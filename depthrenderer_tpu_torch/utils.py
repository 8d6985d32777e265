"""Small host-side utilities: logging, frame timing and PSNR.

Counterpart of ``depthrenderer_tpu/utils.py`` (``log``, ``FrameTimer`` and
``psnr``; reference ``DepthRenderer/utils.py:12-17, 523-538``).
"""

from __future__ import annotations

import datetime
import time

import numpy as np


def log(message):
    """Print a message to stdout with a timestamp."""
    print(f"[{datetime.datetime.now()}] {message}", flush=True)


class FrameTimer:
    """Wall-clock frame timer: the delta since the previous ``update()`` and
    the accumulated elapsed time."""

    def __init__(self):
        self.last_frame_time = time.time()
        self.delta = 0.0
        self.elapsed = 0.0

    def reset(self):
        self.last_frame_time = time.time()
        self.delta = 0.0
        self.elapsed = 0.0

    def update(self):
        now = time.time()
        self.delta = now - self.last_frame_time
        self.elapsed += self.delta
        self.last_frame_time = now


def psnr(a, b, max_value=255.0):
    """Peak signal-to-noise ratio in dB between two images (uint8 or
    float)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(max_value**2 / mse))
