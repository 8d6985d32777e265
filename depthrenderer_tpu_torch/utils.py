"""Small host-side utilities: logging and frame timing.

Counterpart of ``depthrenderer_tpu/utils.py`` (``log`` and ``FrameTimer``;
reference ``DepthRenderer/utils.py:12-17, 523-538``).
"""

from __future__ import annotations

import datetime
import time


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
