"""A seeded synthetic colour + depth scene for smoke runs and profiles.

The repository holds no photograph and depth map of its own, so the chip
smoke (``chip_smoke.py``) and :mod:`.profiling` render this one.
"""

from __future__ import annotations

import numpy as np


def synthetic_scene(seed=0, h=480, w=640):
    """A seeded 640x480 RGBA colour image and a smooth sinusoid depth map
    with a few steps (uint8, 255 = nearest)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    colour = np.stack([
        (xx / (w - 1)) * 255,
        (yy / (h - 1)) * 255,
        ((xx // 16 + yy // 16) % 2) * 200 + 27,
        np.full((h, w), 255.0),
    ], axis=-1)
    colour[..., :3] += rng.normal(0, 6, (h, w, 3))
    colour = np.clip(np.round(colour), 0, 255).astype(np.uint8)
    depth = 110 + 60 * np.sin(xx / w * 7 + 0.3) * np.cos(yy / h * 5)
    depth[h // 4:h // 2, w // 5:w // 2] += 70       # a raised box
    depth[(xx - 0.7 * w) ** 2 + (yy - 0.6 * h) ** 2 < (0.12 * h) ** 2] = 20
    return colour, np.clip(np.round(depth), 0, 255).astype(np.uint8)
