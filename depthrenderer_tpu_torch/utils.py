"""Small host-side utilities: logging, frame timing, array packing, Perlin
noise and PSNR.

Counterpart of ``depthrenderer_tpu/utils.py`` (reference
``DepthRenderer/utils.py:12-17, 189-214, 523-591``). The Perlin noise and
its depth overlay stay in host numpy float64, as the JAX package computes
them: a seed's permutation comes from numpy's ``default_rng``, and the
overlaid uint8 depth map must equal the JAX package's byte for byte.
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


def flatten_arrays(arrays):
    """Each array of ``arrays`` flattened (reference ``utils.py:189-196``)."""
    return tuple(np.ravel(np.asarray(a)) for a in arrays)


def interweave_arrays(arrays):
    """N same-length flat arrays interleaved element by element:
    ``interweave_arrays([[1, 3, 5], [2, 4, 6]]) -> [1, 2, 3, 4, 5, 6]``
    (reference ``utils.py:199-214``)."""
    return np.stack([np.asarray(a) for a in arrays], axis=-1).reshape(-1)


def perlin(width, height, scale=5, seed=None):
    """2-D gradient (Perlin) noise with the fade ``6t^5 - 15t^4 + 10t^3``
    (reference ``utils.py:541-591``): a (height, width) float64 array,
    deterministic for a given ``seed``."""
    xs = np.linspace(0, scale, width, endpoint=False)
    ys = np.linspace(0, scale, height, endpoint=False)
    x, y = np.meshgrid(xs, ys)
    p = np.random.default_rng(seed).permutation(256)
    p = np.concatenate([p, p])
    xi = x.astype(int)
    yi = y.astype(int)
    xf = x - xi
    yf = y - yi

    def fade(t):
        return 6 * t**5 - 15 * t**4 + 10 * t**3

    def gradient(h, gx, gy):
        g = np.array([[0, 1], [0, -1], [1, 0], [-1, 0]])[h % 4]
        return g[..., 0] * gx + g[..., 1] * gy

    def lerp(a, b, t):
        return a + t * (b - a)

    u, v = fade(xf), fade(yf)
    n00 = gradient(p[p[xi] + yi], xf, yf)
    n01 = gradient(p[p[xi] + yi + 1], xf, yf - 1)
    n11 = gradient(p[p[xi + 1] + yi + 1], xf - 1, yf - 1)
    n10 = gradient(p[p[xi + 1] + yi], xf - 1, yf)
    return lerp(lerp(n00, n10, u), lerp(n01, n11, u), v)


def overlay_noise(image, **perlin_kwargs):
    """An (H, W, C) image plus min-max normalised Perlin noise, rescaled to
    uint8 by its maximum (reference ``__main__.py:23-35``)."""
    height, width = image.shape[:2]
    noise = perlin(width, height, **perlin_kwargs)
    noise = 255 * ((noise - noise.min()) / (noise.max() - noise.min()))
    new_image = np.asarray(image).astype(np.float64) + noise[..., None]
    new_image = new_image / new_image.max()
    return (255 * new_image).astype(np.uint8)


def psnr(a, b, max_value=255.0):
    """Peak signal-to-noise ratio in dB between two images (uint8 or
    float)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(max_value**2 / mse))
