"""Host-side asset I/O: colour images, depth maps, resizing and PNG output.

Counterpart of ``depthrenderer_tpu/io.py`` (reference
``DepthRenderer/utils.py:126-186``). Images stay top-down end to end. Pillow
is imported only inside the loaders and ``resize``; PNG files are written by
the native encoder (:mod:`.native`).
"""

from __future__ import annotations

import numpy as np


def load_image(fp):
    """Load an image from disk as a numpy array, top row first."""
    from PIL import Image

    with Image.open(fp) as img:
        return np.asarray(img)


def load_colour(fp, should_mask=False, mask_white=True):
    """Load a colour image as RGBA uint8: greyscale broadcasts to RGB, RGB
    gains an alpha equal to the image maximum, and optional colour-key
    masking zeroes the alpha of pure-white (or pure-black) pixels."""
    colour_image = load_image(fp)
    if colour_image.ndim == 2:
        colour_image = np.stack([colour_image] * 3, axis=2)
    h, w, c = colour_image.shape
    if c == 3:
        alpha = colour_image.max() * np.ones((h, w, 1), dtype=colour_image.dtype)
        colour_image = np.concatenate((colour_image, alpha), axis=2)
    else:
        colour_image = colour_image.copy()
    if should_mask:
        mask_colour = [255, 255, 255] if mask_white else [0, 0, 0]
        mask = np.all(colour_image[:, :, :3] == mask_colour, axis=2)
        colour_image[mask, 3] = 0
    return colour_image


def load_depth(fp):
    """Load a depth map, min-max normalise it and quantise to (H, W) uint8
    (255 = nearest after meshing's ``z = 1 - d/255``)."""
    depth_map = load_image(fp)
    if depth_map.ndim == 3:
        depth_map = depth_map[..., 0]
    depth_map = depth_map.astype(np.float64)
    lo, hi = depth_map.min(), depth_map.max()
    if hi > lo:
        depth_map = (depth_map - lo) / (hi - lo)
    else:
        depth_map = np.zeros_like(depth_map)
    return (255 * depth_map).astype(np.uint8)


def resize(image, size):
    """Resize an image to ``size`` (height, width, ...) with Lanczos."""
    from PIL import Image

    height, width = size[:2]
    resized = Image.fromarray(image).resize((width, height), Image.LANCZOS)
    return np.asarray(resized)


def save_image(frame, path):
    """Write an (H, W, 3|4) uint8 frame to ``path`` as PNG."""
    from . import native

    data = native.png_encode(np.asarray(frame))
    with open(path, "wb") as f:
        f.write(data)


def to_uint8(frame):
    """Convert a float frame in [0, 1] (or uint8 passthrough) to uint8."""
    frame = np.asarray(frame)
    if frame.dtype == np.uint8:
        return frame
    return np.clip(np.round(frame * 255.0), 0, 255).astype(np.uint8)
