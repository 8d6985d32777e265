"""Asset I/O: colour images, depth maps, resizing, PNG output and the YUV
4:2:0 frame pack.

Counterpart of ``depthrenderer_tpu/io.py`` (reference
``DepthRenderer/utils.py:126-186, 345-377``). Images stay top-down end to
end. Pillow is imported only inside the functions that use it; PNG files are
written by the native encoder (:mod:`.native`). :func:`rgba_to_yuv420` runs
on the frames' own device, so a render farm reads 1.5 bytes a pixel back
from the card instead of 4.
"""

from __future__ import annotations

import numpy as np
import torch


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


def save_image(frame, path, file_format="PNG"):
    """Write an (H, W, C) uint8 frame to ``path``: PNG by the native
    encoder, any other format by Pillow."""
    frame = np.asarray(frame)
    if file_format.upper() != "PNG":
        from PIL import Image

        Image.fromarray(frame).save(path, file_format)
        return
    from . import native

    data = native.png_encode(frame)
    with open(path, "wb") as f:
        f.write(data)


def to_uint8(frame):
    """Convert a float frame in [0, 1] (or uint8 passthrough) to uint8."""
    frame = np.asarray(frame)
    if frame.dtype == np.uint8:
        return frame
    return np.clip(np.round(frame * 255.0), 0, 255).astype(np.uint8)


# -- the YUV 4:2:0 frame pack and the frame-buffer helpers ------------------


def rgba_to_yuv420(frames):
    """RGBA -> planar YUV 4:2:0 (JFIF full-range BT.601) on the frames' own
    device.

    ``frames``: (..., H, W, C >= 3) uint8 tensor (or array) with even H and
    W. Returns (..., H*W*3//2) uint8: the Y plane, then the Cb and Cr
    half-planes of the 2x2 box-filtered RGB, the layout
    :func:`.native.jpeg_encode_yuv420` and
    :meth:`.video.AviFile.write_yuv420` take. The float order is the JAX
    package's: Y, then the 2x2 mean, then Cb and Cr, then round half to
    even and clip. Each step is its own eager operation, so nothing is
    contracted and the card's bytes equal the CPU's.
    """
    frames = torch.as_tensor(frames)
    h, w = int(frames.shape[-3]), int(frames.shape[-2])
    if h % 2 or w % 2:
        raise ValueError(f"YUV 4:2:0 needs an even frame size, got {w}x{h}")
    f = frames[..., :3].to(torch.float32)
    r, g, b = f.unbind(-1)
    y = 0.299 * r + 0.587 * g + 0.114 * b
    lead = tuple(f.shape[:-3])
    q = f.reshape(lead + (h // 2, 2, w // 2, 2, 3)).mean(dim=(-2, -4))
    r4, g4, b4 = q.unbind(-1)
    cb = 128.0 - 0.168736 * r4 - 0.331264 * g4 + 0.5 * b4
    cr = 128.0 + 0.5 * r4 - 0.418688 * g4 - 0.081312 * b4
    return torch.cat([x.round().clamp(0.0, 255.0).to(torch.uint8).flatten(-2)
                      for x in (y, cb, cr)], dim=-1)


def yuv420_planes(packed, h: int, w: int):
    """One packed (H*W*3//2,) frame -> its (Y, Cb, Cr) plane views."""
    cq = h * w // 4
    return (packed[:h * w].reshape(h, w),
            packed[h * w:h * w + cq].reshape(h // 2, w // 2),
            packed[h * w + cq:].reshape(h // 2, w // 2))


def yuv420_to_rgb(packed, h: int, w: int):
    """Host inverse of :func:`rgba_to_yuv420` (numpy, as the JAX package
    computes it): packed (H*W*3//2,) uint8 -> (H, W, 3) uint8."""
    y, cb, cr = (p.astype(np.float32) for p in
                 yuv420_planes(np.asarray(packed, np.uint8), h, w))
    cb = np.repeat(np.repeat(cb, 2, 0), 2, 1) - 128.0
    cr = np.repeat(np.repeat(cr, 2, 0), 2, 1) - 128.0
    r = y + 1.402 * cr
    g = y - 0.344136 * cb - 0.714136 * cr
    b = y + 1.772 * cb
    return np.clip(np.round(np.stack([r, g, b], -1)), 0, 255).astype(np.uint8)


def read_frame_buffer(frame_buffer, size, mode="RGBA"):
    """Raw frame-buffer bytes as a PIL image (reference
    ``utils.py:345-355``)."""
    from PIL import Image

    return Image.frombytes(mode, size, data=frame_buffer)


def process_frame_numpy(frame):
    """A frame as a numpy array. The reference also un-flips GL's bottom-up
    rows (``utils.py:358-366``); frames here are top-down already."""
    if isinstance(frame, torch.Tensor):
        return frame.detach().cpu().numpy()
    return np.asarray(frame)


def process_frame_pillow(frame):
    """A frame as a PIL image (reference ``utils.py:369-377``)."""
    from PIL import Image

    if isinstance(frame, Image.Image):
        return frame
    return Image.fromarray(process_frame_numpy(frame))
