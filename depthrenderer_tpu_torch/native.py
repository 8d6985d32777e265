"""The native (C) frame encoders: PNG, baseline JPEG (from RGB(A) or from
planar YUV 4:2:0) and AVI DIB rows.

Compiles this package's own ``csrc/frameops.c`` (a copy of the C source the
JAX package ships beside its encoders) with the system C compiler into the
git-ignored ``build/`` directory on first use, and loads it with ctypes. It
needs zlib (``-lz``) for PNG.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "frameops.c"
BUILD_DIR = _PKG / "build"
LIBRARY = BUILD_DIR / "libframeops.so"

_lib = None
_lock = threading.Lock()


def build(force: bool = False) -> Path:
    """Compile frameops.c unless an up-to-date library exists; returns its
    path. Raises ``RuntimeError`` with the compiler's output on failure."""
    if (LIBRARY.exists() and not force
            and LIBRARY.stat().st_mtime >= SOURCE.stat().st_mtime):
        return LIBRARY
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Compile to a private name, then rename: concurrent processes never load
    # a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [os.environ.get("CC", "cc"), "-O3", "-fPIC", "-shared", "-o", tmp,
           str(SOURCE), "-lz", "-lm"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"building {SOURCE.name} failed:\n{' '.join(cmd)}\n"
                           f"{proc.stderr}")
    os.replace(tmp, LIBRARY)
    return LIBRARY


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            cp, i32, sz = ctypes.c_char_p, ctypes.c_int32, ctypes.c_size_t
            lib.png_encode.restype = sz
            lib.png_encode.argtypes = [cp, i32, i32, i32, i32, cp, sz]
            lib.png_encode_bound.restype = sz
            lib.png_encode_bound.argtypes = [i32, i32, i32]
            lib.jpeg_encode.restype = sz
            lib.jpeg_encode.argtypes = [cp, i32, i32, i32, i32, cp, sz]
            lib.jpeg_encode_bound.restype = sz
            lib.jpeg_encode_bound.argtypes = [i32, i32]
            lib.jpeg_encode_yuv420.restype = sz
            lib.jpeg_encode_yuv420.argtypes = [cp, cp, cp, i32, i32, i32, cp,
                                               sz]
            lib.rgb_to_bgr_rows.restype = None
            lib.rgb_to_bgr_rows.argtypes = [cp, cp, i32, i32, i32, i32, i32]
            _lib = lib
    return _lib


def _image(image):
    image = np.ascontiguousarray(image, dtype=np.uint8)
    if image.ndim != 3 or image.shape[2] not in (3, 4):
        raise ValueError(f"expected an (H, W, 3|4) uint8 image, got "
                         f"{image.shape}")
    return image


def png_encode(image, level: int = 3) -> bytes:
    """Encode a top-down (H, W, 3|4) uint8 image as PNG bytes."""
    lib = _load()
    image = _image(image)
    h, w, c = image.shape
    cap = lib.png_encode_bound(w, h, c)
    out = ctypes.create_string_buffer(cap)
    n = lib.png_encode(image.ctypes.data_as(ctypes.c_char_p), w, h, c, level,
                       out, cap)
    if n == 0:
        raise RuntimeError("native png_encode failed")
    return out.raw[:n]


def jpeg_encode(image, quality: int = 92) -> bytes:
    """Encode a top-down (H, W, 3|4) uint8 image as baseline 4:2:0 JPEG."""
    lib = _load()
    image = _image(image)
    h, w, c = image.shape
    cap = lib.jpeg_encode_bound(w, h)
    out = ctypes.create_string_buffer(cap)
    n = lib.jpeg_encode(image.ctypes.data_as(ctypes.c_char_p), w, h, c,
                        quality, out, cap)
    if n == 0:
        raise RuntimeError("native jpeg_encode failed")
    return out.raw[:n]


def jpeg_encode_yuv420(y, cb, cr, quality: int = 92) -> bytes:
    """Encode planar YUV 4:2:0 (JFIF full-range BT.601, as
    :func:`.io.rgba_to_yuv420` packs it) as baseline JPEG: ``y`` (H, W),
    ``cb`` and ``cr`` (ceil(H/2), ceil(W/2)) uint8. The encoder skips its
    colour conversion and chroma subsampling."""
    lib = _load()
    y, cb, cr = (np.ascontiguousarray(p, dtype=np.uint8) for p in (y, cb, cr))
    if y.ndim != 2:
        raise ValueError(f"expected an (H, W) Y plane, got {y.shape}")
    h, w = y.shape
    half = ((h + 1) // 2, (w + 1) // 2)
    if cb.shape != half or cr.shape != half:
        raise ValueError(f"chroma planes {cb.shape} and {cr.shape} do not "
                         f"match the Y plane {y.shape}: expected {half}")
    cap = lib.jpeg_encode_bound(w, h)
    out = ctypes.create_string_buffer(cap)
    n = lib.jpeg_encode_yuv420(y.ctypes.data_as(ctypes.c_char_p),
                               cb.ctypes.data_as(ctypes.c_char_p),
                               cr.ctypes.data_as(ctypes.c_char_p), w, h,
                               quality, out, cap)
    if n == 0:
        raise RuntimeError("native jpeg_encode_yuv420 failed")
    return out.raw[:n]


def rgb_to_bgr_rows(image, row_pad: int, bottom_up: bool = True) -> bytes:
    """A top-down RGB(A) frame as padded BGR rows (the AVI DIB layout)."""
    lib = _load()
    image = _image(image)
    h, w, c = image.shape
    out = ctypes.create_string_buffer(row_pad * h)
    lib.rgb_to_bgr_rows(image.ctypes.data_as(ctypes.c_char_p), out, w, h, c,
                        row_pad, 1 if bottom_up else 0)
    return out.raw
