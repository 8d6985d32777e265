"""The benchmark's own reader of the AVI files the CLI writes, and its JPEG
decode (Pillow): the check reads the encoder's output without the
program's reader."""

from __future__ import annotations

import io
import struct

import numpy as np

_FRAME_CHUNKS = (b"dc", b"db")


def _chunks(data: bytes, pos: int, end: int):
    while pos + 8 <= end:
        cid = data[pos:pos + 4]
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        yield cid, pos + 8, size
        pos += 8 + size + (size & 1)


def header(path):
    """(width, height, frame count the header states)."""
    with open(path, "rb") as f:
        head = f.read(256)
    avih = head.find(b"avih")
    if head[:4] != b"RIFF" or head[8:12] != b"AVI " or avih < 0 or len(
            head) < avih + 64:
        raise ValueError(f"{path} is not an AVI file")
    vals = struct.unpack("<14I", head[avih + 8:avih + 64])
    return vals[8], vals[9], vals[4]


def frame_payloads(path):
    """Every video frame chunk of the file's ``movi`` list, in order."""
    with open(path, "rb") as f:
        data = f.read()
    for cid, start, size in _chunks(data, 12, len(data)):
        if cid == b"LIST" and data[start:start + 4] == b"movi":
            return [data[s:s + n] for c, s, n in
                    _chunks(data, start + 4, start + size)
                    if c[2:] in _FRAME_CHUNKS]
    raise ValueError(f"{path} has no movi list")


def decode_jpeg(payload) -> np.ndarray:
    """A JPEG frame -> (H, W, 3) uint8 RGB."""
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(payload)).convert("RGB"))


def read_png(path) -> np.ndarray:
    """A PNG -> (H, W, 4) uint8 RGBA."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA"))
