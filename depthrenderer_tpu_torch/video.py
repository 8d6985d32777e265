"""Dependency-free AVI writer: motion JPEG or raw DIB frames.

Counterpart of ``depthrenderer_tpu/video.py``'s :class:`AviFile` (the
reference encodes with ``cv2.VideoWriter``, ``DepthRenderer/utils.py:440-484``).
JPEG frames come from the native encoder (:func:`encode_jpeg`); DIB frames are
bottom-up BGR rows, bit exact.
"""

from __future__ import annotations

import io as _io
import struct

import numpy as np

from . import native

_AVIF_HASINDEX = 0x00000010
_AVIIF_KEYFRAME = 0x00000010


def encode_jpeg(rgb, quality: int = 92) -> bytes:
    """One baseline JPEG frame (4:2:0, Annex K tables) from the native
    encoder."""
    return native.jpeg_encode(rgb, quality=quality)


def _fourcc(code: str) -> bytes:
    b = code.encode("ascii")
    if len(b) != 4:
        raise ValueError(f"fourcc must be 4 characters, got {code!r}")
    return b


class AviFile:
    """Streaming AVI writer.

    :param path: output file path.
    :param size: (width, height) of frames.
    :param fps: frame rate (may be fractional).
    :param codec: ``"MJPG"`` (JPEG frames) or ``"DIB "`` (uncompressed BGR).
    :param quality: JPEG quality for MJPG.

    Frames are top-down (H, W, 3|4) uint8 arrays; :meth:`close` patches the
    header counts and writes the index.
    """

    def __init__(self, path, size, fps=24.0, codec="MJPG", quality=92):
        if codec not in ("MJPG", "DIB "):
            raise ValueError(f"Unsupported codec {codec!r}")
        self.path = str(path)
        self.width, self.height = int(size[0]), int(size[1])
        self.fps = float(fps)
        self.codec = codec
        self.quality = int(quality)
        self._index = []
        self._frames = 0
        self._closed = False
        self._f = open(self.path, "wb")
        self._write_headers_placeholder()

    def _write_headers_placeholder(self):
        f = self._f
        f.write(b"RIFF" + struct.pack("<I", 0) + b"AVI ")
        hdrl = _io.BytesIO()
        hdrl.write(b"hdrl")
        usec_per_frame = int(round(1_000_000 / self.fps)) if self.fps > 0 else 0
        avih = struct.pack(
            "<14I", usec_per_frame, 0, 0, _AVIF_HASINDEX,
            0,  # dwTotalFrames (patched)
            0, 1, 0, self.width, self.height, 0, 0, 0, 0)
        hdrl.write(b"avih" + struct.pack("<I", len(avih)) + avih)

        strl = _io.BytesIO()
        strl.write(b"strl")
        strh = struct.pack(
            "<4s4sIHHIIIIIIIi4H", b"vids", _fourcc(self.codec), 0, 0, 0, 0,
            1000, int(round(self.fps * 1000)), 0,
            0,  # dwLength (patched)
            0, 0xFFFFFFFF & -1, 0, 0, 0, self.width & 0xFFFF,
            self.height & 0xFFFF)
        strl.write(b"strh" + struct.pack("<I", len(strh)) + strh)
        compression = (0 if self.codec == "DIB "
                       else struct.unpack("<I", _fourcc("MJPG"))[0])
        size_image = ((self.width * 3 + 3) & ~3) * self.height
        strf = struct.pack("<IiiHHIIiiII", 40, self.width, self.height, 1, 24,
                           compression, size_image, 0, 0, 0, 0)
        strl.write(b"strf" + struct.pack("<I", len(strf)) + strf)
        strl_data = strl.getvalue()
        hdrl.write(b"LIST" + struct.pack("<I", len(strl_data)) + strl_data)
        hdrl_data = hdrl.getvalue()
        f.write(b"LIST" + struct.pack("<I", len(hdrl_data)) + hdrl_data)

        self._movi_list_pos = f.tell()
        f.write(b"LIST" + struct.pack("<I", 0) + b"movi")
        self._movi_start = f.tell()
        # RIFF(12) + LIST hdr(8) + 'hdrl'(4) + 'avih'+size(8) + 4 dwords.
        self._avih_totalframes_pos = 12 + 8 + 4 + 8 + 4 * 4
        self._strh_length_pos = (12 + 8 + 4 + 8 + len(avih) + 8 + 4 + 8
                                 + 4 + 4 + 4 + 2 + 2 + 4 + 4 + 4 + 4)

    def _encode(self, frame) -> bytes:
        frame = np.asarray(frame)
        if frame.ndim != 3 or frame.shape[:2] != (self.height, self.width):
            raise ValueError(f"Expected a ({self.height}, {self.width}, C) "
                             f"frame, got {frame.shape}")
        if self.codec == "DIB ":
            return native.rgb_to_bgr_rows(frame, (self.width * 3 + 3) & ~3,
                                          bottom_up=True)
        return encode_jpeg(frame[..., :3], self.quality)

    def write(self, frame):
        """Append one top-down RGB(A) uint8 frame."""
        if self._closed:
            raise ValueError("AviFile already closed.")
        payload = self._encode(frame)
        chunk_id = b"00db" if self.codec == "DIB " else b"00dc"
        offset = self._f.tell() - self._movi_start
        self._f.write(chunk_id + struct.pack("<I", len(payload)) + payload)
        if len(payload) % 2:
            self._f.write(b"\x00")
        self._index.append((chunk_id, offset, len(payload)))
        self._frames += 1

    def close(self):
        if self._closed:
            return
        self._closed = True
        f = self._f
        movi_end = f.tell()
        f.write(b"idx1" + struct.pack("<I", 16 * len(self._index)))
        for chunk_id, offset, size in self._index:
            f.write(chunk_id + struct.pack("<III", _AVIIF_KEYFRAME, offset, size))
        riff_end = f.tell()
        f.seek(4)
        f.write(struct.pack("<I", riff_end - 8))
        f.seek(self._movi_list_pos + 4)
        f.write(struct.pack("<I", movi_end - (self._movi_list_pos + 8)))
        f.seek(self._avih_totalframes_pos)
        f.write(struct.pack("<I", self._frames))
        f.seek(self._strh_length_pos)
        f.write(struct.pack("<I", self._frames))
        f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
