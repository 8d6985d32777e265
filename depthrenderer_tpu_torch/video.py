"""Dependency-free video containers: AVI (motion JPEG or raw DIB frames)
and MP4 (motion-JPEG samples), their readers, and the MP4 conversion.

Counterpart of ``depthrenderer_tpu/video.py`` (the reference encodes with
``cv2.VideoWriter``, ``DepthRenderer/utils.py:440-484``, and post-processes
with ffmpeg, ``render_many.py:27-147``). JPEG frames come from the native
encoder (:func:`encode_jpeg`; the JAX package prefers Pillow's, so the two
packages' ``write`` payloads differ while ``write_sample``,
``write_yuv420`` and the remux, native in both, are byte-identical); DIB
frames are bottom-up BGR rows, bit exact. :func:`convert_to_mp4` transcodes
to H.264 when ffmpeg is on the host and otherwise remuxes the AVI's JPEG
payloads into an MP4 unchanged. The readers decode with Pillow.
"""

from __future__ import annotations

import io as _io
import os
import shutil
import struct
import subprocess

import numpy as np

from . import native

# The JPEG quality of MJPG frames unless a writer is given another; the
# card's encoder (:mod:`.ops.jpeg`) writes the CLI's frames at it.
JPEG_QUALITY = 92

_AVIF_HASINDEX = 0x00000010
_AVIIF_KEYFRAME = 0x00000010


def encode_jpeg(rgb, quality: int = JPEG_QUALITY) -> bytes:
    """One baseline JPEG frame (4:2:0, Annex K tables) from the native
    encoder."""
    return native.jpeg_encode(rgb, quality=quality)


def _fourcc(code: str) -> bytes:
    b = code.encode("ascii")
    if len(b) != 4:
        raise ValueError(f"fourcc must be 4 characters, got {code!r}")
    return b


def _check_frame(frame, width, height):
    frame = np.asarray(frame)
    if frame.ndim != 3 or frame.shape[:2] != (height, width):
        raise ValueError(f"Expected a ({height}, {width}, C) frame, got "
                         f"{frame.shape}")
    return frame


def _mp4_path(avi_path: str) -> str:
    return (avi_path[:-4] + ".mp4" if avi_path.lower().endswith(".avi")
            else avi_path + ".mp4")


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def convert_to_mp4(avi_path, mp4_path=None, remove_source=True, crf=18):
    """Convert an AVI to MP4: an H.264 transcode when ffmpeg is on the host
    (reference counterpart ``render_many.py:76``), else a native remux
    (:func:`remux_avi_to_mp4`, MJPG payloads unchanged). Returns the MP4
    path."""
    avi_path = str(avi_path)
    mp4_path = _mp4_path(avi_path) if mp4_path is None else str(mp4_path)
    if not ffmpeg_available():
        return remux_avi_to_mp4(avi_path, mp4_path,
                                remove_source=remove_source)
    subprocess.run(
        ["ffmpeg", "-i", avi_path, "-c:v", "libx264", "-crf", str(crf),
         "-pix_fmt", "yuv420p", mp4_path, "-y"],
        check=True, capture_output=True)
    if remove_source:
        os.remove(avi_path)
    return mp4_path


def read_video_frames(path):
    """Every frame of a video by container (``.mp4``: :func:`read_mp4_frames`,
    else :func:`read_avi_frames`): top-down (H, W, 3) uint8 RGB."""
    if str(path).lower().endswith(".mp4"):
        return read_mp4_frames(path)
    return read_avi_frames(path)


def read_video_info(path):
    """(width, height, frames, fps) of a video by container."""
    if str(path).lower().endswith(".mp4"):
        return read_mp4_info(path)
    return read_avi_info(path)


def open_video_writer(path, size, fps=24.0, **kw):
    """The writer of ``path``'s container: :class:`Mp4File` for ``.mp4``,
    else :class:`AviFile`."""
    if str(path).lower().endswith(".mp4"):
        return Mp4File(path, size, fps=fps, **kw)
    return AviFile(path, size, fps=fps, **kw)


# ---------------------------------------------------------------------------
# ISO-BMFF (MP4) with motion-JPEG samples
# ---------------------------------------------------------------------------

_MP4_TIMESCALE = 90000
_MP4_MATRIX = struct.pack(
    ">9i", 0x00010000, 0, 0, 0, 0x00010000, 0, 0, 0, 0x40000000)


def _box(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + kind + payload


def _full_box(kind: bytes, payload: bytes, version=0, flags=0) -> bytes:
    return _box(kind, struct.pack(">I", (version << 24) | flags) + payload)


class Mp4File:
    """Streaming MP4 (ISO/IEC 14496-12) writer with motion-JPEG samples.

    The ``jpeg`` visual sample entry is the MJPEG-in-MP4 convention ffmpeg,
    VLC and QuickTime decode; every sample is a complete JFIF image and a
    sync sample (no ``stss``). Layout: ``ftyp``, a streaming ``mdat``, then
    ``moov`` (sizes and chunk offsets patched at :meth:`close`), one chunk a
    sample. :meth:`write` takes top-down (H, W, 3|4) uint8 frames;
    :meth:`write_sample` appends a pre-encoded JPEG unchanged.
    """

    def __init__(self, path, size, fps=24.0, quality=92):
        self.path = str(path)
        self.width, self.height = int(size[0]), int(size[1])
        self.fps = float(fps)
        self.quality = int(quality)
        self._sizes: list[int] = []
        self._offsets: list[int] = []
        self._closed = False
        self._f = open(self.path, "wb")
        self._f.write(_box(b"ftyp", b"isom" + struct.pack(">I", 0x200)
                           + b"isomiso2mp41"))
        self._mdat_pos = self._f.tell()
        self._f.write(struct.pack(">I", 0) + b"mdat")  # size patched at close

    def write(self, frame):
        """Append one top-down RGB(A) uint8 frame (native JPEG)."""
        frame = _check_frame(frame, self.width, self.height)
        self.write_sample(encode_jpeg(frame[..., :3], self.quality))

    def write_sample(self, jpeg_bytes: bytes):
        """Append one pre-encoded JPEG sample verbatim."""
        if self._closed:
            raise ValueError("Mp4File already closed.")
        self._offsets.append(self._f.tell())
        self._sizes.append(len(jpeg_bytes))
        self._f.write(jpeg_bytes)

    def _moov(self) -> bytes:
        n = len(self._sizes)
        ts = _MP4_TIMESCALE
        delta = int(round(ts / self.fps)) if self.fps > 0 else ts
        dur = n * delta
        mvhd = _full_box(b"mvhd", struct.pack(
            ">IIIIiH", 0, 0, ts, dur, 0x00010000, 0x0100)
            + b"\x00" * 10 + _MP4_MATRIX + b"\x00" * 24
            + struct.pack(">I", 2))
        tkhd = _full_box(b"tkhd", struct.pack(">IIIII", 0, 0, 1, 0, dur)
                         + b"\x00" * 8 + struct.pack(">hhhh", 0, 0, 0, 0)
                         + _MP4_MATRIX
                         + struct.pack(">II", self.width << 16,
                                       self.height << 16),
                         flags=3)  # enabled | in_movie
        mdhd = _full_box(b"mdhd", struct.pack(
            ">IIIIHH", 0, 0, ts, dur, 0x55C4, 0))  # language 'und'
        hdlr = _full_box(b"hdlr", struct.pack(">I", 0) + b"vide"
                         + b"\x00" * 12 + b"DepthRenderer\x00")
        entry = (
            b"\x00" * 6 + struct.pack(">H", 1)          # data_reference_index
            + struct.pack(">HH", 0, 0) + b"\x00" * 12   # pre_defined, reserved
            + struct.pack(">HH", self.width, self.height)
            + struct.pack(">II", 0x00480000, 0x00480000)  # 72 dpi
            + struct.pack(">I", 0) + struct.pack(">H", 1)  # frame_count
            + bytes(32)                                   # compressorname
            + struct.pack(">Hh", 24, -1))                 # depth, pre_defined
        stsd = _full_box(b"stsd", struct.pack(">I", 1) + _box(b"jpeg", entry))
        stts = _full_box(b"stts", struct.pack(">III", 1, n, delta))
        stsc = _full_box(b"stsc", struct.pack(">IIII", 1, 1, 1, 1))
        stsz = _full_box(b"stsz", struct.pack(">II", 0, n)
                         + b"".join(struct.pack(">I", s) for s in self._sizes))
        stco = _full_box(b"stco", struct.pack(">I", n)
                         + b"".join(struct.pack(">I", o)
                                    for o in self._offsets))
        vmhd = _full_box(b"vmhd", struct.pack(">HHHH", 0, 0, 0, 0), flags=1)
        dinf = _box(b"dinf", _full_box(
            b"dref", struct.pack(">I", 1) + _full_box(b"url ", b"", flags=1)))
        stbl = _box(b"stbl", stsd + stts + stsc + stsz + stco)
        minf = _box(b"minf", vmhd + dinf + stbl)
        mdia = _box(b"mdia", mdhd + hdlr + minf)
        trak = _box(b"trak", tkhd + mdia)
        return _box(b"moov", mvhd + trak)

    def close(self):
        if self._closed:
            return
        self._closed = True
        f = self._f
        mdat_end = f.tell()
        f.write(self._moov())
        f.seek(self._mdat_pos)
        f.write(struct.pack(">I", mdat_end - self._mdat_pos))
        f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _avi_chunks(path):
    """(width, height, fps, [(chunk id, payload)]) of the movi list of an
    AVI written by :class:`AviFile` (idx1 entries also hold chunk ids, so
    only the movi list is walked)."""
    w, h, _, fps = read_avi_info(path)
    with open(path, "rb") as f:
        data = f.read()
    movi = data.find(b"movi")
    idx1 = data.find(b"idx1", movi)
    end = idx1 if idx1 > 0 else len(data)
    chunks = []
    pos = movi + 4
    while pos + 8 <= end:
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        chunks.append((data[pos:pos + 4], data[pos + 8:pos + 8 + size]))
        pos += 8 + size + (size % 2)
    return w, h, fps, chunks


def _dib_frame(payload, w, h):
    """A raw DIB chunk (bottom-up, padded BGR rows) -> top-down RGB."""
    row = (w * 3 + 3) & ~3
    arr = np.frombuffer(payload, np.uint8)[:row * h].reshape(h, row)
    return arr[:, :w * 3].reshape(h, w, 3)[::-1, :, ::-1].copy()


def remux_avi_to_mp4(avi_path, mp4_path=None, remove_source=False,
                     quality=92):
    """Rewrap an AVI written by :class:`AviFile` as an MP4, without ffmpeg:
    MJPG chunks (``00dc``) move into the MP4 unchanged, raw DIB chunks
    (``00db``) are JPEG-encoded first. Returns the MP4 path."""
    avi_path = str(avi_path)
    mp4_path = _mp4_path(avi_path) if mp4_path is None else str(mp4_path)
    w, h, fps, chunks = _avi_chunks(avi_path)
    with Mp4File(mp4_path, (w, h), fps=fps or 24.0, quality=quality) as out:
        for chunk_id, payload in chunks:
            if chunk_id == b"00dc":
                out.write_sample(payload)
            elif chunk_id == b"00db":
                out.write(_dib_frame(payload, w, h))
    if remove_source:
        os.remove(avi_path)
    return mp4_path


def _walk_mp4_boxes(data, start, end, path=()):
    """Yield (path, kind, payload_start, payload_end) over nested MP4
    boxes."""
    containers = {b"moov", b"trak", b"mdia", b"minf", b"stbl", b"dinf"}
    pos = start
    while pos + 8 <= end:
        size = struct.unpack(">I", data[pos:pos + 4])[0]
        kind = data[pos + 4:pos + 8]
        if size < 8:
            break
        yield path + (kind,), kind, pos + 8, pos + size
        if kind in containers:
            yield from _walk_mp4_boxes(data, pos + 8, pos + size,
                                       path + (kind,))
        pos += size


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def read_mp4_info(path):
    """(width, height, frames, fps) of an MP4 written by :class:`Mp4File`."""
    data = _read(path)
    if data[4:8] != b"ftyp":
        raise ValueError(f"{path} is not an MP4 file")
    w = h = frames = ts = delta = 0
    for _, kind, a, b in _walk_mp4_boxes(data, 0, len(data)):
        if kind == b"tkhd":
            w = struct.unpack(">I", data[b - 8:b - 4])[0] >> 16
            h = struct.unpack(">I", data[b - 4:b])[0] >> 16
        elif kind == b"mdhd":
            ts = struct.unpack(">I", data[a + 12:a + 16])[0]
        elif kind == b"stts":
            frames, delta = struct.unpack(">II", data[a + 8:a + 16])
    return w, h, frames, ts / delta if delta else 0.0


def read_mp4_samples(path):
    """The JPEG samples of an :class:`Mp4File` MP4, in order (from its
    ``stsz`` and ``stco`` tables)."""
    data = _read(path)
    sizes, offsets = [], []
    for _, kind, a, b in _walk_mp4_boxes(data, 0, len(data)):
        if kind == b"stsz":
            n = struct.unpack(">I", data[a + 8:a + 12])[0]
            sizes = struct.unpack(f">{n}I", data[a + 12:a + 12 + 4 * n])
        elif kind == b"stco":
            n = struct.unpack(">I", data[a + 4:a + 8])[0]
            offsets = struct.unpack(f">{n}I", data[a + 8:a + 8 + 4 * n])
    return [data[o:o + s] for o, s in zip(offsets, sizes)]


def _decode_jpeg(payload):
    from PIL import Image

    return np.asarray(Image.open(_io.BytesIO(payload)).convert("RGB"))


def read_mp4_frames(path):
    """Every sample of an :class:`Mp4File` MP4 decoded: top-down (H, W, 3)
    uint8 RGB."""
    return [_decode_jpeg(s) for s in read_mp4_samples(path)]


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

    def __init__(self, path, size, fps=24.0, codec="MJPG",
                 quality=JPEG_QUALITY):
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
        frame = _check_frame(frame, self.width, self.height)
        if self.codec == "DIB ":
            return native.rgb_to_bgr_rows(frame, (self.width * 3 + 3) & ~3,
                                          bottom_up=True)
        return encode_jpeg(frame[..., :3], self.quality)

    def write(self, frame):
        """Append one top-down RGB(A) uint8 frame."""
        if self._closed:
            raise ValueError("AviFile already closed.")
        self._append_chunk(self._encode(frame))

    def write_yuv420(self, y, cb, cr):
        """Append one frame given as planar YUV 4:2:0 (MJPG only): ``y``
        (H, W), ``cb`` and ``cr`` (H/2, W/2) uint8, the planes
        :func:`.io.rgba_to_yuv420` packs. The native encoder takes them as
        they are."""
        if self._closed:
            raise ValueError("AviFile already closed.")
        if self.codec != "MJPG":
            raise ValueError("write_yuv420 needs the MJPG codec")
        y, cb, cr = (np.asarray(p) for p in (y, cb, cr))
        half = ((self.height + 1) // 2, (self.width + 1) // 2)
        if (y.shape != (self.height, self.width) or cb.shape != half
                or cr.shape != half):
            raise ValueError(
                f"YUV 4:2:0 planes {y.shape}, {cb.shape}, {cr.shape} do not "
                f"fit a {self.width}x{self.height} frame")
        self._append_chunk(native.jpeg_encode_yuv420(y, cb, cr,
                                                     quality=self.quality))

    def write_jpeg(self, payload: bytes):
        """Append one frame already encoded as a JPEG (MJPG only), as
        :meth:`write` would have encoded it: ``jpeg_encode`` at this file's
        quality, or the card's encoder (:mod:`.ops.jpeg`)."""
        if self._closed:
            raise ValueError("AviFile already closed.")
        if self.codec != "MJPG":
            raise ValueError("write_jpeg needs the MJPG codec")
        self._append_chunk(payload)

    def _append_chunk(self, payload: bytes):
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


def read_avi_frames(path):
    """Every frame of an AVI written by :class:`AviFile` decoded (MJPG
    ``00dc`` by Pillow, raw DIB ``00db`` unpacked): top-down (H, W, 3)
    uint8 RGB."""
    w, h, _, chunks = _avi_chunks(path)
    frames = []
    for chunk_id, payload in chunks:
        if chunk_id == b"00dc":
            frames.append(_decode_jpeg(payload))
        elif chunk_id == b"00db":
            frames.append(_dib_frame(payload, w, h))
    return frames


def read_avi_payloads(path):
    """The MJPG JPEG payloads of an :class:`AviFile` AVI, in order."""
    return [p for cid, p in _avi_chunks(path)[3] if cid == b"00dc"]


def read_avi_info(path):
    """(width, height, frames, fps) from an AVI's main header."""
    with open(path, "rb") as f:
        data = f.read(4096)
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise ValueError(f"{path} is not an AVI file")
    i = data.find(b"avih")
    usec, _, _, _, frames, _, _, _, w, h = struct.unpack("<10I",
                                                         data[i + 8:i + 48])
    return w, h, frames, 1e6 / usec if usec else 0.0
