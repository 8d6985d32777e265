"""Baseline JPEG (4:2:0, Annex K tables) of rendered frames on the card,
byte for byte the native host encoder's (``native.jpeg_encode``,
``csrc/frameops.c``).

The JAX package has no kernel here: it encodes on the host (Pillow or the
same C file). The card encoder exists because one host thread encoding
~80 ms a 1080p frame left the card idle (``PERF.md``). ``csrc/jpeg.cu``
runs the host encoder's steps over a whole frame group in six launches:

1. ``dct``: colour conversion, the 2x2 chroma mean, the AAN FDCT,
   quantisation and zigzag, 48 blocks (8 MCUs of one MCU row) a CTA, 8
   threads a block; each block's DC value and its AC bits;
2. ``scan``: each block's bits (its DC difference against the previous
   block of its component in MCU order) and their exclusive scan, one CTA a
   frame; the frame's bit buffer zeroed as far as it will be written;
3. ``pack``: each block's bits at its offset, one thread a block (words
   shared with a neighbour merged with ``atomicOr``); the last block pads
   its byte with 1s;
4. ``ffcount``, 5. ``layout`` and 6. ``stuff``: the 0xFF bytes counted,
   scanned and scattered with a 0x00 after each, behind the constant header
   (SOI to SOS) and before EOI, each frame at its offset in one buffer.

Every float step is the C file's, in its order and uncontracted (the file is
built with ``--fmad=false``), ``lrintf`` is ``__float2int_rn``. The bound
is the frame read once and the JPEG bytes written once.

Frames come in either of the render paths' layouts: the scan's raw (F,
HPAD, WL) int32 (R in the low byte) or the tiled routes' (F, H, W, 4)
uint8; both are 4 bytes a pixel with a row stride. :func:`encode_plain`,
the plain twin, runs the same stages in numpy for the tests.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np
import torch

from .. import profiling
from ..video import JPEG_QUALITY
from . import cuda_build

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

QTBL_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])

QTBL_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
    + [99] * 32)

# Annex K: (BITS[1..16], HUFFVAL) of DC luma, AC luma, DC chroma, AC chroma.
DC_L = ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), tuple(range(12)))
DC_C = ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0), tuple(range(12)))
AC_L = ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d), bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa"))
AC_C = ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77), bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa"))

# The AAN scale factors of frameops.c (its reciprocal quantisation table).
_AAN = (1.0, 1.387039845, 1.306562965, 1.175875602, 1.0, 0.785694958,
        0.541196100, 0.275899379)


def _huffman(bits, vals, n):
    """Canonical codes of a (BITS, HUFFVAL) table -> (n,) int64 ``code |
    size << 16`` by symbol (size 0: no code)."""
    out = np.zeros(n, np.int64)
    code = 0
    k = 0
    for length, count in enumerate(bits, start=1):
        for _ in range(count):
            out[vals[k]] = code | length << 16
            code += 1
            k += 1
        code <<= 1
    return out


class Tables:
    """A quality's tables as ``frameops.c`` builds them: ``qt`` (2, 64)
    quantisers, ``rq`` (2, 64) float32 reciprocals (both in natural order;
    0 luma, 1 chroma), ``dc`` (2, 16) and ``ac`` (2, 256) Huffman codes
    (``code | size << 16``)."""

    def __init__(self, quality: int):
        quality = min(max(int(quality), 1), 100)
        scale = 5000 // quality if quality < 50 else 200 - 2 * quality
        self.qt = np.clip((np.stack([QTBL_LUMA, QTBL_CHROMA]) * scale + 50)
                          // 100, 1, 255)
        s = np.array([[_AAN[i >> 3] * _AAN[i & 7] * 8.0 for i in range(64)]])
        self.rq = (1.0 / (self.qt * s)).astype(np.float32)
        self.dc = np.zeros((2, 16), np.int64)
        self.dc[0, :12] = _huffman(*DC_L, 12)
        self.dc[1, :12] = _huffman(*DC_C, 12)
        self.ac = np.stack([_huffman(*AC_L, 256), _huffman(*AC_C, 256)])

    def blob(self) -> np.ndarray:
        """The tables as ``struct JpegTables`` of csrc/jpeg.cu: rq, dc, ac,
        32 bits each."""
        return np.concatenate([self.rq.view(np.int32).ravel(),
                               self.dc.astype(np.int32).ravel(),
                               self.ac.astype(np.int32).ravel()])


@functools.lru_cache(maxsize=8)
def tables(quality: int) -> Tables:
    return Tables(quality)


def _segment(marker: int, data: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(data) + 2).to_bytes(2, "big") + data


@functools.lru_cache(maxsize=8)
def header(width: int, height: int, quality: int) -> bytes:
    """SOI through SOS of a frame, as ``jpeg_write_headers`` writes it."""
    t = tables(quality)
    out = bytearray(b"\xff\xd8")
    out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    for k in range(2):
        out += _segment(0xDB, bytes([k]) + bytes(t.qt[k][ZIGZAG].tolist()))
    out += _segment(0xC0, bytes([8]) + height.to_bytes(2, "big")
                    + width.to_bytes(2, "big")
                    + bytes([3, 1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1]))
    for cls_id, (bits, vals) in ((0x00, DC_L), (0x10, AC_L), (0x01, DC_C),
                                 (0x11, AC_C)):
        out += _segment(0xC4, bytes([cls_id, *bits]) + bytes(vals))
    out += _segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))
    return bytes(out)


class Geometry:
    """A frame's MCU grid: ``mcu_w`` x ``mcu_h`` MCUs of 16x16 pixels, six
    8x8 blocks each (Y0-Y3, Cb, Cr), ``nblk`` blocks in scan order; the
    capacities that no frame can exceed: ``word_cap`` 32-bit words of
    entropy bits (2,112 bits a block at most: DC code and value, 63 AC codes
    and values, 3 ZRLs and EOB, 16 bits each) and ``out_cap`` bytes of a
    frame with every byte stuffed."""

    def __init__(self, width: int, height: int, quality: int):
        self.width, self.height = int(width), int(height)
        self.mcu_w, self.mcu_h = -(-self.width // 16), -(-self.height // 16)
        self.nblk = 6 * self.mcu_w * self.mcu_h
        if 2112 * self.nblk >= 2**31:   # the kernels' bit offsets are int32
            raise ValueError(f"a {self.width}x{self.height} frame is too "
                             f"large for the card's JPEG encoder")
        self.hdr = header(self.width, self.height, int(quality))
        self.word_cap = -(-(66 * self.nblk + 1) // 4) * 4
        self.out_cap = len(self.hdr) + 8 * self.word_cap + 2


def _pixels(frames, width: int, height: int) -> np.ndarray:
    """(F, H, W, 4) uint8 view of either layout (see the module doc)."""
    a = np.asarray(frames.cpu() if isinstance(frames, torch.Tensor)
                   else frames)
    if a.dtype == np.int32 and a.ndim == 3:
        a = np.ascontiguousarray(a).view(np.uint8).reshape(*a.shape, 4)
    if a.dtype != np.uint8 or a.ndim != 4 or a.shape[3] != 4:
        raise ValueError(f"expected (F, rows, stride) int32 or (F, H, W, 4) "
                         f"uint8 frames, got {a.dtype} {a.shape}")
    if a.shape[1] < height or a.shape[2] < width:
        raise ValueError(f"frames {a.shape[1:3]} are smaller than "
                         f"{height}x{width}")
    return a[:, :height, :width]


# -- the plain twin: the kernels' stages in numpy ----------------------------

_F = np.float32


def _dct1d(d):
    """frameops.c's ``dct1d_aan`` on a list of 8 float32 arrays."""
    tmp0, tmp7 = d[0] + d[7], d[0] - d[7]
    tmp1, tmp6 = d[1] + d[6], d[1] - d[6]
    tmp2, tmp5 = d[2] + d[5], d[2] - d[5]
    tmp3, tmp4 = d[3] + d[4], d[3] - d[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    o = [None] * 8
    o[0], o[4] = tmp10 + tmp11, tmp10 - tmp11
    z1 = (tmp12 + tmp13) * _F(0.707106781)
    o[2], o[6] = tmp13 + z1, tmp13 - z1
    tmp10, tmp11, tmp12 = tmp4 + tmp5, tmp5 + tmp6, tmp6 + tmp7
    z5 = (tmp10 - tmp12) * _F(0.382683433)
    z2 = _F(0.541196100) * tmp10 + z5
    z4 = _F(1.306562965) * tmp12 + z5
    z3 = tmp11 * _F(0.707106781)
    z11, z13 = tmp7 + z3, tmp7 - z3
    o[5], o[3] = z13 + z2, z13 - z2
    o[1], o[7] = z11 + z4, z11 - z4
    return o


def coefficients_plain(px, t: Tables):
    """(F, H, W, 4) uint8 -> (F, nblk, 64) int16 quantised coefficients in
    zigzag order, blocks in scan order (stage 1 of the kernels)."""
    F, H, W = px.shape[:3]
    g_h, g_w = -(-H // 16) * 16, -(-W // 16) * 16
    rows = np.minimum(np.arange(g_h), H - 1)
    cols = np.minimum(np.arange(g_w), W - 1)
    p = px[:, rows][:, :, cols, :3].astype(np.int32)   # clamped edges
    r, g, b = (p[..., c].astype(_F) for c in range(3))
    y = _F(0.299) * r + _F(0.587) * g + _F(0.114) * b - _F(128)
    quad = p[:, 0::2, 0::2] + p[:, 0::2, 1::2] + p[:, 1::2, 0::2] \
        + p[:, 1::2, 1::2]
    r4, g4, b4 = (quad[..., c].astype(_F) * _F(0.25) for c in range(3))
    cb = _F(-0.168736) * r4 - _F(0.331264) * g4 + _F(0.5) * b4
    cr = _F(0.5) * r4 - _F(0.418688) * g4 - _F(0.081312) * b4
    mh, mw = g_h // 16, g_w // 16
    # (F, mh, mw, 6, 8, 8): Y0, Y1, Y2, Y3, Cb, Cr of each MCU.
    yb = y.reshape(F, mh, 2, 8, mw, 2, 8).transpose(0, 1, 4, 2, 5, 3, 6)
    blocks = np.concatenate([
        yb.reshape(F, mh, mw, 4, 8, 8),
        cb.reshape(F, mh, 8, mw, 8).transpose(0, 1, 3, 2, 4)[:, :, :, None],
        cr.reshape(F, mh, 8, mw, 8).transpose(0, 1, 3, 2, 4)[:, :, :, None],
    ], axis=3).reshape(F, -1, 8, 8)
    rowsd = _dct1d([blocks[..., k] for k in range(8)])
    blocks = np.stack(rowsd, axis=-1)
    cold = _dct1d([blocks[..., k, :] for k in range(8)])
    blocks = np.stack(cold, axis=-2).reshape(F, -1, 6, 64)
    rq = np.concatenate([np.repeat(t.rq[:1], 4, 0), np.repeat(t.rq[1:], 2, 0)])
    q = np.rint(blocks * rq).astype(np.int32).astype(np.int16)
    return q.reshape(F, -1, 64)[..., ZIGZAG]


def _bitlen(v):
    a = np.abs(v.astype(np.int64))
    n = np.zeros(a.shape, np.int64)
    while a.any():
        n += a > 0
        a >>= 1
    return n


def _dc_diff(coef):
    """(F, nblk) DC differences against the previous block of each
    component in MCU order (0 before the first)."""
    dc = coef[..., 0].astype(np.int64)
    F, n = dc.shape
    i = np.arange(n)
    prev = np.where(i % 6 == 0, i - 3, np.where(i % 6 < 4, i - 1, i - 6))
    pred = np.where(prev >= 0, dc[:, np.maximum(prev, 0)], 0)
    return dc - pred


def _fields(coef, t: Tables):
    """Every block's bit fields in stream order: (F, nblk, 64 * 5) values
    and lengths (0 = no field): the DC code and value, then for each AC
    position up to three ZRLs, its code and its value, and the EOB in the
    last slot."""
    F, n, _ = coef.shape
    chroma = (np.arange(n) % 6 >= 4)[None, :]
    z = coef.astype(np.int64)
    val = np.zeros((F, n, 64, 5), np.int64)
    ln = np.zeros((F, n, 64, 5), np.int64)
    # DC: code and value bits.
    diff = _dc_diff(coef)
    s = _bitlen(diff)
    dc = np.where(chroma, t.dc[1][np.minimum(s, 15)], t.dc[0][np.minimum(s, 15)])
    val[:, :, 0, 3], ln[:, :, 0, 3] = dc & 0xFFFF, dc >> 16
    val[:, :, 0, 4] = np.where(diff < 0, diff + (1 << s) - 1, diff)
    ln[:, :, 0, 4] = s
    # AC: the run of zeros since the previous nonzero coefficient.
    k = np.arange(64)
    nz = (z != 0) & (k > 0)
    last = np.maximum.accumulate(np.where(nz, k, 0), axis=-1)
    prev = np.concatenate([np.zeros_like(last[..., :1]), last[..., :-1]], -1)
    run = k - prev - 1
    sz = _bitlen(z)
    ac = np.stack([t.ac[0], t.ac[1]])[chroma.astype(int)[..., None],
                                      ((run & 15) << 4 | sz) & 255]
    zrl = np.where(chroma, t.ac[1][0xF0], t.ac[0][0xF0])[..., None]
    for j in range(3):
        on = nz & (run >> 4 > j)
        val[..., j] = np.where(on, zrl & 0xFFFF, 0)
        ln[..., j] = np.where(on, zrl >> 16, 0)
    val[..., 1:, 3] = np.where(nz, ac & 0xFFFF, 0)[..., 1:]
    ln[..., 1:, 3] = np.where(nz, ac >> 16, 0)[..., 1:]
    val[..., 1:, 4] = np.where(nz, np.where(z < 0, z + (1 << sz) - 1, z),
                               0)[..., 1:]
    ln[..., 1:, 4] = np.where(nz, sz, 0)[..., 1:]
    # EOB after trailing zeros, in the last position's first ZRL slot
    # (which it cannot otherwise hold: z[63] is zero there).
    eob = np.where(chroma, t.ac[1][0], t.ac[0][0])
    tail = z[..., 63] == 0
    val[..., 63, 0] = np.where(tail, eob & 0xFFFF, val[..., 63, 0])
    ln[..., 63, 0] = np.where(tail, eob >> 16, ln[..., 63, 0])
    return val.reshape(F, n, -1), ln.reshape(F, n, -1)


def encode_plain(frames, width: int, height: int, quality: int = 92):
    """The twin of the kernels: one JPEG (bytes) a frame, through the same
    stages: coefficients, per-block bit counts, their offsets, the bits
    packed at them, the 1s pad, the byte stuffing."""
    t = tables(quality)
    px = _pixels(frames, width, height)
    coef = coefficients_plain(px, t)
    val, ln = _fields(coef, t)
    bits = ln.sum(-1)
    offsets = np.cumsum(bits, axis=1) - bits
    hdr = header(width, height, quality)
    out = []
    for f in range(px.shape[0]):
        total = int(bits[f].sum())
        pad = -total % 8
        stream = np.ones(total + pad, np.uint8)
        # Each field's bits at its block's offset plus the fields before it.
        v, n = val[f].ravel(), ln[f].ravel()
        start = (offsets[f][:, None] + np.cumsum(ln[f], -1) - ln[f]).ravel()
        which = np.repeat(np.arange(n.size), n)
        first = start[which]
        pos = np.arange(total) - np.repeat(np.cumsum(n) - n, n)
        stream[first + pos] = (v[which] >> (n[which] - 1 - pos)) & 1
        data = np.packbits(stream)
        ff = data == 0xFF
        at = np.arange(data.size) + np.cumsum(ff) - ff
        stuffed = np.zeros(data.size + int(ff.sum()), np.uint8)
        stuffed[at] = data
        out.append(hdr + stuffed.tobytes() + b"\xff\xd9")
    return out


# -- the kernels ---------------------------------------------------------------

CHUNKS = 64   # CTAs a frame in the stuffing passes (read when scratch is made)

# Launches of csrc/jpeg.cu's kernels since the last reset_launch_counts();
# the wrapper adds one a kernel where it launches the group and nowhere else.
LAUNCHES = {"dct": 0, "scan": 0, "pack": 0, "ffcount": 0, "layout": 0,
            "stuff": 0}

_lib = None
_lib_lock = threading.Lock()


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build_kernels(force: bool = False):
    """Compile csrc/jpeg.cu into build/libjpeg.so (nvcc, sm_90a) unless an
    up-to-date library exists. Raises ``RuntimeError`` with nvcc's output."""
    return cuda_build.build("jpeg.cu", force=force)


class _JpegParams(ctypes.Structure):
    """Mirror of ``struct JpegParams`` in csrc/jpeg.cu (field order and
    types must match)."""

    _fields_ = [(name, ctypes.c_longlong) for name in (
        "frame_stride", "word_cap", "out_cap")] + [
        (name, ctypes.c_int) for name in (
            "row_stride", "width", "height", "frames", "mcu_w", "mcu_h",
            "nblk", "hdr_len", "chunks")]


def bind(lib):
    """Set the C entry points' argument and result types on a loaded
    ``jpeg.cu`` library -> the library."""
    vp = ctypes.c_void_p
    lib.jpeg_encode_group.restype = ctypes.c_int
    lib.jpeg_encode_group.argtypes = [vp] * 11 + [
        ctypes.POINTER(_JpegParams), vp]
    lib.jpeg_error_string.restype = ctypes.c_char_p
    lib.jpeg_error_string.argtypes = [ctypes.c_int]
    return lib


def _load_lib():
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = bind(ctypes.CDLL(str(build_kernels())))
    return _lib


def _layout(frames):
    """(row stride, frame stride) in pixels of a frame group in either
    layout, or ValueError."""
    if frames.dtype == torch.int32 and frames.dim() == 3:
        return frames.shape[2], frames.shape[1] * frames.shape[2]
    if (frames.dtype == torch.uint8 and frames.dim() == 4
            and frames.shape[3] == 4):
        return frames.shape[2], frames.shape[1] * frames.shape[2]
    raise ValueError(f"expected (F, rows, stride) int32 or (F, H, W, 4) uint8 "
                     f"frames, got {frames.dtype} {tuple(frames.shape)}")


class Encoder:
    """Encodes groups of up to ``frame_batch`` frames of one size and
    quality, and holds the kernels' scratch (about 700 bytes an 8x8 block:
    100 MB for 16 1080p frames), made on the first group's device.

    :meth:`encode` returns frame f's JPEG as ``out[offsets[f]:offsets[f +
    1]]``; on a CUDA device both stay on it, queued on the current stream.
    """

    def __init__(self, frame_batch: int, width: int, height: int,
                 quality: int = JPEG_QUALITY):
        self.geom = Geometry(width, height, quality)
        self.quality = int(quality)
        self.frame_batch = int(frame_batch)
        self._scratch = None

    def out_bytes(self, frames: int) -> int:
        """Bytes of an output buffer that holds any ``frames`` frames."""
        return frames * self.geom.out_cap

    def scratch(self, dev) -> dict:
        """The kernels' tables and scratch on ``dev`` (made once)."""
        if self._scratch is None:
            g, F = self.geom, self.frame_batch
            blob = tables(self.quality).blob()
            self._scratch = {
                "tables": torch.from_numpy(blob).to(dev),
                "hdr": torch.tensor(list(g.hdr), dtype=torch.uint8,
                                    device=dev),
                "coef": torch.empty((F, g.nblk, 64), dtype=torch.int16,
                                    device=dev),
                "dc": torch.empty((F, g.nblk), dtype=torch.int32, device=dev),
                "acbits": torch.empty((F, g.nblk), dtype=torch.int32,
                                      device=dev),
                "words": torch.empty((F, g.word_cap), dtype=torch.int32,
                                     device=dev),
                "ffcnt": torch.empty((F, CHUNKS), dtype=torch.int32,
                                     device=dev),
                "fstat": torch.empty((F, 4), dtype=torch.int64, device=dev)}
        return self._scratch

    def encode(self, frames, out=None):
        """-> (offsets (F + 1) int64, out uint8) of the group ``frames``
        (either layout). ``out`` may be a buffer of at least
        :meth:`out_bytes` bytes on the frames' device. The kernels run on
        CUDA tensors (six launches); other tensors raise ``ValueError``."""
        g = self.geom
        F = frames.shape[0]
        if not 0 < F <= self.frame_batch:
            raise ValueError(f"a group of {F} frames; this encoder takes 1 "
                             f"to {self.frame_batch}")
        row_stride, frame_stride = _layout(frames)
        if frames.shape[1] < g.height or row_stride < g.width:
            raise ValueError(f"frames {tuple(frames.shape)} do not hold "
                             f"{g.height}x{g.width}")
        frames = frames.contiguous()
        cuda_build.check_cuda({"frames": frames}, {"frames": frames.dtype},
                              {"frames": frames.shape})
        if out is None:
            out = torch.empty(self.out_bytes(F), dtype=torch.uint8,
                              device=frames.device)
        if out.numel() < self.out_bytes(F) or out.device != frames.device:
            raise ValueError(f"out must hold {self.out_bytes(F)} bytes on "
                             f"{frames.device}")
        offsets = torch.empty(F + 1, dtype=torch.int64, device=frames.device)
        s = self.scratch(frames.device)
        ptrs = [frames, s["tables"], s["hdr"], s["coef"], s["dc"],
                s["acbits"], s["words"], s["ffcnt"], s["fstat"], offsets, out]
        params = _JpegParams(
            frame_stride=frame_stride, word_cap=g.word_cap,
            out_cap=out.numel(), row_stride=row_stride, width=g.width,
            height=g.height, frames=F, mcu_w=g.mcu_w, mcu_h=g.mcu_h,
            nblk=g.nblk, hdr_len=len(g.hdr), chunks=s["ffcnt"].shape[1])
        lib = _load_lib()
        stream = torch.cuda.current_stream(frames.device).cuda_stream
        err = lib.jpeg_encode_group(
            *[ctypes.c_void_p(t.data_ptr()) for t in ptrs],
            ctypes.byref(params), ctypes.c_void_p(stream))
        if err != 0:
            raise RuntimeError(f"jpeg_encode_group launch failed: "
                               f"{lib.jpeg_error_string(err).decode()}")
        for k in LAUNCHES:
            LAUNCHES[k] += 1
        profiling.count("jpeg.frames", F)
        return offsets, out

