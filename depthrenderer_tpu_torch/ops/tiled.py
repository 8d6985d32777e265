"""What the tiled rasteriser's two routes share: the window gather, the pixel
x triangle pass and the tile shade.

Both routes (``raster_pallas`` and ``raster_grid``) turn a frame group into
``(chunks, 12, TC)`` chunk planes per (tile, anchor pass) with
:func:`gather_frames`, run :func:`raster_pairs` on them and shade the merged
tile rows with :func:`shade_tiles`. :func:`raster_pairs` is one hand-written
CUDA kernel (``csrc/pair.cu``, the TPU ``raster_pallas._pair_kernel``, built
with nvcc on first use) with a plain PyTorch twin,
:func:`raster_pairs_plain`; the wrapper runs the twin for CPU tensors and
launches the kernel, or raises, for CUDA tensors.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import common, cuda_build
from .common import RasterConfig

_F32 = torch.float32
_I32 = torch.int32
_FAR = float(common.FAR_SENTINEL)

# Device bytes a frame group's plane tables (cov + attr) may take: a fifth of
# the H100's 80 GB, leaving room for the gather index, the tile outputs and
# the shade. The group size changes no pixel.
COEFF_BUDGET = 16 << 30


# ---------------------------------------------------------------------------
# Windows
# ---------------------------------------------------------------------------

def tile_origins(config: RasterConfig, width, height, device):
    """(px0, py0): (ntiles,) int32 pixel origins of the tiles, row-major."""
    th, tw = config.tile_h, config.tile_w
    ntr, ntc = -(-height // th), -(-width // tw)
    py0 = (torch.arange(ntr, dtype=_I32, device=device) * th
           ).repeat_interleave(ntc)
    px0 = (torch.arange(ntc, dtype=_I32, device=device) * tw).repeat(ntr)
    return px0, py0


def _window_index(origin, never, rel):
    """Source columns (n, chunks, 1, TC) of windows at ``origin`` (n,) int64
    (the column of the window's first cell, diagonal 0); padding slots take
    the column ``never`` (n,)."""
    idx = origin[:, None, None] + rel[None]
    idx = torch.where(rel[None] >= 0, idx, never[:, None, None])
    return idx[:, :, None, :]


def _gather(src, idx, out=None):
    """src (12, N) at idx (n, chunks, 1, TC) -> (n, chunks, 12, TC), into
    ``out`` if given.

    One ``torch.gather`` over stride-0 views: neither the source nor the
    index is copied out to the output's size."""
    n, nch, _, tc = idx.shape
    return torch.gather(src[None, None].expand(n, nch, 12, src.shape[1]), 3,
                        idx.expand(n, nch, 12, tc), out=out)


def gather_windows(part, out=(None, None)):
    """Chunk planes of one frame's windows, in one gather per table.

    :param part: ``(cov_src, attr_src, origin, rel)``: the frame's (12, N)
        plane tables (last column the padding plane), the (n,) int64 table
        column of each window's first cell, and the (chunks, TC) relative
        columns (-1 = padding).
    :param out: tensors to gather ``cov`` and ``attr`` into.
    :return: ``(cov, attr)``, each (n, chunks, 12, TC) float32.
    """
    cov, attr, origin, rel = part
    idx = _window_index(origin, torch.full_like(origin, cov.shape[1] - 1),
                        rel)
    return _gather(cov, idx, out[0]), _gather(attr, idx, out[1])


def gather_frames(frame_part, frames: int):
    """Chunk planes of a frame group's windows, frame after frame ->
    ``(cov, attr)``, each (frames * n, chunks, 12, TC).

    ``frame_part(f)`` builds frame ``f``'s :func:`gather_windows` part; its
    windows are gathered into the group's tables before the next frame's
    part is built, so one frame's full-grid plane tables are resident at a
    time beside the group's windows (which :data:`COEFF_BUDGET` bounds)."""
    cov, attr = gather_windows(frame_part(0))
    if frames == 1:
        return cov, attr
    n = cov.shape[0]
    out = tuple(t.new_empty((frames * n,) + t.shape[1:]) for t in (cov, attr))
    out[0][:n], out[1][:n] = cov, attr
    del cov, attr
    for f in range(1, frames):
        gather_windows(frame_part(f), (out[0][f * n:(f + 1) * n],
                                       out[1][f * n:(f + 1) * n]))
    return out


def active_pairs(jlo, jhi, tc: int, tile_pixels: int) -> int:
    """Pixel x triangle pairs the kernel evaluates for these ranges."""
    return int((jhi.long() - jlo.long()).sum()) * tc * tile_pixels


# ---------------------------------------------------------------------------
# Pairs: the plain twin and the CUDA kernel (csrc/pair.cu)
# ---------------------------------------------------------------------------

_TILE_SLICE = 64  # tiles per vectorised step of the plain twin


def _pixel_centres(px0, py0, height, config: RasterConfig):
    """(n, P) window-coordinate pixel centres of each tile, row-major."""
    tw = config.tile_w
    pix = torch.arange(config.tile_h * tw, device=px0.device)
    col = (pix % tw).to(_F32)
    row = (pix // tw).to(_F32)
    qx = (px0.to(_F32)[:, None] + col) + 0.5
    qy = height - ((py0.to(_F32)[:, None] + row) + 0.5)
    return qx, qy


def _pairs_chunk(cov, attr, qx, qy):
    """One chunk for a slice of tiles: cov, attr (a, 12, TC), qx, qy (a, P)
    -> (chunk_best (a, P), attrs (a, P, 5))."""
    TC = cov.shape[-1]
    qx3, qy3 = qx[:, :, None], qy[:, :, None]

    def plane(k):   # fma(qx, A, qy*B) + C, as XLA rounds the JAX kernel
        return common.fma(qx3, cov[:, None, 3 * k],
                          qy3 * cov[:, None, 3 * k + 1]) + cov[:, None,
                                                               3 * k + 2]

    l0, l1, l2, zz = plane(0), plane(1), plane(2), plane(3)
    covered = (l0 >= 0.0) & (l1 >= 0.0) & (l2 >= 0.0) & (zz >= -1.0) & (
        zz <= 1.0)
    key = torch.where(covered, zz, _FAR)
    chunk_best = key.amin(-1)
    # Lowest triangle id among the minima (first-drawn tie semantics).
    m = (key == chunk_best[..., None]) & covered
    iota = torch.arange(TC, device=cov.device)
    sel = torch.where(m, iota, TC).amin(-1).clamp(max=TC - 1)   # (a, P)
    picked = torch.gather(attr, 2, sel[:, None, :].expand(-1, 12, -1))
    vals = [common.fma(picked[:, 3 * a], qx, picked[:, 3 * a + 1] * qy)
            + picked[:, 3 * a + 2] for a in range(4)]
    minl = torch.gather(torch.minimum(l0, torch.minimum(l1, l2)), 2,
                        sel[..., None])[..., 0]
    return chunk_best, torch.stack(vals + [minl], dim=-1)


def _finish(best_z, best):
    """(n, P) best z and (n, P, 5) winner attributes -> (n, P, 8) rows:
    u, v, z_model, coverage, best z, min-λ, 0, 0."""
    cov_flag = (best_z < _FAR).to(_F32)
    den = best[..., 2]
    den = torch.where(den.abs() > 1e-30, den, torch.ones_like(den))
    zero = torch.zeros_like(best_z)
    return torch.stack([best[..., 0] / den, best[..., 1] / den,
                        best[..., 3] / den, cov_flag, best_z, best[..., 4],
                        zero, zero], dim=-1)


def raster_pairs_plain(cov_planes, attr_planes, px0, py0, jlo, jhi, height,
                       config: RasterConfig):
    """The pair kernel's function in PyTorch ops, vectorised over tiles and
    pixels, looped over chunks (each chunk on the tiles whose active range
    holds it), in the kernel's float order: planes and attributes are
    ``fma(qx, A, qy*B) + C``, as XLA's CPU backend contracts the JAX kernel's
    ``qx*A + qy*B + C`` (the kernel uses ``fmaf``).

    :param cov_planes, attr_planes: (ntiles, nchunks, 12, TC) float32.
    :param px0, py0, jlo, jhi: (ntiles,) int32.
    :return: (ntiles, tile_h * tile_w, 8) float32 rows.
    """
    n = cov_planes.shape[0]
    P = config.tile_h * config.tile_w
    dev = cov_planes.device
    best_z = torch.full((n, P), _FAR, dtype=_F32, device=dev)
    best = torch.zeros((n, P, 5), dtype=_F32, device=dev)
    if n:
        qx_all, qy_all = _pixel_centres(px0, py0, height, config)
        jlo64, jhi64 = jlo.long(), jhi.long()
        for j in range(int(jlo64.min()), int(jhi64.max())):
            act = torch.nonzero((jlo64 <= j) & (j < jhi64))[:, 0]
            for s in range(0, act.numel(), _TILE_SLICE):
                t = act[s:s + _TILE_SLICE]
                chunk_best, vals = _pairs_chunk(
                    cov_planes[t, j], attr_planes[t, j], qx_all[t], qy_all[t])
                better = chunk_best < best_z[t]
                best_z[t] = torch.where(better, chunk_best, best_z[t])
                best[t] = torch.where(better[..., None], vals, best[t])
    return _finish(best_z, best)


_lib = None
_lib_lock = threading.Lock()

# Launches of the pair kernel since the last reset_launch_counts(); the
# wrapper adds one where it launches the kernel and nowhere else.
LAUNCHES = {"pairs": 0}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build_kernels(force: bool = False):
    """Compile csrc/pair.cu into build/libpair.so (nvcc, sm_90a) unless an
    up-to-date library exists. Raises ``RuntimeError`` with nvcc's output."""
    return cuda_build.build("pair.cu", force=force)


class _PairParams(ctypes.Structure):
    """Mirror of ``struct PairParams`` in csrc/pair.cu (field order and types
    must match)."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "ntiles", "nchunks", "tc", "tile_h", "tile_w", "height")]


def _load_lib():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_kernels()))
            vp = ctypes.c_void_p
            lib.pair_raster.restype = ctypes.c_int
            lib.pair_raster.argtypes = [vp] * 7 + [
                ctypes.POINTER(_PairParams), vp]
            lib.pair_error_string.restype = ctypes.c_char_p
            lib.pair_error_string.argtypes = [ctypes.c_int]
            _lib = lib
    return _lib


def raster_pairs(cov_planes, attr_planes, px0, py0, jlo, jhi, height,
                 config: RasterConfig):
    """Stream the pixel x triangle work of every tile -> (ntiles, P, 8)
    float32 rows (u, v, z_model, coverage, best z, min-λ, 0, 0).

    CPU tensors: :func:`raster_pairs_plain`; CUDA tensors: the ``pairs``
    kernel (one launch), or an exception.
    """
    if cuda_build.on_cpu(cov_planes, attr_planes, px0, py0, jlo, jhi):
        return raster_pairs_plain(cov_planes, attr_planes, px0, py0, jlo, jhi,
                                  height, config)
    n, nch, _, tc = cov_planes.shape
    P = config.tile_h * config.tile_w
    if P > 1024:
        raise ValueError(f"the pair kernel takes tiles of at most 1024 "
                         f"pixels, got {config.tile_h}x{config.tile_w}")
    cuda_build.check_cuda(
        {"cov_planes": cov_planes, "attr_planes": attr_planes, "px0": px0,
         "py0": py0, "jlo": jlo, "jhi": jhi},
        {"cov_planes": _F32, "attr_planes": _F32, "px0": _I32, "py0": _I32,
         "jlo": _I32, "jhi": _I32},
        {"cov_planes": (n, nch, 12, tc), "attr_planes": (n, nch, 12, tc),
         "px0": (n,), "py0": (n,), "jlo": (n,), "jhi": (n,)})
    out = torch.empty((n, P, 8), dtype=_F32, device=cov_planes.device)
    params = _PairParams(ntiles=n, nchunks=nch, tc=tc, tile_h=config.tile_h,
                         tile_w=config.tile_w, height=height)
    lib = _load_lib()
    stream = torch.cuda.current_stream(cov_planes.device).cuda_stream
    ptrs = [t.data_ptr() for t in (cov_planes, attr_planes, px0, py0, jlo,
                                    jhi, out)]
    err = lib.pair_raster(*[ctypes.c_void_p(p) for p in ptrs],
                          ctypes.byref(params), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"pair_raster launch failed: "
                           f"{lib.pair_error_string(err).decode()}")
    LAUNCHES["pairs"] += 1
    return out


# ---------------------------------------------------------------------------
# Shade
# ---------------------------------------------------------------------------

def shade_tiles(tiles, texture, width, height, config: RasterConfig,
                mode: str):
    """(F, ntiles, P, 8) merged tile rows -> (F, height, width, 4) uint8."""
    th, tw = config.tile_h, config.tile_w
    ntr, ntc = -(-height // th), -(-width // tw)
    F = tiles.shape[0]
    full = (tiles[..., :6].reshape(F, ntr, ntc, th, tw, 6)
            .permute(0, 1, 3, 2, 4, 5)
            .reshape(F, ntr * th, ntc * tw, 6)[:, :height, :width])
    return common.shade(full[..., 3] > 0.5, full[..., 0], full[..., 1],
                        full[..., 2], texture, mode, min_lam=full[..., 5])
