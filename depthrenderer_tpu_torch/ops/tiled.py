"""What the tiled rasteriser's two routes share: the plane tables and their
windows, the pixel x triangle pass and the tile shade.

Both routes (``raster_pallas`` and ``raster_grid``) turn a frame group into
its frames' plane tables, ``(F, 12, N)`` for cov and attr, and per tile the
table columns of its windows: ``origin`` (int64, the frame's offset
``f * 12 * N`` folded in) and the route's ``rel`` (chunks, TC) relative
columns (-1 = padding). :func:`raster_pairs` runs the pixel x triangle pass
on them and :func:`shade_tiles` shades the merged tile rows.
:func:`raster_pairs` is one hand-written CUDA kernel (``csrc/pair.cu``, the
TPU ``raster_pallas._pair_kernel``, built with nvcc on first use) that reads
each window's chunks straight from the tables, with a plain PyTorch twin,
:func:`raster_pairs_plain`, on ``(chunks, 12, TC)`` window copies
(:func:`gather_tables`, the TPU kernel's own input layout); the wrapper
runs gather and twin for CPU tensors and launches the kernel, or raises,
for CUDA tensors.
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

# Device bytes a frame group's plane tables (cov + attr) may take: 32 GiB of
# the H100's 80 GB, two frames' tables at d13 (~12 GiB each) beside one
# frame's plane build, the tile rows and the shade; at d10 (0.2 GB a frame)
# it never binds. The group size changes no pixel.
COEFF_BUDGET = 32 << 30


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


def new_tables(vg, frames=None):
    """Empty ``(cov, attr)`` plane tables of a padded grid ``vg`` (8, ..., R,
    C): each (12, N) float32, or (frames, 12, N), N = 2 * cells + 1."""
    n = 2 * (vg.shape[-2] - 1) * (vg.shape[-1] - 1) + 1
    shape = (12, n) if frames is None else (frames, 12, n)
    return tuple(torch.empty(shape, dtype=_F32, device=vg.device)
                 for _ in range(2))


def write_planes(table, diag, planes, cell0=0):
    """One diagonal class's (12, ..., rows, cells_c) planes of the cells
    from ``cell0`` on (row-major) into the (..., 12, N) table's columns
    ``2 * cell + diag``."""
    cells = planes.shape[-2] * planes.shape[-1]
    lead = table.shape[:-2]
    table[..., 2 * cell0 + diag:2 * (cell0 + cells):2] = planes.reshape(
        (12,) + lead + (cells,)).movedim(0, -2)


def write_padding(cov, attr, never_cov):
    """The tables' last column: the padding plane (``never_cov``, 12
    floats; attr zeros)."""
    cov[..., -1] = torch.as_tensor(never_cov, dtype=_F32, device=cov.device)
    attr[..., -1] = 0.0


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

    ``frame_part(f)`` gives frame ``f``'s :func:`gather_windows` part; its
    windows are gathered into the output before the next frame's part is
    taken."""
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


def gather_tables(cov, attr, origin, rel, ntiles: int):
    """Window copies of a frame group's tables, the plain twin's input ->
    ``(cov, attr)``, each (ntiles, wpt * chunks, 12, TC): tile ``t``'s
    windows ``origin[t * wpt:(t + 1) * wpt]`` one after another.

    :param cov, attr: (F, 12, N) plane tables (each frame's last column the
        padding plane).
    :param origin: (ntiles * wpt,) int64 table columns of the windows' first
        cells with the frame offsets ``f * 12 * N`` folded in; frame-major,
        the same count for every frame.
    :param rel: (chunks, TC) relative columns, -1 = padding.
    """
    frames, _, n = cov.shape
    per = origin.numel() // max(frames, 1)
    win = gather_frames(lambda f: (cov[f], attr[f],
                                   origin[f * per:(f + 1) * per] - f * 12 * n,
                                   rel.long()), frames)
    return tuple(w.reshape((ntiles, -1) + w.shape[2:]) for w in win)


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

    _fields_ = [("nstride", ctypes.c_longlong)] + [
        (name, ctypes.c_int) for name in (
            "ntiles", "wpt", "nch", "tc", "tile_h", "tile_w", "height")]


def _load_lib():
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = bind(ctypes.CDLL(str(build_kernels())))
    return _lib


def bind(lib):
    """Set the C entry points' argument and result types on a loaded
    ``pair.cu`` library -> the library."""
    vp = ctypes.c_void_p
    lib.pair_raster.restype = ctypes.c_int
    lib.pair_raster.argtypes = [vp] * 9 + [ctypes.POINTER(_PairParams), vp]
    lib.pair_threads.restype = ctypes.c_int
    lib.pair_threads.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.pair_error_string.restype = ctypes.c_char_p
    lib.pair_error_string.argtypes = [ctypes.c_int]
    return lib


def raster_pairs(cov, attr, origin, rel, px0, py0, jlo, jhi, height,
                 config: RasterConfig):
    """Stream the pixel x triangle work of every tile -> (ntiles, P, 8)
    float32 rows (u, v, z_model, coverage, best z, min-λ, 0, 0).

    :param cov, attr: (F, 12, N) float32 plane tables of the frame group.
    :param origin: (ntiles * wpt,) int64 window origins (see
        :func:`gather_tables`); tile ``t``'s chunk ``j`` is window
        ``j // chunks``, relative row ``j % chunks``.
    :param rel: (chunks, TC) int32 relative columns, -1 = padding.
    :param px0, py0, jlo, jhi: (ntiles,) int32 tile origins and active
        chunk ranges.

    CPU tensors: :func:`gather_tables` and :func:`raster_pairs_plain`; CUDA
    tensors: the ``pairs`` kernel (one launch), or an exception.
    """
    tensors = {"cov": cov, "attr": attr, "origin": origin, "rel": rel,
               "px0": px0, "py0": py0, "jlo": jlo, "jhi": jhi}
    n = px0.shape[0]
    if cuda_build.on_cpu(*tensors.values()):
        return raster_pairs_plain(*gather_tables(cov, attr, origin, rel, n),
                                  px0, py0, jlo, jhi, height, config)
    lib = _load_lib()
    if lib.pair_threads(config.tile_h, config.tile_w) == 0:
        raise ValueError(f"the pair kernel takes tiles of at most 1024 "
                         f"pixels, 8 rows of 128-column segments, got "
                         f"{config.tile_h}x{config.tile_w}")
    P = config.tile_h * config.tile_w
    nch, tc = rel.shape
    wpt = origin.shape[0] // max(n, 1)
    cuda_build.check_cuda(
        tensors,
        {"cov": _F32, "attr": _F32, "origin": torch.int64, "rel": _I32,
         "px0": _I32, "py0": _I32, "jlo": _I32, "jhi": _I32},
        {"cov": (cov.shape[0], 12, cov.shape[2]), "attr": cov.shape,
         "origin": (n * wpt,), "rel": (nch, tc), "px0": (n,), "py0": (n,),
         "jlo": (n,), "jhi": (n,)})
    out = torch.empty((n, P, 8), dtype=_F32, device=cov.device)
    params = _PairParams(nstride=cov.shape[2], ntiles=n, wpt=max(wpt, 1),
                         nch=nch, tc=tc, tile_h=config.tile_h,
                         tile_w=config.tile_w, height=height)
    stream = torch.cuda.current_stream(cov.device).cuda_stream
    ptrs = [t.data_ptr() for t in tensors.values()] + [out.data_ptr()]
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
    """(F, ntiles, P, 8) merged tile rows -> (F, height, width, 4) uint8;
    in ``texture_z`` mode also the (F, height, width) float32 NDC depth of
    each pixel's winner (``FAR_SENTINEL`` where nothing covers it)."""
    th, tw = config.tile_h, config.tile_w
    ntr, ntc = -(-height // th), -(-width // tw)
    F = tiles.shape[0]
    full = (tiles[..., :6].reshape(F, ntr, ntc, th, tw, 6)
            .permute(0, 1, 3, 2, 4, 5)
            .reshape(F, ntr * th, ntc * tw, 6)[:, :height, :width])
    rgba = common.shade(full[..., 3] > 0.5, full[..., 0], full[..., 1],
                        full[..., 2], texture,
                        "texture" if mode == "texture_z" else mode,
                        min_lam=full[..., 5])
    if mode == "texture_z":
        return rgba, full[..., 4]
    return rgba
