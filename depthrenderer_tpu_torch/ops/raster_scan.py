"""The column-crossing scan rasteriser for grid meshes, on PyTorch and CUDA.

Counterpart of ``depthrenderer_tpu/ops/raster_scan.py`` (the standard and
``big_grid`` variants, in-kernel edge culling, ``texture``/``debug_z``/
``wireframe``/``texture_z`` modes, raw packed-RGBA output, and the fidelity
tiers built on it). For each pixel it finds the grid cell whose projected
micro-triangle covers it:

1. **prep** (:func:`prep_scan`, plain PyTorch): project the grid, then derive
   the per-(band, 128-column chunk) row window and scan rows ``bounds``, the
   per-block march anchors ``canch`` and the narrow-march offsets ``mid``.
   The standard variant shares one window origin ``w0`` per band (``bounds``
   = ``kb | ke << 12 | multi << 24``); ``big_grid`` (d11/d12) gives every
   chunk its own (``bounds`` = ``w0c / 8 | kb << 10 | ke << 19 | multi <<
   28``, ``w0`` zero, ``mid`` -1). Its integers equal the JAX package's
   exactly.
2. **solve** (:func:`solve_records`): per (band, scanline, grid column), the
   first ``nbr`` rows where the column polyline crosses the scanline become
   records: crossing x and z, bracket row, and ``sr`` strip rows of
   (sx, sy, z), with ``dual_col`` also the right column's (sx, sy, z) at the
   same rows. ``big_grid`` records hold global bracket rows.
3. **march** (:func:`march_exact`): per pixel, the march picks the records
   whose crossing pair brackets the pixel (top ``hyps`` by crossing depth),
   the exact edge tests run on the strip cells, and the colfix fan re-tests
   every scanned row around each slot's top-1 column where the block still
   has holes (at K >= 2 the inner fan first, then the outer cells where
   holes remain). Depth ties go to the lowest triangle id. ``big_grid``
   marches the whole 128-aligned fetch window; a window of 4 or more
   128-column chunks marches chunk by chunk behind the JAX kernel's block
   gate. ``edge_cull_threshold`` drops cells whose selected triangle's
   corner model-z spread exceeds it; ``wireframe`` keeps the covered pixels
   whose winner's least barycentric weight is within
   ``common.WIREFRAME_EDGE_THRESHOLD``.
4. **shade** (:func:`shade`): bilinear RGBA8 sampling into packed uint32
   pixels, R in the low byte; ``texture_z`` also writes the raster depth.

A ``bflag`` per band (the patch tier's sparse bands) makes all three passes
skip an unflagged band, which shades packed 0 with raster depth FAR.

The fidelity tiers run two passes and merge them by raster depth: the
quality tier (``row_edge``, :func:`render_frames_scan_quality`) adds a full
pass over the transposed problem, the patch tier (``patch``,
:func:`render_frames_scan_patched`) runs that pass only on the bands and
blocks where pass 1 left holes. :func:`tier_configs` derives both passes'
configs.

Each of solve, march and shade is one hand-written CUDA kernel in
``csrc/scan.cu`` (built with nvcc on first use) and has a plain PyTorch twin
(``*_plain``) in this module. A wrapper runs the twin for tensors on the CPU
and launches the kernel, or raises, for tensors on a CUDA device.

What the port drops from the TPU kernel, on purpose (each one a clamp that
exists only to fit the TPU's VMEM windows; the port computes the unclamped
value, and the tests count the pixels where that differs):

* the 64x256 (``tex_rows`` x ``tex_cols``) texture window per 128-pixel
  block: texture taps read the whole texture, clamped to its edge;
* the colfix fan's two-subtable column window (``NS2``): fan columns anywhere
  in the fetch window are tested, and the fan's row bounds are the union over
  every 128-column chunk its corners land in (``big_grid``: each corner's
  cells are also held to its own chunk's rows, as in the JAX kernel);
* the record fetch's two-subtable window, which the JAX kernel uses when the
  fetch window is 4 or more 128-column subtables (``cw = 384``: the
  transposed tier pass at 1080p; ``big_grid`` at d11/d12): every fetch reads
  its own column;
* the ``big_grid`` colfix fan's ``rmax``-row window at a shared origin
  ``g0``: rows past ``g0 + rmax`` are tested, and the window's last row's
  bottom corners are its true next row, not a re-read of its last 8-row
  block's first;
* the ``pack_xy`` 16+16-bit strip coding: strips are stored as float32.
  ``ScanConfig.pack_xy`` is accepted and has no effect.

The TPU layout machinery has no counterpart: window double buffers, 8-row
aligned loads, the sublane-major curve, subtable gather chains,
``bands_per_step``, ``mxu_march`` and profiling phases. Narrow and wide
marches follow the JAX kernel's per-block choice exactly.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from . import common, cuda_build

_FAR = float(common.FAR_SENTINEL)
_NOBASE = -1.0e9  # bracket-row sentinel of an empty record slot
_F32 = torch.float32
_I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class ScanConfig:
    """Static configuration of the scan rasteriser; the JAX package's
    ``ScanConfig`` field for field, with the same checks.

    :param rmax: grid rows in a band's window.
    :param cw: march window width in grid columns (multiple of 128).
    :param sr: strip rows per record; cells tested per record = sr - 1.
    :param off: strip start offset above the bracket row.
    :param nbr: crossing slots kept per (pixel row, column).
    :param hyps: march hypotheses kept per slot (1 or 2).
    :param margin: hull margin in grid rows.
    :param dmax: cap on the neighbour-strip realign delta (None = sr - 1).
    :param colfix: half-width K of the colfix fan (None = off).
    :param pack_xy: accepted for config parity; the port stores float32
        strips, so it has no effect.

    :param dual_col: records carry their right column's corners.
    :param row_edge: the quality tier (a transposed second pass).
    :param patch: the patch tier (a sparse transposed second pass).

    :param big_grid: the large-grid variant (d11/d12): a row window per
        128-column chunk, global bracket rows.
    :param edge_cull_threshold: cull cells whose selected triangle's corner
        model-z spread exceeds this (None = off).

    ``mxu_march`` and ``tex_rows``/``tex_cols`` are kept so a JAX config
    converts one to one; the port raises ``NotImplementedError`` for
    ``mxu_march``.
    """

    rmax: int = 320
    cw: int = 256
    sr: int = 12
    off: int = 5
    nbr: int = 2
    hyps: int = 2
    margin: int = 10
    dmax: int | None = None
    edge_cull_threshold: float | None = None
    big_grid: bool = False
    pack_xy: bool = False
    dual_col: bool = False
    row_edge: bool = False
    patch: bool = False
    mxu_march: bool = False
    colfix: int | None = None
    tex_rows: int = 128
    tex_cols: int = 384

    def __post_init__(self):
        assert self.cw % 128 == 0 and self.cw >= 128
        assert 0 < self.off < self.sr
        assert 1 <= self.nbr <= 4
        assert self.hyps in (1, 2)
        assert self.rmax % 8 == 0
        assert self.rmax < (512 if self.big_grid else 4096)
        assert self.tex_rows % 8 == 0 and self.tex_cols % 128 == 0
        assert self.dmax is None or 1 <= self.dmax <= self.sr - 1
        assert not (self.pack_xy and self.big_grid)
        assert not (self.dual_col and self.big_grid)
        assert not (self.row_edge and self.big_grid)
        assert not (self.patch and self.big_grid)
        assert not (self.patch and self.row_edge)
        assert not (self.mxu_march and (self.big_grid or self.hyps != 1
                                        or self.cw > 256))
        assert self.colfix is None or (
            not self.mxu_march and 0 <= self.colfix <= 3)

    @property
    def nrec(self) -> int:
        """float32 record planes per slot: sxc, zc, basew + sr strip rows of
        (sx, sy, z), and with ``dual_col`` the right column's (sx, sy, z)
        after each row's own."""
        return 3 + self.per_row * self.sr

    @property
    def per_row(self) -> int:
        """Record planes per strip row."""
        return 6 if self.dual_col else 3


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _vmem_budget_ok(grid_n: int, cfg: ScanConfig) -> bool:
    """The JAX package's variant switch (its TPU VMEM budget), kept so that
    :func:`suggest_scan_config` picks the same config as the reference."""
    cl = _ceil_to(grid_n, 128)
    rec_bytes = cfg.nbr * (3 + (2 if cfg.pack_xy else 3)
                           * (2 if cfg.dual_col else 1) * cfg.sr) * 8 * cl * 4
    if cfg.big_grid:
        win_bytes = 3 * cfg.rmax * 128 * 4
        tex_bytes = 2 * cfg.tex_rows * cfg.tex_cols * 4
        return win_bytes + rec_bytes + tex_bytes < 10 * 2**20
    win_bytes = 2 * 3 * cfg.rmax * cl * 4
    curve_bytes = cfg.nbr * 2 * cl * 8 * 4
    return win_bytes + rec_bytes + curve_bytes < 13 * 2**20


def scan_supported(grid_n: int, config: ScanConfig | None = None) -> bool:
    """Whether the scan renders this grid: the JAX package's budget rule, met
    by the standard variant through d10 and by ``big_grid`` through d12
    (4097 vertices a side)."""
    cfg = config if config is not None else suggest_scan_config(grid_n, 1920,
                                                                1080)
    return _vmem_budget_ok(grid_n, cfg)


def suggest_scan_config(grid_n: int, width: int, height: int,
                        quality: bool = False, **overrides) -> ScanConfig:
    """The JAX package's heuristic config for an ``grid_n``-vertex grid,
    line for line (same defaults, same variant switch)."""
    rmax_explicit = "rmax" in overrides
    pack_explicit = "pack_xy" in overrides
    dual_explicit = "dual_col" in overrides
    rowe_explicit = "row_edge" in overrides
    colfix_explicit = "colfix" in overrides
    strips_explicit = {k: k in overrides for k in ("sr", "off", "dmax")}
    if quality:
        overrides.setdefault("row_edge", not overrides.get("big_grid", False))
        overrides.setdefault("dual_col", not overrides.get("big_grid", False))
        overrides.setdefault("sr", 12)
        overrides.setdefault("off", 5)
        overrides.setdefault("dmax", None)
        overrides.setdefault("hyps", 2)
    rmax = overrides.pop(
        "rmax", min(320, _ceil_to(max(grid_n // 3 + 48, 64), 8)))
    overrides.setdefault("pack_xy", not overrides.get("big_grid", False))
    overrides.setdefault("hyps", 2 if grid_n < 1025 else 1)
    if width > 2048:
        overrides.setdefault("tex_cols", 512)
    else:
        overrides.setdefault("tex_cols", 256)
        overrides.setdefault("tex_rows", 64)
    cells_per_block = int(128 * grid_n / max(width, 1))
    half_need = cells_per_block // 2 + grid_n // 13 + 12
    cw = overrides.pop(
        "cw",
        max(128, min(_ceil_to(2 * half_need + 8, 128), _ceil_to(grid_n, 128))),
    )
    if (not overrides.get("big_grid", False)
            and not overrides.get("mxu_march", False) and cw <= 384):
        overrides.setdefault("colfix", 3 if quality else 1)
    if overrides.get("colfix") is not None and not quality:
        overrides.setdefault("sr", 6)
        overrides.setdefault("off", 2)
        overrides.setdefault("dmax", 4)
    overrides.setdefault("sr", 10)
    overrides.setdefault("off", 4)
    overrides.setdefault("dmax", 5)
    cfg = ScanConfig(rmax=rmax, cw=cw, **overrides)
    if (cfg.dual_col and not dual_explicit and not cfg.big_grid
            and not _vmem_budget_ok(grid_n, cfg)):
        cfg = dataclasses.replace(cfg, dual_col=False)
    if not cfg.big_grid and not _vmem_budget_ok(grid_n, cfg):
        cfg = dataclasses.replace(
            cfg, big_grid=True,
            pack_xy=cfg.pack_xy if pack_explicit else False,
            dual_col=cfg.dual_col if dual_explicit else False,
            row_edge=cfg.row_edge if rowe_explicit else False,
            patch=False,
            colfix=cfg.colfix if colfix_explicit else (3 if quality else 1),
            sr=cfg.sr if (strips_explicit["sr"] or quality) else 10,
            off=cfg.off if (strips_explicit["off"] or quality) else 4,
            dmax=cfg.dmax if (strips_explicit["dmax"] or quality) else 5,
            rmax=cfg.rmax if rmax_explicit else min(cfg.rmax, 320))
    return cfg


def check_supported(config: ScanConfig):
    """Raise ``NotImplementedError`` for a config the port does not run."""
    if config.mxu_march:
        raise NotImplementedError(
            "scan config mxu_march is not ported (ROADMAP.md queue 1 item 4, "
            "'Not ported': measured slower on the TPU, not needed on a GPU)")


# ---------------------------------------------------------------------------
# Geometry of one render call
# ---------------------------------------------------------------------------


class ScanGeometry(NamedTuple):
    """Static sizes shared by prep, the three passes and their kernels."""

    width: int
    height: int
    n_r: int
    n_c: int
    cl: int        # grid columns padded to 128
    rpad: int      # grid rows padded to 8 and to rmax
    nbands: int    # 8-pixel-row bands
    nchunks: int   # 128-column chunks
    nblk: int      # 128-pixel blocks per band
    wl: int        # output width padded to 128
    hpad: int      # output height padded to 8

    @staticmethod
    def of(width, height, n_r, n_c, config: ScanConfig) -> "ScanGeometry":
        cl = _ceil_to(n_c, 128)
        nbands = -(-height // 8)
        return ScanGeometry(
            width=int(width), height=int(height), n_r=int(n_r), n_c=int(n_c),
            cl=cl, rpad=max(_ceil_to(n_r, 8), config.rmax), nbands=nbands,
            nchunks=cl // 128, nblk=-(-width // 128),
            wl=_ceil_to(width, 128), hpad=nbands * 8)


# ---------------------------------------------------------------------------
# Prep (plain PyTorch): projection, hull bands, march anchors
# ---------------------------------------------------------------------------


def pack_texture(texture):
    """(Ht, Wt, 4) texels -> (Ht, Wt) int32 packed RGBA8, R in the low byte
    (texels quantised to 8 bits first)."""
    t8 = common.quantise_texture(texture).to(torch.int64)
    p = t8[..., 0] | (t8[..., 1] << 8) | (t8[..., 2] << 16) | (t8[..., 3] << 24)
    return ((p + 2**31) % 2**32 - 2**31).to(_I32).contiguous()


def _xla_row_mean(x, dim: int):
    """Mean over ``dim`` summed in the order XLA's CPU backend sums it: rows
    fold into windows of 32 (zero-padded half before, half after) summed in
    order, recursively, then one multiply by the float32 reciprocal of the
    count. The march anchors round this mean, so the order is kept."""
    n = x.shape[dim]
    x = x.movedim(dim, 0)
    s = x
    while s.shape[0] > 32:
        m = s.shape[0]
        m2 = _ceil_to(m, 32)
        lo = (m2 - m) // 2
        z = s.new_zeros((m2,) + s.shape[1:])
        z[lo:lo + m] = s
        w = z.reshape((m2 // 32, 32) + s.shape[1:])
        acc = s.new_zeros((m2 // 32,) + s.shape[1:])
        for r in range(32):
            acc = acc + w[:, r]
        s = acc
    acc = s.new_zeros(s.shape[1:])
    for r in range(s.shape[0]):
        acc = acc + s[r]
    return acc * common.const(np.float32(1.0) / np.float32(n), acc)


def _monotone_interp(q, xp, fp):
    """``jnp.interp`` over a curve increasing or decreasing in ``xp``,
    batched over a leading dim: q (T, m), xp (T, n), fp (n,).

    Same search (``jnp.searchsorted``'s binary scan, side='right'), same
    division guard and edge clamps as JAX, so the rounded anchors agree.
    """
    flip = (xp[:, -1] < xp[:, 0])[:, None]
    xp = torch.where(flip, -xp, xp)
    q = torch.where(flip, -q, q)
    n = xp.shape[1]
    low = torch.zeros(q.shape, dtype=torch.int64, device=q.device)
    high = torch.full(q.shape, n, dtype=torch.int64, device=q.device)
    for _ in range(int(np.ceil(np.log2(n + 1)))):
        mid = (low + high) // 2
        go_left = q < torch.gather(xp, 1, mid)
        low, high = torch.where(go_left, low, mid), torch.where(go_left, mid,
                                                                high)
    i = torch.clamp(high, 1, n - 1)
    fpb = fp[None].expand(xp.shape[0], n)
    f_lo = torch.gather(fpb, 1, i - 1)
    df = torch.gather(fpb, 1, i) - f_lo
    x_lo = torch.gather(xp, 1, i - 1)
    dx = torch.gather(xp, 1, i) - x_lo
    delta = q - x_lo
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = dx.abs() <= eps
    f = torch.where(dx0, f_lo, f_lo + (delta / torch.where(
        dx0, torch.ones_like(dx), dx)) * df)
    f = torch.where(q < xp[:, :1], fpb[:, :1], f)
    return torch.where(q > xp[:, -1:], fpb[:, -1:], f)


def _pad_rows(x, rows: int, value):
    """Pad dim 1 of (T, r, ...) to ``rows`` with a constant."""
    extra = rows - x.shape[1]
    if extra <= 0:
        return x
    pad = x.new_full((x.shape[0], extra) + x.shape[2:], value)
    return torch.cat([x, pad], dim=1)


class ScanPrep(NamedTuple):
    """Per-frame inputs of the three passes (leading dim T).

    ``win`` (T, 3, RPAD, CL) projected sx, sy, z, edge-padded; ``w0``
    (T, nbands) the band's window origin in 8-row units (0 in ``big_grid``);
    ``bounds`` (T, nbands * nchunks) each chunk's scan rows [kb, ke) relative
    to its window origin and its multi-crossing bit, packed ``kb | ke << 12 |
    multi << 24`` (standard: the band's window), or ``big_grid``'s ``w0c / 8
    | kb << 10 | ke << 19 | multi << 28`` (the chunk's own window at global
    row ``w0c``; see :func:`unpack_bounds`); ``canch`` (T, nblocks) march
    anchors in 8-column units; ``mid`` (T, nbands * nblocks) narrow-march
    offsets (-1 wide, -2 no candidates; -1 everywhere in ``big_grid``);
    ``overflow_rows`` (T,) hull rows clipped by ``rmax``.
    """

    win: torch.Tensor
    w0: torch.Tensor
    bounds: torch.Tensor
    canch: torch.Tensor
    mid: torch.Tensor
    overflow_rows: torch.Tensor


def prep_scan(mvps, vertex_grid, width: int, height: int,
              config: ScanConfig) -> ScanPrep:
    """Project the grid for each MVP and derive the passes' scalars
    (the JAX package's ``_prep_scan_impl``, batched over frames)."""
    vertex_grid = torch.as_tensor(vertex_grid, dtype=_F32)
    dev = vertex_grid.device
    mvps = torch.as_tensor(mvps, dtype=_F32, device=dev)
    T = mvps.shape[0]
    n_r, n_c = vertex_grid.shape[0], vertex_grid.shape[1]
    g = ScanGeometry.of(width, height, n_r, n_c, config)
    CL, RPAD, nbands, nchunks = g.cl, g.rpad, g.nbands, g.nchunks

    sx, sy, z, inv_w = common.project_vertices(vertex_grid, mvps, width,
                                               height)   # (T, n_r, n_c)
    # Near-plane masking: behind-camera vertices get sy = z = 1e9 (no
    # crossing enters them; every touching cell fails the depth test) and a
    # bounded sx.
    bad = inv_w <= 0.0
    big_f = common.const(1.0e9, sy)
    sy = torch.where(bad, big_f, sy)
    z = torch.where(bad, big_f, z)
    sx = torch.where(bad, torch.clamp(sx, -2.0 * width, 3.0 * width), sx)

    ridx = torch.clamp(torch.arange(RPAD, device=dev), max=n_r - 1)
    cidx = torch.clamp(torch.arange(CL, device=dev), max=n_c - 1)
    win = torch.stack([a[:, ridx][:, :, cidx] for a in (sx, sy, z)], dim=1)

    band = torch.arange(nbands, dtype=_F32, device=dev)
    qy_top = height - (band * 8.0 + 0.5)
    qy_bot = height - (band * 8.0 + 7.5)
    qt4 = qy_top[None, :, None, None]
    qb4 = qy_bot[None, :, None, None]

    # Per-chunk row bounds from the chunk's projected sy extrema, by a
    # two-level (8-row block, then row) first/last-row search.
    syp = sy[:, :, cidx]
    cmin = syp.reshape(T, n_r, nchunks, 128).amin(dim=3)
    cmax = syp.reshape(T, n_r, nchunks, 128).amax(dim=3)
    c_lo = cmin[:, 1:] if n_r > 1 else cmin
    c_hi = cmax[:, :-1] if n_r > 1 else cmax
    big = 1 << 20
    nk = c_lo.shape[1]
    nkb = -(-nk // 8)
    c_lo_p = _pad_rows(c_lo, nkb * 8, 3.0e38)
    c_hi_p = _pad_rows(c_hi, nkb * 8, -3.0e38)
    bl_lo = c_lo_p.reshape(T, nkb, 8, nchunks).amin(dim=2)
    bl_hi = c_hi_p.reshape(T, nkb, 8, nchunks).amax(dim=2)
    bs = torch.arange(nkb, device=dev)[None, None, :, None]
    b0 = torch.where(bl_lo[:, None] <= qt4, bs, big).amin(dim=2)
    b1 = torch.where(bl_hi[:, None] >= qb4, bs, -1).amax(dim=2)

    def rows_of_block(vals, blk):
        """Rows blk*8..blk*8+7 of vals (T, nkb*8, nchunks) per (band, chunk)
        -> (T, nbands, 8, nchunks)."""
        idx = (torch.clamp(blk, 0, nkb - 1)[:, :, None, :] * 8
               + torch.arange(8, device=dev)[None, None, :, None])
        src = vals[:, None].expand(T, nbands, nkb * 8, nchunks)
        return torch.gather(src, 2, idx)

    ri = torch.arange(8, device=dev)[None, None, :, None]
    sat0 = rows_of_block(c_lo_p, b0) <= qt4
    k0 = torch.clamp(b0, 0, nkb - 1) * 8 + torch.where(sat0, ri, big).amin(2)
    k0 = torch.where(b0 >= big, big, k0)
    sat1 = rows_of_block(c_hi_p, b1) >= qb4
    k1 = torch.clamp(b1, 0, nkb - 1) * 8 + torch.where(sat1, ri, -big).amax(2)
    k1 = torch.where(b1 < 0, -1, k1)
    empty = k0 > k1
    r_lo = torch.clamp(k0 - config.margin, 0, max(n_r - 2, 0))
    r_hi = torch.clamp(k1 + config.margin, 0, max(n_r - 2, 0))

    # Scan rows k in [kb, ke) need row k+1; the strip tail needs sr-off-1.
    ke_cap = config.rmax - (config.sr - config.off) - 1

    # Multi-crossing flag per (band, chunk): some up-step (s[k] < qy <=
    # s[k+1]) in an 8-row block overlapping the scan range straddles the band.
    wsy = win[:, 1]
    up = wsy[:, 1:] > wsy[:, :-1]
    up_lo = torch.where(up, wsy[:, :-1], common.const(3.0e38, wsy))
    up_hi = torch.where(up, wsy[:, 1:], common.const(-3.0e38, wsy))
    lo_c = up_lo.reshape(T, RPAD - 1, nchunks, 128).amin(dim=3)
    hi_c = up_hi.reshape(T, RPAD - 1, nchunks, 128).amax(dim=3)
    nb2 = -(-(RPAD - 1) // 8)
    lo_b = _pad_rows(lo_c, nb2 * 8, 3.0e38).reshape(T, nb2, 8, nchunks).amin(2)
    hi_b = _pad_rows(hi_c, nb2 * 8, -3.0e38).reshape(T, nb2, 8, nchunks).amax(2)

    def multi_flag(kb_g, ke_g):
        bs2 = torch.arange(nb2, device=dev)[None, None, :, None]
        cond = ((bs2 * 8 + 7 >= kb_g[:, :, None, :])
                & (bs2 * 8 < ke_g[:, :, None, :])
                & (lo_b[:, None] < qt4) & (hi_b[:, None] >= qb4))
        return cond.any(dim=2).to(torch.int64)

    if config.big_grid:
        # Each chunk's own window, 8-row aligned, starting off + 3 rows above
        # its first hull row; the band-level origin is unused.
        w0c = torch.clamp(r_lo - (config.off + 3), 0,
                          max(RPAD - config.rmax, 0))
        w0c = (w0c // 8) * 8                                 # (T, nb, nch)
        w0 = torch.zeros((T, nbands), dtype=w0c.dtype, device=dev)
    else:
        r_lo_band = torch.where(empty, big, r_lo).amin(dim=2)
        r_lo_band = torch.where(r_lo_band >= big, 0, r_lo_band)
        w0 = torch.clamp(r_lo_band - (config.off + 3), 0,
                         max(RPAD - config.rmax, 0))
        w0 = (w0 // 8) * 8                                   # (T, nbands)
        w0c = w0[:, :, None]
    kb = torch.clamp(r_lo - w0c, 0, ke_cap)
    ke = torch.minimum(r_hi + 1 - w0c,
                       torch.clamp(n_r - 1 - w0c, max=ke_cap))
    ke = torch.maximum(ke, kb)
    kb = torch.where(empty, 0, kb)
    ke = torch.where(empty, 0, ke)
    overflow_rows = torch.where(
        empty, 0, torch.clamp((r_hi + 1 - w0c) - ke_cap, min=0)).sum(dim=(1, 2))
    multi = multi_flag(w0c + kb, w0c + ke)
    if config.big_grid:
        bounds = (w0c // 8) | (kb << 10) | (ke << 19) | (multi << 28)
    else:
        bounds = kb | (ke << 12) | (multi << 24)
    bounds = bounds.to(_I32).reshape(T, -1)

    # March anchors per 128-pixel block from the mean projected column x.
    col_x = _xla_row_mean(sx, dim=1)                         # (T, n_c)
    nblocks = g.nblk
    qx_c = torch.arange(nblocks, dtype=_F32, device=dev) * 128.0 + 64.0
    c0 = _monotone_interp(qx_c[None].expand(T, nblocks).contiguous(), col_x,
                          torch.arange(n_c, dtype=_F32, device=dev))
    canch = torch.clamp(
        torch.round((c0 - config.cw / 2.0) / 8.0).to(torch.int64),
        0, max((CL - config.cw - 128) // 8, 0))

    # Narrow march window per (band, block): candidate pair bases from each
    # column's sx range over the band window (66 px left, 2 px right slack).
    # big_grid always marches wide.
    if config.big_grid or config.cw <= 128:
        mid = torch.full((T, nbands * nblocks), -1, dtype=_I32, device=dev)
    else:
        sxw = win[:, 0]
        nrb = RPAD // 8
        bmin = sxw.reshape(T, nrb, 8, CL).amin(dim=2)
        bmax = sxw.reshape(T, nrb, 8, CL).amax(dim=2)
        nwb = config.rmax // 8
        p = 1 << (max(nwb, 1).bit_length() - 1)
        lmin, lmax = bmin, bmax
        k = 1
        while k < p:
            rep = min(k, nrb)
            smin_k = torch.cat([lmin[:, k:], lmin[:, -1:].expand(T, rep, CL)],
                               dim=1)[:, :nrb]
            smax_k = torch.cat([lmax[:, k:], lmax[:, -1:].expand(T, rep, CL)],
                               dim=1)[:, :nrb]
            lmin = torch.minimum(lmin, smin_k)
            lmax = torch.maximum(lmax, smax_k)
            k *= 2
        a_i = torch.clamp(w0 // 8, 0, nrb - 1)
        b_i = torch.clamp(w0 // 8 + nwb - p, 0, nrb - 1)

        def take(tab, idx):
            return torch.gather(tab, 1, idx[:, :, None].expand(T, nbands, CL))

        smin = torch.minimum(take(lmin, a_i), take(lmin, b_i))  # (T, nb, CL)
        smax = torch.maximum(take(lmax, a_i), take(lmax, b_i))
        pmin = torch.minimum(smin, torch.cat([smin[..., 1:], smin[..., -1:]],
                                             dim=-1))
        pmax = torch.maximum(smax, torch.cat([smax[..., 1:], smax[..., -1:]],
                                             dim=-1))
        bx = torch.arange(nblocks, dtype=_F32, device=dev)[None, None, :, None]
        x0 = bx * 128.0 - 66.0
        x1 = bx * 128.0 + 130.0
        cand = (pmin[:, :, None, :] <= x1) & (pmax[:, :, None, :] >= x0)
        cix = torch.arange(CL, dtype=_I32, device=dev)
        p_lo = torch.where(cand, cix, big).amin(dim=3).to(torch.int64)
        p_hi = torch.where(cand, cix, -1).amax(dim=3).to(torch.int64)
        has = p_hi >= p_lo                                   # (T, nb, nblk)
        canch_m = canch[:, None, :] * 8
        centre = torch.where(has, (p_lo + p_hi) // 2, canch_m + config.cw // 2)
        mid_cols = torch.minimum(
            torch.maximum(((centre - 63) // 8) * 8, canch_m),
            canch_m + config.cw - 128)
        ok = has & (p_lo >= mid_cols) & (p_hi <= mid_cols + 126)
        mid8 = (mid_cols - canch_m) // 8
        mid = torch.where(ok, mid8, torch.where(has, -1, -2)).to(_I32)
        mid = mid.reshape(T, -1)

    return ScanPrep(win.contiguous(), (w0 // 8).to(_I32), bounds,
                    canch.to(_I32), mid.contiguous(),
                    overflow_rows.to(torch.int64))


def unpack_bounds(bounds, w0, g: ScanGeometry, config: ScanConfig):
    """One frame's packed ``bounds`` -> ``(origin, kb, ke, multi)``, each
    (nbands, nchunks) int64: the grid row of each chunk's window row 0 (the
    band's ``w0`` in the standard variant, the chunk's own in ``big_grid``),
    its scan rows [kb, ke) relative to that origin and its multi-crossing
    bit."""
    bnd = bounds.reshape(g.nbands, g.nchunks).to(torch.int64)
    if config.big_grid:
        return ((bnd & 0x3FF) * 8, (bnd >> 10) & 0x1FF, (bnd >> 19) & 0x1FF,
                (bnd >> 28) & 1)
    origin = (w0.to(torch.int64) * 8)[:, None].expand(g.nbands, g.nchunks)
    return origin, bnd & 0xFFF, (bnd >> 12) & 0xFFF, (bnd >> 24) & 1


def minv_rows(mvps) -> np.ndarray:
    """Rows 2 and 3 of each inverse MVP, inverted in host float64 and
    rounded to float32: (T, 8). The passes rebuild 1/w and model z of any
    corner from them."""
    m = np.asarray(torch.as_tensor(mvps).detach().cpu(), np.float64)
    minv = np.linalg.inv(m)
    return np.concatenate([minv[:, 2], minv[:, 3]], axis=1).astype(np.float32)


def check_uv_grid(uv_grid):
    """Require the standard grid parameterisation (u = col/(n_c-1),
    v = 1 - row/(n_r-1)): the passes rebuild UVs analytically."""
    if uv_grid is None:
        return
    uv_grid = torch.as_tensor(uv_grid)
    n_r, n_c = uv_grid.shape[0], uv_grid.shape[1]
    if n_r < 2 or n_c < 2:
        return
    corners = uv_grid[::n_r - 1, ::n_c - 1].detach().cpu().numpy()
    expect = np.array([[[0.0, 1.0], [1.0, 1.0]], [[0.0, 0.0], [1.0, 0.0]]],
                      np.float32)
    if not np.allclose(corners, expect, atol=1e-5):
        raise ValueError(
            "the scan rasteriser requires the standard grid-mesh UV "
            f"parameterisation (corner UVs {expect.tolist()}, got "
            f"{corners.tolist()})")


def raw_rgba(raw, width, height):
    """(T, HPAD, WL) int32 packed RGBA -> (T, H, W, 4) uint8 view on the
    same device (R in the low byte: little-endian bytes are R, G, B, A)."""
    u8 = raw.view(torch.uint8).unflatten(-1, (raw.shape[-1], 4))
    return u8[..., :height, :width, :]


def unpack_raw_frames(raw, width, height):
    """(T, HPAD, WL) int32 packed RGBA -> (T, H, W, 4) uint8 numpy view."""
    raw = np.ascontiguousarray(np.asarray(
        raw.cpu() if isinstance(raw, torch.Tensor) else raw))
    u8 = raw.view(np.uint8).reshape(raw.shape[0], raw.shape[1],
                                    raw.shape[2], 4)
    return u8[:, :height, :width]


# ---------------------------------------------------------------------------
# Constants shared by the plain passes and the kernels
# ---------------------------------------------------------------------------


def _f32(x) -> float:
    return float(np.float32(x))


class _Consts(NamedTuple):
    """Per-call float32 constants, rounded as the JAX kernel rounds them."""

    sxw: float       # f32(2.0 / width): NDC scale of window x
    syw: float       # f32(2.0 / height)
    inv_ncm1: float  # f32(1) / f32(n_c - 1): u step per grid column
    inv_nrm1: float  # f32(1) / f32(n_r - 1): v step per grid row

    @staticmethod
    def of(g: ScanGeometry) -> "_Consts":
        return _Consts(
            sxw=_f32(2.0 / g.width), syw=_f32(2.0 / g.height),
            inv_ncm1=_f32(np.float32(1.0) / np.float32(max(g.n_c - 1, 1))),
            inv_nrm1=_f32(np.float32(1.0) / np.float32(max(g.n_r - 1, 1))))


# ---------------------------------------------------------------------------
# Plain PyTorch passes (the kernels' twins; run on the CPU and on the card)
# ---------------------------------------------------------------------------

_BAND_CHUNK = 8  # bands per vectorised step of the plain passes


def _active_chunks(nbands: int, bflag):
    """The band ranges [b0, b1) the plain passes process: chunks of
    ``_BAND_CHUNK`` bands, without those no flagged band is in."""
    flags = None if bflag is None else bflag.bool().tolist()
    for b0 in range(0, nbands, _BAND_CHUNK):
        b1 = min(b0 + _BAND_CHUNK, nbands)
        if flags is None or any(flags[b0:b1]):
            yield b0, b1


def solve_records_plain(win, w0, bounds, g: ScanGeometry,
                        config: ScanConfig, bflag=None):
    """Column solve for one frame -> records (nbands, nbr, nrec, 8, CL).

    For each (band, scanline y, column c) with chunk bounds [kb, ke): the
    first ``nbr`` rows k (only the first one unless the chunk's multi bit is
    set) with ``sy[k] >= qy > sy[k+1]`` fill slots in row order. Rows count
    from the column's window origin (:func:`unpack_bounds`). A record is
    ``sxc, zc`` (the crossing interpolated at ``frac = (sy[k]-qy) /
    max(sy[k]-sy[k+1], 1e-12)``), the bracket row ``basew`` (``k``, and in
    ``big_grid`` the global row ``k + w0c``) and strip rows
    ``k-off .. k-off+sr-1`` of (sx, sy, z); strip rows above the window read
    0. With ``dual_col`` each strip row also holds the right column's
    (sx, sy, z) at the same window row: column c + 1, and for the last
    column of the table the last chunk's first column (the JAX kernel's
    lane roll within its last chunk; the march masks that column). Empty
    slots hold ``sxc = zc = FAR``, ``basew = -1e9``, zero strips.

    ``bflag`` (nbands,) skips unflagged bands, as the kernel does; their
    records are not defined there and are never read.
    """
    dev = win.device
    SR, OFF, NBR, R = config.sr, config.off, config.nbr, config.rmax
    PR = config.per_row
    CL = g.cl
    rec = torch.zeros((g.nbands, NBR, config.nrec, 8, CL), dtype=_F32,
                      device=dev)
    rec[:, :, 0:2] = _FAR
    rec[:, :, 2] = _NOBASE
    origin, kb_c, ke_c, multi_c = (
        t.repeat_interleave(128, dim=1)                          # (nb, CL)
        for t in unpack_bounds(bounds, w0, g, config))
    # Bracket rows count from the chunk's own window in big_grid.
    kbase = (origin if config.big_grid else torch.zeros_like(origin)).to(_F32)
    kk = torch.arange(R - 1, device=dev)[None, None, :, None]
    yy = torch.arange(8, dtype=_F32, device=dev)
    right = torch.arange(1, CL + 1, device=dev)
    right[-1] = CL - 128
    for b0, b1 in _active_chunks(g.nbands, bflag):
        B = b1 - b0
        rows = (origin[b0:b1, None, :]
                + torch.arange(R, device=dev)[None, :, None])    # (B, R, CL)
        wv = torch.gather(win[:, None].expand(3, B, g.rpad, CL), 2,
                          rows[None].expand(3, B, R, CL))        # (3,B,R,CL)
        if config.dual_col:
            wv = torch.cat([wv, wv[..., right]])                 # (6,B,R,CL)
        bandf = torch.arange(b0, b1, dtype=_F32, device=dev)
        qy = (g.height - (bandf[:, None] * 8.0 + yy[None])) - 0.5  # (B, 8)
        q4 = qy[:, :, None, None]
        s_hi = wv[1][:, None, :-1]
        s_lo = wv[1][:, None, 1:]
        kb = kb_c[b0:b1, None, None]
        ke = ke_c[b0:b1, None, None]
        cross = (s_hi >= q4) & (s_lo < q4) & (kk >= kb) & (kk < ke)
        csum = torch.cumsum(cross.to(torch.int32), dim=2)
        for s in range(NBR):
            fire = cross & (csum == s + 1)
            if s >= 1:
                fire = fire & (multi_c[b0:b1, None, None] == 1)
            has = fire.any(dim=2)                                # (B, 8, CL)
            k = torch.argmax(fire.to(torch.uint8), dim=2)        # (B, 8, CL)

            def at(v, row):
                src = wv[v][:, None].expand(B, 8, R, CL)
                return torch.gather(src, 2, row.clamp(0, R - 1)[:, :, None])[
                    :, :, 0]

            x0, y0, z0 = at(0, k), at(1, k), at(2, k)
            x1, y1, z1 = at(0, k + 1), at(1, k + 1), at(2, k + 1)
            denom = torch.clamp(y0 - y1, min=_f32(1e-12))
            frac = (y0 - qy[:, :, None]) / denom
            sxc = common.fma(x1 - x0, frac, x0)
            zc = common.fma(z1 - z0, frac, z0)
            out = rec[b0:b1, s]                       # (B, nrec, 8, CL) view
            out[:, 0] = torch.where(has, sxc, out[:, 0])
            out[:, 1] = torch.where(has, zc, out[:, 1])
            out[:, 2] = torch.where(has, k.to(_F32) + kbase[b0:b1, None],
                                    out[:, 2])
            for sj in range(SR):
                r = k - OFF + sj
                for v in range(PR):
                    val = torch.where(r >= 0, at(v, r), torch.zeros_like(x0))
                    out[:, 3 + PR * sj + v] = torch.where(
                        has, val, out[:, 3 + PR * sj + v])
    return rec


class _Best(NamedTuple):
    """The division-free winner carry: z numerator, doubled area, triangle
    id, u/w, v/w, 1/w scaled by the area, and the least barycentric weight
    scaled by the area (read by the wireframe mode)."""

    zn: torch.Tensor
    ar: torch.Tensor
    id: torch.Tensor
    uw: torch.Tensor
    vw: torch.Tensor
    iw: torch.Tensor
    ml: torch.Tensor

    def where(self, m, other: "_Best") -> "_Best":
        return _Best(*(torch.where(m, a, b) for a, b in zip(self, other)))


def _model_z(x, y, z, m2, m3, sxw, syw):
    """A corner's model z for the edge cull (the JAX kernel's ``zm_of``): the
    inverse MVP's rows 2 and 3 applied to the corner's NDC, then a divide
    guarded at |1/w| <= 1e-30, with each multiply-add fused as XLA's CPU
    backend fuses it."""
    fma = common.fma
    a = fma(x, sxw, common.const(-1.0, x))
    b = fma(y, syw, common.const(-1.0, y))
    iw = fma(m3[2], z, fma(m3[0], a, m3[1] * b)) + m3[3]
    num = fma(m2[2], z, fma(m2[0], a, m2[1] * b)) + m2[3]
    return num / torch.where(iw.abs() > _f32(1e-30), iw, torch.ones_like(iw))


def _cell_fold(best: _Best, cell_ok, diag_e, top_e, bottom_e, left_e, right_e,
               z00, z10, z01, z11, i00, i10, i01, i11, u0, u1, v_top, v_bot,
               base_id, inv_ncm1, inv_nrm1, zms=None, cull=None) -> _Best:
    """One cell's exact coverage test and winner fold (JAX ``_cell_fold``):
    the diagonal's sign selects one triangle, coverage needs all three edges
    >= 0, area > 1e-12 and the depth in [-1, 1]; the nearer depth wins,
    compared cross-multiplied, ties to the lower triangle id. With ``cull``
    (the edge-cull threshold) the cell also needs its selected triangle's
    corner model-z spread (``zms``: the four corners' :func:`_model_z`) at
    most ``cull``."""
    d = diag_e >= 0.0
    w_a = torch.where(d, diag_e, bottom_e)
    w_b = torch.where(d, top_e, right_e)
    w_c = torch.where(d, left_e, -diag_e)
    area = w_a + w_b + w_c
    ok = cell_ok & (area > _f32(1e-12))
    if cull is not None:
        zm00, zm10, zm01, zm11 = zms
        zm_a = torch.where(d, zm00, zm01)
        zm_c = torch.where(d, zm01, zm11)
        spread = (torch.maximum(torch.maximum(zm_a, zm10), zm_c)
                  - torch.minimum(torch.minimum(zm_a, zm10), zm_c))
        ok = ok & (spread <= _f32(cull))
    inside = ((d & (top_e >= 0.0) & (left_e >= 0.0))
              | (~d & (bottom_e >= 0.0) & (right_e >= 0.0)))
    z_a = torch.where(d, z00, z01)
    z_c = torch.where(d, z01, z11)
    znum = w_a * z_a + w_b * z10 + w_c * z_c
    cov = ok & inside & (znum >= -area) & (znum <= area)
    tid = base_id + torch.where(d, 0.0, 1.0)
    c_l = znum * best.ar
    c_r = best.zn * area
    better = cov & ((c_l < c_r) | ((c_l == c_r) & (tid < best.id)))
    p_a = w_a * torch.where(d, i00, i01)
    p_b = w_b * i10
    p_c = w_c * torch.where(d, i01, i11)
    iw = p_a + p_b + p_c
    uw = torch.where(d, u0, u1) * iw + inv_ncm1 * torch.where(d, p_c, -p_b)
    vw = torch.where(d, v_top, v_bot) * iw + inv_nrm1 * torch.where(d, -p_b,
                                                                    p_a)
    ml = torch.minimum(w_a, torch.minimum(w_b, w_c))
    new = _Best(znum, area, tid, uw, vw, iw, ml)
    return new.where(better, best)


def _edge(xa, ya, xb, yb, qx, qy):
    """Edge function e(q) = (xb - xa)(qy - ya) - (yb - ya)(qx - xa)."""
    return (xb - xa) * (qy - ya) - (yb - ya) * (qx - xa)


def n_attrs(raster_z: bool, min_lam: bool = False) -> int:
    """attrs planes: u, v, model z, coverage, the raster z when a consumer
    reads it (the ``texture_z`` shade, the attrs merge), and after it the
    winner's normalised least barycentric weight for the quality tier's
    wireframe mode."""
    return 6 if min_lam else 5 if raster_z else 4


def march_exact_plain(rec, win, w0, bounds, canch, mid, minv, g: ScanGeometry,
                      config: ScanConfig, bflag=None, raster_z: bool = False,
                      wire: bool = False, min_lam: bool = False):
    """March + exact tests + colfix for one frame -> attrs (4, HPAD, WL)
    float32: u, v, model z, coverage (1.0 / 0.0); with ``raster_z`` a fifth
    plane, the raster z (FAR where uncovered); with ``min_lam`` (which
    implies ``raster_z``) a sixth, ``ml / ar``, the winner's least
    barycentric weight over its doubled area (the JAX kernel's attrs
    channel 5; 0 where uncovered), coverage left ungated.

    ``minv`` is the frame's (8,) float32 inverse-MVP rows 2 and 3. Pixels
    are processed as (bands, 8, blocks, 128); the JAX kernel's block-level
    gates (slot gate, chunk gate, hypothesis-2 gate, colfix gate and fan row
    bounds) reduce over each 8x128 block. ``bflag`` (nbands,) leaves
    unflagged bands uncovered (zeros, raster z FAR) without marching them.
    ``wire`` (the wireframe mode): the coverage plane keeps the covered
    pixels whose winner's least barycentric weight is at most
    ``common.WIREFRAME_EDGE_THRESHOLD`` of its doubled area.
    """
    dev = rec.device
    c = _Consts.of(g)
    na = n_attrs(raster_z, min_lam)
    out = torch.zeros((na, g.hpad, g.wl), dtype=_F32, device=dev)
    if na > 4:
        out[4] = _FAR
    m2 = [common.const(_f32(minv[k]), rec) for k in range(4)]
    m3 = [common.const(_f32(minv[4 + k]), rec) for k in range(4)]
    for b0, b1 in _active_chunks(g.nbands, bflag):
        attrs = _march_bands(rec[b0:b1], win, w0[b0:b1], bounds, canch,
                             mid, m2, m3, b0, g, c, config, wire, min_lam)
        attrs = attrs[:na].reshape(na, (b1 - b0) * 8, g.wl)
        if bflag is not None:
            keep = bflag[b0:b1].bool().repeat_interleave(8)[None, :, None]
            attrs = torch.where(keep, attrs, out[:, b0 * 8:b1 * 8])
        out[:, b0 * 8:b1 * 8] = attrs
    return out


def _march_bands(rec, win, w0, bounds, canch, mid, m2, m3, b0,
                 g: ScanGeometry, c: _Consts, config: ScanConfig,
                 wire: bool = False, min_lam: bool = False):
    dev = rec.device
    B = rec.shape[0]
    NBR, SR, OFF, CW = config.nbr, config.sr, config.off, config.cw
    CL, nblk = g.cl, g.nblk
    CWF = min(CW + 128, CL)
    # big_grid marches the whole 128-aligned fetch window; a window of 4 or
    # more 128-column chunks marches chunk by chunk behind a block gate, and
    # never narrow.
    MW = CWF if config.big_grid else CW
    chunked = MW // 128 >= 4
    narrow_ok = not config.big_grid and CW > 128 and not chunked
    cull = config.edge_cull_threshold
    FAR = common.const(_FAR, rec)
    inv_ncm1 = common.const(c.inv_ncm1, rec)
    inv_nrm1 = common.const(c.inv_nrm1, rec)
    sxw = common.const(c.sxw, rec)
    syw = common.const(c.syw, rec)

    # Pixel grid (B, 8, nblk, 128) and per-block scalars.
    lane = torch.arange(128, dtype=_F32, device=dev)
    blkf = torch.arange(nblk, dtype=_F32, device=dev)
    qx = ((blkf * 128.0)[:, None] + lane[None]) + 0.5       # (nblk, 128)
    qx = qx[None, None].expand(B, 8, nblk, 128)
    rowf = (torch.arange(b0, b0 + B, dtype=_F32, device=dev)[:, None] * 8.0
            + torch.arange(8, dtype=_F32, device=dev)[None])
    qy = ((g.height - rowf) - 0.5)[:, :, None, None].expand(B, 8, nblk, 128)
    canch = canch.to(torch.int64)
    canch_m = canch * 8                                      # (nblk,)
    canch_f = canch_m // 128
    # March-window column -> fetch-window column.
    off_f = (torch.zeros_like(canch_m) if config.big_grid
             else canch_m - canch_f * 128)
    # Prep gives -1 (wide) everywhere when cw <= 128 or big_grid; the patch
    # pass's block gate may set -2 there too.
    midb = mid.reshape(g.nbands, nblk)[b0:b0 + B].to(torch.int64)
    w0r = w0.to(torch.int64) * 8                             # (B,) rows
    w0f = w0r.to(_F32)[:, None, None, None]

    def blk(x):
        """(nblk,) or (B, nblk) -> broadcastable over (B, 8, nblk, 128)."""
        x = x if x.dim() == 2 else x[None].expand(B, nblk)
        return x[:, None, :, None]

    def block_any(m):
        """(B, 8, nblk, 128) bool -> per-block any, broadcastable."""
        return m.any(dim=3, keepdim=True).any(dim=1, keepdim=True)

    def plane(s, p):
        """Record plane (B, 8, CL) of slot s."""
        return rec[:, s, p]

    def gather_cols(tab, cols):
        """tab (B, 8, CL); cols (B|1, 8|1, nblk, L) -> (B, 8, nblk, L)."""
        L = cols.shape[-1]
        cols = cols.expand(B, 8, nblk, L).reshape(B, 8, nblk * L)
        return torch.gather(tab, 2, cols).reshape(B, 8, nblk, L)

    def fetch(s, p, j):
        """rec[s, p] at fetch-window column j (clamped to [0, CWF-1])."""
        cols = blk(canch_f * 128) + torch.clamp(j, 0, CWF - 1)
        return gather_cols(plane(s, p), cols)

    best = _Best(FAR.expand(B, 8, nblk, 128), torch.ones_like(qx),
                 torch.full_like(qx, 2.0e30), torch.zeros_like(qx),
                 torch.zeros_like(qx), torch.zeros_like(qx),
                 torch.zeros_like(qx))

    def invw(x, y, z):
        return (m3[0] * (x * sxw - 1.0) + m3[1] * (y * syw - 1.0)
                + m3[2] * z + m3[3])

    def model_z(corner):
        return _model_z(*corner, m2, m3, sxw, syw)

    def realigned_right(s, j1, bw1):
        """The right neighbour record's strip, realigned by the bracket-row
        delta d = bw2 - bw1: aligned2[k] = strip2[k - d] for |d| <= dmax,
        else NaN (which fails every test it reaches). Where the JAX kernel
        skips this for a block with no shear it passes strip2 with NaN z for
        a missing right record: the same coverage, lane by lane."""
        j2 = j1 + 1
        bw2 = fetch(s, 2, j2)
        strip2 = [tuple(fetch(s, 3 + 3 * k + v, j2) for v in range(3))
                  for k in range(SR)]
        dmax = SR - 1 if config.dmax is None else min(config.dmax, SR - 1)
        d = bw2 - bw1
        nan = torch.full_like(bw1, float("nan"))
        aligned2 = []
        for k in range(SR):
            acc = (nan, nan, nan)
            for delta in range(-dmax, dmax + 1):
                kk = k - delta
                if 0 <= kk < SR:
                    m = d == float(delta)
                    acc = tuple(torch.where(m, strip2[kk][v], acc[v])
                                for v in range(3))
            aligned2.append(acc)
        return aligned2

    def exact_record(best_in, s, h):
        jf = torch.clamp(h, 0.0, float(MW - 1))
        j1 = jf.to(torch.int64) + blk(off_f)
        bw1 = fetch(s, 2, j1)
        PR = config.per_row
        strip1 = [tuple(fetch(s, 3 + PR * k + v, j1) for v in range(3))
                  for k in range(SR)]
        if config.dual_col:
            # Self-contained record: the right column's corners at the
            # record's own rows (no neighbour fetch, no realign).
            aligned2 = [tuple(fetch(s, 3 + PR * k + 3 + v, j1)
                              for v in range(3)) for k in range(SR)]
        else:
            aligned2 = realigned_right(s, j1, bw1)
        iw1 = [invw(*strip1[k]) for k in range(SR)]
        iw2 = [invw(*aligned2[k]) for k in range(SR)]
        if cull is not None:
            zm1 = [model_z(strip1[k]) for k in range(SR)]
            zm2 = [model_z(aligned2[k]) for k in range(SR)]
        cg = blk(canch_f * 128).to(_F32) + j1.to(_F32)
        u0 = cg * inv_ncm1
        u1 = (cg + 1.0) * inv_ncm1
        rg0 = w0f + bw1 - float(OFF)
        col_ok = (bw1 > _f32(_NOBASE + 1.0)) & (cg <= float(g.n_c - 2))
        b = best_in
        prev_bottom = None
        for k in range(SR - 1):
            r_cell = rg0 + float(k)
            cell_ok = col_ok & (r_cell >= 0.0) & (r_cell <= float(g.n_r - 2))
            v_top = 1.0 - r_cell * inv_nrm1
            v_bot = 1.0 - (r_cell + 1.0) * inv_nrm1
            x00, y00, z00 = strip1[k]
            x10, y10, z10 = strip1[k + 1]
            x01, y01, z01 = aligned2[k]
            x11, y11, z11 = aligned2[k + 1]
            base_id = (r_cell * float(g.n_c - 1) + cg) * 2.0
            diag_e = _edge(x10, y10, x01, y01, qx, qy)
            left_e = _edge(x00, y00, x10, y10, qx, qy)
            top_e = (_edge(x01, y01, x00, y00, qx, qy) if prev_bottom is None
                     else -prev_bottom)
            bottom_e = _edge(x10, y10, x11, y11, qx, qy)
            right_e = _edge(x11, y11, x01, y01, qx, qy)
            prev_bottom = bottom_e
            zms = (None if cull is None
                   else (zm1[k], zm1[k + 1], zm2[k], zm2[k + 1]))
            b = _cell_fold(b, cell_ok, diag_e, top_e, bottom_e, left_e,
                           right_e, z00, z10, z01, z11, iw1[k], iw1[k + 1],
                           iw2[k], iw2[k + 1], u0, u1, v_top, v_bot, base_id,
                           inv_ncm1, inv_nrm1, zms, cull)
        return b

    def sweep(s, lo, L, need2):
        """Bracket sweep over record columns lo .. lo+L-1 (per block):
        returns per pixel (o1, m1, cnt, o2) — the first column of the
        nearest hit, its key, the hit count and the second hypothesis."""
        cols = lo[:, None, :, None] + torch.arange(L, device=dev)
        sxs = gather_cols(plane(s, 0), cols)                 # (B, 8, nblk, L)
        zcs = gather_cols(plane(s, 1), cols)
        nxt = torch.roll(sxs, -1, dims=3)
        mn = torch.minimum(sxs, nxt)
        mx = torch.maximum(sxs, nxt)
        mx[..., L - 1] = -_FAR
        q = qx[..., None]
        hit = (q >= mn[:, :, :, None, :]) & (q <= mx[:, :, :, None, :])
        key = torch.where(hit, zcs[:, :, :, None, :], FAR)  # (B,8,nblk,128,L)
        m1 = key.amin(dim=4)
        o1 = torch.argmax((key == m1[..., None]).to(torch.uint8), dim=4)
        cnt = hit.sum(dim=4)
        o2 = None
        if need2:
            key2 = key.scatter(4, o1[..., None], _FAR)
            m2v = key2.amin(dim=4)
            o2 = torch.argmax((key2 == m2v[..., None]).to(torch.uint8), dim=4)
        return o1, m1, cnt, o2

    def sweep_chunked(s, lo):
        """The JAX kernel's chunked march over a window of 4+ chunks: per
        128-column chunk of the window, a block gate (some crossing x of the
        block's 8 scanlines, over the chunk and the next chunk's first 8
        columns, at most the block's last pixel centre, and some real one at
        least its first pixel centre - 64) and a bracket sweep over the
        chunk's 128 pair bases (the window's last chunk: 127). Returns per
        pixel (o1, m1, cnt): the first column of the nearest hit in a gated
        chunk, or ``MW`` if none, its key, and the gated chunks' hit
        count."""
        qx0 = blk(blkf * 128.0 + 0.5)
        o1 = torch.full(qx.shape, MW, dtype=torch.int64, device=dev)
        m1 = FAR.expand(qx.shape)
        cnt = torch.zeros(qx.shape, dtype=torch.int64, device=dev)
        for ch in range(MW // 128):
            L = 128 + 8 if ch < MW // 128 - 1 else 128
            npair = 128 if ch < MW // 128 - 1 else 127
            cols = lo[:, None, :, None] + ch * 128 + torch.arange(L,
                                                                  device=dev)
            sxs = gather_cols(plane(s, 0), cols)             # (B, 8, nblk, L)
            zcs = gather_cols(plane(s, 1), cols)
            near = (sxs <= qx0 + 127.0).any(dim=3, keepdim=True)
            real = ((sxs < _f32(_FAR * 0.5))
                    & (sxs >= qx0 - 64.0)).any(dim=3, keepdim=True)
            gate = (near.any(dim=1, keepdim=True)
                    & real.any(dim=1, keepdim=True))        # (B, 1, nblk, 1)
            a, an = sxs[..., :npair], sxs[..., 1:npair + 1]
            q = qx[..., None]
            hit = ((q >= torch.minimum(a, an)[:, :, :, None, :])
                   & (q <= torch.maximum(a, an)[:, :, :, None, :]))
            key = torch.where(hit, zcs[:, :, :, None, :npair], FAR)
            m1c = key.amin(dim=4)
            o1c = torch.argmax((key == m1c[..., None]).to(torch.uint8),
                               dim=4) + ch * 128
            better = gate & (m1c < m1)
            o1 = torch.where(better, o1c, o1)
            m1 = torch.where(better, m1c, m1)
            cnt = cnt + torch.where(gate, hit.sum(dim=4), 0)
        return o1, m1, cnt

    fixes = []
    lo_w = (canch_f * 128 + off_f)[None].expand(B, nblk)     # window start
    lo_n = canch_m[None] + torch.clamp(midb, min=0) * 8
    narrow = blk(midb) >= 0
    for s in range(NBR):
        zc_w = gather_cols(plane(s, 1), lo_w[:, None, :, None]
                           + torch.arange(MW, device=dev))
        any_rec = block_any((zc_w < _f32(_FAR * 0.5)).any(dim=3,
                                                           keepdim=True)
                            .expand(B, 8, nblk, 128))
        if narrow_ok:
            zc_n = gather_cols(plane(s, 1), lo_n[:, None, :, None]
                               + torch.arange(128, device=dev))
            any_nar = block_any((zc_n < _f32(_FAR * 0.5)).any(
                dim=3, keepdim=True).expand(B, 8, nblk, 128))
            any_rec = torch.where(narrow, any_nar, any_rec)
        gate = any_rec & (blk(midb) != -2)

        need2 = config.hyps == 2
        if chunked:
            o1c, m1, cnt = sweep_chunked(s, lo_w)
            h1 = o1c.to(_F32)
            if need2:   # the second hypothesis sweeps the whole window
                h2 = sweep(s, lo_w, MW, True)[3].to(_F32)
        else:
            o1w, m1, cnt, o2w = sweep(s, lo_w, MW, need2)
            h1 = o1w.to(_F32)
            h2 = o2w.to(_F32) if need2 else None
            if narrow_ok:
                o1n, m1n, cntn, o2n = sweep(s, lo_n, 128, need2)
                mid8 = (blk(midb) * 8).to(_F32)
                h1 = torch.where(narrow, o1n.to(_F32) + mid8, h1)
                m1 = torch.where(narrow, m1n, m1)
                cnt = torch.where(narrow, cntn, cnt)
                if need2:
                    h2 = torch.where(narrow, o2n.to(_F32) + mid8, h2)
        new = exact_record(best, s, h1)
        if need2:
            multi = block_any(cnt > 1)
            new = exact_record(new, s, h2).where(multi, new)
        best = new.where(gate, best)
        fixes.append((torch.where(gate, h1, float(MW)),
                      torch.where(gate, m1, FAR)))

    if config.colfix is not None:
        for offs in fan_cascade(config.colfix):
            for h1s, m1s in fixes:
                go = block_any((best.id >= _f32(1.0e30))
                               & (m1s < _f32(_FAR * 0.5)))
                best = _colfix(best, go, h1s, m1s, qx, qy, win, w0r, w0f,
                               bounds, canch_f, off_f, b0, g, c, config, m2,
                               m3, offs)

    bz = best.zn / best.ar
    cov = bz < FAR
    den = torch.where(best.iw.abs() > _f32(1e-30), best.iw,
                      torch.ones_like(best.iw))
    zero = torch.zeros_like(bz)
    u = torch.where(cov, best.uw / den, zero)
    v = torch.where(cov, best.vw / den, zero)
    ndcx = qx * c.sxw - 1.0
    ndcy = qy * c.syw - 1.0
    num = (m2[0] * ndcx + m2[1] * ndcy + m2[2] * bz + m2[3]) * best.ar
    zmod = torch.where(cov, num / den, zero)
    if wire:
        cov = cov & (best.ml <= common.const(common.WIREFRAME_EDGE_THRESHOLD,
                                             bz) * best.ar)
    planes = [u, v, zmod, cov.to(_F32), bz]
    if min_lam:
        planes.append(best.ml / best.ar)
    return torch.stack(planes)                          # (5|6,B,8,nblk,128)


def fan_cascade(k: int):
    """The colfix fan calls for half-width ``k``, in order, each as its
    corner-column offsets from the top-1 column: the inner fan (cells j0-1
    .. j0+1; at K = 0 the one cell j0), then at K >= 2 the outer cells
    j0-K .. j0-2 and j0+2 .. j0+K on the blocks the inner fan left holed.
    Cells lie between consecutive offsets only."""
    inner = tuple(range(-min(k, 1), min(k, 1) + 2))
    if k < 2:
        return (inner,)
    return inner, tuple(range(-k, 0)) + tuple(range(2, k + 2))


def _colfix(best: _Best, go, h1s, m1s, qx, qy, win, w0r, w0f, bounds,
            canch_f, off_f, b0, g: ScanGeometry, c: _Consts,
            config: ScanConfig, m2, m3, offs) -> _Best:
    """One colfix fan call (see :func:`fan_cascade`) for one slot, on the
    blocks where ``go`` holds.

    For each pixel with a real marched bracket (``m1 < FAR/2``), the fan
    corner columns are ``j0 + o`` for ``o`` in ``offs`` around its top-1
    column ``j0``; every window row k in the block's [rb0*8, rb1*8) is
    exact-tested over the fan's cells, masked to [kb_u, ke_u) — the union
    of the scan bounds of the chunks any valid fan corner of the block lands
    in. In ``big_grid`` the rows are global grid rows, and a cell also
    needs row k inside the scan rows of the chunks both its corner columns
    land in (the JAX kernel's per-subtable row masks).
    """
    B, _, nblk, _ = qx.shape
    sel = go.expand(B, 1, nblk, 1)[:, 0, :, 0].nonzero()    # (Nb, 2)
    if sel.shape[0] == 0:
        return best
    bi, ki = sel[:, 0], sel[:, 1]
    big = config.big_grid
    # Rows of the window the fan reads: the band's rmax rows, or big_grid's
    # whole (padded) grid.
    R = g.rpad if big else config.rmax
    CWF = min(config.cw + 128, g.cl)
    MW = CWF if big else config.cw
    nsub = CWF // 128
    NF = len(offs)
    cull = config.edge_cull_threshold
    inv_ncm1 = common.const(c.inv_ncm1, qx)
    inv_nrm1 = common.const(c.inv_nrm1, qx)
    sxw = common.const(c.sxw, qx)
    syw = common.const(c.syw, qx)

    def pick(x):
        return x[bi, :, ki]                                  # (Nb, 8, 128)

    bsel = _Best(*(pick(t) for t in best))
    h1, m1, qxs, qys = pick(h1s), pick(m1s), pick(qx), pick(qy)
    cf = canch_f[ki]                                         # (Nb,)
    hitok = m1 < _f32(_FAR * 0.5)
    j0 = torch.clamp(h1, 0.0, float(MW - 1)).to(torch.int64) + off_f[ki][:,
                                                                          None,
                                                                          None]
    ix = [j0 + o for o in offs]
    colok = [hitok & (x >= 0) & (x <= CWF - 1) for x in ix]
    sub = [torch.clamp(x, 0, CWF - 1) // 128 for x in ix]   # fetch chunk
    col = [cf[:, None, None] * 128 + torch.clamp(x, 0, CWF - 1) for x in ix]
    cg = [cc.to(_F32) for cc in col]

    # Each chunk's scan rows in window rows (big_grid: global rows).
    band = bi + b0
    org, kbs, kes, _ = unpack_bounds(
        bounds, torch.zeros(g.nbands, dtype=torch.int64, device=qx.device),
        g, config)
    nonempty = kes > kbs
    lo_t = torch.where(nonempty, org + kbs, R)
    hi_t = torch.where(nonempty, org + kes, 0)
    # Row bounds: union over the chunks the block's valid fan corners use.
    kb_u = torch.full_like(cf, R)
    ke_u = torch.zeros_like(cf)
    for tt in range(nsub):
        used = torch.zeros_like(hitok)
        for cc in range(NF):
            used = used | (colok[cc] & (sub[cc] == tt))
        used = used.flatten(1).any(dim=1)
        kb_u = torch.where(used, torch.minimum(kb_u, lo_t[band, cf + tt]),
                           kb_u)
        ke_u = torch.where(used, torch.maximum(ke_u, hi_t[band, cf + tt]),
                           ke_u)
    rb0 = torch.clamp(kb_u // 8, max=R // 8 - 1)
    rb1 = torch.clamp((ke_u + 8) // 8, max=R // 8)
    k_lo, k_hi = int(rb0.min()) * 8, int(rb1.max()) * 8
    if k_hi <= k_lo:
        return best
    if big:   # each corner column's own chunk rows
        chunk_rows = [(lo_t[band[:, None, None], cf[:, None, None] + t],
                       hi_t[band[:, None, None], cf[:, None, None] + t])
                      for t in sub]

    base = w0r[bi][:, None, None]                            # window row 0
    wflat = win.reshape(3, -1)
    nb = bi.shape[0]

    def corners(k_rows):
        """(x, y, z) of window row k_rows (Nb,) at each fan column."""
        rows = (base + k_rows[:, None, None]) * g.cl
        return [tuple(wflat[v][(rows + cc).reshape(-1)].reshape(nb, 8, 128)
                      for v in range(3)) for cc in col]

    def invw(x, y, z):
        return (m3[0] * (x * sxw - 1.0) + m3[1] * (y * syw - 1.0)
                + m3[2] * z + m3[3])

    cells = [f for f in range(NF - 1) if offs[f + 1] == offs[f] + 1]
    start = rb0 * 8
    kb3, ke3 = kb_u[:, None, None], ke_u[:, None, None]
    st3 = start[:, None, None]
    prev_bottom = [None] * len(cells)
    for k in range(k_lo, k_hi):
        kt = torch.full_like(cf, k)
        # Row k+1 past the band window re-reads the last 8-row block's first
        # row (the JAX kernel's clamped block load), and past big_grid's
        # padded grid the last row; such rows are masked.
        kb_next = torch.where(kt + 1 >= R, torch.full_like(kt, R - 1 if big
                                                           else R - 8), kt + 1)
        gtop = corners(kt)
        gbot = corners(kb_next)
        r_cell = w0f[bi] + float(k)                          # (Nb, 1, 1, 1)
        r_cell = r_cell.reshape(nb, 1, 1)
        in_rng = (k >= kb3) & (k < ke3)
        row_ok = in_rng & (r_cell >= 0.0) & (r_cell <= float(g.n_r - 2))
        v_top = 1.0 - r_cell * inv_nrm1
        v_bot = 1.0 - (r_cell + 1.0) * inv_nrm1
        lines = [_edge(gtop[cc][0], gtop[cc][1], gbot[cc][0], gbot[cc][1],
                       qxs, qys) for cc in range(NF)]
        iwt = [invw(*gtop[cc]) for cc in range(NF)]
        iwb = [invw(*gbot[cc]) for cc in range(NF)]
        if cull is not None:
            zmt = [_model_z(*gtop[cc], m2, m3, sxw, syw) for cc in range(NF)]
            zmb = [_model_z(*gbot[cc], m2, m3, sxw, syw) for cc in range(NF)]
        if big:
            in_chunk = [(k >= lo) & (k < hi) for lo, hi in chunk_rows]
        first = st3 == k
        for ci, f in enumerate(cells):
            x00, y00, z00 = gtop[f]
            x10, y10, z10 = gbot[f]
            x01, y01, z01 = gtop[f + 1]
            x11, y11, z11 = gbot[f + 1]
            cgf = cg[f]
            cell_ok = (row_ok & colok[f] & colok[f + 1]
                       & (cgf <= float(g.n_c - 2)))
            if big:
                cell_ok = cell_ok & in_chunk[f] & in_chunk[f + 1]
            u0 = cgf * inv_ncm1
            u1 = (cgf + 1.0) * inv_ncm1
            base_id = (r_cell * float(g.n_c - 1) + cgf) * 2.0
            diag_e = _edge(x10, y10, x01, y01, qxs, qys)
            top0 = _edge(x01, y01, x00, y00, qxs, qys)
            top_e = (top0 if prev_bottom[ci] is None
                     else torch.where(first, top0, -prev_bottom[ci]))
            bottom_e = _edge(x10, y10, x11, y11, qxs, qys)
            prev_bottom[ci] = bottom_e
            zms = (None if cull is None
                   else (zmt[f], zmb[f], zmt[f + 1], zmb[f + 1]))
            bsel = _cell_fold(bsel, cell_ok, diag_e, top_e, bottom_e,
                              lines[f], -lines[f + 1], z00, z10, z01, z11,
                              iwt[f], iwb[f], iwt[f + 1], iwb[f + 1], u0, u1,
                              v_top, v_bot, base_id, inv_ncm1, inv_nrm1, zms,
                              cull)
    out = []
    for full, part in zip(best, bsel):
        full = full.clone()
        full[bi, :, ki] = part
        out.append(full)
    return _Best(*out)


def shade_plain(attrs, texq, ht: int, wt: int, mode: str, bflag=None):
    """Bilinear RGBA8 shade of attrs (4 or 5, HPAD, WL) -> (HPAD, WL) int32
    packed pixels, R in the low byte; background (0, 0, 0, 255).

    ``mode`` ``wireframe`` shades as ``texture`` (the march's ``wire``
    coverage already keeps only the edge bands); ``texture_z`` shades as
    ``texture`` and returns ``(packed, z)``: z the raster depth (attrs plane
    4) where covered, FAR elsewhere.
    ``bflag`` (nbands,; texture_z only) gives unflagged bands packed 0 and z
    FAR.
    """
    if bflag is not None and mode != "texture_z":
        raise ValueError("sparse bands exist only in the texture_z mode")
    tex = texq.to(torch.int64)
    texels = torch.stack([(tex >> s) & 0xFF for s in (0, 8, 16, 24)], dim=-1)
    cov = attrs[3] > 0.5
    rgba = common.shade(cov, attrs[0], attrs[1], attrs[2], texels.to(_F32),
                        "debug_z" if mode == "debug_z" else "texture").to(
                            torch.int64)
    p = rgba[..., 0] | (rgba[..., 1] << 8) | (rgba[..., 2] << 16) | (
        rgba[..., 3] << 24)
    packed = ((p + 2**31) % 2**32 - 2**31).to(_I32)
    if mode != "texture_z":
        return packed
    z = torch.where(cov, attrs[4], common.const(_FAR, attrs))
    if bflag is not None:
        keep = bflag.bool().repeat_interleave(8)[:, None]
        packed = torch.where(keep, packed, torch.zeros_like(packed))
        z = torch.where(keep, z, common.const(_FAR, z))
    return packed, z


# ---------------------------------------------------------------------------
# The CUDA kernels (csrc/scan.cu), built with nvcc on first use
# ---------------------------------------------------------------------------

_lib = None
_lib_lock = threading.Lock()

# Launches of each kernel since the last reset_launch_counts(); a wrapper adds
# one where it launches its kernel and nowhere else.
LAUNCHES = {"solve": 0, "march": 0, "shade": 0}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build_kernels(force: bool = False) -> Path:
    """Compile csrc/scan.cu into build/libscan.so (nvcc, sm_90a) unless an
    up-to-date library exists. Raises ``RuntimeError`` with nvcc's output."""
    return cuda_build.build("scan.cu", force=force)


# ScanParams.mode; the wireframe mode's coverage is the march's, so it shades
# as the texture mode does.
_MODES = {"texture": 0, "debug_z": 1, "texture_z": 2, "wireframe": 0}


class _Params(ctypes.Structure):
    """Mirror of ``struct ScanParams`` in csrc/scan.cu (field order and
    types must match)."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "width", "height", "n_r", "n_c", "cl", "rpad", "wl", "hpad",
        "nbands", "nchunks", "nblk", "rmax", "cw", "cwf", "sr", "off", "nbr",
        "hyps", "dmax", "colfix", "ht", "wt", "mode", "dual", "raster_z",
        "big", "wire", "cull")] + [
        (name, ctypes.c_float) for name in (
            "sxw", "syw", "inv_ncm1", "inv_nrm1", "cull_thr")] + [
        ("m2", ctypes.c_float * 4), ("m3", ctypes.c_float * 4)]


def _load_lib(path=None):
    """The kernels' library: ``build/libscan.so`` (built on first use), or
    the library at ``path`` (another build of a ``scan.cu`` with the same
    C interface), which the wrappers then launch from."""
    global _lib
    with _lib_lock:
        if _lib is None or path is not None:
            lib = ctypes.CDLL(str(path or build_kernels()))
            vp, ip = ctypes.c_void_p, ctypes.POINTER(_Params)
            for name, n_ptr in (("scan_solve", 5), ("scan_march", 8),
                                ("scan_shade", 5)):
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int
                fn.argtypes = [vp] * n_ptr + [ip, vp]
            lib.scan_error_string.restype = ctypes.c_char_p
            lib.scan_error_string.argtypes = [ctypes.c_int]
            _lib = lib
    return _lib


def march_shape() -> tuple[int, int]:
    """The march kernel's block: (threads, pixels a thread); a block covers
    an 8-row band's 128-pixel block."""
    threads, pixels = ctypes.c_int(), ctypes.c_int()
    _load_lib().scan_march_shape(ctypes.byref(threads), ctypes.byref(pixels))
    return threads.value, pixels.value


def kernel_ptxas(kernel: str, lib=None) -> dict:
    """ptxas's registers, spills, stack and shared memory of each instance
    of ``<kernel>_kernel`` (``solve``, ``march`` or ``shade``) in
    ``build/libscan.so``, or in the library ``lib`` (from its build
    report)."""
    lib = cuda_build.library_path("scan.cu") if lib is None else lib
    return {k: v for k, v in cuda_build.ptxas_usage(lib).items()
            if k.startswith(f"{kernel}_kernel")}


def _params(g: ScanGeometry, config: ScanConfig, minv=None, tex_hw=(0, 0),
            mode: str = "texture", raster_z: bool = False,
            wire: int = 0) -> _Params:
    """The kernels' parameters; ``wire`` is ScanParams.wire: 0 off, 1 the
    single pass's coverage test, 2 the attrs mode's sixth plane."""
    c = _Consts.of(g)
    dmax = config.sr - 1 if config.dmax is None else min(config.dmax,
                                                         config.sr - 1)
    p = _Params(
        width=g.width, height=g.height, n_r=g.n_r, n_c=g.n_c, cl=g.cl,
        rpad=g.rpad, wl=g.wl, hpad=g.hpad, nbands=g.nbands,
        nchunks=g.nchunks, nblk=g.nblk, rmax=config.rmax, cw=config.cw,
        cwf=min(config.cw + 128, g.cl), sr=config.sr, off=config.off,
        nbr=config.nbr, hyps=config.hyps, dmax=dmax,
        colfix=-1 if config.colfix is None else config.colfix,
        ht=int(tex_hw[0]), wt=int(tex_hw[1]), mode=_MODES[mode],
        dual=int(config.dual_col), raster_z=int(raster_z),
        big=int(config.big_grid), wire=int(wire),
        cull=int(config.edge_cull_threshold is not None), sxw=c.sxw,
        syw=c.syw, inv_ncm1=c.inv_ncm1, inv_nrm1=c.inv_nrm1,
        cull_thr=_f32(config.edge_cull_threshold or 0.0))
    if minv is not None:
        for k in range(4):
            p.m2[k] = _f32(minv[k])
            p.m3[k] = _f32(minv[4 + k])
    return p


def _launch(name, ptrs, params):
    lib = _load_lib()
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib, name)(*[ctypes.c_void_p(p) for p in ptrs],
                             ctypes.byref(params), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.scan_error_string(err).decode()}")
    LAUNCHES[name[len("scan_"):]] += 1


def _check(**named):
    """``check_cuda`` over ``name=(tensor, dtype, shape)``, skipping absent
    (None) tensors."""
    named = {k: v for k, v in named.items() if v[0] is not None}
    cuda_build.check_cuda({k: v[0] for k, v in named.items()},
                          {k: v[1] for k, v in named.items()},
                          {k: v[2] for k, v in named.items()})


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def _on_cpu(*tensors) -> bool:
    return cuda_build.on_cpu(*(t for t in tensors if t is not None))


def solve_records(win, w0, bounds, g: ScanGeometry, config: ScanConfig,
                  bflag=None):
    """Column solve for one frame -> records (nbands, nbr, nrec, 8, CL);
    ``bflag`` (nbands,) int32 skips unflagged bands. CPU tensors:
    :func:`solve_records_plain`; CUDA: the ``solve`` kernel."""
    if _on_cpu(win, w0, bounds, bflag):
        return solve_records_plain(win, w0, bounds, g, config, bflag)
    _check(win=(win, _F32, (3, g.rpad, g.cl)), w0=(w0, _I32, (g.nbands,)),
           bounds=(bounds, _I32, (g.nbands * g.nchunks,)),
           bflag=(bflag, _I32, (g.nbands,)))
    rec = torch.empty((g.nbands, config.nbr, config.nrec, 8, g.cl),
                      dtype=_F32, device=win.device)
    _launch("scan_solve", [win.data_ptr(), w0.data_ptr(), bounds.data_ptr(),
                           _ptr(bflag), rec.data_ptr()], _params(g, config))
    return rec


def march_exact(rec, win, w0, bounds, canch, mid, minv, g: ScanGeometry,
                config: ScanConfig, bflag=None, raster_z: bool = False,
                wire: bool = False, min_lam: bool = False):
    """March + exact tests + colfix for one frame -> attrs (4, HPAD, WL),
    with ``raster_z`` (5, HPAD, WL), with ``min_lam`` (6, HPAD, WL); ``wire``
    gives the wireframe mode's coverage (see :func:`march_exact_plain`). CPU
    tensors: :func:`march_exact_plain`; CUDA: the ``march`` kernel."""
    if wire and min_lam:
        raise ValueError("wire gates the coverage of a single pass; min_lam "
                         "leaves it for the test after the merge")
    if _on_cpu(rec, win, w0, bounds, canch, mid, bflag):
        return march_exact_plain(rec, win, w0, bounds, canch, mid, minv, g,
                                 config, bflag, raster_z, wire, min_lam)
    _check(rec=(rec, _F32, (g.nbands, config.nbr, config.nrec, 8, g.cl)),
           win=(win, _F32, (3, g.rpad, g.cl)), w0=(w0, _I32, (g.nbands,)),
           bounds=(bounds, _I32, (g.nbands * g.nchunks,)),
           canch=(canch, _I32, (g.nblk,)),
           mid=(mid, _I32, (g.nbands * g.nblk,)),
           bflag=(bflag, _I32, (g.nbands,)))
    attrs = torch.empty((n_attrs(raster_z, min_lam), g.hpad, g.wl),
                        dtype=_F32, device=rec.device)
    _launch("scan_march",
            [rec.data_ptr(), win.data_ptr(), w0.data_ptr(), bounds.data_ptr(),
             canch.data_ptr(), mid.data_ptr(), _ptr(bflag), attrs.data_ptr()],
            _params(g, config, minv=minv, raster_z=raster_z or min_lam,
                    wire=2 if min_lam else int(wire)))
    return attrs


def shade(attrs, texq, g: ScanGeometry, config: ScanConfig, mode: str,
          bflag=None):
    """Shade attrs (4 or 5, HPAD, WL) with the packed texture (Ht, Wt) int32
    -> (HPAD, WL) int32 packed RGBA, and in the ``texture_z`` mode (5
    planes) also the (HPAD, WL) float32 raster z (see :func:`shade_plain`).
    CPU: :func:`shade_plain`; CUDA: the ``shade`` kernel."""
    ht, wt = texq.shape
    na = attrs.shape[0] if attrs.dim() == 3 else 0
    if na not in (4, 5) or (mode == "texture_z" and na != 5):
        raise ValueError(f"shade in the {mode} mode takes attrs of "
                         f"{'5' if mode == 'texture_z' else '4 or 5'} "
                         f"planes, got shape {tuple(attrs.shape)}")
    if _on_cpu(attrs, texq, bflag):
        return shade_plain(attrs, texq, ht, wt, mode, bflag)
    if bflag is not None and mode != "texture_z":
        raise ValueError("sparse bands exist only in the texture_z mode")
    _check(attrs=(attrs, _F32, (na, g.hpad, g.wl)),
           texq=(texq, _I32, (ht, wt)), bflag=(bflag, _I32, (g.nbands,)))
    out = torch.empty((g.hpad, g.wl), dtype=_I32, device=attrs.device)
    z = (torch.empty((g.hpad, g.wl), dtype=_F32, device=attrs.device)
         if mode == "texture_z" else None)
    _launch("scan_shade", [attrs.data_ptr(), texq.data_ptr(), _ptr(bflag),
                           out.data_ptr(), _ptr(z)],
            _params(g, config, tex_hw=(ht, wt), mode=mode))
    return out if z is None else (out, z)


# ---------------------------------------------------------------------------
# Frames
# ---------------------------------------------------------------------------

FRAME_GROUP = 16  # frames per prep batch


def _upload_mvps(mvps, dev):
    """(T, 4, 4) float32 MVPs -> (MVPs on ``dev``, (T, 8) inverse-MVP rows
    from the host copy). MVPs given on the host reach the device by a
    non-blocking copy, so nothing waits here."""
    mvps_host = torch.as_tensor(mvps, dtype=_F32).cpu()
    minv = minv_rows(mvps_host)
    if dev.type == "cpu":
        return mvps_host, minv
    return mvps_host.pin_memory().to(dev, non_blocking=True), minv


def _render_pass(p: ScanPrep, i: int, minv_i, g: ScanGeometry,
                config: ScanConfig, texq, mode: str, bflag=None):
    """Frame ``i`` of a prep batch through solve, march and shade -> the
    shade's output (see :func:`shade`)."""
    args = (p.win[i], p.w0[i], p.bounds[i])
    rec = solve_records(*args, g, config, bflag)
    attrs = march_exact(rec, *args, p.canch[i], p.mid[i], minv_i, g, config,
                        bflag, raster_z=mode == "texture_z",
                        wire=mode == "wireframe")
    return shade(attrs, texq, g, config, mode, bflag)


def render_frames_scan(mvps, vertex_grid, uv_grid, texture, width, height,
                       config: ScanConfig, mode: str = "texture",
                       frame_batch: int = FRAME_GROUP):
    """Render frames through the scan passes, on the device of
    ``vertex_grid``: one pass, or with ``config.row_edge`` the quality tier
    (:func:`render_frames_scan_quality`), or with ``config.patch`` in the
    ``texture`` mode the patch tier (:func:`render_frames_scan_patched`;
    other modes render the single pass, as the JAX package does).

    ``texture`` is the (Ht, Wt, 4) texels (quantised to 8 bits here).
    ``uv_grid`` is only checked (:func:`check_uv_grid`: the passes rebuild
    UVs analytically); that reads its corners back, so a caller that
    renders one grid in many calls checks it once and passes None.
    :return: ``(frames, overflow)``: (T, HPAD, WL) int32 packed RGBA (see
        :func:`unpack_raw_frames`) and a device scalar, the most hull rows
        ``rmax`` clipped in any frame (see :func:`warn_overflow`). Given MVPs
        on the host and ``uv_grid`` None or on the host, nothing here waits
        for the device.
    """
    check_supported(config)
    if mode not in ("texture", "debug_z", "wireframe"):
        raise ValueError(f"unknown scan mode {mode!r}")
    check_uv_grid(uv_grid)
    vertex_grid = torch.as_tensor(vertex_grid, dtype=_F32)
    dev = vertex_grid.device
    texture = torch.as_tensor(texture, device=dev)
    if config.row_edge:
        return render_frames_scan_quality(mvps, vertex_grid, texture, width,
                                          height, config, mode, frame_batch)
    if config.patch and mode == "texture":
        return render_frames_scan_patched(mvps, vertex_grid, texture, width,
                                          height, config, frame_batch)
    mvps, minv = _upload_mvps(mvps, dev)
    T = mvps.shape[0]
    n_r, n_c = vertex_grid.shape[0], vertex_grid.shape[1]
    g = ScanGeometry.of(width, height, n_r, n_c, config)
    texq = pack_texture(texture)
    out = torch.empty((T, g.hpad, g.wl), dtype=_I32, device=dev)
    overflow = torch.zeros((), dtype=torch.int64, device=dev)
    for s in range(0, T, frame_batch):
        p = prep_scan(mvps[s:s + frame_batch], vertex_grid, width, height,
                      config)
        overflow = torch.maximum(overflow, p.overflow_rows.max())
        for i in range(p.win.shape[0]):
            out[s + i] = _render_pass(p, i, minv[s + i], g, config, texq,
                                      mode)
    return out, overflow


def warn_overflow(overflow, config: ScanConfig):
    """Log when ``rmax`` clipped hull rows (reads the device scalar)."""
    from ..utils import log

    ovf = int(overflow)
    if ovf:
        log(f"WARNING: scan depth-hull window clipped up to {ovf} candidate "
            f"row(s) (rmax={config.rmax}); raise ScanConfig.rmax or expect "
            f"misses at extreme depth relief.")


# ---------------------------------------------------------------------------
# The fidelity tiers: a transposed second pass, merged by raster depth
# ---------------------------------------------------------------------------

# Clip-space screen transpose of the second pass: ndcx' = -ndcy, ndcy' =
# -ndcx (z, w unchanged). With the grid transposed too, the projected
# triangles keep their winding, and transposed pixel (i', j') is original
# pixel (j', i'); its records anchor on crossings of grid rows with vertical
# scanlines, the cells a column pass misses where a pixel enters its cell
# through a horizontal edge.
ROW_EDGE_SWAP = np.array(((0.0, -1.0, 0.0, 0.0),
                          (-1.0, 0.0, 0.0, 0.0),
                          (0.0, 0.0, 1.0, 0.0),
                          (0.0, 0.0, 0.0, 1.0)), np.float64)


def swap_mvps(mvps) -> torch.Tensor:
    """The second pass's MVPs: ``ROW_EDGE_SWAP @ mvp`` in host float64 (a
    permutation with signs, so exact), rounded to float32."""
    m = np.asarray(torch.as_tensor(mvps).detach().cpu(), np.float64)
    return torch.from_numpy(
        np.einsum("ij,tjk->tik", ROW_EDGE_SWAP, m).astype(np.float32))


def tier_configs(config: ScanConfig, n_r: int, n_c: int, width: int,
                 height: int):
    """The two passes' configs of a tier -> ``(cfg1, cfg2)``: pass 1 over
    the (width x height) image, pass 2 over the transposed (height x width)
    one. The render path and the chip smoke both take them from here.

    Quality (``row_edge``): pass 1 is ``config`` without the flag, at the
    JAX package's larger texture window; pass 2 the suggested config of the
    transposed output at ``config``'s strip knobs. Patch: pass 1 is
    ``config`` without the flag; pass 2 takes cheap strips with a colfix of
    its own when pass 1 has colfix, else quality-grade strips.
    """
    grid_n = max(n_r, n_c)
    if config.row_edge:
        cfg1 = dataclasses.replace(config, row_edge=False,
                                   tex_rows=max(config.tex_rows, 128),
                                   tex_cols=max(config.tex_cols, 384))
        cfg2 = suggest_scan_config(
            grid_n, height, width, sr=config.sr, off=config.off,
            dmax=config.dmax, hyps=config.hyps,
            edge_cull_threshold=config.edge_cull_threshold,
            tex_rows=192, tex_cols=384)
    elif config.patch:
        cfg1 = dataclasses.replace(config, patch=False)
        if config.colfix is not None:
            knobs = dict(sr=6, off=2, dmax=4, hyps=1, colfix=1)
        else:
            knobs = dict(sr=max(config.sr, 12), off=max(config.off, 5),
                         dmax=None, hyps=2)
        cfg2 = suggest_scan_config(
            grid_n, height, width, nbr=max(config.nbr, 2), tex_rows=192,
            tex_cols=384, edge_cull_threshold=config.edge_cull_threshold,
            **knobs)
    else:
        raise ValueError("tier_configs needs a row_edge or patch config")
    return cfg1, cfg2


def _scan_grouped(mvps, vertex_grid, texture, width, height,
                  config: ScanConfig, mode: str, frame_batch: int,
                  gates=None, min_lam: bool = False):
    """One pass over frames in groups -> (outputs, overflow): ``texture_z``
    gives ((T, HPAD, WL) int32 packed, (T, HPAD, WL) float32 raster z),
    ``attrs`` gives (T, 5, HPAD, WL) attrs (``texture`` unused), with
    ``min_lam`` (T, 6, HPAD, WL) (see :func:`march_exact_plain`). ``gates``
    ``(bflag (T, nbands), blkflag (T, nbands, nblk))`` from
    :func:`patch_flags` restricts the pass to the flagged bands and blocks
    (the patch tier's sparse pass)."""
    dev = vertex_grid.device
    mvps, minv = _upload_mvps(mvps, dev)
    T = mvps.shape[0]
    g = ScanGeometry.of(width, height, vertex_grid.shape[0],
                        vertex_grid.shape[1], config)
    plane = (T, g.hpad, g.wl)
    if mode == "texture_z":
        texq = pack_texture(texture)
        outs = (torch.empty(plane, dtype=_I32, device=dev),
                torch.empty(plane, dtype=_F32, device=dev))
    else:
        outs = torch.empty((T, n_attrs(True, min_lam), g.hpad, g.wl),
                           dtype=_F32, device=dev)
    overflow = torch.zeros((), dtype=torch.int64, device=dev)
    for s in range(0, T, frame_batch):
        p = prep_scan(mvps[s:s + frame_batch], vertex_grid, width, height,
                      config)
        overflow = torch.maximum(overflow, p.overflow_rows.max())
        bflag = None
        if gates is not None:
            bounds, mid = apply_patch_gates(
                p.bounds, p.mid, p.canch, gates[1][s:s + frame_batch],
                min(config.cw + 128, g.cl), g.cl)
            p = p._replace(bounds=bounds, mid=mid)
            bflag = gates[0][s:s + frame_batch]
        for i in range(p.win.shape[0]):
            fl = None if bflag is None else bflag[i]
            if mode == "texture_z":
                outs[0][s + i], outs[1][s + i] = _render_pass(
                    p, i, minv[s + i], g, config, texq, mode, fl)
            else:
                args = (p.win[i], p.w0[i], p.bounds[i])
                rec = solve_records(*args, g, config)
                outs[s + i] = march_exact(rec, *args, p.canch[i], p.mid[i],
                                          minv[s + i], g, config,
                                          raster_z=True, min_lam=min_lam)
    return outs, overflow


def merge_row_edge_raw(rgba1, z1, rgba2, z2, width: int, height: int):
    """Depth merge of two ``texture_z`` passes in pass 1's raw layout (T,
    HPAD, WL): pass 2 (the transposed pass over the height x width image)
    wins where its raster z is strictly nearer; padding and exact ties keep
    pass 1 (an exact cross-pass tie is the same triangle)."""
    r2 = torch.zeros_like(rgba1)
    zz2 = torch.full_like(z1, _FAR)
    r2[:, :height, :width] = rgba2[:, :width, :height].transpose(1, 2)
    zz2[:, :height, :width] = z2[:, :width, :height].transpose(1, 2)
    return torch.where(zz2 < z1, r2, rgba1)


def merge_row_edge(a1, a2, width: int, height: int):
    """Depth merge of two passes' attrs (T, 5 or 6, HPAD, WL): pass 2's
    covered pixels win where their raster z is strictly lower, with its
    analytic UVs mapped back (u = 1 - v', v = 1 - u': the grid transpose
    swaps the parameter axes; the least barycentric weight of a sixth plane
    does not swap). Outside the image the result is 0."""
    b1 = a1[:, :, :height, :width]
    b2 = a2[:, :, :width, :height].transpose(2, 3)
    b2m = torch.cat([1.0 - b2[:, 1:2], 1.0 - b2[:, 0:1], b2[:, 2:]], dim=1)
    win2 = (b2[:, 3] > 0.5) & (b2[:, 4] < b1[:, 4])
    out = torch.zeros_like(a1)
    out[:, :, :height, :width] = torch.where(win2[:, None], b2m, b1)
    return out


def wire_coverage(attrs):
    """The wireframe test on merged attrs (T, 6, HPAD, WL) -> (T, 5, HPAD,
    WL): coverage kept where the winner's normalised least barycentric
    weight is at most ``common.WIREFRAME_EDGE_THRESHOLD``, divided first and
    compared after, once, as the JAX package's ``common.shade`` tests
    ``min_lam`` after its attrs merge."""
    cov = (attrs[:, 3] > 0.5) & (attrs[:, 5] <= common.const(
        common.WIREFRAME_EDGE_THRESHOLD, attrs))
    return torch.cat([attrs[:, :3], cov[:, None].to(_F32), attrs[:, 4:5]],
                     dim=1)


def patch_flags(z1, width: int, height: int, nbands2: int, nblocks2: int):
    """The transposed pass's work units that can fill pass-1 holes -> (bflag
    (T, nbands2) int32, blkflag (T, nbands2, nblocks2) bool).

    A hole is a pixel with raster z FAR strictly inside its screen column's
    or its screen row's covered span. Transposed band i' covers original
    columns [8i', 8i'+8), block b' original rows [128b', 128b'+128).
    """
    T = z1.shape[0]
    dev = z1.device
    cov = z1[:, :height, :width] < common.const(_FAR * 0.5, z1)
    big = 1 << 20
    row = torch.arange(height, device=dev)[None, :, None]
    col = torch.arange(width, device=dev)[None, None, :]
    ymin = torch.where(cov, row, big).amin(dim=1, keepdim=True)
    ymax = torch.where(cov, row, -1).amax(dim=1, keepdim=True)
    xmin = torch.where(cov, col, big).amin(dim=2, keepdim=True)
    xmax = torch.where(cov, col, -1).amax(dim=2, keepdim=True)
    hole = ~cov & (((row > ymin) & (row < ymax))
                   | ((col > xmin) & (col < xmax)))
    holep = torch.zeros((T, nblocks2 * 128, nbands2 * 8), dtype=torch.bool,
                        device=dev)
    holep[:, :height, :width] = hole
    f = holep.reshape(T, nblocks2, 128, nbands2, 8)
    blkflag = f.any(dim=4).any(dim=2).transpose(1, 2).contiguous()
    return blkflag.any(dim=2).to(_I32), blkflag


def apply_patch_gates(bounds, mid, canch, blkflag, cwf: int, cl: int):
    """Restrict a prepped pass (batched over T) to the flagged blocks ->
    ``(bounds, mid)``: unflagged blocks get ``mid = -2`` (the march skips
    them), and solve chunks no flagged block can read get zeroed bounds. A
    wide block reads its fetch window [canch_f, canch_f + cwf/128 + 1)
    chunks; a narrow one (``mid >= 0``) the three chunks from its narrow
    window's first."""
    T, nb2, nblk2 = blkflag.shape
    mid_g = mid.reshape(T, nb2, nblk2)
    mid2 = torch.where(blkflag.reshape(T, -1), mid, -2).to(_I32)
    canch_f = (canch * 8) // 128                              # (T, nblk2)
    off_f = canch * 8 - canch_f * 128
    ch_i = torch.arange(cl // 128, device=bounds.device)[None, None, None, :]
    narrow = blkflag & (mid_g >= 0)
    b0 = canch_f[:, None, :] + (torch.clamp(mid_g, min=0) * 8
                                + off_f[:, None, :]) // 128
    lo_w = canch_f[:, None, :]
    lo = torch.where(narrow, b0, lo_w)[..., None]
    hi = torch.where(narrow, b0 + 3, lo_w + (cwf // 128 + 1))[..., None]
    act = (blkflag & (mid_g != -2))[..., None]
    needed = ((ch_i >= lo) & (ch_i < hi) & act).any(dim=2)
    bounds2 = torch.where(needed.reshape(T, -1), bounds, 0).to(_I32)
    return bounds2.contiguous(), mid2.contiguous()


def _transposed(vertex_grid, texture):
    """The second pass's contiguous transposed grid and texture."""
    return (vertex_grid.transpose(0, 1).contiguous(),
            texture.transpose(0, 1).contiguous())


def render_frames_scan_quality(mvps, vertex_grid, texture, width, height,
                               config: ScanConfig, mode: str = "texture",
                               frame_batch: int = FRAME_GROUP):
    """The quality tier (``config.row_edge``) -> ``(frames, overflow)`` as
    :func:`render_frames_scan`.

    Pass 1 is the column scan at ``cfg1``, pass 2 the same passes over the
    transposed problem (transposed grid, ``ROW_EDGE_SWAP @ mvp``, width and
    height swapped) at ``cfg2`` (:func:`tier_configs`). In the ``texture``
    mode each pass shades itself (pass 2 samples the transposed texture) and
    the packed pixels merge by raster z (:func:`merge_row_edge_raw`); in the
    ``debug_z`` and ``wireframe`` modes the attrs merge
    (:func:`merge_row_edge`) and shade once, the wireframe's attrs carrying
    a sixth plane, the winner's normalised least barycentric weight, tested
    after the merge (:func:`wire_coverage`).
    """
    dev = vertex_grid.device
    n_r, n_c = vertex_grid.shape[0], vertex_grid.shape[1]
    cfg1, cfg2 = tier_configs(config, n_r, n_c, width, height)
    mvps = torch.as_tensor(mvps, dtype=_F32).cpu()
    mvps2 = swap_mvps(mvps)
    vgrid_t, tex_t = _transposed(vertex_grid, texture)
    g = ScanGeometry.of(width, height, n_r, n_c, cfg1)
    T = mvps.shape[0]
    out = torch.empty((T, g.hpad, g.wl), dtype=_I32, device=dev)
    overflow = torch.zeros((), dtype=torch.int64, device=dev)
    texq = None if mode == "texture" else pack_texture(texture)
    for s in range(0, T, frame_batch):
        e = min(s + frame_batch, T)
        if mode == "texture":
            (r1, z1), o1 = _scan_grouped(mvps[s:e], vertex_grid, texture,
                                         width, height, cfg1, "texture_z",
                                         frame_batch)
            (r2, z2), o2 = _scan_grouped(mvps2[s:e], vgrid_t, tex_t, height,
                                         width, cfg2, "texture_z",
                                         frame_batch)
            out[s:e] = merge_row_edge_raw(r1, z1, r2, z2, width, height)
        else:
            wire = mode == "wireframe"
            a1, o1 = _scan_grouped(mvps[s:e], vertex_grid, None, width,
                                   height, cfg1, "attrs", frame_batch,
                                   min_lam=wire)
            a2, o2 = _scan_grouped(mvps2[s:e], vgrid_t, None, height, width,
                                   cfg2, "attrs", frame_batch, min_lam=wire)
            merged = merge_row_edge(a1, a2, width, height)
            if wire:
                merged = wire_coverage(merged)
            for i in range(e - s):
                out[s + i] = shade(merged[i], texq, g, cfg1, mode)
        overflow = torch.maximum(overflow, torch.maximum(o1, o2))
    return out, overflow


def render_frames_scan_patched(mvps, vertex_grid, texture, width, height,
                               config: ScanConfig,
                               frame_batch: int = FRAME_GROUP):
    """The patch tier (``config.patch``, texture mode) -> ``(frames,
    overflow)`` as :func:`render_frames_scan`.

    Pass 1 is the column scan at ``cfg1``; its raster z flags the holes
    (:func:`patch_flags`), and the transposed pass at ``cfg2`` runs only on
    the flagged bands (sparse bands) and blocks (:func:`apply_patch_gates`)
    before the same packed depth merge as the quality tier.
    """
    dev = vertex_grid.device
    n_r, n_c = vertex_grid.shape[0], vertex_grid.shape[1]
    cfg1, cfg2 = tier_configs(config, n_r, n_c, width, height)
    mvps = torch.as_tensor(mvps, dtype=_F32).cpu()
    mvps2 = swap_mvps(mvps)
    vgrid_t, tex_t = _transposed(vertex_grid, texture)
    g1 = ScanGeometry.of(width, height, n_r, n_c, cfg1)
    g2 = ScanGeometry.of(height, width, n_c, n_r, cfg2)
    T = mvps.shape[0]
    out = torch.empty((T, g1.hpad, g1.wl), dtype=_I32, device=dev)
    overflow = torch.zeros((), dtype=torch.int64, device=dev)
    for s in range(0, T, frame_batch):
        e = min(s + frame_batch, T)
        (r1, z1), o1 = _scan_grouped(mvps[s:e], vertex_grid, texture, width,
                                     height, cfg1, "texture_z", frame_batch)
        gates = patch_flags(z1, width, height, g2.nbands, g2.nblk)
        (r2, z2), o2 = _scan_grouped(mvps2[s:e], vgrid_t, tex_t, height,
                                     width, cfg2, "texture_z", frame_batch,
                                     gates=gates)
        out[s:e] = merge_row_edge_raw(r1, z1, r2, z2, width, height)
        overflow = torch.maximum(overflow, torch.maximum(o1, o2))
    return out, overflow
