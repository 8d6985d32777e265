"""The tiled rasteriser's binning, its grid route and the lossless control.

Counterpart of ``depthrenderer_tpu/ops/raster_grid.py``. The mesh is a
regular grid, so the triangles that can cover a screen tile form a rectangle
of grid cells: per-tile binning is a window into the projected vertex grid,
placed from exact per-patch projected bounding boxes (:func:`_tile_bounds`,
:func:`_tile_windows`) and sized from measured spans (:func:`measured_config`).
These integers equal the JAX package's.

The grid route renders through the same pixel x triangle kernel as the
Pallas route (``tiled.raster_pairs``, ``csrc/pair.cu``), with the
planes in its own triangle order, (cell, diagonal), ``TC = min(chunk_tris,
2 * cells)`` triangles per chunk, and every chunk of every row-anchored
window, anchor-major, in one chunk list. A sequential strict-``<`` minimum
over that list is the JAX grid path's per-anchor minimum followed by its
strict-``<`` anchor merge (``_render_tile``), ties included.

:func:`render_frame_grid_exact` is the lossless control every fidelity
figure is measured against.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import common, raster_reference, tiled
from .raster_soup import rasterize_soup
from .common import RasterConfig

_F32 = torch.float32
_I32 = torch.int32

# Vertex-grid attribute channels (channel-major grids: (8, R, C)).
_SX, _SY, _Z, _INVW, _UW, _VW, _ZMW, _ZM = range(8)
_BIG = 1 << 30

# Grid cells whose triangles' planes the tiled preps build in one batch of
# frames (each frame's whole grid at once): 16 frames at d10, one from d12.
PREP_CELLS = 1 << 24

# Window area cap, as the JAX package sizes it for the TPU's VMEM (kept so the
# two packages pick the same configs; whether the card should lift it is
# queued in ROADMAP.md).
MAX_CELLS = 10240


def _ceil_to(value: int, mult: int) -> int:
    return -(-value // mult) * mult


def _padded_cells(n_r: int, n_c: int, config: RasterConfig):
    """Cell-grid size after padding: windows always fit and the cell count
    is a patch multiple."""
    ps = config.patch_size
    cells_r = max(_ceil_to(max(n_r - 1, config.window_rows), ps),
                  config.window_rows)
    cells_c = max(_ceil_to(max(n_c - 1, config.window_cols), ps),
                  config.window_cols)
    return cells_r, cells_c


def _pad_edge(x, rows: int, cols: int):
    """Edge-replicate the last two dims of ``x`` up to (rows, cols)."""
    ri = torch.arange(rows, device=x.device).clamp(max=x.shape[-2] - 1)
    ci = torch.arange(cols, device=x.device).clamp(max=x.shape[-1] - 1)
    return x[..., ri[:, None], ci[None, :]]


def _project_attribute_grid(mvp, vertex_grid, uv_grid, width, height):
    """Project the vertex grid -> (8, n_r, n_c) channel-major float32 grid:
    sx, sy, z_ndc, 1/w, u/w, v/w, zm/w, zm."""
    sx, sy, z, inv_w = common.project_vertices_tiled(vertex_grid, mvp, width,
                                                     height)
    zm = vertex_grid[..., 2]
    u, v = uv_grid[..., 0], uv_grid[..., 1]
    return torch.stack([sx, sy, z, inv_w, u * inv_w, v * inv_w, zm * inv_w,
                        zm.expand_as(sx)])


def _padded_grid(mvp, vertex_grid, uv_grid, width, height,
                 config: RasterConfig):
    """The projected attribute grid, edge-padded to the config's cells ->
    (8, R, C), or (8, F, R, C) for F MVPs (F, 4, 4)."""
    n_r, n_c = vertex_grid.shape[0], vertex_grid.shape[1]
    cells_r, cells_c = _padded_cells(n_r, n_c, config)
    vg = _project_attribute_grid(mvp, vertex_grid, uv_grid, width, height)
    return _pad_edge(vg, cells_r + 1, cells_c + 1)


def _tile_bounds(xs, ys, config: RasterConfig, width, height, num_tile_rows,
                 num_tile_cols, ws=None):
    """Exact per-tile candidate cell bounds (r0, r1, c0, c1) from patch
    bboxes.

    :param xs, ys: (R, C) projected x/y grids, padded to patch multiples.
    :param ws: the (R, C) 1/w grid: a corner with 1/w <= 0 (behind the
        camera) is left out of its cell's box. Every triangle with such a
        corner is masked, and its sign-flipped projection would otherwise
        stretch the windows of every tile its patch seems to reach. With no
        corner behind the camera the bounds are the JAX package's.
    :return: four (tiles_r, tiles_c) int32 tensors in cell units.
    """
    ps = config.patch_size
    cells_r, cells_c = xs.shape[0] - 1, xs.shape[1] - 1

    def corners(g):
        return torch.stack([g[:-1, :-1], g[1:, :-1], g[:-1, 1:], g[1:, 1:]])

    front = None if ws is None else corners(ws) > 0

    def cell_minmax(g):
        c = corners(g)
        if front is None:
            return c.amin(0), c.amax(0)
        inf = float("inf")
        return (torch.where(front, c, inf).amin(0),
                torch.where(front, c, -inf).amax(0))

    xmin, xmax = cell_minmax(xs)
    ymin, ymax = cell_minmax(ys)
    pr, pc = cells_r // ps, cells_c // ps

    def patch_reduce(a, op):
        return op(op(a.reshape(pr, ps, pc, ps), dim=3), dim=1)

    pxmin, pxmax = patch_reduce(xmin, torch.amin), patch_reduce(xmax, torch.amax)
    pymin, pymax = patch_reduce(ymin, torch.amin), patch_reduce(ymax, torch.amax)

    # Tile rects over pixel centres, in window coords (y up).
    th, tw = config.tile_h, config.tile_w
    dev = xs.device
    tr = torch.arange(num_tile_rows, dtype=_F32, device=dev)
    tc = torch.arange(num_tile_cols, dtype=_F32, device=dev)
    rx0 = tc * tw + 0.5
    rx1 = tc * tw + (tw - 0.5)
    ry1 = height - (tr * th + 0.5)
    ry0 = height - (tr * th + th - 0.5)

    # Separable overlap masks: (tiles_c, pr, pc) for x, (tiles_r, pr, pc) for
    # y. A tile overlaps patch (p, q) when both hold; the patch rows (cols)
    # it overlaps anywhere are counted by a product over the other axis
    # (0/1 sums of at most 128 terms: exact in float32).
    mx = ((pxmax[None] >= rx0[:, None, None])
          & (pxmin[None] <= rx1[:, None, None])).to(_F32)
    my = ((pymax[None] >= ry0[:, None, None])
          & (pymin[None] <= ry1[:, None, None])).to(_F32)
    rows_hit = torch.einsum("apq,bpq->abp", my, mx) > 0   # (tr, tc, pr)
    cols_hit = torch.einsum("apq,bpq->abq", my, mx) > 0   # (tr, tc, pc)

    pri = torch.arange(pr, dtype=_I32, device=dev)
    pci = torch.arange(pc, dtype=_I32, device=dev)
    big = torch.full((), _BIG, dtype=_I32, device=dev)
    r0p = torch.where(rows_hit, pri, big).amin(-1)
    r1p = torch.where(rows_hit, pri, -big).amax(-1)
    c0p = torch.where(cols_hit, pci, big).amin(-1)
    c1p = torch.where(cols_hit, pci, -big).amax(-1)
    empty = r0p >= _BIG
    zero = torch.zeros_like(r0p)
    r0 = torch.where(empty, zero, r0p) * ps
    r1 = (torch.where(empty, zero, r1p) + 1) * ps
    c0 = torch.where(empty, zero, c0p) * ps
    c1 = (torch.where(empty, zero, c1p) + 1) * ps
    return r0, r1, c0, c1


def _tile_windows(xs, ys, config: RasterConfig, width, height, num_tile_rows,
                  num_tile_cols, ws=None):
    """Per-tile candidate-window starts from exact projected patch bboxes
    (``ws``: see :func:`_tile_bounds`).

    :return: ``(wr, wc, overflow)``: (num_tiles, row_anchors) window row
        starts, (num_tiles,) window column starts, and (num_tiles,) flags of
        tiles whose true candidate span exceeds the anchored windows.
    """
    cells_r, cells_c = xs.shape[0] - 1, xs.shape[1] - 1
    r0, r1, c0, c1 = _tile_bounds(xs, ys, config, width, height,
                                  num_tile_rows, num_tile_cols, ws)
    WR, WC = config.window_rows, config.window_cols
    wr_cap = max(cells_r - WR, 0)
    wc_cap = max(cells_c - WC, 0)
    A = max(config.row_anchors, 1)
    if A == 1:
        wr = torch.clamp(torch.div(r0 + r1 - WR, 2, rounding_mode="floor"),
                         0, wr_cap).reshape(-1, 1)
    else:
        # A row-anchored windows tile the span [r0, r1) from the top; anchors
        # past the span clamp onto it (duplicate coverage, identical planes).
        ks = torch.arange(A, dtype=_I32, device=xs.device) * WR
        top = torch.minimum(r0.reshape(-1)[:, None] + ks[None, :],
                            torch.clamp(r1.reshape(-1)[:, None] - WR, min=0))
        wr = torch.clamp(top, 0, wr_cap)
    wc = torch.clamp(torch.div(c0 + c1 - WC, 2, rounding_mode="floor"),
                     0, wc_cap)
    overflow = ((r1 - r0) > A * WR) | ((c1 - c0) > WC)
    return wr.to(_I32), wc.reshape(-1).to(_I32), overflow.reshape(-1)


def _tile_spans(xs, ys, config, width, height, num_tile_rows, num_tile_cols,
                ws=None):
    """Per-tile candidate-cell spans (rows, cols) for one view."""
    r0, r1, c0, c1 = _tile_bounds(xs, ys, config, width, height,
                                  num_tile_rows, num_tile_cols, ws)
    return r1 - r0, c1 - c0


def measured_config(mvps, vertex_grid, width, height, sample: int = 3,
                    quantile: float = 0.995, row_anchors: int = 1,
                    **overrides) -> RasterConfig:
    """Size the candidate window from measured per-tile candidate spans over
    ``sample`` of the MVPs: the ``quantile`` of the spans (1.0 = lossless),
    rows split over ``row_anchors`` windows, the area capped at
    :data:`MAX_CELLS`. The same config as the JAX package's function; the
    percentile is numpy's, on the host."""
    vertex_grid = torch.as_tensor(vertex_grid, dtype=_F32)
    mvps = torch.as_tensor(mvps, dtype=_F32,
                           device=vertex_grid.device).reshape(-1, 4, 4)
    n = vertex_grid.shape[0]
    probe = common.suggest_config(n, width, height, **dict(overrides))
    ps = probe.patch_size
    take = np.linspace(0, len(mvps) - 1, min(sample, len(mvps))).astype(int)
    cells = max(_ceil_to(n - 1, ps), ps)
    th, tw = probe.tile_h, probe.tile_w
    ntr, ntc = -(-height // th), -(-width // tw)

    r_spans, c_spans = [], []
    for k in take:
        sx, sy, _, iw = (_pad_edge(g, cells + 1, cells + 1) for g in
                         common.project_vertices_tiled(vertex_grid, mvps[k],
                                                       width, height))
        rs, cs = _tile_spans(sx, sy, probe, width, height, ntr, ntc, iw)
        r_spans.append(rs.cpu().numpy().ravel())
        c_spans.append(cs.cpu().numpy().ravel())

    q = min(max(quantile, 0.0), 1.0) * 100.0
    max_r = int(np.percentile(np.concatenate(r_spans), q))
    max_c = int(np.percentile(np.concatenate(c_spans), q))
    max_r = -(-max_r // max(row_anchors, 1))
    rows = min(cells, _ceil_to(max(max_r + ps, 8), 8))
    cols = min(cells, _ceil_to(max(max_c + ps, 16), 16))
    while rows * cols > MAX_CELLS and (rows > 8 or cols > 16):
        if rows >= cols and rows > 8:
            rows -= 8
        elif cols > 16:
            cols -= 16
        else:
            rows -= 8
    return dataclasses.replace(probe, window_rows=rows, window_cols=cols,
                               row_anchors=row_anchors)


def binning_overflow_tiles(mvps, vertex_grid, uv_grid, width, height,
                           config: RasterConfig):
    """Count tiles whose true candidate span exceeds the anchored windows,
    per MVP -> (T,) int32 tensor. Binning only, no rendering."""
    vertex_grid = torch.as_tensor(vertex_grid, dtype=_F32)
    mvps = torch.as_tensor(mvps, dtype=_F32,
                           device=vertex_grid.device).reshape(-1, 4, 4)
    n_r, n_c = vertex_grid.shape[0], vertex_grid.shape[1]
    cells_r, cells_c = _padded_cells(n_r, n_c, config)
    ntr = -(-height // config.tile_h)
    ntc = -(-width // config.tile_w)
    counts = []
    for mvp in mvps:
        sx, sy, _, iw = (_pad_edge(g, cells_r + 1, cells_c + 1) for g in
                         common.project_vertices_tiled(vertex_grid, mvp,
                                                       width, height))
        r0, r1, c0, c1 = _tile_bounds(sx, sy, config, width, height, ntr,
                                      ntc, iw)
        over = (((r1 - r0) > config.window_rows * config.row_anchors)
                | ((c1 - c0) > config.window_cols))
        counts.append(over.sum().to(_I32))
    return torch.stack(counts)


# ---------------------------------------------------------------------------
# The grid route
# ---------------------------------------------------------------------------

def _corners(g):
    return g[..., :-1, :-1], g[..., 1:, :-1], g[..., :-1, 1:], g[..., 1:, 1:]


def _triangle(g, diag):
    a, b, c, d = _corners(g)
    return (a, b, c) if diag == 0 else (c, b, d)


def _cell_planes_grid(vg, config: RasterConfig, out=None, cell0=0):
    """Planes of every triangle of a padded grid, in the grid route's
    formula (``common.triangle_planes``; the JAX ``_tile_planes``).

    :param vg: (8, R, C) padded channel-major grid, or (8, F, R, C) for F
        frames at once.
    :param out: the (cov, attr) tables to write, else new ones.
    :param cell0: the first cell (row-major) of ``vg``'s cells in ``out``,
        when ``vg`` holds a slab of the grid's cell rows.
    :return: ``(cov, attr)``, each (12, 2 * cells + 1) float32, or (F, 12,
        2 * cells + 1): column
        ``2 * cell + diag`` (cells row-major), the last column the never-
        covered plane. cov rows are [A, B, C] of λ0, λ1, λ2, z; attr rows of
        u/w, v/w, 1/w, zm/w.
    """
    cov_t, attr_t = tiled.new_tables(vg) if out is None else out
    never = torch.zeros((4, 3), dtype=_F32, device=vg.device)
    never[:3, 2] = -1.0
    never[3, 2] = common.FAR_SENTINEL
    for diag in (0, 1):
        x = _triangle(vg[_SX], diag)
        y = _triangle(vg[_SY], diag)
        z = _triangle(vg[_Z], diag)
        w = _triangle(vg[_INVW], diag)
        p = [torch.stack([x[k], y[k]], dim=-1) for k in range(3)]
        coeffs, area2 = common.triangle_planes(*p, *z)   # (..., 4, 3)
        valid = (area2 > 1e-12) & (w[0] > 0) & (w[1] > 0) & (w[2] > 0)
        if config.edge_cull_threshold is not None:
            m = _triangle(vg[_ZM], diag)
            spread = (torch.maximum(m[0], torch.maximum(m[1], m[2]))
                      - torch.minimum(m[0], torch.minimum(m[1], m[2])))
            valid &= spread <= config.edge_cull_threshold
        coeffs = torch.where(valid[..., None, None], coeffs, never)
        # attr plane (a, x) = sum over corners c of attr[c, a] * lam[c, x],
        # the 3-term dot rounded as XLA's CPU backend rounds it.
        corner = [_triangle(vg[ch], diag) for ch in (_UW, _VW, _INVW, _ZMW)]
        rows = []
        for a in range(4):
            for xk in range(3):
                lam = [coeffs[..., c, xk] for c in range(3)]
                rows.append(common.fma(
                    corner[a][2], lam[2],
                    common.fma(corner[a][1], lam[1], corner[a][0] * lam[0])))
        tiled.write_planes(cov_t, diag, coeffs.reshape(
            coeffs.shape[:-2] + (12,)).movedim(-1, 0), cell0)
        tiled.write_planes(attr_t, diag, torch.stack(rows), cell0)
    tiled.write_padding(cov_t, attr_t, never.reshape(12))
    return cov_t, attr_t


def _grid_chunks(config: RasterConfig):
    """(TC, chunks per anchor) of the grid route."""
    tris = 2 * config.window_rows * config.window_cols
    tc = min(config.chunk_tris, tris)
    return tc, -(-tris // tc)


def _grid_rel(config: RasterConfig, cells_c: int, device):
    """(chunks, TC) source column of each chunk slot relative to
    ``2 * (window origin cell)``, in (cell, diagonal) order; -1 = padding."""
    tc, nch = _grid_chunks(config)
    k = torch.arange(nch * tc, device=device)
    cell = k // 2
    rel = 2 * ((cell // config.window_cols) * cells_c
               + cell % config.window_cols) + k % 2
    rel = torch.where(k < 2 * config.window_rows * config.window_cols, rel, -1)
    return rel.reshape(nch, tc)


def prep_batches(frames: int, n_r: int, n_c: int, config: RasterConfig):
    """How the tiled preps build a group's planes, within
    :data:`PREP_CELLS` cells at once -> ``[(frames, [rows, ...]), ...]``:
    slices of frames, each built in slabs of whole cell rows (as many frames
    as hold PREP_CELLS cells in one slab each, or one frame in slabs of
    PREP_CELLS cells)."""
    cells_r, cells_c = _padded_cells(n_r, n_c, config)
    if cells_r * cells_c <= PREP_CELLS:
        step = PREP_CELLS // (cells_r * cells_c)
        return [(slice(s, min(s + step, frames)), [slice(0, cells_r)])
                for s in range(0, frames, step)]
    rows = max(1, PREP_CELLS // cells_c)
    slabs = [slice(r, min(r + rows, cells_r))
             for r in range(0, cells_r, rows)]
    return [(slice(f, f + 1), slabs) for f in range(frames)]


def cell_planes_of(planes_fn, vgs, config: RasterConfig, tables, slabs):
    """Run a route's plane builder (``planes_fn(vg, config, out, cell0)``)
    over a frame batch's padded grids ``vgs`` (8, F, R, C) slab by slab of
    cell rows, into ``tables`` (F, 12, N)."""
    cells_c = vgs.shape[-1] - 1
    for rows in slabs:
        planes_fn(vgs[..., rows.start:rows.stop + 1, :], config, tables,
                  rows.start * cells_c)


def _grid_group(mvps, vertex_grid, uv_grid, width, height,
                config: RasterConfig):
    """Plane tables and windows of a frame group on the grid route ->
    ``(cov, attr, origin, rel, px0, py0, jlo, jhi)`` with the (frame, tile)
    axes merged: the frames' (F, 12, N) tables and each tile's row-anchored
    windows, every anchor's chunks one after the other per tile (see
    ``tiled.raster_pairs``). The planes of several frames are built at once
    (:func:`prep_batches`)."""
    ntr = -(-height // config.tile_h)
    ntc = -(-width // config.tile_w)
    tables, origins = None, []
    for batch, slabs in prep_batches(len(mvps), vertex_grid.shape[0],
                                     vertex_grid.shape[1], config):
        vgs = _padded_grid(mvps[batch], vertex_grid, uv_grid, width, height,
                           config)
        if tables is None:
            tables = tiled.new_tables(vgs, len(mvps))
        cell_planes_of(_cell_planes_grid, vgs, config,
                       (tables[0][batch], tables[1][batch]), slabs)
        for f in range(batch.start, batch.stop):
            vg = vgs[:, f - batch.start]
            wr, wc, _ = _tile_windows(vg[_SX], vg[_SY], config, width,
                                      height, ntr, ntc, vg[_INVW])
            origin = 2 * (wr.long() * (vg.shape[2] - 1) + wc.long()[:, None])
            origins.append(origin.reshape(-1) + f * tables[0][f].numel())
    rel = _grid_rel(config, vgs.shape[-1] - 1, vgs.device).to(_I32)
    n = len(mvps) * ntr * ntc
    dev = vgs.device
    px0, py0 = tiled.tile_origins(config, width, height, dev)
    jlo = torch.zeros((n,), dtype=_I32, device=dev)
    jhi = torch.full((n,), config.row_anchors * rel.shape[0], dtype=_I32,
                     device=dev)
    return tables + (torch.cat(origins), rel, px0.repeat(len(mvps)),
                     py0.repeat(len(mvps)), jlo, jhi)


def table_bytes_per_frame(n_r: int, n_c: int, config: RasterConfig) -> int:
    """Device bytes of one frame's plane tables (cov + attr) on either
    tiled route, for an (n_r, n_c) vertex grid."""
    cells_r, cells_c = _padded_cells(n_r, n_c, config)
    return 2 * 12 * (2 * cells_r * cells_c + 1) * 4


def frame_group(n_r: int, n_c: int, config: RasterConfig,
                frame_batch: int = 16) -> int:
    """Frames per prep and pair kernel launch on either tiled route:
    ``frame_batch``, clamped so a group's plane tables stay within
    ``tiled.COEFF_BUDGET``."""
    per_frame = table_bytes_per_frame(n_r, n_c, config)
    return max(1, min(frame_batch, tiled.COEFF_BUDGET // per_frame))


def render_frames_grid(mvps, vertex_grid, uv_grid, texture, width, height,
                       config: RasterConfig = RasterConfig(),
                       mode: str = "texture", frame_batch: int = 16):
    """Render frames through the grid route -> (T, height, width, 4) uint8 on
    the device of ``vertex_grid``; in ``texture_z`` mode also the (T,
    height, width) float32 NDC depth of each pixel (``FAR_SENTINEL`` where
    nothing covers it), the control's depth-merge key.

    Frames go in groups of ``frame_batch``, clamped so a group's plane
    tables stay within ``tiled.COEFF_BUDGET``: one prep, one pair
    kernel launch and one shade per group.

    :param texture: (Ht, Wt, 4) texels (0..255).
    :param mode: ``texture``, ``debug_z``, ``wireframe`` or ``texture_z``.
    """
    vertex_grid = torch.as_tensor(vertex_grid, dtype=_F32)
    dev = vertex_grid.device
    uv_grid = torch.as_tensor(uv_grid, dtype=_F32, device=dev)
    texture = torch.as_tensor(texture, device=dev)
    mvps = torch.as_tensor(mvps, dtype=_F32, device=dev).reshape(-1, 4, 4)
    T = mvps.shape[0]
    fb = frame_group(vertex_grid.shape[0], vertex_grid.shape[1], config,
                     frame_batch)
    ntiles = (-(-height // config.tile_h)) * (-(-width // config.tile_w))
    out = torch.empty((T, height, width, 4), dtype=torch.uint8, device=dev)
    zout = (torch.empty((T, height, width), dtype=_F32, device=dev)
            if mode == "texture_z" else None)
    for s in range(0, T, fb):
        planes = _grid_group(mvps[s:s + fb], vertex_grid, uv_grid, width,
                             height, config)
        tiles = tiled.raster_pairs(*planes, height, config)
        shaded = tiled.shade_tiles(
            tiles.reshape((-1, ntiles) + tiles.shape[1:]), texture, width,
            height, config, mode)
        if zout is None:
            out[s:s + fb] = shaded
        else:
            out[s:s + fb], zout[s:s + fb] = shaded
    return out if zout is None else (out, zout)


def render_frame_grid(mvp, vertex_grid, uv_grid, texture, width, height,
                      config: RasterConfig = RasterConfig(),
                      mode: str = "texture"):
    """One frame of a grid mesh through the grid route -> (height, width, 4)
    uint8 (and its (height, width) depth in ``texture_z`` mode)."""
    out = render_frames_grid(torch.as_tensor(mvp, dtype=_F32)[None],
                             vertex_grid, uv_grid, texture, width, height,
                             config, mode, frame_batch=1)
    if mode == "texture_z":
        return out[0][0], out[1][0]
    return out[0]


def straddlers(mvp, vertex_grid):
    """The grid's triangles with corners on both sides of the camera plane
    (``clip_w <= 0`` and ``> 0``), in host float64 -> (k, 3) int64 vertex
    ids (row-major grid vertices), in the grid routes' triangle order."""
    mvp64 = raster_reference.host(mvp, np.float64)
    v = raster_reference.host(vertex_grid, np.float64)
    n_r, n_c = v.shape[:2]
    w = v.reshape(-1, 3) @ mvp64[3, :3] + mvp64[3, 3]   # clip w
    ids = np.arange(n_r * n_c, dtype=np.int64).reshape(n_r, n_c)
    a, b = ids[:-1, :-1], ids[1:, :-1]
    c, d = ids[:-1, 1:], ids[1:, 1:]
    tris = np.stack([np.stack([a, b, c], -1), np.stack([c, b, d], -1)],
                    axis=2).reshape(-1, 3)
    wt = w[tris]
    return tris[(wt <= 0).any(axis=1) & (wt > 0).any(axis=1)]


def straddling_triangles(mvp, vertex_grid) -> int:
    """Count the grid's triangles with corners on both sides of the camera
    plane, in host float64."""
    return len(straddlers(mvp, vertex_grid))


def straddler_soup(tris, vertex_grid, uv_grid, mvp):
    """Straddling triangles ``tris`` (:func:`straddlers`) as a soup, clipped
    at GL's near plane (``raster_reference.clip_gl_near``) -> ``(vertices
    (V, 3) float32, uvs (V, 2), indices (3 k,))`` on the host. The soup
    holds only the vertices the triangles use: a vertex's projection does
    not depend on the others."""
    used, local = np.unique(tris, return_inverse=True)
    v = raster_reference.host(vertex_grid, np.float32).reshape(-1, 3)[used]
    uv = raster_reference.host(uv_grid, np.float32).reshape(-1, 2)[used]
    v2, uv2, idx2 = raster_reference.clip_gl_near(
        v, uv, local.reshape(-1), mvp)
    return v2.astype(np.float32), uv2, idx2


def render_frame_grid_exact(mvp, vertex_grid, uv_grid, texture, width,
                            height, strips: int = 1, max_anchors: int = 64,
                            mode: str = "texture", edge_cull_threshold=None,
                            with_stats: bool = False):
    """The provably lossless single-frame render: the control the fast
    routes are measured against.

    * **Strips**: the frame renders in ``strips`` horizontal slices, each
      through a strip-viewport projection (an exact host-float64 NDC-y remap
      composed into the MVP), bounding the per-call plane tables.
    * **Row anchors**: raised until :func:`binning_overflow_tiles` proves that
      no tile exceeds its anchored windows, so no candidate is dropped.
    * **Near-plane straddlers**: the grid route masks the triangles with
      corners on both sides of the camera plane. In ``texture`` mode they
      are clipped exactly in host float64 and rendered through the soup
      (``raster_soup.rasterize_soup(mode="texture_z")``), and the strips,
      rendered in ``texture_z`` (the strip remap changes only row 1 of the
      MVP, so every strip's NDC z is the same key), take the soup's pixel
      where its depth is strictly less: GL's depth test across one draw
      call, the grid winning a tie.

    :return: (height, width, 4) uint8 numpy frame, and with ``with_stats``
        ``{"config": the RasterConfig it settled on, "strips": strips,
        "straddlers": straddling triangles, "soup_triangles": the clipped
        soup's triangles, "soup_won": pixels the soup took}``.
    """
    vertex_grid = torch.as_tensor(vertex_grid, dtype=_F32)
    dev = vertex_grid.device
    strips = max(strips, 1)
    while height % strips:   # equal strip heights
        strips += 1
    hs = height // strips
    mvp64 = raster_reference.host(mvp, np.float64)
    mvps_k = []
    for k in range(strips):
        r1 = (k + 1) * hs
        S = np.eye(4, dtype=np.float64)
        S[1, 1] = height / hs
        S[1, 3] = (2.0 * r1 - height) / hs - 1.0
        mvps_k.append((S @ mvp64).astype(np.float32))
    mvps_k = torch.from_numpy(np.stack(mvps_k)).to(dev)

    anchors = 1
    while True:
        cfg = measured_config(mvps_k, vertex_grid, width, hs, sample=strips,
                              quantile=1.0, row_anchors=anchors,
                              edge_cull_threshold=edge_cull_threshold)
        ovf = int(binning_overflow_tiles(mvps_k, vertex_grid, uv_grid, width,
                                         hs, cfg).max())
        if ovf == 0:
            break
        if anchors >= max_anchors:
            raise RuntimeError(
                f"render_frame_grid_exact: {ovf} tile(s) still overflow at "
                f"{anchors} row anchors (column spans exceed the capped "
                f"window?); raise max_anchors or strips")
        anchors = min(anchors * 2, max_anchors)

    tris = straddlers(mvp, vertex_grid)
    soup, nsoup = None, 0
    if mode == "texture" and len(tris):
        sv, suv, sidx = straddler_soup(tris, vertex_grid, uv_grid, mvp)
        nsoup = len(sidx) // 3
        soup = rasterize_soup(torch.from_numpy(sv).to(dev), suv, sidx,
                              torch.as_tensor(mvp, dtype=_F32), texture,
                              width, height, mode="texture_z",
                              edge_cull_threshold=edge_cull_threshold)
    gmode = "texture_z" if soup is not None else mode
    parts = [render_frame_grid(mvps_k[k], vertex_grid, uv_grid, texture,
                               width, hs, cfg, gmode) for k in range(strips)]
    won = 0
    if soup is None:
        frame = torch.cat(parts, 0)
    else:
        frame = torch.cat([p[0] for p in parts], 0)
        take = soup[1] < torch.cat([p[1] for p in parts], 0)
        frame = torch.where(take[..., None], soup[0], frame)
        won = int(take.sum())
    frame = frame.cpu().numpy()
    if with_stats:
        return frame, {"config": cfg, "strips": strips,
                       "straddlers": len(tris), "soup_triangles": nsoup,
                       "soup_won": won}
    return frame
