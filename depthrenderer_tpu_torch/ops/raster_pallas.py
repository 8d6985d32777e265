"""The tiled rasteriser's Pallas route, on PyTorch and CUDA.

Counterpart of ``depthrenderer_tpu/ops/raster_pallas.py``, in three stages
per frame group:

1. **prep** (plain PyTorch): project the grid, bin the tiles
   (``raster_grid._tile_bounds``), build the λ/z and attribute planes of every
   triangle of the grid once into the frame's plane tables, and place each
   tile's candidate window in them: its table origin, the route's relative
   columns in the JAX route's triangle order (chunk, diagonal, cell; -1 for
   the ``never`` padding) and the exact active chunk range ``[jlo, jhi)``
   per tile and anchor pass.
2. **pairs** (``tiled.raster_pairs``): per 8x128 tile, every active chunk's
   planes at every pixel: coverage, min z with lowest-id ties, the winner's
   attributes, strict-``<`` chunk merge. One launch of the hand-written CUDA
   kernel (``csrc/pair.cu``) per frame group, reading the windows' chunks
   straight from the tables.
3. **shade** (plain PyTorch): merge the two anchor passes by depth (strict
   ``<``), assemble the tiles and shade (``tiled.shade_tiles``).

The grid route (``raster_grid.render_frames_grid``) runs the same kernel on
its own plane order.
"""

from __future__ import annotations

import torch

from . import common, raster_grid, tiled
from .common import RasterConfig

_F32 = torch.float32
_I32 = torch.int32
_FAR = float(common.FAR_SENTINEL)
# The padding plane's cov column: λ0 C = -1 (never covered), z C = FAR.
_NEVER_COV = (0.0, 0.0, -1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, _FAR)


# ---------------------------------------------------------------------------
# Prep
# ---------------------------------------------------------------------------

def _cell_planes(vg, config: RasterConfig, out=None, cell0=0):
    """Planes of every triangle of a padded grid, in the Pallas route's
    formula (the JAX ``_prep_tile_planes``, computed once for the whole grid
    instead of once per window: a plane depends only on its cell).

    Rounded as XLA's CPU backend rounds the JAX expressions under ``jit``:
    ``a*b - c*d`` is ``fma(a, b, -(c*d))`` and ``a*b + c*d + e*f`` is
    ``fma(e, f, fma(a, b, c*d))``.

    :param vg: (8, R, C) padded channel-major grid, or (8, F, R, C) for F
        frames at once.
    :param out: the (cov, attr) tables to write, else new ones.
    :param cell0: the first cell (row-major) of ``vg``'s cells in ``out``,
        when ``vg`` holds a slab of the grid's cell rows.
    :return: ``(cov, attr)``, each (12, 2 * cells + 1) float32, or (F, 12,
        2 * cells + 1): column
        ``2 * cell + diag`` (cells row-major), the last column the padding
        plane (λ0 C = -1, z C = FAR for cov; zeros for attr).
    """
    sx, sy, z, invw, uw, vw, zmw, zm = vg
    cov, attr = tiled.new_tables(vg) if out is None else out
    for diag in (0, 1):
        def tri(g):
            return raster_grid._triangle(g, diag)

        x0, x1, x2 = tri(sx)
        y0, y1, y2 = tri(sy)
        fma = common.fma
        area2 = fma(x1 - x0, y2 - y0, -((y1 - y0) * (x2 - x0)))
        valid = area2 > 1e-12
        w0, w1, w2 = tri(invw)
        valid &= (w0 > 0) & (w1 > 0) & (w2 > 0)
        if config.edge_cull_threshold is not None:
            m0, m1, m2 = tri(zm)
            spread = (torch.maximum(m0, torch.maximum(m1, m2))
                      - torch.minimum(m0, torch.minimum(m1, m2)))
            valid &= spread <= config.edge_cull_threshold
        one = torch.ones_like(area2)
        inv_area = torch.where(valid, one / torch.where(valid, area2, one),
                               torch.zeros_like(area2))

        def edge(ax, ay, bx, by):
            return (-(by - ay) * inv_area, (bx - ax) * inv_area,
                    fma(by - ay, ax, -((bx - ax) * ay)) * inv_area)

        lam = [edge(x1, y1, x2, y2), edge(x2, y2, x0, y0),
               edge(x0, y0, x1, y1)]
        lam[0] = tuple(torch.where(valid, c, k)
                       for c, k in zip(lam[0], (0.0, 0.0, -1.0)))

        def combine(v0, v1, v2):
            return [fma(v2, lam[2][k], fma(v0, lam[0][k], v1 * lam[1][k]))
                    for k in range(3)]

        zp = [torch.where(valid, c, k)
              for c, k in zip(combine(*tri(z)), (0.0, 0.0, _FAR))]
        cov_rows = list(lam[0]) + list(lam[1]) + list(lam[2]) + zp
        attr_rows = (combine(*tri(uw)) + combine(*tri(vw))
                     + combine(*tri(invw)) + combine(*tri(zmw)))
        tiled.write_planes(cov, diag, torch.stack(cov_rows), cell0)
        tiled.write_planes(attr, diag, torch.stack(attr_rows), cell0)
    tiled.write_padding(cov, attr, _NEVER_COV)
    return cov, attr


def _chunks(config: RasterConfig):
    """(TC cells per chunk, cell chunks per window); a window has twice as
    many plane chunks (one per diagonal class)."""
    cells = config.window_rows * config.window_cols
    tc = min(config.chunk_tris // 2, cells)
    return tc, -(-cells // tc)


def _window_rel(config: RasterConfig, cells_c: int, device):
    """(2 * chunks, TC) source column of each chunk slot relative to
    ``2 * (window origin cell)``, in (chunk, diagonal, cell) order; -1 =
    padding."""
    tc, nc = _chunks(config)
    WC = config.window_cols
    k = torch.arange(nc * tc, device=device)
    rel = 2 * ((k // WC) * cells_c + k % WC)
    rel = torch.where(k < config.window_rows * WC, rel, -1).reshape(nc, 1, tc)
    diag = torch.arange(2, device=device).reshape(1, 2, 1)
    return torch.where(rel >= 0, rel + diag, -1).reshape(2 * nc, tc)


def _active_range(sy, wr, wc, py0, row_floor, height, config: RasterConfig):
    """Exact active chunk range [jlo, jhi) per window from the window
    columns' y extents; chunks that end above ``row_floor`` are skipped
    (pass B of two anchors)."""
    WR, WC = config.window_rows, config.window_cols
    tc, nc = _chunks(config)
    dev = sy.device
    rows = wr.long()[:, None] + torch.arange(WR + 1, device=dev)
    cols = wc.long()[:, None] + torch.arange(WC + 1, device=dev)
    win = sy[rows[:, :, None], cols[:, None, :]]   # (n, WR+1, WC+1)
    rmin, rmax = win.amin(-1), win.amax(-1)
    row_ymin = torch.minimum(rmin[:, :-1], rmin[:, 1:])
    row_ymax = torch.maximum(rmax[:, :-1], rmax[:, 1:])
    tile_ymin = height - (py0.to(_F32) + config.tile_h - 0.5)
    tile_ymax = height - (py0.to(_F32) + 0.5)
    rows_per_chunk = tc // WC if tc % WC == 0 else -(-tc // WC) + 1
    j = torch.arange(nc, device=dev)
    ridx = torch.clamp(((j * tc) // WC)[:, None]
                       + torch.arange(rows_per_chunk, device=dev), 0, WR - 1)
    cymin = row_ymin[:, ridx].amin(-1)
    cymax = row_ymax[:, ridx].amax(-1)
    active = (cymax >= tile_ymin[:, None]) & (cymin <= tile_ymax[:, None])
    active &= ((j + 1) * tc - 1) // WC >= row_floor[:, None]
    any_active = active.any(1)
    first = active.to(_I32).argmax(1)
    last = (nc - 1) - active.flip(1).to(_I32).argmax(1)
    zero = torch.zeros_like(first)
    jlo = torch.where(any_active, 2 * first, zero).to(_I32)
    jhi = torch.where(any_active, 2 * (last + 1), zero).to(_I32)
    return jlo, jhi


def _window_origins(vg, wr, wc):
    """(n,) int64 table column of each window's first cell (diagonal 0)."""
    return 2 * (wr.long() * (vg.shape[2] - 1) + wc.long())


def _prep_tile_planes(vg, wr, wc, px0, py0, row_floor, height,
                      config: RasterConfig):
    """Chunk planes of a batch of tile windows on one padded grid (the JAX
    function's layout, gathered from the grid's plane tables).

    :param vg: (8, R, C) padded channel-major projected grid.
    :param wr, wc, px0, py0, row_floor: (n,) int window origins (cells),
        tile origins (pixels) and pass-B row floors.
    :return: ``(cov, attr, jlo, jhi)``: (n, 2 * chunks, 12, TC) float32
        planes ([A, B, C] rows of λ0, λ1, λ2, z and of u/w, v/w, 1/w, zm/w)
        and (n,) int32 active chunk ranges.
    """
    del px0  # column skipping is not worthwhile at full-width chunks
    row_floor = torch.as_tensor(row_floor, device=vg.device)
    part = _cell_planes(vg, config) + (
        _window_origins(vg, wr, wc),
        _window_rel(config, vg.shape[2] - 1, vg.device))
    return tiled.gather_windows(part) + _active_range(
        vg[raster_grid._SY], wr, wc, py0, row_floor, height, config)


def _tile_passes(vg, config: RasterConfig, width, height):
    """Window origins of every (anchor pass, tile) of one frame ->
    ``(wr, wc, px0, py0, floors)``, each (row_anchors * ntiles,) int32."""
    th, tw = config.tile_h, config.tile_w
    ntr, ntc = -(-height // th), -(-width // tw)
    WR, WC = config.window_rows, config.window_cols
    cr, cc = vg.shape[1] - 1, vg.shape[2] - 1
    r0, r1, c0, c1 = raster_grid._tile_bounds(
        vg[raster_grid._SX], vg[raster_grid._SY], config, width, height, ntr,
        ntc, vg[raster_grid._INVW])
    r0, r1, c0, c1 = (a.reshape(-1) for a in (r0, r1, c0, c1))
    wc_ = torch.clamp(torch.div(c0 + c1 - WC, 2, rounding_mode="floor"), 0,
                      max(cc - WC, 0))
    px0, py0 = tiled.tile_origins(config, width, height, vg.device)
    if config.row_anchors == 1:
        wr = torch.clamp(torch.div(r0 + r1 - WR, 2, rounding_mode="floor"), 0,
                         max(cr - WR, 0))
        return (wr.to(_I32), wc_.to(_I32), px0, py0,
                torch.zeros_like(px0))
    wr_a = torch.clamp(r0, 0, max(cr - WR, 0))
    wr_b = torch.maximum(torch.clamp(r1 - WR, 0, max(cr - WR, 0)), wr_a)
    # Pass B skips the rows pass A already covers; tiles that fit one window
    # get an empty pass B (floor = WR).
    floor_b = torch.clamp(wr_a + WR - wr_b, 0, WR)
    floor_b = torch.where(r1 - r0 <= WR, torch.full_like(floor_b, WR), floor_b)
    return (torch.cat([wr_a, wr_b]).to(_I32), torch.cat([wc_, wc_]).to(_I32),
            torch.cat([px0, px0]), torch.cat([py0, py0]),
            torch.cat([torch.zeros_like(floor_b), floor_b]).to(_I32))


def _prep_stage_batched(mvps, vertex_grid, uv_grid, width, height,
                        config: RasterConfig):
    """Prep of a frame group, (frame, anchor pass, tile) axes merged ->
    ``(cov, attr, origin, rel, px0, py0, jlo, jhi)``: the frames' (F, 12, N)
    plane tables, each frame's built over its whole grid once (several
    frames at once: ``raster_grid.prep_batches``), and the windows in them
    (see ``tiled.raster_pairs``)."""
    vertex_grid = torch.as_tensor(vertex_grid, dtype=_F32)
    uv_grid = torch.as_tensor(uv_grid, dtype=_F32, device=vertex_grid.device)
    mvps = torch.as_tensor(mvps, dtype=_F32,
                           device=vertex_grid.device).reshape(-1, 4, 4)
    tables, ints = None, []
    for batch, slabs in raster_grid.prep_batches(
            len(mvps), vertex_grid.shape[0], vertex_grid.shape[1], config):
        vgs = raster_grid._padded_grid(mvps[batch], vertex_grid, uv_grid,
                                       width, height, config)
        if tables is None:
            tables = tiled.new_tables(vgs, len(mvps))
        raster_grid.cell_planes_of(_cell_planes, vgs, config,
                                   (tables[0][batch], tables[1][batch]),
                                   slabs)
        for f in range(batch.start, batch.stop):
            vg = vgs[:, f - batch.start]
            wr, wc, px0, py0, floors = _tile_passes(vg, config, width, height)
            jlo, jhi = _active_range(vg[raster_grid._SY], wr, wc, py0,
                                     floors, height, config)
            ints.append((_window_origins(vg, wr, wc)
                         + f * tables[0][f].numel(), px0, py0, jlo, jhi))
    rel = _window_rel(config, vgs.shape[-1] - 1, vgs.device).to(_I32)
    origin, px0, py0, jlo, jhi = (torch.cat(a) for a in zip(*ints))
    return tables + (origin, rel, px0, py0, jlo, jhi)


def _prep_stage_impl(mvp, vertex_grid, uv_grid, width, height,
                     config: RasterConfig):
    """Prep of one frame in the JAX function's layout -> ``(cov, attr, px0,
    py0, jlo, jhi)``: the windows' (n, 2 * chunks, 12, TC) chunk planes
    over the (anchor pass, tile) axis."""
    cov, attr, origin, rel, px0, py0, jlo, jhi = _prep_stage_batched(
        torch.as_tensor(mvp, dtype=_F32)[None], vertex_grid, uv_grid, width,
        height, config)
    return tiled.gather_tables(cov, attr, origin, rel, px0.shape[0]) + (
        px0, py0, jlo, jhi)


def _shade_stage_batched(tiles, texture, width, height, config: RasterConfig,
                         mode: str):
    """Split the merged (frame, anchor pass, tile) axis, merge the two anchor
    passes by depth (strict ``<``: pass A wins ties) and shade."""
    ntiles = (-(-height // config.tile_h)) * (-(-width // config.tile_w))
    tiles = tiles.reshape((-1, config.row_anchors, ntiles) + tiles.shape[1:])
    merged = tiles[:, 0]
    if config.row_anchors == 2:
        b = tiles[:, 1]
        merged = torch.where((b[..., 4] < merged[..., 4])[..., None], b,
                             merged)
    return tiled.shade_tiles(merged, texture, width, height, config, mode)


def _check_anchors(config: RasterConfig):
    assert config.row_anchors <= 2, \
        "the Pallas tiled path implements 1 or 2 row anchors (use the grid " \
        "path for higher anchor counts)"


def render_frames_pallas(mvps, vertex_grid, uv_grid, texture, width, height,
                         config: RasterConfig = RasterConfig(),
                         mode: str = "texture", frame_batch: int = 16):
    """Frames through the Pallas route -> (T, height, width, 4) uint8 on the
    device of ``vertex_grid``.

    Frames go in groups of ``frame_batch``, clamped so a group's plane tables
    stay within ``tiled.COEFF_BUDGET`` (``raster_grid.frame_group``): one
    prep, one pair kernel launch and one shade per group. (The JAX function
    pads the last group to keep one compiled shape; eager PyTorch needs no
    padding, and no pixel depends on the grouping.)
    """
    _check_anchors(config)
    vertex_grid = torch.as_tensor(vertex_grid, dtype=_F32)
    dev = vertex_grid.device
    texture = torch.as_tensor(texture, device=dev)
    mvps = torch.as_tensor(mvps, dtype=_F32, device=dev).reshape(-1, 4, 4)
    T = mvps.shape[0]
    fb = raster_grid.frame_group(vertex_grid.shape[0], vertex_grid.shape[1],
                                 config, frame_batch)
    out = torch.empty((T, height, width, 4), dtype=torch.uint8, device=dev)
    for s in range(0, T, fb):
        planes = _prep_stage_batched(mvps[s:s + fb], vertex_grid, uv_grid,
                                     width, height, config)
        tiles = tiled.raster_pairs(*planes, height, config)
        out[s:s + fb] = _shade_stage_batched(tiles, texture, width, height,
                                             config, mode)
    return out


def render_frame_pallas(mvp, vertex_grid, uv_grid, texture, width, height,
                        config: RasterConfig = RasterConfig(),
                        mode: str = "texture"):
    """One frame through the Pallas route -> (height, width, 4) uint8."""
    return render_frames_pallas(torch.as_tensor(mvp, dtype=_F32)[None],
                                vertex_grid, uv_grid, texture, width, height,
                                config, mode, frame_batch=1)[0]
