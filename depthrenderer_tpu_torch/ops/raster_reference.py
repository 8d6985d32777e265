"""Brute-force float64 rasteriser of a grid mesh on chosen pixel rows: the
oracle that a full-size frame can be checked against.

The semantics are those of the JAX package's ``raster_reference`` (its numpy
oracle): window-space projection in float64, CCW front faces (doubled area
> 1e-12), every vertex in front of the camera, the model-z spread cull,
coverage where all three barycentric weights are >= 0 and z_ndc is in
[-1, 1], min z with the lowest triangle id on ties, perspective-correct u
and v, bilinear clamp-to-edge sampling of the 8-bit texels, background
(0, 0, 0, 255). Only the ``texture`` mode is carried.

What differs is the search: on each requested row only the grid cells whose
projected y-extent reaches the row's pixel centres are tested, in ascending
triangle id order, so a 4K frame at mesh density 12 can be checked on a few
rows of the card in seconds. Triangle ``2 * (i * (n_c - 1) + j) + k`` of
cell (i, j) is ``(a, b, c)`` for k = 0 and ``(c, b, d)`` for k = 1, with
``a = (i, j)``, ``b = (i + 1, j)``, ``c = (i, j + 1)``, ``d = (i + 1, j +
1)``: the grid routes' order.
"""

from __future__ import annotations

import torch

_F64 = torch.float64


def _bilinear(texture, u, v):
    """(N, 4) float64 bilinear clamp-to-edge samples of (Ht, Wt, 4) texels."""
    ht, wt = texture.shape[:2]
    tx = u * wt - 0.5
    ty = (1.0 - v) * ht - 0.5
    x0, y0 = torch.floor(tx), torch.floor(ty)
    fx, fy = (tx - x0)[:, None], (ty - y0)[:, None]
    x0i, y0i = x0.long(), y0.long()
    x1i = torch.clamp(x0i + 1, 0, wt - 1)
    y1i = torch.clamp(y0i + 1, 0, ht - 1)
    x0i, y0i = torch.clamp(x0i, 0, wt - 1), torch.clamp(y0i, 0, ht - 1)
    c00, c01 = texture[y0i, x0i], texture[y0i, x1i]
    c10, c11 = texture[y1i, x0i], texture[y1i, x1i]
    top = c00 + (c01 - c00) * fx
    bot = c10 + (c11 - c10) * fx
    return top + (bot - top) * fy


def rasterize_grid_rows(mvp, vertex_grid, uv_grid, texture, width: int,
                        height: int, rows, edge_cull_threshold=None,
                        chunk: int = 4096):
    """The oracle's pixels on the given rows (top-down indices) ->
    (len(rows), width, 4) uint8 on the grid's device.

    :param mvp: (4, 4) model-view-projection matrix.
    :param vertex_grid: (n_r, n_c, 3) model-space vertices.
    :param uv_grid: (n_r, n_c, 2) texture coordinates.
    :param texture: (Ht, Wt, 4) texels (0..255).
    :raises NotImplementedError: when a triangle straddles the camera plane
        (the JAX oracle clips it; that clip is not carried here).
    """
    dev = vertex_grid.device
    n_r, n_c = vertex_grid.shape[:2]
    v = vertex_grid.reshape(-1, 3).to(_F64)
    uv = uv_grid.reshape(-1, 2).to(_F64).to(dev)
    tex = torch.as_tensor(texture).to(device=dev, dtype=_F64)
    m = torch.as_tensor(mvp).to(device=dev, dtype=_F64)
    clip = v @ m[:, :3].T + m[:, 3]
    w = clip[:, 3]
    inv_w = torch.where(w.abs() > 1e-30, 1.0 / w, torch.zeros_like(w))
    sx = (clip[:, 0] * inv_w + 1.0) * 0.5 * width
    sy = (clip[:, 1] * inv_w + 1.0) * 0.5 * height
    zn = clip[:, 2] * inv_w
    zm = v[:, 2]

    def corners(g):
        g = g.reshape(n_r, n_c)
        return torch.stack([g[:-1, :-1], g[1:, :-1], g[:-1, 1:], g[1:, 1:]])

    wc = corners(w)
    if bool(((wc <= 0).any(0) & (wc > 0).any(0)).any()):
        raise NotImplementedError(
            "rasterize_grid_rows: a triangle straddles the camera plane")
    syc = corners(sy)
    ylo, yhi = syc.amin(0).reshape(-1), syc.amax(0).reshape(-1)
    del wc, syc
    qx = torch.arange(width, dtype=_F64, device=dev) + 0.5
    out = []
    for r in rows:
        qy = height - (float(r) + 0.5)
        cells = torch.nonzero((ylo <= qy) & (yhi >= qy)).squeeze(1)
        a = cells // (n_c - 1) * n_c + cells % (n_c - 1)
        b, c = a + n_c, a + 1
        tris = torch.stack([torch.stack([a, b, c], -1),
                            torch.stack([c, b, b + 1], -1)], 1).reshape(-1, 3)
        best_z = torch.full((width,), float("inf"), dtype=_F64, device=dev)
        best_l = torch.zeros((width, 3), dtype=_F64, device=dev)
        best_t = torch.zeros((width, 3), dtype=torch.int64, device=dev)
        for s in range(0, len(tris), chunk):
            t = tris[s:s + chunk]
            x0, x1, x2 = (sx[t[:, k]][:, None] for k in range(3))
            y0, y1, y2 = (sy[t[:, k]][:, None] for k in range(3))
            area2 = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
            ok = (area2 > 1e-12) & (w[t] > 0).all(1)[:, None]
            if edge_cull_threshold is not None:
                z3 = zm[t]
                ok &= ((z3.amax(1) - z3.amin(1))
                       <= edge_cull_threshold)[:, None]
            inv_area = torch.where(ok, 1.0 / torch.where(ok, area2, 1.0), 0.0)
            q = qx[None]
            l0 = ((x2 - x1) * (qy - y1) - (y2 - y1) * (q - x1)) * inv_area
            l1 = ((x0 - x2) * (qy - y2) - (y0 - y2) * (q - x2)) * inv_area
            l2 = ((x1 - x0) * (qy - y0) - (y1 - y0) * (q - x0)) * inv_area
            z = (l0 * zn[t[:, 0]][:, None] + l1 * zn[t[:, 1]][:, None]
                 + l2 * zn[t[:, 2]][:, None])
            cov = (ok & (l0 >= 0) & (l1 >= 0) & (l2 >= 0) & (z >= -1.0)
                   & (z <= 1.0))
            zmin, idx = torch.where(cov, z, float("inf")).min(0)
            better = zmin < best_z
            lam = torch.stack([l0, l1, l2], -1).gather(
                0, idx[None, :, None].expand(1, width, 3))[0]
            best_z = torch.where(better, zmin, best_z)
            best_l = torch.where(better[:, None], lam, best_l)
            best_t = torch.where(better[:, None], t[idx], best_t)
        covered = torch.isfinite(best_z)
        wt = inv_w[best_t]
        den = (best_l * wt).sum(1)
        den = torch.where(den.abs() > 1e-30, den, 1.0)
        u = (best_l * uv[best_t, 0] * wt).sum(1) / den
        vv = (best_l * uv[best_t, 1] * wt).sum(1) / den
        rgba = _bilinear(tex, u, vv)
        bg = torch.tensor([0.0, 0.0, 0.0, 255.0], dtype=_F64, device=dev)
        rgba = torch.where(covered[:, None], rgba, bg)
        out.append(torch.clamp(torch.round(rgba), 0, 255).to(torch.uint8))
    return torch.stack(out)
