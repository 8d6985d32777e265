"""Brute-force float64 rasterisers: the oracles the fast routes are checked
against.

The semantics are those of the JAX package's ``raster_reference`` (its numpy
oracle): GL's near-plane clip of the triangles that straddle the camera
plane (:func:`clip_near_plane`, host float64 Sutherland-Hodgman against
``clip_w = 1e-9``), window-space projection in float64, CCW front faces
(doubled area > 1e-12), every vertex in front of the camera, the model-z
spread cull, coverage where all three barycentric weights are >= 0 and
z_ndc is in [-1, 1], min z with the lowest triangle id on ties,
perspective-correct u and v, bilinear clamp-to-edge sampling of the 8-bit
texels, background (0, 0, 0, 255).

* :func:`rasterize_reference` renders a triangle soup: every pixel against
  every triangle, in float64 on the device of its inputs.
* :func:`rasterize_grid_rows` renders chosen pixel rows of a grid mesh: on
  each row only the grid cells whose projected y-extent reaches the row's
  pixel centres are tested, in ascending triangle id order, so a 4K frame
  at mesh density 12 can be checked on a few rows of the card in seconds.
  Triangle ``2 * (i * (n_c - 1) + j) + k`` of cell (i, j) is ``(a, b, c)``
  for k = 0 and ``(c, b, d)`` for k = 1, with ``a = (i, j)``, ``b = (i + 1,
  j)``, ``c = (i, j + 1)``, ``d = (i + 1, j + 1)``: the grid routes' order.
  A straddling triangle is replaced by its clipped fan, tested at its
  place in that order, as the clip emits it.
"""

from __future__ import annotations

import numpy as np
import torch

_F64 = torch.float64

# The clip plane: vertices with clip_w > CLIP_W are in front of the camera.
CLIP_W = 1e-9


def host(x, dtype=None):
    """A numpy copy of an array or tensor (on any device)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def device_of(x):
    return x.device if isinstance(x, torch.Tensor) else torch.device("cpu")


def _fans(vertices, uvs, tri, w, eps):
    """Sutherland-Hodgman against ``clip_w = eps``, in host float64.

    :return: ``(new_vertices (k, 3), new_uvs (k, 2), out (m, 3) int64,
        parent (m,) int64)``: the crossing vertices (ids from
        ``len(vertices)`` on, in the order they are made), and every kept
        triangle in id order: one in front as it is, a straddling one as
        the 1 or 2 triangles of its fanned 3- or 4-gon at its own place,
        one behind dropped. ``parent`` is each output's input triangle.
    """
    inside = w > eps
    nin = inside[tri].sum(axis=1)
    straddle = (nin > 0) & (nin < 3)
    new_v, new_uv, fan_rows, fan_parent, fan_slot = [], [], [], [], []
    vcount = len(vertices)
    for ti in np.flatnonzero(straddle):
        poly = []
        for k in range(3):
            a, b = tri[ti][k], tri[ti][(k + 1) % 3]
            if inside[a]:
                poly.append(a)
            if inside[a] != inside[b]:
                t = (eps - w[a]) / (w[b] - w[a])
                new_v.append(vertices[a] + (vertices[b] - vertices[a]) * t)
                new_uv.append(uvs[a] + (uvs[b] - uvs[a]) * t)
                poly.append(vcount)
                vcount += 1
        for k in range(1, len(poly) - 1):
            fan_rows.append((poly[0], poly[k], poly[k + 1]))
            fan_parent.append(ti)
            fan_slot.append(k - 1)
    front = np.flatnonzero(nin == 3)
    parent = np.concatenate([front, np.asarray(fan_parent, np.int64)])
    # A 4-gon's two triangles follow each other: sort on (parent, fan slot).
    slot = np.concatenate([np.zeros(len(front), np.int64),
                           np.asarray(fan_slot, np.int64)])
    order = np.argsort(2 * parent + slot)
    out = np.concatenate([tri[front].astype(np.int64),
                          np.asarray(fan_rows, np.int64).reshape(-1, 3)])
    return (np.asarray(new_v, np.float64).reshape(-1, 3),
            np.asarray(new_uv, np.float64).reshape(-1, 2), out[order],
            parent[order])


def _clip(vertices, uvs, indices, d, eps):
    """Sutherland-Hodgman against the plane ``d = eps`` of the affine
    per-vertex function ``d``, keeping ``d > eps`` (see
    :func:`clip_near_plane`)."""
    tri = indices.reshape(-1, 3)
    nin = (d > eps)[tri].sum(axis=1)
    if not ((nin > 0) & (nin < 3)).any():
        keep = nin == 3
        if keep.all():
            return vertices, uvs, indices.reshape(-1)
        return vertices, uvs, tri[keep].reshape(-1)
    new_v, new_uv, out, _ = _fans(vertices, uvs, tri, d, eps)
    return (np.concatenate([vertices, new_v]), np.concatenate([uvs, new_uv]),
            out.reshape(-1))


def _host_inputs(vertices, uvs, indices, mvp):
    return (host(vertices, np.float64), host(uvs, np.float64), host(indices),
            host(mvp, np.float64))


def clip_near_plane(vertices, uvs, indices, mvp, eps=CLIP_W):
    """Clip the triangles that straddle the camera plane (``clip_w = eps``)
    on the host: every vertex kept has ``clip_w > 0``, and the per-pixel z
    test then reproduces GL's near clip. This is the JAX package's clip,
    whose float64 oracle is exact with it.

    ``clip_w`` is affine in the model-space position, so the crossing is
    lerped in model space from the w values, exactly, in float64.

    :return: ``(vertices2, uvs2, indices2)`` numpy arrays, equal to the JAX
        package's: the inputs unchanged when every triangle is in front (the
        common case, a fast exit), the triangles behind dropped, and
        otherwise the crossing vertices appended and each straddler's fan
        at its place, with int64 indices.
    """
    vertices, uvs, indices, mvp = _host_inputs(vertices, uvs, indices, mvp)
    return _clip(vertices, uvs, indices, vertices @ mvp[3, :3] + mvp[3, 3],
                 eps)


def near_depth(vertices, mvp):
    """``clip_z + clip_w`` of each vertex in host float64: GL's near plane
    is its zero (z_ndc = -1), a vertex in front of it is positive."""
    vertices, mvp = host(vertices, np.float64), host(mvp, np.float64)
    return vertices @ (mvp[2, :3] + mvp[3, :3]) + (mvp[2, 3] + mvp[3, 3])


def clip_gl_near(vertices, uvs, indices, mvp):
    """Clip the triangles that cross GL's near plane (``clip_z = -clip_w``,
    z_ndc = -1) on the host, as GL's fixed-function pipeline clips them, in
    the same form as :func:`clip_near_plane`.

    The pixels kept are those :func:`clip_near_plane` and the per-pixel z
    test keep (the near plane lies in front of the camera plane, and z_ndc
    is affine over a triangle's pixels), but a crossing vertex has
    ``clip_w`` = the near distance instead of 1e-9: its window coordinates
    stay within float32's reach, so a float32 rasteriser renders the
    clipped triangle as the float64 oracle does.
    """
    vertices, uvs, indices, mvp = _host_inputs(vertices, uvs, indices, mvp)
    return _clip(vertices, uvs, indices, near_depth(vertices, mvp), 0.0)


def _bilinear(texture, u, v):
    """(..., 4) float64 bilinear clamp-to-edge samples of (Ht, Wt, 4)
    texels."""
    ht, wt = texture.shape[:2]
    tx = u * wt - 0.5
    ty = (1.0 - v) * ht - 0.5
    x0, y0 = torch.floor(tx), torch.floor(ty)
    fx, fy = (tx - x0)[..., None], (ty - y0)[..., None]
    x0i, y0i = x0.long(), y0.long()
    x1i = torch.clamp(x0i + 1, 0, wt - 1)
    y1i = torch.clamp(y0i + 1, 0, ht - 1)
    x0i, y0i = torch.clamp(x0i, 0, wt - 1), torch.clamp(y0i, 0, ht - 1)
    c00, c01 = texture[y0i, x0i], texture[y0i, x1i]
    c10, c11 = texture[y1i, x0i], texture[y1i, x1i]
    top = c00 + (c01 - c00) * fx
    bot = c10 + (c11 - c10) * fx
    return top + (bot - top) * fy


def _project(v, m, width, height):
    """float64 window x, y, NDC z and 1/w of (V, 3) vertices."""
    clip = torch.cat([v, torch.ones_like(v[:, :1])], 1) @ m.T
    w = clip[:, 3]
    inv_w = torch.where(w.abs() > 1e-30, 1.0 / w, torch.zeros_like(w))
    sx = (clip[:, 0] * inv_w + 1.0) * 0.5 * width
    sy = (clip[:, 1] * inv_w + 1.0) * 0.5 * height
    return sx, sy, clip[:, 2] * inv_w, w, inv_w


def _edges(sx, sy, zn, t, qx, qy):
    """λ0, λ1, λ2 (unnormalised edge functions) and the doubled area of
    triangles ``t`` (k, 3) at pixel centres ``qx``, ``qy`` (broadcast to
    (k, P))."""
    x0, x1, x2 = (sx[t[:, k]][:, None] for k in range(3))
    y0, y1, y2 = (sy[t[:, k]][:, None] for k in range(3))
    area2 = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    e0 = (x2 - x1) * (qy - y1) - (y2 - y1) * (qx - x1)
    e1 = (x0 - x2) * (qy - y2) - (y0 - y2) * (qx - x2)
    e2 = (x1 - x0) * (qy - y0) - (y1 - y0) * (qx - x0)
    return e0, e1, e2, area2


class _Best:
    """The running depth test of one set of pixels: min z, the winner's
    corners and barycentric weights; chunks of triangles in id order merge
    by strict ``<`` (the earlier wins a tie)."""

    def __init__(self, n, dev):
        self.z = torch.full((n,), float("inf"), dtype=_F64, device=dev)
        self.lam = torch.zeros((n, 3), dtype=_F64, device=dev)
        self.tri = torch.zeros((n, 3), dtype=torch.int64, device=dev)

    def add(self, t, ok, sx, sy, zn, qx, qy):
        """Test triangles ``t`` (k, 3) with per-triangle mask ``ok`` (k, 1)
        at the pixels (qx, qy broadcastable to (k, P))."""
        e0, e1, e2, area2 = _edges(sx, sy, zn, t, qx, qy)
        ok = ok & (area2 > 1e-12)
        inv_area = torch.where(ok, 1.0 / torch.where(ok, area2, 1.0), 0.0)
        l0, l1, l2 = e0 * inv_area, e1 * inv_area, e2 * inv_area
        z = (l0 * zn[t[:, 0]][:, None] + l1 * zn[t[:, 1]][:, None]
             + l2 * zn[t[:, 2]][:, None])
        cov = (ok & (l0 >= 0) & (l1 >= 0) & (l2 >= 0) & (z >= -1.0)
               & (z <= 1.0))
        zmin, idx = torch.where(cov, z, float("inf")).min(0)
        better = zmin < self.z
        n = idx.numel()
        lam = torch.stack([l0, l1, l2], -1).gather(
            0, idx[None, :, None].expand(1, n, 3))[0]
        self.z = torch.where(better, zmin, self.z)
        self.lam = torch.where(better[:, None], lam, self.lam)
        self.tri = torch.where(better[:, None], t[idx], self.tri)

    def shade(self, inv_w, uv, zm, texture, mode):
        """-> (P, 4) uint8 in ``texture``, ``debug_z`` or ``wireframe``."""
        covered = torch.isfinite(self.z)
        lam, tri = self.lam, self.tri
        l0, l1, l2 = lam[:, 0], lam[:, 1], lam[:, 2]
        w0, w1, w2 = inv_w[tri[:, 0]], inv_w[tri[:, 1]], inv_w[tri[:, 2]]
        den = l0 * w0 + l1 * w1 + l2 * w2
        den = torch.where(den.abs() > 1e-30, den, 1.0)

        def interp(a):
            return (l0 * a[tri[:, 0]] * w0 + l1 * a[tri[:, 1]] * w1
                    + l2 * a[tri[:, 2]] * w2) / den

        u, v = interp(uv[:, 0]), interp(uv[:, 1])
        if mode == "wireframe":
            covered = covered & (lam.amin(-1) <= 0.15)
            mode = "texture"
        tex = _bilinear(texture, u, v)
        if mode == "texture":
            rgba = tex
        elif mode == "debug_z":
            grey = torch.clamp(interp(zm), 0.0, 1.0) * 255.0
            rgba = torch.stack([grey, grey, grey, tex[:, 3]], -1)
        else:
            raise ValueError(f"Unknown shading mode {mode!r}")
        bg = torch.tensor([0.0, 0.0, 0.0, 255.0], dtype=_F64,
                          device=rgba.device)
        rgba = torch.where(covered[:, None], rgba, bg)
        return torch.clamp(torch.round(rgba), 0, 255).to(torch.uint8)


def _cull_ok(t, zm, edge_cull_threshold):
    """(k, 1) model-z spread cull of triangles ``t`` (all True when off)."""
    if edge_cull_threshold is None:
        return torch.ones((len(t), 1), dtype=torch.bool, device=t.device)
    z3 = zm[t]
    return ((z3.amax(1) - z3.amin(1)) <= edge_cull_threshold)[:, None]


def rasterize_reference(vertices, uvs, indices, mvp, texture, width: int,
                        height: int, mode: str = "texture",
                        edge_cull_threshold=None, pixels=None):
    """Render a triangle soup with the brute-force oracle, in float64 on the
    device of ``vertices``; equal to the JAX package's numpy oracle.

    :param vertices: (V, 3) model-space positions.
    :param uvs: (V, 2) texture coordinates.
    :param indices: flat (T*3,) triangle indices.
    :param mvp: (4, 4) model-view-projection matrix.
    :param texture: (Ht, Wt, 4) texels (0..255).
    :param mode: ``texture``, ``debug_z`` or ``wireframe``.
    :param edge_cull_threshold: optional model-z spread cull.
    :param pixels: triangle x pixel pairs a step holds (a working-set cap,
        by default 2^24 on a card and 2^20 on the CPU; the result does not
        depend on it).
    :return: (height, width, 4) uint8 tensor, top-down.
    """
    dev = device_of(vertices)
    v, uv, idx = clip_near_plane(vertices, uvs, indices, mvp)
    v = torch.as_tensor(v, dtype=_F64, device=dev)
    uv = torch.as_tensor(uv, dtype=_F64, device=dev)
    tri = torch.as_tensor(idx.astype(np.int64), device=dev).reshape(-1, 3)
    m = torch.as_tensor(host(mvp, np.float64), device=dev)
    tex = torch.as_tensor(host(texture)).to(device=dev, dtype=_F64)
    sx, sy, zn, w, inv_w = _project(v, m, width, height)
    ok = (w[tri] > 0).all(1)[:, None] & _cull_ok(tri, v[:, 2],
                                                  edge_cull_threshold)
    # Triangles no pixel can take (back-facing, behind, culled) leave the
    # running minimum as it is: test only the others, still in id order.
    x0, x1, x2 = (sx[tri[:, k]] for k in range(3))
    y0, y1, y2 = (sy[tri[:, k]] for k in range(3))
    live = ok[:, 0] & ((x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0) > 1e-12)
    tri = tri[live]
    qx, qy = (c.reshape(-1).to(_F64) for c in _centres(width, height, dev))
    best = _Best(width * height, dev)
    if pixels is None:
        pixels = 1 << (24 if dev.type == "cuda" else 20)
    step = max(1, pixels // (width * height))
    for s in range(0, len(tri), step):
        t = tri[s:s + step]
        best.add(t, torch.ones((len(t), 1), dtype=torch.bool, device=dev),
                 sx, sy, zn, qx[None], qy[None])
    return best.shade(inv_w, uv, v[:, 2], tex, mode).reshape(height, width,
                                                             4)


def _centres(width, height, dev):
    qx = torch.arange(width, dtype=_F64, device=dev) + 0.5
    qy = height - (torch.arange(height, dtype=_F64, device=dev) + 0.5)
    return (qx[None, :].expand(height, width),
            qy[:, None].expand(height, width))


def _straddler_fans(v, uv, w, tri_ids, corners, n_vertices):
    """The clipped fans of the grid's straddling triangles -> ``(new
    vertices (k, 3), new uvs (k, 2), fans (m, 3) with vertex ids into the
    grid's vertices followed by the new ones, keys (m,): 2 * parent id +
    fan slot)``, all on the grid's device."""
    dev = v.device
    ids = corners.reshape(-1)
    used, local = torch.unique(ids, return_inverse=True)
    vh, uvh = host(v[used]), host(uv[used])
    wh = host(w[used])
    nv, nuv, out, parent = _fans(vh, uvh, host(local).reshape(-1, 3), wh,
                                 CLIP_W)
    out = torch.as_tensor(out, device=dev)
    glob = torch.where(out < len(used), used[out.clamp(max=len(used) - 1)],
                       n_vertices + out - len(used))
    parent = torch.as_tensor(parent, device=dev)
    slot = torch.zeros_like(parent)
    slot[1:] = (parent[1:] == parent[:-1]).long()
    keys = 2 * tri_ids[parent] + slot
    return (torch.as_tensor(nv, dtype=_F64, device=dev),
            torch.as_tensor(nuv, dtype=_F64, device=dev), glob, keys)


def rasterize_grid_rows(mvp, vertex_grid, uv_grid, texture, width: int,
                        height: int, rows, edge_cull_threshold=None,
                        chunk: int = 4096):
    """The oracle's pixels on the given rows (top-down indices) ->
    (len(rows), width, 4) uint8 on the grid's device.

    :param mvp: (4, 4) model-view-projection matrix.
    :param vertex_grid: (n_r, n_c, 3) model-space vertices.
    :param uv_grid: (n_r, n_c, 2) texture coordinates.
    :param texture: (Ht, Wt, 4) texels (0..255).

    Triangles that straddle the camera plane are clipped
    (:func:`clip_near_plane`); each row tests their fans whose y-extent
    reaches it beside its cells, each fan at its parent's place in id order.
    """
    dev = vertex_grid.device
    n_r, n_c = vertex_grid.shape[:2]
    nvert = n_r * n_c
    v = vertex_grid.reshape(-1, 3).to(_F64)
    uv = uv_grid.reshape(-1, 2).to(_F64).to(dev)
    tex = torch.as_tensor(texture).to(device=dev, dtype=_F64)
    m = torch.as_tensor(mvp).to(device=dev, dtype=_F64)
    w = v @ m[3, :3] + m[3, 3]
    inside = (w > CLIP_W).reshape(n_r, n_c)

    def corners(g):
        return torch.stack([g[:-1, :-1], g[1:, :-1], g[:-1, 1:], g[1:, 1:]])

    a = corners(torch.arange(nvert, device=dev).reshape(n_r, n_c)).reshape(
        4, -1)
    ins = corners(inside).reshape(4, -1)
    # Per triangle (id 2 * cell + k): corners in front.
    nin = torch.stack([ins[0].int() + ins[1] + ins[2],
                       ins[2].int() + ins[1] + ins[3]], 1).reshape(-1)
    front = nin == 3
    straddle = (nin > 0) & (nin < 3)
    fans = None
    if bool(straddle.any()):
        tri_ids = torch.nonzero(straddle).squeeze(1)
        cell, k = tri_ids // 2, (tri_ids % 2)[:, None]
        abc = torch.stack([a[0][cell], a[1][cell], a[2][cell]], 1)
        cbd = torch.stack([a[2][cell], a[1][cell], a[3][cell]], 1)
        nv, nuv, ftri, fkeys = _straddler_fans(
            v, uv, w, tri_ids, torch.where(k == 0, abc, cbd), nvert)
        v = torch.cat([v, nv])
        uv = torch.cat([uv, nuv])
        fans = (ftri, fkeys)
    sx, sy, zn, wv, inv_w = _project(v, m, width, height)
    zm = v[:, 2]
    syc = corners(sy[:nvert].reshape(n_r, n_c))
    ylo, yhi = syc.amin(0).reshape(-1), syc.amax(0).reshape(-1)
    del syc
    if fans is not None:
        fy = sy[fans[0]]
        fylo, fyhi = fy.amin(1), fy.amax(1)
    qx = torch.arange(width, dtype=_F64, device=dev) + 0.5
    out = []
    for r in rows:
        qy = height - (float(r) + 0.5)
        cells = torch.nonzero((ylo <= qy) & (yhi >= qy)).squeeze(1)
        tid = torch.stack([2 * cells, 2 * cells + 1], 1).reshape(-1)
        ca = a[:, cells]
        tris = torch.stack([torch.stack([ca[0], ca[1], ca[2]], -1),
                            torch.stack([ca[2], ca[1], ca[3]], -1)],
                           1).reshape(-1, 3)
        keep = front[tid]
        tris, keys = tris[keep], 2 * tid[keep]
        if fans is not None:
            hit = (fylo <= qy) & (fyhi >= qy)
            if bool(hit.any()):
                keys = torch.cat([keys, fans[1][hit]])
                tris = torch.cat([tris, fans[0][hit]])[torch.argsort(keys)]
        best = _Best(width, dev)
        for s in range(0, len(tris), chunk):
            t = tris[s:s + chunk]
            ok = (wv[t] > 0).all(1)[:, None] & _cull_ok(t, zm,
                                                        edge_cull_threshold)
            best.add(t, ok, sx, sy, zn, qx[None], qy)
        out.append(best.shade(inv_w, uv, zm, tex, "texture"))
    return torch.stack(out)
