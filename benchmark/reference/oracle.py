"""A brute-force rasteriser of chosen pixel rows of a grid mesh.

A frozen copy of the port's float64 row oracle
(``depthrenderer_tpu_torch/ops/raster_reference.py``:
``rasterize_grid_rows``), trimmed to the camera poses the benchmark renders,
where every vertex lies in front of the camera (a pose that puts one behind
it raises). Its semantics are GL's: window-space projection, CCW front
faces (doubled area > 1e-12), coverage where all three barycentric weights
are >= 0 and z_ndc is in [-1, 1], min z with the lowest triangle id on
ties, the model-z spread edge cull, perspective-correct u and v, bilinear
clamp-to-edge sampling of the 8-bit texels, background (0, 0, 0, 255). On
each row only the grid cells whose projected y-extent reaches the row's
pixel centres are tested, in ascending triangle id order: triangle
``2 * (i * (n - 1) + j) + k`` of cell (i, j) is ``(a, b, c)`` for k = 0 and
``(c, b, d)`` for k = 1, with ``a = (i, j)``, ``b = (i + 1, j)``, ``c = (i,
j + 1)``, ``d = (i + 1, j + 1)``.

``precision="float64"`` is the reference. ``precision="tf32"`` is the
correctness check's control: the same algorithm in float32 with the
projection's products on TF32 inputs (10 mantissa bits, rounded to
nearest even), the step below the float32 arithmetic with TF32 off that
the program states.
"""

from __future__ import annotations

import torch

PRECISIONS = ("float64", "tf32")


def tf32_round(x):
    """float32 ``x`` rounded to TF32's 10 mantissa bits, to nearest even."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def _project(v, m, width, height, precision):
    """Window x, y, NDC z and 1/w of (V, 3) vertices."""
    ones = torch.ones_like(v[:, :1])
    if precision == "tf32":
        a = tf32_round(torch.cat([v, ones], 1))
        b = tf32_round(m)
        clip = a[:, 0:1] * b[:, 0][None]
        for k in range(1, 4):
            clip = clip + a[:, k:k + 1] * b[:, k][None]
    else:
        clip = torch.cat([v, ones], 1) @ m.T
    w = clip[:, 3]
    if not bool((w > 1e-9).all()):
        raise ValueError("a vertex lies behind the camera: the reference "
                         "renders poses in front of the whole mesh only")
    inv_w = 1.0 / w
    sx = (clip[:, 0] * inv_w + 1.0) * 0.5 * width
    sy = (clip[:, 1] * inv_w + 1.0) * 0.5 * height
    return sx, sy, clip[:, 2] * inv_w, inv_w


def _bilinear(texture, u, v):
    """(..., 4) bilinear clamp-to-edge samples of (Ht, Wt, 4) texels."""
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


class _Best:
    """The running depth test of one row of pixels: min z, the winner's
    corners and barycentric weights; chunks of triangles in id order merge
    by strict ``<`` (the earlier wins a tie)."""

    def __init__(self, n, dtype, dev):
        self.z = torch.full((n,), float("inf"), dtype=dtype, device=dev)
        self.lam = torch.zeros((n, 3), dtype=dtype, device=dev)
        self.tri = torch.zeros((n, 3), dtype=torch.int64, device=dev)

    def add(self, t, ok, sx, sy, zn, qx, qy):
        x0, x1, x2 = (sx[t[:, k]][:, None] for k in range(3))
        y0, y1, y2 = (sy[t[:, k]][:, None] for k in range(3))
        area2 = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
        e0 = (x2 - x1) * (qy - y1) - (y2 - y1) * (qx - x1)
        e1 = (x0 - x2) * (qy - y2) - (y0 - y2) * (qx - x2)
        e2 = (x1 - x0) * (qy - y0) - (y1 - y0) * (qx - x0)
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

    def shade(self, inv_w, uv, texture):
        """-> (P, 4) uint8, textured."""
        covered = torch.isfinite(self.z)
        l0, l1, l2 = self.lam[:, 0], self.lam[:, 1], self.lam[:, 2]
        tri = self.tri
        w0, w1, w2 = inv_w[tri[:, 0]], inv_w[tri[:, 1]], inv_w[tri[:, 2]]
        den = l0 * w0 + l1 * w1 + l2 * w2
        den = torch.where(den.abs() > 1e-30, den, 1.0)

        def interp(a):
            return (l0 * a[tri[:, 0]] * w0 + l1 * a[tri[:, 1]] * w1
                    + l2 * a[tri[:, 2]] * w2) / den

        rgba = _bilinear(texture, interp(uv[:, 0]), interp(uv[:, 1]))
        bg = torch.tensor([0.0, 0.0, 0.0, 255.0], dtype=rgba.dtype,
                          device=rgba.device)
        rgba = torch.where(covered[:, None], rgba, bg)
        return torch.clamp(torch.round(rgba), 0, 255).to(torch.uint8)


def render_rows(mvp, vertex_grid, uv_grid, texture, width: int, height: int,
                rows, edge_cull_threshold=None, precision: str = "float64",
                chunk: int = 4096):
    """The pixels of the given rows (top-down indices) of one frame ->
    (len(rows), width, 4) uint8 on the grid's device.

    :param mvp: (4, 4) model-view-projection matrix.
    :param vertex_grid: (n, n, 3) model-space vertices.
    :param uv_grid: (n, n, 2) texture coordinates.
    :param texture: (Ht, Wt, 4) uint8 texels.
    """
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    dtype = torch.float64 if precision == "float64" else torch.float32
    dev = vertex_grid.device
    n_r, n_c = vertex_grid.shape[:2]
    v = vertex_grid.reshape(-1, 3).to(dtype)
    uv = uv_grid.reshape(-1, 2).to(device=dev, dtype=dtype)
    tex = torch.as_tensor(texture).to(device=dev, dtype=dtype)
    m = torch.as_tensor(mvp).to(device=dev, dtype=dtype)
    sx, sy, zn, inv_w = _project(v, m, width, height, precision)
    zm = v[:, 2]

    def corners(g):
        return torch.stack([g[:-1, :-1], g[1:, :-1], g[:-1, 1:], g[1:, 1:]])

    a = corners(torch.arange(n_r * n_c, device=dev).reshape(n_r, n_c)
                ).reshape(4, -1)
    syc = corners(sy.reshape(n_r, n_c))
    ylo, yhi = syc.amin(0).reshape(-1), syc.amax(0).reshape(-1)
    del syc
    qx = torch.arange(width, dtype=dtype, device=dev) + 0.5
    out = []
    for r in rows:
        qy = height - (float(r) + 0.5)
        cells = torch.nonzero((ylo <= qy) & (yhi >= qy)).squeeze(1)
        ca = a[:, cells]
        tris = torch.stack([torch.stack([ca[0], ca[1], ca[2]], -1),
                            torch.stack([ca[2], ca[1], ca[3]], -1)],
                           1).reshape(-1, 3)
        best = _Best(width, dtype, dev)
        for s in range(0, len(tris), chunk):
            t = tris[s:s + chunk]
            if edge_cull_threshold is None:
                ok = torch.ones((len(t), 1), dtype=torch.bool, device=dev)
            else:
                z3 = zm[t]
                ok = ((z3.amax(1) - z3.amin(1))
                      <= edge_cull_threshold)[:, None]
            best.add(t, ok, sx, sy, zn, qx[None], qy)
        out.append(best.shade(inv_w, uv, tex))
    return torch.stack(out)
