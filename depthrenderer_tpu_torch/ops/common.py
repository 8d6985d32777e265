"""Shared rasterisation math: configs, projection, plane setup, texture
sampling, shading.

Counterpart of ``depthrenderer_tpu/ops/common.py``. Conventions (the
reference's OpenGL semantics): ``clip = MVP @ [x, y, z, 1]``; the viewport
maps NDC [-1, 1] to [0, W] x [0, H] with y up; output images are top-down, so
pixel (row i, col j) has window centre (j + 0.5, H - i - 0.5); background is
black with alpha 255; texels are quantised to 8 bits before bilinear,
clamp-to-edge filtering with GL's half-texel rule.

Float expressions follow the JAX package's order of operations, so the same
inputs give the same bits on the CPU and on the GPU, and the projection's bits
equal the JAX package's on its CPU backend.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

# Depth of uncovered pixels: loses every depth test (valid NDC z <= 1).
FAR_SENTINEL = 3.0e38

# Barycentric threshold for wireframe-mode edge coverage (fraction of the
# triangle's extent; a visual debug aid, not a screen-metric line width).
WIREFRAME_EDGE_THRESHOLD = 0.15

_F32 = torch.float32


def const(x, like):
    """A float32 scalar on ``like``'s device, filled there (no host copy, so
    no wait on the stream). Dividing by it is a true division on every
    device (CUDA divides by a host scalar as a multiply by its
    reciprocal)."""
    return torch.full((), x, dtype=_F32, device=like.device)


def fma(a, b, c):
    """float32 ``a * b + c`` rounded once, as a fused multiply-add (CUDA's
    ``fmaf``) rounds it, on any device.

    The float32 product is exact in float64; the float64 sum is made
    round-to-odd (its error, from Knuth's two-sum, nudges an even result one
    ulp towards the exact value), and rounding a round-to-odd value with 29
    spare bits to float32 is the correctly rounded result.
    """
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float("inf"), float("-inf")).to(s)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(_F32)


def project_vertices(vertices, mvp, width, height):
    """Project model-space vertices to window coordinates.

    :param vertices: (..., 3) float32 positions.
    :param mvp: (4, 4) or (T, 4, 4) float32 model-view-projection matrices.
    :return: ``(sx, sy, z_ndc, inv_w)``, each shaped ``mvp.shape[:-2] +
        vertices.shape[:-1]``: window x/y (y up), NDC depth and 1/clip_w.

    Rounded as the JAX package's batched scan prep rounds on XLA's CPU
    backend: ``clip_j = ((v0 m_j0 + v1 m_j1) + v2 m_j2) + m_j3`` as separate
    float32 operations, then ``sx = fma(clip_x, 1/w, 1) * (W/2)``. One ulp
    of sy moves a crossing across a scanline, and with it the prep's
    integers.
    """
    vertices = torch.as_tensor(vertices, dtype=_F32)
    mvp = torch.as_tensor(mvp, dtype=_F32, device=vertices.device)
    lead = mvp.shape[:-2]
    vdims = vertices.dim() - 1
    m = mvp.reshape(lead + (1,) * vdims + (4, 4))
    v0, v1, v2 = vertices[..., 0], vertices[..., 1], vertices[..., 2]
    clip = [((v0 * m[..., j, 0] + v1 * m[..., j, 1]) + v2 * m[..., j, 2])
            + m[..., j, 3] for j in range(4)]
    w = clip[3]
    inv_w = torch.where(w.abs() > 1e-20, torch.ones_like(w) / w,
                        torch.zeros_like(w))
    one = torch.ones_like(inv_w)
    sx = fma(clip[0], inv_w, one) * (0.5 * width)
    sy = fma(clip[1], inv_w, one) * (0.5 * height)
    return sx, sy, clip[2] * inv_w, inv_w


def pixel_centers(width, height, device=None):
    """Window-coordinate centres of every image pixel, top-down row order ->
    ``(qx, qy)``, each (height, width) float32."""
    cols = torch.arange(width, dtype=_F32, device=device) + 0.5
    rows_win = height - (torch.arange(height, dtype=_F32, device=device)
                         + 0.5)
    return (cols[None, :].expand(height, width),
            rows_win[:, None].expand(height, width))


def project_vertices_tiled(vertices, mvp, width, height):
    """Project model-space vertices to window coordinates, rounded as the
    JAX package's tiled and grid paths round under ``jit`` on XLA's CPU
    backend (the scan prep has its own rounding: :func:`project_vertices`).

    ``clip = vertices @ m.T + t`` with the 3-term dot as a chain of fused
    multiply-adds, ``fma(v2, m2, fma(v1, m1, v0 * m0)) + t``, then
    ``sx = fma(clip_x, 1/w, 1) * (W/2)``. The binning integers depend on the
    last bit of ``sx, sy``.

    :param vertices: (..., 3) float32 positions.
    :param mvp: (4, 4) or (T, 4, 4) float32 model-view-projection matrices.
    :return: ``(sx, sy, z_ndc, inv_w)``, each shaped ``mvp.shape[:-2] +
        vertices.shape[:-1]``.
    """
    vertices = torch.as_tensor(vertices, dtype=_F32)
    mvp = torch.as_tensor(mvp, dtype=_F32, device=vertices.device)
    lead = mvp.shape[:-2]
    shape = lead + vertices.shape[:-1]
    m = mvp.reshape(lead + (1,) * (vertices.dim() - 1) + (4, 4))
    v0, v1, v2 = (vertices[..., k].expand(shape) for k in range(3))

    def row(j):
        mj = [m[..., j, k].expand(shape) for k in range(4)]
        return fma(v2, mj[2], fma(v1, mj[1], v0 * mj[0])) + mj[3]

    clip = [row(j) for j in range(4)]
    w = clip[3]
    inv_w = torch.where(w.abs() > 1e-20, torch.ones_like(w) / w,
                        torch.zeros_like(w))
    one = torch.ones_like(inv_w)
    sx = fma(clip[0], inv_w, one) * (0.5 * width)
    sy = fma(clip[1], inv_w, one) * (0.5 * height)
    return sx, sy, clip[2] * inv_w, inv_w


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    """Static configuration of the tiled rasteriser; the JAX package's
    ``RasterConfig`` field for field, with the same checks.

    :param tile_h/tile_w: screen tile size in pixels.
    :param window_rows/window_cols: per-tile candidate window in grid cells.
    :param chunk_tris: triangles per streaming z-merge step.
    :param patch_size: cells per binning patch side.
    :param map_batch: kept for config parity (the JAX grid path's tiles per
        ``lax.map`` step); the port has no use for it.
    :param edge_cull_threshold: cull triangles whose model-space corner depth
        spread exceeds this value.
    :param row_anchors: row-anchored candidate windows per tile, merged by
        depth.
    """

    tile_h: int = 8
    tile_w: int = 128
    window_rows: int = 32
    window_cols: int = 80
    chunk_tris: int = 512
    patch_size: int = 8
    map_batch: int = 32
    edge_cull_threshold: Optional[float] = None
    row_anchors: int = 1

    def __post_init__(self):
        assert self.tile_h > 0 and self.tile_w > 0
        assert self.window_rows > 0 and self.window_cols > 0
        assert self.chunk_tris > 0 and self.patch_size > 0
        assert self.row_anchors >= 1


def suggest_config(grid_n: int, width: int, height: int,
                   **overrides) -> RasterConfig:
    """Heuristic raster config for a near-frontal view of a ``grid_n``-vertex
    grid: the window from the average cell footprint with a margin for
    parallax and patch granularity, clamped to the grid."""
    cells = max(1, grid_n - 1)
    tile_h = overrides.pop("tile_h", 8)
    tile_w = overrides.pop("tile_w", 128)
    patch = overrides.pop("patch_size", 8)
    cell_h = max(height / cells, 0.5)
    cell_w = max(width / cells, 0.5)
    margin = 2 * patch + 8
    rows = min(cells, int(tile_h / cell_h) + margin)
    cols = min(cells, int(tile_w / cell_w) + margin)
    rows = min(cells, -(-rows // patch) * patch)
    cols = min(cells, -(-cols // 16) * 16)
    return RasterConfig(tile_h=tile_h, tile_w=tile_w, window_rows=rows,
                        window_cols=cols, patch_size=patch, **overrides)


def triangle_planes(p0, p1, p2, z0, z1, z2):
    """Per-triangle λ and depth plane coefficients.

    Each of ``p0/p1/p2`` is (..., 2) window xy. Returns ``(coeffs, area2)``:
    ``coeffs`` is (..., 4, 3), the (A, B, C) rows of λ0, λ1, λ2 and z as
    affine functions of window position (λ normalised by the doubled signed
    area). Back-facing and degenerate triangles have ``area2 <= 0``; the
    caller masks them. Rounded as XLA's CPU backend rounds the JAX function
    under ``jit``: ``a*b - c*d`` is ``fma(a, b, -(c*d))`` and the depth plane
    ``fma(z2, l2, fma(z0, l0, z1*l1))``.
    """

    def edge(pa, pb):
        ax, ay = pa[..., 0], pa[..., 1]
        bx, by = pb[..., 0], pb[..., 1]
        return torch.stack([-(by - ay), bx - ax,
                            fma(by - ay, ax, -((bx - ax) * ay))], dim=-1)

    e0, e1, e2 = edge(p1, p2), edge(p2, p0), edge(p0, p1)
    area2 = fma(p1[..., 0] - p0[..., 0], p2[..., 1] - p0[..., 1],
                -((p1[..., 1] - p0[..., 1]) * (p2[..., 0] - p0[..., 0])))
    inv_area = torch.where(area2.abs() > 1e-12,
                           torch.ones_like(area2) / area2,
                           torch.zeros_like(area2))
    l0 = e0 * inv_area[..., None]
    l1 = e1 * inv_area[..., None]
    l2 = e2 * inv_area[..., None]
    zc = fma(z2[..., None], l2, fma(z0[..., None], l0, z1[..., None] * l1))
    return torch.stack([l0, l1, l2, zc], dim=-2), area2


def quantise_texture(texture):
    """(Ht, Wt, C) float or uint8 texels -> float32 rounded to 8 bits
    (the uploaded RGBA8 texels GL filters)."""
    t = torch.as_tensor(texture).to(_F32)
    return torch.clamp(torch.round(t), 0.0, 255.0)


def sample_texture_bilinear(texture, u, v):
    """Bilinear, clamp-to-edge sample of 8-bit-quantised texels.

    :param texture: (Ht, Wt, C) texels (float in 0..255, or uint8).
    :param u, v: texture coordinates of one shape; ``v = 1`` samples row 0.
    :return: (..., C) float32 samples.
    """
    tex = quantise_texture(texture)
    ht, wt = tex.shape[0], tex.shape[1]
    tx = torch.clamp(u * wt - 0.5, 0.0, wt - 1.0)
    ty = torch.clamp((1.0 - v) * ht - 0.5, 0.0, ht - 1.0)
    x0f = torch.floor(tx)
    y0f = torch.floor(ty)
    fx = (tx - x0f)[..., None]
    fy = (ty - y0f)[..., None]
    x0 = x0f.long()
    y0 = y0f.long()
    x1 = torch.clamp(x0 + 1, max=wt - 1)
    y1 = torch.clamp(y0 + 1, max=ht - 1)
    c00, c01 = tex[y0, x0], tex[y0, x1]
    c10, c11 = tex[y1, x0], tex[y1, x1]
    top = c00 + (c01 - c00) * fx
    bot = c10 + (c11 - c10) * fx
    return top + (bot - top) * fy


def shade(covered, u, v, z_model, texture, mode: str, min_lam=None):
    """Fragment shading -> (..., 4) uint8: ``texture`` (the reference's
    ``shader.frag``), ``debug_z`` (grey model z, texture alpha) or
    ``wireframe`` (texture shading where the winner's min-barycentric
    ``min_lam`` is within :data:`WIREFRAME_EDGE_THRESHOLD`), with the black,
    alpha-255 background where uncovered."""
    if mode == "wireframe":
        if min_lam is None:
            raise ValueError("wireframe shading needs the winner min-bary")
        covered = covered & (min_lam <= WIREFRAME_EDGE_THRESHOLD)
        mode = "texture"
    tex = sample_texture_bilinear(texture, u, v)
    if mode == "texture":
        rgba = tex
    elif mode == "debug_z":
        grey = torch.clamp(z_model, 0.0, 1.0) * 255.0
        rgba = torch.stack([grey, grey, grey, tex[..., 3]], dim=-1)
    else:
        raise ValueError(f"Unknown shading mode {mode!r}")
    background = torch.zeros(4, dtype=_F32, device=rgba.device)
    background[3] = 255.0   # filled on the device: no host copy, no wait
    out = torch.where(covered[..., None], rgba, background)
    return torch.clamp(torch.round(out), 0.0, 255.0).to(torch.uint8)
