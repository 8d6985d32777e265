"""Streaming z-buffer rasteriser for an arbitrary triangle soup.

Counterpart of ``depthrenderer_tpu/ops/raster_soup.py``. Triangles are
taken in fixed-size chunks with a running (best z, best λ, best triangle)
state per pixel: every pixel is tested against every triangle, O(pixels x
triangles), so this route is for non-grid meshes, the straddling
triangles the lossless control composes (``raster_grid``) and tests. The
JAX function is plain ``jnp`` (no Pallas kernel), so this one is plain
PyTorch on every device.

Semantics are those of the float64 oracle (``raster_reference``) in
float32. Triangles that straddle the camera plane are clipped on the host
first (``raster_reference.clip_near_plane``). Within a chunk the lowest
triangle id wins a depth tie (``min`` takes the first index); across chunks
a strict ``<`` keeps the earlier chunk's winner. Masked triangles
(back-facing, degenerate, behind the camera, edge-culled) get planes that
cover nothing.

Float expressions follow the JAX function's rounding on XLA's CPU backend
under ``jit``: the projection and the planes as the grid route rounds them
(``common.project_vertices_tiled``, ``common.triangle_planes``), each plane
at a pixel as ``fma(qy, B, qx*A) + C`` (the (P, 3) @ (3, 4 TC) product
inside the JAX function's scan; the tiled routes' product contracts the
other term).
"""

from __future__ import annotations

import numpy as np
import torch

from . import common
from .raster_reference import clip_gl_near, device_of, host, near_depth

_F32 = torch.float32

# Bytes a step's (pixels x chunk triangles) working set may hold: about
# 60 bytes a pair (the four planes, the exact fma's float64 temporaries,
# the key and the coverage mask).
STEP_BYTES = 1 << 30
_PAIR_BYTES = 60
# Pixel rows of a step at most, and columns of the rectangles a step's
# chunks are culled against: a grid-ordered soup's chunk reaches few.
_CULL_ROWS, _CULL_COLS = 16, 128


def _on(x, dtype, dev):
    """An array or tensor as a tensor of ``dtype`` (None: its own) on
    ``dev``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x))
    return x.to(device=dev, dtype=dtype or x.dtype)


def _never(dev):
    """The planes of a triangle that covers no pixel: λ = -1, z = FAR."""
    never = torch.zeros((4, 3), dtype=_F32, device=dev)
    never[:3, 2] = -1.0
    never[3, 2] = common.FAR_SENTINEL
    return never


def soup_planes(vertices, uvs, tri, mvp, width, height,
                edge_cull_threshold=None):
    """Per-triangle planes of a soup -> ``(coeffs (T, 4, 3), inv_w (V,))``:
    rows λ0, λ1, λ2 and z as (A, B, C) of window position, masked
    triangles given the never-covered planes."""
    sx, sy, zn, inv_w = common.project_vertices_tiled(vertices, mvp, width,
                                                      height)
    p = torch.stack([sx, sy], dim=1)
    c = [tri[:, k] for k in range(3)]
    coeffs, area2 = common.triangle_planes(p[c[0]], p[c[1]], p[c[2]],
                                           zn[c[0]], zn[c[1]], zn[c[2]])
    valid = (area2 > 1e-12) & (inv_w[tri] > 0).all(1)
    if edge_cull_threshold is not None:
        zs = vertices[:, 2][tri]
        valid &= (zs.amax(1) - zs.amin(1)) <= edge_cull_threshold
    never = _never(vertices.device)
    return torch.where(valid[:, None, None], coeffs, never), inv_w


def chunks_reaching(planes, x0, x1, y0, y1):
    """Which chunks hold a triangle that can cover a pixel centre in one of
    the window rectangles [x0, x1] x [y0, y1] (1-D tensors, one entry a
    rectangle) -> (chunks,) bool.

    Each plane is affine, so its largest and smallest values over a
    rectangle are at corners (exact in float64); the float32 value at a
    pixel, ``fma(qy, B, qx*A) + C``, is within 3 ulp of the magnitudes
    ``|qx A| + |qy B| + |C|`` of the exact one, so a margin of 2^-20 of
    them keeps every triangle whose three λ and z can all pass somewhere in
    the rectangle. A skipped chunk changes no pixel of the rectangles.
    Small rectangles cull more: a triangle passes only where the
    rectangle meets each of its three half-planes.
    """
    a, b, c = (planes[:, :, k, :, None].double() for k in range(3))
    x0, x1, y0, y1 = (t.double() for t in (x0, x1, y0, y1))
    hi = c + torch.maximum(a * x0, a * x1) + torch.maximum(b * y0, b * y1)
    lo = c + torch.minimum(a * x0, a * x1) + torch.minimum(b * y0, b * y1)
    err = 2.0**-20 * (a.abs() * torch.maximum(x0.abs(), x1.abs())
                      + b.abs() * torch.maximum(y0.abs(), y1.abs())
                      + c.abs())
    reach = ((hi[:, :3] + err[:, :3] >= 0.0).all(1)
             & (hi[:, 3] + err[:, 3] >= -1.0) & (lo[:, 3] - err[:, 3] <= 1.0))
    reach |= ~torch.isfinite(hi + err).all(1) | ~torch.isfinite(lo).all(1)
    return reach.flatten(1).any(-1)


def _chunk_min(planes, qx, qy):
    """One chunk at a set of pixels: planes (4, 3, TC), qx, qy (P, 1) ->
    (chunk best z (P,), index of the first triangle that reaches it (P,),
    λ (3, P, TC))."""
    E = [common.fma(qy, planes[k, 1], qx * planes[k, 0]) + planes[k, 2]
         for k in range(4)]
    covered = ((E[0] >= 0.0) & (E[1] >= 0.0) & (E[2] >= 0.0)
               & (E[3] >= -1.0) & (E[3] <= 1.0))
    key = torch.where(covered, E[3], common.FAR_SENTINEL)
    best, arg = key.min(dim=1)   # the first index among equal minima
    return best, arg, torch.stack(E[:3])


def rasterize_soup(vertices, uvs, indices, mvp, texture, width: int,
                   height: int, mode: str = "texture", chunk_tris: int = 256,
                   edge_cull_threshold=None, pixel_tile=None):
    """Render a triangle soup on the device of ``vertices``.

    :param vertices: (V, 3) model-space positions.
    :param uvs: (V, 2) texture coordinates.
    :param indices: flat (T*3,) triangle indices.
    :param mvp: (4, 4) model-view-projection matrix.
    :param texture: (Ht, Wt, 4) texels (0..255).
    :param mode: ``texture``, ``debug_z``, ``wireframe`` or ``texture_z``.
    :param chunk_tris: triangles per streaming step.
    :param edge_cull_threshold: optional model-z spread cull.
    :param pixel_tile: pixels per step, rounded down to whole rows, at most
        16 (by default as many as keep a step within :data:`STEP_BYTES`);
        each step skips the chunks that cannot reach its rows
        (:func:`chunks_reaching`, in blocks of 128 columns). A pixel's
        result depends on neither.
    :return: (height, width, 4) uint8 frame, top-down; with ``texture_z``
        also the (height, width) float32 NDC depth, ``FAR_SENTINEL`` where
        nothing covers the pixel (the depth-merge key of the lossless
        control).
    """
    if mode not in ("texture", "debug_z", "wireframe", "texture_z"):
        raise ValueError(f"Unknown shading mode {mode!r}")
    dev = device_of(vertices)
    if (near_depth(vertices, mvp) <= 0).any():
        v64, uv64, idx = clip_gl_near(vertices, uvs, indices, mvp)
        vertices, uvs, indices = v64.astype(np.float32), uv64, idx
    v, uv = _on(vertices, _F32, dev), _on(uvs, _F32, dev)
    tri = _on(indices, torch.int64, dev).reshape(-1, 3)
    m = _on(mvp, _F32, dev)
    texture = _on(texture, None, dev)
    T = len(tri)
    if T == 0:   # one triangle that covers nothing
        tri = torch.zeros((1, 3), dtype=torch.int64, device=dev)
        v = torch.cat([v, torch.zeros((1, 3), dtype=_F32, device=dev)])
        uv = torch.cat([uv, torch.zeros((1, 2), dtype=_F32, device=dev)])
        T = 1
    coeffs, inv_w = soup_planes(v, uv, tri, m, width, height,
                                edge_cull_threshold)
    tc = chunk_tris
    pad = (-T) % tc
    if pad:
        coeffs = torch.cat([coeffs, _never(dev).expand(pad, 4, 3)])
    # (chunks, 4, 3, TC): each plane's A, B, C over a chunk's triangles.
    planes = coeffs.reshape(-1, tc, 4, 3).permute(0, 2, 3, 1).contiguous()

    P = width * height
    if pixel_tile is None:
        pixel_tile = max(1, STEP_BYTES // (_PAIR_BYTES * tc))
    # A step takes whole pixel rows, at most _CULL_ROWS of them.
    rows = min(max(1, pixel_tile // width), _CULL_ROWS)
    # The chunks a step runs: those reaching one of its blocks of columns.
    bx0 = torch.arange(0, width, _CULL_COLS, dtype=_F32, device=dev) + 0.5
    bx1 = torch.clamp(bx0 + (_CULL_COLS - 1), max=width - 0.5)
    qx_all, qy_all = (q.reshape(-1) for q in common.pixel_centers(
        width, height, dev))
    best_z = torch.empty((P,), dtype=_F32, device=dev)
    best_tri = torch.empty((P,), dtype=torch.int64, device=dev)
    best_l = torch.empty((P, 3), dtype=_F32, device=dev)
    for r0 in range(0, height, rows):
        r1 = min(r0 + rows, height)
        sl = slice(r0 * width, r1 * width)
        qx, qy = qx_all[sl, None], qy_all[sl, None]
        n = qx.shape[0]
        bz = torch.full((n,), common.FAR_SENTINEL, dtype=_F32, device=dev)
        bt = torch.zeros((n,), dtype=torch.int64, device=dev)
        bl = torch.zeros((n, 3), dtype=_F32, device=dev)
        reach = chunks_reaching(planes, bx0, bx1,
                                torch.full_like(bx0, height - r1 + 0.5),
                                torch.full_like(bx0, height - r0 - 0.5))
        for j in torch.nonzero(reach).squeeze(1).tolist():
            cz, arg, lam = _chunk_min(planes[j], qx, qy)
            better = cz < bz     # strict: the earlier chunk wins a tie
            bz = torch.where(better, cz, bz)
            bt = torch.where(better, j * tc + arg, bt)
            picked = lam.gather(2, arg[None, :, None].expand(3, n, 1))[..., 0]
            bl = torch.where(better[:, None], picked.T, bl)
        best_z[sl], best_tri[sl], best_l[sl] = bz, bt, bl

    covered = best_z < common.FAR_SENTINEL
    corners = tri[best_tri.clamp(0, T - 1)]
    w_c = inv_w[corners]
    u_c, v_c = uv[corners][..., 0], uv[corners][..., 1]
    zm_c = v[:, 2][corners]

    def dot3(a):
        return ((a[:, 0] + a[:, 1]) + a[:, 2])

    den = dot3(best_l * w_c)
    den = torch.where(den.abs() > 1e-30, den, torch.ones_like(den))
    u = dot3(best_l * u_c * w_c) / den
    vv = dot3(best_l * v_c * w_c) / den
    z_model = dot3(best_l * zm_c * w_c) / den
    rgba = common.shade(covered, u, vv, z_model, texture,
                        "texture" if mode == "texture_z" else mode,
                        min_lam=best_l.amin(1)).reshape(height, width, 4)
    if mode == "texture_z":
        return rgba, torch.where(covered, best_z, common.FAR_SENTINEL
                                 ).reshape(height, width)
    return rgba
