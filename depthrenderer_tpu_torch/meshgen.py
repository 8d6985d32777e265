"""Depth-displaced quad-grid mesh generation on tensors.

Counterpart of ``depthrenderer_tpu/meshgen.py`` (reference
``DepthRenderer/render.py:464-545``): a grid of ``(2^density + 1)^2`` vertices
spanning ``x, y in [-1, 1]`` (y scaled by the image aspect ratio), z =
``1 - depth/255`` from the nearest depth pixel, UVs ``u: 0->1`` left to right
and ``v: 1->0`` top to bottom, and two triangles per cell in the order
``(a, b, c), (c, b, d)``.

Every float is computed with the JAX package's float32 formulas (its
``linspace`` blend, its aspect expression and depth scaling) and rounded as
XLA's CPU backend rounds them, so vertices and UVs equal the JAX package's
element by element; the depth sample indices are host float64 like the
reference's numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.common import fma

_F32 = torch.float32


def grid_vertex_count(density: int) -> int:
    """Vertices per side of the grid for a given mesh density."""
    return 2**density + 1


def _linspace(start: float, stop: float, n: int, device=None):
    """float32 linspace with ``jnp.linspace``'s formula: start*(1-s) + stop*s
    with s = i/(n-1) in float32, and the exact endpoint appended."""
    start_t = torch.full((), start, dtype=_F32, device=device)
    stop_t = torch.full((), stop, dtype=_F32, device=device)
    if n == 1:
        return start_t.reshape(1)
    div = n - 1
    step = (torch.arange(div, dtype=_F32, device=device)
            / torch.full((), float(div), dtype=_F32, device=device))
    out = start_t * (1 - step) + stop_t * step
    return torch.cat([out, stop_t.reshape(1)])


def _depth_sample_indices(n: int, height: int, width: int):
    """Depth-map sample indices for an n-vertex grid side, in host float64:
    ``u = int(j/n * W)`` and the top-down row ``H - 1 - int((1 - i/n) * H - 1)``
    (reference ``render.py:503-504``)."""
    idx = np.arange(n, dtype=np.float64)
    u_px = (idx / n * width).astype(np.int64)
    v_px_gl = ((1.0 - idx / n) * height - 1.0).astype(np.int64)
    v_px = height - 1 - v_px_gl
    return u_px, v_px


def _sample_depth(depth_map, n: int, device=None):
    depth_map = torch.as_tensor(np.array(depth_map), device=device)
    if depth_map.ndim == 3:
        depth_map = depth_map[..., 0]
    height, width = depth_map.shape
    u_px, v_px = _depth_sample_indices(n, height, width)
    u_px = torch.as_tensor(u_px, device=depth_map.device)
    v_px = torch.as_tensor(v_px, device=depth_map.device)
    grid = depth_map[v_px][:, u_px].to(_F32)
    # z = 1 - d/255 rounded as XLA's CPU backend rounds the JAX package's
    # jitted form: d times the float32 reciprocal of 255, fused with the
    # subtraction.
    recip = torch.full_like(grid, float(np.float32(1.0) / np.float32(255.0)))
    return fma(-grid, recip, torch.ones_like(grid)), height, width


def grid_mesh(depth_map, density: int, device=None):
    """Generate the displaced grid mesh from an (H, W) uint8 depth map.

    :return: ``(vertices, uvs, indices)``: (n*n, 3) float32, (n*n, 2) float32
        and (cells*6,) int32 indices ``[a, b, c, c, b, d]`` per cell.
    """
    if density < 0:
        raise ValueError(f"Density must be non-negative, got {density}.")
    n = grid_vertex_count(density)
    z, height, width = _sample_depth(depth_map, n, device)
    dev = z.device

    x = _linspace(-1.0, 1.0, n, dev)
    y = _linspace(1.0, -1.0, n, dev)
    # Aspect correction as the reference: y = (h/w)y - 0.5(1 - h/w)y, the
    # first product fused with the subtraction (XLA's CPU rounding).
    hw = torch.full_like(y, height / width)
    y = fma(hw, y, -((0.5 * (1.0 - hw)) * y))
    u_tex = _linspace(0.0, 1.0, n, dev)
    v_tex = _linspace(1.0, 0.0, n, dev)

    xg = x[None, :].expand(n, n)
    yg = y[:, None].expand(n, n)
    vertices = torch.stack([xg, yg, z], dim=-1).reshape(-1, 3)
    uvs = torch.stack([u_tex[None, :].expand(n, n),
                       v_tex[:, None].expand(n, n)], dim=-1).reshape(-1, 2)
    return vertices, uvs, grid_indices(density, dev)


def grid_indices(density: int, device=None):
    """Triangle indices in the reference's per-cell order: for cell (i, j),
    a = i*n + j, b = a + n, c = a + 1, d = b + 1; triangles (a, b, c),
    (c, b, d)."""
    n = grid_vertex_count(density)
    i = torch.arange(n - 1, dtype=torch.int32, device=device)
    a = i[:, None] * n + i[None, :]
    b = a + n
    c = a + 1
    d = b + 1
    return torch.stack([a, b, c, c, b, d], dim=-1).reshape(-1)


def grid_depth(depth_map, density: int, device=None):
    """Just the displaced (n, n) z grid, rounded as :func:`grid_mesh`
    rounds it: the fast path for re-skinning a grid with a new depth map
    (reference ``Mesh.from_copy_with_new_depth``, ``render.py:547-565``)."""
    return _sample_depth(depth_map, grid_vertex_count(density), device)[0]
