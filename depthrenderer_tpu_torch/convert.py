"""State carried across from the JAX package, as plain numpy and dicts.

The two packages render the same scene with the same config through these:
the JAX package's ``Mesh`` arrays become this port's :class:`Mesh` and
:class:`Texture`, and ``dataclasses.asdict`` of its ``ScanConfig`` becomes
this port's :class:`ScanConfig`, and of its ``RasterConfig`` this port's
:class:`RasterConfig`. Nothing here imports the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from .meshgen import grid_indices
from .ops.common import RasterConfig
from .ops.raster_scan import ScanConfig
from .scene import Mesh, Texture


def scene_from_numpy(vertex_grid, uv_grid, texture, transform=None,
                     device=None):
    """A grid :class:`Mesh` from numpy arrays.

    :param vertex_grid: (n, n, 3) or (n*n, 3) float32 vertices.
    :param uv_grid: (n, n, 2) or (n*n, 2) float32 texture coordinates.
    :param texture: (H, W, 3|4) uint8 texels.
    :param transform: (4, 4) model matrix (identity if None).
    """
    vertices = np.array(vertex_grid, np.float32).reshape(-1, 3)
    uvs = np.array(uv_grid, np.float32).reshape(-1, 2)
    n = int(round(len(vertices) ** 0.5))
    if n * n != len(vertices):
        raise ValueError("grid vertex count must be square")
    density = int(round(np.log2(n - 1))) if n > 1 else 0
    if 2**density + 1 != n:
        raise ValueError(f"grid side {n} is not 2**density + 1")
    mesh = Mesh(Texture(texture, device=device), vertices, uvs,
                grid_indices(density, device), grid_density=density,
                device=device)
    if transform is not None:
        mesh.transform = torch.as_tensor(np.array(transform, np.float32),
                                         device=mesh.vertices.device)
    return mesh


def scan_config_from_dict(d: dict) -> ScanConfig:
    """This port's :class:`ScanConfig` from ``dataclasses.asdict`` of the
    JAX package's (same field names)."""
    return ScanConfig(**dict(d))


def raster_config_from_jax(d: dict) -> RasterConfig:
    """This port's :class:`RasterConfig` from ``dataclasses.asdict`` of the
    JAX package's (same field names), so both render with one static
    config."""
    return RasterConfig(**dict(d))
