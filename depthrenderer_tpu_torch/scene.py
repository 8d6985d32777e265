"""Scene objects: :class:`Texture`, :class:`Mesh` and :class:`Camera`.

Counterparts of ``depthrenderer_tpu/scene.py`` (reference
``DepthRenderer/render.py:14-565``), holding tensors on a chosen device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import meshgen
from .transforms import Axis
from .utils import FrameTimer, log


class Texture:
    """An RGBA texture as an (H, W, 4) tensor; RGB images gain alpha 255.

    Sampled bilinearly with clamp-to-edge wrapping (reference
    ``render.py:333-372``).
    """

    def __init__(self, image, device=None):
        image = torch.as_tensor(np.array(image), device=device)
        if image.ndim != 3:
            raise ValueError(
                f"Image should have exactly three dimensions (height, width, "
                f"channels); got {image.ndim}.")
        if image.shape[2] == 3:
            alpha = torch.full(image.shape[:2] + (1,), 255, dtype=image.dtype,
                               device=image.device)
            image = torch.cat([image, alpha], dim=2)
        self.image = image

    @property
    def shape(self):
        return tuple(self.image.shape)


class Mesh:
    """A textured triangle mesh: ``vertices`` (V, 3) float32,
    ``texture_coordinates`` (V, 2) float32, flat int32 ``indices`` and the
    (4, 4) model ``transform``. Grid meshes record ``grid_density``."""

    def __init__(self, texture: Texture, vertices, texture_coordinates, indices,
                 grid_density: Optional[int] = None, device=None):
        self.texture = texture
        self.vertices = torch.as_tensor(vertices, dtype=torch.float32,
                                        device=device).clone()
        self.texture_coordinates = torch.as_tensor(
            texture_coordinates, dtype=torch.float32, device=device).clone()
        self.indices = torch.as_tensor(indices, dtype=torch.int32,
                                       device=device)
        self.transform = torch.eye(4, dtype=torch.float32,
                                   device=self.vertices.device)
        self.grid_density = grid_density

    @property
    def is_grid(self) -> bool:
        return self.grid_density is not None

    @property
    def num_triangles(self) -> int:
        return int(self.indices.numel()) // 3

    @staticmethod
    def from_texture(texture: Texture, depth_map=None, density=0, debug=False,
                     device=None):
        """The depth-displaced grid mesh (reference ``render.py:464-545``);
        with no depth map every z is 1."""
        if density % 1 != 0 or density < 0:
            raise ValueError(
                f"Density must be a non-negative whole number, got {density}.")
        if debug:
            log("Generating mesh...")
        timer = FrameTimer()
        if depth_map is None:
            n = meshgen.grid_vertex_count(int(density))
            depth_map = np.zeros((n, n), dtype=np.uint8)
        vertices, uvs, indices = meshgen.grid_mesh(depth_map, int(density),
                                                   device=device)
        mesh = Mesh(texture, vertices, uvs, indices,
                    grid_density=int(density), device=device)
        if debug:
            log(f"Num. triangles: {mesh.num_triangles:,d}")
            log(f"Num. vertices: {len(mesh.vertices):,d}")
            timer.update()
            log(f"Mesh Generation Took {1000 * timer.delta:.2f} ms")
        return mesh


class Camera:
    """A perspective camera: the reference's projection with ``fov_y`` in
    degrees used directly as the focal scale (``render.py:85-92``)."""

    def __init__(self, window_size, fov_y=60, near=0.01, far=1000.0,
                 device=None):
        self.window_size = tuple(window_size)
        self.fov_y = float(fov_y)
        self.near = float(near)
        self.far = float(far)
        self.device = device
        self.projection = self._projection_matrix(self.fov_y)

    def _projection_matrix(self, fov_y):
        # Python float arithmetic, rounded once to float32 — the JAX
        # package's numpy construction.
        fov_y = max(0.0, float(fov_y))
        n, f, a = self.near, self.far, self.aspect_ratio
        return torch.tensor(
            [[fov_y / a, 0, 0, 0],
             [0, fov_y, 0, 0],
             [0, 0, (f + n) / (n - f), (2 * n * f) / (n - f)],
             [0, 0, -1, 0]],
            dtype=torch.float32, device=self.device)

    @property
    def aspect_ratio(self):
        return self.window_width / self.window_height

    @property
    def window_width(self):
        return self.window_size[0]

    @property
    def window_height(self):
        return self.window_size[1]


__all__ = ["Texture", "Mesh", "Camera", "Axis"]
