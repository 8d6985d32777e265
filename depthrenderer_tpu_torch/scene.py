"""Scene objects: :class:`Texture`, :class:`Mesh` and :class:`Camera`.

Counterparts of ``depthrenderer_tpu/scene.py`` (reference
``DepthRenderer/render.py:14-565``), holding tensors on a chosen device.
There is no GL upload, so the reference's ``cleanup`` methods free
nothing. The camera's navigation builds its matrices in numpy float32 as
the JAX package does, so they equal its matrices bit for bit.
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

    def copy(self):
        return Texture(self.image.clone(), device=self.image.device)

    def cleanup(self):   # API parity; nothing to free.
        pass


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

    def cleanup(self):   # API parity; nothing to free.
        pass

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

    @staticmethod
    def from_copy_with_new_depth(mesh: "Mesh", depth_map):
        """Copy a grid mesh, replacing only its z displacement from a new
        depth map (reference ``render.py:547-565``)."""
        if not mesh.is_grid:
            raise ValueError("from_copy_with_new_depth requires a grid mesh.")
        dev = mesh.vertices.device
        vertices = mesh.vertices.clone()
        vertices[:, 2] = meshgen.grid_depth(depth_map, mesh.grid_density,
                                            device=dev).reshape(-1)
        out = Mesh(mesh.texture.copy(), vertices, mesh.texture_coordinates,
                   mesh.indices.clone(), grid_density=mesh.grid_density,
                   device=dev)
        out.transform = mesh.transform.clone()
        return out


def _host(m):
    return m.detach().cpu().numpy()


class Camera:
    """A perspective camera: the ``view`` matrix and the reference's
    projection with ``fov_y`` in degrees used directly as the focal scale
    (``render.py:85-92``). The reference's mouse and keyboard navigation are
    plain methods here: :meth:`zoom_in`, :meth:`zoom_out`,
    :meth:`reset_zoom`, :meth:`pan` and :meth:`rotate`."""

    def __init__(self, window_size, fov_y=60, near=0.01, far=1000.0,
                 zoom_speed=10, device=None):
        self.window_size = tuple(window_size)
        self.fov_y = float(fov_y)
        self.original_fov_y = float(fov_y)
        self.near = float(near)
        self.far = float(far)
        self.zoom_speed = float(zoom_speed)
        self.near_zoom_rate = 1.05
        self.rotation_speed = 0.001
        self.device = device
        self.view = torch.eye(4, dtype=torch.float32, device=device)
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

    @property
    def view_projection_matrix(self):
        """``projection @ view`` (numpy float32, as the JAX package forms
        it)."""
        return torch.from_numpy(_host(self.projection) @ _host(self.view)
                                ).to(self.device)

    # -- zoom (reference render.py:94-121) ---------------------------------

    def zoom_in(self):
        if self.fov_y < self.zoom_speed:
            self.fov_y *= self.near_zoom_rate
        else:
            self.fov_y += self.zoom_speed
        self.projection = self._projection_matrix(self.fov_y)

    def zoom_out(self):
        if self.fov_y <= self.zoom_speed:
            self.fov_y *= 0.9
        else:
            self.fov_y -= self.zoom_speed
        self.projection = self._projection_matrix(self.fov_y)

    def reset_zoom(self):
        self.fov_y = self.original_fov_y
        self.projection = self._projection_matrix(self.fov_y)

    # -- navigation (reference render.py:152-170) --------------------------

    def _post_multiply(self, m):
        self.view = torch.from_numpy(_host(self.view) @ m).to(self.device)

    def pan(self, dx, dy):
        """Translate the view in the image plane, normalised by the window
        size."""
        t = np.eye(4, dtype=np.float32)
        t[0, 3] = dx / self.window_width
        t[1, 3] = dy / self.window_height
        self._post_multiply(t)

    def rotate(self, dx, dy):
        """Rotate the view by mouse-style deltas (reference
        ``render.py:160-164``)."""
        cy, sy = (np.cos(self.rotation_speed * dx),
                  np.sin(self.rotation_speed * dx))
        cx, sx = (np.cos(-self.rotation_speed * dy),
                  np.sin(-self.rotation_speed * dy))
        rot_y = np.array([[cy, 0, sy, 0], [0, 1, 0, 0], [-sy, 0, cy, 0],
                          [0, 0, 0, 1]], dtype=np.float32)
        rot_x = np.array([[1, 0, 0, 0], [0, cx, -sx, 0], [0, sx, cx, 0],
                          [0, 0, 0, 1]], dtype=np.float32)
        self._post_multiply(rot_y @ rot_x)


__all__ = ["Texture", "Mesh", "Camera", "Axis"]
