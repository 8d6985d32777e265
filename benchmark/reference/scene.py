"""The reference's mesh, camera and camera path, in float64.

The semantics are the DepthRenderer application's (its ``render.py`` mesh
and projection, ``animation.py`` and the CLI's ``__main__.py`` sway), as the
port documents them: a grid of ``(2^d + 1)^2`` vertices over ``x, y in
[-1, 1]`` with y aspect-corrected, ``z = (1 - depth/255) * displacement``
from the nearest depth pixel, UVs ``u: 0 -> 1`` left to right and ``v:
1 -> 0`` top to bottom; the projection with ``fov_y`` in degrees used as
the focal scale; the camera at ``dz = -10`` behind the composed 5-second
sway; frame ``k`` at ``t = (k + 1) / fps``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

F64 = torch.float64
NEAR, FAR = 0.01, 1000.0
CAMERA_DZ = -10.0
SWAY_SECONDS = 5.0


def vertex_count(density: int) -> int:
    return 2 ** density + 1


def grid(depth, density: int, displacement: float, device="cpu"):
    """-> ((n, n, 3) vertices, (n, n, 2) UVs), float64 on ``device``."""
    depth = np.asarray(depth)
    height, width = depth.shape
    n = vertex_count(density)
    i = np.arange(n, dtype=np.float64)
    u_px = (i / n * width).astype(np.int64)
    v_px = height - 1 - ((1.0 - i / n) * height - 1.0).astype(np.int64)
    z = 1.0 - depth[v_px][:, u_px].astype(np.float64) / 255.0
    x = np.linspace(-1.0, 1.0, n)
    y = np.linspace(1.0, -1.0, n)
    hw = height / width
    y = hw * y - 0.5 * (1.0 - hw) * y
    verts = np.stack([np.broadcast_to(x[None, :], (n, n)),
                      np.broadcast_to(y[:, None], (n, n)),
                      z * displacement], axis=-1)
    uvs = np.stack([np.broadcast_to(np.linspace(0.0, 1.0, n)[None, :], (n, n)),
                    np.broadcast_to(np.linspace(1.0, 0.0, n)[:, None], (n, n))],
                   axis=-1)
    return (torch.as_tensor(verts, dtype=F64, device=device),
            torch.as_tensor(uvs, dtype=F64, device=device))


def projection(fov_y: float, width: int, height: int):
    a = width / height
    return np.array([[fov_y / a, 0, 0, 0],
                     [0, fov_y, 0, 0],
                     [0, 0, (FAR + NEAR) / (NEAR - FAR),
                      2 * NEAR * FAR / (NEAR - FAR)],
                     [0, 0, -1, 0]], dtype=np.float64)


def _rotation(angle: float, axis: str):
    c, s = math.cos(angle), math.sin(angle)
    if axis == "x":
        return np.array([[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0],
                         [0, 0, 0, 1]], dtype=np.float64)
    return np.array([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0],
                     [0, 0, 0, 1]], dtype=np.float64)


def _translation(dx=0.0, dy=0.0, dz=0.0):
    m = np.eye(4)
    m[:3, 3] = (dx, dy, dz)
    return m


def sway(t: float):
    """The CLI's composed sway at elapsed time ``t``: two bouncing
    rotations (2.5 degrees about y, 0.5 about x, phase 0.5, reversed) and
    two translations (0.30 along x; 0.15 along y, phase 0.25), one cycle
    per 5 seconds, multiplied in that order."""
    speed = 1.0 / SWAY_SECONDS

    def bounce(angle_deg, axis):
        phase = 2 * math.pi * (-speed * t + 0.5)
        return _rotation(math.sin(phase) * math.radians(angle_deg), axis)

    def move(distance, offset):
        return math.sin(2 * math.pi * speed * t + 2 * math.pi * offset) * distance

    return (bounce(2.5, "y") @ bounce(0.5, "x")
            @ _translation(dx=move(0.30, 0.0)) @ _translation(dy=move(0.15, 0.25)))


def mvp(frame: int, fps: float, fov_y: float, width: int, height: int):
    """(4, 4) float64 ``projection @ camera @ sway(t_frame)`` (the model
    matrix is the identity)."""
    t = (frame + 1) / fps
    return projection(fov_y, width, height) @ _translation(dz=CAMERA_DZ) @ sway(t)
