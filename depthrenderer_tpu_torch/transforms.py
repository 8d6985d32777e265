"""4x4 homogeneous transform constructors on float32 tensors.

Counterpart of ``depthrenderer_tpu/transforms.py`` with the same semantics:

* :func:`perspective` uses the vertical field of view in **degrees** directly
  as the focal scale (the reference's nonstandard projection,
  ``DepthRenderer/utils.py:30-36``).
* Matrices act on column vectors (``M @ [x, y, z, 1]^T``).

Every constructor broadcasts over a leading batch shape: ``rotation`` of a (T,)
angle tensor is a (T, 4, 4) batch (the JAX package ``vmap``s the scalar form).
:func:`matmul` multiplies 4x4 batches with explicit float32 products summed in
index order, so the result does not depend on a matmul library's summation
order, precision mode (TF32) or device.
"""

from __future__ import annotations

import enum

import numpy as np
import torch

_F32 = torch.float32


class Axis(enum.Enum):
    """The axes of a 3-D coordinate system."""

    X = 0
    Y = 1
    Z = 2


def _t(x, device=None):
    return torch.as_tensor(x, dtype=_F32, device=device)


def _assemble(rows):
    """rows: 4 lists of 4 broadcastable f32 tensors -> (..., 4, 4)."""
    flat = [e for r in rows for e in r]
    flat = torch.broadcast_tensors(*flat)
    return torch.stack(flat, dim=-1).reshape(flat[0].shape + (4, 4))


def matmul(a, b):
    """(..., 4, 4) @ (..., 4, 4) in float32, summed left to right over k."""
    out = a[..., :, 0:1] * b[..., 0:1, :]
    for k in range(1, 4):
        out = out + a[..., :, k:k + 1] * b[..., k:k + 1, :]
    return out


def perspective(fov_y, aspect_ratio, near=0.01, far=1000.0, device=None):
    """Perspective projection matrix, reference semantics (degrees as focal
    scale), computed in float32 like the JAX package."""
    fov_y, aspect_ratio, near, far = (_t(v, device) for v in
                                      (fov_y, aspect_ratio, near, far))
    z = torch.zeros_like(fov_y)
    one = torch.ones_like(fov_y)
    return _assemble([
        [fov_y / aspect_ratio, z, z, z],
        [z, fov_y, z, z],
        [z, z, (far + near) / (near - far), (2.0 * near * far) / (near - far)],
        [z, z, -one, z],
    ])


def rotation(angle, axis: Axis = Axis.X, degrees: bool = False, device=None):
    """Rotation about a coordinate axis; ``angle`` may be a tensor of any
    shape (the result gains two trailing dims)."""
    angle = _t(angle, device)
    if degrees:
        angle = angle * _t(np.pi / 180.0, angle.device)
    c = torch.cos(angle)
    s = torch.sin(angle)
    z = torch.zeros_like(angle)
    one = torch.ones_like(angle)
    if axis == Axis.X:
        rows = [[one, z, z, z], [z, c, -s, z], [z, s, c, z], [z, z, z, one]]
    elif axis == Axis.Y:
        rows = [[c, z, s, z], [z, one, z, z], [-s, z, c, z], [z, z, z, one]]
    elif axis == Axis.Z:
        rows = [[c, -s, z, z], [s, c, z, z], [z, z, one, z], [z, z, z, one]]
    else:
        raise ValueError(f"Invalid axis {axis!r}; expected an {Axis}.")
    return _assemble(rows)


def translation(dx=0.0, dy=0.0, dz=0.0, device=None):
    """Translation matrix; components may be tensors of one shape."""
    dx, dy, dz = (_t(v, device) for v in (dx, dy, dz))
    z = torch.zeros_like(dx)
    one = torch.ones_like(dx)
    return _assemble([
        [one, z, z, dx],
        [z, one, z, dy],
        [z, z, one, dz],
        [z, z, z, one],
    ])


def scale(sx=1.0, sy=None, sz=None, device=None):
    """Scale matrix; with ``sy`` or ``sz`` None, ``sx`` scales all axes."""
    if sy is None or sz is None:
        sy = sx
        sz = sx
    sx, sy, sz = (_t(v, device) for v in (sx, sy, sz))
    z = torch.zeros_like(sx)
    one = torch.ones_like(sx)
    return _assemble([
        [sx, z, z, z],
        [z, sy, z, z],
        [z, z, sz, z],
        [z, z, z, one],
    ])


def identity(device=None):
    """4x4 float32 identity."""
    return torch.eye(4, dtype=_F32, device=device)
