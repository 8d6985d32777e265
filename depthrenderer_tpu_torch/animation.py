"""Camera-path animation as functions of a batch of frame times.

Counterpart of ``depthrenderer_tpu/animation.py`` (reference
``DepthRenderer/animation.py:1-119``). Every animation maps a (T,) float32
tensor of elapsed times to a (T, 4, 4) batch of transforms; the batch
dimension is written out where the JAX package ``vmap``s a scalar function.
The float32 expressions follow the JAX package's order of operations.

The k-th rendered frame (k = 0, 1, ...) sees ``elapsed = (k+1) / fps``,
because the reference updates the animation before reading it
(``__main__.py:143-148``).

The reference's stateful API (``update``, ``reset``, ``transform``,
``apply``; ``animation.py:6-27``) wraps the same functions: ``transform``
is ``transform_at(elapsed)`` on the animation's ``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from .transforms import Axis, identity, matmul, rotation, translation

_F32 = torch.float32


def _c(x, like):
    """A float32 constant on ``like``'s device (rounded from a Python float,
    as JAX rounds a weakly typed scalar)."""
    return torch.full((), x, dtype=_F32, device=like.device)


def frame_times(num_frames: int, fps: float, device=None):
    """Elapsed times seen by each frame's animation update."""
    t = torch.arange(num_frames, dtype=_F32, device=device) + 1.0
    return t / torch.full((), fps, dtype=_F32, device=device)


class Animation:
    """Identity transform at all times."""

    elapsed = 0.0
    device = None   # where ``transform`` is computed

    def transform_at(self, t):
        """(T, 4, 4) transforms for a (T,) float32 tensor of times."""
        return identity(t.device).expand(t.shape + (4, 4))

    def batch(self, times, device=None):
        """Transforms for a vector of frame times -> (T, 4, 4)."""
        if isinstance(times, torch.Tensor):
            times = times.to(dtype=_F32, device=device)
        else:
            times = torch.tensor(np.asarray(times), dtype=_F32, device=device)
        return self.transform_at(times)

    # -- the reference's stateful API ---------------------------------------

    def update(self, delta):
        self.elapsed += delta

    def reset(self):
        self.elapsed = 0.0

    @property
    def transform(self):
        """The (4, 4) transform at the accumulated ``elapsed`` time."""
        t = torch.full((1,), self.elapsed, dtype=_F32, device=self.device)
        return self.transform_at(t)[0]

    def apply(self, other):
        """``other @ transform`` (reference ``animation.py:18-19``)."""
        return matmul(torch.as_tensor(other, dtype=_F32,
                                      device=self.device), self.transform)


class RotateAxisBounce(Animation):
    """``angle(t) = sin(2 pi (speed t + offset)) * angle`` about one axis."""

    def __init__(self, angle=np.pi / 2, axis=Axis.Y, speed=1.0, offset=0.0):
        self.angle = float(angle)
        self.axis = axis
        self.speed = float(speed)
        self.offset = float(offset)

    def transform_at(self, t):
        phase = _c(2.0 * np.pi, t) * (_c(self.speed, t) * t
                                      + _c(self.offset, t))
        return rotation(torch.sin(phase) * _c(self.angle, t), axis=self.axis)


class RotateXYBounce(Animation):
    """``R_y(sin(phi) angle) @ R_x(cos(phi) angle)``,
    ``phi = 2 pi (speed t + offset)``."""

    def __init__(self, angle=np.pi / 2, speed=1.0, offset=0.0):
        self.angle = float(angle)
        self.speed = float(speed)
        self.offset = float(offset)

    def transform_at(self, t):
        phase = _c(2.0 * np.pi, t) * (_c(self.speed, t) * t
                                      + _c(self.offset, t))
        angle = _c(self.angle, t)
        return matmul(rotation(torch.sin(phase) * angle, axis=Axis.Y),
                      rotation(torch.cos(phase) * angle, axis=Axis.X))


class Translate(Animation):
    """``d(t) = sin(2 pi speed t + 2 pi offset) * distance`` along one axis."""

    def __init__(self, distance=1.0, axis=Axis.X, speed=1.0, offset=0.0):
        self.distance = float(distance)
        self.axis = axis
        self.speed = float(speed)
        self.offset = float(offset)

    def transform_at(self, t):
        arg = (_c(self.speed, t) * t * _c(2.0, t) * _c(np.pi, t)
               + _c(self.offset * 2.0 * np.pi, t))
        d = torch.sin(arg) * _c(self.distance, t)
        zero = torch.zeros_like(d)
        return translation(d if self.axis == Axis.X else zero,
                           d if self.axis == Axis.Y else zero,
                           d if self.axis == Axis.Z else zero)


class Compose(Animation):
    """Matrix product of child animations, in list order."""

    def __init__(self, animations):
        self.animations = list(animations)

    def transform_at(self, t):
        out = identity(t.device).expand(t.shape + (4, 4))
        for animation in self.animations:
            out = matmul(out, animation.transform_at(t))
        return out

    def update(self, delta):
        """Advance this animation and every child (reference
        ``animation.py:98-106``)."""
        super().update(delta)
        for animation in self.animations:
            animation.update(delta)

    def reset(self):
        super().reset()
        for animation in self.animations:
            animation.reset()


def default_sway(animation_length_secs: float = 5.0):
    """The reference CLI's composed sway animation (``__main__.py:119-127``)."""
    speed = 1.0 / animation_length_secs
    return Compose([
        RotateAxisBounce(np.deg2rad(2.5), axis=Axis.Y, offset=0.5, speed=-speed),
        RotateAxisBounce(np.deg2rad(0.5), axis=Axis.X, offset=0.5, speed=-speed),
        Translate(distance=0.30, speed=speed),
        Translate(distance=0.15, axis=Axis.Y, offset=0.25, speed=speed),
    ])
