"""The march probes: ``transpose`` and ``march_top2``.

Counterparts of ``experiments/scan_probe_march.py``'s P1 (an in-kernel
(8, 256) -> (256, 8) transpose) and P2 (the scan march's core: per row ``y``
and pixel ``l`` a dense sign test over the row's 256 crossing columns and
the top 2 crossings by depth, summed over trips). The probe's P3, P3b and
P3c are gathers (``gather_accum``, :mod:`.gather`).
"""

from __future__ import annotations

import torch

from .. import probes as _p
from ..ops import cuda_build

_F32 = torch.float32

# The probe's "no crossing" key.
BIG = 3.0e38


def transpose_plain(x):
    """Plain twin of ``transpose``."""
    return x.transpose(0, 1).contiguous()


def transpose(x):
    """``x`` (R, C) float32 -> (C, R).

    CPU tensors: :func:`transpose_plain`; CUDA tensors: the ``transpose``
    kernel (one launch), or an exception."""
    if _p.on_cpu(x):
        return transpose_plain(x)
    r, c = x.shape
    cuda_build.check_cuda({"x": x}, {"x": _F32}, {"x": (r, c)})
    out = torch.empty((c, r), dtype=_F32, device=x.device)
    _p.launch("transpose", (x, out), _p.ProbeParams(R=r, C=c))
    return out


def march_top2_plain(curve, zc, qx, case, trips: int, copies: int = 1):
    """Plain twin of ``march_top2``, written as the probe's kernel is: per
    trip ``t``, ``f = curve[y, c] - (qx[0, l] + 0.001 * t)`` (float32
    product, then sum), ``hit = f * f[c + 1 mod C] <= 0 & zc < BIG``, key
    ``zc`` where hit else BIG, then the least key ``m1``, its lowest column
    ``o1``, and the same over the other columns (``o2``, ``m2``); rows
    ``4y .. 4y + 3`` of the (4Y, L) sum hold ``o1, m1, o2, m2``;
    ``copies`` > 1 stacks that many."""
    y, c = curve.shape
    dev = curve.device
    iota = torch.arange(c, dtype=_F32, device=dev)[None, :, None]
    z = zc[:, :, None]
    acc = torch.zeros((4 * y, qx.shape[1]), dtype=_F32, device=dev)
    step = torch.tensor(0.001, dtype=_F32, device=dev)
    for t in range(trips):
        shift = step * torch.tensor(float(t), dtype=_F32, device=dev)
        f = curve[:, :, None] - (qx[0:1, :] + shift)[None]     # (Y, C, L)
        f2 = torch.roll(f, -1, dims=1)
        key = torch.where((f * f2 <= 0.0) & (z < BIG), z, BIG)
        m1 = key.amin(dim=1, keepdim=True)
        o1 = torch.where(key == m1, iota, BIG).amin(dim=1, keepdim=True)
        key2 = torch.where(iota == o1, BIG, key)
        m2 = key2.amin(dim=1, keepdim=True)
        o2 = torch.where(key2 == m2, iota, BIG).amin(dim=1, keepdim=True)
        acc = acc + torch.cat([o1, m1, o2, m2], dim=1).reshape(acc.shape)
    return acc if copies == 1 else acc.expand(copies, *acc.shape).contiguous()


def march_top2(curve, zc, qx, case, trips: int, copies: int = 1):
    """The march's top-2 crossing search over ``curve`` and ``zc`` (Y, C)
    for the pixels ``qx[0]`` (qx (Y, L)), summed over ``trips`` trips ->
    (4Y, L) float32 (see :func:`march_top2_plain`; ``copies`` > 1: that
    many identical outputs, each its own blocks).

    CPU tensors: :func:`march_top2_plain`; CUDA tensors: the ``march_top2``
    kernel (one launch), or an exception."""
    if _p.on_cpu(curve, zc, qx):
        return march_top2_plain(curve, zc, qx, case, trips, copies)
    y, c = case.table
    cuda_build.check_cuda({"curve": curve, "zc": zc, "qx": qx},
                          dict.fromkeys(("curve", "zc", "qx"), _F32),
                          {"curve": (y, c), "zc": (y, c), "qx": case.index})
    shape = (4 * y, case.index[1])
    out = torch.empty(shape if copies == 1 else (copies,) + shape,
                      dtype=_F32, device=curve.device)
    params = _p.ProbeParams(S=y, C=c, L=case.index[1], trips=trips,
                            copies=copies)
    _p.launch("march_top2", (curve, zc, qx, out), params)
    return out
