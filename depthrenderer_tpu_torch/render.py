"""Clip rendering: the whole camera path as MVP batches through the scan passes.

Counterpart of ``depthrenderer_tpu/render.py``'s :func:`render_clip` (the scan
path; ``MeshRenderer`` and the tiled and grid paths are not ported yet). Frames
render in groups on the current CUDA stream; each group's packed frames are
copied into a pinned host buffer with ``non_blocking`` copies and a CUDA event,
and the host unpacks and hands group k to ``on_frames`` while group k+1
renders.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .ops import raster_scan
from .scene import Mesh
from .transforms import matmul


def resolve_device(device) -> torch.device:
    """The render device. A CUDA device must exist: the port never falls
    back to the CPU on its own (``device="cpu"`` asks for it)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to render with the plain passes")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def _auto_impl(grid_n: int, width: int = 1920, height: int = 1080) -> str:
    """The rasteriser for a grid: the scan whenever the config it resolves
    to is the standard variant. The tiled path the JAX package falls back to
    is not ported, so anything else raises."""
    cfg = raster_scan.suggest_scan_config(grid_n, width, height)
    if raster_scan.scan_supported(grid_n, cfg):
        return "scan"
    raise NotImplementedError(
        f"grid n={grid_n} resolves to the big_grid scan variant (d >= 11), "
        "which is not ported yet (ROADMAP.md queue 1, 'scan variants')")


def _grid_arrays(mesh: Mesh):
    n = int(round(len(mesh.vertices) ** 0.5))
    if n * n != len(mesh.vertices):
        raise ValueError("grid mesh vertex count must be square")
    return (mesh.vertices.reshape(n, n, 3),
            mesh.texture_coordinates.reshape(n, n, 2), n)


def clip_mvps(projection, view_batch, model):
    """(T, 4, 4) float32 ``projection @ view @ model`` on the host (the
    passes need a host copy for the inverse MVPs)."""
    proj, views, model = (torch.as_tensor(m, dtype=torch.float32).cpu()
                          for m in (projection, view_batch, model))
    return matmul(matmul(proj, views), model)


def render_clip(mesh: Mesh, projection, view_batch, width, height,
                config: Optional[raster_scan.ScanConfig] = None,
                mode: str = "texture",
                frame_batch: int = raster_scan.FRAME_GROUP,
                on_frames: Optional[Callable[[int, np.ndarray], None]] = None,
                colfix="auto", device="cuda"):
    """Render a clip of a grid mesh through the scan passes.

    :param mesh: a grid :class:`Mesh` (its tensors move to ``device``).
    :param projection: (4, 4) projection matrix.
    :param view_batch: (T, 4, 4) per-frame view matrices.
    :param config: a :class:`ScanConfig`; by default
        ``suggest_scan_config`` for the grid and output size.
    :param frame_batch: frames per group (one prep batch, one host copy).
    :param on_frames: ``(start_index, frames)`` per group, frames (k, H, W, 4)
        uint8; called for group k while group k+1 renders.
    :param colfix: ``"auto"``, ``None`` or ``1`` (the ported fan widths).
    :param device: ``"cuda"`` (kernels) or ``"cpu"`` (plain passes).
    :return: the frame count, or the stacked (T, H, W, 4) uint8 frames when
        ``on_frames`` is None.
    """
    device = resolve_device(device)
    if not mesh.is_grid:
        raise ValueError("render_clip requires a grid mesh")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    vgrid, uvgrid, n = _grid_arrays(mesh)
    _auto_impl(n, width, height)
    if config is None:
        config = raster_scan.suggest_scan_config(
            n, width, height,
            **({} if colfix == "auto" else {"colfix": colfix}))
    raster_scan.check_supported(config)

    vgrid = vgrid.to(device)
    uvgrid = uvgrid.to(device)
    texture = mesh.texture.image.to(device)
    mvps = clip_mvps(projection, view_batch, mesh.transform)
    total = int(mvps.shape[0])
    g = raster_scan.ScanGeometry.of(width, height, n, n, config)
    cuda = device.type == "cuda"
    collected = []

    def deliver(start, host):
        frames = raster_scan.unpack_raw_frames(host, width, height)
        if on_frames is None:
            collected.append(frames.copy())
        else:
            on_frames(start, frames)

    # Two pinned host buffers: group k's copy lands in one while the host
    # reads group k-1 out of the other.
    hosts = ([torch.empty((frame_batch, g.hpad, g.wl), dtype=torch.int32,
                          pin_memory=True) for _ in range(2)] if cuda else [])
    pending = []  # (start, host tensor, event)
    overflow = torch.zeros((), dtype=torch.int64, device=device)
    for i, start in enumerate(range(0, total, frame_batch)):
        stop = min(start + frame_batch, total)
        dev, ovf = raster_scan.render_frames_scan(
            mvps[start:stop], vgrid, uvgrid, texture, width, height, config,
            mode, frame_batch=frame_batch)
        overflow = torch.maximum(overflow, ovf)
        if not cuda:
            deliver(start, dev)
            continue
        host = hosts[i % 2][:stop - start]
        host.copy_(dev, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        pending.append((start, host, event))
        if len(pending) > 1:
            s, h, e = pending.pop(0)
            e.synchronize()
            deliver(s, h)
    for s, h, e in pending:
        e.synchronize()
        deliver(s, h)
    raster_scan.warn_overflow(overflow, config)
    if on_frames is None:
        return np.concatenate(collected, axis=0)
    return total
