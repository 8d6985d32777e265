"""Scene- and frame-parallel rendering over a list of devices.

Counterpart of ``depthrenderer_tpu/parallel/sharding.py``. Rendering novel
views is embarrassingly parallel over frames and scenes, so each device owns
a contiguous block of them (the JAX package's shard of a 1-D device mesh)
and renders it through the same function the one-device path calls
(``render_frames_scan``, ``render_frames_pallas`` or ``render_frames_grid``),
so a scene's frames equal the one-scene path's byte for byte whatever the
device count. The JAX package needs ``shard_map``, a traceable in-trace
float32 inverse MVP and padding to a multiple of the device count for that;
here each device's work is queued from the host, and the kernels launch
asynchronously on each device's current stream, so the devices overlap
without either.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch

from ..ops import raster_grid, raster_pallas, raster_scan
from ..ops.common import RasterConfig

IMPLS = ("scan", "pallas", "grid")


def default_devices() -> list:
    """Every CUDA device; raises without one (no silent CPU fallback)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass devices=[torch.device('cpu')]"
                           " to render with the plain passes")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def device_blocks(count: int, num_devices: int) -> list:
    """Contiguous ``(start, stop)`` blocks of ``count`` items, one a device:
    ``ceil(count / num_devices)`` each, the last ones shorter or empty (the
    JAX shard's split of the padded axis)."""
    per = -(-count // num_devices) if count else 0
    return [(min(d * per, count), min((d + 1) * per, count))
            for d in range(num_devices)]


def _on(device):
    """The context that makes ``device`` current (CUDA) or nothing (CPU)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _upload(mvps, device):
    """(T, 4, 4) float32 MVPs on ``device``, by a pinned non-blocking copy
    on CUDA (a pageable copy would wait for the stream)."""
    mvps = torch.as_tensor(mvps, dtype=torch.float32).cpu()
    if device.type == "cpu":
        return mvps
    return mvps.pin_memory().to(device, non_blocking=True)


def _render_frames(impl, mvps, vertex_grid, uv_grid, texture, width, height,
                   config, scan_config, mode, frame_batch):
    """One scene's frames on the device of ``vertex_grid`` -> ((T, H, W, 4)
    uint8, the scan's overflow scalar or None). The scan takes ``uv_grid``
    None (checked by the caller)."""
    if impl == "scan":
        if scan_config is None:
            scan_config = raster_scan.suggest_scan_config(
                vertex_grid.shape[0], width, height)
        raw, overflow = raster_scan.render_frames_scan(
            mvps, vertex_grid, uv_grid, texture, width, height, scan_config,
            mode, frame_batch=frame_batch)
        return raster_scan.raw_rgba(raw, width, height), overflow
    frames_fn = (raster_pallas.render_frames_pallas if impl == "pallas"
                 else raster_grid.render_frames_grid)
    mvps = _upload(mvps, vertex_grid.device)
    return frames_fn(mvps, vertex_grid, uv_grid, texture, width, height,
                     config, mode, frame_batch=frame_batch), None


def _check_impl(impl):
    if impl not in IMPLS:
        raise ValueError(f"unknown sharded raster impl {impl!r} (want one of "
                         f"{IMPLS})")


def _check_uv_grids(impl, uv_grids):
    """The scan checks each given UV grid here, once a call (a grid on a
    card is read back: the caller that renders in chunks checks its grids
    once and passes None); the tiled routes need the grids."""
    if uv_grids is None:
        if impl != "scan":
            raise ValueError(f"impl {impl!r} needs the UV grids (only the "
                             "scan rebuilds UVs and takes None)")
        return
    if impl == "scan":
        for uv in uv_grids:
            raster_scan.check_uv_grid(uv)


def render_scenes_sharded(mvps, vertex_grids, uv_grids, textures, width: int,
                          height: int, config: RasterConfig = RasterConfig(),
                          mode: str = "texture",
                          frame_batch: int = raster_scan.FRAME_GROUP,
                          impl: str = "scan", scan_config=None,
                          devices: Optional[Sequence] = None,
                          with_overflow: bool = False):
    """Render many scenes, each device owning a contiguous block of them
    (:func:`device_blocks`).

    :param mvps: (S, T, 4, 4) per-scene, per-view MVPs (host float32).
    :param vertex_grids: S (n, n, 3) grids; ``uv_grids`` S (n, n, 2), or
        None on the scan for grids already checked with
        ``raster_scan.check_uv_grid``; ``textures`` S (Ht, Wt, 4). Each
        moves to its scene's device (no copy where it lies there already:
        put them there once).
    :param config: the tiled routes' :class:`RasterConfig`.
    :param scan_config: the scan's ``ScanConfig`` (default
        ``suggest_scan_config(n, width, height)``).
    :param devices: the devices (default :func:`default_devices`).
    :return: a list of S (T, height, width, 4) uint8 tensors, each on its
        scene's device; with ``with_overflow`` also the list of the scan's
        per-scene overflow scalars (None on the tiled routes). With host
        MVPs and the scan's ``uv_grids`` None or on the host, nothing here
        waits for a device.
    """
    _check_impl(impl)
    _check_uv_grids(impl, uv_grids)
    devices = [torch.device(d) for d in (devices or default_devices())]
    mvps = torch.as_tensor(mvps, dtype=torch.float32)
    S = len(vertex_grids)
    frames, overflow = [None] * S, [None] * S
    for dev, (s0, s1) in zip(devices, device_blocks(S, len(devices))):
        with _on(dev):
            for s in range(s0, s1):
                frames[s], overflow[s] = _render_frames(
                    impl, mvps[s], torch.as_tensor(vertex_grids[s],
                                                   device=dev),
                    None if impl == "scan"
                    else torch.as_tensor(uv_grids[s], device=dev),
                    torch.as_tensor(textures[s], device=dev), width, height,
                    config, scan_config, mode, frame_batch)
    return (frames, overflow) if with_overflow else frames


def render_frames_sharded(mvps, vertex_grid, uv_grid, texture, width: int,
                          height: int, config: RasterConfig = RasterConfig(),
                          mode: str = "texture",
                          frame_batch: int = raster_scan.FRAME_GROUP,
                          with_stats: bool = False, impl: str = "grid",
                          scan_config=None,
                          devices: Optional[Sequence] = None):
    """Render one clip with its frames in contiguous blocks, one a device;
    the scene is copied to every device.

    :param mvps: (T, 4, 4) per-frame MVPs.
    :param uv_grid: (n, n, 2), or None on the scan for a grid already
        checked (see :func:`render_scenes_sharded`).
    :return: a list of per-device (T_d, height, width, 4) uint8 blocks in
        frame order (empty blocks left out); with ``with_stats`` also
        ``{"mean_luma": float}``, the mean BT.601 luma over every frame.
    """
    _check_impl(impl)
    _check_uv_grids(impl, None if uv_grid is None else [uv_grid])
    devices = [torch.device(d) for d in (devices or default_devices())]
    mvps = torch.as_tensor(mvps, dtype=torch.float32)
    blocks = []
    for dev, (f0, f1) in zip(devices, device_blocks(len(mvps), len(devices))):
        if f1 == f0:
            continue
        with _on(dev):
            blocks.append(_render_frames(
                impl, mvps[f0:f1], torch.as_tensor(vertex_grid, device=dev),
                None if impl == "scan"
                else torch.as_tensor(uv_grid, device=dev),
                torch.as_tensor(texture, device=dev), width, height, config,
                scan_config, mode, frame_batch)[0])
    if not with_stats:
        return blocks
    weights = torch.tensor([0.299, 0.587, 0.114], dtype=torch.float64)
    luma = sum(float((b[..., :3].double() @ weights.to(b.device)).sum())
               for b in blocks)
    count = sum(b.shape[0] * b.shape[1] * b.shape[2] for b in blocks)
    return blocks, {"mean_luma": luma / max(count, 1)}
