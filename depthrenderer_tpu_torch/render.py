"""Renderers: the headless replacement for the reference's GLFW/GL frame
loop (``DepthRenderer/render.py:568-861``). Counterpart of
``depthrenderer_tpu/render.py``.

* :func:`render_clip` is the throughput path: the whole camera path as MVP
  batches through the column-crossing scan (the default, with its fidelity
  tiers ``quality`` and ``patch``), the tiled Pallas route or the tiled grid
  route. Frames render in groups on the current CUDA stream; each group's
  frames are copied into a pinned host buffer with ``non_blocking`` copies
  and a CUDA event, and the host hands group k to ``on_frames`` while group
  k+1 renders.
* :class:`MeshRenderer` is the API-parity path: the reference's
  callback-driven frame loop (``on_update``, ``on_exit``, ``get_frame``,
  pause, shader switching), one frame a draw through the same functions,
  read back before the next. A mesh that is not a grid renders through the
  soup (``ops/raster_soup``). Deliberate differences from the reference,
  as in the JAX package: the framebuffer is the requested size, and
  ``get_frame`` returns the frame just drawn (no PBO latency).
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from . import profiling
from .ops import raster_grid, raster_pallas, raster_scan, raster_soup
from .ops.common import RasterConfig, suggest_config
from .scene import Camera, Mesh
from .transforms import matmul
from .utils import FrameTimer, log

IMPLS = ("scan", "pallas", "grid")


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
    """The rasteriser for a grid, as the JAX package picks it on its
    accelerator: the scan whenever its suggested config fits the JAX
    package's budget (the standard variant through d10, big_grid through
    d12), else the tiled Pallas route."""
    cfg = raster_scan.suggest_scan_config(grid_n, width, height)
    return "scan" if raster_scan.scan_supported(grid_n, cfg) else "pallas"


def _grid_arrays(mesh: Mesh):
    n = int(round(len(mesh.vertices) ** 0.5))
    if n * n != len(mesh.vertices):
        raise ValueError("grid mesh vertex count must be square")
    return (mesh.vertices.reshape(n, n, 3),
            mesh.texture_coordinates.reshape(n, n, 2), n)


def _pin_matmul_precision():
    """Full float32 products on the card (no TF32), as the JAX package's
    HIGHEST precision."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def clip_mvps(projection, view_batch, model):
    """(T, 4, 4) float32 ``projection @ view @ model`` on the host (the
    passes need a host copy for the inverse MVPs)."""
    proj, views, model = (torch.as_tensor(m, dtype=torch.float32).cpu()
                          for m in (projection, view_batch, model))
    return matmul(matmul(proj, views), model)


def clip_scan_config(grid_n: int, width: int, height: int, colfix="auto",
                     quality: bool = False, patch: bool = False,
                     edge_cull_threshold: Optional[float] = None):
    """The scan's config for a clip (see :func:`render_clip` for the
    knobs); the batch farm's sharded path takes the same one."""
    if quality and patch:
        raise ValueError("quality and patch are mutually exclusive (quality "
                         "already runs the full transposed pass that patch "
                         "sparsifies)")
    return raster_scan.suggest_scan_config(
        grid_n, width, height, quality=quality, patch=patch,
        edge_cull_threshold=edge_cull_threshold,
        **({} if colfix == "auto" else {"colfix": colfix}))


def tiled_config(mvps, vertex_grid, uv_grid, width, height,
                 binning_quantile: float = 0.995,
                 edge_cull_threshold: Optional[float] = None) -> RasterConfig:
    """The tiled routes' config for a clip: ``measured_config`` over three
    sampled MVPs, with a warning when the quantile-sized window drops
    candidates at those views (GL never drops a triangle)."""
    sample = mvps[np.linspace(0, len(mvps) - 1,
                              min(3, len(mvps))).astype(int)]
    cfg = raster_grid.measured_config(
        sample, vertex_grid, width, height, quantile=binning_quantile,
        edge_cull_threshold=edge_cull_threshold)
    overflow = int(raster_grid.binning_overflow_tiles(
        sample, vertex_grid, uv_grid, width, height, cfg).max())
    if overflow:
        log(f"WARNING: {overflow} tile(s) exceed the candidate window at the "
            f"sampled views (binning_quantile={binning_quantile}); triangles "
            f"near strong depth edges may be dropped there. Re-run with "
            f"--binning-quantile 1.0 for lossless binning.")
    return cfg


@profiling.spanned("render.clip", root=True)
def render_clip(mesh: Mesh, projection, view_batch, width, height,
                config=None, mode: str = "texture",
                frame_batch: int = raster_scan.FRAME_GROUP,
                on_frames: Optional[Callable[[int, np.ndarray], None]] = None,
                colfix="auto", device="cuda", impl: str = "auto",
                binning_quantile: float = 0.995,
                edge_cull_threshold: Optional[float] = None,
                quality: bool = False, patch: bool = False):
    """Render a clip of a grid mesh.

    :param mesh: a grid :class:`Mesh` (its tensors move to ``device``).
    :param projection: (4, 4) projection matrix.
    :param view_batch: (T, 4, 4) per-frame view matrices.
    :param config: a :class:`ScanConfig` (scan) or :class:`RasterConfig`
        (tiled routes); by default ``suggest_scan_config``, or the tiled
        routes' measured config (:func:`tiled_config`).
    :param frame_batch: frames per group (one host copy; the tiled routes
        clamp their kernel groups further by ``tiled.COEFF_BUDGET``).
    :param on_frames: ``(start_index, frames)`` per group, frames (k, H, W, 4)
        uint8; called for group k while group k+1 renders.
    :param colfix: the scan's colfix fan half-width: ``"auto"`` (1, or 3
        under ``quality``), ``None`` (off) or 0-3.
    :param device: ``"cuda"`` (kernels) or ``"cpu"`` (plain passes).
    :param impl: ``"auto"`` (= the scan), ``"scan"``, ``"pallas"`` or
        ``"grid"``. Past the scan's budget (d13 and up) ``"auto"`` and
        ``"scan"`` log a NOTICE and render through ``"pallas"``, as the
        reference does (a ``ScanConfig`` given as ``config`` is dropped).
    :param binning_quantile: the tiled routes' window quantile (1.0 =
        lossless binning).
    :param edge_cull_threshold: the depth-discontinuity edge cull: cells or
        triangles whose corner model-z spread exceeds it are dropped (the
        scan culls in its march kernel).
    :param quality: the scan's quality tier: dual-column records and a
        full transposed second pass, merged by depth.
    :param patch: the scan's patch tier: a transposed second pass only where
        the first left holes (with ``colfix=3`` the balanced tier).
    :return: the frame count, or the stacked (T, H, W, 4) uint8 frames when
        ``on_frames`` is None.

    Spans (:mod:`.profiling`): ``render.clip`` (a request's root unless it
    runs inside one), and under it ``render.upload`` (the grid, UVs,
    texture and MVPs to the device), ``render.dispatch`` (each group's
    kernels and readback queued; on the CPU its whole render),
    ``render.wait`` (each group's event waited for) and ``render.deliver``
    (unpack and ``on_frames``); the counter ``render.frames`` counts the
    frames delivered.
    """
    device = resolve_device(device)
    if not mesh.is_grid:
        raise ValueError("render_clip requires a grid mesh (MeshRenderer "
                         "renders any mesh)")
    _pin_matmul_precision()
    vgrid, uvgrid, n = _grid_arrays(mesh)
    if impl in ("auto", "scan"):
        impl = _auto_impl(n, width, height)
        if impl != "scan":
            # As the reference does past d12: the tiled route on the same
            # device, with its own measured config.
            log(f"NOTICE: grid n={n} exceeds the scan kernel's VMEM window "
                f"budget; falling back to the tiled path for this clip.")
            if isinstance(config, raster_scan.ScanConfig):
                config = None
    elif impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
    if impl == "scan":
        # Checked once, before the upload: the check reads the grid's
        # corners, which on the card would wait for every group queued.
        raster_scan.check_uv_grid(uvgrid)
    with profiling.span("render.upload"):
        vgrid = vgrid.to(device)
        uvgrid = uvgrid.to(device)
        texture = mesh.texture.image.to(device)
        mvps = clip_mvps(projection, view_batch, mesh.transform)
        if impl != "scan":
            # One copy of the MVPs to the device before any work is queued
            # (a later pageable copy would wait for the stream).
            mvps = mvps.to(device)
    total = int(mvps.shape[0])
    cuda = device.type == "cuda"

    if impl == "scan":
        if config is None:
            config = clip_scan_config(n, width, height, colfix, quality,
                                      patch, edge_cull_threshold)
        raster_scan.check_supported(config)
        g = raster_scan.ScanGeometry.of(width, height, n, n, config)
        host_shape = (g.hpad, g.wl)
        host_dtype = torch.int32
        overflow = torch.zeros((), dtype=torch.int64, device=device)

        def render(mvps_g):
            nonlocal overflow
            dev, ovf = raster_scan.render_frames_scan(
                mvps_g, vgrid, None, texture, width, height, config, mode,
                frame_batch=frame_batch)
            overflow = torch.maximum(overflow, ovf)
            return dev

        def unpack(host):
            return raster_scan.unpack_raw_frames(host, width, height)
    else:
        if config is None:
            config = tiled_config(mvps, vgrid, uvgrid, width, height,
                                  binning_quantile, edge_cull_threshold)
        frames_fn = (raster_pallas.render_frames_pallas if impl == "pallas"
                     else raster_grid.render_frames_grid)
        host_shape = (height, width, 4)
        host_dtype = torch.uint8

        def render(mvps_g):
            return frames_fn(mvps_g, vgrid, uvgrid, texture, width, height,
                             config, mode, frame_batch=frame_batch)

        def unpack(host):
            return host.numpy()

    collected = []

    def deliver(start, host):
        with profiling.span("render.deliver"):
            frames = unpack(host)
            if on_frames is None:
                collected.append(frames.copy())
            else:
                on_frames(start, frames)
        profiling.count("render.frames", len(frames))

    def wait_and_deliver(start, host, event):
        with profiling.span("render.wait"):
            event.synchronize()
        deliver(start, host)

    # Two pinned host buffers: group k's copy lands in one while the host
    # reads group k-1 out of the other.
    hosts = ([torch.empty((frame_batch,) + host_shape, dtype=host_dtype,
                          pin_memory=True) for _ in range(2)] if cuda else [])
    pending = []  # (start, host tensor, event)
    for i, start in enumerate(range(0, total, frame_batch)):
        stop = min(start + frame_batch, total)
        with profiling.span("render.dispatch"):
            dev = render(mvps[start:stop])
            if cuda:
                host = hosts[i % 2][:stop - start]
                host.copy_(dev, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
                pending.append((start, host, event))
        if not cuda:
            deliver(start, dev)
        elif len(pending) > 1:
            wait_and_deliver(*pending.pop(0))
    for group in pending:
        wait_and_deliver(*group)
    if impl == "scan":
        raster_scan.warn_overflow(overflow, config)
    if on_frames is None:
        return np.concatenate(collected, axis=0)
    return total


class MeshRenderer:
    """Headless per-frame renderer with the reference's callback-driven
    loop.

    :param camera: the :class:`Camera` (its ``window_size`` is the default
        framebuffer size).
    :param width, height: framebuffer size override.
    :param fps: target frame rate; with ``fixed_time_step`` (default)
        ``on_update`` always receives ``1 / fps``, the reference's
        deterministic-output mode (``render.py:750-755``).
    :param unlimited_frame_works: True: frames as fast as they render
        (reference ``render.py:593``); False: the loop sleeps to pace real
        time.
    :param config: a :class:`RasterConfig` (tiled routes) or
        ``raster_scan.ScanConfig`` (scan); None: derived per mesh
        (``suggest_scan_config`` for the scan, ``suggest_config`` for the
        tiled routes) and again on every mesh swap.
    :param mode: ``texture``, ``debug_z`` or ``wireframe`` (the reference's
        1/2/3 keys, ``render.py:845-859``).
    :param impl: ``auto``, ``scan``, ``pallas``, ``grid`` or ``soup``. On a
        grid mesh ``auto`` picks the scan through d12 and the tiled Pallas
        route past it (:func:`_auto_impl`); a mesh that is not a grid
        always renders through the soup.
    :param device: ``"cuda"`` (default; raises without a card) or
        ``"cpu"``.
    """

    def __init__(self, camera: Optional[Camera] = None, width=None,
                 height=None, fps: float = 60, fixed_time_step: bool = True,
                 unlimited_frame_works: bool = True, config=None,
                 mode: str = "texture",
                 window_name: str = "depthrenderer_tpu_torch",
                 impl: str = "auto", device="cuda"):
        if impl not in ("auto", "soup") + IMPLS:
            raise ValueError(f"unknown impl {impl!r}")
        self.device = resolve_device(device)
        _pin_matmul_precision()
        self.camera = camera if camera is not None else Camera((512, 512))
        self.window_name = window_name
        self.width = int(width if width is not None
                         else self.camera.window_width)
        self.height = int(height if height is not None
                          else self.camera.window_height)
        self.fps = float(fps)
        self.target_frame_time_secs = 1.0 / self.fps
        self.fixed_time_step = fixed_time_step
        self.unlimited_frame_works = unlimited_frame_works
        self.config = config
        self._config_auto = config is None
        self.mode = mode
        self._impl_requested = impl
        self.impl = "scan" if impl == "auto" else impl

        self.frame_timer = FrameTimer()
        self.is_paused = False
        self.is_running = True
        self._should_close = False
        self._mesh: Optional[Mesh] = None
        self._frame: Optional[np.ndarray] = None
        self.frame_count = 0

        self.on_update: Optional[Callable[[float], None]] = None
        self.on_exit: Optional[Callable[[], None]] = None

    # -- scene wiring -------------------------------------------------------

    @property
    def mesh(self):
        return self._mesh

    @mesh.setter
    def mesh(self, mesh: Mesh):
        dev = self.device
        self._mesh = mesh
        self._texture = mesh.texture.image.to(dev)
        self._vertices = mesh.vertices.to(dev)
        self._uvs = mesh.texture_coordinates.to(dev)
        self._indices = mesh.indices.to(dev)
        if not mesh.is_grid:
            if self._impl_requested == "auto":
                self.impl = "soup"
            return
        vgrid, uvgrid, n = _grid_arrays(mesh)
        self._vgrid, self._uvgrid = vgrid.to(dev), uvgrid.to(dev)
        if self._impl_requested == "auto":
            self.impl = _auto_impl(n, self.width, self.height)
        # A second, denser mesh must not inherit the previous mesh's
        # config unless the caller pinned one.
        if self._config_auto:
            self.config = (
                raster_scan.suggest_scan_config(n, self.width, self.height)
                if self.impl == "scan"
                else suggest_config(n, self.width, self.height))

    @property
    def frame_buffer_shape(self):
        """(width, height) of the framebuffer (reference
        ``render.py:727-732``)."""
        return self.width, self.height

    # -- frame production ---------------------------------------------------

    def draw(self):
        """Render one frame of the current camera and mesh, through the
        function :func:`render_clip` calls for the same route."""
        if not self.is_running or self._mesh is None:
            return
        w, h, mode = self.width, self.height, self.mode
        mvps = clip_mvps(self.camera.projection, self.camera.view[None],
                         self._mesh.transform)
        if not self._mesh.is_grid or self.impl == "soup":
            frame = raster_soup.rasterize_soup(
                self._vertices, self._uvs, self._indices, mvps[0],
                self._texture, w, h, mode)
        elif self.impl == "scan":
            raw, _ = raster_scan.render_frames_scan(
                mvps, self._vgrid, self._uvgrid, self._texture, w, h,
                self.config, mode, frame_batch=1)
            frame = torch.from_numpy(raster_scan.unpack_raw_frames(
                raw, w, h)[0])
        else:
            frames_fn = (raster_pallas.render_frames_pallas
                         if self.impl == "pallas"
                         else raster_grid.render_frames_grid)
            frame = frames_fn(mvps.to(self.device), self._vgrid,
                              self._uvgrid, self._texture, w, h, self.config,
                              mode, frame_batch=1)[0]
        self._frame = frame.cpu().numpy()
        self.frame_count += 1

    def get_frame(self):
        """The frame just drawn, (H, W, 4) uint8 numpy, top-down; None
        before the first draw."""
        return self._frame

    # -- loop control -------------------------------------------------------

    def run(self, max_frames: Optional[int] = None):
        """Run the frame loop until :meth:`close` (or ``max_frames``).

        As the reference's loop (``render.py:734-764``): draw, then
        ``on_update(delta)`` unless paused, at the target frame rate unless
        ``unlimited_frame_works``. Each draw reads its frame back before
        the next starts: batched clips belong to :func:`render_clip`.
        """
        log("MeshRenderer.run(): per-frame dispatch loop (API-parity path); "
            "use render_clip() for batched-throughput rendering.")
        try:
            self.frame_timer.reset()
            while not self._should_close:
                self.frame_timer.update()
                if (self.unlimited_frame_works
                        or self.frame_timer.elapsed
                        > self.target_frame_time_secs):
                    self.draw()
                    if self.on_update is not None and not self.is_paused:
                        if self.unlimited_frame_works or self.fixed_time_step:
                            delta = self.target_frame_time_secs
                        else:
                            delta = self.frame_timer.elapsed
                        self.on_update(delta)
                    self.frame_timer.elapsed = 0.0
                    if (max_frames is not None
                            and self.frame_count >= max_frames):
                        break
                elif not self.unlimited_frame_works:
                    time.sleep(max(0.0, self.target_frame_time_secs
                                   - self.frame_timer.elapsed))
            if self.on_exit:
                self.on_exit()
        finally:
            self.is_running = False

    def close(self):
        """Ask the loop to exit (reference ``render.py:827-828``)."""
        self._should_close = True

    def cleanup(self):   # API parity; nothing to free.
        pass

    # -- runtime controls (the reference's key bindings as methods) ---------

    def pause(self, value: Optional[bool] = None):
        self.is_paused = (not self.is_paused) if value is None else bool(value)

    def use_default_shader(self):
        self.mode = "texture"

    def use_debug_shader(self):
        self.mode = "debug_z"

    def toggle_wireframe(self):
        """Toggle wireframe rendering (the reference's key-3 GL_LINE toggle,
        ``render.py:853-859``, whose logic was inverted; this one is not).
        Every route shades it, so the toggle never changes the route."""
        if self.mode == "wireframe":
            self.mode = self._pre_wireframe_mode
        else:
            self._pre_wireframe_mode = self.mode
            self.mode = "wireframe"
