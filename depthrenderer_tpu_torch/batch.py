"""Batch farm: one colour image against many depth-model outputs.

Counterpart of ``depthrenderer_tpu/batch.py`` (reference
``render_many.py:150-382``): every subdirectory of ``depth_maps_path`` holds
a depth map named like the colour image; each model gets its own animated
video (one sway loop) and a PNG snapshot a second, and afterwards mosaic,
concatenated and ground-truth-paired comparison videos are made
(:mod:`.postprocess`). A per-image manifest makes interrupted runs
resumable.

Two paths. The sequential one renders model after model through
:func:`.render.render_clip`. ``--sharded`` renders every model at once over
every device (:func:`.parallel.render_scenes_sharded`, one contiguous block
of models a device) in chunks of ``--frame-batch`` views: chunk i+1 is
dispatched before chunk i is read back, so its readback and encode overlap
the next chunk's render; frames come back through pinned host buffers by
non-blocking copies and a CUDA event. With ``--readback yuv420`` (the
``auto`` choice for MJPG on ``cuda``) each frame is packed to YUV 4:2:0 on
its device (:func:`.io.rgba_to_yuv420`, 1.5 bytes a pixel instead of 4),
and the encoder takes the planes; the PNG snapshots still read full RGBA,
only for the frames that are due. Both paths render each model with the
same per-model config, so for the scan their AVIs are byte-identical.

Spans and counters (:mod:`.profiling`): ``batch.farm`` (a job's root: the
encoder threads' ``writer.*`` spans carry its request id), and on the
sharded path ``batch.dispatch`` (each chunk's render, pack and copies
queued) and ``batch.snapshot_read`` (a due snapshot's RGBA read back on
the YUV path); the counter ``batch.frames`` counts the model-frames handed
to the writers.

Usage::

    python -m depthrenderer_tpu_torch.batch <colour image> <depth-maps dir> \\
        -fps 60 -mesh-density 8 -displacement-factor 4.0 -output-path output
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from . import animation as anim_mod
from . import io as dio
from . import postprocess, profiling, transforms
from .ops import raster_grid, raster_scan
from .parallel import default_devices, device_blocks, render_scenes_sharded
from .render import (_auto_impl, _grid_arrays, clip_mvps, clip_scan_config,
                     render_clip, resolve_device)
from .scene import Camera, Mesh, Texture
from .tasks import RecurringTask
from .utils import log
from .writers import AsyncImageWriter, AsyncVideoWriter


def _parse_colfix(v: str):
    """CLI --colfix value -> render_clip's ``colfix``."""
    return v if v == "auto" else None if v == "none" else int(v)


def build_parser(prog="python -m depthrenderer_tpu_torch.batch"):
    p = argparse.ArgumentParser(
        prog=prog,
        description="Render one colour image against many depth-model "
        "outputs and produce per-model and comparison videos.")
    p.add_argument("image_path", type=Path,
                   help="The path to the colour image.")
    p.add_argument("depth_maps_path", type=Path,
                   help="Folder of per-model subfolders, each holding a depth "
                        "map with the colour image's file name.")
    for names, kwargs in [
        (("-fps", "--fps"), dict(type=float, default=60.0)),
        (("-mesh-density", "--mesh-density"),
         dict(type=int, default=8, dest="mesh_density")),
        (("-displacement-factor", "--displacement-factor"),
         dict(type=float, default=4.0, dest="displacement_factor")),
        (("-output-path", "--output-path"),
         dict(type=Path, default=Path("output"), dest="output_path")),
    ]:
        p.add_argument(*names, **kwargs)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--frames", type=int, default=None,
                   help="Frames per model (default: one animation loop).")
    p.add_argument("--fov-y", type=float, default=18.0, dest="fov_y")
    p.add_argument("--codec", choices=("MJPG", "DIB "), default="MJPG")
    p.add_argument("--frame-batch", type=int, default=raster_scan.FRAME_GROUP,
                   dest="frame_batch",
                   help="Views rendered per group or chunk (default "
                        f"{raster_scan.FRAME_GROUP}).")
    p.add_argument("--binning-quantile", type=float, default=0.995,
                   dest="binning_quantile",
                   help="The tiled routes' candidate-window quantile (1.0 = "
                        "lossless).")
    p.add_argument("--edge-cull", type=float, default=None, dest="edge_cull")
    p.add_argument("--png-every-seconds", type=float, default=1.0,
                   dest="png_every_seconds",
                   help="PNG snapshot interval in seconds (reference: 1/s).")
    p.add_argument("--resume", action="store_true",
                   help="Skip models already recorded in the output manifest.")
    p.add_argument("--no-post", action="store_true",
                   help="Skip the mosaic, concat and paired videos.")
    p.add_argument("--container", choices=("avi", "mp4"), default="avi",
                   help="Video container: avi, or mp4 (H.264 with ffmpeg, "
                        "else the AVI's JPEG payloads remuxed).")
    p.add_argument("--impl", choices=("auto", "grid", "pallas", "scan"),
                   default="auto",
                   help="Rasteriser: auto = the scan (the tiled Pallas "
                        "route past its budget); both paths.")
    p.add_argument("--quality", action="store_true",
                   help="The scan's quality tier (both paths; raises when "
                        "the resolved impl is not the scan).")
    p.add_argument("--patch", action="store_true",
                   help="The scan's patch tier (both paths; raises when the "
                        "resolved impl is not the scan). Exclusive with "
                        "--quality.")
    p.add_argument("--colfix", default="auto",
                   choices=("auto", "none", "0", "1", "2", "3"),
                   help="The scan's column-fan hole fill half-width (auto = "
                        "1, or 3 under --quality; none = off).")
    p.add_argument("--sharded", action="store_true",
                   help="Render every model at once, each device owning a "
                        "contiguous block of them, instead of one after "
                        "another.")
    p.add_argument("--readback", choices=("auto", "rgba", "yuv420"),
                   default="auto",
                   help="--sharded frame readback: yuv420 packs frames to "
                        "planar YUV 4:2:0 on the device (1.5 B/px instead of "
                        "4) and the MJPEG encoder takes the planes; PNG "
                        "snapshots still read back full RGBA. auto = yuv420 "
                        "for MJPG on cuda with an even frame size, else rgba.")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda (the kernels, every card with --sharded; "
                        "default) or cpu (the plain PyTorch passes).")
    return p


def discover_models(depth_maps_path, image_filename):
    """Sorted ``(model name, depth path)`` of the subdirectories holding the
    expected depth map."""
    models = []
    for entry in sorted(os.listdir(depth_maps_path)):
        full = os.path.join(depth_maps_path, entry)
        if os.path.isdir(full):
            depth = os.path.join(full, image_filename)
            if os.path.exists(depth):
                models.append((entry, depth))
            else:
                log(f"Skipping model '{entry}': no depth map {depth}")
    return models


def _resolve_impl(args, n, width, height):
    """The rasteriser for the farm; the fidelity knobs need the scan (a knob
    silently ignored would ship fast frames labelled as quality ones)."""
    impl = _auto_impl(n, width, height) if args.impl == "auto" else args.impl
    if args.quality and args.patch:
        raise SystemExit("--quality and --patch are mutually exclusive")
    if args.quality or args.patch or args.colfix != "auto":
        knob = ("--quality" if args.quality
                else "--patch" if args.patch else "--colfix")
        if impl != "scan":
            raise SystemExit(
                f"{knob} requires the scan rasteriser (resolved impl is "
                f"'{impl}'): pass --impl scan, or drop {knob}.")
    return impl


def _readback_yuv(args, device, width, height) -> bool:
    even = width % 2 == 0 and height % 2 == 0
    if args.readback == "auto":
        return args.codec == "MJPG" and device.type == "cuda" and even
    if args.readback == "yuv420" and args.codec != "MJPG":
        raise SystemExit("--readback yuv420 requires the MJPG codec")
    return args.readback == "yuv420"


def _model_mesh(base_mesh, texture, depth, args):
    """A model's grid mesh: the first from the texture, the rest re-skinned
    from it with the new depth (reference ``render.py:547-565``)."""
    if base_mesh is None:
        mesh = Mesh.from_texture(texture, depth, density=args.mesh_density)
    else:
        mesh = Mesh.from_copy_with_new_depth(base_mesh, depth)
    mesh.vertices[:, 2] = mesh.vertices[:, 2] * args.displacement_factor
    return mesh


def farm_views(fps: float, num_frames=None):
    """The reference's batch camera path (render_many.py:318-330): the
    CLI's sway at a 2.5 degree bounce, one loop every 1 / 0.2 seconds ->
    (T, 4, 4) views; ``num_frames`` None is one loop."""
    rotation_angle = 2.5
    loops_per_second = 0.5 / rotation_angle
    sway = anim_mod.default_sway(1.0 / loops_per_second)
    if num_frames is None:
        num_frames = int(fps / loops_per_second)  # one loop
    times = anim_mod.frame_times(num_frames, fps)
    return transforms.matmul(transforms.translation(dz=-10.0)[None],
                             sway.batch(times))


@profiling.spanned("batch.farm", root=True)
def run_farm(args) -> dict:
    """The farm for parsed arguments (:func:`build_parser`) -> ``{"models",
    "videos", "frames": frames rendered, "seconds": render and encode}``."""
    device = resolve_device(args.device)
    image_filename = Path(args.image_path).name
    image_name = Path(args.image_path).stem
    models = discover_models(args.depth_maps_path, image_filename)
    if not models:
        raise SystemExit(f"No model subdirectories with '{image_filename}' "
                         f"found under {args.depth_maps_path}.")
    video_output_path = os.path.join(args.output_path, "single_videos",
                                     image_name)
    os.makedirs(video_output_path, exist_ok=True)
    manifest_path = os.path.join(args.output_path,
                                 f"{image_name}.manifest.json")
    manifest = {}
    if args.resume and os.path.exists(manifest_path):
        with open(manifest_path) as f:
            manifest = json.load(f)

    colour = dio.load_colour(args.image_path)
    height, width = colour.shape[:2]
    out_w = args.width or width
    out_h = args.height or height
    n = 2 ** args.mesh_density + 1
    impl = _resolve_impl(args, n, out_w, out_h)

    texture = Texture(colour)
    camera = Camera(window_size=(width, height), fov_y=args.fov_y)
    views = farm_views(args.fps, args.frames)
    num_frames = len(views)
    png_every = max(1, int(round(args.png_every_seconds * args.fps)))

    def video_path(model_name):
        return os.path.join(video_output_path,
                            f"{model_name}.{args.container}")

    def done(model_name):
        return (args.resume
                and manifest.get(model_name, {}).get("frames") == num_frames
                and os.path.exists(video_path(model_name)))

    def png_task(model_name, image_writer):
        frames_dir = os.path.join(args.output_path, "frames", model_name)
        os.makedirs(frames_dir, exist_ok=True)
        # ``frame`` may be a zero-argument callable (the YUV readback hands
        # a lazy device slice, so only the due frames read RGBA back).
        return RecurringTask(
            lambda frame, idx: image_writer.write(
                frame() if callable(frame) else frame,
                os.path.join(frames_dir, f"{idx:06d}.png")),
            frequency=png_every)

    def finish(model_name):
        manifest[model_name] = {"frames": num_frames,
                                "video": video_path(model_name)}
        with open(manifest_path, "w") as f:
            json.dump(manifest, f, indent=2)

    image_writer = AsyncImageWriter()
    names = [m for m, _ in models]
    todo, base_mesh, meshes = [], None, []
    for model_name, depth_path in models:
        if done(model_name):
            log(f"[{model_name}] already complete, skipping (resume).")
            continue
        depth = dio.resize(dio.load_depth(depth_path), colour.shape)
        mesh = _model_mesh(base_mesh, texture, depth, args)
        if base_mesh is None:
            base_mesh = mesh
        todo.append(model_name)
        meshes.append(mesh)

    t0 = time.perf_counter()
    try:
        if args.sharded and todo:
            _render_sharded(args, todo, meshes, camera, views, impl, out_w,
                            out_h, device, video_path, png_task, image_writer)
            for model_name in todo:
                finish(model_name)
        else:
            for model_name, mesh in zip(todo, meshes):
                _render_sequential(args, model_name, mesh, camera, views,
                                   out_w, out_h, device,
                                   video_path(model_name),
                                   png_task(model_name, image_writer))
                finish(model_name)
    finally:
        image_writer.cleanup()
    dt = time.perf_counter() - t0
    total = len(todo) * num_frames
    log(f"Rendered {total} frames ({len(todo)} models x {num_frames}) in "
        f"{dt:.2f}s ({total / max(dt, 1e-9):.1f} frames/s aggregate, "
        f"encode included).")
    videos = [video_path(m) for m in names]
    _postprocess(args, videos, names, image_name, out_w, out_h)
    log("Batch rendering complete.")
    return {"models": names, "videos": videos, "frames": total,
            "seconds": dt}


def _render_sequential(args, model_name, mesh, camera, views, out_w, out_h,
                       device, video_path, png_task):
    """One model through ``render_clip`` into its video and snapshots (with
    ``--impl auto`` past the scan's budget it logs the NOTICE)."""
    video_writer = AsyncVideoWriter(video_path, size=(out_w, out_h),
                                    fps=args.fps, codec=args.codec)

    def on_frames(start, frames):
        for k in range(frames.shape[0]):
            video_writer.write(frames[k])
            png_task(frames[k], start + k)
        profiling.count("batch.frames", frames.shape[0])

    log(f"[{model_name}] rendering {len(views)} frames at {out_w}x{out_h}...")
    t0 = time.perf_counter()
    try:
        render_clip(mesh, camera.projection, views, out_w, out_h,
                    frame_batch=args.frame_batch, on_frames=on_frames,
                    colfix=_parse_colfix(args.colfix), device=device,
                    impl=args.impl, binning_quantile=args.binning_quantile,
                    edge_cull_threshold=args.edge_cull,
                    quality=args.quality, patch=args.patch)
    finally:
        video_writer.cleanup()
    dt = time.perf_counter() - t0
    log(f"[{model_name}] {len(views)} frames in {dt:.2f}s "
        f"({len(views) / dt:.1f} frames/s).")


def _postprocess(args, video_sources, model_names, image_name, out_w, out_h):
    if args.no_post:
        return
    postprocess.create_mosaic_video(video_sources,
                                    os.path.join(args.output_path, "mosaic"),
                                    image_name, (out_h, out_w), fps=args.fps)
    postprocess.create_concat_video(video_sources,
                                    os.path.join(args.output_path, "concat"),
                                    image_name)
    if "ground_truth" in model_names:
        postprocess.create_paired_videos(
            video_sources, os.path.join(args.output_path, "paired"),
            image_name, model_names)
    else:
        log("No 'ground_truth' model; skipping paired videos.")


def _tiled_shared_config(args, meshes, mvps, out_w, out_h):
    """The tiled routes' config shared by every model: each model's measured
    window over three sampled views, the largest span taken (a model with
    stronger relief than the first would otherwise drop triangles), with a
    warning where the shared window drops candidates."""
    sample = mvps[np.linspace(0, len(mvps) - 1,
                              min(3, len(mvps))).astype(int)]
    grids = [_grid_arrays(m)[:2] for m in meshes]
    per_scene = [raster_grid.measured_config(
        sample, vg, out_w, out_h, quantile=args.binning_quantile,
        edge_cull_threshold=args.edge_cull) for vg, _ in grids]
    config = dataclasses.replace(
        per_scene[0], window_rows=max(c.window_rows for c in per_scene),
        window_cols=max(c.window_cols for c in per_scene))
    overflow = max(int(raster_grid.binning_overflow_tiles(
        sample, vg, uv, out_w, out_h, config).max()) for vg, uv in grids)
    if overflow:
        log(f"WARNING: {overflow} tile(s) exceed the shared candidate window "
            f"at the sampled views (binning_quantile={args.binning_quantile})"
            f"; triangles near strong depth edges may be dropped there. "
            f"Re-run with --binning-quantile 1.0 for lossless binning.")
    return config


def _render_sharded(args, model_names, meshes, camera, views, impl, out_w,
                    out_h, device, video_path, png_task, image_writer):
    """Every model at once over every device, in chunks of views; chunk i+1
    is dispatched before chunk i is read back and encoded."""
    devices = default_devices() if device.type == "cuda" else [device]
    cuda = device.type == "cuda"
    S = len(meshes)
    n = 2 ** args.mesh_density + 1
    mvps = clip_mvps(camera.projection, views, meshes[0].transform)
    yuv = _readback_yuv(args, device, out_w, out_h)
    scan_config, config = None, None
    if impl == "scan":
        scan_config = clip_scan_config(n, out_w, out_h,
                                       _parse_colfix(args.colfix),
                                       args.quality, args.patch,
                                       args.edge_cull)
        raster_scan.check_supported(scan_config)
    else:
        config = _tiled_shared_config(args, meshes, mvps, out_w, out_h)
    log(f"Sharding {S} models over {len(devices)} device(s) (impl={impl}"
        f"{', quality' if args.quality else ''}, readback "
        f"{'yuv420' if yuv else 'rgba'}).")

    # Each model's grid, UVs and texture go to its device once.
    owner = [None] * S
    for dev, (s0, s1) in zip(devices, device_blocks(S, len(devices))):
        for s in range(s0, s1):
            owner[s] = dev
    grids = [_grid_arrays(m)[:2] for m in meshes]
    vgrids = [vg.to(owner[s]) for s, (vg, _) in enumerate(grids)]
    if impl == "scan":
        # Checked here once, on the host: a check of a grid on the card
        # would wait, in every chunk, for the chunks queued before it.
        for _, uv in grids:
            raster_scan.check_uv_grid(uv)
        uvgrids = None
    else:
        uvgrids = [uv.to(owner[s]) for s, (_, uv) in enumerate(grids)]
    textures = [m.texture.image.to(owner[s]) for s, m in enumerate(meshes)]
    writers = [AsyncVideoWriter(video_path(m), size=(out_w, out_h),
                                fps=args.fps, codec=args.codec)
               for m in model_names]
    tasks = [png_task(m, image_writer) for m in model_names]
    chunk = max(1, args.frame_batch)
    per_frame = (out_h * out_w * 3 // 2,) if yuv else (out_h, out_w, 4)
    # Two pinned host buffers a model: chunk i lands in one while the host
    # reads chunk i-1 out of the other (the writers copy what they take).
    hosts = [[torch.empty((chunk,) + per_frame, dtype=torch.uint8,
                          pin_memory=True) for _ in range(S)]
             for _ in range(2)] if cuda else None
    overflow = []

    def snapshot(frame):
        """A due snapshot's RGBA, read back to the host."""
        with profiling.span("batch.snapshot_read"):
            return frame.cpu().numpy()

    def consume(start, stop, dev_frames, host, events):
        for s in range(S):
            if events:
                events[s].synchronize()
            frames = host[s].numpy()
            for k in range(stop - start):
                if yuv:
                    writers[s].write_yuv420(
                        *dio.yuv420_planes(frames[k], out_h, out_w))
                    tasks[s](lambda s=s, k=k: snapshot(dev_frames[s][k]),
                             start + k)
                else:
                    writers[s].write(frames[k])
                    tasks[s](frames[k], start + k)
        profiling.count("batch.frames", S * (stop - start))

    try:
        pending = None
        for i, start in enumerate(range(0, len(mvps), chunk)):
            stop = min(start + chunk, len(mvps))
            with profiling.span("batch.dispatch"):
                dev_frames, ovf = render_scenes_sharded(
                    mvps[start:stop].expand(S, -1, -1, -1), vgrids, uvgrids,
                    textures, out_w, out_h, config, frame_batch=chunk,
                    impl=impl, scan_config=scan_config, devices=devices,
                    with_overflow=True)
                overflow += [o for o in ovf if o is not None]
                packed = [dio.rgba_to_yuv420(f) if yuv else f
                          for f in dev_frames]
                if cuda:
                    host, events = [h[:stop - start] for h in hosts[i % 2]], []
                    for s in range(S):
                        with torch.cuda.device(owner[s]):
                            host[s].copy_(packed[s], non_blocking=True)
                            events.append(torch.cuda.Event())
                            events[-1].record()
                else:
                    host, events = packed, None
            if pending is not None:
                consume(*pending)
            pending = (start, stop, dev_frames, host, events)
        if pending is not None:
            consume(*pending)
    finally:
        for w in writers:
            w.cleanup()
    if overflow:
        raster_scan.warn_overflow(max(int(o) for o in overflow), scan_config)


def main(argv=None):
    run_farm(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
