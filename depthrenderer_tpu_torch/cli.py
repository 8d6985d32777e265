"""Single-scene CLI: colour + depth pair -> animated novel-view video + sample frame.

Counterpart of ``depthrenderer_tpu/cli.py`` with the same flags, plus
``--device {cuda,cpu}``::

    python -m depthrenderer_tpu_torch <colour> <depth> -fps 60 -mesh-density 8 \\
        -displacement-factor 4.0 -output-path frames

Defaults as the reference (fps 60, density 8, displacement 4.0, fov_y 18,
camera at dz=-10, 5-second composed sway, 3 loops, sample frame at frame 10,
``<image name>.avi``). Frames render on the GPU through the scan kernels by
default, or through the tiled rasteriser's pair kernel with ``--impl pallas``
or ``--impl grid``; ``--device cpu`` runs the plain PyTorch passes. The
scan's fidelity tiers: ``--quality``, and ``--patch --colfix 3`` (balanced).
``--container mp4`` remuxes the AVI's JPEG payloads into an MP4 (H.264 when
ffmpeg is on the host); ``--overlay-noise`` overlays Perlin noise on the
depth map, one seed-0 layer a scale, as the reference's depth augmentation.
"""

from __future__ import annotations

import argparse
import os
import time
from pathlib import Path

from . import animation as anim_mod
from . import io as dio
from . import profiling, transforms
from .render import render_clip, resolve_device
from .scene import Camera, Mesh, Texture
from .utils import log, overlay_noise
from .writers import AsyncImageWriter, AsyncVideoWriter

SAMPLE_FRAME_INDEX = 10  # reference: DelayedTask(OneTimeTask(write), delay=10)


def build_parser(prog="python -m depthrenderer_tpu_torch"):
    p = argparse.ArgumentParser(
        prog=prog,
        description="Render a colour/depth image pair as an animated "
        "novel-view video with the CUDA column-crossing scan rasteriser "
        "(or the tiled rasteriser: --impl pallas|grid).")
    p.add_argument("image_path", type=Path, help="The path to the colour image.")
    p.add_argument("depth_path", type=Path,
                   help="The path to the depth map of the colour image.")
    for names, kwargs in [
        (("-fps", "--fps"), dict(type=float, default=60.0,
                                 help="Target frames per second (default 60).")),
        (("-mesh-density", "--mesh-density"),
         dict(type=int, default=8, dest="mesh_density",
              help="Grid subdivision; +1 roughly quadruples vertex count "
                   "(default 8).")),
        (("-displacement-factor", "--displacement-factor"),
         dict(type=float, default=4.0, dest="displacement_factor",
              help="Multiplier on normalised depth (default 4.0).")),
        (("-output-path", "--output-path"),
         dict(type=Path, default=Path("frames"), dest="output_path",
              help="Directory for output frames/video (default 'frames').")),
    ]:
        p.add_argument(*names, **kwargs)
    p.add_argument("--width", type=int, default=None,
                   help="Output width (default: colour image width).")
    p.add_argument("--height", type=int, default=None,
                   help="Output height (default: colour image height).")
    p.add_argument("--frames", type=int, default=None,
                   help="Total frames (default: 3 animation loops = 3*5*fps).")
    p.add_argument("--loops", type=float, default=3.0,
                   help="Animation loops when --frames is unset (default 3).")
    p.add_argument("--fov-y", type=float, default=18.0, dest="fov_y",
                   help="Vertical field of view in degrees (default 18).")
    p.add_argument("--mode", choices=("texture", "debug_z", "wireframe"),
                   default="texture",
                   help="Shading mode (debug_z = the reference's debug "
                        "shader; wireframe = the triangles' edge bands).")
    p.add_argument("--codec", choices=("MJPG", "DIB "), default="MJPG",
                   help="AVI codec: MJPG (compact) or 'DIB ' (uncompressed).")
    p.add_argument("--container", choices=("avi", "mp4"), default="avi",
                   help="Video container: avi, or mp4 (H.264 with "
                        "ffmpeg, else the AVI's JPEG payloads remuxed).")
    p.add_argument("--frame-batch", type=int, default=16, dest="frame_batch",
                   help="Frames rendered per group (default 16).")
    p.add_argument("--binning-quantile", type=float, default=0.995,
                   dest="binning_quantile",
                   help="Candidate-window sizing quantile of the tiled "
                        "routes: 1.0 = lossless binning (slower), lower = "
                        "faster with possible speckles at depth edges "
                        "(default 0.995); the scan does not use it.")
    p.add_argument("--edge-cull", type=float, default=None, dest="edge_cull",
                   help="Cull triangles whose model-z spread exceeds this "
                        "(every route; BASELINE preset 4 uses 0.25).")
    p.add_argument("--impl", choices=("auto", "grid", "pallas", "scan"),
                   default="auto",
                   help="Rasteriser: auto = scan (past its budget, d13 "
                        "and up, auto and scan fall back to pallas with a "
                        "NOTICE, as the reference does); pallas = the tiled "
                        "route (pair kernel); grid = the tiled route in the "
                        "grid path's triangle order.")
    p.add_argument("--quality", action="store_true",
                   help="The scan's quality tier: dual-column records, "
                        "colfix 3 and a full second pass over the "
                        "transposed problem, merged by depth; the slowest "
                        "and most faithful scan. Exclusive with --patch.")
    p.add_argument("--patch", action="store_true",
                   help="The scan's patch tier: the transposed second pass "
                        "runs only on the bands and blocks where the first "
                        "left coverage holes. With '--colfix 3' this is the "
                        "balanced tier between the default and --quality.")
    p.add_argument("--colfix", default="auto",
                   choices=("auto", "none", "0", "1", "2", "3"),
                   help="The scan's column-fan hole fill: its half-width "
                        "0-3 (at 2 and 3 the +-1 fan runs first and the "
                        "wider cells only where holes remain), none to turn "
                        "it off; auto = 1, or 3 under --quality.")
    p.add_argument("--no-video", action="store_true",
                   help="Skip video output (write only the sample frame).")
    p.add_argument("--png-every", type=int, default=None, dest="png_every",
                   help="Also dump every Nth frame as PNG.")
    p.add_argument("--overlay-noise", type=int, nargs="+", default=None,
                   dest="overlay_noise", metavar="SCALE",
                   help="Overlay Perlin noise on the depth map at the "
                        "given scales (the reference's depth augmentation, "
                        "e.g. --overlay-noise 32 16 8).")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda (the kernels; default) or cpu (the plain "
                        "PyTorch passes).")
    return p


def noised_depth(depth, scales):
    """The depth map with one seed-0 Perlin layer a scale overlaid, in
    order (reference ``__main__.py:88``)."""
    d = depth[..., None]
    for scale in scales:
        d = overlay_noise(d, scale=scale, seed=0)
    return d[..., 0]


@profiling.spanned("cli.render_scene", root=True)
def render_scene(colour, depth, args):
    """Everything after the image loads: mesh, camera, sway, render, encode.

    :param colour: (H, W, 4) uint8 colour image.
    :param depth: (H, W) uint8 depth map at the colour image's size (with
        ``--overlay-noise`` the noise is overlaid here).
    :param args: the parsed CLI namespace (:func:`build_parser`).
    :return: dict with ``frames``, ``seconds`` (render and encode) and the
        output ``video`` / ``sample`` paths.

    The call is the span ``cli.render_scene``, a request's root
    (:mod:`.profiling`).
    """
    device = resolve_device(args.device)
    if args.overlay_noise:
        depth = noised_depth(depth, args.overlay_noise)
    height, width = colour.shape[:2]
    out_w = args.width or width
    out_h = args.height or height
    texture = Texture(colour)
    mesh = Mesh.from_texture(texture, depth_map=depth,
                             density=args.mesh_density, debug=True)
    mesh.vertices[:, 2] *= args.displacement_factor

    camera = Camera(window_size=(width, height), fov_y=args.fov_y)
    camera_position = transforms.translation(dz=-10.0)
    log(f"Projection:\n{camera.projection}")
    os.makedirs(args.output_path, exist_ok=True)

    animation_length_secs = 5.0
    sway = anim_mod.default_sway(animation_length_secs)
    num_frames = args.frames
    if num_frames is None:
        num_frames = int(args.loops * animation_length_secs * args.fps)
    times = anim_mod.frame_times(num_frames, args.fps)
    views = transforms.matmul(camera_position[None], sway.batch(times))

    image_writer = AsyncImageWriter(num_workers=1)
    video_writer = None
    video_path = None
    if not args.no_video:
        video_path = os.path.join(
            args.output_path,
            f"{Path(args.image_path).name}.{args.container}")
        video_writer = AsyncVideoWriter(video_path, size=(out_w, out_h),
                                        fps=args.fps, codec=args.codec)
    sample_path = os.path.join(args.output_path, "sample_frame.png")
    wrote_sample = False

    def on_frames(start, frames):
        nonlocal wrote_sample
        for k in range(frames.shape[0]):
            idx = start + k
            if video_writer is not None:
                video_writer.write(frames[k])
            if not wrote_sample and idx >= min(SAMPLE_FRAME_INDEX,
                                               num_frames - 1):
                image_writer.write(frames[k], sample_path)
                wrote_sample = True
            if args.png_every and idx % args.png_every == 0:
                image_writer.write(
                    frames[k], os.path.join(args.output_path, f"{idx:06d}.png"))

    log(f"Rendering {num_frames} frames at {out_w}x{out_h} on {device} "
        f"(mesh density {args.mesh_density}, {mesh.num_triangles:,d} "
        f"triangles)...")
    colfix = ({"auto": "auto", "none": None}[args.colfix]
              if args.colfix in ("auto", "none") else int(args.colfix))
    t0 = time.perf_counter()
    try:
        render_clip(mesh, camera.projection, views, out_w, out_h,
                    mode=args.mode, frame_batch=args.frame_batch,
                    on_frames=on_frames, colfix=colfix, device=device,
                    impl=args.impl, binning_quantile=args.binning_quantile,
                    edge_cull_threshold=args.edge_cull,
                    quality=args.quality, patch=args.patch)
    finally:
        if video_writer is not None:
            video_writer.cleanup()
            video_path = video_writer.path
        image_writer.cleanup()
    dt = time.perf_counter() - t0
    log(f"Rendered and encoded {num_frames} frames in {dt:.2f}s "
        f"({num_frames / dt:.1f} frames/s).")
    log(f"Output written to {args.output_path}.")
    return {"frames": num_frames, "seconds": dt, "video": video_path,
            "sample": sample_path}


def main(argv=None):
    args = build_parser().parse_args(argv)
    resolve_device(args.device)
    log(f"Loading colour image {args.image_path} ...")
    colour = dio.load_colour(args.image_path)
    depth = dio.load_depth(args.depth_path)
    depth = dio.resize(depth, colour.shape)
    render_scene(colour, depth, args)
    return 0
