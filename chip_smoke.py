"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--frames N]

Phases (each prints one line; any failure exits non-zero with its traceback):

1. environment: the card (nvidia-smi), torch, CUDA and nvcc versions; builds
   the scan kernels (csrc/scan.cu, nvcc) and the native encoders
   (frameops.c) from the checkout and prints the build seconds.
2. kernels against their plain PyTorch twins, on a seeded synthetic 640x480
   colour + depth scene at mesh density 10 rendered at 1920x1080 with the
   shipped scan config, two sway frames: the records must equal the plain
   solve's, and at least 99.9% of output pixels must be byte-identical (the
   rest at most 1 LSB per channel, or a depth-tie winner flip). Each kernel
   is timed with CUDA events beside its plain twin.
3. the main path: ``cli.render_scene`` on the same arrays for one sway loop
   (300 frames at 60 fps) into an MJPG AVI and ``sample_frame.png`` in a
   temporary directory, with the kernel launch counters reset before and
   read after; prints render-only and incl.-encode frames/s.

The second-to-last line is the kernel table as JSON, the last line
``{"ok": true, "device": {...}}``. Without a CUDA device it exits 2 and
prints no result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

SOURCE = "depthrenderer_tpu_torch/csrc/scan.cu"
REPLACES = "depthrenderer_tpu/ops/raster_scan.py:815"
WIDTH, HEIGHT, DENSITY = 1920, 1080, 10


def phase(name, **fields):
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def synthetic_scene(seed=0, h=480, w=640):
    """A seeded 640x480 RGBA colour image and a smooth sinusoid depth map
    with a few steps (uint8, 255 = nearest)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    colour = np.stack([
        (xx / (w - 1)) * 255,
        (yy / (h - 1)) * 255,
        ((xx // 16 + yy // 16) % 2) * 200 + 27,
        np.full((h, w), 255.0),
    ], axis=-1)
    colour[..., :3] += rng.normal(0, 6, (h, w, 3))
    colour = np.clip(np.round(colour), 0, 255).astype(np.uint8)
    depth = 110 + 60 * np.sin(xx / w * 7 + 0.3) * np.cos(yy / h * 5)
    depth[h // 4:h // 2, w // 5:w // 2] += 70       # a raised box
    depth[(xx - 0.7 * w) ** 2 + (yy - 0.6 * h) ** 2 < (0.12 * h) ** 2] = 20
    return colour, np.clip(np.round(depth), 0, 255).astype(np.uint8)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() over reps launches (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def wall_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def frame_agreement(a, b):
    """Per-pixel max channel difference of two packed frames, the share of
    byte-identical pixels and the count of pixels off by more than 1 LSB
    (a depth-tie winner flip, or a disagreement)."""
    a8 = a.view(torch.uint8).reshape(a.shape + (4,)).int()
    b8 = b.view(torch.uint8).reshape(b.shape + (4,)).int()
    diff = (a8 - b8).abs().amax(dim=-1)
    return diff, (diff == 0).float().mean().item(), int((diff > 1).sum())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=300,
                    help="main-path frames (default: one 5 s sway loop)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2

    from depthrenderer_tpu_torch import animation, cli, native, transforms
    from depthrenderer_tpu_torch.ops import raster_scan as rs
    from depthrenderer_tpu_torch.render import clip_mvps
    from depthrenderer_tpu_torch.scene import Camera, Mesh, Texture

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda")

    # -- phase 1: environment and builds ---------------------------------
    card = nvidia_smi()
    print(card, flush=True)
    nvcc = subprocess.run([rs._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    t0 = time.perf_counter()
    rs.build_kernels(force=True)
    t_scan = time.perf_counter() - t0
    t0 = time.perf_counter()
    native.build(force=True)
    t_native = time.perf_counter() - t0
    phase("env", card=repr(card), torch=torch.__version__,
          cuda=torch.version.cuda, nvcc=repr(nvcc[-1]),
          build_scan_s=f"{t_scan:.2f}", build_frameops_s=f"{t_native:.2f}")

    # -- phase 2: each kernel against its plain twin ----------------------
    colour, depth = synthetic_scene()
    mesh = Mesh.from_texture(Texture(colour), depth_map=depth,
                             density=DENSITY)
    mesh.vertices[:, 2] *= 4.0
    n = int(round(len(mesh.vertices) ** 0.5))
    cfg = rs.suggest_scan_config(n, WIDTH, HEIGHT)
    camera = Camera(window_size=(colour.shape[1], colour.shape[0]),
                    fov_y=18.0)
    times = animation.frame_times(300, 60.0)[[0, 74]]
    views = transforms.matmul(transforms.translation(dz=-10.0)[None],
                              animation.default_sway().batch(times))
    mvps = clip_mvps(camera.projection, views, mesh.transform)
    vgrid = mesh.vertices.reshape(n, n, 3).to(dev)
    g = rs.ScanGeometry.of(WIDTH, HEIGHT, n, n, cfg)
    texq = rs.pack_texture(mesh.texture.image.to(dev))
    minv = rs.minv_rows(mvps)
    prep = rs.prep_scan(mvps.to(dev), vgrid, WIDTH, HEIGHT, cfg)
    stats = {"solve": [0.0], "march": [0.0], "shade": [0, 0]}
    counts = {"identical": 0, "off_1lsb": 0, "off_more": 0, "pixels": 0}
    for i in range(mvps.shape[0]):
        args_i = (prep.win[i], prep.w0[i], prep.bounds[i])
        rec_k = rs.solve_records(*args_i, g, cfg)
        rec_p = rs.solve_records_plain(*args_i, g, cfg)
        torch.cuda.synchronize()
        if not torch.equal(rec_k, rec_p):
            bad = int((rec_k != rec_p).sum())
            raise AssertionError(f"frame {i}: {bad} record values differ "
                                 "between the solve kernel and its twin")
        stats["solve"].append(float((rec_k - rec_p).abs().max()))
        march_args = (prep.win[i], prep.w0[i], prep.bounds[i], prep.canch[i],
                      prep.mid[i], minv[i], g, cfg)
        att_k = rs.march_exact(rec_k, *march_args)
        att_p = rs.march_exact_plain(rec_k, *march_args)
        stats["march"].append(float((att_k - att_p).abs().max()))
        out_k = rs.shade(att_k, texq, g, cfg, "texture")
        out_p = rs.shade_plain(att_k, texq, *texq.shape, "texture")
        diff_s, _, _ = frame_agreement(out_k, out_p)
        stats["shade"].append(int(diff_s.max()))
        # The whole chain: kernels end to end vs plain twins end to end.
        full_p = rs.shade_plain(att_p, texq, *texq.shape, "texture")
        diff, same, more = frame_agreement(out_k[:HEIGHT, :WIDTH],
                                           full_p[:HEIGHT, :WIDTH])
        counts["identical"] += int((diff == 0).sum())
        counts["off_1lsb"] += int((diff == 1).sum())
        counts["off_more"] += more
        counts["pixels"] += diff.numel()
        cov = (out_k[:HEIGHT, :WIDTH] != (255 << 24) - 2**32).float().mean()
        if not 0.3 < float(cov) <= 1.0:
            raise AssertionError(f"frame {i}: covered share {float(cov):.3f}")
    share = counts["identical"] / counts["pixels"]
    flips = counts["off_more"] / counts["pixels"]
    phase("kernels_vs_plain", frames=mvps.shape[0], **counts,
          identical_share=f"{share:.6f}",
          march_max_abs=max(stats["march"]),
          shade_max_lsb=max(stats["shade"]))
    if share < 0.999 or flips > 0.001:
        raise AssertionError(f"kernels disagree with the plain passes: "
                             f"{share:.6f} identical, {flips:.6f} > 1 LSB")

    # Times at the main path's shapes (frame 0), kernel beside plain twin.
    w0a = (prep.win[0], prep.w0[0], prep.bounds[0])
    rec = rs.solve_records(*w0a, g, cfg)
    march_args = (prep.win[0], prep.w0[0], prep.bounds[0], prep.canch[0],
                  prep.mid[0], minv[0], g, cfg)
    att = rs.march_exact(rec, *march_args)
    ms = {
        "solve": (cuda_ms(lambda: rs.solve_records(*w0a, g, cfg), 20),
                  wall_ms(lambda: rs.solve_records_plain(*w0a, g, cfg))),
        "march": (cuda_ms(lambda: rs.march_exact(rec, *march_args), 20),
                  wall_ms(lambda: rs.march_exact_plain(rec, *march_args))),
        "shade": (cuda_ms(lambda: rs.shade(att, texq, g, cfg, "texture"), 50),
                  wall_ms(lambda: rs.shade_plain(att, texq, *texq.shape,
                                                 "texture"))),
    }
    prep_ms = cuda_ms(lambda: rs.prep_scan(mvps.to(dev), vgrid, WIDTH, HEIGHT,
                                           cfg), 5) / mvps.shape[0]
    kernel_ms = sum(v[0] for v in ms.values())
    plain_ms = sum(v[1] for v in ms.values())
    phase("kernel_times", **{f"{k}_ms": f"{v[0]:.4f}" for k, v in ms.items()},
          **{f"{k}_plain_ms": f"{v[1]:.2f}" for k, v in ms.items()},
          prep_ms_per_frame=f"{prep_ms:.3f}",
          kernels_ms_per_frame=f"{kernel_ms:.3f}",
          plain_ms_per_frame=f"{plain_ms:.1f}")

    # -- phase 3: the main path -------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = Path(tmp) / "frames"
        common = ["scene.png", "scene_depth.png", "-mesh-density",
                  str(DENSITY), "--width", str(WIDTH), "--height",
                  str(HEIGHT), "--frames", str(args.frames),
                  "-output-path", str(out_dir)]
        # Render only (frames reach the host, nothing is encoded).
        render_args = cli.build_parser().parse_args(common + ["--no-video"])
        mesh_r = Mesh.from_texture(Texture(colour), depth_map=depth,
                                   density=DENSITY)
        mesh_r.vertices[:, 2] *= render_args.displacement_factor
        views_r = transforms.matmul(
            transforms.translation(dz=-10.0)[None],
            animation.default_sway().batch(
                animation.frame_times(args.frames, render_args.fps)))
        from depthrenderer_tpu_torch.render import render_clip

        # Warm-up group: the first call at these shapes pins its host buffers
        # and grows the allocator.
        render_clip(mesh_r, camera.projection, views_r[:16], WIDTH, HEIGHT,
                    on_frames=lambda s, f: None, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render_clip(mesh_r, camera.projection, views_r, WIDTH, HEIGHT,
                    on_frames=lambda s, f: None, device="cuda")
        torch.cuda.synchronize()
        render_fps = args.frames / (time.perf_counter() - t0)

        # The CLI body: render + MJPG AVI + sample PNG.
        rs.reset_launch_counts()
        result = cli.render_scene(colour, depth,
                                  cli.build_parser().parse_args(common))
        launches = dict(rs.LAUNCHES)
        video, sample = Path(result["video"]), Path(result["sample"])
        for path in (video, sample):
            if not path.is_file() or path.stat().st_size == 0:
                raise AssertionError(f"missing output {path}")
        with open(video, "rb") as f:
            head = f.read(64)
        if head[:4] != b"RIFF" or head[8:12] != b"AVI ":
            raise AssertionError("output video is not an AVI")
        n_frames = int.from_bytes(head[48:52], "little")
        if n_frames != args.frames:
            raise AssertionError(f"AVI holds {n_frames} frames, expected "
                                 f"{args.frames}")
        with open(sample, "rb") as f:
            if f.read(8) != b"\x89PNG\r\n\x1a\n":
                raise AssertionError("sample_frame.png is not a PNG")
        for name, count in launches.items():
            if count <= 0:
                raise AssertionError(f"kernel {name} never launched on the "
                                     "main path")
        phase("main_path", frames=args.frames, launches=json.dumps(launches),
              render_only_fps=f"{render_fps:.2f}",
              incl_encode_fps=f"{args.frames / result['seconds']:.2f}",
              avi_bytes=video.stat().st_size,
              sample_png_bytes=sample.stat().st_size)

    errs = {"solve": max(stats["solve"]), "march": max(stats["march"]),
            "shade": float(max(stats["shade"]))}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES, "launches": launches[name],
         "max_abs_err": errs[name], "ms": round(ms[name][0], 4),
         "plain_ms": round(ms[name][1], 2)}
        for name in ("solve", "march", "shade")]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
