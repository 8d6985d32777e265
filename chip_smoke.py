"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--frames N]

Phases (each prints one line; any failure exits non-zero with its traceback):

1. ``env``: the card (nvidia-smi), torch, CUDA and nvcc versions; builds the
   scan kernels (csrc/scan.cu), the pair kernel (csrc/pair.cu), one nvcc each,
   started together, and the native encoders (csrc/frameops.c) from the
   checkout, and prints each build's seconds.
2. ``kernels_vs_plain`` and ``kernel_times``: the scan kernels against their
   plain PyTorch twins on a seeded synthetic 640x480 colour + depth scene at
   mesh density 10 rendered at 1920x1080 with the shipped scan config, two
   sway frames: records equal, at least 99.9% of output pixels byte-identical
   (the rest at most 1 LSB, or a depth-tie flip). Each kernel is timed with
   CUDA events beside its plain twin.
3. ``main_path``: ``cli.render_scene`` (the scan) on the same arrays for one
   sway loop (300 frames at 60 fps) into an MJPG AVI and ``sample_frame.png``,
   with the launch counters set to 0 just before and read just after.
4. ``tiled_kernel_vs_plain``: the pair kernel against ``raster_pairs_plain``
   on the first kernel launch of the tiled CLI run below, as that run makes
   it: the config ``render_clip`` measures from the run's 32 views
   (``measured_config(q=0.995, anchors=1)`` over frames 0, 15 and 31), its
   first frame group. Tile rows equal, frames at the scan's bar; kernel,
   plain twin and prep times, active pairs, plane bytes and peak memory.
5. ``tiled_path``: ``render_clip(impl="pallas")`` render-only frames/s over
   64 frames after one warm-up group, then ``cli.render_scene --impl pallas``
   over 32 frames into an MJPG AVI, with the pair kernel's launch counter set
   to 0 just before and read just after; the count must be the number of
   frame groups of the checked config.
6. ``control``: ``render_frame_grid_exact`` (the lossless control, grid
   route, 2 strips as bench.py renders 1080p/d10) at sway frame 0: its row
   anchors and seconds, and the PSNR, the share of pixels off by more than 1
   LSB and the share off by more than 8 LSB (bench.py's flips) of the scan
   frame and of the tiled frame against it; the scan frame and the control
   on 16 evenly spaced rows against the float64 oracle
   (``ops/raster_reference.rasterize_grid_rows``): shares > 1 and > 8 LSB.
7. ``tiers``: the scan's fidelity tiers, ``--quality`` and ``--patch
   --colfix 3``. For each, on sway frame 74 at the configs the render path
   derives (``raster_scan.tier_configs``): pass 1, then (patch) the hole
   flags and block gates from the kernel chain's raster z, then pass 2 on
   the transposed problem (sparse for the patch tier), each kernel against
   its plain twin (records equal on the bands a pass renders, attributes
   max abs 0, packed pixels and raster z at the scan's 99.9 % bar), the
   merged kernel frame against the merged plain frame at the same bar, and
   each kernel's time beside its twin's and its bound. Then
   ``cli.render_scene`` with each tier's flags over 32 frames (launch
   counters set to 0 before, read after: ``solve``, ``march`` and ``shade``
   each 2 x frames), render-only and incl.-encode frames/s, and each tier's
   frame 0 against the control beside the default scan's; the phase fails if
   the quality tier's > 8 LSB share is above the default scan's.
8. ``big_grid``: BASELINE preset 4 (4K at mesh density 12, edge cull 0.25)
   and the scan kernels' big_grid, edge-cull and wireframe paths. On sway
   frame 74, each kernel against its twin at the tiers' bars, with times
   beside twin and bound: the wireframe mode and the edge cull at the
   default 1080p/d10 config, and the big_grid variant with edge cull at
   1080p/d11 (a 640-column chunked march). Then a seeded synthetic
   3840x2160 scene at d12 (4097 x 4097 vertices), frame 0: each kernel's
   time beside its bound; solve and shade against their twins on the whole
   frame (records and pixels equal) and the march against its twin on six
   bands, half of them among those whose blocks open the most chunks of the
   1024-column chunked march (attrs max abs 0); ``render_clip`` render-only
   frames/s over 16 frames after one warm-up group with its peak device
   memory; ``cli.render_scene -mesh-density 12 --width 3840 --height 2160
   --edge-cull 0.25`` over 16 frames (launch counters set to 0 before, read
   after: ``solve``, ``march`` and ``shade`` each = frames); and frame 0
   against ``render_frame_grid_exact`` at 16 strips with the same edge cull,
   as bench.py renders 4K/d12 (PSNR, shares, holes), then the scan frame
   and that control on 16 rows against the float64 oracle.

9. ``probes``: the probe kernels of ``csrc/probes.cu`` (the TPU probes of
   ``experiments/``, ROADMAP K3). ``probes_vs_plain``: every case of
   ``depthrenderer_tpu_torch.probes`` (40), kernel against twin bit for bit
   at the case's check trip count. Then the launch counters are set to 0
   and ``python -m depthrenderer_tpu_torch.probes``'s runner times every
   case (one ``[probe]`` line each: ns per lookup from the slope between
   two trip counts, lookups/s, blocks, SMs and the bound) with ``--quick``:
   it skips the two long counts, gather_probe9's 65,536 trips (timed at
   2,048 and 8,192) and gather_probe10's 65,536 (its 1,024 / 8,192 pair
   gives the slope); every kernel must have launched. For the JSON line
   each kernel's numbers are one case's at its check trips: gather_accum
   ``gp1_lane`` (gather_probe.py's lane gather, 256 trips), roll_accum
   ``gp5_roll``, onehot_dot ``gp1_onehot``, transpose ``spm_p1_transpose``
   (library: ``x.t().contiguous()``), march_top2 ``spm_p2_march``.

Each kernel's ``bound_ms`` is the larger of the bytes it must move (inputs
read once, outputs written once) over 3.35 TB/s and the operations this
run's data needs over 67 TFLOP/s (float32 outside the tensor cores), the
H100 SXM's published peaks. The second-to-last line is the kernel table as
JSON, the last line ``{"ok": true, "device": {...}}``. Without a CUDA device
it exits 2 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

WIDTH, HEIGHT, DENSITY = 1920, 1080, 10
# Frames of the tiled CLI run (the scan's main path keeps its 300-frame loop)
# and of the tiled render-only measure.
TILED_FRAMES, TILED_RENDER_FRAMES = 32, 64
# The tiers phase: the checked frame (the yawed frame kernels_vs_plain also
# checks), the CLI runs' frames, and each tier's flags and render_clip
# arguments.
TIER_FRAME, TIER_CLI_FRAMES = 74, 32
TIERS = {"quality": (["--quality"], {"quality": True}),
         "patch": (["--patch", "--colfix", "3"], {"patch": True, "colfix": 3})}
# The big_grid phase: BASELINE preset 4 (bench.py --preset 4) and the kernel
# check's 1080p/d11 config.
BIG_WIDTH, BIG_HEIGHT, BIG_DENSITY, BIG_FRAMES = 3840, 2160, 12, 16
EDGE_CULL, CHECK_DENSITY, BIG_CONTROL_STRIPS = 0.25, 11, 16
# Bands of the 4K/d12 march twin, and pixel rows of the float64 oracle.
MARCH_BANDS, ORACLE_ROWS = 6, 16
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# The control's strips at 1080p/d10, as bench.py renders it; a "flip" is a
# pixel off by more than 8 LSB, bench.py's winner-flip measure.
CONTROL_STRIPS = 2
# Operations per active (pixel, triangle) pair of the pair kernel: four
# planes at fma + mul + add (4 each) and six comparisons.
PAIR_OPS = 22
KERNELS = {
    "solve": ("depthrenderer_tpu_torch/csrc/scan.cu",
              "depthrenderer_tpu/ops/raster_scan.py:815"),
    "march": ("depthrenderer_tpu_torch/csrc/scan.cu",
              "depthrenderer_tpu/ops/raster_scan.py:815"),
    "shade": ("depthrenderer_tpu_torch/csrc/scan.cu",
              "depthrenderer_tpu/ops/raster_scan.py:815"),
    "pairs": ("depthrenderer_tpu_torch/csrc/pair.cu",
              "depthrenderer_tpu/ops/raster_pallas.py:184"),
}
# The probe kernels (csrc/probes.cu) and the case whose numbers each one's
# JSON entry carries; their "replaces" lists every experiments/ pallas_call
# site the kernel stands for (from the case registry).
PROBE_KERNELS = {"gather_accum": "gp1_lane", "roll_accum": "gp5_roll",
                 "onehot_dot": "gp1_onehot", "transpose": "spm_p1_transpose",
                 "march_top2": "spm_p2_march"}
PROBE_REPS = 10


def phase(name, **fields):
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


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


def bound(nbytes, ops):
    """(bound_ms, bound_by): the card's least time for this work."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def frame_agreement(a, b):
    """Per-pixel max channel difference of two packed frames, the share of
    byte-identical pixels and the count of pixels off by more than 1 LSB
    (a depth-tie winner flip, or a disagreement)."""
    a8 = a.view(torch.uint8).reshape(a.shape + (4,)).int()
    b8 = b.view(torch.uint8).reshape(b.shape + (4,)).int()
    diff = (a8 - b8).abs().amax(dim=-1)
    return diff, (diff == 0).float().mean().item(), int((diff > 1).sum())


def rgba_agreement(a, b):
    """The same for (..., 4) uint8 frames: (identical share, > 1 LSB
    share)."""
    diff = (a.int() - b.int()).abs().amax(dim=-1)
    return (diff == 0).float().mean().item(), (diff > 1).float().mean().item()


def check_outputs(result, frames):
    """The CLI's AVI (RIFF/AVI, frame count) and sample PNG."""
    video, sample = Path(result["video"]), Path(result["sample"])
    for path in (video, sample):
        if not path.is_file() or path.stat().st_size == 0:
            raise AssertionError(f"missing output {path}")
    with open(video, "rb") as f:
        head = f.read(64)
    if head[:4] != b"RIFF" or head[8:12] != b"AVI ":
        raise AssertionError("output video is not an AVI")
    n_frames = int.from_bytes(head[48:52], "little")
    if n_frames != frames:
        raise AssertionError(f"AVI holds {n_frames} frames, expected {frames}")
    with open(sample, "rb") as f:
        if f.read(8) != b"\x89PNG\r\n\x1a\n":
            raise AssertionError("sample_frame.png is not a PNG")
    return video.stat().st_size, sample.stat().st_size


def build_all():
    """Build every kernel source and the encoders, all started together;
    -> {name: seconds}."""
    from depthrenderer_tpu_torch import native, probes
    from depthrenderer_tpu_torch.ops import raster_scan as rs
    from depthrenderer_tpu_torch.ops import tiled

    def timed(fn):
        t0 = time.perf_counter()
        fn(force=True)
        return time.perf_counter() - t0

    jobs = {"scan": rs.build_kernels, "pair": tiled.build_kernels,
            "probes": probes.build_kernels, "frameops": native.build}
    with ThreadPoolExecutor(len(jobs)) as ex:
        futures = {k: ex.submit(timed, fn) for k, fn in jobs.items()}
        return {k: f.result() for k, f in futures.items()}


def scan_bounds(prep, i, g, cfg, texq, bflag=None, with_z=False):
    """Bytes and operations of the three scan kernels on frame i; with a
    band flag (sparse bands) the records, the window and the attributes
    read count only the flagged bands' share. The attributes are 4 planes;
    ``with_z`` (the tiers' passes): the march also writes the raster-z
    plane, and the shade reads it and writes the raster z. A big_grid
    block sweeps its whole 128-aligned fetch window (``min(cw + 128,
    CL)`` columns)."""
    from depthrenderer_tpu_torch.ops import raster_scan as rs

    share = 1.0 if bflag is None else float(bflag.float().mean())
    rec = g.nbands * cfg.nbr * cfg.nrec * 8 * g.cl * 4 * share
    attrs = rs.n_attrs(with_z) * g.hpad * g.wl * 4
    ints = nbytes(prep.w0[i], prep.bounds[i])
    win = nbytes(prep.win[i]) * share
    solve = (win + ints + rec, 2 * 8 * 128 * g.nchunks * g.nbands * share)
    # The march sweeps, per pixel, the slot-0 record columns of its block's
    # march window (128 narrow, cw wide, none when skipped): two comparisons
    # each. The exact tests and colfix come on top, uncounted.
    mid = prep.mid[i].long()
    wide = min(cfg.cw + 128, g.cl) if cfg.big_grid else cfg.cw
    cols = torch.where(mid >= 0, 128, torch.where(mid == -1, wide, 0))
    if bflag is not None:
        cols = cols.reshape(g.nbands, g.nblk) * bflag.long()[:, None]
    march = (rec + win + nbytes(prep.canch[i], prep.mid[i]) + ints + attrs,
             2 * 1024 * int(cols.sum()))
    shade = (attrs * share + nbytes(texq)
             + g.hpad * g.wl * 4 * (2 if with_z else 1), 0)
    return {"solve": solve, "march": march, "shade": shade}


def pair_bounds(planes, tc, tile_pixels):
    """Bytes and operations of the pair kernel on these planes: the active
    chunks' planes read once, the rows written once, 22 operations per
    active pair."""
    from depthrenderer_tpu_torch.ops import tiled

    cov, attr, px0, py0, jlo, jhi = planes
    chunks = int((jhi.long() - jlo.long()).sum())
    pairs = tiled.active_pairs(jlo, jhi, tc, tile_pixels)
    moved = (chunks * 2 * 12 * tc * 4 + nbytes(px0, py0, jlo, jhi)
             + cov.shape[0] * tile_pixels * 8 * 4)
    return moved, PAIR_OPS * pairs, pairs


def scan_phase(scene, dev):
    """Phase 2: the scan kernels against their plain twins at 1080p/d10."""
    from depthrenderer_tpu_torch import animation, transforms
    from depthrenderer_tpu_torch.ops import raster_scan as rs
    from depthrenderer_tpu_torch.render import clip_mvps

    mesh, projection, vgrid, _, texture = scene
    n = vgrid.shape[0]
    cfg = rs.suggest_scan_config(n, WIDTH, HEIGHT)
    times = animation.frame_times(300, 60.0)[[0, 74]]
    views = transforms.matmul(transforms.translation(dz=-10.0)[None],
                              animation.default_sway().batch(times))
    mvps = clip_mvps(projection, views, mesh.transform)
    g = rs.ScanGeometry.of(WIDTH, HEIGHT, n, n, cfg)
    texq = rs.pack_texture(texture)
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
    bounds = {k: bound(*v) for k, v in
              scan_bounds(prep, 0, g, cfg, texq).items()}
    phase("kernel_times", **{f"{k}_ms": f"{v[0]:.4f}" for k, v in ms.items()},
          **{f"{k}_plain_ms": f"{v[1]:.2f}" for k, v in ms.items()},
          **{f"{k}_bound_ms": f"{v[0]:.4f}" for k, v in bounds.items()},
          prep_ms_per_frame=f"{prep_ms:.3f}",
          kernels_ms_per_frame=f"{sum(v[0] for v in ms.values()):.3f}",
          plain_ms_per_frame=f"{sum(v[1] for v in ms.values()):.1f}")
    errs = {"solve": max(stats["solve"]), "march": max(stats["march"]),
            "shade": float(max(stats["shade"]))}
    return {k: {"max_abs_err": errs[k], "ms": ms[k][0], "plain_ms": ms[k][1],
                "bound_ms": bounds[k][0], "bound_by": bounds[k][1]}
            for k in ms}


def cli_args(out_dir, frames, extra=(), density=DENSITY, width=WIDTH,
             height=HEIGHT):
    from depthrenderer_tpu_torch import cli

    return cli.build_parser().parse_args(
        ["scene.png", "scene_depth.png", "-mesh-density", str(density),
         "--width", str(width), "--height", str(height), "--frames",
         str(frames), "-output-path", str(out_dir), *extra])


def clip_views(frames, fps=60.0):
    from depthrenderer_tpu_torch import animation, transforms

    return transforms.matmul(
        transforms.translation(dz=-10.0)[None],
        animation.default_sway().batch(animation.frame_times(frames, fps)))


def smoke_scene(colour, depth, dev, density=DENSITY):
    """The scene as the CLI builds it (mesh density ``density``, depth
    displacement 4, fov_y 18) -> ``(mesh, projection, vgrid, uvgrid,
    texture)``, the grids and the texture on ``dev``."""
    from depthrenderer_tpu_torch.scene import Camera, Mesh, Texture

    mesh = Mesh.from_texture(Texture(colour), depth_map=depth,
                             density=density)
    mesh.vertices[:, 2] *= 4.0
    n = int(round(len(mesh.vertices) ** 0.5))
    projection = Camera((colour.shape[1], colour.shape[0]),
                        fov_y=18.0).projection
    return (mesh, projection, mesh.vertices.reshape(n, n, 3).to(dev),
            mesh.texture_coordinates.reshape(n, n, 2).to(dev),
            mesh.texture.image.to(dev))


def render_fps(mesh, projection, frames, warm, width=WIDTH, height=HEIGHT,
               **kw):
    """Render-only frames/s of ``render_clip`` (frames reach the host,
    nothing is encoded) after one warm-up group: the first call at these
    shapes pins its host buffers and grows the allocator."""
    from depthrenderer_tpu_torch.render import render_clip

    views = clip_views(frames)
    render_clip(mesh, projection, views[:warm], width, height,
                on_frames=lambda s, f: None, device="cuda", **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    render_clip(mesh, projection, views, width, height,
                on_frames=lambda s, f: None, device="cuda", **kw)
    torch.cuda.synchronize()
    return frames / (time.perf_counter() - t0)


def scan_main_path(colour, depth, scene, frames, tmp):
    """Phase 3: the scan's CLI body, launch counters read around it."""
    from depthrenderer_tpu_torch import cli
    from depthrenderer_tpu_torch.ops import raster_scan as rs

    mesh, projection = scene[:2]
    fps = render_fps(mesh, projection, frames, 16)
    rs.reset_launch_counts()
    result = cli.render_scene(colour, depth, cli_args(tmp / "scan", frames))
    launches = dict(rs.LAUNCHES)
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} never launched on the main "
                                 "path")
    avi, png = check_outputs(result, frames)
    phase("main_path", frames=frames, launches=json.dumps(launches),
          render_only_fps=f"{fps:.2f}",
          incl_encode_fps=f"{frames / result['seconds']:.2f}",
          avi_bytes=avi, sample_png_bytes=png)
    return launches


def tiled_phase(scene, dev):
    """Phase 4: the pair kernel against its plain twin on the tiled CLI
    run's first kernel launch: the config ``render_clip`` measures from that
    run's views, its first frame group -> (config, group, kernel fields)."""
    from depthrenderer_tpu_torch import cli
    from depthrenderer_tpu_torch.ops import raster_pallas as trp
    from depthrenderer_tpu_torch.ops import tiled
    from depthrenderer_tpu_torch.render import clip_mvps, tiled_config

    mesh, projection, vgrid, uvgrid, texture = scene
    # render_clip's own steps on the CLI run's views (default quantile).
    mvps = clip_mvps(projection, clip_views(TILED_FRAMES),
                     mesh.transform).to(dev)
    cfg = tiled_config(mvps, vgrid, uvgrid, WIDTH, HEIGHT)
    group = trp.frame_group(WIDTH, HEIGHT, cfg,
                            cli.build_parser().get_default("frame_batch"))
    first = mvps[:group]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    planes = trp._prep_stage_batched(first, vgrid, uvgrid, WIDTH, HEIGHT, cfg)
    rows_k = tiled.raster_pairs(*planes, HEIGHT, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows_p = tiled.raster_pairs_plain(*planes, HEIGHT, cfg)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    max_abs = float((rows_k - rows_p).abs().max())
    if not torch.equal(rows_k, rows_p):
        bad = int((rows_k != rows_p).sum())
        raise AssertionError(f"{bad} tile-row values differ between the pair "
                             "kernel and its twin")
    frames_k = trp._shade_stage_batched(rows_k, texture, WIDTH, HEIGHT, cfg,
                                        "texture")
    frames_p = trp._shade_stage_batched(rows_p, texture, WIDTH, HEIGHT, cfg,
                                        "texture")
    same, more = rgba_agreement(frames_k, frames_p)
    covered = float((frames_k[..., :3].amax(-1) > 0).float().mean())
    if same < 0.999 or more > 0.001 or not 0.3 < covered <= 1.0:
        raise AssertionError(f"tiled frames: {same:.6f} identical, "
                             f"{more:.6f} > 1 LSB, {covered:.3f} covered")
    del rows_p, frames_p, frames_k
    # Times of the same launch, kernel beside plain twin.
    tc = planes[0].shape[-1]
    P = cfg.tile_h * cfg.tile_w
    kernel_ms = cuda_ms(lambda: tiled.raster_pairs(*planes, HEIGHT, cfg), 3)
    prep_ms = cuda_ms(lambda: trp._prep_stage_batched(
        first, vgrid, uvgrid, WIDTH, HEIGHT, cfg), 2) / group
    moved, ops, pairs = pair_bounds(planes, tc, P)
    bound_ms, bound_by = bound(moved, ops)
    peak = torch.cuda.max_memory_allocated() / 2**30
    plane_bytes = trp._coeff_bytes_per_frame(WIDTH, HEIGHT, cfg)
    phase("tiled_kernel_vs_plain", frames=group, **config_fields(cfg),
          rows_equal=True, identical_share=f"{same:.6f}",
          off_more_share=f"{more:.6f}", pairs_ms=f"{kernel_ms:.4f}",
          pairs_ms_per_frame=f"{kernel_ms / group:.4f}",
          pairs_plain_ms=f"{plain_ms:.1f}",
          pairs_bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
          prep_ms_per_frame=f"{prep_ms:.3f}",
          active_pairs_per_frame=pairs // group,
          plane_gb_per_frame=f"{plane_bytes / 1e9:.3f}",
          peak_gib=f"{peak:.2f}")
    del planes, rows_k
    return cfg, group, {"max_abs_err": max_abs, "ms": kernel_ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by}


def config_fields(cfg):
    """The tiled config's window and chunking, as phase fields."""
    from depthrenderer_tpu_torch.ops import raster_pallas as trp

    tc, nc = trp._chunks(cfg)
    return {"window": f"{cfg.window_rows}x{cfg.window_cols}",
            "chunk_tris": cfg.chunk_tris, "tc": tc, "nchunks": 2 * nc}


def tiled_main_path(colour, depth, scene, cfg, group, tmp):
    """Phase 5: render_clip(impl="pallas") and the CLI body with --impl
    pallas, the pair kernel's launch counter read around the CLI run."""
    from depthrenderer_tpu_torch import cli
    from depthrenderer_tpu_torch.ops import tiled

    mesh, projection = scene[:2]
    torch.cuda.reset_peak_memory_stats()
    fps = render_fps(mesh, projection, TILED_RENDER_FRAMES, 16, impl="pallas")
    peak = torch.cuda.max_memory_allocated() / 2**30
    tiled.reset_launch_counts()
    args = cli_args(tmp / "pallas", TILED_FRAMES, ["--impl", "pallas"])
    result = cli.render_scene(colour, depth, args)
    launches = tiled.LAUNCHES["pairs"]
    if launches <= 0:
        raise AssertionError("kernel pairs never launched on the tiled path")
    # render_clip's groups of --frame-batch frames, each in kernel groups of
    # the checked config's size.
    batch = args.frame_batch
    want = sum(-(-min(batch, TILED_FRAMES - s) // group)
               for s in range(0, TILED_FRAMES, batch))
    if launches != want:
        raise AssertionError(f"{launches} pair launches on the tiled path, "
                             f"{want} with the checked config")
    avi, png = check_outputs(result, TILED_FRAMES)
    phase("tiled_path", render_frames=TILED_RENDER_FRAMES,
          render_only_fps=f"{fps:.2f}", render_peak_gib=f"{peak:.2f}",
          frames=TILED_FRAMES, **config_fields(cfg), group=group,
          launches=json.dumps({"pairs": launches}),
          incl_encode_fps=f"{TILED_FRAMES / result['seconds']:.2f}",
          avi_bytes=avi, sample_png_bytes=png)
    return launches


def control_fidelity(frame, control):
    """PSNR, > 1 LSB share and > 8 LSB share (bench.py's flips) of a
    (H, W, 4) uint8 frame against the control."""
    from depthrenderer_tpu_torch.utils import psnr

    diff = np.abs(frame.astype(np.int32) - control.astype(np.int32)).max(-1)
    return psnr(frame, control), float((diff > 1).mean()), float(
        (diff > 8).mean())


def control_phase(scene, tiled_cfg, dev):
    """Phase 6: the lossless control at sway frame 0 against the scan and
    tiled frames -> (control frame, the scan's fidelity)."""
    from depthrenderer_tpu_torch.ops import raster_grid as trg
    from depthrenderer_tpu_torch.ops import raster_pallas as trp
    from depthrenderer_tpu_torch.ops import raster_scan as rs
    from depthrenderer_tpu_torch.render import clip_mvps

    mesh, projection, vgrid, uvgrid, texture = scene
    n = vgrid.shape[0]
    mvps = clip_mvps(projection, clip_views(1), mesh.transform)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    control, stats = trg.render_frame_grid_exact(
        mvps[0].to(dev), vgrid, uvgrid, texture, WIDTH, HEIGHT,
        strips=CONTROL_STRIPS, with_stats=True)
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    scan_cfg = rs.suggest_scan_config(n, WIDTH, HEIGHT)
    raw, _ = rs.render_frames_scan(mvps, vgrid, uvgrid, texture, WIDTH,
                                   HEIGHT, scan_cfg)
    scan = rs.unpack_raw_frames(raw.cpu(), WIDTH, HEIGHT)[0]
    tiled = trp.render_frames_pallas(mvps.to(dev), vgrid, uvgrid, texture,
                                     WIDTH, HEIGHT, tiled_cfg)[0].cpu().numpy()
    fields, fid = {}, {}
    for name, frame in (("scan", scan), ("tiled", tiled)):
        fid[name] = control_fidelity(frame, control)
        fields[f"{name}_psnr_db"] = f"{fid[name][0]:.2f}"
        fields[f"{name}_off_more_share"] = f"{fid[name][1]:.6f}"
        fields[f"{name}_flip_share"] = f"{fid[name][2]:.6f}"
    cfg = stats["config"]
    covered = float((control[..., :3].max(-1) > 0).mean())
    if not 0.3 < covered <= 1.0:
        raise AssertionError(f"control frame covered share {covered:.3f}")
    phase("control", frame=0, row_anchors=cfg.row_anchors,
          window=f"{cfg.window_rows}x{cfg.window_cols}",
          strips=stats["strips"], seconds=f"{seconds:.2f}",
          peak_gib=f"{peak:.2f}", covered_share=f"{covered:.4f}", **fields,
          **oracle_fidelity(mvps[0], vgrid, uvgrid, texture, WIDTH, HEIGHT,
                            {"scan": scan, "control": control}))
    return control, fid["scan"]


def timed_ms(fn):
    """(fn(), wall milliseconds), the device synchronised around it."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def tier_pass(label, cfg, mvp, vgrid, texture, width, height, dev,
              gates=None, mode="texture_z"):
    """One pass of a tier on one frame, each kernel against its plain twin
    -> (kernel (packed, z), plain-chain (packed, z), phase fields).

    The twins run on the kernels' inputs (the march twin on the kernel's
    records, the shade twin on the kernel's attrs); the plain chain's frame
    shades the march twin's attrs. ``gates`` (bflag, blkflag) makes the pass
    sparse. ``mode`` ``texture`` or ``wireframe`` checks a single pass
    instead (4 attribute planes, no raster z: z is None)."""
    from depthrenderer_tpu_torch.ops import raster_scan as rs

    g = rs.ScanGeometry.of(width, height, vgrid.shape[0], vgrid.shape[1],
                           cfg)
    minv = rs.minv_rows(mvp)
    prep = rs.prep_scan(mvp.to(dev), vgrid, width, height, cfg)
    texq = rs.pack_texture(texture)
    bflag = None
    if gates is not None:
        bounds, mid = rs.apply_patch_gates(prep.bounds, prep.mid, prep.canch,
                                           gates[1], min(cfg.cw + 128, g.cl),
                                           g.cl)
        prep = prep._replace(bounds=bounds, mid=mid)
        bflag = gates[0][0].contiguous()
    args = (prep.win[0], prep.w0[0], prep.bounds[0])
    rec = rs.solve_records(*args, g, cfg, bflag)
    rec_p, solve_plain = timed_ms(
        lambda: rs.solve_records_plain(*args, g, cfg, bflag))
    rows = slice(None) if bflag is None else bflag.bool()
    if not torch.equal(rec[rows], rec_p[rows]):
        bad = int((rec[rows] != rec_p[rows]).sum())
        raise AssertionError(f"{label}: {bad} record values differ between "
                             "the solve kernel and its twin")
    del rec_p
    margs = (prep.win[0], prep.w0[0], prep.bounds[0], prep.canch[0],
             prep.mid[0], minv[0], g, cfg, bflag)
    with_z = mode == "texture_z"
    mkw = {"raster_z": with_z, "wire": mode == "wireframe"}
    att = rs.march_exact(rec, *margs, **mkw)
    att_p, march_plain = timed_ms(
        lambda: rs.march_exact_plain(rec, *margs, **mkw))
    march_err = float((att - att_p).abs().max())
    if march_err != 0.0:
        raise AssertionError(f"{label}: march attrs differ from the twin's "
                             f"by {march_err}")

    def pair(o):   # (packed, raster z or None)
        return o if with_z else (o, None)

    out = pair(rs.shade(att, texq, g, cfg, mode, bflag))
    sh_p, shade_plain = timed_ms(lambda: pair(rs.shade_plain(
        att, texq, *texq.shape, mode, bflag)))
    if not (torch.equal(out[0], sh_p[0])
            and (not with_z or torch.equal(out[1], sh_p[1]))):
        raise AssertionError(f"{label}: shade outputs differ from the twin's")
    chain_p = pair(rs.shade_plain(att_p, texq, *texq.shape, mode, bflag))
    _, same, more = frame_agreement(out[0], chain_p[0])
    z_same = (float((out[1] == chain_p[1]).float().mean()) if with_z
              else 1.0)
    if same < 0.999 or more > 0.001 * out[0].numel() or z_same < 0.999:
        raise AssertionError(f"{label}: kernel chain against plain chain: "
                             f"{same:.6f} identical, {more} > 1 LSB, "
                             f"raster z {z_same:.6f} equal")
    ms = {"solve": cuda_ms(lambda: rs.solve_records(*args, g, cfg, bflag),
                           10),
          "march": cuda_ms(lambda: rs.march_exact(rec, *margs, **mkw), 10),
          "shade": cuda_ms(lambda: rs.shade(att, texq, g, cfg, mode, bflag),
                           20)}
    plain = {"solve": solve_plain, "march": march_plain,
             "shade": shade_plain}
    bounds = {k: bound(*v) for k, v in scan_bounds(
        prep, 0, g, cfg, texq, bflag, with_z=with_z).items()}
    fields = {"cfg": f"sr{cfg.sr}/hyps{cfg.hyps}/colfix{cfg.colfix}/"
                     f"cw{cfg.cw}/dual{int(cfg.dual_col)}/"
                     f"big{int(cfg.big_grid)}/cull{cfg.edge_cull_threshold}",
              "identical_share": f"{same:.6f}",
              "z_equal_share": f"{z_same:.6f}",
              **{f"{k}_ms": f"{v:.4f}" for k, v in ms.items()},
              **{f"{k}_plain_ms": f"{v:.1f}" for k, v in plain.items()},
              **{f"{k}_bound_ms": f"{v[0]:.4f}" for k, v in bounds.items()}}
    if bflag is not None:
        fields["bands"] = f"{int(bflag.sum())}/{g.nbands}"
        fields["blocks_live"] = int((prep.mid[0] != -2).sum())
    return out, chain_p, fields


def tier_kernels(name, scene, dev):
    """The tiers phase's kernel checks of one tier on sway frame 74."""
    from depthrenderer_tpu_torch.ops import raster_scan as rs
    from depthrenderer_tpu_torch.render import clip_mvps

    mesh, projection, vgrid, _, texture = scene
    n = vgrid.shape[0]
    cfg = rs.suggest_scan_config(n, WIDTH, HEIGHT, **TIERS[name][1])
    cfg1, cfg2 = rs.tier_configs(cfg, n, n, WIDTH, HEIGHT)
    mvp = clip_mvps(projection, clip_views(300)[TIER_FRAME:TIER_FRAME + 1],
                    mesh.transform)
    vgrid_t = vgrid.transpose(0, 1).contiguous()
    tex_t = texture.transpose(0, 1).contiguous()
    (k1, p1, f1) = tier_pass(f"{name} pass 1", cfg1, mvp, vgrid, texture,
                             WIDTH, HEIGHT, dev)
    phase(f"tiers_{name}_pass1", frame=TIER_FRAME, **f1)
    gates = None
    if name == "patch":
        g2 = rs.ScanGeometry.of(HEIGHT, WIDTH, n, n, cfg2)
        gates = rs.patch_flags(k1[1][None], WIDTH, HEIGHT, g2.nbands,
                               g2.nblk)
        gates_p = rs.patch_flags(p1[1][None], WIDTH, HEIGHT, g2.nbands,
                                 g2.nblk)
        phase(f"tiers_{name}_flags",
              flagged_bands=f"{int(gates[0].sum())}/{g2.nbands}",
              flagged_blocks=f"{int(gates[1].sum())}/{g2.nbands * g2.nblk}",
              equal_to_plain_chain=all(torch.equal(a, b) for a, b in
                                       zip(gates, gates_p)))
    (k2, p2, f2) = tier_pass(f"{name} pass 2", cfg2, rs.swap_mvps(mvp),
                             vgrid_t, tex_t, HEIGHT, WIDTH, dev, gates)
    phase(f"tiers_{name}_pass2", frame=TIER_FRAME, **f2)
    merged_k = rs.merge_row_edge_raw(k1[0][None], k1[1][None], k2[0][None],
                                     k2[1][None], WIDTH, HEIGHT)[0]
    merged_p = rs.merge_row_edge_raw(p1[0][None], p1[1][None], p2[0][None],
                                     p2[1][None], WIDTH, HEIGHT)[0]
    _, same, more = frame_agreement(merged_k[:HEIGHT, :WIDTH],
                                    merged_p[:HEIGHT, :WIDTH])
    won = int((merged_k != k1[0]).sum())
    phase(f"tiers_{name}_merged", identical_share=f"{same:.6f}",
          off_more=more, pass2_pixels=won)
    if same < 0.999 or more > 0.001 * HEIGHT * WIDTH:
        raise AssertionError(f"{name}: merged kernel frame against the plain "
                             f"chain: {same:.6f} identical, {more} > 1 LSB")


def tier_cli(name, colour, depth, scene, control, scan_fid, tmp):
    """The tiers phase's CLI run and fidelity of one tier -> its > 8 LSB
    share against the control."""
    from depthrenderer_tpu_torch import cli
    from depthrenderer_tpu_torch.ops import raster_scan as rs
    from depthrenderer_tpu_torch.render import clip_mvps

    mesh, projection, vgrid, uvgrid, texture = scene
    flags, kw = TIERS[name]
    fps = render_fps(mesh, projection, TIER_CLI_FRAMES, 16, **kw)
    rs.reset_launch_counts()
    result = cli.render_scene(colour, depth, cli_args(
        tmp / name, TIER_CLI_FRAMES, flags))
    launches = dict(rs.LAUNCHES)
    want = 2 * TIER_CLI_FRAMES
    if launches != {"solve": want, "march": want, "shade": want}:
        raise AssertionError(f"{name}: launches {launches} on the CLI run, "
                             f"expected {want} each")
    avi, png = check_outputs(result, TIER_CLI_FRAMES)
    cfg = rs.suggest_scan_config(vgrid.shape[0], WIDTH, HEIGHT, **kw)
    mvps = clip_mvps(projection, clip_views(1), mesh.transform)
    raw, _ = rs.render_frames_scan(mvps, vgrid, uvgrid, texture, WIDTH,
                                   HEIGHT, cfg)
    frame = rs.unpack_raw_frames(raw.cpu(), WIDTH, HEIGHT)[0]
    fid = control_fidelity(frame, control)
    phase(f"tiers_{name}_path", frames=TIER_CLI_FRAMES,
          launches=json.dumps(launches), render_only_fps=f"{fps:.2f}",
          incl_encode_fps=f"{TIER_CLI_FRAMES / result['seconds']:.2f}",
          avi_bytes=avi, sample_png_bytes=png,
          psnr_db=f"{fid[0]:.2f}", off_more_share=f"{fid[1]:.6f}",
          flip_share=f"{fid[2]:.6f}",
          scan_psnr_db=f"{scan_fid[0]:.2f}",
          scan_flip_share=f"{scan_fid[2]:.6f}")
    return fid[2]


def tiers_phase(colour, depth, scene, control, scan_fid, dev, tmp):
    """Phase 7: the fidelity tiers."""
    flips = {}
    for name in TIERS:
        tier_kernels(name, scene, dev)
        flips[name] = tier_cli(name, colour, depth, scene, control, scan_fid,
                               tmp)
    if flips["quality"] > scan_fid[2]:
        raise AssertionError(
            f"the quality tier flips {flips['quality']:.6f} of the pixels "
            f"against the control, the default scan {scan_fid[2]:.6f}")


def big_grid_checks(colour, depth, scene, dev):
    """Phase 8, the kernel checks on sway frame 74: the wireframe mode and
    the edge cull (0.25) at the default 1080p/d10 config, and the big_grid
    variant with edge cull at 1080p/d11, each kernel against its twin."""
    from depthrenderer_tpu_torch.ops import raster_scan as rs
    from depthrenderer_tpu_torch.render import clip_mvps

    views = clip_views(300)[TIER_FRAME:TIER_FRAME + 1]
    mesh, projection, vgrid, _, texture = scene
    cfg = rs.suggest_scan_config(vgrid.shape[0], WIDTH, HEIGHT)
    mvp = clip_mvps(projection, views, mesh.transform)
    _, _, fields = tier_pass("wireframe", cfg, mvp, vgrid, texture, WIDTH,
                             HEIGHT, dev, mode="wireframe")
    phase("big_grid_wireframe_vs_plain", frame=TIER_FRAME, **fields)
    # The edge cull in the standard variant (what --edge-cull runs at d10).
    culled = rs.suggest_scan_config(vgrid.shape[0], WIDTH, HEIGHT,
                                    edge_cull_threshold=EDGE_CULL)
    _, _, fields = tier_pass("edge_cull", culled, mvp, vgrid, texture, WIDTH,
                             HEIGHT, dev, mode="texture")
    phase("edge_cull_vs_plain", frame=TIER_FRAME, **fields)

    mesh11, projection11, vgrid11, _, texture11 = smoke_scene(
        colour, depth, dev, CHECK_DENSITY)
    cfg11 = rs.suggest_scan_config(vgrid11.shape[0], WIDTH, HEIGHT,
                                   edge_cull_threshold=EDGE_CULL)
    if not cfg11.big_grid:
        raise AssertionError(f"d{CHECK_DENSITY} at 1080p resolved to {cfg11}")
    mvp11 = clip_mvps(projection11, views, mesh11.transform)
    torch.cuda.reset_peak_memory_stats()
    _, _, fields = tier_pass("big_grid", cfg11, mvp11, vgrid11, texture11,
                             WIDTH, HEIGHT, dev, mode="texture")
    phase("big_grid_kernels_vs_plain", frame=TIER_FRAME,
          density=CHECK_DENSITY, size=f"{WIDTH}x{HEIGHT}",
          rmax=cfg11.rmax, fetch_cols=min(cfg11.cw + 128,
                                          -(-vgrid11.shape[1] // 128) * 128),
          peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}",
          **fields)


def open_chunks(rec, canch, g, cfg):
    """Per band, the most 128-column chunks that the chunked march's block
    gate opens for slot 0 in one of its blocks (the gate of
    ``raster_scan._march_bands``' ``sweep_chunked``, on the records)."""
    from depthrenderer_tpu_torch.ops import raster_scan as rs

    nch = min(cfg.cw + 128, g.cl) // 128
    sx = rec[:, 0, 0]                                  # (nbands, 8, CL)
    lo = canch.long() * 8 // 128 * 128                 # (nblk,)
    qx0 = torch.arange(g.nblk, device=rec.device)[:, None] * 128.0 + 0.5
    count = torch.zeros((g.nbands, g.nblk), dtype=torch.int64,
                        device=rec.device)
    for ch in range(nch):
        cols = (lo[:, None] + ch * 128
                + torch.arange(136 if ch < nch - 1 else 128,
                               device=rec.device))
        sxs = sx[:, :, cols]                           # (nbands, 8, nblk, L)
        near = (sxs <= qx0 + 127.0).any(3).any(1)
        real = ((sxs < rs._FAR * 0.5) & (sxs >= qx0 - 64.0)).any(3).any(1)
        count += near & real
    return count.amax(1)


def big_grid_twins(prep, rec, att, margs, texq, g, cfg):
    """Phase 8 at preset 4, frame 0: solve and shade against their twins on
    the whole frame (records equal, packed pixels equal); the march twin on
    a few bands (the widest-gated, and some spread over the covered ones),
    its attrs equal to the kernel's there -> phase fields."""
    from depthrenderer_tpu_torch.ops import raster_scan as rs

    t0 = time.perf_counter()
    args = margs[:3]
    rec_p, solve_plain = timed_ms(lambda: rs.solve_records_plain(*args, g,
                                                                  cfg))
    if not torch.equal(rec, rec_p):
        raise AssertionError(f"4K/d12: {int((rec != rec_p).sum())} record "
                             "values differ between the solve kernel and "
                             "its twin")
    del rec_p
    out_k = rs.shade(att, texq, g, cfg, "texture")
    out_p, shade_plain = timed_ms(lambda: rs.shade_plain(
        att, texq, *texq.shape, "texture"))
    if not torch.equal(out_k, out_p):
        raise AssertionError("4K/d12: shade output differs from the twin's")
    counts = open_chunks(rec, prep.canch[0], g, cfg)
    full = torch.nonzero(counts == counts.max()).squeeze(1)
    live = torch.nonzero(counts > 0).squeeze(1)
    pick = sorted({int(full[k]) for k in torch.linspace(
        0, len(full) - 1, MARCH_BANDS // 2).round().long()}
        | {int(live[k]) for k in torch.linspace(
            0, len(live) - 1, MARCH_BANDS - MARCH_BANDS // 2).round().long()})
    bflag = torch.zeros(g.nbands, dtype=torch.int32, device=rec.device)
    bflag[pick] = 1
    att_p, march_plain = timed_ms(lambda: rs.march_exact_plain(
        rec, *margs, bflag))
    rows = bflag.bool().repeat_interleave(8)
    march_err = float((att[:, rows] - att_p[:, rows]).abs().max())
    if march_err != 0.0:
        raise AssertionError(f"4K/d12: march attrs differ from the twin's by "
                             f"{march_err} on bands {pick}")
    return {"records_equal": True, "shade_equal": True,
            "march_bands": ",".join(map(str, pick)),
            "band_open_chunks": ",".join(str(int(counts[b])) for b in pick),
            "most_open_chunks": int(counts.max()),
            "bands_with_most": len(full), "march_max_abs": march_err,
            "solve_plain_ms": f"{solve_plain:.1f}",
            "march_plain_ms": f"{march_plain:.1f}",
            "shade_plain_ms": f"{shade_plain:.1f}",
            "seconds": f"{time.perf_counter() - t0:.1f}"}


def oracle_fidelity(mvp, vgrid, uvgrid, texture, width, height, frames,
                    cull=None):
    """Each (H, W, 4) frame on ORACLE_ROWS evenly spaced rows against the
    float64 oracle (``raster_reference.rasterize_grid_rows``) -> phase
    fields: > 1 LSB and > 8 LSB shares, and the oracle's seconds."""
    from depthrenderer_tpu_torch.ops import raster_reference as ref

    rows = np.linspace(0, height - 1, ORACLE_ROWS).round().astype(int)
    oracle, ms = timed_ms(lambda: ref.rasterize_grid_rows(
        mvp.to(vgrid.device), vgrid, uvgrid, texture, width, height,
        rows.tolist(), cull))
    oracle = oracle.cpu().numpy()
    if not 0.3 < float((oracle[..., :3].max(-1) > 0).mean()) <= 1.0:
        raise AssertionError("the oracle's rows are mostly uncovered")
    fields = {"oracle_rows": len(rows), "oracle_s": f"{ms / 1e3:.1f}"}
    for name, frame in frames.items():
        _, off, flip = control_fidelity(frame[rows], oracle)
        fields[f"{name}_vs_oracle_off_more"] = f"{off:.6f}"
        fields[f"{name}_vs_oracle_flip"] = f"{flip:.6f}"
    return fields


def big_grid_path(dev, tmp):
    """Phase 8 at BASELINE preset 4 (4K/d12, edge cull 0.25): kernel times
    on frame 0 beside their bounds and each kernel against its twin there,
    render-only frames/s and peak memory, the CLI run with its launch
    counts, and frame 0 against the control and the float64 oracle."""
    from depthrenderer_tpu_torch import cli
    from depthrenderer_tpu_torch.ops import raster_grid as trg
    from depthrenderer_tpu_torch.ops import raster_scan as rs
    from depthrenderer_tpu_torch.render import clip_mvps
    from depthrenderer_tpu_torch.synthetic import synthetic_scene

    colour, depth = synthetic_scene(h=BIG_HEIGHT, w=BIG_WIDTH)
    t0 = time.perf_counter()
    mesh, projection, vgrid, uvgrid, texture = smoke_scene(colour, depth, dev,
                                                           BIG_DENSITY)
    mesh_s = time.perf_counter() - t0
    n = vgrid.shape[0]
    cfg = rs.suggest_scan_config(n, BIG_WIDTH, BIG_HEIGHT,
                                 edge_cull_threshold=EDGE_CULL)
    if not (cfg.big_grid and rs.scan_supported(n, cfg)):
        raise AssertionError(f"4K/d12 resolved to {cfg}")
    g = rs.ScanGeometry.of(BIG_WIDTH, BIG_HEIGHT, n, n, cfg)
    mvp = clip_mvps(projection, clip_views(1), mesh.transform)
    minv = rs.minv_rows(mvp)
    texq = rs.pack_texture(texture)
    torch.cuda.reset_peak_memory_stats()
    prep = rs.prep_scan(mvp.to(dev), vgrid, BIG_WIDTH, BIG_HEIGHT, cfg)
    args = (prep.win[0], prep.w0[0], prep.bounds[0])
    rec = rs.solve_records(*args, g, cfg)
    margs = args + (prep.canch[0], prep.mid[0], minv[0], g, cfg)
    att = rs.march_exact(rec, *margs)
    ms = {"solve": cuda_ms(lambda: rs.solve_records(*args, g, cfg), 5),
          "march": cuda_ms(lambda: rs.march_exact(rec, *margs), 5),
          "shade": cuda_ms(lambda: rs.shade(att, texq, g, cfg, "texture"),
                           20)}
    bounds = {k: bound(*v) for k, v in
              scan_bounds(prep, 0, g, cfg, texq).items()}
    covered = float(att[3, :BIG_HEIGHT, :BIG_WIDTH].mean())
    phase("big_grid_kernel_times", size=f"{BIG_WIDTH}x{BIG_HEIGHT}",
          density=BIG_DENSITY, edge_cull=EDGE_CULL,
          cfg=f"rmax{cfg.rmax}/cw{cfg.cw}/sr{cfg.sr}/colfix{cfg.colfix}",
          records_gb=f"{nbytes(rec) / 1e9:.3f}",
          covered_share=f"{covered:.4f}",
          **{f"{k}_ms": f"{v:.4f}" for k, v in ms.items()},
          **{f"{k}_bound_ms": f"{v[0]:.4f}" for k, v in bounds.items()},
          **{f"{k}_bound_by": v[1] for k, v in bounds.items()},
          mesh_s=f"{mesh_s:.1f}")
    if not 0.3 < covered <= 1.0:
        raise AssertionError(f"4K/d12 frame 0 covered share {covered:.3f}")
    phase("big_grid_kernels_vs_plain_4k", frame=0,
          **big_grid_twins(prep, rec, att, margs, texq, g, cfg))
    del prep, rec, att

    torch.cuda.reset_peak_memory_stats()
    fps = render_fps(mesh, projection, BIG_FRAMES, 16, BIG_WIDTH, BIG_HEIGHT,
                     edge_cull_threshold=EDGE_CULL)
    peak = torch.cuda.max_memory_allocated() / 2**30
    rs.reset_launch_counts()
    result = cli.render_scene(colour, depth, cli_args(
        tmp / "preset4", BIG_FRAMES, ["--edge-cull", str(EDGE_CULL)],
        BIG_DENSITY, BIG_WIDTH, BIG_HEIGHT))
    launches = dict(rs.LAUNCHES)
    if launches != {"solve": BIG_FRAMES, "march": BIG_FRAMES,
                    "shade": BIG_FRAMES}:
        raise AssertionError(f"preset 4: launches {launches} on the CLI run, "
                             f"expected {BIG_FRAMES} each")
    avi, png = check_outputs(result, BIG_FRAMES)
    phase("big_grid_path", frames=BIG_FRAMES, launches=json.dumps(launches),
          render_only_fps=f"{fps:.2f}", render_peak_gib=f"{peak:.2f}",
          incl_encode_fps=f"{BIG_FRAMES / result['seconds']:.2f}",
          avi_bytes=avi, sample_png_bytes=png)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    control, stats = trg.render_frame_grid_exact(
        mvp[0].to(dev), vgrid, uvgrid, texture, BIG_WIDTH, BIG_HEIGHT,
        strips=BIG_CONTROL_STRIPS, edge_cull_threshold=EDGE_CULL,
        with_stats=True)
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    raw, _ = rs.render_frames_scan(mvp, vgrid, uvgrid, texture, BIG_WIDTH,
                                   BIG_HEIGHT, cfg)
    frame = rs.unpack_raw_frames(raw.cpu(), BIG_WIDTH, BIG_HEIGHT)[0]
    fid = control_fidelity(frame, control)
    # Coverage apart from shading: holes (the control covers, the scan
    # does not) and the reverse.
    cov_s, cov_c = (f[..., :3].max(-1) > 0 for f in (frame, control))
    ccfg = stats["config"]
    phase("big_grid_control", frame=0, strips=stats["strips"],
          row_anchors=ccfg.row_anchors,
          window=f"{ccfg.window_rows}x{ccfg.window_cols}",
          seconds=f"{seconds:.2f}", peak_gib=f"{peak:.2f}",
          psnr_db=f"{fid[0]:.2f}", off_more_share=f"{fid[1]:.6f}",
          flip_share=f"{fid[2]:.6f}",
          hole_share=f"{float((cov_c & ~cov_s).mean()):.6f}",
          scan_only_share=f"{float((cov_s & ~cov_c).mean()):.6f}",
          **oracle_fidelity(mvp[0], vgrid, uvgrid, texture, BIG_WIDTH,
                            BIG_HEIGHT, {"scan": frame, "control": control},
                            EDGE_CULL))


def probe_cost(case, ins, out, trips):
    """(bytes, float32 operations) of one probe launch at ``trips``: inputs
    read once, the output written once; one add per lookup (gathers,
    roll), two operations per multiply-add (onehot_dot's dense one-hot
    product), a subtract and a multiply per (row, pixel, column) for
    march_top2, none for the transpose."""
    from depthrenderer_tpu_torch import probes

    moved = nbytes(*ins.values(), out)
    if case.kernel == "transpose":
        return moved, 0
    if case.kernel == "onehot_dot":
        return moved, 2 * probes.bound_work(case)[0] * trips
    if case.kernel == "march_top2":
        return moved, probes.bound_work(case)[0] * trips
    return moved, probes.lookups_per_trip(case) * trips


def probes_phase(dev):
    """Phase 9: the probe kernels against their twins, then the probes'
    runner over every case with the launch counters around it."""
    from depthrenderer_tpu_torch import probes
    from depthrenderer_tpu_torch.probes.__main__ import (check_case,
                                                         device_inputs, run)

    checked, errs = {}, dict.fromkeys(probes.KERNEL_NAMES, 0.0)
    for case in probes.CASES.values():
        ins = device_inputs(case, dev)
        res = check_case(case, ins)
        if not res["equal"]:
            raise AssertionError(f"probe {case.name}: kernel and twin differ "
                                 f"(max abs {res['max_abs_err']})")
        errs[case.kernel] = max(errs[case.kernel], res["max_abs_err"])
        checked[case.name] = (res, ins)
    phase("probes_vs_plain", cases=len(checked), all_equal=True,
          plain_s=f"{sum(r['plain_ms'] for r, _ in checked.values()) / 1e3:.2f}")

    probes.reset_launch_counts()
    timed = {r["name"]: r for r in run(list(probes.CASES.values()), "cuda",
                                       quick=True, check=False,
                                       reps=PROBE_REPS)}
    launches = dict(probes.LAUNCHES)
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"probe kernel {name} never launched on "
                                 "the probes' runner")
    out = {}
    for kernel, name in PROBE_KERNELS.items():
        case = probes.CASES[name]
        res, ins = checked[name]
        trips = res["check_trips"]
        moved, ops = probe_cost(case, ins,
                                probes.run_case(case, ins, trips), trips)
        b_ms, b_by = bound(moved, ops)
        out[kernel] = {"max_abs_err": errs[kernel], "ms": res["check_ms"],
                       "plain_ms": res["plain_ms"], "bound_ms": b_ms,
                       "bound_by": b_by,
                       "library_ms": timed[name].get("library_ms")}
    phase("probes", cases=len(timed), launches=json.dumps(launches),
          **{f"{k}_ms": f"{v['ms']:.4f}" for k, v in out.items()},
          **{f"{k}_bound_ms": f"{v['bound_ms']:.6f}" for k, v in out.items()})
    return out, launches


def kernel_table(results, launches):
    """The JSON kernel table: every kernel's source, the TPU kernel it
    replaces (the probe kernels: every experiments/ site of their cases),
    launches on the main path and this run's numbers."""
    from depthrenderer_tpu_torch import probes

    kernels = dict(KERNELS, **{
        k: ("depthrenderer_tpu_torch/csrc/probes.cu",
            ", ".join(sorted({c.site for c in probes.cases_of(k)})))
        for k in PROBE_KERNELS})

    def rounded(v, n):
        return None if v is None else round(v, n)

    return {"kernels": [
        {"name": name, "route": "cuda", "source": kernels[name][0],
         "replaces": kernels[name][1], "launches": launches[name],
         "max_abs_err": results[name]["max_abs_err"],
         "ms": rounded(results[name]["ms"], 6),
         "plain_ms": rounded(results[name]["plain_ms"], 3),
         "bound_ms": rounded(results[name]["bound_ms"], 6),
         "bound_by": results[name]["bound_by"],
         "library_ms": rounded(results[name].get("library_ms"), 6)}
        for name in kernels]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=300,
                    help="scan main-path frames (default: one 5 s sway loop)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2

    from depthrenderer_tpu_torch.ops import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda")
    seconds = {}

    # -- phase 1: environment and builds ---------------------------------
    t_all = time.perf_counter()
    card = nvidia_smi()
    print(card, flush=True)
    nvcc = subprocess.run([cuda_build.nvcc(), "--version"],
                          capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()
    builds = build_all()
    phase("env", card=repr(card), torch=torch.__version__,
          cuda=torch.version.cuda, nvcc=repr(nvcc[-1]),
          **{f"build_{k}_s": f"{v:.2f}" for k, v in builds.items()})
    seconds["env"] = time.perf_counter() - t_all

    from depthrenderer_tpu_torch.synthetic import synthetic_scene

    colour, depth = synthetic_scene()
    scene = smoke_scene(colour, depth, dev)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        results = scan_phase(scene, dev)
        seconds["scan_kernels"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        scan_launches = scan_main_path(colour, depth, scene, args.frames, tmp)
        seconds["main_path"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        tiled_cfg, group, results["pairs"] = tiled_phase(scene, dev)
        seconds["tiled_kernel"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        pair_launches = tiled_main_path(colour, depth, scene, tiled_cfg,
                                        group, tmp)
        seconds["tiled_path"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        control, scan_fid = control_phase(scene, tiled_cfg, dev)
        seconds["control"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        tiers_phase(colour, depth, scene, control, scan_fid, dev, tmp)
        seconds["tiers"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        big_grid_checks(colour, depth, scene, dev)
        seconds["big_grid_checks"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        big_grid_path(dev, tmp)
        seconds["big_grid_path"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        probe_results, probe_launches = probes_phase(dev)
        results.update(probe_results)
        seconds["probes"] = time.perf_counter() - t0
    phase("seconds", **{k: f"{v:.1f}" for k, v in seconds.items()},
          total=f"{time.perf_counter() - t_all:.1f}")

    launches = dict(scan_launches, pairs=pair_launches, **probe_launches)
    print(json.dumps(kernel_table(results, launches)), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
