"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--frames N]

Phases (each prints one line; any failure exits non-zero with its traceback):

1. ``env``: the card (nvidia-smi), torch, CUDA and nvcc versions; builds the
   scan kernels (csrc/scan.cu), the pair kernel (csrc/pair.cu), the JPEG
   kernels (csrc/jpeg.cu), one nvcc each, started together, and the native
   encoders (csrc/frameops.c) from the checkout, and prints each build's
   seconds.
2. ``kernels_vs_plain`` and ``kernel_times``: the scan kernels against their
   plain PyTorch twins on a seeded synthetic 640x480 colour + depth scene at
   mesh density 10 rendered at 1920x1080 with the shipped scan config, two
   sway frames: records equal, at least 99.9% of output pixels byte-identical
   (the rest at most 1 LSB, or a depth-tie flip). Each kernel is timed with
   CUDA events beside its plain twin (the shade, whose device time is below
   its wrapper's host cost, by the slope between CUDA graphs of 20 and 40
   launches, beside ``F.grid_sample`` timed the same way: its library
   call); ptxas's report of the march's instances and of the solve kernel
   (registers, spill and stack bytes).
3. ``main_path``: ``cli.render_scene`` (the scan) on the same arrays for one
   sway loop (300 frames at 60 fps) into an MJPG AVI (its frames encoded on
   the card) and ``sample_frame.png``, with the launch counters set to 0
   just before and read just after: every scan and JPEG kernel launched.
   ``jpeg_vs_host``: one 16-frame group of the same clip in the scan's raw
   layout through the JPEG kernels: the coefficients equal the twin's
   (``jpeg.coefficients_plain``), each frame's payload
   ``native.jpeg_encode``'s byte for byte; the group's time (CUDA events,
   20 groups) against its bound (the RGBA read once and the JPEG written
   once) and the host encoder's, and ptxas's report of the six kernels.
4. ``tiled_kernel_vs_plain``: the pair kernel (on the group's plane
   tables) against ``raster_pairs_plain`` (on the windows gathered out of
   them, frame by frame) on the first kernel launch of the tiled CLI run
   below, as that run makes it: the config ``render_clip`` measures from the
   run's 32 views (``measured_config(q=0.995, anchors=1)`` over frames 0, 15
   and 31), its first frame group. Tile rows equal bit for bit, frames at
   the scan's bar; kernel, plain twin and prep times, active pairs, table
   and read bytes a frame, peak memory and ptxas's report of
   ``pair_kernel``.
5. ``tiled_path``: ``render_clip(impl="pallas")`` render-only frames/s over
   64 frames after one warm-up group, then ``cli.render_scene --impl pallas``
   over 32 frames into an MJPG AVI, with the pair kernel's launch counter set
   to 0 just before and read just after; the count must be the number of
   frame groups of the checked config. Then the same clip through
   ``render_clip`` with each launch's rows held against the twin on 16
   kernel tiles of every frame (``PairCheck``, bit for bit).
   ``d13_fallback_path``: ``cli.render_scene -mesh-density 13`` (auto
   impl, the default ``--frame-batch``) at 1080p over 4 frames: past the
   scan's budget it must log the reference's NOTICE and render through the
   tiled route, the pair kernel launched and no scan kernel (launch
   counters set to 0 before, read after); whether the tiled route warned
   that its window drops candidates is printed, and the peak device
   memory; then the route's frames in the default group (each launch's rows
   on sampled tiles against the twin) equal those at one frame a group,
   byte for byte.
6. ``control``: ``render_frame_grid_exact`` (the lossless control, grid
   route, 2 strips as bench.py renders 1080p/d10) at sway frame 0, each pair
   kernel launch's rows on sampled tiles against the twin: its row
   anchors and seconds, and the PSNR, the share of pixels off by more than 1
   LSB and the share off by more than 8 LSB (bench.py's flips) of the scan
   frame and of the tiled frame against it; the scan frame and the control
   on 16 evenly spaced rows against the float64 oracle
   (``ops/raster_reference.rasterize_grid_rows``): shares > 1 and > 8 LSB.
   ``straddle_control``: the close pose ``translation(dz=-3) @ rotation(20
   degrees, Y)`` of the same scene, where triangles straddle the camera
   plane: their count (the phase fails at 0), the host clip's seconds and
   the clipped soup's triangles, the soup (``raster_soup.rasterize_soup``,
   texture_z) with its seconds and peak memory against the float64 soup
   oracle on the card (``raster_reference.rasterize_reference``; limit:
   <= 3 % of pixels off by more than 8 LSB, >= 30 dB on the rest, the JAX
   package's bar), the composed control (anchors, window, seconds, each
   pair launch's rows on sampled tiles against the twin) and the share of
   pixels its soup takes in the depth merge (> 0); reported: the control
   and the scan against the clip-aware row oracle on 16 rows, and the scan
   and tiled frames against the control (both mask the straddlers).
   ``straddle_control_inside``: the same at mesh density 6 with the camera
   inside the relief (dz -1.5), where the soup must take pixels.
   ``mesh_renderer``: ``MeshRenderer`` on the d10 grid, ``run(max_frames=
   32)`` with the sway advanced in ``on_update``: frames byte-identical to
   ``render_clip``'s for the same views, ``solve``, ``march`` and ``shade``
   launched 32 times each (counters set to 0 just before the loop, read
   just after), frames/s; then a mesh that is not a grid (the d6 mesh's
   arrays, 8,192 triangles) through the soup for 4 frames: seconds a frame,
   peak memory, its first frame against ``render_frame_grid_exact`` of the
   d6 grid (limit: >= 45 dB on the pixels within 8 LSB, <= 1 % beyond).
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
   as bench.py renders 4K/d12 (PSNR, shares, holes; each pair kernel
   launch's rows on sampled tiles against the twin), then the scan frame
   and that control on 16 rows against the float64 oracle.

9. ``probes``: the probe kernels of ``csrc/probes.cu`` (the TPU probes of
   ``experiments/``, ROADMAP K3). ``probes_vs_plain``: every case of
   ``depthrenderer_tpu_torch.probes`` (40), kernel against twin bit for bit
   at the case's check trip count (onehot_dot also with 3 copies). Then
   the launch counters are set to 0 and ``python -m
   depthrenderer_tpu_torch.probes``'s runner times every case (one
   ``[probe]`` line each: ns per lookup from the slope between two trip
   counts, lookups/s, blocks, SMs and the bound) with ``--quick``:
   it skips the two long counts, gather_probe9's 65,536 trips (timed at
   2,048 and 8,192) and gather_probe10's 65,536 (its 1,024 / 8,192 pair
   gives the slope); every kernel must have launched. For the JSON line
   each kernel's numbers are one case's at its check trips: gather_accum
   ``gp1_lane`` (gather_probe.py's lane gather, 256 trips), roll_accum
   ``gp5_roll``, onehot_dot ``gp1_onehot``, transpose ``spm_p1_transpose``
   (it timed from launches captured in CUDA graphs of two sizes, without
   the host's launch cost or the graph's), march_top2 ``spm_p2_march``.
   Their library calls are timed the same way, from graphs of 20 and 40
   calls: the transpose's ``x.t().contiguous()``, a trip of onehot_dot as
   ``torch.matmul`` of the prebuilt float32 one-hot by the table (full
   float32), a set of roll_accum as ``torch.roll``; the JSON's
   ``library_ms`` is that call's time times the calls of the check launch
   (its trips; times the 64 sets for the roll). The ``probes`` line also
   gives each of those cases' slope over its stated bound (``*_x``: the
   runner's ``x_stated``) and over its library call (``*_x_library``).
10. The farm and the rest of the surface. ``batch_path``: ``batch.run_farm``
   (``python -m depthrenderer_tpu_torch.batch``) at its defaults on the
   synthetic 640x480 image: mesh density 8, 60 fps, one sway loop (300
   frames) a model, four models (``ground_truth``, the synthetic depth,
   and three made with ``utils.overlay_noise`` at scales 32, 16 and 8,
   seeds 1-3); three runs, sequential, ``--sharded --readback yuv420``
   and ``--sharded --readback rgba`` (only the last with the
   post-processing), each with the launch counters set to 0 before and
   read after (``solve``, ``march``, ``shade`` each 4 x 300): frames/s
   incl. encode, the sequential and sharded-rgba AVIs byte-identical per
   model, the YUV run decoded against the rgba run (least PSNR, >= 40 dB,
   and max abs), the mosaic, concat and paired videos' frame counts and
   ``evaluate.compare_videos(ground_truth, model)``'s mean masked PSNR.
   Before the runs, ``batch_kernels_vs_plain``: each model's solve, march
   and shade at the farm's shapes and config on the loop's frames 0 and
   150 against the plain twins (max abs 0) and equal to
   ``render_frames_scan``'s frames; ``batch_dispatch_no_wait``: one
   16-view chunk of the sharded farm's dispatch for every model
   (``render_scenes_sharded`` and the YUV pack) under
   ``torch.cuda.set_sync_debug_mode("error")``, so nothing in it waits for
   the card, with its host ms beside the ms until the card is done.
   ``yuv_pack_vs_cpu``: ``io.rgba_to_yuv420`` of 16 farm frames on the card
   against the CPU's, byte for byte, its ms a frame beside its bound (4
   bytes read and 1.5 written a pixel at 3.35 TB/s).
   ``tiers_quality_wireframe``: the quality tier's wireframe at 1080p/d10
   on sway frame 74: each pass's march with the sixth attrs plane (``ml /
   ar``) against its twin (max abs 0), its ms beside the raster-z
   instance's, the twin's and the bound; the merged, wire-tested and shaded
   frame against the twin chain's and ``render_frames_scan``'s (equal);
   then 32 frames of ``cli.render_scene --quality --mode wireframe``
   (launches: ``solve`` and ``march`` 2 x frames, ``shade`` = frames: the
   merged attrs shade once). ``cli_mp4_noise``: 32 frames of
   ``--container mp4 --overlay-noise 32 16 8`` beside the same run into
   an AVI: the MP4's frame count (``video.read_mp4_info``) and, remuxed
   (no ffmpeg), its JPEG samples equal to the AVI's payloads.

Each kernel's ``bound_ms`` is the larger of the bytes it must move (inputs
read once, outputs written once) over 3.35 TB/s and the operations this
run's data needs over 67 TFLOP/s (float32 outside the tensor cores), the
H100 SXM's published peaks (the pair kernel: ``march_times.pair_bounds``,
12 operations an active pair); onehot_dot's operations are the
multiply-adds of its three bf16 parts (``probes.bound_work``, the count
the runner's bound reads) over the tensor cores' 989 TFLOP/s (bf16,
dense). The second-to-last line is the kernel table as
JSON, the last line ``{"ok": true, "device": {...}}``. Without a CUDA device
it exits 2 and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import re
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
# Past the scan's budget: the d13 CLI run, which falls back to the tiled
# route as the reference does.
D13_DENSITY, D13_FRAMES = 13, 4
# Bands of the 4K/d12 march twin, and pixel rows of the float64 oracle.
MARCH_BANDS, ORACLE_ROWS = 6, 16
# The control's strips at 1080p/d10, as bench.py renders it; a "flip" is a
# pixel off by more than 8 LSB, bench.py's winner-flip measure.
CONTROL_STRIPS = 2
# The straddling poses (translation dz, yaw in degrees): the close view of
# the d10 scene, and the camera inside the d6 scene's relief; the
# MeshRenderer phase's loop frames and soup-route frames (mesh density 6).
STRADDLE_POSE, INSIDE_POSE = (-3.0, 20.0), (-1.5, 0.0)
RENDERER_FRAMES, SOUP_FRAMES, SOUP_DENSITY = 32, 4, 6
# The batch farm at its defaults on the 640x480 synthetic scene: mesh
# density 8, one sway loop at 60 fps (int(60 / (0.5 / 2.5)) = 300 frames) a
# model; the three noised models' Perlin (scale, seed).
FARM_DENSITY, FARM_FRAMES = 8, 300
FARM_NOISE = ((32, 1), (16, 2), (8, 3))
# The farm frames whose kernels are held against the twins (the loop's first
# and middle frames), and the views of the sharded dispatch that must not
# wait for the card (one chunk at the default --frame-batch).
FARM_CHECK_FRAMES, FARM_CHUNK = (0, FARM_FRAMES // 2), 16
# Kernel tiles of every frame that each pair kernel launch of a phase holds
# against the twin (half the busiest, half evenly spaced).
PAIR_SAMPLE = 16
KERNELS = {
    "solve": ("depthrenderer_tpu_torch/csrc/scan.cu",
              "depthrenderer_tpu/ops/raster_scan.py:815"),
    "march": ("depthrenderer_tpu_torch/csrc/scan.cu",
              "depthrenderer_tpu/ops/raster_scan.py:815"),
    "shade": ("depthrenderer_tpu_torch/csrc/scan.cu",
              "depthrenderer_tpu/ops/raster_scan.py:815"),
    "pairs": ("depthrenderer_tpu_torch/csrc/pair.cu",
              "depthrenderer_tpu/ops/raster_pallas.py:184"),
    # The six launches of a frame group, as one entry.
    "jpeg": ("depthrenderer_tpu_torch/csrc/jpeg.cu",
             "none: the JAX package encodes on the host "
             "(depthrenderer_tpu_torch/csrc/frameops.c:386)"),
}
# Frames of the JPEG phase's group: the main path's frame batch.
JPEG_GROUP = 16
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
    from depthrenderer_tpu_torch.ops import jpeg
    from depthrenderer_tpu_torch.ops import raster_scan as rs
    from depthrenderer_tpu_torch.ops import tiled

    def timed(fn):
        t0 = time.perf_counter()
        fn(force=True)
        return time.perf_counter() - t0

    jobs = {"scan": rs.build_kernels, "pair": tiled.build_kernels,
            "probes": probes.build_kernels, "jpeg": jpeg.build_kernels,
            "frameops": native.build}
    with ThreadPoolExecutor(len(jobs)) as ex:
        futures = {k: ex.submit(timed, fn) for k, fn in jobs.items()}
        return {k: f.result() for k, f in futures.items()}


def march_ptxas_fields(big):
    """The march kernel's block shape and ptxas's report (registers, bytes
    of spill stores and of stack) of its instances of one variant
    (big_grid or standard), keyed by edge cull and wireframe."""
    from depthrenderer_tpu_torch.ops import raster_scan as rs

    threads, pixels = rs.march_shape()
    fields = {"block": f"{threads}_threads_x_{pixels}_pixels"}
    for name, u in rs.kernel_ptxas("march").items():
        big_i, cull, wire = (f == "true" for f in
                             name[name.index("<") + 1:-1].split(", "))
        if big_i == big:
            fields[f"cull{int(cull)}_wire{int(wire)}"] = (
                f"{u['registers']}regs/{u['spill_stores']}B_spill/"
                f"{u['stack']}B_stack")
    return fields


def solve_ptxas_fields():
    """ptxas's report of the solve kernel: registers, bytes of spill
    stores, of stack and of shared memory."""
    from depthrenderer_tpu_torch.ops import raster_scan as rs

    return {name.replace(" ", ""): (
        f"{u['registers']}regs/{u['spill_stores']}B_spill/{u['stack']}"
        f"B_stack/{u['smem']}B_smem")
        for name, u in rs.kernel_ptxas("solve").items()}


def pair_ptxas_fields():
    """ptxas's report of the pair kernel (registers, bytes of spill stores,
    of stack and of static shared memory)."""
    from depthrenderer_tpu_torch.ops import cuda_build

    u = cuda_build.ptxas_usage(cuda_build.library_path("pair.cu"))[
        "pair_kernel"]
    return {"pair_ptxas": f"{u['registers']}regs/{u['spill_stores']}B_spill/"
                          f"{u['stack']}B_stack/{u['smem']}B_smem"}


def rows_equal(a, b):
    """Tile rows equal bit for bit (float32 compared as int32)."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


class PairCheck:
    """While a phase runs, every pair kernel launch's tile rows on
    PAIR_SAMPLE kernel tiles of each frame (half of frame 0's busiest, half
    evenly spaced; the same tiles in every frame) against the plain twin on
    the windows gathered out of the tables, bit for bit. The twin's seconds
    are kept apart (``seconds``), so a phase can leave them out of its own
    time."""

    def __init__(self):
        self.launches = self.tiles = 0
        self.seconds = 0.0

    def __enter__(self):
        from depthrenderer_tpu_torch.ops import tiled

        self.module, self.kernel = tiled, tiled.raster_pairs
        tiled.raster_pairs = self
        return self

    def __exit__(self, *exc):
        self.module.raster_pairs = self.kernel

    def __call__(self, *args):
        from depthrenderer_tpu_torch.march_times import (_frame_tiles,
                                                          twin_rows)

        rows = self.kernel(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        planes, height, cfg = args[:8], args[8], args[9]
        frames, m, _ = _frame_tiles(planes)
        work = (planes[7] - planes[6])[:m].long()
        k = min(PAIR_SAMPLE // 2, m)
        sel = torch.unique(torch.cat([
            torch.topk(work, k).indices,
            torch.linspace(0, m - 1, k, device=work.device).round().long()]))
        want = twin_rows(planes, height, cfg, sel)
        idx = torch.cat([f * m + sel for f in range(frames)])
        if not rows_equal(rows[idx], want):
            bad = int((rows[idx] != want).sum())
            raise AssertionError(f"{bad} tile-row values differ between the "
                                 "pair kernel and its twin")
        self.launches += 1
        self.tiles += idx.numel()
        torch.cuda.synchronize()
        self.seconds += time.perf_counter() - t0
        return rows

    def fields(self):
        if self.launches == 0:
            raise AssertionError("no pair kernel launch was checked")
        return {"pair_rows_equal": True,
                "pair_checked": f"{self.launches}launches/"
                                f"{self.tiles}tiles"}


def scan_phase(scene, dev):
    """Phase 2: the scan kernels against their plain twins at 1080p/d10."""
    from depthrenderer_tpu_torch import animation, transforms
    from depthrenderer_tpu_torch.march_times import (bound, grid_sample_call,
                                                      scan_bounds)
    from depthrenderer_tpu_torch.ops import raster_scan as rs
    from depthrenderer_tpu_torch.probes.__main__ import graph_ms
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
        # The shade's ~0.02 ms is below the wrapper's host cost: its device
        # time is the slope between CUDA graphs of 20 and 40 launches.
        "shade": (graph_ms(lambda: rs.shade(att, texq, g, cfg, "texture"),
                           20),
                  wall_ms(lambda: rs.shade_plain(att, texq, *texq.shape,
                                                 "texture"))),
    }
    shade_stream_ms = cuda_ms(lambda: rs.shade(att, texq, g, cfg, "texture"),
                              50)
    library = {"shade": graph_ms(grid_sample_call(att, texq), 20)}
    prep_ms = cuda_ms(lambda: rs.prep_scan(mvps.to(dev), vgrid, WIDTH, HEIGHT,
                                           cfg), 5) / mvps.shape[0]
    bounds = {k: bound(*v) for k, v in
              scan_bounds(prep, 0, g, cfg, texq).items()}
    phase("kernel_times", **{f"{k}_ms": f"{v[0]:.4f}" for k, v in ms.items()},
          **{f"{k}_plain_ms": f"{v[1]:.2f}" for k, v in ms.items()},
          **{f"{k}_bound_ms": f"{v[0]:.4f}" for k, v in bounds.items()},
          shade_timing="graph_slope_20_40",
          shade_stream_ms=f"{shade_stream_ms:.4f}",
          shade_library_ms=f"{library['shade']:.4f}",
          prep_ms_per_frame=f"{prep_ms:.3f}",
          kernels_ms_per_frame=f"{sum(v[0] for v in ms.values()):.3f}",
          plain_ms_per_frame=f"{sum(v[1] for v in ms.values()):.1f}")
    phase("kernel_times_march_ptxas", **march_ptxas_fields(big=False))
    phase("kernel_times_solve_ptxas", **solve_ptxas_fields())
    errs = {"solve": max(stats["solve"]), "march": max(stats["march"]),
            "shade": float(max(stats["shade"]))}
    return {k: {"max_abs_err": errs[k], "ms": ms[k][0], "plain_ms": ms[k][1],
                "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
                "library_ms": library.get(k)}
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
    from depthrenderer_tpu_torch.ops import jpeg
    from depthrenderer_tpu_torch.ops import raster_scan as rs

    mesh, projection = scene[:2]
    fps = render_fps(mesh, projection, frames, 16)
    rs.reset_launch_counts()
    jpeg.reset_launch_counts()
    result = cli.render_scene(colour, depth, cli_args(tmp / "scan", frames))
    launches = {**rs.LAUNCHES,
                **{f"jpeg_{k}": v for k, v in jpeg.LAUNCHES.items()}}
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


def jpeg_phase(scene, dev):
    """Phase 3b: the JPEG kernels on one frame group of the main path (the
    scan's raw layout, the CLI's config and quality) against the host: the
    coefficients equal the twin's, each payload ``native.jpeg_encode``'s;
    the group timed with CUDA events beside the host encoder."""
    from depthrenderer_tpu_torch import native
    from depthrenderer_tpu_torch.march_times import bound
    from depthrenderer_tpu_torch.ops import cuda_build, jpeg
    from depthrenderer_tpu_torch.ops import raster_scan as rs
    from depthrenderer_tpu_torch.render import clip_mvps, clip_scan_config
    from depthrenderer_tpu_torch.video import JPEG_QUALITY

    mesh, projection, vgrid, _, texture = scene
    mvps = clip_mvps(projection, clip_views(300)[:JPEG_GROUP],
                     mesh.transform)
    cfg = clip_scan_config(vgrid.shape[0], WIDTH, HEIGHT)
    raw, _ = rs.render_frames_scan(mvps, vgrid, None, texture, WIDTH, HEIGHT,
                                   cfg, "texture", frame_batch=JPEG_GROUP)
    enc = jpeg.Encoder(JPEG_GROUP, WIDTH, HEIGHT)
    out = torch.empty(enc.out_bytes(JPEG_GROUP), dtype=torch.uint8,
                      device=dev)
    offsets, _ = enc.encode(raw, out)
    o = offsets.tolist()
    data = out[:o[-1]].cpu().numpy()
    host = rs.unpack_raw_frames(raw.cpu(), WIDTH, HEIGHT)
    coef = enc.scratch(dev)["coef"].cpu().numpy()
    twin = jpeg.coefficients_plain(host, jpeg.tables(JPEG_QUALITY))
    if not np.array_equal(coef, twin):
        raise AssertionError(f"{int((coef != twin).sum())} coefficients "
                             "differ between the JPEG kernels and the twin")
    t0 = time.perf_counter()
    want = [native.jpeg_encode(f[..., :3], JPEG_QUALITY) for f in host]
    host_ms = (time.perf_counter() - t0) * 1e3
    bad = [k for k in range(JPEG_GROUP)
           if data[o[k]:o[k + 1]].tobytes() != want[k]]
    if bad:
        raise AssertionError(f"frames {bad} of the group: the card's JPEG "
                             "differs from native.jpeg_encode's")
    ms = cuda_ms(lambda: enc.encode(raw, out), 20)
    bound_ms, bound_by = bound(JPEG_GROUP * WIDTH * HEIGHT * 4 + o[-1], 0)
    usage = cuda_build.ptxas_usage(cuda_build.library_path("jpeg.cu"))
    phase("jpeg_vs_host", frames=JPEG_GROUP, payloads_equal=True,
          coefficients_equal=True, jpeg_bytes=o[-1],
          ms_per_group=f"{ms:.4f}", bound_ms=f"{bound_ms:.4f}",
          host_ms_per_group=f"{host_ms:.1f}",
          **{m.group(0): f"{u['registers']}regs/{u['spill_stores']}B_spill/"
                         f"{u['stack']}B_stack/{u['smem']}B_smem"
             for k, u in usage.items()
             if (m := re.search(r"jpeg_[a-z]+_kernel", k))})
    # No library JPEG encoder is installed beside PyTorch on the card.
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": host_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def tiled_phase(scene, dev):
    """Phase 4: the pair kernel against its plain twin on the tiled CLI
    run's first kernel launch: the config ``render_clip`` measures from that
    run's views, its first frame group -> (config, group, kernel fields)."""
    from depthrenderer_tpu_torch import cli
    from depthrenderer_tpu_torch.march_times import (bound, pair_bounds,
                                                      twin_rows)
    from depthrenderer_tpu_torch.ops import raster_grid as trg
    from depthrenderer_tpu_torch.ops import raster_pallas as trp
    from depthrenderer_tpu_torch.ops import tiled
    from depthrenderer_tpu_torch.render import clip_mvps, tiled_config

    mesh, projection, vgrid, uvgrid, texture = scene
    n = vgrid.shape[0]
    # render_clip's own steps on the CLI run's views (default quantile).
    mvps = clip_mvps(projection, clip_views(TILED_FRAMES),
                     mesh.transform).to(dev)
    cfg = tiled_config(mvps, vgrid, uvgrid, WIDTH, HEIGHT)
    group = trg.frame_group(n, n, cfg,
                            cli.build_parser().get_default("frame_batch"))
    first = mvps[:group]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    planes = trp._prep_stage_batched(first, vgrid, uvgrid, WIDTH, HEIGHT, cfg)
    rows_k = tiled.raster_pairs(*planes, HEIGHT, cfg)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    t0 = time.perf_counter()
    rows_p = twin_rows(planes, HEIGHT, cfg)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    max_abs = float((rows_k - rows_p).abs().max())
    if not rows_equal(rows_k, rows_p):
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
    tc = planes[3].shape[1]
    kernel_ms = cuda_ms(lambda: tiled.raster_pairs(*planes, HEIGHT, cfg), 3)
    del planes, rows_k
    prep_ms = cuda_ms(lambda: trp._prep_stage_batched(
        first, vgrid, uvgrid, WIDTH, HEIGHT, cfg), 2) / group
    planes = trp._prep_stage_batched(first, vgrid, uvgrid, WIDTH, HEIGHT, cfg)
    moved, ops, pairs = pair_bounds(planes, cfg)
    bound_ms, bound_by = bound(moved, ops)
    table_gb = trg.table_bytes_per_frame(n, n, cfg) / 1e9
    phase("tiled_kernel_vs_plain", frames=group, **config_fields(cfg),
          rows_equal=True, identical_share=f"{same:.6f}",
          off_more_share=f"{more:.6f}", pairs_ms=f"{kernel_ms:.4f}",
          pairs_ms_per_frame=f"{kernel_ms / group:.4f}",
          pairs_plain_ms=f"{plain_ms:.1f}",
          pairs_bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
          bound_share=f"{bound_ms / kernel_ms:.4f}",
          prep_ms_per_frame=f"{prep_ms:.3f}",
          active_pairs_per_frame=pairs // group,
          table_gb_per_frame=f"{table_gb:.3f}",
          read_gb_per_frame=f"{moved / group / 1e9:.3f}",
          peak_gib=f"{peak:.2f}", dyn_smem_bytes=2 * 3 * tc * 16,
          **pair_ptxas_fields())
    del planes
    return cfg, group, {"max_abs_err": max_abs, "ms": kernel_ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": None}


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
    from depthrenderer_tpu_torch.render import render_clip

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
    # The same clip again through render_clip, each launch's rows held
    # against the twin (outside the timed runs).
    with PairCheck() as check:
        render_clip(mesh, projection, clip_views(TILED_FRAMES), WIDTH, HEIGHT,
                    on_frames=lambda s, f: None, device="cuda", impl="pallas")
    phase("tiled_path", render_frames=TILED_RENDER_FRAMES,
          render_only_fps=f"{fps:.2f}", render_peak_gib=f"{peak:.2f}",
          frames=TILED_FRAMES, **config_fields(cfg), group=group,
          launches=json.dumps({"pairs": launches}),
          incl_encode_fps=f"{TILED_FRAMES / result['seconds']:.2f}",
          avi_bytes=avi, sample_png_bytes=png, **check.fields())
    return launches


def d13_path(colour, depth, tmp):
    """Phase 5, continued: ``-mesh-density 13`` at 1080p through
    ``cli.render_scene`` at the CLI's default ``--frame-batch`` (auto
    impl). Past the scan's budget the CLI must log the reference's NOTICE
    and render through the tiled route on the card: the pair kernel
    launched, no scan kernel; the tiled route's own window warning, if any,
    is reported, and the run's peak device memory. A group holds its
    frames' full-grid plane tables (~12.9 GB a frame at d13), which the pair
    kernel reads in place. Then the same frames through the route's
    ``render_frames_pallas`` at the config ``render_clip`` measures, at the
    default frame batch (a group of more than one frame; each launch's rows
    on sampled tiles against the twin) and at one frame a group: byte for
    byte equal."""
    from depthrenderer_tpu_torch import cli
    from depthrenderer_tpu_torch.ops import raster_grid as trg
    from depthrenderer_tpu_torch.ops import raster_pallas as trp
    from depthrenderer_tpu_torch.ops import raster_scan as rs
    from depthrenderer_tpu_torch.ops import tiled
    from depthrenderer_tpu_torch.render import clip_mvps, tiled_config

    fb = cli.build_parser().get_default("frame_batch")
    torch.cuda.reset_peak_memory_stats()
    rs.reset_launch_counts()
    tiled.reset_launch_counts()
    captured = io.StringIO()
    with contextlib.redirect_stdout(captured):
        result = cli.render_scene(colour, depth, cli_args(
            tmp / "d13", D13_FRAMES, density=D13_DENSITY))
    log_text = captured.getvalue()
    print(log_text, end="", flush=True)
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = dict(rs.LAUNCHES, **tiled.LAUNCHES)
    notice = ("NOTICE: grid n=8193 exceeds the scan kernel's VMEM window "
              "budget; falling back to the tiled path" in log_text)
    if not notice:
        raise AssertionError("d13: the CLI did not log the fallback NOTICE")
    if launches["pairs"] <= 0 or any(launches[k] for k in rs.LAUNCHES):
        raise AssertionError(f"d13: launches {launches}; expected the pair "
                             "kernel only")
    avi, png = check_outputs(result, D13_FRAMES)

    dev = torch.device("cuda")
    mesh, projection, vgrid, uvgrid, texture = smoke_scene(
        colour, depth, dev, density=D13_DENSITY)
    mvps = clip_mvps(projection, clip_views(D13_FRAMES), mesh.transform).to(
        dev)
    with contextlib.redirect_stdout(io.StringIO()):
        cfg = tiled_config(mvps, vgrid, uvgrid, WIDTH, HEIGHT)
    group = trg.frame_group(vgrid.shape[0], vgrid.shape[1], cfg, fb)
    if min(group, D13_FRAMES) < 2:
        raise AssertionError(f"d13: a group of {group} frame(s) at the "
                             f"default --frame-batch {fb}")
    torch.cuda.reset_peak_memory_stats()
    with PairCheck() as check:
        frames = {fb: trp.render_frames_pallas(
            mvps, vgrid, uvgrid, texture, WIDTH, HEIGHT, cfg,
            frame_batch=fb)}
    group_peak = torch.cuda.max_memory_allocated() / 2**30
    frames[1] = trp.render_frames_pallas(mvps, vgrid, uvgrid, texture, WIDTH,
                                         HEIGHT, cfg, frame_batch=1)
    table_gb = trg.table_bytes_per_frame(vgrid.shape[0], vgrid.shape[1],
                                         cfg) / 1e9
    if not torch.equal(frames[fb], frames[1]):
        bad = int((frames[fb] != frames[1]).any(-1).sum())
        raise AssertionError(f"d13: {bad} pixels differ between groups of "
                             f"{group} frames and of one")
    phase("d13_fallback_path", density=D13_DENSITY,
          size=f"{WIDTH}x{HEIGHT}", frames=D13_FRAMES, frame_batch=fb,
          group=group, notice=notice, launches=json.dumps(launches),
          window_warning="WARNING:" in log_text, peak_gib=f"{peak:.2f}",
          group_peak_gib=f"{group_peak:.2f}",
          table_gb_per_frame=f"{table_gb:.3f}",
          incl_encode_fps=f"{D13_FRAMES / result['seconds']:.3f}",
          frames_equal_batch1=True, avi_bytes=avi, sample_png_bytes=png,
          **check.fields())


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
    with PairCheck() as check:
        control, stats = trg.render_frame_grid_exact(
            mvps[0].to(dev), vgrid, uvgrid, texture, WIDTH, HEIGHT,
            strips=CONTROL_STRIPS, with_stats=True)
    seconds = time.perf_counter() - t0 - check.seconds
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
          strips=stats["strips"], seconds=f"{seconds:.2f}", **check.fields(),
          peak_gib=f"{peak:.2f}", covered_share=f"{covered:.4f}", **fields,
          **oracle_fidelity(mvps[0], vgrid, uvgrid, texture, WIDTH, HEIGHT,
                            {"scan": scan, "control": control}))
    return control, fid["scan"]


def close_mvp(mesh, projection, dz, yaw_deg):
    """``projection @ translation(dz) @ rotation(yaw, Y) @ model`` on the
    host, as ``render_clip`` forms its MVPs."""
    from depthrenderer_tpu_torch import transforms as tt
    from depthrenderer_tpu_torch.render import clip_mvps

    view = tt.matmul(tt.translation(dz=dz),
                     tt.rotation(np.deg2rad(yaw_deg), axis=tt.Axis.Y))
    return clip_mvps(projection, view[None], mesh.transform)[0]


def soup_vs_oracle(sv, suv, sidx, mvp, texture, dev):
    """The clipped straddler soup through ``rasterize_soup`` (texture_z)
    and the float64 oracle on the card -> ((rgba, z), fields): seconds,
    peak GiB, covered share, and the oracle bar's numbers (the share of
    pixels off by more than 8 LSB and the PSNR of the rest)."""
    from depthrenderer_tpu_torch.ops import common
    from depthrenderer_tpu_torch.ops import raster_reference as ref
    from depthrenderer_tpu_torch.ops import raster_soup
    from depthrenderer_tpu_torch.utils import psnr

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    soup, soup_ms = timed_ms(lambda: raster_soup.rasterize_soup(
        torch.from_numpy(sv).to(dev), suv, sidx, mvp, texture, WIDTH, HEIGHT,
        mode="texture_z"))
    peak = torch.cuda.max_memory_allocated() / 2**30
    oracle, oracle_ms = timed_ms(lambda: ref.rasterize_reference(
        torch.from_numpy(sv).to(dev), suv, sidx, mvp, texture, WIDTH,
        HEIGHT))
    got, want = soup[0].cpu().numpy(), oracle.cpu().numpy()
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32)).max(-1)
    flips = float((diff > 8).mean())
    rest = psnr(got[diff <= 8], want[diff <= 8])
    covered = float((soup[1] < common.FAR_SENTINEL).float().mean())
    return soup, flips, rest, {
        "soup_s": f"{soup_ms / 1e3:.2f}", "soup_peak_gib": f"{peak:.2f}",
        "soup_covered_share": f"{covered:.6f}",
        "soup_oracle_s": f"{oracle_ms / 1e3:.2f}",
        "soup_vs_oracle_flip_share": f"{flips:.6f}",
        "soup_vs_oracle_psnr_db": f"{rest:.2f}"}


def straddle_phase(scene, scene6, dev):
    """Phase 6b: the lossless control at a pose where triangles straddle the
    camera plane (1080p/d10, ``translation(dz=-3) @ rotation(20 degrees,
    Y)``): the straddler count (> 0), the host clip's seconds and the
    clipped soup, the soup against the float64 oracle on the card (>= 30 dB
    on the pixels within 8 LSB, <= 3 % beyond), the composed control (each
    pair launch's rows on sampled tiles against the twin) and the share of
    pixels the soup wins in its merge (> 0); reported: the control against the
    clip-aware row oracle on 16 rows, and the scan and tiled frames at this
    pose against the control. Then the d6 mesh with the camera inside the
    scene's relief (dz=-1.5, no yaw), where the soup must win pixels in the
    merge, at the same soup-against-oracle bar."""
    from depthrenderer_tpu_torch.ops import raster_grid as trg
    from depthrenderer_tpu_torch.ops import raster_pallas as trp
    from depthrenderer_tpu_torch.ops import raster_scan as rs
    from depthrenderer_tpu_torch.render import tiled_config

    mesh, projection, vgrid, uvgrid, texture = scene
    n = vgrid.shape[0]
    mvp = close_mvp(mesh, projection, *STRADDLE_POSE)
    tris = trg.straddlers(mvp, vgrid)
    if len(tris) == 0:
        raise AssertionError("no triangle straddles the camera plane")
    (sv, suv, sidx), clip_ms = timed_ms(
        lambda: trg.straddler_soup(tris, vgrid, uvgrid, mvp))
    _, flips, rest, fields = soup_vs_oracle(sv, suv, sidx, mvp, texture, dev)
    if flips > 0.03 or rest < 30.0:
        raise AssertionError(f"soup against the float64 oracle: {flips:.4f} "
                             f"> 8 LSB, {rest:.2f} dB")
    t0 = time.perf_counter()
    with PairCheck() as check:
        control, stats = trg.render_frame_grid_exact(
            mvp.to(dev), vgrid, uvgrid, texture, WIDTH, HEIGHT,
            strips=CONTROL_STRIPS, with_stats=True)
    control_s = time.perf_counter() - t0 - check.seconds
    if stats["soup_won"] == 0:
        raise AssertionError("the soup won no pixel in the control's merge")
    raw, _ = rs.render_frames_scan(mvp[None], vgrid, uvgrid, texture, WIDTH,
                                   HEIGHT, rs.suggest_scan_config(n, WIDTH,
                                                                  HEIGHT))
    scan = rs.unpack_raw_frames(raw.cpu(), WIDTH, HEIGHT)[0]
    tiled_cfg = tiled_config(mvp[None].to(dev), vgrid, uvgrid, WIDTH, HEIGHT)
    tiled = trp.render_frames_pallas(mvp[None].to(dev), vgrid, uvgrid,
                                     texture, WIDTH, HEIGHT,
                                     tiled_cfg)[0].cpu().numpy()
    for name, frame in (("scan", scan), ("tiled", tiled)):
        p, off, flip = control_fidelity(frame, control)
        fields.update({f"{name}_psnr_db": f"{p:.2f}",
                       f"{name}_off_more_share": f"{off:.6f}",
                       f"{name}_flip_share": f"{flip:.6f}"})
    cfg = stats["config"]
    phase("straddle_control", frame="dz-3_yaw20", straddlers=len(tris),
          soup_triangles=len(sidx) // 3, clip_s=f"{clip_ms / 1e3:.2f}",
          **fields, control_s=f"{control_s:.2f}",
          row_anchors=cfg.row_anchors,
          window=f"{cfg.window_rows}x{cfg.window_cols}",
          strips=stats["strips"], **check.fields(),
          soup_won_share=f"{stats['soup_won'] / (WIDTH * HEIGHT):.6f}",
          **oracle_fidelity(mvp, vgrid, uvgrid, texture, WIDTH, HEIGHT,
                            {"control": control, "scan": scan}))

    # The merge where the soup reaches the frame: the d6 mesh, the camera
    # inside the relief.
    mesh6, projection6, vgrid6, uvgrid6, texture = scene6
    mvp = close_mvp(mesh6, projection6, *INSIDE_POSE)
    tris = trg.straddlers(mvp, vgrid6)
    sv, suv, sidx = trg.straddler_soup(tris, vgrid6, uvgrid6, mvp)
    _, flips, rest, fields = soup_vs_oracle(sv, suv, sidx, mvp, texture, dev)
    if flips > 0.03 or rest < 30.0:
        raise AssertionError(f"inside: soup against the float64 oracle: "
                             f"{flips:.4f} > 8 LSB, {rest:.2f} dB")
    with PairCheck() as check:
        control, stats = trg.render_frame_grid_exact(
            mvp.to(dev), vgrid6, uvgrid6, texture, WIDTH, HEIGHT,
            strips=CONTROL_STRIPS, with_stats=True)
    won = stats["soup_won"] / (WIDTH * HEIGHT)
    if stats["soup_won"] == 0:
        raise AssertionError("the soup won no pixel of the inside pose")
    phase("straddle_control_inside", frame="d6_dz-1.5_yaw0",
          straddlers=len(tris), soup_triangles=len(sidx) // 3, **fields,
          row_anchors=stats["config"].row_anchors, strips=stats["strips"],
          **check.fields(), soup_won_share=f"{won:.6f}",
          **oracle_fidelity(mvp, vgrid6, uvgrid6, texture, WIDTH, HEIGHT,
                            {"control": control}))


def mesh_renderer_phase(scene, scene6, dev):
    """Phase 6c: ``MeshRenderer`` (the reference's frame loop, the API-parity
    path). On the d10 grid, ``run(max_frames=32)`` with the sway advanced in
    ``on_update`` as the reference's ``__main__`` does: frames byte-identical
    to ``render_clip``'s for the same views, ``solve``, ``march`` and
    ``shade`` launched 32 times each (counters set to 0 just before the
    loop, read just after), frames/s. A mesh that is not a grid (the d6
    mesh's arrays) draws 4 frames through the soup; its first against
    ``render_frame_grid_exact`` of the d6 grid at the same MVP (>= 45 dB on
    the pixels within 8 LSB, <= 1 % beyond)."""
    from depthrenderer_tpu_torch import animation, transforms
    from depthrenderer_tpu_torch.ops import raster_grid as trg
    from depthrenderer_tpu_torch.ops import raster_scan as rs
    from depthrenderer_tpu_torch.render import (MeshRenderer, clip_mvps,
                                                render_clip)
    from depthrenderer_tpu_torch.scene import Camera, Mesh
    from depthrenderer_tpu_torch.utils import psnr

    mesh = scene[0]
    camera = Camera((WIDTH, HEIGHT), fov_y=18.0)
    views = clip_views(RENDERER_FRAMES)
    want = render_clip(mesh, camera.projection, views, WIDTH, HEIGHT,
                       device="cuda")
    renderer = MeshRenderer(camera=camera, fps=60.0, device="cuda")
    renderer.mesh = mesh
    sway, cam_pos, frames = animation.default_sway(), \
        transforms.translation(dz=-10.0), []

    def on_update(delta):
        frames.append(renderer.get_frame())
        sway.update(delta)
        camera.view = transforms.matmul(cam_pos, sway.transform)

    sway.update(1 / 60.0)
    camera.view = transforms.matmul(cam_pos, sway.transform)
    renderer.on_update = on_update
    rs.reset_launch_counts()
    t0 = time.perf_counter()
    renderer.run(max_frames=RENDERER_FRAMES)
    seconds = time.perf_counter() - t0
    launches = dict(rs.LAUNCHES)
    if len(frames) != RENDERER_FRAMES or any(
            not np.array_equal(f, w) for f, w in zip(frames, want)):
        raise AssertionError("MeshRenderer frames differ from render_clip's")
    if launches != {k: RENDERER_FRAMES for k in launches}:
        raise AssertionError(f"MeshRenderer launches {launches}, expected "
                             f"{RENDERER_FRAMES} each")

    mesh6, _, vgrid6, uvgrid6, texture = scene6
    soup_mesh = Mesh(mesh6.texture, mesh6.vertices, mesh6.texture_coordinates,
                     mesh6.indices)
    renderer = MeshRenderer(camera=camera, device="cuda")
    renderer.mesh = soup_mesh
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    soup, views = [], clip_views(SOUP_FRAMES)
    for view in views:
        camera.view = view
        renderer.draw()
        soup.append(renderer.get_frame())
    soup_s = (time.perf_counter() - t0) / SOUP_FRAMES
    peak = torch.cuda.max_memory_allocated() / 2**30
    mvp = clip_mvps(camera.projection, views[:1], mesh6.transform)[0]
    control = trg.render_frame_grid_exact(mvp.to(dev), vgrid6, uvgrid6,
                                          texture, WIDTH, HEIGHT,
                                          strips=CONTROL_STRIPS)
    diff = np.abs(soup[0].astype(np.int32) - control.astype(np.int32)).max(-1)
    flips = float((diff > 8).mean())
    rest = psnr(soup[0][diff <= 8], control[diff <= 8])
    covered = float((soup[0][..., :3].max(-1) > 0).mean())
    if renderer.impl != "soup" or flips > 0.01 or rest < 45.0 or covered < 0.3:
        raise AssertionError(f"soup route: impl {renderer.impl}, {flips:.4f} "
                             f"> 8 LSB, {rest:.2f} dB, covered {covered:.3f}")
    phase("mesh_renderer", frames=RENDERER_FRAMES, impl="scan",
          launches=json.dumps(launches), frames_equal_render_clip=True,
          loop_fps=f"{RENDERER_FRAMES / seconds:.2f}",
          soup_triangles=soup_mesh.num_triangles, soup_frames=SOUP_FRAMES,
          soup_s_per_frame=f"{soup_s:.2f}", soup_peak_gib=f"{peak:.2f}",
          soup_vs_control_psnr_db=f"{rest:.2f}",
          soup_vs_control_flip_share=f"{flips:.6f}",
          soup_covered_share=f"{covered:.4f}")


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
    from depthrenderer_tpu_torch.march_times import bound, scan_bounds
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
    from depthrenderer_tpu_torch.march_times import bound, scan_bounds
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
    phase("big_grid_kernel_times_march_ptxas", **march_ptxas_fields(big=True))
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
    with PairCheck() as check:
        control, stats = trg.render_frame_grid_exact(
            mvp[0].to(dev), vgrid, uvgrid, texture, BIG_WIDTH, BIG_HEIGHT,
            strips=BIG_CONTROL_STRIPS, edge_cull_threshold=EDGE_CULL,
            with_stats=True)
    seconds = time.perf_counter() - t0 - check.seconds
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
          seconds=f"{seconds:.2f}", peak_gib=f"{peak:.2f}", **check.fields(),
          psnr_db=f"{fid[0]:.2f}", off_more_share=f"{fid[1]:.6f}",
          flip_share=f"{fid[2]:.6f}",
          hole_share=f"{float((cov_c & ~cov_s).mean()):.6f}",
          scan_only_share=f"{float((cov_s & ~cov_c).mean()):.6f}",
          **oracle_fidelity(mvp[0], vgrid, uvgrid, texture, BIG_WIDTH,
                            BIG_HEIGHT, {"scan": frame, "control": control},
                            EDGE_CULL))


def probe_cost(case, ins, out, trips):
    """(bytes, operations, their peak rate) of one probe launch at
    ``trips``: inputs read once, the output written once; one FP32 add per
    lookup (gathers, roll), a subtract and a multiply per (row, pixel,
    column) for march_top2, none for the transpose; onehot_dot's dense
    product on its three bf16 parts, two operations a multiply-add
    (``probes.bound_work``), at the tensor cores' bf16 rate."""
    from depthrenderer_tpu_torch import probes
    from depthrenderer_tpu_torch.march_times import (BF16_TENSOR_OPS_PER_S,
                                                     FP32_OPS_PER_S)

    moved = nbytes(*ins.values(), out)
    if case.kernel == "transpose":
        return moved, 0, FP32_OPS_PER_S
    if case.kernel == "onehot_dot":
        return (moved, 2 * probes.bound_work(case)[0] * trips,
                BF16_TENSOR_OPS_PER_S)
    if case.kernel == "march_top2":
        return moved, probes.bound_work(case)[0] * trips, FP32_OPS_PER_S
    return moved, probes.lookups_per_trip(case) * trips, FP32_OPS_PER_S


def probes_phase(dev):
    """Phase 9: the probe kernels against their twins, then the probes'
    runner over every case with the launch counters around it."""
    from depthrenderer_tpu_torch import probes
    from depthrenderer_tpu_torch.march_times import bound
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
        if case.kernel == "onehot_dot":
            # Its copies too: each its own 128 blocks.
            copied = check_case(case, ins, copies=3)
            if not copied["equal"]:
                raise AssertionError(f"probe {case.name}: 3 copies differ "
                                     "from the twin")
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
        moved, ops, rate = probe_cost(
            case, ins, probes.run_case(case, ins, trips), trips)
        b_ms, b_by = bound(moved, ops, rate)
        lib_ms = timed[name].get("library_trip_ms")
        out[kernel] = {"max_abs_err": errs[kernel], "ms": res["check_ms"],
                       "plain_ms": res["plain_ms"], "bound_ms": b_ms,
                       "bound_by": b_by,
                       "library_ms": lib_ms and lib_ms * trips}
    nan = float("nan")
    phase("probes", cases=len(timed), launches=json.dumps(launches),
          **{f"{k}_ms": f"{v['ms']:.4f}" for k, v in out.items()},
          **{f"{k}_bound_ms": f"{v['bound_ms']:.6f}" for k, v in out.items()},
          **{f"{k}_x": f"{timed[n].get('x_stated', nan):.3f}"
             for k, n in PROBE_KERNELS.items()},
          **{f"{k}_x_library": f"{timed[n]['x_library']:.3f}"
             for k, n in PROBE_KERNELS.items() if "x_library" in timed[n]})
    return out, launches


def write_farm_inputs(colour, depth, root):
    """The farm's inputs: the colour image, and four models' depth maps of
    its name: ``ground_truth`` (the synthetic depth) and three made with
    the reference's depth augmentation, ``overlay_noise`` at FARM_NOISE's
    scales and seeds."""
    from PIL import Image

    from depthrenderer_tpu_torch.utils import overlay_noise

    root.mkdir(parents=True, exist_ok=True)
    Image.fromarray(colour).save(root / "scene.png")
    models = {"ground_truth": depth}
    for scale, seed in FARM_NOISE:
        models[f"noise{scale}_seed{seed}"] = overlay_noise(
            depth[..., None], scale=scale, seed=seed)[..., 0]
    for name, d in models.items():
        (root / "models" / name).mkdir(parents=True, exist_ok=True)
        Image.fromarray(d).save(root / "models" / name / "scene.png")
    return root / "scene.png", root / "models", list(sorted(models))


def farm_run(image, models, out, extra):
    """One ``batch.run_farm`` at the farm's defaults, launch counters set
    to 0 before and read after -> (result, launches, seconds with the
    post-processing)."""
    from depthrenderer_tpu_torch import batch
    from depthrenderer_tpu_torch.ops import raster_scan as rs

    args = batch.build_parser().parse_args(
        [str(image), str(models), "-mesh-density", str(FARM_DENSITY),
         "--frames", str(FARM_FRAMES), "-output-path", str(out), *extra])
    rs.reset_launch_counts()
    t0 = time.perf_counter()
    result = batch.run_farm(args)
    seconds = time.perf_counter() - t0
    return result, dict(rs.LAUNCHES), seconds


def farm_scenes(colour, models, dev):
    """The farm's scenes as ``batch.run_farm`` builds them at its defaults
    -> ({model: (vertex grid, texture) on ``dev``}, the checked frames'
    MVPs (2, 4, 4) and the chunk's (FARM_CHUNK, 4, 4) on the host, the
    scan config the farm's paths take)."""
    from depthrenderer_tpu_torch import batch
    from depthrenderer_tpu_torch import io as dio
    from depthrenderer_tpu_torch.render import (_grid_arrays, clip_mvps,
                                                clip_scan_config)
    from depthrenderer_tpu_torch.scene import Camera, Texture

    args = batch.build_parser().parse_args(
        ["scene.png", str(models), "-mesh-density", str(FARM_DENSITY)])
    h, w = colour.shape[:2]
    texture, base, meshes = Texture(colour), None, {}
    for name, path in batch.discover_models(models, "scene.png"):
        depth = dio.resize(dio.load_depth(path), colour.shape)
        meshes[name] = batch._model_mesh(base, texture, depth, args)
        if base is None:
            base = meshes[name]
    views = batch.farm_views(args.fps)
    n = 2 ** FARM_DENSITY + 1
    cfg = clip_scan_config(n, w, h, batch._parse_colfix(args.colfix),
                           args.quality, args.patch, args.edge_cull)
    camera = Camera(window_size=(w, h), fov_y=args.fov_y)
    mvps = clip_mvps(camera.projection, views, base.transform)
    scenes = {m: (_grid_arrays(mesh)[0].to(dev), mesh.texture.image.to(dev))
              for m, mesh in meshes.items()}
    return (scenes, mvps[list(FARM_CHECK_FRAMES)], mvps[:FARM_CHUNK],
            cfg)


def farm_kernels_vs_plain(colour, models, dev):
    """Every farm model's kernels at the farm's shapes (640x480, d8, the
    farm's own scan config) on the loop's first and middle frames: solve,
    march and shade each against its plain twin on the same inputs, max
    abs 0, and the kernel chain's frame equal to ``render_frames_scan``'s.
    Then one chunk of the sharded farm's dispatch (every model's
    ``render_scenes_sharded`` and YUV pack) under CUDA's sync debug mode
    "error": it must queue its work without waiting for the card."""
    from depthrenderer_tpu_torch import io as dio
    from depthrenderer_tpu_torch.ops import raster_scan as rs
    from depthrenderer_tpu_torch.parallel import render_scenes_sharded

    h, w = colour.shape[:2]
    scenes, mvps, chunk, cfg = farm_scenes(colour, models, dev)
    g = rs.ScanGeometry.of(w, h, 2 ** FARM_DENSITY + 1,
                           2 ** FARM_DENSITY + 1, cfg)
    minv = rs.minv_rows(mvps)
    errs = {"solve": 0.0, "march": 0.0, "shade": 0}
    plain_s = 0.0
    for name, (vgrid, texture) in scenes.items():
        texq = rs.pack_texture(texture)
        prep = rs.prep_scan(mvps.to(dev), vgrid, w, h, cfg)
        path = rs.render_frames_scan(mvps, vgrid, None, texture, w, h, cfg)[0]
        for i in range(mvps.shape[0]):
            args_i = (prep.win[i], prep.w0[i], prep.bounds[i])
            margs = (*args_i, prep.canch[i], prep.mid[i], minv[i], g, cfg)
            rec = rs.solve_records(*args_i, g, cfg)
            att = rs.march_exact(rec, *margs)
            out = rs.shade(att, texq, g, cfg, "texture")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rec_p = rs.solve_records_plain(*args_i, g, cfg)
            att_p = rs.march_exact_plain(rec, *margs)
            out_p = rs.shade_plain(att, texq, *texq.shape, "texture")
            torch.cuda.synchronize()
            plain_s += time.perf_counter() - t0
            err = {"solve": float((rec - rec_p).abs().max()),
                   "march": float((att - att_p).abs().max()),
                   "shade": int(frame_agreement(out, out_p)[0].max())}
            cov = float((out[:h, :w] != (255 << 24) - 2**32).float().mean())
            if any(err.values()) or not torch.equal(out, path[i]) \
                    or not 0.3 < cov <= 1.0:
                raise AssertionError(
                    f"farm {name} frame {FARM_CHECK_FRAMES[i]}: kernels off "
                    f"their twins by {err}, path frame equal "
                    f"{torch.equal(out, path[i])}, covered {cov:.3f}")
            errs = {k: max(v, err[k]) for k, v in errs.items()}
    phase("batch_kernels_vs_plain", models=len(scenes),
          frames=",".join(map(str, FARM_CHECK_FRAMES)), size=f"{w}x{h}",
          density=FARM_DENSITY, cfg=f"sr{cfg.sr}/hyps{cfg.hyps}/"
          f"colfix{cfg.colfix}/cw{cfg.cw}/rmax{cfg.rmax}",
          **{f"{k}_max_abs": v for k, v in errs.items()},
          equal_to_render_path=True, plain_s=f"{plain_s:.1f}")

    vgrids = [v for v, _ in scenes.values()]
    textures = [t for _, t in scenes.values()]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        frames = render_scenes_sharded(
            chunk.expand(len(vgrids), -1, -1, -1), vgrids, None, textures, w,
            h, frame_batch=FARM_CHUNK, scan_config=cfg, devices=[dev])
        packed = [dio.rgba_to_yuv420(f) for f in frames]
        dispatch_ms = (time.perf_counter() - t0) * 1e3
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    done_ms = (time.perf_counter() - t0) * 1e3
    if [p.shape for p in packed] != [(FARM_CHUNK, h * w * 3 // 2)] * len(
            vgrids):
        raise AssertionError(f"sharded dispatch packed "
                             f"{[p.shape for p in packed]}")
    phase("batch_dispatch_no_wait", models=len(vgrids), frames=FARM_CHUNK,
          sync_debug_mode="error", dispatch_ms=f"{dispatch_ms:.2f}",
          done_ms=f"{done_ms:.2f}")


def batch_path(colour, depth, dev, tmp):
    """The batch farm (``python -m depthrenderer_tpu_torch.batch``) at its
    defaults on the synthetic 640x480 scene: d8, 60 fps, one sway loop
    (300 frames) a model, four models; its kernels against their twins at
    the farm's shapes (:func:`farm_kernels_vs_plain`), then sequential,
    ``--sharded --readback yuv420`` and ``--sharded --readback rgba`` (the
    last with the post-processing)."""
    from depthrenderer_tpu_torch import evaluate
    from depthrenderer_tpu_torch import io as dio
    from depthrenderer_tpu_torch import video
    from depthrenderer_tpu_torch.utils import psnr

    image, models, names = write_farm_inputs(colour, depth, tmp / "farm_in")
    farm_kernels_vs_plain(colour, models, dev)
    runs = {"seq": ["--no-post"],
            "sharded_yuv420": ["--sharded", "--readback", "yuv420",
                               "--no-post"],
            "sharded_rgba": ["--sharded", "--readback", "rgba"]}
    out, fields = {}, {}
    for run, extra in runs.items():
        result, launches, seconds = farm_run(image, models,
                                             tmp / f"farm_{run}", extra)
        want = len(names) * FARM_FRAMES
        if result["frames"] != want or launches != {
                "solve": want, "march": want, "shade": want}:
            raise AssertionError(f"farm {run}: {result['frames']} frames, "
                                 f"launches {launches}, expected {want} each")
        out[run] = dict(zip(result["models"], result["videos"]))
        fields[f"{run}_fps"] = f"{result['frames'] / result['seconds']:.2f}"
        fields[f"{run}_s"] = f"{seconds:.1f}"
        fields[f"{run}_launches"] = json.dumps(launches).replace(" ", "")
    identical = {m: Path(out["seq"][m]).read_bytes()
                 == Path(out["sharded_rgba"][m]).read_bytes() for m in names}
    if not all(identical.values()):
        raise AssertionError(f"sequential and sharded-rgba AVIs differ: "
                             f"{identical}")
    worst_psnr, worst_abs = float("inf"), 0
    for m in names:
        for a, b in zip(video.read_video_frames(out["sharded_yuv420"][m]),
                        video.read_video_frames(out["sharded_rgba"][m])):
            worst_psnr = min(worst_psnr, psnr(a, b))
            worst_abs = max(worst_abs, int(np.abs(a.astype(int)
                                                  - b.astype(int)).max()))
    if worst_psnr < 40.0:
        raise AssertionError(f"YUV readback decodes {worst_psnr:.2f} dB from "
                             "the RGBA readback")
    root = Path(out["sharded_rgba"][names[0]]).parents[2]
    post = {"mosaic": root / "mosaic" / "scene.avi",
            "concat": root / "concat" / "scene.avi",
            **{f"paired_{m}": root / "paired" / "scene"
               / f"ground_truth-{m}.avi" for m in names if m != "ground_truth"}}
    counts = {k: video.read_video_info(p)[2] for k, p in post.items()}
    expect = {k: FARM_FRAMES * (len(names) if k == "concat" else 1)
              for k in post}
    if counts != expect:
        raise AssertionError(f"post-processing frame counts {counts}, "
                             f"expected {expect}")
    gt_depth = dio.resize(dio.load_depth(models / "ground_truth" /
                                         "scene.png"), colour.shape)
    masked = {m: float(np.mean(evaluate.compare_videos(
        out["sharded_rgba"]["ground_truth"], out["sharded_rgba"][m],
        gt_depth, device="cuda"))) for m in names if m != "ground_truth"}
    phase("batch_path", models=len(names), frames_per_model=FARM_FRAMES,
          size=f"{colour.shape[1]}x{colour.shape[0]}", density=FARM_DENSITY,
          **fields, seq_vs_sharded_rgba_identical=all(identical.values()),
          yuv_vs_rgba_min_psnr_db=f"{worst_psnr:.2f}",
          yuv_vs_rgba_max_abs=worst_abs,
          post_frames=json.dumps(counts).replace(" ", ""),
          **{f"masked_psnr_{m}_db": f"{v:.2f}" for m, v in masked.items()})


def yuv_pack_vs_cpu(colour, depth, dev):
    """The farm's YUV 4:2:0 pack on the card against the CPU's on 16 farm
    frames (the ground-truth model's first frame group), byte for byte,
    its time a frame beside its bound: 4 bytes read and 1.5 written a
    pixel at 3.35 TB/s."""
    from depthrenderer_tpu_torch import io as dio
    from depthrenderer_tpu_torch.march_times import HBM_BYTES_PER_S
    from depthrenderer_tpu_torch.render import render_clip

    mesh, projection = smoke_scene(colour, depth, dev,
                                   density=FARM_DENSITY)[:2]
    h, w = colour.shape[:2]
    frames = torch.from_numpy(render_clip(
        mesh, projection, clip_views(16), w, h, device="cuda"))
    on_card = frames.to(dev)
    packed = dio.rgba_to_yuv420(on_card)
    if not torch.equal(packed.cpu(), dio.rgba_to_yuv420(frames)):
        bad = int((packed.cpu() != dio.rgba_to_yuv420(frames)).sum())
        raise AssertionError(f"YUV pack: {bad} bytes differ from the CPU's")
    n = frames.shape[0]
    ms = cuda_ms(lambda: dio.rgba_to_yuv420(on_card), 20) / n
    bound_ms = h * w * 5.5 / HBM_BYTES_PER_S * 1e3
    phase("yuv_pack_vs_cpu", frames=n, equal=True, ms_per_frame=f"{ms:.6f}",
          bound_ms_per_frame=f"{bound_ms:.6f}", bound_by="bytes",
          bound_share=f"{bound_ms / ms:.3f}")


def wire_pass(label, cfg, mvp, vgrid, texq, width, height, dev):
    """One pass of the quality wireframe on one frame: the march's 6-plane
    attrs against the twin's (max abs 0) -> (kernel attrs, twin attrs,
    fields: the march's ms beside the texture_z instance's, the twin's
    and the bound)."""
    from depthrenderer_tpu_torch.march_times import bound, scan_bounds
    from depthrenderer_tpu_torch.ops import raster_scan as rs

    g = rs.ScanGeometry.of(width, height, vgrid.shape[0], vgrid.shape[1],
                           cfg)
    prep = rs.prep_scan(mvp.to(dev), vgrid, width, height, cfg)
    args = (prep.win[0], prep.w0[0], prep.bounds[0])
    rec = rs.solve_records(*args, g, cfg)
    margs = (rec, *args, prep.canch[0], prep.mid[0], rs.minv_rows(mvp)[0], g,
             cfg)
    att = rs.march_exact(*margs, min_lam=True)
    att_p, plain = timed_ms(lambda: rs.march_exact_plain(*margs,
                                                         min_lam=True))
    err = float((att - att_p).abs().max())
    if att.shape[0] != 6 or err != 0.0:
        raise AssertionError(f"{label}: 6-plane march differs from the twin "
                             f"by {err} (shape {tuple(att.shape)})")
    b = bound(*scan_bounds(prep, 0, g, cfg, texq, with_z=True,
                           min_lam=True)["march"])
    fields = {"march_ms": f"{cuda_ms(lambda: rs.march_exact(*margs, min_lam=True), 10):.4f}",
              "texture_z_march_ms":
                  f"{cuda_ms(lambda: rs.march_exact(*margs, raster_z=True), 10):.4f}",
              "march_plain_ms": f"{plain:.1f}",
              "march_bound_ms": f"{b[0]:.4f}", "bound_by": b[1],
              "max_abs_err": err,
              "wire_share": f"{float((att[5][att[3] > 0.5] <= 0.15).float().mean()):.4f}"}
    return att, att_p, fields


def tiers_quality_wireframe(colour, depth, scene, dev, tmp):
    """The quality tier's wireframe (``--quality --mode wireframe``) at
    1080p/d10 on sway frame 74: each pass's 6-plane march against its twin,
    the merged and wire-tested frame against the twin chain's and the
    render path's; then 32 frames through ``cli.render_scene``."""
    from depthrenderer_tpu_torch import cli
    from depthrenderer_tpu_torch.ops import raster_scan as rs
    from depthrenderer_tpu_torch.render import clip_mvps

    mesh, projection, vgrid, uvgrid, texture = scene
    n = vgrid.shape[0]
    cfg = rs.suggest_scan_config(n, WIDTH, HEIGHT, quality=True)
    cfg1, cfg2 = rs.tier_configs(cfg, n, n, WIDTH, HEIGHT)
    mvp = clip_mvps(projection, clip_views(300)[TIER_FRAME:TIER_FRAME + 1],
                    mesh.transform)
    texq = rs.pack_texture(texture)
    a1, p1, f1 = wire_pass("pass 1", cfg1, mvp, vgrid, texq, WIDTH, HEIGHT,
                           dev)
    phase("tiers_quality_wireframe_pass1", frame=TIER_FRAME, **f1)
    a2, p2, f2 = wire_pass("pass 2", cfg2, rs.swap_mvps(mvp),
                           vgrid.transpose(0, 1).contiguous(),
                           rs.pack_texture(texture.transpose(0, 1)
                                           .contiguous()), HEIGHT, WIDTH, dev)
    phase("tiers_quality_wireframe_pass2", frame=TIER_FRAME, **f2)
    g1 = rs.ScanGeometry.of(WIDTH, HEIGHT, n, n, cfg1)

    def frame_of(x1, x2, shade):
        merged = rs.wire_coverage(rs.merge_row_edge(x1[None], x2[None],
                                                    WIDTH, HEIGHT))[0]
        return shade(merged)

    kernel = frame_of(a1, a2, lambda m: rs.shade(m, texq, g1, cfg1,
                                                 "wireframe"))
    plain = frame_of(p1, p2, lambda m: rs.shade_plain(m, texq, *texq.shape,
                                                      "wireframe"))
    path = rs.render_frames_scan(mvp, vgrid, uvgrid, texture, WIDTH, HEIGHT,
                                 cfg, "wireframe")[0][0]
    lit = float((rs.raw_rgba(kernel[None], WIDTH, HEIGHT)[..., :3].amax(-1)
                 > 0).float().mean())
    if not (torch.equal(kernel, plain) and torch.equal(kernel, path)):
        raise AssertionError("quality wireframe: the merged kernel frame "
                             "differs from the twin chain's or the path's")
    phase("tiers_quality_wireframe_merged", equal_to_twin_chain=True,
          equal_to_render_path=True, lit_share=f"{lit:.4f}")
    frames = TIER_CLI_FRAMES
    fps = render_fps(mesh, projection, frames, 16, quality=True,
                     mode="wireframe")
    rs.reset_launch_counts()
    result = cli.render_scene(colour, depth, cli_args(
        tmp / "quality_wireframe", frames, ["--quality", "--mode",
                                            "wireframe"]))
    launches = dict(rs.LAUNCHES)
    # Two passes march; the merged attrs shade once a frame.
    want = {"solve": 2 * frames, "march": 2 * frames, "shade": frames}
    if launches != want:
        raise AssertionError(f"quality wireframe: launches {launches}, "
                             f"expected {want}")
    avi, png = check_outputs(result, frames)
    phase("tiers_quality_wireframe_path", frames=frames,
          launches=json.dumps(launches).replace(" ", ""),
          render_only_fps=f"{fps:.2f}",
          incl_encode_fps=f"{frames / result['seconds']:.2f}",
          avi_bytes=avi, sample_png_bytes=png)


def cli_mp4_noise(colour, depth, tmp):
    """``--container mp4 --overlay-noise 32 16 8`` through
    ``cli.render_scene`` (32 frames at 1080p/d10), beside the same run into
    an AVI: the MP4's frame count, and (remuxed, without ffmpeg) its JPEG
    samples against the AVI's payloads."""
    from depthrenderer_tpu_torch import cli, video
    from depthrenderer_tpu_torch.ops import raster_scan as rs

    frames = TIER_CLI_FRAMES
    noise = ["--overlay-noise", "32", "16", "8"]
    rs.reset_launch_counts()
    mp4 = cli.render_scene(colour, depth, cli_args(
        tmp / "mp4", frames, ["--container", "mp4", *noise]))
    launches = dict(rs.LAUNCHES)
    if launches != {"solve": frames, "march": frames, "shade": frames}:
        raise AssertionError(f"cli mp4: launches {launches}")
    avi = cli.render_scene(colour, depth, cli_args(tmp / "mp4_avi", frames,
                                                   noise))
    info = video.read_mp4_info(mp4["video"])
    if not mp4["video"].endswith(".mp4") or info[2] != frames:
        raise AssertionError(f"cli mp4: {mp4['video']} holds {info}")
    remux = not video.ffmpeg_available()
    same = (video.read_mp4_samples(mp4["video"])
            == video.read_avi_payloads(avi["video"]))
    if remux and not same:
        raise AssertionError("cli mp4: the remuxed JPEG samples differ from "
                             "the AVI's payloads")
    phase("cli_mp4_noise", frames=frames, mp4_frames=info[2],
          converter="remux" if remux else "ffmpeg",
          payloads_equal_avi=same, mp4_bytes=Path(mp4["video"]).stat().st_size,
          incl_encode_fps=f"{frames / mp4['seconds']:.2f}")


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
        results["jpeg"] = jpeg_phase(scene, dev)
        seconds["jpeg"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        tiled_cfg, group, results["pairs"] = tiled_phase(scene, dev)
        seconds["tiled_kernel"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        pair_launches = tiled_main_path(colour, depth, scene, tiled_cfg,
                                        group, tmp)
        seconds["tiled_path"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        d13_path(colour, depth, tmp)
        seconds["d13_path"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        control, scan_fid = control_phase(scene, tiled_cfg, dev)
        seconds["control"] = time.perf_counter() - t0
        scene6 = smoke_scene(colour, depth, dev, density=SOUP_DENSITY)
        t0 = time.perf_counter()
        straddle_phase(scene, scene6, dev)
        seconds["straddle_control"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        mesh_renderer_phase(scene, scene6, dev)
        seconds["mesh_renderer"] = time.perf_counter() - t0
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
        t0 = time.perf_counter()
        batch_path(colour, depth, dev, tmp)
        seconds["batch_path"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        yuv_pack_vs_cpu(colour, depth, dev)
        seconds["yuv_pack_vs_cpu"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        tiers_quality_wireframe(colour, depth, scene, dev, tmp)
        seconds["tiers_quality_wireframe"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cli_mp4_noise(colour, depth, tmp)
        seconds["cli_mp4_noise"] = time.perf_counter() - t0
    phase("seconds", **{k: f"{v:.1f}" for k, v in seconds.items()},
          total=f"{time.perf_counter() - t_all:.1f}")

    launches = dict(scan_launches, pairs=pair_launches,
                    jpeg=scan_launches["jpeg_dct"], **probe_launches)
    print(json.dumps(kernel_table(results, launches)), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
