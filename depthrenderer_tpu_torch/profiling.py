"""Where a clip's device time goes: ``render_clip`` under ``torch.profiler``.

    python -m depthrenderer_tpu_torch.profiling [--impl scan|pallas|grid]
        [--tier quality|patch] [--density D] [--width W] [--height H]
        [--edge-cull T] [--frames N]

Renders the synthetic scene (:mod:`.synthetic`, at the output's size) at
mesh density 10 and 1920x1080 by default, 64 frames of the default sway at
60 fps, with a sink that drops the frames, after one 16-frame warm-up group,
and prints one JSON line: the card (``nvidia-smi`` name and power limit),
wall ms, device busy ms (the sum of the CUDA kernels' and copies' self
time), the busy share, peak device memory, and each kernel's ms per frame
with its share of the busy time. ``--tier`` profiles one of the scan's
fidelity tiers: ``quality``, or ``patch`` with colfix 3. BASELINE preset 4
is ``--impl scan --density 12 --width 3840 --height 2160 --edge-cull 0.25
--frames 16``. It needs a CUDA device.

Beside it, the counterparts of the JAX package's tracing tools
(``depthrenderer_tpu/profiling.py``):
:func:`device_trace` (a ``torch.profiler`` trace for TensorBoard or
Perfetto), :class:`StageTimer` (named wall-clock stages, each waiting for
its device result) and :class:`ThroughputMeter` (frames a second).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import time

import torch

from .utils import log

WIDTH, HEIGHT, DENSITY, FRAMES, WARM = 1920, 1080, 10, 64, 16
TOP = 12   # kernels listed
TIERS = {"quality": {"quality": True}, "patch": {"patch": True, "colfix": 3}}


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace the host and the CUDA devices with ``torch.profiler`` and write
    a Chrome trace into ``log_dir`` (view with Perfetto or TensorBoard)::

        with profiling.device_trace("/tmp/trace"):
            frames = render_clip(...)
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    log(f"torch.profiler trace written to {path}")


class StageTimer:
    """Accumulating wall-clock timer of named stages::

        timer = StageTimer()
        with timer.stage("raster", block_on=frames):
            frames = render(...)
        timer.report()

    ``block_on`` (a tensor, or a sequence of them) is waited for at the end
    of the stage: the CUDA devices it lies on are synchronised, so the
    stage's time covers its device work."""

    def __init__(self):
        self.totals = {}
        self.counts = {}

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                tensors = (block_on if isinstance(block_on, (list, tuple))
                           else [block_on])
                for dev in {t.device for t in tensors
                            if isinstance(t, torch.Tensor)}:
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self):
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            log(f"[stage] {name}: {total * 1e3:.1f} ms total, "
                f"{total / n * 1e3:.2f} ms/call over {n} calls")


class ThroughputMeter:
    """Frames a second of a streaming pipeline since construction."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.frames = 0

    def add(self, n: int = 1):
        self.frames += n

    @property
    def fps(self) -> float:
        dt = time.perf_counter() - self.t0
        return self.frames / dt if dt > 0 else 0.0


def profile_clip(impl="pallas", tier=None, density=DENSITY, width=WIDTH,
                 height=HEIGHT, edge_cull=None, frames=FRAMES):
    """Profile one ``render_clip`` run -> dict (see the module docstring)."""
    from torch.profiler import ProfilerActivity, profile

    from . import animation, transforms
    from .render import render_clip
    from .scene import Camera, Mesh, Texture
    from .synthetic import synthetic_scene

    colour, depth = (synthetic_scene() if (width, height) == (WIDTH, HEIGHT)
                     else synthetic_scene(h=height, w=width))
    mesh = Mesh.from_texture(Texture(colour), depth_map=depth,
                             density=density)
    mesh.vertices[:, 2] *= 4.0
    projection = Camera((colour.shape[1], colour.shape[0]),
                        fov_y=18.0).projection
    views = transforms.matmul(
        transforms.translation(dz=-10.0)[None],
        animation.default_sway().batch(animation.frame_times(frames, 60.0)))

    def run(v):
        render_clip(mesh, projection, v, width, height, impl=impl,
                    on_frames=lambda s, f: None, device="cuda",
                    edge_cull_threshold=edge_cull, **TIERS.get(tier, {}))
        torch.cuda.synchronize()

    run(views[:WARM])
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(views)
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if "CUDA" not in str(e.device_type):
            continue   # host ops: their kernels are listed on their own
        ms = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0)) / 1e3
        if ms > 0:
            rows.append((e.key, ms))
    busy = sum(ms for _, ms in rows)
    rows.sort(key=lambda r: -r[1])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return {
        "card": card, "impl": impl, "tier": tier, "frames": frames,
        "size": f"{width}x{height}", "density": density,
        "edge_cull": edge_cull,
        "wall_ms": round(wall_ms, 2), "device_busy_ms": round(busy, 2),
        "busy_share": round(busy / wall_ms, 4),  # 0 if nothing was traced
        "peak_gib": round(torch.cuda.max_memory_allocated() / 2**30, 2),
        "kernels": [{"name": k[:80], "ms_per_frame": round(ms / frames, 4),
                     "share": round(ms / max(busy, 1e-9), 4)}
                    for k, ms in rows[:TOP]],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--impl", choices=("scan", "pallas", "grid"),
                    default="pallas")
    ap.add_argument("--tier", choices=tuple(TIERS), default=None,
                    help="a fidelity tier of the scan (implies --impl scan)")
    ap.add_argument("--density", type=int, default=DENSITY,
                    help=f"mesh density (default {DENSITY})")
    ap.add_argument("--width", type=int, default=WIDTH)
    ap.add_argument("--height", type=int, default=HEIGHT)
    ap.add_argument("--edge-cull", type=float, default=None,
                    dest="edge_cull", help="edge-cull threshold (default off)")
    ap.add_argument("--frames", type=int, default=FRAMES,
                    help=f"profiled frames (default {FRAMES})")
    args = ap.parse_args(argv)
    if args.tier is not None:
        args.impl = "scan"
    if not torch.cuda.is_available():
        raise SystemExit("profiling needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    print(json.dumps(profile_clip(args.impl, args.tier, args.density,
                                  args.width, args.height, args.edge_cull,
                                  args.frames)), flush=True)


if __name__ == "__main__":
    main()
