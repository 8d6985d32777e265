"""The port's tracing: spans and counters, a ``torch.profiler`` trace, and
where a clip's device time goes.

**Spans and counters.** ``with profiling.span("render.dispatch"): ...``
times a stage on the host clock (``time.perf_counter_ns``) and adds its
seconds and one call to a total kept per name; ``profiling.count(name, n)``
adds to a named integer. Both are always on and cost two clock reads and a
lock a span. While tracing is on, each span is also kept one by one (name,
start and end in ns, thread, its id, its parent's id, the request's id) and
opens a ``torch.profiler.record_function`` range of the same name, so an
exported trace shows it on the kernels' clock. Tracing is on where the
calling thread sees the torch profiler on (``profiling.device_trace``, any
``torch.profiler.profile``), and in a worker thread that takes (:func:`adopt`)
the :func:`context` of a thread that saw it on (a Python thread does not
inherit the profiler: its spans are kept, but no ``record_function`` range
is opened there). A span made with ``root=True`` opens a request when none is
open, and every span under it, in its thread or an adopting one, carries
its id. At most ``MAX_KEPT`` spans are kept; past that they are counted in
``profiling.dropped``. :func:`snapshot` returns the totals, the counters,
the kernels' launch counters (``raster_scan.LAUNCHES``, ``tiled.LAUNCHES``,
``probes.LAUNCHES``, of the modules loaded) and the kept spans;
:func:`reset` clears the recorder (the launch counters keep their own
``reset_launch_counts``).

**A clip's profile**::

    python -m depthrenderer_tpu_torch.profiling [--impl scan|pallas|grid]
        [--tier quality|patch] [--density D] [--width W] [--height H]
        [--edge-cull T] [--frames N]

Renders the synthetic scene (:mod:`.synthetic`, at the output's size) at
mesh density 10 and 1920x1080 by default, 64 frames of the default sway at
60 fps, with a sink that drops the frames, after one 16-frame warm-up group,
and prints one JSON line: the card (``nvidia-smi`` name and power limit),
wall ms, device busy ms (the union of the intervals of every CUDA kernel,
copy and memset in the trace), the busy share, peak device memory, each
kernel's ms per frame with its share of the busy time, each span's total
and self ms per frame (self: the part of its time no child span covers)
and the kernels' launches. ``--tier`` profiles one of the scan's fidelity
tiers: ``quality``, or ``patch`` with colfix 3. BASELINE preset 4 is
``--impl scan --density 12 --width 3840 --height 2160 --edge-cull 0.25
--frames 16``. It needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import itertools
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from typing import NamedTuple, Optional

import torch

from .utils import log

WIDTH, HEIGHT, DENSITY, FRAMES, WARM = 1920, 1080, 10, 64, 16
TOP = 12   # kernels listed
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")   # Chrome trace cats
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


# -- spans and counters -----------------------------------------------------

MAX_KEPT = 65_536
DROPPED = "profiling.dropped"
LAUNCH_MODULES = tuple(f"{__package__}.{m}"
                       for m in ("ops.raster_scan", "ops.tiled", "probes"))
_profiler_on = torch.autograd._profiler_enabled


class Span(NamedTuple):
    """A kept span: host-clock ns, the thread's ident, and ids."""

    name: str
    start_ns: int
    end_ns: int
    thread: int
    id: int
    parent: Optional[int]
    request: Optional[int]


class _Local(threading.local):
    inherited = False       # the thread adopted a tracing context
    request = None          # the open request's id
    parent = None           # the adopted parent span's id

    def __init__(self):
        self.stack = []     # ids of the kept spans open in this thread


_local = _Local()
_lock = threading.Lock()
_ids = itertools.count(1)
_totals = {}      # name -> [ns, calls]
_counters = {}    # name -> int
_kept = []        # Span


class span:
    """``with span(name[, root=True]) as s:`` -- see the module docstring.
    After the block ``s.ms`` is the span's duration in ms."""

    __slots__ = ("name", "root", "ns", "_t0", "_id", "_rf", "_saved")

    def __init__(self, name: str, root: bool = False):
        self.name = name
        self.root = root
        self._id = None

    def __enter__(self):
        profiler = _profiler_on()
        if profiler or _local.inherited:
            loc = _local
            self._id = next(_ids)
            self._saved = loc.request
            if self.root and loc.request is None:
                loc.request = self._id
            loc.stack.append(self._id)
            self._rf = None
            if profiler:
                self._rf = torch.profiler.record_function(self.name)
                self._rf.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self.ns = t1 - self._t0
        if self._id is not None:
            if self._rf is not None:
                self._rf.__exit__(*exc)
            loc = _local
            loc.stack.pop()
            kept = Span(self.name, self._t0, t1, threading.get_ident(),
                        self._id, loc.stack[-1] if loc.stack else loc.parent,
                        loc.request)
            loc.request = self._saved
        with _lock:
            total = _totals.get(self.name)
            if total is None:
                _totals[self.name] = [self.ns, 1]
            else:
                total[0] += self.ns
                total[1] += 1
            if self._id is not None:
                if len(_kept) < MAX_KEPT:
                    _kept.append(kept)
                else:
                    _counters[DROPPED] = _counters.get(DROPPED, 0) + 1
        return False

    @property
    def ms(self) -> float:
        return self.ns / 1e6


def spanned(name: str, root: bool = False):
    """Decorator: each call of the function runs inside ``span(name,
    root)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name, root):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, n: int = 1):
    """Add ``n`` to the counter ``name``."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def context():
    """What a worker thread started here needs to keep its spans as this
    thread would: None while tracing is off, else (request id, parent span
    id). Take it in the thread that starts the worker; pass it to
    :func:`adopt` in the worker."""
    loc = _local
    if not (loc.inherited or _profiler_on()):
        return None
    return loc.request, loc.stack[-1] if loc.stack else loc.parent


def adopt(ctx):
    """In a worker thread: keep spans under the request and parent span of
    ``ctx`` (:func:`context`), or keep none if it is None."""
    loc = _local
    loc.inherited = ctx is not None
    loc.request, loc.parent = ctx if ctx is not None else (None, None)


def snapshot() -> dict:
    """-> {"spans": {name: {"seconds", "calls"}}, "counters": {name: n},
    "launches": {"<module>.<kernel>": n}, "kept": [Span]}."""
    with _lock:
        out = {"spans": {n: {"seconds": ns / 1e9, "calls": c}
                         for n, (ns, c) in _totals.items()},
               "counters": dict(_counters),
               "kept": list(_kept)}
    out["launches"] = {
        f"{mod.rsplit('.', 1)[1]}.{k}": v
        for mod in LAUNCH_MODULES if mod in sys.modules
        for k, v in sys.modules[mod].LAUNCHES.items()}
    return out


def reset():
    """Clear the totals, counters and kept spans."""
    with _lock:
        _totals.clear()
        _counters.clear()
        _kept.clear()


def _union(intervals):
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def span_table(kept, frames: int) -> dict:
    """Each kept span name's total and self ms per frame; self time is the
    part of a span no child span covers."""
    children = {}
    for s in kept:
        children.setdefault(s.parent, []).append(s)
    out = {}
    for s in kept:
        inside = [(max(c.start_ns, s.start_ns), min(c.end_ns, s.end_ns))
                  for c in children.get(s.id, ())]
        own = s.end_ns - s.start_ns
        row = out.setdefault(s.name, [0, 0])
        row[0] += own
        row[1] += own - _union((a, b) for a, b in inside if b > a)
    return {n: {"total_ms_per_frame": round(t / 1e6 / frames, 4),
                "self_ms_per_frame": round(o / 1e6 / frames, 4)}
            for n, (t, o) in sorted(out.items(), key=lambda kv: -kv[1][0])}


def device_ops(prof):
    """(name, start us, end us) of every CUDA kernel, copy and memset in
    ``prof``'s trace (its exported Chrome trace; the ranges of
    ``record_function`` that the trace also puts on the device's timeline
    are left out)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.unlink(path)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    return [(ev["name"], float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]))
            for ev in events
            if ev.get("ph") == "X" and "dur" in ev
            and ev.get("cat") in DEVICE_CATS]


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
    reset()
    before = snapshot()["launches"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(views)
        wall_ms = (time.perf_counter() - t0) * 1e3
    snap = snapshot()
    ops = device_ops(prof)
    busy = _union((s, e) for _, s, e in ops) / 1e3
    by_name = {}
    for name, s, e in ops:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e3
    rows = sorted(by_name.items(), key=lambda r: -r[1])
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
        "spans": span_table(snap["kept"], frames),
        "launches": {k: v - before.get(k, 0)
                     for k, v in snap["launches"].items()},
    }


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Where a clip's device time goes: render_clip under "
        "torch.profiler.")
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
    # Run as ``python -m``, this file is ``__main__``, a second copy of the
    # module: the package's own copy holds the recorder the spans fill.
    from . import profiling
    print(json.dumps(profiling.profile_clip(args.impl, args.tier, args.density,
                                  args.width, args.height, args.edge_cull,
                                  args.frames)), flush=True)


if __name__ == "__main__":
    main()
