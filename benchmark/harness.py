"""The benchmark's harness: finds a cell's files by name, drives its window,
reads its metrics and decides ``correct``.

Everything that belongs to one configuration, traffic mix or metric sits in
a file of its own, found by the name ``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: the configuration's sizes and settings;
* ``workloads/<cell>.json``: the cell's configuration, driver, traffic
  parameters and the limits of its correctness check;
* ``drivers/<driver>.py``: a ``Driver(run)`` with ``setup()``,
  ``clip(k) -> frames delivered``, ``release()``, ``check(control=False)
  -> (numbers, failed clips)`` and ``close()``;
* ``metrics/<metric>.py``: ``read(run) -> float or None``.

Traffic is closed-loop: one client asks for clip after clip while the
window is open; the clip in flight when it closes is finished and counted.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import sys
import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from pathlib import Path

from . import check, devtrace

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# Compared by whole top-level name: depthrenderer_tpu_torch is not
# depthrenderer_tpu.
FORBIDDEN = ("jax", "jaxlib", "flax", "depthrenderer_tpu")
CACHE_DIRS = {"TRITON_CACHE_DIR": "triton",
              "TORCH_EXTENSIONS_DIR": "torch_extensions",
              "CUDA_CACHE_PATH": "cuda"}
CLIP_SPAN = "bench.clip"


def forbidden_modules(names=None):
    """The forbidden top-level packages among module ``names`` (default:
    ``sys.modules``)."""
    names = sys.modules if names is None else names
    tops = {str(n).split(".", 1)[0] for n in names}
    return sorted(t for t in tops if t in FORBIDDEN)


def set_cache_dirs(root: Path = ROOT):
    """Kernel and build caches at fixed paths inside the checkout, so only
    a checkout's first run builds."""
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = str(root / ".bench_cache" / sub)


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def plugin(bench_dir: Path, kind: str, name: str):
    """Load ``<bench_dir>/<kind>/<name>.py`` as a module."""
    path = Path(bench_dir) / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} file {path}")
    mod_name = f"_bench_{kind}_{name}".replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(benchmark: dict, cell: str, traced: bool):
    """The metric entries a cell reports: ``end_to_end`` ones untraced,
    ``per_layer`` ones traced; an entry without ``workloads`` belongs to
    every cell (a per-layer one: every cell that reports what it moves)."""
    e2e = [m for m in benchmark["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not traced:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in benchmark["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


@dataclass
class Clip:
    index: int
    start: float
    end: float
    frames: int


@dataclass
class Run:
    """One run of a cell: its files' contents, the clips its window
    counted, the benchmark's spans (host clock) and, traced, the trace."""

    cell: str
    workload: dict
    config: dict
    seed: int
    seconds: float
    device: str
    traced: bool = False
    device_kind: str = "cpu"
    clips: list = field(default_factory=list)
    spans: list = field(default_factory=list)   # (name, start, end)
    notes: dict = field(default_factory=dict)   # set-up readings, for stderr
    window_start: float = 0.0
    setup_s: float = 0.0
    trace: devtrace.Trace | None = None
    tracing: bool = False   # the profiler is on

    @contextmanager
    def span(self, name: str):
        """A benchmark span: host-clock start and end, and a
        ``record_function`` range while the profiler is on."""
        if self.tracing:
            import torch

            rf = torch.profiler.record_function(name)
        else:
            rf = nullcontext()
        t0 = time.perf_counter()
        with rf:
            yield
        self.spans.append((name, t0, time.perf_counter()))

    @contextmanager
    def timed(self, note: str):
        """Host seconds of a set-up step (device work waited for), kept in
        ``notes`` for the run's stderr line."""
        t0 = time.perf_counter()
        yield
        if self.device == "cuda":
            import torch

            torch.cuda.synchronize()
        self.notes[note] = time.perf_counter() - t0

    def span_seconds(self, name: str):
        return [e - s for n, s, e in self.spans
                if n == name and s >= self.window_start]

    @property
    def window_s(self) -> float:
        return self.clips[-1].end - self.window_start

    @property
    def frames(self) -> int:
        return sum(c.frames for c in self.clips)

    @property
    def frames_per_s(self) -> float:
        return self.frames / self.window_s


def _profiler():
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def run_cell(cell: str, seed: int, seconds: float, traced: bool = False, *,
             bench_dir: Path = BENCH, benchmark: dict | None = None,
             device: str = "cuda", t_start: float | None = None,
             control: bool = False):
    """Set up, run the window, read the metrics and check -> (result
    dict, [check.Compared], the control's numbers (with ``control``) or
    None, the :class:`Run`)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    bench_dir = Path(bench_dir)
    if benchmark is None:
        benchmark = load_json(bench_dir.parent / "BENCHMARK.json")
    entry = {w["name"]: w for w in benchmark["workloads"]}[cell]
    workload = load_json(bench_dir / "workloads" / f"{cell}.json")
    config = load_json(bench_dir / "configs" / f"{entry['config']}.json")
    run = Run(cell, workload, config, int(seed), float(seconds), device,
              traced)
    if device == "cuda":
        run.device_kind = torch.cuda.get_device_name(0)
    if "host_threads" in workload["traffic"]:
        # Few host threads: the host's share of a clip (the mesh build)
        # then varies less from run to run on a shared host.
        torch.set_num_threads(int(workload["traffic"]["host_threads"]))
    driver = plugin(bench_dir, "drivers", workload["driver"]).Driver(run)
    try:
        driver.setup()
        trace_clips = int(workload["traffic"].get("trace_clips", 1))
        prof = None
        if traced:
            # Started before the window: the profiler's own start-up (CUPTI)
            # takes seconds.
            prof = _profiler()
            prof.start()
            run.tracing = True
        if device == "cuda":
            torch.cuda.synchronize()
        run.window_start = time.perf_counter()
        run.setup_s = run.window_start - t_start
        deadline = run.window_start + run.seconds
        k = 0
        while k == 0 or time.perf_counter() < deadline:
            with run.span(CLIP_SPAN):
                t0 = time.perf_counter()
                frames = driver.clip(k)
                t1 = time.perf_counter()
            run.clips.append(Clip(k, t0, t1, frames))
            k += 1
            if prof is not None and k == trace_clips:
                run.tracing = False
                prof.stop()
        if prof is not None and run.tracing:
            run.tracing = False
            prof.stop()
        peak = 0
        if device == "cuda":
            torch.cuda.synchronize()
            peak = int(torch.cuda.max_memory_allocated())
        driver.release()
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        if prof is not None:
            traced_frames = sum(c.frames for c in run.clips[:trace_clips])
            run.trace = devtrace.from_profiler(prof, traced_frames, CLIP_SPAN)
            del prof
        values, failed = driver.check()
        compared = check.judge(values, workload["check"]["limits"])
        control_values = driver.check(control=True)[0] if control else None
    finally:
        driver.close()

    metrics = {}
    for m in cell_metrics(benchmark, cell, traced):
        value = plugin(bench_dir, "metrics", m["name"]).read(run)
        if value is None:
            if not traced:
                raise RuntimeError(f"end-to-end metric {m['name']} read "
                                   f"nothing")
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": run.device_kind,
           "count": int(entry["chips"]),
           "memory_peak_bytes": peak}
    result = {"correct": all(c.ok for c in compared),
              "attempted": len(run.clips),
              "failed": len(failed),
              "metrics": metrics,
              "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in compared}
    run.notes.update(clips=len(run.clips), frames=run.frames,
                     window_s=run.window_s, setup_s=run.setup_s)
    return result, compared, control_values, run


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Run one benchmark cell.")
    p.add_argument("--workload", required=True, help="the cell's name")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True,
                   help="length of the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, t_start=None):
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse_args(argv)
    benchmark = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in benchmark["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}; BENCHMARK.json has "
              f"{sorted(cells)}", file=sys.stderr)
        return 2
    set_cache_dirs()
    import torch

    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    result, compared, _, run = run_cell(
        args.workload, args.seed, args.seconds, bool(args.trace),
        benchmark=benchmark, t_start=t_start)
    return report(result, compared, run.notes)


def report(result: dict, compared, notes: dict) -> int:
    """The run's end, once its window has closed: refuse (exit 4, no
    result) if a forbidden package was loaded; else the run's notes and
    the numbers compared with their limits as the last lines of stderr,
    and the result as the last line of stdout."""
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules were loaded: {bad}", file=sys.stderr)
        return 4
    print("[run] " + " ".join(f"{k}={v}" for k, v in notes.items()),
          file=sys.stderr)
    for c in compared:
        print(f"[check] {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
