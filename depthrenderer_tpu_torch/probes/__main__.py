"""``python -m depthrenderer_tpu_torch.probes`` — run the probe cases.

    python -m depthrenderer_tpu_torch.probes [--case NAME ...]
        [--device cuda|cpu] [--quick] [--json PATH] [--order random|lanes]
        [--blocks N] [--beside PATH] [--sass]

For every case (all of them by default) it prints one line: the kernel
against its plain twin at the check trip count (bit for bit), then, on the
card, the probe's own timing: the kernel's time at the case's two trip
counts (CUDA events around 20 back-to-back launches queued behind a
device-side sleep, so the host's launch cost is not timed; the transpose,
whose time is its launch, from CUDA graphs of 20 and 40 captured launches:
the difference over 20), and their difference over the extra trips as ns
per lookup and lookups/s; the blocks and SMs the launch occupies; and the
bound: the shared-memory words a gather or the roll reads at 32 a clock per
SM used, FP32 multiply-adds at 128 a clock per SM used (the baselines,
march_top2's subtract and multiply per column), onehot_dot's multiply-adds
on its three bf16 parts at the tensor cores' 2,048 a clock per SM used
(and, as ``x_fp32``, its one float32 product at FP32's rate), or the
transpose's bytes over 3.35 TB/s, at the card's maximum SM clock
(``nvidia-smi --query-gpu=clocks.max.sm``). Beside that bound
(``x_bound``), for a gather: the shared-memory bound counted in the bank
wavefronts the case's indices give under gather_accum's layout
(``wavefronts``, ``x_wave``; :func:`~depthrenderer_tpu_torch.probes.
wavefronts`); ``x_stated`` is the time over the larger of the two. Where one
PyTorch call computes a unit of the work (:func:`library_call`: the
transpose's ``x.t().contiguous()``, a trip of onehot_dot as
``torch.matmul`` in full float32, a set of roll_accum as ``torch.roll``),
its time from CUDA graphs of 20 and 40 calls (``library_ms``; a trip's
worth, ``library_trip_ms``) and the kernel's time a trip of one output over
it (``x_library``).

``--device`` defaults to ``cuda`` and raises without a CUDA device;
``--device cpu`` runs every wrapper's plain twin (the check is then the
twin against itself, and nothing is timed: no device number comes from
the CPU). ``--quick`` takes the shorter trip pairs where a case has a long
count (gather_probe9's 65,536 trips: timed at 2,048 and 8,192;
gather_probe10's 65,536: its 1,024 and 8,192 pair).

Two questions the TPU probes did not need to ask: ``--order lanes`` gives
every gather the index ``l`` at lane ``l`` (no shared-memory bank
conflict) instead of the probe's random one, and ``--blocks N`` has
gather_accum, roll_accum, onehot_dot and march_top2 compute as many
identical outputs as take about N blocks (each output on its own blocks),
so that the card holds more warps than the probe's one tile gives it (their
latency hidden) and the time per lookup is a throughput.

``--beside PATH`` builds another ``probes.cu`` (a parent's: ``git show
HEAD~1:depthrenderer_tpu_torch/csrc/probes.cu > chip_tmp/parent.cu``) into
``build/beside/`` beside the package's (one nvcc each, started together),
holds its kernels against the twins too, and times every case with both
libraries in turns (other, this, this, other): ``beside_*`` beside the
package's numbers, each the mean of its two runs. ``--sass`` reads
``cuobjdump -sass`` of the built library and prints, per case of
gather_accum, roll_accum, onehot_dot and march_top2, the instructions of
its kernel's hot loop (the innermost loop with the most loads, the most
HMMA for onehot_dot, or the sweep's column loop) per lookup (per HMMA for
onehot_dot; per column of one pixel and trip for march_top2), and the time
over the issue floor they set (``x_issue``: 4 warp instructions a clock per
SM; for the march, the instructions its vote cannot skip); where the loop
converts with I2F (16 a clock per SM), the time over that unit's floor
(``x_conv``), which sets ``x_stated`` where it binds.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from .. import probes
from . import (CASES, COPIED, FP32_MACS_PER_CLOCK, ORDERS, bound_work,
               check_trips, geometry, lookups_per_trip, make_inputs,
               onehot_macs, run_case, sms_used, timing_trips, wavefronts)

HBM_BYTES_PER_S = 3.35e12
# Multiply-adds of one mma.sync m16n8k16 (onehot_dot's HMMA).
MMA_MACS = 16 * 8 * 16
# Device-side sleep queued ahead of each timed run, per launch: longer than
# the host takes to enqueue one launch, so the launches run back to back.
_SLEEP_CYCLES_PER_LAUNCH = 400_000


def device_inputs(case, device, seed: int = 0, order: str = "random"):
    return {k: torch.from_numpy(v).to(device)
            for k, v in make_inputs(case, seed, order).items()}


def device_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` launches."""
    fn()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(_SLEEP_CYCLES_PER_LAUNCH * reps)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_ms(fn, reps: int) -> float:
    """Device milliseconds one call of ``fn()`` adds to a CUDA graph:
    graphs of ``reps`` and of ``2 * reps`` captured calls, each replayed
    three times (CUDA events around each replay, the least kept); their
    difference over ``reps`` is a call's time without the host's launch
    cost or the graph's own."""
    fn()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    best = []
    for n in (reps, 2 * reps):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(n):
                fn()
        graph.replay()
        runs = []
        for _ in range(3):
            start.record()
            graph.replay()
            stop.record()
            torch.cuda.synchronize()
            runs.append(start.elapsed_time(stop))
        best.append(min(runs))
    return (best[1] - best[0]) / reps


def launch_ms(case, fn, reps: int) -> float:
    """The time of one launch of ``fn``: the transpose, a copy of a few KB
    whose time is its launch, from CUDA graphs of at least 20 launches
    (:func:`graph_ms`); the other kernels from ``reps`` back-to-back
    launches (:func:`device_ms`)."""
    if case.kernel == "transpose":
        return graph_ms(fn, max(reps, 20))
    return device_ms(fn, reps)


def wall_ms(fn) -> float:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def max_sm_clock_mhz():
    """The card's maximum SM clock (nvidia-smi), or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.CalledProcessError, ValueError, IndexError):
        return None


def compare(got, want):
    """(equal bit for bit, max abs difference over the finite values; 0
    when equal, inf when the non-finite values differ)."""
    if torch.equal(got.view(torch.int32), want.view(torch.int32)):
        return True, 0.0
    a, b = got.double(), want.double()
    fin = torch.isfinite(a) & torch.isfinite(b)
    if not torch.equal(fin, torch.isfinite(a) | torch.isfinite(b)):
        return False, float("inf")
    return False, float((a - b)[fin].abs().max())


def check_case(case, ins, copies: int = 1) -> dict:
    """The kernel (or, on the CPU, the wrapper's twin) against the twin at
    the case's check trip count, and both times there (the twin's by the
    host clock)."""
    trips = check_trips(case)

    def kernel(plain=False):
        return run_case(case, ins, trips, plain, copies)

    got = kernel()
    plain_ms = wall_ms(lambda: kernel(plain=True))
    equal, err = compare(got, kernel(plain=True))
    res = {"check_trips": trips, "equal": equal, "max_abs_err": err,
           "plain_ms": plain_ms}
    if got.is_cuda:
        res["check_ms"] = launch_ms(case, kernel, 5)
    return res


def bound_ns_per_trip(case, clock_mhz, n_sms: int, copies: int = 1):
    work, rate, by = bound_work(case)
    work *= copies
    if rate is None:
        return work / HBM_BYTES_PER_S * 1e9, by
    if clock_mhz is None:
        return None, by
    sms = sms_used(case, n_sms, copies)
    return work / (rate * sms * clock_mhz * 1e6) * 1e9, by


def bound_fields(case, ins, per_trip, clock_mhz, n_sms: int,
                 copies: int = 1) -> dict:
    """A trip's time (ns) against the case's bounds: the plain one
    (``x_bound``), the shared-memory bound in wavefronts (``x_wave``) for a
    gather, and ``x_stated`` against the larger."""
    bound, by = bound_ns_per_trip(case, clock_mhz, n_sms, copies)
    n = lookups_per_trip(case) * copies
    res = {"ns_per_trip": per_trip, "ns_per_lookup": per_trip / n,
           "lookups_per_s": n / per_trip * 1e9 if per_trip > 0 else None,
           "bound_by": by}
    if bound is None or bound <= 0:
        return res
    res.update(bound_ns_per_lookup=bound / n, x_bound=per_trip / bound)
    stated = {by: bound}
    if by == "smem":
        waves = wavefronts(case, {k: v.cpu().numpy() for k, v in
                                  ins.items()})
        stated["smem_waves"] = bound * waves
        res.update(wavefronts=waves, x_wave=per_trip / (bound * waves))
    key = max(stated, key=stated.get)
    res.update(stated_by=key, x_stated=per_trip / stated[key])
    if case.kernel == "onehot_dot":
        sms = sms_used(case, n_sms, copies)
        fp32 = onehot_macs(case) * copies / (
            FP32_MACS_PER_CLOCK * sms * clock_mhz * 1e6) * 1e9
        res.update(bound_fp32_ns_per_lookup=fp32 / n, x_fp32=per_trip / fp32)
    return res


def slope_ns_per_trip(case, ins, reps: int, quick: bool, copies: int = 1):
    """(trips, ms at each, ns a trip): the probe's slope timing."""
    t1, t2 = timing_trips(case, quick)
    ms1 = launch_ms(case, lambda: run_case(case, ins, t1, copies=copies),
                    reps)
    if t2 <= t1:
        return [t1, t2], [ms1], ms1 * 1e6
    ms2 = device_ms(lambda: run_case(case, ins, t2, copies=copies), reps)
    return [t1, t2], [ms1, ms2], (ms2 - ms1) * 1e6 / (t2 - t1)


def library_call(case, ins):
    """(fn, calls a trip) for the one PyTorch call that computes a unit of
    the case's work, or None: the transpose's ``x.t().contiguous()`` (its
    launch); onehot_dot's ``torch.matmul`` of trip 0's prebuilt float32
    one-hot (P, R) by the table (a trip; in full float32, see
    :func:`full_f32_matmul`); roll_accum's ``torch.roll(tab, k, dims=1)``
    at the first set's shift (a set: ``unroll`` a trip)."""
    if case.kernel == "transpose":
        x = ins["x"]
        return (lambda: x.t().contiguous()), 1
    if case.kernel == "onehot_dot":
        tab, idx = ins["tab"], ins["idx"]
        cells = torch.arange(tab.shape[0], device=tab.device)
        oh = (cells[None, :] == idx % tab.shape[0]).float()
        return (lambda: torch.matmul(oh, tab)), 1
    if case.kernel == "roll_accum":
        tab, k = ins["tab"], int(ins["sh"][0, 0])
        return (lambda: torch.roll(tab, k, dims=1)), case.unroll
    return None


@contextlib.contextmanager
def full_f32_matmul():
    """float32 matrix products in full float32 inside (no TF32)."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    precision = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.set_float32_matmul_precision(precision)


def library_fields(case, ins, res, reps: int, copies: int) -> dict:
    """The library call's time in CUDA graphs of 20 and 40 calls (at least)
    beside the kernel's: ``library_ms`` a call, ``library_trip_ms`` a trip's
    calls, ``x_library`` the kernel's time a trip of one output over it."""
    lib = library_call(case, ins)
    if lib is None:
        return {}
    fn, calls = lib
    with full_f32_matmul():
        ms = graph_ms(fn, max(reps, 20))
    out = {"library_ms": ms, "library_trip_ms": ms * calls}
    if "ns_per_trip" in res and ms > 0:
        out["x_library"] = res["ns_per_trip"] * 1e-6 / copies / (ms * calls)
    return out


def measure_case(case, ins, reps: int, quick: bool, clock_mhz,
                 n_sms: int, copies: int = 1) -> dict:
    """The probe's slope timing on the card, beside the library call's."""
    trips, ms, per_trip = slope_ns_per_trip(case, ins, reps, quick, copies)
    res = {"trips": trips, "ms": ms, "blocks": geometry(case)[2] * copies,
           "sms": sms_used(case, n_sms, copies)}
    res.update(bound_fields(case, ins, per_trip, clock_mhz, n_sms, copies))
    res.update(library_fields(case, ins, res, reps, copies))
    if case.kernel == "transpose":
        # Both as back-to-back launches from the host too (where the
        # launch itself is timed).
        res.update(
            stream_ms=device_ms(lambda: run_case(case, ins, trips[0]), reps),
            library_stream_ms=device_ms(library_call(case, ins)[0], reps))
    return res


@contextlib.contextmanager
def using(lib):
    """Launch the probe kernels from ``lib`` (a bound library) inside."""
    before = probes._lib
    probes._lib = lib
    try:
        yield
    finally:
        probes._lib = before


def build_beside(beside):
    """Build the package's probes.cu and ``beside`` (one nvcc each, started
    together) -> {"this": lib, "beside": lib}, bound."""
    from ..march_times import build_libs

    built = build_libs(Path(beside), source="probes.cu")
    return {k: probes.bind(ctypes.CDLL(str(v[1]))) for k, v in built.items()}


def measure_beside(case, ins, libs, reps, quick, clock, n_sms, copies):
    """The slope timing with both libraries in turns (other, this, this,
    other): the package's fields, each the mean of its two runs, and the
    other's as ``beside_*``."""
    runs = {"this": [], "beside": []}
    for label in ("beside", "this", "this", "beside"):
        with using(libs[label]):
            runs[label].append(slope_ns_per_trip(case, ins, reps, quick,
                                                 copies))
    res = {"trips": runs["this"][0][0], "blocks": geometry(case)[2] * copies,
           "sms": sms_used(case, n_sms, copies)}
    for label, prefix in (("this", ""), ("beside", "beside_")):
        r = runs[label]
        ms = [sum(x[1][i] for x in r) / len(r) for i in range(len(r[0][1]))]
        per_trip = sum(x[2] for x in r) / len(r)
        fields = dict(ms=ms, **bound_fields(case, ins, per_trip, clock,
                                            n_sms, copies))
        res.update({prefix + k: v for k, v in fields.items()})
    res["speedup"] = res["beside_ns_per_trip"] / res["ns_per_trip"]
    res.update(library_fields(case, ins, res, reps, copies))
    return res


def sass_label_marker(case):
    """(kernel label in the SASS, the opcode a lookup issues once or twice
    (per column of one pixel and trip for march_top2; onehot_dot's unit is
    its HMMA), how many times)."""
    if case.kernel == "march_top2":
        return "march_top2_kernel", "FMUL", 1
    if case.kernel == "onehot_dot":
        return "onehot_dot_kernel", "HMMA", 1
    if case.kernel == "roll_accum":
        return f"roll_accum_kernel<{case.unroll}>", "LDS", 1
    args = (probes.FORMS[case.form], probes.AXES[case.axis],
            probes.DTYPES[case.dtype], case.naccs, case.unroll)
    label = "gather_accum_kernel<" + ", ".join(map(str, args)) + ">"
    if case.form == "fma":
        return label, "FFMA", 1
    if case.form == "convert":
        return label, "FADD", 1
    return label, "LDS", 2 if case.form in ("clip2", "and2") else 1


def sass_fields(case, kernels) -> dict:
    """The case's hot loop (the innermost with the most markers) in the SASS
    ``kernels`` (:func:`~depthrenderer_tpu_torch.ops.cuda_build.sass`):
    its instructions, lookups and instructions a lookup (``sass_per_lookup``;
    where a branch inside can skip a stretch of it, as the march's vote
    does, also without that stretch: ``sass_fast_per_lookup``) and its
    commonest opcodes."""
    from ..ops import cuda_build

    label, marker, per = sass_label_marker(case)
    loops = cuda_build.sass_loops(kernels.get(label, []))
    if not loops:
        return {"sass_kernel": label, "sass": "no loop found"}
    _, _, ops, guarded = max(loops, key=lambda lp: lp[2][marker])
    # The march's update recomputes the products it guards: count a column
    # once, outside.
    lookups = (ops[marker] - guarded[marker]) / per
    if not lookups:
        return {"sass_kernel": label, "sass": f"no {marker} in a loop"}
    total, skip = sum(ops.values()), sum(guarded.values())
    res = {"sass_kernel": label, "sass_loop_instrs": total,
           "sass_loop_lookups": lookups, "sass_per_lookup": total / lookups}
    if skip:
        res["sass_fast_per_lookup"] = (total - skip) / lookups
    if ops["I2F"]:
        res["sass_i2f_per_lookup"] = ops["I2F"] / lookups
    res["sass_ops"] = ",".join(f"{o}:{n}" for o, n in ops.most_common(8))
    return res


# Conversions a clock per SM of I2F, the int-to-float unit a conversion
# from 16 bits (bitcast's epilogue) takes; I2FP, which converts 32 bits (the
# u32 epilogue, the convert baseline), is not this slow.
I2F_PER_CLOCK = 16


def issue_fields(case, res, clock_mhz, n_sms: int, copies: int) -> dict:
    """From the hot loop's SASS: the time over the issue floor of its
    instructions (those no branch inside it skips; 4 warp instructions a
    clock per SM used), and, where it converts with I2F, over that unit's
    floor (``x_conv``, which then also sets ``x_stated`` if it binds)."""
    per = res.get("sass_fast_per_lookup", res.get("sass_per_lookup"))
    if per is None or clock_mhz is None or "ns_per_trip" not in res:
        return {}
    # Units of the SASS count a trip, and how many a warp instruction
    # covers: lookups or columns of a sweep (a thread's each), or HMMA.
    units, lanes = lookups_per_trip(case) * copies, 32
    if case.kernel == "march_top2":
        units *= case.table[1]
    elif case.kernel == "onehot_dot":
        units, lanes = bound_work(case)[0] * copies / MMA_MACS, 1
    hz = sms_used(case, n_sms, copies) * clock_mhz * 1e6
    t = res["ns_per_trip"]
    out = {"x_issue": t / (units / lanes * per / (4 * hz) * 1e9)}
    i2f = res.get("sass_i2f_per_lookup", 0)
    if i2f:
        conv = units * i2f / (I2F_PER_CLOCK * hz) * 1e9
        out["x_conv"] = t / conv
        if t / conv < res.get("x_stated", float("inf")):
            out.update(stated_by="i2f", x_stated=t / conv)
    return out


def _fmt(v):
    if isinstance(v, float):
        return f"{v:.6g}"
    if isinstance(v, list):
        return ",".join(_fmt(x) for x in v)
    return str(v)


def run(cases, device="cuda", quick=False, check=True, reps=20,
        order="random", blocks=0, out=print, beside=None,
        sass=False) -> list:
    """Check (``check``) and, on the card, time every case (in ``order``;
    the copied kernels (``COPIED``) with as many copies as make
    about ``blocks`` blocks; ``beside`` another probes.cu timed in turns,
    ``sass`` the hot loops' instructions a lookup); prints one line a case
    through ``out`` and returns the results."""
    dev = torch.device(device)
    libs = kernels = None
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the probes run on a CUDA device; pass "
                               "--device cpu for the plain twins")
        clock = max_sm_clock_mhz()
        n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
        if beside is not None:
            libs = build_beside(beside)
            probes._lib = libs["this"]
        if sass:
            from ..ops import cuda_build

            kernels = cuda_build.sass(probes.build_kernels())
    elif beside is not None or sass:
        raise RuntimeError("--beside and --sass read the card's kernels")
    results = []
    for case in cases:
        ins = device_inputs(case, dev, order=order)
        n = 1
        if case.kernel in COPIED:
            n = max(1, blocks // geometry(case)[2])
        res = {"name": case.name, "kernel": case.kernel, "site": case.site,
               "order": order, "copies": n}
        if check:
            res.update(check_case(case, ins, n))
            if libs is not None:
                with using(libs["beside"]):
                    res["beside_equal"] = check_case(case, ins, n)["equal"]
        if dev.type == "cuda":
            if libs is not None:
                res.update(measure_beside(case, ins, libs, reps, quick, clock,
                                          n_sms, n))
            else:
                res.update(measure_case(case, ins, reps, quick, clock, n_sms,
                                        n))
            if kernels is not None and case.kernel != "transpose":
                res.update(sass_fields(case, kernels))
                res.update(issue_fields(case, res, clock, n_sms, n))
        else:
            res["timing"] = "not measured (cpu)"
        out("[probe] " + " ".join(f"{k}={_fmt(v)}" for k, v in res.items()))
        results.append(res)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m depthrenderer_tpu_torch.probes",
        description=__doc__.splitlines()[0])
    ap.add_argument("--case", action="append", choices=sorted(CASES),
                    help="run this case (repeatable; default: all)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--quick", action="store_true",
                    help="shorter trip pairs for the long cases")
    ap.add_argument("--json", help="also write the results to this file")
    ap.add_argument("--order", default="random", choices=ORDERS,
                    help="the probes' random indices, or lane l's index l")
    ap.add_argument("--blocks", type=int, default=0,
                    help="copy the output of gather_accum, roll_accum, "
                    "onehot_dot and march_top2 over about this many blocks")
    ap.add_argument("--beside", type=Path, default=None,
                    help="also build this other probes.cu and time it in "
                    "turns with the package's")
    ap.add_argument("--sass", action="store_true",
                    help="print the hot loops' SASS instructions a lookup")
    args = ap.parse_args(argv)
    cases = [c for c in CASES.values() if not args.case or c.name in args.case]
    results = run(cases, args.device, quick=args.quick, order=args.order,
                  blocks=args.blocks, beside=args.beside, sass=args.sass)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    bad = [r["name"] for r in results
           if not r["equal"] or not r.get("beside_equal", True)]
    if bad:
        print(f"kernel and twin differ: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
