"""``python -m depthrenderer_tpu_torch.probes`` — run the probe cases.

    python -m depthrenderer_tpu_torch.probes [--case NAME ...]
        [--device cuda|cpu] [--quick] [--json PATH] [--order random|lanes]
        [--blocks N]

For every case (all of them by default) it prints one line: the kernel
against its plain twin at the check trip count (bit for bit), then, on the
card, the probe's own timing: the kernel's time at the case's two trip
counts (CUDA events around 20 back-to-back launches queued behind a
device-side sleep, so the host's launch cost is not timed), and their
difference over the extra trips as ns per lookup and lookups/s; the blocks
and SMs the launch occupies; and the bound: the shared-memory words a
gather reads at 32 a clock per SM used, FP32 multiply-adds at 128 a clock
per SM used (onehot_dot, the baselines, march_top2's subtract and multiply
per column), or the transpose's bytes over 3.35 TB/s, at the card's
maximum SM clock (``nvidia-smi --query-gpu=clocks.max.sm``).

``--device`` defaults to ``cuda`` and raises without a CUDA device;
``--device cpu`` runs every wrapper's plain twin (the check is then the
twin against itself, and nothing is timed: no device number comes from
the CPU). ``--quick`` takes the shorter trip pairs where a case has a long
count (gather_probe9's 65,536 trips: timed at 2,048 and 8,192;
gather_probe10's 65,536: its 1,024 and 8,192 pair).

Two questions the TPU probes did not need to ask: ``--order lanes`` gives
every gather the index ``l`` at lane ``l`` (no shared-memory bank
conflict) instead of the probe's random one, and ``--blocks N`` has
gather_accum, roll_accum and march_top2 compute as many identical outputs
as take about N blocks (each output on its own blocks), so that the card
holds more warps than the probe's one tile gives it (their latency hidden)
and the time per lookup is a throughput.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

from . import (CASES, COPIED, ORDERS, bound_work, check_trips, geometry,
               lookups_per_trip, make_inputs, run_case, sms_used, timing_trips)

HBM_BYTES_PER_S = 3.35e12
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
        res["check_ms"] = device_ms(kernel, 5)
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


def measure_case(case, ins, reps: int, quick: bool, clock_mhz,
                 n_sms: int, copies: int = 1) -> dict:
    """The probe's slope timing on the card."""
    t1, t2 = timing_trips(case, quick)
    ms1 = device_ms(lambda: run_case(case, ins, t1, copies=copies), reps)
    bound, by = bound_ns_per_trip(case, clock_mhz, n_sms, copies)
    n = lookups_per_trip(case) * copies
    res = {"trips": [t1, t2], "ms": [ms1], "bound_by": by,
           "blocks": geometry(case)[2] * copies,
           "sms": sms_used(case, n_sms, copies)}
    if t2 > t1:
        ms2 = device_ms(lambda: run_case(case, ins, t2, copies=copies), reps)
        per_trip = (ms2 - ms1) * 1e6 / (t2 - t1)
        res["ms"].append(ms2)
    else:
        per_trip = ms1 * 1e6
    res.update(ns_per_trip=per_trip, ns_per_lookup=per_trip / n,
               lookups_per_s=n / per_trip * 1e9 if per_trip > 0 else None)
    if bound is not None:
        res.update(bound_ns_per_lookup=bound / n,
                   x_bound=per_trip / bound if bound > 0 else None)
    if case.kernel == "transpose":
        res["library_ms"] = device_ms(lambda: ins["x"].t().contiguous(),
                                      reps)
    return res


def _fmt(v):
    if isinstance(v, float):
        return f"{v:.6g}"
    if isinstance(v, list):
        return ",".join(_fmt(x) for x in v)
    return str(v)


def run(cases, device="cuda", quick=False, check=True, reps=20,
        order="random", blocks=0, out=print) -> list:
    """Check (``check``) and, on the card, time every case (in ``order``;
    gather_accum, roll_accum and march_top2 with as many copies as make
    about ``blocks`` blocks); prints one line a case through ``out`` and
    returns the results."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the probes run on a CUDA device; pass "
                               "--device cpu for the plain twins")
        clock = max_sm_clock_mhz()
        n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
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
        if dev.type == "cuda":
            res.update(measure_case(case, ins, reps, quick, clock, n_sms, n))
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
                    help="copy gather_accum's, roll_accum's and "
                    "march_top2's output over about this many blocks")
    args = ap.parse_args(argv)
    cases = [c for c in CASES.values() if not args.case or c.name in args.case]
    results = run(cases, args.device, quick=args.quick, order=args.order,
                  blocks=args.blocks)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    bad = [r["name"] for r in results if not r["equal"]]
    if bad:
        print(f"kernel and twin differ: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
