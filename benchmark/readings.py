"""The readings a cell's correctness limits are set from: for each seed, the
numbers the check compares for the program and for the control (the
reference one precision step down, in the program's place), from short runs
of the cell in one process, so the set-up's imports and builds are paid
once::

    python benchmark/readings.py --workload <cell> --seconds 3 \\
        --seeds 11 12 13 [--out FILE]

One JSON line a seed on stdout (and appended to ``--out``).
"""

import argparse
import json
import sys
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parent.parent)

from benchmark import harness  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    harness.set_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("readings need a CUDA device", file=sys.stderr)
        return 3
    for seed in args.seeds:
        result, compared, control, run = harness.run_cell(
            args.workload, seed, args.seconds, control=True)
        line = json.dumps({
            "workload": args.workload, "seed": seed,
            "correct": result["correct"], "clips": len(run.clips),
            "program": {c.name: c.value for c in compared},
            "control": control, "kind": run.device_kind,
            "setup_s": run.setup_s})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
