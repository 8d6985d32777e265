"""Run one cell of the port's benchmark on the CUDA device(s) of this host::

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The last line of standard output is the run's JSON result; the numbers the
correctness check compared, each beside its limit, are the last lines of
standard error. See README.md.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# The checkout's root, not this directory, heads the import path.
sys.path[0] = str(Path(__file__).resolve().parent.parent)

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_start=T_START))
