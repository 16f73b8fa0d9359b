"""Run one cell of BENCHMARK.json once on a CUDA card and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. The last line of standard output is one JSON
object (correct, attempted, failed, metrics, device, with --trace 1 a
breakdown, and last the numbers compared with their limits); the numbers
compared are also the last lines of standard error. Without a CUDA card it
exits non-zero and prints no result.
"""

import time

_T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.harness.runner import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=_T_START))
