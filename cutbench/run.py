#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` on one NVIDIA card.

    python3 cutbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Prints the result as one JSON object on the
last line of standard output, and each number the correctness check
compared, with its limit, as the last lines of standard error.  Exits
non-zero, printing no result, without a CUDA card.
"""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from cutbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
