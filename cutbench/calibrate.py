#!/usr/bin/env python3
"""The readings that a cell's correctness limits are set from, on the card
at the cell's own size: the program's numbers on many seeds (the lower
readings) and the control's, the reference computed in bfloat16 in the
program's place, on some of them (the upper readings).  Not part of a
benchmark run.

    python3 cutbench/calibrate.py --workload <name> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--seconds 5]

One JSON line a seed: ``program`` (each number compared) and, for a
control seed, ``control``.  Exits non-zero without a CUDA card.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from cutbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in seeds:
        t = time.perf_counter()
        out = harness.run_cell(args.workload, seed, args.seconds, False,
                               control="bfloat16" if seed in control else None)
        line = {"workload": args.workload, "seed": seed,
                "correct": out["correct"], "attempted": out["attempted"],
                "program": {k: v["value"] for k, v in out["compared"].items()},
                "metrics": {k: v["value"] for k, v in out["metrics"].items()},
                "seconds": time.perf_counter() - t}
        if "control" in out:
            line["control"] = out["control"]
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
