"""Bench regression sentinel CLI of the port — diff → gate.

  # classify an existing payload against the port's trajectory
  PYTHONPATH=src python -m repro_torch.launch.bench_diff \\
      --from-payload PAYLOAD.json [--history TORCH_BENCH_HISTORY.jsonl]

  # strict gate: machine-independent kinds only, baselines required
  PYTHONPATH=src python -m repro_torch.launch.bench_diff --gate \\
      --from-payload PAYLOAD.json

Each payload is classified against the last K history entries of the
SAME bench and variant (smoke vs full) — per-metric median + MAD,
direction-aware thresholds (``repro_torch.obs.perf.regress``).  Exits 1
when any selected-kind metric classifies regressed, 2 under ``--gate``
when a payload has no baseline (a silently-green gate is worse than a red
one).  ``--gate`` also narrows the gated kinds to ``count,quality,bool``
unless ``--kinds`` says otherwise: iteration counts, cut values and
ok-flags transfer across machines, wall-clock baselines recorded on one
host do not.

The JAX package's ``repro.launch.bench_diff`` also runs its benches
(``benchmarks.run``) and records them first.  The port has no benchmarks
of its own yet, so here a run without ``--from-payload`` stops with an
error that says so.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

#: the JAX package's benches that the port has no counterpart of
MISSING_BENCHES = ("irls", "serve", "cuttree", "sharded", "kernel", "drift")


def _repo_root() -> str:
    here = os.path.abspath(os.path.dirname(__file__))
    return os.path.dirname(os.path.dirname(os.path.dirname(here)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gate", action="store_true",
                    help="CI mode: machine-independent kinds only (unless "
                         "--kinds), missing baselines fail with exit 2")
    ap.add_argument("--kinds", default=None,
                    help="comma-separated metric kinds to gate on "
                         "(default: all gateable; --gate: count,quality,bool)")
    ap.add_argument("--from-payload", nargs="*", default=None,
                    metavar="FILE",
                    help="classify existing payload file(s)")
    ap.add_argument("--history", default=None,
                    help="trajectory file (default "
                         "<repo>/TORCH_BENCH_HISTORY.jsonl)")
    ap.add_argument("--k", type=int, default=8,
                    help="baseline window: last K matching entries")
    ap.add_argument("--z", type=float, default=4.0,
                    help="MAD z-score for the noise term of the threshold")
    ap.add_argument("--show", choices=("changed", "all", "gated"),
                    default="changed", help="table verbosity")
    args = ap.parse_args(argv)

    from ..obs.perf import history as hist
    from ..obs.perf import regress

    if args.from_payload is None:
        ap.error("the port has no torch benchmarks yet (the JAX package's "
                 f"{', '.join(MISSING_BENCHES)} benches run on JAX): nothing "
                 "to run or record; classify a payload with --from-payload")

    if args.kinds is not None:
        kinds = tuple(k.strip() for k in args.kinds.split(",") if k.strip())
    elif args.gate:
        kinds = ("count", "quality", "bool")
    else:
        kinds = None                      # all gateable

    history_file = args.history or hist.history_path(_repo_root())
    baseline = hist.read_history(history_file)

    payloads = []
    for f in args.from_payload:
        with open(f) as fh:
            payloads.append(json.load(fh))

    exit_code = 0
    missing_baseline = []
    for payload in payloads:
        verdicts = regress.compare_payload(payload, baseline, k=args.k,
                                           z=args.z)
        print(regress.render_table(verdicts, show=args.show))
        bad = regress.gate(verdicts, kinds)
        if bad:
            exit_code = 1
            for v in bad:
                print(f"  REGRESSED [{v.kind}] {v.bench}:{v.metric} "
                      f"{v.baseline_median:.6g} -> {v.current:.6g} "
                      f"(threshold ±{v.threshold:.3g})", file=sys.stderr)
        if args.gate and verdicts and \
                all(v.classification == "new" for v in verdicts):
            missing_baseline.append(payload.get("name", "?"))
        print()
    if missing_baseline:
        print(f"--gate: no committed baseline for "
              f"{', '.join(missing_baseline)} — seed {history_file} first "
              f"(run bench_diff without --gate after appending the "
              f"payload's history)", file=sys.stderr)
        return 2
    return exit_code


if __name__ == "__main__":
    sys.exit(main())
