"""Performance trajectory + regression detection (the perf sentinel).

``schema``   — flatten a bench payload into comparable scalar metrics with
               stable dotted paths, each classified into a (kind,
               direction) pair (time/lower, throughput/higher, count/lower,
               quality/equal, ...).
``history``  — the append-only trajectory store, the port's own
               ``TORCH_BENCH_HISTORY.jsonl``: one flattened ``{bench,
               variant, run, git_sha, metric, value}`` record per metric
               per bench run.
``regress``  — the noise-aware comparator: per-metric baseline = median +
               MAD over the last K matching-variant history entries,
               direction-aware classification into regressed / improved /
               flat / new.
``profile``  — continuous profiling: the FLOPs and bytes of each solve,
               counted from its shapes and the steps it took, so that
               ``SolveResult.telemetry`` reports achieved GFLOP/s and the
               H100 roofline fraction per solve (the JAX package asks XLA's
               cost analysis instead).

CLI: ``python -m repro_torch.launch.bench_diff --from-payload`` (diff →
gate).  The port of the JAX package's ``repro.obs.perf``.
"""
from .history import (HISTORY_FILE, append_history, git_sha, history_path,
                      history_records, read_history)
from .profile import default_enabled, per_solve_cost, solve_work
from .regress import Verdict, compare_payload, gate, render_table
from .schema import classify, extract_metrics

__all__ = [
    "HISTORY_FILE", "append_history", "git_sha", "history_path",
    "history_records", "read_history",
    "default_enabled", "per_solve_cost", "solve_work",
    "Verdict", "compare_payload", "gate", "render_table",
    "classify", "extract_metrics",
]
