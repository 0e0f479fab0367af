"""Bench-payload metric schema: flatten + classify.

Every ``BENCH_<name>.json`` payload is a nested dict of measurement
groups; the comparator needs flat ``metric → scalar`` pairs whose paths
stay STABLE across runs.  :func:`extract_metrics` walks the payload:

* dict keys join with ``.`` (``telemetry.mean_pcg_iters_per_solve``);
* lists of dicts key each element by its discriminator field —
  ``topology`` / ``family`` / ``backend`` / ``offered_rate`` / ... —
  giving ``topologies[grid].adaptive_fused.s_per_solve`` instead of a
  positional index that would reshuffle whenever a bench adds a case;
* ``cfg`` / ``obs`` / ``name`` / ``derived`` subtrees and raw sample
  lists are skipped (configuration echo and unbounded detail, not
  comparable measurements);
* bools become 0/1 so ok-flags (``quality_ok``, ``parity_ok``,
  ``zero_extra_collectives``) gate generically: any True→False flip is
  a regression.

:func:`classify` maps a metric path to ``(kind, direction)``:

    kind        direction   default rel. threshold
    time        lower       0.35   (wall-clock: noisy on shared hosts)
    throughput  higher      0.30
    ratio       higher      0.30   (speedups: a ratio of two walls)
    count       lower|higher 0.05  (iteration counts: deterministic)
    quality     equal|lower 2e-3   (cut values: the benches' own
                                    quality_rtol discipline — voltages
                                    agree per seed, rounding can flip a
                                    borderline node across hosts)
    bool        higher      0      (any flip fires)
    info        —           ∞      (tracked, never gated)

Direction is what "worse" means: a LOWER-is-better latency regresses
upward, a HIGHER-is-better throughput regresses downward, an
EQUAL-direction cut value regresses in either direction.  Unrecognized
metrics default to ``info`` — the gate only ever fires on explicitly
classified measurements.

A copy of the JAX package's ``repro.obs.perf.schema``: the same paths and
classes, so that the two packages read one payload alike.
"""
from __future__ import annotations

import re
from typing import Dict, Iterator, List, Tuple

__all__ = ["extract_metrics", "classify", "KIND_RTOL", "KINDS"]

# discriminator fields tried IN ORDER to key list elements stably
_DISCRIMINATORS = ("topology", "family", "backend", "name", "kind",
                   "offered_rate", "side", "phase")
# subtrees that are configuration/observability echo, not measurements
_SKIP_KEYS = {"cfg", "obs", "name", "derived"}

KINDS = ("time", "throughput", "ratio", "count", "quality", "bool", "info")

#: default relative thresholds per kind (fraction of |baseline median|);
#: the comparator takes max(rtol·|median|, z·1.4826·MAD) so a noisy
#: baseline widens its own gate
KIND_RTOL: Dict[str, float] = {
    "time": 0.35,
    "throughput": 0.30,
    "ratio": 0.30,
    "count": 0.05,
    "quality": 2e-3,
    "bool": 0.0,
    "info": float("inf"),
}

# (regex on the FULL path, kind, direction) — first match wins.  Info
# rules come first so config echoes like max_wait_ms never match the
# *_ms time rule.
_RULES: List[Tuple[str, str, str]] = [
    # -- config echo / context: tracked but never gated ---------------------
    (r"(^|\.)(n|m|side|solves|n_solves|n_waves|batches|base|repeat)$",
     "info", "higher"),
    (r"(^|\.)(max_batch|max_wait_ms|n_requests|n_topos|n_workers)$",
     "info", "higher"),
    (r"(^|\.)(n_pairs|pair_solves|sampled_pairs|refine_changed_edges)$",
     "info", "higher"),
    (r"(^|\.)(parity_rtol|offered_rate|reference_rate)$", "info", "higher"),
    (r"by_worker|flush_reasons|rule_stats|cache\.", "info", "higher"),
    (r"(^|\.)(utilization|mean_batch_size|early_exit_rate)$",
     "info", "higher"),
    (r"share_of_total$|overhead_frac$", "info", "lower"),
    (r"(^|\.)flops$|hbm_bytes$|while_trip_scale$|roofline", "info", "higher"),
    # -- deterministic counts ----------------------------------------------
    (r"pcg_iters|pcg_total|irls_iters|irls_executed", "count", "lower"),
    (r"(^|\.)(kernel_n|kernel_m)$", "count", "lower"),
    (r"(node|edge|iter)_reduction$", "count", "higher"),
    # -- solution quality ---------------------------------------------------
    (r"rel_diff$|rel_gap$|max_rel", "quality", "lower"),
    (r"(^|\.)(cut_value|cut_plain|cut_presolve|cut_adaptive|cut_fixed|"
     r"oracle_cut|global_min_cut_exact|global_min_cut_irls)$",
     "quality", "equal"),
    # -- throughput / ratios ------------------------------------------------
    (r"per_sec$|_gflops$|_gbps$", "throughput", "higher"),
    (r"speedup|slo_attainment", "ratio", "higher"),
    # -- wall-clock ---------------------------------------------------------
    (r"(_|^)(us|ms|s)$|_us_|us_per_call|s_per_solve", "time", "lower"),
    (r"p50|p99|latency|_wall$|seconds", "time", "lower"),
]
_COMPILED = [(re.compile(pat), kind, direction)
             for pat, kind, direction in _RULES]


def classify(path: str) -> Tuple[str, str]:
    """Metric path → ``(kind, direction)``; unrecognized → ``("info", ...)``.

    Bool-valued metrics are detected by VALUE in :func:`extract_metrics`,
    not by name — this function only sees the path.
    """
    leaf = path.rsplit("]", 1)[-1].lstrip(".")
    for rx, kind, direction in _COMPILED:
        if rx.search(leaf) or rx.search(path):
            return kind, direction
    return "info", "higher"


def _element_key(elem: dict, index: int) -> str:
    for d in _DISCRIMINATORS:
        if d in elem and isinstance(elem[d], (str, int, float)):
            v = elem[d]
            if isinstance(v, float):
                v = f"{v:g}"
            return str(v)
    return str(index)


def _walk(obj, path: str) -> Iterator[Tuple[str, float, bool]]:
    if isinstance(obj, dict):
        for k in sorted(obj):
            if not path and k in _SKIP_KEYS:
                continue
            sub = f"{path}.{k}" if path else str(k)
            yield from _walk(obj[k], sub)
    elif isinstance(obj, (list, tuple)):
        if obj and all(isinstance(e, dict) for e in obj):
            for i, e in enumerate(obj):
                yield from _walk(e, f"{path}[{_element_key(e, i)}]")
        # lists of scalars are raw samples (latency traces, batch sizes):
        # unbounded, order-dependent — not comparable metrics
    elif isinstance(obj, bool):
        yield path, float(obj), True
    elif isinstance(obj, (int, float)) and obj == obj:   # finite or inf, not NaN
        yield path, float(obj), False


def extract_metrics(payload: dict) -> List[Dict[str, object]]:
    """Flatten a bench payload into classified scalar metrics.

    Returns ``[{"metric", "value", "kind", "direction"}, ...]`` sorted by
    metric path.  NaN values (sanitized to null in the written payload
    anyway) are dropped; bools are emitted as 0/1 with kind ``bool``.
    """
    out = []
    for path, value, is_bool in _walk(payload, ""):
        if is_bool:
            kind, direction = "bool", "higher"
        else:
            kind, direction = classify(path)
        out.append({"metric": path, "value": value,
                    "kind": kind, "direction": direction})
    out.sort(key=lambda r: r["metric"])
    return out
