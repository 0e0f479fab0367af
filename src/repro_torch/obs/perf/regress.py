"""Noise-aware bench comparator: baseline = median + MAD, direction-aware.

For each metric the baseline is the last K matching ``(bench, metric,
variant)`` entries of the trajectory (``history.py``).  The decision
threshold is

    max(rtol_kind · |median|,  z · 1.4826 · MAD,  atol_kind)

so a deterministic metric (MAD = 0) gates at the kind's relative
tolerance while a noisy one widens its own gate — 1.4826·MAD estimates
the standard deviation robustly (no single outlier run can poison the
baseline the way a mean/stddev fit would), and z = 4 puts the false-
positive rate per metric in the 1e-4 range under roughly normal noise.
Classification is direction-aware: a lower-is-better latency regresses
UPWARD, a higher-is-better throughput regresses DOWNWARD, an
equal-direction cut value regresses either way.  Metrics with no
baseline classify ``new``; ``info`` metrics always classify ``flat``.

A copy of the JAX package's ``repro.obs.perf.regress``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from .history import payload_variant
from .schema import KIND_RTOL, extract_metrics

__all__ = ["Verdict", "compare_payload", "gate", "render_table",
           "MAD_SIGMA", "DEFAULT_Z"]

MAD_SIGMA = 1.4826        # MAD → sigma under normal noise
DEFAULT_Z = 4.0
DEFAULT_K = 8

#: absolute floors per kind: a bool flip is |Δ| = 1 (floor 0.5); quality
#: metrics compare near-zero rel-diffs (floor 1e-9); everything else
#: relies on the relative term
_KIND_ATOL = {"bool": 0.5, "quality": 1e-9}
GATEABLE_KINDS = ("time", "throughput", "ratio", "count", "quality", "bool")


@dataclass
class Verdict:
    bench: str
    metric: str
    kind: str
    direction: str
    classification: str          # regressed | improved | flat | new
    current: float
    baseline_median: Optional[float]
    baseline_mad: Optional[float]
    n_baseline: int
    threshold: float
    delta: float                 # current - baseline_median (0.0 when new)

    @property
    def delta_rel(self) -> float:
        if not self.baseline_median:
            return float("nan") if self.classification == "new" else 0.0
        return self.delta / abs(self.baseline_median)


def _median(xs: Sequence[float]) -> float:
    s = sorted(xs)
    k = len(s)
    mid = k // 2
    return s[mid] if k % 2 else 0.5 * (s[mid - 1] + s[mid])


def classify_value(bench: str, metric: str, kind: str, direction: str,
                   baseline: Sequence[float], current: float,
                   rtol: Optional[float] = None,
                   z: float = DEFAULT_Z) -> Verdict:
    if not baseline:
        return Verdict(bench, metric, kind, direction, "new", current,
                       None, None, 0, float("inf"), 0.0)
    med = _median(baseline)
    mad = _median([abs(b - med) for b in baseline])
    if rtol is None:
        rtol = KIND_RTOL.get(kind, float("inf"))
    thresh = max(rtol * abs(med), z * MAD_SIGMA * mad,
                 _KIND_ATOL.get(kind, 0.0))
    delta = current - med
    if kind == "info" or thresh == float("inf"):
        cls = "flat"
    elif direction == "lower":
        cls = ("regressed" if delta > thresh
               else "improved" if delta < -thresh else "flat")
    elif direction == "higher":
        cls = ("regressed" if delta < -thresh
               else "improved" if delta > thresh else "flat")
    else:                                      # equal: any drift is bad
        cls = "regressed" if abs(delta) > thresh else "flat"
    return Verdict(bench, metric, kind, direction, cls, current, med, mad,
                   len(baseline), thresh, delta)


def compare_payload(payload: dict, history: List[Dict[str, object]],
                    k: int = DEFAULT_K,
                    rtols: Optional[Dict[str, float]] = None,
                    z: float = DEFAULT_Z) -> List[Verdict]:
    """Classify every metric of ``payload`` against the trajectory.

    ``history`` should be the records read BEFORE this payload's own run
    was appended (the CLI snapshots the file first), so the baseline
    never includes the measurement under test.
    """
    bench = payload.get("name", "?")
    variant = payload_variant(payload)
    by_metric: Dict[str, List[float]] = {}
    for r in history:
        if r.get("bench") == bench and r.get("variant") == variant:
            try:
                by_metric.setdefault(str(r["metric"]), []).append(
                    float(r["value"]))     # type: ignore[arg-type]
            except (TypeError, ValueError):
                continue
    out = []
    for m in extract_metrics(payload):
        kind = str(m["kind"])
        rtol = (rtols or {}).get(kind)
        baseline = by_metric.get(str(m["metric"]), [])[-k:]
        out.append(classify_value(bench, str(m["metric"]), kind,
                                  str(m["direction"]), baseline,
                                  float(m["value"]), rtol=rtol, z=z))
    return out


def gate(verdicts: Sequence[Verdict],
         kinds: Optional[Sequence[str]] = None) -> List[Verdict]:
    """The regressions that should fail the run, restricted to ``kinds``
    (default: every gateable kind — pass ``("count", "quality", "bool")``
    for machine-independent CI gating, where wall-clock baselines
    recorded on one host don't transfer to another)."""
    kinds = tuple(kinds) if kinds is not None else GATEABLE_KINDS
    return [v for v in verdicts
            if v.classification == "regressed" and v.kind in kinds]


_ORDER = {"regressed": 0, "improved": 1, "new": 2, "flat": 3}


def render_table(verdicts: Sequence[Verdict], show: str = "changed",
                 top: int = 40) -> str:
    """Text table, regressions first.

    show — "changed": regressed/improved/new only; "all": everything
    except info; "gated": regressed only.
    """
    if show == "gated":
        rows = [v for v in verdicts if v.classification == "regressed"]
    elif show == "all":
        rows = [v for v in verdicts if v.kind != "info"]
    else:
        rows = [v for v in verdicts
                if v.classification in ("regressed", "improved", "new")
                and v.kind != "info"]
    rows = sorted(rows, key=lambda v: (_ORDER[v.classification],
                                       -abs(v.delta_rel or 0.0), v.metric))
    n_reg = sum(1 for v in verdicts if v.classification == "regressed")
    n_imp = sum(1 for v in verdicts if v.classification == "improved")
    bench = verdicts[0].bench if verdicts else "?"
    head = (f"{bench}: {len(verdicts)} metrics — {n_reg} regressed, "
            f"{n_imp} improved")
    if not rows:
        return head + " (nothing to show)"
    lines = [head,
             f"  {'metric':<58} {'kind':<10} {'baseline':>12} "
             f"{'current':>12} {'Δ':>8}  class"]
    for v in rows[:top]:
        name = v.metric if len(v.metric) <= 58 else "..." + v.metric[-55:]
        base = ("—" if v.baseline_median is None
                else f"{v.baseline_median:.6g}")
        dr = v.delta_rel
        delta = ("" if v.classification == "new" or dr != dr
                 else f"{dr:+.1%}")
        lines.append(f"  {name:<58} {v.kind:<10} {base:>12} "
                     f"{v.current:>12.6g} {delta:>8}  {v.classification}")
    if len(rows) > top:
        lines.append(f"  ... {len(rows) - top} more")
    return "\n".join(lines)
