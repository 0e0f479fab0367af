"""Serving metrics: per-request latency breakdown, throughput, batch shapes.

Per completed request the engine records a phase breakdown (seconds):

  queue     — submit → batch execution start (micro-batcher residency)
  assembly  — batch execution start → solver dispatch (session/warm
              lookup, weight staging)
  irls      — per-request share of the vmapped scanned program
  irls_wall — the batch's FULL solver wall (what the request waited for)
  rounding  — host rounding of this request's voltages
  total     — submit → future resolution

``latency_ms`` / ``snapshot`` reduce those to p50/p90/p99 (reported in
ms), plus throughput over the active window, exact counter totals, the
observed batch/bucket-size distribution and ``phase_coverage`` — the
mean fraction of per-request ``total`` accounted for by
queue + assembly + setup + presolve + irls_wall + rounding (how much of
each request's wall the breakdown explains).

Storage is an ``obs.metrics.MetricsRegistry``: exact counters stay
exact; latency/batch samples live in BOUNDED reservoirs (default 4096
per series), so sustained traffic runs at flat memory where the old
append-to-list design grew without bound.  ``prometheus_text()`` exposes
the same registry in Prometheus text format.  A copy of the JAX package's
``repro.serve.metrics``.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

from ..obs.metrics import Histogram, MetricsRegistry, _percentile

PHASES = ("queue", "assembly", "irls", "rounding", "total")
#: phases whose sum is checked against ``total`` per request ("setup" and
#: "presolve" only appear on first-compile / kernelized solves)
COVERAGE_PHASES = ("queue", "assembly", "setup", "presolve", "irls_wall",
                   "rounding")
#: every sampled series (PHASES plus the batch-wall series)
_SAMPLED = PHASES + ("irls_wall",)

_COUNTERS = ("submitted", "completed", "failed", "rejected", "cancelled",
             "batches")

#: flush triggers the batcher can report (see ``serve.batcher.MicroBatch``)
FLUSH_REASONS = ("size", "deadline", "idle", "shutdown")


def percentile(samples: List[float], p: float) -> float:
    """p-th percentile of ``samples`` (nan when empty)."""
    return _percentile(list(samples), p)


class ServeMetrics:
    """Counters + bounded latency samples for one ``MinCutServer``."""

    def __init__(self, max_samples: int = 4096):
        self._lock = threading.Lock()
        self.max_samples = int(max_samples)
        self.registry = MetricsRegistry()
        for name in _COUNTERS:
            self.registry.counter(f"requests_{name}" if name != "batches"
                                  else "batches")
        for ph in _SAMPLED:
            self.registry.histogram(f"{ph}_seconds",
                                    max_samples=self.max_samples)
        self.registry.histogram("batch_size", max_samples=self.max_samples)
        self.registry.histogram("bucket_size", max_samples=self.max_samples)
        self.registry.histogram("phase_coverage",
                                max_samples=self.max_samples)
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None

    # exact counter totals stay attribute-compatible with the old class
    def _counter(self, name: str):
        return self.registry.counter(f"requests_{name}"
                                     if name != "batches" else "batches")

    @property
    def submitted(self) -> int:
        return int(self._counter("submitted").value)

    @property
    def completed(self) -> int:
        return int(self._counter("completed").value)

    @property
    def failed(self) -> int:
        return int(self._counter("failed").value)

    @property
    def rejected(self) -> int:
        return int(self._counter("rejected").value)

    @property
    def cancelled(self) -> int:
        return int(self._counter("cancelled").value)

    @property
    def batches(self) -> int:
        return int(self._counter("batches").value)

    def _hist(self, name: str) -> Histogram:
        return self.registry.histogram(name, max_samples=self.max_samples)

    # -- recording (engine hot path) ------------------------------------------
    def record_submit(self, now: float) -> None:
        self._counter("submitted").inc()
        with self._lock:
            if self._t_first is None:
                self._t_first = now

    def record_reject(self) -> None:
        self._counter("rejected").inc()

    def record_cancelled(self) -> None:
        self._counter("cancelled").inc()

    def record_batch(self, size: int, bucket: int,
                     reason: str = "size") -> None:
        self._counter("batches").inc()
        self.registry.counter(f"batches_{reason}").inc()
        self._hist("batch_size").observe(int(size))
        self._hist("bucket_size").observe(int(bucket))

    def record_solve_cost(self, flops: Optional[float],
                          achieved_gflops: Optional[float]) -> None:
        """Cost figures of one served solve, when its telemetry carries
        them (the port has no cost model yet, so it records none): total
        device flops as an exact counter, achieved GFLOP/s as a bounded
        sample series — both land in ``prometheus_text``."""
        if flops:
            self.registry.counter("solve_flops").inc(float(flops))
        if achieved_gflops is not None:
            self._hist("achieved_gflops").observe(float(achieved_gflops))

    def record_request(self, timings: Dict[str, float], now: float,
                       failed: bool = False) -> None:
        if failed:
            self._counter("failed").inc()
        else:
            self._counter("completed").inc()
            for ph in _SAMPLED:
                if ph in timings:
                    self._hist(f"{ph}_seconds").observe(float(timings[ph]))
            total = float(timings.get("total", 0.0))
            if total > 0:
                acc = sum(float(timings.get(ph, 0.0))
                          for ph in COVERAGE_PHASES)
                self._hist("phase_coverage").observe(min(1.0, acc / total))
        with self._lock:
            self._t_last = now

    # -- reductions ------------------------------------------------------------
    def latency_ms(self, phase: str, p: float) -> float:
        return self._hist(f"{phase}_seconds").percentile(p) * 1e3

    def window_seconds(self) -> float:
        """Active window: first submit → latest completion (0 when idle)."""
        with self._lock:
            if self._t_first is None or self._t_last is None:
                return 0.0
            return max(0.0, self._t_last - self._t_first)

    def solves_per_sec(self) -> float:
        completed = self.completed
        window = self.window_seconds()
        if not completed or window <= 0:
            return float("inf") if completed else 0.0
        return completed / window

    def flush_reasons(self) -> Dict[str, int]:
        """Batches flushed per trigger (size/deadline/idle/shutdown)."""
        return {r: int(self.registry.counter(f"batches_{r}").value)
                for r in FLUSH_REASONS}

    def mean_batch_size(self) -> float:
        h = self._hist("batch_size")
        return h.total / h.count if h.count else float("nan")

    def max_batch_size(self) -> int:
        h = self._hist("batch_size")
        return int(h.max) if h.count else 0

    def phase_coverage(self) -> float:
        h = self._hist("phase_coverage")
        s = h.snapshot()
        return s["mean"]

    # -- exposition ------------------------------------------------------------
    def snapshot(self) -> Dict[str, object]:
        """Everything, as a plain JSON-serializable dict.

        ``batch_sizes`` / ``bucket_sizes`` are the BOUNDED reservoir
        samples (the exact count/mean/max come from the exact fields).
        """
        out: Dict[str, object] = {
            name: getattr(self, name) for name in _COUNTERS}
        out["batch_sizes"] = [int(v) for v in self._hist("batch_size").values()]
        out["bucket_sizes"] = [int(v)
                               for v in self._hist("bucket_size").values()]
        out["solves_per_sec"] = self.solves_per_sec()
        out["mean_batch_size"] = self.mean_batch_size()
        out["max_batch_size"] = self.max_batch_size()
        out["phase_coverage"] = self.phase_coverage()
        out["flush_reasons"] = self.flush_reasons()
        for ph in PHASES:
            h = self._hist(f"{ph}_seconds")
            for p in (50, 90, 99):
                out[f"{ph}_p{p}_ms"] = h.percentile(p) * 1e3
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition of every counter/series."""
        return self.registry.prometheus_text(prefix="mincut_serve_")

    def dump(self) -> str:
        """Human-readable text report."""
        s = self.snapshot()
        lines = [
            "serve metrics",
            f"  requests : {s['submitted']} submitted, "
            f"{s['completed']} completed, {s['failed']} failed, "
            f"{s['rejected']} rejected, {s['cancelled']} cancelled",
            f"  batches  : {s['batches']} "
            f"(mean size {s['mean_batch_size']:.2f}, "
            f"max {s['max_batch_size']}; flushed "
            + ", ".join(f"{v} by {k}"
                        for k, v in s["flush_reasons"].items() if v)
            + ")",
            f"  rate     : {s['solves_per_sec']:.1f} solves/sec",
            f"  coverage : {s['phase_coverage']:.3f} of total accounted by "
            f"{'+'.join(COVERAGE_PHASES)}",
            "  latency (ms)        p50        p90        p99",
        ]
        for ph in PHASES:
            lines.append(f"    {ph:<10}  {s[f'{ph}_p50_ms']:>9.2f}  "
                         f"{s[f'{ph}_p90_ms']:>9.2f}  "
                         f"{s[f'{ph}_p99_ms']:>9.2f}")
        return "\n".join(lines)
