"""Observability: tracing, metrics, solver telemetry.

    trace      — thread-safe nested span tracer: in-memory ring +
                 optional JSONL sink + ``torch.profiler`` passthrough;
                 free when disabled (``trace.configure(enabled=True)``)
    metrics    — Counter/Gauge/Histogram (bounded reservoir) registry
                 with JSON + Prometheus-text exposition
    telemetry  — the ``SolveResult.telemetry`` schema and its
                 per-session / per-server aggregation
    dashboard  — the JSONL sink's reader: per-path span aggregates and
                 the text tree that ``launch/obs.py`` renders

    perf       — the perf gate: payload schema, trajectory store,
                 regression comparator, per-solve work counts
                 (``launch/bench_diff.py``)

Copies of the JAX package's ``repro.obs`` modules of the same names, but
``perf.profile``, which counts a solve's work from its shapes where the
JAX package asks XLA.  Span names:

    serve.*     engine batch/assembly/session_build   (serve/)
    session.*   solve / solve_batch / irls / rounding (core/session.py)
    cuttree.*   build / wave / refine / repair        (cuttree/)
"""
from . import dashboard, metrics, telemetry, trace
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry, Reservoir,
                      get_registry, parse_prometheus_text)
from .telemetry import TelemetryAggregator, build_solve_telemetry
from .trace import Tracer, configure, enabled, event, fence, get_tracer, span


def bench_snapshot() -> dict:
    """Observability snapshot for bench payloads.

    Always includes the global metrics registry; includes a span-path
    summary only when tracing ran (the payload stays small and
    deterministic-ish otherwise).
    """
    out = {"metrics": get_registry().snapshot()}
    spans = trace.spans()
    if spans:
        agg = dashboard.aggregate([s.to_dict() for s in spans])
        out["span_paths"] = {
            path: {"count": int(d["count"]),
                   "total_s": d["total_s"], "self_s": d["self_s"]}
            for path, d in sorted(agg.items())}
    return out
