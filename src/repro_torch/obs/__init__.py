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

Copies of the JAX package's ``repro.obs`` modules of the same names; its
perf gate (``obs/perf``) waits for a later slice of the port.  Span names:

    serve.*     engine batch/assembly/session_build   (serve/)
    session.*   solve / solve_batch / irls / rounding (core/session.py)
    cuttree.*   build / wave / refine / repair        (cuttree/)
"""
from . import dashboard, metrics, telemetry, trace
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry, Reservoir,
                      get_registry, parse_prometheus_text)
from .telemetry import TelemetryAggregator, build_solve_telemetry
from .trace import Tracer, configure, enabled, event, fence, get_tracer, span
