"""Structured span tracer — the timing substrate every subsystem shares.

One global :class:`Tracer` (off by default; ``configure(enabled=True)``
turns it on) records nested, thread-aware spans:

    from repro_torch.obs import trace

    with trace.span("irls.solve", topo=key, backend="scanned") as sp:
        v = run(...)
        sp.fence(v)                    # block_until_ready: device work is
        sp.set(pcg_iters=int(it))      # attributed to the span that ran it

Design constraints (this is hot-path adjacent code):

* **Disabled means free.**  ``span()`` returns a shared no-op context
  manager when tracing is off — one attribute read and one branch, no
  allocation, no lock.  The serving engine and the solver session keep
  their instrumentation unconditionally in place because of this.
* **Nesting is implicit.**  A thread-local stack supplies each span's
  parent, so the engine worker thread, caller threads and test threads
  each get their own well-formed span tree; spans survive exceptions
  (``__exit__`` records the error type and still closes the span).
* **Two sinks.**  Every finished span lands in an in-memory ring
  (bounded ``deque`` — a long-running server cannot leak) and, when a
  JSONL path is configured, as one JSON object per line (the JAX
  package's span schema).
* **Device attribution is explicit.**  CUDA launches are async: a span
  that merely *launched* device work closes before the work ran.
  ``sp.fence(x)`` synchronizes the device of every CUDA tensor it is
  given (``torch.cuda.synchronize``) so the wall time lands in the span
  that did the launching (skipped when tracing is off — the fence must
  never change disabled-mode behavior).
* **Profiler passthrough.**  ``configure(profiler=True)`` additionally
  wraps each span in ``torch.profiler.record_function`` so the same names
  show up in a ``torch.profiler`` trace.

A copy of the JAX package's ``repro.obs.trace`` with those two device
hooks written for PyTorch.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

import torch

__all__ = ["Tracer", "SpanRecord", "get_tracer", "configure", "enabled",
           "span", "event", "spans", "clear", "fence"]


def _synchronize(vals) -> None:
    """Wait for the device work behind every CUDA tensor (or
    ``torch.device``) in ``vals``; anything on the CPU is ready already."""
    devices = {dev for dev in (getattr(v, "device", v) for v in vals)
               if isinstance(dev, torch.device) and dev.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)


class SpanRecord:
    """One finished span (plain attributes; ``to_dict`` for the sinks)."""

    __slots__ = ("name", "span_id", "parent_id", "thread", "t0", "t1",
                 "attrs", "error")

    def __init__(self, name: str, span_id: int, parent_id: Optional[int],
                 thread: str, t0: float, t1: float,
                 attrs: Dict[str, Any], error: Optional[str]):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.thread = thread
        self.t0 = t0
        self.t1 = t1
        self.attrs = attrs
        self.error = error

    @property
    def dur_s(self) -> float:
        return self.t1 - self.t0

    def to_dict(self) -> Dict[str, Any]:
        d = {"name": self.name, "span_id": self.span_id,
             "parent_id": self.parent_id, "thread": self.thread,
             "t0": self.t0, "t1": self.t1, "dur_s": self.dur_s}
        if self.attrs:
            d["attrs"] = self.attrs
        if self.error is not None:
            d["error"] = self.error
        return d


class _NoopSpan:
    """Shared do-nothing span: the entire disabled-mode cost."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_NoopSpan":
        return self

    def fence(self, *vals):
        # no block_until_ready when tracing is off: the fence exists for
        # attribution, and disabled tracing must not change async dispatch
        return vals[0] if len(vals) == 1 else vals


_NOOP = _NoopSpan()


class _Span:
    """Live span handle (context manager)."""

    __slots__ = ("_tracer", "name", "span_id", "parent_id", "t0", "attrs",
                 "_annotation")

    def __init__(self, tracer: "Tracer", name: str, parent_id: Optional[int],
                 attrs: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.span_id = tracer._next_id()
        self.parent_id = parent_id
        self.attrs = attrs
        self.t0 = 0.0
        self._annotation = None

    def set(self, **attrs) -> "_Span":
        self.attrs.update(attrs)
        return self

    def fence(self, *vals):
        """Block until ``vals`` are device-ready; time lands in this span."""
        _synchronize(vals)
        return vals[0] if len(vals) == 1 else vals

    def __enter__(self) -> "_Span":
        tr = self._tracer
        if tr._profiler:
            try:
                self._annotation = torch.profiler.record_function(self.name)
                self._annotation.__enter__()
            except Exception:
                self._annotation = None
        tr._stack().append(self.span_id)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = time.perf_counter()
        tr = self._tracer
        stack = tr._stack()
        # tolerate a corrupted stack rather than masking the caller's error
        if stack and stack[-1] == self.span_id:
            stack.pop()
        elif self.span_id in stack:
            del stack[stack.index(self.span_id):]
        if self._annotation is not None:
            try:
                self._annotation.__exit__(exc_type, exc, tb)
            except Exception:
                pass
        err = None if exc_type is None else exc_type.__name__
        tr._emit(SpanRecord(self.name, self.span_id, self.parent_id,
                            threading.current_thread().name, self.t0, t1,
                            self.attrs, err))
        return False


class Tracer:
    """Thread-safe span recorder: ring buffer + optional JSONL sink."""

    def __init__(self, ring: int = 8192):
        self._enabled = False
        self._profiler = False
        self._ring: "deque[SpanRecord]" = deque(maxlen=ring)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._id = 0
        self._jsonl_path: Optional[str] = None
        self._jsonl_file = None

    # -- configuration ---------------------------------------------------------
    def configure(self, enabled: Optional[bool] = None,
                  ring: Optional[int] = None,
                  jsonl: Optional[str] = None,
                  profiler: Optional[bool] = None) -> "Tracer":
        """Reconfigure in place; only the arguments given change.

        ``jsonl`` — path to append finished spans to (one JSON object per
        line), or ``""`` to close the current sink.  Configuring a sink
        implies ``enabled=True`` unless ``enabled=False`` is passed
        explicitly.
        """
        with self._lock:
            if ring is not None:
                self._ring = deque(self._ring, maxlen=ring)
            if jsonl is not None:
                if self._jsonl_file is not None:
                    self._jsonl_file.close()
                    self._jsonl_file = None
                self._jsonl_path = jsonl or None
                if self._jsonl_path:
                    os.makedirs(os.path.dirname(
                        os.path.abspath(self._jsonl_path)), exist_ok=True)
                    self._jsonl_file = open(self._jsonl_path, "a",
                                            buffering=1)
                    if enabled is None:
                        enabled = True
            if profiler is not None:
                self._profiler = profiler
            if enabled is not None:
                self._enabled = enabled
        return self

    @property
    def enabled(self) -> bool:
        return self._enabled

    @property
    def jsonl_path(self) -> Optional[str]:
        return self._jsonl_path

    # -- recording -------------------------------------------------------------
    def span(self, name: str, **attrs):
        """Context manager for one timed span (no-op when disabled)."""
        if not self._enabled:
            return _NOOP
        stack = self._stack()
        parent = stack[-1] if stack else None
        return _Span(self, name, parent, attrs)

    def event(self, name: str, **attrs) -> None:
        """Zero-duration span (structured point event, e.g. a warning)."""
        if not self._enabled:
            return
        stack = self._stack()
        parent = stack[-1] if stack else None
        now = time.perf_counter()
        self._emit(SpanRecord(name, self._next_id(), parent,
                              threading.current_thread().name, now, now,
                              attrs, None))

    # -- reading ---------------------------------------------------------------
    def spans(self) -> List[SpanRecord]:
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    # -- internals -------------------------------------------------------------
    def _stack(self) -> List[int]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _next_id(self) -> int:
        with self._lock:
            self._id += 1
            return self._id

    def _emit(self, rec: SpanRecord) -> None:
        with self._lock:
            self._ring.append(rec)
            if self._jsonl_file is not None:
                try:
                    self._jsonl_file.write(
                        json.dumps(rec.to_dict(), default=str) + "\n")
                except (ValueError, OSError):
                    pass       # sink closed mid-shutdown; the ring still has it


# -- module-level default tracer (what all in-repo instrumentation uses) -------
_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER


def configure(**kwargs) -> Tracer:
    return _TRACER.configure(**kwargs)


def enabled() -> bool:
    return _TRACER.enabled


def span(name: str, **attrs):
    return _TRACER.span(name, **attrs)


def event(name: str, **attrs) -> None:
    _TRACER.event(name, **attrs)


def spans() -> List[SpanRecord]:
    return _TRACER.spans()


def clear() -> None:
    _TRACER.clear()


def fence(*vals):
    """Block until device-ready iff tracing is enabled (free otherwise)."""
    if _TRACER.enabled:
        _synchronize(vals)
    return vals[0] if len(vals) == 1 else vals
