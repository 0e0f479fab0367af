"""Micro-batcher: group pending requests, pad to power-of-two buckets.

A flush of k requests is padded (by
``MinCutSession.solve_batch(pad_to=...)``) up to ``bucket_size(k)`` — the
next power of two, capped at ``max_batch`` — so the batch shapes a server
runs stay in a set of ``log2(max_batch) + 1`` per ``(topology, cfg)``
group.  (The JAX package compiles one vmapped program per batch length,
which is why it bounds them; the port keeps the same buckets, so a server
of either package runs the same batches.)

Grouping key is caller-defined (the engine uses
``(topology_fingerprint, cfg, rounding)`` — only requests that can legally
share one vmapped program batch together).  Flush triggers per group:

* size trigger — ``max_batch`` pending requests flush immediately;
* deadline trigger — the OLDEST pending request never waits more than
  ``max_wait_ms`` beyond its arrival before its group flushes;
* idle trigger (``take(..., allow_partial=True)``) — a PARTIAL batch
  flushes immediately.  The continuous-batching engine passes
  ``allow_partial`` whenever a dispatch worker is idle: a free worker and
  a pending request means waiting out ``max_wait_ms`` buys nothing —
  batches only grow while every worker is busy, which is exactly when
  batching pays.

``ready``/``flush_all`` flush every triggered group at once (the legacy
single-worker drain loop); ``take`` hands out ONE batch per call — the
worker-pool handoff, where each idle worker claims one batch under the
engine's lock and executes it outside.

The batcher is a pure data structure driven by explicit ``now`` timestamps;
the engine owns the clock and the locking.  That keeps it deterministic and
directly unit-testable.  A copy of the JAX package's ``repro.serve.batcher``.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Hashable, List, NamedTuple, Optional, Tuple


def bucket_size(k: int, max_batch: int) -> int:
    """Next power of two ≥ k, capped at ``max_batch``."""
    if k < 1:
        raise ValueError(f"batch of {k} requests cannot be bucketed")
    b = 1
    while b < k:
        b <<= 1
    return min(b, max_batch)


class MicroBatch(NamedTuple):
    """One flushed group: execute ``requests`` padded up to ``bucket``.

    ``reason`` records WHICH trigger flushed the group — "size" (hit
    ``max_batch``), "deadline" (oldest request aged past max-wait-ms),
    "idle" (an idle worker claimed a partial batch rather than waiting)
    or "shutdown" (engine drain) — so the tracing/metrics layers can tell
    batches that filled up from batches a free worker (or the clock)
    forced out.
    """

    key: Hashable
    requests: List[Any]
    bucket: int
    reason: str = "size"


class MicroBatcher:
    """Deadline/size-triggered request grouper (see module docstring)."""

    def __init__(self, max_batch: int = 8, max_wait_ms: float = 2.0):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        # group key -> list of (request, arrival time); insertion-ordered so
        # deadline scans see oldest groups first
        self._groups: "OrderedDict[Hashable, List[Tuple[Any, float]]]" = \
            OrderedDict()

    @property
    def pending(self) -> int:
        return sum(len(g) for g in self._groups.values())

    def add(self, key: Hashable, request: Any, now: float) -> None:
        self._groups.setdefault(key, []).append((request, now))

    def next_deadline(self) -> Optional[float]:
        """Earliest time any group must flush, or None when empty."""
        oldest = [g[0][1] for g in self._groups.values() if g]
        return min(oldest) + self.max_wait_s if oldest else None

    def _take(self, key: Hashable, k: int, reason: str) -> MicroBatch:
        group = self._groups[key]
        chunk = [r for r, _ in group[:k]]
        del group[:k]
        if not group:
            del self._groups[key]
        return MicroBatch(key=key, requests=chunk,
                          bucket=bucket_size(len(chunk), self.max_batch),
                          reason=reason)

    def take(self, now: float, allow_partial: bool = False
             ) -> Optional[MicroBatch]:
        """Claim ONE batch for an idle worker, or None when nothing fires.

        Trigger precedence: a full group ("size") beats a group whose
        oldest request aged past the deadline ("deadline"); with
        ``allow_partial`` — the idle-aware flush policy — any pending
        group fires immediately ("idle"), oldest head request first, so
        a free worker never sits behind ``max_wait_ms``.
        """
        deadline_key = oldest_key = None
        deadline_t = oldest_t = None
        for key, group in self._groups.items():
            if len(group) >= self.max_batch:
                return self._take(key, self.max_batch, "size")
            head_t = group[0][1]
            if now - head_t >= self.max_wait_s and \
                    (deadline_t is None or head_t < deadline_t):
                deadline_key, deadline_t = key, head_t
            if oldest_t is None or head_t < oldest_t:
                oldest_key, oldest_t = key, head_t
        if deadline_key is not None:
            return self._take(deadline_key, self.max_batch, "deadline")
        if allow_partial and oldest_key is not None:
            return self._take(oldest_key, self.max_batch, "idle")
        return None

    def ready(self, now: float) -> List[MicroBatch]:
        """Flush every group that hit its size or deadline trigger."""
        out: List[MicroBatch] = []
        for key in list(self._groups):
            while key in self._groups and \
                    len(self._groups[key]) >= self.max_batch:
                out.append(self._take(key, self.max_batch, "size"))
            if key in self._groups and \
                    now - self._groups[key][0][1] >= self.max_wait_s:
                out.append(self._take(key, self.max_batch, "deadline"))
        return out

    def flush_all(self) -> List[MicroBatch]:
        """Drain everything regardless of deadlines (engine shutdown)."""
        out: List[MicroBatch] = []
        for key in list(self._groups):
            while key in self._groups:
                out.append(self._take(key, self.max_batch, "shutdown"))
        return out
