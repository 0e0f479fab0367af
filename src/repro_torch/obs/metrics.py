"""Bounded metrics primitives + registry with Prometheus/JSON exposition.

Three instrument kinds, all thread-safe and all O(1) memory:

* :class:`Counter` — monotonically increasing exact total.
* :class:`Gauge`   — last-set value.
* :class:`Histogram` — EXACT count/sum/min/max plus a bounded
  :class:`Reservoir` of samples (Vitter's Algorithm R: each of the n
  observations ends up in the k-slot sample with probability k/n) for
  percentile estimates.  This is what replaced the serving layer's
  unbounded ``_samples`` lists: sustained traffic keeps percentiles
  honest at flat memory.

:class:`MetricsRegistry` names the instruments and renders them two
ways: ``snapshot()`` (plain JSON dict — what ``BENCH_*.json`` payloads
and ``stats()`` embed) and ``prometheus_text()`` (text exposition
format: counters as ``_total``, histograms as summaries with quantile
labels, ``# TYPE``/``# HELP`` comments).  ``parse_prometheus_text`` is
the minimal inverse used by the round-trip test.

A module-level default registry (``get_registry()``) collects the
always-on cross-subsystem counters (solves, batches, queue gauges) —
increments are one lock + one add, cheap enough to leave unconditional.
A copy of the JAX package's ``repro.obs.metrics``.
"""
from __future__ import annotations

import math
import random
import threading
from typing import Dict, List, Optional, Tuple

__all__ = ["Reservoir", "Counter", "Gauge", "Histogram", "MetricsRegistry",
           "get_registry", "parse_prometheus_text"]


def _percentile(samples: List[float], p: float) -> float:
    if not samples:
        return float("nan")
    s = sorted(samples)
    if len(s) == 1:
        return float(s[0])
    rank = (p / 100.0) * (len(s) - 1)
    lo = int(math.floor(rank))
    hi = min(lo + 1, len(s) - 1)
    frac = rank - lo
    return float(s[lo] * (1.0 - frac) + s[hi] * frac)


class Reservoir:
    """Bounded uniform sample of an unbounded stream (Algorithm R).

    Exact aggregates (``count``/``total``/``min``/``max``) are tracked on
    the side, so only the percentile estimate is sampled.  Deterministic
    given ``seed`` — tests and benchmarks reproduce.
    """

    def __init__(self, maxlen: int = 2048, seed: int = 0):
        if maxlen < 1:
            raise ValueError(f"maxlen must be >= 1, got {maxlen}")
        self.maxlen = int(maxlen)
        self._rng = random.Random(seed)
        self._samples: List[float] = []
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def add(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if len(self._samples) < self.maxlen:
            self._samples.append(v)
        else:
            j = self._rng.randrange(self.count)
            if j < self.maxlen:
                self._samples[j] = v

    def values(self) -> List[float]:
        return list(self._samples)

    def __len__(self) -> int:
        return len(self._samples)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else float("nan")

    def percentile(self, p: float) -> float:
        return _percentile(self._samples, p)


class Counter:
    """Monotone exact counter."""

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counter {self.name} cannot decrease (v={v})")
        with self._lock:
            self._value += v

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Last-set value."""

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = float("nan")
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Exact aggregates + bounded-reservoir percentiles."""

    QUANTILES = (50, 90, 99)

    def __init__(self, name: str, help: str = "", max_samples: int = 2048,
                 seed: int = 0):
        self.name = name
        self.help = help
        self._res = Reservoir(maxlen=max_samples, seed=seed)
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        with self._lock:
            self._res.add(v)

    @property
    def count(self) -> int:
        with self._lock:
            return self._res.count

    @property
    def total(self) -> float:
        with self._lock:
            return self._res.total

    def percentile(self, p: float) -> float:
        with self._lock:
            return self._res.percentile(p)

    def values(self) -> List[float]:
        """The bounded reservoir sample (NOT every observation)."""
        with self._lock:
            return self._res.values()

    @property
    def max(self) -> float:
        with self._lock:
            return self._res.max if self._res.count else float("nan")

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            r = self._res
            out = {"count": r.count, "sum": r.total,
                   "min": r.min if r.count else float("nan"),
                   "max": r.max if r.count else float("nan"),
                   "mean": r.mean}
            for q in self.QUANTILES:
                out[f"p{q}"] = r.percentile(q)
        return out


def _sanitize(name: str) -> str:
    out = "".join(ch if (ch.isalnum() or ch == "_") else "_" for ch in name)
    return out if not out[:1].isdigit() else "_" + out


class MetricsRegistry:
    """Named instrument store with JSON + Prometheus exposition.

    ``counter``/``gauge``/``histogram`` are get-or-create (idempotent, so
    call sites don't coordinate); a name can only ever hold one kind.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: "Dict[str, object]" = {}

    def _get(self, name: str, cls, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, **kwargs)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} is a "
                                f"{type(m).__name__}, not a {cls.__name__}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, Counter, help=help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, Gauge, help=help)

    def histogram(self, name: str, help: str = "",
                  max_samples: int = 2048) -> Histogram:
        return self._get(name, Histogram, help=help,
                         max_samples=max_samples)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()

    def snapshot(self) -> Dict[str, object]:
        """Everything, as one JSON-serializable dict."""
        with self._lock:
            items = sorted(self._metrics.items())
        out: Dict[str, object] = {}
        for name, m in items:
            if isinstance(m, Histogram):
                out[name] = m.snapshot()
            else:
                out[name] = m.value
        return out

    def prometheus_text(self, prefix: str = "") -> str:
        """Prometheus text exposition format (0.0.4)."""
        with self._lock:
            items = sorted(self._metrics.items())
        lines: List[str] = []
        for name, m in items:
            pname = _sanitize(prefix + name)
            if isinstance(m, Counter):
                if not pname.endswith("_total"):
                    pname += "_total"
                if m.help:
                    lines.append(f"# HELP {pname} {m.help}")
                lines.append(f"# TYPE {pname} counter")
                lines.append(f"{pname} {m.value:.17g}")
            elif isinstance(m, Gauge):
                if m.help:
                    lines.append(f"# HELP {pname} {m.help}")
                lines.append(f"# TYPE {pname} gauge")
                v = m.value
                lines.append(f"{pname} {'NaN' if math.isnan(v) else format(v, '.17g')}")
            elif isinstance(m, Histogram):
                if m.help:
                    lines.append(f"# HELP {pname} {m.help}")
                lines.append(f"# TYPE {pname} summary")
                s = m.snapshot()
                for q in Histogram.QUANTILES:
                    v = s[f"p{q}"]
                    lines.append(
                        f'{pname}{{quantile="{q / 100.0:g}"}} '
                        f"{'NaN' if math.isnan(v) else format(v, '.17g')}")
                lines.append(f"{pname}_sum {s['sum']:.17g}")
                lines.append(f"{pname}_count {s['count']}")
        return "\n".join(lines) + ("\n" if lines else "")


def parse_prometheus_text(text: str) -> Dict[str, object]:
    """Minimal inverse of ``prometheus_text`` (the round-trip checker).

    Returns ``{metric_name: value}`` for counters/gauges and
    ``{metric_name: {"quantiles": {q: v}, "sum": s, "count": c}}`` for
    summaries.  Ignores HELP lines; TYPE lines decide the shape.
    """
    types: Dict[str, str] = {}
    out: Dict[str, object] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(None, 3)
            types[name] = kind
            continue
        if line.startswith("#"):
            continue
        key, _, val = line.rpartition(" ")
        key = key.strip()
        v = float(val)
        if "{" in key:
            base, _, label = key.partition("{")
            label = label.rstrip("}")
            q = float(label.split("=")[1].strip('"'))
            d = out.setdefault(base, {"quantiles": {}, "sum": None,
                                      "count": None})
            d["quantiles"][q] = v
        elif key.endswith("_sum") and types.get(key[:-4]) == "summary":
            out.setdefault(key[:-4], {"quantiles": {}, "sum": None,
                                      "count": None})["sum"] = v
        elif key.endswith("_count") and types.get(key[:-6]) == "summary":
            out.setdefault(key[:-6], {"quantiles": {}, "sum": None,
                                      "count": None})["count"] = v
        else:
            out[key] = v
    return out


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry (always-on subsystem counters)."""
    return _REGISTRY
