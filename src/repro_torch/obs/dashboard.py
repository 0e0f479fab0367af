"""JSONL span-sink reader: aggregation + text dashboard rendering.

Pure functions over the trace schema ``trace.py`` writes (one JSON span
per line).  The ``repro_torch.launch.obs`` CLI is a thin argparse shell around
:func:`load_spans` → :func:`aggregate` → :func:`render`, optionally in a
follow loop (tail the file, re-render).

The "flamegraph-style" summary groups spans by their PATH — the chain of
ancestor names joined with ``>`` (``serve.batch>session.solve_batch>
session.irls``) — so the tree view shows, per call site, call count,
total wall time, and SELF time (total minus child time), sorted so the
expensive paths surface first.  Parent links are resolved per thread via
``span_id``/``parent_id``; orphans (parent outside the ring/file window)
root their own subtree, which keeps partial tails readable.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Optional, Tuple

__all__ = ["load_spans", "aggregate", "render", "span_names", "percentile"]


def load_spans(path: str, offset: int = 0) -> Tuple[List[Dict[str, Any]], int]:
    """Read spans from a JSONL sink starting at byte ``offset``.

    Returns ``(spans, new_offset)``; skips partial/corrupt trailing lines
    (a live writer may be mid-line), so follow mode can call this
    repeatedly with the returned offset.
    """
    spans: List[Dict[str, Any]] = []
    with open(path, "r") as fh:
        fh.seek(offset)
        while True:
            pos = fh.tell()
            line = fh.readline()
            if not line:
                break
            if not line.endswith("\n"):
                return spans, pos           # partial tail: retry next round
            line = line.strip()
            if not line:
                continue
            try:
                spans.append(json.loads(line))
            except json.JSONDecodeError:
                continue
        return spans, fh.tell()


def span_names(spans: Iterable[Dict[str, Any]]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for s in spans:
        out[s["name"]] = out.get(s["name"], 0) + 1
    return out


def percentile(samples: List[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]) of a duration sample list."""
    if not samples:
        return 0.0
    xs = sorted(samples)
    i = min(len(xs) - 1, max(0, int(round(q / 100.0 * (len(xs) - 1)))))
    return xs[i]


def aggregate(spans: List[Dict[str, Any]]) -> Dict[str, Dict[str, float]]:
    """Per-PATH aggregates: count, total seconds, self seconds, errors,
    and the raw duration samples (``durations``) the renderer turns into
    p50/p99 percentiles — tail latency per call site, not just the mean.

    ``self`` subtracts each span's DIRECT children's durations from its
    own, so a path's self time is where the wall clock actually went.
    """
    by_id = {s["span_id"]: s for s in spans if "span_id" in s}

    def path_of(s) -> str:
        parts = [s["name"]]
        seen = {s.get("span_id")}
        p = s.get("parent_id")
        while p is not None and p in by_id and p not in seen:
            seen.add(p)
            parent = by_id[p]
            parts.append(parent["name"])
            p = parent.get("parent_id")
        return ">".join(reversed(parts))

    child_time: Dict[int, float] = {}
    for s in spans:
        p = s.get("parent_id")
        if p is not None and p in by_id:
            child_time[p] = child_time.get(p, 0.0) + float(s.get("dur_s", 0.0))

    agg: Dict[str, Dict[str, float]] = {}
    for s in spans:
        path = path_of(s)
        d = agg.setdefault(path, {"count": 0, "total_s": 0.0, "self_s": 0.0,
                                  "errors": 0, "durations": []})
        dur = float(s.get("dur_s", 0.0))
        d["count"] += 1
        d["total_s"] += dur
        d["self_s"] += max(0.0, dur - child_time.get(s.get("span_id"), 0.0))
        d["durations"].append(dur)
        if s.get("error"):
            d["errors"] += 1
    return agg


def render(agg: Dict[str, Dict[str, float]], top: int = 30,
           title: str = "span summary", sort: Optional[str] = None) -> str:
    """Flamegraph-style text tree, expensive paths first.

    ``sort=None`` keeps the tree layout (roots by total time, children
    indented beneath them).  ``sort="self"|"p99"|"count"`` flattens the
    listing and ranks every path by that column descending — the hunting
    view ("which call site burns the most self time / has the worst
    tail") rather than the structural one.
    """
    if not agg:
        return f"{title}: (no spans)"
    if sort is not None:
        keys = {"self": lambda d: d["self_s"],
                "p99": lambda d: percentile(d.get("durations", []), 99),
                "count": lambda d: d["count"]}
        if sort not in keys:
            raise ValueError(f"sort must be one of {sorted(keys)}: {sort!r}")
        order = sorted(agg, key=lambda p: (-keys[sort](agg[p]), p))
    else:
        # order: by root path total desc, then depth-first lexicographic
        roots: Dict[str, float] = {}
        for path, d in agg.items():
            root = path.split(">", 1)[0]
            roots[root] = roots.get(root, 0.0) + (d["total_s"]
                                                  if ">" not in path else 0.0)
        order = sorted(agg, key=lambda p: (-roots.get(p.split(">", 1)[0],
                                                      0.0), p))
    lines = [title,
             f"  {'path':<44} {'count':>7} {'total':>10} {'self':>10} "
             f"{'mean':>9} {'p50':>9} {'p99':>9}"]
    for path in order[:top]:
        d = agg[path]
        if sort is None:
            depth = path.count(">")
            name = ("  " * depth) + path.rsplit(">", 1)[-1]
        else:
            name = path
        if len(name) > 44:
            name = name[:41] + "..."
        mean = d["total_s"] / d["count"] if d["count"] else 0.0
        durs = d.get("durations", [])
        p50, p99 = percentile(durs, 50), percentile(durs, 99)
        err = f"  !{int(d['errors'])}err" if d["errors"] else ""
        lines.append(f"  {name:<44} {int(d['count']):>7} "
                     f"{d['total_s'] * 1e3:>8.1f}ms {d['self_s'] * 1e3:>8.1f}ms "
                     f"{mean * 1e3:>7.2f}ms {p50 * 1e3:>7.2f}ms "
                     f"{p99 * 1e3:>7.2f}ms{err}")
    if len(order) > top:
        lines.append(f"  ... {len(order) - top} more paths")
    return "\n".join(lines)
