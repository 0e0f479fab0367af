"""Append-only bench trajectory store of the port: ``TORCH_BENCH_HISTORY.jsonl``.

A ``BENCH_<name>.json``-style payload is a snapshot that shows the LATEST
number, not the trajectory, and gives the comparator nothing to estimate
noise from.  This module is the history: :func:`append_history` appends
one JSON line per extracted metric of a payload:

    {"bench": "irls", "variant": "smoke", "run": 3,
     "git_sha": "7d954e2", "metric": "topologies[grid]....s_per_solve",
     "value": 0.0042, "kind": "time", "direction": "lower"}

``variant`` separates smoke payloads (tiny instances) from full runs —
their values differ by orders of magnitude and must never share a
baseline.  ``run`` is a monotone per-(bench, variant) counter so "last
K entries" is well defined even when several benches interleave.

A copy of the JAX package's ``repro.obs.perf.history``, with a file of
its own: the port's payloads are measured on the card, and a card run must
never share a baseline with the JAX package's ``BENCH_HISTORY.jsonl``,
whose numbers come from the CPU.
"""
from __future__ import annotations

import json
import os
import subprocess
from typing import Dict, List, Optional

from .schema import extract_metrics

__all__ = ["HISTORY_FILE", "history_path", "git_sha", "history_records",
           "append_history", "read_history"]

HISTORY_FILE = "TORCH_BENCH_HISTORY.jsonl"


def history_path(root: str) -> str:
    return os.path.join(root, HISTORY_FILE)


def git_sha(root: Optional[str] = None) -> str:
    """Short commit sha of ``root`` (cwd when None); "unknown" outside
    git / without the binary — history must never sink a bench run."""
    try:
        out = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                             cwd=root or ".", capture_output=True,
                             text=True, timeout=10)
        sha = out.stdout.strip()
        return sha if out.returncode == 0 and sha else "unknown"
    except Exception:
        return "unknown"


def payload_variant(payload: dict) -> str:
    cfg = payload.get("cfg") or {}
    return "smoke" if cfg.get("smoke") else "full"


def read_history(path: str) -> List[Dict[str, object]]:
    """All records, file order (appends only, so file order = time
    order).  Skips corrupt/partial lines instead of failing the gate."""
    out: List[Dict[str, object]] = []
    if not os.path.exists(path):
        return out
    with open(path, "r") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(rec, dict) and "metric" in rec:
                out.append(rec)
    return out


def _next_run(records: List[Dict[str, object]], bench: str,
              variant: str) -> int:
    runs = [int(r.get("run", 0)) for r in records
            if r.get("bench") == bench and r.get("variant") == variant]
    return (max(runs) + 1) if runs else 0


def history_records(payload: dict, run: int = 0,
                    sha: str = "unknown") -> List[Dict[str, object]]:
    """Flatten one bench payload into its history lines (pure)."""
    bench = payload.get("name", "?")
    variant = payload_variant(payload)
    return [{"bench": bench, "variant": variant, "run": int(run),
             "git_sha": sha, **m} for m in extract_metrics(payload)]


def append_history(payload: dict, path: str,
                   sha: Optional[str] = None) -> List[Dict[str, object]]:
    """Append one bench run's metric records to the trajectory file.

    Reads the existing file only to number the run; the write itself is
    a pure append.  Returns the records written.
    """
    if sha is None:
        sha = git_sha(os.path.dirname(path) or ".")
    existing = read_history(path)
    recs = history_records(
        payload, run=_next_run(existing, payload.get("name", "?"),
                               payload_variant(payload)), sha=sha)
    with open(path, "a") as fh:
        for r in recs:
            fh.write(json.dumps(r, sort_keys=True) + "\n")
    return recs
