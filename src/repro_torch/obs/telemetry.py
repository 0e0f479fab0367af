"""Solver telemetry: the per-solve "why" record and its aggregation.

``SolveResult.telemetry`` (a plain dict, JSON-ready — built by
:func:`build_solve_telemetry` inside ``MinCutSession``) captures what the
timings alone cannot explain:

    backend            host | scanned | sharded
    n, m               instance size actually solved (kernel size under
                       presolve)
    irls_configured    T of the schedule
    irls_executed      iterations that did work (adaptive early exit
                       freezes the tail at 0 PCG iterations)
    pcg_per_iter       PCG spend per IRLS iteration (list)
    pcg_total          sum of the above
    rel_history        per-iteration final PCG relative residual
    eps_first/eps_last eps schedule endpoints (+ schedule name)
    adaptive           early-exit schedule active?
    early_exit_iter    first frozen iteration (None = ran the full T)
    warm_start         True/False/None (None = not applicable)
    presolve           kernelization stats (kernel_n/m, reductions,
                       per-rule fired counts, base) or None
    phases             per-phase wall seconds (setup/presolve/irls/
                       rounding/total; the engine adds queue/assembly)
    flops, hbm_bytes   the work this solve did, counted from its shapes
                       and PCG trace (``obs.perf.profile``; the JAX package
                       reads XLA's cost analysis instead); None when the
                       session does not profile
    achieved_gflops    flops / irls wall seconds / 1e9 (+ achieved_gbps,
                       roofline_fraction against the H100's float32 and HBM
                       rates); None with the cost
    clamped_reweights  sharded reweight-clamp hits this solve (the
                       cfg.reweight_clamp float32 mitigation); None when
                       not applicable
    worker             dispatch-worker id (engine-served solves only —
                       the continuous-batching pool attributes each
                       completed request to the worker that executed it)

:class:`TelemetryAggregator` folds those dicts into a bounded summary —
per ``MinCutSession`` (every session owns one) and per ``MinCutServer``
(the engine feeds completed requests in, queue time included), surfaced
by ``stats()["telemetry"]``.  A copy of the JAX package's
``repro.obs.telemetry``.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

import numpy as np

from .metrics import Reservoir

__all__ = ["build_solve_telemetry", "TelemetryAggregator"]


def _as_float_list(x) -> Optional[List[float]]:
    if x is None:
        return None
    return [float(v) for v in np.asarray(x).ravel()]


def _as_int_list(x) -> Optional[List[int]]:
    if x is None:
        return None
    return [int(v) for v in np.asarray(x).ravel()]


def build_solve_telemetry(cfg, backend: str, n: int, m: int,
                          timings: Dict[str, float],
                          pcg_iters=None, residuals=None, diagnostics=None,
                          warm_start: Optional[bool] = None,
                          presolve: Optional[Dict[str, Any]] = None,
                          cost: Optional[Dict[str, Any]] = None,
                          clamped_reweights: Optional[int] = None,
                          ) -> Dict[str, Any]:
    """Assemble the per-solve telemetry dict (see module docstring).

    ``pcg_iters``/``residuals`` come from the scanned/sharded programs;
    the host backend supplies ``diagnostics`` (IRLSDiagnostics) instead.
    """
    from ..core.irls import eps_schedule_array

    if diagnostics is not None and pcg_iters is None:
        pcg_iters = diagnostics.pcg_iters
    if diagnostics is not None and residuals is None:
        residuals = diagnostics.pcg_residuals
    iters = _as_int_list(pcg_iters)
    rels = _as_float_list(residuals)
    eps = eps_schedule_array(cfg)
    adaptive = bool(cfg.irls_tol > 0 or cfg.adaptive_tol)
    executed = None
    early_exit = None
    if iters is not None:
        nz = [i for i, it in enumerate(iters) if it > 0]
        executed = len(nz)
        # trailing zeros under the adaptive schedule = the frozen tail;
        # +1 maps the iteration index to 1-based "exited after iteration k"
        if adaptive and iters and iters[-1] == 0:
            early_exit = (nz[-1] + 1) if nz else 0
    cost = cost or {}
    return {
        "backend": backend,
        "n": int(n),
        "m": int(m),
        "flops": cost.get("flops"),
        "hbm_bytes": cost.get("hbm_bytes"),
        "achieved_gflops": cost.get("achieved_gflops"),
        "achieved_gbps": cost.get("achieved_gbps"),
        "roofline_fraction": cost.get("roofline_fraction"),
        "clamped_reweights": (int(clamped_reweights)
                              if clamped_reweights is not None else None),
        "irls_configured": int(cfg.n_irls),
        "irls_executed": executed,
        "pcg_per_iter": iters,
        "pcg_total": int(sum(iters)) if iters is not None else None,
        "rel_history": rels,
        "eps_first": float(eps[0]) if len(eps) else float(cfg.eps),
        "eps_last": float(eps[-1]) if len(eps) else float(cfg.eps),
        "eps_schedule": cfg.eps_schedule,
        "adaptive": adaptive,
        "early_exit_iter": early_exit,
        "warm_start": warm_start,
        "presolve": presolve,
        "phases": {k: float(v) for k, v in (timings or {}).items()},
    }


class TelemetryAggregator:
    """Bounded fold of per-solve telemetry dicts (thread-safe).

    ``add`` is cheap (lock + a handful of scalar updates + reservoir
    inserts); ``snapshot`` renders the aggregate the server/bench payloads
    embed: solve counts per backend, PCG spend distribution, phase time
    totals and shares, early-exit/warm-start/presolve rates, kernel
    reduction distribution.
    """

    def __init__(self, max_samples: int = 2048):
        self._lock = threading.Lock()
        self._max_samples = max_samples
        self._reset()

    def _reset(self) -> None:
        self.solves = 0
        self.by_backend: Dict[str, int] = {}
        self.by_worker: Dict[str, int] = {}
        self.pcg = Reservoir(self._max_samples)
        self.irls = Reservoir(self._max_samples)
        self.phase_totals: Dict[str, float] = {}
        self.adaptive_solves = 0
        self.early_exits = 0
        self.warm_hits = 0
        self.warm_known = 0
        self.presolve_solves = 0
        self.kernel_node_reduction = Reservoir(self._max_samples)
        self.flops_total = 0
        self.profiled_solves = 0
        self.achieved_gflops = Reservoir(self._max_samples)
        self.clamped_reweights_total = 0

    def clear(self) -> None:
        with self._lock:
            self._reset()

    def add(self, t: Optional[Dict[str, Any]]) -> None:
        if not t:
            return
        with self._lock:
            self.solves += 1
            b = t.get("backend", "?")
            self.by_backend[b] = self.by_backend.get(b, 0) + 1
            if t.get("worker") is not None:
                w = str(t["worker"])
                self.by_worker[w] = self.by_worker.get(w, 0) + 1
            if t.get("pcg_total") is not None:
                self.pcg.add(t["pcg_total"])
            if t.get("irls_executed") is not None:
                self.irls.add(t["irls_executed"])
            for ph, v in (t.get("phases") or {}).items():
                self.phase_totals[ph] = self.phase_totals.get(ph, 0.0) + v
            if t.get("adaptive"):
                self.adaptive_solves += 1
                if t.get("early_exit_iter") is not None:
                    self.early_exits += 1
            if t.get("warm_start") is not None:
                self.warm_known += 1
                if t["warm_start"]:
                    self.warm_hits += 1
            if t.get("flops"):
                self.flops_total += int(t["flops"])
                self.profiled_solves += 1
                if t.get("achieved_gflops") is not None:
                    self.achieved_gflops.add(t["achieved_gflops"])
            if t.get("clamped_reweights"):
                self.clamped_reweights_total += int(t["clamped_reweights"])
            p = t.get("presolve")
            if p:
                self.presolve_solves += 1
                if p.get("node_reduction") is not None and \
                        np.isfinite(p["node_reduction"]):
                    self.kernel_node_reduction.add(p["node_reduction"])

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            total = self.phase_totals.get("total", 0.0)
            phases = dict(self.phase_totals)
            shares = {ph: (v / total if total > 0 else float("nan"))
                      for ph, v in phases.items() if ph != "total"}
            return {
                "solves": self.solves,
                "by_backend": dict(self.by_backend),
                "by_worker": dict(self.by_worker),
                "mean_pcg_iters_per_solve": self.pcg.mean,
                "p90_pcg_iters_per_solve": self.pcg.percentile(90),
                "mean_irls_iters_per_solve": self.irls.mean,
                "phase_seconds": phases,
                "phase_share_of_total": shares,
                "adaptive_solves": self.adaptive_solves,
                "early_exit_rate": (self.early_exits / self.adaptive_solves
                                    if self.adaptive_solves else float("nan")),
                "warm_start_rate": (self.warm_hits / self.warm_known
                                    if self.warm_known else float("nan")),
                "presolve_solves": self.presolve_solves,
                "mean_kernel_node_reduction": self.kernel_node_reduction.mean,
                "profiled_solves": self.profiled_solves,
                "total_flops": self.flops_total,
                "mean_achieved_gflops": self.achieved_gflops.mean,
                "p90_achieved_gflops": self.achieved_gflops.percentile(90),
                "clamped_reweights_total": self.clamped_reweights_total,
            }
