"""Solver session API: ``Problem`` + ``MinCutSession`` + ``SolveResult``.

The pipeline (partition → reorder → IRLS with warm-started block-Jacobi
PCG → rounding) has two kinds of state:

* **topology-level** — the k-way partition, the node reordering, the
  block/ELL plans.  Built ONCE per graph topology (``Problem``) and reused
  across every solve on it.
* **numeric** — edge/terminal weights, voltages, the per-iteration
  reweighted systems.  Fresh per solve (``MinCutSession.solve``).

This slice of the port runs the ``"host"`` backend: a host-driven IRLS loop
whose steps run on the session's device.  The JAX package's ``"scanned"``
and ``"sharded"`` backends, presolve and delta staging are later slices
(ROADMAP queue 1) and raise ``NotImplementedError`` here.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, NamedTuple, Optional, Union

import numpy as np
import torch
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components

from . import laplacian as lap
from . import precond as pc
from . import rounding as rd
from .incidence import DeviceGraph, device_graph_from_instance
from .irls import (IRLSConfig, IRLSDiagnostics, _Stepper, run_host_loop,
                   torch_dtype)
from .rounding import RoundingResult
from ..graphs import partition as gp
from ..graphs.structures import EdgeList, STInstance, permute_instance


class Weights(NamedTuple):
    """A same-topology weight assignment, in ORIGINAL node/edge order.

    c   : float[m]  non-terminal edge weights (the Problem's edge order)
    c_s : float[n]  terminal-source weights
    c_t : float[n]  terminal-sink weights
    """

    c: np.ndarray
    c_s: np.ndarray
    c_t: np.ndarray


WeightsLike = Union["Weights", STInstance, tuple]


def as_weights(w: WeightsLike) -> Weights:
    """Coerce an STInstance / (c, c_s, c_t) triple into ``Weights``."""
    if isinstance(w, Weights):
        return w
    if isinstance(w, STInstance):
        return Weights(c=np.asarray(w.graph.weight),
                       c_s=np.asarray(w.s_weight),
                       c_t=np.asarray(w.t_weight))
    c, c_s, c_t = w
    return Weights(c=np.asarray(c), c_s=np.asarray(c_s), c_t=np.asarray(c_t))


def check_weights_for(instance: STInstance, weights: WeightsLike) -> Weights:
    """Coerce + validate a weight assignment against ``instance``'s topology
    (shapes + terminal connectivity)."""
    w = as_weights(weights)
    n, m = instance.n, instance.graph.m
    if (w.c.shape[0], w.c_s.shape[0], w.c_t.shape[0]) != (m, n, n):
        raise ValueError(
            f"weights do not match the topology: got "
            f"c[{w.c.shape[0]}], c_s[{w.c_s.shape[0]}], "
            f"c_t[{w.c_t.shape[0]}]; expected c[{m}], c_s[{n}], c_t[{n}]")
    for name, tw in (("c_s", w.c_s), ("c_t", w.c_t)):
        if not np.any(np.asarray(tw) > 0):
            raise ValueError(
                f"{name} has no positive entry: a terminal with no edge "
                f"into the graph makes the reduced Laplacian system "
                f"singular; give at least one node a positive {name} weight")
    return w


class Problem:
    """One-time topology state: instance + partition labels + plans.

    Build once per graph topology with ``Problem.build``; plans are built
    lazily, once per device, and cached."""

    def __init__(self, instance: STInstance, n_blocks: int,
                 labels: np.ndarray, labels_sorted: np.ndarray,
                 perm: Optional[np.ndarray], inv: Optional[np.ndarray],
                 inst_r: STInstance):
        self.instance = instance          # original node order
        self.n_blocks = int(n_blocks)
        self.labels = labels              # original order
        self.labels_sorted = labels_sorted
        self.perm = perm                  # new_id = perm[old_id]; None = id
        self.inv = inv                    # old_id = inv[new_id]
        self.inst_r = inst_r              # reordered instance (solver frame)
        self._cache: Dict[tuple, object] = {}
        self._components: Optional[np.ndarray] = None
        self._plan_lock = threading.RLock()

    @classmethod
    def build(cls, instance: STInstance, n_blocks: int = 16,
              labels: Optional[np.ndarray] = None, seed: int = 0) -> "Problem":
        """Partition (unless ``labels`` given) and reorder the instance.
        ``n_blocks <= 1`` skips partitioning and reordering."""
        n = instance.n
        if n_blocks > 1:
            if labels is None:
                labels = gp.partition_kway(instance.graph, n_blocks, seed=seed)
            labels = np.asarray(labels, dtype=np.int64)
            perm = gp.partition_order(labels)
            inv = np.empty_like(perm)
            inv[perm] = np.arange(n)
            inst_r = permute_instance(instance, perm)
            labels_sorted = np.sort(labels)
        else:
            labels = np.zeros(n, dtype=np.int64)
            labels_sorted = labels
            perm = inv = None
            inst_r = instance
        return cls(instance, n_blocks, labels, labels_sorted, perm, inv,
                   inst_r)

    # -- frames ---------------------------------------------------------------
    def to_original(self, v: np.ndarray) -> np.ndarray:
        """Reordered (solver) frame → original node order."""
        return v[self.perm] if self.perm is not None else v

    def to_reordered(self, v: np.ndarray) -> np.ndarray:
        """Original node order → reordered (solver) frame."""
        return np.asarray(v)[self.inv] if self.inv is not None else np.asarray(v)

    def check_weights(self, weights: WeightsLike) -> Weights:
        """Coerce + validate a weight override against this topology."""
        return check_weights_for(self.instance, weights)

    def component_labels(self) -> np.ndarray:
        """Connected-component labels of the NON-TERMINAL graph (cached)."""
        with self._plan_lock:
            if self._components is None:
                g = self.instance.graph
                adj = coo_matrix((np.ones(g.m, dtype=np.int8),
                                  (np.asarray(g.src), np.asarray(g.dst))),
                                 shape=(g.n, g.n))
                _, self._components = connected_components(adj, directed=False)
            return self._components

    # -- cached plans ---------------------------------------------------------
    def _cached(self, key: tuple, build):
        with self._plan_lock:
            if key not in self._cache:
                self._cache[key] = build()
            return self._cache[key]

    def device_graph(self, dtype=torch.float32,
                     weights: Optional[WeightsLike] = None,
                     device="cuda") -> DeviceGraph:
        """Device-resident (reordered) graph; the index arrays are uploaded
        once per device and shared across every weight vector."""
        device = torch.device(device)
        base = self._cached(("graph", str(dtype), str(device)),
                            lambda: device_graph_from_instance(
                                self.inst_r, dtype=dtype, device=device))
        if weights is None:
            return base
        w = self.check_weights(weights)

        def val(a):
            return torch.as_tensor(np.asarray(a), device=device).to(dtype)

        return DeviceGraph(src=base.src, dst=base.dst, c=val(w.c),
                           c_s=val(self.to_reordered(w.c_s)),
                           c_t=val(self.to_reordered(w.c_t)))

    def block_plan(self, device="cuda") -> pc.BlockPlan:
        g = self.inst_r.graph
        return self._cached(("block", str(torch.device(device))),
                            lambda: pc.build_block_plan(
                                g.src, g.dst, self.labels_sorted,
                                max(1, self.n_blocks), device=device))

    def ell_plan(self, device="cuda") -> lap.EllPlan:
        g = self.inst_r.graph
        return self._cached(("ell", str(torch.device(device))),
                            lambda: lap.build_ell_plan(g.src, g.dst, g.n,
                                                       device=device))

    def instance_with(self, weights: Optional[WeightsLike]) -> STInstance:
        """Original-order instance carrying ``weights`` (for rounding);
        the Problem's own instance when weights is None."""
        if weights is None:
            return self.instance
        w = self.check_weights(weights)
        g = self.instance.graph
        return STInstance(
            graph=EdgeList(src=g.src, dst=g.dst,
                           weight=np.asarray(w.c), n=g.n),
            s_weight=np.asarray(w.c_s), t_weight=np.asarray(w.c_t))


class SolveResult(NamedTuple):
    """Everything a solve produced, in ORIGINAL node order."""

    voltages: np.ndarray                    # x^(T), original node order
    cut: Optional[RoundingResult]           # None when rounding=None
    diagnostics: Optional[IRLSDiagnostics]  # host backend
    residuals: Optional[np.ndarray]         # scanned/sharded only (None here)
    timings: Dict[str, float]               # per-phase seconds
    backend: str
    pcg_iters: Optional[np.ndarray] = None  # scanned/sharded only (None here)
    telemetry: Optional[Dict] = None        # None until obs is ported

    @property
    def cut_value(self) -> float:
        return self.cut.cut_value if self.cut is not None else float("nan")


class MinCutSession:
    """Solver cache over one ``Problem`` on one device.

    Steppers are keyed on the ``IRLSConfig``; the first solve per config pays
    the plan upload, later solves only the numerics.  ``solve(weights=...)``
    re-solves the same topology under new weights; ``solve(warm_from=prev)``
    continues from a previous result's voltages."""

    BACKENDS = ("host",)
    _LATER = {"scanned": "ROADMAP queue 1, item 7 (batched backend)",
              "sharded": "ROADMAP queue 1, item 12 (distributed/)"}

    def __init__(self, problem: Union[Problem, STInstance],
                 cfg: IRLSConfig = IRLSConfig(), backend: str = "host",
                 device="cuda"):
        if isinstance(problem, STInstance):
            n_blocks = cfg.n_blocks if cfg.precond == "block_jacobi" else 1
            problem = Problem.build(problem, n_blocks=n_blocks)
        self.problem = problem
        self.cfg = cfg
        self._check_backend(backend)
        self.backend = backend
        self.device = torch.device(device)
        self._steppers: Dict[IRLSConfig, _Stepper] = {}
        self._lock = threading.Lock()

    def _check_backend(self, backend: str) -> None:
        if backend in self._LATER:
            raise NotImplementedError(
                f"backend {backend!r} is not ported yet: "
                f"{self._LATER[backend]}")
        if backend not in self.BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; "
                             f"known: {self.BACKENDS}")

    def solve(self, weights: Optional[WeightsLike] = None,
              warm_from: Optional[Union[SolveResult, np.ndarray]] = None,
              rounding: Optional[str] = "two_level",
              backend: Optional[str] = None,
              cfg: Optional[IRLSConfig] = None,
              collect_voltages: bool = False,
              presolve: bool = False,
              delta_key: Optional[str] = None) -> SolveResult:
        """IRLS → rounding → SolveResult.

        weights   — same-topology weight override (Weights / STInstance /
                    (c, c_s, c_t)), ORIGINAL order; None = Problem weights.
        warm_from — previous SolveResult (or original-order voltage array)
                    to continue from.
        rounding  — name in ``rounding.REGISTRY`` ("two_level", "sweep"),
                    or None to skip rounding.
        """
        backend = backend or self.backend
        cfg = cfg or self.cfg
        self._check_backend(backend)
        if presolve:
            raise NotImplementedError(
                "presolve is not ported yet: ROADMAP queue 1, item 8")
        if delta_key is not None:
            raise NotImplementedError(
                "delta_key staging is not ported yet: ROADMAP queue 1, item 6")
        trivial = self._check_connectivity(weights, rounding, backend)
        if trivial is not None:
            return trivial
        timings: Dict[str, float] = {}
        t0 = time.perf_counter()
        v, diag = self._solve_host(cfg, weights, warm_from, collect_voltages,
                                   timings)
        timings["irls"] = (time.perf_counter() - t0
                           - timings.get("setup", 0.0))
        cut = None
        if rounding is not None:
            t1 = time.perf_counter()
            cut = rd.round_voltages(rounding, self.problem.instance_with(weights),
                                    v, device=self.device)
            timings["rounding"] = time.perf_counter() - t1
        timings["total"] = time.perf_counter() - t0
        return SolveResult(voltages=v, cut=cut, diagnostics=diag,
                           residuals=None, timings=timings, backend=backend)

    def _check_connectivity(self, weights, rounding, backend):
        """Guard against instances whose reduced Laplacian is singular.

        s and t in different components → the min cut is trivially 0;
        returns that SolveResult instead of letting PCG produce NaNs.
        Components touching NEITHER terminal are singular blocks too; those
        are rejected."""
        w = (self.problem.check_weights(weights) if weights is not None
             else as_weights(self.problem.instance))
        comp = self.problem.component_labels()
        s_comps = np.unique(comp[np.asarray(w.c_s) > 0])
        t_comps = np.unique(comp[np.asarray(w.c_t) > 0])
        if np.intersect1d(s_comps, t_comps).size:
            stray = np.setdiff1d(np.unique(comp),
                                 np.union1d(s_comps, t_comps))
            if stray.size:
                raise ValueError(
                    f"{stray.size} connected component(s) touch neither "
                    f"terminal: their Laplacian blocks are singular and "
                    f"PCG would return garbage voltages there; restrict "
                    f"the graph to the components that touch a terminal")
            return None
        # trivial 0-cut: every component holding an s-terminal goes source
        # side; no terminal edge crosses (no component holds both kinds)
        in_source = np.isin(comp, s_comps)
        cut = None
        if rounding is not None:
            cut = RoundingResult(in_source=in_source, cut_value=0.0,
                                 meta={"method": "trivial_disconnected"})
        return SolveResult(voltages=in_source.astype(np.float64), cut=cut,
                           diagnostics=None, residuals=None,
                           timings={"total": 0.0, "irls": 0.0},
                           backend=backend)

    def _plans_for(self, cfg: IRLSConfig):
        block_plan = None
        if cfg.precond == "block_jacobi":
            # the partition is Problem-level state; a cfg asking for another
            # block count would silently run the wrong preconditioner
            if cfg.n_blocks != self.problem.n_blocks:
                raise ValueError(
                    f"cfg.n_blocks={cfg.n_blocks} does not match the "
                    f"Problem's partition (n_blocks={self.problem.n_blocks}); "
                    f"build the Problem with the matching n_blocks")
            block_plan = self.problem.block_plan(self.device)
        ell_plan = (self.problem.ell_plan(self.device) if cfg.layout == "ell"
                    else None)
        return block_plan, ell_plan

    def _solve_host(self, cfg, weights, warm_from, collect_voltages, timings):
        prob = self.problem
        dtype = torch_dtype(cfg)
        t = time.perf_counter()
        with self._lock:
            stepper = self._steppers.get(cfg)
            if stepper is None:
                block_plan, ell_plan = self._plans_for(cfg)
                stepper = _Stepper(prob.device_graph(dtype, device=self.device),
                                   cfg, block_plan, ell_plan)
                self._steppers[cfg] = stepper
        timings["setup"] = time.perf_counter() - t
        v0 = None
        if warm_from is not None:
            w = (warm_from.voltages if isinstance(warm_from, SolveResult)
                 else warm_from)
            v0 = prob.to_reordered(np.asarray(w))
        dev_w = None
        if weights is not None:
            g = prob.device_graph(dtype, weights, device=self.device)
            dev_w = (g.c, g.c_s, g.c_t)
        v, diag = run_host_loop(stepper, cfg, prob.instance.n, dtype, v0=v0,
                                collect_voltages=collect_voltages,
                                weights=dev_w)
        diag.setup_time = timings["setup"]
        return prob.to_original(v.cpu().numpy()), diag
