"""Solver session API: ``Problem`` + ``MinCutSession`` + ``SolveResult``.

The pipeline (partition → reorder → IRLS with warm-started block-Jacobi
PCG → rounding) has two kinds of state:

* **topology-level** — the k-way partition, the node reordering, the
  block/ELL plans.  Built ONCE per graph topology (``Problem``) and reused
  across every solve on it.
* **numeric** — edge/terminal weights, voltages, the per-iteration
  reweighted systems.  Fresh per solve (``MinCutSession.solve``).

Two backends run on the session's device:

  backend     driver                                    solve_batch
  ─────────   ───────────────────────────────────────   ───────────
  "host"      ``run_host_loop``: one IRLS iteration     no
              per call, PCG stopping on tolerance,
              full diagnostics
  "scanned"   ``make_scanned_program``: all T           yes (a batch of
              iterations on the fixed or masked         B lanes in one
              adaptive schedule                         program)

The JAX package's ``"sharded"`` backend, presolve and delta staging are
later slices (ROADMAP queue 1) and raise ``NotImplementedError`` here.
"""
from __future__ import annotations

import hashlib
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components

from . import laplacian as lap
from . import precond as pc
from . import rounding as rd
from .incidence import DeviceGraph, device_graph_from_instance
from .irls import (IRLSConfig, IRLSDiagnostics, _Stepper, make_scanned_program,
                   run_host_loop, torch_dtype)
from .rounding import RoundingResult
from ..graphs import partition as gp
from ..graphs.structures import EdgeList, STInstance, permute_instance
from ..obs import trace
from ..obs.metrics import get_registry
from ..obs.telemetry import TelemetryAggregator, build_solve_telemetry


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


def rebind_terminals(instance: STInstance, u: int, v: int,
                     c: Optional[np.ndarray] = None,
                     strength: Optional[float] = None) -> Weights:
    """One-hot terminal rebinding: ``Weights`` whose only terminal edges are
    s—``u`` and t—``v``, each with capacity ``strength``.

    Any ``strength`` ≥ the u-v min cut of the non-terminal graph keeps the
    terminal edges uncut, so the instance's min cut IS the u-v min cut of
    the graph under ``c`` (default: the instance's own edge weights).  The
    default strength is ``1 + min(d_c(u), d_c(v))``: the weighted degree
    already bounds the u-v min cut, and staying near the graph's own weight
    scale keeps the IRLS conductances well-conditioned.  The topology is
    untouched, so solves under the returned weights reuse every plan."""
    n = instance.n
    u, v = int(u), int(v)
    if not (0 <= u < n and 0 <= v < n):
        raise ValueError(f"terminal pair ({u}, {v}) out of range for n={n}")
    if u == v:
        raise ValueError(f"terminal pair must be distinct, got ({u}, {v})")
    default_c = c is None
    c = np.asarray(instance.graph.weight if default_c else c,
                   dtype=np.float64)
    if c.shape[0] != instance.graph.m:
        raise ValueError(f"c has {c.shape[0]} edges; topology has "
                         f"{instance.graph.m}")
    if strength is None:
        if default_c:
            deg = instance.graph.weighted_degrees()
        else:
            deg = np.zeros(n, dtype=np.float64)
            np.add.at(deg, np.asarray(instance.graph.src), c)
            np.add.at(deg, np.asarray(instance.graph.dst), c)
        strength = 1.0 + min(deg[u], deg[v])
    c_s = np.zeros(n, dtype=np.float64)
    c_t = np.zeros(n, dtype=np.float64)
    c_s[u] = strength
    c_t[v] = strength
    return Weights(c=c, c_s=c_s, c_t=c_t)


def topology_fingerprint(instance: STInstance) -> str:
    """Content hash of the graph TOPOLOGY (n + oriented edge list).

    Weights are excluded: two instances that differ only in edge/terminal
    weights share a fingerprint, and so every topology-level artifact.  The
    same blake2b hash as the JAX package's, so the two packages agree on
    every fingerprint.  The cache key of the serving layer."""
    g = instance.graph
    h = hashlib.blake2b(digest_size=16)
    h.update(np.int64(g.n).tobytes())
    h.update(np.ascontiguousarray(np.asarray(g.src, dtype=np.int64)).tobytes())
    h.update(np.ascontiguousarray(np.asarray(g.dst, dtype=np.int64)).tobytes())
    return h.hexdigest()


def _lanes_to(arrays, dtype, device) -> torch.Tensor:
    """Stack one host array per lane into a (B, ·) tensor on ``device``,
    each rounded to ``dtype`` on the host first (half the upload)."""
    return torch.stack([torch.as_tensor(np.asarray(a)).to(dtype)
                        for a in arrays]).to(device)


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
        self._fingerprint: Optional[str] = None
        self._plan_lock = threading.RLock()

    @property
    def fingerprint(self) -> str:
        """Topology content hash (see ``topology_fingerprint``)."""
        with self._plan_lock:
            if self._fingerprint is None:
                self._fingerprint = topology_fingerprint(self.instance)
            return self._fingerprint

    def rebind_terminals(self, u: int, v: int,
                         c: Optional[np.ndarray] = None,
                         strength: Optional[float] = None) -> Weights:
        """Weights that re-pin the terminals to the node pair (u, v): a
        pure weight change (see ``rebind_terminals``)."""
        return rebind_terminals(self.instance, u, v, c=c, strength=strength)

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
    diagnostics: Optional[IRLSDiagnostics]  # host backend only
    residuals: Optional[np.ndarray]         # scanned: PCG residual per IRLS
                                            # iteration
    timings: Dict[str, float]               # per-phase seconds
    backend: str
    pcg_iters: Optional[np.ndarray] = None  # scanned: PCG iterations spent
                                            # per IRLS iteration (0 once
                                            # the adaptive mask froze it)
    telemetry: Optional[Dict] = None        # per-solve record (obs.telemetry;
                                            # cost fields None)

    @property
    def cut_value(self) -> float:
        return self.cut.cut_value if self.cut is not None else float("nan")


class MinCutSession:
    """Solver cache over one ``Problem`` on one device.

    Steppers and scanned programs are keyed on ``(IRLSConfig, backend,
    ...)``; the first solve per key pays the plan upload, later solves only
    the numerics.  ``solve(weights=...)`` re-solves the same topology under
    new weights; ``solve(warm_from=prev)`` continues from a previous
    result's voltages; ``solve_batch`` solves many weight assignments of the
    topology in one batched scanned program.  Safe to share between the
    serving engine's worker threads: every cache build runs once, under a
    lock per key."""

    BACKENDS = ("host", "scanned")
    _LATER = {"sharded": "ROADMAP queue 1, item 12 (distributed/)"}

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
        self._steppers: Dict[tuple, object] = {}
        self._cache_lock = threading.Lock()
        self._compile_locks: Dict[tuple, threading.Lock] = {}
        # per-session fold of every SolveResult.telemetry (obs.telemetry)
        self.telemetry = TelemetryAggregator()

    def _check_backend(self, backend: str) -> None:
        if backend in self._LATER:
            raise NotImplementedError(
                f"backend {backend!r} is not ported yet: "
                f"{self._LATER[backend]}")
        if backend not in self.BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; "
                             f"known: {self.BACKENDS}")

    @staticmethod
    def _check_delta_key(cfg: IRLSConfig) -> None:
        """A delta key changes nothing off the fused-ELL path (the JAX
        package only records the weights there); on it, it would restage
        the ELL weight table in place, which is not ported yet."""
        if cfg.layout == "ell" and cfg.fuse_edge_sweep:
            raise NotImplementedError(
                "delta_key staging of the fused-ELL weight table is not "
                "ported yet: ROADMAP queue 1, delta staging")

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
        delta_key — identity of a weight sequence: accepted and without
                    effect off the fused-ELL path; on it, not ported yet.
        """
        backend = backend or self.backend
        cfg = cfg or self.cfg
        self._check_backend(backend)
        if presolve:
            raise NotImplementedError(
                "presolve is not ported yet: ROADMAP queue 1, item 8")
        if delta_key is not None:
            self._check_delta_key(cfg)
        trivial = self._check_connectivity(weights, rounding, backend)
        if trivial is not None:
            return trivial
        timings: Dict[str, float] = {}
        diag = rels = pcg_iters = None
        get_registry().counter(f"session_solves_{backend}_total").inc()
        t0 = time.perf_counter()
        with trace.span("session.solve", backend=backend,
                        n=self.problem.instance.n):
            with trace.span("session.irls", backend=backend):
                if backend == "host":
                    v, diag = self._solve_host(cfg, weights, warm_from,
                                               collect_voltages, timings)
                else:
                    v, rels, pcg_iters = self._solve_scanned(
                        cfg, weights, timings, warm_from)
            timings["irls"] = (time.perf_counter() - t0
                               - timings.get("setup", 0.0))
            # a single solve is its own batch: the solver wall a caller
            # waited behind equals this request's IRLS time
            timings["irls_wall"] = timings["irls"]
            cut = None
            if rounding is not None:
                t1 = time.perf_counter()
                with trace.span("session.rounding", method=rounding):
                    cut = rd.round_voltages(
                        rounding, self.problem.instance_with(weights), v,
                        device=self.device)
                timings["rounding"] = time.perf_counter() - t1
            timings["total"] = time.perf_counter() - t0
        tel = build_solve_telemetry(
            cfg, backend, self.problem.instance.n,
            self.problem.instance.graph.m, timings, pcg_iters=pcg_iters,
            residuals=rels, diagnostics=diag,
            warm_start=warm_from is not None)
        self.telemetry.add(tel)
        return SolveResult(voltages=v, cut=cut, diagnostics=diag,
                           residuals=rels, timings=timings, backend=backend,
                           pcg_iters=pcg_iters, telemetry=tel)

    def solve_batch(self, weights_batch: Sequence[WeightsLike],
                    rounding: Optional[str] = "two_level",
                    cfg: Optional[IRLSConfig] = None,
                    pad_to: Optional[int] = None,
                    presolve: bool = False,
                    warm_from: Optional[Sequence] = None,
                    delta_keys: Optional[Sequence[Optional[str]]] = None,
                    ) -> List[SolveResult]:
        """Solve MANY same-topology instances in one batched scanned program
        — the serving path (segmentation frames, FlowImprove populations).
        The lanes share the topology and plans; rounding runs per instance
        afterwards.

        ``pad_to`` pads the batch up to that length by repeating the last
        weight vector (the micro-batcher's power-of-two buckets); only the
        real results are returned.  ``warm_from`` — one previous
        SolveResult / original-order voltage array per entry: the whole
        batch runs the warm-started program.  Entries whose terminals lie
        in different components resolve to the trivial 0-cut and drop out
        of the batch.  ``delta_keys`` — one weight-sequence identity per
        entry: accepted and without effect off the fused-ELL path; on it,
        not ported yet.  ``presolve`` is not ported yet."""
        ws = [self.problem.check_weights(w) for w in weights_batch]
        if not ws:
            # empty batch: nothing to stack, nothing to build
            return []
        cfg = cfg or self.cfg
        if delta_keys is not None and len(delta_keys) != len(ws):
            raise ValueError(f"delta_keys has {len(delta_keys)} entries for "
                             f"a batch of {len(ws)}")
        if presolve:
            raise NotImplementedError(
                "presolve is not ported yet: ROADMAP queue 1, item 8")
        if delta_keys is not None and any(k is not None for k in delta_keys):
            self._check_delta_key(cfg)
        prob = self.problem
        dtype = torch_dtype(cfg)
        warm = warm_from is not None
        if warm and len(warm_from) != len(ws):
            raise ValueError(f"warm_from has {len(warm_from)} entries for a "
                             f"batch of {len(ws)}")
        # disconnected entries resolve trivially and drop out of the batch
        out: List[Optional[SolveResult]] = [None] * len(ws)
        live: List[int] = []
        for i, w in enumerate(ws):
            out[i] = self._check_connectivity(w, rounding, "scanned")
            if out[i] is None:
                live.append(i)
        if not live:
            return [r for r in out if r is not None]
        ws_live = [ws[i] for i in live]
        n_real = len(ws_live)
        pad = 0
        if pad_to is not None:
            if pad_to < n_real:
                raise ValueError(f"pad_to={pad_to} is smaller than the batch "
                                 f"({n_real})")
            pad = pad_to - n_real
        get_registry().counter("session_solves_scanned_total").inc(n_real)
        t0 = time.perf_counter()
        with trace.span("session.solve_batch", size=n_real,
                        pad_to=pad_to or n_real, warm=warm):
            run = self._get_scanned(cfg, dtype, warm)
            ws_run = ws_live + [ws_live[-1]] * pad
            C = _lanes_to([w.c for w in ws_run], dtype, self.device)
            CS = _lanes_to([prob.to_reordered(w.c_s) for w in ws_run], dtype,
                           self.device)
            CT = _lanes_to([prob.to_reordered(w.c_t) for w in ws_run], dtype,
                           self.device)
            with trace.span("session.irls", backend="scanned",
                            batch=len(ws_run)):
                if warm:
                    vs = [np.asarray(v.voltages
                                     if isinstance(v, SolveResult) else v)
                          for v in warm_from]
                    vs_run = [vs[i] for i in live] + [vs[live[-1]]] * pad
                    V0 = _lanes_to([prob.to_reordered(v) for v in vs_run],
                                   dtype, self.device)
                    V, RELS, ITERS = run(C, CS, CT, V0)
                else:
                    V, RELS, ITERS = run(C, CS, CT)
                del C, CS, CT
                V = V.cpu().numpy()
                RELS = RELS.cpu().numpy()
                ITERS = ITERS.cpu().numpy()
            t_irls = time.perf_counter() - t0
            rounded = []
            for j, i in enumerate(live):
                w = ws_live[j]
                v = prob.to_original(V[j])
                cut = None
                t1 = time.perf_counter()
                if rounding is not None:
                    with trace.span("session.rounding", method=rounding):
                        cut = rd.round_voltages(rounding,
                                                prob.instance_with(w), v,
                                                device=self.device)
                rounded.append((i, j, v, cut, time.perf_counter() - t1))
            # every caller's future resolves only once the WHOLE batch
            # returns, so the solver wall a request waited behind is the
            # full batch wall minus its own rounding (counted separately)
            t_wall = time.perf_counter() - t0
            for i, j, v, cut, t_round in rounded:
                timings = {"irls": t_irls / n_real,
                           "irls_wall": t_wall - t_round,
                           "rounding": t_round}
                tel = build_solve_telemetry(
                    cfg, "scanned", prob.instance.n, prob.instance.graph.m,
                    timings, pcg_iters=ITERS[j], residuals=RELS[j],
                    warm_start=warm)
                self.telemetry.add(tel)
                out[i] = SolveResult(
                    voltages=v, cut=cut, diagnostics=None,
                    residuals=RELS[j], timings=timings, backend="scanned",
                    pcg_iters=ITERS[j], telemetry=tel)
        return [r for r in out if r is not None]

    def telemetry_snapshot(self) -> Dict[str, object]:
        """Aggregated telemetry over every solve this session ran (PCG
        spend distribution, phase walls, early-exit/warm-start rates)."""
        return self.telemetry.snapshot()

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
        timings = {"total": 0.0, "irls": 0.0}
        tel = build_solve_telemetry(
            self.cfg, backend, self.problem.instance.n,
            self.problem.instance.graph.m, timings, pcg_iters=[])
        tel["trivial"] = "disconnected"
        self.telemetry.add(tel)
        return SolveResult(voltages=in_source.astype(np.float64), cut=cut,
                           diagnostics=None, residuals=None,
                           timings=timings, backend=backend, pcg_iters=None,
                           telemetry=tel)

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

    def _cached(self, key: tuple, build):
        """The cached driver under ``key``, built once: concurrent callers
        of a cold key wait for the one build (a lock per key)."""
        got = self._steppers.get(key)
        if got is None:
            with self._cache_lock:
                lock = self._compile_locks.setdefault(key, threading.Lock())
            with lock:
                got = self._steppers.get(key)
                if got is None:
                    got = build()
                    self._steppers[key] = got
        return got

    def _solve_host(self, cfg, weights, warm_from, collect_voltages, timings):
        prob = self.problem
        dtype = torch_dtype(cfg)
        t = time.perf_counter()

        def build():
            block_plan, ell_plan = self._plans_for(cfg)
            return _Stepper(prob.device_graph(dtype, device=self.device),
                            cfg, block_plan, ell_plan)

        stepper = self._cached((cfg, "host"), build)
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

    def _get_scanned(self, cfg, dtype, warm: bool):
        """The scanned program of ``cfg``, cached on (cfg, warm).  One
        program serves a single solve (a batch of one) and a batch alike."""
        def build():
            block_plan, ell_plan = self._plans_for(cfg)
            g0 = self.problem.device_graph(dtype, device=self.device)
            return make_scanned_program(g0.src, g0.dst, cfg, block_plan,
                                        ell_plan, warm=warm)

        return self._cached((cfg, "scanned", warm), build)

    def _solve_scanned(self, cfg, weights, timings, warm_from=None):
        prob = self.problem
        dtype = torch_dtype(cfg)
        warm = warm_from is not None
        t = time.perf_counter()
        have = (cfg, "scanned", warm) in self._steppers
        run = self._get_scanned(cfg, dtype, warm)
        timings["setup"] = 0.0 if have else time.perf_counter() - t
        # a batch of one lane: the arithmetic of every lane of solve_batch,
        # so a solo solve and the same weights co-batched agree
        g = prob.device_graph(dtype, weights, device=self.device)
        args = [g.c[None], g.c_s[None], g.c_t[None]]
        if warm:
            wv = np.asarray(warm_from.voltages
                            if isinstance(warm_from, SolveResult)
                            else warm_from)
            args.append(_lanes_to([prob.to_reordered(wv)], dtype, self.device))
        v, rels, iters = run(*args)
        return (prob.to_original(v[0].cpu().numpy()), rels[0].cpu().numpy(),
                iters[0].cpu().numpy())
