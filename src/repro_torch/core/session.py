"""Solver session API: ``Problem`` + ``MinCutSession`` + ``SolveResult``.

The pipeline (partition → reorder → IRLS with warm-started block-Jacobi
PCG → rounding) has two kinds of state:

* **topology-level** — the k-way partition, the node reordering, the
  block/ELL plans.  Built ONCE per graph topology (``Problem``) and reused
  across every solve on it.
* **numeric** — edge/terminal weights, voltages, the per-iteration
  reweighted systems.  Fresh per solve (``MinCutSession.solve``).

Three backends run on the session's device:

  backend     driver                                 warm_from  solve_batch
  ─────────   ────────────────────────────────────   ─────────  ───────────
  "host"      ``run_host_loop``: one IRLS iteration  yes        no
              per call, PCG stopping on tolerance,
              full diagnostics
  "scanned"   ``make_scanned_program``: all T        yes        yes (B lanes
              iterations on the fixed or masked                 in one
              adaptive schedule                                 program)
  "sharded"   ``distributed.solver.ShardedSolver``:  no         no (a batch
              the halo or psum schedule over the                runs the
              ranks of a ``torch.distributed``                  scanned
              group (§3.3)                                      program)

All three run presolve (``presolve=True``: exact kernelization, the kernel
solved on the same backend and device, the result lifted back with a cut
certificate); host and scanned run delta staging (``delta_key=``: a keyed
weight sequence restages only the changed slots of the fused-ELL weight
table), the sharded backend its own incremental plan refill.  A sharded
session runs on every rank of its group (None: the default group, or a
world of one that the solver initializes and that stays the default group
until ``distributed.collectives.release_world()``), and each rank gets the
same result.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from collections import OrderedDict
from typing import Dict, List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from . import laplacian as lap
from . import precond as pc
from . import rounding as rd
from .incidence import DeviceGraph, device_graph_from_instance
from .adaptive import is_adaptive
from .irls import (IRLSConfig, IRLSDiagnostics, _Stepper, make_scanned_program,
                   run_host_loop, torch_dtype)
from .rounding import RoundingResult
from ..graphs import partition as gp
from ..graphs.structures import EdgeList, STInstance, permute_instance
from ..obs import trace
from ..obs.metrics import get_registry
from ..obs.perf import profile as perf_profile
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

# delta staging engages only while the diff stays this sparse; beyond it a
# full restage is cheaper (one dense scatter against a large gather/scatter
# pair)
DELTA_MAX_FRAC = 0.25


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
        """Connected-component labels of the NON-TERMINAL graph (cached):
        two nodes share a label iff a path of graph edges joins them, each
        component labelled by its smallest node id.  Used by the solve
        guard against s-t-disconnected instances."""
        with self._plan_lock:
            if self._components is None:
                from ..presolve.rules import _connected_components
                g = self.instance.graph
                self._components = _connected_components(
                    g.n, np.asarray(g.src, dtype=np.int64),
                    np.asarray(g.dst, dtype=np.int64))
            return self._components

    # -- contraction-derived problems ------------------------------------------
    def derive(self, vertex_map: np.ndarray, n_blocks: int = 1,
               seed: int = 0):
        """Contract this topology by ``vertex_map`` (int[n] -> [0, k)) and
        build a Problem on the contracted graph.

        Returns ``(problem, derived)``; ``derived`` (a
        ``presolve.DerivedInstance``) carries the vertex/edge maps:
        ``derived.project_weights(c)`` pushes same-topology edge weights
        onto the contracted graph and ``derived.lift_partition(side)``
        pulls a contracted side assignment back to the original vertices."""
        from ..presolve.contract import derive_instance
        d = derive_instance(self.instance, vertex_map)
        return Problem.build(d.instance, n_blocks=n_blocks, seed=seed), d

    def contract(self, s_nodes, t_nodes, n_blocks: int = 1, seed: int = 0,
                 strength: Optional[float] = None):
        """Merge ``s_nodes`` into one supernode and ``t_nodes`` into
        another (disjoint node sets or single ints) and pin the terminals
        to the two supernodes.

        Returns ``(problem, derived, weights)``: the contracted Problem,
        the projection/lift maps, and one-hot terminal ``Weights`` on the
        contracted instance (``rebind_terminals`` semantics)."""
        from ..presolve.contract import contraction_map, derive_instance
        s_arr = np.atleast_1d(np.asarray(s_nodes, dtype=np.int64))
        t_arr = np.atleast_1d(np.asarray(t_nodes, dtype=np.int64))
        if np.intersect1d(s_arr, t_arr).size:
            raise ValueError("s_nodes and t_nodes must be disjoint")
        vm = contraction_map(self.instance.n, [s_arr, t_arr])
        d = derive_instance(self.instance, vm)
        prob = Problem.build(d.instance, n_blocks=n_blocks, seed=seed)
        w = rebind_terminals(d.instance, int(vm[s_arr[0]]), int(vm[t_arr[0]]),
                             strength=strength)
        return prob, d, w

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

        return base._replace(c=val(w.c), c_s=val(self.to_reordered(w.c_s)),
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

    def ell_delta_map(self, device="cuda") -> lap.EllDeltaMap:
        """Per-edge (row, lane) slot pairs of the ELL plan on ``device``:
        the scatter targets of delta staging
        (``lap.ell_edge_weights_delta``).  Topology-level like the plan;
        built once per device, lazily."""
        return self._cached(("ell_delta", str(torch.device(device))),
                            lambda: lap.build_ell_delta_map(
                                self.ell_plan(device)))

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
    telemetry: Optional[Dict] = None        # per-solve record (obs.telemetry)

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
    lock per key.

    ``schedule`` ("halo" or "psum"), ``precond_bs`` and ``group`` configure
    the sharded backend (``distributed.solver.ShardedSolver``).
    ``profile`` — count every solve's work into its telemetry (FLOPs,
    bytes, achieved rates, H100 roofline fraction; ``obs.perf.profile``);
    None follows ``profile.default_enabled()``."""

    BACKENDS = ("host", "scanned", "sharded")

    def __init__(self, problem: Union[Problem, STInstance],
                 cfg: IRLSConfig = IRLSConfig(), backend: str = "host",
                 device="cuda", schedule: str = "halo",
                 precond_bs: int = 128, group=None,
                 profile: Optional[bool] = None):
        if isinstance(problem, STInstance):
            n_blocks = cfg.n_blocks if cfg.precond == "block_jacobi" else 1
            problem = Problem.build(problem, n_blocks=n_blocks)
        self.problem = problem
        self.cfg = cfg
        self._check_backend(backend)
        self.backend = backend
        self.device = torch.device(device)
        self.schedule = schedule
        self.precond_bs = precond_bs
        self.group = group
        self._steppers: Dict[tuple, object] = {}
        # sharded: whether each solver's plans hold override weights
        self._sharded_weights: Dict[tuple, bool] = {}
        # _cache_lock guards the lock table and the LRUs below
        self._cache_lock = threading.Lock()
        self._compile_locks: Dict[tuple, threading.Lock] = {}
        # presolve state: kernels keyed on a weight-content hash (the rules
        # are weight-dependent), kernel SESSIONS keyed on the kernel's
        # topology fingerprint, so weight vectors that reduce to the same
        # kernel topology share its partition, plans and drivers
        self._kernels: "OrderedDict[str, object]" = OrderedDict()
        self._kernel_max = 16
        self._kernel_sessions: Dict[tuple, MinCutSession] = {}
        # drift-aware kernel reuse: the latest (weights, kernel) per delta
        # key, so a sparse weight change revalidates the reduction journal
        # and patches the kernel weights instead of re-running the fixpoint
        self._kernel_recent: "OrderedDict[str, tuple]" = OrderedDict()
        self._kernel_outcomes = {"reuse": 0, "patch": 0, "rebuild": 0}
        # delta staging: per key the previous weights and staged ELL table,
        # so a solve that drifts few edges rewrites only their slots
        self._delta: "OrderedDict[str, dict]" = OrderedDict()
        self._delta_max = 64
        # per-session fold of every SolveResult.telemetry (obs.telemetry)
        self.telemetry = TelemetryAggregator()
        # continuous profiling (obs.perf.profile): per driver key the
        # solve's shape and its per-unit work
        self._profile = profile
        self._program_costs: Dict[tuple, dict] = {}

    def _check_backend(self, backend: str) -> None:
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
        presolve  — kernelize first (``presolve``): exact s,t-safe
                    reductions shrink the instance, the kernel is solved on
                    the requested backend, and voltages/partition/cut are
                    lifted back to the original n with an exact cut-value
                    certificate.  Kernels and kernel sessions are cached on
                    this session.
        delta_key — identity of a weight SEQUENCE (e.g. a serving tenant):
                    the session remembers the previous weights under this
                    key, diffs the new ones against them, and (a) restages
                    only the changed ELL slots on the fused-ELL path and
                    (b) revalidates + patches the cached presolve kernel
                    instead of re-kernelizing.  Results are bit-equal to
                    the path without a key.
        """
        backend = backend or self.backend
        cfg = cfg or self.cfg
        self._check_backend(backend)
        if presolve:
            return self._solve_presolve(weights, warm_from, rounding,
                                        backend, cfg, delta_key=delta_key)
        if warm_from is not None and backend == "sharded":
            raise ValueError("warm_from is only supported on the host and "
                             "scanned backends (sharded runs a fixed cold "
                             "schedule)")
        trivial = self._check_connectivity(weights, rounding, backend)
        if trivial is not None:
            return trivial
        c_ell = delta_tel = None
        if delta_key is not None:
            w_chk = (self.problem.check_weights(weights)
                     if weights is not None
                     else as_weights(self.problem.instance))
            c_ell, delta_tel = self._stage_with_delta(w_chk, cfg, backend,
                                                      delta_key)
        timings: Dict[str, float] = {}
        diag = rels = pcg_iters = None
        get_registry().counter(f"session_solves_{backend}_total").inc()
        t0 = time.perf_counter()
        with trace.span("session.solve", backend=backend,
                        n=self.problem.instance.n):
            with trace.span("session.irls", backend=backend):
                if backend == "host":
                    v, diag = self._solve_host(cfg, weights, warm_from,
                                               collect_voltages, timings,
                                               c_ell=c_ell)
                elif backend == "sharded":
                    v, rels, pcg_iters = self._solve_sharded(cfg, weights,
                                                             timings)
                else:
                    v, rels, pcg_iters = self._solve_scanned(
                        cfg, weights, timings, warm_from, c_ell=c_ell)
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
        clamped = sharded_refill = None
        if backend == "sharded":
            solver = self._steppers.get((cfg, "sharded", self.schedule))
            clamped = solver.last_clamped
            sharded_refill = dict(solver.delta_stats)
        tel = build_solve_telemetry(
            cfg, backend, self.problem.instance.n,
            self.problem.instance.graph.m, timings, pcg_iters=pcg_iters,
            residuals=rels, diagnostics=diag,
            warm_start=(None if backend == "sharded"
                        else warm_from is not None),
            cost=self._solve_cost(cfg, backend, warm_from is not None,
                                  diag, pcg_iters, timings),
            clamped_reweights=clamped)
        if delta_tel is not None:
            tel["delta"] = delta_tel
        if sharded_refill is not None:
            tel["sharded_refill"] = sharded_refill
        self.telemetry.add(tel)
        self._record_cost_metrics(tel)
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
        of the batch.

        ``presolve`` kernelizes every entry, groups entries whose kernels
        share a topology, batches each group and lifts the results back;
        it runs cold (incompatible with ``warm_from``).  ``delta_keys`` —
        one weight-sequence identity per entry (None opts an entry out):
        each entry stages through the per-key cache of
        ``solve(delta_key=...)``, so a drifting tenant's ELL table is
        patched instead of restaged (fused-ELL configs); under ``presolve``
        the keys drive kernel revalidation per entry instead."""
        ws = [self.problem.check_weights(w) for w in weights_batch]
        if not ws:
            # empty batch: nothing to stack, nothing to build
            return []
        cfg = cfg or self.cfg
        if delta_keys is not None and len(delta_keys) != len(ws):
            raise ValueError(f"delta_keys has {len(delta_keys)} entries for "
                             f"a batch of {len(ws)}")
        if presolve:
            if warm_from is not None:
                raise ValueError("presolve batches run cold (the kernel "
                                 "node set depends on the weights, so a "
                                 "previous voltage vector has no stable "
                                 "projection)")
            return self._solve_batch_presolve(ws, rounding, cfg,
                                              delta_keys=delta_keys)
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
        ext = (delta_keys is not None and cfg.layout == "ell"
               and cfg.fuse_edge_sweep)
        delta_infos: Optional[List[Optional[dict]]] = None
        get_registry().counter("session_solves_scanned_total").inc(n_real)
        t0 = time.perf_counter()
        with trace.span("session.solve_batch", size=n_real,
                        pad_to=pad_to or n_real, warm=warm):
            run = self._get_scanned(cfg, dtype, warm, ext)
            ws_run = ws_live + [ws_live[-1]] * pad
            C = _lanes_to([w.c for w in ws_run], dtype, self.device)
            CS = _lanes_to([prob.to_reordered(w.c_s) for w in ws_run], dtype,
                           self.device)
            CT = _lanes_to([prob.to_reordered(w.c_t) for w in ws_run], dtype,
                           self.device)
            args = [C, CS, CT]
            if ext:
                # one staged table per live lane, padded with the last one
                staged, delta_infos = [], []
                for j, i in enumerate(live):
                    k = delta_keys[i]
                    if k is None:
                        staged.append(lap.ell_edge_weights(
                            prob.ell_plan(self.device), C[j]))
                        delta_infos.append(None)
                    else:
                        ce, inf = self._stage_with_delta(ws_live[j], cfg,
                                                         "scanned", k)
                        staged.append(ce)
                        delta_infos.append(inf)
                args.append(torch.stack(staged + [staged[-1]] * pad))
                del staged
            with trace.span("session.irls", backend="scanned",
                            batch=len(ws_run)):
                if warm:
                    vs = [np.asarray(v.voltages
                                     if isinstance(v, SolveResult) else v)
                          for v in warm_from]
                    vs_run = [vs[i] for i in live] + [vs[live[-1]]] * pad
                    args.append(_lanes_to([prob.to_reordered(v)
                                           for v in vs_run],
                                          dtype, self.device))
                V, RELS, ITERS = run(*args)
                del C, CS, CT, args
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
                    warm_start=warm,
                    cost=self._solve_cost(cfg, "scanned", warm, None,
                                          ITERS[j], timings))
                if delta_infos is not None and delta_infos[j] is not None:
                    tel["delta"] = delta_infos[j]
                self.telemetry.add(tel)
                self._record_cost_metrics(tel)
                out[i] = SolveResult(
                    voltages=v, cut=cut, diagnostics=None,
                    residuals=RELS[j], timings=timings, backend="scanned",
                    pcg_iters=ITERS[j], telemetry=tel)
        return [r for r in out if r is not None]

    def telemetry_snapshot(self) -> Dict[str, object]:
        """Aggregated telemetry over every solve this session ran (PCG
        spend distribution, phase walls, early-exit/warm-start rates,
        kernel reductions and presolve kernel outcomes)."""
        snap = self.telemetry.snapshot()
        if sum(self._kernel_outcomes.values()):
            snap["kernel_outcomes"] = dict(self._kernel_outcomes)
        return snap

    def _check_connectivity(self, weights, rounding, backend):
        """Guard against instances whose reduced Laplacian is singular.

        s and t in different components → the min cut is trivially 0;
        returns that SolveResult instead of letting PCG produce NaNs.
        Components touching NEITHER terminal are singular blocks too; those
        are rejected with a pointer at ``presolve=True``, which merges them
        away exactly."""
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
                    f"PCG would return garbage voltages there.  Solve with "
                    f"presolve=True (kernelization merges terminal-free "
                    f"components away exactly) or restrict the graph")
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

    # -- presolve (kernelization) ---------------------------------------------
    def _kernel_for(self, w: Weights, delta_key: Optional[str] = None):
        """Kernelize under ``w``; returns ``(kernel, action)``.

        Three outcomes, cheapest first (counted in ``_kernel_outcomes``):

        * ``"reuse"``   — weight-content-hash LRU hit: identical weights
          were kernelized before.
        * ``"patch"``   — ``delta_key`` names a weight sequence whose last
          kernel is on file and the changed edges pass journal
          revalidation (``presolve.patch_kernel``), so the kernel's
          weights are patched through the contraction map instead of
          re-running the fixpoint.  Exact: the lift-time certificate is
          re-checked per solve as always.
        * ``"rebuild"`` — the full kernelize fixpoint.
        """
        from ..presolve import kernelize, patch_kernel

        h = hashlib.blake2b(digest_size=16)
        c64 = np.ascontiguousarray(np.asarray(w.c, dtype=np.float64))
        cs64 = np.ascontiguousarray(np.asarray(w.c_s, dtype=np.float64))
        ct64 = np.ascontiguousarray(np.asarray(w.c_t, dtype=np.float64))
        for arr in (c64, cs64, ct64):
            h.update(arr.tobytes())
        key = h.hexdigest()
        with self._cache_lock:
            kernel = self._kernels.get(key)
            if kernel is not None:
                self._kernels.move_to_end(key)
                self._kernel_outcomes["reuse"] += 1
                if delta_key is not None:
                    self._kernel_recent[delta_key] = (c64, cs64, ct64,
                                                      kernel)
                    self._kernel_recent.move_to_end(delta_key)
                return kernel, "reuse"
            recent = (self._kernel_recent.get(delta_key)
                      if delta_key is not None else None)
        # kernelize/patch outside the lock; a concurrent duplicate costs a
        # redundant kernelization, never a wrong result
        action, kernel = "rebuild", None
        if recent is not None:
            kernel = patch_kernel(recent[3], recent[:3], (c64, cs64, ct64))
            if kernel is not None:
                action = "patch"
        if kernel is None:
            kernel = kernelize(self.problem.instance, c=w.c, c_s=w.c_s,
                               c_t=w.c_t)
        with self._cache_lock:
            self._kernel_outcomes[action] += 1
            kernel = self._kernels.setdefault(key, kernel)
            self._kernels.move_to_end(key)
            while len(self._kernels) > self._kernel_max:
                self._kernels.popitem(last=False)
            if delta_key is not None:
                self._kernel_recent[delta_key] = (c64, cs64, ct64, kernel)
                self._kernel_recent.move_to_end(delta_key)
                while len(self._kernel_recent) > self._delta_max:
                    self._kernel_recent.popitem(last=False)
        return kernel, action

    def _kernel_cfg(self, cfg: IRLSConfig, kernel_n: int) -> IRLSConfig:
        """Config for the kernel solve: block Jacobi needs blocks with a
        sensible number of nodes, so tiny kernels run point Jacobi rather
        than partitioning 30 nodes 16 ways."""
        if cfg.precond == "block_jacobi" and kernel_n < 8 * cfg.n_blocks:
            return dataclasses.replace(cfg, precond="jacobi", n_blocks=1)
        return cfg

    def _kernel_session(self, kernel, cfg: IRLSConfig):
        """Session over the kernel topology on this session's device,
        cached on the kernel's fingerprint: weight vectors that reduce to
        the same kernel topology share its partition, plans and drivers."""
        kcfg = self._kernel_cfg(cfg, kernel.kernel_n)
        nb = kcfg.n_blocks if kcfg.precond == "block_jacobi" else 1
        key = (topology_fingerprint(kernel.instance), nb)
        sess = self._kernel_sessions.get(key)
        if sess is None:
            with self._lock_for(("kernel",) + key):
                sess = self._kernel_sessions.get(key)
                if sess is None:
                    sess = MinCutSession(
                        Problem.build(kernel.instance, n_blocks=nb),
                        cfg=kcfg, backend=self.backend, device=self.device,
                        schedule=self.schedule, precond_bs=self.precond_bs,
                        group=self.group, profile=self._profile)
                    self._kernel_sessions[key] = sess
        return sess, kcfg

    def _lift_result(self, kernel, kres: SolveResult, rounding,
                     t_presolve: float,
                     action: Optional[str] = None) -> SolveResult:
        """Map a kernel-space SolveResult back to the original vertex set,
        attaching the exact cut certificate."""
        v = kernel.lift_voltages(kres.voltages)
        cut = None
        if rounding is not None and kres.cut is not None:
            kside = np.asarray(kres.cut.in_source, dtype=bool)
            cert = kernel.certificate(kside)
            meta = dict(kres.cut.meta or {})
            meta["presolve"] = {
                "kernel_n": kernel.kernel_n, "kernel_m": kernel.kernel_m,
                "base": kernel.base, "stats": kernel.stats,
                "certificate": cert,
            }
            cut = RoundingResult(in_source=kernel.lift_partition(kside),
                                 cut_value=cert["lifted_cut"], meta=meta)
        timings = dict(kres.timings)
        timings["presolve"] = t_presolve
        timings["total"] = timings.get("total", 0.0) + t_presolve
        # the kernel session built the solve telemetry (n/m are the KERNEL
        # size, the instance actually solved); graft the reduction stats
        # and the presolve-inclusive phases on top
        tel = dict(kres.telemetry) if kres.telemetry else None
        if tel is not None:
            tel["presolve"] = {
                "kernel_n": kernel.kernel_n, "kernel_m": kernel.kernel_m,
                "node_reduction": kernel.node_reduction,
                "edge_reduction": kernel.edge_reduction,
                "base": kernel.base, "stats": kernel.stats,
            }
            if action is not None:
                tel["presolve"]["action"] = action
            tel["phases"] = {k: float(x) for k, x in timings.items()}
            self.telemetry.add(tel)
        return SolveResult(voltages=v, cut=cut, diagnostics=kres.diagnostics,
                           residuals=kres.residuals, timings=timings,
                           backend=kres.backend, pcg_iters=kres.pcg_iters,
                           telemetry=tel)

    def _trivial_from_kernel(self, kernel, rounding, backend,
                             t_presolve: float,
                             action: Optional[str] = None) -> SolveResult:
        """The reductions decided the whole cut (kernel_n == 0, including
        the s-t-disconnected case, where base == 0)."""
        in_source = kernel.lift_partition(None)
        cert = kernel.certificate(None)
        cut = None
        if rounding is not None:
            cut = RoundingResult(
                in_source=in_source, cut_value=cert["lifted_cut"],
                meta={"method": "presolve_trivial",
                      "presolve": {"kernel_n": 0, "base": kernel.base,
                                   "stats": kernel.stats,
                                   "certificate": cert}})
        timings = {"presolve": t_presolve, "total": t_presolve}
        tel = build_solve_telemetry(self.cfg, backend, 0, 0, timings,
                                    pcg_iters=[])
        tel["trivial"] = "presolve"
        tel["presolve"] = {
            "kernel_n": 0, "kernel_m": 0,
            "node_reduction": kernel.node_reduction,
            "edge_reduction": kernel.edge_reduction,
            "base": kernel.base, "stats": kernel.stats,
        }
        if action is not None:
            tel["presolve"]["action"] = action
        self.telemetry.add(tel)
        return SolveResult(voltages=in_source.astype(np.float64), cut=cut,
                           diagnostics=None, residuals=None,
                           timings=timings, backend=backend, pcg_iters=None,
                           telemetry=tel)

    def _solve_presolve(self, weights, warm_from, rounding, backend,
                        cfg: IRLSConfig,
                        delta_key: Optional[str] = None) -> SolveResult:
        w = (self.problem.check_weights(weights) if weights is not None
             else as_weights(self.problem.instance))
        t0 = time.perf_counter()
        with trace.span("session.presolve", n=self.problem.instance.n):
            kernel, action = self._kernel_for(w, delta_key=delta_key)
        t_pre = time.perf_counter() - t0
        if kernel.trivial:
            return self._trivial_from_kernel(kernel, rounding, backend,
                                             t_pre, action=action)
        sess, kcfg = self._kernel_session(kernel, cfg)
        v0 = None
        if warm_from is not None:
            wv = np.asarray(warm_from.voltages
                            if isinstance(warm_from, SolveResult)
                            else warm_from)
            if wv.shape[0] == kernel.n:
                # kernel node k's id IS its surviving union-find root, so
                # the projection is a gather of the original voltages
                roots = np.nonzero(kernel.kernel_of_root >= 0)[0]
                v0 = wv[roots]
        kres = sess.solve(weights=as_weights(kernel.instance),
                          warm_from=v0, rounding=rounding, backend=backend,
                          cfg=kcfg, delta_key=delta_key)
        return self._lift_result(kernel, kres, rounding, t_pre,
                                 action=action)

    def _solve_batch_presolve(self, ws: List[Weights], rounding,
                              cfg: IRLSConfig,
                              delta_keys: Optional[Sequence] = None,
                              ) -> List[SolveResult]:
        out: List[Optional[SolveResult]] = [None] * len(ws)
        groups: Dict[tuple, List[tuple]] = {}
        for i, w in enumerate(ws):
            dk = delta_keys[i] if delta_keys is not None else None
            t0 = time.perf_counter()
            with trace.span("session.presolve", n=self.problem.instance.n):
                kernel, action = self._kernel_for(w, delta_key=dk)
            t_pre = time.perf_counter() - t0
            if kernel.trivial:
                out[i] = self._trivial_from_kernel(kernel, rounding,
                                                   "scanned", t_pre,
                                                   action=action)
            else:
                key = (topology_fingerprint(kernel.instance),)
                groups.setdefault(key, []).append((i, kernel, t_pre, action))
        for items in groups.values():
            sess, kcfg = self._kernel_session(items[0][1], cfg)
            kress = sess.solve_batch(
                [as_weights(k.instance) for _, k, _, _ in items],
                rounding=rounding, cfg=kcfg)
            for (i, kernel, t_pre, action), kres in zip(items, kress):
                out[i] = self._lift_result(kernel, kres, rounding, t_pre,
                                           action=action)
        return [r for r in out if r is not None]

    # -- continuous profiling (obs.perf.profile) ---------------------------------
    def _profiling(self) -> bool:
        return (self._profile if self._profile is not None
                else perf_profile.default_enabled())

    def program_costs(self) -> Dict[str, dict]:
        """Per driver of every profiled solve (keyed ``"<backend>"``-style
        like the driver cache: ``host``, ``scanned/<warm>``,
        ``sharded/<schedule>``), the solve's shape and the per-unit work of
        ``obs.perf.profile.terms`` (JSON-ready)."""
        return {"/".join(str(p) for p in key[1:]): cost
                for key, cost in self._program_costs.items()}

    def _shape_for(self, cfg: IRLSConfig, backend: str):
        """The ``SolveShape`` of this session's solves under ``cfg`` on
        ``backend`` (its plans are built by then; a sharded solve counts
        this rank's shard)."""
        if backend == "sharded":
            return self._steppers[(cfg, "sharded", self.schedule)].work_shape()
        prob = self.problem
        block_plan, ell_plan = self._plans_for(cfg)
        precond = cfg.precond
        if backend == "scanned" and (precond == "none" or block_plan is None
                                     and precond == "block_jacobi"):
            precond = "jacobi"     # the scanned schedules' least scaling
        return perf_profile.solve_shape(
            cfg, prob.instance.n, prob.instance.graph.m,
            ell_k=ell_plan.k if ell_plan is not None else 0,
            blocks=block_plan.p if block_plan is not None else 0,
            bs=block_plan.bs if block_plan is not None else 0,
            precond=precond)

    def _solve_cost(self, cfg: IRLSConfig, backend: str, warm: bool, diag,
                    pcg_iters, timings) -> Optional[dict]:
        """Per-solve cost record for telemetry (None when not profiled):
        the work counted from the solve's shape and its PCG trace.

        Host: per IRLS iteration (``diag.pcg_iters``, the cold system
        first).  Scanned: the lane's trace (``pcg_iters``) after the cold
        initial solve, which the program does not report: counted at
        ``pcg_max_iters`` steps on the fixed schedule and at none on the
        adaptive one (a lower bound).  Sharded: every CG step of the
        collective census, and the census's bytes."""
        if not self._profiling():
            return None
        key = ((cfg, backend) if backend == "host"
               else (cfg, backend, self.schedule) if backend == "sharded"
               else (cfg, backend, warm))
        cost = self._program_costs.get(key)
        if cost is None:
            shape = self._shape_for(cfg, backend)
            cost = self._program_costs[key] = {
                "shape": shape._asdict(),
                "terms": {name: w._asdict() for name, w
                          in perf_profile.terms(shape).items()}}
        shape = perf_profile.SolveShape(**cost["shape"])
        collective = 0.0
        if backend == "host":
            iters = list(diag.pcg_iters)
            systems, steps, calls = len(iters), sum(iters), len(iters)
        elif backend == "scanned":
            iters = np.asarray(pcg_iters)
            initial = (0 if warm or is_adaptive(cfg)
                       else cfg.pcg_max_iters)
            systems, steps, calls = len(iters) + (not warm), \
                int(iters.sum()) + initial, 1
        else:
            census = self._steppers[key].collective_stats()
            systems, steps, calls = len(pcg_iters) + 1, \
                census["pcg_steps"], 1
            collective = float(sum(v["bytes"]
                                   for ops in census["scopes"].values()
                                   for v in ops.values()))
        work = perf_profile.solve_work(shape, systems, steps, cold=not warm)
        per_call = {"flops": work["flops"] / calls,
                    "hbm_bytes": work["hbm_bytes"] / calls,
                    "collective_bytes": collective / calls}
        return perf_profile.per_solve_cost(per_call, timings.get("irls", 0.0),
                                           calls)

    def _record_cost_metrics(self, tel) -> None:
        if not tel or not tel.get("flops"):
            return
        reg = get_registry()
        reg.counter("session_flops_total").inc(int(tel["flops"]))
        if tel.get("achieved_gflops") is not None:
            reg.gauge("session_achieved_gflops").set(tel["achieved_gflops"])

    # -- drivers ----------------------------------------------------------------
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

    def _lock_for(self, key: tuple) -> threading.Lock:
        with self._cache_lock:
            return self._compile_locks.setdefault(key, threading.Lock())

    def _cached(self, key: tuple, build):
        """The cached driver under ``key``, built once: concurrent callers
        of a cold key wait for the one build (a lock per key)."""
        got = self._steppers.get(key)
        if got is None:
            with self._lock_for(key):
                got = self._steppers.get(key)
                if got is None:
                    got = build()
                    self._steppers[key] = got
        return got

    def _stage_with_delta(self, w: Weights, cfg: IRLSConfig, backend: str,
                          delta_key: str):
        """Delta-aware edge-weight staging for a keyed weight SEQUENCE.

        Remembers the previous ``Weights`` under ``delta_key`` and diffs the
        new vector against them.  On the fused-ELL path the staged (n, k)
        ELL weight table is carried forward too: a sparse diff rewrites
        only the changed edges' two slots (``lap.ell_edge_weights_delta``)
        instead of restaging all m, bit-equal to a full restage because
        both round the same float64 inputs to the compute dtype once.

        Returns ``(c_ell, info)``: the staged table on this session's
        device (None off the fused-ELL path) and a telemetry record whose
        ``"mode"`` is ``"cold"`` (no previous entry), ``"delta"`` (sparse
        diff applied) or ``"full"`` (diff denser than ``DELTA_MAX_FRAC``
        or dtype changed: full restage, cache refreshed)."""
        m = int(np.asarray(w.c).shape[0])
        c64 = np.array(w.c, dtype=np.float64)
        dtype = torch_dtype(cfg)
        fused_ell = (backend in ("host", "scanned") and cfg.layout == "ell"
                     and cfg.fuse_edge_sweep)
        with self._cache_lock:
            entry = self._delta.get(delta_key)
        info = {"key": delta_key, "mode": "cold", "changed_edges": None,
                "edges": m}
        changed = None
        if entry is not None:
            diff = np.flatnonzero(entry["c"] != c64)
            info["changed_edges"] = int(diff.size)
            if diff.size <= DELTA_MAX_FRAC * max(1, m):
                changed = diff
            info["mode"] = "delta" if changed is not None else "full"
        c_ell = None
        if fused_ell:
            if (changed is not None and entry.get("c_ell") is not None
                    and entry.get("dtype") == str(dtype)):
                c_ell = lap.ell_edge_weights_delta(
                    self.problem.ell_delta_map(self.device), entry["c_ell"],
                    c64, changed)
            else:
                # cold (or unusable) entry: stage everything once, so the
                # next solve under this key can go sparse
                if entry is not None:
                    info["mode"] = "full"
                c_ell = lap.ell_edge_weights(
                    self.problem.ell_plan(self.device),
                    torch.as_tensor(c64).to(dtype).to(self.device))
        with self._cache_lock:
            self._delta[delta_key] = {"c": c64, "c_ell": c_ell,
                                      "dtype": str(dtype)}
            self._delta.move_to_end(delta_key)
            while len(self._delta) > self._delta_max:
                self._delta.popitem(last=False)
        return c_ell, info

    def _solve_host(self, cfg, weights, warm_from, collect_voltages, timings,
                    c_ell=None):
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
                                weights=dev_w, c_ell=c_ell)
        diag.setup_time = timings["setup"]
        return prob.to_original(v.cpu().numpy()), diag

    def _get_scanned(self, cfg, dtype, warm: bool, ext: bool = False):
        """The scanned program of ``cfg``, cached on (cfg, warm, ext).  One
        program serves a single solve (a batch of one) and a batch alike;
        ``ext`` takes the ELL weight table staged by the caller."""
        def build():
            block_plan, ell_plan = self._plans_for(cfg)
            g0 = self.problem.device_graph(dtype, device=self.device)
            return make_scanned_program(g0.src, g0.dst, cfg, block_plan,
                                        ell_plan, warm=warm, ext_stage=ext,
                                        coo=g0.coo)

        return self._cached((cfg, "scanned", warm, ext), build)

    def _solve_scanned(self, cfg, weights, timings, warm_from=None,
                       c_ell=None):
        prob = self.problem
        dtype = torch_dtype(cfg)
        warm = warm_from is not None
        ext = c_ell is not None
        t = time.perf_counter()
        have = (cfg, "scanned", warm, ext) in self._steppers
        run = self._get_scanned(cfg, dtype, warm, ext)
        timings["setup"] = 0.0 if have else time.perf_counter() - t
        # a batch of one lane: the arithmetic of every lane of solve_batch,
        # so a solo solve and the same weights co-batched agree
        g = prob.device_graph(dtype, weights, device=self.device)
        args = [g.c[None], g.c_s[None], g.c_t[None]]
        if ext:
            args.append(c_ell[None])
        if warm:
            wv = np.asarray(warm_from.voltages
                            if isinstance(warm_from, SolveResult)
                            else warm_from)
            args.append(_lanes_to([prob.to_reordered(wv)], dtype, self.device))
        v, rels, iters = run(*args)
        return (prob.to_original(v[0].cpu().numpy()), rels[0].cpu().numpy(),
                iters[0].cpu().numpy())

    def _solve_sharded(self, cfg, weights, timings):
        from ..distributed.solver import ShardedSolver

        prob = self.problem
        key = (cfg, "sharded", self.schedule)
        # one lock covers build + update_weights + solve: the solver's plan
        # weight arrays are mutable state shared by every caller of this
        # (cfg, schedule) solver, so an interleaved update/solve pair from
        # two serving workers would solve under the wrong weights
        with self._lock_for(key):
            solver = self._steppers.get(key)
            t = time.perf_counter()
            if solver is None:
                labels = prob.labels if prob.n_blocks > 1 else None
                solver = ShardedSolver(prob.instance_with(weights), cfg,
                                       group=self.group,
                                       schedule=self.schedule,
                                       labels=labels,
                                       precond_bs=self.precond_bs,
                                       device=self.device)
                self._steppers[key] = solver
                self._sharded_weights[key] = weights is not None
                timings["setup"] = time.perf_counter() - t
            elif weights is not None or self._sharded_weights.get(key):
                # same solver, refreshed plan weight arrays.  Refill
                # whenever an override is in play (never trust object
                # identity — callers may mutate weight arrays in place) and
                # once more when dropping back to the Problem's own weights
                solver.update_weights(prob.instance_with(weights))
                self._sharded_weights[key] = weights is not None
                timings["setup"] = time.perf_counter() - t
            else:
                timings["setup"] = 0.0
            v, rels, iters = solver.solve()
        return np.asarray(v), np.asarray(rels), np.asarray(iters)
