"""``CutTreeService`` — all-pairs min-cut queries served from cached trees.

The pair-solve cost of a topology is paid ONCE: the service builds a
Gusfield cut tree (n−1 batched IRLS solves through the shared
``SessionCache`` machinery, optionally exact-refined) the first time a
topology is queried, then answers every ``min_cut(u, v)`` /
``global_min_cut()`` / ``partition(u, v)`` from the finished tree — pure
array walks, microseconds, no solver in the loop.  Trees live in their own
LRU keyed on the same topology content hash as the sessions; evicting a
tree drops ~n²/8 bytes of stored cut sides while the registered instance
stays, so an evicted topology rebuilds (at build cost) on its next query.

    svc = CutTreeService(capacity=8, solver="irls", refine=True,
                         device="cuda")
    key = svc.register(instance)
    svc.min_cut(key, u, v)          # ~µs after the first call built the tree
    svc.global_min_cut(key)         # (value, certified side)
    svc.update_weights(key, c_new)  # drift: repair the cached tree in
                                    # place, else invalidate for rebuild
    svc.stats()                     # build/query counters + latency p50/p99

Thread-safety matches the rest of ``repro_torch.serve``: callers may query from
multiple threads; builds are serialized under the service lock.

The JAX package's ``repro.serve.cuttree`` over the port's session cache:
the service hands its ``device`` to the cache, which builds every session
there (the IRLS pair solves run on it).
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..core.irls import IRLSConfig
from ..core.session import MinCutSession, Problem
from ..cuttree import CutTree, build_cut_tree, repair_cut_tree
from ..cuttree.gusfield import DEFAULT_CFG
from ..graphs.structures import EdgeList, STInstance

from .cache import CacheStats, SessionCache
from .metrics import percentile


class CutTreeService:
    """Build-once, query-forever all-pairs min-cut front-end.

    cfg       — IRLS config for tree builds (default: the adaptive
                early-exit schedule, ``cuttree.DEFAULT_CFG``)
    capacity  — LRU capacity for BOTH the session cache and the tree cache
    solver    — "irls" (batched, approximate, optionally refined) or
                "exact" (Dinic per pair)
    refine    — exact certify/refine pass after IRLS builds
    device    — where the sessions of IRLS builds solve ("cuda", or "cpu"
                for the kernels' plain versions)
    """

    def __init__(self, cfg: Optional[IRLSConfig] = None, capacity: int = 8,
                 solver: str = "irls", refine: bool = True,
                 rounding: str = "sweep", max_batch: int = 64,
                 store_sides: bool = True, seed: int = 0,
                 device="cuda"):
        if solver not in ("irls", "exact"):
            raise ValueError(f"unknown solver {solver!r}; known: irls, exact")
        self.cfg = cfg or DEFAULT_CFG
        self.solver = solver
        self.refine = bool(refine)
        self.rounding = rounding
        self.max_batch = int(max_batch)
        self.store_sides = bool(store_sides)
        self.seed = seed
        self.device = torch.device(device)
        self.sessions = SessionCache(capacity, self._build_session,
                                     self.device)
        self._trees: "OrderedDict[str, CutTree]" = OrderedDict()
        self._capacity = int(capacity)
        self.tree_stats = CacheStats()
        self._ever_built: set = set()
        self._lock = threading.RLock()
        # sliding window: queries are ~µs and unbounded in count, so keep
        # percentiles over the most recent window instead of growing forever
        self._query_s: "deque[float]" = deque(maxlen=4096)
        self._queries = 0
        self._pair_solves = 0
        self._build_s_total = 0.0
        # weight-drift accounting: update_weights() repairs cached trees
        # when the reuse proofs go through, else invalidates them
        self._weight_updates = 0
        self._repairs = 0
        self._invalidations = 0
        self._repair_reused = 0
        self._repair_solved = 0

    # -- topology lifecycle ----------------------------------------------------
    def register(self, instance: STInstance) -> str:
        """Register a topology; returns its content-hash key."""
        return self.sessions.register(instance)

    def _build_session(self, instance: STInstance,
                       device: torch.device) -> MinCutSession:
        prob = Problem.build(instance, n_blocks=1, seed=self.seed)
        return MinCutSession(prob, self.cfg, backend="scanned",
                             device=device)

    def _resolve(self, topo: Union[str, STInstance]) -> str:
        if isinstance(topo, str):
            if not self.sessions.known(topo):
                raise KeyError(f"unknown topology key {topo!r}; register() "
                               f"its instance first")
            return topo
        return self.register(topo)

    def tree(self, topo: Union[str, STInstance]) -> CutTree:
        """The topology's cut tree, building (and caching) it on first use."""
        key = self._resolve(topo)
        with self._lock:
            t = self._trees.get(key)
            if t is not None:
                self.tree_stats.hits += 1
                self._trees.move_to_end(key)
                return t
            self.tree_stats.misses += 1
            if key in self._ever_built:
                self.tree_stats.rebuilds += 1
        # build OUTSIDE the lock — n−1 pair solves take seconds, and a
        # build for one topology must not block cache-hit queries for
        # others (same rule as SessionCache.get).  Two threads racing the
        # same cold key both build; the last insert wins — wasted work,
        # never a wrong answer.
        t0 = time.perf_counter()
        if self.solver == "irls":
            sess = self.sessions.get(key)
            t = build_cut_tree(sess.problem, session=sess, cfg=self.cfg,
                               solver="irls", rounding=self.rounding,
                               max_batch=self.max_batch,
                               refine=self.refine,
                               store_sides=self.store_sides)
        else:
            t = build_cut_tree(self.sessions.instance(key), solver="exact",
                               store_sides=self.store_sides)
        dt = time.perf_counter() - t0
        with self._lock:
            self._build_s_total += dt
            self._pair_solves += t.meta["n_solves"]
            self._trees[key] = t
            self._ever_built.add(key)
            while len(self._trees) > self._capacity:
                self._trees.popitem(last=False)
                self.tree_stats.evictions += 1
            return t

    def update_weights(self, topo: Union[str, STInstance],
                       weights) -> str:
        """New edge weights for a registered topology (same edges/nodes).

        Returns what happened to the cached tree:

        * ``"repaired"``    — the cached tree was repaired in place
          (``repair_cut_tree``: reuse-proven edges keep their stored cuts,
          the rest re-solve exactly), so queries stay warm
        * ``"invalidated"`` — no cached tree, or it could not be repaired
          (no stored sides / order, or approximate values) — the next
          query rebuilds at full cost from the new weights
        * ``"unchanged"``   — the weights are bit-identical to the stored
          ones; nothing to do

        Either way the registered instance (and its cached session) is
        switched to the new weights, so later builds see them too.
        """
        key = self._resolve(topo)
        inst = self.sessions.instance(key)
        c_old = np.asarray(inst.graph.weight, dtype=np.float64)
        c_new = np.asarray(weights, dtype=np.float64)
        if c_new.shape != c_old.shape:
            raise ValueError(f"weights have shape {c_new.shape}, topology "
                             f"has {c_old.shape[0]} edges")
        if np.array_equal(c_old, c_new):
            return "unchanged"
        inst_new = STInstance(
            graph=EdgeList(src=inst.graph.src, dst=inst.graph.dst,
                           weight=c_new, n=inst.n),
            s_weight=inst.s_weight, t_weight=inst.t_weight)
        with self._lock:
            self._weight_updates += 1
            t = self._trees.get(key)
        repaired: Optional[CutTree] = None
        if t is not None:
            try:
                # exact re-solves regardless of the build solver: there are
                # few of them (that's the point of repair) and they keep the
                # tree's values exact, so the NEXT drift can repair again
                repaired = repair_cut_tree(inst_new, t, c_old, c_new,
                                           solver="exact")
            except ValueError:
                repaired = None
        self.sessions.update_instance(key, inst_new)
        with self._lock:
            if repaired is not None:
                self._trees[key] = repaired
                self._trees.move_to_end(key)
                self._repairs += 1
                self._repair_reused += int(repaired.meta["n_reused"])
                self._repair_solved += int(repaired.meta["n_solves"])
                self._pair_solves += int(repaired.meta["n_solves"])
                self._build_s_total += float(repaired.meta["t_repair_s"])
                return "repaired"
            self._trees.pop(key, None)
            self._invalidations += 1
            return "invalidated"

    # -- queries ---------------------------------------------------------------
    def _timed(self, fn, *args):
        t = self.tree(args[0])
        t0 = time.perf_counter()
        out = fn(t, *args[1:])
        dt = time.perf_counter() - t0
        with self._lock:
            self._queries += 1
            self._query_s.append(dt)
        return out

    def min_cut(self, topo: Union[str, STInstance], u: int, v: int) -> float:
        """All-pairs min-cut value between u and v, from the cached tree."""
        return self._timed(lambda t, uu, vv: t.min_cut(uu, vv), topo, u, v)

    def min_cut_batch(self, topo: Union[str, STInstance],
                      pairs) -> np.ndarray:
        return self._timed(lambda t, ps: t.min_cut_batch(ps), topo, pairs)

    def partition(self, topo: Union[str, STInstance], u: int,
                  v: int) -> Tuple[np.ndarray, bool]:
        """(side, certified) bipartition separating u from v (u's side
        True); see ``CutTree.partition``."""
        return self._timed(lambda t, uu, vv: t.partition(uu, vv), topo, u, v)

    def global_min_cut(self, topo: Union[str, STInstance]
                       ) -> Tuple[float, np.ndarray]:
        return self._timed(lambda t: t.global_min_cut(), topo)

    # -- introspection ---------------------------------------------------------
    def stats(self) -> Dict[str, object]:
        with self._lock:
            samples = list(self._query_s)
            out: Dict[str, object] = {
                "trees_cached": len(self._trees),
                "tree_cache": self.tree_stats.snapshot(),
                "sessions": self.sessions.stats.snapshot(),
                "queries": self._queries,
                "pair_solves": self._pair_solves,
                "build_s_total": self._build_s_total,
                "weight_updates": self._weight_updates,
                "repairs": self._repairs,
                "invalidations": self._invalidations,
                "repair_reused": self._repair_reused,
                "repair_solved": self._repair_solved,
            }
        for p in (50, 99):
            out[f"query_p{p}_us"] = percentile(samples, p) * 1e6
        return out
