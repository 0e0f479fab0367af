"""Exact combinatorial s-t max-flow / min-cut (host-side oracle).

The paper rounds on a coarsened graph with the Boykov–Kolmogorov solver and
benchmarks against it as the exact serial baseline (Table 3).  We provide a
self-contained Dinic implementation with floating-point capacities:

* level-graph BFS + iterative blocking-flow DFS with current-arc pointers,
* undirected non-terminal edges stored as an antiparallel arc pair with
  capacity c each (the standard undirected reduction — each arc doubles as
  the other's residual),
* min-cut side extraction by residual BFS from s.

This is deliberately host/numpy code: in the paper too, the exact solve is
the sequential root-process step of the two-level rounding (§3.4, Table 2),
and its input is the SMALL coarsened graph.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

_EPS = 1e-12


class MaxFlowResult(NamedTuple):
    value: float
    in_source: np.ndarray  # bool[n_total]: True = source side (includes s)


class _ArcGraph:
    """CSR-ish arc storage: arcs come in (i, i^1) residual pairs."""

    __slots__ = ("n", "to", "cap", "head", "nxt", "n_arcs")

    def __init__(self, n: int, est_arcs: int):
        self.n = n
        self.to = np.empty(est_arcs, dtype=np.int64)
        self.cap = np.empty(est_arcs, dtype=np.float64)
        self.head = np.full(n, -1, dtype=np.int64)
        self.nxt = np.empty(est_arcs, dtype=np.int64)
        self.n_arcs = 0

    def add_pair(self, u: int, v: int, cap_uv: float, cap_vu: float):
        i = self.n_arcs
        self.to[i] = v
        self.cap[i] = cap_uv
        self.nxt[i] = self.head[u]
        self.head[u] = i
        self.to[i + 1] = u
        self.cap[i + 1] = cap_vu
        self.nxt[i + 1] = self.head[v]
        self.head[v] = i + 1
        self.n_arcs = i + 2

    def add_pairs_bulk(self, us, vs, caps_uv, caps_vu):
        """Vectorized bulk arc-pair insertion."""
        k = len(us)
        if k == 0:
            return
        i0 = self.n_arcs
        fwd = i0 + 2 * np.arange(k)
        bwd = fwd + 1
        self.to[fwd] = vs
        self.to[bwd] = us
        self.cap[fwd] = caps_uv
        self.cap[bwd] = caps_vu
        # linked-list threading must be sequential per node; do it with a
        # grouped pass: process arcs in order, standard head/next splice
        for j in range(k):
            u, v = us[j], vs[j]
            f, b = fwd[j], bwd[j]
            self.nxt[f] = self.head[u]
            self.head[u] = f
            self.nxt[b] = self.head[v]
            self.head[v] = b
        self.n_arcs = i0 + 2 * k


def _build(instance) -> Tuple[_ArcGraph, int, int]:
    g = instance.graph
    n = g.n
    s, t = n, n + 1
    su = np.nonzero(np.asarray(instance.s_weight) > 0)[0]
    tu = np.nonzero(np.asarray(instance.t_weight) > 0)[0]
    m_total = g.m + len(su) + len(tu)
    ag = _ArcGraph(n + 2, 2 * m_total)
    ag.add_pairs_bulk(np.asarray(g.src, dtype=np.int64),
                      np.asarray(g.dst, dtype=np.int64),
                      np.asarray(g.weight, dtype=np.float64),
                      np.asarray(g.weight, dtype=np.float64))
    ag.add_pairs_bulk(np.full(len(su), s, dtype=np.int64), su.astype(np.int64),
                      np.asarray(instance.s_weight)[su].astype(np.float64),
                      np.zeros(len(su)))
    ag.add_pairs_bulk(tu.astype(np.int64), np.full(len(tu), t, dtype=np.int64),
                      np.asarray(instance.t_weight)[tu].astype(np.float64),
                      np.zeros(len(tu)))
    return ag, s, t


def _bfs_levels(ag: _ArcGraph, s: int, t: int) -> np.ndarray:
    level = np.full(ag.n, -1, dtype=np.int64)
    level[s] = 0
    frontier = [s]
    while frontier:
        nxt_frontier = []
        for u in frontier:
            a = ag.head[u]
            while a != -1:
                v = ag.to[a]
                if ag.cap[a] > _EPS and level[v] < 0:
                    level[v] = level[u] + 1
                    nxt_frontier.append(v)
                a = ag.nxt[a]
        if level[t] >= 0:
            # can stop exploring deeper than t's level
            pass
        frontier = nxt_frontier
    return level


def _blocking_flow(ag: _ArcGraph, s: int, t: int, level: np.ndarray) -> float:
    """Iterative DFS blocking flow with current-arc (it) pointers."""
    it = ag.head.copy()
    total = 0.0
    INF = float("inf")
    # stack holds (node, arc-used-to-enter) path
    while True:
        # find one augmenting path via DFS
        path_arcs = []
        u = s
        while True:
            if u == t:
                # augment along path_arcs
                push = INF
                for a in path_arcs:
                    push = min(push, ag.cap[a])
                for a in path_arcs:
                    ag.cap[a] -= push
                    ag.cap[a ^ 1] += push
                total += push
                # retreat to the first saturated arc
                cut_idx = 0
                for idx, a in enumerate(path_arcs):
                    if ag.cap[a] <= _EPS:
                        cut_idx = idx
                        break
                path_arcs = path_arcs[:cut_idx]
                u = ag.to[path_arcs[-1]] if path_arcs else s
                continue
            a = it[u]
            advanced = False
            while a != -1:
                v = ag.to[a]
                if ag.cap[a] > _EPS and level[v] == level[u] + 1:
                    it[u] = a
                    path_arcs.append(a)
                    u = v
                    advanced = True
                    break
                a = ag.nxt[a]
            if not advanced:
                it[u] = -1
                level[u] = -2  # dead-end: prune from this phase
                if not path_arcs:
                    return total
                a_back = path_arcs.pop()
                u = ag.to[a_back ^ 1]
                it[u] = ag.nxt[it[u]] if it[u] != -1 else -1
    return total


def max_flow(instance) -> MaxFlowResult:
    """Exact max-flow value and min-cut side for an STInstance."""
    ag, s, t = _build(instance)
    total = 0.0
    while True:
        level = _bfs_levels(ag, s, t)
        if level[t] < 0:
            break
        pushed = _blocking_flow(ag, s, t, level)
        if pushed <= _EPS:
            break
        total += pushed
    # residual BFS from s → source side
    seen = np.zeros(ag.n, dtype=bool)
    seen[s] = True
    frontier = [s]
    while frontier:
        nf = []
        for u in frontier:
            a = ag.head[u]
            while a != -1:
                v = ag.to[a]
                if ag.cap[a] > _EPS and not seen[v]:
                    seen[v] = True
                    nf.append(v)
                a = ag.nxt[a]
        frontier = nf
    return MaxFlowResult(value=total, in_source=seen)


def min_cut_value(instance) -> float:
    return max_flow(instance).value


def min_cut_indicator(instance) -> np.ndarray:
    """bool[n] over non-terminal nodes: True = source side."""
    res = max_flow(instance)
    return res.in_source[: instance.n]
