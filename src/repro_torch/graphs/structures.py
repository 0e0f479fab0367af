"""Graph containers used across the port (numpy, host side).

* ``EdgeList`` — canonical undirected edge list (each edge stored once with an
  arbitrary orientation ``src -> dst``); the layout the IRLS solver consumes.
* ``CSR`` — host-side compressed sparse rows, used by the partitioner.
* ``STInstance`` — an s-t min-cut instance: non-terminal graph + terminal
  edge weights (the paper's §3.3 decomposition).

These are the port's own copies of the same containers in the JAX package;
``instance_from_arrays`` builds an ``STInstance`` from plain arrays, which is
how an instance made elsewhere (any object with the same fields) is carried
into the port.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np


class EdgeList(NamedTuple):
    """Undirected weighted graph as an oriented edge list.

    src, dst : int32[m]   endpoints (arbitrary but fixed orientation)
    weight   : float[m]   positive edge weights c({u,v})
    n        : int        number of nodes (static python int)
    """

    src: np.ndarray
    dst: np.ndarray
    weight: np.ndarray
    n: int

    @property
    def m(self) -> int:
        return int(self.src.shape[0])

    def degrees(self) -> np.ndarray:
        d = np.zeros(self.n, dtype=np.int64)
        np.add.at(d, np.asarray(self.src), 1)
        np.add.at(d, np.asarray(self.dst), 1)
        return d

    def weighted_degrees(self) -> np.ndarray:
        d = np.zeros(self.n, dtype=np.float64)
        np.add.at(d, np.asarray(self.src), np.asarray(self.weight, dtype=np.float64))
        np.add.at(d, np.asarray(self.dst), np.asarray(self.weight, dtype=np.float64))
        return d

    def total_weight(self) -> float:
        return float(np.sum(self.weight))

    def validate(self) -> "EdgeList":
        src = np.asarray(self.src)
        dst = np.asarray(self.dst)
        w = np.asarray(self.weight)
        if not (src.shape == dst.shape == w.shape and src.ndim == 1):
            raise ValueError("src, dst and weight must be 1-D of one length")
        if not np.all(w > 0):
            raise ValueError("edge weights must be positive")
        if not np.all(src != dst):
            raise ValueError("self loops are not allowed")
        if (min(src.min(initial=0), dst.min(initial=0)) < 0
                or max(src.max(initial=-1), dst.max(initial=-1)) >= self.n):
            raise ValueError("edge endpoint out of range")
        return self

    def permute_nodes(self, perm: np.ndarray) -> "EdgeList":
        """Relabel nodes: new_id = perm[old_id]."""
        perm = np.asarray(perm)
        return EdgeList(
            src=perm[np.asarray(self.src)].astype(np.int32),
            dst=perm[np.asarray(self.dst)].astype(np.int32),
            weight=np.asarray(self.weight),
            n=self.n,
        )


@dataclasses.dataclass(frozen=True)
class CSR:
    """Host-side symmetric adjacency in CSR form (both directions stored)."""

    indptr: np.ndarray  # int64[n+1]
    indices: np.ndarray  # int32[2m]
    data: np.ndarray  # float[2m]
    n: int

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    def neighbors(self, u: int) -> Tuple[np.ndarray, np.ndarray]:
        lo, hi = self.indptr[u], self.indptr[u + 1]
        return self.indices[lo:hi], self.data[lo:hi]

    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)


def canonicalize_edges(src, dst, weight, n: int, merge: str = "sum",
                       return_map: bool = False):
    """Orient each edge ``lo < hi``, drop self-loops, sort by ``(lo, hi)``
    and collapse parallel edges.

    ``merge`` decides how parallel edge weights combine: ``"sum"``
    (capacities in parallel add), ``"min"`` (series-path semantics) or
    ``"first"`` (keep the first occurrence's weight — the generators'
    dedup).  Returns ``(src, dst, weight)`` as ``int64/int64/float64``
    arrays, plus, when ``return_map``, an ``int64[m_in]`` map from each
    input edge to its output slot (``-1`` for dropped self-loops).
    """
    if merge not in ("sum", "min", "first"):
        raise ValueError(f"unknown merge {merge!r}; known: sum, min, first")
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    w = np.asarray(weight, dtype=np.float64)
    lo = np.minimum(src, dst)
    hi = np.maximum(src, dst)
    keep = lo != hi
    emap = np.full(src.shape[0], -1, dtype=np.int64)
    key = lo[keep] * np.int64(n) + hi[keep]
    uniq, inv = np.unique(key, return_inverse=True)
    k = uniq.shape[0]
    if merge == "sum":
        wout = np.zeros(k, dtype=np.float64)
        np.add.at(wout, inv, w[keep])
    elif merge == "min":
        wout = np.full(k, np.inf, dtype=np.float64)
        np.minimum.at(wout, inv, w[keep])
    else:  # first occurrence (in input order) wins
        first_seen = np.full(k, src.shape[0], dtype=np.int64)
        np.minimum.at(first_seen, inv, np.nonzero(keep)[0])
        wout = w[first_seen]
    emap[keep] = inv
    out = (uniq // n, uniq % n, wout)
    return out + (emap,) if return_map else out


def edgelist_to_csr(g: EdgeList) -> CSR:
    src = np.asarray(g.src, dtype=np.int64)
    dst = np.asarray(g.dst, dtype=np.int64)
    w = np.asarray(g.weight, dtype=np.float64)
    rows = np.concatenate([src, dst])
    cols = np.concatenate([dst, src])
    vals = np.concatenate([w, w])
    order = np.argsort(rows, kind="stable")
    rows, cols, vals = rows[order], cols[order], vals[order]
    indptr = np.zeros(g.n + 1, dtype=np.int64)
    np.add.at(indptr, rows + 1, 1)
    indptr = np.cumsum(indptr)
    return CSR(indptr=indptr, indices=cols.astype(np.int32), data=vals, n=g.n)


class STInstance(NamedTuple):
    """An s-t min-cut instance: non-terminal graph + terminal edges.

    ``graph`` is the non-terminal graph over nodes 0..n-1; ``s_weight[u]`` /
    ``t_weight[u]`` are the terminal edge weights c({s,u}) / c({t,u}) (0
    when absent).  The full graph has n+2 nodes with s = n, t = n+1.
    """

    graph: EdgeList
    s_weight: np.ndarray  # float[n]
    t_weight: np.ndarray  # float[n]

    @property
    def n(self) -> int:
        return self.graph.n

    @property
    def s(self) -> int:
        return self.graph.n

    @property
    def t(self) -> int:
        return self.graph.n + 1

    def cut_value(self, in_source: np.ndarray) -> float:
        """cut(S, S̄) for a boolean indicator over non-terminal nodes
        (True = source side).  Includes terminal edges; float64 on host."""
        ind = np.asarray(in_source, dtype=bool)
        s_, d_ = np.asarray(self.graph.src), np.asarray(self.graph.dst)
        w = np.asarray(self.graph.weight, dtype=np.float64)
        crossing = ind[s_] != ind[d_]
        val = float(np.sum(w[crossing]))
        # s->u is cut when u is on the sink side; u->t when u is on the source side
        val += float(np.sum(np.asarray(self.s_weight, dtype=np.float64)[~ind]))
        val += float(np.sum(np.asarray(self.t_weight, dtype=np.float64)[ind]))
        return val


def permute_instance(inst: STInstance, perm: np.ndarray) -> STInstance:
    """Relabel non-terminal nodes of an instance: new_id = perm[old_id]."""
    perm = np.asarray(perm)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0])
    return STInstance(
        graph=inst.graph.permute_nodes(perm),
        s_weight=np.asarray(inst.s_weight)[inv],
        t_weight=np.asarray(inst.t_weight)[inv],
    )


def instance_from_arrays(src, dst, weight, n: int, s_weight,
                         t_weight) -> STInstance:
    """Build an ``STInstance`` from plain arrays (copies, original dtypes).

    This is how an instance generated elsewhere enters the port: pass its
    edge arrays, node count and terminal weights.  The arrays are copied,
    so the port never aliases a caller's buffers."""
    return STInstance(
        graph=EdgeList(src=np.array(src), dst=np.array(dst),
                       weight=np.array(weight), n=int(n)),
        s_weight=np.array(s_weight), t_weight=np.array(t_weight))
