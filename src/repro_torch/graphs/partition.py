"""METIS-lite: multilevel k-way graph partitioning on the host (numpy).

The paper (§3.2) partitions the non-terminal graph once with ParMETIS,
reorders nodes so each component is contiguous, and extracts the block-Jacobi
preconditioner as the block diagonal of P L̃ Pᵀ.  We reproduce the same
pipeline with a self-contained multilevel partitioner:

  1. *coarsen* by heavy-edge matching until the graph is small,
  2. *initial partition* by greedy BFS region growing (balanced volumes),
  3. *uncoarsen + refine* with boundary greedy moves (KL/FM-style gains).

Quality target is the paper's: balanced blocks and a small weighted edge cut
(objective (i)/(ii) in §3.2).  This is setup-time host work (numpy), exactly
as in the paper where partitioning is a separate phase (Table 2, col 1).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .structures import EdgeList, edgelist_to_csr


def bfs_grow(g: EdgeList, frac: float = 0.5, seed: int = 0) -> np.ndarray:
    """Grow a BFS region from a random seed until ``frac`` of total volume.
    Used for geometric-bisection-style seed sets (paper §5.1)."""
    rng = np.random.default_rng(seed)
    csr = edgelist_to_csr(g)
    d = g.weighted_degrees()
    target = float(d.sum()) * frac
    start = int(rng.integers(g.n))
    visited = np.zeros(g.n, dtype=bool)
    frontier = [start]
    visited[start] = True
    vol = d[start]
    out = [start]
    while frontier and vol < target:
        nxt = []
        for u in frontier:
            for v in csr.indices[csr.indptr[u]:csr.indptr[u + 1]]:
                v = int(v)
                if not visited[v]:
                    visited[v] = True
                    nxt.append(v)
                    out.append(v)
                    vol += d[v]
                    if vol >= target:
                        break
            if vol >= target:
                break
        frontier = nxt
    return np.asarray(out, dtype=np.int64)


def _heavy_edge_matching(g: EdgeList, rng: np.random.Generator) -> np.ndarray:
    """Greedy heavy-edge matching; returns coarse label per node."""
    order = np.argsort(-np.asarray(g.weight, dtype=np.float64), kind="stable")
    matched = np.full(g.n, -1, dtype=np.int64)
    src = np.asarray(g.src)[order]
    dst = np.asarray(g.dst)[order]
    nxt = 0
    for u, v in zip(src, dst):
        if matched[u] < 0 and matched[v] < 0:
            matched[u] = matched[v] = nxt
            nxt += 1
    for u in range(g.n):
        if matched[u] < 0:
            matched[u] = nxt
            nxt += 1
    return matched


def _contract(g: EdgeList, labels: np.ndarray, node_w: np.ndarray) -> Tuple[EdgeList, np.ndarray]:
    """Contract nodes by ``labels`` (coarse ids 0..nc-1), summing parallel
    edge weights and node weights; drops resulting self loops."""
    nc = int(labels.max()) + 1
    from .structures import canonicalize_edges
    lo, hi, wsum = canonicalize_edges(labels[np.asarray(g.src)],
                                      labels[np.asarray(g.dst)],
                                      g.weight, nc, merge="sum")
    cw = np.zeros(nc, dtype=np.float64)
    np.add.at(cw, labels, node_w)
    cg = EdgeList(src=lo.astype(np.int32), dst=hi.astype(np.int32),
                  weight=wsum, n=nc)
    return cg, cw


def _initial_kway(g: EdgeList, node_w: np.ndarray, p: int,
                  rng: np.random.Generator) -> np.ndarray:
    """Greedy balanced BFS region growing into p parts on the coarsest graph."""
    csr = edgelist_to_csr(g)
    total = float(node_w.sum())
    target = total / p
    labels = np.full(g.n, -1, dtype=np.int64)
    remaining = set(range(g.n))
    for part in range(p - 1):
        if not remaining:
            break
        start = int(rng.choice(list(remaining)))
        vol = 0.0
        frontier = [start]
        labels[start] = part
        remaining.discard(start)
        vol += node_w[start]
        while frontier and vol < target:
            nf = []
            for u in frontier:
                for v in csr.indices[csr.indptr[u]:csr.indptr[u + 1]]:
                    v = int(v)
                    if labels[v] < 0:
                        labels[v] = part
                        remaining.discard(v)
                        vol += node_w[v]
                        nf.append(v)
                        if vol >= target:
                            break
                if vol >= target:
                    break
            frontier = nf
    for u in remaining:
        labels[u] = p - 1
    return labels


def _refine(g: EdgeList, labels: np.ndarray, node_w: np.ndarray, p: int,
            n_pass: int = 4, imbalance: float = 1.1) -> np.ndarray:
    """Boundary greedy refinement: move a node to the neighbouring part with
    the largest positive gain if balance permits."""
    csr = edgelist_to_csr(g)
    labels = labels.copy()
    part_w = np.zeros(p)
    np.add.at(part_w, labels, node_w)
    limit = node_w.sum() / p * imbalance
    for _ in range(n_pass):
        moved = 0
        # boundary nodes: any neighbour in another part
        nbr_lab = labels[csr.indices]
        own = np.repeat(labels, np.diff(csr.indptr))
        is_boundary = np.zeros(g.n, dtype=bool)
        np.logical_or.at(is_boundary, np.repeat(np.arange(g.n), np.diff(csr.indptr)),
                         nbr_lab != own)
        for u in np.nonzero(is_boundary)[0]:
            lo, hi = csr.indptr[u], csr.indptr[u + 1]
            labs = labels[csr.indices[lo:hi]]
            wts = csr.data[lo:hi]
            cur = labels[u]
            # connectivity to each candidate part
            gains = {}
            internal = float(wts[labs == cur].sum())
            for lab in np.unique(labs):
                if lab == cur:
                    continue
                ext = float(wts[labs == lab].sum())
                gains[int(lab)] = ext - internal
            if not gains:
                continue
            best = max(gains, key=gains.get)
            if gains[best] > 1e-12 and part_w[best] + node_w[u] <= limit:
                part_w[cur] -= node_w[u]
                part_w[best] += node_w[u]
                labels[u] = best
                moved += 1
        if moved == 0:
            break
    return labels


def partition_kway(g: EdgeList, p: int, seed: int = 0,
                   coarsen_to: int = 4000) -> np.ndarray:
    """Multilevel k-way partition; returns int64 labels in [0, p)."""
    if p <= 1:
        return np.zeros(g.n, dtype=np.int64)
    rng = np.random.default_rng(seed)
    node_w = g.weighted_degrees() + 1e-9

    levels: List[Tuple[EdgeList, np.ndarray, np.ndarray]] = []  # (graph, node_w, labels->coarse)
    cur_g, cur_w = g, node_w
    while cur_g.n > max(coarsen_to, 8 * p) and cur_g.m > 0:
        match = _heavy_edge_matching(cur_g, rng)
        if int(match.max()) + 1 >= cur_g.n:  # no progress
            break
        levels.append((cur_g, cur_w, match))
        cur_g, cur_w = _contract(cur_g, match, cur_w)

    labels = _initial_kway(cur_g, cur_w, p, rng)
    labels = _refine(cur_g, labels, cur_w, p)

    while levels:
        fine_g, fine_w, match = levels.pop()
        labels = labels[match]
        labels = _refine(fine_g, labels, fine_w, p)
    return labels


def cut_weight(g: EdgeList, labels: np.ndarray) -> float:
    s = np.asarray(g.src)
    d = np.asarray(g.dst)
    w = np.asarray(g.weight, dtype=np.float64)
    return float(w[labels[s] != labels[d]].sum())


def partition_order(labels: np.ndarray, seed: int = 0) -> np.ndarray:
    """Permutation perm with new_id = perm[old_id], grouping nodes of the same
    part contiguously (the paper's reordering P in §3.2)."""
    order = np.argsort(labels, kind="stable")  # order[new] = old
    perm = np.empty_like(order)
    perm[order] = np.arange(order.shape[0])
    return perm


def block_ranges(labels: np.ndarray, p: int) -> List[Tuple[int, int]]:
    """Contiguous [start, end) ranges per part after ``partition_order``."""
    counts = np.bincount(labels, minlength=p)
    ends = np.cumsum(counts)
    starts = ends - counts
    return list(zip(starts.tolist(), ends.tolist()))
