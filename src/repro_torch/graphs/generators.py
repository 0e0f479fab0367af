"""Synthetic graph/instance generators mirroring the paper's two data families.

The paper evaluates on (a) road networks (planar, avg degree ~2.5) and (b)
N-D grid segmentation graphs (6/26-connected voxel grids from the UWO
max-flow datasets, weights made float by adding U[0,1] noise).  Offline we
synthesize statistically matching families:

* ``road_like``      — jittered-grid planar nets with degree ~2.6 (road proxy)
* ``grid_2d/grid_3d``— 4/6/26-connected grids with smooth+noisy capacities
* ``random_regular`` — small test graphs
* ``flow_improve_instance`` — terminal edges built like FlowImprove from a
  seed bisection (how the paper makes road networks into s-t instances)
* ``segmentation_instance`` — unary potentials from a smooth random field

Same seeds give the same arrays as the JAX package's generators, bit for
bit: both draw from numpy's ``default_rng`` in the same order.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components

from .structures import EdgeList, STInstance, canonicalize_edges


def _dedup_and_connect(src, dst, w, n, rng) -> EdgeList:
    """Canonicalize (u<v), drop dups/self-loops, then add spanning edges to
    make the graph connected."""
    lo, hi, w = canonicalize_edges(src, dst, w, n, merge="first")
    adj = coo_matrix((np.ones(lo.shape[0], dtype=np.int8), (lo, hi)),
                     shape=(n, n))
    if connected_components(adj, directed=False, return_labels=False) <= 1:
        # a connected graph gets no spanning edges and draws nothing more
        # from rng, so skipping the per-edge union-find below changes nothing
        return EdgeList(src=lo.astype(np.int32), dst=hi.astype(np.int32),
                        weight=w, n=n).validate()

    # union-find to connect components
    parent = np.arange(n, dtype=np.int64)

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    for a, b in zip(lo, hi):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb
    roots = np.array(sorted({find(i) for i in range(n)}))
    extra_src, extra_dst = [], []
    for i in range(len(roots) - 1):
        extra_src.append(roots[i])
        extra_dst.append(roots[i + 1])
        parent[find(roots[i])] = find(roots[i + 1])
    if extra_src:
        lo = np.concatenate([lo, np.minimum(extra_src, extra_dst)])
        hi = np.concatenate([hi, np.maximum(extra_src, extra_dst)])
        w = np.concatenate([w, rng.uniform(0.5, 1.5, size=len(extra_src))])
    return EdgeList(src=lo.astype(np.int32), dst=hi.astype(np.int32), weight=w, n=n).validate()


def road_like(side: int, seed: int = 0, keep_prob: float = 0.62) -> EdgeList:
    """Planar road-network proxy: jittered grid, 4-neighbour links kept with
    probability ``keep_prob`` (gives avg degree ≈ 2.5, like usroads-48)."""
    rng = np.random.default_rng(seed)
    n = side * side
    ii, jj = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    idx = (ii * side + jj).ravel()
    right = np.stack([idx[(jj < side - 1).ravel()],
                      (idx + 1)[(jj < side - 1).ravel()]], axis=1)
    down = np.stack([idx[(ii < side - 1).ravel()],
                     (idx + side)[(ii < side - 1).ravel()]], axis=1)
    edges = np.concatenate([right, down], axis=0)
    keep = rng.uniform(size=edges.shape[0]) < keep_prob
    edges = edges[keep]
    # road segment "lengths" -> float weights
    w = rng.uniform(0.2, 2.0, size=edges.shape[0])
    return _dedup_and_connect(edges[:, 0], edges[:, 1], w, n, rng)


def grid_2d(h: int, w: int, seed: int = 0, smooth: bool = True) -> EdgeList:
    """4-connected 2D grid with smooth random capacities + U[0,1] noise."""
    rng = np.random.default_rng(seed)
    n = h * w
    ii, jj = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    idx = (ii * w + jj).ravel()
    src = np.concatenate([idx[(jj < w - 1).ravel()], idx[(ii < h - 1).ravel()]])
    dst = np.concatenate([(idx + 1)[(jj < w - 1).ravel()], (idx + w)[(ii < h - 1).ravel()]])
    base = _smooth_field((h, w), rng) if smooth else np.ones((h, w))
    f = base.ravel()
    wts = 2.0 + 2.0 * np.exp(-np.abs(f[src] - f[dst]) * 4.0) + rng.uniform(0, 1, size=src.shape[0])
    return _dedup_and_connect(src, dst, wts, n, rng)


def grid_3d(d: int, h: int, w: int, conn: int = 6, seed: int = 0) -> EdgeList:
    """6- or 26-connected 3D voxel grid (MRI-scan proxy)."""
    if conn not in (6, 26):
        raise ValueError(f"conn must be 6 or 26, got {conn}")
    rng = np.random.default_rng(seed)
    n = d * h * w
    coords = np.stack(np.meshgrid(np.arange(d), np.arange(h), np.arange(w),
                                  indexing="ij"), axis=-1).reshape(-1, 3)
    idx = coords[:, 0] * h * w + coords[:, 1] * w + coords[:, 2]
    offs = []
    full = [(dz, dy, dx) for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    for o in full:
        if o == (0, 0, 0):
            continue
        if conn == 6 and sum(abs(v) for v in o) != 1:
            continue
        # keep each undirected pair once: lexicographically positive offset
        if o > (0, 0, 0):
            offs.append(o)
    srcs, dsts = [], []
    for dz, dy, dx in offs:
        nc = coords + np.array([dz, dy, dx])
        ok = ((nc[:, 0] >= 0) & (nc[:, 0] < d) & (nc[:, 1] >= 0) & (nc[:, 1] < h)
              & (nc[:, 2] >= 0) & (nc[:, 2] < w))
        srcs.append(idx[ok])
        dsts.append(nc[ok, 0] * h * w + nc[ok, 1] * w + nc[ok, 2])
    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)
    field = _smooth_field((d, h, w), rng).ravel()
    wts = 1.0 + 4.0 * np.exp(-np.abs(field[src] - field[dst]) * 3.0) + rng.uniform(0, 1, size=src.shape[0])
    return _dedup_and_connect(src, dst, wts, n, rng)


def random_regular(n: int, deg: int, seed: int = 0) -> EdgeList:
    """Small random near-regular test graph (configuration-model style)."""
    rng = np.random.default_rng(seed)
    stubs = np.repeat(np.arange(n), deg)
    rng.shuffle(stubs)
    half = len(stubs) // 2
    src, dst = stubs[:half], stubs[half:2 * half]
    w = rng.uniform(0.5, 2.0, size=half)
    return _dedup_and_connect(src, dst, w, n, rng)


def _smooth_field(shape, rng) -> np.ndarray:
    """Cheap smooth random field: random gaussians + box blur."""
    f = rng.standard_normal(shape)
    for axis in range(len(shape)):
        for _ in range(3):
            f = (f + np.roll(f, 1, axis=axis) + np.roll(f, -1, axis=axis)) / 3.0
    return f


def flow_improve_instance(g: EdgeList, seed_set: Optional[np.ndarray] = None,
                          alpha: Optional[float] = None, seed: int = 0) -> STInstance:
    """Build an s-t instance from a seed bisection as FlowImprove does (the
    paper's §5.1 road-network recipe): s connects to every u in the seed set
    A with weight d_w(u); t connects to every u ∉ A with weight α·d_w(u),
    α = vol(A)/vol(Ā)."""
    rng = np.random.default_rng(seed)
    d = g.weighted_degrees()
    if seed_set is None:
        # geometric-ish bisection: BFS from a random node until half the volume
        from .partition import bfs_grow
        seed_set = bfs_grow(g, frac=0.5, seed=int(rng.integers(1 << 31)))
    ind = np.zeros(g.n, dtype=bool)
    ind[np.asarray(seed_set)] = True
    volA = float(d[ind].sum())
    volB = float(d[~ind].sum())
    if alpha is None:
        alpha = volA / max(volB, 1e-12)
    s_w = np.where(ind, d, 0.0)
    t_w = np.where(~ind, alpha * d, 0.0)
    return STInstance(graph=g, s_weight=s_w, t_weight=t_w)


def segmentation_instance(g: EdgeList, shape: Tuple[int, ...], seed: int = 0,
                          unary_strength: Optional[float] = None) -> STInstance:
    """Unary potentials from a smooth field (image/MRI segmentation proxy):
    source affinity where field > threshold, sink affinity elsewhere.

    ``unary_strength`` scales the terminal weights; the default ties it to
    the mean weighted degree so the min cut trades off boundary length
    against unary disagreement."""
    rng = np.random.default_rng(seed)
    field = _smooth_field(shape, rng).ravel()
    if field.shape[0] != g.n:
        raise ValueError(f"shape {shape} has {field.shape[0]} cells; "
                         f"graph has {g.n} nodes")
    if unary_strength is None:
        unary_strength = 0.55 * float(g.weighted_degrees().mean())
    lo, hi = np.quantile(field, [0.35, 0.65])
    u = unary_strength
    s_w = np.where(field > hi, u * (1.0 + field - hi), 0.0) \
        + rng.uniform(0, 0.05 * u, g.n)
    t_w = np.where(field < lo, u * (1.0 + lo - field), 0.0) \
        + rng.uniform(0, 0.05 * u, g.n)
    return STInstance(graph=g, s_weight=s_w, t_weight=t_w)
