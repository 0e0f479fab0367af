"""GNN batch builders for the assigned shape cells.

A copy of the JAX package's ``repro/data/graphs.py`` (numpy only): the same
arguments and seed give the same arrays.  Builds the batch dicts the models
in models/gnn.py consume, at three fidelities:

* ``synthetic_batch(...)``  — real numpy arrays (smoke tests, examples);
* ``batch_shapes(...)``     — {name: (shape, dtype)} for the dry-run's
  ShapeDtypeStruct ``input_specs`` (never allocates);
* ``build_triplets(...)``   — REAL DimeNet triplet construction (k→j→i)
  from an edge list, with a per-graph cap + uniform subsampling (the
  documented policy for dense graphs, DESIGN.md §5).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def build_triplets(src: np.ndarray, dst: np.ndarray, n: int,
                   max_triplets: Optional[int] = None, seed: int = 0
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """All (k→j, j→i) directed-edge pairs: for each edge e=(j→i), couple
    with every edge e'=(k→j) landing on j, k ≠ i.  Returns (tri_kj, tri_ji)
    as indices into the directed edge list."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    m = len(src)
    order = np.argsort(dst, kind="stable")
    by_dst_start = np.zeros(n + 1, dtype=np.int64)
    np.add.at(by_dst_start, dst + 1, 1)
    by_dst_start = np.cumsum(by_dst_start)
    in_edges = order  # edge ids sorted by dst

    tri_kj, tri_ji = [], []
    for e in range(m):
        j = src[e]          # edge e: j -> i
        i = dst[e]
        lo, hi = by_dst_start[j], by_dst_start[j + 1]
        for ein in in_edges[lo:hi]:
            if src[ein] == i:     # exclude backtracking k == i
                continue
            tri_kj.append(ein)
            tri_ji.append(e)
    tri_kj = np.asarray(tri_kj, dtype=np.int32)
    tri_ji = np.asarray(tri_ji, dtype=np.int32)
    if max_triplets is not None and len(tri_kj) > max_triplets:
        rng = np.random.default_rng(seed)
        keep = rng.choice(len(tri_kj), size=max_triplets, replace=False)
        tri_kj, tri_ji = tri_kj[keep], tri_ji[keep]
    return tri_kj, tri_ji


def _pad(a, size, dtype=None):
    out = np.zeros((size,) + a.shape[1:], dtype=dtype or a.dtype)
    k = min(len(a), size)
    out[:k] = a[:k]
    return out


def synthetic_gnn_batch(arch: str, n_nodes: int, n_edges: int,
                        d_feat: int = 16, n_graphs: int = 1,
                        sbf_dim: int = 42, max_triplets: Optional[int] = None,
                        out_dim: int = 3, n_classes: int = 7,
                        in_edge_dim: int = 7, seed: int = 0) -> Dict:
    """Random connected-ish graph batch matching a shape cell (numpy)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    dst = ((src + 1 + rng.integers(0, max(1, n_nodes - 1), n_edges))
           % n_nodes).astype(np.int32)
    batch = {
        "edge_src": src, "edge_dst": dst,
        "edge_mask": np.ones(n_edges, np.float32),
        "node_mask": np.ones(n_nodes, np.float32),
    }
    gid = np.sort(rng.integers(0, n_graphs, n_nodes)).astype(np.int32)
    if arch == "gcn-cora":
        batch["node_feat"] = rng.standard_normal((n_nodes, d_feat)).astype(np.float32)
        batch["labels"] = rng.integers(0, n_classes, n_nodes).astype(np.int32)
    elif arch == "schnet":
        batch["node_type"] = rng.integers(0, 100, n_nodes).astype(np.int32)
        batch["edge_dist"] = rng.uniform(0.5, 10.0, n_edges).astype(np.float32)
        batch["graph_ids"] = gid
        batch["n_graphs"] = n_graphs
        batch["labels"] = rng.standard_normal(n_graphs).astype(np.float32)
    elif arch == "dimenet":
        batch["node_type"] = rng.integers(0, 100, n_nodes).astype(np.int32)
        batch["edge_dist"] = rng.uniform(0.5, 5.0, n_edges).astype(np.float32)
        tri_kj, tri_ji = build_triplets(src, dst, n_nodes, max_triplets, seed)
        T = max_triplets if max_triplets else max(1, len(tri_kj))
        batch["tri_kj"] = _pad(tri_kj, T)
        batch["tri_ji"] = _pad(tri_ji, T)
        tm = np.zeros(T, np.float32)
        tm[: min(len(tri_kj), T)] = 1.0
        batch["tri_mask"] = tm
        batch["tri_sbf"] = rng.standard_normal((T, sbf_dim)).astype(np.float32)
        batch["graph_ids"] = gid
        batch["n_graphs"] = n_graphs
        batch["labels"] = rng.standard_normal(n_graphs).astype(np.float32)
    elif arch == "meshgraphnet":
        batch["node_feat"] = rng.standard_normal((n_nodes, d_feat)).astype(np.float32)
        batch["edge_feat"] = rng.standard_normal((n_edges, in_edge_dim)).astype(np.float32)
        batch["labels"] = rng.standard_normal((n_nodes, out_dim)).astype(np.float32)
    else:
        raise ValueError(arch)
    return batch


def gnn_batch_shapes(arch: str, n_nodes: int, n_edges: int, d_feat: int,
                     n_triplets: int = 0, sbf_dim: int = 42,
                     n_graphs: int = 1, out_dim: int = 3,
                     in_edge_dim: int = 7) -> Dict[str, Tuple[Tuple[int, ...], np.dtype]]:
    """Shape/dtype table for ShapeDtypeStruct input specs (dry-run)."""
    f32, i32 = np.float32, np.int32
    shapes = {
        "edge_src": ((n_edges,), i32), "edge_dst": ((n_edges,), i32),
        "edge_mask": ((n_edges,), f32), "node_mask": ((n_nodes,), f32),
    }
    if arch == "gcn-cora":
        shapes["node_feat"] = ((n_nodes, d_feat), f32)
        shapes["labels"] = ((n_nodes,), i32)
    elif arch == "schnet":
        shapes.update({"node_type": ((n_nodes,), i32),
                       "edge_dist": ((n_edges,), f32),
                       "graph_ids": ((n_nodes,), i32),
                       "labels": ((n_graphs,), f32)})
    elif arch == "dimenet":
        shapes.update({"node_type": ((n_nodes,), i32),
                       "edge_dist": ((n_edges,), f32),
                       "tri_kj": ((n_triplets,), i32),
                       "tri_ji": ((n_triplets,), i32),
                       "tri_mask": ((n_triplets,), f32),
                       "tri_sbf": ((n_triplets, sbf_dim), f32),
                       "graph_ids": ((n_nodes,), i32),
                       "labels": ((n_graphs,), f32)})
    elif arch == "meshgraphnet":
        shapes.update({"node_feat": ((n_nodes, d_feat), f32),
                       "edge_feat": ((n_edges, in_edge_dim), f32),
                       "labels": ((n_nodes, out_dim), f32)})
    else:
        raise ValueError(arch)
    return shapes
