"""Real fanout neighbour sampler for sampled GNN training (minibatch_lg).

GraphSAGE-style layered uniform sampling over a host CSR graph:
seeds [B] → layer 1 (fanout f1) → layer 2 (fanout f2) → ...  The sampled
subgraph is emitted as PADDED static-shape arrays (model code is jit-stable
across batches):

  sub_nodes  i32[max_nodes]    original node ids (0-padded)
  node_mask  f[max_nodes]
  edge_src/edge_dst i32[max_edges]  indices INTO sub_nodes
  edge_mask  f[max_edges]
  seed_mask  f[max_nodes]      1 for the seed (loss) nodes

Sampling runs on host numpy (the paper's setup phase lives on host too);
vectorized per layer with replacement-free capping per node.  A copy of
the JAX package's ``repro/data/sampler.py`` on the port's own ``CSR``: the
same graph and seed give the same arrays.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from ..graphs.structures import CSR


class NeighborSampler:
    def __init__(self, csr: CSR, fanouts: Sequence[int], batch_nodes: int,
                 seed: int = 0):
        self.csr = csr
        self.fanouts = list(fanouts)
        self.batch_nodes = batch_nodes
        self.rng = np.random.default_rng(seed)
        # static output sizes
        self.max_nodes = batch_nodes
        self.max_edges = 0
        frontier = batch_nodes
        for f in self.fanouts:
            self.max_edges += frontier * f
            frontier = frontier * f
            self.max_nodes += frontier

    def sample(self, seeds: np.ndarray = None) -> Dict[str, np.ndarray]:
        csr = self.csr
        if seeds is None:
            seeds = self.rng.integers(0, csr.n, size=self.batch_nodes)
        seeds = np.asarray(seeds, dtype=np.int64)
        nodes: List[np.ndarray] = [seeds]
        srcs: List[np.ndarray] = []
        dsts: List[np.ndarray] = []
        id_of = {int(u): i for i, u in enumerate(seeds)}
        all_nodes = list(seeds)
        frontier = seeds
        for f in self.fanouts:
            deg = csr.indptr[frontier + 1] - csr.indptr[frontier]
            # uniform WITH replacement when deg > 0 (standard GraphSAGE)
            offs = (self.rng.random((len(frontier), f))
                    * np.maximum(deg, 1)[:, None]).astype(np.int64)
            nbr = csr.indices[csr.indptr[frontier][:, None] + offs]
            valid = np.broadcast_to((deg > 0)[:, None], (len(frontier), f))
            src_local = []
            dst_local = []
            new_frontier = []
            for i, u in enumerate(frontier):
                ui = id_of[int(u)]
                for j in range(f):
                    if not valid[i, j]:
                        continue
                    v = int(nbr[i, j])
                    vi = id_of.get(v)
                    if vi is None:
                        vi = len(all_nodes)
                        id_of[v] = vi
                        all_nodes.append(v)
                        new_frontier.append(v)
                    src_local.append(vi)
                    dst_local.append(ui)   # message flows neighbour → seed
            srcs.append(np.asarray(src_local, dtype=np.int32))
            dsts.append(np.asarray(dst_local, dtype=np.int32))
            frontier = np.asarray(new_frontier, dtype=np.int64) \
                if new_frontier else np.empty(0, dtype=np.int64)
            if len(frontier) == 0:
                break

        sub_nodes = np.zeros(self.max_nodes, dtype=np.int32)
        node_mask = np.zeros(self.max_nodes, dtype=np.float32)
        k = min(len(all_nodes), self.max_nodes)
        sub_nodes[:k] = np.asarray(all_nodes[:k], dtype=np.int32)
        node_mask[:k] = 1.0
        seed_mask = np.zeros(self.max_nodes, dtype=np.float32)
        seed_mask[: len(seeds)] = 1.0

        es = np.concatenate(srcs) if srcs else np.empty(0, np.int32)
        ed = np.concatenate(dsts) if dsts else np.empty(0, np.int32)
        edge_src = np.zeros(self.max_edges, dtype=np.int32)
        edge_dst = np.zeros(self.max_edges, dtype=np.int32)
        edge_mask = np.zeros(self.max_edges, dtype=np.float32)
        ke = min(len(es), self.max_edges)
        edge_src[:ke] = es[:ke]
        edge_dst[:ke] = ed[:ke]
        edge_mask[:ke] = 1.0
        return {"sub_nodes": sub_nodes, "node_mask": node_mask,
                "edge_src": edge_src, "edge_dst": edge_dst,
                "edge_mask": edge_mask, "seed_mask": seed_mask}
