"""The four assigned GNN architectures + their shape-cell table.

Cell sizes are shared across the GNN archs (assignment layout); per-arch
feature semantics differ (GCN/MGN consume dense node features, SchNet/
DimeNet consume atom types + edge geometry).  DimeNet triplet counts are
capped per cell with uniform subsampling.  A copy of the JAX package's
``repro/configs/gnn.py`` on the port's config dataclasses."""
from __future__ import annotations

import dataclasses

from ..models.gnn import (DimeNetConfig, GCNConfig, MeshGraphNetConfig,
                          SchNetConfig)

GNN_CELLS = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")

# minibatch_lg: padded subgraph from the fanout-(15,10) sampler over the
# 232,965-node / 114.6M-edge global graph: 1024·(1+15+150) nodes,
# 1024·(15+150) edges (static shapes the sampler emits).
GNN_SHAPES = {
    "full_graph_sm": dict(kind="train", n_nodes=2708, n_edges=10556,
                          d_feat=1433, n_graphs=1, n_classes=7,
                          n_triplets=65536),
    "minibatch_lg": dict(kind="train", n_nodes=169_984, n_edges=168_960,
                         d_feat=602, n_graphs=1, n_classes=41,
                         n_triplets=1_048_576, sampled=True,
                         global_nodes=232_965, global_edges=114_615_892,
                         batch_nodes=1024, fanouts=(15, 10)),
    "ogb_products": dict(kind="train", n_nodes=2_449_029, n_edges=61_859_140,
                         d_feat=100, n_graphs=1, n_classes=47,
                         n_triplets=123_718_280),
    "molecule": dict(kind="train", n_nodes=30 * 128, n_edges=64 * 128,
                     d_feat=16, n_graphs=128, n_classes=2,
                     n_triplets=16384),
}


def gcn_cora(cell: dict) -> GCNConfig:
    return GCNConfig(name="gcn-cora", n_layers=2, d_hidden=16,
                     in_dim=cell["d_feat"], n_classes=cell["n_classes"])


def schnet(cell: dict) -> SchNetConfig:
    return SchNetConfig(name="schnet", n_interactions=3, d_hidden=64,
                        n_rbf=300, cutoff=10.0)


def dimenet(cell: dict) -> DimeNetConfig:
    return DimeNetConfig(name="dimenet", n_blocks=6, d_hidden=128,
                         n_bilinear=8, n_spherical=7, n_radial=6)


def meshgraphnet(cell: dict) -> MeshGraphNetConfig:
    return MeshGraphNetConfig(name="meshgraphnet", n_layers=15, d_hidden=128,
                              mlp_layers=2, in_node_dim=cell["d_feat"],
                              in_edge_dim=7, out_dim=3)


GNN_ARCHS = {
    "gcn-cora": gcn_cora,
    "schnet": schnet,
    "dimenet": dimenet,
    "meshgraphnet": meshgraphnet,
}

REDUCED_CELL = dict(kind="train", n_nodes=64, n_edges=160, d_feat=8,
                    n_graphs=4, n_classes=3, n_triplets=512)


def reduced_gnn(arch_id: str):
    cell = REDUCED_CELL
    cfg = GNN_ARCHS[arch_id](cell)
    if arch_id == "schnet":
        return dataclasses.replace(cfg, d_hidden=16, n_rbf=32)
    if arch_id == "dimenet":
        return dataclasses.replace(cfg, d_hidden=16, n_blocks=2)
    if arch_id == "meshgraphnet":
        return dataclasses.replace(cfg, d_hidden=16, n_layers=3)
    return cfg
