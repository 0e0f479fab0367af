"""DIN recsys architecture + its four serving/training shape cells (a copy
of the JAX package's ``repro/configs/din_cfg.py`` on the port's
``DINConfig``)."""
from __future__ import annotations

import dataclasses

from ..models.recsys import DINConfig

DIN_CELLS = ("train_batch", "serve_p99", "serve_bulk", "retrieval_cand")

DIN_SHAPES = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="retrieval", batch=1, n_candidates=1_000_000),
}


def din() -> DINConfig:
    # exact assigned interaction dims; production-scale sparse tables
    return DINConfig(name="din", embed_dim=18, seq_len=100,
                     attn_mlp=(80, 40), mlp=(200, 80),
                     n_items=100_000_000, n_cates=1_000_000, n_tags=100_000,
                     tag_bag_width=16)


def reduced_din() -> DINConfig:
    return dataclasses.replace(din(), n_items=5000, n_cates=200, n_tags=100,
                               seq_len=12, tag_bag_width=4)
