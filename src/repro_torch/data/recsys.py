"""Synthetic click-log generator for DIN (deterministic, seeded).

Item popularity is Zipf; each user's history is drawn around a latent
interest cluster so the target attention has signal; labels follow a simple
cluster-affinity logit.  Also provides the shape tables for the dry-run
specs of all four DIN cells (train_batch / serve_p99 / serve_bulk /
retrieval_cand).  A copy of the JAX package's ``repro/data/recsys.py``
(numpy only): the same arguments and seed give the same arrays.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def din_batch(batch: int, seq_len: int, n_items: int, n_cates: int,
              n_tags: int, tag_width: int = 16, seed: int = 0) -> Dict:
    rng = np.random.default_rng(seed)
    n_clusters = 32
    cluster = rng.integers(0, n_clusters, batch)
    span = max(1, n_items // n_clusters)

    def items_near(c, size):
        base = c * span
        return (base + rng.integers(0, span, size)) % n_items

    hist = np.stack([items_near(c, seq_len) for c in cluster]).astype(np.int32)
    hist_len = rng.integers(seq_len // 4, seq_len + 1, batch)
    mask = (np.arange(seq_len)[None] < hist_len[:, None]).astype(np.float32)
    pos = rng.random(batch) < 0.5
    tgt_cluster = np.where(pos, cluster, rng.integers(0, n_clusters, batch))
    target = np.array([items_near(c, 1)[0] for c in tgt_cluster], np.int32)
    return {
        "hist_items": hist,
        "hist_cates": (hist % n_cates).astype(np.int32),
        "hist_mask": mask,
        "target_item": target,
        "target_cate": (target % n_cates).astype(np.int32),
        "profile_tags": rng.integers(0, n_tags, (batch, tag_width)).astype(np.int32),
        "profile_mask": (rng.random((batch, tag_width)) < 0.7).astype(np.float32),
        "labels": pos.astype(np.float32),
    }


def din_retrieval_batch(n_candidates: int, seq_len: int, n_items: int,
                        n_cates: int, n_tags: int, tag_width: int = 16,
                        seed: int = 0) -> Dict:
    rng = np.random.default_rng(seed)
    cand = rng.integers(0, n_items, n_candidates).astype(np.int32)
    return {
        "hist_items": rng.integers(0, n_items, (1, seq_len)).astype(np.int32),
        "hist_cates": rng.integers(0, n_cates, (1, seq_len)).astype(np.int32),
        "hist_mask": np.ones((1, seq_len), np.float32),
        "cand_items": cand,
        "cand_cates": (cand % n_cates).astype(np.int32),
        "profile_tags": rng.integers(0, n_tags, (1, tag_width)).astype(np.int32),
        "profile_mask": np.ones((1, tag_width), np.float32),
    }


def din_batch_shapes(batch: int, seq_len: int, tag_width: int = 16,
                     with_labels: bool = True) -> Dict[str, Tuple[Tuple[int, ...], np.dtype]]:
    f32, i32 = np.float32, np.int32
    s = {
        "hist_items": ((batch, seq_len), i32),
        "hist_cates": ((batch, seq_len), i32),
        "hist_mask": ((batch, seq_len), f32),
        "target_item": ((batch,), i32),
        "target_cate": ((batch,), i32),
        "profile_tags": ((batch, tag_width), i32),
        "profile_mask": ((batch, tag_width), f32),
    }
    if with_labels:
        s["labels"] = ((batch,), f32)
    return s


def din_retrieval_shapes(n_candidates: int, seq_len: int, tag_width: int = 16):
    f32, i32 = np.float32, np.int32
    return {
        "hist_items": ((1, seq_len), i32),
        "hist_cates": ((1, seq_len), i32),
        "hist_mask": ((1, seq_len), f32),
        "cand_items": ((n_candidates,), i32),
        "cand_cates": ((n_candidates,), i32),
        "profile_tags": ((1, tag_width), i32),
        "profile_mask": ((1, tag_width), f32),
    }
