"""DIN (Deep Interest Network) — target-attention CTR model (PyTorch).

The port of ``repro/models/recsys.py``: the same config, parameter tree,
batch dict and arithmetic.  The hot path is the sparse embedding lookup,
a gather plus masked reduces as in the reference; the multi-hot profile
field goes through ``layers.embedding_bag``.  Each table is read by one
gather per forward over all of its ids (the history's and the target's
together), whose backward is the fixed-order segment sum of
``layers.gather``: one dense table gradient, and the same bits on every
run on the card.

Shapes (batch dict):
  hist_items  i32[B, S]   user behaviour sequence (item ids)
  hist_cates  i32[B, S]
  hist_mask   f[B, S]
  target_item i32[B], target_cate i32[B]
  profile_tags i32[B, W] + profile_mask f[B, W]   (multi-hot → embedding_bag)
  labels      f[B]        (click / no-click)

``retrieval_cand``: one user vs n_candidates items, scored ``chunk``
candidates at a time (each candidate's score depends only on its own row,
so chunks change no answer; at 1,000,000 candidates the reference's one
broadcast would be a [C, S, 8d] float32 input of 57.6 GB).

``rules``: None or ``sharding.no_sharding()`` change nothing; rules on a
mesh raise (``din_rules`` comes with ROADMAP queue 1, item 7, "Dry runs").
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from ..train.checkpoint import tree_from_numpy
from .layers import RowIndex, embedding_bag, gather, mlp
from .sharding import require_no_mesh
from .transformer import as_torch_dtype


@dataclasses.dataclass(frozen=True)
class DINConfig:
    name: str = "din"
    embed_dim: int = 18
    seq_len: int = 100
    attn_mlp: tuple = (80, 40)
    mlp: tuple = (200, 80)
    n_items: int = 100_000_000       # production-scale sparse table
    n_cates: int = 1_000_000
    n_tags: int = 100_000
    tag_bag_width: int = 16
    dtype: Any = torch.float32        # a torch, numpy or JAX dtype, or name

    def __post_init__(self):
        object.__setattr__(self, "dtype", as_torch_dtype(self.dtype))


def din_init(cfg: DINConfig, gen: Optional[torch.Generator] = None,
             device="cuda"):
    d = cfg.embed_dim

    def table(rows):
        t = torch.randn((rows, d), generator=gen, dtype=torch.float32,
                        device=device)
        return t.mul_(0.01).to(cfg.dtype)       # in place: one table's bytes

    def mlp_params(dims):
        return {"w": [(torch.randn((a, b), generator=gen, dtype=torch.float32,
                                   device=device) / math.sqrt(a)).to(cfg.dtype)
                      for a, b in zip(dims[:-1], dims[1:])],
                "b": [torch.zeros((b,), dtype=cfg.dtype, device=device)
                      for b in dims[1:]]}

    de = 2 * d                        # item+cate concat
    return {
        "item_table": table(cfg.n_items),
        "cate_table": table(cfg.n_cates),
        "tag_table": table(cfg.n_tags),
        # attention unit input: [h, t, h−t, h·t] over the 2d-concat embeds
        "attn": mlp_params([4 * de] + list(cfg.attn_mlp) + [1]),
        # final MLP: user-interest (2d) + target (2d) + tag bag (d)
        "mlp": mlp_params([2 * de + d] + list(cfg.mlp) + [1]),
    }


def _mlp(p, x, act=torch.relu):
    return mlp(x, p["w"], p["b"], act=act)


def _lookup(table: torch.Tensor, *ids: torch.Tensor):
    """The rows of ``table`` for each ids tensor (shaped ids.shape + (d,)),
    read by one gather over all of them."""
    flat = torch.cat([i.reshape(-1) for i in ids])
    rows = gather(table, RowIndex(flat, table.shape[0]))
    out, at = [], 0
    for i in ids:
        out.append(rows[at:at + i.numel()].reshape(i.shape + table.shape[1:]))
        at += i.numel()
    return out


def _embed_pairs(params, items, cates):
    """[item row, cate row] of each (items, cates) pair of ids tensors."""
    ei = _lookup(params["item_table"], *items)
    ec = _lookup(params["cate_table"], *cates)
    return [torch.cat([a, b], dim=-1) for a, b in zip(ei, ec)]


def din_user_interest(params, hist_emb, hist_mask, target_emb, cfg: DINConfig):
    """Target attention (the DIN attention unit): per history item,
    MLP([h, t, h−t, h⊙t]) → activation weight; weighted sum (un-normalized
    sigmoid weights, as the reference)."""
    # hist_emb [..., S, 2d], target_emb [..., 2d]
    t = target_emb[..., None, :].expand(hist_emb.shape)
    att_in = torch.cat([hist_emb, t, hist_emb - t, hist_emb * t], dim=-1)
    w = _mlp(params["attn"], att_in, act=torch.sigmoid)[..., 0]  # [..., S]
    w = w * hist_mask
    return torch.einsum("...s,...sd->...d", w, hist_emb)


def din_logits(params, batch, cfg: DINConfig, rules=None):
    require_no_mesh(rules, "din")
    hist, target = _embed_pairs(params,
                                (batch["hist_items"], batch["target_item"]),
                                (batch["hist_cates"], batch["target_cate"]))
    interest = din_user_interest(params, hist, batch["hist_mask"], target, cfg)
    tags = embedding_bag(params["tag_table"], batch["profile_tags"],
                         batch["profile_mask"], mode="mean")
    feat = torch.cat([interest, target, tags], dim=-1)
    return _mlp(params["mlp"], feat)[..., 0]


def din_loss(params, batch, cfg: DINConfig, rules=None):
    logits = din_logits(params, batch, cfg, rules).float()
    y = batch["labels"].float()
    # torch.maximum splits a tie's gradient as jnp.maximum does
    return torch.mean(torch.maximum(logits, logits.new_zeros(()))
                      - logits * y + torch.log1p(torch.exp(-logits.abs())))


def din_retrieval_scores(params, batch, cfg: DINConfig, rules=None,
                         chunk: Optional[int] = 65536):
    """Score ONE user's history against n_candidates items.

    batch: hist_items/hist_cates/hist_mask [1, S]; cand_items i32[C];
    cand_cates i32[C]; profile_tags/profile_mask [1, W].  The history
    [S, 2d] is broadcast against ``chunk`` candidates at a time (None: all
    C at once, as the reference) → [chunk, S] weights; returns f[C]."""
    require_no_mesh(rules, "din")
    hist, cand = _embed_pairs(params,
                              (batch["hist_items"][0], batch["cand_items"]),
                              (batch["hist_cates"][0], batch["cand_cates"]))
    mask = batch["hist_mask"][0]                          # [S]
    tags = embedding_bag(params["tag_table"], batch["profile_tags"],
                         batch["profile_mask"], mode="mean")        # [1, d]
    S, D2 = hist.shape
    C = cand.shape[0]
    step = chunk or C
    scores = []
    for c0 in range(0, C, step):
        cc = cand[c0:c0 + step]
        c = cc.shape[0]
        h = hist[None].expand(c, S, D2)
        interest = din_user_interest(params, h, mask[None], cc, cfg)
        feat = torch.cat([interest, cc, tags.expand(c, tags.shape[-1])], -1)
        scores.append(_mlp(params["mlp"], feat)[..., 0])
    return torch.cat(scores)


def params_from_numpy(tree, cfg: DINConfig, device="cuda"):
    """The reference's DIN parameter pytree (numpy arrays) as the port's,
    on ``device`` in ``cfg.dtype``."""
    return tree_from_numpy(tree, din_init(cfg, None, "meta"), device)
