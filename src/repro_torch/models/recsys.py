"""DIN (Deep Interest Network) — target-attention CTR model (PyTorch).

The port of ``repro/models/recsys.py``: the same config, parameter tree,
batch dict and arithmetic.  The hot path is the sparse embedding lookup,
a gather plus masked reduces as in the reference; the multi-hot profile
field is ``layers.embedding_bag``'s masked mean (``bag_reduce``).  Each
table is read by one gather per forward over all of its ids (the
history's and the target's together), whose backward is the fixed-order
segment sum of ``layers.gather``: one dense table gradient, and the same
bits on every run on the card.

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

``rules``: None or ``sharding.no_sharding()`` change nothing.  With rules
on a mesh (``launch.cells.din_rules``: batch over the data axes, table rows
over ``model``, candidates over every axis) the tables are row-sharded
(a DTensor over ``model``, or a tensor every rank holds whole, of which it
takes its rows): each rank looks up the ids in its row range, puts zero
elsewhere, and the rows are summed over ``model`` (the vocab-parallel
embedding; candidates, which differ between the model ranks, are
all-gathered over ``model`` first and their rows reduce-scattered back).
Each rank scores its rows of the batch (its candidates in retrieval);
the MLPs are replicated, their gradients all-reduced over the data axes
where the batch is split.  ``din_logits`` and ``din_retrieval_scores``
return DTensors over the batch or candidates there; ``din_loss`` the same
scalar on every rank.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from ..distributed import collectives as C
from ..train.checkpoint import tree_from_numpy
from .layers import RowIndex, bag_reduce, gather, mlp
from .sharding import local_block, stored_dims
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


class _Layout:
    """DIN on ``rules``' mesh: the data axes the batch is split over
    (``data``, where B divides them), the model axes the table rows are
    (``model``), the candidates' axes (``cand``).  Without a mesh all are
    empty and every collective the identity."""

    def __init__(self, rules, rows: Optional[int] = None):
        mesh = rules.mesh if rules is not None else None
        self.mesh = mesh
        axes = (lambda name: C._active(mesh, rules.axes(name))) \
            if mesh is not None else (lambda name: ())
        self.data = axes("batch")
        if rows is not None and rows % C.mesh_size(mesh, self.data):
            self.data = ()
        self.model = axes("rows")
        self.cand = axes("candidates")

    def rows(self, x, axes):
        """This rank's rows of a batch leaf over ``axes`` (a DTensor's
        block, or its slice of a tensor every rank holds whole)."""
        if hasattr(x, "to_local"):
            return x.to_local()
        return C._slice(x, self.mesh, axes, 0) if axes else x

    def param(self, t):
        """A replicated parameter as this rank's work takes it (its
        gradient all-reduced over the data axes the batch is split on)."""
        if self.mesh is None:
            return t
        return local_block(t, self.mesh, {}, {a: True for a in self.data},
                           stored_dims(t))

    def table(self, t):
        """(this rank's block of a table's rows, its first row): row-sharded
        over ``model`` where the rows divide it, else whole."""
        if self.mesh is None:
            return t, 0
        tp = C.mesh_size(self.mesh, self.model)
        split = tp > 1 and t.shape[0] % tp == 0
        model = self.model if split else ()
        need = {a: 0 for a in model}
        block = local_block(t, self.mesh, need,
                            {a: True for a in self.data}, stored_dims(t))
        return block, C.mesh_coord(self.mesh, model) * block.shape[0]

    def placements(self, rules, name, n):
        return rules.placements(rules.spec(name, shape=(n,)))


def _lookup(table: torch.Tensor, *ids: torch.Tensor, lay=None,
            scattered: bool = False):
    """The rows of ``table`` for each ids tensor (shaped ids.shape + (d,)),
    read by one gather over all of them.  On a mesh ``table`` is
    ``_Layout.table``'s (block, first row): ids outside the block read 0
    and the rows are summed over ``model``; ``scattered`` ids differ between
    the model ranks (candidates): they are all-gathered over ``model``
    first and the summed rows reduce-scattered back."""
    flat = torch.cat([i.reshape(-1) for i in ids])
    if lay is None or lay.mesh is None:
        rows = gather(table, RowIndex(flat, table.shape[0]))
    else:
        block, row0 = table
        if scattered:
            flat = C.gather(flat, lay.mesh, lay.model, 0, reduce_grad=False)
        local = flat - row0
        ok = (local >= 0) & (local < block.shape[0])
        rows = gather(block, RowIndex(torch.where(ok, local, 0),
                                      block.shape[0]))
        rows = rows * ok[:, None].to(rows.dtype)
        if scattered:
            rows = C.reduce_scatter(rows, lay.mesh, lay.model, 0)
        else:
            rows = C.reduce(rows, lay.mesh, lay.model)
        table = block
    out, at = [], 0
    for i in ids:
        out.append(rows[at:at + i.numel()].reshape(i.shape + table.shape[1:]))
        at += i.numel()
    return out


def _embed_pairs(params, items, cates, lay=None, scattered=False):
    """[item row, cate row] of each (items, cates) pair of ids tensors."""
    ei = _lookup(params["item_table"], *items, lay=lay, scattered=scattered)
    ec = _lookup(params["cate_table"], *cates, lay=lay, scattered=scattered)
    return [torch.cat([a, b], dim=-1) for a, b in zip(ei, ec)]


def _tag_bag(params, tags, mask, lay=None):
    """The profile's tag bag, mean mode: ``_lookup``'s rows through
    ``layers.bag_reduce``."""
    (emb,) = _lookup(params["tag_table"], tags, lay=lay)
    return bag_reduce(emb, mask, "mean")


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


def _params(params, lay):
    """The tables as (block, first row) and the MLPs as this rank's work
    takes them; the params themselves without a mesh."""
    if lay.mesh is None:
        return params
    out = {k: lay.table(params[k]) for k in
           ("item_table", "cate_table", "tag_table")}
    for k in ("attn", "mlp"):
        out[k] = {n: [lay.param(t) for t in params[k][n]]
                  for n in ("w", "b")}
    return out


def _logits(params, batch, cfg: DINConfig, lay):
    """This rank's logits (its rows of the batch)."""
    b = {k: lay.rows(v, lay.data) for k, v in batch.items()}
    p = _params(params, lay)
    hist, target = _embed_pairs(p, (b["hist_items"], b["target_item"]),
                                (b["hist_cates"], b["target_cate"]), lay)
    interest = din_user_interest(p, hist, b["hist_mask"], target, cfg)
    tags = _tag_bag(p, b["profile_tags"], b["profile_mask"], lay)
    feat = torch.cat([interest, target, tags], dim=-1)
    return _mlp(p["mlp"], feat)[..., 0], b


def din_logits(params, batch, cfg: DINConfig, rules=None):
    from torch.distributed.tensor import DTensor

    B = batch["target_item"].shape[0]
    lay = _Layout(rules, B)
    logits, _ = _logits(params, batch, cfg, lay)
    if lay.mesh is None:
        return logits
    return DTensor.from_local(logits, lay.mesh,
                              lay.placements(rules, "batch", B),
                              run_check=False)


def din_loss(params, batch, cfg: DINConfig, rules=None):
    B = batch["target_item"].shape[0]
    lay = _Layout(rules, B)
    logits, b = _logits(params, batch, cfg, lay)
    logits = logits.float()
    y = b["labels"].float()
    # torch.maximum splits a tie's gradient as jnp.maximum does
    terms = (torch.maximum(logits, logits.new_zeros(())) - logits * y
             + torch.log1p(torch.exp(-logits.abs())))
    if not lay.data:
        return torch.mean(terms)
    return C.reduce(terms.sum(), lay.mesh, lay.data) / B


def din_retrieval_scores(params, batch, cfg: DINConfig, rules=None,
                         chunk: Optional[int] = 65536):
    """Score ONE user's history against n_candidates items.

    batch: hist_items/hist_cates/hist_mask [1, S]; cand_items i32[C];
    cand_cates i32[C]; profile_tags/profile_mask [1, W].  The history
    [S, 2d] is broadcast against ``chunk`` candidates at a time (None: all
    C at once, as the reference) → [chunk, S] weights; returns f[C] (on a
    mesh a DTensor over the candidates, each rank scoring its own)."""
    from torch.distributed.tensor import DTensor

    lay = _Layout(rules)
    p = _params(params, lay)
    cand_items = lay.rows(batch["cand_items"], lay.cand)
    cand_cates = lay.rows(batch["cand_cates"], lay.cand)
    hist_items, hist_cates, mask, tags_ids, tags_mask = (
        lay.rows(batch[k], ()) for k in ("hist_items", "hist_cates",
                                         "hist_mask", "profile_tags",
                                         "profile_mask"))
    (hist,) = _embed_pairs(p, (hist_items[0],), (hist_cates[0],), lay)
    (cand,) = _embed_pairs(p, (cand_items,), (cand_cates,), lay,
                           scattered=bool(lay.model))
    mask = mask[0]                                         # [S]
    tags = _tag_bag(p, tags_ids, tags_mask, lay)           # [1, d]
    S, D2 = hist.shape
    C_l = cand.shape[0]
    step = chunk or C_l
    scores = []
    for c0 in range(0, C_l, step):
        cc = cand[c0:c0 + step]
        c = cc.shape[0]
        h = hist[None].expand(c, S, D2)
        interest = din_user_interest(p, h, mask[None], cc, cfg)
        feat = torch.cat([interest, cc, tags.expand(c, tags.shape[-1])], -1)
        scores.append(_mlp(p["mlp"], feat)[..., 0])
    scores = torch.cat(scores)
    if lay.mesh is None:
        return scores
    C_all = batch["cand_items"].shape[0]
    return DTensor.from_local(scores, lay.mesh,
                              lay.placements(rules, "candidates", C_all),
                              run_check=False)


def params_from_numpy(tree, cfg: DINConfig, device="cuda"):
    """The reference's DIN parameter pytree (numpy arrays) as the port's,
    on ``device`` in ``cfg.dtype``."""
    return tree_from_numpy(tree, din_init(cfg, None, "meta"), device)
