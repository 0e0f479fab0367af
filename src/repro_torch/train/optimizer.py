"""AdamW + gradient clipping, written by hand (PyTorch).

The port of ``repro/train/optimizer.py``, with its semantics kept exactly
(``torch.optim.AdamW`` differs): the warm-up reads the count before the
step's increment, the bias corrections use the incremented count, decay is
decoupled and applied to leaves with ndim ≥ 2 only (the stacked norms
(L, D) are such leaves, as in the reference), the clip factor is cast to
each gradient's dtype before the multiply (inside the update: the caller's
gradients are not copied or written), and the moments are stored in
``moments_dtype``.  A leaf of more than ``SLICE_ENTRIES`` entries is
updated in row slices, with the same bits.  Parameters and moments are
updated in place under ``torch.no_grad()``; the count and the metrics stay
on the parameters' device (no host sync).

A tree is the reference's pytree: nested dicts (leaves in sorted key order,
as ``jax.tree.leaves`` walks them), lists and tuples of tensors.  Leaves
may be DTensors (``models/transformer.shard_params``): the moments take
each parameter's placements (the reference's ZeRO-sharded state), the
update runs on each rank's local blocks, and the clip's global norm sums
each leaf's squares over its shards, a replicated leaf counted once.  The
error-feedback int8 compression (``compress_grads``) is the reference's
``_compress_ef``.  ``state_from_numpy`` carries the reference's parameters
and AdamW state over.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from ..models.sharding import whole
from ..models.transformer import as_torch_dtype, params_from_numpy
from .checkpoint import named_leaves, to_tensor, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: Optional[float] = 1.0
    moments_dtype: Any = torch.float32   # a torch, numpy or JAX dtype, or name
    warmup_steps: int = 100
    compress_grads: bool = False      # error-feedback int8

    def __post_init__(self):
        object.__setattr__(self, "moments_dtype",
                           as_torch_dtype(self.moments_dtype))


def init_state(cfg: AdamWConfig, tree) -> Dict:
    """Zero moments in ``moments_dtype`` shaped as the parameters' tree,
    the count (int32, 0-dim) on their device, and under ``compress_grads``
    a float32 residual per leaf."""
    zeros = lambda p: torch.zeros_like(p, dtype=cfg.moments_dtype)
    dev = named_leaves(tree)[0][1].device
    state = {"m": tree_map(zeros, tree), "v": tree_map(zeros, tree),
             "count": torch.zeros((), dtype=torch.int32, device=dev)}
    if cfg.compress_grads:
        state["ef_residual"] = tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.float32), tree)
    return state


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local block (the tensor the DTensor holds: in-place
    updates reach it), a plain tensor itself."""
    return t.to_local() if isinstance(t, DTensor) else t


def _global_norm(tree) -> torch.Tensor:
    """√(Σ_leaves Σ x²) in float32, the leaves summed in ``named_leaves``
    order (sorted keys), as the reference's Python ``sum`` over
    ``jax.tree.leaves``.  A DTensor leaf's sum is reduced over the mesh
    dims it is sharded on (its partial sums), not over those it is
    replicated on."""
    total = None
    for _, x in named_leaves(tree):
        s = whole(x.float().square().sum())
        total = s if total is None else total + s
    return torch.sqrt(total)


def _compress_ef(g: torch.Tensor, resid: torch.Tensor):
    """int8 quantize with error feedback: g' = deq(q(g + resid));
    new_resid = (g + resid) − g'."""
    x = g.float() + resid
    scale = x.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return deq, x - deq


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (the count before the increment):
    linear warm-up over ``warmup_steps``, float32."""
    warm = torch.clamp((step + 1).float() / max(1, cfg.warmup_steps), max=1.0)
    return cfg.lr * warm


# a leaf of more entries than this is updated in row slices of at most
# this many entries, so that the update's float32 temporaries (the scaled
# gradient, m32, v32, the step and the new value) take the slice's bytes,
# not the leaf's (DIN's 1.8e9-entry item table would take ~7.2 GB each)
SLICE_ENTRIES = 1 << 26


def _row_slices(t: torch.Tensor, limit: int):
    """Row ranges of ``t`` (along dim 0) of at most ``limit`` entries each
    (one row at least); the whole tensor when it fits or has no rows."""
    if t.dim() == 0 or t.numel() <= limit:
        return [...]
    rows = max(1, limit // max(1, t[0].numel()))
    return [slice(i, i + rows) for i in range(0, t.shape[0], rows)]


def apply_updates(cfg: AdamWConfig, params, grads, state):
    """One AdamW step, in place.  ``grads``: a tree shaped as ``params``'
    (or the list of its leaves in ``named_leaves`` order); it is read, not
    written.  Returns (params, state, metrics) with ``grad_norm`` and
    ``lr`` as 0-dim float32 tensors on the device.

    The clip factor is applied inside the update, a slice at a time, and a
    leaf above ``SLICE_ENTRIES`` is updated in row slices through the same
    elementwise expressions: the same bits as one update of the whole
    leaf, with temporaries bounded by the slice."""
    ps = [p for _, p in named_leaves(params)]
    gs = [g for _, g in named_leaves(grads)]
    metrics = {}
    with torch.no_grad():
        count = state["count"] + 1
        if cfg.compress_grads:
            resid = [r for _, r in named_leaves(state["ef_residual"])]
            pairs = [_compress_ef(g, r) for g, r in zip(gs, resid)]
            gs = [deq for deq, _ in pairs]
            for r, (_, new_r) in zip(resid, pairs):
                r.copy_(new_r)
            del pairs

        gnorm = _global_norm(gs)
        metrics["grad_norm"] = gnorm
        scale = None
        if cfg.clip_norm is not None:
            scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)

        lr = lr_at(cfg, state["count"])
        metrics["lr"] = lr
        ps, gs = [_local(p) for p in ps], [_local(g) for g in gs]
        b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, device=count.device),
                              count.float())
        b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, device=count.device),
                              count.float())
        for p, g, (_, m), (_, v) in zip(ps, gs, named_leaves(state["m"]),
                                        named_leaves(state["v"])):
            m, v = _local(m), _local(v)
            decay = p.dim() >= 2      # decoupled weight decay on matrices only
            g_scale = None if scale is None else scale.to(g.dtype)
            for rows in _row_slices(p, SLICE_ENTRIES):
                ps_, gs_, ms_, vs_ = p[rows], g[rows], m[rows], v[rows]
                if g_scale is not None:
                    gs_ = gs_ * g_scale
                g32 = gs_.float()
                m32 = ms_.float() * cfg.b1 + g32 * (1 - cfg.b1)
                v32 = vs_.float() * cfg.b2 + g32 * g32 * (1 - cfg.b2)
                del gs_, g32
                step_ = (m32 / b1c) / (torch.sqrt(v32 / b2c) + cfg.eps)
                if decay:
                    step_ = step_ + cfg.weight_decay * ps_.float()
                ps_.copy_((ps_.float() - lr * step_).to(p.dtype))
                del step_
                ms_.copy_(m32.to(cfg.moments_dtype))
                vs_.copy_(v32.to(cfg.moments_dtype))
        state["count"].copy_(count)
    return params, state, metrics


def state_from_numpy(params_tree, opt_state_tree, cfg, device="cuda"):
    """The reference's (params, opt_state) pytrees of numpy arrays (e.g.
    ``jax.tree.map(np.asarray, ...)``) as the port's: the parameters
    through ``params_from_numpy`` (``cfg`` the ``LMConfig``) as a
    ``Transformer``'s ``tree()``, the AdamW state (``m``, ``v``, ``count``, and
    ``ef_residual`` under ``compress_grads``) as a tree of tensors of the
    same dtypes and bits on ``device``."""
    params = params_from_numpy(params_tree, cfg, device=device).tree()
    state = tree_map(lambda a: to_tensor(np.array(a), device), opt_state_tree)
    state["count"] = state["count"].to(torch.int32)
    return params, state
