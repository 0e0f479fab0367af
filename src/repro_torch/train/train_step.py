"""Generic train/eval step builders shared by every architecture (PyTorch).

The port of ``repro/train/train_step.py``.  ``build_train_step(loss_fn,
opt_cfg)`` returns a function (params, opt_state, batch) → (params,
opt_state, metrics) that updates the parameters and moments in place, with
optional microbatch gradient accumulation (the batch split along its first
dim; the gradients summed in float32 buffers, as the reference's float32
zeros, then divided by the count).  With one microbatch the gradients keep
the parameters' dtype.  The gradients come from ``torch.autograd.grad``, so
nothing accumulates in ``.grad``; the parameters' ``requires_grad`` is
turned on for the step.  Metrics: ``loss``, ``grad_norm`` and ``lr`` as
0-dim float32 tensors on the device.

On sharded parameters (DTensors) the step is the same program on every
rank: the gradients come back as DTensors of the parameters' layout, and
a batch given as a DTensor over its rows is split into microbatches of
each rank's local rows (the loss is a mean over the whole batch either
way, so the rows' grouping into microbatches does not change it).
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.distributed.tensor import DTensor

from .optimizer import AdamWConfig, apply_updates, named_leaves


def _split(x, n: int):
    """x's n microbatches along its first dim (the reference's reshape to
    (n, b // n, ...)), as a list; a tree is split leaf by leaf, a DTensor
    by its local rows."""
    if isinstance(x, dict):
        parts = {k: _split(v, n) for k, v in x.items()}
        return [{k: parts[k][i] for k in x} for i in range(n)]
    if isinstance(x, DTensor):
        return [DTensor.from_local(part, x.device_mesh, x.placements,
                                   run_check=False)
                for part in _split(x.to_local(), n)]
    b = x.shape[0]
    if b % n:
        raise ValueError(f"batch {b} does not split into {n} microbatches")
    return list(torch.chunk(x, n, dim=0))


def build_train_step(loss_fn: Callable, opt_cfg: AdamWConfig,
                     n_microbatches: int = 1):
    """loss_fn(params, batch) → scalar loss tensor."""

    def grads_of(params, leaves, batch):
        loss = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, [p for _, p in leaves],
                                    allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for (_, p), g in zip(leaves, grads)]
        return loss.detach(), grads

    def step(params, opt_state, batch):
        leaves = named_leaves(params)
        for _, p in leaves:
            p.requires_grad_(True)
        if n_microbatches == 1:
            loss, grads = grads_of(params, leaves, batch)
        else:
            loss = None
            acc = [torch.zeros_like(p, dtype=torch.float32)
                   for _, p in leaves]
            for mb in _split(batch, n_microbatches):
                mb_loss, grads = grads_of(params, leaves, mb)
                loss = mb_loss if loss is None else loss + mb_loss
                for a, g in zip(acc, grads):
                    a.add_(g)
                del grads
            loss = loss / n_microbatches
            grads = [a / n_microbatches for a in acc]
            del acc
        params, opt_state, metrics = apply_updates(opt_cfg, params, grads,
                                                   opt_state)
        metrics = dict(metrics, loss=loss)
        return params, opt_state, metrics

    return step


def build_eval_step(loss_fn: Callable):
    def step(params, batch):
        with torch.no_grad():
            return loss_fn(params, batch)
    return step
