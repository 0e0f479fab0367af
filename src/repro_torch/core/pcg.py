"""Preconditioned conjugate gradients on the reduced Laplacian (paper §3.1).

Supports warm starts, the relative-residual stop (‖r‖/‖b‖ ≤ tol), a hard
iteration cap and a residual history.  The stopping test runs on squared
norms, ``‖r‖² ≤ tol²·‖b‖²``, so a step costs one extra reduction and no
square root.

Three variants share one update rule:

* ``pcg``             — tolerance + cap (the host driver's solver).
* ``pcg_masked``      — the same loop with every update gated on the
  instance's own ``active`` flag; with a single instance its iterates equal
  ``pcg``'s.  ``tol=inf`` exits at entry (how a finished instance is
  parked).
* ``pcg_fixed_iters`` — a fixed number of steps, no stopping test.

The loops run on the host: each step of ``pcg`` and ``pcg_masked`` reads
the squared residual back with ``.item()`` to decide whether to go on, so
the iteration counts equal the JAX package's ``lax.while_loop`` counts.
That is one device-to-host synchronisation per CG step.

The matvec, the preconditioner and the inner products are closures
(``dot``/``dot2``, default ``lane_dot``), so the same loops serve the ELL
kernels, the COO layout and dense oracles.  ``dot2(r, z) → (r·z, r·r)``
lets a caller fuse both reductions of a step into one.  ``step_scope``
(default none) is a context manager factory entered around each CG step of
``pcg_masked`` and ``pcg_fixed_iters``: the sharded solver counts the
collectives of a step under it (``distributed.collectives``).

Batches: ``pcg_masked`` and ``pcg_fixed_iters`` also take a batch of B
independent systems, with ``b`` and the iterates of shape (B, n) and every
scalar of the recurrence (B,).  This is the batched program the JAX package
gets from ``jax.vmap``.  ``pcg_masked`` then counts iterations per lane and
runs until no lane is active: a lane whose residual is below its own
tolerance takes no further step (its updates are masked), so it is frozen
while the others go on, and ``tol`` may be a (B,) tensor.  The stopping test
reads one bool per CG step for the whole batch.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch


class PCGResult(NamedTuple):
    x: torch.Tensor          # solution
    iters: int               # iterations taken
    rel_res: torch.Tensor    # final relative residual (0-d)
    history: torch.Tensor    # f[max_iters+1] residual norms (NaN-padded)


def lane_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inner product over the last dimension: one value per lane.  Each
    lane is its own ``torch.dot``, so its value does not depend on how many
    lanes share the batch: a co-batched lane and the same system solved
    alone take the same steps (bit for bit, where the matvec's scatters are
    deterministic too)."""
    if a.dim() == 1:
        return torch.dot(a, b)
    return torch.stack([torch.dot(x, y) for x, y in zip(a, b)])


def _resolve_dots(dot, dot2):
    if dot is None:
        dot = lane_dot
    if dot2 is None:
        def dot2(r, z, _dot=dot):
            return _dot(r, z), _dot(r, r)
    return dot, dot2


def _nonzero(x: torch.Tensor) -> torch.Tensor:
    """``x`` where it is non-zero, else 1 (the divide-by-zero guards)."""
    return torch.where(x != 0, x, torch.ones_like(x))


def _tol2(tol, bb: torch.Tensor) -> torch.Tensor:
    """tol²·‖b‖², with tol squared in float32 as the solver's dtype squares
    it.  ``tol`` is a host scalar (no transfer to the device) or a tensor of
    per-lane tolerances."""
    if isinstance(tol, torch.Tensor):
        t = tol.to(device=bb.device, dtype=bb.dtype)
        return t * t * bb
    return float(np.float32(tol) * np.float32(tol)) * bb


def pcg(matvec: Callable[[torch.Tensor], torch.Tensor],
        b: torch.Tensor,
        x0: Optional[torch.Tensor] = None,
        precond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        tol: float = 1e-3,
        max_iters: int = 300,
        record_history: bool = False) -> PCGResult:
    """Solve ``A x = b`` with A SPD given through ``matvec``.

    ``precond`` applies M⁻¹ (identity when None); ``x0`` warm-starts."""
    if precond is None:
        precond = lambda r: r
    x = torch.zeros_like(b) if x0 is None else x0

    bb = torch.dot(b, b)
    # guard: b == 0 ⇒ x = 0 is exact; avoid dividing by zero
    bb = torch.where(bb > 0, bb, torch.ones_like(bb))
    tol2 = _tol2(tol, bb)

    r = b - matvec(x)
    z = precond(r)
    p = z
    rz = torch.dot(r, z)
    rr = torch.dot(r, r)

    hist_len = max_iters + 1 if record_history else 1
    history = torch.full((hist_len,), math.nan, dtype=b.dtype, device=b.device)
    history[0] = torch.sqrt(rr / bb)

    it = 0
    while it < max_iters and bool(rr > tol2):
        Ap = matvec(p)
        pAp = torch.dot(p, Ap)
        alpha = rz / _nonzero(pAp)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = torch.dot(r, z)
        beta = rz_new / _nonzero(rz)
        p = z + beta * p
        rz = rz_new
        rr = torch.dot(r, r)
        it += 1
        if record_history:
            history[it] = torch.sqrt(rr / bb)
    return PCGResult(x=x, iters=it, rel_res=torch.sqrt(rr / bb),
                     history=history)


def pcg_masked(matvec, b, x0=None, precond=None, tol=1e-3,
               max_iters: int = 50, dot=None, dot2=None,
               step_scope=contextlib.nullcontext,
               planned: bool = False) -> PCGResult:
    """PCG with early exit and explicitly masked updates (no history).

    Same update rule as ``pcg``; every state update is gated on the lane's
    own ``active = rr > tol²·‖b‖²``, so a converged lane's (x, r, p) are
    frozen.  ``tol`` may be ``inf`` (per lane, too): zero iterations, ``x0``
    untouched.  ``iters`` is an int32 tensor of per-lane counts (0-d for a
    single system).  ``planned`` (a planning run on fake tensors, which
    cannot read the stop test on the host): all ``max_iters`` steps run,
    each with its masked updates."""
    if precond is None:
        precond = lambda r: r
    dot, dot2 = _resolve_dots(dot, dot2)
    x = torch.zeros_like(b) if x0 is None else x0

    bb = dot(b, b)
    bb = torch.where(bb > 0, bb, torch.ones_like(bb))
    tol2 = _tol2(tol, bb)

    r = b - matvec(x)
    z = precond(r)
    p = z
    rz, rr = dot2(r, z)

    it = torch.zeros(rr.shape, dtype=torch.int32, device=rr.device)
    zero = torch.zeros_like(bb)
    step = 0
    # every lane still active has taken every step so far, so the shared
    # step count is the cap of each lane's own count
    while step < max_iters and (planned or bool((rr > tol2).any())):
        with step_scope():
            active = rr > tol2
            Ap = matvec(p)
            pAp = dot(p, Ap)
            alpha = torch.where(active, rz / _nonzero(pAp), zero)
            x = x + alpha[..., None] * p
            r = r - alpha[..., None] * Ap
            z = precond(r)
            rz_new, rr_new = dot2(r, z)
            beta = rz_new / _nonzero(rz)
            p = torch.where(active[..., None], z + beta[..., None] * p, p)
            rz = torch.where(active, rz_new, rz)
            rr = torch.where(active, rr_new, rr)
            it = it + active.to(torch.int32)
        step += 1
    return PCGResult(x=x, iters=it, rel_res=torch.sqrt(rr / bb),
                     history=torch.zeros((1,), dtype=b.dtype, device=b.device))


def pcg_fixed_iters(matvec, b, x0=None, precond=None, n_iters: int = 50,
                    record_history: bool = True, dot=None, dot2=None,
                    step_scope=contextlib.nullcontext):
    """PCG with a fixed iteration count (no stopping test, no host sync).
    ``record_history=False`` drops the per-step residual-norm reduction.
    On a batch, ``rel_res`` holds one value per lane and ``history`` is
    (n_iters, B)."""
    if precond is None:
        precond = lambda r: r
    dot, dot2 = _resolve_dots(dot, dot2)
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    z = precond(r)
    p = z
    rz = dot(r, z)
    res_hist = []
    for _ in range(n_iters):
        with step_scope():
            Ap = matvec(p)
            pAp = dot(p, Ap)
            alpha = rz / _nonzero(pAp)
            x = x + alpha[..., None] * p
            r = r - alpha[..., None] * Ap
            z = precond(r)
            if record_history:
                rz_new, rr = dot2(r, z)
                res_hist.append(torch.sqrt(torch.clamp(rr, min=0.0)))
            else:
                rz_new = dot(r, z)
            beta = rz_new / _nonzero(rz)
            p = z + beta[..., None] * p
            rz = rz_new
    bb = dot(b, b)
    b_norm = torch.sqrt(torch.clamp(bb, min=0.0))
    b_norm = torch.where(b_norm > 0, b_norm, torch.ones_like(b_norm))
    rr_fin = dot(r, r)
    if record_history:
        history = (torch.stack(res_hist) if res_hist
                   else torch.zeros((0,), dtype=b.dtype, device=b.device)) / b_norm
    else:
        history = torch.zeros((1,), dtype=b.dtype, device=b.device)
    return PCGResult(x=x, iters=n_iters,
                     rel_res=torch.sqrt(torch.clamp(rr_fin, min=0.0)) / b_norm,
                     history=history)
