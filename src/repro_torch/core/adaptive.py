"""IRLS adaptive-schedule state machine (early exit).

* **outer convergence** — the relative change of the fractional cut value
  ``‖CBx‖₁`` must stay below ``cfg.irls_tol`` for ``cfg.irls_patience``
  consecutive iterations, and a reading only counts when the inner system
  was solved (residual at the tight tolerance, or the iteration cap hit).
* **inner tolerance** (``cfg.adaptive_tol``) — Eisenstat–Walker style:
  ``0.5 × change`` clipped to ``[tight, cfg.pcg_loose_tol]`` and monotone
  non-increasing.
* **freezing** — once ``done``, the next inner tolerance is ∞ (the masked
  PCG exits at entry).

The host driver reads one fractional cut, residual and iteration count per
IRLS iteration, so its state lives on the CPU as 0-d float32 tensors: the
same float32 arithmetic as the JAX package's state machine, with no device
round trip.  The scanned driver keeps one state per lane of its batch, as
(B,) tensors on the batch's device, where the JAX package vmaps the same
elementwise code.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class AdaptiveState(NamedTuple):
    """Early-exit state carried across IRLS iterations (0-d CPU tensors on
    the host driver, (B,) tensors per lane on the scanned driver).

    frac  : f32   last fractional-cut reading ‖CBx‖₁
    tol   : f32   current inner (PCG) tolerance
    small : i32   consecutive sub-``irls_tol`` qualified readings
    done  : bool  converged — freeze the instance from here on
    """

    frac: torch.Tensor
    tol: torch.Tensor
    small: torch.Tensor
    done: torch.Tensor


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def is_adaptive(cfg) -> bool:
    """Does this config run the convergence-masked (early-exit) schedule?"""
    return cfg.irls_tol > 0.0 or cfg.adaptive_tol


def initial_tol(cfg, tight: float) -> float:
    """First inner tolerance: loose under ``adaptive_tol``, else ``tight``."""
    return cfg.pcg_loose_tol if cfg.adaptive_tol else tight


def init_state(cfg, frac0, tight: float) -> AdaptiveState:
    """State after the initial WLS solve produced ``frac0 = ‖CBx⁰‖₁`` (a
    host scalar, or one reading per lane)."""
    frac = _f32(frac0)
    return AdaptiveState(frac=frac,
                         tol=torch.full_like(frac, initial_tol(cfg, tight)),
                         small=torch.zeros_like(frac, dtype=torch.int32),
                         done=torch.zeros_like(frac, dtype=torch.bool))


def inner_tol(state: AdaptiveState) -> torch.Tensor:
    """Tolerance for the NEXT inner solve: ∞ once done (a no-op solve)."""
    return torch.where(state.done, torch.full_like(state.tol, float("inf")),
                       state.tol)


def advance(cfg, state: AdaptiveState, frac, rel_res, iters,
            tight: float) -> AdaptiveState:
    """Fold one finished IRLS iteration into the state.

    ``frac`` is ‖CBx‖₁ of the post-iteration voltages, ``rel_res``/``iters``
    the inner solve's final relative residual and iteration count."""
    frac = _f32(frac)
    rel_res = _f32(rel_res)
    iters = torch.as_tensor(iters, dtype=torch.int32)
    change = ((frac - state.frac).abs()
              / torch.clamp(state.frac.abs(), min=1e-30))
    if cfg.adaptive_tol:
        # Eisenstat–Walker, monotone: never loosen back — a productive step
        # must not turn the next one into a no-op
        tol_next = torch.minimum(state.tol, torch.clamp(
            0.5 * change, min=tight, max=cfg.pcg_loose_tol))
        tol_next = torch.where(state.done, state.tol, tol_next)
    else:
        tol_next = state.tol
    if cfg.irls_tol > 0.0:
        solved = (rel_res <= tight * 1.001) | (iters >= cfg.pcg_max_iters)
        qual = (change <= cfg.irls_tol) & solved
        small_new = torch.where(state.done, state.small,
                                torch.where(qual, state.small + 1,
                                            torch.zeros_like(state.small)))
        done_new = state.done | (small_new >= cfg.irls_patience)
    else:
        small_new = state.small
        done_new = state.done
    frac_new = torch.where(state.done, state.frac, frac)
    return AdaptiveState(frac=frac_new, tol=tol_next, small=small_new,
                         done=done_new)
