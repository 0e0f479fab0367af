"""Cheeger-type inequality diagnostics (paper Thm 2.7, eq. 11, eq. 14).

λ₂ of the pencil (L, D) — with d(s)=d(t)=C (twice total edge weight), 0
elsewhere — satisfies  φ²/2 ≤ λ₂ ≤ 2φ  where φ = mincut/C.

Prop A.1 characterizes λ₂ as the optimal value of the WLS problem

    min  (1/2C) xᵀ L x   s.t.  x_s = 1, x_t = −1

which is the same reduced-Laplacian solve as the IRLS step with the ORIGINAL
weights and ±1 boundary encoding; the port's PCG solves it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .incidence import DeviceGraph
from .laplacian import initial_weights, matvec_coo
from .pcg import pcg


class CheegerEstimate(NamedTuple):
    lam2: torch.Tensor        # second generalized eigenvalue of (L, D)
    g_voltage: torch.Tensor   # the optimizing voltage vector (±1 boundary)
    lower_phi: torch.Tensor   # lower bound on φ implied by λ₂: λ₂/2 ≤ φ
    upper_phi: torch.Tensor   # upper bound on φ implied by λ₂: φ ≤ sqrt(2 λ₂)


def cheeger_lambda2(g: DeviceGraph, tol: float = 1e-6,
                    max_iters: int = 2000) -> CheegerEstimate:
    """Solve eq. (14) and evaluate λ₂ = xᵀLx / (2C).

    With x_s=1, x_t=−1 the reduced system becomes L̃ v = r_s·1 + r_t·(−1)
    where the conductances are the ORIGINAL weights (eq. 14 has no
    reweighting: plain L)."""
    rw = initial_weights(g)
    b = g.c_s - g.c_t
    res = pcg(lambda v: matvec_coo(g, rw, v), b,
              precond=lambda x: x / rw.diag, tol=tol, max_iters=max_iters)
    v = res.x
    # xᵀ L x over the full graph with boundary (+1, −1)
    de = v[g.src] - v[g.dst]
    quad = ((g.c * de * de).sum() + (g.c_s * (1.0 - v) ** 2).sum()
            + (g.c_t * (v + 1.0) ** 2).sum())
    C = 2.0 * (g.c.sum() + g.c_s.sum() + g.c_t.sum())
    lam2 = quad / (2.0 * C)
    return CheegerEstimate(lam2=lam2, g_voltage=v, lower_phi=lam2 / 2.0,
                           upper_phi=torch.sqrt(2.0 * lam2))


def phi_of_cut(cut_value: float, total_weight_C: float) -> float:
    """φ(S) for an s-t cut: vol(S)=vol(S̄)=C (only s,t carry d-weight), so
    φ = cut/C."""
    return float(cut_value) / float(total_weight_C)
