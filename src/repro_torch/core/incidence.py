"""Incidence-operator primitives for the IRLS min-cut solver (torch).

The paper's objective is ``min ‖C B x‖₁`` (eq. 1) where ``B`` is the oriented
edge-node incidence matrix and ``C = diag(c)``.  ``B`` is never
materialized: on the device a graph is the triplet ``(src, dst, c)`` plus
terminal weights.  The voltage vector ``v`` covers only the n non-terminal
nodes, with the boundary condition x_s = 1, x_t = 0 folded in, so the edge
residual vector has three segments::

    z = [ c_e (v[src]-v[dst])   for non-terminal edges   ]
        [ c_su (1 - v[u])       for terminal s-edges      ]
        [ c_tu (v[u] - 0)       for terminal t-edges      ]

A batch of B same-topology instances shares ``src``/``dst`` and carries a
leading lane dimension on the weights and voltages: ``c`` (B, m), ``c_s``,
``c_t`` and ``v`` (B, n).  Every function here works on one instance or on
a batch, and the objectives return one value per lane.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class DeviceGraph(NamedTuple):
    """Device-resident s-t instance (see graphs.structures.STInstance).

    src, dst : int32[m]      non-terminal edge endpoints
    c        : f[m] or f[B, m]  non-terminal edge weights
    c_s, c_t : f[n] or f[B, n]  terminal edge weights to s / t (0 where absent)
    """

    src: torch.Tensor
    dst: torch.Tensor
    c: torch.Tensor
    c_s: torch.Tensor
    c_t: torch.Tensor

    @property
    def n(self) -> int:
        return self.c_s.shape[-1]

    @property
    def m(self) -> int:
        return self.src.shape[0]


def device_graph_from_instance(inst, dtype=torch.float32,
                               device="cuda") -> DeviceGraph:
    """Move a host STInstance onto ``device`` (int32 indices, as the JAX
    package and the edge-reweight kernel take them)."""
    def idx(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int32), device=device)

    def val(a):
        return torch.as_tensor(np.asarray(a), device=device).to(dtype)

    return DeviceGraph(src=idx(inst.graph.src), dst=idx(inst.graph.dst),
                       c=val(inst.graph.weight), c_s=val(inst.s_weight),
                       c_t=val(inst.t_weight))


def eps_sq(eps) -> float:
    """ε² rounded as float32 arithmetic rounds it: the solver squares ε in
    the working precision, and a Python float would square it in float64."""
    return float(np.float32(eps) * np.float32(eps))


def edge_residuals(g: DeviceGraph, v: torch.Tensor):
    """``C B x`` with the boundary condition folded in: (z_edges, z_s, z_t)."""
    z_edges = g.c * (v[..., g.src] - v[..., g.dst])
    z_s = g.c_s * (1.0 - v)
    z_t = g.c_t * v
    return z_edges, z_s, z_t


def smoothed_objective(g: DeviceGraph, v: torch.Tensor, eps: float) -> torch.Tensor:
    """S_ε(x) = Σ_e sqrt((CBx)_e² + ε²)  (eq. 9), full-graph edge sum (one
    value per lane).

    Terminal entries with zero capacity are excluded, so S_ε → ‖CBx‖₁ as
    ε → 0 on the actual edge set."""
    z_e, z_s, z_t = edge_residuals(g, v)
    e2 = eps_sq(eps)
    s = torch.sqrt(z_e * z_e + e2).sum(-1)
    zero = torch.zeros((), dtype=v.dtype, device=v.device)
    s = s + torch.where(g.c_s > 0, torch.sqrt(z_s * z_s + e2), zero).sum(-1)
    s = s + torch.where(g.c_t > 0, torch.sqrt(z_t * z_t + e2), zero).sum(-1)
    return s


def l1_objective(g: DeviceGraph, v: torch.Tensor) -> torch.Tensor:
    """Exact ‖C B x‖₁ (the fractional cut value of the embedding x), one
    value per lane."""
    z_e, z_s, z_t = edge_residuals(g, v)
    return z_e.abs().sum(-1) + z_s.abs().sum(-1) + z_t.abs().sum(-1)
