"""Electrical-flow view of the WLS solve (paper Prop. 2.3), in torch.

Each IRLS WLS step computes an electrical flow ``z = C W⁻¹ C B x`` whose flow
value is ``xᵀ L x``.  These helpers expose that view for diagnostics and for
the property tests (flow conservation at non-terminal nodes, flow value).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .incidence import DeviceGraph
from .laplacian import Reweighted


class ElectricalFlow(NamedTuple):
    flow_e: torch.Tensor   # flow along non-terminal edges (orientation src->dst)
    flow_s: torch.Tensor   # flow along s->u terminal edges
    flow_t: torch.Tensor   # flow along u->t terminal edges
    value: torch.Tensor    # flow value μ(z) = xᵀ L x


def electrical_flow(g: DeviceGraph, rw: Reweighted,
                    v: torch.Tensor) -> ElectricalFlow:
    """z = C W⁻¹ C B x expressed through the reweighted conductances:
    per-edge flow = r_e · (potential difference).  The flow value is the
    source outflow μ = Σ_u flow_s(u), which equals xᵀLx over the full graph
    (the reduced quadratic form plus the terminal boundary terms)."""
    flow_e = rw.r * (v[g.src] - v[g.dst])
    flow_s = rw.r_s * (1.0 - v)       # s is at potential 1
    flow_t = rw.r_t * v               # t is at potential 0
    return ElectricalFlow(flow_e=flow_e, flow_s=flow_s, flow_t=flow_t,
                          value=flow_s.sum())


def conservation_residual(g: DeviceGraph, fl: ElectricalFlow) -> torch.Tensor:
    """Net flow into each non-terminal node (~0 at the WLS solution:
    Kirchhoff's current law, the `Bᵀ z = −Φᵀλ` identity of Prop 2.3)."""
    net = torch.zeros(g.n, dtype=fl.flow_e.dtype, device=fl.flow_e.device)
    net.index_add_(0, g.dst, fl.flow_e)
    net.index_add_(0, g.src, -fl.flow_e)
    return net + fl.flow_s - fl.flow_t


def flow_value_quadratic(g: DeviceGraph, rw: Reweighted,
                         v: torch.Tensor) -> torch.Tensor:
    """μ(z) = xᵀ L x over the FULL graph (Prop 2.3), computed from the
    residual form: Σ_e r_e (Δx_e)² including terminal edges."""
    de = v[g.src] - v[g.dst]
    return ((rw.r * de * de).sum() + (rw.r_s * (1.0 - v) ** 2).sum()
            + (rw.r_t * v * v).sum())
