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


class Segments(NamedTuple):
    """A fixed-order segmented sum over the edges, per endpoint node.

    ``perm`` lists edge ids grouped by node (a stable sort, so each node's
    run is in the order the edges are listed) and ``offsets`` (n + 1
    entries) bounds each node's run in it, so ``segment_sum`` adds every
    node's edges in one order: the same on every run, on every device, and
    for every lane of a batch (no atomics)."""

    perm: torch.Tensor      # int64[len]: edge ids
    offsets: torch.Tensor   # int64[n + 1]


class CooPlan(NamedTuple):
    """Per-topology plan of the COO scatters: the edges grouped by ``src``
    and by ``dst`` (the two sums of ``laplacian.matvec_coo``), and the 2m
    edge ends ``[src, dst]`` grouped by node (the degree sums and the sweep
    rounding), with each end's side."""

    by_src: Segments
    by_dst: Segments
    by_end: Segments        # perm: the edge id of each end
    end_sign: torch.Tensor  # int8[2m] in by_end order: +1 src end, -1 dst end


def segments(keys: torch.Tensor, n: int) -> Segments:
    """The ``Segments`` of ``keys`` (node ids in [0, n)), on their device
    (no host sync: the offsets are searched, not counted)."""
    ordered, perm = torch.sort(keys.to(torch.int64), stable=True)
    offsets = torch.searchsorted(
        ordered, torch.arange(n + 1, dtype=torch.int64, device=keys.device))
    return Segments(perm=perm, offsets=offsets)


def reduce_segments(offsets: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-node sums of ``x``, already in segment order along its last
    dimension.  ``unsafe`` skips ``segment_reduce``'s checks of the
    offsets, which wait on the card; a plan is valid by construction."""
    off = offsets.expand(x.shape[:-1] + offsets.shape)
    return torch.segment_reduce(x, "sum", offsets=off, axis=x.dim() - 1,
                                unsafe=True)


def segment_sum(seg: Segments, x: torch.Tensor) -> torch.Tensor:
    """Per-node sums of ``x`` (its last dimension indexed by edge) in the
    fixed order of ``seg``: shape ``x.shape[:-1] + (n,)``.  On the CPU the
    bits are those of ``index_add_`` (edge order as well)."""
    return reduce_segments(seg.offsets, x[..., seg.perm])


def segment_sum_rows(seg: Segments, x: torch.Tensor) -> torch.Tensor:
    """The row-wise twin of ``segment_sum``: per-node sums of the rows of
    ``x`` (its first dimension indexed by edge) in the fixed order of
    ``seg``, shape ``(n,) + x.shape[1:]``.  On the CPU the bits are those
    of ``index_add_`` along dim 0."""
    return torch.segment_reduce(x[seg.perm], "sum", offsets=seg.offsets,
                                axis=0, unsafe=True)


def coo_plan(src: torch.Tensor, dst: torch.Tensor, n: int) -> CooPlan:
    """The ``CooPlan`` of a topology, built once on the device of its
    index arrays (stable sorts, deterministic on every device)."""
    m = src.shape[0]
    ends = segments(torch.cat([src, dst]), n)
    return CooPlan(by_src=segments(src, n), by_dst=segments(dst, n),
                   by_end=Segments(perm=ends.perm % m, offsets=ends.offsets),
                   end_sign=torch.where(ends.perm < m, 1, -1).to(torch.int8))


class DeviceGraph(NamedTuple):
    """Device-resident s-t instance (see graphs.structures.STInstance).

    src, dst : int32[m]      non-terminal edge endpoints
    c        : f[m] or f[B, m]  non-terminal edge weights
    c_s, c_t : f[n] or f[B, n]  terminal edge weights to s / t (0 where absent)
    coo      : the topology's ``CooPlan``
    """

    src: torch.Tensor
    dst: torch.Tensor
    c: torch.Tensor
    c_s: torch.Tensor
    c_t: torch.Tensor
    coo: CooPlan

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

    src, dst = idx(inst.graph.src), idx(inst.graph.dst)
    return DeviceGraph(src=src, dst=dst, c=val(inst.graph.weight),
                       c_s=val(inst.s_weight), c_t=val(inst.t_weight),
                       coo=coo_plan(src, dst, inst.n))


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
