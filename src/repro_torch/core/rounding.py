"""Rounding procedures: sweep cut and the two-level procedure (paper §3.4).

* ``sweep_cut`` — sort nodes by voltage, evaluate every prefix cut with
  difference arrays (O(m + n log n)), return the best threshold.  Runs in
  torch on the device.
* ``two_level`` — the paper's contribution: exploit node voltage
  polarization.  2-means (centers initialized at 0.1/0.9) on x^(T) picks
  γ₀ = c₀ + 0.05 and γ₁ = c₁ − 0.05; nodes with x ≤ γ₀ are contracted into
  the sink, x ≥ γ₁ into the source, the small coarse graph is solved exactly
  (core/maxflow.py) and the cut is lifted back.  Host numpy.

Both return a boolean indicator over non-terminal nodes (True = source side)
plus the cut value, recomputed in float64 on the host.  Procedures resolve
through ``REGISTRY`` (name → ``(instance, voltages, **kw) →
RoundingResult``); every rounder takes ``device=``.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch

from ..graphs.structures import EdgeList, STInstance
from .incidence import CooPlan, coo_plan, reduce_segments


class RoundingResult(NamedTuple):
    in_source: np.ndarray   # bool[n]
    cut_value: float
    meta: dict


Rounder = Callable[..., "RoundingResult"]

REGISTRY: Dict[str, Rounder] = {}


def register(name: str):
    """Register a rounding procedure under ``rounding == name``."""
    def deco(fn: Rounder) -> Rounder:
        REGISTRY[name] = fn
        return fn
    return deco


def round_voltages(name: str, instance, v, **kw) -> "RoundingResult":
    """Resolve ``name`` through REGISTRY and round the voltage vector."""
    try:
        rounder = REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown rounding {name!r}; "
                         f"registered: {sorted(REGISTRY)}") from None
    return rounder(instance, v, **kw)


# ---------------------------------------------------------------------------
# Sweep cut
# ---------------------------------------------------------------------------

def sweep_cut_torch(src, dst, w, s_w, t_w, v, coo: CooPlan):
    """All-prefix cut evaluation on the device of ``v``.

    Sort nodes by voltage DESCENDING; prefix i (1..n) puts the top-i nodes
    on the source side.  An internal edge (u,x) crosses for
    i in [min(r_u,r_x)+1, max(r_u,r_x)]; a terminal s-edge crosses while u
    is outside, a terminal t-edge while u is inside.  Difference arrays +
    cumsum give cut(i) for every i in one pass.  ``coo`` is the topology's
    ``incidence.CooPlan``.  Returns (in_source, cut).
    """
    n = v.shape[0]
    order = torch.argsort(-v, stable=True)      # order[i] = node at rank i
    rank = torch.empty(n, dtype=torch.int64, device=v.device)
    rank[order] = torch.arange(n, device=v.device)
    # diff over prefix index i in [1..n]; slot j holds the cut at i = j+1.
    # Node u enters at i = rank[u]+1: each of its edges starts crossing
    # there (+w) if its other end ranks later, else stops (-w); its s-edge
    # stops and its t-edge starts.  Each node's ends are summed in the
    # plan's fixed order (no atomics, so the chosen prefix is the same on
    # every run) and land in u's own slot (rank is a permutation)
    t = w * torch.sign(rank[dst] - rank[src]).to(w.dtype)
    per_node = reduce_segments(coo.by_end.offsets,
                               t[coo.by_end.perm] * coo.end_sign)
    d = torch.empty_like(per_node)
    d[rank] = per_node - s_w + t_w
    base = s_w.sum()              # cut at i = 0: all s-edges cross
    cuts = base + torch.cumsum(d, dim=0)
    # every prefix i ∈ [0, n] is a valid s-t cut (i = 0 is `base`)
    best = torch.argmin(cuts)
    best_val = cuts[best]
    use0 = base < best_val
    in_source = rank <= torch.where(use0, torch.full_like(best, -1), best)
    return in_source, torch.where(use0, base, best_val)


#: the last few topologies rounded: (src, dst, device) → their index
#: tensors and ``CooPlan``, so a served topology sorts its edges once
_TOPOLOGIES: "OrderedDict" = OrderedDict()
_TOPOLOGIES_LOCK = threading.Lock()
_TOPOLOGIES_KEPT = 4


def _topology(g: EdgeList, device):
    """``g``'s index tensors and plan on ``device``, cached by the identity
    of its index arrays (``Problem.instance_with`` shares them between the
    requests of one topology)."""
    key = (id(g.src), id(g.dst), str(device))
    with _TOPOLOGIES_LOCK:
        hit = _TOPOLOGIES.get(key)
        if hit is not None and hit[0] is g.src and hit[1] is g.dst:
            _TOPOLOGIES.move_to_end(key)
            return hit[2]
    src = torch.as_tensor(np.asarray(g.src, dtype=np.int64), device=device)
    dst = torch.as_tensor(np.asarray(g.dst, dtype=np.int64), device=device)
    topo = (src, dst, coo_plan(src, dst, g.n))
    with _TOPOLOGIES_LOCK:
        _TOPOLOGIES[key] = (g.src, g.dst, topo)
        _TOPOLOGIES.move_to_end(key)
        while len(_TOPOLOGIES) > _TOPOLOGIES_KEPT:
            _TOPOLOGIES.popitem(last=False)
    return topo


@register("sweep")
def sweep_cut(instance: STInstance, v: np.ndarray,
              device="cuda") -> RoundingResult:
    g = instance.graph
    src, dst, coo = _topology(g, device)

    def val(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)

    ind, _ = sweep_cut_torch(src, dst, val(g.weight), val(instance.s_weight),
                             val(instance.t_weight), val(v), coo)
    ind = ind.cpu().numpy()
    exact = instance.cut_value(ind)   # recompute in f64 on host
    return RoundingResult(in_source=ind, cut_value=exact,
                          meta={"method": "sweep"})


# ---------------------------------------------------------------------------
# Two-level rounding
# ---------------------------------------------------------------------------

def kmeans_thresholds(v: np.ndarray, n_iters: int = 25,
                      margin: float = 0.05) -> Tuple[float, float]:
    """2-means on the voltages, centers initialized at 0.1 / 0.9 (paper
    §3.4); γ₀ = c₀ + margin, γ₁ = c₁ − margin."""
    c0, c1 = 0.1, 0.9
    for _ in range(n_iters):
        assign1 = np.abs(v - c1) < np.abs(v - c0)
        if assign1.any():
            c1 = float(v[assign1].mean())
        if (~assign1).any():
            c0 = float(v[~assign1].mean())
    if c0 > c1:
        c0, c1 = c1, c0
    return c0 + margin, c1 - margin


def coarsen(instance: STInstance, v: np.ndarray, gamma0: float,
            gamma1: float) -> Tuple[STInstance, np.ndarray, np.ndarray, float]:
    """Contract S₀ = {x ≤ γ₀} into the sink and S₁ = {x ≥ γ₁} into the
    source (paper §3.4 edge-weight rules).  Returns the coarse instance, the
    label array (0 = sink-merged, 1 = source-merged, 2 = contour), the
    contour node ids and the weight of edges that cross between the merged
    sides (a constant of every cut)."""
    g = instance.graph
    v = np.asarray(v)
    in_s0 = v <= gamma0
    in_s1 = v >= gamma1
    contour = ~(in_s0 | in_s1)
    contour_ids = np.nonzero(contour)[0]
    nc = len(contour_ids)
    # map original node -> coarse id (contour nodes are 0..nc-1 in coarse)
    cmap = np.full(g.n, -1, dtype=np.int64)
    cmap[contour_ids] = np.arange(nc)

    src = np.asarray(g.src)
    dst = np.asarray(g.dst)
    w = np.asarray(g.weight, dtype=np.float64)
    # original terminal edges of contour nodes survive
    cs = np.asarray(instance.s_weight, dtype=np.float64)[contour_ids].copy()
    ct = np.asarray(instance.t_weight, dtype=np.float64)[contour_ids].copy()

    a_s0 = in_s0[src]; a_s1 = in_s1[src]; a_c = contour[src]
    b_s0 = in_s0[dst]; b_s1 = in_s1[dst]; b_c = contour[dst]

    # contour-contour edges survive
    cc = a_c & b_c
    c_src = cmap[src[cc]]
    c_dst = cmap[dst[cc]]
    c_w = w[cc]

    # contour-S1 edges become source-terminal; contour-S0 become sink-terminal
    for a, b in ((src, dst), (dst, src)):
        am = contour[a]
        sel = am & in_s1[b]
        np.add.at(cs, cmap[a[sel]], w[sel])
        sel = am & in_s0[b]
        np.add.at(ct, cmap[a[sel]], w[sel])

    # S1—S0 edges cross every cut: a constant offset.  Terminal edges
    # absorbed by contraction (s—u for u ∈ S0, u—t for u ∈ S1) likewise.
    st_cross = float(w[(a_s1 & b_s0) | (a_s0 & b_s1)].sum())
    st_cross += float(np.asarray(instance.s_weight, dtype=np.float64)[in_s0].sum())
    st_cross += float(np.asarray(instance.t_weight, dtype=np.float64)[in_s1].sum())

    coarse = STInstance(
        graph=EdgeList(src=c_src.astype(np.int32), dst=c_dst.astype(np.int32),
                       weight=c_w, n=nc),
        s_weight=cs, t_weight=ct,
    )
    labels = np.where(in_s1, 1, np.where(in_s0, 0, 2))
    return coarse, labels, contour_ids, st_cross


@register("two_level")
def two_level(instance: STInstance, v: np.ndarray, margin: float = 0.05,
              device="cuda") -> RoundingResult:
    """The paper's two-level rounding: coarsen by polarization, solve the
    coarse instance EXACTLY, lift.  ``device`` runs the sweep-cut fallback
    of a fully polarized (empty-contour) coarsening."""
    from .maxflow import max_flow

    gamma0, gamma1 = kmeans_thresholds(np.asarray(v), margin=margin)
    coarse, labels, contour_ids, st_cross = coarsen(instance, v, gamma0, gamma1)
    if coarse.n == 0:
        # degenerate coarsening: the threshold assignment IS the cut; keep
        # the better of it and the sweep cut
        in_source = labels == 1
        thr = RoundingResult(in_source=in_source,
                             cut_value=instance.cut_value(in_source),
                             meta={"method": "two_level", "gamma0": gamma0,
                                   "gamma1": gamma1, "coarse_n": 0,
                                   "reduction": float(instance.n + 2)})
        sw = sweep_cut(instance, v, device=device)
        return thr if thr.cut_value <= sw.cut_value else \
            RoundingResult(in_source=sw.in_source, cut_value=sw.cut_value,
                           meta=dict(thr.meta, fallback="sweep"))
    res = max_flow(coarse)
    in_source = labels == 1
    in_source[contour_ids] = res.in_source[: coarse.n]
    exact = instance.cut_value(in_source)
    meta = {
        "method": "two_level", "gamma0": gamma0, "gamma1": gamma1,
        "coarse_n": int(coarse.n), "coarse_m": int(coarse.graph.m),
        "reduction": (instance.n + 2) / max(1, coarse.n + 2),
        "coarse_flow": float(res.value), "st_cross": st_cross,
    }
    return RoundingResult(in_source=in_source, cut_value=exact, meta=meta)
