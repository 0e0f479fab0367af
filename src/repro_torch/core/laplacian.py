"""Reweighted reduced-Laplacian operators (paper eqs. 4–8), in torch.

Each IRLS step needs the reduced Laplacian ``L̃ = Zᵀ Bᵀ C W⁻¹ C B Z`` and the
right-hand side ``b = −Zᵀ L e_s``.  With the STInstance layout the reduced
system is the Laplacian of the non-terminal graph under reweighted
conductances ``r_e = c_e² / w_e`` plus diagonal terminal conductances::

    (L̃ v)_u = (Σ_{e∋u} r_e + r_s(u) + r_t(u)) v_u − Σ_{e=(u,x)} r_e v_x
    b_u     = r_s(u)

Two matvec layouts:

* **edge-scatter** (COO): gather v[src], v[dst] → per-edge flux →
  per-node segmented sums in edge order (``incidence.CooPlan``: no
  atomics, so a served solve gives the same bits on every run).
* **ELLPACK**: padded fixed-degree rows; the layout of the hand-written CUDA
  kernels (kernels/csrc/ell_spmv.cu, fused_ell_sweep.cu).

Every operator takes one instance or a batch of B lanes that share the
topology and the plans: per-lane tensors carry a leading lane dimension
(``r`` (B, m), ``v`` and ``diag`` (B, n), ``vals`` (B, n, k)), and the
scatters run along the last dimension.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .incidence import DeviceGraph, eps_sq, segment_sum


class Reweighted(NamedTuple):
    """Per-IRLS-iteration reweighted conductances (eq. 4 → eq. 8).

    r    : f[m]  reweighted non-terminal conductances c²/w
    r_s  : f[n]  reweighted terminal-source conductances
    r_t  : f[n]  reweighted terminal-sink conductances
    diag : f[n]  diagonal of the reduced Laplacian L̃
    (each with a leading lane dimension in a batch)
    """

    r: torch.Tensor
    r_s: torch.Tensor
    r_t: torch.Tensor
    diag: torch.Tensor


def _degree(g: DeviceGraph, r: torch.Tensor) -> torch.Tensor:
    return segment_sum(g.coo.by_end, r)


def edge_conductances(src: torch.Tensor, dst: torch.Tensor, c: torch.Tensor,
                      v: torch.Tensor, eps) -> torch.Tensor:
    """r_e = c_e² / sqrt((c_e (v[src]−v[dst]))² + ε²) (eq. 4 on the
    non-terminal edges).  The plain version of the edge-reweight kernel."""
    z = c * (v[..., src] - v[..., dst])
    return (c * c) / torch.sqrt(z * z + eps_sq(eps))


def reweight(g: DeviceGraph, v: torch.Tensor, eps: float,
             edge_r=edge_conductances) -> Reweighted:
    """IRLS Step 1 (eq. 4): w_e = sqrt((CBx)_e² + ε²); r_e = c_e²/w_e.

    ``edge_r(src, dst, c, v, eps)`` computes r_e: ``edge_conductances`` or
    its kernel wrapper ``kernels.ops.edge_reweight_r``."""
    r = edge_r(g.src, g.dst, g.c, v, eps)
    z_s = g.c_s * (1.0 - v)
    z_t = g.c_t * v
    e2 = eps_sq(eps)
    r_s = (g.c_s * g.c_s) / torch.sqrt(z_s * z_s + e2)
    r_t = (g.c_t * g.c_t) / torch.sqrt(z_t * z_t + e2)
    # zero-capacity terminal entries must not contribute conductance
    zero = torch.zeros((), dtype=v.dtype, device=v.device)
    r_s = torch.where(g.c_s > 0, r_s, zero)
    r_t = torch.where(g.c_t > 0, r_t, zero)
    return Reweighted(r=r, r_s=r_s, r_t=r_t, diag=_degree(g, r) + r_s + r_t)


def initial_weights(g: DeviceGraph) -> Reweighted:
    """W⁰ = C (paper §2.1): conductances r = c²/c = c."""
    return Reweighted(r=g.c, r_s=g.c_s, r_t=g.c_t,
                      diag=_degree(g, g.c) + g.c_s + g.c_t)


def matvec_coo(g: DeviceGraph, rw: Reweighted, v: torch.Tensor) -> torch.Tensor:
    """Edge-scatter (COO) reduced-Laplacian matvec  y = L̃ v."""
    flux = rw.r * (v[..., g.src] - v[..., g.dst])
    y_src = segment_sum(g.coo.by_src, flux)
    y_dst = segment_sum(g.coo.by_dst, flux)
    return y_src - y_dst + (rw.r_s + rw.r_t) * v


def rhs(rw: Reweighted) -> torch.Tensor:
    """b = −Zᵀ L e_s = terminal-source conductances (≥ 0, Prop 2.2)."""
    return rw.r_s


# ---------------------------------------------------------------------------
# ELLPACK layout: static index plan + per-iteration value fill
# ---------------------------------------------------------------------------

class EllPlan(NamedTuple):
    """Static ELL index plan for the non-terminal graph (built once on host).

    cols      : int32[n, k]  padded neighbour ids (0 where invalid)
    slot_rows : int64[2m]    destination row of each directed edge copy
    slot_cols : int64[2m]    destination lane of each directed edge copy
    edge_id   : int64[2m]    originating undirected edge id of each copy
    edge_row  : int64[m]     row of the FIRST slot of each undirected edge
    edge_lane : int64[m]     lane of that slot (``r_e = -vals[edge_row,
                             edge_lane]`` recovers the conductances from a
                             fused-sweep value matrix)
    """

    cols: torch.Tensor
    slot_rows: torch.Tensor
    slot_cols: torch.Tensor
    edge_id: torch.Tensor
    edge_row: torch.Tensor
    edge_lane: torch.Tensor

    @property
    def n(self) -> int:
        return self.cols.shape[0]

    @property
    def k(self) -> int:
        return self.cols.shape[1]


def build_ell_plan_arrays(src, dst, n: int, pad_to_multiple: int = 8):
    """Host-side construction of the static ELL plan (numpy arrays, in the
    field order of ``EllPlan``)."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    m = src.shape[0]
    rows = np.concatenate([src, dst])
    cols = np.concatenate([dst, src])
    eid = np.concatenate([np.arange(m), np.arange(m)])
    order = np.argsort(rows, kind="stable")
    rows, cols, eid = rows[order], cols[order], eid[order]
    deg = np.bincount(rows, minlength=n)
    k = int(deg.max()) if n else 0
    k = max(1, -(-k // pad_to_multiple) * pad_to_multiple)
    # lane index within the row = running offset
    starts = np.zeros(n + 1, dtype=np.int64)
    starts[1:] = np.cumsum(deg)
    lane = np.arange(2 * m) - starts[rows]
    colmat = np.zeros((n, k), dtype=np.int32)
    colmat[rows, lane] = cols
    # first slot of each undirected edge (gather-back map for fused sweeps)
    _, first = np.unique(eid, return_index=True)
    return colmat, rows, lane, eid, rows[first], lane[first]


def build_ell_plan(src, dst, n: int, pad_to_multiple: int = 8,
                   device="cuda") -> EllPlan:
    """The ELL plan of ``build_ell_plan_arrays``, moved to ``device``."""
    return EllPlan(*(torch.as_tensor(a, device=device)
                     for a in build_ell_plan_arrays(src, dst, n,
                                                    pad_to_multiple)))


def fill_ell(plan: EllPlan, rw: Reweighted):
    """Scatter the per-iteration conductances into the static ELL slots.

    Returns (vals[n,k], diag[n]): off-diagonals are −r_e, the diagonal is the
    full L̃ diagonal (includes terminal conductances)."""
    vals = torch.zeros(rw.r.shape[:-1] + (plan.n, plan.k), dtype=rw.r.dtype,
                       device=rw.r.device)
    vals[..., plan.slot_rows, plan.slot_cols] = -rw.r[..., plan.edge_id]
    return vals, rw.diag


def matvec_ell(cols: torch.Tensor, vals: torch.Tensor, diag: torch.Tensor,
               v: torch.Tensor) -> torch.Tensor:
    """ELLPACK matvec  y = diag·v + Σ_lane vals[:,lane] · v[cols[:,lane]].

    Padded lanes carry vals == 0, so gathering v[0] there is harmless."""
    return diag * v + (vals * v[..., cols]).sum(dim=-1)


# ---------------------------------------------------------------------------
# Fused single-sweep reweight (reweight → ELL values → diagonal → RHS)
# ---------------------------------------------------------------------------

def terminal_conductances(c_s: torch.Tensor, c_t: torch.Tensor,
                          v: torch.Tensor, eps):
    """``r_s = c_s² / sqrt((c_s(1−v))² + ε²)`` and the t-side analogue, with
    0 where the capacity is 0 (absent terminal edges carry no conductance)."""
    z_s = c_s * (1.0 - v)
    z_t = c_t * v
    e2 = eps_sq(eps)
    zero = torch.zeros((), dtype=v.dtype, device=v.device)
    r_s = torch.where(c_s > 0, (c_s * c_s) * torch.rsqrt(z_s * z_s + e2), zero)
    r_t = torch.where(c_t > 0, (c_t * c_t) * torch.rsqrt(z_t * z_t + e2), zero)
    return r_s, r_t


def ell_edge_weights(plan: EllPlan, c: torch.Tensor) -> torch.Tensor:
    """Scatter the edge weights ``c`` into the static ELL slots, once per
    SOLVE (the weights are fixed across the IRLS loop).  Padded slots keep
    c = 0 → r = 0, so every IRLS iteration is then a scatter-free sweep."""
    ce = torch.zeros(c.shape[:-1] + (plan.n, plan.k), dtype=c.dtype,
                     device=c.device)
    ce[..., plan.slot_rows, plan.slot_cols] = c[..., plan.edge_id]
    return ce


class EllDeltaMap(NamedTuple):
    """Edge-major view of the TWO ELL slots of every undirected edge.

    ``ell_edge_weights`` scatters slot-major (all 2m directed copies); a
    drift step that touches d ≪ m edges only needs the 2d slots of the
    changed edges.  ``rows[e]``/``lanes[e]`` are those two (row, lane)
    destinations of edge ``e``, on the plan's device.  Built once per
    topology next to the plan."""

    rows: torch.Tensor   # int64[m, 2]
    lanes: torch.Tensor  # int64[m, 2]


def build_ell_delta_map(plan: EllPlan) -> EllDeltaMap:
    """The per-edge slot map of ``plan``: a stable argsort of
    ``plan.edge_id`` (on the plan's device) groups each edge's two slots,
    in plan order."""
    m = plan.edge_id.shape[0] // 2
    order = torch.sort(plan.edge_id, stable=True).indices
    return EllDeltaMap(rows=plan.slot_rows[order].reshape(m, 2),
                       lanes=plan.slot_cols[order].reshape(m, 2))


def ell_edge_weights_delta(dmap: EllDeltaMap, c_ell_prev: torch.Tensor,
                           c: np.ndarray, changed) -> torch.Tensor:
    """Delta mode of ``ell_edge_weights``: a copy of the previously staged
    (n, k) table with only the slots of the ``changed`` edge ids rewritten
    from ``c`` (host array of all m edge weights).

    Bit-equal to a full restage: the untouched slots ARE the previous
    staging, and the changed slots receive the values ``ell_edge_weights``
    writes, rounded once to the table's dtype.  ``changed`` is a host int
    array (the diff is data-dependent); the previous table is not
    modified, so a solve still reading it is unaffected."""
    changed = np.asarray(changed, dtype=np.int64)
    if changed.size == 0:
        return c_ell_prev
    dev = c_ell_prev.device
    idx = torch.as_tensor(changed, device=dev)
    vals = torch.as_tensor(np.asarray(c)[changed],
                           device=dev).to(c_ell_prev.dtype)
    out = c_ell_prev.clone()
    out[dmap.rows[idx], dmap.lanes[idx]] = vals[:, None].expand(-1, 2)
    return out


def fused_ell_sweep(cols: torch.Tensor, c_ell: torch.Tensor,
                    c_s: torch.Tensor, c_t: torch.Tensor, v: torch.Tensor,
                    eps):
    """One edge sweep builds the WHOLE per-iteration system (eq. 4 → eq. 8).

    Per ELL slot (u, lane) holding edge e = (u, x):

        z = c_e (v[u] − v[x]);  r_e = c_e² / sqrt(z² + ε²);  vals = −r_e

    plus diag[u] = Σ_lane r + r_s[u] + r_t[u] and rhs = r_s.  Returns
    ``(vals[n,k], diag[n], r_s[n], r_t[n])``.  ``v`` may be longer than the
    row count (halo-extended); its first n entries are the row voltages.
    This is the plain version of the CUDA kernel
    (kernels/csrc/fused_ell_sweep.cu)."""
    n = cols.shape[0]
    vr = v[..., :n]
    z = c_ell * (vr[..., None] - v[..., cols])
    r = (c_ell * c_ell) * torch.rsqrt(z * z + eps_sq(eps))
    r_s, r_t = terminal_conductances(c_s, c_t, vr, eps)
    diag = r.sum(dim=-1) + r_s + r_t
    return -r, diag, r_s, r_t


def edge_r_from_vals(plan: EllPlan, vals: torch.Tensor) -> torch.Tensor:
    """Recover per-edge conductances r[m] from a fused-sweep value matrix."""
    return -vals[..., plan.edge_row, plan.edge_lane]


def dense_reduced_laplacian(g: DeviceGraph, rw: Reweighted) -> torch.Tensor:
    """Dense L̃ (testing oracle only — O(n²) memory)."""
    n = g.n
    L = torch.zeros((n, n), dtype=rw.r.dtype, device=rw.r.device)
    L.index_put_((g.src, g.dst), -rw.r, accumulate=True)
    L.index_put_((g.dst, g.src), -rw.r, accumulate=True)
    ar = torch.arange(n, device=rw.r.device)
    L.index_put_((ar, ar), rw.diag, accumulate=True)
    return L
