"""Sharded reduced-Laplacian SpMV: the paper's §3.3 block-row distribution.

Two communication schedules:

* **psum** (baseline) — edges sharded, voltage vector replicated.  Each
  rank scatters its local fluxes into a full-length vector and one
  all-reduce of n floats combines them.  Robust, partition-agnostic;
  collective volume = n per matvec.

* **halo** (optimized; the paper's actual design) — nodes are partitioned
  into contiguous ranges (one per rank, from the k-way partitioner); every
  DIRECTED edge copy lives with the owner of its head node, so the scatter
  is purely local and only the *gather* of remote tail values needs
  communication.  Each rank exports its boundary values; one all-gather of
  (p × b_sh) floats replaces the n-float all-reduce.  With a good partition
  b_sh ≪ n/p — this is exactly the paper's argument that "k-way
  partitioning ... helps to reduce the process communication cost".

Both schedules are built as STATIC plans on the host (numpy) once per
instance — the paper's one-time setup phase — with a leading rank axis of
size p; each rank then uploads its own row (``distributed.solver``).  The
builders are the JAX package's (``repro/distributed/spmv.py``), array for
array.

``HaloEllPlan`` (built by ``build_halo_ell``) restages each shard's copy
list into a LOCAL ELLPACK layout whose column ids index the halo-extended
vector ``[v_local | halo]`` — the layout that lets the fused single-sweep
edge kernel (``kernels.ops.fused_ell_sweep``, or its plain version
``core.laplacian.fused_ell_sweep``) build the whole per-IRLS-iteration
system (reweight → ELL values → diagonal → RHS) in ONE pass over the local
edges, boundary values included.

The per-rank operations below take this rank's rows and a
``collectives.Collectives``.  The ELL halo matvec stays plain torch, as in
the JAX package: ``ops.ell_spmv`` reads a vector as long as its rows, and
the matvec reads ``[v_local | halo]``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core import laplacian as lap
from ..graphs import partition as gp
from ..kernels import ops as kops
from .collectives import Collectives


# ---------------------------------------------------------------------------
# Plans (host-side, static)
# ---------------------------------------------------------------------------

class PsumPlan(NamedTuple):
    """Edge-sharded / replicated-v plan.  All arrays have a leading shard
    axis of size p; edge slots are padded with c = 0."""

    src: np.ndarray    # i32[p, ml]
    dst: np.ndarray    # i32[p, ml]
    c: np.ndarray      # f32[p, ml]
    c_s: np.ndarray    # f32[n_pad]   (replicated)
    c_t: np.ndarray    # f32[n_pad]
    n: int             # true node count
    n_pad: int
    p: int


class HaloPlan(NamedTuple):
    """Block-row plan.  Nodes reordered so shard i owns [i·nl, (i+1)·nl).

    heads     : i32[p, ml]   local head index of each directed copy
    tails_ext : i32[p, ml]   tail index into [local v (nl) | halo (p·b_sh)]
    c         : f32[p, ml]   edge weight of each copy (0 = padding)
    c_s, c_t  : f32[p, nl]   terminal weights (local slices)
    export    : i32[p, b_sh] local indices of exported boundary nodes
    node_valid: f32[p, nl]   1 for real nodes, 0 for padding
    perm      : i64[n]       new_id = perm[old_id] (for lifting results)
    n, nl, b_sh, p
    """

    heads: np.ndarray
    tails_ext: np.ndarray
    c: np.ndarray
    c_s: np.ndarray
    c_t: np.ndarray
    export: np.ndarray
    node_valid: np.ndarray
    perm: np.ndarray
    n: int
    nl: int
    b_sh: int
    p: int


def build_psum_plan(instance, p: int) -> PsumPlan:
    g = instance.graph
    n = g.n
    n_pad = -(-n // p) * p
    m = g.m
    ml = -(-m // p) * p // p
    src = np.zeros((p, ml), dtype=np.int32)
    dst = np.zeros((p, ml), dtype=np.int32)
    c = np.zeros((p, ml), dtype=np.float32)
    flat_src = np.asarray(g.src, dtype=np.int32)
    flat_dst = np.asarray(g.dst, dtype=np.int32)
    flat_c = np.asarray(g.weight, dtype=np.float32)
    for i in range(p):
        lo, hi = i * ml, min((i + 1) * ml, m)
        if hi > lo:
            src[i, : hi - lo] = flat_src[lo:hi]
            dst[i, : hi - lo] = flat_dst[lo:hi]
            c[i, : hi - lo] = flat_c[lo:hi]
    c_s = np.zeros(n_pad, dtype=np.float32)
    c_t = np.zeros(n_pad, dtype=np.float32)
    c_s[:n] = np.asarray(instance.s_weight, dtype=np.float32)
    c_t[:n] = np.asarray(instance.t_weight, dtype=np.float32)
    return PsumPlan(src=src, dst=dst, c=c, c_s=c_s, c_t=c_t,
                    n=n, n_pad=n_pad, p=p)


def build_halo_plan(instance, p: int, labels: Optional[np.ndarray] = None) -> HaloPlan:
    """Partition → reorder → directed copies → halo layout (all numpy)."""
    g = instance.graph
    n = g.n
    if labels is None:
        labels = gp.partition_kway(g, p)
    perm = gp.partition_order(labels)           # new = perm[old]
    src = perm[np.asarray(g.src, dtype=np.int64)]
    dst = perm[np.asarray(g.dst, dtype=np.int64)]
    w = np.asarray(g.weight, dtype=np.float32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(n)
    c_s_r = np.asarray(instance.s_weight, dtype=np.float32)[inv]
    c_t_r = np.asarray(instance.t_weight, dtype=np.float32)[inv]

    # contiguous equal ranges per shard (may split partition boundaries when
    # parts are unbalanced — the preconditioner plan tolerates this)
    nl = -(-n // p)
    owner = lambda node: np.minimum(node // nl, p - 1)

    # directed copies: (head, tail) both ways
    heads = np.concatenate([src, dst])
    tails = np.concatenate([dst, src])
    cc = np.concatenate([w, w])
    h_own = owner(heads)
    t_own = owner(tails)

    # exported nodes per shard: tails whose copy lives on another shard
    remote = h_own != t_own
    b_sh = 0
    exports = []
    for j in range(p):
        ex = np.unique(tails[remote & (t_own == j)])
        exports.append(ex)
        b_sh = max(b_sh, len(ex))
    b_sh = max(1, -(-b_sh // 8) * 8)
    export = np.zeros((p, b_sh), dtype=np.int32)
    for j, ex in enumerate(exports):
        export[j, : len(ex)] = ex - j * nl
    # the owners' ranges increase with j, so the export lists laid end to
    # end are sorted: a node's position in its owner's list is its rank in
    # the concatenation less the lists before it
    all_ex = np.concatenate(exports)
    ex_start = np.cumsum([0] + [len(ex) for ex in exports])

    # per-shard copy arrays
    ml = 0
    per_shard = []
    for i in range(p):
        sel = np.nonzero(h_own == i)[0]
        per_shard.append(sel)
        ml = max(ml, len(sel))
    ml = max(1, -(-ml // 8) * 8)
    H = np.zeros((p, ml), dtype=np.int32)
    T = np.zeros((p, ml), dtype=np.int32)
    C = np.zeros((p, ml), dtype=np.float32)
    for i, sel in enumerate(per_shard):
        k_ = len(sel)
        H[i, :k_] = heads[sel] - i * nl
        tl = tails[sel]
        local = owner(tl) == i
        text = np.empty(k_, dtype=np.int64)
        text[local] = tl[local] - i * nl
        far = tl[~local]
        j = owner(far)
        pos = np.searchsorted(all_ex, far) - ex_start[j]
        text[~local] = nl + j * b_sh + pos
        T[i, :k_] = text
        C[i, :k_] = cc[sel]

    n_pad = nl * p
    cs = np.zeros(n_pad, dtype=np.float32)
    ct = np.zeros(n_pad, dtype=np.float32)
    cs[:n] = c_s_r
    ct[:n] = c_t_r
    valid = np.zeros(n_pad, dtype=np.float32)
    valid[:n] = 1.0
    return HaloPlan(heads=H, tails_ext=T, c=C,
                    c_s=cs.reshape(p, nl), c_t=ct.reshape(p, nl),
                    export=export, node_valid=valid.reshape(p, nl),
                    perm=perm, n=n, nl=nl, b_sh=b_sh, p=p)


class HaloEllPlan(NamedTuple):
    """Per-shard ELL restaging of the halo copy list (fused-sweep layout).

    cols      : i32[p, nl, k]  tail index (into [local | halo]) of each slot
    c_ell     : f32[p, nl, k]  edge weight per slot (0 = padding) — host-
                               staged once per plan fill, so the device-side
                               sweep is scatter-free
    copy_row  : i32[p, ml]     ELL slot (row, lane) of each directed copy:
    copy_lane : i32[p, ml]     the gather-back map recovering per-copy
                               conductances ``r = −vals[row, lane]`` for the
                               block-Jacobi assembly (padding copies point
                               at slot (0, 0); downstream consumers mask
                               them with copy_valid)
    k         : int            ELL width (max real copies per local head)
    """

    cols: np.ndarray
    c_ell: np.ndarray
    copy_row: np.ndarray
    copy_lane: np.ndarray
    k: int


def build_halo_ell(plan: HaloPlan, pad_to_multiple: int = 8) -> HaloEllPlan:
    """Restage each shard's (heads, tails_ext, c) copy arrays slot-major.

    Every directed copy already lives with its head's owner, so rows are
    the local head ids and the column ids are the existing ``tails_ext``
    indices into the halo-extended vector — no new communication structure,
    just the layout the row-parallel fused sweep needs.  Pure numpy, run at
    plan-build/refill time (the weights land in ``c_ell`` here, the
    once-per-solve ``ell_edge_weights`` staging of the single-device fused
    path, amortized into the plan fill).

    Slot assignment is STRUCTURAL — a copy slot is real when it names an
    actual copy (head ≠ tail or nonzero weight), not when its weight is
    positive — so the ELL width ``k`` depends on the topology only and a
    same-topology weight refill (``update_weights``) that zeroes an edge
    keeps identical staging shapes (the zeroed edge just contributes
    r = 0 in the sweep).
    """
    p, ml = plan.heads.shape
    nl = plan.nl
    lanes = np.zeros((p, ml), dtype=np.int64)
    k = 1
    # structural copies: plan padding slots carry head == tail == 0 AND
    # c == 0; a real copy never has head == tail (no self loops), so this
    # mask is weight-independent for every real edge
    struct = ((plan.heads != plan.tails_ext) | (plan.c > 0))
    for i in range(p):
        h = plan.heads[i].astype(np.int64)
        real = np.nonzero(struct[i])[0]
        hr = h[real]
        order = np.argsort(hr, kind="stable")
        hs = hr[order]
        # lane = running offset within equal head ids (sorted, stable)
        first = np.searchsorted(hs, hs, side="left")
        lane_sorted = np.arange(len(hs)) - first
        lanes[i, real[order]] = lane_sorted
        if len(hs):
            k = max(k, int(lane_sorted.max()) + 1)
    k = max(1, -(-k // pad_to_multiple) * pad_to_multiple)
    cols = np.zeros((p, nl, k), dtype=np.int32)
    c_ell = np.zeros((p, nl, k), dtype=np.float32)
    copy_row = np.zeros((p, ml), dtype=np.int32)
    copy_lane = np.zeros((p, ml), dtype=np.int32)
    for i in range(p):
        real = np.nonzero(struct[i])[0]
        h = plan.heads[i][real].astype(np.int64)
        ln = lanes[i, real]
        cols[i, h, ln] = plan.tails_ext[i][real]
        c_ell[i, h, ln] = plan.c[i][real]
        copy_row[i, real] = h.astype(np.int32)
        copy_lane[i, real] = ln.astype(np.int32)
    return HaloEllPlan(cols=cols, c_ell=c_ell, copy_row=copy_row,
                       copy_lane=copy_lane, k=k)


# ---------------------------------------------------------------------------
# Per-rank operations (this rank's rows of the plans; index tensors int64
# for the plain gathers and scatters, int32 where a kernel reads them)
# ---------------------------------------------------------------------------

def halo_exchange(coll: Collectives, v_loc: torch.Tensor,
                  export_loc: torch.Tensor,
                  compression: Optional[str] = None) -> torch.Tensor:
    """Collect every rank's exported boundary values.

    v_loc: f[nl] local voltages; export_loc: i64[b_sh].
    Returns the extended vector [v_loc | halo(p·b_sh)].

    ``compression="int8"`` quantizes the exported values with one per-rank
    scale before the all-gather — 4× less halo wire traffic for a slightly
    inexact matvec (voltages live in [0,1], so the quantization error is
    ≤ scale/254 ≈ 4e-3).  Two all-gathers then: ``q`` and the scales."""
    bvals = v_loc[export_loc]
    if compression == "int8":
        scale = bvals.abs().max() / 127.0 + 1e-12
        q = torch.clamp(torch.round(bvals / scale), -127, 127).to(torch.int8)
        halo_q = coll.all_gather(q)                       # [p, b_sh] int8
        scales = coll.all_gather(scale.reshape(1))        # [p, 1]
        halo = halo_q.to(v_loc.dtype) * scales
    else:
        halo = coll.all_gather(bvals)                     # [p, b_sh]
    return torch.cat([v_loc, halo.reshape(-1)])


def make_halo_matvec(plan_nl: int):
    """y_u = diag_u v_u − Σ_{copies head=u} r_e v_tail  (local scatter only).

    ``ext`` is the halo-extended vector from halo_exchange; ``r`` are the
    per-copy reweighted conductances (0 on padding)."""
    def mv(ext, heads, tails_ext, r, diag_loc):
        contrib = r * ext[tails_ext]
        acc = torch.zeros(plan_nl, dtype=ext.dtype,
                          device=ext.device).index_add_(0, heads, contrib)
        return diag_loc * ext[:plan_nl] - acc
    return mv


def psum_matvec(coll: Collectives, v_full: torch.Tensor, src: torch.Tensor,
                dst: torch.Tensor, r: torch.Tensor, rs_rt_diag: torch.Tensor,
                n_pad: int) -> torch.Tensor:
    """Baseline: local partial scatter over owned edges + one all-reduce of
    n_pad floats."""
    flux = r * (v_full[src] - v_full[dst])
    zeros = lambda: torch.zeros(n_pad, dtype=v_full.dtype,
                                device=v_full.device)
    y = zeros().index_add_(0, src, flux)
    y = y - zeros().index_add_(0, dst, flux)
    y = coll.all_reduce(y)
    return y + rs_rt_diag * v_full


def make_ell_halo_matvec(ell_cols: torch.Tensor, vals: torch.Tensor,
                         diag_loc: torch.Tensor):
    """Fused-layout halo matvec: y = diag ⊙ x + Σ_lane vals ⊙ ext[cols]
    (vals already carry −r, so this is the same contraction as
    ``make_halo_matvec`` without the scatter)."""
    def mv(x_loc, ext):
        return diag_loc * x_loc + (vals * ext[ell_cols]).sum(dim=1)
    return mv


def coo_reweight(src_or_heads: torch.Tensor, dst_or_tails: torch.Tensor,
                 c: torch.Tensor, v: torch.Tensor, eps,
                 use_pallas: bool = False) -> torch.Tensor:
    """Per-edge reweighted conductances in ONE pass over the local edge
    chunk — the COO flavor of the fused edge sweep, shared by the psum
    schedule (replicated v) and the unfused halo path (halo-extended v).
    ``use_pallas`` launches the ``edge_reweight`` CUDA kernel
    (``kernels.ops.edge_reweight_r``; int32 indices); padded slots carry
    c = 0 → r = 0 either way."""
    if use_pallas:
        r = kops.edge_reweight_r(src_or_heads, dst_or_tails, c, v, eps)
    else:
        r = lap.edge_conductances(src_or_heads, dst_or_tails, c, v, eps)
    return torch.where(c > 0, r, torch.zeros((), dtype=r.dtype,
                                             device=r.device))


def halo_l1_local(heads: torch.Tensor, tails_ext: torch.Tensor,
                  c: torch.Tensor, c_s: torch.Tensor, c_t: torch.Tensor,
                  v_loc: torch.Tensor, ext: torch.Tensor) -> torch.Tensor:
    """Shard-local contribution to the fractional cut value ‖CBx‖₁.

    Each undirected edge appears as TWO directed copies (possibly on two
    ranks) with identical |z|, hence the ÷2; the terminal terms are
    shard-local (padding nodes carry c_s = c_t = 0).  The all-reduce of
    this scalar is the global objective — the ONE extra reduction per IRLS
    iteration that drives the distributed early exit (nothing is added per
    PCG step).
    """
    z = c * (ext[heads] - ext[tails_ext])
    return (0.5 * z.abs().sum()
            + (c_s * (1.0 - v_loc)).abs().sum()
            + (c_t * v_loc).abs().sum())
