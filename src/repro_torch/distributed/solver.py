"""Sharded IRLS + PCG over ``torch.distributed`` (the parallel PIRMCut of §3).

Every rank runs the whole IRLS(T) × PCG(K) nest on its own shard: the
same program on each rank (SPMD), as the JAX package's one ``shard_map``
program runs on each device of the mesh.  Communication per PCG step:

  psum schedule : 1 × all-reduce(n)      (baseline)
  halo schedule : 1 × all-gather(p·b_sh) (partition-aware, b_sh ≪ n/p)

plus scalar all-reduces for the CG dot products on the halo schedule
(squared-norm bookkeeping: one ``p·Ap`` reduction and one fused
``[r·z, r·r]`` pair reduction per step — sqrt only on exit).  The
block-Jacobi preconditioner is fully local to each rank — its sub-blocks
are nested inside the partition parts, so applying it needs NO collectives
(the paper's central argument for block Jacobi, §4).

Both schedules run the SAME iteration core as the host/scanned backends:

* the PCG loops are ``core.pcg.pcg_fixed_iters`` / ``pcg_masked`` with the
  cross-rank inner products plugged in (``collectives.psum_dots``), and
* the adaptive early-exit schedule is ``core.adaptive``, driven here by
  all-reduced scalars: the fractional cut value is ONE extra scalar
  all-reduce per IRLS iteration, every rank reads identical reduced
  values, so all ranks take the early exit in the same step and the masked
  PCG adds ZERO collectives per step over the fixed schedule.

Under ``cfg.fuse_edge_sweep`` (the default) the halo schedule restages the
local copy list into a per-rank ELL layout (``spmv.build_halo_ell``) and
builds each iteration's system — reweight → ELL values → diagonal → RHS —
in ONE pass over the local edges with the exported boundary values from
``halo_exchange``: the ``fused_ell_sweep`` CUDA kernel under
``cfg.use_pallas``, its plain version ``core.laplacian.fused_ell_sweep``
otherwise.  The unfused halo build and the psum schedule's edge pass run
the COO sweep ``spmv.coo_reweight`` (the ``edge_reweight`` kernel under
``cfg.use_pallas``).

Each rank builds the numpy plans (deterministic, so every rank builds the
same ones), uploads its own row of each as fresh contiguous tensors on its
device, and gathers the voltages at the end: ``solve()`` returns the same
full-length voltages, in the original node order, on every rank.  The
collective census (``collective_stats``) counts calls and bytes per scope
and op at the process group; it replaces the JAX package's walk over the
compiled HLO.

The dry-run API plans without an instance: ``abstract_halo_plans`` gives
the plans of a production-size cell as fake tensors of the reference's
shapes and dtypes (no storage), a ``ShardedSolver`` built on them over a
fake world (``launch.mesh.make_production_mesh(plan=True)``) takes its
rank's rows, and ``lower()`` runs the solve body once on them under the
op walker (``launch.hlo_analysis.analyze``).  Every IRLS iteration after
the first runs the same ops, so ``lower`` plans 1 and 2 iterations and
extrapolates to T (the reference's body-once correction; a planned
fake op costs ~0.1 ms of host time, and 50 × 50 PCG steps over 256 ranks
take ~10⁶ of them).  The fixed schedule reads nothing back to the host, so
it plans as it runs.  The adaptive schedule reads its all-reduced scalars
on the host, which a plan cannot: its plan runs the adaptive program at its
largest trip count (every IRLS iteration, every PCG at ``pcg_max_iters``
steps of the masked loop, the early exit's reductions made but never
read), an upper bound (``Plan.bound == "upper"``).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core import adaptive as sched
from ..core import laplacian as lap
from ..core.irls import IRLSConfig, eps_schedule_array, torch_dtype
from ..core.pcg import pcg_fixed_iters, pcg_masked
from ..graphs import partition as gp
from ..kernels import ops as kops
from ..obs import trace
from ..obs.metrics import get_registry
from .collectives import Collectives, psum_dots, world
from .spmv import (HaloPlan, build_halo_ell, build_halo_plan,
                   build_psum_plan, coo_reweight, halo_exchange,
                   halo_l1_local, make_ell_halo_matvec, make_halo_matvec,
                   psum_matvec)

class Float32DivergenceWarning(UserWarning):
    """IRLS reweights ran into the float32 precision wall (see
    ``float32_divergence_threshold``)."""


def float32_divergence_threshold(eps: float) -> float:
    """Largest reweighted conductance float32 IRLS tolerates at this ε.

    The reweight r = c²/√((c·Δv)² + ε²) is bounded by max(c²)/ε, so a
    shrinking ε drives the conductance spread toward 1/ε.  In float32 the
    PCG quadratic forms lose ~εf32·κ of their value to rounding (εf32 ≈
    1.19e-7); once the spread reaches ~1/√(ε·εf32) the lost digits reach
    the residual scale √ε the stop test needs, and the iteration stalls or
    diverges (ε = 1e-8 diverges in float32 while ε = 1e-6 is fine —
    thresholds ≈ 2.9e7 and 2.9e6 against reweights ~1e8 and ~1e6).
    """
    return 1.0 / float(np.sqrt(eps * np.finfo(np.float32).eps))


class HaloBlockPlan(NamedTuple):
    """Per-shard sub-block preconditioner plan (zero-collective apply).

    copy_b/copy_i/copy_j : i32[p, mc] sub-block / local slots of intra-block
                           directed copies (off-diagonal scatter targets)
    copy_id              : i32[p, mc] source copy index (into the ml axis)
    copy_valid           : f32[p, mc] 1 = real, 0 = padding
    node_b/node_s        : i32[p, nl] sub-block / slot of each local node
    nb, bs               : static — sub-blocks per shard / block size
    """

    copy_b: np.ndarray
    copy_i: np.ndarray
    copy_j: np.ndarray
    copy_id: np.ndarray
    copy_valid: np.ndarray
    node_b: np.ndarray
    node_s: np.ndarray
    nb: int
    bs: int


def build_halo_block_plan(plan: HaloPlan, target_bs: int = 128) -> HaloBlockPlan:
    """Split each shard's contiguous node range into fixed-size sub-blocks
    (node order already groups partition parts → sub-blocks inherit the
    partition locality the paper's preconditioner relies on)."""
    p, nl = plan.p, plan.nl
    bs = min(target_bs, nl)
    nb = -(-nl // bs)
    node_b = np.broadcast_to((np.arange(nl) // bs).astype(np.int32), (p, nl)).copy()
    node_s = np.broadcast_to((np.arange(nl) % bs).astype(np.int32), (p, nl)).copy()
    rows = []
    mc = 0
    for i in range(p):
        h, t, c = plan.heads[i], plan.tails_ext[i], plan.c[i]
        ok = (c > 0) & (t < nl) & ((h // bs) == (t // bs))
        ids = np.nonzero(ok)[0]
        rows.append(ids)
        mc = max(mc, len(ids))
    mc = max(8, -(-mc // 8) * 8)
    copy_b = np.zeros((p, mc), dtype=np.int32)
    copy_i = np.zeros((p, mc), dtype=np.int32)
    copy_j = np.zeros((p, mc), dtype=np.int32)
    copy_id = np.zeros((p, mc), dtype=np.int32)
    copy_valid = np.zeros((p, mc), dtype=np.float32)
    for i, ids in enumerate(rows):
        k = len(ids)
        h, t = plan.heads[i][ids], plan.tails_ext[i][ids]
        copy_b[i, :k] = (h // bs).astype(np.int32)
        copy_i[i, :k] = (h % bs).astype(np.int32)
        copy_j[i, :k] = (t % bs).astype(np.int32)
        copy_id[i, :k] = ids.astype(np.int32)
        copy_valid[i, :k] = 1.0
    return HaloBlockPlan(copy_b=copy_b, copy_i=copy_i, copy_j=copy_j,
                         copy_id=copy_id, copy_valid=copy_valid,
                         node_b=node_b, node_s=node_s, nb=nb, bs=bs)


# refills stay incremental while the diff is this sparse; denser drift
# amortizes better through the vectorized full plan fill
DELTA_MAX_FRAC = 0.25


def directed_copy_slots(instance, plan: HaloPlan):
    """Directed copy e ∈ [0, 2m) → (shard, ml slot) in the halo plan —
    the scatter targets of an incremental weight refill.  Replays the
    owner/selection order of ``build_halo_plan`` once per topology."""
    g = instance.graph
    perm, nl, p = plan.perm, plan.nl, plan.p
    src = perm[np.asarray(g.src, dtype=np.int64)]
    dst = perm[np.asarray(g.dst, dtype=np.int64)]
    heads = np.concatenate([src, dst])
    h_own = np.minimum(heads // nl, p - 1)
    slot = np.empty(heads.shape[0], dtype=np.int64)
    for i in range(p):
        sel = np.nonzero(h_own == i)[0]
        slot[sel] = np.arange(sel.size)
    return h_own.astype(np.int32), slot.astype(np.int32)


def delta_refill(plan: HaloPlan, ell, prev, instance, copy_slots,
                 max_frac: float = DELTA_MAX_FRAC):
    """The halo plan and ELL staging (``ell`` may be None) of ``plan``
    refilled from ``prev``'s weights to ``instance``'s by patching only
    the changed slots; returns ``(plan, ell)``, or None when the full
    refill is needed.

    Applies when the edge-weight diff vs the previous instance is sparse
    (at most ``max_frac`` of the edges) AND support-stable (changed edges
    positive before and after — the block-preconditioner copy selection
    masks on c > 0, so a support flip changes plan STRUCTURE and needs the
    full path).  Terminal weights are refreshed unconditionally
    (vectorized O(n), same expressions as the full fill).  Bit-equal to a
    full refill, since both write the same float32 values to the same
    slots.  ``copy_slots()`` returns ``directed_copy_slots`` (called only
    when an edge changed).
    """
    w_old = np.asarray(prev.graph.weight, dtype=np.float32)
    w_new = np.asarray(instance.graph.weight, dtype=np.float32)
    if w_old.shape != w_new.shape:
        return None
    m = w_new.shape[0]
    diff = np.flatnonzero(w_old != w_new)
    if diff.size > max_frac * max(1, m):
        return None
    if diff.size and (np.any(w_old[diff] <= 0) or np.any(w_new[diff] <= 0)):
        return None
    if diff.size:
        sh, sl = copy_slots()
        idx = np.concatenate([diff, diff + m])
        vals = np.concatenate([w_new[diff], w_new[diff]])
        c = plan.c.copy()
        c[sh[idx], sl[idx]] = vals
        plan = plan._replace(c=c)
        if ell is not None:
            ce = ell.c_ell.copy()
            ce[sh[idx], ell.copy_row[sh[idx], sl[idx]],
               ell.copy_lane[sh[idx], sl[idx]]] = vals
            ell = ell._replace(c_ell=ce)
    cs_new = np.asarray(instance.s_weight, dtype=np.float32)
    ct_new = np.asarray(instance.t_weight, dtype=np.float32)
    if (not np.array_equal(np.asarray(prev.s_weight, dtype=np.float32),
                           cs_new)
            or not np.array_equal(np.asarray(prev.t_weight,
                                             dtype=np.float32), ct_new)):
        n, nl, p = plan.n, plan.nl, plan.p
        inv = np.empty_like(plan.perm)
        inv[plan.perm] = np.arange(n)
        cs = np.zeros(nl * p, dtype=np.float32)
        ct = np.zeros(nl * p, dtype=np.float32)
        cs[:n] = cs_new[inv]
        ct[:n] = ct_new[inv]
        plan = plan._replace(c_s=cs.reshape(p, nl), c_t=ct.reshape(p, nl))
    return plan, ell


def abstract_halo_plans(n: int, m: int, p: int, boundary_frac: float,
                        precond_bs: int = 128, device=None
                        ) -> Tuple[HaloPlan, HaloBlockPlan]:
    """Analytic plan SHAPES for a planning run at scales where building a
    real instance on the host is pointless, as fake tensors (no storage;
    created in the ``FakeTensorMode`` the caller has entered, else in one
    of their own).  nl/ml/b_sh follow the same padding rules as
    ``build_halo_plan``; boundary_frac comes from the real partitioner's
    measured cut fraction on small instances of the family.  No ELL
    staging: the plan is of the unfused system build, as the JAX
    package's."""
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode

    pad8 = lambda x: max(8, -(-int(x) // 8) * 8)
    nl = pad8(-(-n // p))
    ml = pad8(2 * m / p * 1.05)
    b_sh = pad8(n * boundary_frac / p)
    i32, f32, i64 = torch.int32, torch.float32, torch.int64
    mode = detect_fake_mode() or FakeTensorMode()
    dev = torch.device(device) if device is not None else None
    with mode:
        sds = lambda shape, dt: torch.empty(shape, dtype=dt, device=dev)
        plan = HaloPlan(
            heads=sds((p, ml), i32), tails_ext=sds((p, ml), i32),
            c=sds((p, ml), f32), c_s=sds((p, nl), f32),
            c_t=sds((p, nl), f32), export=sds((p, b_sh), i32),
            node_valid=sds((p, nl), f32), perm=sds((n,), i64), n=n, nl=nl,
            b_sh=b_sh, p=p)
        bs = min(precond_bs, nl)
        nb = -(-nl // bs)
        mc = ml  # upper bound: every copy intra-block
        bplan = HaloBlockPlan(
            copy_b=sds((p, mc), i32), copy_i=sds((p, mc), i32),
            copy_j=sds((p, mc), i32), copy_id=sds((p, mc), i32),
            copy_valid=sds((p, mc), f32), node_b=sds((p, nl), i32),
            node_s=sds((p, nl), i32), nb=nb, bs=bs)
    return plan, bplan


class ShardedSolver:
    """Sharded PIRMCut IRLS (halo or psum schedule) on this rank.

    Runs the fixed ``n_irls × pcg_max_iters`` schedule by default, or the
    convergence-masked adaptive one when the config sets any of the
    early-exit knobs (``irls_tol`` / ``adaptive_tol`` — see
    core/adaptive.py); ``cfg.eps_schedule`` is honored.  ``solve`` returns
    ``(v, rels, iters)`` where ``iters`` is the PCG spend per IRLS
    iteration (parked at 0 once the adaptive mask froze the solve).

    ``group`` is the process group (None: ``collectives.world(device)``,
    the default group, initialized as a world of one when there is none);
    ``device`` is where this rank's shard lives.
    """

    def __init__(self, instance, cfg: IRLSConfig, group=None,
                 schedule: str = "halo", labels: Optional[np.ndarray] = None,
                 precond_bs: int = 128, plans: Optional[tuple] = None,
                 halo_compression: Optional[str] = None, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("a sharded solve on cuda needs a CUDA card; "
                               "pass device='cpu' for the CPU")
        if schedule not in ("halo", "psum"):
            raise ValueError(schedule)
        if group is None:
            world(self.device)
        self.cfg = cfg
        self.coll = Collectives(group)
        self.p, self.rank = self.coll.size, self.coll.rank
        self.halo_compression = halo_compression
        # kept for host-side diagnostics (the float32 divergence sentinel
        # reads the weights) and the delta refill's diff
        self._instance = instance
        self.last_clamped = 0  # reweight-clamp hits of the latest solve()
        self.schedule = schedule
        self._planned = None   # the cached planning run (``compiled``)
        self._mode = None      # the FakeTensorMode of a planning run
        self._planning = False  # inside ``lower``: no host reads
        self._labels = labels
        self._precond_bs = precond_bs
        self.ell = None        # HaloEllPlan when the fused sweep is active
        # incremental refills: update_weights diffs the new weights against
        # the previous instance and, when the diff is sparse and support-
        # stable, patches the affected plan slots (halo c + ELL staging)
        # instead of re-running the host-side plan fills
        self.delta_stats = {"delta": 0, "rebuild": 0}
        self._copy_map = None  # directed copy -> (shard, ml slot), lazy
        if plans is not None:
            if schedule == "halo":
                if len(plans) == 3:
                    self.plan, self.block_plan, self.ell = plans
                else:
                    self.plan, self.block_plan = plans
            else:
                (self.plan,) = plans
        elif schedule == "halo":
            if labels is None:
                # partition here (not inside build_halo_plan) so the labels
                # survive for same-topology plan refills (update_weights)
                self._labels = labels = gp.partition_kway(instance.graph,
                                                          self.p)
            self.plan = build_halo_plan(instance, self.p, labels=labels)
            self.block_plan = build_halo_block_plan(self.plan, precond_bs)
            if cfg.fuse_edge_sweep:
                self.ell = build_halo_ell(self.plan)
        else:
            self.plan = build_psum_plan(instance, self.p)
        if self.plan.p != self.p:
            raise ValueError(f"plans for {self.plan.p} shards on a group "
                             f"of {self.p} ranks")
        self._upload()

    # -- this rank's shard on its device ------------------------------------
    def _row(self, a: np.ndarray, dtype=None) -> torch.Tensor:
        """This rank's row of a [p, ...] plan array as a fresh contiguous
        tensor (16-byte aligned, as the kernels' vector variants need; a
        view of a [p, ml] array would not be where ml % 4 ≠ 0).  A fake
        plan array (``abstract_halo_plans``) gives a fake row of its own."""
        if isinstance(a, torch.Tensor):
            t = a[self.rank].to(self.device).clone()
        else:
            t = torch.tensor(np.ascontiguousarray(a[self.rank]),
                             device=self.device)
        return t if dtype is None else t.to(dtype)

    def _upload(self, weights_only: bool = False) -> None:
        """Upload this rank's plan rows (only the weight arrays after a
        delta refill)."""
        dt = torch_dtype(self.cfg)
        i64 = torch.int64
        t = {} if not weights_only else self._t
        pl_ = self.plan
        if self.schedule == "psum":
            t["c"] = self._row(pl_.c, dt)
            # terminals are REPLICATED on the psum schedule
            t["c_s"] = torch.tensor(pl_.c_s, device=self.device).to(dt)
            t["c_t"] = torch.tensor(pl_.c_t, device=self.device).to(dt)
            if not weights_only:
                t["src32"], t["dst32"] = self._row(pl_.src), self._row(pl_.dst)
                t["src"], t["dst"] = t["src32"].to(i64), t["dst32"].to(i64)
            self._t = t
            return
        t["c"] = self._row(pl_.c, dt)
        t["c_s"], t["c_t"] = self._row(pl_.c_s, dt), self._row(pl_.c_t, dt)
        if self.ell is not None:
            t["c_ell"] = self._row(self.ell.c_ell, dt)
        if not weights_only:
            bp = self.block_plan
            t["heads32"] = self._row(pl_.heads)
            t["tails32"] = self._row(pl_.tails_ext)
            t["heads"], t["tails"] = (t["heads32"].to(i64),
                                      t["tails32"].to(i64))
            t["export"] = self._row(pl_.export, i64)
            t["valid"] = self._row(pl_.node_valid, dt)
            for name in ("copy_b", "copy_i", "copy_j", "copy_id", "node_b",
                         "node_s"):
                t[name] = self._row(getattr(bp, name), i64)
            t["copy_valid"] = self._row(bp.copy_valid, dt)
            if self.ell is not None:
                t["cols32"] = self._row(self.ell.cols)
                t["cols"] = t["cols32"].to(i64)
                t["copy_row"] = self._row(self.ell.copy_row, i64)
                t["copy_lane"] = self._row(self.ell.copy_lane, i64)
        self._t = t

    # -- same-topology refills ------------------------------------------------
    def update_weights(self, instance):
        """Refill the plan's weight arrays for a SAME-TOPOLOGY instance.

        The partition labels and the plans' structure are reused — only the
        host-side plan fill (and the ELL weight restaging, when fused) is
        redone, with identical shapes, and this rank's rows re-uploaded.
        The k-way partition is skipped entirely; this is the session API's
        sharded serving path.

        The refill itself is INCREMENTAL under weight drift: the new
        weights are diffed against the previous instance's, and a sparse
        support-stable diff (every changed edge stays positive, so the
        preconditioner's structural copy selection cannot move) patches
        only the affected halo-plan and ELL-staging slots — bit-equal to a
        full refill, since both write the same float32 values to the same
        slots.  Dense diffs, support flips and terminal-only topologies
        fall back to the full plan fill; ``delta_stats`` counts both paths.
        """
        if self.schedule == "halo" and self._try_delta_refill(instance):
            self._instance = instance
            self.delta_stats["delta"] += 1
            self._upload(weights_only=True)
            return
        self._instance = instance
        self.delta_stats["rebuild"] += 1
        if self.schedule == "halo":
            new_plan = build_halo_plan(instance, self.p, labels=self._labels)
            if (new_plan.nl, new_plan.b_sh, new_plan.heads.shape) != \
                    (self.plan.nl, self.plan.b_sh, self.plan.heads.shape):
                raise ValueError("update_weights requires the same topology "
                                 "(plan shapes changed)")
            self.plan = new_plan
            self.block_plan = build_halo_block_plan(new_plan, self._precond_bs)
            if self.ell is not None:
                new_ell = build_halo_ell(new_plan)
                if new_ell.cols.shape != self.ell.cols.shape:
                    raise ValueError("update_weights requires the same "
                                     "topology (ELL staging shapes changed)")
                self.ell = new_ell
        else:
            new_plan = build_psum_plan(instance, self.p)
            if (new_plan.n_pad, new_plan.src.shape) != \
                    (self.plan.n_pad, self.plan.src.shape):
                raise ValueError("update_weights requires the same topology "
                                 "(plan shapes changed)")
            self.plan = new_plan
        self._upload()

    def _directed_copy_slots(self):
        if self._copy_map is None:
            self._copy_map = directed_copy_slots(self._instance, self.plan)
        return self._copy_map

    def _try_delta_refill(self, instance) -> bool:
        """Patch the halo plan + ELL staging in place of a full refill
        (``delta_refill``); False when the diff needs the full path."""
        if self._instance is None:
            return False
        out = delta_refill(self.plan, self.ell, self._instance, instance,
                           self._directed_copy_slots)
        if out is None:
            return False
        self.plan, self.ell = out
        return True

    # -- shared pieces ----------------------------------------------------------
    def _clamp_cap(self, c, c_s, c_t, eps_last: float):
        """float32 mitigation: cap the reweights at the divergence threshold
        cap = c_max·thresh(ε_last/c_max) = √(c_max³/(ε_last·εf32)) so the
        conductance spread the PCG quadratic forms see stays representable.
        c_max is a global MAX all-reduce, once, OUTSIDE the IRLS loop
        (weights are loop constants), so every rank caps identically."""
        eps_f32 = float(np.finfo(np.float32).eps)
        zero = torch.zeros((), dtype=c.dtype, device=c.device)
        local_max = torch.stack([zero] + [a.max() for a in (c, c_s, c_t)
                                          if a.numel()]).max()
        c_max = self.coll.all_reduce(local_max.reshape(1), "max")[0]
        return torch.sqrt(c_max ** 3 / (eps_last * eps_f32)).to(c.dtype)

    def _pcg(self, mv, b, x0, M, tol, adaptive: bool, dot=None, dot2=None):
        cfg = self.cfg
        if adaptive:
            return pcg_masked(mv, b, x0=x0, precond=M, tol=tol,
                              max_iters=cfg.pcg_max_iters, dot=dot,
                              dot2=dot2, step_scope=self.coll.pcg_step,
                              planned=self._planning)
        return pcg_fixed_iters(mv, b, x0=x0, precond=M,
                               n_iters=cfg.pcg_max_iters,
                               record_history=False, dot=dot, dot2=dot2,
                               step_scope=self.coll.pcg_step)

    def _irls(self, solve, prepare, frac, zeros):
        """The IRLS schedule of both routes.

        ``solve(eps, initial, x0, tol, ctx)`` builds and solves one
        iteration's system and returns (v, rel, iters, clamp hits);
        ``prepare(v)`` is what the next system and the fractional cut read
        of ``v`` (the halo exchange; ``v`` itself on psum); ``frac(v, ctx)``
        is the all-reduced ‖CBx‖₁, a device scalar.

        The adaptive state machine runs on all-reduced scalars, so every
        rank takes the SAME early-exit decision.  ``prepare(v)`` of the
        post-iteration voltages powers both the fractional cut and the next
        system: the early exit adds one scalar all-reduce per IRLS
        iteration and nothing per PCG step.  In a planning run (``lower``)
        nothing is read on the host: no iteration freezes, every PCG takes
        its ``pcg_max_iters`` masked steps, and the fractional cut is
        reduced but not read — the adaptive program at its largest trip
        count."""
        cfg = self.cfg
        eps_np = eps_schedule_array(cfg)
        adaptive = sched.is_adaptive(cfg)
        tight = cfg.pcg_tight_tol
        tol0 = sched.initial_tol(cfg, tight) if adaptive else cfg.pcg_tol
        self.coll.scope = "irls"
        v, _, _, _ = solve(cfg.eps, True, zeros, tol0, None)
        rels, iters, nclamps = [], [], []
        if not adaptive:
            for eps_l in eps_np:
                x0 = v if cfg.warm_start else torch.zeros_like(v)
                v, rel, _, nc = solve(float(eps_l), False, x0, cfg.pcg_tol,
                                      prepare(v))
                rels.append(rel)
                nclamps.append(nc)
            return v, rels, [cfg.pcg_max_iters] * cfg.n_irls, nclamps

        planning = self._planning
        ctx = prepare(v)
        f = frac(v, ctx)
        st = None if planning else sched.init_state(cfg, float(f), tight)
        for eps_l in eps_np:
            done = not planning and bool(st.done)
            x0 = v if cfg.warm_start else torch.zeros_like(v)
            # a done solve freezes: tol=∞ parks its PCG at 0 iterations
            tol = tol0 if planning else sched.inner_tol(st)
            v2, rel, it, nc = solve(float(eps_l), False, x0, tol, ctx)
            if done:
                v2 = v
            ctx = prepare(v2)
            f = frac(v2, ctx)
            rels.append(rel)
            if planning:
                iters.append(it)
                nclamps.append(nc)
            else:
                it = int(it)
                iters.append(0 if done else it)
                nclamps.append(torch.zeros_like(nc) if done else nc)
                st = sched.advance(cfg, st, float(f), float(rel), it, tight)
            v = v2
        return v, rels, iters, nclamps

    # -- halo schedule --------------------------------------------------------
    def _run_halo(self, t):
        cfg, coll = self.cfg, self.coll
        nl = self.plan.nl
        nb, bs = self.block_plan.nb, self.block_plan.bs
        use_block = cfg.precond in ("block_jacobi",)
        compression = self.halo_compression
        adaptive = sched.is_adaptive(cfg)
        fused = self.ell is not None
        eps_np = eps_schedule_array(cfg)
        clamp = bool(cfg.reweight_clamp)
        eps_last = float(eps_np[-1]) if len(eps_np) else float(cfg.eps)
        heads, tails, c = t["heads"], t["tails"], t["c"]
        c_s, c_t, valid, export = t["c_s"], t["c_t"], t["valid"], t["export"]
        dtype, dev = c.dtype, c.device
        zero = torch.zeros((), dtype=dtype, device=dev)
        one = torch.ones((), dtype=dtype, device=dev)

        cap = self._clamp_cap(c, c_s, c_t, eps_last) if clamp else None

        def local_dot(a, b_):
            return torch.dot(a * valid, b_ * valid)

        dot, dot2 = psum_dots(coll, local_dot)

        def exchange(x):
            return halo_exchange(coll, x, export, compression)

        def make_precond(r_copies, diag):
            if not use_block:
                return lambda x: x / diag
            A = torch.zeros((nb, bs, bs), dtype=dtype, device=dev)
            rvals = r_copies[t["copy_id"]] * t["copy_valid"]
            A.index_put_((t["copy_b"], t["copy_i"], t["copy_j"]), -rvals,
                         accumulate=True)
            node_b, node_s = t["node_b"], t["node_s"]
            A.index_put_((node_b, node_s, node_s),
                         torch.where(valid > 0, diag, zero), accumulate=True)
            occ = torch.zeros((nb, bs), dtype=dtype, device=dev)
            occ[node_b, node_s] = valid     # one slot per node: max = set
            eye = torch.eye(bs, dtype=dtype, device=dev)
            A = A + eye * (1.0 - occ)[:, None, :]
            # a block that is not positive definite gets a NaN factor, as
            # the JAX package's Cholesky returns (core.precond does so too)
            chol, info = torch.linalg.cholesky_ex(A)
            chol.masked_fill_((info != 0)[:, None, None], float("nan"))

            def apply_M(x):
                xb = torch.zeros((nb, bs), dtype=x.dtype, device=dev)
                xb[node_b, node_s] = x * valid
                yb = torch.cholesky_solve(xb[..., None], chol)[..., 0]
                return yb[node_b, node_s] * valid
            return apply_M

        def system(eps, initial, ext):
            """One iteration's (matvec, b, per-copy r, diag, clamp hits).

            Fused: the whole build is ONE row-parallel sweep over the local
            ELL-staged edges with the halo-extended vector — the halo-aware
            fused edge sweep.  Unfused (``fuse_edge_sweep=False``): the
            per-copy passes.  ``ext`` is ``halo_exchange(v)`` (unused when
            ``initial`` — W⁰ = C needs no voltages)."""
            nclamp = torch.zeros((), dtype=torch.int32, device=dev)
            if fused:
                ell_c = t["c_ell"]
                if initial:
                    r_s, r_t = c_s, c_t
                    vals = -ell_c
                    diag = ell_c.sum(dim=1) + r_s + r_t
                else:
                    sweep = (kops.fused_ell_sweep if cfg.use_pallas
                             else lap.fused_ell_sweep)
                    vals, diag, r_s, r_t = sweep(t["cols32"], ell_c, c_s,
                                                 c_t, ext, eps)
                    if clamp:
                        # ELL stores r negated (vals = −r); the sweep
                        # already folded r into diag, so subtract the
                        # excess back out instead of re-summing rows
                        excess = torch.clamp(-vals - cap, min=0.0)
                        vals = vals + excess
                        diag = diag - excess.sum(dim=1)
                        exc_s = torch.clamp(r_s - cap, min=0.0)
                        exc_t = torch.clamp(r_t - cap, min=0.0)
                        r_s, r_t = r_s - exc_s, r_t - exc_t
                        diag = diag - exc_s - exc_t
                        nclamp = ((excess > 0).sum() + (exc_s > 0).sum()
                                  + (exc_t > 0).sum()).to(torch.int32)
                diag = torch.where(valid > 0, diag, one)
                # gather-back for the block-Jacobi assembly (one
                # ml-element read against the sweep's 2m)
                r_copies = -vals[t["copy_row"], t["copy_lane"]]
                mv_ell = make_ell_halo_matvec(t["cols"], vals, diag)

                def mv(x):
                    return mv_ell(x, exchange(x))
                return mv, r_s, r_copies, diag, nclamp
            if initial:
                r, r_s, r_t = c, c_s, c_t
            else:
                r = coo_reweight(t["heads32"], t["tails32"], c, ext, eps,
                                 cfg.use_pallas)
                r_s, r_t = lap.terminal_conductances(c_s, c_t, ext[:nl], eps)
                if clamp:
                    nclamp = ((r > cap).sum() + (r_s > cap).sum()
                              + (r_t > cap).sum()).to(torch.int32)
                    r = torch.minimum(r, cap)
                    r_s = torch.minimum(r_s, cap)
                    r_t = torch.minimum(r_t, cap)
            deg = torch.zeros(nl, dtype=dtype, device=dev).index_add_(
                0, heads, r)
            diag = torch.where(valid > 0, deg + r_s + r_t, one)
            mv_halo = make_halo_matvec(nl)

            def mv(x):
                return mv_halo(exchange(x), heads, tails, r, diag)
            return mv, r_s, r, diag, nclamp

        def solve_wls(eps, initial, x0, tol, ext):
            mv, b, r_copies, diag, nclamp = system(eps, initial, ext)
            M = make_precond(r_copies, diag)
            res = self._pcg(mv, b, x0, M, tol, adaptive, dot, dot2)
            # clamp hits are a diagnostic: reduce only when the clamp is
            # live so the default program keeps its collective census
            nc = coll.all_reduce(nclamp) if clamp else nclamp
            return res.x * valid, res.rel_res, res.iters, nc

        def frac_of(v_, ext_):
            return coll.all_reduce(halo_l1_local(heads, tails, c, c_s, c_t,
                                                 v_, ext_))

        return self._irls(solve_wls, exchange, frac_of,
                          torch.zeros(nl, dtype=dtype, device=dev))

    # -- psum schedule ----------------------------------------------------------
    def _run_psum(self, t):
        cfg, coll = self.cfg, self.coll
        n_pad = self.plan.n_pad
        adaptive = sched.is_adaptive(cfg)
        eps_np = eps_schedule_array(cfg)
        clamp = bool(cfg.reweight_clamp)
        eps_last = float(eps_np[-1]) if len(eps_np) else float(cfg.eps)
        src, dst, c, c_s, c_t = t["src"], t["dst"], t["c"], t["c_s"], t["c_t"]
        dtype, dev = c.dtype, c.device
        # v is REPLICATED here, so plain local dots already see the whole
        # vector — the only collective per PCG step is the matvec's n-float
        # all-reduce (psum_matvec)

        cap = self._clamp_cap(c, c_s, c_t, eps_last) if clamp else None

        def conductances(v, eps, initial):
            nclamp = torch.zeros((), dtype=torch.int32, device=dev)
            if initial:
                r, r_s, r_t = c, c_s, c_t
            else:
                r = coo_reweight(t["src32"], t["dst32"], c, v, eps,
                                 cfg.use_pallas)
                r_s, r_t = lap.terminal_conductances(c_s, c_t, v, eps)
                if clamp:
                    # edges are sharded (reduce the count); terminals are
                    # REPLICATED — count them once, not once per rank
                    nclamp = (coll.all_reduce((r > cap).sum().to(torch.int32))
                              + (r_s > cap).sum()
                              + (r_t > cap).sum()).to(torch.int32)
                    r = torch.minimum(r, cap)
                    r_s = torch.minimum(r_s, cap)
                    r_t = torch.minimum(r_t, cap)
            zeros = lambda: torch.zeros(n_pad, dtype=dtype, device=dev)
            deg = zeros().index_add_(0, src, r)
            deg = deg + zeros().index_add_(0, dst, r)
            deg = coll.all_reduce(deg)
            total = deg + r_s + r_t
            diag = torch.where(total > 0, total, torch.ones_like(total))
            return r, r_s, r_t, diag, nclamp

        def solve_wls(eps, initial, x0, tol, v):
            r, r_s, r_t, diag, nclamp = conductances(v, eps, initial)
            rs_rt = r_s + r_t

            def mv(x):
                return psum_matvec(coll, x, src, dst, r, rs_rt, n_pad)
            res = self._pcg(mv, r_s, x0, lambda x: x / diag, tol, adaptive)
            return res.x, res.rel_res, res.iters, nclamp

        def l1(v_, _ctx):
            # edges are sharded (one all-reduce); terminals replicated
            z = c * (v_[src] - v_[dst])
            edge = coll.all_reduce(z.abs().sum())
            return (edge + (c_s * (1.0 - v_)).abs().sum()
                    + (c_t * v_).abs().sum())

        return self._irls(solve_wls, lambda v_: v_, l1,
                          torch.zeros(n_pad, dtype=dtype, device=dev))

    # -- execution --------------------------------------------------------------
    def _fake_mode(self):
        from torch._guards import detect_fake_mode
        from torch._subclasses.fake_tensor import FakeTensorMode

        if self._mode is None:
            self._mode = detect_fake_mode(list(self._t.values())) \
                or FakeTensorMode()
        return self._mode

    def arrays(self) -> Tuple[torch.Tensor, ...]:
        """This rank's shard: its uploaded plan rows on its device, in the
        order that ``_body`` and ``abstract_inputs`` take them."""
        return tuple(self._t.values())

    def abstract_inputs(self):
        """``arrays()`` as fake tensors: the solve body's arguments."""
        from torch._subclasses.fake_tensor import FakeTensor

        mode = self._fake_mode()
        return tuple(t if isinstance(t, FakeTensor) else mode.from_tensor(t)
                     for t in self.arrays())

    def _body(self, *arrays):
        """The solve body on this rank's shard ``arrays``
        (``abstract_inputs``' order): the IRLS loop and, on the halo
        schedule, the final gather of the voltages, as ``solve`` runs them.
        Returns (voltages, rels, iters, clamp hits) on the device."""
        t = dict(zip(self._t, arrays))
        self.coll.reset()
        self.coll.scope = "setup"
        if self.schedule == "halo":
            out, rels, iters, nclamps = self._run_halo(t)
            out = self.coll.all_gather(out)
        else:
            out, rels, iters, nclamps = self._run_psum(t)
        self.coll.scope = "setup"
        return out, rels, iters, nclamps

    def lower(self):
        """The planning run of the solve body on ``abstract_inputs``
        (``launch.hlo_analysis.analyze``): its costs, memory and collective
        census a rank.  A fixed schedule plans as it runs; an adaptive one
        at its largest trip count (``_irls``), marked ``bound="upper"``."""
        from ..launch import hlo_analysis

        cfg = self.cfg

        def plan(n_irls):
            self.cfg = dataclasses.replace(cfg, n_irls=n_irls)
            self._planning = True
            try:
                return hlo_analysis.analyze(self._body,
                                            self.abstract_inputs(),
                                            self._fake_mode(), coll=self.coll)
            finally:
                self.cfg = cfg
                self._planning = False

        if cfg.n_irls <= 2 or cfg.eps_schedule is not None:
            out = plan(cfg.n_irls)
        else:
            # the body-once correction: every IRLS iteration after the
            # first runs the same ops, so plan 1 and 2 and extrapolate to T
            out = hlo_analysis.extrapolate(plan(1), plan(2), cfg.n_irls - 1)
        out.bound = "upper" if sched.is_adaptive(cfg) else "exact"
        return out

    def compiled(self):
        """``lower()``'s plan, cached."""
        if self._planned is None:
            self._planned = self.lower()
        return self._planned

    def work_shape(self):
        """The ``obs.perf.profile.SolveShape`` of this rank's shard: its
        rows (nl on the halo schedule, the replicated n_pad on psum) and its
        directed copies or edges, the halo's ELL width and its sub-block
        preconditioner (Cholesky factors, applied by triangular solves)."""
        from ..obs.perf import profile as perf_profile

        cfg, rank = self.cfg, self.rank
        if self.schedule == "psum":
            return perf_profile.solve_shape(
                dataclasses.replace(cfg, layout="coo"), self.plan.n_pad,
                self.plan.src.shape[1], precond="jacobi")
        copies = self.plan.heads.shape[1]
        block = cfg.precond == "block_jacobi"
        return perf_profile.solve_shape(
            dataclasses.replace(cfg, layout="coo" if self.ell is None else "ell",
                                explicit_block_inverse=False),
            self.plan.nl, copies,
            ell_k=self.ell.k if self.ell is not None else 0,
            slots=int(np.count_nonzero(self.plan.c[rank])),
            blocks=self.block_plan.nb if block else 0,
            bs=self.block_plan.bs if block else 0,
            precond="block_jacobi" if block else "jacobi")

    def collective_stats(self) -> Dict[str, object]:
        """The collective census of the latest ``solve()`` on this rank (the
        same on every rank): calls and bytes per scope (``setup``,
        ``irls``, ``pcg_step``) and op, the CG steps taken and the
        ``pcg_step`` scope per step (``collectives.Collectives.stats``)."""
        return self.coll.stats()

    def _record_collective_gauges(self) -> None:
        per = self.collective_stats()["per_pcg_step"]
        reg = get_registry()
        reg.gauge(f"sharded_{self.schedule}_collectives_per_pcg_step").set(
            per.get("calls", 0.0))
        reg.gauge(f"sharded_{self.schedule}_collective_bytes_per_pcg_step"
                  ).set(per.get("bytes", 0.0))

    def check_float32_divergence(self, rels=None) -> Optional[float]:
        """Host-side sentinel: will the reweight ceiling c²/ε blow past the
        float32 stability threshold as the IRLS converges?

        The reweight r = c²/√((c·Δv)² + ε²) approaches c²/ε on settled
        edges (Δv → 0), so the conductance spread is set by ε RELATIVE to
        the weight scale: with ε_rel = ε / max(c) the normalized spread is
        1/ε_rel, and it crosses ``float32_divergence_threshold(ε_rel)``
        exactly when ε_rel < εf32 (float32 machine eps ≈ 1.19e-7) — the
        regime that diverges (ε = 1e-8 at unit weights) while ε = 1e-6
        stays safe.  Deterministic (weights + config only, no solved
        voltages needed); ``rels`` (per-IRLS final PCG relative residuals)
        is only consulted to name the first stalled iteration in the
        warning.  Returns the offending max conductance c²_max/ε when it
        breaches (after warning), else None.  No-op for float64 configs.
        """
        inst = self._instance
        if inst is None or torch_dtype(self.cfg) != torch.float32:
            return None
        eps_sched = eps_schedule_array(self.cfg)
        eps = float(eps_sched[-1]) if len(eps_sched) else float(self.cfg.eps)
        c_max = 0.0
        for arr in (inst.graph.weight, inst.s_weight, inst.t_weight):
            a = np.asarray(arr, dtype=np.float64)
            if a.size:
                c_max = max(c_max, float(np.max(a, initial=0.0)))
        if c_max <= 0:
            return None
        eps_rel = eps / c_max
        thresh = float32_divergence_threshold(eps_rel)
        if 1.0 / eps_rel <= thresh:
            return None
        r_max = c_max * c_max / eps
        stalled_iter = None
        if rels is not None:
            r = np.asarray(rels, dtype=np.float64)
            bad = np.nonzero(~np.isfinite(r) | (r > 1.0))[0]
            if bad.size:
                stalled_iter = int(bad[0])
        get_registry().counter("sharded_float32_divergence_total").inc()
        trace.event("sharded.float32_divergence", max_conductance=r_max,
                    threshold=thresh, eps=eps, eps_rel=eps_rel,
                    stalled_iter=stalled_iter, schedule=self.schedule,
                    clamped=bool(self.cfg.reweight_clamp))
        if self.cfg.reweight_clamp:
            # the mitigation is active: the reweights are capped AT the
            # threshold, so the spread the PCG sees stays representable —
            # keep the counter + trace event for the record, skip the
            # warning (nothing is about to diverge)
            return r_max
        at_iter = (f"; PCG stalled (rel residual > 1 or non-finite) first "
                   f"at IRLS iteration {stalled_iter}"
                   if stalled_iter is not None else "")
        warnings.warn(Float32DivergenceWarning(
            f"sharded IRLS reweights will reach ~{r_max:.3e} as edges "
            f"settle — past the float32 stability threshold "
            f"({thresh:.3e} at weight-relative eps {eps_rel:.3e}): the "
            f"PCG quadratic forms lose their significant digits at this "
            f"conductance spread and the iteration can stall or diverge"
            f"{at_iter}.  Raise cfg.eps (>= ~{c_max * 1.2e-7:.1e} at this "
            f"weight scale; 1e-6 is safe at unit weights) or switch "
            f"cfg.dtype to float64"), stacklevel=3)
        return r_max

    def solve(self):
        """Run the sharded IRLS on this rank (every rank calls it).

        Returns ``(v, rels, iters)``: voltages in ORIGINAL node order (the
        same on every rank), the per-IRLS-iteration final PCG relative
        residual, and the PCG iterations actually spent per IRLS iteration
        (``pcg_max_iters`` under the fixed schedule; drops to 0 once the
        adaptive mask froze the solve — the direct measure of what the
        early exit saved).
        """
        with trace.span("sharded.solve", schedule=self.schedule, p=self.p,
                        n=self.plan.n):
            out, rels, iters, nclamps = self._body(*self.arrays())
            if self.schedule == "halo":
                v = out.reshape(-1).cpu().numpy()[self.plan.perm]
            else:
                v = out.cpu().numpy()[: self.plan.n]
            rels = (torch.stack(rels).cpu().numpy() if rels
                    else np.zeros(0, dtype=np.float32))
            iters = np.asarray(iters, dtype=np.int32)
            # total reweight-clamp hits across the IRLS sweep (always 0
            # when cfg.reweight_clamp is off); session telemetry reads it
            self.last_clamped = int(torch.stack(nclamps).sum()) \
                if nclamps else 0
            if self.last_clamped:
                get_registry().counter(
                    "sharded_clamped_reweights_total").inc(self.last_clamped)
            self.check_float32_divergence(rels=rels)
            if trace.enabled():
                self._record_collective_gauges()
        return v, rels, iters
