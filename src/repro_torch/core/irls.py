"""PIRMCut IRLS driver (paper Algorithm 1, eqs. 4–5), host loop in torch.

The solver alternates

  Step 1 (reweight):  w_e = sqrt((CBx)_e² + ε²);  conductances r = c²/w
  Step 2 (WLS):       solve  L̃(r) v = b(r)  with PCG (warm-started)

starting from x⁰ = the solution with W⁰ = C, for T iterations; x^(T) then
goes to rounding (core/rounding.py).

Each iteration's system is built by ONE dispatch helper
(``_iteration_system``): either one fused sweep over the slot-major edge
data (``fuse_edge_sweep`` + ``layout="ell"``; the CUDA kernel
kernels/csrc/fused_ell_sweep.cu under ``use_pallas``, the plain torch sweep
otherwise) or the separate passes (reweight, value fill, rhs).  Under
``use_pallas`` the ELL matvec is the CUDA kernel kernels/csrc/ell_spmv.cu
and the explicit-inverse block-Jacobi apply is
kernels/csrc/block_diag_matvec.cu; on the unfused path the COO reweight is
kernels/csrc/edge_reweight.cu.  ``use_pallas`` keeps the JAX package's
name, so one kwargs dict builds the config of both packages.

Two drivers:

* ``run_host_loop`` — one IRLS iteration per ``_Stepper`` call, PCG stopping
  on tolerance, full diagnostics (the ``"host"`` backend).
* ``make_scanned_program`` — the JAX package's scanned program: all T
  iterations on a fixed or convergence-masked schedule, on one instance or
  on a batch of B same-topology lanes (the ``"scanned"`` backend and
  ``MinCutSession.solve_batch``).  Where the JAX package vmaps a
  ``lax.scan``, the port writes the lane dimension out and runs the T
  iterations as a host loop.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from . import adaptive as sched
from . import laplacian as lap
from . import precond as pc
from ..kernels import ops as kops
from .incidence import (CooPlan, DeviceGraph, l1_objective,
                        smoothed_objective)
from .pcg import pcg, pcg_fixed_iters, pcg_masked


@dataclasses.dataclass(frozen=True)
class IRLSConfig:
    """All paper knobs (§5.4 defaults) + framework extensions; the fields and
    defaults of the JAX package's ``IRLSConfig``."""

    eps: float = 1e-6                 # smoothing parameter ε
    n_irls: int = 50                  # T
    pcg_tol: float = 1e-3             # relative-residual stop
    pcg_max_iters: int = 50           # paper uses 50 at scale / 300 in §5.2
    warm_start: bool = True
    precond: str = "block_jacobi"     # jacobi | block_jacobi | chebyshev | none
    n_blocks: int = 16                # block-Jacobi part count ("processes" p)
    explicit_block_inverse: bool = False  # batched-matvec apply path
    cheby_degree: int = 4
    eps_schedule: Optional[str] = None  # None | "anneal" (ε: 1e-2 → eps)
    layout: str = "coo"               # coo | ell  (matvec layout)
    dtype: str = "float32"
    use_pallas: bool = False          # route sweep/matvec/apply through the
                                      # hand-written CUDA kernels
    # -- adaptive early exit; all zero/False is the fixed paper schedule
    irls_tol: float = 0.0             # rel. fractional-cut change that marks
                                      # an instance converged; 0 = run all T
    irls_patience: int = 2            # consecutive sub-irls_tol iterations
                                      # required before freezing
    adaptive_tol: bool = False        # Eisenstat–Walker inner tolerance
    pcg_loose_tol: float = 0.1        # loosest inner tolerance adaptive_tol
                                      # may use
    pcg_tight_tol: float = 1e-6       # tight end of the scanned schedule
                                      # (not used by the host driver)
    fuse_edge_sweep: bool = True      # build the per-iteration system in one
                                      # edge sweep (ELL layout only)
    reweight_clamp: bool = False      # sharded float32 mitigation (sharded
                                      # backend only; not ported yet)


@dataclasses.dataclass
class IRLSDiagnostics:
    pcg_iters: List[int]
    pcg_residuals: List[float]
    objective: List[float]            # smoothed S_ε(x^l)
    l1_objective: List[float]         # exact ‖CBx‖₁ (fractional cut value)
    voltages: Optional[List[np.ndarray]]  # per-iteration x (polarization study)
    setup_time: float = 0.0
    irls_time: float = 0.0


def torch_dtype(cfg: IRLSConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _eps_at(cfg: IRLSConfig, l: int) -> float:
    if cfg.eps_schedule == "anneal":
        # geometric continuation 1e-2 → eps over the first 60% of iterations
        hot, cold = 1e-2, cfg.eps
        frac = min(1.0, l / max(1, int(0.6 * cfg.n_irls)))
        return float(hot * (cold / hot) ** frac)
    return cfg.eps


def eps_schedule_array(cfg: IRLSConfig) -> np.ndarray:
    """ε for iterations 1..T as an array."""
    return np.asarray([_eps_at(cfg, l) for l in range(1, cfg.n_irls + 1)])


def _fused(cfg: IRLSConfig, ell_plan: Optional[lap.EllPlan]) -> bool:
    return cfg.fuse_edge_sweep and cfg.layout == "ell" and ell_plan is not None


def _ell_matvec(cfg: IRLSConfig, ell_plan: lap.EllPlan, vals, diag):
    if cfg.use_pallas:
        return lambda v: kops.ell_spmv(ell_plan.cols, vals, diag, v)
    return lambda v: lap.matvec_ell(ell_plan.cols, vals, diag, v)


def _make_matvec(g: DeviceGraph, rw: lap.Reweighted, cfg: IRLSConfig,
                 ell_plan: Optional[lap.EllPlan]):
    if cfg.layout == "ell":
        vals, diag = lap.fill_ell(ell_plan, rw)
        return _ell_matvec(cfg, ell_plan, vals, diag)
    return lambda v: lap.matvec_coo(g, rw, v)


def _reweight(g: DeviceGraph, v, eps, cfg: IRLSConfig) -> lap.Reweighted:
    """The reweight dispatch of the unfused path."""
    if cfg.use_pallas:
        return lap.reweight(g, v, eps, edge_r=kops.edge_reweight_r)
    return lap.reweight(g, v, eps)


def _iteration_system(g: DeviceGraph, cfg: IRLSConfig,
                      ell_plan: Optional[lap.EllPlan], c_ell, v, eps):
    """Build one IRLS iteration's system: returns ``(matvec, b, rw)``.

    Fused path (ELL layout + ``fuse_edge_sweep``): reweight → ELL value fill
    → diagonal → RHS in ONE sweep over the edge data.  ``c_ell`` is the
    once-per-solve slot-major weight stage (``lap.ell_edge_weights``); None
    builds it here.  Unfused path: the separate passes."""
    if not _fused(cfg, ell_plan):
        rw = _reweight(g, v, eps, cfg)
        return _make_matvec(g, rw, cfg, ell_plan), lap.rhs(rw), rw
    if c_ell is None:
        c_ell = lap.ell_edge_weights(ell_plan, g.c)
    sweep = kops.fused_ell_sweep if cfg.use_pallas else lap.fused_ell_sweep
    vals, diag, r_s, r_t = sweep(ell_plan.cols, c_ell, g.c_s, g.c_t, v, eps)
    # the per-edge conductances: any REGISTRY preconditioner may index rw.r
    # (block_jacobi does); one m-element gather against the sweep's 2m
    r = lap.edge_r_from_vals(ell_plan, vals)
    rw = lap.Reweighted(r=r, r_s=r_s, r_t=r_t, diag=diag)
    return _ell_matvec(cfg, ell_plan, vals, diag), r_s, rw


class _Stepper:
    """One IRLS iteration per call, on the device of its graph.

    The topology (src/dst and plans) is fixed at construction; the edge and
    terminal weights are arguments, so one stepper serves every
    same-topology weight vector."""

    def __init__(self, g: DeviceGraph, cfg: IRLSConfig,
                 block_plan: Optional[pc.BlockPlan],
                 ell_plan: Optional[lap.EllPlan]):
        self.g = g
        self.cfg = cfg
        self.block_plan = block_plan
        self.ell_plan = ell_plan

    def stage_edge_weights(self, weights=None):
        """Slot-major ELL weight stage for the fused sweep, computed ONCE per
        solve; None when the config doesn't run the fused path."""
        if not _fused(self.cfg, self.ell_plan):
            return None
        c = weights[0] if weights is not None else self.g.c
        return lap.ell_edge_weights(self.ell_plan, c)

    def _step(self, v, eps, *, first: bool, weights=None, tol=None,
              c_ell=None):
        cfg = self.cfg
        c, c_s, c_t = (weights if weights is not None
                       else (self.g.c, self.g.c_s, self.g.c_t))
        tol = cfg.pcg_tol if tol is None else tol
        g = self.g._replace(c=c, c_s=c_s, c_t=c_t)
        if first:
            rw = lap.initial_weights(g)
            matvec = _make_matvec(g, rw, cfg, self.ell_plan)
            b = lap.rhs(rw)
        else:
            matvec, b, rw = _iteration_system(g, cfg, self.ell_plan, c_ell,
                                              v, eps)
        apply_M = pc.make_preconditioner(cfg.precond, rw, matvec, cfg,
                                         self.block_plan)
        x0 = v if (cfg.warm_start and not first) else torch.zeros_like(v)
        res = pcg(matvec, b, x0=x0, precond=apply_M, tol=tol,
                  max_iters=cfg.pcg_max_iters, record_history=True)
        s_eps = smoothed_objective(g, res.x, eps)
        frac_cut = l1_objective(g, res.x)
        return res.x, res.iters, res.rel_res, s_eps, frac_cut


def run_host_loop(stepper: _Stepper, cfg: IRLSConfig, n: int, dtype,
                  v0=None, collect_voltages: bool = False, weights=None,
                  c_ell=None):
    """Drive a ``_Stepper`` through the IRLS loop; returns (voltages, diag).

    ``v0`` — optional warm-start voltages (REORDERED frame): the cold initial
    WLS with W⁰ = C is skipped.  ``weights`` — optional device
    ``(c, c_s, c_t)`` (REORDERED frame) overriding the stepper's weights.
    ``c_ell`` — optional pre-staged slot-major ELL weights.

    Adaptive knobs run the state machine of core/adaptive.py on the
    recorded diagnostics: ``irls_tol > 0`` breaks out once converged,
    ``adaptive_tol`` feeds a per-iteration inner tolerance."""
    diag = IRLSDiagnostics(pcg_iters=[], pcg_residuals=[], objective=[],
                           l1_objective=[],
                           voltages=[] if collect_voltages else None)
    device = stepper.g.c.device
    t1 = time.perf_counter()
    adaptive = sched.is_adaptive(cfg)
    tight = cfg.pcg_tol          # the host PCG stops on tolerance anyway
    tol_l = sched.initial_tol(cfg, tight) if adaptive else cfg.pcg_tol
    st = None                    # AdaptiveState, seeded by the first reading
    if c_ell is None:
        c_ell = stepper.stage_edge_weights(weights)  # one scatter per SOLVE
    if v0 is None:
        v = torch.zeros((n,), dtype=dtype, device=device)
        # x⁰: WLS with W⁰ = C (cold start by definition)
        v, iters, rel, s_eps, frac = stepper._step(v, cfg.eps, first=True,
                                                   weights=weights, tol=tol_l)
        _record(diag, v, iters, rel, s_eps, frac, collect_voltages)
        if adaptive:
            st = sched.init_state(cfg, diag.l1_objective[-1], tight)
    else:
        v = torch.as_tensor(np.asarray(v0), device=device).to(dtype)
    for l in range(1, cfg.n_irls + 1):
        eps_l = _eps_at(cfg, l)
        v, iters, rel, s_eps, frac = stepper._step(v, eps_l, first=False,
                                                   weights=weights, tol=tol_l,
                                                   c_ell=c_ell)
        _record(diag, v, iters, rel, s_eps, frac, collect_voltages)
        if not adaptive:
            continue
        if st is None:           # warm start: first reading seeds the state
            st = sched.init_state(cfg, diag.l1_objective[-1], tight)
            continue
        st = sched.advance(cfg, st, diag.l1_objective[-1],
                           diag.pcg_residuals[-1], iters, tight)
        if cfg.adaptive_tol:
            tol_l = float(st.tol)
        if bool(st.done):
            break                  # converged: stop paying for matvecs
    if v.is_cuda:
        torch.cuda.synchronize(v.device)
    diag.irls_time = time.perf_counter() - t1
    return v, diag


def _record(diag, v, iters, rel, s_eps, frac, collect_voltages):
    diag.pcg_iters.append(int(iters))
    diag.pcg_residuals.append(float(rel))
    diag.objective.append(float(s_eps))
    diag.l1_objective.append(float(frac))
    if collect_voltages and diag.voltages is not None:
        diag.voltages.append(v.cpu().numpy().copy())


def solve(instance, cfg: IRLSConfig = IRLSConfig(),
          labels: Optional[np.ndarray] = None,
          collect_voltages: bool = False, device="cuda"):
    """Run PIRMCut IRLS on a host STInstance (one-shot path).

    ``labels`` — optional partition labels over non-terminal nodes for the
    block-Jacobi preconditioner; computed with the multilevel partitioner
    when absent.  Returns (v in original node order, diagnostics)."""
    from .session import Problem

    t0 = time.perf_counter()
    n_blocks = cfg.n_blocks if cfg.precond == "block_jacobi" else 1
    prob = Problem.build(instance, n_blocks=n_blocks, labels=labels)
    dtype = torch_dtype(cfg)
    g = prob.device_graph(dtype, device=device)
    block_plan = (prob.block_plan(device) if cfg.precond == "block_jacobi"
                  else None)
    ell_plan = prob.ell_plan(device) if cfg.layout == "ell" else None
    stepper = _Stepper(g, cfg, block_plan, ell_plan)
    setup_time = time.perf_counter() - t0

    v, diag = run_host_loop(stepper, cfg, g.n, dtype,
                            collect_voltages=collect_voltages)
    diag.setup_time = setup_time
    return prob.to_original(v.cpu().numpy()), diag


# ---------------------------------------------------------------------------
# Scanned driver (fixed or convergence-masked schedule), one instance or a
# batch of lanes
# ---------------------------------------------------------------------------

def _scanned_precond(cfg: IRLSConfig, rw, matvec,
                     block_plan: Optional[pc.BlockPlan]):
    """The scanned schedules need at least diagonal scaling: "none", and
    block Jacobi without a plan, run point Jacobi, as in the JAX package."""
    name = cfg.precond
    if name == "none" or (name == "block_jacobi" and block_plan is None):
        name = "jacobi"
    return pc.make_preconditioner(name, rw, matvec, cfg, block_plan)


def make_scanned_program(src, dst, cfg: IRLSConfig,
                         block_plan: Optional[pc.BlockPlan] = None,
                         ell_plan: Optional[lap.EllPlan] = None,
                         warm: bool = False, ext_stage: bool = False,
                         *, coo: CooPlan):
    """Build the weight-parameterized scanned IRLS program.

    Returns ``run(c, c_s, c_t) → (v, rels, iters)`` with the topology
    (src/dst and plans) closed over.  ``c`` may be (m,) or a batch (B, m),
    with ``c_s``/``c_t`` (n,) or (B, n); ``v`` then has the shape of
    ``c_s`` and ``rels``/``iters`` are (T,) or (B, T): per IRLS iteration the
    final PCG relative residual and the PCG iterations spent (0 once a lane
    is done).  ``warm=True`` builds ``run(c, c_s, c_t, v0)``, which skips
    the cold initial WLS (W⁰ = C) and reweights from the caller's voltages.

    Schedules, as in the JAX package:

    * fixed (``irls_tol == 0`` and not ``adaptive_tol``): T iterations of
      ``pcg_fixed_iters`` with ``pcg_max_iters`` steps each, no host sync.
    * adaptive: T iterations of the batched ``pcg_masked`` under the
      per-lane state machine of core/adaptive.py.  A done lane's inner
      tolerance is ∞, so its PCG takes no step and its voltages stay frozen
      while the other lanes go on.  All T iterations run, so ``rels`` and
      ``iters`` are full (B, T) arrays, as under ``jax.vmap``.

    ``ext_stage=True`` (fused ELL configs only) moves the once-per-solve
    slot-major weight staging out of the program: the caller passes the
    staged table right after the weights, ``run(c, c_s, c_t, c_ell[, v0])``
    with ``c_ell`` (n, k) or (B, n, k).  This is the delta-staging path:
    under sparse weight drift the session patches the previous staging
    (``lap.ell_edge_weights_delta``) instead of restaging all m edges.
    ``coo`` is the topology's ``incidence.CooPlan``."""
    if ext_stage and not _fused(cfg, ell_plan):
        raise ValueError("ext_stage requires the fused ELL path "
                         "(cfg.layout='ell' + fuse_edge_sweep + an ELL plan)")
    adaptive = sched.is_adaptive(cfg)
    tight = cfg.pcg_tight_tol
    eps_sched = [float(e) for e in eps_schedule_array(cfg)]

    def system(g, c_ell, v, eps_l):
        matvec, b, rw = _iteration_system(g, cfg, ell_plan, c_ell, v, eps_l)
        return matvec, b, _scanned_precond(cfg, rw, matvec, block_plan)

    def initial(g):
        rw0 = lap.initial_weights(g)
        matvec0 = _make_matvec(g, rw0, cfg, ell_plan)
        apply_M0 = _scanned_precond(cfg, rw0, matvec0, block_plan)
        if adaptive:
            return pcg_masked(matvec0, lap.rhs(rw0), precond=apply_M0,
                              tol=sched.initial_tol(cfg, tight),
                              max_iters=cfg.pcg_max_iters).x
        return pcg_fixed_iters(matvec0, lap.rhs(rw0), precond=apply_M0,
                               n_iters=cfg.pcg_max_iters,
                               record_history=False).x

    def fixed_step(g, c_ell, v, eps_l):
        matvec, b, apply_M = system(g, c_ell, v, eps_l)
        x0 = v if cfg.warm_start else torch.zeros_like(v)
        res = pcg_fixed_iters(matvec, b, x0=x0, precond=apply_M,
                              n_iters=cfg.pcg_max_iters, record_history=False)
        return res.x, res.rel_res

    def masked_step(g, c_ell, v, eps_l, st):
        matvec, b, apply_M = system(g, c_ell, v, eps_l)
        x0 = v if cfg.warm_start else torch.zeros_like(v)
        # a done lane's PCG is a no-op, not a discarded solve: tol=∞
        res = pcg_masked(matvec, b, x0=x0, precond=apply_M,
                         tol=sched.inner_tol(st), max_iters=cfg.pcg_max_iters)
        # done lanes freeze while the other lanes of the batch go on
        v_new = torch.where(st.done[..., None], v, res.x)
        spent = torch.where(st.done, 0, res.iters)
        st_new = sched.advance(cfg, st, l1_objective(g, v_new), res.rel_res,
                               res.iters, tight)
        return v_new, st_new, res.rel_res, spent

    def _run(c, c_s, c_t, v_warm, c_ell):
        g = DeviceGraph(src=src, dst=dst, c=c, c_s=c_s, c_t=c_t, coo=coo)
        # the slot-major ELL weights, staged ONCE per solve (unless the
        # caller staged them: the delta path)
        if c_ell is None and _fused(cfg, ell_plan):
            c_ell = lap.ell_edge_weights(ell_plan, c)
        v = v_warm.to(c.dtype) if warm else initial(g)
        rels, iters = [], []
        if not adaptive:
            for eps_l in eps_sched:
                v, rel = fixed_step(g, c_ell, v, eps_l)
                rels.append(rel)
            rels = torch.stack(rels, dim=-1)
            return v, rels, torch.full(rels.shape, cfg.pcg_max_iters,
                                       dtype=torch.int32, device=rels.device)
        # seeded from v0's own fractional cut: the cold-start behaviour, and
        # a converged warm start freezes after irls_patience iterations
        st = sched.init_state(cfg, l1_objective(g, v), tight)
        for eps_l in eps_sched:
            v, st, rel, spent = masked_step(g, c_ell, v, eps_l, st)
            rels.append(rel)
            iters.append(spent)
        return v, torch.stack(rels, dim=-1), torch.stack(iters, dim=-1)

    if ext_stage and warm:
        def run(c, c_s, c_t, c_ell, v0):
            return _run(c, c_s, c_t, v0, c_ell)
    elif ext_stage:
        def run(c, c_s, c_t, c_ell):
            return _run(c, c_s, c_t, None, c_ell)
    elif warm:
        def run(c, c_s, c_t, v0):
            return _run(c, c_s, c_t, v0, None)
    else:
        def run(c, c_s, c_t):
            return _run(c, c_s, c_t, None, None)
    return run


def solve_scanned(g: DeviceGraph, cfg: IRLSConfig,
                  block_plan: Optional[pc.BlockPlan] = None,
                  ell_plan: Optional[lap.EllPlan] = None):
    """The scanned program on one device graph (single or batched weights);
    returns ``(v, rels)``."""
    run = make_scanned_program(g.src, g.dst, cfg, block_plan, ell_plan,
                               coo=g.coo)
    v, rels, _ = run(g.c, g.c_s, g.c_t)
    return v, rels
