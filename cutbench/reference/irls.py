"""Plain PyTorch IRLS for the s,t minimum cut, written from the algorithm's
definition (Algorithm 1 of the PIRMCut paper, eqs. 4-8) for the benchmark's
comparison.  It imports nothing of the program: it takes the graph and the
weights as arrays, builds its own reduced Laplacian, preconditioner and
schedule, and works in the dtype it is given (float64 as the reference,
bfloat16 as the control).

The voltage vector covers the n non-terminal nodes (x_s = 1, x_t = 0 folded
in).  Each IRLS iteration reweights every edge, r_e = c_e² / sqrt((c_e Δx_e)²
+ ε²), a terminal edge by the same rule (zero-capacity terminal edges carry
no conductance), and solves L̃ x = r_s, where L̃ is the Laplacian of the
non-terminal graph under r plus the diagonal r_s + r_t.  The first system
takes r = c (W⁰ = C) from x = 0; later ones start from the previous x.

Two schedules, as the configurations state them:

* ``solve_fixed`` — T iterations, each a PCG run to ‖r‖/‖b‖ ≤ tol or
  ``max_iters`` steps (the test comes before every step), block Jacobi
  over a given partition or point Jacobi.  Given the step counts that a
  solver under test reported (``follow``), each system takes exactly that
  many steps instead.  ``stall_residual`` judges where such a solve
  stalled: the relative residual of the system reweighted at its answer,
  at that answer.
* ``solve_adaptive`` — a batch of lanes, each with the early-exit rule:
  the inner tolerance starts loose and follows half the relative change of
  the fractional cut ‖CBx‖₁, clipped to [tight, loose] and never loosened;
  a reading counts toward convergence when the change is within
  ``irls_tol`` and the inner solve reached the tight tolerance or its step
  cap; ``patience`` such readings in a row freeze the lane, whose voltages
  then stay as they are.  A warm lane skips the first system and starts
  from the voltages it is given.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class Graph:
    """The non-terminal edges (int64, shared by every lane) and one weight
    row per lane: ``c`` (B, m), ``cs``/``ct`` (B, n)."""

    src: torch.Tensor
    dst: torch.Tensor
    c: torch.Tensor
    cs: torch.Tensor
    ct: torch.Tensor

    @property
    def n(self) -> int:
        return self.cs.shape[-1]


def make_graph(src, dst, c, cs, ct, dtype, device) -> Graph:
    """A ``Graph`` from host arrays; ``c``, ``cs`` and ``ct`` may be one
    weight vector or a stack of lanes."""
    def rows(a):
        t = torch.as_tensor(a, dtype=torch.float64).to(device=device)
        return (t[None] if t.dim() == 1 else t).to(dtype)

    def idx(a):
        return torch.as_tensor(a).to(device=device, dtype=torch.int64)

    return Graph(idx(src), idx(dst), rows(c), rows(cs), rows(ct))


def reweight(g: Graph, x: torch.Tensor, eps: float):
    """Eq. 4: (r, r_s, r_t) at voltages ``x`` (B, n)."""
    e2 = eps * eps
    z = g.c * (x[:, g.src] - x[:, g.dst])
    r = g.c * g.c / torch.sqrt(z * z + e2)
    zs = g.cs * (1 - x)
    zt = g.ct * x
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    rs = torch.where(g.cs > 0, g.cs * g.cs / torch.sqrt(zs * zs + e2), zero)
    rt = torch.where(g.ct > 0, g.ct * g.ct / torch.sqrt(zt * zt + e2), zero)
    return r, rs, rt


def degree(g: Graph, r, rs, rt) -> torch.Tensor:
    d = rs + rt
    d = d.index_add(1, g.src, r)
    return d.index_add(1, g.dst, r)


def matvec(g: Graph, r, rs, rt, x) -> torch.Tensor:
    """y = L̃ x."""
    flux = r * (x[:, g.src] - x[:, g.dst])
    y = (rs + rt) * x
    y = y.index_add(1, g.src, flux)
    return y.index_add(1, g.dst, -flux)


def dot(a, b) -> torch.Tensor:
    return (a * b).sum(-1)


def l1_objective(g: Graph, x) -> torch.Tensor:
    """‖CBx‖₁, the fractional cut of the voltages, one value per lane."""
    return ((g.c * (x[:, g.src] - x[:, g.dst])).abs().sum(-1)
            + (g.cs * (1 - x)).abs().sum(-1) + (g.ct * x).abs().sum(-1))


class Boxes:
    """A block-Jacobi partition: ``labels`` (n,) in [0, P), each part
    padded to ``bs`` slots; the intra-part edges index the blocks."""

    def __init__(self, labels, src, dst, device):
        labels = torch.as_tensor(labels).to(device=device, dtype=torch.int64)
        self.p = int(labels.max()) + 1
        counts = torch.bincount(labels, minlength=self.p)
        self.bs = int(counts.max())
        order = torch.argsort(labels, stable=True)
        start = torch.cumsum(counts, 0) - counts
        slot = torch.empty_like(labels)
        slot[order] = torch.arange(labels.numel(), device=device) - start[labels[order]]
        self.block, self.slot = labels, slot
        src = torch.as_tensor(src).to(device=device, dtype=torch.int64)
        dst = torch.as_tensor(dst).to(device=device, dtype=torch.int64)
        self.intra = torch.nonzero(labels[src] == labels[dst]).flatten()
        self.ib = labels[src[self.intra]]
        self.ii = slot[src[self.intra]]
        self.ij = slot[dst[self.intra]]
        occupied = torch.zeros((self.p, self.bs), dtype=torch.bool, device=device)
        occupied[labels, slot] = True
        self.pad = ~occupied

    def factor(self, r, diag, work_dtype):
        """Cholesky factors of the diagonal blocks of L̃ (one lane), in
        ``work_dtype`` (a Cholesky needs float32 at least)."""
        A = torch.zeros((self.p, self.bs, self.bs), dtype=work_dtype,
                        device=diag.device)
        ri = -r[0, self.intra].to(work_dtype)
        A.index_put_((self.ib, self.ii, self.ij), ri, accumulate=True)
        A.index_put_((self.ib, self.ij, self.ii), ri, accumulate=True)
        A.index_put_((self.block, self.slot, self.slot),
                     diag[0].to(work_dtype), accumulate=True)
        A.diagonal(dim1=1, dim2=2).add_(self.pad.to(work_dtype))
        L, info = torch.linalg.cholesky_ex(A)
        if bool((info != 0).any()):
            raise FloatingPointError("a diagonal block is not positive definite")
        return L

    def apply(self, L, x):
        """M⁻¹x for one lane by the blocks' factors."""
        xb = torch.zeros((self.p, self.bs), dtype=L.dtype, device=x.device)
        xb[self.block, self.slot] = x[0].to(L.dtype)
        yb = torch.cholesky_solve(xb[..., None], L)[..., 0]
        return yb[self.block, self.slot][None].to(x.dtype)


def _work_dtype(dtype):
    return torch.float64 if dtype == torch.float64 else torch.float32


def pcg(A, b, x0, M, tol, max_iters: int, follow=None):
    """Preconditioned CG on a batch of lanes (B, n), each lane stopping on
    its own ‖r‖ ≤ tol·‖b‖ (``tol`` a (B,) tensor; ∞ takes no step).  The test
    comes before every step.  ``M`` is a zero-argument factory of the
    preconditioner's apply, called only once some lane takes a step.
    ``follow`` (B,) int64: each lane takes exactly that many steps (at most
    ``max_iters``), the test aside.  Returns (x, steps per lane, final
    relative residual per lane)."""
    x = x0
    bb = dot(b, b)
    bb = torch.where(bb > 0, bb, torch.ones_like(bb))
    tol2 = tol.to(bb.dtype) ** 2 * bb
    r = b - A(x)
    rr = dot(r, r)
    steps = torch.zeros(b.shape[0], dtype=torch.int64, device=b.device)

    def still(rr):
        return rr > tol2 if follow is None else steps < follow

    active = still(rr)
    if max_iters > 0 and bool(active.any()):
        apply_m = M()
        z = apply_m(r)
        p = z
        rz = dot(r, z)
        for _ in range(max_iters):
            if not bool(active.any()):
                break
            Ap = A(p)
            pAp = dot(p, Ap)
            alpha = torch.where(active, rz / torch.where(pAp != 0, pAp, 1), 0)
            x = x + alpha[:, None] * p
            r = r - alpha[:, None] * Ap
            z = apply_m(r)
            rz_new = dot(r, z)
            beta = rz_new / torch.where(rz != 0, rz, 1)
            p = torch.where(active[:, None], z + beta[:, None] * p, p)
            rz = torch.where(active, rz_new, rz)
            rr = torch.where(active, dot(r, r), rr)
            steps = steps + active.to(torch.int64)
            active = still(rr)
    return x, steps, torch.sqrt(rr / bb)


def _system(g: Graph, x, eps, boxes: Optional[Boxes], first: bool):
    if first:
        r, rs, rt = g.c, g.cs, g.ct
    else:
        r, rs, rt = reweight(g, x, eps)
    diag = degree(g, r, rs, rt)

    def A(y):
        return matvec(g, r, rs, rt, y)

    if boxes is None:
        def M():
            return lambda y: y / diag
    else:
        def M():
            # the blocks from the conductances rounded to the lanes' dtype,
            # assembled and factored in float32 at least
            w = _work_dtype(x.dtype)
            d = degree(g, r.to(w), rs.to(w), rt.to(w))
            L = boxes.factor(r.to(w), d, w)
            return lambda y: boxes.apply(L, y)
    return A, rs, M


def solve_fixed(g: Graph, eps: float, n_irls: int, tol: float,
                max_iters: int, boxes: Optional[Boxes] = None,
                follow=None):
    """The fixed schedule on one lane: returns (x (1, n), PCG steps per
    system).  ``follow``: the n_irls + 1 step counts to take, one per
    system, in place of the stopping rule."""
    if follow is not None and len(follow) != n_irls + 1:
        raise ValueError(f"{len(follow)} step counts for the "
                         f"{n_irls + 1} systems of the schedule")
    x = torch.zeros_like(g.cs)
    tols = torch.full((1,), tol, dtype=torch.float64, device=x.device)
    steps = []
    for it in range(n_irls + 1):
        A, b, M = _system(g, x, eps, boxes, first=it == 0)
        fix = None
        if follow is not None:
            fix = torch.full((1,), min(int(follow[it]), max_iters),
                             dtype=torch.int64, device=x.device)
        x, s, _ = pcg(A, b, x, M, tols, max_iters, follow=fix)
        steps.append(int(s[0]))
    return x, steps


def stall_residual(g: Graph, x, eps: float) -> torch.Tensor:
    """‖b − L̃x‖/‖b‖ of the system reweighted at ``x`` (B, n), at ``x``:
    at most the PCG tolerance where a fixed-schedule solve stalled there,
    since its last system then took no step from ``x``."""
    A, b, _ = _system(g, x, eps, None, first=False)
    r = b - A(x)
    return torch.sqrt(dot(r, r) / dot(b, b))


def solve_adaptive(g: Graph, eps: float, n_irls: int, max_iters: int,
                   irls_tol: float, patience: int, loose: float,
                   tight: float, x0: Optional[torch.Tensor] = None):
    """The early-exit schedule on a batch of lanes (see the module's
    docstring).  ``x0`` (B, n) warm-starts every lane.  Returns (x, PCG
    steps per lane and iteration)."""
    dev, f64 = g.cs.device, torch.float64
    B = g.cs.shape[0]
    if x0 is None:
        A, b, M = _system(g, torch.zeros_like(g.cs), eps, None, first=True)
        x, _, _ = pcg(A, b, torch.zeros_like(g.cs), M,
                      torch.full((B,), loose, dtype=f64, device=dev), max_iters)
    else:
        x = x0.to(g.cs.dtype)
    frac = l1_objective(g, x).to(f64)
    tol = torch.full((B,), loose, dtype=f64, device=dev)
    small = torch.zeros(B, dtype=torch.int64, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    spent = []
    for _ in range(n_irls):
        A, b, M = _system(g, x, eps, None, first=False)
        inner = torch.where(done, torch.full_like(tol, float("inf")), tol)
        xs, steps, rel = pcg(A, b, x, M, inner, max_iters)
        x = torch.where(done[:, None], x, xs)
        spent.append(torch.where(done, 0, steps))
        f = l1_objective(g, x).to(f64)
        change = (f - frac).abs() / frac.abs().clamp(min=1e-30)
        tol = torch.where(done, tol, torch.minimum(
            tol, change.mul(0.5).clamp(min=tight, max=loose)))
        solved = (rel.to(f64) <= tight * 1.001) | (steps >= max_iters)
        qual = (change <= irls_tol) & solved
        small = torch.where(done, small, torch.where(qual, small + 1, 0))
        frac = torch.where(done, frac, f)
        done = done | (small >= patience)
    return x, torch.stack(spent, dim=-1)
