"""Preconditioners for the reduced-Laplacian PCG (paper §3.1–3.2).

The paper's choice is block Jacobi: blocks come from a k-way partition of the
non-terminal graph, factorized once per IRLS iteration and applied in
parallel.  Here, as in the JAX package:

* the nodes are reordered so each part is contiguous and padded to a fixed
  block size ``bs``;
* each IRLS iteration scatters the block diagonal of ``L̃`` into a batched
  dense tensor ``A[p, bs, bs]`` and factorizes it with one batched Cholesky;
* each PCG preconditioning step is a batched triangular solve or, with
  ``explicit_block_inverse``, a batched matvec against the explicit inverse
  — the CUDA kernel kernels/csrc/block_diag_matvec.cu under ``use_pallas``.

A point Jacobi and a Chebyshev polynomial preconditioner are the cheaper
options.  All of them take one instance or a batch of B lanes sharing one
block plan: a batch's blocks form one flat batch ``A[B·P, bs, bs]``, so the
Cholesky, the explicit inverse and the block_diag_matvec kernel see a single
block batch.  Strategies resolve through ``REGISTRY`` (name → factory
``(rw, matvec, cfg, block_plan) → apply_fn | None``).
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from .laplacian import Reweighted

PrecondFactory = Callable[..., Optional[Callable[[torch.Tensor], torch.Tensor]]]

REGISTRY: Dict[str, PrecondFactory] = {}


def register(name: str):
    """Register a preconditioner factory under ``cfg.precond == name``."""
    def deco(fn: PrecondFactory) -> PrecondFactory:
        REGISTRY[name] = fn
        return fn
    return deco


def make_preconditioner(name: str, rw: Reweighted, matvec, cfg,
                        block_plan: Optional["BlockPlan"] = None):
    """Resolve ``name`` through REGISTRY and build the per-iteration apply
    (``x → M⁻¹x``, or None for the identity)."""
    try:
        factory = REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown preconditioner {name!r}; "
                         f"registered: {sorted(REGISTRY)}") from None
    return factory(rw, matvec, cfg, block_plan)


class BlockPlan(NamedTuple):
    """Static block-Jacobi scatter plan (built once on host, like the paper's
    one-time symbolic factorization).

    node_block : int64[n]       block id of each (reordered) node
    node_slot  : int64[n]       position of each node inside its block
    intra_e    : int64[mi]      edge ids with both endpoints in one block
    intra_b    : int64[mi]      that block id
    intra_i/j  : int64[mi]      local slots of src/dst inside the block
    p, bs      : static ints    number of blocks / padded block size
    """

    node_block: torch.Tensor
    node_slot: torch.Tensor
    intra_e: torch.Tensor
    intra_b: torch.Tensor
    intra_i: torch.Tensor
    intra_j: torch.Tensor
    p: int
    bs: int


def build_block_plan_arrays(src, dst, labels, p: int, pad_to_multiple: int = 8):
    """Host-side plan construction (numpy arrays in the field order of
    ``BlockPlan``).  ``labels`` must already correspond to the *reordered*
    node ids (contiguous ranges per part)."""
    labels = np.asarray(labels, dtype=np.int64)
    n = labels.shape[0]
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    counts = np.bincount(labels, minlength=p)
    bs = int(counts.max()) if n else 1
    bs = max(8, -(-bs // pad_to_multiple) * pad_to_multiple)
    # slot within block = rank among same-label nodes (labels are sorted)
    starts = np.zeros(p + 1, dtype=np.int64)
    starts[1:] = np.cumsum(counts)
    slot = np.arange(n) - starts[labels]
    same = labels[src] == labels[dst]
    ie = np.nonzero(same)[0]
    return (labels, slot, ie, labels[src[ie]], slot[src[ie]], slot[dst[ie]],
            int(p), int(bs))


def build_block_plan(src, dst, labels, p: int, pad_to_multiple: int = 8,
                     device="cuda") -> BlockPlan:
    """The block plan of ``build_block_plan_arrays``, moved to ``device``."""
    *arrays, p, bs = build_block_plan_arrays(src, dst, labels, p,
                                             pad_to_multiple)
    return BlockPlan(*(torch.as_tensor(a, device=device) for a in arrays),
                     p=p, bs=bs)


def assemble_blocks(plan: BlockPlan, rw: Reweighted) -> torch.Tensor:
    """Scatter the block diagonal of L̃ into A[p, bs, bs] (A[B·p, bs, bs]
    for a batch of B lanes, lane-major).

    The diagonal is the FULL L̃ diagonal (cut-edge and terminal conductances
    included), so every block is strictly diagonally dominant ⇒ SPD; padded
    slots get the identity."""
    p, bs = plan.p, plan.bs
    dt, dev = rw.diag.dtype, rw.diag.device
    lanes = rw.diag.reshape(-1, rw.diag.shape[-1]).shape[0]
    A = torch.zeros((lanes, p, bs, bs), dtype=dt, device=dev)
    lane = torch.arange(lanes, device=dev)[:, None]
    r_in = rw.r[..., plan.intra_e].reshape(lanes, -1)
    A.index_put_((lane, plan.intra_b, plan.intra_i, plan.intra_j), -r_in,
                 accumulate=True)
    A.index_put_((lane, plan.intra_b, plan.intra_j, plan.intra_i), -r_in,
                 accumulate=True)
    A.index_put_((lane, plan.node_block, plan.node_slot, plan.node_slot),
                 rw.diag.reshape(lanes, -1), accumulate=True)
    # identity on padded slots keeps the batched Cholesky nonsingular
    occupied = torch.zeros((p, bs), dtype=dt, device=dev)
    occupied[plan.node_block, plan.node_slot] = 1.0
    pad = torch.arange(bs, device=dev)
    A[:, :, pad, pad] += 1.0 - occupied
    return A.reshape(lanes * p, bs, bs)


class BlockJacobi(NamedTuple):
    """Factorized block-Jacobi preconditioner state (per IRLS iteration)."""

    chol: torch.Tensor            # [(B·)p, bs, bs] lower Cholesky factors
    inv: Optional[torch.Tensor]   # [(B·)p, bs, bs] explicit inverses
    plan: BlockPlan


def factorize_blocks(plan: BlockPlan, rw: Reweighted,
                     explicit_inverse: bool = False) -> BlockJacobi:
    """Batched Cholesky of the assembled blocks.  A block that is not
    positive definite gets a NaN factor (and NaN inverse), as the JAX
    package's Cholesky returns, instead of an exception."""
    A = assemble_blocks(plan, rw)
    chol, info = torch.linalg.cholesky_ex(A)
    del A
    chol.masked_fill_((info != 0)[:, None, None], float("nan"))
    inv = None
    if explicit_inverse:
        eye = torch.eye(plan.bs, dtype=chol.dtype, device=chol.device)
        # row-major: on CUDA cholesky_solve returns column-major batches,
        # and the block_diag_matvec kernel reads rows
        inv = torch.cholesky_solve(eye.expand(chol.shape), chol).contiguous()
    return BlockJacobi(chol=chol, inv=inv, plan=plan)


def gather_blocks(plan: BlockPlan, x: torch.Tensor) -> torch.Tensor:
    """x[..., n] → the flat block batch xb[(B·)p, bs] (padded slots 0)."""
    xb = torch.zeros(x.shape[:-1] + (plan.p, plan.bs), dtype=x.dtype,
                     device=x.device)
    xb[..., plan.node_block, plan.node_slot] = x
    return xb.reshape(-1, plan.bs)


def scatter_blocks(plan: BlockPlan, xb: torch.Tensor, shape) -> torch.Tensor:
    """The inverse of ``gather_blocks``: back to a vector of ``shape``."""
    y = xb.reshape(-1, plan.p, plan.bs)[:, plan.node_block, plan.node_slot]
    return y.reshape(shape)


def block_diag_matvec(blocks: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y[p] = blocks[p] @ x[p]: the explicit-inverse apply.  The plain
    version of the block_diag_matvec kernel."""
    return torch.einsum("pij,pj->pi", blocks, x)


def apply_block_jacobi(M: BlockJacobi, x: torch.Tensor) -> torch.Tensor:
    """y = M⁻¹x via batched triangular solves, or a batched matvec with the
    explicit inverse when it was formed (plain torch; the CUDA kernel route
    is ``_make_block_jacobi`` under ``use_pallas``)."""
    xb = gather_blocks(M.plan, x)
    if M.inv is not None:
        yb = block_diag_matvec(M.inv, xb)
    else:
        yb = torch.cholesky_solve(xb[..., None], M.chol)[..., 0]
    return scatter_blocks(M.plan, yb, x.shape)


# ---------------------------------------------------------------------------
# Point Jacobi + Chebyshev polynomial options
# ---------------------------------------------------------------------------

def jacobi_apply(diag: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return x / diag


def make_chebyshev_apply(matvec: Callable[[torch.Tensor], torch.Tensor],
                         diag: torch.Tensor, degree: int = 4,
                         lam_max_scale: float = 1.1):
    """Chebyshev polynomial preconditioner for the Jacobi-scaled operator
    D^{-1/2} L̃ D^{-1/2}, whose spectrum sits in (0, 2): ``degree`` extra
    matvecs per apply and no factorization."""
    dh = torch.sqrt(diag)
    lam_max = 2.0 * lam_max_scale  # Gershgorin bound for scaled Laplacian
    lam_min = lam_max / 30.0
    theta = 0.5 * (lam_max + lam_min)
    delta = 0.5 * (lam_max - lam_min)

    def scaled_mv(y):
        return matvec(y / dh) / dh

    def apply(x):
        # Chebyshev semi-iteration (Saad, Iterative Methods §12.3) for the
        # symmetrically scaled system; z0 = 0.  A fixed polynomial, so a
        # valid SPD preconditioner for CG.
        b = x / dh
        r = b
        d = r / theta
        z = d
        sigma = theta / delta
        rho = 1.0 / sigma
        for _ in range(degree - 1):
            r = b - scaled_mv(z)
            rho_next = 1.0 / (2.0 * sigma - rho)
            d = rho_next * rho * d + (2.0 * rho_next / delta) * r
            z = z + d
            rho = rho_next
        return z / dh

    return apply


# ---------------------------------------------------------------------------
# Registry entries
# ---------------------------------------------------------------------------

@register("none")
def _make_none(rw, matvec, cfg, block_plan):
    return None


@register("jacobi")
def _make_jacobi(rw, matvec, cfg, block_plan):
    diag = rw.diag
    return lambda x: jacobi_apply(diag, x)


@register("chebyshev")
def _make_chebyshev(rw, matvec, cfg, block_plan):
    return make_chebyshev_apply(matvec, rw.diag, cfg.cheby_degree)


@register("block_jacobi")
def _make_block_jacobi(rw, matvec, cfg, block_plan):
    """Block Jacobi needs a partition plan; without one it degrades to point
    Jacobi, as in the JAX package."""
    if block_plan is None:
        return _make_jacobi(rw, matvec, cfg, block_plan)
    M = factorize_blocks(block_plan, rw, cfg.explicit_block_inverse)
    if cfg.use_pallas and M.inv is not None:
        from ..kernels import ops as kops
        return lambda x: scatter_blocks(
            M.plan, kops.block_diag_matvec(M.inv, gather_blocks(M.plan, x)),
            x.shape)
    return lambda x: apply_block_jacobi(M, x)
