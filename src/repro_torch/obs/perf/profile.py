"""Continuous profiling: the work of a solve, counted from its shapes.

The JAX package reads FLOP and byte counts from XLA's ``cost_analysis()``
of each compiled program; torch compiles no program to ask.  The port
counts instead: every operation of a solve has a term (``Work``: FLOPs
and the bytes it must move, each input read once and each output written
once), and a solve is a sum of terms, from the instance's shapes and the
steps it took:

    systems built  T + 1 (the cold W⁰ = C system, then one per IRLS
                   iteration): the sweep, or the COO reweight and the
                   degrees, the block factorization, and the r₀ matvec
                   and preconditioner apply of each PCG call
    CG steps       the PCG trace (``pcg_per_iter``): per step one matvec,
                   one preconditioner apply, and the vector updates and
                   inner products

The terms of the three hot kernels are the bounds of ``chip_smoke.py``'s
kernel table (``ell_matvec``, ``ell_sweep``, ``block_apply``), so a
solve's roofline and a kernel's read the same bytes.  Nothing depends on
the route: ``cfg.use_pallas`` picks who does the work, not how much there
is, so the kernel route and the plain route of one solve count the same.

Rates and the roofline are the H100's (NVIDIA's SXM data sheet, at the
full 700 W power limit): 3.35 TB/s of HBM, 67 TFLOP/s in float32 outside
the tensor cores (the solver's arithmetic).  Collective bytes (the
sharded solver's census, ``distributed.collectives``) are reported and
not timed: no link rate was measured for them.

Counting costs a few Python operations a solve, so profiling follows the
JAX package's switch: on when ``REPRO_PROFILE=1`` or the tracing layer is
enabled, off for plain solves.
"""
from __future__ import annotations

import os
from typing import Any, Dict, NamedTuple, Optional

__all__ = ["default_enabled", "per_solve_cost", "PROFILE_ENV",
           "HBM_BYTES_PER_S", "PEAK_F32_FLOP_PER_S", "Work", "SolveShape",
           "solve_shape", "terms", "solve_work"]

PROFILE_ENV = "REPRO_PROFILE"

#: NVIDIA H100 SXM data sheet: HBM3 rate and the float32 rate outside the
#: tensor cores (the rates of a card at its full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

F32 = 4          # values (the solver runs in float32)
IDX = 4          # int32 indices, as the kernels take them


def default_enabled() -> bool:
    """Profile by default?  ``REPRO_PROFILE`` (1/0) wins; otherwise
    follow the tracing switch — a traced run wants the device-side
    counters, an untraced unit test does not."""
    env = os.environ.get(PROFILE_ENV, "").strip().lower()
    if env in ("1", "true", "on", "yes"):
        return True
    if env in ("0", "false", "off", "no"):
        return False
    from .. import trace
    return trace.enabled()


class Work(NamedTuple):
    flops: float
    hbm_bytes: float

    def __add__(self, other: "Work") -> "Work":
        return Work(self.flops + other.flops, self.hbm_bytes + other.hbm_bytes)

    def __mul__(self, k: float) -> "Work":
        return Work(self.flops * k, self.hbm_bytes * k)


NONE = Work(0.0, 0.0)


class SolveShape(NamedTuple):
    """What the count needs of a solve's configuration and instance.

    rows, edges    : nodes and undirected edges (a shard's rows and its
                     directed copies on the sharded solver)
    layout, fused  : "ell" or "coo"; whether one sweep builds the system
    k, slots       : ELL width and the filled slots (2m; copies on a shard)
    precond        : the preconditioner that runs ("none", "jacobi",
                     "chebyshev", "block_jacobi")
    blocks, bs     : block-Jacobi blocks and their padded size
    explicit       : block Jacobi applied through explicit inverses
    cheby_degree   : Chebyshev degree
    """

    rows: int
    edges: int
    layout: str
    fused: bool
    k: int
    slots: int
    precond: str
    blocks: int
    bs: int
    explicit: bool
    cheby_degree: int


def solve_shape(cfg, rows: int, edges: int, ell_k: int = 0,
                slots: Optional[int] = None, blocks: int = 0, bs: int = 0,
                precond: Optional[str] = None) -> SolveShape:
    """The ``SolveShape`` of ``cfg`` on an instance of ``rows`` nodes and
    ``edges`` edges (``ell_k``: the ELL plan's width; ``blocks``/``bs``:
    the block plan's; ``precond`` overrides the config's where a driver
    runs another)."""
    layout = cfg.layout
    return SolveShape(
        rows=int(rows), edges=int(edges), layout=layout,
        fused=bool(layout == "ell" and cfg.fuse_edge_sweep),
        k=int(ell_k), slots=int(2 * edges if slots is None else slots),
        precond=precond or cfg.precond, blocks=int(blocks), bs=int(bs),
        explicit=bool(cfg.explicit_block_inverse),
        cheby_degree=int(cfg.cheby_degree))


# -- the terms: bytes = inputs read once + outputs written once --------------

def ell_matvec(rows: int, k: int, slots: int) -> Work:
    """y = diag·v + Σ_lane vals·v[cols]: cols and vals [rows, k], diag, v,
    y [rows]; a multiply-add per filled slot and two flops per row (the
    ``ell_spmv`` bound of the kernel table)."""
    return Work(2 * slots + 2 * rows, (IDX + F32) * rows * k + 3 * F32 * rows)


def ell_sweep(rows: int, k: int, slots: int) -> Work:
    """The fused sweep: cols and c_ell [rows, k], c_s, c_t, v in; vals
    [rows, k], diag, r_s, r_t out; ~10 flops per filled slot, ~12 per row
    (the ``fused_ell_sweep`` bound of the kernel table)."""
    return Work(10 * slots + 12 * rows,
                (IDX + 2 * F32) * rows * k + 6 * F32 * rows)


def ell_fill(rows: int, k: int, edges: int) -> Work:
    """The unfused ELL value fill: r [m] in, vals [rows, k] out."""
    return Work(0, F32 * edges + F32 * rows * k)


def edge_reweight(rows: int, edges: int) -> Work:
    """r_e = c_e²/√((c_e(v[src]−v[dst]))² + ε²): src, dst, c, v in, r out;
    ~7 flops per edge (the ``edge_reweight`` bound of the kernel table)."""
    return Work(7 * edges, 2 * IDX * edges + 2 * F32 * edges + F32 * rows)


def terminal_reweight(rows: int) -> Work:
    """r_s, r_t from c_s, c_t and v: ~7 flops each per row."""
    return Work(14 * rows, 5 * F32 * rows)


def degrees(rows: int, edges: int) -> Work:
    """diag = Σ_{e∋u} r_e + r_s + r_t: r and both endpoint lists, r_s and
    r_t in, diag out; two adds per edge, two per row."""
    return Work(2 * edges + 2 * rows,
                (2 * IDX + F32) * edges + 3 * F32 * rows)


def coo_matvec(rows: int, edges: int) -> Work:
    """y = Σ r_e(v[src]−v[dst]) at both ends + (r_s + r_t)·v: src, dst, r,
    v, r_s, r_t in, y out; four flops per edge and three per row."""
    return Work(4 * edges + 3 * rows,
                (2 * IDX + F32) * edges + 4 * F32 * rows)


def jacobi_apply(rows: int) -> Work:
    return Work(rows, 3 * F32 * rows)


def block_apply(blocks: int, bs: int) -> Work:
    """y[p] = M⁻¹[p] x[p] over blocks of bs² (the ``block_diag_matvec``
    bound of the kernel table; two triangular solves against the Cholesky
    factor move and compute the same)."""
    return Work(2 * blocks * bs * bs, F32 * blocks * bs * bs
                + 2 * F32 * blocks * bs)


def block_factor(blocks: int, bs: int, rows: int, edges: int,
                 explicit: bool) -> Work:
    """Assemble and factorize the blocks once per system: r and diag in,
    the factor (or the explicit inverse) out; bs³/3 flops a block for the
    Cholesky, and 2·bs³ more for the explicit inverse (two triangular
    solves against the identity)."""
    per = bs ** 3 / 3 + (2 * bs ** 3 if explicit else 0)
    return Work(blocks * per, F32 * edges + F32 * rows
                + F32 * blocks * bs * bs)


def cg_vectors(rows: int) -> Work:
    """One CG step's vector work beside the matvec and the apply: the
    inner products p·Ap and [r·z, r·r] and the updates of x, r and p."""
    return Work(12 * rows, 14 * F32 * rows)


def terms(shape: SolveShape) -> Dict[str, Work]:
    """The solve's per-unit work: ``initial_system`` (W⁰ = C),
    ``system`` (one IRLS iteration's build), ``factorization`` (per system
    built), ``matvec`` and ``precond`` (per PCG call and per CG step) and
    ``cg_vectors`` (per CG step)."""
    s = shape
    if s.layout == "ell":
        mv = ell_matvec(s.rows, s.k, s.slots)
        fill = ell_fill(s.rows, s.k, s.edges)
    else:
        mv = coo_matvec(s.rows, s.edges)
        fill = NONE
    initial = degrees(s.rows, s.edges) + fill
    if s.fused:
        system = ell_sweep(s.rows, s.k, s.slots)
    else:
        system = (edge_reweight(s.rows, s.edges) + terminal_reweight(s.rows)
                  + degrees(s.rows, s.edges) + fill)
    factor = NONE
    if s.precond == "block_jacobi" and s.blocks:
        factor = block_factor(s.blocks, s.bs, s.rows, s.edges, s.explicit)
        apply = block_apply(s.blocks, s.bs)
    elif s.precond == "chebyshev":
        apply = mv * (s.cheby_degree - 1) + Work(10 * s.rows,
                                                 14 * F32 * s.rows)
    elif s.precond == "none":
        apply = NONE
    else:
        apply = jacobi_apply(s.rows)
    return {"initial_system": initial, "system": system,
            "factorization": factor, "matvec": mv, "precond": apply,
            "cg_vectors": cg_vectors(s.rows)}


def solve_work(shape: SolveShape, systems: int, steps: int,
               cold: bool = True) -> Dict[str, Any]:
    """The work of a solve that built ``systems`` systems (the W⁰ = C one
    first when ``cold``; a warm start reweights from its voltages at once)
    and took ``steps`` CG steps in all: ``{"flops", "hbm_bytes", "terms":
    {name: {"count", "flops", "hbm_bytes"}}}``."""
    t = terms(shape)
    first = 1 if cold and systems else 0
    counts = {"initial_system": first, "system": systems - first,
              "factorization": systems,
              "matvec": systems + steps, "precond": systems + steps,
              "cg_vectors": steps}
    out = {name: {"count": int(counts[name]),
                  "flops": float(t[name].flops * counts[name]),
                  "hbm_bytes": float(t[name].hbm_bytes * counts[name])}
           for name in t}
    return {"flops": sum(v["flops"] for v in out.values()),
            "hbm_bytes": sum(v["hbm_bytes"] for v in out.values()),
            "terms": out}


def per_solve_cost(cost: Optional[Dict[str, float]], seconds: float,
                   calls: float = 1.0) -> Optional[Dict[str, Any]]:
    """Scale a per-call cost record to one solve and derive rates.

    ``calls`` — executions of ``cost`` this solve ran (the host backend
    counts per IRLS iteration, the scanned and sharded ones per solve).
    ``seconds`` — the solve's IRLS wall.  The roofline fraction compares
    the wall with the least time the card could take for the counted work:
    the larger of the FLOPs over the float32 rate and the bytes over the
    HBM rate (collective bytes are reported, not timed).
    """
    if cost is None:
        return None
    flops = cost["flops"] * calls
    hbm = cost["hbm_bytes"] * calls
    coll = cost.get("collective_bytes", 0.0) * calls
    out: Dict[str, Any] = {
        "flops": flops, "hbm_bytes": hbm, "collective_bytes": coll,
        "program_calls": float(calls),
    }
    if seconds and seconds > 0:
        out["achieved_gflops"] = flops / seconds / 1e9
        out["achieved_gbps"] = hbm / seconds / 1e9
        t_roof = max(flops / PEAK_F32_FLOP_PER_S, hbm / HBM_BYTES_PER_S)
        out["roofline_fraction"] = t_roof / seconds
    return out
