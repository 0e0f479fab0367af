"""The benchmark's yardstick: the card's published bandwidth and the bytes
that a kernel's work needs, from the shapes alone.

Each kernel's bytes count each input byte once and each output byte once
(a gathered vector is read once), whatever the kernel reads again.  The
formulas are frozen here, apart from the program, so that a later change
to a kernel does not move its yardstick.  A metric that reads another
kernel adds its formula here with it.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
F4 = 4                          # bytes of a float32 or an int32


def ell_spmv_bytes(n: int, k: int, lanes: int = 1) -> float:
    """y = diag⊙v + Σ_lane vals⊙v[cols]: cols (n, k) shared by the lanes;
    per lane vals (n, k), diag, v and y (n)."""
    return F4 * (n * k + lanes * (n * k + 3 * n))


def fused_ell_sweep_bytes(n: int, k: int, lanes: int = 1) -> float:
    """One IRLS system from the slot-major weights: reads cols, c_ell,
    c_s, c_t and v; writes vals, diag, r_s and r_t."""
    return F4 * (n * k + lanes * (2 * n * k + 6 * n))


def edge_reweight_bytes(n: int, m: int, lanes: int) -> float:
    """r_e for every edge of every lane: src and dst (m, shared), per lane
    c (m), v (n) and r (m)."""
    return F4 * (2 * m + lanes * (2 * m + n))
