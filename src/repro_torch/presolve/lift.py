"""Lift kernel solutions back to the original vertex set.

Three lift targets:

* partitions (``lift_partition``) — boolean source-side indicators.
  Union-find-merged vertices inherit their root's side; terminal-merged
  vertices take the terminal's side; degree-2-eliminated vertices are
  filled by replaying the elimination journal *in reverse*: a node
  eliminated with incident weights (w_ua, w_ub) sits with the heavier
  neighbour (exactness argument in docs/API.md).
* voltages (``lift_voltages``) — same resolution order with float
  values; terminal-merged nodes pin to ``high``/``low`` so downstream
  sweep rounding still sees them on the correct extreme.
* certificates (``cut_certificate``) — recompute the lifted partition's
  cut value on the *original* instance and check it equals the kernel
  cut value plus the constant ``base``.  This is the end-to-end
  exactness witness: reductions cannot have changed the cut.

Journal replay order matters: an entry (u, a, b, ...) references nodes
that were alive when u was eliminated, so any later merge/elimination of
a or b appears *after* u's entry.  Replaying in reverse therefore
resolves a and b through the final union-find and already-filled journal
sides.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def _root_values(kernel, kernel_vals: Optional[np.ndarray],
                 s_val, t_val, dtype) -> np.ndarray:
    """Per-root value array over all n+2 ids, journal-replayed.

    ``kernel_vals`` maps kernel ids to values (None iff trivial kernel).
    """
    n = kernel.n
    S, T = n, n + 1
    parent = kernel.parent
    vals = np.zeros(n + 2, dtype=dtype)
    vals[S] = s_val
    vals[T] = t_val
    surv = kernel.kernel_of_root >= 0
    if kernel.kernel_n:
        if kernel_vals is None:
            raise ValueError("kernel solution required for a nontrivial kernel")
        kv = np.asarray(kernel_vals)
        if kv.shape[0] != kernel.kernel_n:
            raise ValueError(f"expected {kernel.kernel_n} kernel values, got {kv.shape[0]}")
        vals[surv] = kv[kernel.kernel_of_root[surv]].astype(dtype)
    # Reverse journal replay fills eliminated roots.  a/b were alive at
    # u's elimination, so their (final) roots are either terminals,
    # kernel survivors, or nodes eliminated *later* — already filled.
    J = kernel.journal
    for row in J[::-1]:
        u, a, b = int(row[0]), int(row[1]), int(row[2])
        wa, wb = float(row[3]), float(row[4])
        pick = a if wa >= wb else b
        vals[u] = vals[parent[pick]]
    return vals


def lift_partition(kernel, kernel_side: Optional[np.ndarray]) -> np.ndarray:
    """Map a kernel source-side indicator to the original n vertices."""
    vals = _root_values(kernel, kernel_side, True, False, bool)
    return vals[kernel.parent[:kernel.n]]


def lift_voltages(kernel, kernel_v: Optional[np.ndarray],
                  high: float = 1.0, low: float = 0.0) -> np.ndarray:
    """Map kernel voltages to the original vertices (source-side merged
    nodes at ``high``, sink-side at ``low``, journal nodes following the
    heavier neighbour — consistent with ``lift_partition`` under any
    threshold rounding)."""
    vals = _root_values(kernel, kernel_v, high, low, np.float64)
    return vals[kernel.parent[:kernel.n]]


def cut_certificate(kernel, kernel_side: Optional[np.ndarray]) -> Dict[str, float]:
    """Exact cut-value certificate for a lifted partition.

    Returns the kernel-side cut value (+ base), the recomputed original
    cut value of the lifted partition, and their relative gap — which
    must be ~0 (float summation order only) for exact reductions.
    """
    in_source = lift_partition(kernel, kernel_side)
    lifted = float(kernel.original.cut_value(in_source))
    if kernel.kernel_n:
        kcut = float(kernel.instance.cut_value(np.asarray(kernel_side, dtype=bool)))
    else:
        kcut = 0.0
    total = kcut + kernel.base
    denom = max(abs(total), abs(lifted), 1.0)
    return {
        "kernel_cut": kcut,
        "base": float(kernel.base),
        "stated_cut": total,
        "lifted_cut": lifted,
        "rel_gap": abs(total - lifted) / denom,
    }
