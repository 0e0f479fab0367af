"""Plain PyTorch cut arithmetic for the benchmark's comparison: the value of
a partition, the fractional cut of voltages and the sweep cut of voltages,
in float64.  It imports nothing of the program."""
from __future__ import annotations

import torch


def cut_value(src, dst, c, cs, ct, in_source) -> float:
    """Σ c over edges with one end on each side, plus cs over the nodes on
    the sink side and ct over the nodes on the source side."""
    s = in_source
    return float((c * (s[src] != s[dst])).sum() + cs[~s].sum() + ct[s].sum())


def fractional_cut(src, dst, c, cs, ct, x) -> float:
    """‖CBx‖₁ of the voltages ``x`` (x_s = 1, x_t = 0)."""
    return float((c * (x[src] - x[dst]).abs()).sum() + (cs * (1 - x).abs()).sum()
                 + (ct * x.abs()).sum())


def sweep_cut(src, dst, c, cs, ct, x):
    """The best of the n + 1 cuts that put the nodes of highest voltage on
    the source side (ties by node id).  Returns (in_source, value)."""
    n = x.shape[0]
    order = torch.argsort(-x, stable=True)
    rank = torch.empty(n, dtype=torch.int64, device=x.device)
    rank[order] = torch.arange(n, device=x.device)
    # cut(i) for i in [0, n]: the top-i nodes on the source side.  An edge
    # crosses for i in (min rank, max rank]; an s-edge while its node is
    # outside (i <= rank); a t-edge while it is inside (i > rank).
    d = torch.zeros(n + 2, dtype=torch.float64, device=x.device)
    lo = torch.minimum(rank[src], rank[dst])
    hi = torch.maximum(rank[src], rank[dst])
    d.index_add_(0, lo + 1, c)
    d.index_add_(0, hi + 1, -c)
    d[0] += cs.sum()
    d.index_add_(0, rank + 1, ct - cs)
    cuts = torch.cumsum(d, 0)[: n + 1]
    best = int(torch.argmin(cuts))
    return rank < best, float(cuts[best])
