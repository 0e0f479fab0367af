"""The benchmark's plain reference: what a configuration's solver is meant
to compute, in plain PyTorch, independent of the program (it imports
nothing of it and takes nothing the program made).  ``solve`` runs the
schedule that a configuration's ``solver`` section states on a batch of
weight assignments of one topology and rounds each lane by the sweep cut.
Under the fixed schedule it may follow, lane by lane, the PCG step counts
that the solver under test reported (``follow``): its answer is then the
float64 solve along the same stopping decisions.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from . import cut, irls


def adaptive(solver: dict) -> bool:
    """Does the configuration state the early-exit schedule?"""
    return solver.get("irls_tol", 0.0) > 0.0 or solver.get("adaptive_tol", False)


def solve(solver: dict, driver: str, src, dst, weights: Sequence,
          labels: Optional[np.ndarray] = None, x0: Optional[np.ndarray] = None,
          dtype=torch.float64, device="cuda", follow=None):
    """Voltages and sweep cuts of ``weights`` (a list of (c, cs, ct) host
    arrays, one per lane) under the configuration's ``solver`` section and
    ``driver`` ("host": one lane at a time; "batched": the lanes together).
    ``labels`` is the block-Jacobi partition; ``x0`` (n,) warm-starts every
    lane.  The arithmetic runs in ``dtype`` (float64 for the reference).
    ``follow``: per lane, the step count of each system of the fixed
    schedule to take in place of its stopping rule.  Returns a list of
    (voltages float64 numpy, in_source, cut value, record): the fixed
    schedule's record holds ``steps``, the PCG steps of each system; the
    early-exit schedule's is empty."""
    g = irls.make_graph(src, dst, np.stack([w[0] for w in weights]),
                        np.stack([w[1] for w in weights]),
                        np.stack([w[2] for w in weights]), dtype, device)
    eps, T = float(solver["eps"]), int(solver["n_irls"])
    K = int(solver["pcg_max_iters"])
    records = [{} for _ in weights]
    if adaptive(solver):
        if follow is not None:
            raise NotImplementedError("the reference follows step counts "
                                      "under the fixed schedule only")
        if driver != "batched" or solver.get("eps_schedule"):
            raise NotImplementedError("the reference follows the early-exit "
                                      "schedule of the batched driver only")
        init = None
        if x0 is not None:
            init = torch.as_tensor(np.asarray(x0, dtype=np.float64),
                                   device=device).to(dtype).expand(g.cs.shape)
        x, _ = irls.solve_adaptive(
            g, eps, T, K, float(solver["irls_tol"]),
            int(solver.get("irls_patience", 2)),
            float(solver.get("pcg_loose_tol", 0.1)),
            float(solver.get("pcg_tight_tol", 1e-6)), x0=init)
    else:
        if driver != "host" or x0 is not None or solver.get("eps_schedule"):
            raise NotImplementedError("the reference follows the fixed "
                                      "schedule of the host driver, cold")
        boxes = None
        if solver.get("precond") == "block_jacobi":
            boxes = irls.Boxes(labels, src, dst, device)
        rows = []
        for lane in range(g.cs.shape[0]):
            one = irls.Graph(g.src, g.dst, g.c[lane:lane + 1],
                             g.cs[lane:lane + 1], g.ct[lane:lane + 1])
            x, steps = irls.solve_fixed(
                one, eps, T, float(solver["pcg_tol"]), K, boxes,
                follow=None if follow is None else follow[lane])
            rows.append(x)
            records[lane] = {"steps": steps}
        x = torch.cat(rows)
    out = []
    for lane in range(x.shape[0]):
        c, cs, ct = (torch.as_tensor(np.asarray(a, dtype=np.float64),
                                     device=device) for a in weights[lane])
        xl = x[lane].to(torch.float64)
        side, value = cut.sweep_cut(g.src, g.dst, c, cs, ct, xl)
        out.append((xl.cpu().numpy(), side.cpu().numpy(), value,
                    records[lane]))
    return out
