"""Terminal-rebinding layer: one topology, any (u, v) cut pair.

The solver stack keys every expensive artifact — partition, plans, compiled
steppers, serving cache entries — on the TOPOLOGY (``topology_fingerprint``
deliberately excludes weights), and terminals live entirely in the weight
vectors (``c_s`` / ``c_t``).  Rebinding the cut pair is therefore *just a
weight change*: ``pin_pair(problem, u, v)`` returns a ``Weights`` whose only
terminal edges are s—u and t—v, and every solve under it reuses the
topology's compiled plans.  That is the primitive the Gusfield cut-tree
construction (``cuttree.gusfield``) drives n−1 times per topology — and
batches through ``MinCutSession.solve_batch``, since same-topology pair
solves are exactly what the vmapped scanned program was built for.

The terminal capacity (``strength``) defaults to ``1 + min(d_c(u), d_c(v))``
— already an upper bound on the u-v min cut, so the terminal edges can never
be the cut, while staying at the graph's own weight scale (IRLS conductances
stay well-conditioned where a big-M pin would not).  See
``core.session.rebind_terminals`` for the underlying helper.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from ..core.session import Problem, Weights, rebind_terminals
from ..graphs.structures import STInstance

ProblemLike = Union[Problem, STInstance]


def _instance_of(problem: ProblemLike) -> STInstance:
    return problem.instance if isinstance(problem, Problem) else problem


def pin_pair(problem: ProblemLike, u: int, v: int,
             c: Optional[np.ndarray] = None,
             strength: Optional[float] = None) -> Weights:
    """``Weights`` that make (u, v) the terminal pair of ``problem``'s
    topology: large-capacity one-hot ``c_s``/``c_t``, edge weights ``c``
    (default: the instance's own).  Solving under the result computes the
    u-v min cut of the non-terminal graph while reusing every compiled
    topology-level artifact."""
    return rebind_terminals(_instance_of(problem), u, v, c=c,
                            strength=strength)


def pin_pairs(problem: ProblemLike, pairs: Sequence[Tuple[int, int]],
              c: Optional[np.ndarray] = None,
              strength: Optional[float] = None) -> List[Weights]:
    """``pin_pair`` over a pair list — the batch the wave scheduler hands to
    ``MinCutSession.solve_batch`` (one degree pass shared across pairs)."""
    inst = _instance_of(problem)
    if strength is not None:
        return [rebind_terminals(inst, u, v, c=c, strength=strength)
                for u, v in pairs]
    if c is None:
        cc, deg = None, inst.graph.weighted_degrees()
    else:
        cc = np.asarray(c, dtype=np.float64)
        deg = np.zeros(inst.n, dtype=np.float64)
        np.add.at(deg, np.asarray(inst.graph.src), cc)
        np.add.at(deg, np.asarray(inst.graph.dst), cc)
    return [rebind_terminals(inst, u, v, c=cc,
                             strength=1.0 + min(deg[int(u)], deg[int(v)]))
            for u, v in pairs]


def graph_cut_value(instance: STInstance, in_side: np.ndarray,
                    c: Optional[np.ndarray] = None) -> float:
    """Cut value of a bipartition over the NON-TERMINAL graph only (terminal
    edges excluded — pinned pairs never cut theirs, and the tree stores the
    graph-level u-v cut)."""
    g = instance.graph
    w = np.asarray(g.weight if c is None else c, dtype=np.float64)
    ind = np.asarray(in_side, dtype=bool)
    crossing = ind[np.asarray(g.src)] != ind[np.asarray(g.dst)]
    return float(np.sum(w[crossing]))
