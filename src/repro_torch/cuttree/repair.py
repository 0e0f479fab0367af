"""Incremental cut-tree repair under weight drift.

A Gusfield tree answers all-pairs min-cut queries from n−1 pair solves,
but those solves were made against one weight vector.  When weights
drift, rebuilding from scratch re-solves every pair even though most
stored cuts are still optimal.  :func:`repair_cut_tree` replays the
original construction (the acceptance order ``build_cut_tree`` records
in ``meta["order"]``) and re-solves only the tree edges whose stored cut
can no longer be proven optimal; everything else is reused with its
value updated in closed form.

Why replay instead of patching edges in place: a pure "is the drifted
edge on the u-v tree path" test is unsound — lowering one edge's weight
can change the min-cut value of pairs whose tree path never touches it
(the new global structure routes a cheaper cut through the drifted
edge).  Replaying the recursive construction keeps every accepted edge a
true pair min cut, so the repaired tree carries the same guarantees as a
fresh build.

Reuse soundness.  Let ``d_e = c_new[e] - c_old[e]`` over the changed
edges, ``total_neg`` the sum of all negative ``d_e``, and for a stored
cut side ``s`` let ``S = sum of d_e over changed edges separated by s``.
Any (m, rep)-separating cut C satisfies ``new(C) = old(C) + sep(C)`` with
``old(C) >= oldval`` and ``sep(C) >= total_neg``, hence:

* Rule B: if ``S <= total_neg`` then ``new(C) >= oldval + total_neg >=
  oldval + S`` — the stored cut (new value ``oldval + S``) stays optimal.
* Rule C: if ``S <= 0``, a beating cut must separate some nonempty set
  N' of negative-delta edges (otherwise ``sep(C) >= 0`` and ``new(C) >=
  oldval >= oldval + S``).  For each such C, ``old(C) >=
  max(oldval, max_{e in N'} pathmin_old(e))`` — C separates (m, rep)
  and every pair in N', and the tree path-min lower-bounds each pair
  min cut by the min-cut ultrametric inequality — while ``sep(C) >=
  sum_{e in N'} d_e``.  Minimizing over N' (sort negatives by path-min
  ascending, prefix-sum their deltas) gives the reusability test

      min_k ( max(oldval, pm_(k)) + prefix_(k) )  >=  oldval + S.

Both rules need the stored values to be exact min cuts of their pairs,
so repair requires an ``exact``-solver or ``refine=True`` build.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from ..core.irls import IRLSConfig
from ..core.session import MinCutSession, Problem
from ..graphs.structures import EdgeList, STInstance
from ..obs import trace
from ..obs.metrics import get_registry

from .gusfield import (DEFAULT_CFG, _as_problem, _solve_wave_exact,
                       _solve_wave_irls)
from .tree import CutTree, pack_side


def _repairable(tree: CutTree) -> Optional[str]:
    """None if ``tree`` supports repair, else the reason it does not."""
    if tree.sides is None:
        return "tree was built with store_sides=False"
    if tree.meta.get("order") is None:
        return "tree lacks the build acceptance order in meta"
    if tree.meta.get("contracted"):
        return "Gomory-Hu (contracted) trees are not replayable"
    if not (tree.meta.get("solver") == "exact" or tree.meta.get("refined")):
        return ("stored values are approximate (IRLS build without "
                "refine) — reuse proofs need exact pair values")
    return None


def repair_cut_tree(problem: Union[Problem, STInstance], tree: CutTree,
                    c_old: np.ndarray, c_new: np.ndarray, *,
                    solver: str = "exact",
                    session: Optional[MinCutSession] = None,
                    cfg: Optional[IRLSConfig] = None,
                    rounding: str = "sweep",
                    batch: bool = True, max_batch: int = 64,
                    device="cuda") -> CutTree:
    """Repair ``tree`` (built under edge weights ``c_old``) for ``c_new``.

    Topology is unchanged — only edge weights drift (terminals are
    rebound per pair anyway).  Returns a new :class:`CutTree` whose
    every edge is a true pair min cut under ``c_new``; reused edges keep
    their stored side with the value updated to ``oldval + S`` (see
    module docstring), re-solved edges go through the same exact /
    batched-IRLS wave machinery as a fresh build; the IRLS re-solves run
    on ``device`` where no ``session`` is given.

    Raises ``ValueError`` when the tree cannot be repaired (no stored
    sides, no recorded build order, contracted build, or approximate
    values) — callers should fall back to ``build_cut_tree``.
    """
    reason = _repairable(tree)
    if reason is not None:
        raise ValueError(f"cut tree not repairable: {reason}")
    if solver not in ("irls", "exact"):
        raise ValueError(f"unknown solver {solver!r}; known: irls, exact")
    instance = (problem.instance if isinstance(problem, Problem)
                else problem)
    if session is not None:
        instance = session.problem.instance
    n = tree.n
    if instance.n != n:
        raise ValueError(f"tree n={n} does not match instance n={instance.n}")
    c_old = np.asarray(c_old, dtype=np.float64)
    c_new = np.asarray(c_new, dtype=np.float64)
    if c_old.shape != c_new.shape or c_old.shape[0] != instance.graph.m:
        raise ValueError("c_old/c_new must both match the instance edge count")
    root = tree.root

    t0 = time.perf_counter()
    changed = np.flatnonzero(c_old != c_new)
    src = np.asarray(instance.graph.src, dtype=np.int64)[changed]
    dst = np.asarray(instance.graph.dst, dtype=np.int64)[changed]
    d = (c_new - c_old)[changed]
    total_neg = float(d[d < 0].sum())

    # Rule C machinery: negatives sorted by old-tree path-min, with the
    # prefix sums of their deltas (both computed once on the OLD tree).
    neg = np.flatnonzero(d < 0)
    pm_neg = np.array([tree.min_cut(int(src[j]), int(dst[j]))
                       for j in neg])
    ordn = np.argsort(pm_neg)
    pm_sorted = pm_neg[ordn]
    pref = np.cumsum(d[neg][ordn]) if neg.size else np.zeros(0)

    # Per-edge validation: S (separated-delta sum) and reuse validity.
    S = np.zeros(n)
    valid = np.zeros(n, dtype=bool)
    old_side = np.zeros((n, n), dtype=bool)   # unpacked stored sides
    for m in range(n):
        if m == root:
            continue
        s = tree.side_of(m)
        old_side[m] = s
        if changed.size:
            sep = s[src] != s[dst]
            S[m] = float(d[sep].sum())
        oldval = float(tree.weight[m])
        bound = (float(np.min(np.maximum(oldval, pm_sorted) + pref))
                 if neg.size else np.inf)
        valid[m] = (S[m] <= total_neg
                    or (S[m] <= 0.0 and bound >= oldval + S[m]))

    inst_new = STInstance(
        graph=EdgeList(src=instance.graph.src, dst=instance.graph.dst,
                       weight=c_new, n=n),
        s_weight=instance.s_weight, t_weight=instance.t_weight)
    deg = inst_new.graph.weighted_degrees()
    if solver == "irls" and session is None:
        prob = _as_problem(problem, None)
        session = MinCutSession(prob, cfg or DEFAULT_CFG, backend="scanned",
                                device=device)
    if solver == "irls":
        cfg = cfg or session.cfg

    order = [int(m) for m in tree.meta["order"]]

    def _reuse(m: int, r: int) -> Optional[Tuple[float, np.ndarray]]:
        """Reusable old cut for the pair (m, r), or None.

        Flow equivalence gives the OLD min cut of any pair from the old
        tree: the bottleneck edge b on the m-r tree path has value
        ``mincut_old(m, r)`` and its stored side is an optimal cut —
        whenever that side actually separates m from r (Gusfield trees
        only guarantee it for the solved pair).  Rules B/C then certify
        it under the new weights exactly as for solved pairs, so replay
        divergence (m attached to a different rep than before) does not
        force a fresh solve.
        """
        _val, b = tree.min_cut_edge(m, r)
        if not valid[b]:
            return None
        s = old_side[b]
        if s[m] == s[r]:
            return None
        side = s.copy() if s[m] else ~s
        return float(tree.weight[b]) + S[b], side

    reuse_memo: Dict[Tuple[int, int], Optional[Tuple[float, np.ndarray]]] = {}

    def _reuse_cached(m: int, r: int) -> Optional[Tuple[float, np.ndarray]]:
        key = (m, r)
        if key not in reuse_memo:
            reuse_memo[key] = _reuse(m, r)
        return reuse_memo[key]

    parent_new = np.full(n, root, dtype=np.int64)
    weight_new = np.full(n, np.inf, dtype=np.float64)
    sides_new = np.zeros((n, (n + 7) // 8), dtype=np.uint8)
    processed = np.zeros(n, dtype=bool)
    processed[root] = True
    rep_of = np.full(n, root, dtype=np.int64)   # current group rep per node

    n_reused = n_solved = 0
    t_solve = 0.0
    wave_sizes: List[int] = []
    pos = 0
    # fresh solves survive across waves, keyed on the exact (m, rep)
    # pair they answered — a diverged wave only discards predictions,
    # never solver work
    cache: Dict[Tuple[int, int], Tuple[float, np.ndarray]] = {}

    def _split(m: int, r: int, rep: np.ndarray, done: np.ndarray,
               side: np.ndarray) -> None:
        move = (~done) & (rep == r) & side
        move[m] = False
        rep[move] = m

    with trace.span("cuttree.repair", n=n,
                    changed_edges=int(changed.size)) as span:
        while pos < len(order):
            # Speculative scan: walk the remaining order on a copy of the
            # group state, accepting reuses and cached solves, collecting
            # (m, rep) tasks for everything else.  State is exact up to
            # the first uncached task, so every wave commits at least one
            # new solve's worth of progress.
            spec_rep = rep_of.copy()
            spec_done = processed.copy()
            tasks: Dict[int, int] = {}
            for m in order[pos:]:
                r = int(spec_rep[m])
                ru = _reuse_cached(m, r)
                if ru is not None:
                    side = ru[1]
                elif (m, r) in cache:
                    side = cache[(m, r)][1]
                else:
                    if len(tasks) >= max_batch:
                        break
                    tasks[m] = r
                    side = old_side[m]     # best guess for the split
                spec_done[m] = True
                _split(m, r, spec_rep, spec_done, side)
            if tasks:
                pairs = list(tasks.items())
                ts = time.perf_counter()
                if solver == "exact":
                    out = _solve_wave_exact(inst_new, deg, pairs)
                else:
                    out = _solve_wave_irls(session, cfg, deg, pairs,
                                           rounding, batch, max_batch,
                                           instance=inst_new)
                t_solve += time.perf_counter() - ts
                n_solved += len(pairs)
                wave_sizes.append(len(pairs))
                for (m, r), (value, side) in zip(pairs, out):
                    side = np.asarray(side, dtype=bool).copy()
                    side[m], side[r] = True, False
                    cache[(m, r)] = (float(value), side)
            # Commit against the live state: stop at the first node whose
            # actual rep has neither a valid reuse nor a cached solve (it
            # becomes the next wave's first task).
            committed_any = False
            for m in order[pos:]:
                r = int(rep_of[m])
                ru = _reuse_cached(m, r)
                if ru is not None:
                    value, side = ru
                    n_reused += 1
                elif (m, r) in cache:
                    value, side = cache.pop((m, r))
                else:
                    break
                parent_new[m] = r
                weight_new[m] = value
                sides_new[m] = pack_side(side)
                processed[m] = True
                _split(m, r, rep_of, processed, side)
                pos += 1
                committed_any = True
            if not committed_any:   # cannot happen (the first uncached
                break               # task always commits) — guard anyway
        span.set(reused=n_reused, solved=n_solved)
    n_discarded = len(cache)

    t_total = time.perf_counter() - t0
    meta = dict(tree.meta)
    meta.update({
        "repaired": True,
        "solver": solver if n_solved else tree.meta.get("solver"),
        "changed_edges": int(changed.size),
        "n_reused": int(n_reused),
        "n_solves": int(n_solved),
        "speculation_discarded": int(n_discarded),
        "n_waves": len(wave_sizes),
        "wave_sizes": wave_sizes,
        # exactness survives repair only if the fresh solves were exact
        "refined": bool(tree.meta.get("refined"))
                   and (solver == "exact" or n_solved == 0),
        "t_solve_s": t_solve,
        "t_repair_s": t_total,
    })
    new_tree = CutTree(parent=parent_new, weight=weight_new, root=root,
                       sides=sides_new, meta=meta)
    # the repaired tree is itself repairable: record its acceptance order
    new_tree.meta["order"] = order
    reg = get_registry()
    reg.counter("cuttree_repairs_total").inc()
    reg.counter("cuttree_repair_reused_total").inc(n_reused)
    reg.counter("cuttree_repair_solved_total").inc(n_solved)
    return new_tree
