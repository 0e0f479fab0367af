"""Wave-scheduled Gusfield cut-tree construction over batched pair solves.

Gusfield's algorithm (Gomory–Hu without contraction) computes a
flow-equivalent cut tree from n−1 same-graph s-t solves.  Its recursive
form maps directly onto this repo's batched serving machinery: maintain
groups ``(rep, members)`` of nodes attached to a representative, and each
ROUND solve member-vs-rep pairs, then split each group's members by cut
side.  Groups are disjoint node sets, so every round's solves are
independent: they share one topology and differ only in terminal weights,
which is exactly what ``MinCutSession.solve_batch`` vmaps over.  The wave
scheduler chunks each round into power-of-two padded batches (the serving
batcher's bucketing, so the per-batch-length compile cache stays bounded)
and the whole build reuses ONE set of compiled plans.

Group-level parallelism alone is data-dependent — lopsided cut sides keep
the recursion a chain of 1-group waves — so the batched path also
SPECULATES inside each group: a wave solves up to ``max_batch`` pairs
``(member_k, rep)`` ahead of time, then replays the splits in member
order, accepting each speculative result while its member is still
attached to the rep and discarding the ones whose member moved to a
split-off side.  Lopsided splits (the common case on segmentation-style
instances) keep nearly every speculative solve valid, so the batch stays
full either way; the discarded remainder is counted in
``meta["n_solves"]`` vs ``meta["n_pairs"]``.

Two pair solvers:

* ``solver="exact"``  — the ``core.maxflow`` Dinic oracle per pair:
  exact values and sides; the tree answers every pair query exactly.
* ``solver="irls"``   — the paper's solver through the scanned batched
  program: fast, approximate; sides come from rounding.  An optional
  ``refine=True`` pass re-solves each of the n−1 TREE edges exactly
  (certify/refine): edge values and stored sides become exact min cuts
  for their own pairs, pulling path-minimum queries to within the
  structure error of the IRLS build.

``build_cut_tree`` is the one entry point;
``repro_torch.serve.CutTreeService`` caches its output per topology and
``repro_torch.launch.cut_tree`` drives it from the command line.  The IRLS
pair solves run on the session's device (``device=``, ``"cuda"`` by
default, where ``build_cut_tree`` makes the session); Dinic runs on the
host.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from ..core.irls import IRLSConfig
from ..core.maxflow import max_flow
from ..core.session import (MinCutSession, Problem, Weights,
                            rebind_terminals, topology_fingerprint)
from ..graphs.structures import STInstance
from ..obs import trace
from ..obs.metrics import get_registry

from .pairs import graph_cut_value
from .tree import CutTree, pack_side

# cut-tree build default: the adaptive early-exit scanned schedule (the
# serving default) — co-batched pair solves stop paying for converged lanes
DEFAULT_CFG = IRLSConfig(n_irls=16, pcg_max_iters=40, precond="jacobi",
                         n_blocks=1, irls_tol=1e-3, adaptive_tol=True)


def _as_problem(problem: Union[Problem, STInstance],
                session: Optional[MinCutSession]) -> Problem:
    if isinstance(problem, Problem):
        return problem
    if session is not None:
        return session.problem
    return Problem.build(problem, n_blocks=1)


def _pair_weights(instance: STInstance, deg: np.ndarray, u: int,
                  v: int) -> Weights:
    return rebind_terminals(instance, u, v,
                            strength=1.0 + min(deg[u], deg[v]))


def _solve_wave_exact(instance: STInstance, deg: np.ndarray,
                      tasks: List[Tuple[int, int]]):
    """Dinic oracle per pair — exact values and sides."""
    out = []
    for t, rep in tasks:
        w = _pair_weights(instance, deg, t, rep)
        res = max_flow(STInstance(graph=instance.graph, s_weight=w.c_s,
                                  t_weight=w.c_t))
        side = res.in_source[: instance.n].copy()
        out.append((float(res.value), side))
    return out


def _solve_wave_irls(session: MinCutSession, cfg: IRLSConfig, deg: np.ndarray,
                     tasks: List[Tuple[int, int]], rounding: str,
                     batch: bool, max_batch: int,
                     instance: Optional[STInstance] = None):
    """Batched scanned solves per pair; sides from rounding, values recomputed
    over the graph from the (normalized) side so a misrounded terminal can
    only cost accuracy, never inject the pin strength into the tree.

    ``instance`` overrides the session's instance (same topology, drifted
    weights — the repair path); per-solve weight overrides carry the new
    edge weights through the session's compiled plans."""
    if instance is None:
        instance = session.problem.instance
    ws = [_pair_weights(instance, deg, t, rep) for t, rep in tasks]
    results = []
    if batch:
        # lazy: serve imports core.session, serve.cuttree imports cuttree
        from ..serve.batcher import bucket_size
        for lo in range(0, len(ws), max_batch):
            chunk = ws[lo:lo + max_batch]
            results.extend(session.solve_batch(
                chunk, rounding=rounding, cfg=cfg,
                pad_to=bucket_size(len(chunk), max_batch)))
    else:
        results = [session.solve(weights=w, rounding=rounding, cfg=cfg)
                   for w in ws]
    out = []
    for (t, rep), res in zip(tasks, results):
        side = np.asarray(res.cut.in_source, dtype=bool).copy()
        side[t], side[rep] = True, False
        out.append((graph_cut_value(instance, side), side))
    return out


def build_cut_tree(problem: Union[Problem, STInstance], *,
                   solver: str = "irls",
                   session: Optional[MinCutSession] = None,
                   cfg: Optional[IRLSConfig] = None,
                   rounding: str = "sweep",
                   batch: bool = True, max_batch: int = 64,
                   refine: bool = False, store_sides: bool = True,
                   root: int = 0, contract: bool = False,
                   device="cuda") -> CutTree:
    """Build a Gusfield cut tree of ``problem``'s non-terminal graph.

    problem   — a ``Problem`` (plans reused) or an ``STInstance`` (a
                1-block Problem is built unless ``session`` is given).
                The instance's own terminals are irrelevant: every pair
                solve rebinds them (``pin_pair``).
    solver    — "irls" (batched scanned solves, approximate) or "exact"
                (Dinic per pair).
    rounding  — rounding registry name for IRLS sides ("sweep" is the
                cheap default; rounding is per-pair host work, so the
                build keeps it light).
    batch     — group each wave's independent solves into ``solve_batch``
                calls (chunked to ``max_batch``, pow2-padded), speculating
                extra member-vs-rep pairs per group to keep the batch full
                (see module docstring).  ``False`` solves one pair per
                wave — the sequential baseline the benchmark compares
                against.
    refine    — after an IRLS build, re-solve every tree edge exactly and
                overwrite its value and stored side (certify/refine).
    store_sides — keep each edge's cut side (bit-packed, n·n/8 bytes) so
                ``partition``/``global_min_cut`` return certified cuts.
    contract  — run full Gomory-Hu instead of Gusfield: every recursion
                step contracts the complement subtrees into supernodes
                before the pair solve (``Problem.derive`` machinery), so
                later solves run on shrinking graphs AND every tree edge's
                stored side is a certified min-cut partition for all pairs
                it separates.  Exact solver only: each step derives a new
                topology, which would defeat the IRLS path's whole
                compiled-plan reuse (and its approximation error would
                poison the contractions).
    device    — where the session made here solves (IRLS
                without ``session``); a given session keeps its own.
    """
    if solver not in ("irls", "exact"):
        raise ValueError(f"unknown solver {solver!r}; known: irls, exact")
    if contract:
        if solver != "exact":
            raise ValueError(
                "contract=True (Gomory-Hu) requires solver='exact': every "
                "recursion step solves on a freshly contracted topology, "
                "so there is no plan reuse for the IRLS path to amortize, "
                "and contracting on an approximate cut side would "
                "invalidate the tree")
        instance = (problem.instance if isinstance(problem, Problem)
                    else problem)
        if session is not None:
            instance = session.problem.instance
        return build_gomory_hu(instance, root=root, store_sides=store_sides)
    if solver == "irls":
        prob = _as_problem(problem, session)
        if session is None:
            session = MinCutSession(prob, cfg or DEFAULT_CFG,
                                    backend="scanned", device=device)
        cfg = cfg or session.cfg
        instance = prob.instance
        fingerprint = prob.fingerprint
    else:
        instance = (problem.instance if isinstance(problem, Problem)
                    else problem)
        if session is not None:
            instance = session.problem.instance
        fingerprint = topology_fingerprint(instance)
    n = instance.n
    if n < 2:
        raise ValueError(f"cut tree needs at least 2 nodes, got n={n}")
    root = int(root)
    if not (0 <= root < n):
        raise ValueError(f"root {root} out of range for n={n}")

    deg = instance.graph.weighted_degrees()
    parent = np.full(n, root, dtype=np.int64)
    parent[root] = root
    weight = np.full(n, np.inf, dtype=np.float64)
    sides = (np.zeros((n, (n + 7) // 8), dtype=np.uint8)
             if store_sides else None)

    # recursion state: disjoint (rep, members) groups.  Each wave solves
    # member-vs-rep pairs — one per group, plus speculative extra members
    # on the batched path — then replays the splits in member order.
    groups: List[Tuple[int, List[int]]] = \
        [(root, [i for i in range(n) if i != root])]
    accept_order: List[int] = []     # acceptance sequence (repair replay)
    wave_sizes: List[int] = []
    n_solves = 0
    t_solve = 0.0
    t0 = time.perf_counter()
    speculative = bool(batch) and solver == "irls"
    with trace.span("cuttree.build", solver=solver, n=n,
                    batched=speculative) as build_span:
        while groups:
            per_group = (max(1, max_batch // len(groups)) if speculative
                         else 1)
            tasks: List[Tuple[int, int]] = []        # (group index, member)
            for gi, (rep, members) in enumerate(groups):
                for m in members[:per_group]:
                    tasks.append((gi, m))
            pairs = [(m, groups[gi][0]) for gi, m in tasks]
            wave_sizes.append(len(pairs))
            n_solves += len(pairs)
            ts = time.perf_counter()
            with trace.span("cuttree.wave", pairs=len(pairs),
                            groups=len(groups)):
                if solver == "exact":
                    results = _solve_wave_exact(instance, deg, pairs)
                else:
                    results = _solve_wave_irls(session, cfg, deg, pairs,
                                               rounding, batch, max_batch)
            t_solve += time.perf_counter() - ts
            by_group: Dict[int, List[Tuple[int, float, np.ndarray]]] = {}
            for (gi, m), (value, side) in zip(tasks, results):
                by_group.setdefault(gi, []).append((m, value, side))
            new_groups: List[Tuple[int, List[int]]] = []
            for gi, (rep, members) in enumerate(groups):
                cur = list(members)
                cur_set = set(cur)
                # accept each speculative (m, rep) solve while m is still
                # attached to rep; members that moved to a split-off side
                # get re-solved (against their new rep) in a later wave
                for m, value, side in by_group[gi]:
                    if m not in cur_set:
                        continue
                    parent[m] = rep
                    weight[m] = value
                    accept_order.append(int(m))
                    if sides is not None:
                        sides[m] = pack_side(side)
                    stay, moved = [], []
                    for x in cur:
                        if x == m:
                            continue
                        (moved if side[x] else stay).append(x)
                    cur, cur_set = stay, set(stay)
                    if moved:
                        new_groups.append((m, moved))
                if cur:
                    new_groups.append((rep, cur))
            groups = new_groups

        refined = 0
        max_refine_rel = 0.0
        if refine and solver == "irls":
            tr = time.perf_counter()
            with trace.span("cuttree.refine", edges=n - 1):
                for i in range(n):
                    if i == root:
                        continue
                    w = _pair_weights(instance, deg, i, int(parent[i]))
                    res = max_flow(STInstance(graph=instance.graph,
                                              s_weight=w.c_s,
                                              t_weight=w.c_t))
                    exact = float(res.value)
                    rel = abs(exact - weight[i]) / max(abs(exact), 1e-30)
                    if rel > 1e-12:
                        refined += 1
                        max_refine_rel = max(max_refine_rel, rel)
                    weight[i] = exact
                    if sides is not None:
                        side = res.in_source[:n].copy()
                        if not side[i]:      # normalize: True = i's side
                            side = ~side
                        sides[i] = pack_side(side)
            t_refine = time.perf_counter() - tr
        else:
            t_refine = 0.0
        build_span.set(waves=len(wave_sizes), solves=n_solves,
                       discarded=n_solves - (n - 1))

    t_total = time.perf_counter() - t0
    meta = {
        "solver": solver,
        "contracted": False,
        "n": int(n),
        "root": root,
        "fingerprint": fingerprint,
        "n_pairs": int(n - 1),                   # accepted tree edges
        "n_solves": int(n_solves),               # solver calls incl. the
                                                 # discarded speculation
        "n_waves": len(wave_sizes),
        "wave_sizes": wave_sizes,
        "speculation_discarded": int(n_solves - (n - 1)),
        "batched": speculative,
        "max_batch": int(max_batch),
        "rounding": rounding if solver == "irls" else None,
        "refined": bool(refine and solver == "irls"),
        "refine_changed_edges": refined,
        "refine_max_rel_delta": max_refine_rel,
        "t_solve_s": t_solve,
        "t_refine_s": t_refine,
        "t_build_s": t_total,
        "pairs_per_sec": n_solves / max(t_solve, 1e-12),
        # acceptance order: replaying it reproduces the exact grouping
        # history, which is what lets repair_cut_tree reuse stored cuts
        "order": accept_order,
    }
    reg = get_registry()
    reg.counter("cuttree_builds_total").inc()
    reg.counter("cuttree_pair_solves_total").inc(n_solves)
    reg.counter("cuttree_speculation_discarded_total").inc(n_solves - (n - 1))
    return CutTree(parent=parent, weight=weight, root=root, sides=sides,
                   meta=meta)


# ---------------------------------------------------------------------------
# Gomory-Hu with complement-side contraction (contract=True)
# ---------------------------------------------------------------------------

def build_gomory_hu(instance: STInstance, *, root: int = 0,
                    store_sides: bool = True) -> CutTree:
    """Classic Gomory-Hu construction over the non-terminal graph.

    The tree is grown over SETS of vertices: each step picks a set X with
    |X| >= 2 and a pair (s, t) in X, contracts every tree subtree hanging
    off X into one supernode each (``presolve.derive_instance`` — the
    "contract the complement side" step), solves the contracted s-t min
    cut exactly, splits X by the lifted cut side and reattaches each
    subtree to the side its supernode fell on.  The Gomory-Hu lemma makes
    every step's contraction exact, so all n−1 edges carry certified cut
    values AND partitions: the stored side of an edge equals the final
    tree bipartition across it, for every pair that edge separates.

    n−1 Dinic solves like Gusfield, but on graphs that only shrink as the
    tree refines — the deeper the recursion, the smaller the solve.
    """
    from ..presolve.contract import derive_instance

    n = instance.n
    if n < 2:
        raise ValueError(f"cut tree needs at least 2 nodes, got n={n}")
    root = int(root)
    if not (0 <= root < n):
        raise ValueError(f"root {root} out of range for n={n}")

    t0 = time.perf_counter()
    # tree over set-nodes: vertex lists + adjacency; edge data keyed on the
    # (frozen) pair of set-node ids
    verts: List[List[int]] = [list(range(n))]
    adj: List[set] = [set()]
    edge_val: Dict[Tuple[int, int], float] = {}
    edge_side: Dict[Tuple[int, int], np.ndarray] = {}  # True = lower-id side
    contracted_sizes: List[int] = []
    work = [0]
    t_solve = 0.0
    while work:
        x = work.pop()
        vx = verts[x]
        if len(vx) < 2:
            continue
        s, t = vx[0], vx[1]
        # subtrees of the tree with x removed: one supernode each
        group_of = np.full(n, -1, dtype=np.int64)
        subtree_roots = []
        for nb in adj[x]:
            stack, seen = [nb], {x, nb}
            members = []
            while stack:
                y = stack.pop()
                members.extend(verts[y])
                for z in adj[y]:
                    if z not in seen:
                        seen.add(z)
                        stack.append(z)
            group_of[members] = len(subtree_roots)
            subtree_roots.append(nb)
        # vertex_map: X's vertices keep distinct ids, each subtree -> one id
        vm = np.empty(n, dtype=np.int64)
        free = group_of < 0
        vm[free] = np.arange(int(free.sum()))
        vm[~free] = int(free.sum()) + group_of[~free]
        d = derive_instance(instance, vm)
        contracted_sizes.append(d.instance.n)
        dd = d.instance.graph.weighted_degrees()
        cs, ct = int(vm[s]), int(vm[t])
        w = rebind_terminals(d.instance, cs, ct,
                             strength=1.0 + min(dd[cs], dd[ct]))
        ts = time.perf_counter()
        with trace.span("cuttree.wave", pairs=1, contracted_n=d.instance.n):
            res = max_flow(STInstance(graph=d.instance.graph, s_weight=w.c_s,
                                      t_weight=w.c_t))
        t_solve += time.perf_counter() - ts
        side_c = res.in_source[: d.instance.n]
        side = side_c[vm]                     # original vertices, True = s
        value = float(res.value)
        # split x: A keeps node id x, B becomes a new node y
        A = [v for v in vx if side[v]]
        B = [v for v in vx if not side[v]]
        y = len(verts)
        verts[x] = A
        verts.append(B)
        adj.append(set())
        # reattach each subtree to the side its supernode fell on
        for gi, nb in enumerate(subtree_roots):
            if not side_c[int(free.sum()) + gi]:
                adj[x].discard(nb)
                nb_adj = adj[nb]
                nb_adj.discard(x)
                nb_adj.add(y)
                adj[y].add(nb)
                key_old = (min(x, nb), max(x, nb))
                key_new = (min(y, nb), max(y, nb))
                edge_val[key_new] = edge_val.pop(key_old)
                sd = edge_side.pop(key_old)
                # normalize: stored True = lower-id side of the edge
                if (key_old[0] == x) != (key_new[0] == y):
                    sd = ~sd
                edge_side[key_new] = sd
        adj[x].add(y)
        adj[y].add(x)
        key = (min(x, y), max(x, y))
        edge_val[key] = value
        edge_side[key] = side if key[0] == x else ~side
        if len(A) >= 2:
            work.append(x)
        if len(B) >= 2:
            work.append(y)

    # every set-node is now a singleton; re-root the tree at ``root``
    vertex_of = {i: v[0] for i, v in enumerate(verts)}
    node_of = {v: i for i, v in vertex_of.items()}
    parent = np.full(n, root, dtype=np.int64)
    weight = np.full(n, np.inf, dtype=np.float64)
    sides = (np.zeros((n, (n + 7) // 8), dtype=np.uint8)
             if store_sides else None)
    stack = [node_of[root]]
    seen = {node_of[root]}
    while stack:
        a = stack.pop()
        va = vertex_of[a]
        for b in adj[a]:
            if b in seen:
                continue
            seen.add(b)
            vb = vertex_of[b]
            parent[vb] = va
            key = (min(a, b), max(a, b))
            weight[vb] = edge_val[key]
            if sides is not None:
                # stored True = lower-id set-node's side; CutTree wants
                # True = child's (b's) side
                sd = edge_side[key] if key[0] == b else ~edge_side[key]
                sides[vb] = pack_side(sd)
            stack.append(b)
    meta = {
        "solver": "exact",
        "contracted": True,
        "n": int(n),
        "root": root,
        "fingerprint": topology_fingerprint(instance),
        "n_pairs": int(n - 1),
        "n_solves": int(n - 1),
        "mean_contracted_n": float(np.mean(contracted_sizes)),
        "max_contracted_n": int(np.max(contracted_sizes)),
        "t_solve_s": t_solve,
        "t_build_s": time.perf_counter() - t0,
    }
    reg = get_registry()
    reg.counter("cuttree_builds_total").inc()
    reg.counter("cuttree_pair_solves_total").inc(n - 1)
    return CutTree(parent=parent, weight=weight, root=root, sides=sides,
                   meta=meta)
