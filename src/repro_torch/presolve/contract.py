"""Kernel assembly and contraction-derived instances.

:func:`kernelize` runs the reduction rules (``rules.py``) and packages
the survivors into a :class:`Kernel`: a smaller ``STInstance`` over the
kernel nodes, a ``vertex_map`` relating original vertices to kernel
vertices (or to a terminal side / an eliminated slot), and the journal
needed to lift solutions back (``lift.py``).

:func:`derive_instance` / ``Problem.derive`` / ``Problem.contract`` are
the general contraction API: given any vertex grouping they build the
merged instance plus edge/weight projection maps, so callers (e.g. the
Gomory-Hu builder in ``cuttree``) can pose cut problems on contracted
topologies and map results back.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..graphs.structures import EdgeList, STInstance, canonicalize_edges
from .rules import (IN_BASE, IN_DROPPED, RULES, Reduction, reduce_instance)

# vertex_map sentinel codes for non-surviving vertices
MERGED_SOURCE = -1
MERGED_SINK = -2
ELIMINATED = -3   # removed by a degree-2 series merge; side from journal

# WeightMap kinds: where an original weight entry's value ends up in the
# kernel.  Entries whose kind is K_EDGE / K_CS / K_CT / K_BASE / K_DROP
# contribute *additively* to the indexed kernel quantity, so a pure value
# change there patches through; K_POISON fed a value-dependent rule
# decision and K_ABSENT is a terminal entry that was <= 0 at kernelize
# time (no pseudo-edge existed) — changes to either force a re-kernelize.
K_EDGE = 0     # idx-th kernel graph edge weight
K_CS = 1       # kernel source weight of node idx
K_CT = 2       # kernel sink weight of node idx
K_BASE = 3     # folded into Kernel.base
K_DROP = 4     # self-loop after contraction — value-irrelevant
K_POISON = 5
K_ABSENT = 6


@dataclasses.dataclass(frozen=True)
class WeightMap:
    """Additive provenance of original weights in a kernel.

    ``edge_kind``/``edge_idx`` cover the m original graph edges;
    ``cs_*``/``ct_*`` cover the n terminal weight entries.  See the
    ``K_*`` kind codes above.  Built by :func:`kernelize` (``track=True``)
    and consumed by :func:`patch_kernel`.
    """

    edge_kind: np.ndarray   # int8[m]
    edge_idx: np.ndarray    # int64[m]
    cs_kind: np.ndarray     # int8[n]
    cs_idx: np.ndarray      # int64[n]
    ct_kind: np.ndarray     # int8[n]
    ct_idx: np.ndarray      # int64[n]


@dataclasses.dataclass(frozen=True)
class Kernel:
    """Exact kernel of an s-t min-cut instance.

    ``instance`` is the reduced problem over ``kernel_n`` nodes (with the
    reduced terminal weights baked in); solving it and adding ``base``
    gives the original min-cut value.  ``vertex_map[i]`` is the kernel id
    of original vertex i, or ``MERGED_SOURCE`` / ``MERGED_SINK`` /
    ``ELIMINATED``.  A trivial kernel (``kernel_n == 0``) means the cut
    is fully decided by reductions — including the s-t disconnected
    case, where ``base == 0``.
    """

    original: STInstance
    instance: Optional[STInstance]   # None iff trivial
    vertex_map: np.ndarray           # int64[n]
    base: float
    st_connected: bool
    journal: np.ndarray              # float64[k, 5] (u, a, b, w_ua, w_ub)
    parent: np.ndarray               # int64[n+2] fully compressed
    removed: np.ndarray              # bool[n+2]
    kernel_of_root: np.ndarray       # int64[n+2]: kernel id per surviving root, else -1
    stats: Dict[str, int]
    wmap: Optional["WeightMap"] = None   # set when kernelized with track=True

    @property
    def n(self) -> int:
        return self.original.n

    @property
    def kernel_n(self) -> int:
        return 0 if self.instance is None else self.instance.n

    @property
    def kernel_m(self) -> int:
        return 0 if self.instance is None else self.instance.graph.m

    @property
    def trivial(self) -> bool:
        return self.instance is None

    @property
    def node_reduction(self) -> float:
        """Original/kernel node-count ratio (inf for trivial kernels)."""
        kn = self.kernel_n
        return float("inf") if kn == 0 else self.n / kn

    @property
    def edge_reduction(self) -> float:
        m = self.original.graph.m
        km = self.kernel_m
        return float("inf") if km == 0 else max(m, 1) / km

    # lifting lives in lift.py; re-exported as methods for ergonomics
    def lift_partition(self, kernel_side: Optional[np.ndarray]) -> np.ndarray:
        from .lift import lift_partition
        return lift_partition(self, kernel_side)

    def lift_voltages(self, kernel_v: Optional[np.ndarray],
                      high: float = 1.0, low: float = 0.0) -> np.ndarray:
        from .lift import lift_voltages
        return lift_voltages(self, kernel_v, high=high, low=low)

    def certificate(self, kernel_side: Optional[np.ndarray]) -> Dict[str, float]:
        from .lift import cut_certificate
        return cut_certificate(self, kernel_side)


def _weight_map(red: Reduction, skind: np.ndarray,
                sidx: np.ndarray) -> WeightMap:
    """Compose input->slot provenance with the slot->kernel split."""
    slot = red.input_slot
    kind = np.full(slot.shape[0], K_POISON, dtype=np.int8)
    idx = np.zeros(slot.shape[0], dtype=np.int64)
    live = slot >= 0
    kind[live] = skind[slot[live]]
    idx[live] = sidx[slot[live]]
    kind[slot == IN_DROPPED] = K_DROP
    kind[slot == IN_BASE] = K_BASE
    ns, nt = red.si.shape[0], red.ti.shape[0]
    m = slot.shape[0] - ns - nt
    cs_kind = np.full(red.n, K_ABSENT, dtype=np.int8)
    cs_idx = np.zeros(red.n, dtype=np.int64)
    ct_kind = np.full(red.n, K_ABSENT, dtype=np.int8)
    ct_idx = np.zeros(red.n, dtype=np.int64)
    cs_kind[red.si] = kind[m:m + ns]
    cs_idx[red.si] = idx[m:m + ns]
    ct_kind[red.ti] = kind[m + ns:]
    ct_idx[red.ti] = idx[m + ns:]
    return WeightMap(edge_kind=kind[:m], edge_idx=idx[:m],
                     cs_kind=cs_kind, cs_idx=cs_idx,
                     ct_kind=ct_kind, ct_idx=ct_idx)


def _assemble(instance: STInstance, red: Reduction) -> Kernel:
    n = red.n
    S, T = n, n + 1
    parent = red.parent
    ids = np.arange(n + 2)
    is_root = parent == ids
    # Surviving candidate roots: non-terminal, unremoved union-find roots.
    surv = is_root & (ids < n) & ~red.removed
    # Isolated survivors (no incident edge at all, not even a terminal
    # edge) are degree-0: cut-neutral, merged into the source side.
    touched = np.zeros(n + 2, dtype=bool)
    touched[red.eu] = True
    touched[red.ev] = True
    isolated = surv & ~touched
    n_iso = int(isolated.sum())
    if n_iso:
        parent = parent.copy()
        parent[isolated] = S
        surv = surv & ~isolated
    kernel_of_root = np.full(n + 2, -1, dtype=np.int64)
    roots = np.nonzero(surv)[0]
    kn = int(roots.size)
    kernel_of_root[roots] = np.arange(kn)

    stats = dict(red.stats)
    stats["degree0"] = n_iso
    stats["kernel_n"] = kn

    vm = np.empty(n, dtype=np.int64)
    r = parent[:n]
    vm[:] = kernel_of_root[r]
    vm[r == S] = MERGED_SOURCE
    vm[r == T] = MERGED_SINK
    vm[red.removed[r]] = ELIMINATED

    if kn == 0:
        wmap = None
        if red.input_slot is not None:
            # No kernel slots exist; any still-live slot (impossible in
            # practice once every non-terminal root is merged) maps to
            # poison, sentinel entries keep their additive meaning.
            wmap = _weight_map(
                red, np.full(red.eu.shape[0], K_POISON, dtype=np.int8),
                np.zeros(red.eu.shape[0], dtype=np.int64))
        return Kernel(original=instance, instance=None, vertex_map=vm,
                      base=red.base, st_connected=red.st_connected,
                      journal=red.journal, parent=parent,
                      removed=red.removed, kernel_of_root=kernel_of_root,
                      stats=stats, wmap=wmap)

    # Split surviving canonical edges into kernel edges / terminal weights.
    # Canonical orientation is lo < hi, so a terminal endpoint is always
    # ``ev`` (S = n, T = n + 1 are the largest ids) and S-T edges were
    # already folded into ``base``.
    c_s = np.zeros(kn)
    c_t = np.zeros(kn)
    to_s = red.ev == S
    to_t = red.ev == T
    plain = ~(to_s | to_t)
    np.add.at(c_s, kernel_of_root[red.eu[to_s]], red.ew[to_s])
    np.add.at(c_t, kernel_of_root[red.eu[to_t]], red.ew[to_t])
    ku = kernel_of_root[red.eu[plain]]
    kv = kernel_of_root[red.ev[plain]]
    kw = red.ew[plain]
    g = EdgeList(src=ku.astype(np.int32), dst=kv.astype(np.int32),
                 weight=kw.astype(np.float64), n=kn)
    kinst = STInstance(graph=g, s_weight=c_s, t_weight=c_t)
    stats["kernel_m"] = g.m
    wmap = None
    if red.input_slot is not None:
        n_slots = red.eu.shape[0]
        skind = np.empty(n_slots, dtype=np.int8)
        sidx = np.empty(n_slots, dtype=np.int64)
        skind[plain] = K_EDGE
        sidx[plain] = np.arange(int(plain.sum()), dtype=np.int64)
        skind[to_s] = K_CS
        sidx[to_s] = kernel_of_root[red.eu[to_s]]
        skind[to_t] = K_CT
        sidx[to_t] = kernel_of_root[red.eu[to_t]]
        wmap = _weight_map(red, skind, sidx)
    return Kernel(original=instance, instance=kinst, vertex_map=vm,
                  base=red.base, st_connected=red.st_connected,
                  journal=red.journal, parent=parent, removed=red.removed,
                  kernel_of_root=kernel_of_root, stats=stats, wmap=wmap)


def kernelize(instance: STInstance,
              c: Optional[np.ndarray] = None,
              c_s: Optional[np.ndarray] = None,
              c_t: Optional[np.ndarray] = None,
              rules: Sequence[str] = RULES,
              max_cycles: int = 200,
              track: bool = True) -> Kernel:
    """Reduce ``instance`` (optionally with override weights) to an exact
    kernel.  The kernel preserves the min s-t cut value exactly:
    ``min_cut(kernel) + base == min_cut(original)``.

    ``track=True`` (default) additionally records a :class:`WeightMap`
    on the kernel so that later weight drift can be applied through
    :func:`patch_kernel` without re-running the reduction fixpoint; the
    tracking overhead is a few extra int64 arrays per pass."""
    if c is not None or c_s is not None or c_t is not None:
        # Bake the overrides into the instance the Kernel keeps as
        # "original": lifting and certificates must be evaluated against
        # the weights the reductions actually saw.
        g = instance.graph
        instance = STInstance(
            graph=EdgeList(
                src=g.src, dst=g.dst,
                weight=np.asarray(g.weight if c is None else c,
                                  dtype=np.float64), n=g.n),
            s_weight=np.asarray(instance.s_weight if c_s is None else c_s,
                                dtype=np.float64),
            t_weight=np.asarray(instance.t_weight if c_t is None else c_t,
                                dtype=np.float64))
    from ..obs import trace
    from ..obs.metrics import get_registry
    with trace.span("presolve.kernelize", n=instance.n,
                    m=instance.graph.m) as sp:
        red = reduce_instance(instance, rules=rules, max_cycles=max_cycles,
                              track=track)
        kernel = _assemble(instance, red)
        sp.set(kernel_n=kernel.stats.get("kernel_n"),
               kernel_m=kernel.stats.get("kernel_m", 0),
               cycles=kernel.stats.get("cycles"))
    reg = get_registry()
    reg.counter("presolve_kernelize_total").inc()
    reg.counter("presolve_nodes_in_total").inc(instance.n)
    reg.counter("presolve_kernel_nodes_total").inc(
        kernel.stats.get("kernel_n", 0))
    if kernel.trivial:
        reg.counter("presolve_trivial_total").inc()
    return kernel


def patch_kernel(kernel: Kernel,
                 old: Tuple[np.ndarray, np.ndarray, np.ndarray],
                 new: Tuple[np.ndarray, np.ndarray, np.ndarray]
                 ) -> Optional[Kernel]:
    """Revalidate ``kernel`` (built under ``old = (c, c_s, c_t)``) against
    ``new`` weights and return a patched exact kernel, or ``None`` when
    the drift could have changed a reduction decision.

    Soundness rests on two observations.  First, stopping the fixpoint
    early is always exact, so the patched kernel need not match what a
    fresh ``kernelize(new)`` would produce — only the *applied*
    reductions must remain valid.  Second, every applied reduction is
    either purely structural (components, degree-0/1 — valid for any
    nonnegative weights on the same topology) or value-dependent exactly
    on the inputs the tracker poisoned (degree-2 min + journal side,
    heavy-edge condition, terminal cancellation).  Hence a diff patches
    through iff no changed entry is ``K_POISON``, no changed terminal
    entry crosses the support boundary (``K_ABSENT`` becoming positive,
    or a tracked pseudo-edge dropping to zero — either would change the
    terminal edge set the rules saw), and no new weight is negative.
    Everything else applies additively via the :class:`WeightMap`.

    The certificate stays honest automatically: the patched kernel's
    ``original`` carries the new weights, so ``cut_certificate``
    recomputes the lifted cut against them on every solve.
    """
    wm = kernel.wmap
    if wm is None:
        return None
    c_o, cs_o, ct_o = (np.asarray(a, dtype=np.float64) for a in old)
    c_n, cs_n, ct_n = (np.asarray(a, dtype=np.float64) for a in new)
    if (c_o.shape != c_n.shape or cs_o.shape != cs_n.shape
            or ct_o.shape != ct_n.shape
            or c_n.shape[0] != wm.edge_kind.shape[0]
            or cs_n.shape[0] != wm.cs_kind.shape[0]):
        return None
    if kernel.instance is not None:
        kw = np.array(kernel.instance.graph.weight, dtype=np.float64)
        kcs = np.array(kernel.instance.s_weight, dtype=np.float64)
        kct = np.array(kernel.instance.t_weight, dtype=np.float64)
    else:
        kw = kcs = kct = None
    base = float(kernel.base)

    def apply(kind, idx, o, nv, terminal):
        nonlocal base
        chg = np.flatnonzero(o != nv)
        if chg.size == 0:
            return True
        if np.any(nv[chg] < 0):
            return False
        k = kind[chg]
        if np.any(k == K_POISON) or np.any(k == K_ABSENT):
            return False
        if terminal and np.any(nv[chg] <= 0):
            # A tracked pseudo-edge dropping to zero shrinks the terminal
            # edge set the rules reasoned over; re-kernelize.  (Graph
            # edges participate in the reduction regardless of weight,
            # so they have no such support boundary.)
            return False
        d = (nv - o)[chg]
        for code, tgt in ((K_EDGE, kw), (K_CS, kcs), (K_CT, kct)):
            sel = k == code
            if sel.any():
                if tgt is None:
                    return False
                np.add.at(tgt, idx[chg[sel]], d[sel])
        b = k == K_BASE
        if b.any():
            base += float(d[b].sum())
        return True

    if not (apply(wm.edge_kind, wm.edge_idx, c_o, c_n, False)
            and apply(wm.cs_kind, wm.cs_idx, cs_o, cs_n, True)
            and apply(wm.ct_kind, wm.ct_idx, ct_o, ct_n, True)):
        return None
    og = kernel.original.graph
    original = STInstance(
        graph=EdgeList(src=og.src, dst=og.dst, weight=c_n, n=og.n),
        s_weight=cs_n, t_weight=ct_n)
    kinst = kernel.instance
    if kinst is not None:
        kinst = STInstance(
            graph=EdgeList(src=kinst.graph.src, dst=kinst.graph.dst,
                           weight=kw, n=kinst.graph.n),
            s_weight=kcs, t_weight=kct)
    stats = dict(kernel.stats)
    stats["patched"] = stats.get("patched", 0) + 1
    return dataclasses.replace(kernel, original=original, instance=kinst,
                               base=base, stats=stats)


# ---------------------------------------------------------------------------
# General contraction-derived instances (Gomory-Hu building block)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DerivedInstance:
    """A contracted instance plus the maps to project/lift.

    ``vertex_map[i]`` is the contracted id of original node i (always
    >= 0 here — plain contraction never eliminates nodes).  ``edge_map``
    sends each original edge to its contracted slot (-1 if it became a
    self-loop).  ``project_weights`` pushes fresh per-edge weights onto
    the contracted topology; ``lift_partition`` pulls a side assignment
    back to the original vertices.
    """

    instance: STInstance
    vertex_map: np.ndarray
    edge_map: np.ndarray

    def project_weights(self, c: np.ndarray) -> np.ndarray:
        out = np.zeros(self.instance.graph.m)
        ok = self.edge_map >= 0
        np.add.at(out, self.edge_map[ok], np.asarray(c, dtype=np.float64)[ok])
        return out

    def lift_partition(self, side: np.ndarray) -> np.ndarray:
        return np.asarray(side)[self.vertex_map]


def derive_instance(instance: STInstance, vertex_map: np.ndarray) -> DerivedInstance:
    """Contract ``instance`` by ``vertex_map`` (int64[n] -> [0, k)).

    Parallel edges merge by summation, self-loops drop, and terminal
    weights are segment-summed per group — the exact contraction
    semantics for cuts (all merged nodes are forced to one side)."""
    vm = np.asarray(vertex_map, dtype=np.int64)
    if vm.shape != (instance.n,):
        raise ValueError(f"vertex_map must have shape ({instance.n},), got {vm.shape}")
    if vm.min() < 0:
        raise ValueError("vertex_map entries must be >= 0")
    k = int(vm.max()) + 1
    g = instance.graph
    lo, hi, w, emap = canonicalize_edges(
        vm[np.asarray(g.src)], vm[np.asarray(g.dst)], g.weight, k,
        merge="sum", return_map=True)
    c_s = np.zeros(k)
    c_t = np.zeros(k)
    np.add.at(c_s, vm, np.asarray(instance.s_weight, dtype=np.float64))
    np.add.at(c_t, vm, np.asarray(instance.t_weight, dtype=np.float64))
    cg = EdgeList(src=lo.astype(np.int32), dst=hi.astype(np.int32),
                  weight=w, n=k)
    return DerivedInstance(
        instance=STInstance(graph=cg, s_weight=c_s, t_weight=c_t),
        vertex_map=vm, edge_map=emap)


def contraction_map(n: int, groups: Sequence[Sequence[int]]) -> np.ndarray:
    """Build a vertex_map merging each group into one supernode.

    Ungrouped vertices keep distinct ids; ids are compacted to [0, k).
    The supernode of ``groups[j]`` is the id of its smallest member
    after compaction (query via ``vertex_map[groups[j][0]]``)."""
    vm = np.arange(n, dtype=np.int64)
    for grp in groups:
        grp = np.asarray(list(grp), dtype=np.int64)
        if grp.size == 0:
            continue
        vm[grp] = int(grp.min())
    # compact
    uniq, inv = np.unique(vm, return_inverse=True)
    return inv.astype(np.int64)
