"""Exact s,t-safe kernelization rules (VieCut-style, terminal-aware).

The reductions here shrink an :class:`~repro_torch.graphs.structures.STInstance`
*without changing its minimum s-t cut value*.  They are the classic
connectivity-preserving contractions of Padberg-Rinaldi / VieCut
(PAPERS.md 1708.06127, 1808.05458) adapted to the two-terminal setting:
the virtual source ``S = n`` and sink ``T = n + 1`` participate in the
edge list (terminal weights become edges) but are never contracted into
anything — they stay union-find roots so "merged into S" is a statement
about sides of the cut.

Rule catalogue (each exact; safety argument in docs/API.md):

``components``
    (a) If S and T fall in different connected components the min cut is
    the trivial 0-cut (plus any direct S-T weight) — every node in S's
    component is source-side, everything else sink-side.
    (b) With S deleted, any component not containing T cannot reach the
    sink except through S; moving it wholesale to the source side never
    increases a cut, so it is merged into S.  (c) Symmetrically with T
    deleted, components not containing S merge into T.  Step (b)
    subsumes the degree-0 drop and the "restrict to the s-t component"
    rule: an isolated node or a stray component contains neither
    terminal and merges into S with zero cut contribution.

``terminal_cancel``
    A node u with both a source edge (u,S,ws) and a sink edge (u,T,wt)
    pays min(ws, wt) in every s-t cut — whichever side u takes, the
    opposite terminal's edge is cut.  The minimum moves into ``base``
    and only |ws - wt| survives on the heavier terminal's side.  On
    dense-terminal instances this strips most terminal edges before the
    degree rules run.

``degree1``
    A non-terminal node u with a single incident edge (u, x, w) can
    always sit on x's side of the cut (moving it there removes w from
    the cut and adds nothing), so u is contracted into x.

``degree2``
    A non-terminal node u with exactly two incident edges (u,a,w1),
    (u,b,w2) is replaced by the direct edge (a,b) of weight min(w1,w2):
    if a,b are separated the path contributes exactly min(w1,w2) to the
    min cut (cut the cheaper side); if not, it contributes 0.  The new
    edge merges with any existing parallel (a,b) edge by summation.

``heavy``
    An edge (u,v,w) with 2w >= wdeg(u) (w at least the total weight of
    u's *other* incident edges, terminals included) can be contracted:
    separating u from v costs >= w >= wdeg(u) - w, while keeping them
    together costs at most wdeg(u) - w, so some min cut keeps u with v.
    (A "w >= wdeg(u)" condition would be vacuous since wdeg includes w
    itself; the half-degree form is the standard exact condition.)
    Applied simultaneously only along a matching so each node moves at
    most once per pass.

All passes are vectorized NumPy over the edge list; a fixpoint loop
cycles the enabled rules until none fires.  Stopping early is always
safe — a partially reduced instance is still exact — so the loop is
capped by ``max_cycles``.

The output :class:`Reduction` carries the union-find ``parent`` array,
the ``removed`` mask plus ``journal`` for degree-2 eliminations (needed
to lift solutions back), the surviving canonical edges, and ``base`` —
direct S-T weight that every s-t cut pays unconditionally.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components

from ..graphs.structures import STInstance, canonicalize_edges

#: Default rule order; ``components`` first so later rules never see a
#: graph where S or T is unreachable; ``terminal_cancel`` early so
#: dense-terminal instances shed their terminal edges before the
#: degree rules count incident edges.
RULES: Tuple[str, ...] = ("components", "terminal_cancel", "degree1",
                          "degree2", "heavy")

#: ``input_slot`` sentinels (weight-provenance tracking, ``track=True``):
#: where an input edge's weight currently lives when it no longer maps to
#: a canonical edge slot.
IN_DROPPED = -1   # became a self-loop — weight is irrelevant to any cut
IN_BASE = -2      # folded into ``base`` (S-T edge)
IN_POISON = -3    # fed a value-dependent rule decision (degree2 min /
                  # journal, heavy condition, terminal_cancel min) — a
                  # later weight change here invalidates kernel patching


@dataclasses.dataclass
class Reduction:
    """Result of running reduction rules to (near-)fixpoint.

    Node ids live in ``[0, n + 2)`` with ``S = n`` and ``T = n + 1``.
    ``parent`` is fully path-compressed: ``parent[i]`` is i's root.
    ``journal`` rows are ``(u, a, b, w_ua, w_ub)`` in elimination order;
    ids are canonical roots *at elimination time* (resolve through
    ``parent`` / later journal entries when replaying in reverse).
    """

    n: int
    parent: np.ndarray        # int64[n+2]
    removed: np.ndarray       # bool[n+2] — degree-2 eliminated roots
    journal: np.ndarray       # float64[k, 5]
    eu: np.ndarray            # int64[mk] surviving canonical edges (lo)
    ev: np.ndarray            # int64[mk] (hi; may be S or T)
    ew: np.ndarray            # float64[mk]
    base: float               # direct S-T weight (constant cut offset)
    st_connected: bool
    stats: Dict[str, int]
    #: With ``track=True``: for each input edge (m graph edges, then the
    #: ``si`` source pseudo-edges, then the ``ti`` sink pseudo-edges) the
    #: surviving canonical slot its weight flowed into, or one of the
    #: IN_* sentinels.  ``None`` when tracking was off.
    input_slot: Optional[np.ndarray] = None   # int64[m + |si| + |ti|]
    si: Optional[np.ndarray] = None           # int64 — nodes with c_s > 0
    ti: Optional[np.ndarray] = None           # int64 — nodes with c_t > 0

    @property
    def n_total(self) -> int:
        return self.n + 2


def _compress(parent: np.ndarray) -> None:
    """Full path compression in place: parent[i] <- root(i)."""
    while True:
        p2 = parent[parent]
        if np.array_equal(p2, parent):
            return
        parent[:] = p2


def _connected_components(n_total: int, eu: np.ndarray, ev: np.ndarray) -> np.ndarray:
    """Connected-component labels, each component labelled by its smallest
    node id.

    Returns int64 labels where two nodes share a label iff connected.  The
    components come from ``scipy.sparse.csgraph.connected_components`` in
    O(m + n); relabelling each by its smallest node id gives exactly the
    fixpoint of the JAX package's min-label propagation, so every
    ``Reduction`` and ``Kernel`` built on these labels is the same."""
    if eu.size == 0:
        return np.arange(n_total, dtype=np.int64)
    adj = coo_matrix((np.ones(eu.size, dtype=np.float64),
                      (np.asarray(eu, dtype=np.int64),
                       np.asarray(ev, dtype=np.int64))),
                     shape=(n_total, n_total))
    _, lab = connected_components(adj, directed=False)
    # nodes in id order: a component's first node is its smallest
    _, first = np.unique(lab, return_index=True)
    return first[lab].astype(np.int64)


def _canonicalize(parent: np.ndarray, eu: np.ndarray, ev: np.ndarray,
                  ew: np.ndarray, S: int, T: int
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, float]:
    """Map edges through the union-find, fold S-T edges into ``base``,
    drop self-loops and merge parallel edges by summation."""
    _compress(parent)
    ru, rv = parent[eu], parent[ev]
    lo = np.minimum(ru, rv)
    hi = np.maximum(ru, rv)
    st = (lo == S) & (hi == T)
    base_add = float(ew[st].sum()) if st.any() else 0.0
    keep = ~st
    lo2, hi2, w2 = canonicalize_edges(lo[keep], hi[keep], ew[keep],
                                      T + 1, merge="sum")
    return lo2, hi2, w2, base_add


class _State:
    """Mutable reduction state shared by the rule passes."""

    def __init__(self, n: int, eu, ev, ew, track: bool = False):
        self.n = n
        self.S, self.T = n, n + 1
        self.parent = np.arange(n + 2, dtype=np.int64)
        self.removed = np.zeros(n + 2, dtype=bool)
        self.journal: List[np.ndarray] = []
        self.eu, self.ev, self.ew = eu, ev, ew
        self.base = 0.0
        self.st_connected = True
        # input-edge -> current canonical slot (weight provenance)
        self.slot: Optional[np.ndarray] = (
            np.arange(eu.shape[0], dtype=np.int64) if track else None)
        self.stats: Dict[str, int] = {
            "components": 0, "terminal_cancel": 0, "degree1": 0,
            "degree2": 0, "heavy": 0, "cycles": 0,
        }

    def apply_slot_code(self, code: np.ndarray) -> None:
        """Remap live slot references through ``code`` (old slot -> new
        slot or sentinel); sentinel entries are left untouched."""
        live = self.slot >= 0
        self.slot[live] = code[self.slot[live]]

    def poison_slots(self, slot_mask: np.ndarray) -> None:
        """Mark inputs whose weight currently sits in a masked slot as
        having fed a value-dependent decision."""
        live = self.slot >= 0
        hit = np.zeros(self.slot.shape[0], dtype=bool)
        hit[live] = slot_mask[self.slot[live]]
        self.slot[hit] = IN_POISON

    def canonicalize(self) -> None:
        if self.slot is None:
            self.eu, self.ev, self.ew, badd = _canonicalize(
                self.parent, self.eu, self.ev, self.ew, self.S, self.T)
            self.base += badd
            return
        _compress(self.parent)
        ru, rv = self.parent[self.eu], self.parent[self.ev]
        lo = np.minimum(ru, rv)
        hi = np.maximum(ru, rv)
        stm = (lo == self.S) & (hi == self.T)
        if stm.any():
            self.base += float(self.ew[stm].sum())
        keep = ~stm
        lo2, hi2, w2, emap = canonicalize_edges(
            lo[keep], hi[keep], self.ew[keep], self.T + 1,
            merge="sum", return_map=True)
        code = np.empty(self.eu.shape[0], dtype=np.int64)
        code[stm] = IN_BASE
        code[keep] = np.where(emap >= 0, emap, IN_DROPPED)
        self.apply_slot_code(code)
        self.eu, self.ev, self.ew = lo2, hi2, w2

    def degrees(self) -> np.ndarray:
        n_total = self.n + 2
        return (np.bincount(self.eu, minlength=n_total)
                + np.bincount(self.ev, minlength=n_total))


def _rule_components(st: _State) -> bool:
    """Trivialize s-t disconnection; merge terminal-dominated components."""
    S, T, n = st.S, st.T, st.n
    fired = False
    comp = _connected_components(n + 2, st.eu, st.ev)
    live = (np.arange(n + 2) < n) & (st.parent == np.arange(n + 2)) & ~st.removed
    if comp[S] != comp[T]:
        # Trivial cut: S's component is source-side, everything else sink.
        st.st_connected = False
        side_s = comp == comp[S]
        st.parent[live & side_s] = S
        st.parent[live & ~side_s] = T
        st.stats["components"] += int(live.sum())
        st.canonicalize()   # all edges become self-loops
        return True
    # (b) with S deleted: components without T cannot reach the sink.
    for term, other in ((S, T), (T, S)):
        keep = (st.eu != term) & (st.ev != term)
        comp = _connected_components(n + 2, st.eu[keep], st.ev[keep])
        merge = live & (comp != comp[other])
        merge[term] = merge[other] = False
        if merge.any():
            st.parent[merge] = term
            st.stats["components"] += int(merge.sum())
            st.canonicalize()
            live = (np.arange(n + 2) < n) & (st.parent == np.arange(n + 2)) & ~st.removed
            fired = True
    return fired


def _rule_degree1(st: _State) -> bool:
    """Contract non-terminal degree-1 nodes into their sole neighbour."""
    n = st.n
    deg = st.degrees()
    ids = np.arange(n + 2)
    cand = (deg == 1) & (ids < n) & ~st.removed
    if not cand.any():
        return False
    partner = np.full(n + 2, -1, dtype=np.int64)
    mu = cand[st.eu]
    partner[st.eu[mu]] = st.ev[mu]
    mv = cand[st.ev]
    partner[st.ev[mv]] = st.eu[mv]
    cs = np.nonzero(cand)[0]
    p = partner[cs]
    # Mutual degree-1 pairs (an isolated edge u-x): keep the smaller id
    # as the surviving root to avoid a 2-cycle in the union-find.
    mutual = (p < n) & cand[p]
    skip = mutual & (cs < p)
    cs, p = cs[~skip], p[~skip]
    st.parent[cs] = p
    st.stats["degree1"] += int(cs.size)
    st.canonicalize()
    return True


def _rule_degree2(st: _State) -> bool:
    """Replace degree-2 non-terminal nodes by a min-weight series edge."""
    n = st.n
    deg = st.degrees()
    ids = np.arange(n + 2)
    cand = (deg == 2) & (ids < n) & ~st.removed
    if not cand.any():
        return False
    mu = cand[st.eu]
    mv = cand[st.ev]
    nodes = np.concatenate([st.eu[mu], st.ev[mv]])
    nbrs = np.concatenate([st.ev[mu], st.eu[mv]])
    ws = np.concatenate([st.ew[mu], st.ew[mv]])
    order = np.argsort(nodes, kind="stable")
    nodes, nbrs, ws = nodes[order], nbrs[order], ws[order]
    u2 = nodes[0::2]
    a, b = nbrs[0::2], nbrs[1::2]
    wa, wb = ws[0::2], ws[1::2]
    # Conflict-free subset: drop u if a neighbour is a smaller-id
    # candidate (local-min filter) so eliminated nodes never reference
    # each other within one pass.  The fixpoint loop mops up the rest.
    clash = (cand[a] & (a < u2)) | (cand[b] & (b < u2))
    keep = ~clash
    if not keep.any():
        # All candidates clash pairwise by id ordering — cannot happen
        # (the globally smallest candidate id never clashes), but guard.
        return False
    u2, a, b, wa, wb = u2[keep], a[keep], b[keep], wa[keep], wb[keep]
    gone = np.zeros(n + 2, dtype=bool)
    gone[u2] = True
    emask = ~(gone[st.eu] | gone[st.ev])
    if st.slot is not None:
        # Both incident weights feed min(wa, wb) and the lift-time
        # journal comparison — value-dependent, so poison them.
        code = np.full(st.eu.shape[0], IN_POISON, dtype=np.int64)
        code[emask] = np.arange(int(emask.sum()), dtype=np.int64)
        st.apply_slot_code(code)
    st.eu = np.concatenate([st.eu[emask], np.minimum(a, b)])
    st.ev = np.concatenate([st.ev[emask], np.maximum(a, b)])
    st.ew = np.concatenate([st.ew[emask], np.minimum(wa, wb)])
    st.removed[u2] = True
    st.journal.append(np.stack(
        [u2.astype(np.float64), a.astype(np.float64), b.astype(np.float64),
         wa, wb], axis=1))
    st.stats["degree2"] += int(u2.size)
    st.canonicalize()
    return True


def _rule_heavy(st: _State) -> bool:
    """Contract edges with 2w >= wdeg(endpoint) along a heaviest-first
    matching; the movable endpoint must be non-terminal."""
    n = st.n
    n_total = n + 2
    wdeg = np.zeros(n_total)
    np.add.at(wdeg, st.eu, st.ew)
    np.add.at(wdeg, st.ev, st.ew)
    cu = (2.0 * st.ew >= wdeg[st.eu]) & (st.eu < n)
    cv = (2.0 * st.ew >= wdeg[st.ev]) & (st.ev < n)
    cand = cu | cv
    if not cand.any():
        return False
    idx = np.nonzero(cand)[0]
    mov = np.where(cu[idx], st.eu[idx], st.ev[idx])
    oth = np.where(cu[idx], st.ev[idx], st.eu[idx])
    # Heaviest-first matching: each node participates in at most one
    # contraction per pass (simultaneous contractions are only safe
    # along a matching — the condition references current degrees).
    order = np.argsort(-st.ew[idx], kind="stable")
    mov, oth = mov[order], oth[order]
    rank = np.arange(mov.size, dtype=np.int64)
    claim = np.full(n_total, mov.size, dtype=np.int64)
    np.minimum.at(claim, mov, rank)
    np.minimum.at(claim, oth, rank)
    ok = (claim[mov] == rank) & (claim[oth] == rank)
    if not ok.any():
        return False
    if st.slot is not None:
        # The 2w >= wdeg(mov) test reads every weight incident to the
        # moved endpoint at firing time — poison all of them.
        movset = np.zeros(n_total, dtype=bool)
        movset[mov[ok]] = True
        st.poison_slots(movset[st.eu] | movset[st.ev])
    st.parent[mov[ok]] = oth[ok]
    st.stats["heavy"] += int(ok.sum())
    st.canonicalize()
    return True


def _rule_terminal_cancel(st: _State) -> bool:
    """Cancel paired terminal edges per node (dense-terminal rule).

    A node u carrying both a source edge (u,S,ws) and a sink edge
    (u,T,wt) pays at least min(ws, wt) in *every* s-t cut: whichever
    side u lands on, the edge to the opposite terminal is cut.  That
    minimum moves into ``base`` and only the difference ``|ws - wt|``
    survives, on the heavier terminal's side.  Exact, and the lift is
    unaffected (no node merges or removals).
    """
    S, T, n = st.S, st.T, st.n
    n_total = n + 2
    to_s = st.ev == S
    to_t = st.ev == T
    ws = np.zeros(n_total)
    wt = np.zeros(n_total)
    # Canonical edges are unique per (lo, hi) pair, so plain assignment
    # is safe — at most one S slot and one T slot per node.
    ws[st.eu[to_s]] = st.ew[to_s]
    wt[st.eu[to_t]] = st.ew[to_t]
    both = (ws > 0) & (wt > 0)
    if not both.any():
        return False
    st.base += float(np.minimum(ws, wt)[both].sum())
    drop = (to_s | to_t) & both[st.eu]
    keep = ~drop
    if st.slot is not None:
        # min(ws, wt) and the surviving side both depend on the two
        # terminal weights — poison the dropped slots, reindex the rest.
        code = np.full(st.eu.shape[0], IN_POISON, dtype=np.int64)
        code[keep] = np.arange(int(keep.sum()), dtype=np.int64)
        st.apply_slot_code(code)
    fired = np.nonzero(both)[0]
    diff = ws[fired] - wt[fired]
    nz = diff != 0
    new_u = fired[nz]
    new_v = np.where(diff[nz] > 0, S, T).astype(np.int64)
    st.eu = np.concatenate([st.eu[keep], new_u])
    st.ev = np.concatenate([st.ev[keep], new_v])
    st.ew = np.concatenate([st.ew[keep], np.abs(diff[nz])])
    st.stats["terminal_cancel"] += int(fired.size)
    st.canonicalize()
    return True


_RULE_FNS = {
    "components": _rule_components,
    "terminal_cancel": _rule_terminal_cancel,
    "degree1": _rule_degree1,
    "degree2": _rule_degree2,
    "heavy": _rule_heavy,
}


def reduce_instance(instance: STInstance,
                    c: Optional[np.ndarray] = None,
                    c_s: Optional[np.ndarray] = None,
                    c_t: Optional[np.ndarray] = None,
                    rules: Sequence[str] = RULES,
                    max_cycles: int = 200,
                    track: bool = False) -> Reduction:
    """Run the enabled reduction ``rules`` to fixpoint (or ``max_cycles``).

    ``c``/``c_s``/``c_t`` override the instance's weights (same shapes);
    by default the instance's own weights are reduced.  Zero-weight
    terminal entries simply produce no terminal edge.

    ``track=True`` records weight provenance: ``Reduction.input_slot``
    maps every input edge (graph edges, then source pseudo-edges for the
    ``si`` nodes, then sink pseudo-edges for ``ti``) to the surviving
    canonical slot its weight flowed into, or an ``IN_*`` sentinel.
    This is what makes kernels patchable under weight drift — an input
    whose slot is not ``IN_POISON`` never influenced a value-dependent
    rule decision, so its weight can change freely without invalidating
    any applied reduction.
    """
    for r in rules:
        if r not in _RULE_FNS:
            raise ValueError(f"unknown reduction rule {r!r}; known: {sorted(_RULE_FNS)}")
    n = instance.n
    S, T = n, n + 1
    g = instance.graph
    c = np.asarray(g.weight if c is None else c, dtype=np.float64)
    c_s = np.asarray(instance.s_weight if c_s is None else c_s, dtype=np.float64)
    c_t = np.asarray(instance.t_weight if c_t is None else c_t, dtype=np.float64)
    si = np.nonzero(c_s > 0)[0]
    ti = np.nonzero(c_t > 0)[0]
    eu = np.concatenate([np.asarray(g.src, dtype=np.int64), si,
                         ti]).astype(np.int64)
    ev = np.concatenate([np.asarray(g.dst, dtype=np.int64),
                         np.full(si.size, S, dtype=np.int64),
                         np.full(ti.size, T, dtype=np.int64)])
    ew = np.concatenate([c, c_s[si], c_t[ti]])

    st = _State(n, eu, ev, ew, track=track)
    st.canonicalize()
    fns = [_RULE_FNS[r] for r in rules]
    idle = 0
    cycles = 0
    while idle < len(fns) and cycles < max_cycles:
        fired = fns[cycles % len(fns)](st)
        idle = 0 if fired else idle + 1
        cycles += 1
        if not st.st_connected:
            break
    st.stats["cycles"] = cycles

    journal = (np.concatenate(st.journal, axis=0) if st.journal
               else np.zeros((0, 5), dtype=np.float64))
    _compress(st.parent)
    return Reduction(n=n, parent=st.parent, removed=st.removed,
                     journal=journal, eu=st.eu, ev=st.ev, ew=st.ew,
                     base=st.base, st_connected=st.st_connected,
                     stats=dict(st.stats), input_slot=st.slot,
                     si=si, ti=ti)
