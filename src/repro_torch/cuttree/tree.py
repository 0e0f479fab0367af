"""``CutTree`` — the all-pairs min-cut query engine.

A Gusfield (flow-equivalent) cut tree over the n non-terminal nodes of one
topology: node i ≠ root hangs off ``parent[i]`` under an edge of weight
``weight[i]`` = the min-cut value computed for the pair (i, parent[i])
during construction.  Finished, it answers every pair query without another
solve:

* ``min_cut(u, v)`` — the minimum edge weight on the tree path u → v.  With
  exact pair solves this IS the exact u-v min-cut value for ALL of the
  ``n·(n−1)/2`` pairs (flow equivalence), from n−1 solves.
* ``global_min_cut()`` — the minimum tree edge.  Its stored cut achieves
  that value, so with stored sides (the build default) and exact pair
  solves the returned partition is a certified global min cut.
* ``partition(u, v)`` — a cut achieving ``min_cut(u, v)`` when the stored
  side of the bottleneck edge separates u from v (the common case; Gusfield
  trees do not guarantee it for every pair), otherwise the tree split —
  still a valid u/v separator, reported via ``certified``.

Queries are pure array walks — microseconds, no solver, no device — which is
what lets ``repro_torch.serve.CutTreeService`` answer pair traffic from a cache.
Serialization (``to_dict``/``from_dict``, ``save``/``load``) is plain JSON
so trees can be built offline and shipped next to their topology; the
JSON is the JAX package's byte for byte, so either package loads a tree
the other saved.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class CutTree:
    """Rooted Gusfield tree: ``parent``/``weight`` arrays + optional stored
    cut sides (one bool[n] per edge, bit-packed) and build metadata."""

    def __init__(self, parent: np.ndarray, weight: np.ndarray, root: int = 0,
                 sides: Optional[np.ndarray] = None,
                 meta: Optional[Dict] = None):
        self.parent = np.asarray(parent, dtype=np.int64).copy()
        self.weight = np.asarray(weight, dtype=np.float64).copy()
        self.root = int(root)
        n = self.parent.shape[0]
        if self.weight.shape[0] != n:
            raise ValueError(f"parent[{n}] and weight[{self.weight.shape[0]}] "
                             f"disagree")
        if not (0 <= self.root < n) or self.parent[self.root] != self.root:
            raise ValueError(f"root {self.root} must be its own parent")
        self.weight[self.root] = np.inf          # never the path minimum
        # bit-packed uint8[n, ceil(n/8)]: sides[i] = source(i)-side indicator
        # of the cut solved for edge (i, parent[i]); None = not stored
        self.sides = None if sides is None else \
            np.asarray(sides, dtype=np.uint8).copy()
        if self.sides is not None and \
                self.sides.shape != (n, (n + 7) // 8):
            raise ValueError(f"sides shape {self.sides.shape} != "
                             f"{(n, (n + 7) // 8)}")
        self.meta = dict(meta or {})
        self.depth = self._depths()              # also validates acyclicity

    # -- structure -------------------------------------------------------------
    @property
    def n(self) -> int:
        return int(self.parent.shape[0])

    def _depths(self) -> np.ndarray:
        n = self.n
        depth = np.full(n, -1, dtype=np.int64)
        depth[self.root] = 0
        for i in range(n):
            if depth[i] >= 0:
                continue
            chain = []
            j = i
            while depth[j] < 0:
                chain.append(j)
                j = int(self.parent[j])
                if len(chain) > n:
                    raise ValueError("parent array contains a cycle")
            for k, node in enumerate(reversed(chain)):
                depth[node] = depth[j] + k + 1
        return depth

    def edges(self) -> List[Tuple[int, int, float]]:
        """(child, parent, weight) for every tree edge."""
        return [(i, int(self.parent[i]), float(self.weight[i]))
                for i in range(self.n) if i != self.root]

    def side_of(self, i: int) -> Optional[np.ndarray]:
        """Stored cut side for edge (i, parent[i]): bool[n], True = i's side
        of the solve that produced ``weight[i]``.  None when not stored."""
        if self.sides is None or i == self.root:
            return None
        return np.unpackbits(self.sides[i], count=self.n).astype(bool)

    def subtree_mask(self, i: int) -> np.ndarray:
        """bool[n]: nodes in the subtree rooted at i (the tree split of the
        edge (i, parent[i]))."""
        # a node is in subtree(i) iff walking to the root passes through i
        mask = np.zeros(self.n, dtype=bool)
        mask[i] = True
        state = np.zeros(self.n, dtype=np.int8)  # 0 unknown, 1 in, 2 out
        state[i] = 1
        state[self.root] = 2 if i != self.root else 1
        for start in range(self.n):
            if state[start]:
                continue
            chain = []
            j = start
            while not state[j]:
                chain.append(j)
                j = int(self.parent[j])
            verdict = state[j]
            for node in chain:
                state[node] = verdict
        mask[:] = state == 1
        return mask

    # -- queries ---------------------------------------------------------------
    def min_cut_edge(self, u: int, v: int) -> Tuple[float, int]:
        """(value, bottleneck) — the minimum edge weight on the tree path
        u → v and the child endpoint of that edge."""
        u, v = int(u), int(v)
        if not (0 <= u < self.n and 0 <= v < self.n):
            raise ValueError(f"pair ({u}, {v}) out of range for n={self.n}")
        if u == v:
            raise ValueError(f"min cut of a node with itself is undefined "
                             f"(got ({u}, {v}))")
        best, arg = np.inf, u
        while self.depth[u] > self.depth[v]:
            if self.weight[u] < best:
                best, arg = self.weight[u], u
            u = int(self.parent[u])
        while self.depth[v] > self.depth[u]:
            if self.weight[v] < best:
                best, arg = self.weight[v], v
            v = int(self.parent[v])
        while u != v:
            if self.weight[u] < best:
                best, arg = self.weight[u], u
            if self.weight[v] < best:
                best, arg = self.weight[v], v
            u, v = int(self.parent[u]), int(self.parent[v])
        return float(best), int(arg)

    def min_cut(self, u: int, v: int) -> float:
        """Min-cut value between u and v (path minimum; exact for every pair
        when the tree was built with exact pair solves)."""
        return self.min_cut_edge(u, v)[0]

    def min_cut_batch(self, pairs: Sequence[Tuple[int, int]]) -> np.ndarray:
        return np.array([self.min_cut(u, v) for u, v in pairs],
                        dtype=np.float64)

    def min_cut_matrix(self) -> np.ndarray:
        """Dense all-pairs matrix (diagonal = +inf).  O(n² · depth) walks —
        for reports/tests on small n; serve queries one pair at a time."""
        out = np.full((self.n, self.n), np.inf)
        for u in range(self.n):
            for v in range(u + 1, self.n):
                out[u, v] = out[v, u] = self.min_cut(u, v)
        return out

    def partition(self, u: int, v: int) -> Tuple[np.ndarray, bool]:
        """(side, certified): a bipartition separating u from v with u's
        side True.  ``certified`` means the side is the stored min cut of
        the bottleneck edge (value == ``min_cut(u, v)``); otherwise it is
        the tree split of that edge — a valid separator whose value may
        exceed the minimum (Gusfield trees only certify the solved pairs)."""
        _, arg = self.min_cut_edge(u, v)
        side = self.side_of(arg)
        if side is not None and side[u] != side[v]:
            return (side if side[u] else ~side), True
        mask = self.subtree_mask(arg)
        if mask[u] == mask[v]:       # can't happen: arg is on the u-v path
            raise AssertionError("tree split failed to separate the pair")
        return (mask if mask[u] else ~mask), False

    def global_min_cut(self) -> Tuple[float, np.ndarray]:
        """(value, side) of the lightest tree edge.  The minimum pair
        min-cut over all pairs equals the minimum tree edge, and that
        edge's stored cut achieves it — so with stored sides (the
        ``store_sides=True`` build default) and exact pair solves the
        returned partition is a certified global min cut.  Without stored
        sides the side falls back to the tree split of that edge, which
        separates its pair but may cut more than ``value``."""
        if self.n < 2:
            raise ValueError("global min cut needs at least 2 nodes")
        arg = int(np.argmin(self.weight))
        side = self.side_of(arg)
        if side is None:
            side = self.subtree_mask(arg)
        return float(self.weight[arg]), side

    # -- serialization ---------------------------------------------------------
    def to_dict(self) -> Dict:
        out = {
            "parent": self.parent.tolist(),
            "weight": [None if not np.isfinite(w) else float(w)
                       for w in self.weight],
            "root": self.root,
            "meta": self.meta,
        }
        if self.sides is not None:
            out["sides_hex"] = [bytes(row).hex() for row in self.sides]
        return out

    @classmethod
    def from_dict(cls, d: Dict) -> "CutTree":
        weight = np.array([np.inf if w is None else w for w in d["weight"]],
                          dtype=np.float64)
        sides = None
        if d.get("sides_hex") is not None:
            sides = np.stack([np.frombuffer(bytes.fromhex(row),
                                            dtype=np.uint8)
                              for row in d["sides_hex"]])
        return cls(parent=np.asarray(d["parent"], dtype=np.int64),
                   weight=weight, root=int(d["root"]), sides=sides,
                   meta=d.get("meta"))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)

    @classmethod
    def load(cls, path: str) -> "CutTree":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def __repr__(self) -> str:
        solver = self.meta.get("solver", "?")
        return (f"CutTree(n={self.n}, root={self.root}, solver={solver!r}, "
                f"min_edge={float(np.min(self.weight)):.4g})")


def pack_side(side: np.ndarray) -> np.ndarray:
    """bool[n] → the bit-packed uint8 row ``CutTree.sides`` stores."""
    return np.packbits(np.asarray(side, dtype=bool))
