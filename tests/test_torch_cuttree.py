"""The port's cut trees (``repro_torch.cuttree``, ``serve.CutTreeService``,
``launch.cut_tree``) against the JAX package's, on the CPU.

The same seeded instances go through both packages with ``device="cpu"``
on the port's side.  Dinic is the same host code in both, so exact trees
(Gusfield and Gomory–Hu) and exact repairs are array-equal: parent,
weight, stored sides, acceptance order, reuse and solve counts.  IRLS
trees are held as tests/test_cuttree.py and tests/test_drift.py hold the
reference's: refined trees within rel 1e-3 of the exact tree on every
pair, refined edges at the Dinic value (rel 1e-9), an IRLS repair in the
strong config within rel 1e-6 of a fresh exact build; their parents equal
the reference's on the 6×6 grid and the tiny instances.  Trees saved as
JSON by either package load in the other with equal queries.
"""
import inspect
import itertools
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import tiny_instance  # noqa: E402

from repro.core import IRLSConfig as JConfig  # noqa: E402
from repro import cuttree as jct  # noqa: E402
from repro.graphs import generators as jgen  # noqa: E402
from repro.graphs.structures import (EdgeList as JEdgeList,  # noqa: E402
                                     STInstance as JSTInstance)
from repro.serve import CutTreeService as JService  # noqa: E402

from repro_torch import cuttree as ct  # noqa: E402
from repro_torch.core import IRLSConfig, max_flow  # noqa: E402
from repro_torch.core.session import rebind_terminals  # noqa: E402
from repro_torch.graphs.structures import (EdgeList, STInstance,  # noqa: E402
                                           instance_from_arrays)
from repro_torch.serve import CutTreeService  # noqa: E402

# tests/test_cuttree.py's IRLS config
CFG_KW = dict(n_irls=10, pcg_max_iters=30, precond="jacobi", n_blocks=1,
              irls_tol=1e-3, adaptive_tol=True)
CFG, JCFG = IRLSConfig(**CFG_KW), JConfig(**CFG_KW)
# tests/test_drift.py's strong config for IRLS repair
STRONG_KW = dict(n_irls=40, pcg_max_iters=120, precond="jacobi", n_blocks=1,
                 pcg_tol=1e-8, eps=1e-6)


def _port(inst):
    return instance_from_arrays(inst.graph.src, inst.graph.dst,
                                inst.graph.weight, inst.n, inst.s_weight,
                                inst.t_weight)


def _grid(side, seed):
    """A JAX-package segmentation grid (tests/test_drift.py's ``_grid``)."""
    g = jgen.grid_2d(side, side, seed=seed)
    return jgen.segmentation_instance(g, (side, side), seed=seed + 1)


def small_grid():
    """tests/test_cuttree.py's 6×6 grid."""
    g = jgen.grid_2d(6, 6, seed=2)
    return jgen.segmentation_instance(g, (6, 6), seed=3)


def _with_weights(inst, c, port=False):
    E, S = (EdgeList, STInstance) if port else (JEdgeList, JSTInstance)
    return S(graph=E(src=inst.graph.src, dst=inst.graph.dst, weight=c,
                     n=inst.n),
             s_weight=inst.s_weight, t_weight=inst.t_weight)


def _drift(rng, c, k, upward=False):
    """tests/test_drift.py's ``_drift``."""
    c2 = c.copy()
    idx = rng.choice(c2.size, size=k, replace=False)
    z = rng.normal(0.0, 0.3, size=k)
    c2[idx] *= np.exp(np.abs(z) if upward else z)
    return c2


def _assert_same_tree(a, b, order=True):
    np.testing.assert_array_equal(a.parent, b.parent)
    np.testing.assert_array_equal(a.weight, b.weight)
    np.testing.assert_array_equal(a.sides, b.sides)
    assert a.root == b.root
    if order:
        assert a.meta["order"] == b.meta["order"]


def _all_pairs_rel(a, b):
    """Largest relative gap between two trees' min cuts over all pairs."""
    x, y = a.min_cut_matrix(), b.min_cut_matrix()
    off = ~np.eye(a.n, dtype=bool)
    return float(np.max(np.abs(x[off] - y[off]) / np.abs(y[off])))


def _dinic_pair(inst, u, v):
    w = rebind_terminals(inst, u, v)
    return max_flow(STInstance(graph=inst.graph, s_weight=w.c_s,
                               t_weight=w.c_t)).value


FIXTURES = {"tiny12-0": lambda: tiny_instance(n=12, seed=0),
            "tiny12-1": lambda: tiny_instance(n=12, seed=1),
            "tiny12-5": lambda: tiny_instance(n=12, seed=5),
            "grid6": small_grid,
            "grid7": lambda: _grid(7, 4)}


# ---------------------------------------------------------------------------
# pair rebinding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_c,strength", [(False, None), (True, None),
                                             (False, 7.5), (True, 2.0)])
def test_pin_pairs_match_reference(with_c, strength):
    """pin_pair / pin_pairs give the reference's weights, array for array,
    with and without an edge-weight override and a pin strength."""
    j = tiny_instance(n=10, seed=1)
    p = _port(j)
    c = (np.random.default_rng(3).uniform(0.5, 2.0, j.graph.m)
         if with_c else None)
    pairs = [(0, 3), (4, 9), (7, 1)]
    got = ct.pin_pairs(p, pairs, c=c, strength=strength)
    want = jct.pin_pairs(j, pairs, c=c, strength=strength)
    for (u, v), g, w in zip(pairs, got, want):
        one = ct.pin_pair(p, u, v, c=c, strength=strength)
        for a, b, d in zip(g, w, one):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            np.testing.assert_array_equal(np.asarray(a), np.asarray(d))


def test_graph_cut_value_matches_reference():
    j = small_grid()
    side = np.random.default_rng(0).uniform(size=j.n) < 0.5
    c = np.asarray(j.graph.weight) * 1.5
    assert ct.graph_cut_value(_port(j), side) == \
        jct.graph_cut_value(j, side)
    assert ct.graph_cut_value(_port(j), side, c=c) == \
        jct.graph_cut_value(j, side, c=c)


# ---------------------------------------------------------------------------
# exact trees: array-equal to the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_exact_tree_equals_reference(name):
    """Gusfield over Dinic: parent, weight, stored sides and acceptance
    order equal the reference's; every pair at its Dinic value."""
    j = FIXTURES[name]()
    p = _port(j)
    got = ct.build_cut_tree(p, solver="exact", device="cpu")
    want = jct.build_cut_tree(j, solver="exact")
    _assert_same_tree(got, want)
    for key in ("n_pairs", "n_solves", "n_waves", "wave_sizes",
                "fingerprint", "speculation_discarded"):
        assert got.meta[key] == want.meta[key], key
    if name.startswith("tiny"):
        for u, v in itertools.combinations(range(p.n), 2):
            assert got.min_cut(u, v) == pytest.approx(_dinic_pair(p, u, v),
                                                      rel=1e-8)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_gomory_hu_equals_reference(name):
    """contract=True: the Gomory–Hu tree equals the reference's and its
    min cuts equal the exact Gusfield tree's on every pair (rel 1e-9)."""
    j = FIXTURES[name]()
    p = _port(j)
    got = ct.build_cut_tree(p, solver="exact", contract=True, device="cpu")
    want = jct.build_cut_tree(j, solver="exact", contract=True)
    _assert_same_tree(got, want, order=False)
    for key in ("contracted", "n_solves", "mean_contracted_n",
                "max_contracted_n", "fingerprint"):
        assert got.meta[key] == want.meta[key], key
    gus = ct.build_cut_tree(p, solver="exact", device="cpu")
    assert _all_pairs_rel(got, gus) <= 1e-9
    with pytest.raises(ValueError, match="requires solver='exact'"):
        ct.build_cut_tree(p, solver="irls", contract=True, device="cpu")


def test_exact_tree_global_min_cut_certified():
    p = _port(tiny_instance(n=12, seed=5))
    tree = ct.build_cut_tree(p, solver="exact", device="cpu")
    value, side = tree.global_min_cut()
    expect = min(_dinic_pair(p, u, v)
                 for u, v in itertools.combinations(range(p.n), 2))
    assert value == pytest.approx(expect, rel=1e-8)
    assert ct.graph_cut_value(p, side) == pytest.approx(value, rel=1e-8)
    for u, v in [(0, 5), (3, 11), (2, 7), (10, 1)]:
        part, certified = tree.partition(u, v)
        assert part[u] and not part[v]
        cut = ct.graph_cut_value(p, part)
        if certified:
            assert cut == pytest.approx(tree.min_cut(u, v), rel=1e-8)
        else:
            assert cut >= tree.min_cut(u, v) - 1e-9


# ---------------------------------------------------------------------------
# CutTree mechanics and JSON across the packages
# ---------------------------------------------------------------------------

def test_cut_tree_path_minimum_handmade():
    tree = ct.CutTree(parent=[0, 0, 1, 0], weight=[np.inf, 5.0, 3.0, 2.5])
    assert tree.min_cut(2, 0) == 3.0
    assert tree.min_cut(1, 0) == 5.0
    assert tree.min_cut(2, 3) == 2.5
    assert tree.min_cut_edge(2, 1) == (3.0, 2)
    value, side = tree.global_min_cut()
    assert value == 2.5
    np.testing.assert_array_equal(side, [False, False, False, True])
    part, certified = tree.partition(2, 0)
    assert not certified
    np.testing.assert_array_equal(part, [False, False, True, False])
    assert tree.min_cut_batch([(2, 0), (2, 3)]).tolist() == [3.0, 2.5]
    assert repr(tree) == repr(jct.CutTree(parent=[0, 0, 1, 0],
                                          weight=[np.inf, 5.0, 3.0, 2.5]))


def test_cut_tree_rejects_malformed():
    with pytest.raises(ValueError, match="cycle"):
        ct.CutTree(parent=[0, 2, 1], weight=[np.inf, 1.0, 1.0])
    with pytest.raises(ValueError, match="root"):
        ct.CutTree(parent=[1, 0], weight=[1.0, 1.0], root=0)
    with pytest.raises(ValueError, match="sides shape"):
        ct.CutTree(parent=[0, 0], weight=[np.inf, 1.0],
                   sides=np.zeros((2, 2), dtype=np.uint8))
    with pytest.raises(ValueError, match="disagree"):
        ct.CutTree(parent=[0, 0], weight=[np.inf])
    tree = ct.CutTree(parent=[0, 0], weight=[np.inf, 1.0])
    with pytest.raises(ValueError, match="undefined"):
        tree.min_cut(1, 1)
    with pytest.raises(ValueError, match="range"):
        tree.min_cut(0, 2)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_tree_json_loads_in_the_other_package(tmp_path, writer):
    """A tree saved by one package loads in the other with equal queries
    and partitions; both write the same bytes for the same tree."""
    j = tiny_instance(n=10, seed=3)
    tree_p = ct.build_cut_tree(_port(j), solver="exact", device="cpu")
    tree_j = jct.build_cut_tree(j, solver="exact")
    for t in (tree_p, tree_j):       # build times differ; the rest must not
        for key in ("t_solve_s", "t_refine_s", "t_build_s", "pairs_per_sec"):
            t.meta[key] = 0.0
    assert json.dumps(tree_p.to_dict()) == json.dumps(tree_j.to_dict())
    path = os.path.join(str(tmp_path), "tree.json")
    src, load = ((tree_p, jct.CutTree.load) if writer == "port"
                 else (tree_j, ct.CutTree.load))
    src.save(path)
    back = load(path)
    np.testing.assert_array_equal(back.parent, src.parent)
    np.testing.assert_array_equal(back.sides, src.sides)
    assert back.meta == src.meta
    for u, v in itertools.combinations(range(j.n), 2):
        assert back.min_cut(u, v) == src.min_cut(u, v)
    for u, v in [(0, 5), (2, 9)]:
        s0, c0 = src.partition(u, v)
        s1, c1 = back.partition(u, v)
        assert c0 == c1
        np.testing.assert_array_equal(s0, s1)


# ---------------------------------------------------------------------------
# IRLS trees: batched waves and the exact certify/refine pass
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["grid6", "tiny12-4", "tiny12-7"])
def test_irls_tree_refined_matches_exact_and_reference(name):
    """The refined IRLS tree is within rel 1e-3 of the exact tree on every
    pair (and its global min cut), as is the reference's; its parent array
    and wave schedule equal the reference's."""
    j = (small_grid() if name == "grid6"
         else tiny_instance(n=12, seed=int(name.split("-")[1])))
    p = _port(j)
    got = ct.build_cut_tree(p, cfg=CFG, max_batch=8, refine=True,
                            device="cpu")
    want = jct.build_cut_tree(j, cfg=JCFG, max_batch=8, refine=True)
    exact = ct.build_cut_tree(p, solver="exact", device="cpu")
    assert got.meta["batched"] and got.meta["refined"]
    assert got.meta["n_solves"] >= got.meta["n_pairs"] == p.n - 1
    assert got.meta["n_waves"] < p.n - 1
    for tree in (got, want):
        assert _all_pairs_rel(tree, exact) <= 1e-3
        assert tree.global_min_cut()[0] == pytest.approx(
            exact.global_min_cut()[0], rel=1e-3)
    np.testing.assert_array_equal(got.parent, want.parent)
    assert got.meta["order"] == want.meta["order"]
    assert got.meta["wave_sizes"] == want.meta["wave_sizes"]


def test_refined_irls_trees_miss_some_pairs_in_both_packages():
    """ROADMAP queue 3: the 1e-3 all-pairs bar of the refined IRLS tree
    (tests/test_cuttree.py's 6×6 grid) does not hold at grid side 12 in the
    cut-tree default config, in either package: refine makes each tree edge
    its pair's exact cut but keeps the structure, so a node that the IRLS
    sides attached under the wrong representative keeps a path minimum
    below its exact cut.  Both trees stay lower bounds of the exact cut on
    every pair (the min cut's ultrametric inequality), with the exact
    global min cut."""
    j = _grid(12, 0)                 # launch.cut_tree --family grid --side 12
    p = _port(j)
    exact = ct.build_cut_tree(p, solver="exact", device="cpu")
    y = exact.min_cut_matrix()
    off = ~np.eye(p.n, dtype=bool)
    for tree in (ct.build_cut_tree(p, max_batch=8, refine=True,
                                   device="cpu"),
                 jct.build_cut_tree(j, max_batch=8, refine=True)):
        gap = (y[off] - tree.min_cut_matrix()[off]) / y[off]
        assert gap.min() >= -1e-9
        assert gap.max() > 1e-3
        assert tree.global_min_cut()[0] == pytest.approx(
            exact.global_min_cut()[0], rel=1e-9)


def test_refine_pins_tree_edges_to_oracle():
    p = _port(tiny_instance(n=12, seed=7))
    tree = ct.build_cut_tree(p, cfg=CFG, max_batch=8, refine=True,
                             device="cpu")
    for i, par, w in tree.edges():
        assert w == pytest.approx(_dinic_pair(p, i, par), rel=1e-9), (i, par)


def test_irls_sequential_baseline_no_speculation():
    j = tiny_instance(n=10, seed=2)
    tree = ct.build_cut_tree(_port(j), cfg=CFG, batch=False, device="cpu")
    want = jct.build_cut_tree(j, cfg=JCFG, batch=False)
    assert not tree.meta["batched"]
    assert tree.meta["n_solves"] == tree.meta["n_pairs"] == 9
    assert sum(tree.meta["wave_sizes"]) == 9
    np.testing.assert_array_equal(tree.parent, want.parent)


def test_entry_points_default_to_the_card():
    """Every entry point that makes a session defaults to "cuda"."""
    for fn in (ct.build_cut_tree, ct.repair_cut_tree):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    sig = inspect.signature(CutTreeService.__init__)
    assert sig.parameters["device"].default == "cuda"
    for f in ("n_irls", "pcg_max_iters", "precond", "n_blocks", "irls_tol",
              "adaptive_tol", "eps", "use_pallas", "layout"):
        assert getattr(ct.DEFAULT_CFG, f) == getattr(jct.DEFAULT_CFG, f), f
    assert not ct.DEFAULT_CFG.use_pallas


# ---------------------------------------------------------------------------
# repair under drift
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("upward", [True, False])
def test_repair_exact_equals_reference_over_drift_sequence(upward):
    """tests/test_drift.py's drift sequence (grid 7, 4 chained steps):
    every repaired tree equals the reference's repair, reuse and solve
    counts included, and a fresh exact build on every pair (rel 1e-9)."""
    j = _grid(7, 4)
    p = _port(j)
    c = np.asarray(j.graph.weight, dtype=np.float64).copy()
    tree_p = ct.build_cut_tree(p, solver="exact", device="cpu")
    tree_j = jct.build_cut_tree(j, solver="exact")
    rng = np.random.default_rng(4 + upward)
    for _ in range(4):
        c_new = _drift(rng, c, k=max(1, j.graph.m // 30), upward=upward)
        p_new, j_new = _with_weights(p, c_new, True), _with_weights(j, c_new)
        tree_p = ct.repair_cut_tree(p_new, tree_p, c, c_new, solver="exact",
                                    device="cpu")
        tree_j = jct.repair_cut_tree(j_new, tree_j, c, c_new, solver="exact")
        _assert_same_tree(tree_p, tree_j)
        for key in ("n_reused", "n_solves", "speculation_discarded",
                    "n_waves", "wave_sizes", "changed_edges", "refined"):
            assert tree_p.meta[key] == tree_j.meta[key], key
        fresh = ct.build_cut_tree(p_new, solver="exact", device="cpu")
        assert _all_pairs_rel(tree_p, fresh) <= 1e-9
        c, p = c_new, p_new
    assert tree_p.meta["repaired"] and tree_p.meta["n_reused"] > 0


def test_repair_irls_resolves_match_exact_values():
    """tests/test_drift.py's IRLS repair: re-solves through the batched
    waves in the strong config, within rel 1e-6 of a fresh exact build on
    every pair."""
    j = _grid(5, 6)
    p = _port(j)
    c = np.asarray(j.graph.weight, dtype=np.float64).copy()
    tree = ct.build_cut_tree(p, solver="exact", device="cpu")
    c_new = _drift(np.random.default_rng(6), c, k=2, upward=True)
    p_new = _with_weights(p, c_new, True)
    rep = ct.repair_cut_tree(p_new, tree, c, c_new, solver="irls",
                             cfg=IRLSConfig(**STRONG_KW), rounding="sweep",
                             device="cpu")
    fresh = ct.build_cut_tree(p_new, solver="exact", device="cpu")
    a, b = rep.min_cut_matrix(), fresh.min_cut_matrix()
    off = ~np.eye(p.n, dtype=bool)
    assert np.allclose(a[off], b[off], rtol=1e-6)
    assert rep.meta["n_solves"] > 0 and rep.meta["solver"] == "irls"


def test_repair_rejects_unrepairable_trees():
    p = _port(_grid(5, 5))
    c = np.asarray(p.graph.weight, dtype=np.float64)
    c2 = c * 1.1
    no_sides = ct.build_cut_tree(p, solver="exact", store_sides=False,
                                 device="cpu")
    with pytest.raises(ValueError, match="store_sides"):
        ct.repair_cut_tree(_with_weights(p, c2, True), no_sides, c, c2,
                           device="cpu")
    gh = ct.build_cut_tree(p, solver="exact", contract=True, device="cpu")
    with pytest.raises(ValueError, match="acceptance order|contracted"):
        ct.repair_cut_tree(_with_weights(p, c2, True), gh, c, c2,
                           device="cpu")
    approx = ct.build_cut_tree(p, solver="irls", cfg=CFG, refine=False,
                               device="cpu")
    with pytest.raises(ValueError, match="approximate"):
        ct.repair_cut_tree(_with_weights(p, c2, True), approx, c, c2,
                           device="cpu")


# ---------------------------------------------------------------------------
# CutTreeService
# ---------------------------------------------------------------------------

def test_service_builds_once_then_serves_from_cache():
    insts = [tiny_instance(n=10, seed=s) for s in (0, 1)]
    svc = CutTreeService(cfg=CFG, capacity=2, solver="exact", device="cpu")
    ref = JService(cfg=JCFG, capacity=2, solver="exact")
    keys = [svc.register(_port(i)) for i in insts]
    assert keys == [ref.register(i) for i in insts]
    v = svc.min_cut(keys[0], 0, 5)
    assert v == ref.min_cut(keys[0], 0, 5)
    assert v == pytest.approx(_dinic_pair(_port(insts[0]), 0, 5), rel=1e-8)
    assert svc.tree_stats.misses == 1
    assert svc.min_cut(keys[0], 0, 5) == v == ref.min_cut(keys[0], 0, 5)
    for s in (svc, ref):
        s.global_min_cut(keys[0])
        s.partition(keys[0], 2, 7)
    assert svc.tree_stats.misses == 1 and svc.tree_stats.hits >= 3
    got, want = svc.stats(), ref.stats()
    assert set(got) == set(want)
    for key in ("queries", "pair_solves", "trees_cached", "tree_cache",
                "weight_updates", "repairs", "invalidations"):
        assert got[key] == want[key], key
    assert got["queries"] == 4 and got["pair_solves"] == 9
    assert np.isfinite(got["query_p50_us"])
    with pytest.raises(KeyError, match="unknown topology"):
        svc.min_cut("deadbeef", 0, 1)


def test_service_lru_evicts_and_rebuilds_trees():
    insts = [tiny_instance(n=8, seed=s) for s in range(3)]
    svc = CutTreeService(cfg=CFG, capacity=2, solver="exact", device="cpu")
    keys = [svc.register(_port(i)) for i in insts]
    for k in keys:
        svc.min_cut(k, 0, 3)
    assert svc.tree_stats.evictions == 1
    svc.min_cut(keys[0], 0, 3)
    assert svc.tree_stats.rebuilds == 1
    assert svc.stats()["trees_cached"] == 2


def test_service_update_weights_repaired_invalidated_unchanged():
    """tests/test_drift.py's service drift: "repaired" (the tree equal to
    the reference service's and to a fresh exact build), then "unchanged",
    and "invalidated" for a topology with no cached tree."""
    j = _grid(6, 7)
    svc = CutTreeService(solver="exact", device="cpu")
    ref = JService(solver="exact")
    key = svc.register(_port(j))
    assert key == ref.register(j)
    for s in (svc, ref):
        s.min_cut(key, 0, j.n - 1)
    c = np.asarray(j.graph.weight, dtype=np.float64).copy()
    c2 = _drift(np.random.default_rng(7), c, k=4, upward=True)
    assert svc.update_weights(key, c2) == "repaired"
    assert ref.update_weights(key, c2) == "repaired"
    _assert_same_tree(svc.tree(key), ref.tree(key))
    fresh = ct.build_cut_tree(_with_weights(_port(j), c2, True),
                              solver="exact", device="cpu")
    assert _all_pairs_rel(svc.tree(key), fresh) <= 1e-9
    assert svc.update_weights(key, c2) == "unchanged"
    st = svc.stats()
    assert st["repairs"] == 1 and st["weight_updates"] == 1
    assert st["repair_reused"] == ref.stats()["repair_reused"]
    key2 = svc.register(_port(_grid(5, 8)))
    inst2 = svc.sessions.instance(key2)
    assert svc.update_weights(
        key2, np.asarray(inst2.graph.weight) * 2.0) == "invalidated"
    with pytest.raises(ValueError, match="shape"):
        svc.update_weights(key2, np.ones(3))


def test_service_irls_refined_matches_oracle():
    """An IRLS service builds its tree through a session on its device
    (the session cache's); refined pair values at the Dinic cut."""
    p = _port(tiny_instance(n=12, seed=4))
    svc = CutTreeService(cfg=CFG, solver="irls", refine=True, max_batch=8,
                         device="cpu")
    key = svc.register(p)
    for u, v in [(0, 7), (3, 10), (5, 1)]:
        assert svc.min_cut(key, u, v) == pytest.approx(_dinic_pair(p, u, v),
                                                       rel=1e-3)
    assert svc.sessions.get(key).device == torch.device("cpu")
    assert svc.stats()["sessions"]["misses"] == 1


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cut_tree_cli_matches_reference(tmp_path, monkeypatch, capsys):
    """``launch.cut_tree --device cpu --side 6`` in-process: the reference
    CLI's JSON keys, pair count, global min cut and verify gate."""
    from repro.launch import cut_tree as jcli
    from repro_torch.launch import cut_tree as cli

    args = ["--side", "6", "--verify-pairs", "10", "--queries", "200"]
    assert cli.main(args + ["--device", "cpu", "--json-out",
                            str(tmp_path / "port.json")]) == 0
    out = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["cut_tree"])
    assert jcli.main(args + ["--json-out", str(tmp_path / "ref.json")]) == 0
    ref_out = capsys.readouterr().out
    got = json.loads((tmp_path / "port.json").read_text())
    want = json.loads((tmp_path / "ref.json").read_text())
    assert set(got) == set(want) and set(got["meta"]) == set(want["meta"])
    for key in ("n", "m", "family"):
        assert got[key] == want[key]
    assert got["meta"]["n_pairs"] == want["meta"]["n_pairs"] == 35
    assert got["global_min_cut"] == pytest.approx(want["global_min_cut"],
                                                  rel=1e-6)
    assert got["verify_max_rel"] <= 1e-3 and want["verify_max_rel"] <= 1e-3
    # the same lines, up to the times
    assert [ln.split(":")[0] for ln in out.splitlines()] == \
        [ln.split(":")[0] for ln in ref_out.splitlines()]
    assert "verify: 10 pairs" in out and "OK" in out
    # an unverifiable gate fails: the exit contract
    assert cli.main(args + ["--device", "cpu", "--solver", "exact",
                            "--verify-rtol", "-1"]) == 1
