"""The port's presolve (``repro_torch.presolve`` and the session's
``presolve=True``) against the JAX package's ``repro.presolve`` on the CPU.

The reduction rules, kernels, patches, contractions and lifts are numpy in
both packages, so the port's copies must give the same arrays bit for bit
(``_connected_components`` is the one routine written differently: scipy's
components relabelled by their smallest node id).  The solves hold the
tolerances of tests/test_presolve.py: cuts within rel 1e-6 of the JAX
package's and of the exact Dinic oracle, certificates with rel_gap 0
(abs 1e-9).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.presolve as jpre  # noqa: E402
from repro.core import (IRLSConfig as JConfig, MinCutSession as JSession,  # noqa: E402
                        Problem as JProblem)
from repro.graphs import generators as jgen  # noqa: E402
from repro.presolve.rules import _connected_components as jcomponents  # noqa: E402

import repro_torch.presolve as pre  # noqa: E402
from repro_torch.core import (IRLSConfig, MinCutSession, Problem, Weights,  # noqa: E402
                              max_flow)
from repro_torch.graphs.structures import (EdgeList, STInstance,  # noqa: E402
                                           instance_from_arrays)
from repro_torch.presolve.rules import _connected_components  # noqa: E402
from repro_torch.serve import MinCutServer  # noqa: E402

# tests/test_presolve.py's STRONG schedule: strong enough that the plain
# path reaches the true min cut on pinned pairs
STRONG = dict(n_irls=50, pcg_max_iters=150, precond="jacobi", n_blocks=1,
              pcg_tol=1e-8, eps=1e-6)


def _port(inst):
    return instance_from_arrays(inst.graph.src, inst.graph.dst,
                                inst.graph.weight, inst.graph.n,
                                inst.s_weight, inst.t_weight)


def _pinned(g, s, t):
    """One-hot pinned-pair instance (a nontrivial kernel remains) from a
    JAX-package edge list, as the JAX package builds it."""
    from repro.core import rebind_terminals as jrebind
    from repro.graphs.structures import STInstance as JInst

    inst0 = JInst(graph=g, s_weight=np.zeros(g.n), t_weight=np.zeros(g.n))
    w = jrebind(inst0, s, t)
    return JInst(graph=g, s_weight=w.c_s, t_weight=w.c_t)


def _random_instance(seed):
    """tests/test_presolve.py's seeded topology/terminal variety (JAX
    package instance)."""
    from repro.graphs.structures import STInstance as JInst

    rng = np.random.default_rng(seed)
    kind = seed % 3
    if kind == 0:
        g = jgen.social_like(30 + 7 * (seed % 5), seed=seed)
    elif kind == 1:
        g = jgen.road_like(5 + seed % 3, seed=seed)
    else:
        g = jgen.random_regular(20 + seed, 3, seed=seed)
    if seed % 2 == 0:
        s, t = rng.choice(g.n, size=2, replace=False)
        return _pinned(g, int(s), int(t))
    c_s = np.where(rng.uniform(size=g.n) < 0.15, rng.uniform(0.5, 2.0, g.n),
                   0.0)
    c_t = np.where(rng.uniform(size=g.n) < 0.15, rng.uniform(0.5, 2.0, g.n),
                   0.0)
    c_s[int(rng.integers(g.n))] += 1.0
    j = int(rng.integers(g.n))
    c_t[j] += 1.0
    c_s[j] = 0.0
    return JInst(graph=g, s_weight=c_s, t_weight=c_t)


def _fixture(name):
    """JAX-package instances: road_like pinned, a dense-terminal grid, and
    the random variety."""
    if name == "road":
        return _pinned(jgen.road_like(9, seed=0), 4, 75)
    if name == "road_flow":
        return jgen.flow_improve_instance(jgen.road_like(12, seed=5), seed=6)
    if name == "grid":
        g = jgen.grid_2d(10, 10, seed=3)
        return jgen.segmentation_instance(g, (10, 10), seed=4)
    if name == "grid12":              # tests/test_drift.py's patch fixture
        g = jgen.grid_2d(12, 12, seed=3)
        return jgen.segmentation_instance(g, (12, 12), seed=4)
    return _random_instance(int(name.split("_")[1]))


FIXTURES = ["road", "road_flow", "grid"] + [f"random_{s}" for s in range(6)]


def _same(a, b, path="x"):
    """a (port) equals b (JAX package) field for field, array for array:
    same dtypes, bit-equal values."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif hasattr(a, "_fields"):
        assert a._fields == b._fields, path
        for f in a._fields:
            _same(getattr(a, f), getattr(b, f), f"{path}.{f}")
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype,
                                                           b.dtype)
        assert np.array_equal(a, b), path
    else:
        assert a == b, (path, a, b)


# ---------------------------------------------------------------------------
# connected components: scipy relabelled == the JAX package's propagation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(8))
def test_connected_components_labels_match_reference(seed):
    """Random multigraphs over n + 2 slots (the rules' S and T), with
    isolated nodes and repeated edges: the same int64 labels."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 200))
    m = int(rng.integers(0, 2 * n))
    eu = rng.integers(0, n + 2, m).astype(np.int64)
    ev = rng.integers(0, n + 2, m).astype(np.int64)
    got = _connected_components(n + 2, eu, ev)
    want = jcomponents(n + 2, eu, ev)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    # each component is labelled by its smallest node id
    assert np.all(got <= np.arange(n + 2))
    assert np.all(got[got] == got)


@pytest.mark.parametrize("n_total", [1, 2, 7])
def test_connected_components_empty_edge_set(n_total):
    e = np.zeros(0, dtype=np.int64)
    np.testing.assert_array_equal(_connected_components(n_total, e, e),
                                  jcomponents(n_total, e, e))


def test_connected_components_on_a_long_path():
    """A path numbered against its order (the reference propagates over
    O(diameter) sweeps; scipy does not) and a second component."""
    rng = np.random.default_rng(1)
    order = rng.permutation(500)
    eu = np.concatenate([order[:-1], [600, 601]]).astype(np.int64)
    ev = np.concatenate([order[1:], [601, 602]]).astype(np.int64)
    np.testing.assert_array_equal(_connected_components(605, eu, ev),
                                  jcomponents(605, eu, ev))


def test_problem_component_labels_match_reference(road_instance):
    got = Problem.build(_port(road_instance), n_blocks=1).component_labels()
    want = JProblem.build(road_instance, n_blocks=1).component_labels()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# rules, kernels, patches, contractions: array for array
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", FIXTURES)
def test_reduce_instance_matches_reference(name):
    inst = _fixture(name)
    for rules in (("components",), ("degree2",), jpre.RULES):
        got = pre.reduce_instance(_port(inst), rules=rules, track=True)
        want = jpre.reduce_instance(inst, rules=rules, track=True)
        _same(got, want, f"{name}:{rules}")


@pytest.mark.parametrize("name", FIXTURES)
def test_kernelize_matches_reference(name):
    inst = _fixture(name)
    got = pre.kernelize(_port(inst))
    want = jpre.kernelize(inst)
    _same(got, want, name)
    # the kernel is exact: kernel cut + base = the instance's min cut
    oracle = max_flow(_port(inst)).value
    kv = got.base if got.trivial else max_flow(got.instance).value + got.base
    assert kv == pytest.approx(oracle, abs=1e-9)


@pytest.mark.parametrize("name", ["road", "road_flow", "grid12", "random_1"])
def test_patch_kernel_matches_reference(name):
    """A chain of sparse drifts: each patch (or refusal, None) equals the
    JAX package's, and a patched kernel prices cuts like the oracle."""
    inst = _fixture(name)
    rng = np.random.default_rng(7)
    c = np.asarray(inst.graph.weight, dtype=np.float64).copy()
    cs = np.asarray(inst.s_weight, dtype=np.float64)
    ct = np.asarray(inst.t_weight, dtype=np.float64)
    k_p, k_j = pre.kernelize(_port(inst)), jpre.kernelize(inst)
    patched = 0
    for step in range(5):
        c2 = c.copy()
        idx = rng.choice(c.size, size=2, replace=False)
        c2[idx] *= np.exp(rng.normal(0.0, 0.3, size=2))
        got = pre.patch_kernel(k_p, (c, cs, ct), (c2, cs, ct))
        want = jpre.patch_kernel(k_j, (c, cs, ct), (c2, cs, ct))
        assert (got is None) == (want is None), step
        if got is None:
            got = pre.kernelize(_port(inst), c=c2)
            want = jpre.kernelize(inst, c=c2)
        else:
            patched += 1
        _same(got, want, f"{name}:{step}")
        oracle = max_flow(instance_from_arrays(
            inst.graph.src, inst.graph.dst, c2, inst.n, cs, ct)).value
        kv = got.base if got.trivial else max_flow(got.instance).value + got.base
        assert kv == pytest.approx(oracle, rel=1e-9, abs=1e-9)
        k_p, k_j, c = got, want, c2
    assert name != "grid12" or patched > 0


@pytest.mark.parametrize("name", ["road", "grid"])
def test_derive_instance_and_contraction_map_match_reference(name):
    inst = _fixture(name)
    rng = np.random.default_rng(3)
    groups = [rng.choice(inst.n, size=4, replace=False)[:2 + i]
              for i in range(3)]
    groups = [g for i, g in enumerate(groups)
              if not np.intersect1d(g, np.concatenate(groups[:i] or
                                                      [np.zeros(0, int)])).size]
    vm = pre.contraction_map(inst.n, groups)
    np.testing.assert_array_equal(vm, jpre.contraction_map(inst.n, groups))
    got = pre.derive_instance(_port(inst), vm)
    want = jpre.derive_instance(inst, vm)
    _same(got, want, name)
    c = rng.uniform(0.5, 2.0, inst.graph.m)
    np.testing.assert_array_equal(got.project_weights(c),
                                  want.project_weights(c))
    side = rng.uniform(size=got.instance.n) < 0.5
    np.testing.assert_array_equal(got.lift_partition(side),
                                  want.lift_partition(side))


@pytest.mark.parametrize("name", ["road", "road_flow", "random_3"])
def test_lift_and_certificate_match_reference(name):
    """Any kernel side lifts to the same partition and voltages, and the
    certificate is exact (rel_gap 0) and equal to the JAX package's."""
    inst = _fixture(name)
    k_p, k_j = pre.kernelize(_port(inst)), jpre.kernelize(inst)
    rng = np.random.default_rng(0)
    for _ in range(4):
        side = None if k_p.trivial else rng.uniform(size=k_p.kernel_n) < 0.5
        v = None if k_p.trivial else rng.uniform(size=k_p.kernel_n)
        np.testing.assert_array_equal(k_p.lift_partition(side),
                                      k_j.lift_partition(side))
        np.testing.assert_array_equal(k_p.lift_voltages(v),
                                      k_j.lift_voltages(v))
        cert = k_p.certificate(side)
        assert cert == k_j.certificate(side)
        assert cert["rel_gap"] == pytest.approx(0.0, abs=1e-12)


def test_problem_contract_and_derive_match_reference(road_instance):
    inst = _port(road_instance)
    prob, jprob = Problem.build(inst, 1), JProblem.build(road_instance, 1)
    s_nodes, t_nodes = [0, 1, 6], [inst.n - 1, inst.n - 2]
    cprob, d, w = prob.contract(s_nodes, t_nodes)
    jcprob, jd, jw = jprob.contract(s_nodes, t_nodes)
    _same(d, jd)
    for a, b in zip(w, jw):
        np.testing.assert_array_equal(a, b)
    oracle = max_flow(STInstance(graph=cprob.instance.graph, s_weight=w.c_s,
                                 t_weight=w.c_t)).value
    res = MinCutSession(cprob, IRLSConfig(**STRONG), device="cpu").solve(
        weights=w)
    assert res.cut_value == pytest.approx(oracle, rel=1e-6)
    with pytest.raises(ValueError, match="disjoint"):
        prob.contract([0, 1], [1, 2])
    vm = pre.contraction_map(inst.n, [[0, 1, 2]])
    dprob, dd = prob.derive(vm)
    _, jdd = jprob.derive(vm)
    _same(dd, jdd)
    assert dprob.instance.n == inst.n - 2


# ---------------------------------------------------------------------------
# presolve=True through the session: host and scanned
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pinned_road():
    return _pinned(jgen.road_like(9, seed=0), 4, 75)


@pytest.mark.parametrize("backend", ["host", "scanned"])
def test_presolve_parity(pinned_road, backend):
    """tests/test_presolve.py's parity case on the port: the presolved cut
    equals the plain one, the JAX package's and the oracle's within rel
    1e-6; the certificate is exact and the voltages polarize."""
    inst = _port(pinned_road)
    oracle = max_flow(inst).value
    sess = MinCutSession(Problem.build(inst, n_blocks=1),
                         IRLSConfig(**STRONG), device="cpu")
    plain = sess.solve(backend=backend)
    got = sess.solve(backend=backend, presolve=True)
    want = JSession(JProblem.build(pinned_road, n_blocks=1),
                    JConfig(**STRONG)).solve(backend=backend, presolve=True)
    assert plain.cut_value == pytest.approx(oracle, rel=1e-6)
    assert got.cut_value == pytest.approx(plain.cut_value, rel=1e-6)
    assert got.cut_value == pytest.approx(want.cut_value, rel=1e-6)
    meta = got.cut.meta["presolve"]
    assert meta["kernel_n"] == want.cut.meta["presolve"]["kernel_n"]
    assert 0 < meta["kernel_n"] < inst.n
    assert meta["certificate"]["rel_gap"] == pytest.approx(0.0, abs=1e-9)
    assert got.cut_value == meta["certificate"]["lifted_cut"]
    assert got.voltages[4] > 0.9 and got.voltages[75] < 0.1
    assert got.telemetry["presolve"]["action"] == "rebuild"
    assert got.backend == backend


@pytest.mark.parametrize("layout", ["coo", "ell"])
def test_presolve_dense_terminals_stays_exact(grid_instance, layout):
    """Dense terminals barely kernelize; presolve stays exact (on the
    fused-ELL path too)."""
    cfg = IRLSConfig(**STRONG, layout=layout)
    sess = MinCutSession(Problem.build(_port(grid_instance), n_blocks=1), cfg,
                         device="cpu")
    got = sess.solve(presolve=True)
    plain = sess.solve()
    meta = got.cut.meta["presolve"]
    assert 0 < meta["kernel_n"] < grid_instance.n
    assert meta["certificate"]["rel_gap"] == pytest.approx(0.0, abs=1e-9)
    assert got.cut_value == pytest.approx(plain.cut_value, rel=1e-6)
    assert got.cut_value == pytest.approx(max_flow(_port(grid_instance)).value,
                                          rel=1e-6)


def test_solve_batch_presolve_matches_plain():
    jinst = _pinned(jgen.road_like(8, seed=2), 5, 58)
    inst = _port(jinst)
    sess = MinCutSession(Problem.build(inst, n_blocks=1),
                         IRLSConfig(**STRONG), device="cpu")
    base = Weights(np.asarray(inst.graph.weight),
                   np.asarray(inst.s_weight), np.asarray(inst.t_weight))
    ws = [Weights(base.c * s, base.c_s, base.c_t) for s in (1.0, 1.5, 0.8)]
    batch = sess.solve_batch(ws, presolve=True)
    want = JSession(JProblem.build(jinst, n_blocks=1),
                    JConfig(**STRONG)).solve_batch(ws, presolve=True)
    assert len(batch) == 3
    for w, res, ref in zip(ws, batch, want):
        plain = sess.solve(weights=w, backend="scanned")
        assert res.cut_value == pytest.approx(plain.cut_value, rel=1e-6)
        assert res.cut_value == pytest.approx(ref.cut_value, rel=1e-6)
        assert res.backend == "scanned"
    with pytest.raises(ValueError, match="cold"):
        sess.solve_batch(ws, presolve=True, warm_from=[batch[0]] * 3)


def test_presolve_warm_start_projects_voltages(pinned_road):
    inst = _port(pinned_road)
    sess = MinCutSession(Problem.build(inst, n_blocks=1),
                         IRLSConfig(**STRONG), device="cpu")
    cold = sess.solve(presolve=True)
    warm = sess.solve(presolve=True, warm_from=cold)
    assert warm.cut_value == pytest.approx(cold.cut_value, rel=1e-6)
    assert warm.telemetry["presolve"]["action"] == "reuse"
    assert len(warm.diagnostics.pcg_iters) == STRONG["n_irls"]


# ---------------------------------------------------------------------------
# disconnected terminals and stray components
# ---------------------------------------------------------------------------

def _two_component_instance():
    g = EdgeList(src=np.array([0, 1, 3, 4], dtype=np.int32),
                 dst=np.array([1, 2, 4, 5], dtype=np.int32),
                 weight=np.ones(4), n=6)
    c_s = np.zeros(6)
    c_t = np.zeros(6)
    c_s[0] = 1.0
    c_t[5] = 1.0
    return STInstance(graph=g, s_weight=c_s, t_weight=c_t)


@pytest.mark.parametrize("kwargs", [{}, {"presolve": True},
                                    {"backend": "scanned"},
                                    {"backend": "scanned", "presolve": True}])
def test_disconnected_st_returns_trivial_zero_cut(kwargs):
    inst = _two_component_instance()
    sess = MinCutSession(Problem.build(inst, n_blocks=1),
                         IRLSConfig(**STRONG), device="cpu")
    res = sess.solve(**kwargs)
    assert res.cut_value == 0.0
    ind = np.asarray(res.cut.in_source)
    assert ind[0] and not ind[5]
    np.testing.assert_allclose(res.voltages, [1, 1, 1, 0, 0, 0], atol=1e-12)
    k = pre.kernelize(inst)
    assert k.trivial and k.base == 0.0 and not k.st_connected


def test_stray_component_requires_presolve():
    """A terminal-free component leaves the Laplacian singular: the plain
    path refuses with a pointer at presolve=True, which solves it."""
    g = EdgeList(src=np.array([0, 2], dtype=np.int32),
                 dst=np.array([1, 3], dtype=np.int32),
                 weight=np.array([2.0, 1.0]), n=4)
    c_s = np.zeros(4)
    c_t = np.zeros(4)
    c_s[0] = 5.0
    c_t[1] = 5.0
    inst = STInstance(graph=g, s_weight=c_s, t_weight=c_t)
    sess = MinCutSession(Problem.build(inst, n_blocks=1),
                         IRLSConfig(**STRONG), device="cpu")
    with pytest.raises(ValueError, match="presolve"):
        sess.solve()
    res = sess.solve(presolve=True)
    assert res.cut_value == pytest.approx(2.0, abs=1e-12)


# ---------------------------------------------------------------------------
# drift: kernel patching under a delta key, and the server
# ---------------------------------------------------------------------------

def _grid_port(side, seed):
    g = jgen.grid_2d(side, side, seed=seed)
    return _port(jgen.segmentation_instance(g, (side, side), seed=seed + 1))


@pytest.mark.parametrize("backend", ["host", "scanned"])
def test_presolve_delta_key_patches_and_stays_exact(backend):
    """tests/test_drift.py's patch sequence on the port: patched kernels
    price cuts like the Dinic oracle (rel 1e-7), and the outcome telemetry
    records reuse, patch and rebuild as the JAX package's does."""
    inst = _grid_port(12, 3)
    cfg = dict(n_irls=25, pcg_max_iters=80, precond="jacobi", n_blocks=1,
               pcg_tol=1e-8, eps=1e-6)
    sess = MinCutSession(Problem.build(inst, n_blocks=1), IRLSConfig(**cfg),
                         backend=backend, device="cpu")
    jsess = JSession(JProblem.build(inst, n_blocks=1), JConfig(**cfg),
                     backend=backend)
    rng = np.random.default_rng(3)
    c = np.asarray(inst.graph.weight, dtype=np.float64).copy()
    actions = []
    for step in range(6):
        if step:
            c = c.copy()
            idx = rng.choice(c.size, size=2, replace=False)
            c[idx] *= np.exp(rng.normal(0.0, 0.3, size=2))
        w = (c.copy(), inst.s_weight, inst.t_weight)
        res = sess.solve(weights=w, presolve=True, delta_key="tenant")
        ref = jsess.solve(weights=w, presolve=True, delta_key="tenant")
        actions.append(res.telemetry["presolve"]["action"])
        assert actions[-1] == ref.telemetry["presolve"]["action"], step
        if step == 0:
            r2 = sess.solve(weights=w, presolve=True, delta_key="tenant")
            assert r2.telemetry["presolve"]["action"] == "reuse"
            jsess.solve(weights=w, presolve=True, delta_key="tenant")
        oracle = max_flow(instance_from_arrays(
            inst.graph.src, inst.graph.dst, c, inst.n, inst.s_weight,
            inst.t_weight)).value
        assert res.cut_value == pytest.approx(oracle, rel=1e-7), step
        assert res.cut_value == res.cut.meta["presolve"]["certificate"][
            "lifted_cut"]
    outcomes = sess.telemetry_snapshot()["kernel_outcomes"]
    assert outcomes == jsess.telemetry_snapshot()["kernel_outcomes"]
    assert outcomes["reuse"] >= 1 and outcomes["patch"] >= 1
    assert sum(outcomes.values()) == 7


@pytest.mark.parametrize("backend", ["scanned", "host"])
def test_server_presolve(backend):
    """MinCutServer(presolve=True) and a per-request override: every served
    cut is the lifted, certified cut of the same presolved solve."""
    inst = _port(_pinned(jgen.road_like(8, seed=2), 5, 58))
    cfg = IRLSConfig(**STRONG)
    ws = [Weights(np.asarray(inst.graph.weight) * s, inst.s_weight,
                  inst.t_weight) for s in (1.0, 1.25)]
    want = [max_flow(instance_from_arrays(inst.graph.src, inst.graph.dst,
                                          w.c, inst.n, w.c_s, w.c_t)).value
            for w in ws]
    with MinCutServer(cfg=cfg, presolve=True, backend=backend, max_batch=2,
                      n_workers=1, device="cpu") as srv:
        key = srv.register(inst)
        got = [f.result(timeout=300) for f in srv.submit_many(key, ws)]
        off = srv.submit(key, ws[0], presolve=False).result(timeout=300)
        tel = srv.stats()["telemetry"]
    for res, oracle in zip(got, want):
        assert res.cut_value == pytest.approx(oracle, rel=1e-6)
        cert = res.cut.meta["presolve"]["certificate"]
        assert cert["rel_gap"] == pytest.approx(0.0, abs=1e-9)
        assert res.telemetry["presolve"]["kernel_n"] < inst.n
    assert "presolve" not in off.cut.meta
    assert off.cut_value == pytest.approx(want[0], rel=1e-6)
    assert tel["solves"] == 3


def test_adaptive_early_exit_gap_and_presolve_on_scaled_road():
    """The serving config's adaptive schedule (irls_tol 1e-3) stops the
    solve of a scaled road instance above its min cut, in the JAX package
    and the port alike (the same two-level cut); the presolved solve
    reaches the exact Dinic cut (rel 1e-6).  The shape of chip_smoke's
    phase 11c, at side 256."""
    jinst = jgen.flow_improve_instance(jgen.road_like(256, seed=0), seed=1)
    inst = _port(jinst)
    kw = dict(n_irls=20, n_blocks=1, precond="jacobi", irls_tol=1e-3,
              adaptive_tol=True, layout="ell", fuse_edge_sweep=True,
              use_pallas=True)
    w = Weights(np.asarray(inst.graph.weight) * 1.5, inst.s_weight,
                inst.t_weight)
    exact = max_flow(instance_from_arrays(inst.graph.src, inst.graph.dst,
                                          w.c, inst.n, w.c_s, w.c_t)).value
    sess = MinCutSession(Problem.build(inst, n_blocks=1), IRLSConfig(**kw),
                         device="cpu")
    plain = sess.solve(weights=w)
    ref = JSession(JProblem.build(jinst, n_blocks=1),
                   JConfig(**kw)).solve(weights=tuple(w))
    assert plain.cut_value == pytest.approx(ref.cut_value, rel=1e-6)
    assert plain.cut_value > exact * (1 + 1e-2)
    pre = sess.solve(weights=w, presolve=True)
    assert pre.cut_value == pytest.approx(exact, rel=1e-6)
