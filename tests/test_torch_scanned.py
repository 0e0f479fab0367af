"""The port's scanned backend (``make_scanned_program`` → ``solve_batch``)
against the JAX package's scanned backend on the CPU, on the grid and road
fixtures with the reference's partition labels.

Three configs: the server default with ``use_pallas`` (COO layout, point
Jacobi, adaptive schedule — the edge-reweight kernel's wrapper, its plain
version here), the fixed schedule, and the slice-1 kernel config (fused ELL
sweep, ELL SpMV, explicit-inverse block Jacobi).  Each batch is B = 3 lanes
of drifted weights.

Tolerances, as tests/test_torch_irls.py holds the host driver: per-lane PCG
iteration counts equal; rounded cuts at rel 1e-6; voltages at atol 2e-3.

The grid fixture runs at ε = 1e-3 for the counts and voltages.  At the
default ε = 1e-6 its float32 PCG stalls at a relative residual of ~7e-7,
within float32 rounding of the adaptive schedule's tight tolerance 1e-6, so
whether a solve stops there — and every decision of the schedule after it —
falls either way on roundoff: the JAX package's own solo and B = 3 runs of
the same weights spend different counts there, and the fixed schedule's
30 steps past convergence move plateau voltages by ~3e-2 in both packages.
The cuts agree exactly all the same (``test_cut_matches_at_default_eps``).
The road fixture runs at the default ε.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import (IRLSConfig as JConfig, MinCutSession as JSession,  # noqa: E402
                        Problem as JProblem)
from repro.core.session import (rebind_terminals as jrebind,  # noqa: E402
                                topology_fingerprint as jfingerprint)
from repro.graphs import partition as jgp  # noqa: E402

from repro_torch.core import (IRLSConfig, MinCutSession, Problem,  # noqa: E402
                              Weights)
from repro_torch.core.irls import make_scanned_program  # noqa: E402
from repro_torch.core.session import (rebind_terminals,  # noqa: E402
                                      topology_fingerprint)
from repro_torch.graphs.structures import (EdgeList, STInstance,  # noqa: E402
                                           instance_from_arrays)
from repro_torch.kernels import ops  # noqa: E402

SERVER = dict(n_irls=20, n_blocks=1, precond="jacobi", irls_tol=1e-3,
              adaptive_tol=True, use_pallas=True)
FIXED = dict(n_irls=8, n_blocks=1, precond="jacobi", pcg_max_iters=30)
KERNEL = dict(layout="ell", fuse_edge_sweep=True, use_pallas=True,
              precond="block_jacobi", explicit_block_inverse=True, n_blocks=4,
              n_irls=8, pcg_max_iters=30)
CONFIGS = {"server": SERVER, "fixed": FIXED, "kernel": KERNEL}
EPS = {"grid_instance": 1e-3, "road_instance": 1e-6}
CASES = [(f, c) for f in EPS for c in CONFIGS]
B = 3


def _port(inst):
    return instance_from_arrays(inst.graph.src, inst.graph.dst,
                                inst.graph.weight, inst.graph.n,
                                inst.s_weight, inst.t_weight)


def _drifted(inst, n_lanes=B, seed=0):
    rng = np.random.default_rng(seed)
    return [Weights(np.asarray(inst.graph.weight)
                    * rng.uniform(0.8, 1.2, inst.graph.m),
                    np.asarray(inst.s_weight), np.asarray(inst.t_weight))
            for _ in range(n_lanes)]


def _sessions(inst, kw):
    """(reference, port) scanned sessions on the same partition."""
    nb = kw["n_blocks"]
    labels = jgp.partition_kway(inst.graph, nb) if nb > 1 else None
    js = JSession(JProblem.build(inst, nb, labels=labels), JConfig(**kw),
                  backend="scanned")
    ts = MinCutSession(Problem.build(_port(inst), nb, labels=labels),
                       IRLSConfig(**kw), backend="scanned", device="cpu")
    return js, ts


@pytest.fixture(scope="module")
def batches():
    """(fixture, config) → (reference results, port results), each batch
    solved once per module."""
    cache = {}

    def get(request, fixture, config):
        key = (fixture, config)
        if key not in cache:
            inst = request.getfixturevalue(fixture)
            kw = dict(CONFIGS[config], eps=EPS[fixture])
            js, ts = _sessions(inst, kw)
            ws = _drifted(inst)
            cache[key] = (js.solve_batch(ws), ts.solve_batch(ws))
        return cache[key]
    return get


@pytest.mark.parametrize("fixture,config", CASES)
def test_pcg_iterations_match(batches, request, fixture, config):
    jr, tr = batches(request, fixture, config)
    assert len(tr) == len(jr) == B
    for j, t in zip(jr, tr):
        assert t.backend == "scanned"
        assert t.pcg_iters.shape == (CONFIGS[config]["n_irls"],)
        np.testing.assert_array_equal(t.pcg_iters, j.pcg_iters)


@pytest.mark.parametrize("fixture,config", CASES)
def test_voltages_match(batches, request, fixture, config):
    jr, tr = batches(request, fixture, config)
    for j, t in zip(jr, tr):
        assert np.isfinite(t.voltages).all()
        np.testing.assert_allclose(t.voltages, j.voltages, rtol=0, atol=2e-3)


@pytest.mark.parametrize("fixture,config", CASES)
def test_cut_matches(batches, request, fixture, config):
    jr, tr = batches(request, fixture, config)
    for j, t in zip(jr, tr):
        assert t.cut_value == pytest.approx(j.cut_value, rel=1e-6)
        assert t.cut.meta["method"] == "two_level"


@pytest.mark.parametrize("config", CONFIGS)
def test_cut_matches_at_default_eps(grid_instance, config):
    """At ε = 1e-6 the grid's PCG counts and plateau voltages follow
    roundoff (module docstring); the rounded cuts still agree."""
    js, ts = _sessions(grid_instance, CONFIGS[config])
    ws = _drifted(grid_instance, seed=1)
    for j, t in zip(js.solve_batch(ws), ts.solve_batch(ws)):
        assert np.isfinite(t.voltages).all()
        assert t.cut_value == pytest.approx(j.cut_value, rel=1e-6)


def test_warm_from_matches(road_instance):
    """The warm-started program (no cold initial WLS) from the previous
    batch's voltages: same per-lane spend and cuts as the JAX package."""
    js, ts = _sessions(road_instance, SERVER)
    ws = _drifted(road_instance)
    j1, t1 = js.solve_batch(ws), ts.solve_batch(ws)
    ws2 = _drifted(road_instance, seed=5)
    j2 = js.solve_batch(ws2, warm_from=[j1[-1]] * B)
    t2 = ts.solve_batch(ws2, warm_from=[t1[-1]] * B)
    for j, t in zip(j2, t2):
        assert t.telemetry["warm_start"] is True
        np.testing.assert_array_equal(t.pcg_iters, j.pcg_iters)
        assert t.cut_value == pytest.approx(j.cut_value, rel=1e-6)
        np.testing.assert_allclose(t.voltages, j.voltages, atol=2e-3)
    with pytest.raises(ValueError, match="warm_from"):
        ts.solve_batch(ws2, warm_from=[t1[-1]])


def test_single_scanned_solve_matches(road_instance):
    """``solve(backend="scanned")``: one instance through the same program.

    The one case held to within one PCG step at one IRLS iteration, not to
    equal counts: the JAX package solves a single instance with its
    unvmapped program, whose XLA lowering sums in another order than its
    batches, and on this fixture an inner solve there ends one step either
    side of its tolerance (43 against 44 steps).  The port runs a solo
    solve as a batch of one, the arithmetic of every lane of a batch."""
    js, ts = _sessions(road_instance, SERVER)
    j, t = js.solve(), ts.solve()
    assert t.backend == "scanned" and t.diagnostics is None
    gap = np.abs(t.pcg_iters.astype(int) - np.asarray(j.pcg_iters, int))
    assert gap.max() <= 1 and np.count_nonzero(gap) <= 1, (t.pcg_iters,
                                                          j.pcg_iters)
    assert t.cut_value == pytest.approx(j.cut_value, rel=1e-6)
    np.testing.assert_allclose(t.voltages, j.voltages, atol=2e-3)
    assert t.telemetry["pcg_per_iter"] == [int(i) for i in t.pcg_iters]
    assert t.telemetry["warm_start"] is False
    assert set(t.timings) >= {"setup", "irls", "irls_wall", "rounding", "total"}


@pytest.mark.parametrize("config", ["server", "kernel"])
def test_co_batched_equals_solo(grid_instance, config):
    """A lane of a batch gives what the same weights give solved alone
    (bit for bit on the CPU: the lanes never mix, and a solo solve runs as a
    batch of one)."""
    _, ts = _sessions(grid_instance, CONFIGS[config])
    ws = _drifted(grid_instance, n_lanes=4, seed=2)
    batch = ts.solve_batch(ws)
    for w, res in zip(ws, batch):
        solo = ts.solve(weights=w)
        np.testing.assert_array_equal(solo.voltages, res.voltages)
        np.testing.assert_array_equal(solo.pcg_iters, res.pcg_iters)
        assert solo.cut_value == res.cut_value


def test_pad_to_returns_only_real_results(grid_instance):
    _, ts = _sessions(grid_instance, SERVER)
    ws = _drifted(grid_instance, seed=4)
    padded = ts.solve_batch(ws, pad_to=4)
    assert len(padded) == B                 # pad results are dropped
    for a, b in zip(padded, ts.solve_batch(ws)):
        np.testing.assert_array_equal(a.voltages, b.voltages)
        assert a.cut_value == b.cut_value
    with pytest.raises(ValueError, match="pad_to"):
        ts.solve_batch(ws, pad_to=2)


def test_empty_batch_builds_nothing(grid_instance):
    _, ts = _sessions(grid_instance, SERVER)
    assert ts.solve_batch([]) == []
    assert ts._steppers == {}               # no program built for nothing


def _two_components():
    """Two disjoint 4-cycles joined by nothing (nodes 0-3 and 4-7)."""
    src = np.array([0, 1, 2, 3, 4, 5, 6, 7], dtype=np.int32)
    dst = np.array([1, 2, 3, 0, 5, 6, 7, 4], dtype=np.int32)
    w = np.array([1.0, 2.0, 1.5, 1.0, 0.5, 1.0, 2.0, 1.5])
    g = EdgeList(src=src, dst=dst, weight=w, n=8)
    both = STInstance(graph=g, s_weight=np.array([1.0, 0, 0, 0, 2.0, 0, 0, 0]),
                      t_weight=np.array([0, 0, 1.0, 0, 0, 0, 1.5, 0]))
    return both


def test_trivially_disconnected_lane_drops_out():
    """A lane whose terminals lie in different components gets the 0-cut
    without a solve; the other lanes solve as a batch, as in the JAX
    package."""
    from repro.graphs.structures import EdgeList as JEdgeList, STInstance as JST

    inst = _two_components()
    live = Weights(inst.graph.weight, inst.s_weight, inst.t_weight)
    split = Weights(inst.graph.weight, np.array([1.0, 0, 0, 0, 0, 0, 0, 0]),
                    np.array([0, 0, 0, 0, 0, 0, 1.5, 0]))
    jinst = JST(graph=JEdgeList(src=inst.graph.src, dst=inst.graph.dst,
                                weight=inst.graph.weight, n=8),
                s_weight=inst.s_weight, t_weight=inst.t_weight)
    kw = dict(SERVER, n_irls=6)
    got = MinCutSession(Problem.build(inst, 1), IRLSConfig(**kw),
                        backend="scanned", device="cpu").solve_batch(
        [live, split, live])
    want = JSession(JProblem.build(jinst, 1), JConfig(**kw),
                    backend="scanned").solve_batch(
        [tuple(live), tuple(split), tuple(live)])
    assert len(got) == len(want) == 3
    assert got[1].cut_value == want[1].cut_value == 0.0
    assert got[1].cut.meta["method"] == "trivial_disconnected"
    assert got[1].telemetry["trivial"] == "disconnected"
    np.testing.assert_array_equal(got[1].cut.in_source, want[1].cut.in_source)
    for i in (0, 2):
        assert got[i].cut_value == pytest.approx(want[i].cut_value, rel=1e-6)
        np.testing.assert_array_equal(got[i].pcg_iters, want[i].pcg_iters)


@pytest.mark.parametrize("fixture", ["grid_instance", "road_instance"])
def test_topology_fingerprint_matches_reference(request, fixture):
    inst = request.getfixturevalue(fixture)
    pinst = _port(inst)
    fp = topology_fingerprint(pinst)
    assert fp == jfingerprint(inst)
    assert Problem.build(pinst, 1).fingerprint == fp
    # weights do not enter the hash
    rescaled = Problem.build(pinst, 1).instance_with(_drifted(inst)[0])
    assert topology_fingerprint(rescaled) == fp


def test_rebind_terminals_matches_reference(road_instance):
    pinst = _port(road_instance)
    for u, v in ((0, 5), (17, 3)):
        got = rebind_terminals(pinst, u, v)
        want = jrebind(road_instance, u, v)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    got = Problem.build(pinst, 1).rebind_terminals(2, 9, strength=4.0)
    assert got.c_s[2] == got.c_t[9] == 4.0
    assert np.count_nonzero(got.c_s) == np.count_nonzero(got.c_t) == 1
    with pytest.raises(ValueError, match="distinct"):
        rebind_terminals(pinst, 3, 3)


def test_edge_reweight_once_per_irls_iteration(grid_instance, monkeypatch):
    """Under use_pallas the COO system build goes through the edge-reweight
    wrapper once per IRLS iteration of a batch, cold or warm; the cold
    initial solve uses W⁰ = C and no reweight.  (On the CPU the wrapper runs
    the plain version and counts no launch; the same count on the card is
    chip_smoke.py's.)"""
    calls = []
    real = ops.edge_reweight_r

    def spy(src, dst, c, v, eps):
        calls.append(tuple(c.shape))
        return real(src, dst, c, v, eps)

    _, ts = _sessions(grid_instance, SERVER)
    ws = _drifted(grid_instance)
    monkeypatch.setattr(ops, "edge_reweight_r", spy)
    first = ts.solve_batch(ws, rounding=None)
    assert len(calls) == SERVER["n_irls"]
    ts.solve_batch(ws, rounding=None, warm_from=[first[0]] * B)
    assert len(calls) == 2 * SERVER["n_irls"]
    assert set(calls) == {(B, grid_instance.graph.m)}    # one call per batch


def test_later_slices_raise(grid_instance):
    """Delta staging of the fused-ELL weight table, presolve and the
    external stage are ported and no longer raise: keyed batches equal the
    keyless ones bit for bit on the fused-ELL path and off it, presolve
    batches are certified, and the external stage needs an ELL plan."""
    _, ts = _sessions(grid_instance, SERVER)
    ws = _drifted(grid_instance)
    fused = IRLSConfig(**dict(KERNEL, n_blocks=1, precond="jacobi"))
    keyed = ts.solve_batch(ws, cfg=fused, rounding=None,
                           delta_keys=["a"] * B)
    for a, b in zip(keyed, ts.solve_batch(ws, cfg=fused, rounding=None)):
        np.testing.assert_array_equal(a.voltages, b.voltages)
    # every lane drifts every edge: denser than DELTA_MAX_FRAC, so the
    # lanes after the first restage in full
    assert [r.telemetry["delta"]["mode"] for r in keyed] == \
        ["cold"] + ["full"] * (B - 1)
    for r in ts.solve_batch(ws, presolve=True):
        assert r.cut.meta["presolve"]["certificate"]["rel_gap"] == \
            pytest.approx(0.0, abs=1e-9)
    g = ts.problem.device_graph(device="cpu")
    with pytest.raises(ValueError, match="ext_stage"):
        make_scanned_program(g.src, g.dst, IRLSConfig(**KERNEL),
                             ext_stage=True, coo=g.coo)
    keyed = ts.solve_batch(ws, rounding=None, delta_keys=["a"] * B)
    plain = ts.solve_batch(ws, rounding=None)
    for a, b in zip(keyed, plain):
        np.testing.assert_array_equal(a.voltages, b.voltages)
    with pytest.raises(ValueError, match="delta_keys"):
        ts.solve_batch(ws, delta_keys=["a"])
