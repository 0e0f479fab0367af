"""The port's whole solve (``pirmcut`` → session → IRLS → rounding) against
the JAX package on the CPU, on the grid and road fixtures with the
reference's partition labels.

Two configs: the kernel config of the port's main path (fused ELL sweep,
ELL SpMV and explicit-inverse block Jacobi, routed through the kernel
wrappers — their plain versions here) and the default COO config.

Tolerances: PCG iteration counts and the rounded cut (rel 1e-6, the bar
tests/test_kernels.py sets for Pallas vs jnp) must agree exactly.  The
fractional cut ‖CBx‖₁ agrees to rel 2e-4 and voltages to 2e-3: ε = 1e-6
makes the reweighted conductances span six decades, so float32 sums taken
in another order (row-wise ELL vs XLA's scatters) move the PCG iterates by
more than float32 rounding.  Measured on these fixtures: 7e-5 and 7e-4."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import (IRLSConfig as JConfig, MinCutSession as JSession,  # noqa: E402
                        Problem as JProblem, pirmcut as jpirmcut)
from repro.graphs import partition as jgp  # noqa: E402

from repro_torch.core import (IRLSConfig, MinCutSession, Problem,  # noqa: E402
                              pirmcut)
from repro_torch.graphs.structures import (EdgeList, STInstance,  # noqa: E402
                                           instance_from_arrays)

KERNEL = dict(layout="ell", fuse_edge_sweep=True, use_pallas=True,
              precond="block_jacobi", explicit_block_inverse=True)
CONFIGS = {"kernel": dict(KERNEL, n_irls=12, n_blocks=4),
           "default": dict(n_irls=12, n_blocks=4)}
CASES = [(f, c) for f in ("grid_instance", "road_instance") for c in CONFIGS]


def _port(inst):
    return instance_from_arrays(inst.graph.src, inst.graph.dst,
                                inst.graph.weight, inst.graph.n,
                                inst.s_weight, inst.t_weight)


@pytest.fixture(scope="module")
def runs():
    """(fixture, config) → (reference (cut, v, diag), port (cut, v, diag)),
    each solved once per module."""
    cache = {}

    def get(request, fixture, config):
        key = (fixture, config)
        if key not in cache:
            inst = request.getfixturevalue(fixture)
            labels = jgp.partition_kway(inst.graph, 4)
            kw = CONFIGS[config]
            cache[key] = (jpirmcut(inst, JConfig(**kw), labels=labels),
                          pirmcut(_port(inst), IRLSConfig(**kw), labels=labels,
                                  device="cpu"))
        return cache[key]
    return get


@pytest.mark.parametrize("fixture,config", CASES)
def test_pcg_iterations_match(runs, request, fixture, config):
    (_, _, jd), (_, _, td) = runs(request, fixture, config)
    assert td.pcg_iters == jd.pcg_iters
    assert len(td.l1_objective) == CONFIGS[config]["n_irls"] + 1


@pytest.mark.parametrize("fixture,config", CASES)
def test_fractional_cut_matches(runs, request, fixture, config):
    (_, _, jd), (_, _, td) = runs(request, fixture, config)
    np.testing.assert_allclose(td.l1_objective, jd.l1_objective, rtol=2e-4)
    np.testing.assert_allclose(td.objective, jd.objective, rtol=2e-4)


@pytest.mark.parametrize("fixture,config", CASES)
def test_voltages_match(runs, request, fixture, config):
    (_, jv, _), (_, tv, _) = runs(request, fixture, config)
    assert tv.shape == jv.shape and tv.dtype == np.float32
    assert np.isfinite(tv).all()
    np.testing.assert_allclose(tv, jv, rtol=0, atol=2e-3)


@pytest.mark.parametrize("fixture,config", CASES)
def test_cut_matches(runs, request, fixture, config):
    (jc, _, _), (tc, _, _) = runs(request, fixture, config)
    assert tc.cut_value == pytest.approx(jc.cut_value, rel=1e-6)
    assert tc.meta["method"] == jc.meta["method"] == "two_level"


def test_adaptive_schedule_matches(grid_instance):
    """The early-exit state machine stops both packages at the same
    iteration, with the same per-iteration PCG spend.  On the COO layout,
    where the two packages' fractional cuts agree to ~3e-7 relative on this
    fixture; on the ELL layout they differ by ~3e-5, enough to fall either
    side of the state machine's thresholds."""
    labels = jgp.partition_kway(grid_instance.graph, 4)
    kw = dict(n_irls=12, n_blocks=4, irls_tol=1e-4, adaptive_tol=True)
    _, jv, jd = jpirmcut(grid_instance, JConfig(**kw), labels=labels,
                         rounding="sweep")
    tc, tv, td = pirmcut(_port(grid_instance), IRLSConfig(**kw), labels=labels,
                         rounding="sweep", device="cpu")
    assert td.pcg_iters == jd.pcg_iters
    assert len(td.pcg_iters) < 13          # it did exit early
    np.testing.assert_allclose(td.l1_objective, jd.l1_objective, rtol=2e-4)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=2e-3)


def test_session_weights_and_warm_start(road_instance):
    """A second solve on the same topology under new weights, warm-started
    from the first: same PCG spend as the JAX session, same cut."""
    labels = jgp.partition_kway(road_instance.graph, 4)
    kw = dict(KERNEL, n_irls=6, n_blocks=4)
    rng = np.random.default_rng(8)
    c2 = np.asarray(road_instance.graph.weight) * rng.uniform(
        0.8, 1.2, road_instance.graph.m)
    w2 = (c2, road_instance.s_weight, road_instance.t_weight)

    js = JSession(JProblem.build(road_instance, 4, labels=labels), JConfig(**kw))
    ts = MinCutSession(Problem.build(_port(road_instance), 4, labels=labels),
                       IRLSConfig(**kw), device="cpu")
    j1, t1 = js.solve(), ts.solve()
    j2 = js.solve(weights=w2, warm_from=j1)
    t2 = ts.solve(weights=w2, warm_from=t1)
    assert t2.diagnostics.pcg_iters == j2.diagnostics.pcg_iters
    assert len(t2.diagnostics.pcg_iters) == 6     # no cold initial WLS
    assert t2.cut_value == pytest.approx(j2.cut_value, rel=1e-6)
    assert t2.timings["setup"] <= t1.timings["setup"] + 1.0
    assert set(t2.timings) >= {"setup", "irls", "rounding", "total"}


def test_session_later_slices_raise(grid_instance):
    """Only the sharded backend is a later slice: presolve and delta staging
    of the fused-ELL weight table are ported, and a keyed solve is the
    keyless one bit for bit."""
    s = MinCutSession(Problem.build(_port(grid_instance), 1),
                      IRLSConfig(precond="jacobi", n_irls=1), device="cpu")
    fused_ell = IRLSConfig(precond="jacobi", n_irls=1, layout="ell")
    with pytest.raises(NotImplementedError, match="ROADMAP.*distributed/"):
        s.solve(backend="sharded")
    pre = s.solve(presolve=True)
    assert pre.cut.meta["presolve"]["certificate"]["rel_gap"] == \
        pytest.approx(0.0, abs=1e-9)
    keyed = s.solve(delta_key="tenant", cfg=fused_ell)
    assert keyed.telemetry["delta"]["mode"] == "cold"
    np.testing.assert_array_equal(keyed.voltages,
                                  s.solve(cfg=fused_ell).voltages)
    with pytest.raises(ValueError, match="unknown backend"):
        s.solve(backend="tpu")


def test_disconnected_terminals_give_trivial_cut():
    """s and t in different components: the cut is 0 without a solve, as in
    the JAX session."""
    g = EdgeList(src=np.array([0, 2], dtype=np.int32),
                 dst=np.array([1, 3], dtype=np.int32), weight=np.ones(2), n=4)
    inst = STInstance(graph=g, s_weight=np.array([1.0, 0, 0, 0]),
                      t_weight=np.array([0, 0, 0, 1.0]))
    res = MinCutSession(Problem.build(inst, 1), IRLSConfig(precond="jacobi"),
                        device="cpu").solve()
    assert res.cut_value == 0.0
    np.testing.assert_array_equal(res.cut.in_source, [True, True, False, False])
