"""The port's delta staging of the fused-ELL weight table (``delta_key=``,
``delta_keys=``, ``make_scanned_program(ext_stage=True)``) on the CPU,
held to tests/test_drift.py's contract and against the JAX package.

The contract is "incremental == from scratch": a delta-staged table is
bit-equal to a full restage, and a keyed solve bit-equal to the same solve
without a key.  Against the JAX package the staged tables are equal bit
for bit (both round the same float64 weights to float32 once), the mode
sequences (cold/delta/full) equal, and a delta-staged solve's voltages and
cuts agree at the ELL summation-order bars of ROADMAP queue 3: voltages at
atol 2e-3 (recorded gaps up to ~7e-4) and cuts at rel 1e-4 (recorded ~7e-5),
on a grid at ε = 1e-3 as tests/test_torch_scanned.py holds the grid (at
1e-6 its float32 PCG stalls within rounding of the tight tolerance and the
plateau voltages move by ~3e-2 in either package).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.laplacian as jlap  # noqa: E402
from repro.core import (IRLSConfig as JConfig, MinCutSession as JSession,  # noqa: E402
                        Problem as JProblem)
from repro.graphs import generators as jgen  # noqa: E402

from repro_torch.core import IRLSConfig, MinCutSession, Problem  # noqa: E402
from repro_torch.core import laplacian as lap  # noqa: E402
from repro_torch.core.irls import make_scanned_program  # noqa: E402
from repro_torch.core.session import DELTA_MAX_FRAC, as_weights  # noqa: E402
from repro_torch.graphs.structures import instance_from_arrays  # noqa: E402
from repro_torch.serve import MinCutServer  # noqa: E402

ELL = dict(n_irls=4, pcg_max_iters=15, precond="jacobi", n_blocks=1,
           layout="ell", fuse_edge_sweep=True)


def _grid(side, seed=0):
    """A JAX-package segmentation grid and its port copy."""
    g = jgen.grid_2d(side, side, seed=seed)
    j = jgen.segmentation_instance(g, (side, side), seed=seed + 1)
    return j, instance_from_arrays(j.graph.src, j.graph.dst, j.graph.weight,
                                   j.n, j.s_weight, j.t_weight)


def _drift(rng, c, k, sigma=0.3):
    c2 = c.copy()
    idx = rng.choice(c2.size, size=k, replace=False)
    c2[idx] *= np.exp(rng.normal(0.0, sigma, size=k))
    return c2


# ---------------------------------------------------------------------------
# the delta map and the staged table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("side,seed", [(8, 0), (11, 1), (5, 2)])
def test_ell_delta_staging_bit_equal_random_sparse_diffs(side, seed):
    """Chained ell_edge_weights_delta over 10 random sparse diffs: bit-equal
    to a full restage at every step, and to the JAX package's staged
    table."""
    jinst, inst = _grid(side, seed)
    prob = Problem.build(inst, n_blocks=1)
    plan = prob.ell_plan("cpu")
    dmap = prob.ell_delta_map("cpu")
    jprob = JProblem.build(jinst, n_blocks=1)
    jplan, jdmap = jprob.ell_plan(), jprob.ell_delta_map()
    rng = np.random.default_rng(seed)
    c = np.asarray(inst.graph.weight, dtype=np.float64).copy()
    staged = lap.ell_edge_weights(plan, torch.as_tensor(c).float())
    jstaged = jlap.ell_edge_weights(jplan, np.asarray(c, dtype=np.float32))
    for step in range(10):
        c_new = _drift(rng, c, k=int(rng.integers(1, 12)))
        changed = np.flatnonzero(c != c_new)
        prev = staged.clone()
        staged = lap.ell_edge_weights_delta(dmap, staged, c_new, changed)
        full = lap.ell_edge_weights(plan, torch.as_tensor(c_new).float())
        assert torch.equal(staged, full), step
        jstaged = jlap.ell_edge_weights_delta(jdmap, jstaged, c_new, changed)
        np.testing.assert_array_equal(staged.numpy(), np.asarray(jstaged))
        # the previous table is left as it was
        assert torch.equal(prev, lap.ell_edge_weights(
            plan, torch.as_tensor(c).float()))
        c = c_new


def test_ell_delta_map_matches_reference(road_instance):
    inst = instance_from_arrays(road_instance.graph.src,
                                road_instance.graph.dst,
                                road_instance.graph.weight, road_instance.n,
                                road_instance.s_weight,
                                road_instance.t_weight)
    dmap = Problem.build(inst, n_blocks=1).ell_delta_map("cpu")
    jdmap = JProblem.build(road_instance, n_blocks=1).ell_delta_map()
    assert dmap.rows.dtype == torch.int64 and dmap.rows.shape == (inst.graph.m, 2)
    np.testing.assert_array_equal(dmap.rows.numpy(), np.asarray(jdmap.rows))
    np.testing.assert_array_equal(dmap.lanes.numpy(), np.asarray(jdmap.lanes))


def test_ell_delta_empty_diff_returns_the_table():
    _, inst = _grid(5)
    prob = Problem.build(inst, n_blocks=1)
    c = np.asarray(inst.graph.weight, dtype=np.float64)
    staged = lap.ell_edge_weights(prob.ell_plan("cpu"),
                                  torch.as_tensor(c).float())
    got = lap.ell_edge_weights_delta(prob.ell_delta_map("cpu"), staged, c,
                                     np.zeros(0, dtype=np.int64))
    assert got is staged


# ---------------------------------------------------------------------------
# ext_stage: the scanned program with a table staged by the caller
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("warm", [False, True])
def test_ext_stage_program_equals_internal_stage(warm):
    """run(c, c_s, c_t, c_ell[, v0]) with c_ell (B, n, k) staged outside
    gives the bits of run(c, c_s, c_t[, v0])."""
    _, inst = _grid(7, 3)
    cfg = IRLSConfig(**ELL)
    prob = Problem.build(inst, n_blocks=1)
    g = prob.device_graph(device="cpu")
    plan = prob.ell_plan("cpu")
    ext = make_scanned_program(g.src, g.dst, cfg, ell_plan=plan, warm=warm,
                               ext_stage=True, coo=g.coo)
    own = make_scanned_program(g.src, g.dst, cfg, ell_plan=plan, warm=warm,
                               coo=g.coo)
    scale = torch.tensor([[1.0], [1.3], [0.7]])
    C, CS, CT = g.c * scale, g.c_s * scale, g.c_t * scale
    tail = [torch.full_like(CS, 0.5)] if warm else []
    got = ext(C, CS, CT, lap.ell_edge_weights(plan, C), *tail)
    want = own(C, CS, CT, *tail)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_ext_stage_needs_the_fused_ell_path():
    _, inst = _grid(5)
    prob = Problem.build(inst, n_blocks=1)
    g = prob.device_graph(device="cpu")
    for kw in ({"layout": "coo"}, {"fuse_edge_sweep": False}):
        cfg = IRLSConfig(**dict(ELL, **kw))
        with pytest.raises(ValueError, match="ext_stage"):
            make_scanned_program(g.src, g.dst, cfg,
                                 ell_plan=prob.ell_plan("cpu"), ext_stage=True,
                                 coo=g.coo)
    with pytest.raises(ValueError, match="ext_stage"):
        make_scanned_program(g.src, g.dst, IRLSConfig(**ELL), ext_stage=True,
                             coo=g.coo)


# ---------------------------------------------------------------------------
# keyed solves: bit-equal to the keyless path, modes as in the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["host", "scanned"])
def test_session_delta_key_solves_bit_equal(backend):
    """solve(delta_key=...) returns the voltages and cut of the same solve
    without a key, bit for bit, across a drift sequence, with the JAX
    package's mode sequence."""
    jinst, inst = _grid(6, 1)
    sess = MinCutSession(Problem.build(inst, n_blocks=1), IRLSConfig(**ELL),
                         backend=backend, device="cpu")
    jsess = JSession(JProblem.build(jinst, n_blocks=1), JConfig(**ELL),
                     backend=backend)
    w0 = as_weights(inst)
    rng = np.random.default_rng(1)
    c = np.asarray(inst.graph.weight, dtype=np.float64).copy()
    modes, jmodes = [], []
    for step in range(4):
        c = _drift(rng, c, k=3)
        w = (c.copy(), w0.c_s, w0.c_t)
        rf = sess.solve(weights=w, rounding="sweep")
        rd = sess.solve(weights=w, rounding="sweep", delta_key="tenant")
        assert np.array_equal(rf.voltages, rd.voltages), step
        assert rf.cut.cut_value == rd.cut.cut_value, step
        modes.append(rd.telemetry["delta"]["mode"])
        jmodes.append(jsess.solve(weights=w, rounding="sweep",
                                  delta_key="tenant").telemetry["delta"]["mode"])
        assert rd.telemetry["delta"]["changed_edges"] == (None if step == 0
                                                          else 3)
    assert modes == jmodes == ["cold", "delta", "delta", "delta"]


@pytest.mark.parametrize("backend", ["host", "scanned"])
def test_delta_key_off_the_fused_path_records_weights_only(backend):
    """Off the fused-ELL path a key stages no table but records the weights
    and reports the mode, as in the JAX package."""
    _, inst = _grid(6, 2)
    cfg = IRLSConfig(**dict(ELL, layout="coo"))
    sess = MinCutSession(Problem.build(inst, n_blocks=1), cfg,
                         backend=backend, device="cpu")
    rng = np.random.default_rng(2)
    c = np.asarray(inst.graph.weight, dtype=np.float64)
    modes = []
    for _ in range(3):
        c = _drift(rng, c, k=2)
        w = (c, inst.s_weight, inst.t_weight)
        rd = sess.solve(weights=w, rounding="sweep", delta_key="k")
        rf = sess.solve(weights=w, rounding="sweep")
        assert np.array_equal(rd.voltages, rf.voltages)
        modes.append(rd.telemetry["delta"]["mode"])
    assert modes == ["cold", "delta", "delta"]
    assert sess._delta["k"]["c_ell"] is None


def test_solve_batch_delta_keys_bit_equal():
    """solve_batch(ws, delta_keys=...) gives the voltages, cuts and PCG
    counts of solve_batch(ws), with keyed and unkeyed lanes, padding and a
    warm start, and the JAX package's modes."""
    jinst, inst = _grid(6, 4)
    cfg = IRLSConfig(**ELL)
    sess = MinCutSession(Problem.build(inst, n_blocks=1), cfg,
                         backend="scanned", device="cpu")
    jsess = JSession(JProblem.build(jinst, n_blocks=1), JConfig(**ELL),
                     backend="scanned")
    rng = np.random.default_rng(4)
    c = np.asarray(inst.graph.weight, dtype=np.float64)
    prev = None
    for rnd in range(3):
        ws = []
        for _ in range(3):
            c = _drift(rng, c, k=4)
            ws.append((c, inst.s_weight, inst.t_weight))
        keys = ["t", None, "t"] if rnd == 1 else ["t"] * 3
        warm = None if prev is None else [prev[-1].voltages] * 3
        got = sess.solve_batch(ws, rounding="sweep", delta_keys=keys,
                               pad_to=4, warm_from=warm)
        want = sess.solve_batch(ws, rounding="sweep", pad_to=4,
                                warm_from=warm)
        jgot = jsess.solve_batch(ws, rounding="sweep", delta_keys=keys,
                                 pad_to=4, warm_from=warm)
        for a, b, j in zip(got, want, jgot):
            assert np.array_equal(a.voltages, b.voltages)
            assert a.cut_value == b.cut_value
            assert np.array_equal(a.pcg_iters, b.pcg_iters)
            assert ("delta" in a.telemetry) == ("delta" in j.telemetry)
            if "delta" in a.telemetry:
                assert a.telemetry["delta"] == j.telemetry["delta"]
        prev = got
    assert [r.telemetry["delta"]["mode"] for r in got] == ["delta"] * 3


def test_full_mode_above_delta_max_frac():
    """A diff denser than DELTA_MAX_FRAC restages in full (mode "full"),
    still bit-equal; the next sparse diff goes back to delta; a dtype change
    restages in full too."""
    jinst, inst = _grid(6, 5)
    sess = MinCutSession(Problem.build(inst, n_blocks=1), IRLSConfig(**ELL),
                         device="cpu")
    jsess = JSession(JProblem.build(jinst, n_blocks=1), JConfig(**ELL))
    m = inst.graph.m
    rng = np.random.default_rng(5)
    c = np.asarray(inst.graph.weight, dtype=np.float64)
    k_at = int(DELTA_MAX_FRAC * m)
    steps = [("cold", 0), ("delta", k_at), ("full", k_at + 1), ("delta", 2),
             ("full", m)]
    for want_mode, k in steps:
        if k:
            c = _drift(rng, c, k=k)
        w = (c, inst.s_weight, inst.t_weight)
        rd = sess.solve(weights=w, rounding="sweep", delta_key="d")
        rf = sess.solve(weights=w, rounding="sweep")
        jd = jsess.solve(weights=w, rounding="sweep", delta_key="d")
        assert rd.telemetry["delta"]["mode"] == want_mode, (want_mode, k)
        assert rd.telemetry["delta"] == jd.telemetry["delta"]
        assert np.array_equal(rd.voltages, rf.voltages)
    f64 = IRLSConfig(**dict(ELL, dtype="float64"))
    rd = sess.solve(weights=w, rounding="sweep", delta_key="d", cfg=f64)
    assert rd.telemetry["delta"]["mode"] == "full"
    assert sess._delta["d"]["c_ell"].dtype == torch.float64


def test_delta_lru_keeps_64_keys():
    _, inst = _grid(5, 6)
    sess = MinCutSession(Problem.build(inst, n_blocks=1), IRLSConfig(**ELL),
                         device="cpu")
    w = as_weights(inst)
    for i in range(66):
        sess._stage_with_delta(w, sess.cfg, "host", f"k{i}")
    assert len(sess._delta) == 64 and "k0" not in sess._delta
    assert "k65" in sess._delta


@pytest.mark.parametrize("backend", ["host", "scanned"])
def test_delta_staged_solve_against_reference(backend):
    """A delta-staged drift sequence against the JAX package's: voltages at
    atol 2e-3, cuts at rel 1e-4 (the ELL summation-order bars of ROADMAP
    queue 3), at ε = 1e-3."""
    jinst, inst = _grid(8, 7)
    cfg = dict(ELL, n_irls=12, pcg_max_iters=30, eps=1e-3)
    sess = MinCutSession(Problem.build(inst, n_blocks=1), IRLSConfig(**cfg),
                         backend=backend, device="cpu")
    jsess = JSession(JProblem.build(jinst, n_blocks=1), JConfig(**cfg),
                     backend=backend)
    rng = np.random.default_rng(7)
    c = np.asarray(inst.graph.weight, dtype=np.float64)
    for step in range(3):
        c = _drift(rng, c, k=5)
        w = (c, inst.s_weight, inst.t_weight)
        got = sess.solve(weights=w, rounding="sweep", delta_key="t")
        want = jsess.solve(weights=w, rounding="sweep", delta_key="t")
        np.testing.assert_allclose(got.voltages, np.asarray(want.voltages),
                                   atol=2e-3)
        assert got.cut_value == pytest.approx(want.cut_value, rel=1e-4)


# ---------------------------------------------------------------------------
# the server's tenant path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["scanned", "host"])
def test_server_tenant_requests_use_delta_staging(backend):
    """tests/test_drift.py's server case on the port: tenant requests on a
    fused-ELL config restage sparsely and match the same request without a
    tenant bit for bit (warm_capacity=0 keeps the warm start out, so only
    the staging differs)."""
    _, inst = _grid(6, 9)
    rng = np.random.default_rng(9)
    c = np.asarray(inst.graph.weight, dtype=np.float64).copy()
    with MinCutServer(cfg=IRLSConfig(**ELL), max_batch=1, n_workers=1,
                      warm_capacity=0, backend=backend,
                      device="cpu") as server:
        key = server.register(inst)
        for step in range(3):
            c = _drift(rng, c, k=3)
            w = (c.copy(), np.asarray(inst.s_weight),
                 np.asarray(inst.t_weight))
            rt = server.submit(key, w, tenant="t0").result(timeout=120)
            rp = server.submit(key, w).result(timeout=120)
            assert np.array_equal(rt.voltages, rp.voltages), step
            assert rt.cut_value == rp.cut_value
        tel = rt.telemetry
        warm = server.stats()["warm"]
    assert tel["delta"]["mode"] == "delta"
    assert warm["entries"] == 0 and warm["hits"] == 0
