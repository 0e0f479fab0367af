"""The port's host-side plans, generators, operators, PCG and rounding against
the JAX package, on the CPU.  Inputs come from numpy seeds; each tolerance
states its reason."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import laplacian as jlap, precond as jpc  # noqa: E402
from repro.core import rounding as jrd, maxflow as jmf  # noqa: E402
from repro.core.pcg import pcg as jpcg  # noqa: E402
from repro.graphs import generators as jgen, partition as jgp  # noqa: E402
from repro.graphs.structures import permute_instance as jpermute  # noqa: E402

from repro_torch.core import laplacian as lap, precond as pc  # noqa: E402
from repro_torch.core import rounding as rd, maxflow as mf  # noqa: E402
from repro_torch.core.incidence import device_graph_from_instance  # noqa: E402
from repro_torch.core.pcg import pcg, pcg_fixed_iters, pcg_masked  # noqa: E402
from repro_torch.graphs import generators as gen, partition as gp  # noqa: E402
from repro_torch.graphs.structures import (EdgeList, STInstance,  # noqa: E402
                                           instance_from_arrays)
from conftest import tiny_instance  # noqa: E402


def _port(inst):
    return instance_from_arrays(inst.graph.src, inst.graph.dst,
                                inst.graph.weight, inst.graph.n,
                                inst.s_weight, inst.t_weight)


def _same_instance(a, b):
    """Bit-for-bit equality of two instances (arrays, dtypes, n)."""
    assert a.graph.n == b.graph.n
    for x, y in ((a.graph.src, b.graph.src), (a.graph.dst, b.graph.dst),
                 (a.graph.weight, b.graph.weight), (a.s_weight, b.s_weight),
                 (a.t_weight, b.t_weight)):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def _same_edges(a, b):
    _same_instance(STInstance(a, np.zeros(0), np.zeros(0)),
                   STInstance(b, np.zeros(0), np.zeros(0)))


# ---------------------------------------------------------------------------
# generators, partition, instance_from_arrays: bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,args", [
    ("grid_2d", (12, 9)), ("grid_3d", (5, 4, 6)), ("grid_3d_26", (4, 5, 3)),
    ("road_like", (14,)), ("random_regular", (40, 3))])
@pytest.mark.parametrize("seed", [0, 7])
def test_generators_bit_equal(name, args, seed):
    """The connectivity shortcut skips the per-edge union-find only on
    connected graphs; road_like is disconnected and runs the loop."""
    if name == "grid_3d_26":
        a = jgen.grid_3d(*args, conn=26, seed=seed)
        b = gen.grid_3d(*args, conn=26, seed=seed)
    else:
        a = getattr(jgen, name)(*args, seed=seed)
        b = getattr(gen, name)(*args, seed=seed)
    _same_edges(a, b)


def test_instances_bit_equal(grid_instance, road_instance):
    g = gen.grid_2d(16, 16, seed=3)
    _same_instance(grid_instance, gen.segmentation_instance(g, (16, 16), seed=4))
    r = gen.road_like(18, seed=5)
    _same_instance(road_instance, gen.flow_improve_instance(r, seed=6))
    for inst in (grid_instance, road_instance):
        _same_instance(inst, _port(inst))


def test_partition_bit_equal(road_instance):
    g = _port(road_instance).graph
    np.testing.assert_array_equal(jgp.partition_kway(road_instance.graph, 4),
                                  gp.partition_kway(g, 4))
    labels = jgp.partition_kway(road_instance.graph, 4)
    np.testing.assert_array_equal(jgp.partition_order(labels),
                                  gp.partition_order(labels))


# ---------------------------------------------------------------------------
# plans: bit for bit
# ---------------------------------------------------------------------------

def _reordered(inst, p=4):
    labels = jgp.partition_kway(inst.graph, p)
    perm = jgp.partition_order(labels)
    return jpermute(inst, perm), np.sort(labels)


@pytest.mark.parametrize("fixture", ["grid_instance", "road_instance"])
def test_ell_plan_bit_equal(fixture, request):
    inst, _ = _reordered(request.getfixturevalue(fixture))
    g = inst.graph
    want = jlap.build_ell_plan(g.src, g.dst, g.n)
    got = lap.build_ell_plan(g.src, g.dst, g.n, device="cpu")
    for field in lap.EllPlan._fields:
        w = np.asarray(getattr(want, field))
        t = getattr(got, field).numpy()
        np.testing.assert_array_equal(t, w)
        assert t.shape == w.shape
    assert got.cols.dtype == torch.int32


@pytest.mark.parametrize("fixture", ["grid_instance", "road_instance"])
def test_block_plan_bit_equal(fixture, request):
    inst, labels = _reordered(request.getfixturevalue(fixture))
    g = inst.graph
    want = jpc.build_block_plan(g.src, g.dst, labels, 4)
    got = pc.build_block_plan(g.src, g.dst, labels, 4, device="cpu")
    assert (got.p, got.bs) == (want.p, want.bs)
    for field in pc.BlockPlan._fields[:-2]:
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)))


# ---------------------------------------------------------------------------
# operators: COO vs ELL vs dense, and against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fixture", ["grid_instance", "road_instance"])
def test_matvec_coo_ell_dense_agree(fixture, request):
    """The three matvec layouts on one reweighted system, and the fused
    sweep against reweight + fill.  rtol 1e-5 / atol 1e-4·max|y|: float32
    sums in three orders, with conductances up to c²/ε (ε = 1e-3 here)."""
    inst, _ = _reordered(request.getfixturevalue(fixture))
    g = device_graph_from_instance(inst, device="cpu")
    plan = lap.build_ell_plan(inst.graph.src, inst.graph.dst, inst.n,
                              device="cpu")
    rng = np.random.default_rng(3)
    v = torch.as_tensor(rng.uniform(0, 1, inst.n).astype(np.float32))
    x = torch.as_tensor(rng.standard_normal(inst.n).astype(np.float32))
    rw = lap.reweight(g, v, 1e-3)
    y_coo = lap.matvec_coo(g, rw, x)
    vals, diag = lap.fill_ell(plan, rw)
    y_ell = lap.matvec_ell(plan.cols, vals, diag, x)
    y_dense = lap.dense_reduced_laplacian(g, rw) @ x
    scale = float(y_dense.abs().max())
    for y in (y_coo, y_ell):
        np.testing.assert_allclose(y.numpy(), y_dense.numpy(), rtol=1e-5,
                                   atol=1e-4 * scale)
    # the fused sweep builds the same system in one pass
    c_ell = lap.ell_edge_weights(plan, g.c)
    f_vals, f_diag, r_s, r_t = lap.fused_ell_sweep(plan.cols, c_ell, g.c_s,
                                                   g.c_t, v, 1e-3)
    np.testing.assert_allclose(f_vals.numpy(), vals.numpy(), rtol=1e-5)
    np.testing.assert_allclose(f_diag.numpy(), diag.numpy(), rtol=1e-5)
    np.testing.assert_allclose(lap.edge_r_from_vals(plan, f_vals).numpy(),
                               rw.r.numpy(), rtol=1e-5)
    # and the JAX package's COO matvec on the same system
    from repro.core.incidence import device_graph_from_instance as jdg
    jg = jdg(inst)
    jrw = jlap.reweight(jg, jnp.asarray(v.numpy()), 1e-3)
    np.testing.assert_allclose(
        y_coo.numpy(), np.asarray(jlap.matvec_coo(jg, jrw, jnp.asarray(x.numpy()))),
        rtol=1e-5, atol=1e-4 * scale)


@pytest.mark.parametrize("fixture", ["grid_instance", "road_instance"])
@pytest.mark.parametrize("lanes", [None, 3])
def test_coo_segment_plan_reproduces_scatters(fixture, lanes, request):
    """The COO matvec and the degrees sum each node's edges in a fixed
    order (``incidence.CooPlan``, no atomics).  On the CPU that order is
    ``index_add_``'s, so the bits are those of the scatter form, for one
    instance and for every lane of a batch; and the JAX package's operators
    agree within float32 rounding (rtol 1e-5, atol 1e-4·max|y|, as above)."""
    inst, _ = _reordered(request.getfixturevalue(fixture))
    g = device_graph_from_instance(inst, device="cpu")
    rng = np.random.default_rng(11)
    shape = (inst.n,) if lanes is None else (lanes, inst.n)
    v = torch.as_tensor(rng.uniform(0, 1, shape).astype(np.float32))
    x = torch.as_tensor(rng.standard_normal(shape).astype(np.float32))
    rw = lap.reweight(g, v, 1e-3)
    deg = torch.zeros_like(rw.r[..., :1].expand(rw.r.shape[:-1] + (g.n,))
                           ).contiguous()
    deg.index_add_(-1, g.src, rw.r)
    deg.index_add_(-1, g.dst, rw.r)
    assert torch.equal(rw.diag, deg + rw.r_s + rw.r_t)
    flux = rw.r * (x[..., g.src] - x[..., g.dst])
    y_ref = (torch.zeros_like(x).index_add_(-1, g.src, flux)
             - torch.zeros_like(x).index_add_(-1, g.dst, flux)
             + (rw.r_s + rw.r_t) * x)
    y = lap.matvec_coo(g, rw, x)
    assert torch.equal(y, y_ref)
    from repro.core.incidence import device_graph_from_instance as jdg
    jg = jdg(inst)
    for lane in range(1 if lanes is None else lanes):
        vl, xl = (v, x) if lanes is None else (v[lane], x[lane])
        jrw = jlap.reweight(jg, jnp.asarray(vl.numpy()), 1e-3)
        diag = rw.diag if lanes is None else rw.diag[lane]
        np.testing.assert_allclose(diag.numpy(), np.asarray(jrw.diag),
                                   rtol=1e-5)
        jy = np.asarray(jlap.matvec_coo(jg, jrw, jnp.asarray(xl.numpy())))
        yl = y if lanes is None else y[lane]
        np.testing.assert_allclose(yl.numpy(), jy, rtol=1e-5,
                                   atol=1e-4 * float(np.abs(jy).max()))


# ---------------------------------------------------------------------------
# PCG: the cases of tests/test_pcg.py
# ---------------------------------------------------------------------------

def _spd(n, seed, cond=100.0):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    eigs = np.geomspace(1.0, cond, n)
    return (q * eigs) @ q.T


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float32))


def test_pcg_solves_spd():
    A = _t(_spd(50, 0))
    b = _t(np.random.default_rng(1).standard_normal(50))
    res = pcg(lambda x: A @ x, b, tol=1e-6, max_iters=500)
    x_ref = np.linalg.solve(A.double().numpy(), b.double().numpy())
    np.testing.assert_allclose(res.x.numpy(), x_ref, rtol=2e-3, atol=2e-3)


def test_pcg_matches_jax_iterations():
    """Same SPD system, same stop rule: equal iteration counts, and x equal
    up to float32 rounding amplified by cond(A) = 30: relative 2e-3 in
    norm.  The tolerances stop CG well before it runs n = 60 steps: deeper
    stops in float32 land within an iteration of the threshold, where the
    two frameworks' matmul rounding decides the count."""
    A = _spd(60, 0, cond=30).astype(np.float32)
    b = np.random.default_rng(1).standard_normal(60).astype(np.float32)
    for tol in (1e-1, 1e-2, 1e-3):
        rj = jpcg(lambda x: jnp.asarray(A) @ x, jnp.asarray(b), tol=tol,
                  max_iters=500)
        rt = pcg(lambda x: _t(A) @ x, _t(b), tol=tol, max_iters=500)
        assert rt.iters == int(rj.iters)
        xj = np.asarray(rj.x)
        assert (np.linalg.norm(rt.x.numpy() - xj)
                <= 2e-3 * np.linalg.norm(xj))


def test_pcg_jacobi_accelerates():
    A = _t(_spd(60, 2, cond=10) * np.outer(
        np.linspace(1, 40, 60), np.linspace(1, 40, 60)) ** 0.5
        + np.diag(np.linspace(1, 1600, 60)))
    b = torch.ones(60)
    plain = pcg(lambda x: A @ x, b, tol=1e-6, max_iters=2000)
    precond = pcg(lambda x: A @ x, b, tol=1e-6, max_iters=2000,
                  precond=lambda r: r / torch.diagonal(A))
    assert precond.iters < plain.iters


def test_warm_start_reduces_iterations():
    A = _t(_spd(80, 3))
    x_true = _t(np.random.default_rng(4).standard_normal(80))
    b = A @ x_true
    cold = pcg(lambda x: A @ x, b, tol=1e-6, max_iters=500)
    x0 = x_true + 0.01 * _t(np.random.default_rng(5).standard_normal(80))
    warm = pcg(lambda x: A @ x, b, x0=x0, tol=1e-6, max_iters=500)
    assert warm.iters < cold.iters


def test_block_jacobi_exact_on_block_diagonal():
    """When L̃ IS block diagonal, the preconditioner is an exact inverse →
    PCG converges in O(1) iterations."""
    src = np.array([0, 1, 2, 3, 4, 5], dtype=np.int32)
    dst = np.array([1, 2, 0, 4, 5, 3], dtype=np.int32)
    inst = STInstance(graph=EdgeList(src=src, dst=dst, weight=np.ones(6), n=6),
                      s_weight=np.full(6, 0.7), t_weight=np.full(6, 0.3))
    dg = device_graph_from_instance(inst, device="cpu")
    rw = lap.initial_weights(dg)
    plan = pc.build_block_plan(src, dst, np.array([0, 0, 0, 1, 1, 1]), 2,
                               device="cpu")
    for explicit in (False, True):
        M = pc.factorize_blocks(plan, rw, explicit_inverse=explicit)
        res = pcg(lambda v: lap.matvec_coo(dg, rw, v), lap.rhs(rw),
                  precond=lambda x: pc.apply_block_jacobi(M, x),
                  tol=1e-6, max_iters=50)
        assert res.iters <= 2


def test_block_jacobi_explicit_inverse_matches_solve(road_instance):
    """Explicit inverse vs triangular solves (port), and vs the JAX package's
    triangular-solve apply: rtol 2e-3 / atol 2e-4·max|y| as
    tests/test_pcg.py (inverse formed in float32)."""
    inst, labels = _reordered(road_instance)
    dg = device_graph_from_instance(inst, device="cpu")
    rw = lap.initial_weights(dg)
    plan = pc.build_block_plan(inst.graph.src, inst.graph.dst, labels, 4,
                               device="cpu")
    x = _t(np.random.default_rng(0).standard_normal(dg.n))
    y1 = pc.apply_block_jacobi(pc.factorize_blocks(plan, rw), x)
    y2 = pc.apply_block_jacobi(pc.factorize_blocks(plan, rw, True), x)
    from repro.core.incidence import device_graph_from_instance as jdg
    jplan = jpc.build_block_plan(inst.graph.src, inst.graph.dst, labels, 4)
    jM = jpc.factorize_blocks(jplan, jlap.initial_weights(jdg(inst)))
    yj = np.asarray(jpc.apply_block_jacobi(jM, jnp.asarray(x.numpy())))
    scale = float(np.abs(yj).max())
    for y in (y1, y2):
        np.testing.assert_allclose(y.numpy(), yj, rtol=2e-3, atol=2e-4 * scale)


def test_block_jacobi_nan_on_indefinite_block():
    """A block that is not positive definite yields a NaN factor, as the JAX
    package's Cholesky does, instead of an exception."""
    inst = STInstance(graph=EdgeList(src=np.array([0, 2], dtype=np.int32),
                                     dst=np.array([1, 3], dtype=np.int32),
                                     weight=np.ones(2), n=4),
                      s_weight=np.ones(4), t_weight=np.ones(4))
    dg = device_graph_from_instance(inst, device="cpu")
    rw = lap.initial_weights(dg)
    rw = rw._replace(diag=torch.tensor([-1.0, 3.0, 3.0, 3.0]))
    plan = pc.build_block_plan(inst.graph.src, inst.graph.dst,
                               np.array([0, 0, 1, 1]), 2, device="cpu")
    M = pc.factorize_blocks(plan, rw, explicit_inverse=True)
    assert torch.isnan(M.chol[0]).all() and torch.isnan(M.inv[0]).all()
    assert torch.isfinite(M.chol[1]).all()


def test_chebyshev_preconditioner_accelerates(grid_instance):
    dg = device_graph_from_instance(grid_instance, device="cpu")
    rw = lap.reweight(dg, torch.full((dg.n,), 0.5), 1e-2)
    mv = lambda v: lap.matvec_coo(dg, rw, v)
    b = lap.rhs(rw)
    plain = pcg(mv, b, tol=1e-6, max_iters=3000,
                precond=lambda x: x / rw.diag)
    cheb = pcg(mv, b, tol=1e-6, max_iters=3000,
               precond=pc.make_chebyshev_apply(mv, rw.diag, degree=4))
    assert cheb.iters < plain.iters


def test_pcg_fixed_iters_matches_pcg():
    A = _t(_spd(40, 7))
    b = torch.ones(40)
    r1 = pcg(lambda x: A @ x, b, tol=0.0, max_iters=30)
    r2 = pcg_fixed_iters(lambda x: A @ x, b, n_iters=30)
    np.testing.assert_allclose(r1.x.numpy(), r2.x.numpy(), rtol=1e-4, atol=1e-5)


def test_pcg_fixed_iters_no_history_same_solution():
    A = _t(_spd(40, 11))
    b = torch.ones(40)
    r1 = pcg_fixed_iters(lambda x: A @ x, b, n_iters=25)
    r2 = pcg_fixed_iters(lambda x: A @ x, b, n_iters=25, record_history=False)
    np.testing.assert_array_equal(r1.x.numpy(), r2.x.numpy())  # same math
    assert r1.history.shape == (25,) and r2.history.shape == (1,)


def test_pcg_masked_matches_pcg():
    A = _t(_spd(60, 9))
    b = _t(np.random.default_rng(1).standard_normal(60))
    r1 = pcg(lambda x: A @ x, b, tol=1e-5, max_iters=500)
    r2 = pcg_masked(lambda x: A @ x, b, tol=1e-5, max_iters=500)
    assert r1.iters == r2.iters
    np.testing.assert_array_equal(r1.x.numpy(), r2.x.numpy())  # same updates


def test_pcg_masked_inf_tol_is_noop():
    A = _t(_spd(20, 3))
    b = torch.ones(20)
    x0 = _t(np.random.default_rng(0).standard_normal(20))
    res = pcg_masked(lambda x: A @ x, b, x0=x0, tol=float("inf"), max_iters=50)
    assert res.iters == 0
    np.testing.assert_array_equal(res.x.numpy(), x0.numpy())


def test_pcg_zero_rhs_guard():
    """b = 0 ⇒ x = 0 is exact: no division by ‖b‖ = 0, zero iterations."""
    A = _t(_spd(10, 1))
    res = pcg(lambda x: A @ x, torch.zeros(10), tol=1e-3, max_iters=20)
    assert res.iters == 0 and float(res.rel_res) == 0.0
    assert torch.isfinite(res.history[0])


# ---------------------------------------------------------------------------
# rounding and the exact oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fixture", ["grid_instance", "road_instance"])
def test_rounding_matches_jax(fixture, request):
    """Same voltages in, same cuts out: the sweep runs in torch on the CPU
    here, the JAX sweep under XLA; two-level and Dinic are host numpy."""
    inst = request.getfixturevalue(fixture)
    # noisy voltages that lean to the source where the source pulls, so the
    # best sweep threshold is not the all-source/all-sink tie that
    # flow_improve_instance builds in (Σ c_s = Σ c_t)
    rng = np.random.default_rng(2)
    lean = np.asarray(inst.s_weight) > np.asarray(inst.t_weight)
    v = np.clip(0.25 + 0.5 * lean + rng.normal(0, 0.2, inst.n), 0, 1)
    v = v.astype(np.float32)
    pinst = _port(inst)
    for jname in ("sweep", "two_level"):
        want = jrd.REGISTRY[jname](inst, v)
        got = rd.round_voltages(jname, pinst, v, device="cpu")
        np.testing.assert_array_equal(got.in_source, want.in_source)
        assert got.cut_value == want.cut_value
    j = jmf.max_flow(inst)
    t = mf.max_flow(pinst)
    assert t.value == j.value
    np.testing.assert_array_equal(t.in_source, j.in_source)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sweep_plan_evaluates_every_prefix(seed):
    """The sweep sums each node's edge ends in the plan's order and writes
    the sum to the node's rank: every prefix cut is the float64 count of
    the same prefix (a random multigraph with self-loops and parallel
    edges), and the chosen side is the best prefix."""
    from repro_torch.core.incidence import coo_plan
    rng = np.random.default_rng(seed)
    n, m = 40, 200
    src = rng.integers(0, n, m)
    dst = np.where(rng.uniform(size=m) < 0.1, src, rng.integers(0, n, m))
    w = rng.uniform(0.1, 3, m)
    s_w, t_w = rng.uniform(0, 2, n) * (rng.uniform(size=n) < 0.5), \
        rng.uniform(0, 2, n) * (rng.uniform(size=n) < 0.5)
    v = rng.uniform(0, 1, n).astype(np.float32)
    ts, td = torch.as_tensor(src), torch.as_tensor(dst)

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32)

    ind, val = rd.sweep_cut_torch(ts, td, f32(w), f32(s_w), f32(t_w),
                                  torch.as_tensor(v), coo_plan(ts, td, n))
    order = np.argsort(-v, kind="stable")

    def cut(inside):
        cross = inside[src] != inside[dst]
        return w[cross].sum() + s_w[~inside].sum() + t_w[inside].sum()

    prefix = []
    for i in range(n + 1):
        inside = np.zeros(n, bool)
        inside[order[:i]] = True
        prefix.append(cut(inside))
    assert float(val) == pytest.approx(min(prefix), rel=1e-5)
    assert cut(ind.numpy()) == pytest.approx(min(prefix), rel=1e-5)


def test_sweep_reuses_its_topology_plan(grid_instance):
    """Requests of one topology share its index arrays
    (``Problem.instance_with``), so the sweep sorts their ends once."""
    from repro_torch.core.session import Problem
    prob = Problem.build(_port(grid_instance), n_blocks=1)
    w = prob.instance.graph.weight
    one = prob.instance_with((w, prob.instance.s_weight,
                              prob.instance.t_weight))
    two = prob.instance_with((w * 2, prob.instance.s_weight,
                              prob.instance.t_weight))
    assert rd._topology(one.graph, "cpu") is rd._topology(two.graph, "cpu")
    fresh = one._replace(graph=one.graph._replace(
        src=one.graph.src.copy(), dst=one.graph.dst.copy()))
    assert rd._topology(fresh.graph, "cpu") is not rd._topology(one.graph,
                                                                 "cpu")
    v = np.random.default_rng(3).uniform(0, 1, one.n).astype(np.float32)
    a, b = (rd.sweep_cut(i, v, device="cpu") for i in (one, fresh))
    np.testing.assert_array_equal(a.in_source, b.in_source)
    assert a.cut_value == b.cut_value


def test_maxflow_tiny_instance():
    inst = tiny_instance(12, seed=3)
    assert mf.min_cut_value(_port(inst)) == jmf.min_cut_value(inst)
