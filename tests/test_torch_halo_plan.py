"""The port's sharded-solver plans against the JAX package's, in process.

``repro_torch.distributed`` builds the same numpy plans as
``repro.distributed`` (psum, halo, halo block and halo ELL plans), array
for array, from the same instance and partition labels, at shard counts
that divide n and that do not, and with empty boundary sets (the cases of
``tests/test_halo_plan.py``).  The incremental weight refill patches the
plan and the ELL staging bit-equal to a full refill.  No process group is
needed: everything here is host numpy.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

P_VALUES = [1, 3, 4, 8]


def _nondividing(pkg):
    g = pkg.graphs.generators.grid_2d(19, 23, seed=3)   # n = 437: no divisor
    return pkg.graphs.generators.segmentation_instance(g, (19, 23), seed=4)


def _grid20(pkg):
    g = pkg.graphs.generators.grid_2d(20, 20, seed=7)
    return pkg.graphs.generators.segmentation_instance(g, (20, 20), seed=8)


def _two_blocks(pkg):
    """Two DISJOINT 4x4 grids: with labels [0]*16 + [1]*16 no directed copy
    crosses shards, so both boundary sets are empty."""
    gen = pkg.graphs.generators
    st = pkg.graphs.structures
    g1, g2 = gen.grid_2d(4, 4, seed=5), gen.grid_2d(4, 4, seed=6)
    n = g1.n + g2.n
    src = np.concatenate([np.asarray(g1.src), np.asarray(g2.src) + g1.n])
    dst = np.concatenate([np.asarray(g1.dst), np.asarray(g2.dst) + g1.n])
    w = np.concatenate([np.asarray(g1.weight), np.asarray(g2.weight)])
    rng = np.random.default_rng(7)
    return st.STInstance(graph=st.EdgeList(src=src, dst=dst, weight=w, n=n),
                         s_weight=rng.uniform(0.1, 1.0, n),
                         t_weight=rng.uniform(0.1, 1.0, n))


INSTANCES = {"nondividing": _nondividing, "grid20": _grid20}


def _packages():
    import repro.graphs.generators  # noqa: F401
    import repro.graphs.structures  # noqa: F401
    import repro_torch.graphs.generators  # noqa: F401
    import repro_torch.graphs.structures  # noqa: F401
    import repro
    import repro_torch
    return repro, repro_torch


def _assert_same(got, want):
    """Two plan NamedTuples equal field by field (arrays exactly, with
    their dtypes)."""
    assert type(got).__name__ == type(want).__name__
    assert got._fields == want._fields
    for name in want._fields:
        a, b = getattr(got, name), getattr(want, name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, name


@pytest.mark.parametrize("p", P_VALUES)
def test_psum_plan_matches_reference(p):
    from repro.distributed import spmv as jspmv
    from repro_torch.distributed import spmv

    jax_pkg, port = _packages()
    _assert_same(spmv.build_psum_plan(_nondividing(port), p),
                 jspmv.build_psum_plan(_nondividing(jax_pkg), p))


@pytest.mark.parametrize("which", sorted(INSTANCES))
@pytest.mark.parametrize("p", P_VALUES)
def test_halo_plans_match_reference(p, which):
    """Halo, halo block and halo ELL plans, built by each package from its
    own copy of the instance and its own k-way partition: equal labels,
    equal arrays."""
    from repro.distributed import solver as jsolver
    from repro.distributed import spmv as jspmv
    from repro.graphs import partition as jgp
    from repro_torch.distributed import solver, spmv
    from repro_torch.graphs import partition as gp

    jax_pkg, port = _packages()
    inst_j, inst_t = INSTANCES[which](jax_pkg), INSTANCES[which](port)
    labels_j = jgp.partition_kway(inst_j.graph, p)
    labels_t = gp.partition_kway(inst_t.graph, p)
    np.testing.assert_array_equal(labels_t, labels_j)
    plan_j = jspmv.build_halo_plan(inst_j, p, labels=labels_j)
    plan_t = spmv.build_halo_plan(inst_t, p, labels=labels_t)
    _assert_same(plan_t, plan_j)
    if p > 1 and which == "nondividing":
        assert plan_t.nl * p > plan_t.n          # padded last shard
        assert (plan_t.tails_ext >= plan_t.nl).any()   # a real halo
    for bs in (16, 64):
        _assert_same(solver.build_halo_block_plan(plan_t, bs),
                     jsolver.build_halo_block_plan(plan_j, bs))
    _assert_same(spmv.build_halo_ell(plan_t), jspmv.build_halo_ell(plan_j))


def test_halo_plan_without_labels_matches_reference():
    """``labels=None`` partitions inside the builder, in both packages."""
    from repro.distributed import spmv as jspmv
    from repro_torch.distributed import spmv

    jax_pkg, port = _packages()
    _assert_same(spmv.build_halo_plan(_nondividing(port), 4),
                 jspmv.build_halo_plan(_nondividing(jax_pkg), 4))


@pytest.mark.parametrize("p", [1, 2])
def test_halo_plans_empty_boundary_match_reference(p):
    """No cross-shard edges: every export list is empty, the plan stays
    well-formed (b_sh padded, exports zeroed), equal to the reference's."""
    from repro.distributed import solver as jsolver
    from repro.distributed import spmv as jspmv
    from repro_torch.distributed import solver, spmv

    jax_pkg, port = _packages()
    labels = np.asarray([0] * 16 + [1] * 16)
    plan_t = spmv.build_halo_plan(_two_blocks(port), p, labels=labels)
    plan_j = jspmv.build_halo_plan(_two_blocks(jax_pkg), p, labels=labels)
    _assert_same(plan_t, plan_j)
    assert (plan_t.export == 0).all()
    for i in range(p):
        assert (plan_t.tails_ext[i][plan_t.c[i] > 0] < plan_t.nl).all()
    _assert_same(solver.build_halo_block_plan(plan_t, 16),
                 jsolver.build_halo_block_plan(plan_j, 16))
    _assert_same(spmv.build_halo_ell(plan_t), jspmv.build_halo_ell(plan_j))


def _drifted(inst, rng, frac, scale_terminals=False, zero=False):
    from repro_torch.graphs.structures import EdgeList, STInstance

    g = inst.graph
    w = np.asarray(g.weight, dtype=np.float64).copy()
    idx = rng.choice(w.size, max(1, int(frac * w.size)), replace=False)
    w[idx] = 0.0 if zero else w[idx] * rng.uniform(0.5, 1.5, idx.size)
    c_s = np.asarray(inst.s_weight, dtype=np.float64)
    c_t = np.asarray(inst.t_weight, dtype=np.float64)
    if scale_terminals:
        c_s, c_t = c_s * 1.1, c_t * 0.9
    return STInstance(graph=EdgeList(src=g.src, dst=g.dst, weight=w, n=g.n),
                      s_weight=c_s, t_weight=c_t)


@pytest.mark.parametrize("terminals", [False, True])
@pytest.mark.parametrize("p", [3, 4])
def test_delta_refill_bit_equal_to_full_refill(p, terminals):
    """A sparse, support-stable drift patches the halo plan and the ELL
    staging to the very arrays a full refill builds."""
    from repro_torch.distributed import solver, spmv
    from repro_torch.graphs import partition as gp

    _, port = _packages()
    inst = _nondividing(port)
    labels = gp.partition_kway(inst.graph, p)
    plan = spmv.build_halo_plan(inst, p, labels=labels)
    ell = spmv.build_halo_ell(plan)
    rng = np.random.default_rng(p)
    prev = inst
    slots = solver.directed_copy_slots(inst, plan)
    for step in range(3):
        new = _drifted(prev, rng, 0.02, scale_terminals=terminals)
        out = solver.delta_refill(plan, ell, prev, new, lambda: slots)
        assert out is not None, step
        plan, ell = out
        full = spmv.build_halo_plan(new, p, labels=labels)
        _assert_same(plan, full)
        _assert_same(ell, spmv.build_halo_ell(full))
        prev = new


def test_delta_refill_declines_dense_and_support_flips():
    """Dense diffs and edges that turn 0 take the full refill (None)."""
    from repro_torch.distributed import solver, spmv
    from repro_torch.graphs import partition as gp

    _, port = _packages()
    inst = _nondividing(port)
    labels = gp.partition_kway(inst.graph, 4)
    plan = spmv.build_halo_plan(inst, 4, labels=labels)
    ell = spmv.build_halo_ell(plan)
    slots = lambda: solver.directed_copy_slots(inst, plan)
    rng = np.random.default_rng(0)
    assert solver.delta_refill(plan, ell, inst, _drifted(inst, rng, 0.5),
                               slots) is None
    assert solver.delta_refill(plan, ell, inst,
                               _drifted(inst, rng, 0.01, zero=True),
                               slots) is None
    same = solver.delta_refill(plan, ell, inst, inst, slots)
    _assert_same(same[0], plan)
    _assert_same(same[1], ell)
