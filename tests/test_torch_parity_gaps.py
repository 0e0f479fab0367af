"""The helpers that the port copied last against the JAX package's.

``graphs.generators.social_like``, the ELL and dense-Laplacian helpers of
``graphs.structures`` with ``STInstance.full_edgelist`` (numpy in both
packages: the same arrays, dtypes and values), ``core.incidence.
scatter_edge_to_node`` (Bᵀy in the fixed order of the graph's ``CooPlan``,
held at rtol 1e-6 against the reference's ``segment_sum`` and bit-equal run
to run), ``models.transformer.abstract_cache`` against ``cache_shapes`` and
the reference's ``ShapeDtypeStruct`` tree, and ``ShardedSolver.arrays``
against ``abstract_inputs``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.graphs import generators as jgen  # noqa: E402
from repro.graphs import structures as jst  # noqa: E402

from repro_torch.graphs import generators as gen  # noqa: E402
from repro_torch.graphs import structures as st  # noqa: E402


def _same(got, want):
    """Array for array: the same dtype, shape and values."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, \
        (got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


def _same_graph(got, want):
    assert got.n == want.n
    for f in ("src", "dst", "weight"):
        _same(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("n,seed", [(30, 0), (51, 3), (400, 11)])
def test_social_like_matches_reference(n, seed):
    _same_graph(gen.social_like(n, seed=seed), jgen.social_like(n, seed=seed))


def test_social_like_rejects_a_single_node():
    with pytest.raises(ValueError, match="n >= 2"):
        gen.social_like(1)


def _instances():
    """A segmentation grid and a FlowImprove road instance, built by each
    package's own generators (equal arrays: tests/test_torch_core.py)."""
    out = {}
    for name, pkg in (("port", gen), ("ref", jgen)):
        g = pkg.grid_2d(9, 7, seed=3)
        grid = pkg.segmentation_instance(g, (9, 7), seed=4)
        road = pkg.flow_improve_instance(pkg.road_like(8, seed=5), seed=6)
        out[name] = {"grid": grid, "road": road}
    return out


@pytest.mark.parametrize("name", ["grid", "road"])
def test_structure_helpers_match_reference(name):
    insts = _instances()
    got, want = insts["port"][name], insts["ref"][name]
    # the full graph with its terminal edges
    fg, fw = got.full_edgelist(), want.full_edgelist()
    _same_graph(fg, fw)
    # ELLPACK of the Laplacian, its CSR padding at the default and a wider
    # width with a given diagonal, and the dense Laplacian
    for g, jg in ((got.graph, want.graph), (fg, fw)):
        e, je = st.edgelist_to_ell(g), jst.edgelist_to_ell(jg)
        assert (e.n, e.k) == (je.n, je.k)
        for f in ("cols", "vals", "diag"):
            _same(getattr(e, f), getattr(je, f))
        csr, jcsr = st.edgelist_to_csr(g), jst.edgelist_to_csr(jg)
        diag = np.linspace(1.0, 2.0, g.n)
        e, je = (st.csr_to_ell(csr, diag=diag, k=je.k + 2),
                 jst.csr_to_ell(jcsr, diag=diag, k=je.k + 2))
        for f in ("cols", "vals", "diag"):
            _same(getattr(e, f), getattr(je, f))
        rw = np.linspace(0.5, 1.5, g.m)
        _same(st.laplacian_dense(g), jst.laplacian_dense(jg))
        _same(st.laplacian_dense(g, reweight=rw),
              jst.laplacian_dense(jg, reweight=rw))


def test_csr_to_ell_refuses_a_narrow_width():
    g = gen.grid_2d(4, 4, seed=0)
    with pytest.raises(ValueError, match="exceeds ELL width"):
        st.csr_to_ell(st.edgelist_to_csr(g), k=1)
    with pytest.raises(ValueError, match="exceeds ELL width"):
        jst.csr_to_ell(jst.edgelist_to_csr(jgen.grid_2d(4, 4, seed=0)), k=1)


@pytest.mark.parametrize("lanes", [None, 3])
def test_scatter_edge_to_node_matches_reference(lanes):
    """Bᵀy on one lane and on a batch (the reference vmaps it) at rtol
    1e-6, and two runs give equal bits."""
    import jax

    from repro.core import incidence as jinc

    from repro_torch.core import incidence as inc

    inst = gen.flow_improve_instance(gen.road_like(10, seed=2), seed=3)
    g = inc.device_graph_from_instance(inst, device="cpu")
    jg = jinc.device_graph_from_instance(inst)
    rng = np.random.default_rng(0)
    shape = (g.m,) if lanes is None else (lanes, g.m)
    y = rng.standard_normal(shape).astype(np.float32)
    got = inc.scatter_edge_to_node(g, torch.from_numpy(y))
    again = inc.scatter_edge_to_node(g, torch.from_numpy(y.copy()))
    fn = lambda yy: jinc.scatter_edge_to_node(jg, yy)  # noqa: E731
    want = np.asarray(fn(y) if lanes is None else jax.vmap(fn)(y))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert torch.equal(got, again)
    # Bᵀ1 over the edges: each node's out-degree less its in-degree
    ones = inc.scatter_edge_to_node(g, torch.ones(g.m))
    deg = (np.bincount(inst.graph.src, minlength=inst.n)
           - np.bincount(inst.graph.dst, minlength=inst.n))
    np.testing.assert_array_equal(ones.numpy(), deg.astype(np.float32))


def test_abstract_cache_matches_cache_shapes():
    """qwen2's reduced config, a batch of 2 and 48 positions: meta tensors
    of ``cache_shapes``' shapes and dtypes, the reference's
    ``abstract_cache`` tree; inside a ``FakeTensorMode`` fake tensors on the
    device asked for."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

    from repro.configs import registry as jregistry
    from repro.models import transformer as jtr

    from repro_torch.configs import registry
    from repro_torch.models import transformer as tr

    cfg = registry.get("qwen2-1.5b").make_reduced()
    jcfg = jregistry.get("qwen2-1.5b").make_reduced()
    got = tr.abstract_cache(cfg, 2, 48)
    want = tr.cache_shapes(cfg, 2, 48)
    ref = jtr.abstract_cache(jcfg, 2, 48)
    assert sorted(got) == sorted(want) == sorted(ref)
    for k, (shape, dtype) in want.items():
        assert got[k].is_meta
        assert (tuple(got[k].shape), got[k].dtype) == (tuple(shape), dtype)
        assert tuple(ref[k].shape) == tuple(shape)
        assert str(ref[k].dtype) == str(dtype).replace("torch.", "")
    with FakeTensorMode():
        fake = tr.abstract_cache(cfg, 2, 48, device="cpu")
    assert all(isinstance(t, FakeTensor) and t.device.type == "cpu"
               and tuple(t.shape) == tuple(want[k][0])
               for k, t in fake.items())


@pytest.mark.parametrize("sched,fuse", [("halo", True), ("halo", False),
                                        ("psum", True)])
def test_sharded_solver_arrays_are_the_abstract_inputs(sched, fuse):
    """``arrays()``: this rank's plan tensors in the order of
    ``abstract_inputs`` (shape for shape, dtype for dtype) and of the solve
    body, on a fake world of four."""
    import warnings

    from repro_torch.core import IRLSConfig
    from repro_torch.distributed.solver import ShardedSolver
    from repro_torch.launch.mesh import make_plan_mesh, release_plan_world

    warnings.simplefilter("ignore")
    inst = gen.segmentation_instance(gen.grid_2d(12, 12, seed=1), (12, 12),
                                     seed=2)
    try:
        make_plan_mesh((2, 2), ("data", "model"), device="cpu")
        s = ShardedSolver(inst, IRLSConfig(fuse_edge_sweep=fuse),
                          schedule=sched, precond_bs=32, device="cpu")
        arrays, fake = s.arrays(), s.abstract_inputs()
    finally:
        release_plan_world()
    assert len(arrays) == len(fake) == len(s._t)
    for a, f, t in zip(arrays, fake, s._t.values()):
        assert a is t
        assert (tuple(a.shape), a.dtype) == (tuple(f.shape), f.dtype)
