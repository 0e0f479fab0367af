"""The port's GNNs, their data and configs against the JAX package, on the CPU.

Per arch (GCN, SchNet, DimeNet, MeshGraphNet; reduced configs on
``REDUCED_CELL``), on the same numpy batch and the reference's parameters
carried over with ``params_from_numpy``: forward and loss, every
gradient leaf against ``jax.grad``, three train steps against the
reference's ``build_train_step``.  The reference tests' properties on the
port (a small AdamW step lowers the loss, GCN permutation equivariance,
SchNet extensivity, MeshGraphNet edge masking, the DimeNet bottleneck
variant with float32 and bf16 gathers).  The batch builders, the
neighbour sampler and the configs equal the reference's; the fixed-order
gather and segment sum give, on the CPU, the bits of autograd's own
``index_select``/``F.embedding`` backward and of ``index_add_``.  Each
tolerance states its reason."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import gnn as jgnn_cfg  # noqa: E402
from repro.configs import registry as jregistry  # noqa: E402
from repro.data import graphs as jgraphs  # noqa: E402
from repro.models import gnn as jg  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train.train_step import build_train_step as jbuild  # noqa: E402

from repro_torch.configs import gnn as gnn_cfg  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.data import graphs  # noqa: E402
from repro_torch.models import gnn as g  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.sharding import no_sharding  # noqa: E402
from repro_torch.train.checkpoint import named_leaves  # noqa: E402
from repro_torch.train.optimizer import (AdamWConfig, apply_updates,  # noqa: E402
                                         init_state)
from repro_torch.train.train_step import build_train_step  # noqa: E402

ARCHS = ["gcn-cora", "schnet", "dimenet", "meshgraphnet"]
J_INITS = {"gcn-cora": jg.gcn_init, "schnet": jg.schnet_init,
           "dimenet": jg.dimenet_init, "meshgraphnet": jg.mgn_init}
J_FORWARDS = {"gcn-cora": jg.gcn_forward, "schnet": jg.schnet_forward,
              "dimenet": jg.dimenet_forward, "meshgraphnet": jg.mgn_forward}
J_LOSSES = {"gcn-cora": jg.gcn_loss, "schnet": jg.schnet_loss,
            "dimenet": jg.dimenet_loss, "meshgraphnet": jg.mgn_loss}


def _np_batch(arch, cfg, seed=0):
    """The reference test's batch (``_batch_for``) as numpy, n_graphs
    apart."""
    cell = jgnn_cfg.REDUCED_CELL
    b = jgraphs.synthetic_gnn_batch(
        arch, cell["n_nodes"], cell["n_edges"],
        d_feat=getattr(cfg, "in_dim", None) or cell["d_feat"],
        n_graphs=cell["n_graphs"], n_classes=cell["n_classes"],
        max_triplets=cell["n_triplets"],
        in_edge_dim=getattr(cfg, "in_edge_dim", 7),
        out_dim=getattr(cfg, "out_dim", 3),
        sbf_dim=getattr(cfg, "sbf_dim", 42), seed=seed)
    return b, b.pop("n_graphs", None)


def _batches(b, ng):
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    if ng is not None:
        jb["n_graphs"] = tb["n_graphs"] = ng
    return jb, tb


def _setup(arch, seed=0, **overrides):
    """(jcfg, cfg, jparams, params, numpy batch, n_graphs): the reduced
    config (with ``overrides``), the reference's init at PRNGKey(0) and
    the port's copy of it."""
    jcfg = jregistry.get(arch).make_reduced()
    cfg = registry.get(arch).make_reduced()
    if overrides:
        jcfg = dataclasses.replace(jcfg, **overrides)
        cfg = dataclasses.replace(cfg, **overrides)
    jparams = J_INITS[arch](jcfg, jax.random.PRNGKey(0))
    params = g.params_from_numpy(arch, jax.tree.map(np.asarray, jparams),
                                 cfg, device="cpu")
    b, ng = _np_batch(arch, jcfg, seed)
    return jcfg, cfg, jparams, params, b, ng


def _grads(loss_fn, params):
    leaves = named_leaves(params)
    for _, p in leaves:
        p.requires_grad_(True)
    loss = loss_fn(params)
    grads = torch.autograd.grad(loss, [p for _, p in leaves],
                                allow_unused=True)
    for _, p in leaves:
        p.requires_grad_(False)
    return loss.detach(), {k: (torch.zeros_like(p) if gr is None else gr)
                           for (k, p), gr in zip(leaves, grads)}


@pytest.mark.parametrize("arch", ARCHS)
def test_gnn_forward_and_loss_match_jax(arch):
    """Forward output within rel 1e-5 of its max and the loss within rel
    1e-5 (float32 sums in other orders: matmuls, the segment sums, the
    bilinear contraction)."""
    jcfg, cfg, jparams, params, b, ng = _setup(arch)
    jb, tb = _batches(b, ng)
    want = np.asarray(J_FORWARDS[arch](jparams, jb, jcfg))
    forward = {"gcn-cora": g.gcn_forward, "schnet": g.schnet_forward,
               "dimenet": g.dimenet_forward, "meshgraphnet": g.mgn_forward}
    got = forward[arch](params, tb, cfg).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= 1e-5, err
    jloss = float(J_LOSSES[arch](jparams, jb, jcfg))
    loss = float(g.LOSSES[arch](params, tb, cfg))
    assert loss == pytest.approx(jloss, rel=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_gnn_grads_match_jax(arch):
    """Every gradient leaf within 1e-4 of its leaf's max against
    ``jax.grad`` (the same parameters and batch; float32 sums in other
    orders through every layer's backward)."""
    jcfg, cfg, jparams, params, b, ng = _setup(arch)
    jb, tb = _batches(b, ng)
    jloss, jgrads = jax.value_and_grad(
        lambda p: J_LOSSES[arch](p, jb, jcfg))(jparams)
    loss, grads = _grads(lambda p: g.LOSSES[arch](p, tb, cfg), params)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    want = dict(named_leaves(jax.tree.map(np.asarray, jgrads)))
    assert list(grads) == list(want)           # the reference's tree
    for key, gr in grads.items():
        scale = np.abs(want[key]).max()
        err = np.abs(gr.numpy() - want[key]).max()
        assert err <= 1e-4 * scale, (key, err, scale)


# lr 3e-3 with a warm-up of 2 steps, as test_torch_train's LM steps
TRAIN_OPT = dict(lr=3e-3, warmup_steps=2)


@pytest.mark.parametrize("arch", ARCHS)
def test_gnn_train_steps_match_jax(arch):
    """Three train steps (batches at seeds 0, 1, 2, as the launcher draws
    them) from the reference's init and AdamW state: losses within rel
    1e-4; every parameter entry at ``test_train_steps_match_jax``'s bar
    (within 2·Σ_t lr_t plus rel 1e-4 of its leaf's max: Adam's step is ±lr
    where a gradient near 0 takes its sign from roundoff), and 99.9% of the
    entries within 1e-5 of the leaf's max plus 1e-4·Σ_t lr_t: the biases
    start at 0, so their max is a few steps of lr, and an entry whose
    gradient is small beside its leaf's max has its moment m, and so its
    step m̂/√v̂, known to rel ~1e-4 only (SchNet's filter biases read gaps
    of 1.2e-5 of their max)."""
    jcfg, cfg, jparams, params, _, ng = _setup(arch)
    jstate = jopt.init_state(jopt.AdamWConfig(**TRAIN_OPT), jparams)
    state = init_state(AdamWConfig(**TRAIN_OPT), params)

    def with_ng(b):
        return dict(b, n_graphs=ng) if ng is not None else b

    jstep = jax.jit(jbuild(lambda p, b: J_LOSSES[arch](p, with_ng(b), jcfg),
                           jopt.AdamWConfig(**TRAIN_OPT)))
    step = build_train_step(lambda p, b: g.LOSSES[arch](p, with_ng(b), cfg),
                            AdamWConfig(**TRAIN_OPT))
    jlosses, losses = [], []
    for seed in range(3):
        b, _ = _np_batch(arch, jcfg, seed)
        jparams, jstate, jm = jstep(jparams, jstate,
                                    {k: jnp.asarray(v) for k, v in b.items()})
        params, state, m = step(params, state,
                                {k: torch.from_numpy(v) for k, v in b.items()})
        jlosses.append(float(jm["loss"]))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    lr_sum = sum(TRAIN_OPT["lr"] * min(1.0, (t + 1) / TRAIN_OPT["warmup_steps"])
                 for t in range(3))
    want = dict(named_leaves(jax.tree.map(np.asarray, jparams)))
    for key, p in named_leaves(params):
        scale = np.abs(want[key]).max()
        gap = np.abs(p.detach().numpy() - want[key])
        assert gap.max() <= 2 * lr_sum + 1e-4 * scale, (key, gap.max())
        assert np.mean(gap <= 1e-5 * scale + 1e-4 * lr_sum) >= 0.999, key
    assert int(state["count"]) == 3


@pytest.mark.parametrize("arch", ARCHS)
def test_gnn_arch_smoke(arch):
    """The reference's smoke property on the port's own init: finite loss
    and gradients, and one small AdamW step along the gradient lowers the
    same batch's loss."""
    cfg = registry.get(arch).make_reduced()
    params = g.INITS[arch](cfg, torch.Generator().manual_seed(0), "cpu")
    b, ng = _np_batch(arch, cfg)
    _, tb = _batches(b, ng)
    loss, grads = _grads(lambda p: g.LOSSES[arch](p, tb, cfg), params)
    assert torch.isfinite(loss)
    assert all(bool(torch.isfinite(gr).all()) for gr in grads.values())
    oc = AdamWConfig(lr=1e-4, warmup_steps=1, weight_decay=0.0)
    apply_updates(oc, params, list(grads.values()), init_state(oc, params))
    assert float(g.LOSSES[arch](params, tb, cfg)) < float(loss)


def test_gnn_param_trees_are_the_references():
    """Each arch's init (full and reduced, DimeNet with its bottleneck):
    the reference's leaves, key for key and shape for shape, stacked
    per-layer leaves included; ``params_from_numpy`` refuses another
    tree."""
    for arch in ARCHS:
        for make in ("full", "reduced"):
            entry = registry.get(arch)
            jentry = jregistry.get(arch)
            cell = gnn_cfg.GNN_SHAPES["full_graph_sm"]
            cfg = entry.make_config(cell) if make == "full" else \
                entry.make_reduced()
            jcfg = jentry.make_config(cell) if make == "full" else \
                jentry.make_reduced()
            ours = g.INITS[arch](cfg, None, "meta")
            theirs = jax.eval_shape(lambda: J_INITS[arch](
                jcfg, jax.random.PRNGKey(0)))
            assert [(k, tuple(t.shape)) for k, t in named_leaves(ours)] == \
                [(k, tuple(t.shape)) for k, t in named_leaves(theirs)]
    cfg = dataclasses.replace(registry.get("dimenet").make_reduced(),
                              triplet_bottleneck=8)
    keys = [k for k, _ in named_leaves(g.dimenet_init(cfg, None, "meta"))]
    assert "blocks/down" in keys and "blocks/up" in keys
    jcfg, cfg, jparams, _, _, _ = _setup("schnet")
    tree = jax.tree.map(np.asarray, jparams)
    tree["inter"]["in_lin"] = tree["inter"]["in_lin"][:1]
    with pytest.raises(ValueError, match="in_lin"):
        g.params_from_numpy("schnet", tree, cfg, device="cpu")
    del tree["head"]
    with pytest.raises(ValueError, match="parameter tree"):
        g.params_from_numpy("schnet", tree, cfg, device="cpu")


def test_gcn_permutation_equivariance():
    """Relabeling nodes permutes GCN outputs identically."""
    cfg = registry.get("gcn-cora").make_reduced()
    params = g.gcn_init(cfg, torch.Generator().manual_seed(0), "cpu")
    b, _ = _np_batch("gcn-cora", cfg)
    _, batch = _batches(b, None)
    n = batch["node_feat"].shape[0]
    perm = np.random.default_rng(1).permutation(n)
    out1 = g.gcn_forward(params, batch, cfg)
    inv = torch.from_numpy(np.argsort(perm).astype(np.int32))
    pb = dict(batch, node_feat=batch["node_feat"][perm],
              edge_src=inv[batch["edge_src"].long()],
              edge_dst=inv[batch["edge_dst"].long()])
    out2 = g.gcn_forward(params, pb, cfg)
    np.testing.assert_allclose(out2.numpy(), out1.numpy()[perm],
                               rtol=2e-4, atol=2e-4)


def test_schnet_energy_extensive():
    """Doubling a molecule (disjoint copy) doubles its SchNet energy."""
    cfg = registry.get("schnet").make_reduced()
    params = g.schnet_init(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(2)
    n, e = 10, 20
    zt = rng.integers(0, 50, n).astype(np.int32)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = ((src + 1 + rng.integers(0, n - 1, e)) % n).astype(np.int32)
    d = rng.uniform(0.5, 5, e).astype(np.float32)

    def make(m):
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
        return {"node_type": t(np.tile(zt, m)),
                "edge_src": t(np.concatenate([src + i * n for i in range(m)])),
                "edge_dst": t(np.concatenate([dst + i * n for i in range(m)])),
                "edge_dist": t(np.tile(d, m)),
                "edge_mask": torch.ones(e * m), "node_mask": torch.ones(n * m),
                "graph_ids": torch.zeros(n * m, dtype=torch.int32),
                "n_graphs": 1}

    e1 = g.schnet_forward(params, make(1), cfg)
    e2 = g.schnet_forward(params, make(2), cfg)
    assert float(e2[0]) == pytest.approx(2 * float(e1[0]), rel=1e-4)


def test_mgn_edge_masking():
    """Masked (padding) edges must not affect MeshGraphNet outputs."""
    cfg = registry.get("meshgraphnet").make_reduced()
    params = g.mgn_init(cfg, torch.Generator().manual_seed(0), "cpu")
    b, _ = _np_batch("meshgraphnet", cfg)
    _, batch = _batches(b, None)
    out1 = g.mgn_forward(params, batch, cfg)
    fe = batch["edge_feat"].shape[1]
    b2 = dict(batch,
              edge_src=torch.cat([batch["edge_src"],
                                  torch.zeros(8, dtype=torch.int32)]),
              edge_dst=torch.cat([batch["edge_dst"],
                                  torch.ones(8, dtype=torch.int32)]),
              edge_feat=torch.cat([batch["edge_feat"],
                                   torch.full((8, fe), 9.0)]),
              edge_mask=torch.cat([batch["edge_mask"], torch.zeros(8)]))
    out2 = g.mgn_forward(params, b2, cfg)
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("gather_dtype", [None, "bfloat16"])
def test_dimenet_bottleneck_variant_trains(gather_dtype):
    """The DimeNet++-style bottleneck (ht = 8), with float32 and bf16
    triplet gathers: finite loss and gradients, and the loss of the
    reference's same variant within rel 1e-5 (float32) or 2e-3 (bf16: the
    same messages rounded to bf16, where an input a float32 ulp apart may
    round to a neighbouring bf16 value, 2⁻⁸ relative)."""
    jcfg, cfg, jparams, params, b, ng = _setup(
        "dimenet", triplet_bottleneck=8,
        gather_dtype=None if gather_dtype is None else jnp.bfloat16)
    assert cfg.gather_dtype == (None if gather_dtype is None
                                else torch.bfloat16)
    jb, tb = _batches(b, ng)
    loss, grads = _grads(lambda p: g.dimenet_loss(p, tb, cfg), params)
    assert torch.isfinite(loss)
    assert all(bool(torch.isfinite(gr).all()) for gr in grads.values())
    jloss = float(jg.dimenet_loss(jparams, jb, jcfg))
    rel = 1e-5 if gather_dtype is None else 2e-3
    assert float(loss) == pytest.approx(jloss, rel=rel)


def test_scatter_mean_and_rbf_match_jax():
    rng = np.random.default_rng(5)
    vals = rng.standard_normal((40, 3)).astype(np.float32)
    idx = rng.integers(0, 7, 40).astype(np.int32)
    mask = (rng.random(40) < 0.6).astype(np.float32)
    for m in (None, mask):
        want = np.asarray(jg.scatter_mean(
            jnp.asarray(vals), jnp.asarray(idx), 7,
            None if m is None else jnp.asarray(m)))
        got = g.scatter_mean(torch.from_numpy(vals), torch.from_numpy(idx), 7,
                             None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    dist = rng.uniform(0.5, 10.0, 30).astype(np.float32)
    np.testing.assert_allclose(
        g.rbf_expand(torch.from_numpy(dist), 300, 10.0).numpy(),
        np.asarray(jg.rbf_expand(jnp.asarray(dist), 300, 10.0)),
        rtol=1e-5, atol=1e-6)


def test_fixed_order_gather_and_sum_bits_on_cpu():
    """``layers.gather``'s backward gives the bits of autograd's own
    ``index_select`` and ``F.embedding`` backward, and ``segment_sum``
    those of ``index_add_`` (float32, the models' dtype; rows and vectors);
    the sum's backward is the gather of its gradient."""
    gen = torch.Generator().manual_seed(3)
    n, m = 60, 700
    for tail in ((), (5,)):
        ids = torch.randint(0, n, (m,), generator=gen, dtype=torch.int32)
        index = layers.RowIndex(ids, n)
        x = (torch.randn((n,) + tail, generator=gen) * 10).requires_grad_(True)
        gy = torch.randn((m,) + tail, generator=gen)
        (ours,) = torch.autograd.grad(layers.gather(x, index), x, gy)
        (ref,) = torch.autograd.grad(x.index_select(0, ids.long()), x, gy)
        assert torch.equal(ours, ref)
        if tail:
            (emb,) = torch.autograd.grad(
                torch.nn.functional.embedding(ids.long(), x), x, gy)
            assert torch.equal(ours, emb)
        v = gy.clone().requires_grad_(True)
        s = layers.segment_sum(v, index)
        assert torch.equal(s, torch.zeros((n,) + tail).index_add_(
            0, ids.long(), gy))
        gs = torch.randn((n,) + tail, generator=gen)
        (back,) = torch.autograd.grad(s, v, gs)
        assert torch.equal(back, gs[ids.long()])
    # the plan is built once and shared by every use of the index
    index = layers.RowIndex(torch.tensor([2, 0, 2], dtype=torch.int32), 3)
    assert index.seg is index.seg


def test_gnn_rules_without_a_mesh_and_on_a_mesh():
    """``rules`` without a mesh change nothing; on a mesh of one rank
    (``gnn_rules`` on a (1, 1) mesh over a gloo world of one) every
    collective is the identity, so each arch's loss is the unsharded one
    bit for bit."""
    from repro_torch.distributed.collectives import release_world
    from repro_torch.launch.cells import gnn_rules
    from repro_torch.launch.mesh import make_host_mesh

    jcfg, cfg, _, params, b, ng = _setup("meshgraphnet")
    _, tb = _batches(b, ng)
    base = g.mgn_forward(params, tb, cfg)
    assert torch.equal(g.mgn_forward(params, tb, cfg, no_sharding()), base)
    try:
        rules = gnn_rules(make_host_mesh((1, 1), device="cpu"))
        assert rules.axes("nodes") == ("data", "model")
        for arch in ARCHS:
            _, cfg, _, params, b, ng = _setup(arch)
            _, tb = _batches(b, ng)
            assert torch.equal(g.LOSSES[arch](params, tb, cfg, rules),
                               g.LOSSES[arch](params, tb, cfg))
    finally:
        release_world()


# -- data and configs ------------------------------------------------------------

def _assert_same_dicts(a, b):
    assert list(a) == list(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def test_build_triplets_matches_reference():
    rng = np.random.default_rng(0)
    src = rng.integers(0, 30, 120).astype(np.int32)
    dst = ((src + 1 + rng.integers(0, 29, 120)) % 30).astype(np.int32)
    for cap, seed in ((None, 0), (200, 3), (10_000, 1)):
        for a, b in zip(graphs.build_triplets(src, dst, 30, cap, seed),
                        jgraphs.build_triplets(src, dst, 30, cap, seed)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_synthetic_gnn_batch_and_shapes_match_reference(arch):
    for kw in (dict(n_nodes=64, n_edges=160, d_feat=8, n_graphs=4,
                    max_triplets=512, seed=0),
               dict(n_nodes=50, n_edges=90, d_feat=5, n_graphs=2,
                    max_triplets=None, sbf_dim=12, n_classes=3,
                    in_edge_dim=4, out_dim=2, seed=7)):
        _assert_same_dicts(graphs.synthetic_gnn_batch(arch, **kw),
                           jgraphs.synthetic_gnn_batch(arch, **kw))
    for kw in (dict(n_nodes=2708, n_edges=10556, d_feat=1433,
                    n_triplets=65536),
               dict(n_nodes=3840, n_edges=8192, d_feat=16, n_triplets=16384,
                    n_graphs=128, sbf_dim=42, out_dim=3, in_edge_dim=7)):
        assert graphs.gnn_batch_shapes(arch, **kw) == \
            jgraphs.gnn_batch_shapes(arch, **kw)
    with pytest.raises(ValueError):
        graphs.synthetic_gnn_batch("nope", 4, 4)


def test_neighbor_sampler_matches_reference():
    """The sampler on ``test_partition_graphs``' graph (a 6-regular graph
    of 500 nodes, fanouts (5, 3), 16 seeds): three batches array-equal to
    the reference's for the same seed, and for given seeds."""
    from repro.data.sampler import NeighborSampler as JSampler
    from repro.graphs import generators as jgen
    from repro.graphs.structures import edgelist_to_csr as jcsr

    from repro_torch.data.sampler import NeighborSampler
    from repro_torch.graphs import generators as gen
    from repro_torch.graphs.structures import edgelist_to_csr

    ours = NeighborSampler(edgelist_to_csr(gen.random_regular(500, 6, seed=4)),
                           fanouts=(5, 3), batch_nodes=16, seed=0)
    theirs = JSampler(jcsr(jgen.random_regular(500, 6, seed=4)),
                      fanouts=(5, 3), batch_nodes=16, seed=0)
    assert (ours.max_nodes, ours.max_edges) == (theirs.max_nodes,
                                               theirs.max_edges)
    for _ in range(3):
        _assert_same_dicts(ours.sample(), theirs.sample())
    seeds = np.array([3, 3, 499, 0])
    _assert_same_dicts(ours.sample(seeds), theirs.sample(seeds))


def _cfg_dict(cfg):
    d = dataclasses.asdict(cfg)
    for k in ("dtype", "gather_dtype"):
        if d.get(k) is not None:
            d[k] = str(d[k]).removeprefix("torch.") \
                if isinstance(d[k], torch.dtype) else np.dtype(d[k]).name
    return d


def test_gnn_configs_and_registry_match_reference():
    """GNN_CELLS, GNN_SHAPES, REDUCED_CELL, each maker on every cell, the
    reduced configs, the registry entries and the four thin modules,
    field for field the reference's (dtypes by name)."""
    import importlib

    assert gnn_cfg.GNN_CELLS == jgnn_cfg.GNN_CELLS
    assert gnn_cfg.GNN_SHAPES == jgnn_cfg.GNN_SHAPES
    assert gnn_cfg.REDUCED_CELL == jgnn_cfg.REDUCED_CELL
    assert list(gnn_cfg.GNN_ARCHS) == list(jgnn_cfg.GNN_ARCHS)
    for arch in ARCHS:
        for cell in list(gnn_cfg.GNN_SHAPES.values()) + [gnn_cfg.REDUCED_CELL]:
            assert _cfg_dict(gnn_cfg.GNN_ARCHS[arch](cell)) == \
                _cfg_dict(jgnn_cfg.GNN_ARCHS[arch](cell))
        assert _cfg_dict(gnn_cfg.reduced_gnn(arch)) == \
            _cfg_dict(jgnn_cfg.reduced_gnn(arch))
        e, je = registry.get(arch), jregistry.get(arch)
        assert (e.arch_id, e.family, e.cells, e.shapes) == \
            (je.arch_id, je.family, je.cells, je.shapes)
        assert _cfg_dict(e.make_reduced()) == _cfg_dict(je.make_reduced())
        mod = arch.replace("-", "_")
        ours = importlib.import_module(f"repro_torch.configs.{mod}")
        theirs = importlib.import_module(f"repro.configs.{mod}")
        assert ours.ARCH_ID == theirs.ARCH_ID == arch
        assert tuple(ours.cells()) == tuple(theirs.cells())
        cell = gnn_cfg.GNN_SHAPES["minibatch_lg"]
        assert _cfg_dict(ours.config(cell)) == _cfg_dict(theirs.config(cell))
        assert _cfg_dict(ours.reduced()) == _cfg_dict(theirs.reduced())
    # configs take torch, numpy and JAX dtypes and names alike
    for dt in (torch.bfloat16, jnp.bfloat16, "bfloat16"):
        assert g.GCNConfig(dtype=dt).dtype == torch.bfloat16
        assert g.DimeNetConfig(gather_dtype=dt).gather_dtype == torch.bfloat16
    assert g.DimeNetConfig().gather_dtype is None
