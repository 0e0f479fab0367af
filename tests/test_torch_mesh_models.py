"""The port's GNNs and DIN on a mesh (``launch.cells.gnn_rules`` and
``din_rules``) against the JAX package's sharded programs and against the
port unsharded.

Both sides run in subprocesses started once for the module: the port in
four gloo ranks on a (data 2, model 2) mesh, the reference on four emulated
CPU devices with its mesh built with ``AxisType.Auto`` (its
``with_sharding_constraint`` refuses Explicit axes), its batches placed as
``repro.launch.cells`` places them.  Both take the same numpy parameters
(every leaf of the reference's tree in sorted key order, N(0, 1/fan_in))
and batches (the reduced configs on ``REDUCED_CELL``, DIN at B = 8 and 64
retrieval candidates) from a seed, in float32.  Each tolerance states its
reason.
"""
import json
import tempfile

import numpy as np
import pytest

pytest.importorskip("torch")

from tests._torch_ranks import Job  # noqa: E402

ARCHS = ["gcn-cora", "schnet", "dimenet", "meshgraphnet"]
TRAIN_OPT = dict(lr=3e-3, warmup_steps=2)
DIN_B, DIN_C = 8, 64

_SHARED = f"""
import json
ARCHS = {ARCHS!r}
TRAIN_OPT = json.loads({json.dumps(TRAIN_OPT)!r})
DIN_B, DIN_C = {DIN_B}, {DIN_C}


def fill(tree, rng):
    if isinstance(tree, dict):
        return {{k: fill(tree[k], rng) for k in sorted(tree)}}
    if isinstance(tree, (list, tuple)):
        return [fill(v, rng) for v in tree]
    shape = tuple(tree.shape)
    fan = shape[-2] if len(shape) >= 2 else shape[-1]
    return (rng.standard_normal(shape) / np.sqrt(fan)).astype(np.float32)


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {{}}
        for k in sorted(tree):
            out.update(flat(tree[k], prefix + k + "/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {{}}
        for i, v in enumerate(tree):
            out.update(flat(v, prefix + str(i) + "/"))
        return out
    return {{prefix[:-1]: np.asarray(tree, np.float32)}}


def gnn_batch(graphs, arch, cfg, seed):
    cell = gcfg.REDUCED_CELL
    b = graphs.synthetic_gnn_batch(
        arch, cell["n_nodes"], cell["n_edges"],
        d_feat=getattr(cfg, "in_dim", None) or cell["d_feat"],
        n_graphs=cell["n_graphs"], n_classes=cell["n_classes"],
        max_triplets=cell["n_triplets"],
        in_edge_dim=getattr(cfg, "in_edge_dim", 7),
        out_dim=getattr(cfg, "out_dim", 3),
        sbf_dim=getattr(cfg, "sbf_dim", 42), seed=seed)
    return b, b.pop("n_graphs", None)


def din_batches(rdata, cfg):
    b = rdata.din_batch(DIN_B, cfg.seq_len, cfg.n_items, cfg.n_cates,
                        cfg.n_tags, cfg.tag_bag_width, seed=0)
    rb = rdata.din_retrieval_batch(DIN_C, cfg.seq_len, cfg.n_items,
                                   cfg.n_cates, cfg.n_tags,
                                   cfg.tag_bag_width, seed=1)
    return b, rb
"""

_REF = """
import jax, jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs import gnn as gcfg, registry
from repro.data import graphs, recsys as rdata
from repro.launch.cells import din_rules, gnn_rules
from repro.models import gnn as jg, recsys as jr
from repro.train.optimizer import AdamWConfig, init_state
from repro.train.train_step import build_train_step
""" + _SHARED + """
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2,
                     devices=jax.devices()[:4])
INITS = {"gcn-cora": jg.gcn_init, "schnet": jg.schnet_init,
         "dimenet": jg.dimenet_init, "meshgraphnet": jg.mgn_init}
LOSSES = {"gcn-cora": jg.gcn_loss, "schnet": jg.schnet_loss,
          "dimenet": jg.dimenet_loss, "meshgraphnet": jg.mgn_loss}
LEAD = {"edge_src": "edges", "edge_dst": "edges", "edge_mask": "edges",
        "edge_dist": "edges", "edge_feat": "edges", "tri_kj": "triplets",
        "tri_ji": "triplets", "tri_mask": "triplets", "tri_sbf": "triplets"}
rules = gnn_rules(mesh)
rep = NamedSharding(mesh, P())
out = {}


def place(b, ng):
    def sh(k, v):
        if k == "labels" and ng is not None:
            return rep
        return rules.named_sharding(LEAD.get(k, "nodes"),
                                    *(None,) * (v.ndim - 1), shape=v.shape)
    return {k: jax.device_put(jnp.asarray(v), sh(k, v)) for k, v in b.items()}


for arch in ARCHS:
    cfg = registry.get(arch).make_reduced()
    tree = fill(INITS[arch](cfg, jax.random.PRNGKey(0)), np.random.default_rng(0))
    params = jax.tree.map(jnp.asarray, tree)
    b, ng = gnn_batch(graphs, arch, cfg, 0)
    with_ng = (lambda x: dict(x, n_graphs=ng)) if ng is not None else (lambda x: x)
    loss = lambda p, x: LOSSES[arch](p, with_ng(x), cfg, rules)
    l, gr = jax.jit(jax.value_and_grad(loss))(params, place(b, ng))
    out[arch + "/loss"] = np.float64(l)
    for k, v in flat(gr).items():
        out[arch + "/grad/" + k] = v
    opt = AdamWConfig(**TRAIN_OPT)
    step = jax.jit(build_train_step(loss, opt))
    state = init_state(opt, params)
    losses = []
    for seed in range(3):
        bs, _ = gnn_batch(graphs, arch, cfg, seed)
        params, state, m = step(params, state, place(bs, ng))
        losses.append(float(m["loss"]))
    out[arch + "/step_losses"] = np.array(losses)
    for k, v in flat(params).items():
        out[arch + "/step_params/" + k] = v

cfg = registry.get("din").make_reduced()
rules = din_rules(mesh)
tree = fill(jr.din_init(cfg, jax.random.PRNGKey(0)), np.random.default_rng(1))
psh = {k: (rules.named_sharding("rows", None, shape=np.shape(v))
           if k.endswith("_table") else jax.tree.map(lambda _: rep, v))
       for k, v in tree.items()}
params = jax.device_put(jax.tree.map(jnp.asarray, tree), psh)
b, rb = din_batches(rdata, cfg)
bsh = {k: rules.named_sharding("batch", *(None,) * (np.ndim(v) - 1),
                               shape=np.shape(v)) for k, v in b.items()}
jb = jax.device_put({k: jnp.asarray(v) for k, v in b.items()}, bsh)
out["din/logits"] = np.asarray(jax.jit(
    lambda p, x: jr.din_logits(p, x, cfg, rules))(params, jb))
l, gr = jax.jit(jax.value_and_grad(
    lambda p, x: jr.din_loss(p, x, cfg, rules)))(params, jb)
out["din/loss"] = np.float64(l)
for k, v in flat(gr).items():
    out["din/grad/" + k] = v
rsh = {k: (rules.named_sharding("candidates", shape=np.shape(v))
           if k.startswith("cand") else rep) for k, v in rb.items()}
jrb = jax.device_put({k: jnp.asarray(v) for k, v in rb.items()}, rsh)
out["din/scores"] = np.asarray(jax.jit(
    lambda p, x: jr.din_retrieval_scores(p, x, cfg, rules))(params, jrb))
np.savez(OUT, **out)
"""

_PORT = """
from repro_torch.configs import gnn as gcfg, registry
from repro_torch.data import graphs, recsys as rdata
from repro_torch.distributed import collectives as C
from repro_torch.launch.cells import din_rules, gnn_rules
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import gnn as g, recsys as r, transformer as tr
from repro_torch.models.sharding import whole
from repro_torch.train.checkpoint import named_leaves
from repro_torch.train.optimizer import AdamWConfig, init_state
from repro_torch.train.train_step import build_train_step
""" + _SHARED + """
mesh = make_host_mesh((2, 2), ("data", "model"), device="cpu")
rules = gnn_rules(mesh)
out = {}


def grads(loss_fn, params):
    leaves = named_leaves(params)
    for _, p in leaves:
        p.requires_grad_(True)
    loss = loss_fn(params)
    gs = torch.autograd.grad(loss, [p for _, p in leaves], allow_unused=True)
    for _, p in leaves:
        p.requires_grad_(False)
    return loss.detach(), {k: (torch.zeros_like(p) if x is None else whole(x))
                           for (k, p), x in zip(leaves, gs)}


def tensors(b, ng):
    t = {k: torch.from_numpy(v) for k, v in b.items()}
    if ng is not None:
        t["n_graphs"] = ng
    return t


def bits(tree):
    return [v.detach().clone() for _, v in named_leaves(tree)]


FORWARDS = {"gcn-cora": g.gcn_forward, "schnet": g.schnet_forward,
            "dimenet": g.dimenet_forward, "meshgraphnet": g.mgn_forward}
for arch in ARCHS:
    cfg = registry.get(arch).make_reduced()
    tree = fill(g.INITS[arch](cfg, None, "meta"), np.random.default_rng(0))
    params = g.params_from_numpy(arch, tree, cfg, "cpu")
    b, ng = gnn_batch(graphs, arch, cfg, 0)
    tb = tensors(b, ng)
    with torch.no_grad():
        y0 = FORWARDS[arch](params, tb, cfg)
        y1 = FORWARDS[arch](params, tb, cfg, rules)
    if arch in ("gcn-cora", "meshgraphnet"):       # this rank's nodes
        y1 = C.gather(y1, mesh, ("data", "model"), 0)
    out[arch + "/forward"] = y0.numpy()
    out[arch + "/sharded_forward"] = y1.numpy()
    l0, g0 = grads(lambda p: g.LOSSES[arch](p, tb, cfg), params)
    l1, g1 = grads(lambda p: g.LOSSES[arch](p, tb, cfg, rules), params)
    out[arch + "/loss"] = np.float64(l0)
    out[arch + "/sharded_loss"] = np.float64(l1)
    for k in g0:
        out[arch + "/grad/" + k] = g0[k].numpy()
        out[arch + "/sharded_grad/" + k] = g1[k].numpy()
    opt = AdamWConfig(**TRAIN_OPT)
    step = build_train_step(lambda p, x: g.LOSSES[arch](p, x, cfg, rules), opt)
    runs = []
    for _ in range(2):                 # the first step twice, bit for bit
        p = g.params_from_numpy(arch, tree, cfg, "cpu")
        p, s, m = step(p, init_state(opt, p), tb)
        runs.append(bits(p) + bits(s) + [m["loss"], m["grad_norm"]])
    out[arch + "/same_bits"] = np.bool_(all(
        torch.equal(a, b_) for a, b_ in zip(*runs)))
    losses = [float(m["loss"])]
    for seed in (1, 2):
        bs, _ = gnn_batch(graphs, arch, cfg, seed)
        p, s, m = step(p, s, tensors(bs, ng))
        losses.append(float(m["loss"]))
    out[arch + "/step_losses"] = np.array(losses)
    for k, v in named_leaves(p):
        out[arch + "/step_params/" + k] = v.detach().numpy()

cfg = registry.get("din").make_reduced()
rules = din_rules(mesh)
tree = fill(r.din_init(cfg, None, "meta"), np.random.default_rng(1))
params = r.params_from_numpy(tree, cfg, "cpu")
shardings = {k: (rules.named_sharding("rows", None, shape=v.shape)
                 if k.endswith("_table") else {n: None for n in v})
             for k, v in params.items()}
sp = tr.shard_params(params, shardings)
b, rb = din_batches(rdata, cfg)
tb = {k: torch.from_numpy(v) for k, v in b.items()}
trb = {k: torch.from_numpy(v) for k, v in rb.items()}
with torch.no_grad():
    out["din/logits"] = r.din_logits(params, tb, cfg).numpy()
    out["din/sharded_logits"] = whole(r.din_logits(sp, tb, cfg, rules)).numpy()
    out["din/scores"] = r.din_retrieval_scores(params, trb, cfg,
                                               chunk=None).numpy()
    out["din/sharded_scores"] = whole(r.din_retrieval_scores(
        sp, trb, cfg, rules, chunk=4)).numpy()
    out["din/table_block"] = np.array(sp["item_table"].to_local().shape)
l0, g0 = grads(lambda p: r.din_loss(p, tb, cfg), params)
l1, g1 = grads(lambda p: r.din_loss(p, tb, cfg, rules), sp)
out["din/loss"] = np.float64(l0)
out["din/sharded_loss"] = np.float64(l1)
for k in g0:
    out["din/grad/" + k] = g0[k].numpy()
    out["din/sharded_grad/" + k] = g1[k].numpy()
if RANK == 0:
    np.savez(OUT, **out)
"""


@pytest.fixture(scope="module")
def runs():
    with tempfile.TemporaryDirectory() as d:
        jobs = {"ref": Job("ref", d, _REF, devices=4),
                "port": Job("port", d, _PORT, ranks=4)}
        try:
            yield {k: j.result() for k, j in jobs.items()}
        finally:
            for j in jobs.values():
                j.kill()


def _rel(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _grad_keys(res, prefix):
    return sorted(k[len(prefix):] for k in res if k.startswith(prefix))


@pytest.mark.parametrize("arch", ARCHS)
def test_gnn_on_a_mesh_forward_and_loss(runs, arch):
    """The sharded forward (its node blocks gathered) within rel 1e-5 of
    its max of the unsharded one, and the loss within rel 1e-5 of the
    unsharded port's and of the reference's sharded program's: float32
    sums in other orders (each shard's partial sums, then their sum)."""
    port, ref = runs["port"], runs["ref"]
    assert _rel(port[arch + "/sharded_forward"], port[arch + "/forward"]) \
        <= 1e-5
    loss = port[arch + "/sharded_loss"]
    assert loss == pytest.approx(float(port[arch + "/loss"]), rel=1e-5)
    assert loss == pytest.approx(float(ref[arch + "/loss"]), rel=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_gnn_on_a_mesh_grads(runs, arch):
    """Every gradient leaf (each rank's, after the all-reduce of the
    replicated parameters' gradients) within 1e-4 of its leaf's max of the
    unsharded port's and of the reference's sharded program's
    (``test_torch_gnn``'s bar against the reference)."""
    port, ref = runs["port"], runs["ref"]
    keys = _grad_keys(port, arch + "/sharded_grad/")
    assert keys == _grad_keys(ref, arch + "/grad/")
    for k in keys:
        got = port[arch + "/sharded_grad/" + k]
        for want in (port[arch + "/grad/" + k], ref[arch + "/grad/" + k]):
            err = np.abs(got - want).max()
            assert err <= 1e-4 * np.abs(want).max(), (k, err)


@pytest.mark.parametrize("arch", ARCHS)
def test_gnn_on_a_mesh_train_steps(runs, arch):
    """Three sharded train steps against the reference's sharded steps at
    ``test_torch_gnn``'s bars (losses rel 1e-4; each parameter within
    2·Σ lr plus rel 1e-4 of its leaf's max, 99.9% of the entries within
    1e-5 of the max plus 1e-4·Σ lr), and the first step run twice from the
    same state gives the same bits (fixed-order sums, no atomics)."""
    port, ref = runs["port"], runs["ref"]
    assert bool(port[arch + "/same_bits"])
    np.testing.assert_allclose(port[arch + "/step_losses"],
                               ref[arch + "/step_losses"], rtol=1e-4)
    lr_sum = sum(TRAIN_OPT["lr"] * min(1.0, (t + 1) / TRAIN_OPT["warmup_steps"])
                 for t in range(3))
    keys = _grad_keys(port, arch + "/step_params/")
    assert keys == _grad_keys(ref, arch + "/step_params/")
    for k in keys:
        want = ref[arch + "/step_params/" + k]
        gap = np.abs(port[arch + "/step_params/" + k] - want)
        scale = np.abs(want).max()
        assert gap.max() <= 2 * lr_sum + 1e-4 * scale, (k, gap.max())
        assert np.mean(gap <= 1e-5 * scale + 1e-4 * lr_sum) >= 0.999, k


def test_din_on_a_mesh_logits_and_loss(runs):
    """DIN with its tables row-sharded over model (each rank a DTensor
    block of half the rows) and the batch over data: logits within rel
    1e-5 of their max, and the loss within rel 1e-5, of the unsharded
    port's and the reference's sharded program's (the vocab-parallel
    lookup adds one nonzero row to zeros: exact; the loss sums over the
    data shards in another order)."""
    port, ref = runs["port"], runs["ref"]
    assert tuple(port["din/table_block"]) == (2500, 18)
    for want in (port["din/logits"], ref["din/logits"]):
        assert _rel(port["din/sharded_logits"], want) <= 1e-5
    loss = port["din/sharded_loss"]
    assert loss == pytest.approx(float(port["din/loss"]), rel=1e-5)
    assert loss == pytest.approx(float(ref["din/loss"]), rel=1e-5)


def test_din_on_a_mesh_grads(runs):
    """Every gradient leaf, the tables' blocks gathered, within 1e-4 of
    its leaf's max of the unsharded port's and the reference's sharded
    program's (the MLPs' gradients all-reduced over data)."""
    port, ref = runs["port"], runs["ref"]
    keys = _grad_keys(port, "din/sharded_grad/")
    assert keys == _grad_keys(ref, "din/grad/")
    for k in keys:
        got = port["din/sharded_grad/" + k]
        for want in (port["din/grad/" + k], ref["din/grad/" + k]):
            err = np.abs(got - want).max()
            assert err <= 1e-4 * np.abs(want).max(), (k, err)


def test_din_on_a_mesh_retrieval(runs):
    """Retrieval scores with the candidates over all four ranks (their ids
    gathered over model for the row-sharded lookup, scored in chunks of
    4): within 2e-4 (the reference test's bar) of the unsharded port's
    one-shot scores and of the reference's sharded program's."""
    port, ref = runs["port"], runs["ref"]
    got = port["din/sharded_scores"]
    assert got.shape == (DIN_C,)
    for want in (port["din/scores"], ref["din/scores"]):
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
