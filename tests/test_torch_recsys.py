"""The port's DIN, its data and config, and the EmbeddingBag layers against
the JAX package, on the CPU.

On the reduced config and the reference's parameters carried over with
``recsys.params_from_numpy``: logits, loss and every gradient leaf against
``jax.grad``, three train steps against the reference's
``build_train_step``, retrieval scores against the reference's and
chunked against unchunked, and the reference tests' properties (five AdamW
steps lower the loss, retrieval equals pointwise scoring).  The click-log
builders and shape tables equal the reference's.  Each tolerance states its
reason."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import din_cfg as jdin_cfg  # noqa: E402
from repro.configs import registry as jregistry  # noqa: E402
from repro.data import recsys as jdata  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import recsys as jr  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train.train_step import build_train_step as jbuild  # noqa: E402

from repro_torch.configs import din_cfg  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.data import recsys as data  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import recsys as r  # noqa: E402
from repro_torch.distributed.collectives import release_world  # noqa: E402
from repro_torch.launch.cells import din_rules  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models.sharding import whole  # noqa: E402
from repro_torch.train.checkpoint import named_leaves  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig, init_state  # noqa: E402
from repro_torch.train.train_step import build_train_step  # noqa: E402


def _setup():
    jcfg = jregistry.get("din").make_reduced()
    cfg = registry.get("din").make_reduced()
    jparams = jr.din_init(jcfg, jax.random.PRNGKey(0))
    params = r.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                 device="cpu")
    return jcfg, cfg, jparams, params


def _batch(cfg, n=32, seed=0):
    b = data.din_batch(n, cfg.seq_len, cfg.n_items, cfg.n_cates, cfg.n_tags,
                       cfg.tag_bag_width, seed=seed)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _retrieval(cfg, n_cand=16, seed=1):
    b = data.din_retrieval_batch(n_cand, cfg.seq_len, cfg.n_items,
                                 cfg.n_cates, cfg.n_tags, cfg.tag_bag_width,
                                 seed=seed)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def test_din_logits_and_loss_match_jax():
    """Logits within rel 1e-5 of their max, loss within rel 1e-5 (float32
    sums in other orders: the MLPs, the attention-weighted sum)."""
    jcfg, cfg, jparams, params = _setup()
    jb, tb = _batch(cfg)
    want = np.asarray(jr.din_logits(jparams, jb, jcfg))
    got = r.din_logits(params, tb, cfg).numpy()
    assert got.shape == want.shape == (32,)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert float(r.din_loss(params, tb, cfg)) == pytest.approx(
        float(jr.din_loss(jparams, jb, jcfg)), rel=1e-5)


def test_din_grads_match_jax():
    """Every gradient leaf (the three tables' included, dense as the
    reference's) within 1e-4 of its leaf's max against ``jax.grad``."""
    jcfg, cfg, jparams, params = _setup()
    jb, tb = _batch(cfg)
    jgrads = jax.grad(lambda p: jr.din_loss(p, jb, jcfg))(jparams)
    leaves = named_leaves(params)
    for _, p in leaves:
        p.requires_grad_(True)
    grads = torch.autograd.grad(r.din_loss(params, tb, cfg),
                                [p for _, p in leaves])
    want = dict(named_leaves(jax.tree.map(np.asarray, jgrads)))
    assert [k for k, _ in leaves] == list(want)
    for (key, _), gr in zip(leaves, grads):
        assert gr.shape == want[key].shape
        scale = np.abs(want[key]).max()
        assert np.abs(gr.numpy() - want[key]).max() <= 1e-4 * scale, key


def test_din_train_steps_match_jax():
    """Three train steps on batches at seeds 0, 1, 2 (as the launcher):
    losses within rel 1e-4, parameters at ``test_torch_gnn``'s train-step
    bar (within 2·Σ lr plus rel 1e-4 of the leaf's max; 99.9% within 1e-5
    of the max plus 1e-4·Σ lr)."""
    opt = dict(lr=3e-3, warmup_steps=2)
    jcfg, cfg, jparams, params = _setup()
    jstate = jopt.init_state(jopt.AdamWConfig(**opt), jparams)
    state = init_state(AdamWConfig(**opt), params)
    jstep = jax.jit(jbuild(lambda p, b: jr.din_loss(p, b, jcfg),
                           jopt.AdamWConfig(**opt)))
    step = build_train_step(lambda p, b: r.din_loss(p, b, cfg),
                            AdamWConfig(**opt))
    jlosses, losses = [], []
    for seed in range(3):
        jb, tb = _batch(cfg, 8, seed)
        jparams, jstate, jm = jstep(jparams, jstate, jb)
        params, state, m = step(params, state, tb)
        jlosses.append(float(jm["loss"]))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    lr_sum = sum(opt["lr"] * min(1.0, (t + 1) / opt["warmup_steps"])
                 for t in range(3))
    want = dict(named_leaves(jax.tree.map(np.asarray, jparams)))
    for key, p in named_leaves(params):
        scale = np.abs(want[key]).max()
        gap = np.abs(p.detach().numpy() - want[key])
        assert gap.max() <= 2 * lr_sum + 1e-4 * scale, (key, gap.max())
        assert np.mean(gap <= 1e-5 * scale + 1e-4 * lr_sum) >= 0.999, key


def test_din_smoke_and_training():
    """The reference's property on the port's own init: five AdamW steps
    (lr 1e-2, warm-up 1) on one batch lower its loss."""
    cfg = registry.get("din").make_reduced()
    params = r.din_init(cfg, torch.Generator().manual_seed(0), "cpu")
    _, b = _batch(cfg)
    loss0 = float(r.din_loss(params, b, cfg))
    assert np.isfinite(loss0)
    oc = AdamWConfig(lr=1e-2, warmup_steps=1)
    step = build_train_step(lambda p, bb: r.din_loss(p, bb, cfg), oc)
    state = init_state(oc, params)
    for _ in range(5):
        params, state, _ = step(params, state, b)
    with torch.no_grad():
        assert float(r.din_loss(params, b, cfg)) < loss0


def test_din_retrieval_matches_reference_and_pointwise():
    """Retrieval scores: the reference's within rel 1e-5 of their max;
    chunks of 5 (and of 1) within 1e-6 of one pass (each candidate's row
    alone: the chunks change only the matmuls' shapes); and ``din_logits``
    on the tiled batch within 2e-4, the reference test's bar."""
    jcfg, cfg, jparams, params = _setup()
    jb, tb = _retrieval(cfg)
    want = np.asarray(jr.din_retrieval_scores(jparams, jb, jcfg))
    whole = r.din_retrieval_scores(params, tb, cfg, chunk=None)
    assert whole.shape == (16,)
    assert np.abs(whole.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    for chunk in (5, 1):
        np.testing.assert_allclose(
            r.din_retrieval_scores(params, tb, cfg, chunk=chunk).numpy(),
            whole.numpy(), rtol=1e-6, atol=1e-6)
    C = tb["cand_items"].shape[0]
    pb = {"hist_items": tb["hist_items"].repeat(C, 1),
          "hist_cates": tb["hist_cates"].repeat(C, 1),
          "hist_mask": tb["hist_mask"].repeat(C, 1),
          "target_item": tb["cand_items"], "target_cate": tb["cand_cates"],
          "profile_tags": tb["profile_tags"].repeat(C, 1),
          "profile_mask": tb["profile_mask"].repeat(C, 1)}
    np.testing.assert_allclose(whole.numpy(),
                               r.din_logits(params, pb, cfg).numpy(),
                               rtol=2e-4, atol=2e-4)


def test_din_param_tree_and_rules():
    """The port's init is the reference's tree (full config on ``meta``:
    the 100M-row table takes no storage); ``din_rules`` on a mesh of one
    rank (a gloo world of one) gives the unsharded logits, loss and scores
    bit for bit (every collective the identity); a wrong tree is
    refused."""
    full, jfull = registry.get("din").make_config(), \
        jregistry.get("din").make_config()
    ours = r.din_init(full, None, "meta")
    theirs = jax.eval_shape(lambda: jr.din_init(jfull, jax.random.PRNGKey(0)))
    assert [(k, tuple(t.shape)) for k, t in named_leaves(ours)] == \
        [(k, tuple(t.shape)) for k, t in named_leaves(theirs)]
    assert ours["item_table"].shape == (100_000_000, 18)
    jcfg, cfg, jparams, params = _setup()
    _, tb = _batch(cfg, 4)
    _, rb = _retrieval(cfg, 3)
    try:
        rules = din_rules(make_host_mesh((1, 1), device="cpu"))
        assert rules.axes("rows") == ("model",)
        for fn, b in ((r.din_logits, tb), (r.din_loss, tb),
                      (r.din_retrieval_scores, rb)):
            assert torch.equal(whole(fn(params, b, cfg, rules)),
                               fn(params, b, cfg))
    finally:
        release_world()
    tree = jax.tree.map(np.asarray, jparams)
    tree["attn"]["w"] = tree["attn"]["w"][:-1]
    with pytest.raises(ValueError, match="parameter tree"):
        r.params_from_numpy(tree, cfg, device="cpu")


def test_embedding_bag_modes_match_reference():
    """``embedding_bag`` (sum, mean, max) and ``embedding_bag_ragged``
    (with and without weights): ``test_models_lm.py``'s cases, then random
    bags against the reference's values and gradients (max fills padding
    with NEG_INF; an all-padding bag's mean divides by 1)."""
    table = torch.arange(20, dtype=torch.float32).reshape(10, 2)
    ids = torch.tensor([[1, 2, 0], [3, 3, 3]], dtype=torch.int32)
    mask = torch.tensor([[1, 1, 0], [1, 0, 0]], dtype=torch.float32)
    s = layers.embedding_bag(table, ids, mask, "sum")
    assert torch.equal(s[0], table[1] + table[2])
    assert torch.equal(s[1], table[3])
    m = layers.embedding_bag(table, ids, mask, "mean")
    assert torch.equal(m[0], (table[1] + table[2]) / 2)
    rg = layers.embedding_bag_ragged(table, torch.tensor([1, 2, 3]),
                                     torch.tensor([0, 0, 1]), 2)
    assert torch.equal(rg[0], table[1] + table[2])
    assert torch.equal(rg[1], table[3])

    rng = np.random.default_rng(4)
    tab = rng.standard_normal((30, 6)).astype(np.float32)
    ids = rng.integers(0, 30, (9, 5)).astype(np.int32)
    msk = (rng.random((9, 5)) < 0.6).astype(np.float32)
    msk[0] = 0.0                                   # an empty bag
    for mode in ("sum", "mean", "max"):
        jf = lambda t: jlayers.embedding_bag(t, jnp.asarray(ids),
                                             jnp.asarray(msk), mode)
        want, jvjp = jax.vjp(jf, jnp.asarray(tab))
        t = torch.from_numpy(tab).requires_grad_(True)
        got = layers.embedding_bag(t, torch.from_numpy(ids),
                                   torch.from_numpy(msk), mode)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
        gy = rng.standard_normal(got.shape).astype(np.float32)
        (gt,) = torch.autograd.grad(got, t, torch.from_numpy(gy))
        np.testing.assert_allclose(gt.numpy(),
                                   np.asarray(jvjp(jnp.asarray(gy))[0]),
                                   rtol=1e-6, atol=1e-6)
    flat = rng.integers(0, 30, 20).astype(np.int32)
    seg = np.sort(rng.integers(0, 6, 20)).astype(np.int32)
    wts = rng.standard_normal(20).astype(np.float32)
    for w in (None, wts):
        want = jlayers.embedding_bag_ragged(
            jnp.asarray(tab), jnp.asarray(flat), jnp.asarray(seg), 7,
            None if w is None else jnp.asarray(w))
        got = layers.embedding_bag_ragged(
            torch.from_numpy(tab), torch.from_numpy(flat),
            torch.from_numpy(seg), 7, None if w is None else torch.from_numpy(w))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    x = rng.standard_normal((5, 3)).astype(np.float32)
    ws = [rng.standard_normal((3, 4)).astype(np.float32),
          rng.standard_normal((4, 2)).astype(np.float32)]
    bs = [rng.standard_normal(4).astype(np.float32),
          rng.standard_normal(2).astype(np.float32)]
    for final in (False, True):
        want = jlayers.mlp(jnp.asarray(x), [jnp.asarray(w) for w in ws],
                           [jnp.asarray(b) for b in bs], final_act=final)
        got = layers.mlp(torch.from_numpy(x), [torch.from_numpy(w) for w in ws],
                         [torch.from_numpy(b) for b in bs], final_act=final)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


def test_din_data_match_reference():
    """``din_batch`` and ``din_retrieval_batch`` array-equal to the
    reference's (the reduced and the full tables' id ranges), and the shape
    tables equal."""
    for args in ((32, 12, 5000, 200, 100, 4, 0), (7, 100, 100_000_000,
                                                  1_000_000, 100_000, 16, 3)):
        a, b = data.din_batch(*args), jdata.din_batch(*args)
        assert list(a) == list(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for args in ((16, 12, 5000, 200, 100, 4, 1), (1000, 100, 100_000_000,
                                                  1_000_000, 100_000, 16, 2)):
        a, b = data.din_retrieval_batch(*args), jdata.din_retrieval_batch(*args)
        assert list(a) == list(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for kw in (dict(batch=65536, seq_len=100), dict(batch=512, seq_len=100,
                                                    with_labels=False)):
        assert data.din_batch_shapes(**kw) == jdata.din_batch_shapes(**kw)
    assert data.din_retrieval_shapes(1_000_000, 100) == \
        jdata.din_retrieval_shapes(1_000_000, 100)


def test_din_config_and_registry_match_reference():
    """DIN_CELLS, DIN_SHAPES, the full and reduced configs, the registry
    entry and the thin module ``configs/din.py``, field for field the
    reference's (dtype by name)."""
    from repro.configs import din as jdin_mod

    from repro_torch.configs import din as din_mod

    def d(cfg):
        out = dataclasses.asdict(cfg)
        dt = out.pop("dtype")
        out["dtype"] = str(dt).removeprefix("torch.") \
            if isinstance(dt, torch.dtype) else np.dtype(dt).name
        return out

    assert din_cfg.DIN_CELLS == jdin_cfg.DIN_CELLS
    assert din_cfg.DIN_SHAPES == jdin_cfg.DIN_SHAPES
    assert d(din_cfg.din()) == d(jdin_cfg.din())
    assert d(din_cfg.reduced_din()) == d(jdin_cfg.reduced_din())
    e, je = registry.get("din"), jregistry.get("din")
    assert (e.arch_id, e.family, e.cells, e.shapes) == \
        (je.arch_id, je.family, je.cells, je.shapes)
    assert din_mod.ARCH_ID == jdin_mod.ARCH_ID == "din"
    assert d(din_mod.config()) == d(jdin_mod.config())
    assert d(din_mod.reduced()) == d(jdin_mod.reduced())
    assert tuple(din_mod.cells()) == tuple(jdin_mod.cells())
    assert r.DINConfig(dtype="bfloat16").dtype == torch.bfloat16
