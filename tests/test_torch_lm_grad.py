"""The port's LM gradients against the JAX package, on the CPU.

The same seeded inputs (numpy) and the same weights (the JAX init, carried
over by ``params_from_numpy``) go through both packages: the flash backward
(``FlashAttention``) against ``jax.grad`` of the reference's custom VJP and
against autograd through a dense attention; ``lm_loss`` and every
parameter's gradient against ``jax.value_and_grad`` of the reference's
``lm_loss`` for the five LM archs' reduced configs; ``remat`` against no
remat; and the kernel route refusing grad.  Each tolerance states its
reason."""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import lm as jlm  # noqa: E402
from repro.models import layers as jnn  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402

from repro_torch.configs import lm as plm  # noqa: E402
from repro_torch.models import layers as nn  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.train.optimizer import named_leaves  # noqa: E402

LM_IDS = list(jlm.LM_ARCHS)


def _rel_err(got, want):
    """max |got − want| over max |want|: the error against the array's own
    scale."""
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    scale = np.abs(want).max()
    return np.abs(got - want).max() / (scale if scale > 0 else 1.0)


def _qkv(rng, B, Sq, Sk, H, KV, D):
    return (rng.standard_normal((B, Sq, H, D)).astype(np.float32),
            rng.standard_normal((B, Sk, KV, D)).astype(np.float32),
            rng.standard_normal((B, Sk, KV, D)).astype(np.float32),
            rng.standard_normal((B, Sq, H, D)).astype(np.float32))


def _port_grads(q, k, v, w, **kw):
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = nn.flash_attention(tq, tk, tv, **kw)
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach(), (tq.grad, tk.grad, tv.grad)


# -- the flash backward ------------------------------------------------------

# (B, Sq, Sk, H, KV, D, causal, window, q_offset): causal and full; windowed
# on the banded path (window + q_chunk < Sk) and off it; G = 3, 2, 1 and 4;
# q_offset > 0 (the queries are the last Sq of Sk positions)
FLASH_CASES = [
    (2, 48, 48, 6, 2, 16, True, None, 0),
    (2, 48, 48, 6, 2, 16, False, None, 0),
    (2, 64, 64, 4, 2, 8, True, 12, 0),
    (1, 64, 64, 4, 1, 8, True, 40, 0),
    (1, 64, 64, 4, 4, 8, True, 56, 0),
    (1, 32, 64, 4, 2, 8, True, None, 32),
    (2, 32, 64, 8, 2, 8, False, None, 16),
]


@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,causal,window,q_offset", FLASH_CASES)
def test_flash_backward_matches_jax_custom_vjp(B, Sq, Sk, H, KV, D, causal,
                                               window, q_offset):
    """dq, dk and dv of the port's ``FlashAttention`` against ``jax.grad``
    of the reference's ``flash_attention`` (its custom VJP), chunk 16, of a
    weighted sum of the output.  rel 1e-5 of each gradient's max: the same
    float32 tiles, summed by other BLAS orders."""
    rng = np.random.default_rng(B * Sq + Sk + H + (window or 0) + q_offset)
    q, k, v, w = _qkv(rng, B, Sq, Sk, H, KV, D)
    kw = dict(causal=causal, window=window, q_offset=q_offset, q_chunk=16,
              k_chunk=16)

    def jloss(a, b, c):
        return (jnn.flash_attention(a, b, c, **kw) * w).sum()

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v))
    out, grads = _port_grads(q, k, v, w, **kw)
    jout = jnn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               **kw)
    assert _rel_err(out, jout) <= 1e-5
    for name, got, want in zip("qkv", grads, jg):
        assert got.dtype == torch.float32
        err = _rel_err(got, want)
        assert err <= 1e-5, (name, err)


def _dense(q, k, v, window):
    B, S, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    qr = q.reshape(B, S, KV, G, D)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qr, k) / math.sqrt(D)
    pos = torch.arange(S)
    msk = pos[None, :] <= pos[:, None]
    if window:
        msk &= pos[None, :] > pos[:, None] - window
    logits = torch.where(msk[None, None, None], logits, -1e30)
    p = torch.softmax(logits, -1)
    return torch.movedim(torch.einsum("bkgqs,bskd->bkgqd", p, v), -2, 1
                         ).reshape(B, S, H, D)


@pytest.mark.parametrize("window", [None, 12])
def test_flash_attention_matches_dense(window):
    """The reference's ``test_flash_attention_matches_dense`` on the port:
    output (2e-5) and the gradients of Σ out² (5e-4) against autograd
    through a dense softmax attention."""
    rng = np.random.default_rng(0)
    B, S, H, KV, D = 2, 48, 6, 2, 16
    q, k, v, _ = _qkv(rng, B, S, S, H, KV, D)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = nn.flash_attention(tq, tk, tv, causal=True, window=window,
                             q_chunk=16, k_chunk=16)
    dq, dk, dv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    ref = _dense(dq, dk, dv, window)
    np.testing.assert_allclose(out.detach(), ref.detach(), rtol=2e-5,
                               atol=2e-5)
    g = torch.autograd.grad((out ** 2).sum(), (tq, tk, tv))
    gr = torch.autograd.grad((ref ** 2).sum(), (dq, dk, dv))
    for a, b in zip(g, gr):
        np.testing.assert_allclose(a, b, rtol=5e-4, atol=5e-4)


def test_flash_function_saves_inputs_and_output_only():
    """The autograd graph of the recomputing backward holds q, k, v, out
    and lse (two chunks' worth of tiles would be O(S²)); bf16 inputs get
    bf16 gradients."""
    rng = np.random.default_rng(3)
    q, k, v, _ = _qkv(rng, 1, 64, 64, 4, 2, 8)
    tq, tk, tv = (torch.tensor(a).to(torch.bfloat16).requires_grad_()
                  for a in (q, k, v))
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = nn.flash_attention(tq, tk, tv, q_chunk=16, k_chunk=16)
    assert sorted(saved) == sorted([(1, 64, 2, 2, 8), (1, 64, 2, 8),
                                    (1, 64, 2, 8), (1, 64, 2, 2, 8),
                                    (1, 2, 2, 64)])
    out.float().sum().backward()
    assert all(t.grad.dtype == torch.bfloat16 for t in (tq, tk, tv))


def test_flash_attention_without_grad_takes_the_plain_forward():
    """Under ``no_grad`` (serving) the call builds no graph and gives the
    plain forward's numbers; with grad, the same numbers and a graph."""
    rng = np.random.default_rng(4)
    q, k, v, _ = _qkv(rng, 2, 32, 32, 4, 2, 8)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    with torch.no_grad():
        served = nn.flash_attention(tq, tk, tv, q_chunk=16, k_chunk=16)
        plain, _ = nn._flash_fwd_impl(tq.reshape(2, 32, 2, 2, 8), tk, tv,
                                      causal=True, window=None, q_offset=0,
                                      q_chunk=16, k_chunk=16,
                                      scale=1.0 / math.sqrt(8))
    assert served.grad_fn is None
    assert torch.equal(served, plain.reshape(2, 32, 4, 8))
    out = nn.flash_attention(tq, tk, tv, q_chunk=16, k_chunk=16)
    assert out.grad_fn is not None
    assert torch.equal(out.detach(), served)


def test_use_pallas_under_grad_raises():
    """The kernel route has no backward: with an input that requires grad
    it raises, for the layer call and for the model's loss; without grad it
    runs (its plain version, on CPU tensors)."""
    rng = np.random.default_rng(5)
    q, k, v, _ = _qkv(rng, 1, 32, 32, 4, 2, 8)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    with pytest.raises(RuntimeError, match="no backward"):
        nn.flash_attention(tq, tk, tv, q_chunk=16, k_chunk=16,
                           use_pallas=True)
    with torch.no_grad():
        nn.flash_attention(tq, tk, tv, q_chunk=16, k_chunk=16,
                           use_pallas=True)
    cfg = dataclasses.replace(plm.reduced_lm("qwen2-1.5b"),
                              use_pallas_attention=True)
    model = tr.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    model.requires_grad_(True)
    toks = torch.as_tensor(np.random.default_rng(6).integers(
        0, cfg.vocab, (2, 32)))
    with pytest.raises(RuntimeError, match="no backward"):
        tr.lm_loss(model.tree(), toks, cfg)


# -- lm_loss and every parameter's gradient ------------------------------------

def _loss_and_grads(arch, seed=0, **replace):
    kw = dict(dataclasses.asdict(jlm.reduced_lm(arch)))
    moe = kw.pop("moe")
    kw.update(replace)
    jcfg = jtr.LMConfig(**kw, moe=jtr.MoECfg(**moe) if moe else None)
    cfg = tr.LMConfig(**kw, moe=tr.MoECfg(**moe) if moe else None)
    jparams = jtr.init_params(jcfg, jax.random.PRNGKey(seed))
    toks = np.random.default_rng(seed + 1).integers(
        0, cfg.vocab, (2, 32)).astype(np.int32)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jtr.lm_loss(p, jnp.asarray(toks), jcfg))(jparams)
    params = tr.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                  device="cpu").tree()
    return cfg, params, toks, jloss, jgrads


def _port_loss_grads(params, toks, cfg):
    leaves = named_leaves(params)
    for _, p in leaves:
        p.requires_grad_(True)
    loss = tr.lm_loss(params, torch.as_tensor(toks), cfg)
    grads = torch.autograd.grad(loss, [p for _, p in leaves])
    return loss.detach(), {key: g for (key, _), g in zip(leaves, grads)}


@pytest.mark.parametrize("arch", LM_IDS)
def test_lm_loss_and_every_gradient_match_jax(arch):
    """``lm_loss`` (rel 1e-5: float32 sums in other orders) and the gradient
    of every parameter, embed and norms included, within 1e-4 of the leaf's
    max |grad| (2e-4 for MoE, whose gates pass through a softmax and a
    renormalization more) against ``jax.value_and_grad`` of the reference's
    ``lm_loss`` on the same weights and tokens."""
    cfg, params, toks, jloss, jgrads = _loss_and_grads(arch)
    loss, grads = _port_loss_grads(params, toks, cfg)
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert float(loss) == pytest.approx(math.log(cfg.vocab), rel=0.25)
    jflat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(g)
             for path, g in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    assert sorted(jflat) == sorted(grads)
    tol = 2e-4 if cfg.moe else 1e-4
    for key, g in grads.items():
        assert g.shape == jflat[key].shape, key
        assert np.isfinite(g.numpy()).all(), key
        err = _rel_err(g, jflat[key])
        assert err <= tol, (key, err)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "gemma3-27b"])
def test_remat_gives_the_same_loss_and_gradients(arch):
    """``remat=True`` (each group of ``period`` layers under
    ``torch.utils.checkpoint``; gemma3's 12 layers in 2 groups of 6,
    qwen2's 2 in 2 groups of 1) recomputes the same operations: loss and
    every gradient equal to ``remat=False``'s, bit for bit on the CPU."""
    cfg = plm.reduced_lm(arch)
    assert not cfg.remat
    gen = torch.Generator().manual_seed(7)
    params = tr.init_params(cfg, gen, device="cpu").tree()
    toks = np.random.default_rng(8).integers(0, cfg.vocab, (2, 32))
    loss0, grads0 = _port_loss_grads(params, toks, cfg)
    loss1, grads1 = _port_loss_grads(
        params, toks, dataclasses.replace(cfg, remat=True))
    assert torch.equal(loss0, loss1)
    for key in grads0:
        assert torch.equal(grads0[key], grads1[key]), key


def test_remat_wraps_the_groups_and_leaves_the_rest():
    """With 7 layers of period 3, two groups run under checkpoint and the
    last layer runs unwrapped; the loss and gradients equal remat=False's."""
    cfg = dataclasses.replace(plm.reduced_lm("qwen2-1.5b"), n_layers=7,
                              layer_pattern=("G", "G", "G"))
    params = tr.init_params(cfg, torch.Generator().manual_seed(9),
                            device="cpu").tree()
    toks = np.random.default_rng(10).integers(0, cfg.vocab, (2, 16))
    calls = []
    real = tr.checkpoint

    def spy(fn, *args, **kw):
        calls.append(args[2:4])
        return real(fn, *args, **kw)

    loss0, grads0 = _port_loss_grads(params, toks, cfg)
    tr.checkpoint = spy
    try:
        loss1, grads1 = _port_loss_grads(
            params, toks, dataclasses.replace(cfg, remat=True))
    finally:
        tr.checkpoint = real
    assert calls == [(0, 3), (3, 6)]
    assert torch.equal(loss0, loss1)
    assert all(torch.equal(grads0[k], grads1[k]) for k in grads0)


def test_forward_unbinds_the_stacks_once():
    """Each layer's parameters come from one ``unbind`` per stack, so the
    backward reaches each stack through one ``UnbindBackward`` (a single
    ``stack``), not one ``SelectBackward`` per layer."""
    cfg = plm.reduced_lm("qwen2-1.5b")
    model = tr.init_params(cfg, torch.Generator().manual_seed(11),
                           device="cpu")
    model.requires_grad_(True)
    toks = torch.as_tensor(np.random.default_rng(12).integers(
        0, cfg.vocab, (1, 16)))
    loss = tr.lm_loss(model.tree(), toks, cfg)
    stacks = {id(t): name for name, t in model.layers.items()}
    into = {}          # layer stack → the kinds of node that feed its grad
    seen, todo = set(), [loss.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        for nxt, _ in fn.next_functions:
            var = getattr(nxt, "variable", None)
            if var is not None and id(var) in stacks:
                into.setdefault(stacks[id(var)], []).append(type(fn).__name__)
            todo.append(nxt)
    assert into == {name: ["UnbindBackward0"] for name in model.layers}


def test_serving_numbers_unchanged_under_no_grad():
    """``forward`` with ``remat=True`` under ``no_grad`` (serving) gives the
    bits of ``remat=False``, and builds no graph."""
    cfg = dataclasses.replace(plm.reduced_lm("gemma3-27b"), remat=True)
    params = tr.init_params(cfg, torch.Generator().manual_seed(13),
                            device="cpu").tree()
    toks = torch.as_tensor(np.random.default_rng(14).integers(
        0, cfg.vocab, (2, 32)))
    with torch.no_grad():
        h1, _ = tr.forward(params, toks, cfg)
        h0, _ = tr.forward(params, toks, dataclasses.replace(cfg, remat=False))
    assert h1.grad_fn is None and torch.equal(h0, h1)
