"""The port's LM serving stack against the JAX package, on the CPU.

The same seeded inputs (numpy) and the same weights (the JAX init, carried
over by ``params_from_numpy``) go through both packages: the attention
kernel's plain version against ``flash_fwd_pallas`` in interpret mode, the
blockwise attention, prefill (with and without the kernel route), prefill
then decode on a windowed config, and the serving driver's greedy tokens.
Each tolerance states its reason."""
import dataclasses
import io
import math
import re
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import lm as jlm  # noqa: E402
from repro.data import lm as jdata  # noqa: E402
from repro.kernels.flash_attention import flash_fwd_pallas  # noqa: E402
from repro.models import layers as jnn  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402

from repro_torch.configs import lm as plm, registry  # noqa: E402
from repro_torch.data.lm import TokenStream, token_batch  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import lm_serve  # noqa: E402
from repro_torch.models import layers as nn  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402

LM_IDS = list(jlm.LM_ARCHS)


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x, dtype=np.float32)).to(dtype)


def _both(kw):
    """One kwargs dict → (JAX config, port config)."""
    return jtr.LMConfig(**kw), tr.LMConfig(**kw)


def _carry(jparams, cfg):
    return tr.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                device="cpu").tree()


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


# -- the kernel's plain version ---------------------------------------------

# the shapes of tests/test_flash_kernel.py's sweep; 3e-5 is its tolerance
# (float32 sums in another order)
@pytest.mark.parametrize("B,S,H,KV,D,qc,kc", [
    (1, 32, 2, 1, 8, 8, 8),
    (2, 64, 4, 2, 16, 16, 16),
    (2, 128, 6, 2, 32, 32, 64),
    (1, 96, 4, 4, 16, 48, 32),
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_fwd_ref_matches_pallas_kernel(B, S, H, KV, D, qc, kc, causal):
    rng = np.random.default_rng(B * S + H)
    G = H // KV
    q = rng.standard_normal((B * KV * G, S, D)).astype(np.float32)
    k = rng.standard_normal((B * KV, S, D)).astype(np.float32)
    v = rng.standard_normal((B * KV, S, D)).astype(np.float32)
    scale = 1.0 / math.sqrt(D)
    out, lse = flash_fwd_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                g_per_kv=G, causal=causal, q_chunk=qc,
                                k_chunk=kc, scale=scale, interpret=True)
    ops.reset_launches()
    got, got_lse = ops.flash_fwd(_t(q), _t(k), _t(v), g_per_kv=G,
                                 causal=causal, scale=scale)
    assert ops.launches["flash_fwd"] == 0        # CPU tensors: plain version
    assert got.dtype == torch.float32 and got_lse.shape == (B * KV * G, S)
    _close(got, out, 3e-5)
    _close(got_lse, lse, 3e-5)


def test_flash_fwd_ref_matches_pallas_kernel_bf16():
    """bf16 inputs and output at 3e-2, test_flash_kernel.py's bf16
    tolerance: the outputs round to bf16 (u = 2^-8) on both sides."""
    rng = np.random.default_rng(7)
    q = rng.standard_normal((8, 64, 16)).astype(np.float32)
    k = rng.standard_normal((4, 64, 16)).astype(np.float32)
    v = rng.standard_normal((4, 64, 16)).astype(np.float32)
    out, lse = flash_fwd_pallas(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                                g_per_kv=2, causal=True, q_chunk=16,
                                k_chunk=16, scale=0.25, interpret=True)
    got, got_lse = ref.flash_fwd_ref(*(_t(a, torch.bfloat16) for a in (q, k, v)),
                                     g_per_kv=2, causal=True, scale=0.25)
    assert got.dtype == torch.bfloat16
    _close(got.float(), out, 3e-2)
    _close(got_lse, lse, 3e-2)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_fwd_scales_hold_float32_rounding(causal):
    """The checks' entry scales (``ref.flash_fwd_scales``) hold the float32
    plain version against a float64 one at the kernel checks' tolerances
    (out 3e-5, lse 1e-5), also where lse ≈ 0: row 0 of every head has a
    query orthogonal to key 0, so under the causal mask m ≈ 0 and l = 1."""
    rng = np.random.default_rng(11)
    G, S, D, scale = 3, 48, 64, 0.125
    q = rng.standard_normal((2 * G, S, D))
    k = rng.standard_normal((2, S, D))
    v = rng.standard_normal((2, S, D))
    k0 = k[np.arange(2 * G) // G, 0]
    q[:, 0] -= (np.sum(q[:, 0] * k0, -1) / np.sum(k0 * k0, -1))[:, None] * k0
    q, k, v = (a.astype(np.float32) for a in (q, k, v))
    kw = dict(g_per_kv=G, causal=causal, scale=scale)
    got, got_lse = ref.flash_fwd_ref(_t(q), _t(k), _t(v), **kw)
    s_out, s_lse = ref.flash_fwd_scales(_t(q), _t(k), _t(v), **kw)
    # the same function densely in float64
    kh = np.arange(2 * G) // G
    logits = scale * np.einsum("hqd,hsd->hqs", q.astype(np.float64),
                               k[kh].astype(np.float64))
    if causal:
        logits[:, np.triu(np.ones((S, S), bool), 1)] = -1e30
    m = logits.max(-1)
    p = np.exp(logits - m[..., None])
    want = np.einsum("hqs,hsd->hqd", p, v[kh]) / p.sum(-1)[..., None]
    want_lse = m + np.log(p.sum(-1))
    assert np.all(np.abs(got.double().numpy() - want) <= 3e-5 * s_out.numpy())
    assert np.all(np.abs(got_lse.double().numpy() - want_lse)
                  <= 1e-5 * s_lse.numpy())
    if causal:   # the rows the summation term is there for
        assert np.abs(want_lse[:, 0]).max() < 1e-5
        assert np.all(s_lse[:, 0].numpy() > 1e3 * np.abs(want_lse[:, 0]))


# -- blockwise attention ------------------------------------------------------

# 2e-5: tests/test_models_lm.py's tolerance for the blockwise forward
@pytest.mark.parametrize("window,causal,use_pallas", [
    (None, True, False), (None, False, False), (12, True, False),
    (40, True, False), (None, True, True), (12, True, True)])
def test_flash_attention_matches_jax(window, causal, use_pallas):
    """Banded (window 12: 12 + 16 < 48) and masked-window (40) layers on the
    plain path; ``use_pallas`` takes full layers to the kernel route (its
    plain version on the CPU, the Pallas kernel in interpret mode in JAX)
    and leaves windowed ones on the banded path."""
    rng = np.random.default_rng(0)
    B, S, H, KV, D = 2, 48, 6, 2, 16
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D)))
    kw = dict(causal=causal, window=window, q_chunk=16, k_chunk=16,
              use_pallas=use_pallas)
    want = jnn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               **kw)
    got = nn.flash_attention(_t(q), _t(k), _t(v), **kw)
    assert got.shape == (B, S, H, D)
    _close(got, want, 2e-5)


# 2e-5 as test_flash_attention_matches_jax: float32 sums in another order
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,KV", [(6, 2), (4, 4), (6, 1)])
def test_flash_attention_kernel_matches_jax_pallas(causal, H, KV):
    """``flash_attention_kernel`` hands the model's [B, S, H, D] tensors to
    ``ops.flash_fwd`` as they are (no regrouping copy) and still matches
    the JAX ``flash_attention_pallas`` in interpret mode, at the shapes of
    test_flash_attention_matches_jax."""
    from repro.kernels.flash_attention import flash_attention_pallas

    rng = np.random.default_rng(H * KV + causal)
    B, S, D = 2, 48, 16
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D)))
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal, q_chunk=16,
                                  k_chunk=16, interpret=True)
    got = nn.flash_attention_kernel(_t(q), _t(k), _t(v), causal=causal)
    assert got.shape == (B, S, H, D) and got.dtype == torch.float32
    _close(got, want, 2e-5)


def test_prefill_hands_the_kernel_contiguous_model_layout(monkeypatch):
    """On the kernel route every layer's q, k and v reach ``ops.flash_fwd``
    as contiguous [B, S, ·, D] tensors (after RoPE and the head reshape), the
    layout the kernel reads in place; the output goes back as it came."""
    cfg = dataclasses.replace(plm.reduced_lm("qwen2-1.5b"),
                              use_pallas_attention=True)
    params = tr.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu").tree()
    seen = []
    real = ops.flash_fwd

    def spy(q, k, v, **kw):
        seen.append((q, k, v))
        out, lse = real(q, k, v, **kw)
        assert out.shape == q.shape and out.is_contiguous()
        return out, lse

    monkeypatch.setattr(nn.ops, "flash_fwd", spy)
    toks = torch.as_tensor(_tokens(cfg.vocab, (2, 32), 3))
    tr.prefill(params, toks, cfg, pad_cache_to=40)
    assert len(seen) == cfg.n_layers
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    for q, k, v in seen:
        assert q.shape == (2, 32, H, Dh) and k.shape == v.shape == (2, 32, KV, Dh)
        assert q.is_contiguous() and k.is_contiguous() and v.is_contiguous()


def test_flash_attention_q_offset_and_chunk_check():
    """A q block at an offset into the keys (the path decode-by-chunks
    takes) matches JAX; chunks that do not divide the sequence raise."""
    rng = np.random.default_rng(1)
    q = rng.standard_normal((1, 16, 4, 8)).astype(np.float32)
    k = rng.standard_normal((1, 48, 2, 8)).astype(np.float32)
    v = rng.standard_normal((1, 48, 2, 8)).astype(np.float32)
    kw = dict(causal=True, q_offset=32, q_chunk=8, k_chunk=16)
    want = jnn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               **kw)
    _close(nn.flash_attention(_t(q), _t(k), _t(v), **kw), want, 2e-5)
    with pytest.raises(ValueError, match="divide"):
        nn.flash_attention(_t(q), _t(k), _t(v), q_chunk=12)


def test_norm_rope_decode_attention_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 5))
    _close(nn.rms_norm(_t(x), _t(w)), jnn.rms_norm(jnp.asarray(x), jnp.asarray(w)),
           1e-6)
    # positions up to 5000: float32 angles, sin/cos of two libraries
    _close(nn.rope(_t(x), torch.as_tensor(pos)),
           jnn.rope(jnp.asarray(x), jnp.asarray(pos)), 2e-5)
    q = rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
    kc = rng.standard_normal((2, 10, 2, 16)).astype(np.float32)
    vc = rng.standard_normal((2, 10, 2, 16)).astype(np.float32)
    for dtype, jdt, tol in ((torch.float32, jnp.float32, 1e-5),
                            (torch.bfloat16, jnp.bfloat16, 1e-2)):
        for window in (None, 4):
            want = jnn.decode_attention(
                jnp.asarray(q, jdt), jnp.asarray(kc, jdt), jnp.asarray(vc, jdt),
                jnp.asarray(7, jnp.int32), window=window)
            got = nn.decode_attention(_t(q, dtype), _t(kc, dtype),
                                      _t(vc, dtype), 7, window=window)
            assert got.dtype == dtype
            _close(got.float(), want, tol)


# -- the model ------------------------------------------------------------------

def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _check_cache(cache, jcache, tol):
    assert set(cache) == set(jcache)
    for key, arr in jcache.items():
        assert tuple(cache[key].shape) == arr.shape, key
        _close(cache[key].float(), arr, tol)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_prefill_reduced_qwen2_matches_jax(use_pallas):
    """Logits and caches within 2e-4 (tests/test_flash_kernel.py's prefill
    tolerance); with ``use_pallas_attention`` the JAX side runs its Pallas
    kernel in interpret mode."""
    jcfg = dataclasses.replace(jlm.reduced_lm("qwen2-1.5b"),
                               use_pallas_attention=use_pallas)
    cfg = dataclasses.replace(plm.reduced_lm("qwen2-1.5b"),
                              use_pallas_attention=use_pallas)
    jparams = jtr.init_params(jcfg, jax.random.PRNGKey(0))
    params = _carry(jparams, cfg)
    toks = _tokens(cfg.vocab, (2, 32), 1)
    want, jcache = jtr.prefill(jparams, jnp.asarray(toks), jcfg,
                               pad_cache_to=40)
    got, cache = tr.prefill(params, torch.as_tensor(toks), cfg, pad_cache_to=40)
    assert got.dtype == torch.float32 and got.shape == (2, cfg.vocab)
    _close(got, want, 2e-4)
    _check_cache(cache, jcache, 2e-4)
    h, aux = tr.forward(params, torch.as_tensor(toks), cfg)
    jh, _ = jtr.forward(jparams, jnp.asarray(toks), jcfg)
    _close(h, jh, 2e-4)
    assert float(aux) == 0.0


def test_prefill_reduced_qwen2_bf16_matches_jax():
    """In bf16 the two frameworks round at other places (XLA rounds some
    elementwise intermediates, such as silu's sigmoid, to bf16 where torch
    rounds once); over two layers that leaves logits within 3e-2 of
    max |logits| and the caches within 3e-2 (a few bf16 ulps, u = 2^-8)."""
    kw = dict(dtype="bfloat16")
    jcfg = dataclasses.replace(jlm.reduced_lm("qwen2-1.5b"), dtype=jnp.bfloat16)
    cfg = dataclasses.replace(plm.reduced_lm("qwen2-1.5b"), **kw)
    assert cfg.dtype == torch.bfloat16
    jparams = jtr.init_params(jcfg, jax.random.PRNGKey(3))
    params = _carry(jparams, cfg)
    assert params["embed"].dtype == torch.bfloat16
    # the carry-over is exact: bf16 → float32 → bf16
    np.testing.assert_array_equal(params["layers"]["wq"].float().numpy(),
                                  _np(jparams["layers"]["wq"]))
    toks = _tokens(cfg.vocab, (2, 32), 4)
    want, jcache = jtr.prefill(jparams, jnp.asarray(toks), jcfg)
    got, cache = tr.prefill(params, torch.as_tensor(toks), cfg)
    scale = float(np.abs(_np(want)).max())
    assert float((got - _t(want)).abs().max()) <= 3e-2 * scale
    _check_cache(cache, jcache, 3e-2)


_WINDOWED = dict(name="t", n_layers=6, d_model=48, n_heads=4, n_kv_heads=2,
                 d_head=12, d_ff=96, vocab=128, window=8,
                 layer_pattern=("L", "L", "G"), dtype="float32", q_chunk=8,
                 k_chunk=8, loss_chunk=8, remat=False)


def test_prefill_then_decode_matches_jax_windowed():
    """tests/test_models_lm.py:175's serving handoff: prefill P tokens with
    reserved capacity, then decode N one by one, ring caches of the local
    layers included; logits at every step and the final caches within 3e-4
    (its tolerance) of the JAX package's, and the last logits within 3e-4
    of JAX's prefill of the whole sequence."""
    jcfg, cfg = _both(dict(_WINDOWED, dtype=jnp.float32))
    jparams = jtr.init_params(jcfg, jax.random.PRNGKey(0))
    params = _carry(jparams, cfg)
    B, P, N = 2, 16, 8
    toks = _tokens(128, (B, P + N), 5)
    full, _ = jtr.prefill(jparams, jnp.asarray(toks), jcfg)
    want, jcache = jtr.prefill(jparams, jnp.asarray(toks[:, :P]), jcfg,
                               pad_cache_to=P + N)
    got, cache = tr.prefill(params, torch.as_tensor(toks[:, :P]), cfg,
                            pad_cache_to=P + N)
    _close(got, want, 3e-4)
    _check_cache(cache, jcache, 3e-4)
    for t in range(P, P + N):
        want, jcache = jtr.decode_step(jparams, jcache, jnp.asarray(toks[:, t]),
                                       jnp.asarray(t, jnp.int32), jcfg)
        got, cache = tr.decode_step(params, cache, torch.as_tensor(toks[:, t]),
                                    t, cfg)
        _close(got, want, 3e-4)
    _check_cache(cache, jcache, 3e-4)
    _close(got, full, 3e-4)


def test_decode_from_empty_cache_matches_jax_prefill():
    """tests/test_models_lm.py:47: token-by-token decode into an S-sized
    cache reproduces the JAX package's prefill logits (2e-4, its
    tolerance)."""
    jcfg, cfg = _both(dict(_WINDOWED, dtype=jnp.float32))
    jparams = jtr.init_params(jcfg, jax.random.PRNGKey(0))
    params = _carry(jparams, cfg)
    B, S = 2, 24
    toks = _tokens(128, (B, S), 6)
    want, _ = jtr.prefill(jparams, jnp.asarray(toks), jcfg)
    cache = tr.init_cache(cfg, B, S, device="cpu")
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        k: s for k, (s, _) in jtr.cache_shapes(jcfg, B, S).items()}
    for t in range(S):
        got, cache = tr.decode_step(params, cache, torch.as_tensor(toks[:, t]),
                                    t, cfg)
    _close(got, want, 2e-4)


def _jax_driver_tokens(capsys, argv):
    """The greedy tokens the JAX package's lm_serve prints (gen[:12] of its
    first two requests)."""
    from repro.launch import lm_serve as jserve

    old = sys.argv
    sys.argv = ["lm_serve", *argv]
    try:
        jserve.main()
    finally:
        sys.argv = old
    text = capsys.readouterr().out
    return [[int(t) for t in m.split(",")]
            for m in re.findall(r"gen\[:12\]=\[([0-9, ]*)\]", text)]


def test_lm_serve_gives_jax_driver_greedy_tokens(capsys):
    """The port's ``serve`` on the CPU, with the JAX driver's weights (its
    init, seed 0) and prompts (the port's copy of ``token_batch``), greedy-
    decodes the tokens the JAX driver prints, on the reduced config."""
    B, P, N = 2, 16, 8
    want = _jax_driver_tokens(capsys, ["--batch", str(B), "--prompt-len",
                                       str(P), "--gen", str(N)])
    cfg = registry.get("qwen2-1.5b").make_reduced()
    jparams = jtr.init_params(jlm.reduced_lm("qwen2-1.5b"),
                              jax.random.PRNGKey(0))
    prompts = token_batch(cfg.vocab, B, P, seed=0)
    for use_pallas in (False, True):
        c = dataclasses.replace(cfg, use_pallas_attention=use_pallas)
        tokens, tm = lm_serve.serve(c, _carry(jparams, c), prompts, N,
                                    device="cpu")
        assert tokens.shape == (B, N) and tokens.dtype == np.int32
        assert tokens.tolist() == want
        assert tm["prefill_s"] > 0 and tm["decode_s"] > 0


def test_lm_serve_main_prints_the_jax_driver_lines():
    out = io.StringIO()
    with redirect_stdout(out):
        lm_serve.main(["--device", "cpu", "--batch", "3", "--prompt-len", "16",
                       "--gen", "4", "--use-pallas-attention"])
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("model qwen2-1.5b: ") and "(reduced)" in lines[0]
    assert lines[1].startswith("prefill: 3x16 tokens in ")
    assert lines[2].startswith("decode : 3 steps in ") and "batch 3" in lines[2]
    assert [ln.split(":")[0] for ln in lines[3:]] == ["req0", "req1"]


# -- parameters and configs -------------------------------------------------------

def test_params_init_distribution_and_carry_over():
    cfg = plm.reduced_lm("qwen2-1.5b")
    gen = torch.Generator().manual_seed(0)
    params = tr.init_params(cfg, gen, device="cpu")
    shapes = tr.param_shapes(cfg)
    assert tuple(params.embed.shape) == shapes["embed"][0]
    assert {k: tuple(p.shape) for k, p in params.layers.items()} == {
        k: s for k, (s, _) in shapes["layers"].items()}
    for name, p in params.named_parameters():
        assert not p.requires_grad
        if name.endswith("norm"):
            assert not bool(p.any()), name
        else:
            fan_in = p.shape[-2]
            assert float(p.std()) * math.sqrt(fan_in) == pytest.approx(1, rel=0.2)
    # the same tree as the JAX init's, name for name
    jparams = jtr.init_params(jlm.reduced_lm("qwen2-1.5b"), jax.random.PRNGKey(1))
    carried = tr.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                   device="cpu")
    for name, p in carried.named_parameters():
        node = jparams
        for part in name.split("."):
            node = node[part]
        np.testing.assert_array_equal(p.numpy(), _np(node))
    bad = jax.tree.map(np.asarray, jparams)
    bad["layers"]["wq"] = bad["layers"]["wq"][:, :, :-1]
    with pytest.raises(ValueError, match="layers.wq"):
        tr.params_from_numpy(bad, cfg, device="cpu")
    # the MoE trees carry over name for name too: the router, the w1/w3/w2
    # expert stacks and llama4's shared expert s1/s3/s2
    for arch, names in (("mixtral-8x22b", {"router", "w1", "w3", "w2"}),
                        ("llama4-maverick-400b-a17b",
                         {"router", "w1", "w3", "w2", "s1", "s3", "s2"})):
        jparams = jtr.init_params(jlm.reduced_lm(arch), jax.random.PRNGKey(2))
        carried = tr.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       plm.reduced_lm(arch), device="cpu")
        assert names <= set(carried.layers)
        assert carried.layers["w1"].dim() == 4          # (L, E, D, F)
        for name, p in carried.named_parameters():
            node = jparams
            for part in name.split("."):
                node = node[part]
            np.testing.assert_array_equal(p.numpy(), _np(node))


@pytest.mark.parametrize("arch", LM_IDS)
def test_lm_configs_match_jax(arch):
    """The port's full and reduced configs have the JAX package's fields
    and values (dtype by name), and its parameter shapes sum to
    ``param_count``."""
    for jcfg, cfg in ((jlm.LM_ARCHS[arch](), registry.get(arch).make_config()),
                      (jlm.reduced_lm(arch), plm.reduced_lm(arch))):
        for f in dataclasses.fields(jtr.LMConfig):
            a, b = getattr(jcfg, f.name), getattr(cfg, f.name)
            if f.name == "dtype":
                assert str(b).split(".")[-1] == np.dtype(a).name
            elif f.name == "moe":
                assert (a is None) == (b is None)
                if a is not None:
                    assert dataclasses.asdict(a) == dataclasses.asdict(b)
            else:
                assert a == b, f.name
        assert cfg.param_count() == jcfg.param_count()
        shapes = tr.param_shapes(cfg)
        total = (math.prod(shapes["embed"][0]) + math.prod(shapes["final_norm"][0])
                 + sum(math.prod(s) for s, _ in shapes["layers"].values()))
        assert total == cfg.param_count()
    assert plm.LM_SHAPES == jlm.LM_SHAPES


def test_lm_config_fields_and_defaults_match_jax():
    """One kwargs dict builds both sides of a parity test."""
    jf = {f.name: f.default for f in dataclasses.fields(jtr.LMConfig)}
    pf = {f.name: f.default for f in dataclasses.fields(tr.LMConfig)}
    assert list(jf) == list(pf)
    for name in jf:
        if name != "dtype":
            assert jf[name] == pf[name], name
    assert pf["dtype"] == torch.bfloat16 and np.dtype(jf["dtype"]).name == "bfloat16"
    assert [f.name for f in dataclasses.fields(jtr.MoECfg)] == [
        f.name for f in dataclasses.fields(tr.MoECfg)]
    for dt in (jnp.float32, np.float32, "float32", torch.float32):
        assert tr.LMConfig(**dict(_WINDOWED, dtype=dt)).dtype == torch.float32


def test_unported_archs_raise():
    """Every arch of the reference's registry resolves (``pirmcut`` to the
    solver family, with the reference's cells and shapes); an unknown one
    still raises."""
    from repro.configs import registry as jregistry

    entry = registry.get("pirmcut")
    assert entry.family == "solver"
    assert entry.cells == jregistry.get("pirmcut").cells
    assert entry.shapes == jregistry.get("pirmcut").shapes
    assert sorted(registry.ARCHS) == sorted(jregistry.ARCHS)
    assert registry.all_cells(True) == jregistry.all_cells(True)
    with pytest.raises(KeyError, match="unknown arch"):
        registry.get("nope")
    # the GNN and recsys archs are ported: they resolve
    assert registry.get("gcn-cora").family == "gnn"
    assert registry.get("din").family == "recsys"
    # the MoE archs are ported: their parameters build
    params = tr.init_params(plm.reduced_lm("mixtral-8x22b"), device="cpu")
    assert {"router", "w1", "w3", "w2"} <= set(params.layers)


def test_token_stream_matches_jax_copy():
    for args in ((512, 3, 40, 0), (151936, 2, 17, 5)):
        np.testing.assert_array_equal(token_batch(*args),
                                      jdata.token_batch(*args))
    a, b = TokenStream(64, 2, 8, seed=1), jdata.TokenStream(64, 2, 8, seed=1)
    for _ in range(3):
        np.testing.assert_array_equal(next(a), next(b))
