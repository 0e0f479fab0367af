"""The port's MoE layers and MoE serving against the JAX package, on the CPU.

The same seeded inputs (numpy) and the same weights (the JAX init, carried
over by ``params_from_numpy``) go through both packages: ``moe_layer`` with
and without dropped tokens, routes with exact ties between gates,
``moe_layer_grouped``, ``moe_aux_loss``, the reference's own MoE tests on
the port, prefill, forward and decode of the reduced llama4-maverick and
mixtral-8x22b, and the serving driver.  Each tolerance states its reason."""
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
from repro.models import layers as jnn  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402

from repro_torch.configs import lm as plm, registry  # noqa: E402
from repro_torch.data.lm import token_batch  # noqa: E402
from repro_torch.launch import lm_serve  # noqa: E402
from repro_torch.models import layers as nn  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402

MOE_ARCHS = ["llama4-maverick-400b-a17b", "mixtral-8x22b"]


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x, dtype=np.float32)).to(dtype)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _carry(jparams, cfg):
    return tr.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                device="cpu").tree()


def _moe_params(rng, D, F, E, scale=0.25):
    """(numpy arrays, JAX MoEParams, port MoEParams) from one generator."""
    arrs = dict(router=rng.standard_normal((D, E)),
                w1=rng.standard_normal((E, D, F)) * scale,
                w3=rng.standard_normal((E, D, F)) * scale,
                w2=rng.standard_normal((E, F, D)) * scale)
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    return (arrs, jnn.MoEParams(**{k: jnp.asarray(v) for k, v in arrs.items()}),
            nn.MoEParams(**{k: _t(v) for k, v in arrs.items()}))


def _jax_routes(x, router, top_k, capacity_factor):
    """The routing lines of ``repro.models.layers.moe_layer`` (its top-k,
    capacity and stable-sort ranks), returning what the layer keeps
    internal: (top ids [T, k], keep [T·k], C)."""
    T = x.shape[0]
    E = router.shape[1]
    C = int(capacity_factor * top_k * T / E)
    C = max(8, -(-C // 8) * 8)
    gates = jax.nn.softmax((x @ router).astype(jnp.float32), axis=-1)
    _, top_idx = jax.lax.top_k(gates, top_k)
    flat_e = top_idx.reshape(-1)
    Tk = flat_e.shape[0]
    order = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = jnp.searchsorted(sorted_e, jnp.arange(E, dtype=flat_e.dtype))
    rank_sorted = jnp.arange(Tk, dtype=jnp.int32) - starts[sorted_e].astype(
        jnp.int32)
    rank = jnp.zeros((Tk,), jnp.int32).at[order].set(rank_sorted)
    return np.asarray(top_idx), np.asarray(rank < C), C


# -- the layer ---------------------------------------------------------------------

# 2e-5: tests/test_models_lm.py's blockwise tolerance; the float32 expert
# products sum in other orders in the two libraries
@pytest.mark.parametrize("T", [64, 37])
@pytest.mark.parametrize("cap", ["drop", "all"])
@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_layer_matches_jax(top_k, cap, T):
    """float32, E = 4: capacity factor 0.5 drops (token, choice) entries,
    capacity factor E keeps all; T = 37 is not a multiple of E.  The routes
    (top ids and kept entries) equal the reference's exactly."""
    rng = np.random.default_rng(10 * top_k + T)
    D, F, E = 16, 24, 4
    cf = 0.5 if cap == "drop" else float(E)
    x = rng.standard_normal((T, D)).astype(np.float32)
    _, jp, p = _moe_params(rng, D, F, E)
    want = jnn.moe_layer(jnp.asarray(x), jp, top_k, cf)
    got = nn.moe_layer(_t(x), p, top_k, cf)
    assert got.shape == (T, D) and got.dtype == torch.float32
    _close(got, want, 2e-5)
    j_idx, j_keep, C = _jax_routes(jnp.asarray(x), jp.router, top_k, cf)
    r = nn.moe_routes(_t(x), p.router, top_k, cf)
    assert r.capacity == C
    np.testing.assert_array_equal(r.experts.numpy(), j_idx)
    np.testing.assert_array_equal(r.keep.numpy(), j_keep)
    if cap == "drop":
        assert not j_keep.all()
        # a token with every choice dropped gives an exact zero row
        dropped = ~j_keep.reshape(T, top_k).any(axis=1)
        assert dropped.any()
        assert not got[torch.as_tensor(dropped)].any()
    else:
        assert j_keep.all()


def test_routes_break_ties_toward_the_lower_expert():
    """Gates with exact ties: the port's routes are ``lax.top_k``'s, lower
    index first, in ``route_top_k`` and through ``moe_layer``, where a
    router with duplicated columns ties two experts for every token (their
    weights differ, so a route to the other one changes the output).
    ``torch.topk`` gives the higher index on such ties on the CPU."""
    gates = np.array([[0.1, 0.3, 0.3, 0.3],
                      [0.5, 0.5, 0.0, 0.0],
                      [0.2, 0.2, 0.2, 0.4],
                      [0.25, 0.25, 0.25, 0.25]], np.float32)
    for k in (1, 2, 3):
        want_v, want_i = jax.lax.top_k(jnp.asarray(gates), k)
        got_v, got_i = nn.route_top_k(_t(gates), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))

    rng = np.random.default_rng(4)
    T, D, F, E = 48, 16, 24, 4
    x = rng.standard_normal((T, D)).astype(np.float32)
    arrs, _, _ = _moe_params(rng, D, F, E)
    for a, b in ((1, 2), (0, 3)):
        arrs["router"][:, b] = arrs["router"][:, a]     # experts a, b tie
    jp = jnn.MoEParams(**{k: jnp.asarray(v) for k, v in arrs.items()})
    p = nn.MoEParams(**{k: _t(v) for k, v in arrs.items()})
    for top_k in (1, 2, 3):
        j_idx, j_keep, _ = _jax_routes(jnp.asarray(x), jp.router, top_k,
                                       float(E))
        r = nn.moe_routes(_t(x), p.router, top_k, float(E))
        np.testing.assert_array_equal(r.experts.numpy(), j_idx)
        np.testing.assert_array_equal(r.keep.numpy(), j_keep)
        assert set(np.unique(j_idx[:, 0])) <= {0, 1}     # the lower of a pair
        want = jnn.moe_layer(jnp.asarray(x), jp, top_k, float(E))
        _close(nn.moe_layer(_t(x), p, top_k, float(E)), want, 2e-5)


# 2e-5 as test_moe_layer_matches_jax
@pytest.mark.parametrize("G", [2, 4, 8])
def test_moe_layer_grouped_matches_jax(G):
    """Each group routes into its own capacity buffers against the
    reference's grouped dispatch: at capacity factor 0.5 entries drop in
    every group (C from the group's 256/G tokens), at E none do."""
    rng = np.random.default_rng(G)
    T, D, F, E, K = 256, 16, 24, 4, 2
    x = rng.standard_normal((T, D)).astype(np.float32)
    _, jp, p = _moe_params(rng, D, F, E)
    for cf in (0.5, float(E)):
        want = jnn.moe_layer_grouped(jnp.asarray(x), jp, K, cf, n_groups=G)
        got = nn.moe_layer_grouped(_t(x), p, K, cf, n_groups=G)
        _close(got, want, 2e-5)
        keep = nn.moe_routes(_t(x).reshape(G, T // G, D), p.router, K, cf).keep
        assert keep.shape == (G, T // G * K)
        if cf < 1:
            assert not keep.all(dim=1).any()      # drops in every group
        else:
            assert keep.all()


# 1e-6: a float32 mean of softmax gates times loads
@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_aux_loss_matches_jax(top_k):
    rng = np.random.default_rng(20 + top_k)
    x = rng.standard_normal((50, 16)).astype(np.float32)
    router = rng.standard_normal((16, 8)).astype(np.float32)
    want = jnn.moe_aux_loss(jnp.asarray(x), jnp.asarray(router), top_k)
    got = nn.moe_aux_loss(_t(x), _t(router), top_k)
    assert got.dtype == torch.float32 and got.shape == ()
    _close(got, want, 1e-6)


# -- the reference's MoE tests, on the port ------------------------------------------

def test_moe_matches_dense_experts_at_high_capacity():
    """tests/test_models_lm.py's test on the port: with capacity ≥ T no
    entry drops, so MoE == the explicit per-token expert mix (top-k softmax
    renormalized), at its 2e-4."""
    rng = np.random.default_rng(1)
    T, D, F, E, K = 32, 16, 24, 4, 2
    x = _t(rng.standard_normal((T, D)))
    p = nn.MoEParams(router=_t(rng.standard_normal((D, E))),
                     w1=_t(rng.standard_normal((E, D, F)) / 4),
                     w3=_t(rng.standard_normal((E, D, F)) / 4),
                     w2=_t(rng.standard_normal((E, F, D)) / 4))
    y = nn.moe_layer(x, p, top_k=K, capacity_factor=float(E))   # C ≥ T

    gates = torch.softmax(x @ p.router, -1)
    tg, ti = nn.route_top_k(gates, K)
    tg = tg / tg.sum(-1, keepdim=True)
    y_ref = torch.zeros_like(x)
    for t in range(T):
        for j in range(K):
            e = int(ti[t, j])
            h = torch.nn.functional.silu(x[t] @ p.w1[e]) * (x[t] @ p.w3[e])
            y_ref[t] += tg[t, j] * (h @ p.w2[e])
    _close(y, y_ref, 2e-4)


def test_moe_capacity_drops_tokens():
    """tests/test_models_lm.py's test on the port: a tiny capacity drops
    tokens (outputs finite, some rows exactly zero)."""
    rng = np.random.default_rng(2)
    x = _t(rng.standard_normal((64, 8)))
    p = nn.MoEParams(router=_t(rng.standard_normal((8, 4))),
                     w1=_t(rng.standard_normal((4, 8, 12))),
                     w3=_t(rng.standard_normal((4, 8, 12))),
                     w2=_t(rng.standard_normal((4, 12, 8))))
    y = nn.moe_layer(x, p, top_k=1, capacity_factor=0.5)
    assert bool(torch.isfinite(y).all())
    assert int((y.abs().sum(-1) == 0).sum()) > 0


def test_grouped_moe_matches_global():
    """tests/test_flash_kernel.py's test on the port: at capacity ≥ T the
    grouped dispatch equals the global one (its rtol 2e-4, atol 2e-5), and
    its gradient through torch's autograd is finite."""
    rng = np.random.default_rng(1)
    T, D, F, E, K, G = 64, 16, 24, 4, 2, 8
    x = _t(rng.standard_normal((T, D)))
    p = nn.MoEParams(router=_t(rng.standard_normal((D, E))),
                     w1=_t(rng.standard_normal((E, D, F)) / 4),
                     w3=_t(rng.standard_normal((E, D, F)) / 4),
                     w2=_t(rng.standard_normal((E, F, D)) / 4))
    y1 = nn.moe_layer(x, p, top_k=K, capacity_factor=float(E))
    y2 = nn.moe_layer_grouped(x, p, top_k=K, capacity_factor=float(E),
                              n_groups=G)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=2e-4, atol=2e-5)
    xg = x.clone().requires_grad_(True)
    (nn.moe_layer_grouped(xg, p, K, float(E), G) ** 2).sum().backward()
    assert bool(torch.isfinite(xg.grad).all())


# -- the model -------------------------------------------------------------------------

def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _check_cache(cache, jcache, tol):
    assert set(cache) == set(jcache)
    for key, arr in jcache.items():
        assert tuple(cache[key].shape) == arr.shape, key
        _close(cache[key].float(), arr, tol)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_and_forward_reduced_moe_match_jax(arch, use_pallas):
    """Logits, caches and ``forward``'s hidden states within 2e-4 (the bar
    of test_prefill_reduced_qwen2_matches_jax), the aux sum within 1e-5;
    with ``use_pallas_attention`` the JAX side runs its Pallas kernel in
    interpret mode (llama4's layers are global, so they take it; mixtral's
    are windowed and stay on the banded path in both)."""
    jcfg = dataclasses.replace(jlm.reduced_lm(arch),
                               use_pallas_attention=use_pallas)
    cfg = dataclasses.replace(plm.reduced_lm(arch),
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
    jh, jaux = jtr.forward(jparams, jnp.asarray(toks), jcfg)
    _close(h, jh, 2e-4)
    assert aux.dtype == torch.float32 and float(aux) > 0
    _close(aux, jaux, 1e-5)


def test_prefill_reduced_llama4_bf16_matches_jax():
    """In bf16 the two frameworks round at other places (XLA rounds some
    elementwise intermediates to bf16 where torch rounds once; ROADMAP
    queue 3), so logits are held within 3e-2 of max |logits|, the bar of
    test_prefill_reduced_qwen2_bf16_matches_jax."""
    jcfg = dataclasses.replace(jlm.reduced_lm("llama4-maverick-400b-a17b"),
                               dtype=jnp.bfloat16)
    cfg = dataclasses.replace(plm.reduced_lm("llama4-maverick-400b-a17b"),
                              dtype="bfloat16")
    jparams = jtr.init_params(jcfg, jax.random.PRNGKey(3))
    params = _carry(jparams, cfg)
    assert params["layers"]["w1"].dtype == torch.bfloat16
    toks = _tokens(cfg.vocab, (2, 32), 4)
    want, _ = jtr.prefill(jparams, jnp.asarray(toks), jcfg)
    got, _ = tr.prefill(params, torch.as_tensor(toks), cfg)
    scale = float(np.abs(_np(want)).max())
    assert float((got - _t(want)).abs().max()) <= 3e-2 * scale


def test_decode_reduced_mixtral_past_its_window_matches_jax():
    """Prefill 16 tokens, then greedy-decode 12 through the window-8 ring
    caches (it wraps): every step's logits within 3e-4 (the bar of
    test_prefill_then_decode_matches_jax_windowed) and the greedy tokens
    equal the reference's."""
    jcfg = jlm.reduced_lm("mixtral-8x22b")
    cfg = plm.reduced_lm("mixtral-8x22b")
    assert cfg.window == 8
    jparams = jtr.init_params(jcfg, jax.random.PRNGKey(2))
    params = _carry(jparams, cfg)
    B, P, N = 2, 16, 12
    toks = _tokens(cfg.vocab, (B, P), 7)
    want, jcache = jtr.prefill(jparams, jnp.asarray(toks), jcfg,
                               pad_cache_to=P + N)
    got, cache = tr.prefill(params, torch.as_tensor(toks), cfg,
                            pad_cache_to=P + N)
    jtok, tok = jnp.argmax(want, -1).astype(jnp.int32), got.argmax(-1)
    jout, out = [jtok], [tok]
    for t in range(P, P + N - 1):
        want, jcache = jtr.decode_step(jparams, jcache, jtok,
                                       jnp.asarray(t, jnp.int32), jcfg)
        got, cache = tr.decode_step(params, cache, tok, t, cfg)
        _close(got, want, 3e-4)
        jtok, tok = jnp.argmax(want, -1).astype(jnp.int32), got.argmax(-1)
        jout.append(jtok)
        out.append(tok)
    _check_cache(cache, jcache, 3e-4)
    np.testing.assert_array_equal(torch.stack(out, 1).numpy(),
                                  np.stack([np.asarray(t) for t in jout], 1))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_init_params_moe_shapes_fan_in_and_norms(arch):
    """The MoE tree's names and shapes (router, the expert stacks, the
    shared expert where the config has one), each drawn N(0, 1)/√fan_in
    with fan_in the second-to-last dim, norms 0."""
    cfg = plm.reduced_lm(arch)
    params = tr.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    E, D, F, L = cfg.moe.n_experts, cfg.d_model, cfg.d_ff, cfg.n_layers
    shapes = {k: tuple(p.shape) for k, p in params.layers.items()}
    assert shapes["router"] == (L, D, E)
    assert shapes["w1"] == shapes["w3"] == (L, E, D, F)
    assert shapes["w2"] == (L, E, F, D)
    assert ({"s1", "s3", "s2"} <= set(shapes)) == cfg.moe.shared_expert
    if cfg.moe.shared_expert:
        assert shapes["s1"] == shapes["s3"] == (L, D, F)
        assert shapes["s2"] == (L, F, D)
    for name, p in params.named_parameters():
        if name.endswith("norm"):
            assert not bool(p.any()), name
        else:
            assert float(p.std()) * math.sqrt(p.shape[-2]) == pytest.approx(
                1, rel=0.2), name
    total = sum(p.numel() for p in params.parameters())
    assert total == cfg.param_count()
    jcfg = jlm.reduced_lm(arch)
    assert cfg.active_param_count() == jcfg.active_param_count()
    full = registry.get(arch).make_config()
    assert full.active_param_count() == jlm.LM_ARCHS[arch]().active_param_count()


def test_init_params_draws_in_slices(monkeypatch):
    """A parameter larger than one draw is filled slice by slice from one
    generator stream: with the slice cut to 1000 elements, every slice's
    values are N(0, 1)/√fan_in and no two slices repeat."""
    monkeypatch.setattr(tr, "_INIT_CHUNK", 1000)
    cfg = plm.reduced_lm("mixtral-8x22b")
    params = tr.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    w1 = params.layers["w1"].reshape(-1)
    assert w1.numel() > 10 * 1000
    parts = w1[: 10 * 1000].reshape(10, 1000) * math.sqrt(cfg.d_model)
    for part in parts:
        assert float(part.std()) == pytest.approx(1, rel=0.2)
    assert len({float(part[0]) for part in parts}) == 10


# -- the serving driver --------------------------------------------------------------

def _jax_driver_text(capsys, argv):
    """What the JAX package's lm_serve prints."""
    from repro.launch import lm_serve as jserve

    old = sys.argv
    sys.argv = ["lm_serve", *argv]
    try:
        jserve.main()
    finally:
        sys.argv = old
    return capsys.readouterr().out


def _greedy_tokens(text):
    """gen[:12] of the printed requests."""
    return [[int(t) for t in m.split(",")]
            for m in re.findall(r"gen\[:12\]=\[([0-9, ]*)\]", text)]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_lm_serve_moe_gives_jax_driver_greedy_tokens(capsys, arch):
    """The port's ``serve`` on the CPU, with the JAX driver's weights (its
    init, seed 0) and prompts, greedy-decodes the tokens the JAX driver
    prints for the reduced MoE arch (mixtral's window 8 wraps in decode),
    on both attention routes."""
    B, P, N = 2, 16, 8
    want = _greedy_tokens(_jax_driver_text(
        capsys, ["--arch", arch, "--batch", str(B), "--prompt-len", str(P),
                 "--gen", str(N)]))
    assert len(want) == B
    cfg = registry.get(arch).make_reduced()
    jparams = jtr.init_params(jlm.reduced_lm(arch), jax.random.PRNGKey(0))
    prompts = token_batch(cfg.vocab, B, P, seed=0)
    for use_pallas in (False, True):
        c = dataclasses.replace(cfg, use_pallas_attention=use_pallas)
        tokens, _ = lm_serve.serve(c, _carry(jparams, c), prompts, N,
                                   device="cpu")
        assert tokens.tolist() == want


def test_lm_serve_main_serves_mixtral_with_the_jax_driver_lines(capsys):
    """``--arch mixtral-8x22b`` serves on the CPU and prints the JAX
    driver's lines: the same model line and prompts, the same prefill and
    decode lines but for the times, and greedy tokens in range."""
    argv = ["--arch", "mixtral-8x22b", "--batch", "3", "--prompt-len", "16",
            "--gen", "4"]
    want = _jax_driver_text(capsys, argv).splitlines()
    out = io.StringIO()
    with redirect_stdout(out):
        lm_serve.main([*argv, "--device", "cpu"])
    lines = out.getvalue().splitlines()
    assert len(lines) == len(want) == 5
    assert lines[0] == want[0] and lines[0].startswith("model mixtral-8x22b: ")
    for a, b in zip(lines[1:3], want[1:3]):
        assert a.split(" in ")[0] == b.split(" in ")[0]
        assert a.split("(")[1].split(" tok/s")[1:] == \
            b.split("(")[1].split(" tok/s")[1:]
    for a, b in zip(lines[3:], want[3:]):     # same prompts, port's weights
        assert a.split(" → ")[0] == b.split(" → ")[0]
    vocab = plm.reduced_lm("mixtral-8x22b").vocab
    assert all(0 <= t < vocab for row in _greedy_tokens("\n".join(lines))
               for t in row)
    assert lines[1].startswith("prefill: 3x16 tokens in ")
    assert lines[2].startswith("decode : 3 steps in ") and "batch 3" in lines[2]
    assert [ln.split(":")[0] for ln in lines[3:]] == ["req0", "req1"]
