"""The port's LM sharding (``models/sharding``, the sharded transformer,
the grouped MoE dispatch over the data axis, the clip's global norm over
shards) against the JAX package.

The layout tables (``spec``, ``param_shardings``, ``cache_shardings``) are
compared in process at full width on the production meshes' sizes (an
``AbstractMesh`` on both sides: no ranks).  The rest runs in subprocesses
started once for the module: the port in four gloo ranks on a (data 2,
model 2) mesh, the reference on four emulated CPU devices with its meshes
built with ``AxisType.Auto`` (jax 0.9's ``make_mesh`` gives Explicit axes,
which the reference's ``with_sharding_constraint`` refuses).  Both sides
take the same numpy parameters and tokens from a seed, in float32.
"""
import json
import tempfile

import numpy as np
import pytest

pytest.importorskip("torch")

from tests._torch_ranks import PARAMS, Job  # noqa: E402

BASE = dict(name="t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
            d_head=8, d_ff=64, vocab=128, q_chunk=16, k_chunk=16,
            loss_chunk=8, remat=False)
# the sharded loss cases: the reference test's dense and MoE configs, with
# sequence parallelism on and off, heads that do not divide the model axis
# (3 over 2: q's rows are sharded instead; 6 over 2 with 3 KV heads: q's
# heads are, the KV heads whole), and the grouped dispatch with drops
CASES = {
    "dense": {},
    "dense_no_sp": dict(seq_parallel=False, qkv_bias=True),
    "moe": dict(moe=dict(n_experts=4, top_k=2, capacity_factor=4.0)),
    "moe_no_sp": dict(seq_parallel=False,
                      moe=dict(n_experts=4, top_k=2, capacity_factor=4.0)),
    "heads_3_of_1": dict(n_heads=3, n_kv_heads=1, qkv_bias=True),
    "heads_6_of_3": dict(n_heads=6, n_kv_heads=3),
    "moe_grouped": dict(remat=True, moe=dict(
        n_experts=4, top_k=2, capacity_factor=1.0, dispatch="grouped",
        shared_expert=True)),
}
# prefill and decode with a batch of 3 over data 2 (the caches' sequence
# over data) and one KV head over model 2 (d_head over model)
SERVE = dict(BASE, n_kv_heads=1, layer_pattern=["L", "G"], window=8)
SERVE_B, SERVE_P, SERVE_N = 3, 16, 4
# the grouped dispatch alone: E = 4 (EP over data) and E = 3 (no EP)
GROUPED = dict(D=32, F=64, top_k=2, capacity_factor=1.0, tokens=24)

_SHARED = PARAMS + f"""
import json
BASE = json.loads({json.dumps(BASE)!r})
CASES = json.loads({json.dumps(CASES)!r})
SERVE = json.loads({json.dumps(SERVE)!r})
GROUPED = json.loads({json.dumps(GROUPED)!r})
SERVE_B, SERVE_P, SERVE_N = {SERVE_B}, {SERVE_P}, {SERVE_N}


def tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def moe_inputs(E):
    rng = np.random.default_rng(40 + E)
    g = GROUPED
    D, F = g["D"], g["F"]
    x = rng.standard_normal((2 * g["tokens"], D)).astype(np.float32)
    w = [(rng.standard_normal(s) / np.sqrt(s[-2])).astype(np.float32)
         for s in ((D, E), (E, D, F), (E, D, F), (E, F, D))]
    return x, w
"""

_REF = _SHARED + """
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.models import transformer as tr, layers as nn
from repro.models.sharding import lm_rules
from repro.train.optimizer import _global_norm
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2,
                     devices=jax.devices()[:4])
rules = lm_rules(mesh)
out = {}


def cfg_of(kw):
    kw = dict(kw)
    if "moe" in kw:
        kw["moe"] = tr.MoECfg(**kw["moe"])
    kw["layer_pattern"] = tuple(kw.get("layer_pattern", ("G",)))
    return tr.LMConfig(dtype=jnp.float32, **kw)


for name, extra in CASES.items():
    cfg = cfg_of(dict(BASE, **extra))
    params = jax.tree.map(jnp.asarray,
                          make_params(tr.param_shapes(cfg), 0))
    toks = jnp.asarray(tokens(cfg.vocab, (4, 32), 1))
    loss = lambda p, t: tr.lm_loss(p, t, cfg)
    l1, g1 = jax.value_and_grad(loss)(params, toks)
    sp = jax.device_put(params, tr.param_shardings(cfg, rules))
    sloss = jax.jit(jax.value_and_grad(
        lambda p, t: tr.lm_loss(p, t, cfg, rules)))
    l2, g2 = sloss(sp, toks)
    out[name + "/loss"] = np.float64(l1)
    out[name + "/sharded_loss"] = np.float64(l2)
    out[name + "/norm"] = np.float64(_global_norm(g1))
    for k, v in flat(g1).items():
        out[name + "/grad/" + k] = v
    for k, v in flat(g2).items():
        out[name + "/sharded_grad/" + k] = v

from repro.train.optimizer import AdamWConfig, init_state
from repro.train.train_step import build_train_step
cfg = cfg_of(BASE)
params = jax.tree.map(jnp.asarray, make_params(tr.param_shapes(cfg), 0))
opt = AdamWConfig()
step = build_train_step(lambda p, b: tr.lm_loss(p, b, cfg), opt,
                        n_microbatches=2)
_, state, m = step(params, init_state(opt, params),
                   jnp.asarray(tokens(cfg.vocab, (4, 32), 1)))
out["step/loss"] = np.float64(m["loss"])
out["step/grad_norm"] = np.float64(m["grad_norm"])
for k, v in flat(state["m"]).items():
    out["step/m/" + k] = v

cfg = cfg_of(SERVE)
params = jax.tree.map(jnp.asarray, make_params(tr.param_shapes(cfg), 2))
toks = tokens(cfg.vocab, (SERVE_B, SERVE_P + SERVE_N), 3)
logits, cache = tr.prefill(params, jnp.asarray(toks[:, :SERVE_P]), cfg,
                           pad_cache_to=SERVE_P + SERVE_N)
out["serve/prefill"] = np.asarray(logits)
for i in range(SERVE_N):
    logits, cache = tr.decode_step(params, cache,
                                   jnp.asarray(toks[:, SERVE_P + i]),
                                   jnp.int32(SERVE_P + i), cfg)
    out[f"serve/decode{i}"] = np.asarray(logits)

for E in (4, 3):
    x, w = moe_inputs(E)
    p = nn.MoEParams(*(jnp.asarray(a) for a in w))
    out[f"grouped{E}"] = np.asarray(nn.moe_layer_grouped(
        jnp.asarray(x), p, GROUPED["top_k"], GROUPED["capacity_factor"], 2))
np.savez(OUT, **out)
"""

_PORT = _SHARED + """
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import layers as nn, transformer as tr
from repro_torch.models.sharding import lm_rules, whole
from repro_torch.train.optimizer import _global_norm, named_leaves
mesh = make_host_mesh((2, 2), ("data", "model"), device="cpu")
rules = lm_rules(mesh)
out = {}


def cfg_of(kw):
    kw = dict(kw)
    if "moe" in kw:
        kw["moe"] = tr.MoECfg(**kw["moe"])
    kw["layer_pattern"] = tuple(kw.get("layer_pattern", ("G",)))
    return tr.LMConfig(dtype="float32", **kw)


for name, extra in CASES.items():
    cfg = cfg_of(dict(BASE, **extra))
    tree = make_params(tr.param_shapes(cfg), 0)
    params = tr.params_from_numpy(tree, cfg, device="cpu").tree()
    sp = tr.shard_params(params, tr.param_shardings(cfg, rules))
    leaves = [v.requires_grad_() for _, v in named_leaves(sp)]
    toks = torch.from_numpy(tokens(cfg.vocab, (4, 32), 1))
    loss = tr.lm_loss(sp, toks, cfg, rules)
    grads = torch.autograd.grad(loss, leaves)
    out[name + "/sharded_loss"] = np.float64(loss.item())
    out[name + "/norm"] = np.float64(_global_norm(list(grads)).item())
    for (k, _), g in zip(named_leaves(sp), grads):
        out[name + "/sharded_grad/" + k] = whole(g).numpy()
        out[name + "/grad_placements/" + k] = np.array(str(g.placements))

from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.train.optimizer import AdamWConfig, init_state
from repro_torch.train.train_step import build_train_step
cfg = cfg_of(BASE)
sp = tr.shard_params(tr.params_from_numpy(make_params(tr.param_shapes(cfg),
                                                      0), cfg,
                                          device="cpu").tree(),
                     tr.param_shardings(cfg, rules))
opt = AdamWConfig()
state = init_state(opt, sp)
step = build_train_step(lambda p, b: tr.lm_loss(p, b, cfg, rules), opt,
                        n_microbatches=2)
batch = distribute_tensor(torch.from_numpy(tokens(cfg.vocab, (4, 32), 1)),
                          mesh, [Shard(0), Replicate()], src_data_rank=None)
_, state, m = step(sp, state, batch)
out["step/loss"] = np.float64(m["loss"].item())
out["step/grad_norm"] = np.float64(m["grad_norm"].item())
for k, v in named_leaves(state["m"]):
    out["step/m/" + k] = whole(v).numpy()
    out["step/m_placements/" + k] = np.array(str(list(v.placements)))

cfg = cfg_of(SERVE)
params = tr.params_from_numpy(make_params(tr.param_shapes(cfg), 2), cfg,
                              device="cpu").tree()
sp = tr.shard_params(params, tr.param_shardings(cfg, rules))
toks = torch.from_numpy(tokens(cfg.vocab, (SERVE_B, SERVE_P + SERVE_N), 3))
with torch.no_grad():
    logits, cache = tr.prefill(sp, toks[:, :SERVE_P], cfg, rules,
                               pad_cache_to=SERVE_P + SERVE_N)
    out["serve/prefill"] = whole(logits).numpy()
    for i in range(SERVE_N):
        logits, cache = tr.decode_step(sp, cache, toks[:, SERVE_P + i],
                                       SERVE_P + i, cfg, rules)
        out[f"serve/decode{i}"] = whole(logits).numpy()
for k, v in cache.items():
    out["serve/placements/" + k] = np.array(str(list(v.placements)))
    out["serve/local_shape/" + k] = np.array(v.to_local().shape)

for E in (4, 3):
    x, w = moe_inputs(E)
    specs = {"router": ("fsdp", None), "w1": ("expert_ep", "fsdp", "d_ff"),
             "w3": ("expert_ep", "fsdp", "d_ff"),
             "w2": ("expert_ep", "d_ff", "fsdp")}
    p = nn.MoEParams(*(tr.shard_params(torch.from_numpy(a),
                                       rules.named_sharding(*specs[k],
                                                            shape=a.shape))
                       for k, a in zip(nn.MoEParams._fields, w)))
    g = mesh.get_local_rank("data")
    T = GROUPED["tokens"]
    y = nn.moe_layer_grouped(torch.from_numpy(x[g * T:(g + 1) * T]), p,
                             GROUPED["top_k"], GROUPED["capacity_factor"], 2,
                             rules)
    parts = [torch.empty_like(y) for _ in range(4)]
    dist.all_gather(parts, y)
    out[f"grouped{E}"] = torch.cat([parts[0], parts[2]]).numpy()
    out[f"grouped{E}/placements"] = np.array(str(list(p.w1.placements)))
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


# ---------------------------------------------------------------------------
# the layout tables, in process
# ---------------------------------------------------------------------------

ARCHS = ("minitron-4b", "qwen2-1.5b", "gemma3-27b",
         "llama4-maverick-400b-a17b", "mixtral-8x22b")
MESHES = {"pod": ((16, 16), ("data", "model")),
          "multi_pod": ((2, 16, 16), ("pod", "data", "model"))}


def _configs(arch):
    from repro.configs import lm as jlm
    from repro_torch.configs import lm as tlm

    name = {"minitron-4b": "minitron_4b", "qwen2-1.5b": "qwen2_1_5b",
            "gemma3-27b": "gemma3_27b",
            "llama4-maverick-400b-a17b": "llama4_maverick",
            "mixtral-8x22b": "mixtral_8x22b"}[arch]
    return getattr(jlm, name)(), getattr(tlm, name)()


def _dict_leaves(tree, prefix=""):
    """{"a/b": leaf} of a tree of nested dicts (tuples are leaves)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_dict_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _spec_tuple(spec):
    return tuple(tuple(a) if isinstance(a, (list, tuple)) else a
                 for a in spec)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_shardings_match_reference_at_full_width(arch, mesh):
    """``spec`` through ``param_shardings`` and ``cache_shardings`` at full
    width on the production meshes' sizes: leaf for leaf the reference's
    PartitionSpec, and the placements its DTensor form (a dim over ("pod",
    "data") Shard on both)."""
    from jax.sharding import AbstractMesh

    from repro.models import sharding as jsh
    from repro.models import transformer as jtr
    from repro_torch.models import sharding as tsh
    from repro_torch.models import transformer as ttr

    shape, axes = MESHES[mesh]
    jcfg, tcfg = _configs(arch)
    jrules = jsh.lm_rules(AbstractMesh(shape, axes))
    trules = tsh.lm_rules(tsh.AbstractMesh(shape, axes))
    want = {k: _spec_tuple(v.spec) for k, v in
            _dict_leaves(jtr.param_shardings(jcfg, jrules)).items()}
    got = _dict_leaves(ttr.param_specs(tcfg, trules))
    assert got.keys() == want.keys()
    for k in want:
        assert _spec_tuple(got[k]) + (None,) * (len(want[k]) - len(got[k])) \
            == want[k] + (None,) * (len(got[k]) - len(want[k])), (k, got[k],
                                                                  want[k])
    placed = _dict_leaves(ttr.param_shardings(tcfg, trules))
    for k, spec in got.items():
        assert placed[k][1] == trules.placements(spec), k
    jc = jtr.cache_shardings(jcfg, 128, 32768, jrules)
    tc = ttr.cache_shardings(tcfg, 128, 32768, trules)
    for k in jc:
        spec = trules.spec(None, *ttr._cache_slice_dims(
            128, tcfg.n_kv_heads, trules), shape=ttr.cache_shapes(
                tcfg, 128, 32768)[k][0])
        assert _spec_tuple(spec) == _spec_tuple(jc[k].spec) + (None,) * (
            len(spec) - len(jc[k].spec)), k
        assert tc[k][1] == trules.placements(spec)


def test_spec_drops_and_placements():
    """The rules' two drops (a mapping that does not divide its dim, a mesh
    dim an earlier dim claimed) and the pod-major placements."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.models.sharding import AbstractMesh, lm_rules

    r = lm_rules(AbstractMesh((2, 16, 16), ("pod", "data", "model")))
    # mixtral's 8 experts: EP does not divide 32, fsdp takes the data axes
    assert r.spec("expert_ep", "fsdp", "d_ff", shape=(8, 6144, 16384)) == \
        (None, ("pod", "data"), "model")
    # llama4's 128 experts take EP; fsdp finds its axes claimed
    assert r.spec("expert_ep", "fsdp", "d_ff", shape=(128, 5120, 8192)) == \
        (("pod", "data"), None, "model")
    assert r.placements((("pod", "data"), None, "model")) == \
        [Shard(0), Shard(0), Shard(2)]
    assert r.placements((None, None)) == [Replicate()] * 3


# ---------------------------------------------------------------------------
# four gloo ranks against the reference's sharded and unsharded programs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_lm_loss_and_grads_match_reference(runs, case):
    """The sharded ``lm_loss`` and every gradient (whole) on (data 2, model
    2) within rel 2e-4 of the reference's sharded (Auto mesh) and, where
    the layout does not change the function, unsharded programs; the
    gradients come back in the parameters' placements."""
    ref, port = runs["ref"], runs["port"]
    got = float(port[case + "/sharded_loss"])
    assert got == pytest.approx(float(ref[case + "/sharded_loss"]), rel=2e-4)
    grouped = "grouped" in case         # groups of 2 route as the mesh does
    if not grouped:
        assert got == pytest.approx(float(ref[case + "/loss"]), rel=2e-4)
    keys = [k for k in ref if k.startswith(case + "/grad/")]
    assert keys
    for k in keys:
        leaf = k[len(case + "/grad/"):]
        g = port[case + "/sharded_grad/" + leaf]
        assert _rel(g, ref[case + "/sharded_grad/" + leaf]) <= 2e-4, leaf
        if not grouped:
            assert _rel(g, ref[k]) <= 2e-4, leaf
    assert "Shard(dim=0)" in str(port[case + "/grad_placements/embed"])


def test_clip_global_norm_over_shards(runs):
    """``_global_norm`` of the sharded gradients (DTensors: each leaf's
    squares summed over its shards, a replicated leaf such as a norm gain
    once) against the reference's ``_global_norm`` of the unsharded
    gradients."""
    for case in ("dense", "moe", "heads_3_of_1"):
        assert float(runs["port"][case + "/norm"]) == pytest.approx(
            float(runs["ref"][case + "/norm"]), rel=1e-5)


def test_sharded_prefill_and_decode_with_a_batch_that_does_not_divide(runs):
    """B = 3 over data 2: the caches' sequence over data (``seq_shard``);
    one KV head over model 2: d_head over model.  Prefill and decode
    logits against the reference's unsharded ones, each cache in that
    layout (its local block a quarter of it)."""
    ref, port = runs["ref"], runs["port"]
    for k in ["serve/prefill"] + [f"serve/decode{i}" for i in range(SERVE_N)]:
        assert _rel(port[k], ref[k]) <= 2e-4, k
    for name in ("global_k", "local_v"):
        assert str(port["serve/placements/" + name]) == \
            "[Shard(dim=2), Shard(dim=4)]"
    g = port["serve/local_shape/global_k"]
    assert list(g) == [1, SERVE_B, (SERVE_P + SERVE_N) // 2, 1,
                       SERVE["d_head"] // 2]


def test_sharded_train_step_microbatches_the_local_batch(runs):
    """``build_train_step`` on the sharded parameters with 2 microbatches of
    a batch given as a DTensor over its rows (each rank's microbatches cut
    from its own rows) against the reference's microbatched step on the
    unsharded parameters: the loss (a mean over the whole batch either way),
    grad_norm and the first moments (the clipped gradient), which keep the
    parameters' placements."""
    ref, port = runs["ref"], runs["port"]
    assert float(port["step/loss"]) == pytest.approx(
        float(ref["step/loss"]), rel=1e-5)
    assert float(port["step/grad_norm"]) == pytest.approx(
        float(ref["step/grad_norm"]), rel=1e-4)
    keys = [k for k in ref if k.startswith("step/m/")]
    assert len(keys) == 11
    for k in keys:
        assert _rel(port[k], ref[k]) <= 2e-4, k
    assert str(port["step/m_placements/layers/wq"]) == \
        "[Shard(dim=1), Shard(dim=2)]"


@pytest.mark.parametrize("E", [4, 3])
def test_grouped_dispatch_matches_reference(runs, E):
    """``moe_layer_grouped`` on each data rank's group over (data 2, model
    2) against the reference's one-device ``moe_layer_grouped(n_groups=2)``:
    E = 4 takes EP over data (an all-to-all of each group's slots), E = 3
    stays whole over data (FSDP); d_ff over model either way."""
    assert _rel(runs["port"][f"grouped{E}"], runs["ref"][f"grouped{E}"]) \
        <= 1e-5
    placed = str(runs["port"][f"grouped{E}/placements"])
    assert placed == ("[Shard(dim=0), Shard(dim=2)]" if E == 4
                      else "[Shard(dim=1), Shard(dim=2)]")
