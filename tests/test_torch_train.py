"""The port's training substrate against the JAX package, on the CPU.

``apply_updates`` against the reference's on the same parameters,
gradients and state; the reference's ``tests/test_train_fault.py`` cases on
the port (``test_elastic_restore_reshards`` in gloo ranks and a world of
one: ``test_restore_with_shardings_names_the_sharding_bullet``); three
train steps of a reduced qwen2 from the same carried
state and batches; checkpoints written by one package and restored by the
other, bf16 included; ``launch.train`` in process.  Each tolerance states
its reason."""
import dataclasses
import io
import json
import math
import os
import tempfile
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import lm as jlm  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.train import checkpoint as jck  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train.train_step import build_train_step as jbuild  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.data.lm import TokenStream  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.train import checkpoint as ck  # noqa: E402
from repro_torch.train.fault import (Journal, StragglerWatchdog,  # noqa: E402
                                     TrainController)
from repro_torch.train.optimizer import (AdamWConfig, apply_updates,  # noqa: E402
                                         init_state, named_leaves,
                                         state_from_numpy)
from repro_torch.train.train_step import (build_eval_step,  # noqa: E402
                                          build_train_step)


def _bits(x):
    """A leaf's bits as an integer array (bf16 from torch, from
    ``ml_dtypes`` or raw ``|V2`` records alike), for exact comparison."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    x = np.asarray(x)
    if x.dtype.itemsize == 2 and x.dtype.kind in "Vf":
        return x.view(np.int16)
    return x


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


# -- apply_updates against the reference -------------------------------------

def _opt_problem(seed, param_dtype):
    """Parameters of every rank the ndim rule sees (a matrix, a stacked
    (L, D) norm, a bias, a 3-D stack) and three steps' gradients, scaled so
    that the first step clips."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (4, 8), "norm": (3, 8), "b": (8,), "stack": (2, 3, 4)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * scale).astype(np.float32)
              for k, s in shapes.items()} for scale in (3.0, 0.05, 0.2)]
    jp = {k: jnp.asarray(v, param_dtype) for k, v in params.items()}
    tp = {k: torch.from_numpy(np.array(v, np.float32)).to(
        tr.as_torch_dtype(param_dtype)) for k, v in jp.items()}
    return jp, tp, grads


OPT_CASES = {
    "clip_warmup": dict(lr=1e-2, warmup_steps=10, clip_norm=1.0),
    "no_clip": dict(lr=1e-2, warmup_steps=1, clip_norm=None),
    "bf16_moments": dict(lr=1e-2, warmup_steps=3,
                         moments_dtype="bfloat16"),
    "compress": dict(lr=1e-2, warmup_steps=2, compress_grads=True),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_apply_updates_matches_jax(case):
    """Three AdamW steps on the same parameters, gradients and state:
    parameters, moments, the residual, the count and the metrics within
    rel 1e-6 of each array's max (float32 sums of the global norm in other
    orders; the elementwise update is the same IEEE arithmetic)."""
    kw = OPT_CASES[case]
    jcfg, cfg = jopt.AdamWConfig(**kw), AdamWConfig(**kw)
    jp, tp, grads = _opt_problem(7, jnp.float32)
    jstate, state = jopt.init_state(jcfg, jp), init_state(cfg, tp)
    for g in grads:
        jp, jstate, jm = jopt.apply_updates(
            jcfg, jp, {k: jnp.asarray(v) for k, v in g.items()}, jstate)
        tp2, state2, m = apply_updates(
            cfg, tp, {k: torch.from_numpy(v) for k, v in g.items()}, state)
        assert tp2 is tp and state2 is state    # in place
        for key in ("grad_norm", "lr"):
            assert m[key].dtype == torch.float32
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-6)
    assert int(state["count"]) == int(jstate["count"]) == 3
    assert state["count"].dtype == torch.int32
    pairs = [(tp, jp), (state["m"], jstate["m"]), (state["v"], jstate["v"])]
    if cfg.compress_grads:
        pairs.append((state["ef_residual"], jstate["ef_residual"]))
    for ours, theirs in pairs:
        for k in theirs:
            assert str(ours[k].dtype).removeprefix("torch.") == \
                str(theirs[k].dtype)
            want = _np(theirs[k])
            err = np.abs(_np(ours[k]) - want).max() / np.abs(want).max()
            assert err <= 1e-6, (case, k, err)


def test_apply_updates_bf16_params_match_jax():
    """bf16 parameters (the float32 update cast back, as the reference):
    two steps below the clip, so the clip factor is 1 and the elementwise
    arithmetic is the reference's; parameters equal in bits."""
    kw = dict(lr=1e-2, warmup_steps=1, clip_norm=100.0)
    jcfg, cfg = jopt.AdamWConfig(**kw), AdamWConfig(**kw)
    jp, tp, grads = _opt_problem(8, jnp.bfloat16)
    jstate, state = jopt.init_state(jcfg, jp), init_state(cfg, tp)
    for g in grads[1:]:
        jp, jstate, _ = jopt.apply_updates(
            jcfg, jp, {k: jnp.asarray(v, jnp.bfloat16) for k, v in g.items()},
            jstate)
        apply_updates(cfg, tp, {k: torch.from_numpy(v).to(torch.bfloat16)
                                for k, v in g.items()}, state)
    for k in jp:
        assert tp[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(tp[k]), _bits(jp[k]))


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_apply_updates_in_row_slices_keeps_the_bits(case, monkeypatch):
    """With ``SLICE_ENTRIES`` lowered to 100, a table of 300 × 18 entries
    (and the problem's other leaves above 100 entries) is updated in row
    slices: three steps give parameters, moments, the residual, the count
    and the metrics ``torch.equal`` to the whole-leaf update (the
    default), and the caller's gradients are left as they were."""
    from repro_torch.train import optimizer as topt

    cfg = AdamWConfig(**OPT_CASES[case])
    rng = np.random.default_rng(11)
    _, base, grads = _opt_problem(9, jnp.float32)
    base["table"] = torch.from_numpy(
        rng.standard_normal((300, 18)).astype(np.float32))
    for g in grads:
        g["table"] = (rng.standard_normal((300, 18)) * 2).astype(np.float32)
    runs = []
    for limit in (topt.SLICE_ENTRIES, 100):
        monkeypatch.setattr(topt, "SLICE_ENTRIES", limit)
        params = {k: v.clone() for k, v in base.items()}
        state = init_state(cfg, params)
        metrics = []
        for g in grads:
            tg = {k: torch.from_numpy(v.copy()) for k, v in g.items()}
            _, _, m = apply_updates(cfg, params, tg, state)
            for k, v in g.items():
                assert np.array_equal(tg[k].numpy(), v), k
            metrics.append(m)
        runs.append((params, state, metrics))
    (p1, s1, m1), (p2, s2, m2) = runs
    assert len(topt._row_slices(p2["table"], 100)) == 60
    for a, b in zip(m1, m2):
        assert all(torch.equal(a[k], b[k]) for k in a)
    trees = [(p1, p2), (s1["m"], s2["m"]), (s1["v"], s2["v"])]
    if cfg.compress_grads:
        trees.append((s1["ef_residual"], s2["ef_residual"]))
    for a, b in trees:
        for k in a:
            assert torch.equal(a[k], b[k]), (case, k)
    assert torch.equal(s1["count"], s2["count"])


def test_named_leaves_follow_jax_order():
    tree = {"z": torch.zeros(1), "a": {"y": torch.ones(2), "b": [
        torch.zeros(3), torch.ones(4)]}, "n": None}
    jtree = jax.tree.map(lambda t: np.asarray(t), {
        "z": np.zeros(1), "a": {"y": np.ones(2), "b": [np.zeros(3),
                                                          np.ones(4)]},
        "n": None})
    keys = [k for k, _ in named_leaves(tree)]
    assert keys == ["a/b/0", "a/b/1", "a/y", "z"]
    assert [v.shape for v in jax.tree.leaves(jtree)] == \
        [tuple(v.shape) for _, v in named_leaves(tree)]


# -- the reference's tests/test_train_fault.py on the port -------------------

def quad_loss(params, batch):
    return torch.sum((params["w"] @ batch["x"] - batch["y"]) ** 2)


def _loss_value(params, batch):
    with torch.no_grad():
        return float(quad_loss(params, batch))


def make_problem(seed=0):
    rng = np.random.default_rng(seed)
    w_true = rng.standard_normal((4, 8)).astype(np.float32)
    x = rng.standard_normal((8, 32)).astype(np.float32)
    y = w_true @ x
    params = {"w": torch.zeros((4, 8))}
    batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    return params, batch


def _grad_step(oc, params, batch, state):
    params["w"].requires_grad_(True)
    loss = quad_loss(params, batch)
    (g,) = torch.autograd.grad(loss, [params["w"]])
    return apply_updates(oc, params, {"w": g}, state)


def test_adamw_converges():
    params, batch = make_problem()
    oc = AdamWConfig(lr=3e-2, weight_decay=0.0, warmup_steps=1)
    state = init_state(oc, params)
    l0 = _loss_value(params, batch)
    for _ in range(200):
        params, state, _ = _grad_step(oc, params, batch, state)
    assert _loss_value(params, batch) < 1e-2 * l0


def test_grad_compression_error_feedback_converges():
    params, batch = make_problem(1)
    oc = AdamWConfig(lr=3e-2, weight_decay=0.0, warmup_steps=1,
                     compress_grads=True)
    state = init_state(oc, params)
    l0 = _loss_value(params, batch)
    for _ in range(300):
        params, state, _ = _grad_step(oc, params, batch, state)
    assert _loss_value(params, batch) < 1e-1 * l0


def test_microbatch_equals_full_batch():
    params, _ = make_problem(2)
    oc = AdamWConfig(lr=1e-2, warmup_steps=1)

    def loss_fn(p, b):
        return torch.mean((b["x"] @ p["w"].T - b["y"]) ** 2)
    rng = np.random.default_rng(3)
    b = {"x": torch.as_tensor(rng.standard_normal((8, 8)), dtype=torch.float32),
         "y": torch.as_tensor(rng.standard_normal((8, 4)), dtype=torch.float32)}
    s1 = build_train_step(loss_fn, oc, n_microbatches=1)
    s2 = build_train_step(loss_fn, oc, n_microbatches=4)
    p1 = {"w": params["w"].clone()}
    p2 = {"w": params["w"].clone()}
    p1, st1, m1 = s1(p1, init_state(oc, p1), b)
    p2, st2, m2 = s2(p2, init_state(oc, p2), b)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(_np(p1["w"]), _np(p2["w"]), rtol=1e-4,
                               atol=1e-6)


def test_checkpoint_roundtrip_and_prune():
    with tempfile.TemporaryDirectory() as d:
        tree = {"a": torch.arange(5), "b": {"c": torch.ones((2, 3))},
                "lst": [torch.zeros(2), torch.ones(3)]}
        for s in (1, 2, 3, 4):
            ck.save(d, s, tree, extra={"note": f"s{s}"})
        ck.prune(d, keep=2)
        assert ck.latest_step(d) == 4
        step, restored, extra = ck.restore(d, device="cpu")
        assert step == 4 and extra["note"] == "s4"
        assert torch.equal(restored["a"], tree["a"])
        assert torch.equal(restored["lst"][1], tree["lst"][1])
        assert not os.path.exists(os.path.join(d, "ckpt_00000001.npz"))


def test_async_checkpointer():
    with tempfile.TemporaryDirectory() as d:
        saver = ck.AsyncCheckpointer(d)
        saver.save(7, {"x": torch.full((128,), 3.0)})
        saver.wait()
        step, tree, _ = ck.restore(d, device="cpu")
        assert step == 7
        assert torch.all(tree["x"] == 3.0)


def test_async_checkpointer_snapshots_before_returning():
    """The trainer updates its tensors in place right after ``save``
    returns: the checkpoint holds the values at the call, bf16 included."""
    with tempfile.TemporaryDirectory() as d:
        x = torch.full((1 << 16,), 3.0)
        y = torch.full((8,), 1.5, dtype=torch.bfloat16)
        saver = ck.AsyncCheckpointer(d)
        saver.save(1, {"x": x, "y": y})
        x.add_(1.0)
        y.mul_(2.0)
        saver.wait()
        _, tree, _ = ck.restore(d, device="cpu")
        assert torch.all(tree["x"] == 3.0)
        assert tree["y"].dtype == torch.bfloat16 and torch.all(tree["y"] == 1.5)


_ELASTIC_SAVE = """
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.configs import lm as lm_configs
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as tr
from repro_torch.models.sharding import lm_rules, whole
from repro_torch.train import checkpoint as ck
from repro_torch.train.optimizer import named_leaves
CK = CK_DIR
cfg = lm_configs.reduced_lm("qwen2-1.5b")
mesh = make_host_mesh((2, 2), ("data", "model"), device="cpu")
params = tr.init_params(cfg, torch.Generator().manual_seed(0),
                        device="cpu").tree()
w = torch.arange(16.0).reshape(4, 4)
b = torch.arange(8.0).to(torch.bfloat16)
tree = {"params": tr.shard_params(params, tr.param_shardings(
            cfg, lm_rules(mesh))),
        "w": distribute_tensor(w, mesh, [Shard(0), Shard(1)],
                               src_data_rank=None),
        "b": distribute_tensor(b, mesh, [Replicate(), Shard(0)],
                               src_data_rank=None),
        "count": torch.tensor(3, dtype=torch.int32)}
ck.save(CK, 7, tree)
# onto (4, 1): the TARGET mesh decides placement
mesh41 = make_host_mesh((4, 1), ("data", "model"), device="cpu")
ps = tr.param_shardings(cfg, lm_rules(mesh41))
step, got, _ = ck.restore(CK, device="cpu", shardings={
    "params": ps, "w": (mesh41, [Shard(1), Replicate()]),
    "b": (mesh41, [Shard(0), Replicate()]), "count": None})
out = {"step": np.int64(step)}
for (k, a), (_, e) in zip(named_leaves(got), named_leaves(tree)):
    out["equal/" + k] = np.bool_(torch.equal(whole(a), whole(e)))
    out["placed/" + k] = np.bool_(
        getattr(a, "device_mesh", mesh41) is mesh41)
out["w_local"] = got["w"].to_local().numpy()
out["embed_placements"] = np.array(str(list(got["params"]["embed"].placements)))
out["want_embed"] = str(list(ps["embed"][1]))
if RANK == 0:
    np.savez(OUT, **out)
"""

_ELASTIC_ONE = """
import torch
from torch.distributed.tensor import Shard
from repro_torch.configs import lm as lm_configs
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as tr
from repro_torch.models.sharding import lm_rules
from repro_torch.train import checkpoint as ck
cfg = lm_configs.reduced_lm("qwen2-1.5b")
mesh = make_host_mesh((1, 1), device="cpu")
sh = {"w": (mesh, [Shard(0), Shard(1)])}
step, got, _ = ck.restore(CK_DIR, device="cpu", shardings={
    "params": tr.param_shardings(cfg, lm_rules(mesh)), "count": None,
    "w": (mesh, [Shard(0), Shard(1)]), "b": None})
np.savez(OUT, step=np.int64(step), w=got["w"].to_local().numpy(),
         embed=got["params"]["embed"].to_local().numpy(),
         placed=np.bool_(got["w"].device_mesh is mesh
                         and list(got["w"].placements) == sh["w"][1]),
         b=got["b"].float().numpy())
"""


def test_restore_with_shardings_names_the_sharding_bullet():
    """The elastic restore (``restore(shardings=...)``, which raised naming
    the sharding bullet before it was ported): a state saved from a (data 2,
    model 2) mesh by four gloo ranks (DTensor leaves gathered whole, rank 0
    writing) restores onto a (4, 1) mesh of the same ranks and onto a (1, 1)
    mesh of a world of one (the reference's
    ``test_elastic_restore_reshards``): each leaf a DTensor of the target's
    mesh and placements, array-equal to the saved one; the reference's
    ``restore`` reads the same file."""
    from tests._torch_ranks import Job

    with tempfile.TemporaryDirectory() as d:
        ckdir = os.path.join(d, "ck")
        four = Job("save4", d, _ELASTIC_SAVE.replace("CK_DIR", repr(ckdir)),
                   ranks=4).result()
        one = Job("one", d, _ELASTIC_ONE.replace("CK_DIR", repr(ckdir))
                  ).result()
        assert int(four["step"]) == 7
        equal = {k: bool(v) for k, v in four.items() if k.startswith("equal/")}
        assert equal and all(equal.values()), equal
        assert all(bool(v) for k, v in four.items() if k.startswith("placed/"))
        assert str(four["embed_placements"]) == str(four["want_embed"])
        # rank 0's block on (4, 1) with [Shard(1), Replicate()]: column 0
        np.testing.assert_array_equal(four["w_local"],
                                      np.arange(16.0).reshape(4, 4)[:, :1])
        w = np.arange(16.0).reshape(4, 4)
        assert int(one["step"]) == 7 and bool(one["placed"])
        np.testing.assert_array_equal(one["w"], w)
        np.testing.assert_array_equal(one["b"], np.arange(8.0))
        step, ref, _ = jck.restore(ckdir)
        assert step == 7
        np.testing.assert_array_equal(np.asarray(ref["w"]), w)
        # bf16 as the reference's own |V2 records, its bits the saved ones
        assert ref["b"].dtype == np.dtype("V2")
        np.testing.assert_array_equal(
            _bits(ref["b"]), _bits(torch.arange(8.0).to(torch.bfloat16)))
        np.testing.assert_array_equal(np.asarray(ref["params"]["embed"]),
                                      one["embed"])
        assert int(ref["count"]) == 3


def test_resume_lands_where_init_fn_puts_the_state():
    """``resume_or_init`` and ``restore`` put a restored state on the card
    unless the caller names another device, as ``init_fn``'s state is put
    there everywhere in the port: on the CPU the caller says so and the
    resumed state lies where ``init_fn``'s did; without a card the default
    raises instead of training on the CPU."""
    with tempfile.TemporaryDirectory() as d:
        def step_fn(state, batch):
            return {"w": state["w"] + 1.0}, {"loss": float(state["w"].sum())}

        init_fn = lambda: {"w": torch.zeros(4, device="cpu")}
        ctl = TrainController(step_fn, d, ckpt_every=2,
                              install_signal_handler=False)
        s0, state = ctl.resume_or_init(init_fn, device="cpu")
        first = state["w"].device
        ctl.run(state, iter(range(10)), s0, 2)
        ctl2 = TrainController(step_fn, d, ckpt_every=2,
                               install_signal_handler=False)
        s2, state2 = ctl2.resume_or_init(init_fn, device="cpu")
        assert s2 == 2 and state2["w"].device == first
        assert torch.equal(state2["w"], torch.full((4,), 2.0))
        if torch.cuda.is_available():
            _, on_card = ctl2.resume_or_init(init_fn)
            assert on_card["w"].device.type == "cuda"
            assert ck.restore(d)[1]["w"].device.type == "cuda"
        else:
            with pytest.raises((AssertionError, RuntimeError),
                               match="(?i)cuda|gpu|nvidia"):
                ctl2.resume_or_init(init_fn)
            with pytest.raises((AssertionError, RuntimeError),
                               match="(?i)cuda|gpu|nvidia"):
                ck.restore(d)


def test_controller_resume_and_preemption():
    with tempfile.TemporaryDirectory() as d:
        calls = {"n": 0}

        def step_fn(state, batch):
            calls["n"] += 1
            return state + 1, {"loss": float(state)}

        batches = iter(range(10 ** 9))
        sentinel = os.path.join(d, "preempt")
        ctl = TrainController(step_fn, d, ckpt_every=3,
                              preemption_sentinel=sentinel,
                              install_signal_handler=False)
        s0, state = ctl.resume_or_init(lambda: torch.tensor(0),
                                      device="cpu")
        s1, state, stop = ctl.run(state, batches, s0, 5)
        assert s1 == 5 and stop == "completed"
        ctl2 = TrainController(step_fn, d, ckpt_every=3,
                               preemption_sentinel=sentinel,
                               install_signal_handler=False)
        s2, state2 = ctl2.resume_or_init(lambda: torch.tensor(0),
                                      device="cpu")
        assert s2 == 5 and int(state2) == 5
        open(sentinel, "w").close()
        s3, _, stop3 = ctl2.run(state2, batches, s2, 5)
        assert stop3 == "preempted" and s3 == 5


def test_controller_straggler_requests_restart():
    """A step slowed past the watchdog's factor (``inject_slow_step``)
    stops the run with a checkpoint at the next step."""
    import time

    def step_fn(state, batch):
        time.sleep(0.02)           # the slow step sleeps 0.25 s more
        return state + 1, {"loss": 0.0}

    with tempfile.TemporaryDirectory() as d:
        ctl = TrainController(step_fn, d, ckpt_every=100,
                              install_signal_handler=False)
        ctl.watchdog = StragglerWatchdog(factor=8.0, max_consecutive=1,
                                         warmup=2)
        step, state, stop = ctl.run(torch.tensor(0), iter(range(10)), 0, 8,
                                    inject_slow_step=3)
        assert stop == "restart_requested" and step == 4
        assert ck.latest_step(d) == 4 and ctl.restart_requested
        assert ctl.journal.read()[-1]["event"] == "restart_requested"


def test_straggler_watchdog():
    wd = StragglerWatchdog(factor=2.0, max_consecutive=2, warmup=3)
    events = [wd.observe(0.1) for _ in range(5)]
    assert all(e is None for e in events)
    assert wd.observe(0.5) == "straggler"
    assert wd.observe(0.5) == "restart_requested"
    assert wd.observe(0.1) is None


def test_journal_roundtrip():
    with tempfile.TemporaryDirectory() as d:
        j = Journal(os.path.join(d, "j.jsonl"))
        j.append({"step": 1, "loss": 2.0})
        j.append({"step": 2, "event": "straggler"})
        recs = j.read()
        assert len(recs) == 2 and recs[1]["event"] == "straggler"


# -- train steps of a reduced qwen2 against the reference ---------------------

def _reduced_both(arch="qwen2-1.5b"):
    kw = dict(dataclasses.asdict(jlm.reduced_lm(arch)))
    moe = kw.pop("moe")
    jcfg = jtr.LMConfig(**kw, moe=jtr.MoECfg(**moe) if moe else None)
    cfg = tr.LMConfig(**kw, moe=tr.MoECfg(**moe) if moe else None)
    return jcfg, cfg


# lr 3e-3 with a warm-up of 2 steps, so the three steps move the loss
TRAIN_OPT = dict(lr=3e-3, warmup_steps=2)


def _jax_steps(jcfg, jparams, jstate, batches, n_microbatches=1):
    step = jax.jit(jbuild(lambda p, b: jtr.lm_loss(p, b, jcfg),
                          jopt.AdamWConfig(**TRAIN_OPT), n_microbatches))
    losses = []
    for b in batches:
        jparams, jstate, m = step(jparams, jstate, jnp.asarray(b))
        losses.append(float(m["loss"]))
    return jparams, jstate, losses


def _port_steps(cfg, params, state, batches, n_microbatches=1):
    step = build_train_step(lambda p, b: tr.lm_loss(p, b, cfg),
                            AdamWConfig(**TRAIN_OPT), n_microbatches)
    losses = []
    for b in batches:
        params, state, m = step(params, state, torch.from_numpy(b))
        losses.append(float(m["loss"]))
    return params, state, losses


@pytest.mark.parametrize("n_microbatches", [1, 2])
def test_train_steps_match_jax(n_microbatches):
    """Three train steps of the reduced qwen2 (float32) from the reference's
    init carried over, on the same batches: losses within rel 1e-4 (the
    forward's float32 sums in other orders, through two updates).  Every
    parameter entry within 2·Σ_t lr_t of the reference's plus rel 1e-4 of
    its leaf's max: Adam's step m̂/(√v̂ + ε) is ±lr where the gradient is
    near 0 and its sign follows roundoff, so such an entry may land up to
    2·lr a step away; 99.9% of the entries within 1e-5 of the leaf's max."""
    jcfg, cfg = _reduced_both()
    jparams = jtr.init_params(jcfg, jax.random.PRNGKey(0))
    jstate = jopt.init_state(jopt.AdamWConfig(**TRAIN_OPT), jparams)
    params, state = state_from_numpy(jax.tree.map(np.asarray, jparams),
                                     jax.tree.map(np.asarray, jstate), cfg,
                                     device="cpu")
    batches = [b.astype(np.int32) for b, _ in zip(
        TokenStream(cfg.vocab, 4, 32, seed=3), range(3))]
    jparams, jstate, jlosses = _jax_steps(jcfg, jparams, jstate, batches,
                                          n_microbatches)
    params, state, losses = _port_steps(cfg, params, state, batches,
                                        n_microbatches)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    lr_sum = sum(TRAIN_OPT["lr"] * min(1.0, (t + 1) / TRAIN_OPT["warmup_steps"])
                 for t in range(3))
    jflat = dict(named_leaves(jax.tree.map(np.asarray, jparams)))
    for key, p in named_leaves(params):
        want = jflat[key]
        scale = np.abs(want).max()
        gap = np.abs(_np(p) - want)
        assert gap.max() <= 2 * lr_sum + 1e-4 * scale, (key, gap.max())
        assert np.mean(gap <= 1e-5 * scale) >= 0.999, key
    assert int(state["count"]) == 3


def test_eval_step_gives_the_loss_without_a_graph():
    jcfg, cfg = _reduced_both()
    params = tr.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu").tree()
    toks = torch.from_numpy(TokenStream(cfg.vocab, 2, 32, seed=1).__next__())
    loss = build_eval_step(lambda p, b: tr.lm_loss(p, b, cfg))(params, toks)
    assert loss.grad_fn is None
    assert float(loss) == pytest.approx(math.log(cfg.vocab), rel=0.25)


# -- checkpoints across the packages -----------------------------------------

def _trees():
    rng = np.random.default_rng(11)
    f32 = {"a": rng.standard_normal((3, 4)).astype(np.float32),
           "b": {"c": rng.standard_normal(5).astype(np.float32)},
           "lst": [np.arange(4, dtype=np.int32), np.float32(2.5)]}
    bf16 = {"w": rng.standard_normal((6, 8)).astype(np.float32),
            "n": {"g": rng.standard_normal(8).astype(np.float32)}}
    jf32 = jax.tree.map(jnp.asarray, f32)
    jbf16 = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), bf16)
    return jf32, jbf16


def _manifest(d, step):
    with open(os.path.join(d, f"ckpt_{step:08d}.npz.manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("which", ["float32", "bfloat16"])
def test_reference_checkpoint_restores_in_the_port(which):
    """A checkpoint the reference wrote restores in the port bit for bit
    (bf16 from its raw records as ``torch.bfloat16``); the port saving what
    it restored writes the same manifest."""
    jtree = _trees()[0 if which == "float32" else 1]
    with tempfile.TemporaryDirectory() as d, \
            tempfile.TemporaryDirectory() as d2:
        jck.save(d, 3, jtree, extra={"from": "jax"})
        step, tree, extra = ck.restore(d, device="cpu")
        assert step == 3 and extra == {"from": "jax"}
        jflat = dict(named_leaves(jtree))
        for key, t in named_leaves(tree):
            assert isinstance(t, torch.Tensor)
            if which == "bfloat16":
                assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(_bits(t), _bits(jflat[key]))
        ck.save(d2, 3, tree, extra={"from": "jax"})
        assert _manifest(d2, 3) == _manifest(d, 3)


@pytest.mark.parametrize("which", ["float32", "bfloat16"])
def test_port_checkpoint_restores_in_the_reference(which):
    """A checkpoint the port wrote restores in the reference bit for bit
    (bf16 as the reference's own ``|V2`` records), with the manifest the
    reference writes for the same tree."""
    jtree = _trees()[0 if which == "float32" else 1]
    tree = jax.tree.map(
        lambda x: torch.from_numpy(np.array(x, np.float32)).to(
            tr.as_torch_dtype(x.dtype)), jtree)
    with tempfile.TemporaryDirectory() as d, \
            tempfile.TemporaryDirectory() as d2:
        ck.save(d, 5, tree, extra={"from": "torch"})
        step, restored, extra = jck.restore(d)
        assert step == 5 and extra == {"from": "torch"}
        ours = dict(named_leaves(tree))
        for key, x in named_leaves(restored):
            if which == "bfloat16":
                assert x.dtype == np.dtype("V2")
            np.testing.assert_array_equal(_bits(x), _bits(ours[key]))
        jck.save(d2, 5, jtree, extra={"from": "torch"})
        assert _manifest(d, 5) == _manifest(d2, 5)


def test_reference_training_checkpoint_continues_in_the_port():
    """The reference trains the reduced qwen2 one step and checkpoints
    (params, opt_state); the port restores it (keys ``0/embed``,
    ``1/m/…``, ``1/count``) and takes two more steps to the reference's
    losses within rel 1e-4."""
    jcfg, cfg = _reduced_both()
    jparams = jtr.init_params(jcfg, jax.random.PRNGKey(1))
    jstate = jopt.init_state(jopt.AdamWConfig(**TRAIN_OPT), jparams)
    batches = [b.astype(np.int32) for b, _ in zip(
        TokenStream(cfg.vocab, 2, 32, seed=4), range(3))]
    jparams, jstate, _ = _jax_steps(jcfg, jparams, jstate, batches[:1])
    with tempfile.TemporaryDirectory() as d:
        jck.save(d, 1, (jparams, jstate))
        m = _manifest(d, 1)
        assert {"0/embed", "0/layers/wq", "1/m/layers/wq", "1/count"} <= \
            set(m["dtypes"])
        step, (params, state), _ = ck.restore(d, device="cpu")
    assert step == 1 and int(state["count"]) == 1
    assert state["count"].dtype == torch.int32
    _, _, jlosses = _jax_steps(jcfg, jparams, jstate, batches[1:])
    _, _, losses = _port_steps(cfg, params, state, batches[1:])
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)


def test_state_from_numpy_carries_bf16_moments_and_residual():
    """``state_from_numpy`` keeps the reference's dtypes and bits: bf16
    moments, the float32 residual of ``compress_grads``, the int32 count."""
    jcfg, cfg = _reduced_both()
    jparams = jtr.init_params(jcfg, jax.random.PRNGKey(2))
    oc = jopt.AdamWConfig(moments_dtype=jnp.bfloat16, compress_grads=True)
    jstate = jopt.init_state(oc, jparams)
    jstate["m"] = jax.tree.map(lambda x: x + 0.1, jstate["m"])
    jstate["count"] = jnp.asarray(4, jnp.int32)
    params, state = state_from_numpy(jax.tree.map(np.asarray, jparams),
                                     jax.tree.map(np.asarray, jstate), cfg,
                                     device="cpu")
    assert int(state["count"]) == 4 and state["count"].dtype == torch.int32
    for key, x in named_leaves(jax.tree.map(np.asarray, jstate)):
        ours = dict(named_leaves(state))[key]
        np.testing.assert_array_equal(_bits(ours), _bits(x))
    assert state["m"]["embed"].dtype == torch.bfloat16
    assert state["ef_residual"]["embed"].dtype == torch.float32
    assert sorted(params) == ["embed", "final_norm", "layers"]
    assert params["embed"].dtype == cfg.dtype


# -- launch.train ----------------------------------------------------------------

def _train_cli(argv):
    """``launch.train.main`` in process, its stdout captured; the SIGTERM
    handler its controller installs is put back after."""
    import signal

    out = io.StringIO()
    handler = signal.getsignal(signal.SIGTERM)
    try:
        with redirect_stdout(out):
            ctl = launch_train.main(argv)
    finally:
        signal.signal(signal.SIGTERM, handler)
    return ctl, out.getvalue()


def test_launch_train_cpu_trains_and_resumes():
    """``launch.train --device cpu --reduced``: 4 steps checkpointed every
    2, then a second run to 6 resumes at step 4 from the checkpoint and
    takes 2 more; the losses finite and near ln V at the start, the
    printout the reference's."""
    with tempfile.TemporaryDirectory() as d:
        base = ["--arch", "qwen2-1.5b", "--reduced", "--batch", "2",
                "--seq", "32", "--ckpt-every", "2", "--log-every", "2",
                "--ckpt-dir", d, "--device", "cpu"]
        ctl, out = _train_cli(base + ["--steps", "4"])
        assert "step     2 loss" in out and "step     4 loss" in out
        assert f"checkpoints in {d}" in out
        assert ck.latest_step(d) == 4
        ctl2, out2 = _train_cli(base + ["--steps", "6"])
        recs = ctl2.journal.read()
        assert {"event": "resumed", "step": 4} in recs
        steps = [r for r in recs if "loss" in r]
        assert [r["step"] for r in steps] == [0, 1, 2, 3, 4, 5]
        assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
                   for r in steps)
        assert steps[0]["loss"] == pytest.approx(math.log(512), rel=0.25)
        assert ck.latest_step(d) == 6
        _, (params, state), _ = ck.restore(d, device="cpu")
        assert int(state["count"]) == 6
        assert params["layers"]["wq"].shape == (2, 64, 64)


@pytest.mark.parametrize("arch", ["gcn-cora", "schnet", "dimenet",
                                  "meshgraphnet", "din"])
def test_launch_train_gnn_and_recsys(arch):
    """``launch.train --arch <arch> --reduced --steps 3 --device cpu``
    resumes at step 0 from a checkpoint of the reference's own state (its
    ``build_*_training`` init and fresh AdamW state, written by the
    reference's ``checkpoint.save``) and trains on the launcher's batches:
    the journal's three losses within rel 1e-4 of the reference's train
    step on the reference launcher's batches (the same batches: the data
    builders are copies; float32 sums in other orders through two
    updates), the printout the reference's."""
    from repro.launch import train as jlaunch

    if arch == "din":
        _, jparams, jloss, jbatches = jlaunch.build_din_training(True, 8, 0)
    else:
        _, jparams, jloss, jbatches = jlaunch.build_gnn_training(arch, True,
                                                                 0)
    opt = jopt.AdamWConfig()                  # the CLI's defaults
    jstate = jopt.init_state(opt, jparams)
    with tempfile.TemporaryDirectory() as d:
        jck.save(d, 0, (jparams, jstate))
        jstep = jax.jit(jbuild(jloss, opt))
        jlosses = []
        for _ in range(3):
            jparams, jstate, m = jstep(jparams, jstate, next(jbatches))
            jlosses.append(float(m["loss"]))
        ctl, out = _train_cli(["--arch", arch, "--reduced", "--steps", "3",
                               "--log-every", "3", "--ckpt-dir", d,
                               "--device", "cpu"])
        recs = ctl.journal.read()
    assert {"event": "resumed", "step": 0} in recs
    losses = [r["loss"] for r in recs if "loss" in r]
    assert len(losses) == 3 and "step     3 loss" in out
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)


def test_launch_train_solver_arch_and_missing_card():
    with pytest.raises(SystemExit, match="launch.solve"):
        launch_train.main(["--arch", "pirmcut", "--device", "cpu"])
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device trains")
    with pytest.raises(SystemExit, match="no CUDA card"):
        launch_train.main(["--arch", "qwen2-1.5b", "--reduced",
                           "--steps", "1"])


def test_five_thin_config_modules_match_the_reference():
    """``configs/{minitron_4b,…}.py``: ARCH_ID, the full config, the
    reduced config and the cells, field for field the reference's."""
    import importlib
    for mod in ("minitron_4b", "qwen2_1_5b", "gemma3_27b", "llama4_maverick",
                "mixtral_8x22b"):
        ours = importlib.import_module(f"repro_torch.configs.{mod}")
        theirs = importlib.import_module(f"repro.configs.{mod}")
        assert ours.ARCH_ID == theirs.ARCH_ID
        assert tuple(ours.cells()) == tuple(theirs.cells())
        for a, b in ((ours.config(), theirs.config()),
                     (ours.reduced(), theirs.reduced())):
            da, db = dataclasses.asdict(a), dataclasses.asdict(b)
            assert str(da.pop("dtype")).removeprefix("torch.") == \
                np.dtype(db.pop("dtype")).name
            assert da == db
        assert registry.get(ours.ARCH_ID).family == "lm"
