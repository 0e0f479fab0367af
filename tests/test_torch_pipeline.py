"""The port's GPipe pipeline (``train/pipeline.py``) against the JAX
package's, at the reference test's shapes (4 layers, 4 microbatches of 4
sequences of 16 tokens, float32).

Subprocesses started once for the module: the port in gloo ranks on a (pod
2, model 2) mesh and on a (pod 2, data 2, model 2) one, the reference on
eight emulated CPU devices with its meshes built with ``AxisType.Auto``
(jax 0.9's ``make_mesh`` gives Explicit axes, which the reference's
``with_sharding_constraint`` refuses: the reason its own
``test_pipeline_loss_matches_reference`` fails).  Both sides take the same
numpy parameters and tokens from a seed.
"""
import json
import tempfile

import numpy as np
import pytest

pytest.importorskip("torch")

from tests._torch_ranks import PARAMS, Job  # noqa: E402

CFG = dict(name="t", n_layers=4, d_model=32, n_heads=4, n_kv_heads=2,
           d_head=8, d_ff=64, vocab=128, q_chunk=16, k_chunk=16,
           loss_chunk=8, remat=False)
MESHES = {"pod_model": ((2, 2), ("pod", "model")),
          "pod_data_model": ((2, 2, 2), ("pod", "data", "model"))}

_SHARED = PARAMS + f"""
import json
CFG = json.loads({json.dumps(CFG)!r})
MESHES = json.loads({json.dumps(MESHES)!r})
toks = np.random.default_rng(1).integers(0, CFG["vocab"], (4, 4, 16)).astype(
    np.int32)
"""

_REF = _SHARED + """
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.models.transformer import LMConfig, lm_loss, param_shapes
from repro.train.pipeline import build_pipeline_loss, stage_params_from_flat
cfg = LMConfig(dtype=jnp.float32, **CFG)
params = jax.tree.map(jnp.asarray, make_params(param_shapes(cfg), 0))
out = {}
loss, grads = jax.value_and_grad(lambda p: lm_loss(
    p, jnp.asarray(toks).reshape(16, 16), cfg))(params)
out["loss"] = np.float64(loss)
for k, v in flat(grads).items():
    out["grad/" + k] = v
for name, (shape, axes) in MESHES.items():
    n = int(np.prod(shape))
    mesh = jax.make_mesh(tuple(shape), tuple(axes),
                         axis_types=(AxisType.Auto,) * len(axes),
                         devices=jax.devices()[:n])
    fn = build_pipeline_loss(cfg, mesh, None, n_microbatches=4)
    out["pipe/" + name] = np.float64(jax.jit(fn)(
        stage_params_from_flat(params, 2), jnp.asarray(toks)))
np.savez(OUT, **out)
"""

_PORT = _SHARED + """
import sys
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as tr
from repro_torch.train import pipeline as pl
from repro_torch.train.optimizer import named_leaves
from repro_torch.models.sharding import whole
shape, axes = MESHES[sys.argv[1]]
mesh = make_host_mesh(tuple(shape), tuple(axes), device="cpu")
out = {}
for remat in (False, True):
    cfg = tr.LMConfig(dtype="float32", **dict(CFG, remat=remat))
    params = tr.params_from_numpy(make_params(tr.param_shapes(cfg), 0), cfg,
                                  device="cpu").tree()
    staged = tr.shard_params(pl.stage_params_from_flat(params, 2),
                             pl.stage_param_shardings(cfg, mesh))
    leaves = [v.requires_grad_() for _, v in named_leaves(staged)]
    loss = pl.build_pipeline_loss(cfg, mesh, None, 4)(
        staged, torch.from_numpy(toks))
    grads = torch.autograd.grad(loss, leaves)
    tag = "remat/" if remat else ""
    out[tag + "loss"] = np.float64(loss.item())
    for (k, v), g in zip(named_leaves(staged), grads):
        out[tag + "grad/" + k] = whole(g).reshape(
            (-1,) + tuple(g.shape[2:]) if k.startswith("layers/")
            else g.shape).numpy()
        out[tag + "placements/" + k] = np.array(str(list(g.placements)))
if RANK == 0:
    np.savez(OUT, **out)
"""


@pytest.fixture(scope="module")
def runs():
    with tempfile.TemporaryDirectory() as d:
        jobs = {"ref": Job("ref", d, _REF, devices=8)}
        for name, (shape, _) in MESHES.items():
            jobs[name] = Job(name, d, _PORT.replace(
                "sys.argv[1]", repr(name)), ranks=int(np.prod(shape)))
        try:
            yield {k: j.result() for k, j in jobs.items()}
        finally:
            for j in jobs.values():
                j.kill()


def _rel(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_pipeline_loss_matches_reference(runs, mesh):
    """The pipelined loss (GPipe over the pods, 4 microbatches) against the
    reference's pipelined loss on the same mesh and its flat ``lm_loss``,
    rel 1e-4 (the reference test's bar)."""
    got = float(runs[mesh]["loss"])
    assert got == pytest.approx(float(runs["ref"]["pipe/" + mesh]), rel=1e-4)
    assert got == pytest.approx(float(runs["ref"]["loss"]), rel=1e-4)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_pipeline_grads_match_lm_loss(runs, mesh, remat):
    """The staged gradients (the hand-written backward schedule) against
    ``jax.grad`` of the reference's flat ``lm_loss``, every leaf within rel
    1e-4 of its max; the stacks' gradients sharded over the pods, the
    embedding's and final norm's summed over them.  With ``remat`` the
    stages recompute their layers, the same numbers."""
    port, ref = runs[mesh], runs["ref"]
    tag = "remat/" if remat else ""
    assert float(port[tag + "loss"]) == pytest.approx(float(ref["loss"]),
                                                      rel=1e-4)
    keys = [k for k in ref if k.startswith("grad/")]
    assert len(keys) == 11
    for k in keys:
        assert _rel(port[tag + k], ref[k]) <= 1e-4, k
    assert str(port[tag + "placements/layers/wq"]).startswith(
        "[Shard(dim=0)")
    assert "Shard" not in str(port[tag + "placements/embed"])
