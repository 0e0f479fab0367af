"""GPipe-style pipeline parallelism over the "pod" mesh axis (PyTorch).

The port of ``repro/train/pipeline.py``.  Pipelining turns cross-pod
traffic into one activation transfer per microbatch per stage boundary
instead of O(params) all-reduces.  Each rank of the pod axis is a stage
holding ``n_layers / n_stages`` layers (the staged stacks are DTensors
sharded over the pod axis, replicated over the others, as the reference's
``in_specs``); the embedding and final norm are replicated over the pods.
Inside a stage the data and model axes run the sharded LM
(``lm_rules(mesh, data_axes=("data",))``).

The schedule is the classic GPipe fill-drain loop of M + n_stages − 1
ticks: at tick t stage s works on microbatch t − s (if there is one: the
reference computes idle ticks on junk, whose loss it drops; here they pass
their input on), stage 0 embeds its microbatch, the last stage adds its
loss, and every stage hands its output to the next (``send_recv`` over the
pod axis).  The loss is summed on the last stage and shared by an
all-reduce over the pods, divided by M.

It is differentiable, by a backward written by hand (``_GPipe``): the ticks
in reverse, each stage backpropagating its own tick's graph with the
gradient the next stage sent and sending its input's gradient to the
previous one, then the replicated leaves' gradients summed over the pods.
Every rank thus runs its collectives in one fixed order.

Scope, as the reference: dense LMs with a homogeneous layer pattern
(period 1).
"""
from __future__ import annotations

from typing import List

import torch

from ..distributed import collectives as C
from ..models import layers as nn
from ..models import transformer as tr
from ..models.sharding import lm_rules, stored_dims


def stage_param_shapes(cfg: tr.LMConfig, n_stages: int):
    """Layer stacks reshaped [L] → [n_stages, L/n_stages]."""
    if cfg.n_layers % n_stages:
        raise ValueError(f"{cfg.n_layers} layers do not split into "
                         f"{n_stages} stages")
    per = cfg.n_layers // n_stages
    base = tr.param_shapes(cfg)
    staged = {k: ((n_stages, per) + shape[1:], dtype)
              for k, (shape, dtype) in base["layers"].items()}
    return {"embed": base["embed"], "final_norm": base["final_norm"],
            "layers": staged}


def stage_params_from_flat(params, n_stages: int):
    """Reshape a standard param tree into the staged layout (views)."""
    staged = {}
    for k, a in params["layers"].items():
        staged[k] = a.reshape((n_stages, a.shape[0] // n_stages)
                              + a.shape[1:])
    return {"embed": params["embed"], "final_norm": params["final_norm"],
            "layers": staged}


def stage_param_shardings(cfg: tr.LMConfig, mesh, pod_axis: str = "pod"):
    """``(mesh, placements)`` of the staged tree: the stacks' stage dim over
    the pod axis, everything else replicated (the reference's in_specs)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    stacked = [Shard(0) if a == pod_axis else Replicate() for a in names]
    whole = [Replicate() for _ in names]
    shapes = stage_param_shapes(cfg, mesh.size(names.index(pod_axis)))
    return {"embed": (mesh, whole), "final_norm": (mesh, whole),
            "layers": {k: (mesh, stacked) for k in shapes["layers"]}}


class _Schedule:
    """One call's fill-drain over the pod axis, its ticks' graphs kept for
    the backward."""

    def __init__(self, cfg, mesh, rules, M, pod_axis, tokens, names, stored):
        self.cfg, self.mesh, self.M, self.pod = cfg, mesh, M, pod_axis
        self.tokens, self.names, self.stored = tokens, names, stored
        self.n = mesh.size(mesh.mesh_dim_names.index(pod_axis))
        self.stage = mesh.get_local_rank(pod_axis)
        mb, S = tokens.shape[1], tokens.shape[2]
        self.plan = tr._Plan(cfg, rules, mb, S)

    def _leaves(self, leaves):
        by = dict(zip(self.names, leaves))
        emb = (by["embed"], self.stored["embed"])
        fn = (by["final_norm"], self.stored["final_norm"])
        layers: List[dict] = []
        for name in self.names:
            if not name.startswith("layers/"):
                continue
            key = name[len("layers/"):]
            for i, sl in enumerate(by[name][0].unbind(0)):
                if len(layers) <= i:
                    layers.append({})
                layers[i][key] = (sl, self.stored[name])
        return emb, fn, layers

    def forward(self, leaves):
        cfg, plan, mesh = self.cfg, self.plan, self.mesh
        emb, fn, layers = self._leaves(leaves)
        dev = leaves[0].device
        S = self.tokens.shape[2]
        positions = torch.arange(S, device=dev).expand(plan.B_l, S)
        grad = torch.is_grad_enabled()
        first, last = self.stage == 0, self.stage == self.n - 1

        def run_stage(x):
            for lp in layers:
                if cfg.remat and grad:
                    x = tr.checkpoint(lambda x, lp=lp: tr._layer(
                        x, lp, cfg, plan, "G", positions)[0], x,
                        use_reentrant=False)
                else:
                    x = tr._layer(x, lp, cfg, plan, "G", positions)[0]
            return x

        x_in = torch.zeros((plan.B_l, plan.S_l, cfg.d_model), dtype=cfg.dtype,
                           device=dev)
        total = torch.zeros((), dtype=torch.float32, device=dev)
        self.ticks = []
        n_ticks = self.M + self.n - 1
        for t in range(n_ticks):
            i = t - self.stage
            x_leaf = x_in.detach().requires_grad_(grad)
            x, lval = x_leaf, None
            if 0 <= i < self.M:
                toks = plan.tokens(self.tokens[i]).to(dev)
                if first:
                    x = tr._embed(plan.embed_block(emb), toks, plan)
                x = run_stage(x)
                if last:
                    xn = nn.rms_norm(x, plan.w(fn, split_model=plan.ss),
                                     cfg.norm_eps)
                    lval = tr._head_loss(xn, toks, plan.embed_block(emb),
                                         plan)
                    total = total + lval.detach()
            self.ticks.append((x_leaf, x, lval))
            if t < n_ticks - 1:           # hand the activations on
                x_in = C._send_recv(x.detach(), mesh, self.pod, 1)
        return C._all_reduce(total, mesh, (self.pod,)) / self.M

    def backward(self, leaves, g):
        want = [t for t in leaves if t.requires_grad]
        acc = [torch.zeros_like(t) for t in want]
        g_out = None
        for t in reversed(range(len(self.ticks))):
            x_leaf, x, lval = self.ticks[t]
            outs, grads = [], []
            if g_out is not None:
                outs.append(x)
                grads.append(g_out)
            if lval is not None:
                outs.append(lval)
                grads.append(g / self.M)
            if x is x_leaf:
                gx = g_out
            else:
                got = torch.autograd.grad(outs, [x_leaf] + want, grads,
                                          allow_unused=True)
                gx = got[0]
                for a, d in zip(acc, got[1:]):
                    if d is not None:
                        a.add_(d)
            if gx is None:
                gx = torch.zeros_like(x_leaf)
            if t > 0:                     # the input's gradient goes back
                g_out = C._send_recv(gx, self.mesh, self.pod, -1)
        self.ticks = []
        # the replicated leaves: each stage's part, summed over the pods
        out = iter(acc)
        res = []
        for name, t in zip(self.names, leaves):
            if not t.requires_grad:
                res.append(None)
                continue
            a = next(out)
            if not name.startswith("layers/"):
                a = C._all_reduce(a, self.mesh, (self.pod,))
            res.append(a)
        return res


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sched, *locals_):
        leaves = [t.detach().requires_grad_(t.requires_grad) for t in locals_]
        with torch.set_grad_enabled(any(t.requires_grad for t in leaves)):
            loss = sched.forward(leaves)
        ctx.sched, ctx.leaves = sched, leaves
        return loss.detach()

    @staticmethod
    def backward(ctx, g):
        return (None, *ctx.sched.backward(ctx.leaves, g))


def build_pipeline_loss(cfg: tr.LMConfig, mesh, rules, n_microbatches: int,
                        pod_axis: str = "pod"):
    """Returns loss_fn(staged_params, tokens [M, mb, S]) → scalar (the same
    on every rank).  staged_params: ``stage_params_from_flat``'s tree, its
    ``layers`` leaves [n_stages, per, ...] DTensors over the pod axis
    (``stage_param_shardings``); tokens: every rank's whole copy (the data
    axis shards mb).  ``rules`` is replaced, as in the reference, by
    ``lm_rules(mesh, data_axes=("data",))`` inside the stages."""
    if cfg.period != 1:
        raise ValueError("the pipeline takes a homogeneous layer pattern")
    inner = lm_rules(mesh, data_axes=("data",))

    def loss_fn(staged_params, tokens):
        names, locals_, stored = [], [], {}
        for key, t in (("embed", staged_params["embed"]),
                       ("final_norm", staged_params["final_norm"]),
                       *((f"layers/{k}", v) for k, v in
                         sorted(staged_params["layers"].items()))):
            lead = 2 if key.startswith("layers/") else 0
            loc = t.to_local() if hasattr(t, "to_local") else t
            if lead and not hasattr(t, "to_local"):
                stage = mesh.get_local_rank(pod_axis)
                loc = loc[stage:stage + 1]
            names.append(key)
            locals_.append(loc)
            stored[key] = stored_dims(t, lead)
        sched = _Schedule(cfg, mesh, inner, n_microbatches, pod_axis,
                          tokens, names, stored)
        return _GPipe.apply(sched, *locals_)

    return loss_fn
