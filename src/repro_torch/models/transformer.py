"""LM-family transformer: dense and MoE GQA layers with RoPE and
sliding-window patterns, the chunked LM loss, prefill and KV-cache decode
(PyTorch).

The port of ``repro/models/transformer.py``.  ``LMConfig``
and ``MoECfg`` keep the JAX package's fields and defaults, so one kwargs dict
builds both sides of a parity test (``dtype`` may be given as a torch,
numpy or JAX dtype, or its name; it is stored as a torch dtype).
``use_pallas_attention`` routes the prefill attention of full-attention
layers through the hand-written CUDA kernel (inference only: under grad it
raises).  ``remat`` wraps each group of ``period`` layers of a forward under
grad in ``torch.utils.checkpoint``, as the reference checkpoints its scan
body.  MoE layers dispatch through ``layers.moe_layer`` (one device has no
token groups, so the grouped dispatch is not taken, as in the reference
without a mesh), add the shared expert where the config has one, and
``forward`` returns the layers' summed load-balance loss.

The parameters live in a ``Transformer`` module under the JAX pytree's
names, stacked along a leading layer axis (``embed``, ``final_norm``,
``layers.wq`` as (L, D, H·Dh), ``layers.w1`` as (L, E, D, F) for MoE, ...),
so carrying the JAX package's weights over (``params_from_numpy``) is a
name-for-name copy; ``Transformer.tree()`` gives them as the reference's
nested dict, the one form that ``forward``, ``lm_loss``, ``prefill`` and
``decode_step`` take and that the trainer, optimizer and checkpoints hold.
The layers run in a Python loop; a forward takes each layer's parameters
by one ``unbind`` of the stacks (whose backward is one ``stack``, not a
full-size zero gradient per layer as indexing would give); local ('L') layers
keep window-sized ring caches aligned to decode's ``pos % w``, global layers
full-length caches, and decode updates the caches in place.

Sharding.  ``rules`` on a ``DeviceMesh`` (``models/sharding.lm_rules``) runs
the same program over ranks: ``param_shardings`` places each leaf as the
reference does (TP over the model axis, FSDP over the data axes) and
``shard_params`` makes the tree's DTensors; the work runs on each rank's
local blocks with the collectives of ``distributed/collectives`` written
out (``_Plan`` decides the layout of a call): the batch over the data axes
where it divides them, the residual stream's sequence over the model axis
(``seq_parallel``), q/k/v heads over it where they divide it, else q's rows
(the kernel then takes the rank's ``q_offset``), d_ff and the vocabulary
over it (the loss as a vocab-parallel cross entropy: a local masked pick and
all-reduces), MoE layers through ``layers.moe_sharded`` (EP over the data
axes with an all-to-all when E divides them).  Caches are DTensors in
``cache_shardings``' layout, logits DTensors over (batch, vocab).  A mesh
whose dims all have one rank runs the one-device program's operations.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..distributed import collectives as C
from . import layers as L
from .sharding import (ShardingRules, abstract_leaf, as_axes, local_block,
                       no_sharding, stored_dims, whole)

def as_torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch, numpy or JAX dtype, or a dtype's name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    out = getattr(torch, name, None)
    if not isinstance(out, torch.dtype):
        raise ValueError(f"no torch dtype for {dtype!r}")
    return out


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    shared_expert: bool = False
    aux_loss_weight: float = 0.01
    dispatch: str = "global"


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    moe: Optional[MoECfg] = None
    qkv_bias: bool = False
    window: Optional[int] = None          # sliding-window size for 'L' layers
    layer_pattern: Tuple[str, ...] = ("G",)  # periodic pattern, e.g. 5×L + G
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16
    loss_chunk: int = 128                 # CE seq-chunk size
    q_chunk: int = 512
    k_chunk: int = 1024
    remat: bool = True
    # sequence parallelism: the residual stream's seq dim over the model
    # axis (activation memory at train time)
    seq_parallel: bool = True
    # route full-attention prefill forwards through the CUDA kernel
    use_pallas_attention: bool = False

    def __post_init__(self):
        object.__setattr__(self, "dtype", as_torch_dtype(self.dtype))

    @property
    def period(self) -> int:
        return len(self.layer_pattern)

    def layer_kinds(self) -> List[str]:
        reps = -(-self.n_layers // self.period)
        return list((self.layer_pattern * reps)[: self.n_layers])

    def param_count(self) -> int:
        D, F, V = self.d_model, self.d_ff, self.vocab
        H, KV, Dh = self.n_heads, self.n_kv_heads, self.d_head
        attn = D * H * Dh + 2 * D * KV * Dh + H * Dh * D
        if self.qkv_bias:
            attn += (H + 2 * KV) * Dh
        if self.moe:
            ffn = self.moe.n_experts * 3 * D * F + D * self.moe.n_experts
            if self.moe.shared_expert:
                ffn += 3 * D * F
        else:
            ffn = 3 * D * F
        per_layer = attn + ffn + 2 * D
        return self.n_layers * per_layer + V * D + D

    def active_param_count(self) -> int:
        """Per-token active params (MoE: top_k experts only) for MODEL_FLOPS."""
        if not self.moe:
            return self.param_count()
        D, F, V = self.d_model, self.d_ff, self.vocab
        H, KV, Dh = self.n_heads, self.n_kv_heads, self.d_head
        attn = D * H * Dh + 2 * D * KV * Dh + H * Dh * D
        ffn = self.moe.top_k * 3 * D * F + D * self.moe.n_experts
        if self.moe.shared_expert:
            ffn += 3 * D * F
        per_layer = attn + ffn + 2 * D
        return self.n_layers * per_layer + V * D + D


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _layer_shapes(cfg: LMConfig) -> Dict[str, Tuple[Tuple[int, ...], Any]]:
    D, F = cfg.d_model, cfg.d_ff
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    L_ = cfg.n_layers
    t = cfg.dtype
    s: Dict[str, Tuple[Tuple[int, ...], Any]] = {
        "attn_norm": ((L_, D), t), "ffn_norm": ((L_, D), t),
        "wq": ((L_, D, H * Dh), t), "wk": ((L_, D, KV * Dh), t),
        "wv": ((L_, D, KV * Dh), t), "wo": ((L_, H * Dh, D), t),
    }
    if cfg.qkv_bias:
        s.update({"bq": ((L_, H * Dh), t), "bk": ((L_, KV * Dh), t),
                  "bv": ((L_, KV * Dh), t)})
    if cfg.moe:
        E = cfg.moe.n_experts
        s.update({"router": ((L_, D, E), t),
                  "w1": ((L_, E, D, F), t), "w3": ((L_, E, D, F), t),
                  "w2": ((L_, E, F, D), t)})
        if cfg.moe.shared_expert:
            s.update({"s1": ((L_, D, F), t), "s3": ((L_, D, F), t),
                      "s2": ((L_, F, D), t)})
    else:
        s.update({"w1": ((L_, D, F), t), "w3": ((L_, D, F), t),
                  "w2": ((L_, F, D), t)})
    return s


def param_shapes(cfg: LMConfig):
    return {
        "embed": ((cfg.vocab, cfg.d_model), cfg.dtype),
        "final_norm": ((cfg.d_model,), cfg.dtype),
        "layers": _layer_shapes(cfg),
    }


class Transformer(nn.Module):
    """The parameters of a dense or MoE LM under the JAX pytree's names,
    stacked along a leading layer axis; its values are uninitialized until
    ``init_params`` or ``params_from_numpy`` fill them."""

    def __init__(self, cfg: LMConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        shapes = param_shapes(cfg)

        def empty(spec):
            shape, dtype = spec
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                                requires_grad=False)

        self.embed = empty(shapes["embed"])
        self.final_norm = empty(shapes["final_norm"])
        self.layers = nn.ParameterDict(
            {name: empty(spec) for name, spec in shapes["layers"].items()})

    def tree(self) -> Dict[str, Any]:
        """The parameters as the reference's pytree: ``{"embed",
        "final_norm", "layers": {name: stack}}`` of these tensors."""
        return {"embed": self.embed, "final_norm": self.final_norm,
                "layers": dict(self.layers)}


# elements of one float32 draw of init_params (1 GiB)
_INIT_CHUNK = 1 << 28


def init_params(cfg: LMConfig, generator: Optional[torch.Generator] = None,
                device="cuda") -> Transformer:
    """Random weights with the JAX init's distribution: N(0, 1)/√fan_in
    drawn in float32 and cast (fan_in the second-to-last dim, the last for
    1-D), norm gains 0 (rms_norm applies 1 + w).  The numbers come from
    ``generator`` (a seeded one on ``device`` when None), not JAX's.  Each
    parameter is drawn in slices of at most 1 GiB of float32, so the
    temporary stays small beside the weights (llama4's expert stack of one
    layer is 21 GB in float32)."""
    params = Transformer(cfg, device)
    dev = params.embed.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        for name, p in params.named_parameters():
            if name.endswith("norm"):
                p.zero_()
                continue
            fan_in = p.shape[-2] if p.dim() >= 2 else p.shape[-1]
            flat = p.view(-1)
            for a in range(0, flat.numel(), _INIT_CHUNK):
                x = torch.randn(min(_INIT_CHUNK, flat.numel() - a),
                                generator=generator, dtype=torch.float32,
                                device=dev)
                flat[a:a + x.numel()].copy_(x.div_(math.sqrt(max(1, fan_in))))
                del x
    return params


def params_from_numpy(tree, cfg: LMConfig, device="cuda") -> Transformer:
    """The JAX package's parameter pytree (``{"embed", "final_norm",
    "layers": {...}}`` of numpy arrays, e.g. ``jax.tree.map(np.asarray,
    params)``) as the port's parameters.  bfloat16 arrives as
    ``ml_dtypes.bfloat16`` and goes through float32, which is exact."""
    params = Transformer(cfg, device)
    with torch.no_grad():
        for name, p in params.named_parameters():
            node = tree
            for part in name.split("."):
                node = node[part]
            arr = np.array(node, dtype=np.float32)
            if arr.shape != tuple(p.shape):
                raise ValueError(f"{name}: shape {arr.shape}, expected "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.from_numpy(arr))
    return params


def abstract_params(cfg: LMConfig):
    """The parameter tree's shapes and dtypes as tensors on the ``meta``
    device (no storage)."""
    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        shape, dtype = tree
        return torch.empty(shape, dtype=dtype, device="meta")
    return walk(param_shapes(cfg))


def _param_dims(cfg: LMConfig, path: str, ndim: int):
    """The logical dims of one parameter leaf: TP on width dims, FSDP on a
    complementary one (ZeRO-style over the data axes)."""
    if path == "embed":
        return ("vocab", "fsdp")
    if path.endswith("norm"):
        return (None,) * ndim
    if path in ("wq", "wk", "wv"):
        return (None, "fsdp", "heads")          # [L, D, H·Dh]
    if path == "wo":
        return (None, "heads", "fsdp")
    if path in ("bq", "bk", "bv"):
        return (None, "heads")
    if path == "router":
        return (None, "fsdp", None)
    if path in ("w1", "w3"):
        return (None, "expert_ep", "fsdp", "d_ff") if cfg.moe \
            else (None, "fsdp", "d_ff")
    if path == "w2":
        return (None, "expert_ep", "d_ff", "fsdp") if cfg.moe \
            else (None, "d_ff", "fsdp")
    if path in ("s1", "s3"):
        return (None, "fsdp", "d_ff")
    if path == "s2":
        return (None, "d_ff", "fsdp")
    return (None,) * ndim


def _walk_shapes(cfg: LMConfig, fn):
    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        shape, _ = tree
        return fn(_param_dims(cfg, name, len(shape)), shape)
    return walk(param_shapes(cfg))


def param_specs(cfg: LMConfig, rules: ShardingRules):
    """The reference's PartitionSpec of every leaf, as ``rules.spec``
    tuples."""
    return _walk_shapes(cfg, lambda dims, shape: rules.spec(*dims,
                                                            shape=shape))


def param_shardings(cfg: LMConfig, rules: ShardingRules):
    """``(mesh, placements)`` of every leaf (the reference's NamedShardings):
    TP on width dims + FSDP on a complementary dim."""
    return _walk_shapes(cfg, lambda dims, shape: rules.named_sharding(
        *dims, shape=shape))


def shard_params(tree, shardings):
    """The port's ``jax.device_put(tree, shardings)``: every leaf with a
    sharding ``(mesh, placements)`` as a DTensor.  Every rank holds the
    same whole tree (the same seeded generator, or ``params_from_numpy``)
    and keeps its own blocks: no collective, no copy from rank 0."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if isinstance(tree, dict):
        return {k: shard_params(v, shardings[k]) for k, v in tree.items()}
    if shardings is None:
        return tree
    mesh, placements = shardings
    out = distribute_tensor(tree.detach(), mesh, placements,
                            src_data_rank=None)
    local = out.to_local()
    if local.untyped_storage().data_ptr() == \
            tree.untyped_storage().data_ptr() and local.numel() < tree.numel():
        # a view of the whole tensor would keep it alive: keep a copy
        out = DTensor.from_local(local.clone(), mesh, placements,
                                 run_check=False, shape=out.shape,
                                 stride=out.stride())
    return out


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

class _Plan:
    """The layout of one call of B sequences of S tokens on ``rules.mesh``:
    which work each rank does (see the module docstring), and each weight's
    block for it (``w``).  Without a mesh every rank-dependent choice is
    off and every collective the identity: the one-device program."""

    def __init__(self, cfg: LMConfig, rules: ShardingRules, B: int, S: int):
        mesh = rules.mesh
        self.cfg, self.rules, self.mesh = cfg, rules, mesh
        self.data = C._active(mesh, rules.axes("batch"))
        self.model = C._active(mesh, rules.axes("heads"))
        self.dp = C.mesh_size(mesh, self.data)
        self.tp = tp = C.mesh_size(mesh, self.model)
        self.mi = C.mesh_coord(mesh, self.model)
        self.B, self.S = B, S
        self.bs = self.dp > 1 and B % self.dp == 0      # batch over data
        self.B_l = B // self.dp if self.bs else B
        self.b0 = C.mesh_coord(mesh, self.data) * self.B_l if self.bs else 0
        # the residual stream's seq over the model axis (seq_parallel)
        self.ss = cfg.seq_parallel and tp > 1 and S > 1 and S % tp == 0
        self.S_l = S // tp if self.ss else S
        self.s0 = self.mi * self.S_l if self.ss else 0
        self.heads = tp > 1 and cfg.n_heads % tp == 0   # q heads over model
        self.kv = self.heads and cfg.n_kv_heads % tp == 0
        self.q_seq = tp > 1 and not self.heads and self.ss   # q rows instead
        self.attn_split = self.heads or self.q_seq
        self.ffn_split = tp > 1 and cfg.d_ff % tp == 0
        self.vocab = tp > 1 and cfg.vocab % tp == 0

    def w(self, leaf, need_model: Optional[int] = None,
          split_model: bool = False):
        """A weight's block for this rank's work: whole over the data axes
        (gathered from FSDP; the work after it is split over them where the
        batch is), over the model axes sharded on ``need_model`` (None:
        whole), ``split_model`` where the work after it differs between the
        model ranks.  ``leaf``: (local block, stored dims)."""
        t, stored = leaf
        need = {a: need_model for a in self.model}
        split = {a: self.bs for a in self.data}
        split.update({a: split_model for a in self.model})
        return local_block(t, self.mesh, need, split, stored)

    def tokens(self, tokens) -> torch.Tensor:
        """This rank's rows of the token ids [B, S] (a tensor every rank
        holds whole, or a DTensor: its local rows where they are this
        rank's)."""
        from torch.distributed.tensor import DTensor

        if isinstance(tokens, DTensor):
            spec = self.rules.spec("batch", *(None,) * (tokens.dim() - 1),
                                   shape=tokens.shape)
            if list(tokens.placements) == self.rules.placements(spec):
                return tokens.to_local().long()
            tokens = whole(tokens)
        return tokens[self.b0:self.b0 + self.B_l].long()

    def seq_to_residual(self, y):
        """A [B_l, S, D] block whole over the model axes as the residual
        stream's layout."""
        return C.split(y, self.mesh, self.model, 1) if self.ss else y

    def partial_to_residual(self, y):
        """Partial sums [B_l, S, D] over the model axes, reduced into the
        residual stream's layout."""
        if self.ss:
            return C.reduce_scatter(y, self.mesh, self.model, 1)
        return C.reduce(y, self.mesh, self.model)

    def embed_block(self, emb):
        """The embedding's block for the lookup and the tied head (one
        gather serves both): its vocabulary rows over the model axes where
        they divide them."""
        return self.w(emb, 0 if self.vocab else None, self.vocab)

    def logits_placements(self):
        spec = self.rules.spec("batch", "vocab",
                               shape=(self.B, self.cfg.vocab))
        return self.rules.placements(spec)


def _leaf(t, lead: int = 0):
    """(local block, stored dims) of a parameter (DTensor or whole)."""
    return (t.to_local() if hasattr(t, "to_local") else t,
            stored_dims(t, lead))


def _layer_leaves(stacks):
    """Per layer {name: (local slice, stored dims)} of the layer stacks
    (one ``unbind`` of each local stack)."""
    out = None
    for name, t in stacks.items():
        loc, stored = _leaf(t, lead=1)
        slices = loc.unbind(0)
        if out is None:
            out = [{} for _ in slices]
        for lp, sl in zip(out, slices):
            lp[name] = (sl, stored)
    return out


def _embed(e, toks, plan: _Plan):
    """The residual stream's block [B_l, S_l, D] of the token ids [B_l, S]
    from the embedding's block ``e`` (``plan.embed_block``): a
    vocab-parallel lookup (masked, then reduced over the model axes) where
    the vocabulary divides them."""
    cfg = plan.cfg
    if not plan.vocab:
        return plan.seq_to_residual(e[toks].to(cfg.dtype))
    t = toks - plan.mi * e.shape[0]
    ok = (t >= 0) & (t < e.shape[0])
    x = e[t.clamp(0, e.shape[0] - 1)] * ok[..., None].to(e.dtype)
    return plan.partial_to_residual(x.to(cfg.dtype))


def _qkv(x, lp, cfg: LMConfig, plan: _Plan, positions):
    """(q, k, v, q_offset) of a prefill or training step, rope applied: q
    over the rank's heads (or its rows under ``q_seq``), k and v over its KV
    heads where they divide the model axes, else whole."""
    mesh, M = plan.mesh, plan.model
    B_l = x.shape[0]
    S = positions.shape[1]
    Dh = cfg.d_head
    h = L.rms_norm(x, plan.w(lp["attn_norm"], split_model=plan.ss),
                   cfg.norm_eps)
    if plan.ss:
        hg = C.gather(h, mesh, M, 1, reduce_grad=True)
    elif plan.attn_split:
        hg = C.copy(h, mesh, M)
    else:
        hg = h
    split = plan.attn_split
    qn = 1 if plan.heads else None
    kn = 1 if plan.kv else None
    hq, pos_q, q_off = hg, positions, 0
    if plan.q_seq:
        hq = h
        pos_q = positions[:, plan.s0:plan.s0 + plan.S_l]
        q_off = plan.s0
    q = hq @ plan.w(lp["wq"], qn, split)
    k = hg @ plan.w(lp["wk"], kn, split)
    v = hg @ plan.w(lp["wv"], kn, split)
    if cfg.qkv_bias:
        q = q + plan.w(lp["bq"], 0 if plan.heads else None, split)
        k = k + plan.w(lp["bk"], 0 if plan.kv else None, split)
        v = v + plan.w(lp["bv"], 0 if plan.kv else None, split)
    q = L.rope(q.reshape(B_l, hq.shape[1], -1, Dh), pos_q, cfg.rope_theta)
    k = L.rope(k.reshape(B_l, S, -1, Dh), positions, cfg.rope_theta)
    v = v.reshape(B_l, S, -1, Dh)
    return q, k, v, q_off


def _local_kv_heads(k, cfg: LMConfig, plan: _Plan):
    """Whole-KV k [..., KV, Dh] → the KV head of each of this rank's q heads
    (G = 1), where q's heads are split and k's are not."""
    if not plan.heads or plan.kv:
        return k
    H_l = cfg.n_heads // plan.tp
    idx = (plan.mi * H_l + torch.arange(H_l, device=k.device)) // \
        (cfg.n_heads // cfg.n_kv_heads)
    return k.index_select(2, idx)


def _attn_out(x, out, lp, plan: _Plan):
    """x + out @ wo in the residual stream's layout."""
    B_l, Sq = out.shape[:2]
    out = out.reshape(B_l, Sq, -1)
    if plan.heads:
        return x + plan.partial_to_residual(out @ plan.w(lp["wo"], 0, True))
    return x + out @ plan.w(lp["wo"], None, plan.q_seq)


def _attn_block(x, lp, cfg: LMConfig, plan: _Plan, kind: str, positions):
    """Prefill/training self-attention on this rank's block; returns (x,
    (k, v)) with k, v over the rank's batch rows, whole over the sequence,
    over its KV heads where ``plan.kv`` else whole."""
    q, k, v, q_off = _qkv(x, lp, cfg, plan, positions)
    S, Sq = k.shape[1], q.shape[1]
    out = L.flash_attention(
        q, _local_kv_heads(k, cfg, plan), _local_kv_heads(v, cfg, plan),
        causal=True, window=cfg.window if kind == "L" else None,
        q_offset=q_off, q_chunk=Sq if plan.q_seq else min(cfg.q_chunk, Sq),
        k_chunk=min(cfg.k_chunk, S), use_pallas=cfg.use_pallas_attention)
    return _attn_out(x, out, lp, plan), (k, v)


def _ffn_block(x, lp, cfg: LMConfig, plan: _Plan):
    """Returns (x + ffn(x), aux loss) in the residual stream's layout."""
    mesh, M = plan.mesh, plan.model
    h = L.rms_norm(x, plan.w(lp["ffn_norm"], split_model=plan.ss),
                   cfg.norm_eps)
    if not cfg.moe:
        if plan.ffn_split:
            hg = C.gather(h, mesh, M, 1, reduce_grad=True) if plan.ss \
                else C.copy(h, mesh, M)
            y = L.swiglu(hg, plan.w(lp["w1"], 1, True),
                         plan.w(lp["w3"], 1, True), plan.w(lp["w2"], 0, True))
            return x + plan.partial_to_residual(y), 0.0
        return x + L.swiglu(h, plan.w(lp["w1"], None, plan.ss),
                            plan.w(lp["w3"], None, plan.ss),
                            plan.w(lp["w2"], None, plan.ss)), 0.0
    # MoE: the rank's tokens whole over the model axes
    hg = C.gather(h, mesh, M, 1, reduce_grad=False) if plan.ss else h
    B_l, S, D = hg.shape
    hf = hg.reshape(B_l * S, D)
    moe = cfg.moe
    T = plan.B * S
    grouped = (moe.dispatch == "grouped" and plan.dp > 1
               and T % plan.dp == 0)
    aux = 0.0
    router = plan.w(lp["router"])
    if plan.bs:
        stored = {k: lp[k][1] for k in L.MoEParams._fields}
        p = L.MoEParams(*(lp[k][0] for k in L.MoEParams._fields))
        y = L.moe_sharded(hf, p, moe.top_k, moe.capacity_factor, plan.rules,
                          grouped, stored=stored, reduce_model=False)
        partial = any(stored["w1"].get(a) == 2 for a in M)
        if moe.aux_loss_weight:
            aux = L.moe_aux_loss(hf, router, moe.top_k, plan.rules)
    else:       # the whole batch on every data rank
        p = L.MoEParams(router, plan.w(lp["w1"]), plan.w(lp["w3"]),
                        plan.w(lp["w2"]))
        y = L.moe_layer_grouped(hf, p, moe.top_k, moe.capacity_factor,
                                plan.dp) if grouped else \
            L.moe_layer(hf, p, moe.top_k, moe.capacity_factor)
        partial = False
        if moe.aux_loss_weight:
            aux = L.moe_aux_loss(hf, router, moe.top_k)
    if moe.shared_expert:
        if partial:
            hs = C.copy(hf, mesh, M)
            y = y + L.swiglu(hs, plan.w(lp["s1"], 1, True),
                             plan.w(lp["s3"], 1, True),
                             plan.w(lp["s2"], 0, True))
        else:
            y = y + L.swiglu(hf, plan.w(lp["s1"]), plan.w(lp["s3"]),
                             plan.w(lp["s2"]))
    y = y.reshape(B_l, S, D)
    return x + (plan.partial_to_residual(y) if partial
                else plan.seq_to_residual(y)), aux


def _layer(x, lp, cfg, plan, kind, positions):
    x, kv = _attn_block(x, lp, cfg, plan, kind, positions)
    x, aux = _ffn_block(x, lp, cfg, plan)
    return x, kv, aux


def _forward(params, tokens, cfg: LMConfig, rules: ShardingRules):
    """(plan, this rank's final hidden block [B_l, S_l, D], aux sum, the
    embedding's block for the head)."""
    B, S = tokens.shape
    plan = _Plan(cfg, rules, B, S)
    e = plan.embed_block(_leaf(params["embed"]))
    dev = e.device
    toks = plan.tokens(tokens).to(dev)
    x = _embed(e, toks, plan)
    positions = torch.arange(S, device=dev).expand(plan.B_l, S)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    kinds = cfg.layer_kinds()
    layers = _layer_leaves(params["layers"])

    def run(x, aux, first, last):
        for i in range(first, last):
            x, _, a = _layer(x, layers[i], cfg, plan, kinds[i], positions)
            aux = aux + a
        return x, aux

    per = cfg.period
    n_grouped = cfg.n_layers // per * per
    remat = cfg.remat and torch.is_grad_enabled()
    for first in range(0, n_grouped, per):
        if remat:
            x, aux = checkpoint(run, x, aux, first, first + per,
                                use_reentrant=False)
        else:
            x, aux = run(x, aux, first, first + per)
    x, aux = run(x, aux, n_grouped, cfg.n_layers)
    fn = plan.w(_leaf(params["final_norm"]), split_model=plan.ss)
    return plan, L.rms_norm(x, fn, cfg.norm_eps), aux, e


def forward(params, tokens: torch.Tensor, cfg: LMConfig,
            rules: Optional[ShardingRules] = None):
    """Token ids [B, S] → (final hidden states [B, S, D], the layers' aux
    loss sum, float32).  ``params``: a ``Transformer``'s ``tree()``, or
    with ``rules`` on a mesh its ``shard_params`` (the hidden states then a
    DTensor over (batch, seq_sp)).

    Under grad with ``cfg.remat``, each group of ``period`` layers runs
    under ``torch.utils.checkpoint`` (its activations recomputed in the
    backward) and the ``n_layers % period`` layers left over run
    unwrapped, as in the reference."""
    rules = rules or no_sharding()
    plan, x, aux, _ = _forward(params, tokens, cfg, rules)
    if plan.mesh is None:
        return x, aux
    from torch.distributed.tensor import DTensor

    seq = "seq_sp" if cfg.seq_parallel and plan.S > 1 else None
    spec = rules.spec("batch", seq, None, shape=(plan.B, plan.S, cfg.d_model))
    return DTensor.from_local(x, rules.mesh, rules.placements(spec),
                              run_check=False), aux


def _vocab_parallel_loss(x, labels, e, plan: _Plan):
    """Σ over the rank's rows and positions of (logsumexp − label logit),
    float32, chunked over ``loss_chunk`` positions: x [B_l, T, D] whole over
    the model axes (its gradient a partial sum over them where the
    vocabulary is split), labels [B_l, T], e the embedding's block.  Over a
    split vocabulary each
    rank holds V/tp logits: the max and the sum of exponentials are reduced
    over the model axes, the label logit is the owner's masked pick,
    reduced."""
    mesh, M = plan.mesh, plan.model
    T = x.shape[1]
    ch = min(plan.cfg.loss_chunk, T)
    v0 = plan.mi * e.shape[0] if plan.vocab else 0
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for a in range(0, T, ch):
        b = min(a + ch, T)
        logits = (x[:, a:b] @ e.T).float()               # [B_l, ch, V/tp]
        lab = labels[:, a:b] - v0
        ok = (lab >= 0) & (lab < e.shape[0])
        ll = torch.gather(logits, -1, lab.clamp(0, e.shape[0] - 1)[..., None]
                          )[..., 0]
        if plan.vocab:
            m = C.reduce_max(logits.amax(dim=-1), mesh, M)
            s = C.reduce(torch.exp(logits - m[..., None]).sum(dim=-1), mesh, M)
            lse = m + torch.log(s)
            ll = C.reduce(ll * ok, mesh, M)
        else:
            lse = torch.logsumexp(logits, dim=-1)
        total = total + (lse - ll).sum()
    return total


def _head_loss(x, toks, e, plan: _Plan):
    """The mean next-token cross entropy of the whole batch from this
    rank's final hidden block x (residual layout, normed), its token rows
    [B_l, S] and the embedding's block: the seq-sharded residuals gathered
    once, the
    vocab-parallel chunks, the rows' sums reduced over the data axes."""
    mesh, M = plan.mesh, plan.model
    if plan.ss:
        x = C.gather(x, mesh, M, 1, reduce_grad=plan.vocab)
    elif plan.vocab:
        x = C.copy(x, mesh, M)
    total = _vocab_parallel_loss(x[:, :-1], toks[:, 1:], e, plan)
    if plan.bs:
        total = C.reduce(total, mesh, plan.data)
    return total / (plan.B * (plan.S - 1))


def lm_loss(params, tokens: torch.Tensor, cfg: LMConfig,
            rules: Optional[ShardingRules] = None) -> torch.Tensor:
    """Next-token cross entropy (float32 scalar), chunked over the sequence
    (``loss_chunk`` positions a chunk: no [B, S, V] logits at once) with the
    tied head ``embed``, ``logsumexp`` in float32, divided by B·(S − 1);
    MoE configs add ``aux_loss_weight · aux / n_layers``.  With ``rules`` on
    a mesh every rank returns the same loss of the whole batch (tokens: a
    tensor every rank holds whole, or a DTensor over the batch), its
    gradients the DTensors of ``params``' layout."""
    plan, x, aux, e = _forward(params, tokens, cfg, rules or no_sharding())
    loss = _head_loss(x, plan.tokens(tokens).to(x.device), e, plan)
    if cfg.moe and cfg.moe.aux_loss_weight:
        loss = loss + cfg.moe.aux_loss_weight * aux / cfg.n_layers
    return loss


def _logits(x_last, e, plan: _Plan):
    """Logits [B_l, V] float32 of the last positions [B_l, D] (whole over
    the model axes) and the embedding's block; on a mesh a DTensor over
    (batch, vocab)."""
    from torch.distributed.tensor import DTensor

    logits = (x_last @ e.T).float()
    if plan.mesh is None:
        return logits
    return DTensor.from_local(logits, plan.mesh, plan.logits_placements(),
                              run_check=False)


class _CacheLayout:
    """Where a cache [n, B, Sc, KV, Dh] lies (``cache_shardings``): its
    batch over the data axes, else its sequence (``seq``: those axes); KV
    heads over the model axes, else d_head (``mdim``: 2, 3 or None)."""

    def __init__(self, cfg: LMConfig, rules: ShardingRules, B: int,
                 length: int):
        dims = _cache_slice_dims(B, cfg.n_kv_heads, rules)
        spec = rules.spec(*dims, shape=(B, length, cfg.n_kv_heads,
                                        cfg.d_head))
        self.length = length
        self.seq = C._active(rules.mesh, as_axes(spec[1]))
        self.mdim = 2 if spec[2] else 3 if spec[3] else None
        self.placements = (rules.placements((None,) + spec)
                           if rules.mesh is not None else None)

    def block(self, k, plan: _Plan, seq: bool = True):
        """The rank's block of k [B_x, len, KV?, Dh] (over the rank's batch
        rows where the batch is split, whole over the sequence, over the
        rank's KV heads where ``plan.kv``); ``seq=False`` leaves the
        sequence whole (one new token)."""
        if self.seq and seq:
            k = C._slice(k, plan.mesh, self.seq, 1)
        if self.mdim == 3:
            k = C._slice(k, plan.mesh, plan.model, 3)
        return k


def _decode_attn(x, lp, cfg: LMConfig, plan: _Plan, kind: str, positions,
                    kc, vc, lay, cache_len: int):
    """One decode step's self-attention: this token's k/v written into the
    rank's cache blocks in place (where the cache's sequence is over the
    data axes, by the rank that holds the position), attention over the
    cache gathered whole along d_head where it is split there.  Where the
    cache's sequence is split, each rank attends over its own block and
    ``layers.decode_attention`` merges the blocks (split-KV)."""
    mesh = plan.mesh
    q, k, v, _ = _qkv(x, lp, cfg, plan, positions)
    window = cfg.window if kind == "L" else None
    pos = cache_len if window is None else cache_len % lay.length
    row0 = C.mesh_coord(mesh, lay.seq) * kc.shape[1] if lay.seq else 0
    at = pos - row0
    if 0 <= at < kc.shape[1]:
        kc[:, at:at + 1] = lay.block(k, plan, seq=False)
        vc[:, at:at + 1] = lay.block(v, plan, seq=False)
    kq, vq = kc, vc
    if lay.mdim == 3:
        kq = C.gather(kq, mesh, plan.model, 3, reduce_grad=False)
        vq = C.gather(vq, mesh, plan.model, 3, reduce_grad=False)
    eff_len = min(cache_len + 1, lay.length) if window is not None \
        else cache_len + 1
    out = L.decode_attention(q, _local_kv_heads(kq, cfg, plan),
                             _local_kv_heads(vq, cfg, plan), eff_len,
                             window=None, row0=row0, mesh=mesh,
                             axes=lay.seq)
    return _attn_out(x, out, lp, plan)


# ---------------------------------------------------------------------------
# KV-cache serving
# ---------------------------------------------------------------------------

def cache_shapes(cfg: LMConfig, batch: int, seq_len: int):
    """Cache shapes: global layers get full-length caches, local
    (windowed) layers ring buffers of size window."""
    kinds = cfg.layer_kinds()
    n_local = sum(1 for k in kinds if k == "L")
    n_global = len(kinds) - n_local
    KV, Dh = cfg.n_kv_heads, cfg.d_head
    w = min(cfg.window or seq_len, seq_len)
    shapes = {}
    if n_global:
        shapes["global_k"] = ((n_global, batch, seq_len, KV, Dh), cfg.dtype)
        shapes["global_v"] = ((n_global, batch, seq_len, KV, Dh), cfg.dtype)
    if n_local:
        shapes["local_k"] = ((n_local, batch, w, KV, Dh), cfg.dtype)
        shapes["local_v"] = ((n_local, batch, w, KV, Dh), cfg.dtype)
    return shapes


def abstract_cache(cfg: LMConfig, batch: int, seq_len: int, shardings=None,
                   device="meta"):
    """The caches of ``cache_shapes`` without storage (the reference's
    ``ShapeDtypeStruct`` tree): meta tensors, or fake ones of ``device``
    inside a ``FakeTensorMode`` (the dry runs).  With ``shardings``
    (``cache_shardings``'), each is a DTensor holding this rank's block."""
    return {k: abstract_leaf(s, as_torch_dtype(d),
                             None if shardings is None else shardings[k],
                             device)
            for k, (s, d) in cache_shapes(cfg, batch, seq_len).items()}


def init_cache(cfg: LMConfig, batch: int, seq_len: int, device="cuda"):
    return {k: torch.zeros(s, dtype=d, device=device)
            for k, (s, d) in cache_shapes(cfg, batch, seq_len).items()}


def cache_shardings(cfg: LMConfig, batch: int, seq_len: int,
                    rules: ShardingRules):
    """``(mesh, placements)`` of each cache: batch over the data axes when
    divisible, else the cache SEQUENCE over them (long-context split-KV);
    KV heads over the model axis when divisible, else d_head."""
    return {name: rules.named_sharding(
                None, *_cache_slice_dims(shape[1], shape[3], rules),
                shape=shape)
            for name, (shape, _) in cache_shapes(cfg, batch, seq_len).items()}


def _cache_slice_dims(B: int, KV: int, rules: ShardingRules):
    """Logical dims of a [B, S, KV, D] cache slice, as ``cache_shardings``:
    batch-sharded when divisible, else seq-sharded; KV heads over model when
    divisible, else d_head."""
    data_size = max(1, rules._axes_size(rules.rules.get("batch")))
    kv_ok = KV % max(1, rules._axes_size(rules.rules.get("kv_heads"))) == 0
    kv_dim, d_dim = ("kv_heads", None) if kv_ok else (None, "d_head")
    if B % data_size == 0 and B >= data_size:
        return ("batch", None, kv_dim, d_dim)
    return (None, "seq_shard", kv_dim, d_dim)


def _cache_layout(cfg: LMConfig):
    """Per layer: (cache name prefix, index within its kind's stack)."""
    gi = li = 0
    layout = []
    for k in cfg.layer_kinds():
        if k == "L":
            layout.append(("local", li))
            li += 1
        else:
            layout.append(("global", gi))
            gi += 1
    return layout


def layer_params(params, i: int) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s parameters of a ``tree()`` (views into the stacks)."""
    return {name: t[i] for name, t in params["layers"].items()}


def decode_step(params, cache, tokens: torch.Tensor, cache_len: int,
                cfg: LMConfig, rules: Optional[ShardingRules] = None):
    """One serving step: tokens [B] at position ``cache_len`` → (logits
    [B, V] float32, cache).  ``params``: a ``Transformer``'s ``tree()``.
    The cache is updated in place and returned.  With ``rules`` on a mesh:
    the sharded params and ``prefill``'s DTensor caches, logits a DTensor
    over (batch, vocab)."""
    cache_len = int(cache_len)
    rules = rules or no_sharding()
    B = tokens.shape[0]
    plan = _Plan(cfg, rules, B, 1)
    emb = plan.embed_block(_leaf(params["embed"]))
    dev = emb.device
    x = _embed(emb, plan.tokens(tokens).to(dev)[:, None], plan)
    positions = torch.full((plan.B_l, 1), cache_len, dtype=torch.long,
                           device=dev)
    local = {name: t.to_local() if hasattr(t, "to_local") else t
             for name, t in cache.items()}
    lays = {kn: _CacheLayout(cfg, rules, B, cache[f"{kn}_k"].shape[2])
            for kn in ("global", "local") if f"{kn}_k" in cache}
    layers = _layer_leaves(params["layers"])
    for i, (kind, (kname, idx)) in enumerate(zip(cfg.layer_kinds(),
                                                 _cache_layout(cfg))):
        x = _decode_attn(x, layers[i], cfg, plan, kind, positions,
                         local[f"{kname}_k"][idx], local[f"{kname}_v"][idx],
                         lays[kname], cache_len)
        x, _ = _ffn_block(x, layers[i], cfg, plan)
    x = L.rms_norm(x, plan.w(_leaf(params["final_norm"])), cfg.norm_eps)
    return _logits(x[:, 0], emb, plan), cache


def prefill(params, tokens: torch.Tensor, cfg: LMConfig,
            rules: Optional[ShardingRules] = None,
            pad_cache_to: Optional[int] = None):
    """Prefill: tokens [B, S] → (last-position logits [B, V] float32, filled
    cache).  ``params``: a ``Transformer``'s ``tree()``.

    Global layers cache all S keys; local layers keep the trailing window
    as a ring buffer aligned with decode's ``pos % w`` indexing (position p
    lives at slot p % w).  ``pad_cache_to`` reserves extra global-cache
    capacity so decode can continue for (pad_cache_to − S) tokens.  With
    ``rules`` on a mesh: the sharded params, the caches DTensors in
    ``cache_shardings``' layout, logits a DTensor over (batch, vocab)."""
    from torch.distributed.tensor import DTensor

    rules = rules or no_sharding()
    B, S = tokens.shape
    plan = _Plan(cfg, rules, B, S)
    emb = plan.embed_block(_leaf(params["embed"]))
    dev = emb.device
    x = _embed(emb, plan.tokens(tokens).to(dev), plan)
    positions = torch.arange(S, device=dev).expand(plan.B_l, S)
    cap = pad_cache_to or S
    w = min(cfg.window or cap, cap)     # ring size (window, capped by capacity)
    m = min(S, w)                       # how many trailing keys we can store
    lays = {"global": _CacheLayout(cfg, rules, B, max(S, cap)),
            "local": _CacheLayout(cfg, rules, B, w)}
    layout = _cache_layout(cfg)
    n_kind = {kn: sum(1 for k, _ in layout if k == kn) for kn in lays}
    cache: Dict[str, torch.Tensor] = {}
    layers = _layer_leaves(params["layers"])
    for i, (kind, (kname, idx)) in enumerate(zip(cfg.layer_kinds(),
                                                 layout)):
        x, (k, v), _ = _layer(x, layers[i], cfg, plan, kind, positions)
        for part, t in (("k", k), ("v", v)):
            full = t.new_zeros((t.shape[0], lays[kname].length) + t.shape[2:])
            if kname == "global":
                full[:, :S] = t
            else:
                # the last m keys, position p at slot p % w; other slots 0
                full[:, :m] = t[:, S - m:]
                full = torch.roll(full, (S - m) % w, dims=1)
            block = lays[kname].block(full, plan)
            name = f"{kname}_{part}"
            if name not in cache:
                cache[name] = block.new_zeros((n_kind[kname],) + block.shape)
            cache[name][idx] = block
    if plan.mesh is not None:
        cache = {name: DTensor.from_local(t, plan.mesh,
                                          lays[name.split("_")[0]].placements,
                                          run_check=False)
                 for name, t in cache.items()}
    x = L.rms_norm(x, plan.w(_leaf(params["final_norm"]),
                             split_model=plan.ss), cfg.norm_eps)
    last = x[:, -1:]
    if plan.ss:             # the last position is the last model rank's
        last = C.gather(last, plan.mesh, plan.model, 1, reduce_grad=False)
    return _logits(last[:, -1], emb, plan), cache
