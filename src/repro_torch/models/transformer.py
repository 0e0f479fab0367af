"""LM-family transformer: dense and MoE GQA layers with RoPE and
sliding-window patterns, the chunked LM loss, prefill and KV-cache decode
(PyTorch).

The port of ``repro/models/transformer.py`` for one device.  ``LMConfig``
and ``MoECfg`` keep the JAX package's fields and defaults, so one kwargs dict
builds both sides of a parity test (``dtype`` may be given as a torch,
numpy or JAX dtype, or its name; it is stored as a torch dtype).
``use_pallas_attention`` routes the prefill attention of full-attention
layers through the hand-written CUDA kernel (inference only: under grad it
raises).  ``remat`` wraps each group of ``period`` layers of a forward under
grad in ``torch.utils.checkpoint``, as the reference checkpoints its scan
body; ``seq_parallel`` is kept as a field and has no effect on one device.
MoE layers dispatch
through ``layers.moe_layer`` (one device has no token groups, so the
grouped dispatch is not taken, as in the reference without a mesh), add
the shared expert where the config has one, and ``forward`` returns the
layers' summed load-balance loss.

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

Not ported yet (ROADMAP queue 1, item 7, "Sharding"): the sharding rules
(``rules``, ``_residual_constraint``), the grouped MoE dispatch over a
``tokens`` axis, ``abstract_params``/``param_shardings``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import layers as L

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
    remat: bool = True                    # no effect on one device
    seq_parallel: bool = True             # no effect on one device
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


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _attn_block(x, lp, cfg: LMConfig, kind: str, positions, k_cache=None,
                v_cache=None, cache_len=None):
    """Self-attention sub-block.  Prefill when k_cache is None (uses the
    computed k/v); decode when caches are given (Sq == 1), writing this
    token's k/v into them in place."""
    B, S, D = x.shape
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    h = L.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q = h @ lp["wq"]
    k = h @ lp["wk"]
    v = h @ lp["wv"]
    if cfg.qkv_bias:
        q = q + lp["bq"]
        k = k + lp["bk"]
        v = v + lp["bv"]
    q = L.rope(q.reshape(B, S, H, Dh), positions, cfg.rope_theta)
    k = L.rope(k.reshape(B, S, KV, Dh), positions, cfg.rope_theta)
    v = v.reshape(B, S, KV, Dh)
    window = cfg.window if kind == "L" else None
    if k_cache is None:
        out = L.flash_attention(q, k, v, causal=True, window=window,
                                q_chunk=min(cfg.q_chunk, S),
                                k_chunk=min(cfg.k_chunk, S),
                                use_pallas=cfg.use_pallas_attention)
        new_kv = (k, v)
    else:
        # decode: write k/v at the ring/linear position, attend to the cache
        Sc = k_cache.shape[1]
        pos = cache_len if window is None else cache_len % Sc
        k_cache[:, pos:pos + 1] = k
        v_cache[:, pos:pos + 1] = v
        # ring buffer: once full, all Sc slots are valid (RoPE is applied
        # before caching, so absolute positions survive the wrap-around)
        eff_len = min(cache_len + 1, Sc) if window is not None else cache_len + 1
        out = L.decode_attention(q, k_cache, v_cache, eff_len, window=None)
        new_kv = (k_cache, v_cache)
    return x + out.reshape(B, S, H * Dh) @ lp["wo"], new_kv


def _ffn_block(x, lp, cfg: LMConfig):
    """Returns (x + ffn(x), aux loss): the MoE load-balance loss as a
    float32 scalar, 0.0 where the layer has none."""
    B, S, D = x.shape
    h = L.rms_norm(x, lp["ffn_norm"], cfg.norm_eps)
    aux = 0.0
    if not cfg.moe:
        return x + L.swiglu(h, lp["w1"], lp["w3"], lp["w2"]), aux
    hf = h.reshape(B * S, D)
    p = L.MoEParams(router=lp["router"], w1=lp["w1"], w3=lp["w3"],
                    w2=lp["w2"])
    y = L.moe_layer(hf, p, cfg.moe.top_k, cfg.moe.capacity_factor)
    if cfg.moe.aux_loss_weight:
        aux = L.moe_aux_loss(hf, lp["router"], cfg.moe.top_k)
    if cfg.moe.shared_expert:
        y = y + L.swiglu(hf, lp["s1"], lp["s3"], lp["s2"])
    return x + y.reshape(B, S, D), aux


def _layer(x, lp, cfg, kind, positions, cache=None, cache_len=None):
    """Returns (x, (k, v), aux loss)."""
    if cache is None:
        x, kv = _attn_block(x, lp, cfg, kind, positions)
    else:
        x, kv = _attn_block(x, lp, cfg, kind, positions, k_cache=cache[0],
                            v_cache=cache[1], cache_len=cache_len)
    x, aux = _ffn_block(x, lp, cfg)
    return x, kv, aux


def _embed(embed: torch.Tensor, tokens: torch.Tensor, cfg: LMConfig):
    return embed[tokens.to(embed.device).long()].to(cfg.dtype)


def forward(params, tokens: torch.Tensor, cfg: LMConfig):
    """Token ids [B, S] → (final hidden states [B, S, D], the layers' aux
    loss sum, float32).  ``params``: a ``Transformer``'s ``tree()``.

    Under grad with ``cfg.remat``, each group of ``period`` layers runs
    under ``torch.utils.checkpoint`` (its activations recomputed in the
    backward) and the ``n_layers % period`` layers left over run
    unwrapped, as in the reference."""
    B, S = tokens.shape
    x = _embed(params["embed"], tokens, cfg)
    positions = torch.arange(S, device=x.device).expand(B, S)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    kinds = cfg.layer_kinds()
    per_layer = {name: t.unbind(0) for name, t in params["layers"].items()}

    def run(x, aux, first, last):
        for i in range(first, last):
            lp = {name: ts[i] for name, ts in per_layer.items()}
            x, _, a = _layer(x, lp, cfg, kinds[i], positions)
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
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps), aux


def lm_loss(params, tokens: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    """Next-token cross entropy (float32 scalar), chunked over the sequence
    (``loss_chunk`` positions a chunk: no [B, S, V] logits at once) with the
    tied head ``embed``, ``logsumexp`` in float32, divided by B·(S − 1);
    MoE configs add ``aux_loss_weight · aux / n_layers``."""
    x, aux = forward(params, tokens, cfg)                # [B, S, D]
    emb = params["embed"]
    tokens = tokens.to(x.device).long()
    B, S, D = x.shape
    inputs = x[:, :-1]
    labels = tokens[:, 1:]
    T = S - 1
    ch = min(cfg.loss_chunk, T)

    def chunk_loss(a: int, b: int):
        logits = (inputs[:, a:b] @ emb.T).float()        # [B, ch, V]
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels[:, a:b, None])[..., 0]
        return (lse - ll).sum()

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for a in range(0, T, ch):
        total = total + chunk_loss(a, min(a + ch, T))
    loss = total / (B * T)
    if cfg.moe and cfg.moe.aux_loss_weight:
        loss = loss + cfg.moe.aux_loss_weight * aux / cfg.n_layers
    return loss


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


def init_cache(cfg: LMConfig, batch: int, seq_len: int, device="cuda"):
    return {k: torch.zeros(s, dtype=d, device=device)
            for k, (s, d) in cache_shapes(cfg, batch, seq_len).items()}


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
                cfg: LMConfig):
    """One serving step: tokens [B] at position ``cache_len`` → (logits
    [B, V] float32, cache).  ``params``: a ``Transformer``'s ``tree()``.
    The cache is updated in place and returned."""
    cache_len = int(cache_len)
    B = tokens.shape[0]
    x = _embed(params["embed"], tokens, cfg)[:, None, :]
    positions = torch.full((B, 1), cache_len, dtype=torch.long, device=x.device)
    for i, (kind, (kname, idx)) in enumerate(zip(cfg.layer_kinds(),
                                                 _cache_layout(cfg))):
        kv = (cache[f"{kname}_k"][idx], cache[f"{kname}_v"][idx])
        x, _, _ = _layer(x, layer_params(params, i), cfg, kind, positions,
                         cache=kv, cache_len=cache_len)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (x[:, 0] @ params["embed"].T).float(), cache


def prefill(params, tokens: torch.Tensor, cfg: LMConfig,
            pad_cache_to: Optional[int] = None):
    """Prefill: tokens [B, S] → (last-position logits [B, V] float32, filled
    cache).  ``params``: a ``Transformer``'s ``tree()``.

    Global layers cache all S keys; local layers keep the trailing window
    as a ring buffer aligned with decode's ``pos % w`` indexing (position p
    lives at slot p % w).  ``pad_cache_to`` reserves extra global-cache
    capacity so decode can continue for (pad_cache_to − S) tokens."""
    B, S = tokens.shape
    x = _embed(params["embed"], tokens, cfg)
    dev = x.device
    positions = torch.arange(S, device=dev).expand(B, S)
    cap = pad_cache_to or S
    w = min(cfg.window or cap, cap)     # ring size (window, capped by capacity)
    m = min(S, w)                       # how many trailing keys we can store
    layout = _cache_layout(cfg)
    cache = {}
    for kname, length in (("global", max(S, cap)), ("local", w)):
        n = sum(1 for kn, _ in layout if kn == kname)
        if n:
            for part in ("k", "v"):
                cache[f"{kname}_{part}"] = torch.zeros(
                    (n, B, length, cfg.n_kv_heads, cfg.d_head),
                    dtype=cfg.dtype, device=dev)
    for i, (kind, (kname, idx)) in enumerate(zip(cfg.layer_kinds(), layout)):
        x, (k, v), _ = _layer(x, layer_params(params, i), cfg, kind,
                              positions)
        for part, t in (("k", k), ("v", v)):
            dst = cache[f"{kname}_{part}"][idx]
            if kname == "global":
                dst[:, :S] = t
            else:
                # the last m keys, position p at slot p % w; other slots 0
                ring = torch.zeros_like(dst)
                ring[:, :m] = t[:, S - m:]
                dst.copy_(torch.roll(ring, (S - m) % w, dims=1))
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (x[:, -1] @ params["embed"].T).float(), cache
