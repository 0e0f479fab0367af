"""Shared neural-net layers of the LM, GNN and recsys models (PyTorch).

The port of ``repro/models/layers.py``: plain functions over tensors, the
same names, signatures and layouts (q [B, S, H, D], k and v [B, S, KV, D]).
The attention forward is blockwise with an online softmax, so a long
prefill never holds an [Sq, Sk] score matrix; windowed (local) layers take
a banded kv slice per q chunk.  The backward is written by hand
(``FlashAttention``, the counterpart of the reference's custom VJP): it
saves q, k, v, out and lse and recomputes each tile's probabilities, so
training holds no O(S²) residuals.  ``flash_attention(use_pallas=True)``
routes full-attention forwards through the hand-written CUDA kernel
(``kernels/csrc/flash_fwd.cu``), which has no backward: for inference
only, as in the reference.  The JAX package's ``lax.map`` and ``lax.scan``
over chunks are Python loops here.

The MoE layers (``moe_layer``, ``moe_layer_grouped``, ``moe_aux_loss``)
keep the reference's capacity arithmetic and order of work; with ``rules``
on a mesh they run on each rank's tokens (``moe_sharded``: EP over the data
axes by an all-to-all where E divides them, TP over d_ff).  Their routes
come from ``route_top_k``, which breaks ties between equal gates toward the
lower expert index, as ``lax.top_k`` does (``torch.topk`` leaves the order
of equal values undefined, and bf16 router logits tie often).

The GNN and recsys substrate: ``RowIndex`` with ``gather`` and
``segment_sum``, the fixed-order counterparts of ``x[idx]`` and
``jax.ops.segment_sum`` over rows (each one's backward is the other, so
neither direction scatters with atomics and a step gives the same bits on
every run on the card), ``embedding_bag`` (gather plus the masked reduce
``bag_reduce``, the reference's semantics: ``F.embedding_bag``'s ``mean``
counts padding otherwise), ``embedding_bag_ragged`` and ``mlp``.  On a mesh,
``gather_sharded`` and ``segment_sum_sharded`` do the same over rows
sharded along dim 0 (an all-gather before the gather, a reduce-scatter
after the sum: again each one's backward is the other).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..kernels import ops

NEG_INF = -1e30


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + w.float())).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding.  x: [..., S, H, D], positions: [..., S] (int)."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(half, dtype=torch.float32, device=x.device)
                      / half)
    ang = positions[..., None].float() * freqs          # [..., S, half]
    cos = torch.cos(ang)[..., None, :]                  # [..., S, 1, half]
    sin = torch.sin(ang)[..., None, :]
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], dim=-1)
    return out.to(x.dtype)


def _tile_logits(qc, kc, scale, q_pos, k_pos, causal, window):
    logits = torch.einsum("bqkgd,bskd->bkgqs", qc.float(), kc.float()) * scale
    msk = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                     device=qc.device)
    if causal:
        msk &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        msk &= k_pos[None, :] > q_pos[:, None] - window
    return logits + torch.where(msk, 0.0, NEG_INF)[None, None, None]


def _flash_fwd_impl(q, k, v, *, causal, window, q_offset, q_chunk, k_chunk,
                    scale):
    """Returns (out [B,Sq,KV,G,D] float32, lse [B,KV,G,Sq])."""
    B, Sq, KV, G, D = q.shape
    Sk = k.shape[1]
    nq = Sq // q_chunk
    qr = q.reshape(B, nq, q_chunk, KV, G, D)
    banded = window is not None and window + q_chunk < Sk
    w_len = min(window + q_chunk, Sk) if window is not None else Sk
    dev = q.device
    outs, lses = [], []
    for i in range(nq):
        qc = qr[:, i]
        q_start = q_offset + i * q_chunk
        q_pos = q_start + torch.arange(q_chunk, device=dev)
        if banded:
            start = min(max(q_start + q_chunk - w_len, 0), Sk - w_len)
            logits = _tile_logits(qc, k[:, start:start + w_len], scale, q_pos,
                                  start + torch.arange(w_len, device=dev),
                                  causal, window)
            m = logits.amax(dim=-1)
            p = torch.exp(logits - m[..., None])
            l = p.sum(dim=-1)
            o = torch.einsum("bkgqs,bskd->bkgqd", p,
                             v[:, start:start + w_len].float())
            outs.append(o / l.clamp_min(1e-30)[..., None])
            lses.append(m + torch.log(l.clamp_min(1e-30)))
            continue
        m_run = torch.full((B, KV, G, q_chunk), NEG_INF, dtype=torch.float32,
                           device=dev)
        l_run = torch.zeros((B, KV, G, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, KV, G, q_chunk, D), dtype=torch.float32, device=dev)
        for j in range(Sk // k_chunk):
            ks = slice(j * k_chunk, (j + 1) * k_chunk)
            logits = _tile_logits(qc, k[:, ks], scale, q_pos,
                                  j * k_chunk + torch.arange(k_chunk, device=dev),
                                  causal, window)
            m_new = torch.maximum(m_run, logits.amax(dim=-1))
            p = torch.exp(logits - m_new[..., None])
            c1 = torch.exp(m_run - m_new)
            l_run = l_run * c1 + p.sum(dim=-1)
            acc = acc * c1[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p,
                                                     v[:, ks].float())
            m_run = m_new
        outs.append(acc / l_run.clamp_min(1e-30)[..., None])
        lses.append(m_run + torch.log(l_run.clamp_min(1e-30)))
    out = torch.stack(outs, dim=1)                       # [B,nq,KV,G,Qc,D]
    out = torch.movedim(out, -2, 2).reshape(B, Sq, KV, G, D)
    lse = torch.movedim(torch.stack(lses, dim=1), 1, -2).reshape(B, KV, G, Sq)
    return out, lse


def _flash_bwd_impl(q, k, v, out, lse, do, *, causal, window, q_offset,
                    q_chunk, k_chunk, scale):
    """Tile-recomputing backward: (dq, dk, dv) in the inputs' dtypes.
    Memory: float32 accumulators of O(S·D) and one tile at a time."""
    B, Sq, KV, G, D = q.shape
    Sk = k.shape[1]
    nq = Sq // q_chunk
    qr = q.reshape(B, nq, q_chunk, KV, G, D)
    dor = do.reshape(B, nq, q_chunk, KV, G, D)
    lser = lse.reshape(B, KV, G, nq, q_chunk)
    delta = (do.float() * out.float()).sum(dim=-1)         # [B,Sq,KV,G]
    deltar = delta.reshape(B, nq, q_chunk, KV, G)
    banded = window is not None and window + q_chunk < Sk
    w_len = min(window + q_chunk, Sk) if window is not None else Sk
    dev = q.device
    dk = torch.zeros((B, Sk, KV, D), dtype=torch.float32, device=dev)
    dv = torch.zeros((B, Sk, KV, D), dtype=torch.float32, device=dev)
    dqs = []
    for i in range(nq):
        qc = qr[:, i]                                      # [B,Qc,KV,G,D]
        qcf = qc.float()
        doc = dor[:, i].permute(0, 2, 3, 1, 4).float()     # [B,KV,G,Qc,D]
        lsec = lser[:, :, :, i]                            # [B,KV,G,Qc]
        dlt = deltar[:, i].permute(0, 2, 3, 1)             # [B,KV,G,Qc]
        q_start = q_offset + i * q_chunk
        q_pos = q_start + torch.arange(q_chunk, device=dev)

        def tile(kc, vc, k_pos):
            logits = _tile_logits(qc, kc, scale, q_pos, k_pos, causal, window)
            p = torch.exp(logits - lsec[..., None])        # [B,KV,G,Qc,Kc]
            dvc = torch.einsum("bkgqs,bkgqd->bskd", p, doc)
            dp = torch.einsum("bkgqd,bskd->bkgqs", doc, vc.float())
            ds = p * (dp - dlt[..., None]) * scale
            dkc = torch.einsum("bkgqs,bqkgd->bskd", ds, qcf)
            dqc = torch.einsum("bkgqs,bskd->bqkgd", ds, kc.float())
            return dqc, dkc, dvc

        if banded:
            start = min(max(q_start + q_chunk - w_len, 0), Sk - w_len)
            ks = slice(start, start + w_len)
            dqc, dkc, dvc = tile(k[:, ks], v[:, ks],
                                 start + torch.arange(w_len, device=dev))
            dk[:, ks] += dkc
            dv[:, ks] += dvc
            dqs.append(dqc)
            continue
        dq_acc = torch.zeros((B, q_chunk, KV, G, D), dtype=torch.float32,
                             device=dev)
        for j in range(Sk // k_chunk):
            ks = slice(j * k_chunk, (j + 1) * k_chunk)
            dqc, dkc, dvc = tile(k[:, ks], v[:, ks],
                                 j * k_chunk + torch.arange(k_chunk, device=dev))
            dk[:, ks] += dkc
            dv[:, ks] += dvc
            dq_acc = dq_acc + dqc
        dqs.append(dq_acc)
    dq = torch.stack(dqs, dim=1).reshape(B, Sq, KV, G, D)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttention(torch.autograd.Function):
    """The blockwise attention with the tile-recomputing backward (the
    reference's ``_make_flash`` custom VJP).  q [B, Sq, KV, G, D], k and v
    [B, Sk, KV, D] → out [B, Sq, KV, G, D] float32; ``kw`` holds the static
    arguments of ``_flash_fwd_impl``.  Saves q, k, v, out and lse only."""

    @staticmethod
    def forward(ctx, q, k, v, kw):
        out, lse = _flash_fwd_impl(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd_impl(q, k, v, out, lse, do, **ctx.kw)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0, q_chunk: int = 512,
                    k_chunk: int = 1024, scale: Optional[float] = None,
                    use_pallas: bool = False) -> torch.Tensor:
    """Flash attention with GQA, causal masking and sliding windows.

    q: [B, Sq, H, D]; k, v: [B, Sk, KV, D] with H = KV·G.  Windowed layers
    take a banded kv slice per q chunk (compute O(S·window)).  The call
    goes through ``FlashAttention``, whose backward recomputes the tiles
    (no O(S²) residuals); without grad it is the plain forward.

    ``use_pallas=True`` routes the forward of full-attention layers
    (``window is None``, ``q_offset == 0``) through the hand-written CUDA
    kernel (``flash_attention_kernel``); windowed layers stay on the banded
    path.  The kernel has no backward, so ``use_pallas=True`` raises where
    an input requires grad.  The name is the JAX package's, which routes to
    its Pallas kernel."""
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    q_chunk = min(q_chunk, Sq)
    k_chunk = min(k_chunk, k.shape[1])
    if Sq % q_chunk or k.shape[1] % k_chunk:
        raise ValueError(f"chunks must divide the sequences: Sq {Sq}, q_chunk "
                         f"{q_chunk}, Sk {k.shape[1]}, k_chunk {k_chunk}")
    if use_pallas and torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        raise RuntimeError("use_pallas=True: the attention kernel has no "
                           "backward (inference only); train with "
                           "use_pallas_attention=False")
    if use_pallas and window is None and q_offset == 0:
        return flash_attention_kernel(q, k, v, causal=causal, scale=scale)
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              q_chunk=q_chunk, k_chunk=k_chunk, scale=float(scale))
    out = FlashAttention.apply(q.reshape(B, Sq, KV, G, D), k, v, kw)
    return out.reshape(B, Sq, H, D).to(q.dtype)


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, causal: bool = True,
                           scale: Optional[float] = None) -> torch.Tensor:
    """The full-attention forward through ``ops.flash_fwd`` (the counterpart
    of ``flash_attention_pallas``).  q: [B, Sq, H, D]; k, v: [B, Sk, KV, D].
    The kernel reads q, k and v in this layout in place and writes the
    output in it: no copy."""
    H, D = q.shape[2], q.shape[3]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    out, _ = ops.flash_fwd(q, k, v, g_per_kv=H // k.shape[2], causal=causal,
                           scale=float(scale))
    return out


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: int,
                     window: Optional[int] = None,
                     scale: Optional[float] = None, row0: int = 0,
                     mesh=None, axes=()) -> torch.Tensor:
    """Single-step decode: q: [B, 1, H, D] vs cache [B, S, KV, D].

    cache_len: the number of valid cache entries (new token position =
    cache_len).  Returns [B, 1, H, D].  The products read the cache in its
    own dtype and sum in float32, as ``preferred_element_type=float32``
    does: the float32 copy is one layer's cache slice, made and dropped per
    call.  Split-KV: where the cache's sequence is sharded over ``axes`` of
    ``mesh`` (this rank's block starting at position ``row0``), each rank
    attends over its own block, and the softmax's max and sum and the
    output are all-reduced over ``axes`` (no collective without them)."""
    from ..distributed import collectives as C

    B, _, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qr = q.reshape(B, KV, G, D)
    logits = torch.einsum("bkgd,bskd->bkgs", qr.float(), k_cache.float()) * scale
    pos = row0 + torch.arange(S, device=q.device)
    valid = pos[None, :] < cache_len          # attend to the filled prefix
    if window is not None:
        valid = valid & (pos[None, :] >= cache_len - window)
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    m = C.reduce_max(logits.amax(dim=-1, keepdim=True), mesh, axes)
    e = torch.exp(logits - m)
    p = e / C.reduce(e.sum(dim=-1, keepdim=True), mesh, axes)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return C.reduce(out, mesh, axes).reshape(B, 1, H, D).to(q.dtype)


def swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
           w2: torch.Tensor) -> torch.Tensor:
    """SwiGLU FFN: (silu(x@w1) ⊙ (x@w3)) @ w2."""
    return (F.silu(x @ w1) * (x @ w3)) @ w2


class MoEParams(NamedTuple):
    router: torch.Tensor   # [D, E]
    w1: torch.Tensor       # [E, D, F]
    w3: torch.Tensor       # [E, D, F]
    w2: torch.Tensor       # [E, F, D]


def route_top_k(gates: torch.Tensor, top_k: int):
    """(gates [..., E], k) → (top gates [..., k], top expert ids [..., k]
    int64), largest first, ties toward the lower expert index as
    ``lax.top_k`` gives them: a stable descending sort keeps equal gates in
    index order."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :top_k], idx[..., :top_k]


class MoERoutes(NamedTuple):
    """Where each (token, choice) of ``moe_routes`` goes; the leading dims
    are x's (none, or the groups of ``moe_layer_grouped``)."""
    gates: torch.Tensor     # [..., T, k] float32, renormalized over the k
    experts: torch.Tensor   # [..., T, k] int64
    keep: torch.Tensor      # [..., T·k] bool: rank < capacity
    slot: torch.Tensor      # [..., T·k] int64: e·C + rank (e·C if dropped)
    capacity: int           # C, slots per expert


def _capacity(T: int, E: int, top_k: int, capacity_factor: float) -> int:
    """Slots per expert: the reference's Python ints, a multiple of 8."""
    C = int(capacity_factor * top_k * T / E)
    return max(8, -(-C // 8) * 8)


def _ranked(flat_e: torch.Tensor, E: int, C: int):
    """(keep, slot) of expert ids [..., N]: each entry's rank among its
    expert's entries in index order, by a stable sort and ``searchsorted``
    starts; entries at rank ≥ C are dropped."""
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, -1, order)
    experts = torch.arange(E, dtype=flat_e.dtype, device=flat_e.device)
    starts = torch.searchsorted(
        sorted_e, experts.expand(*flat_e.shape[:-1], E).contiguous())
    pos = torch.arange(flat_e.shape[-1], device=flat_e.device)
    rank = torch.empty_like(flat_e).scatter_(
        -1, order, pos - torch.gather(starts, -1, sorted_e))
    keep = rank < C
    return keep, flat_e * C + torch.where(keep, rank, 0)


def _top_gates(x: torch.Tensor, router: torch.Tensor, top_k: int):
    """Router softmax in float32 over ``x @ router`` (in x's dtype), the
    top-k renormalized over the k."""
    gates = torch.softmax((x @ router).float(), dim=-1)
    top_gates, top_idx = route_top_k(gates, top_k)
    return top_gates / top_gates.sum(dim=-1, keepdim=True).clamp_min(1e-9), \
        top_idx


def moe_routes(x: torch.Tensor, router: torch.Tensor, top_k: int,
               capacity_factor: float = 1.25) -> MoERoutes:
    """The routes of x [..., T, D]: router softmax in float32 over ``x @
    router`` (in x's dtype), the renormalized top-k (``route_top_k``), then
    each (token, choice)'s rank among its expert's entries in token-major
    order, by a stable sort of the expert ids and ``searchsorted`` starts;
    entries at rank ≥ C are dropped (GShard semantics)."""
    E = router.shape[1]
    C = _capacity(x.shape[-2], E, top_k, capacity_factor)
    top_gates, top_idx = _top_gates(x, router, top_k)
    keep, slot = _ranked(top_idx.reshape(*top_idx.shape[:-2], -1), E, C)
    return MoERoutes(top_gates, top_idx, keep, slot, C)


def _experts(xe: torch.Tensor, p: MoEParams) -> torch.Tensor:
    """The SwiGLU experts on their slots: xe [E, C, D] → [E, C, D]."""
    h = torch.bmm(xe, p.w1)
    g = torch.bmm(xe, p.w3)
    return torch.bmm(F.silu(h) * g, p.w2)


def _dispatch(x: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor,
              top_k: int, n_slots: int) -> torch.Tensor:
    """x [T, D]'s kept (token, choice) entries in their slots of an
    [n_slots, D] buffer of zeros.  Every kept slot receives exactly one
    entry, so the reference's scatter-add is an indexed assignment here (no
    atomics); dropped entries go to one spare row past the buffer, cut off
    after, so every shape is static (no host read of the kept count)."""
    token = torch.arange(x.shape[0] * top_k, device=x.device) // top_k
    xe = x.new_zeros((n_slots + 1, x.shape[1]))
    xe[torch.where(keep, slot, n_slots)] = x[token]
    return xe[:n_slots]


def _combine(ye: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor,
             gates: torch.Tensor, top_k: int) -> torch.Tensor:
    """Each (token, choice)'s slot of ye [n_slots, D] times its gate (cast
    to ye's dtype; 0 where dropped), the k choices summed: [T, D]."""
    gathered = ye[slot]
    gathered = gathered * (keep * gates.reshape(-1)).to(ye.dtype)[:, None]
    return gathered.reshape(-1, top_k, ye.shape[1]).sum(dim=1)


def moe_layer(x: torch.Tensor, p: MoEParams, top_k: int,
              capacity_factor: float = 1.25, rules=None) -> torch.Tensor:
    """Scatter-based token dispatch (no [T, E, C] one-hot).

    x: [T, D] (tokens flattened), routed by ``moe_routes``.  The gates are
    cast to x's dtype before the combine product, then the k choices are
    summed.  With ``rules`` on a mesh, x is this rank's tokens and p holds
    DTensors: see ``moe_sharded``."""
    if rules is not None and rules.mesh is not None:
        return moe_sharded(x, p, top_k, capacity_factor, rules, grouped=False)
    T, D = x.shape
    E = p.router.shape[1]
    r = moe_routes(x, p.router, top_k, capacity_factor)
    C = r.capacity
    xe = _dispatch(x, r.slot, r.keep, top_k, E * C)
    ye = _experts(xe.view(E, C, D), p).reshape(E * C, D)
    return _combine(ye, r.slot, r.keep, r.gates, top_k)


def moe_layer_grouped(x: torch.Tensor, p: MoEParams, top_k: int,
                      capacity_factor: float = 1.25,
                      n_groups: int = 1, rules=None) -> torch.Tensor:
    """Group-local MoE dispatch (GShard-style grouping): the T tokens split
    into ``n_groups`` groups, each routing into its own per-expert capacity
    buffers (C from the group's Tg tokens) against all E experts.

    x: [T, D] with T divisible by n_groups.  With ``rules`` on a mesh, x is
    this rank's group (the ``tokens`` axes' size is the group count) and p
    holds DTensors: see ``moe_sharded``."""
    if rules is not None and rules.mesh is not None:
        return moe_sharded(x, p, top_k, capacity_factor, rules, grouped=True)
    T, D = x.shape
    E = p.router.shape[1]
    G = n_groups
    Tg = T // G
    r = moe_routes(x.reshape(G, Tg, D), p.router, top_k, capacity_factor)
    C = r.capacity
    group = torch.arange(G, device=x.device)[:, None]
    slot = (group * (E * C) + r.slot).reshape(-1)            # into [G·E·C]
    keep = r.keep.reshape(-1)
    xe = _dispatch(x, slot, keep, top_k, G * E * C)
    # [G, E, C, D] → the experts over [E, G·C, D] → back
    xe = xe.view(G, E, C, D).transpose(0, 1).reshape(E, G * C, D)
    ye = _experts(xe, p).view(E, G, C, D).transpose(0, 1).reshape(G * E * C, D)
    return _combine(ye, slot, keep, r.gates, top_k)


def moe_sharded(x: torch.Tensor, p: MoEParams, top_k: int,
                capacity_factor: float, rules, grouped: bool,
                stored=None, reduce_model: bool = True) -> torch.Tensor:
    """One MoE layer on this rank's tokens, over the ranks of
    ``rules.mesh``.

    x: this rank's tokens [Tl, D] (its slice of the flattened B·S over the
    ``tokens`` axes, the same on every rank of the model axes).  p: the
    layer's weights, DTensors in ``param_shardings``' layout (or local blocks
    with ``stored`` giving {weight: {mesh dim: tensor dim}}): experts over
    the ``expert_ep`` (data) axes when E divides them (EP), else whole over
    them (gathered, FSDP); d_ff over the model axes when it divides them
    (TP).  Returns this rank's [Tl, D]: reduced over the model axes, or, with
    ``reduce_model=False``, this rank's partial sum over them.

    ``grouped``: each rank's tokens are one group of ``moe_layer_grouped``
    (C from Tl); with EP the groups' slots reach the experts' ranks by an
    all-to-all over the data axes and return by the reverse one.  Else the
    routes are global as in ``moe_layer`` (C from T = Tl · ranks; each
    entry's rank among all tokens' entries, from the all-gathered expert
    ids): with EP the rank's slots are summed into the experts' ranks by a
    reduce-scatter and the outputs all-gathered; without, summed on every
    rank.  The combine of the rank's own entries runs on the TP partial
    outputs, so the model axes reduce [Tl, D] once."""
    from ..distributed import collectives as C
    from .sharding import local_block, stored_dims

    mesh = rules.mesh
    data = C._active(mesh, rules.axes("tokens"))
    model = C._active(mesh, rules.axes("d_ff"))
    if stored is None:
        stored = {k: stored_dims(getattr(p, k)) for k in MoEParams._fields}
    p = MoEParams(*[t.to_local() if hasattr(t, "to_local") else t for t in p])
    ep = tuple(a for a in data if stored["w1"].get(a) == 0)
    tp = tuple(a for a in model if stored["w1"].get(a) == 2)
    split = {a: True for a in data + tp}
    router = local_block(p.router, mesh, {}, {a: True for a in data},
                         stored["router"])
    E = router.shape[1]
    w = MoEParams(router, *(
        local_block(getattr(p, k), mesh,
                    {**{a: 0 for a in ep}, **{a: d for a in tp}}, split,
                    stored[k])
        for k, d in (("w1", 2), ("w3", 2), ("w2", 1))))
    D = x.shape[1]
    n_ep = C.mesh_size(mesh, ep)
    if grouped:
        r = moe_routes(x, router, top_k, capacity_factor)
        cap, keep, slot, gates = r.capacity, r.keep, r.slot, r.gates
        xe = _dispatch(x, slot, keep, top_k, E * cap).view(E, cap, D)
        if ep:          # [E, C, D] → experts E/n_ep of each group's slots
            xe = C.all_to_all(xe, mesh, ep)
            xe = xe.view(n_ep, E // n_ep, cap, D).transpose(0, 1).reshape(
                E // n_ep, n_ep * cap, D)
    else:
        n = C.mesh_size(mesh, data)
        cap = _capacity(x.shape[0] * n, E, top_k, capacity_factor)
        gates, top_idx = _top_gates(x, router, top_k)
        flat = C.gather(top_idx.reshape(-1), mesh, data, 0, reduce_grad=False)
        keep_all, slot_all = _ranked(flat, E, cap)
        i0 = C.mesh_coord(mesh, data) * top_idx.numel()
        keep = keep_all[i0:i0 + top_idx.numel()]
        slot = slot_all[i0:i0 + top_idx.numel()]
        xe = _dispatch(x, slot, keep, top_k, E * cap).view(E, cap, D)
        if ep:
            xe = C.reduce_scatter(xe, mesh, ep, 0)
        else:
            xe = C.copy(C.reduce(xe, mesh, data), mesh, data)
    ye = _experts(C.copy(xe, mesh, tp), w)          # partial over tp
    if grouped and ep:
        ye = ye.view(E // n_ep, n_ep, cap, D).transpose(0, 1).reshape(
            E, cap, D)
        ye = C.all_to_all(ye, mesh, ep)
    elif ep:
        ye = C.gather(ye, mesh, ep, 0, reduce_grad=True)
    y = _combine(ye.reshape(E * cap, D), slot, keep, C.copy(gates, mesh, tp),
                 top_k)
    return C.reduce(y, mesh, tp) if reduce_model else y


def moe_aux_loss(x: torch.Tensor, router: torch.Tensor,
                 top_k: int, rules=None) -> torch.Tensor:
    """Switch/GShard load-balance auxiliary loss (float32 scalar).  With
    ``rules`` on a mesh, x is this rank's tokens and the means run over
    every rank's tokens of the ``tokens`` axes (router: a DTensor, or the
    whole matrix as this rank's work takes it, ``local_block``'s)."""
    E = router.shape[1]
    if rules is None or rules.mesh is None:
        gates = torch.softmax((x @ router).float(), dim=-1)
        _, top_idx = route_top_k(gates, top_k)
        me = gates.mean(dim=0)                           # mean gate per expert
        ce = F.one_hot(top_idx[:, 0], E).float().mean(dim=0)  # top-1 load
        return E * (me * ce).sum()
    from ..distributed import collectives as C
    from .sharding import local_block

    mesh = rules.mesh
    data = C._active(mesh, rules.axes("tokens"))
    if hasattr(router, "to_local"):
        router = local_block(router, mesh, {}, {a: True for a in data})
    T = x.shape[0] * C.mesh_size(mesh, data)
    gates = torch.softmax((x @ router).float(), dim=-1)
    _, top_idx = route_top_k(gates, top_k)
    me = C.reduce(gates.sum(dim=0), mesh, data) / T
    ce = C.reduce(F.one_hot(top_idx[:, 0], E).float().sum(dim=0), mesh,
                  data) / T
    return E * (me * ce).sum()


# ---------------------------------------------------------------------------
# Fixed-order gathers and segment sums, EmbeddingBag, MLP
# ---------------------------------------------------------------------------

class RowIndex:
    """Row ids ``ids`` (int, any shape's flat view) into a tensor of ``n``
    rows, with the ``Segments`` of ``core/incidence`` (a stable sort, no
    atomics) built at first use and kept: a model builds one per index
    array per forward, and every layer's gather and sum over it reuses the
    plan, in the forward or the backward."""

    def __init__(self, ids: torch.Tensor, n: int):
        self.ids = ids.reshape(-1)
        self.n = int(n)
        self._seg = None

    @property
    def seg(self):
        if self._seg is None:
            from ..core import incidence

            self._seg = incidence.segments(self.ids, self.n)
        return self._seg

    def sum_rows(self, x: torch.Tensor) -> torch.Tensor:
        from ..core import incidence

        return incidence.segment_sum_rows(self.seg, x)


class _Gather(torch.autograd.Function):
    """x[ids] (rows); backward: the fixed-order segment sum over ids."""

    @staticmethod
    def forward(ctx, x, index):
        ctx.index = index
        return x.index_select(0, index.ids)

    @staticmethod
    def backward(ctx, g):
        return ctx.index.sum_rows(g.contiguous()), None


class _SegmentSum(torch.autograd.Function):
    """Per-row sums over ids in a fixed order; backward: the gather."""

    @staticmethod
    def forward(ctx, x, index):
        ctx.index = index
        return index.sum_rows(x)

    @staticmethod
    def backward(ctx, g):
        return g.index_select(0, ctx.index.ids), None


def gather(x: torch.Tensor, index: RowIndex) -> torch.Tensor:
    """``x[index.ids]`` along dim 0, shaped ``index.ids.shape +
    x.shape[1:]``.  Where a gradient flows to ``x`` its backward is
    ``index``'s fixed-order segment sum (autograd's own scatters with
    atomics on the card); on the CPU its bits are those of
    ``index_select``'s and ``F.embedding``'s backward."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Gather.apply(x, index)
    return x.index_select(0, index.ids)


def segment_sum(x: torch.Tensor, index: RowIndex) -> torch.Tensor:
    """``jax.ops.segment_sum(x, ids, num_segments=n)`` over the rows of
    ``x``, in the fixed order of ``index`` (the same bits on every run;
    on the CPU those of ``index_add_``); its backward gathers."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _SegmentSum.apply(x, index)
    return index.sum_rows(x)


def gather_sharded(x: torch.Tensor, index: RowIndex, mesh, axes
                   ) -> torch.Tensor:
    """``gather`` of rows of a tensor sharded along dim 0 over ``axes`` of
    ``mesh`` (``x`` this rank's block, ``index`` global row ids): the
    blocks all-gathered, then gathered.  Its backward is
    ``segment_sum_sharded`` of the gradient (the fixed-order sum onto every
    row, reduce-scattered back to the blocks)."""
    from ..distributed import collectives as C

    return gather(C.gather(x, mesh, axes, 0), index)


def segment_sum_sharded(x: torch.Tensor, index: RowIndex, mesh, axes
                        ) -> torch.Tensor:
    """``segment_sum`` onto ``index.n`` rows sharded along dim 0 over
    ``axes``: this rank's partial sums over all rows, reduce-scattered to
    its block.  Its backward is ``gather_sharded`` of the gradient."""
    from ..distributed import collectives as C

    return C.reduce_scatter(segment_sum(x, index), mesh, axes, 0)


def embedding_bag(table: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor,
                  mode: str = "sum") -> torch.Tensor:
    """EmbeddingBag over fixed-width multi-hot bags: table [V, D], ids
    int[B, W], mask f[B, W] (0 = padding).  A gather plus ``bag_reduce``,
    as the reference's."""
    emb = gather(table, RowIndex(ids, table.shape[0])).reshape(
        ids.shape + table.shape[1:])
    return bag_reduce(emb, mask, mode)


def bag_reduce(emb: torch.Tensor, mask: torch.Tensor,
               mode: str = "sum") -> torch.Tensor:
    """The masked reduce of ``embedding_bag`` over looked-up rows emb
    [B, W, D]: ``mean`` divides by the bag's mask sum (at least 1),
    ``max`` fills padding with ``NEG_INF``."""
    emb = emb * mask[..., None].to(emb.dtype)
    if mode == "sum":
        return emb.sum(dim=1)
    if mode == "mean":
        denom = torch.clamp(mask.sum(dim=1, keepdim=True), min=1.0)
        return emb.sum(dim=1) / denom.to(emb.dtype)
    if mode == "max":
        return torch.where(mask[..., None] > 0, emb, NEG_INF).amax(dim=1)
    raise ValueError(mode)


def embedding_bag_ragged(table: torch.Tensor, flat_ids: torch.Tensor,
                         segment_ids: torch.Tensor, num_bags: int,
                         weights: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Ragged EmbeddingBag: a gather plus the fixed-order segment sum of
    the rows into ``num_bags`` bags (CSR-style bags)."""
    emb = gather(table, RowIndex(flat_ids, table.shape[0]))
    if weights is not None:
        emb = emb * weights[:, None]
    return segment_sum(emb, RowIndex(segment_ids, num_bags))


def mlp(x: torch.Tensor, weights, biases, act=torch.relu,
        final_act: bool = False) -> torch.Tensor:
    """Plain MLP: weights/biases are lists of tensors."""
    n = len(weights)
    for i, (w, b) in enumerate(zip(weights, biases)):
        x = x @ w + b
        if i < n - 1 or final_act:
            x = act(x)
    return x
