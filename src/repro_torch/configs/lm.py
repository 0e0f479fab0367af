"""The five assigned LM architectures (exact configs from the assignment).

Every arch gets a ``config()`` (full size) and a ``reduced()`` (smoke-test
size: same structural features — GQA ratio, MoE, window pattern, bias — at
toy width/depth).  A copy of the JAX package's ``repro/configs/lm.py`` on the
port's ``LMConfig`` (torch dtypes); the dense and the MoE archs
(llama4-maverick, mixtral-8x22b) all build and serve."""
from __future__ import annotations

import dataclasses

import torch

from ..models.transformer import LMConfig, MoECfg

LM_CELLS = ("train_4k", "prefill_32k", "decode_32k", "long_500k")

LM_SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}


def minitron_4b() -> LMConfig:
    # pruned nemotron [arXiv:2407.14679]
    return LMConfig("minitron-4b", n_layers=32, d_model=3072, n_heads=24,
                    n_kv_heads=8, d_head=128, d_ff=9216, vocab=256000,
                    dtype=torch.bfloat16)


def qwen2_1_5b() -> LMConfig:
    # GQA kv=2, QKV bias [arXiv:2407.10671]
    return LMConfig("qwen2-1.5b", n_layers=28, d_model=1536, n_heads=12,
                    n_kv_heads=2, d_head=128, d_ff=8960, vocab=151936,
                    qkv_bias=True, dtype=torch.bfloat16)


def gemma3_27b() -> LMConfig:
    # 5:1 local:global, 1024-token window, 128k-capable rope
    return LMConfig("gemma3-27b", n_layers=62, d_model=5376, n_heads=32,
                    n_kv_heads=16, d_head=128, d_ff=21504, vocab=262144,
                    window=1024, layer_pattern=("L", "L", "L", "L", "L", "G"),
                    rope_theta=1_000_000.0, dtype=torch.bfloat16)


def llama4_maverick() -> LMConfig:
    # MoE 128e top-1 + shared expert (early-fusion text backbone)
    return LMConfig("llama4-maverick-400b-a17b", n_layers=48, d_model=5120,
                    n_heads=40, n_kv_heads=8, d_head=128, d_ff=8192,
                    vocab=202048,
                    moe=MoECfg(n_experts=128, top_k=1, capacity_factor=1.25,
                               shared_expert=True),
                    dtype=torch.bfloat16)


def mixtral_8x22b() -> LMConfig:
    # 8 experts top-2, sliding-window attention.  Group-local dispatch:
    # 8 experts can't shard over a 16-wide data axis, so global dispatch
    # degenerates into all-reduce storms (§Perf mixtral iteration 1).
    return LMConfig("mixtral-8x22b", n_layers=56, d_model=6144, n_heads=48,
                    n_kv_heads=8, d_head=128, d_ff=16384, vocab=32768,
                    moe=MoECfg(n_experts=8, top_k=2, capacity_factor=1.25,
                               dispatch="grouped"),
                    window=4096, layer_pattern=("L",), dtype=torch.bfloat16)


def _reduced(base: LMConfig) -> LMConfig:
    kw = dict(
        n_layers=max(2, base.period * 2) if base.period > 1 else 2,
        d_model=64, n_heads=4,
        n_kv_heads=max(1, 4 * base.n_kv_heads // base.n_heads),
        d_head=16, d_ff=128, vocab=512, dtype=torch.float32,
        window=8 if base.window else None,
        q_chunk=16, k_chunk=16, loss_chunk=16, remat=False)
    if base.moe:
        kw["moe"] = MoECfg(n_experts=4, top_k=base.moe.top_k,
                           capacity_factor=2.0,
                           shared_expert=base.moe.shared_expert)
    return dataclasses.replace(base, **kw)


LM_ARCHS = {
    "minitron-4b": minitron_4b,
    "qwen2-1.5b": qwen2_1_5b,
    "gemma3-27b": gemma3_27b,
    "llama4-maverick-400b-a17b": llama4_maverick,
    "mixtral-8x22b": mixtral_8x22b,
}


def reduced_lm(arch_id: str) -> LMConfig:
    return _reduced(LM_ARCHS[arch_id]())
