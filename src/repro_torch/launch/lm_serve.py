"""Batched LM serving driver: prefill a batch of prompts, then decode.

The port of ``repro/launch/lm_serve.py`` (same flags, same printout, plus
``--device`` and ``--use-pallas-attention``), with a reduced config:

  PYTHONPATH=src python -m repro_torch.launch.lm_serve --arch qwen2-1.5b \\
      --reduced --batch 4 --prompt-len 64 --gen 32 [--device cpu]

Every arch of the port's registry serves, the MoE ones (``--arch
mixtral-8x22b``, ``--arch llama4-maverick-400b-a17b``) included.

Reports prefill latency and steady-state decode throughput, and greedy-
decodes from the synthetic token stream (the tokens are synthetic, so the
"text" is ids — the plumbing is what's demonstrated: batched requests, KV
cache reuse, the cache updated in place between steps).  The work is in
``serve``, which ``chip_smoke.py`` drives at full width on the card.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..configs import registry
from ..data.lm import token_batch
from ..models import transformer as tr


def serve(cfg: tr.LMConfig, params, prompts, gen: int, device="cuda"):
    """Prefill ``prompts`` [B, P] (cache capacity reserved for ``gen``
    tokens), then greedy-decode: the first token from the prefill's logits,
    the other gen − 1 from a host loop of ``decode_step``.  ``params``: a
    ``Transformer``'s ``tree()``.  Returns (tokens int32 [B, gen] as numpy,
    {"prefill_s", "decode_s"}), each time ending in a device
    synchronization."""
    dev = torch.device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    toks = torch.as_tensor(np.asarray(prompts), dtype=torch.long, device=dev)
    P = toks.shape[1]
    sync()
    t0 = time.perf_counter()
    logits, cache = tr.prefill(params, toks, cfg, pad_cache_to=P + gen)
    tok = logits.argmax(dim=-1)
    sync()
    t_prefill = time.perf_counter() - t0
    outs = [tok]
    t1 = time.perf_counter()
    for step in range(gen - 1):
        logits, cache = tr.decode_step(params, cache, tok, P + step, cfg)
        tok = logits.argmax(dim=-1)
        outs.append(tok)
    sync()
    t_decode = time.perf_counter() - t1
    tokens = torch.stack(outs, dim=1).to(torch.int32).cpu().numpy()
    return tokens, {"prefill_s": t_prefill, "decode_s": t_decode}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--use-pallas-attention", action="store_true",
                    help="prefill attention through the CUDA kernel")
    args = ap.parse_args(argv)

    entry = registry.get(args.arch)
    cfg = entry.make_reduced() if args.reduced else entry.make_config()
    if args.use_pallas_attention:
        cfg = dataclasses.replace(cfg, use_pallas_attention=True)
    print(f"model {cfg.name}: {cfg.param_count()/1e6:.1f}M params (reduced)"
          if args.reduced else f"model {cfg.name}")

    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    params = tr.init_params(cfg, gen, device=args.device).tree()
    B, P, N = args.batch, args.prompt_len, args.gen
    prompts = token_batch(cfg.vocab, B, P, seed=args.seed)
    out, tm = serve(cfg, params, prompts, N, args.device)
    t_prefill, t_decode = tm["prefill_s"], tm["decode_s"]
    print(f"prefill: {B}x{P} tokens in {t_prefill*1e3:.0f} ms "
          f"({B*P/t_prefill/1e3:.1f}k tok/s incl. compile)")
    print(f"decode : {N-1} steps in {t_decode*1e3:.0f} ms "
          f"({B*(N-1)/max(t_decode,1e-9):.0f} tok/s, batch {B})")
    for b in range(min(B, 2)):
        print(f"req{b}: prompt[-8:]={prompts[b,-8:].tolist()} "
              f"→ gen[:12]={out[b,:12].tolist()}")


if __name__ == "__main__":
    main()
