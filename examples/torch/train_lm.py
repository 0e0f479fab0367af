"""End-to-end driver: train a ~100M-param LM for a few hundred steps with
the port's training stack — AdamW, the fault-tolerant controller with
async checkpoints, auto-resume.

  PYTHONPATH=src python examples/torch/train_lm.py --steps 300               # the card
  PYTHONPATH=src python examples/torch/train_lm.py --steps 1 --device cpu    # the CPU
(kill it mid-run and re-launch: it resumes from the latest checkpoint.)

The twin of ``examples/train_lm.py`` on the port: the same model, flags
and printout, parameters from a seeded ``torch.Generator``.  On ``cuda``
(the default) it needs a card and exits non-zero without one.
"""
import argparse
import time

import torch

from repro_torch.data.lm import TokenStream
from repro_torch.models.transformer import LMConfig, init_params, lm_loss
from repro_torch.train.fault import TrainController
from repro_torch.train.optimizer import AdamWConfig, init_state
from repro_torch.train.train_step import build_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default="experiments/train_lm_100m")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card (torch.cuda.is_available() is False); "
                         "pass --device cpu to run on the CPU")

    # ~100M params: 12L × d768 (GPT-2-small-ish with GQA + SwiGLU)
    cfg = LMConfig("lm-100m", n_layers=12, d_model=768, n_heads=12,
                   n_kv_heads=4, d_head=64, d_ff=2048, vocab=32768,
                   dtype=torch.float32, q_chunk=128, k_chunk=128,
                   loss_chunk=64, remat=False)
    n_params = cfg.param_count()
    print(f"model: {n_params/1e6:.1f}M params")

    opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=50)
    step = build_train_step(lambda p, b: lm_loss(p, b, cfg), opt_cfg)

    def step_fn(state, batch):
        p, o = state
        p, o, m = step(p, o, batch)
        return (p, o), m

    def init():
        gen = torch.Generator(device=device).manual_seed(0)
        params = init_params(cfg, gen, device=device).tree()
        return params, init_state(opt_cfg, params)

    ctl = TrainController(step_fn, args.ckpt_dir, ckpt_every=100)
    start, state = ctl.resume_or_init(init, device=device)
    if start > 0:
        print(f"resumed from step {start}")

    stream = (torch.from_numpy(b).to(device)
              for b in TokenStream(cfg.vocab, args.batch, args.seq, seed=0))
    t0 = time.time()
    losses = []
    while start < args.steps:
        chunk = min(20, args.steps - start)
        start, state, stop = ctl.run(state, stream, start, chunk)
        rec = ctl.journal.read()[-1]
        losses.append(rec.get("loss"))
        toks_per_s = args.batch * args.seq / max(rec.get("dt", 1), 1e-9)
        print(f"step {start:4d}  loss {rec.get('loss'):.4f}  "
              f"{toks_per_s/1e3:.1f}k tok/s", flush=True)
        if stop != "completed":
            print(f"stopped: {stop}")
            return
    if losses:
        print(f"trained to step {start} in {time.time()-t0:.0f}s; "
              f"loss {losses[0]:.3f} → {losses[-1]:.3f}")


if __name__ == "__main__":
    main()
