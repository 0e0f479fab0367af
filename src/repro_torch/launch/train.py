"""End-to-end training driver (``--arch <id>`` selects from the registry).

The port of ``repro/launch/train.py`` (the same flags and printout, plus
``--device``): config registry → parameters from a seeded
``torch.Generator`` on the device → the synthetic data pipeline (LM
tokens, GNN batches of the ``full_graph_sm`` cell or ``REDUCED_CELL``, DIN
click logs) → the train step (AdamW, microbatches) → the fault-tolerant
controller (checkpoint, resume, preemption, straggler watchdog).  It runs
on the card unless ``--device cpu`` is given.

Examples:
  python -m repro_torch.launch.train --arch qwen2-1.5b --reduced --steps 20
  python -m repro_torch.launch.train --arch gcn-cora --reduced --steps 100 \\
      --device cpu
  python -m repro_torch.launch.train --arch din --reduced --steps 50

``--arch pirmcut`` is the solver's (``launch.solve``).
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import registry
from ..data.lm import TokenStream
from ..models import gnn as g
from ..models import recsys as r
from ..models import transformer as tr
from ..train.fault import TrainController
from ..train.optimizer import AdamWConfig, init_state
from ..train.train_step import build_train_step


def build_lm_training(arch: str, reduced: bool, batch: int, seq: int,
                      seed: int, device="cuda"):
    """(cfg, params tree, loss_fn, batches on ``device``) of an LM arch."""
    entry = registry.get(arch)
    cfg = entry.make_reduced() if reduced else entry.make_config()
    gen = torch.Generator(device=device).manual_seed(seed)
    params = tr.init_params(cfg, gen, device=device).tree()
    loss_fn = lambda p, b: tr.lm_loss(p, b, cfg)
    stream = TokenStream(cfg.vocab, batch, seq, seed=seed)
    batches = (torch.from_numpy(b).to(device) for b in stream)
    return cfg, params, loss_fn, batches


def build_gnn_training(arch: str, reduced: bool, seed: int, device="cuda",
                       cell: str = "full_graph_sm"):
    """(cfg, params tree, loss_fn, batches on ``device``) of a GNN arch:
    its full config on ``cell`` (the reference launcher's
    ``full_graph_sm`` unless another is asked for), or the reduced one on
    ``REDUCED_CELL``; batch i is ``synthetic_gnn_batch`` at ``seed + i``,
    as the reference's, and the loss adds the cell's ``n_graphs``."""
    from ..configs.gnn import REDUCED_CELL
    from ..data.graphs import synthetic_gnn_batch

    entry = registry.get(arch)
    shape = REDUCED_CELL if reduced else entry.shapes[cell]
    cfg = entry.make_reduced() if reduced else entry.make_config(shape)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = g.INITS[arch](cfg, gen, device)
    loss = g.LOSSES[arch]
    ng_static = shape.get("n_graphs", 1)

    def batches():
        i = 0
        while True:
            b = synthetic_gnn_batch(
                arch, shape["n_nodes"], shape["n_edges"],
                d_feat=getattr(cfg, "in_dim", None) or shape["d_feat"],
                n_graphs=ng_static, n_classes=shape.get("n_classes", 7),
                max_triplets=shape.get("n_triplets"),
                in_edge_dim=getattr(cfg, "in_edge_dim", 7),
                out_dim=getattr(cfg, "out_dim", 3), seed=seed + i)
            i += 1
            b.pop("n_graphs", None)
            yield {k: torch.from_numpy(v).to(device) for k, v in b.items()}

    def loss_fn(p, b):
        bb = dict(b, n_graphs=ng_static) if arch in ("schnet", "dimenet") \
            else b
        return loss(p, bb, cfg)

    return cfg, params, loss_fn, batches()


def build_din_training(reduced: bool, batch: int, seed: int, device="cuda"):
    """(cfg, params tree, loss_fn, batches on ``device``) of DIN: batch i
    is ``din_batch`` at ``seed + i``, as the reference's."""
    from ..data.recsys import din_batch

    entry = registry.get("din")
    cfg = entry.make_reduced() if reduced else entry.make_config()
    gen = torch.Generator(device=device).manual_seed(seed)
    params = r.din_init(cfg, gen, device)

    def batches():
        i = 0
        while True:
            b = din_batch(batch, cfg.seq_len, cfg.n_items, cfg.n_cates,
                          cfg.n_tags, cfg.tag_bag_width, seed=seed + i)
            i += 1
            yield {k: torch.from_numpy(v).to(device) for k, v in b.items()}

    return cfg, params, lambda p, b: r.din_loss(p, b, cfg), batches()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    entry = registry.get(args.arch)
    if entry.family == "solver":
        raise SystemExit("use launch.solve for the solver workload")
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA card "
                         f"(torch.cuda.is_available() is False); pass "
                         f"--device cpu to train on the CPU")
    if entry.family == "lm":
        cfg, params, loss_fn, batches = build_lm_training(
            args.arch, args.reduced, args.batch, args.seq, args.seed, dev)
    elif entry.family == "gnn":
        cfg, params, loss_fn, batches = build_gnn_training(
            args.arch, args.reduced, args.seed, dev)
    else:
        cfg, params, loss_fn, batches = build_din_training(
            args.reduced, args.batch, args.seed, dev)

    opt_cfg = AdamWConfig(lr=args.lr)
    step = build_train_step(loss_fn, opt_cfg,
                            n_microbatches=args.microbatches)

    def step_fn(state, batch):
        p, o = state
        p, o, m = step(p, o, batch)
        return (p, o), m

    ckpt_dir = args.ckpt_dir or f"experiments/train_{args.arch}"
    ctl = TrainController(step_fn, ckpt_dir, ckpt_every=args.ckpt_every,
                          install_signal_handler=True)
    start, state = ctl.resume_or_init(
        lambda: (params, init_state(opt_cfg, params)), device=dev)

    t0 = time.time()
    step_i = start
    batch_iter = iter(batches)
    while step_i < args.steps:
        chunk = min(args.log_every, args.steps - step_i)
        step_i, state, stop = ctl.run(state, batch_iter, step_i, chunk)
        rec = ctl.journal.read()[-1]
        print(f"step {step_i:5d} loss {rec.get('loss', float('nan')):.4f} "
              f"({rec.get('dt', 0)*1e3:.0f} ms/step)", flush=True)
        if stop != "completed":
            print(f"stopped: {stop}")
            break
    print(f"done in {time.time()-t0:.1f}s; checkpoints in {ckpt_dir}")
    return ctl


if __name__ == "__main__":
    main()
