"""Times kernels of one tree of the port, by both of ``chip_smoke.py``'s
methods, and their wrappers' host time.

    python3 kernel_times.py [--src DIR] [--kernels ell|edge_reweight|coo]
                            [--side N] [--lanes 4] [--out FILE]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed (by
default this checkout's), so that two commits can be compared on one card
in one run: unpack the other commit into a directory that git ignores and
run parent, change, change, parent.  ``--kernels`` picks the set:

- ``ell`` (the default): the batched ELL path's three kernels on the inputs
  of ``chip_smoke.py``'s phase 9 (``batched_ell_kernels``), made from
  ``--seed`` on the card: B = ``--lanes`` lanes of values over the ELL plan
  of a ``--side``³ 26-connected grid, and the lanes' [B·P, bs, bs] block
  inverses (8³-voxel boxes);
- ``edge_reweight``: ``edge_reweight`` on the inputs of phase 7
  (``edge_reweight_alone``): the COO graph of the ``--side``³ volume (96 by
  default here) at B = 1 and B = 8, and of the 1024² 4-connected frame at
  B = 8;
- ``coo``: the COO path of ``chip_smoke.py``'s phase 8 on the ``--side``³
  volume (96 by default here), in ``MinCutServer``'s default config with
  ``use_pallas``: the matvec (``laplacian.matvec_coo``) and the reweight
  with its degree sums (``laplacian.reweight``) at B = 8, the sweep
  rounding of one lane (``rounding.sweep_cut_torch``), and a cold
  ``solve_batch`` of 8 drifted lanes (phase 8's first volume batch, no
  warm start) with sweep rounding.  These are plain torch, so a tree's
  ``--src`` decides whether they scatter with atomics (``index_add_``) or
  in a fixed order; the sweep (its argmin indexes on the card) and the
  batch (its PCG waits on the card every step) have no ``graph_ms``.

Per call, three rounds of:

- ``ms``: back-to-back calls between two CUDA events
  (``chip_smoke.time_ms``);
- ``graph_ms``: the same calls captured in a CUDA graph and replayed, the
  launches' device time (``chip_smoke.graph_ms``);
- ``host_us``: the call's host time, the wall time of a loop of calls that
  never waits on the card (far fewer launches than its queue holds), over
  their number.

Prints the card's name and power limit, one line per call and, last, one
JSON object with every round; ``--out`` writes the same object to a file.
Needs one CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# the side of chip_smoke.py's serving frame (its --frame default)
FRAME = 1024
KERNEL_SETS = {"ell": ("ell_spmv", "fused_ell_sweep", "block_diag_matvec"),
               "edge_reweight": ("edge_reweight",),
               "coo": ("edge_reweight",)}


def host_us(fn, calls: int) -> float:
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    wall = time.perf_counter() - t
    torch.cuda.synchronize()
    return wall / calls * 1e6


def kernel_calls(side: int, lanes: int, seed: int) -> dict:
    """The wrapper calls to time, by kernel, on phase 9's inputs, with
    their repetitions."""
    import torch

    import chip_smoke as smoke
    from repro_torch.core import Problem
    from repro_torch.core import laplacian as lap
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    labels, n_blocks = smoke.box_labels(side)
    prob = Problem.build(smoke.segmentation_grid(side, seed),
                         n_blocks=n_blocks, labels=labels)
    plan = prob.ell_plan(dev)
    g = prob.device_graph(torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    cols = plan.cols
    n, k = cols.shape
    valid = torch.zeros((n, k), dtype=torch.bool, device=dev)
    valid[plan.slot_rows, plan.slot_cols] = True
    vals = -torch.rand((lanes, n, k), generator=gen, device=dev) * valid
    diag = torch.rand((lanes, n), generator=gen, device=dev) + (-vals).sum(-1)
    v = torch.rand((lanes, n), generator=gen, device=dev)
    c = g.c * (0.8 + 0.4 * torch.rand((lanes, g.m), generator=gen, device=dev))
    sweep = (cols, lap.ell_edge_weights(plan, c),
             g.c_s.expand(lanes, n).contiguous(),
             g.c_t.expand(lanes, n).contiguous(), v, 1e-6)
    bplan = prob.block_plan(dev)
    p, bs = lanes * bplan.p, bplan.bs
    A = torch.randn((p, bs, bs), generator=gen, device=dev)
    x = torch.randn((p, bs), generator=gen, device=dev)
    return {"ell_spmv": (lambda: ops.ell_spmv(cols, vals, diag, v), 100),
            "fused_ell_sweep": (lambda: ops.fused_ell_sweep(*sweep), 50),
            "block_diag_matvec": (lambda: ops.block_diag_matvec(A, x), 30)}


def edge_reweight_calls(side: int, seed: int) -> dict:
    """The wrapper calls of ``edge_reweight`` on phase 7's inputs, with
    their repetitions."""
    import torch

    import chip_smoke as smoke
    from repro_torch.core import IRLSConfig, Problem
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    eps = IRLSConfig().eps
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    calls = {}
    for tenant, inst, lane_counts in (
            ("volume", smoke.segmentation_grid(side, seed), (1, 8)),
            ("frame", smoke.frame_instance(FRAME, seed + 2), (8,))):
        g = Problem.build(inst, n_blocks=1).device_graph(torch.float32,
                                                         device=dev)
        for lanes in lane_counts:
            c, v = smoke.edge_reweight_inputs(g, lanes, gen)
            args = (g.src, g.dst, c, v, eps)
            calls[f"edge_reweight {tenant} B={lanes}"] = (
                lambda args=args: ops.edge_reweight_r(*args), 50)
    return calls


def coo_calls(side: int, seed: int) -> dict:
    """The COO path's calls on phase 8's volume: operators at B = 8, one
    lane's sweep rounding, and a cold batch of 8 (no CUDA graph: its PCG
    waits on the card every step)."""
    import numpy as np
    import torch

    import chip_smoke as smoke
    from repro_torch.core import MinCutSession, Problem
    from repro_torch.core import laplacian as lap
    from repro_torch.core import rounding as rd

    dev = torch.device("cuda")
    inst = smoke.segmentation_grid(side, seed)
    cfg = smoke.server_cfg(True)
    sess = MinCutSession(Problem.build(inst, n_blocks=1), cfg, device=dev)
    g = sess.problem.device_graph(torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 8)
    lanes = 8
    c, v = smoke.edge_reweight_inputs(g, lanes, gen)
    gb = g._replace(c=c)
    rw = lap.reweight(gb, v, cfg.eps)
    x = torch.randn((lanes, g.n), generator=gen, device=dev)
    src, dst = g.src.long(), g.dst.long()
    # the topology's COO plan, in a tree that has one (an older tree's
    # sweep scatters and takes none)
    plan = (g.coo,) if "coo" in g._fields else ()
    ws, _ = smoke.serve_traffic(np.random.default_rng(seed), inst, 1.0,
                                lanes, 0.05)
    return {"matvec_coo B=8": (lambda: lap.matvec_coo(gb, rw, x), 20, True),
            "reweight B=8": (lambda: lap.reweight(gb, v, cfg.eps), 20, True),
            "sweep_cut": (lambda: rd.sweep_cut_torch(src, dst, g.c, g.c_s,
                                                     g.c_t, v[0], *plan),
                          10, False),
            "cold batch B=8": (lambda: sess.solve_batch(ws, rounding="sweep",
                                                        pad_to=lanes),
                               1, False)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--kernels", choices=sorted(KERNEL_SETS), default="ell")
    ap.add_argument("--side", type=int, default=None,
                    help="grid side (48 for ell, 96 for edge_reweight)")
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))

    import torch

    import chip_smoke as smoke

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    import repro_torch
    from repro_torch.kernels import build

    build.build_all(KERNEL_SETS[args.kernels])
    card = smoke.card_line()
    print(card, flush=True)
    if args.kernels == "ell":
        side = args.side or 48
        calls = kernel_calls(side, args.lanes, args.seed)
    elif args.kernels == "coo":
        side = args.side or 96
        calls = coo_calls(side, args.seed)
    else:
        side = args.side or 96
        calls = edge_reweight_calls(side, args.seed)
    runs = {}
    for name, call in calls.items():
        fn, reps, graphable = (call + (True,))[:3]
        fn()
        r = runs[name] = {"ms": []}
        if graphable:
            r.update(graph_ms=[], host_us=[])
        for _ in range(args.rounds):
            r["ms"].append(smoke.time_ms(fn, reps,
                                         warmup=3 if graphable else 1))
            if graphable:
                r["graph_ms"].append(smoke.graph_ms(fn, reps))
                r["host_us"].append(host_us(fn, reps))
        med = {key: statistics.median(t) for key, t in r.items()}
        r["median"] = med
        if graphable:
            print(f"{name}: {med['ms']:.4f} ms a call back to back, "
                  f"{med['graph_ms']:.4f} ms a launch in a CUDA graph, "
                  f"{med['host_us']:.1f} us of host time a call", flush=True)
        else:
            print(f"{name}: {med['ms']:.4f} ms a call", flush=True)
    report = {"src": str(Path(repro_torch.__file__).parent), "card": card,
              "side": side}
    if args.kernels == "ell":
        report["lanes"] = args.lanes
    elif args.kernels == "edge_reweight":
        report["frame"] = FRAME
    report["kernels"] = runs
    if args.out:
        Path(args.out).write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
