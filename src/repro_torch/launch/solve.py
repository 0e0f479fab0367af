"""End-to-end PIRMCut driver — Algorithm 1 on a real instance, on the card.

The port of ``repro/launch/solve.py`` (same flags, printout and
``--json-out`` fields, plus ``--device``):

  PYTHONPATH=src python -m repro_torch.launch.solve --family grid --side 64 --blocks 8
  PYTHONPATH=src python -m repro_torch.launch.solve --family road --side 256 --irls 20
  PYTHONPATH=src python -m repro_torch.launch.solve --family grid --side 12 --device cpu

Pipeline (paper Algorithm 1) through the session API: build the instance →
``Problem.build`` (k-way partition + reorder, ONCE) → ``MinCutSession.solve``
(IRLS with warm-started block-Jacobi PCG → rounding) → report the cut
value, δ vs the exact serial solver and per-phase times.  ``--repeat``
re-solves on the cached session (the steady-state time of sequence
workloads).  The sharded backend is not ported yet (ROADMAP queue 1,
``distributed/``): ``--backend sharded`` and ``--sharded`` raise.
"""
from __future__ import annotations

import argparse
import json
import time

_SHARDED = ("the sharded backend is not ported yet: ROADMAP queue 1, "
            "distributed/")


def build_instance(family: str, side: int, seed: int):
    from ..graphs import generators as gen

    if family == "road":
        g = gen.road_like(side, seed=seed)
        return gen.flow_improve_instance(g, seed=seed + 1)
    if family == "grid":
        g = gen.grid_2d(side, side, seed=seed)
        return gen.segmentation_instance(g, (side, side), seed=seed + 1)
    if family == "grid3d":
        g = gen.grid_3d(side, side, side, conn=26, seed=seed)
        return gen.segmentation_instance(g, (side, side, side), seed=seed + 1)
    raise ValueError(family)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--family", default="grid", choices=["road", "grid", "grid3d"])
    ap.add_argument("--side", type=int, default=48)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eps", type=float, default=1e-6)
    ap.add_argument("--irls", type=int, default=50)
    ap.add_argument("--pcg-iters", type=int, default=50)
    ap.add_argument("--blocks", type=int, default=8)
    ap.add_argument("--precond", default="block_jacobi",
                    choices=["block_jacobi", "jacobi", "chebyshev", "none"])
    ap.add_argument("--rounding", default="two_level",
                    choices=["two_level", "sweep", "both"])
    ap.add_argument("--cold-start", action="store_true")
    ap.add_argument("--backend", default="host",
                    choices=["host", "scanned", "sharded"])
    ap.add_argument("--sharded", action="store_true",
                    help="alias for --backend sharded (not ported yet)")
    ap.add_argument("--repeat", type=int, default=1,
                    help="re-solve on the cached session (amortized path)")
    ap.add_argument("--no-exact", action="store_true",
                    help="skip the exact serial baseline (large instances)")
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="where the session solves: cuda (the kernels' "
                         "card) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    backend = "sharded" if args.sharded else args.backend
    if backend == "sharded":
        raise NotImplementedError(_SHARDED)

    from ..core import IRLSConfig, MinCutSession, Problem, max_flow
    from ..core import rounding as rd

    t0 = time.time()
    inst = build_instance(args.family, args.side, args.seed)
    t_build = time.time() - t0
    print(f"instance: n={inst.n:,} m={inst.graph.m:,} ({t_build:.1f}s)")

    cfg = IRLSConfig(eps=args.eps, n_irls=args.irls,
                     pcg_max_iters=args.pcg_iters, n_blocks=args.blocks,
                     precond=args.precond, warm_start=not args.cold_start)

    t1 = time.time()
    n_blocks = args.blocks if args.precond == "block_jacobi" else 1
    prob = Problem.build(inst, n_blocks=n_blocks)
    t_problem = time.time() - t1
    sess = MinCutSession(prob, cfg, backend=backend, device=args.device)

    todo = ["two_level", "sweep"] if args.rounding == "both" else [args.rounding]
    res = sess.solve(rounding=todo[0])
    for _ in range(args.repeat - 1):
        res = sess.solve(rounding=todo[0])
    t_irls = res.timings["irls"]

    results = {"n": inst.n, "m": inst.graph.m, "t_build": t_build,
               "t_problem": t_problem, "t_irls": t_irls, "backend": backend,
               f"cut_{todo[0]}": res.cut_value,
               f"t_{todo[0]}": res.timings["rounding"]}
    print(f"problem setup (partition+reorder): {t_problem:.1f}s")
    print(f"IRLS [{backend}]: {t_irls:.1f}s"
          + (f" (stepper build {res.timings['setup']:.1f}s)"
             if res.timings.get("setup") else ""))
    print(f"{todo[0]}: cut={res.cut_value:.4f} "
          f"({res.timings['rounding']:.1f}s)"
          + (f" reduction {res.cut.meta['reduction']:.1f}x "
             f"(coarse n={res.cut.meta['coarse_n']})"
             if todo[0] == "two_level" else ""))
    for r in todo[1:]:
        t2 = time.time()
        extra = rd.round_voltages(r, inst, res.voltages, device=args.device)
        dt = time.time() - t2
        results[f"cut_{r}"] = extra.cut_value
        results[f"t_{r}"] = dt
        print(f"{r}: cut={extra.cut_value:.4f} ({dt:.1f}s)")

    if not args.no_exact:
        t3 = time.time()
        exact = max_flow(inst)
        t_exact = time.time() - t3
        results["cut_exact"] = exact.value
        results["t_exact"] = t_exact
        for r in todo:
            delta = (results[f"cut_{r}"] - exact.value) / exact.value
            results[f"delta_{r}"] = delta
            print(f"delta_{r} = {delta:.2e}")
        t_total = t_irls + results.get("t_two_level", 0)
        print(f"exact (serial Dinic): {exact.value:.4f} ({t_exact:.1f}s) "
              f"speedup_vs_serial={t_exact/max(t_total, 1e-9):.1f}x")

    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
