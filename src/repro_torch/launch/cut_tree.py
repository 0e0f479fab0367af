"""Cut-tree CLI — build a Gusfield tree for one topology and query it.

  PYTHONPATH=src python -m repro_torch.launch.cut_tree
  PYTHONPATH=src python -m repro_torch.launch.cut_tree \\
      --family grid --side 14 --solver irls --refine --verify-pairs 25
  PYTHONPATH=src python -m repro_torch.launch.cut_tree --device cpu --side 6

Builds a synthetic instance (``--family grid|road|regular``), constructs
its cut tree through ``repro_torch.cuttree.build_cut_tree`` (batched IRLS pair
solves by default; ``--solver exact`` for the Dinic oracle,
``--sequential`` for the unbatched baseline), prints build stats, the
global min cut and a handful of pair queries, and optionally verifies
``--verify-pairs`` random pairs against the exact max-flow oracle.  Exits
nonzero when the build produced no solves or verification exceeds
``--verify-rtol`` (the CI smoke gate contract, like mincut_serve).

The port of ``repro/launch/cut_tree.py``: the same flags, printout,
``--json-out`` fields and exit code, plus ``--device`` (where the IRLS
pair solves run, as in ``launch/solve.py``).
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def build_instance(family: str, side: int, seed: int):
    from ..graphs import generators as gen

    if family == "grid":
        g = gen.grid_2d(side, side, seed=seed)
        return gen.segmentation_instance(g, (side, side), seed=seed + 1)
    if family == "road":
        g = gen.road_like(side, seed=seed)
        return gen.flow_improve_instance(g, seed=seed + 1)
    if family == "regular":
        g = gen.random_regular(side * side, 4, seed=seed)
        return gen.flow_improve_instance(g, seed=seed + 1)
    raise ValueError(f"unknown family {family!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--family", choices=("grid", "road", "regular"),
                    default="grid")
    ap.add_argument("--side", type=int, default=12,
                    help="grid/road side (regular: n = side²)")
    ap.add_argument("--solver", choices=("irls", "exact"), default="irls")
    ap.add_argument("--refine", action="store_true",
                    help="exact certify/refine pass after an IRLS build")
    ap.add_argument("--sequential", action="store_true",
                    help="disable wave batching (the sequential baseline)")
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--rounding", default="sweep")
    ap.add_argument("--irls", type=int, default=16)
    ap.add_argument("--pcg-iters", type=int, default=40)
    ap.add_argument("--verify-pairs", type=int, default=0,
                    help="check this many random pairs against the exact "
                         "max-flow oracle")
    ap.add_argument("--verify-rtol", type=float, default=1e-3)
    ap.add_argument("--queries", type=int, default=2000,
                    help="random pair queries to time on the finished tree")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save", default=None, help="write the tree as JSON")
    ap.add_argument("--json-out", default=None, help="write stats as JSON")
    ap.add_argument("--device", default="cuda",
                    help="where the IRLS pair solves run: cuda (the "
                         "kernels' card) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    import numpy as np

    from ..core import IRLSConfig
    from ..core.maxflow import max_flow
    from ..core.session import rebind_terminals
    from ..cuttree import build_cut_tree
    from ..graphs.structures import STInstance

    inst = build_instance(args.family, args.side, args.seed)
    print(f"{args.family}: n={inst.n:,} m={inst.graph.m:,}")
    cfg = IRLSConfig(n_irls=args.irls, pcg_max_iters=args.pcg_iters,
                     precond="jacobi", n_blocks=1, irls_tol=1e-3,
                     adaptive_tol=True)
    tree = build_cut_tree(inst, solver=args.solver, cfg=cfg,
                          rounding=args.rounding,
                          batch=not args.sequential,
                          max_batch=args.max_batch, refine=args.refine,
                          device=args.device)
    m = tree.meta
    print(f"built: {m['n_pairs']} tree edges from {m['n_solves']} pair "
          f"solves in {m['n_waves']} waves "
          f"({m['pairs_per_sec']:.1f} solves/sec, "
          f"build {m['t_build_s']:.2f}s"
          + (f", refine {m['t_refine_s']:.2f}s "
             f"[{m['refine_changed_edges']} edges corrected]"
             if m["refined"] else "") + ")")

    gval, gside = tree.global_min_cut()
    print(f"global min cut: {gval:.6g} "
          f"(|S|={int(gside.sum())}/{tree.n})")

    rng = np.random.default_rng(args.seed + 1)
    pairs = [tuple(rng.choice(tree.n, 2, replace=False))
             for _ in range(max(args.queries, 1))]
    t0 = time.perf_counter()
    vals = tree.min_cut_batch(pairs)
    us = (time.perf_counter() - t0) / len(pairs) * 1e6
    print(f"queries: {len(pairs)} pair min-cuts in "
          f"{us:.1f}us each (median value {np.median(vals):.4g})")

    max_rel = 0.0
    if args.verify_pairs > 0:
        for u, v in pairs[: args.verify_pairs]:
            w = rebind_terminals(inst, int(u), int(v))
            exact = max_flow(STInstance(graph=inst.graph, s_weight=w.c_s,
                                        t_weight=w.c_t)).value
            rel = abs(tree.min_cut(u, v) - exact) / max(abs(exact), 1e-30)
            max_rel = max(max_rel, rel)
        ok = max_rel <= args.verify_rtol
        print(f"verify: {args.verify_pairs} pairs vs exact oracle, "
              f"max rel err {max_rel:.2e} "
              f"({'OK' if ok else 'FAIL'} @ rtol={args.verify_rtol:g})")
    else:
        ok = True

    if args.save:
        tree.save(args.save)
        print(f"tree written to {args.save}")
    if args.json_out:
        payload = {"family": args.family, "n": inst.n, "m": inst.graph.m,
                   "meta": m, "global_min_cut": gval,
                   "query_us": us, "verify_max_rel": max_rel}
        with open(args.json_out, "w") as fh:
            json.dump(payload, fh, indent=1)
    return 0 if (m["n_solves"] > 0 and ok) else 1


if __name__ == "__main__":
    sys.exit(main())
