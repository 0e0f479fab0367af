"""Sequences of related min-cut problems — the FlowImprove workload (§1, §6).

The paper's motivating applications solve a SEQUENCE of s-t min-cut
instances whose weights change slowly (FlowImprove partition refinement).
This is exactly what the session API makes first-class:

  * ``Problem.build`` runs the graph partition / plan construction ONCE,
  * each iteration re-solves with ``session.solve(weights=..., warm_from=
    previous)`` — the same session, new terminal weights, voltages
    warm-started from the previous instance's solution.

  PYTHONPATH=src python examples/torch/flow_improve_sequence.py               # the card
  PYTHONPATH=src python examples/torch/flow_improve_sequence.py --device cpu  # the CPU

The twin of ``examples/flow_improve_sequence.py`` on the port: the same
road network, seeds, config and printout.  On ``cuda`` (the default) it
needs a card and exits non-zero without one.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import IRLSConfig, MinCutSession, Problem, max_flow
from repro_torch.graphs import generators as gen


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    device = torch.device(ap.parse_args(argv).device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card (torch.cuda.is_available() is False); "
                         "pass --device cpu to run on the CPU")

    g = gen.road_like(60, seed=4)
    print(f"road network: {g.n} nodes, {g.m} edges")

    # FlowImprove iterates: seed set → s-t instance → cut → new seed set → ...
    rng = np.random.default_rng(0)
    seed_set = np.nonzero(rng.random(g.n) < 0.5)[0]   # start from a RANDOM set
    cfg = IRLSConfig(eps=1e-6, n_irls=25, pcg_max_iters=100, n_blocks=8)

    inst0 = gen.flow_improve_instance(g, seed_set=seed_set, seed=10)
    problem = Problem.build(inst0, n_blocks=cfg.n_blocks)  # partition built once
    session = MinCutSession(problem, cfg, device=device)

    cut_values = []
    prev = None
    for it in range(4):
        inst = gen.flow_improve_instance(g, seed_set=seed_set, seed=10 + it)
        t0 = time.time()
        res = session.solve(weights=inst, warm_from=prev, rounding="two_level")
        dt = time.time() - t0
        exact = max_flow(inst).value
        delta = (res.cut_value - exact) / exact
        cut_values.append(res.cut_value)
        # the improved partition becomes the next seed set (FlowImprove loop)
        seed_set = np.nonzero(res.cut.in_source)[0]
        prev = res
        print(f"iter {it}: cut={res.cut_value:10.4f} δ={delta:8.1e} "
              f"({dt:.1f}s, {sum(res.diagnostics.pcg_iters)} PCG iters, "
              f"setup {res.timings['setup']:.2f}s)")

    print("\ncut value sequence:", [f"{c:.2f}" for c in cut_values])
    print("(non-increasing sequence = the partition keeps improving)")


if __name__ == "__main__":
    main()
