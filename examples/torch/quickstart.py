"""Quickstart: solve an s-t min-cut with PIRMCut on PyTorch in ~20 lines.

  PYTHONPATH=src python examples/torch/quickstart.py               # the card
  PYTHONPATH=src python examples/torch/quickstart.py --device cpu  # the CPU

The twin of ``examples/quickstart.py`` on the port: the same instance,
config and printout.  On ``cuda`` (the default) it needs a card and exits
non-zero without one.
"""
import argparse

import torch

from repro_torch.core import IRLSConfig, MinCutSession, Problem, max_flow, pirmcut
from repro_torch.graphs import generators as gen


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    device = torch.device(ap.parse_args(argv).device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card (torch.cuda.is_available() is False); "
                         "pass --device cpu to run on the CPU")

    # 1. build an instance: a 2-D segmentation graph (float-valued weights)
    g = gen.grid_2d(32, 32, seed=0)
    inst = gen.segmentation_instance(g, (32, 32), seed=1)
    print(f"instance: {inst.n} nodes, {inst.graph.m} edges")

    # 2. run PIRMCut (Algorithm 1) through the session API: the Problem holds
    #    the one-time partition + plans; the session holds the solver state
    cfg = IRLSConfig(eps=1e-6, n_irls=30, pcg_max_iters=100, n_blocks=8)
    problem = Problem.build(inst, n_blocks=cfg.n_blocks)
    session = MinCutSession(problem, cfg, device=device)
    result = session.solve(rounding="two_level")
    print(f"PIRMCut cut value : {result.cut_value:.4f}")
    print(f"coarse graph size : {result.cut.meta['coarse_n']} "
          f"(reduction {result.cut.meta['reduction']:.1f}x)")
    print(f"PCG iterations/IRLS step: {result.diagnostics.pcg_iters[:10]} ...")

    # 3. a second solve on the same session reuses the partition + plans
    again = session.solve(rounding="two_level")
    print(f"amortized re-solve: {again.timings['total']:.3f}s "
          f"(first: {result.timings['total']:.3f}s)")

    # 4. compare with the exact serial solver (the paper's B-K role)
    exact = max_flow(inst)
    delta = (result.cut_value - exact.value) / exact.value
    print(f"exact min-cut     : {exact.value:.4f}")
    print(f"relative gap δ    : {delta:.2e}")

    # 5. the source side of the cut
    side = result.cut.in_source
    print(f"source side holds {int(side.sum())}/{inst.n} nodes")
    assert delta < 1e-3

    # one-shot convenience wrapper (identical result, no session to keep):
    res, voltages, diag = pirmcut(inst, cfg, rounding="two_level",
                                  device=device)
    assert res.cut_value == result.cut_value


if __name__ == "__main__":
    main()
