"""Image-segmentation example (the paper's N-D grid / GraphCut workload).

Builds a 3-D 26-connected voxel grid with unary potentials from a smooth
random field (an MRI-scan proxy, §5.1), solves it through a MinCutSession
and renders an ASCII slice of the segmentation.  Both rounding procedures
run on the SAME session solve — the voltages are computed once.

  PYTHONPATH=src python examples/torch/segmentation.py               # the card
  PYTHONPATH=src python examples/torch/segmentation.py --device cpu  # the CPU

The twin of ``examples/segmentation.py`` on the port: the same grid,
config and printout.  On ``cuda`` (the default) it needs a card and exits
non-zero without one.
"""
import argparse

import torch

from repro_torch.core import IRLSConfig, MinCutSession, max_flow
from repro_torch.core import rounding as rd
from repro_torch.graphs import generators as gen

D = H = W = 10


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    device = torch.device(ap.parse_args(argv).device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card (torch.cuda.is_available() is False); "
                         "pass --device cpu to run on the CPU")

    g = gen.grid_3d(D, H, W, conn=26, seed=2)
    inst = gen.segmentation_instance(g, (D, H, W), seed=3)
    print(f"voxel grid {D}x{H}x{W} (26-connected): "
          f"{inst.n} voxels, {inst.graph.m} edges")

    cfg = IRLSConfig(eps=1e-6, n_irls=40, pcg_max_iters=50, n_blocks=8)
    session = MinCutSession(inst, cfg, device=device)  # builds the Problem
    result = session.solve(rounding="two_level")
    r_sweep = rd.round_voltages("sweep", inst, result.voltages, device=device)
    exact = max_flow(inst)

    print(f"two-level cut: {result.cut_value:.4f} "
          f"(δ={(result.cut_value-exact.value)/exact.value:.1e})")
    print(f"sweep cut    : {r_sweep.cut_value:.4f} "
          f"(δ={(r_sweep.cut_value-exact.value)/exact.value:.1e})")
    print(f"size reduction in two-level: {result.cut.meta['reduction']:.1f}x")

    seg = result.cut.in_source.reshape(D, H, W)
    print(f"\nmiddle slice (z={D//2}); #=object .=background")
    for row in seg[D // 2]:
        print("".join("#" if x else "." for x in row))


if __name__ == "__main__":
    main()
