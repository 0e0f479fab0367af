"""The paper's own workload: s-t min-cut instance families (Table 1 scale).

A copy of the JAX package's ``repro/configs/pirmcut.py`` on the port's
``IRLSConfig``.  Cells mirror the paper's two data families at their
production sizes; the dry run plans the sharded IRLS program against
analytically derived plan SHAPES (``distributed.solver.abstract_halo_plans``:
building a 50M-node instance on the host is pointless, the shapes are what
the planner needs).  Small REAL instances of the same families drive the
tests, examples and CPU benchmarks."""
from __future__ import annotations

import dataclasses
from typing import Dict

from ..core.irls import IRLSConfig

PIRMCUT_CELLS = ("road_asia", "road_euro", "grid_mri")

# (n_nodes, n_edges, boundary_frac): boundary_frac calibrated from the real
# partitioner's measured cut fraction on the small instances of each family
# (road ≈ planar, sqrt-ish cuts; 26-conn grids cut ≈ surface/volume).
PIRMCUT_SHAPES: Dict[str, dict] = {
    "road_asia": dict(kind="solve", n_nodes=11_950_757, n_edges=12_711_603,
                      boundary_frac=0.002),
    "road_euro": dict(kind="solve", n_nodes=50_912_018, n_edges=54_054_660,
                      boundary_frac=0.001),
    "grid_mri": dict(kind="solve", n_nodes=12_582_912, n_edges=163_577_856,
                     boundary_frac=0.02),
}


@dataclasses.dataclass(frozen=True)
class SolveCell:
    n_nodes: int
    n_edges: int
    boundary_frac: float
    pcg_iters: int = 50
    n_irls: int = 50


def pirmcut_config() -> IRLSConfig:
    """Production solver config (paper §5.4 defaults at Table-1 scale):
    T = K = 50 with the partition-local block-Jacobi preconditioner."""
    return IRLSConfig(eps=1e-6, n_irls=50, pcg_max_iters=50,
                      precond="block_jacobi", n_blocks=128, warm_start=True)


def reduced_pirmcut() -> IRLSConfig:
    """Down-scaled config for smoke tests / CI: same structure, tiny
    schedule (5 IRLS × 10 PCG, 4 blocks)."""
    return IRLSConfig(eps=1e-4, n_irls=5, pcg_max_iters=10,
                      precond="block_jacobi", n_blocks=4, warm_start=True)
