"""Architecture registry of the port: the LM family (dense and MoE), the
four GNNs, DIN and the paper's own solver workload (``pirmcut``).

``ARCHS[arch_id]`` → ArchEntry(family, make_config, make_reduced, cells,
shapes), as in the JAX package's ``repro/configs/registry.py``; ``--arch
<id>`` in the port's launchers (``launch.lm_serve``, ``launch.train``)
resolves through this table, and the ten thin modules
(``configs/qwen2_1_5b.py``, ``configs/gcn_cora.py``, ``configs/din.py`` …)
re-export its entries.  The ``solver`` family (``pirmcut``) trains
nothing: ``launch.train`` refuses it and points to ``launch.solve``;
``launch.dryrun`` plans its cells with ``--include-solver``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

from . import din_cfg, gnn, lm, pirmcut


@dataclasses.dataclass(frozen=True)
class ArchEntry:
    arch_id: str
    family: str                      # lm | gnn | recsys | solver
    make_config: Callable
    make_reduced: Callable
    cells: Tuple[str, ...]
    shapes: Dict[str, dict]


ARCHS: Dict[str, ArchEntry] = {}

for _id, _fn in lm.LM_ARCHS.items():
    ARCHS[_id] = ArchEntry(
        arch_id=_id, family="lm", make_config=_fn,
        make_reduced=lambda _id=_id: lm.reduced_lm(_id),
        cells=lm.LM_CELLS, shapes=lm.LM_SHAPES)

for _id, _fn in gnn.GNN_ARCHS.items():
    ARCHS[_id] = ArchEntry(
        arch_id=_id, family="gnn", make_config=_fn,
        make_reduced=lambda _id=_id: gnn.reduced_gnn(_id),
        cells=gnn.GNN_CELLS, shapes=gnn.GNN_SHAPES)

ARCHS["din"] = ArchEntry(
    arch_id="din", family="recsys", make_config=din_cfg.din,
    make_reduced=din_cfg.reduced_din,
    cells=din_cfg.DIN_CELLS, shapes=din_cfg.DIN_SHAPES)

ARCHS["pirmcut"] = ArchEntry(
    arch_id="pirmcut", family="solver",
    make_config=pirmcut.pirmcut_config, make_reduced=pirmcut.reduced_pirmcut,
    cells=pirmcut.PIRMCUT_CELLS, shapes=pirmcut.PIRMCUT_SHAPES)

ASSIGNED = [a for a in ARCHS if a != "pirmcut"]     # the 10 graded archs


def get(arch_id: str) -> ArchEntry:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]


def all_cells(include_solver: bool = False):
    """Every (arch, cell) pair — 40 assigned (+3 solver when included)."""
    out = []
    for aid, e in ARCHS.items():
        if e.family == "solver" and not include_solver:
            continue
        for c in e.cells:
            out.append((aid, c))
    return out
