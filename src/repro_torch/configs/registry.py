"""Architecture registry of the port: the LM family (dense and MoE), the
four GNNs and DIN.

``ARCHS[arch_id]`` → ArchEntry(family, make_config, make_reduced, cells,
shapes), as in the JAX package's ``repro/configs/registry.py``; ``--arch
<id>`` in the port's launchers (``launch.lm_serve``, ``launch.train``)
resolves through this table, and the ten thin modules
(``configs/qwen2_1_5b.py``, ``configs/gcn_cora.py``, ``configs/din.py`` …)
re-export its entries.  Not ported yet: the solver's ``pirmcut`` entry
(ROADMAP queue 1, item 7, "Dry runs"); ``get`` names the bullet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

from . import din_cfg, gnn, lm


@dataclasses.dataclass(frozen=True)
class ArchEntry:
    arch_id: str
    family: str                      # lm | gnn | recsys
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

# the JAX registry's other family, still to port
NOT_PORTED = {"pirmcut": "solver"}
# the bullet of ROADMAP.md queue 1, item 7 that ports it
PORTED_BY = {"solver": "Dry runs"}


def not_ported_message(arch_id: str) -> str:
    family = NOT_PORTED[arch_id]
    return (f"arch {arch_id!r} ({family} family) is not ported yet: "
            f"ROADMAP.md queue 1, item 7, \"{PORTED_BY[family]}\"")


def get(arch_id: str) -> ArchEntry:
    if arch_id in NOT_PORTED:
        raise KeyError(not_ported_message(arch_id))
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]
