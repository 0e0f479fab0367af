"""Architecture registry of the port: the LM family, dense and MoE.

``ARCHS[arch_id]`` → ArchEntry(family, make_config, make_reduced, cells,
shapes), as in the JAX package's ``repro/configs/registry.py``; ``--arch
<id>`` in the port's launchers (``launch.lm_serve``, ``launch.train``)
resolves through this table, and the five thin modules
(``configs/qwen2_1_5b.py`` …) re-export its LM entries.  Not ported yet:
the GNN and recsys entries (ROADMAP queue 1, item 7, "GNN and recsys") and
the solver's ``pirmcut`` entry (item 7, "Dry runs"); ``get`` names the
bullet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

from . import lm


@dataclasses.dataclass(frozen=True)
class ArchEntry:
    arch_id: str
    family: str                      # lm
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

# the JAX registry's other families, still to port
NOT_PORTED = {"gcn-cora": "gnn", "schnet": "gnn", "dimenet": "gnn",
              "meshgraphnet": "gnn", "din": "recsys", "pirmcut": "solver"}
# the bullet of ROADMAP.md queue 1, item 7 that ports each family
PORTED_BY = {"gnn": "GNN and recsys", "recsys": "GNN and recsys",
             "solver": "Dry runs"}


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
