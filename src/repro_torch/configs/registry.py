"""Architecture registry of the port: the LM family, dense and MoE.

``ARCHS[arch_id]`` → ArchEntry(family, make_config, make_reduced, cells,
shapes), as in the JAX package's ``repro/configs/registry.py``; ``--arch
<id>`` in the port's launchers resolves through this table.  The GNN, recsys
and solver entries of the JAX registry are not ported yet: ``get`` names
them and the ROADMAP item by its title.
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


def get(arch_id: str) -> ArchEntry:
    if arch_id in NOT_PORTED:
        raise KeyError(f"arch {arch_id!r} ({NOT_PORTED[arch_id]} family) is "
                       f"not ported yet: ROADMAP.md queue 1, \"The rest of "
                       f"the model stack\"")
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]
