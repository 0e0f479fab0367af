"""Mesh construction over ``torch.distributed`` ranks.

The port of ``repro/launch/mesh.py``.  Single pod: (16, 16) → ("data",
"model") = 256 ranks; multi-pod: (2, 16, 16) → ("pod", "data", "model") =
512 ranks.  A mesh is a ``DeviceMesh`` over the initialized default group,
one rank a device.  Functions, not module-level constants: importing this
module touches no process group.
"""
from __future__ import annotations

import math

import torch


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The production mesh; it needs a world of 256 (512 multi-pod) ranks.
    Planning at that size without the ranks goes with the dry runs
    (ROADMAP.md queue 1, item 7, "Dry runs"): ``models.sharding.AbstractMesh``
    gives the sizes and names to ``lm_rules`` meanwhile."""
    import torch.distributed as dist

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != need:
        raise RuntimeError(
            f"the production mesh {shape} needs {need} ranks, the world has "
            f"{have}; planning without them goes with the dry runs "
            f"(ROADMAP.md queue 1, item 7, \"Dry runs\")")
    return make_host_mesh(shape, axes, device)


def make_host_mesh(shape=None, axes=("data", "model"), device="cuda"):
    """A mesh over the ranks of the default group (a world of one that
    ``distributed.collectives.world`` initializes when there is none):
    ``shape`` its sizes, by default the squarest 2-D factorization of the
    world size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from ..distributed.collectives import world

    device = torch.device(device)
    world(device)
    n = dist.get_world_size()
    if shape is None:
        a = int(math.isqrt(n))
        while n % a:
            a -= 1
        shape = (a, n // a)
    if device.type == "cuda" and torch.cuda.device_count() == 1:
        # ranks that share one card (gloo) each take device 0
        torch.cuda.set_device(0)
    return init_device_mesh(device.type, tuple(shape),
                            mesh_dim_names=tuple(axes))
