"""Mesh construction over ``torch.distributed`` ranks.

The port of ``repro/launch/mesh.py``.  Single pod: (16, 16) → ("data",
"model") = 256 ranks, on H100s 32 nodes of 8 cards; multi-pod: (2, 16, 16)
→ ("pod", "data", "model") = 512 ranks.  A mesh is a ``DeviceMesh`` over
the initialized default group, one rank a device.

A planning run (``launch.dryrun``) needs the production mesh's sizes and
groups but not its ranks: ``make_production_mesh(plan=True)`` and
``make_plan_mesh`` initialize, in this one process, a world of that many
ranks over torch's fake process group (backend ``"fake"``,
``torch.testing._internal.distributed.fake_pg.FakeStore``: every
collective completes at once and moves nothing), whose rank 0 runs its
program on fake tensors.  That module sits under ``torch.testing``: the
card machine's torch has it too (``chip_smoke.py`` phase 19 plans on it).
Functions, not module-level constants: importing this module touches no
process group.
"""
from __future__ import annotations

import math

import torch


def plan_device() -> torch.device:
    """The device of a planning run's fake tensors: ``cuda`` where a card
    is present, else ``cpu`` (autograd of a CPU build of torch cannot take
    fake CUDA tensors).  Nothing is allocated on either; the kernel wrappers
    plan their launches the same way on both."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def _fake_world(n: int) -> bool:
    """True when the default group is a fake world of ``n`` ranks (and
    initialize one when there is no group)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        from torch.testing._internal.distributed.fake_pg import FakeStore

        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
        return True
    return (dist.get_backend() == "fake" and dist.get_world_size() == n)


def make_plan_mesh(shape, axes, device=None):
    """A ``DeviceMesh`` of ``shape`` over a fake world of its size, for a
    planning run on rank 0 (the world is initialized here when there is
    none; an initialized world must be a fake one of that size)."""
    from torch.distributed.device_mesh import init_device_mesh

    n = math.prod(shape)
    if not _fake_world(n):
        raise RuntimeError(f"a plan mesh {tuple(shape)} needs a fake world "
                           f"of {n} ranks; another group is initialized")
    device = torch.device(device) if device is not None else plan_device()
    return init_device_mesh(device.type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def release_plan_world() -> None:
    """Destroy the fake world, if it is the default group."""
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_backend() == "fake":
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False, device=None,
                         plan: bool = False):
    """The production mesh.  With real ranks it needs a world of 256 (512
    multi-pod) ranks (``device`` by default ``cuda``); ``plan=True`` with no
    group initialized makes it over a fake world of that size in this
    process (``make_plan_mesh``; ``device`` by default ``plan_device()``)
    for a planning run."""
    import torch.distributed as dist

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    if plan and (not dist.is_initialized() or dist.get_backend() == "fake"):
        return make_plan_mesh(shape, axes, device)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != need:
        raise RuntimeError(
            f"the production mesh {shape} needs {need} ranks, the world has "
            f"{have}; plan=True plans on it without them")
    return make_host_mesh(shape, axes, device or "cuda")


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
