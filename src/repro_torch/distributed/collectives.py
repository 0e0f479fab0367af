"""Process groups and collectives for the sharded solver (torch.distributed).

The IRLS solver is 1-D domain-decomposed exactly like the paper's MPI layout
(§3.3: one block row per process).  The JAX package runs it as one SPMD
program under ``shard_map`` over a flattened device mesh; the port runs one
process per rank over ``torch.distributed``, each rank the same program on
its own shard (as under ``torchrun``): NCCL across cards, gloo across CPU
processes.

``Collectives`` wraps a process group with the two collectives the solver
needs (``all_reduce``, ``all_gather``) and counts their calls and bytes per
op under a scope the solver sets: ``setup`` (before the IRLS loop),
``irls`` (per IRLS iteration, outside the CG steps, and the final gather of
the voltages) and ``pcg_step`` (inside a CG step).  That census is the
port's counterpart of the JAX package's walk over the compiled HLO.

``psum_dots`` builds the cross-shard inner products that turn the core PCG
variants (core/pcg.py ``pcg_masked`` / ``pcg_fixed_iters``) into the
distributed solver.  ``world(device)`` is the counterpart of
``flat_mesh()``: the default group when one is initialized, else a world of
one that it initializes itself and ``release_world()`` takes down.

The JAX package's mesh shims ``shard_map``, ``flatten_mesh``,
``shard_leading`` and ``replicated`` have no counterpart here: a rank holds
its shard as ordinary tensors on its own device, so there is no mesh to
flatten and no sharding to name.
"""
from __future__ import annotations

import contextlib
import datetime
import os
from typing import Dict

import torch
import torch.distributed as dist

# a dead rank fails the next collective of the others after this long
DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


class Collectives:
    """``all_reduce`` / ``all_gather`` over ``group`` (None = the default
    group), with a census of calls and bytes per scope and op.

    Bytes are those of each op's result buffer: the reduced tensor for
    ``all_reduce``, the [p, ...] stack for ``all_gather``."""

    def __init__(self, group=None):
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.scope = "setup"
        self.reset()

    def reset(self) -> None:
        self._stats: Dict[str, Dict[str, Dict[str, int]]] = {}
        self.pcg_steps = 0

    @contextlib.contextmanager
    def scoped(self, name: str):
        prev, self.scope = self.scope, name
        try:
            yield
        finally:
            self.scope = prev

    def pcg_step(self):
        """Context of one CG step (``step_scope`` of the PCG loops)."""
        self.pcg_steps += 1
        return self.scoped("pcg_step")

    def _count(self, op: str, nbytes: int) -> None:
        s = self._stats.setdefault(self.scope, {}).setdefault(
            op, {"calls": 0, "bytes": 0})
        s["calls"] += 1
        s["bytes"] += int(nbytes)

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Reduce ``t`` across the ranks IN PLACE and return it; every rank
        receives the same values."""
        dist.all_reduce(t, op=_OPS[op], group=self.group)
        self._count("all_reduce", t.numel() * t.element_size())
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` stacked in rank order: [p, *t.shape]."""
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        self._count("all_gather", self.size * t.numel() * t.element_size())
        return torch.stack(parts)

    def stats(self) -> dict:
        """``{"pcg_steps": n, "scopes": {scope: {op: {"calls", "bytes"}}},
        "per_pcg_step": {"calls", "bytes", op: calls}}`` since the last
        ``reset``; ``per_pcg_step`` divides the ``pcg_step`` scope by the
        steps taken (empty when none was)."""
        scopes = {sc: {op: dict(v) for op, v in ops.items()}
                  for sc, ops in self._stats.items()}
        per, steps = {}, self.pcg_steps
        if steps:
            ops = scopes.get("pcg_step", {})
            per = {op: v["calls"] / steps for op, v in ops.items()}
            per["calls"] = sum(v["calls"] for v in ops.values()) / steps
            per["bytes"] = sum(v["bytes"] for v in ops.values()) / steps
        return {"pcg_steps": self.pcg_steps, "scopes": scopes,
                "per_pcg_step": per}


def psum_dots(coll: Collectives, local_dot=None):
    """``(dot, dot2)`` inner-product closures reduced across the ranks.

    ``dot(a, b)`` is one scalar all-reduce.  ``dot2(r, z) → (r·z, r·r)``
    fuses the CG recurrence scalar AND the squared-norm convergence test
    into ONE all-reduce of a stacked pair — that fusion is why the masked
    (early-exit) PCG costs zero collectives per step over the fixed
    schedule (which reduces ``r·z`` anyway).  Because every rank receives
    the identical reduced values, any stopping decision computed from them
    (the masked loop's test) is taken by all ranks in the same step — the
    distributed early exit needs no extra agreement round.

    ``local_dot`` masks shard-local padding (the halo plan passes
    ``dot(a·valid, b·valid)``); plain ``torch.dot`` when None.
    """
    if local_dot is None:
        local_dot = torch.dot

    def dot(a, b):
        return coll.all_reduce(local_dot(a, b))

    def dot2(r, z):
        rz_rr = coll.all_reduce(torch.stack([local_dot(r, z),
                                             local_dot(r, r)]))
        return rz_rr[0], rz_rr[1]

    return dot, dot2


# the world of one that ``world`` initialized, with the device type it was
# made for, while it is the default group
_own_world = None


def world(device="cuda", timeout: datetime.timedelta = DEFAULT_TIMEOUT):
    """Make sure the default group exists: the caller's ranks when
    ``torch.distributed`` is initialized, else a world of one initialized
    here over a ``HashStore`` — NCCL for CUDA tensors (gloo beside it for
    CPU ones) on ``cuda``, gloo on ``cpu``.  A real group either way, so a
    world of one runs every collective through its backend.

    The world of one stays the default group until ``release_world``.  A
    world of one made for ``cpu`` has no NCCL, so a later call for
    ``cuda`` raises instead of staging the card's tensors through the host;
    a group the caller initialized is taken as it is."""
    global _own_world
    device = torch.device(device)
    if dist.is_initialized():
        own = _own_world is not None and _own_world[0] is dist.group.WORLD
        if own and device.type == "cuda" and _own_world[1] != "cuda":
            raise RuntimeError(
                f"the default group is a world of one made for "
                f"{_own_world[1]} (gloo only); call release_world() before "
                f"a sharded solve on cuda")
        return
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a sharded solve on cuda needs a CUDA card; "
                               "pass device='cpu' for the gloo backend")
        backend = "cpu:gloo,cuda:nccl"
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for device {device}")
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1, timeout=timeout)
    _own_world = (dist.group.WORLD, device.type)


def release_world() -> None:
    """Destroy the world of one that ``world`` initialized, if it is still
    the default group, so that the process can make or join another; a
    group the caller initialized is left alone."""
    global _own_world
    if (_own_world is not None and dist.is_initialized()
            and _own_world[0] is dist.group.WORLD):
        dist.destroy_process_group()
    _own_world = None


def init_from_env(device="cuda",
                  timeout: datetime.timedelta = DEFAULT_TIMEOUT
                  ) -> torch.device:
    """Join the group that ``torchrun`` describes in the environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``,
    ``LOCAL_RANK``): NCCL on ``cuda``, gloo on ``cpu``.  Returns this
    rank's device (``cuda:LOCAL_RANK`` on cuda)."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a sharded solve on cuda needs a CUDA card")
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method="env://", timeout=timeout)
    return device

