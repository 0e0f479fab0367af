"""Process groups and collectives: the sharded solver's, and the LM's over
the named dims of a ``DeviceMesh``.

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

The sharded LM (``models/transformer`` with ``rules``) moves data between
the ranks of a mesh by the differentiable functions at the end of this
module (``gather``, ``copy``, ``reduce``, ``reduce_scatter``, ``split``,
``all_to_all``, ``ppermute``), each counted in ``census`` by op and mesh
dim: the counterpart of the collectives GSPMD inserts for the reference's
sharding constraints.
"""
from __future__ import annotations

import contextlib
import datetime
import math
import os
from typing import Dict, Tuple

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



# ---------------------------------------------------------------------------
# Differentiable collectives over the named dims of a DeviceMesh (the LM's
# tensor, sequence, data, expert and pipeline parallelism)
# ---------------------------------------------------------------------------
#
# The sharded LM runs each rank's own shard of the work on local tensors and
# moves data between ranks by these functions, whose backward is written to
# match (Megatron's rules): a rank's local gradient is always the exact
# gradient of its local value, so a tensor replicated over a mesh dim holds
# the same full gradient on every rank of it.  ``copy`` (identity forward,
# all-reduce backward) marks where a replicated tensor enters work split
# over a mesh dim; ``gather`` all-gathers and, when ``reduce_grad``, its
# backward reduce-scatters (the work after it is split), else it slices.
# ``reduce`` all-reduces partial sums (backward: identity), ``reduce_scatter``
# (backward: all-gather), ``split`` takes this rank's slice (backward:
# all-gather), ``all_to_all`` (backward: the reverse exchange) and
# ``ppermute`` (send to the next rank of a mesh dim, receive from the
# previous; backward the other way).  Over several mesh dims (("pod",
# "data")) a shard index is pod-major.  Every function is the identity when
# the mesh dims have one rank: a mesh of ones runs the one-device program.
#
# gloo takes CUDA tensors for ``all_reduce``, ``all_gather``,
# ``reduce_scatter`` and ``all_to_all`` (staging them through the host
# itself); its P2P send/recv aborts the process on them (``writev: Bad
# address``: the TCP transport is handed the device pointer; chip_smoke's
# ``gloo_native_probe`` on an H100).  The ops in ``GLOO_CUDA_STAGED`` are
# run on host copies of the CUDA tensors and counted as ``staged``.

GLOO_CUDA_STAGED = {"send_recv"}


class LMCensus:
    """Calls and bytes of the LM's collectives by op and mesh dims since
    the last ``reset`` (bytes of each op's result buffer a rank, forward
    and backward alike); ``staged`` counts the bytes that went through host
    copies."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.ops: Dict[str, Dict[str, int]] = {}

    def count(self, op: str, axes, nbytes: int, staged: bool) -> None:
        key = f"{op}[{','.join(axes)}]"
        s = self.ops.setdefault(key, {"calls": 0, "bytes": 0, "staged": 0})
        s["calls"] += 1
        s["bytes"] += int(nbytes)
        if staged:
            s["staged"] += int(nbytes)

    def snapshot(self) -> dict:
        return {k: dict(v) for k, v in self.ops.items()}


census = LMCensus()


def mesh_size(mesh, axes) -> int:
    n = 1
    for a in axes:
        n *= mesh.size(mesh.mesh_dim_names.index(a))
    return n


def mesh_coord(mesh, axes) -> int:
    """This rank's pod-major index over ``axes`` of ``mesh``."""
    idx = 0
    for a in axes:
        idx = idx * mesh.size(mesh.mesh_dim_names.index(a)) + \
            mesh.get_local_rank(a)
    return idx


def _staged(op: str, group, t: torch.Tensor) -> bool:
    return (t.is_cuda and op in GLOO_CUDA_STAGED
            and dist.get_backend(group) == "gloo")


def _ag_one(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _all_gather(x, mesh, axes, dim):
    for a in reversed(axes):                 # inner dim first: pod-major
        n = mesh_size(mesh, (a,))
        x = _ag_one(x, mesh.get_group(a), n, dim)
        census.count("all_gather", (a,), x.numel() * x.element_size(), False)
    return x


def _all_reduce(x, mesh, axes, op=dist.ReduceOp.SUM):
    x = x.clone()
    for a in axes:
        dist.all_reduce(x, op=op, group=mesh.get_group(a))
        census.count("all_reduce", (a,), x.numel() * x.element_size(), False)
    return x


def _rs_one(x, group, n, dim):
    staged = _staged("reduce_scatter", group, x)
    src = x.movedim(dim, 0).contiguous()
    dev = src.device
    if staged:
        src = src.cpu()
    out = src.new_empty((src.shape[0] // n,) + src.shape[1:])
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.to(dev).movedim(0, dim), staged


def _reduce_scatter(x, mesh, axes, dim):
    for a in axes:                           # outer dim first: pod-major
        x, staged = _rs_one(x, mesh.get_group(a), mesh_size(mesh, (a,)), dim)
        census.count("reduce_scatter", (a,), x.numel() * x.element_size(),
                     staged)
    return x


def _slice(x, mesh, axes, dim):
    n, i = mesh_size(mesh, axes), mesh_coord(mesh, axes)
    size = x.shape[dim] // n
    return x.narrow(dim, i * size, size)


def _a2a_one(x, group):
    """Chunk j of x's dim 0 to rank j of ``group``; chunk i of the result
    from rank i."""
    staged = _staged("all_to_all", group, x)
    src = x.contiguous()
    dev = src.device
    if staged:
        src = src.cpu()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.to(dev), staged


def _all_to_all(x, mesh, axes):
    """x's dim 0 in ``size(axes)`` chunks, chunk j to the rank at pod-major
    index j over ``axes``; chunk i of the result came from index i."""
    sizes = [mesh_size(mesh, (a,)) for a in axes]
    n = math.prod(sizes)
    rest = x.shape[1:]
    x = x.reshape((*sizes, x.shape[0] // n) + rest)
    for k, a in enumerate(axes):
        # exchange over dim k: destination index along a → source index
        moved = x.movedim(k, 0)
        out, staged = _a2a_one(moved, mesh.get_group(a))
        census.count("all_to_all", (a,), out.numel() * out.element_size(),
                     staged)
        x = out.movedim(0, k)
    return x.reshape((-1,) + rest)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim, reduce_grad):
        ctx.args = (mesh, axes, dim, reduce_grad)
        return _all_gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim, reduce_grad = ctx.args
        if reduce_grad:
            return _reduce_scatter(g, mesh, axes, dim), None, None, None, None
        return _slice(g, mesh, axes, dim), None, None, None, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, axes = ctx.args
        return _all_reduce(g, mesh, axes), None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return _reduce_scatter(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim = ctx.args
        return _all_gather(g, mesh, axes, dim), None, None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return _slice(x, mesh, axes, dim).clone()

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim = ctx.args
        return _all_gather(g, mesh, axes, dim), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return _all_to_all(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        mesh, axes = ctx.args
        return _all_to_all(g, mesh, axes), None, None


def _send_recv(x, mesh, axis, shift: int):
    """Send x to the rank ``shift`` along ``axis`` (cyclic), receive from the
    rank ``-shift`` along it."""
    group = mesh.get_group(axis)
    n = mesh_size(mesh, (axis,))
    i = mesh.get_local_rank(axis)
    dst = dist.get_global_rank(group, (i + shift) % n)
    src = dist.get_global_rank(group, (i - shift) % n)
    staged = _staged("send_recv", group, x)
    send = x.contiguous()
    dev = send.device
    if staged:
        send = send.cpu()
    recv = torch.empty_like(send)
    works = dist.batch_isend_irecv([dist.P2POp(dist.isend, send, dst, group),
                                    dist.P2POp(dist.irecv, recv, src, group)])
    for w in works:
        w.wait()
    census.count("send_recv", (axis,), recv.numel() * recv.element_size(),
                 staged)
    return recv.to(dev)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.args = (mesh, axis)
        return _send_recv(x, mesh, axis, 1)

    @staticmethod
    def backward(ctx, g):
        mesh, axis = ctx.args
        return _send_recv(g, mesh, axis, -1), None, None


def _active(mesh, axes) -> Tuple[str, ...]:
    """The dims of ``axes`` with more than one rank."""
    if mesh is None:
        return ()
    return tuple(a for a in axes if mesh_size(mesh, (a,)) > 1)


def gather(x, mesh, axes, dim: int, reduce_grad: bool = True):
    """All-gather x's ``dim`` over ``axes`` (pod-major); the backward
    reduce-scatters (``reduce_grad``: the work after it is split over
    ``axes``) or slices (it is replicated)."""
    axes = _active(mesh, axes)
    return _Gather.apply(x, mesh, axes, dim, reduce_grad) if axes else x


def copy(x, mesh, axes):
    """Identity; the backward all-reduces (a replicated tensor entering work
    split over ``axes``)."""
    axes = _active(mesh, axes)
    return _Copy.apply(x, mesh, axes) if axes else x


def reduce(x, mesh, axes):
    """All-reduce (sum) of partial sums; backward identity."""
    axes = _active(mesh, axes)
    return _Reduce.apply(x, mesh, axes) if axes else x


def reduce_max(x, mesh, axes):
    """All-reduce (max), outside autograd (a stabilizing shift)."""
    axes = _active(mesh, axes)
    return _all_reduce(x.detach(), mesh, axes, dist.ReduceOp.MAX) \
        if axes else x.detach()


def reduce_scatter(x, mesh, axes, dim: int):
    """Sum of partial sums over ``axes``, this rank's slice of ``dim``;
    backward all-gather."""
    axes = _active(mesh, axes)
    return _ReduceScatter.apply(x, mesh, axes, dim) if axes else x


def split(x, mesh, axes, dim: int):
    """This rank's slice of ``dim`` (pod-major over ``axes``); backward
    all-gather."""
    axes = _active(mesh, axes)
    return _Split.apply(x, mesh, axes, dim) if axes else x


def all_to_all(x, mesh, axes):
    """x's dim 0 in chunks, chunk j to the rank at index j over ``axes``;
    the result's chunk i from index i.  Backward: the reverse exchange."""
    axes = _active(mesh, axes)
    return _AllToAll.apply(x, mesh, axes) if axes else x


def ppermute(x, mesh, axis: str):
    """x sent to the next rank along ``axis`` (cyclic), the previous rank's
    received; backward the other way."""
    if not _active(mesh, (axis,)):
        return x
    return _PPermute.apply(x, mesh, axis)
