"""The planning run's op walker: flops, HBM bytes, collective wire bytes and
peak live memory a rank, counted from the aten ops a program dispatches.

The port's counterpart of the JAX package's post-GSPMD HLO cost walker
(``repro/launch/hlo_analysis.py``; the file keeps that name so that a
reader finds it).  It walks dispatched aten ops, not HLO text: rank 0's
program runs on fake tensors (``FakeTensorMode``: shapes, dtypes and
devices, no storage) over a fake process group (``launch.mesh``), and
``Walker``, a ``TorchDispatchMode`` entered above the fake mode, sees every
op the program dispatches, forward and backward, once per execution.  A
Python loop runs its body on every trip, so the reference's trip-count
correction has nothing to correct.  Per op:

  · flops: ``torch.utils.flop_counter``'s formula where it has one
    (matmuls, convolutions, attention), the block Cholesky factor and
    solve of the solver's preconditioner, 1 per output element of a
    pointwise op and 1 per input element of a reduction or scatter (the
    reference's elementwise count).  A kernel wrapper's planned launch
    (``kernels.ops.planning``) adds the terms of PERF.md's kernel table,
    not those of the wrapper's plain version;
  · HBM bytes: every tensor input plus every output (the reference's
    unfused upper bound); views and allocations move nothing;
  · memory: the bytes of the storages alive, the arguments' included, and
    their peak (``peak_estimate_bytes``);
  · collectives: the port's census, not the dispatched ops —
    ``distributed.collectives.census`` for the models' collectives by op and
    mesh dim, ``Collectives.stats`` for the solver's by scope (``setup``,
    ``irls``, ``pcg_step``: the counterpart of the reference's
    ``while_loop_collectives``), as wire bytes by ring factors.

On a DTensor (a parameter's or gradient's wrapper) an op is counted on its
local block: what this rank computes.  Every count is per rank.
"""
from __future__ import annotations

import dataclasses
import threading
import weakref
from typing import Any, Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map

from ..distributed import collectives as C

aten = torch.ops.aten

# ---------------------------------------------------------------------------
# Roofline constants: NVIDIA H100 SXM5 80GB datasheet values, not
# measurements
# ---------------------------------------------------------------------------

PEAK_FLOPS = 989e12          # dense bf16 tensor-core FLOP/s a card
HBM_BW = 3.35e12             # HBM3 bytes/s a card
NVLINK_BW = 450e9            # NVLink 4: 900 GB/s a card both ways, 450 one way
IB_BW = 50e9                 # 400 Gb/s NDR InfiniBand a card
NODE_RANKS = 8               # cards a node (an HGX H100 board)
# torch.cuda.get_device_properties(0).total_memory of an "NVIDIA H100
# 80GB HBM3" (700 W) under torch 2.11, as chip_smoke.py phase 19 reads it
CARD_NAME = "NVIDIA H100 80GB HBM3"
CARD_TOTAL_MEMORY = 85_017_493_504
# What a planned peak leaves out when it is held against the card.  The
# planner read the measured peaks of chip_smoke.py phase 19b's two steps
# 3.5% and 2.0% low on that card: a peak is taken 3.5% up.  The walker
# sees no CUDA context, no NCCL buffers and no fragmentation: 2 GiB is
# kept back for them, an allowance and not a measurement.
PEAK_UNDER_READ = 0.035
CARD_RESERVED_BYTES = 2 * 2**30


def peak_with_margin(peak_bytes: float) -> int:
    """A planned peak a rank as the card must hold it (``PEAK_UNDER_READ``
    and ``CARD_RESERVED_BYTES`` added)."""
    return int(peak_bytes * (1.0 + PEAK_UNDER_READ) + CARD_RESERVED_BYTES)

# ops that move no bytes: views, allocations, metadata
_NO_TRAFFIC = {aten.empty, aten.empty_like, aten.empty_strided,
               aten.new_empty, aten.new_empty_strided, aten.detach,
               aten.alias, aten.lift_fresh, aten._local_scalar_dense,
               aten.set_, aten.resize_}
# reductions and scatters: one flop per input element
_REDUCTIONS = {aten.sum, aten.mean, aten.amax, aten.amin, aten.max,
               aten.min, aten.prod, aten.logsumexp, aten._softmax,
               aten._log_softmax, aten._softmax_backward_data,
               aten._log_softmax_backward_data, aten.segment_reduce,
               aten.cumsum, aten.linalg_vector_norm, aten.norm,
               aten.index_add, aten.index_add_, aten.index_put,
               aten.index_put_, aten.scatter_add, aten.scatter_add_,
               aten.index_reduce, aten.var_mean, aten.sort}


def _local(x):
    """A DTensor's local block; anything else itself."""
    return getattr(x, "_local_tensor", x) if isinstance(x, torch.Tensor) \
        else x


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _flop_registry():
    from torch.utils.flop_counter import flop_registry

    return flop_registry


def _special_flops(packet, args, out) -> Optional[float]:
    """Formulas flop_counter does not have: the block Cholesky factor
    (n³/3 a block) and its solve (2·n²·k a block)."""
    if packet in (aten.linalg_cholesky_ex, aten.cholesky):
        a = args[0]
        n = a.shape[-1]
        return a.numel() / (n * n) * n ** 3 / 3
    if packet in (aten.cholesky_solve, aten.linalg_solve_triangular,
                  aten.triangular_solve):
        b, a = args[0], args[1]
        n = a.shape[-1]
        return 2.0 * b.numel() * n / (1 if packet == aten.cholesky_solve
                                      else 2)
    return None


class Walker(TorchDispatchMode):
    """Counts what the ops dispatched while it is entered compute, move and
    keep alive (see the module docstring).  Enter it inside the fake mode
    the program's tensors belong to."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.ops = 0
        self.kernel_launches: Dict[str, int] = {}
        self.kernel_flops: Dict[str, float] = {}
        self.launch_shapes: Dict[str, list] = {}
        self.flops_by_op: Dict[str, float] = {}
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, int] = {}
        self._lock = threading.Lock()

    # -- memory ------------------------------------------------------------
    def _free(self, key: int) -> None:
        with self._lock:
            self.live -= self._storages.pop(key, 0)

    def track(self, tree, local: bool = False) -> int:
        """Count the storages of ``tree``'s tensors (a DTensor's local
        block; ``local``: the tree holds no DTensor) as alive until they
        are freed; returns the bytes newly counted."""
        added = 0
        for t in _tensors(tree if local else tree_map(_local, tree)):
            st = t.untyped_storage()
            key = id(st)
            with self._lock:
                if key in self._storages:
                    continue
                nb = st.nbytes()
                self._storages[key] = nb
                self.live += nb
                self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)
            added += nb
        return added

    def bytes_of(self, tree) -> int:
        """Bytes of the distinct storages of ``tree``'s tensors."""
        seen = {}
        for t in _tensors(tree_map(_local, tree)):
            st = t.untyped_storage()
            seen[id(st)] = st.nbytes()
        return sum(seen.values())

    # -- kernels -----------------------------------------------------------
    def launch(self, rec) -> None:
        """``kernels.ops.planning``'s sink: a planned kernel launch."""
        with self._lock:
            self.flops += rec.flops
            self.hbm_bytes += rec.bytes
            self.kernel_launches[rec.name] = \
                self.kernel_launches.get(rec.name, 0) + 1
            self.kernel_flops[rec.name] = \
                self.kernel_flops.get(rec.name, 0.0) + rec.flops
            shapes = self.launch_shapes.setdefault(rec.name, [])
            if rec.shapes not in shapes:
                shapes.append(rec.shapes)

    # -- ops ---------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if any(hasattr(t, "_local_tensor") for t in types):
            largs, lkwargs = tree_map(_local, (args, kwargs))
            lout = tree_map(_local, out)
        else:
            largs, lkwargs, lout = args, kwargs, out
        ins, outs = _tensors((largs, lkwargs)), _tensors(lout)
        flops = 0.0
        if packet in _flop_registry():
            flops = float(_flop_registry()[packet](*largs, **lkwargs,
                                                   out_val=lout))
        else:
            special = _special_flops(packet, largs, lout)
            if special is not None:
                flops = special
            elif packet in _REDUCTIONS and ins:
                flops = float(max(t.numel() for t in ins))
            elif torch.Tag.pointwise in func.tags and outs:
                flops = float(outs[0].numel())
        moved = 0
        if not func.is_view and packet not in _NO_TRAFFIC:
            moved = sum(_nbytes(t) for t in ins + outs)
        with self._lock:
            self.ops += 1
            self.flops += flops
            self.hbm_bytes += moved
            if flops:
                name = str(packet)
                self.flops_by_op[name] = self.flops_by_op.get(name, 0.0) \
                    + flops
        if outs:
            self.track(outs, local=True)
        return out


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def _wire(op: str, n: int, nbytes: float) -> float:
    """Wire bytes a rank of a ring collective over ``n`` ranks whose result
    buffer is ``nbytes`` (as the census counts it)."""
    if n <= 1:
        return 0.0
    ring = (n - 1) / n
    if op == "all_gather":
        return ring * nbytes
    if op == "reduce_scatter":          # the result is one of n shards
        return ring * nbytes * n
    if op == "all_reduce":
        return 2.0 * ring * nbytes
    if op == "all_to_all":
        return ring * nbytes
    return float(nbytes)                # send_recv: the received buffer


def _group_ranks(mesh, axes) -> list:
    """The global ranks of rank 0's group over the mesh dims ``axes``
    together (the sub-mesh they span through rank 0)."""
    names = tuple(mesh.mesh_dim_names)
    grid = mesh.mesh
    idx = tuple(slice(None) if a in axes else 0 for a in names)
    return [int(r) for r in grid[idx].flatten().tolist()]


def _link(ranks) -> str:
    """``nvlink`` when the ranks share one node of NODE_RANKS cards, else
    ``ib``."""
    return "nvlink" if len({r // NODE_RANKS for r in ranks}) == 1 else "ib"


@dataclasses.dataclass
class Costs:
    """Per-rank costs of a planning run (the reference's ``HloCosts``, plus
    the wire bytes by link and the planned kernel launches)."""
    flops: float
    hbm_bytes: float
    collective_bytes: float
    collective_counts: Dict[str, float]
    per_collective_bytes: Dict[str, float]
    link_bytes: Dict[str, float]
    kernel_launches: Dict[str, int]
    kernel_flops: Dict[str, float]
    flops_by_op: Dict[str, float]


@dataclasses.dataclass
class Plan:
    """A planning run's record: its costs, its memory a rank, the census
    of its collectives as the port counts them (result-buffer bytes), its
    outputs (fake tensors) and the ops walked."""
    costs: Costs
    memory: Dict[str, int]
    census: Dict[str, Any]
    outputs: Any
    ops: int
    launch_shapes: Dict[str, list]


def _collective_costs(mesh, census: dict, solver: Optional[dict],
                      group_ranks: int):
    counts: Dict[str, float] = {}
    wire: Dict[str, float] = {}
    link = {"nvlink": 0.0, "ib": 0.0}
    for key, v in census.items():
        op, axes = key[:-1].split("[")
        ranks = _group_ranks(mesh, axes.split(","))
        w = _wire(op, len(ranks), v["bytes"])
        counts[key] = counts.get(key, 0.0) + v["calls"]
        wire[key] = wire.get(key, 0.0) + w
        link[_link(ranks)] += w
    if solver:
        lk = _link(range(group_ranks))
        for scope, ops in solver["scopes"].items():
            for op, v in ops.items():
                key = f"{scope}/{op}"
                w = _wire(op, group_ranks, v["bytes"])
                counts[key] = counts.get(key, 0.0) + v["calls"]
                wire[key] = wire.get(key, 0.0) + w
                link[lk] += w
    return counts, wire, link


def analyze(fn: Callable, args: tuple, fake_mode, *, mesh=None, coll=None,
            donate_argnums=()) -> Plan:
    """Run ``fn(*args)`` (``args`` fake tensors of ``fake_mode``) once
    under a ``Walker`` and the kernels' planning sink, and return its
    ``Plan``.  ``mesh``: the mesh of the models' collectives (their census
    is reset first); ``coll``: the solver's ``Collectives`` (reset first;
    its group's size prices its wire bytes).  Memory: ``argument_bytes``
    the arguments' storages; ``output_bytes`` the outputs' storages that
    are not an argument's; ``alias_bytes`` the arguments donated
    (``donate_argnums``: updated in place, the outputs alias them);
    ``temp_bytes`` the peak less arguments and outputs."""
    from ..kernels import ops as kops

    C.census.reset()
    if coll is not None:
        coll.reset()
    walker = Walker()
    arg_bytes = walker.track(args)
    alias = walker.bytes_of(tuple(args[i] for i in donate_argnums))
    with fake_mode, walker, kops.planning(walker.launch):
        out = fn(*args)
    arg_keys = {id(t.untyped_storage())
                for t in _tensors(tree_map(_local, args))}
    out_store = {}
    for t in _tensors(tree_map(_local, out)):
        st = t.untyped_storage()
        if id(st) not in arg_keys:
            out_store[id(st)] = st.nbytes()
    out_bytes = sum(out_store.values())
    census = C.census.snapshot()
    solver = coll.stats() if coll is not None else None
    counts, wire, link = _collective_costs(
        mesh, census, solver, coll.size if coll is not None else 1)
    costs = Costs(flops=walker.flops, hbm_bytes=walker.hbm_bytes,
                  collective_bytes=sum(wire.values()),
                  collective_counts=counts, per_collective_bytes=wire,
                  link_bytes=link,
                  kernel_launches=dict(walker.kernel_launches),
                  kernel_flops=dict(walker.kernel_flops),
                  flops_by_op=dict(walker.flops_by_op))
    memory = dict(argument_bytes=arg_bytes, output_bytes=out_bytes,
                  alias_bytes=alias,
                  temp_bytes=max(0, walker.peak - arg_bytes - out_bytes),
                  peak_estimate_bytes=walker.peak)
    return Plan(costs=costs, memory=memory,
                census=dict(models=census, solver=solver), outputs=out,
                ops=walker.ops, launch_shapes=dict(walker.launch_shapes))


def _lin(a, b, n: float):
    """a + n·(b − a), leaf by leaf (numbers and dicts of numbers)."""
    if isinstance(a, dict) or isinstance(b, dict):
        a, b = a or {}, b or {}
        return {k: _lin(a.get(k, 0), b.get(k, 0), n) for k in {**a, **b}}
    return a + n * (b - a)


def extrapolate(one: Plan, two: Plan, n: float) -> Plan:
    """The plan of a loop of 1 + n trips from the plans of 1 and 2 trips
    (everything but the loop counted in both): each count as
    ``one + n·(two − one)``, the memory that of ``two`` (a trip frees what
    it takes)."""
    c1, c2 = one.costs, two.costs
    costs = Costs(**{f.name: _lin(getattr(c1, f.name), getattr(c2, f.name),
                                  n)
                     for f in dataclasses.fields(Costs)})
    return Plan(costs=costs, memory=dict(two.memory),
                census=_lin(one.census, two.census, n), outputs=two.outputs,
                ops=int(_lin(one.ops, two.ops, n)),
                launch_shapes=two.launch_shapes)


def roofline_terms(costs: Costs) -> Dict[str, float]:
    """Per-rank times in seconds from the H100 datasheet rates: flops over
    the dense bf16 peak, bytes over HBM3, wire bytes over NVLink 4 for a
    group inside one node and over NDR InfiniBand for one that spans
    nodes (the counts are already per rank)."""
    t_compute = costs.flops / PEAK_FLOPS
    t_memory = costs.hbm_bytes / HBM_BW
    t_collective = (costs.link_bytes.get("nvlink", 0.0) / NVLINK_BW
                    + costs.link_bytes.get("ib", 0.0) / IB_BW)
    dominant = max((("compute", t_compute), ("memory", t_memory),
                    ("collective", t_collective)), key=lambda kv: kv[1])[0]
    return {"t_compute": t_compute, "t_memory": t_memory,
            "t_collective": t_collective, "dominant": dominant}
