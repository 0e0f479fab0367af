"""Logical-axis sharding rules on a ``DeviceMesh`` (PyTorch).

The port of ``repro/models/sharding.py``.  Models name each tensor dim
LOGICALLY (``batch``, ``heads``, ``d_ff``, ...); a ``ShardingRules`` table
maps logical names to mesh dims.  ``None`` mesh or unmapped names mean "no
constraint".  A mapping is dropped where its mesh size does not divide the
dim, and a mesh dim that an earlier tensor dim already claimed is dropped
(MoE weights map both ``experts`` and ``d_ff`` to the model axis: mixtral's 8
experts fall back to TP over d_ff, llama4's 128 take EP).

``spec`` gives the reference's PartitionSpec as a tuple (per tensor dim:
None, a mesh dim's name, or a tuple of names); ``placements`` maps it onto
DTensor placements, one per mesh dim (a tensor dim over ("pod", "data") is
``Shard(d)`` on both, pod-major as in JAX).  ``constraint`` redistributes a
DTensor (the reference's ``with_sharding_constraint``) and is the identity
without a mesh or on a plain tensor; ``named_sharding`` gives ``(mesh,
placements)`` (the reference's ``NamedSharding``) or None.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` or, to plan
without ranks, an ``AbstractMesh`` (sizes and names only, the counterpart of
``jax.sharding.AbstractMesh``).  Both carry ``shape`` (sizes) and
``mesh_dim_names``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

AxisNames = Union[None, str, Tuple[str, ...]]


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's sizes and dim names, without devices or ranks."""
    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]

    def size(self, dim: Optional[int] = None) -> int:
        if dim is not None:
            return self.shape[dim]
        n = 1
        for s in self.shape:
            n *= s
        return n


def mesh_sizes(mesh) -> Dict[str, int]:
    """{dim name: size} of a DeviceMesh or AbstractMesh."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def as_axes(axes: AxisNames) -> Tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    mesh: object                       # DeviceMesh, AbstractMesh or None
    rules: Dict[str, AxisNames]

    def _axes_size(self, axes: AxisNames) -> int:
        if axes is None or self.mesh is None:
            return 1
        sizes = mesh_sizes(self.mesh)
        size = 1
        for a in as_axes(axes):
            size *= sizes[a]
        return size

    def axes(self, name: str) -> Tuple[str, ...]:
        """The mesh dims a logical name maps to (empty without a mesh)."""
        if self.mesh is None:
            return ()
        return as_axes(self.rules.get(name))

    def spec(self, *dims: Optional[str],
             shape: Optional[Sequence[int]] = None) -> Tuple[AxisNames, ...]:
        """The PartitionSpec of logical dims, as a tuple.  Drops (a)
        mappings that don't divide the dim and (b) mesh dims already claimed
        by an earlier dim."""
        parts: List[AxisNames] = []
        used: set = set()
        for i, d in enumerate(dims):
            axes = self.rules.get(d) if d is not None else None
            if axes is not None:
                tup = tuple(a for a in as_axes(axes) if a not in used)
                axes = tup if tup else None
                if axes is not None and shape is not None and \
                        shape[i] % self._axes_size(axes) != 0:
                    axes = None
                if axes is not None:
                    used.update(axes)
                    if len(axes) == 1:
                        axes = axes[0]
            parts.append(axes)
        return tuple(parts)

    def placements(self, spec: Sequence[AxisNames]) -> list:
        """DTensor placements (one per mesh dim) of a spec: ``Shard(d)`` on
        every mesh dim that tensor dim d maps to, ``Replicate()`` on the
        rest.  A tensor dim over several mesh dims must name them in the
        mesh's order (pod-major)."""
        from torch.distributed.tensor import Replicate, Shard

        names = tuple(self.mesh.mesh_dim_names)
        out = [Replicate() for _ in names]
        for d, axes in enumerate(spec):
            tup = as_axes(axes)
            idx = [names.index(a) for a in tup]
            if idx != sorted(idx):
                raise ValueError(f"dim {d} maps to {tup}, not in the mesh's "
                                 f"order {names}")
            for i in idx:
                out[i] = Shard(d)
        return out

    def constraint(self, x, *dims: Optional[str]):
        """``x`` redistributed to the spec of ``dims`` (a DTensor); the
        identity without a mesh or on a plain tensor."""
        from torch.distributed.tensor import DTensor

        if self.mesh is None or not isinstance(x, DTensor):
            return x
        spec = self.spec(*dims, shape=x.shape)
        return x.redistribute(self.mesh, self.placements(spec))

    def named_sharding(self, *dims: Optional[str],
                       shape: Optional[Sequence[int]] = None):
        """``(mesh, placements)`` of the spec, or None without a mesh."""
        if self.mesh is None:
            return None
        return self.mesh, self.placements(self.spec(*dims, shape=shape))


def no_sharding() -> ShardingRules:
    return ShardingRules(mesh=None, rules={})


# logical-name conventions used across the model zoo:
#   batch, seq, heads, kv_heads, d_model, d_ff, vocab, experts, expert_cap,
#   nodes, edges, graph_batch, rows (embedding-table rows), candidates
def lm_rules(mesh, data_axes: AxisNames = ("pod", "data"),
             model_axes: AxisNames = "model") -> ShardingRules:
    """Standard LM recipe: batch → data axes (DP), width → model axis (TP)."""
    if mesh is not None:
        present = set(mesh.mesh_dim_names)
        data_axes = tuple(a for a in as_axes(data_axes) if a in present)
        if len(data_axes) == 1:
            data_axes = data_axes[0]
    return ShardingRules(mesh=mesh, rules={
        "batch": data_axes,
        "seq_shard": data_axes,      # long-context decode: shard the cache seq
        "seq_sp": model_axes,        # sequence parallelism on the residual
        # flattened B·S token axis (MoE dispatch): data axes only
        "tokens": data_axes,
        "heads": model_axes,
        "kv_heads": model_axes,
        "d_head": model_axes,        # cache fallback when KV ∤ model
        "d_ff": model_axes,
        "vocab": model_axes,
        # EP over the DATA axes: tokens are data-sharded, so expert dispatch
        # is an all-to-all within the data axis
        "expert_ep": data_axes,
        "expert_cap": data_axes,     # capacity-dim fallback when E ∤ data
        "experts": model_axes,
        "nodes": data_axes,
        "edges": data_axes,
        "rows": model_axes,
        "candidates": data_axes,
        "fsdp": data_axes,           # ZeRO-style param/optimizer sharding
    })


def stored_dims(t, lead: int = 0) -> Dict[str, int]:
    """{mesh dim name: the tensor dim it shards} of a DTensor, the dims
    counted after dropping ``lead`` leading ones (a layer stack's L, a
    pipeline's stage and L: the caller takes its own slice of those); a
    plain tensor shards none."""
    from torch.distributed.tensor import DTensor

    if not isinstance(t, DTensor):
        return {}
    return {name: p.dim - lead
            for name, p in zip(t.device_mesh.mesh_dim_names, t.placements)
            if p.is_shard() and p.dim >= lead}


def local_block(t, mesh, need: Dict[str, Optional[int]],
                split: Dict[str, bool],
                stored: Optional[Dict[str, int]] = None):
    """The block of a parameter that this rank's work needs, from the
    block it holds, differentiably.

    ``t``: the rank's local block (a DTensor's ``to_local()``, or a plain
    tensor every rank holds whole); ``stored``: {mesh dim: tensor dim} it is
    sharded on (by default ``stored_dims(t)``, with ``t`` then a DTensor);
    ``need``: {mesh dim: tensor dim} the work wants it sharded on (a mesh
    dim absent or None: whole); ``split``: {mesh dim: True} where the work
    after it differs between the ranks of that dim (each rank's gradient of
    the block is then a partial sum, reduced here in the backward).  No
    mesh: ``t`` itself."""
    from torch.distributed.tensor import DTensor

    from ..distributed import collectives as C

    if stored is None:
        stored = stored_dims(t)
    if isinstance(t, DTensor):
        t = t.to_local()
    if mesh is None:
        return t
    names = tuple(mesh.mesh_dim_names)
    gathers: Dict[int, list] = {}
    splits: Dict[int, list] = {}
    copies = []
    for a in names:
        s, n = stored.get(a), need.get(a)
        if s is not None and s != n:
            gathers.setdefault(s, []).append(a)
        if n is not None and s != n:
            splits.setdefault(n, []).append(a)
        if s is None and n is None and split.get(a):
            copies.append(a)
    for d, axes in gathers.items():
        t = C.gather(t, mesh, tuple(axes), d,
                     reduce_grad=any(split.get(a) for a in axes))
    for d, axes in splits.items():
        t = C.split(t, mesh, tuple(axes), d)
    return C.copy(t, mesh, tuple(copies))


def whole(t):
    """The full tensor of a DTensor through the port's collectives (its
    Shard dims all-gathered, pod-major; its Partial (sum) dims reduced), so
    that it takes the routes ``distributed.collectives`` gives gloo on CUDA
    tensors; a plain tensor is returned as it is.  Even shards only."""
    from torch.distributed.tensor import DTensor

    from ..distributed import collectives as C

    if not isinstance(t, DTensor):
        return t
    mesh = t.device_mesh
    x = t.to_local()
    shards: Dict[int, list] = {}
    partial = []
    for name, p in zip(mesh.mesh_dim_names, t.placements):
        if p.is_shard():
            shards.setdefault(p.dim, []).append(name)
        elif p.is_partial():
            if p.reduce_op != "sum":
                raise ValueError(f"whole: a Partial({p.reduce_op}) dim")
            partial.append(name)
    for d, axes in shards.items():
        x = C.gather(x, mesh, tuple(axes), d, reduce_grad=False)
    return C.reduce(x, mesh, tuple(partial))
