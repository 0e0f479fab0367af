"""Checkpointing: atomic and async-capable (PyTorch).

The port of ``repro/train/checkpoint.py``, in its format: one ``.npz`` per
checkpoint holding every tree leaf (keys are "/"-joined paths) and a JSON
manifest (step, tree structure, shapes, dtypes, extra).  Writes go to a
temp file and are renamed atomically, so a preemption mid-write never
corrupts the latest checkpoint.  A checkpoint written by either package
restores in the other: a port state ``(params_tree, opt_state)`` gives the
reference's keys (``0/embed``, ``0/layers/wq``, ``1/m/…``, ``1/count``).

bfloat16: numpy has no such dtype, and the reference's ``ml_dtypes``
leaves land in the ``.npz`` as raw 2-byte records (``np.load`` gives
``|V2``) with ``bfloat16`` in the manifest.  The port writes its bf16
leaves as the same raw records and reads ``|V2`` leaves named
``bfloat16`` back as ``torch.bfloat16`` from their bits.

``AsyncCheckpointer.save`` copies every leaf to the host before it
returns: the trainer updates its tensors in place, so a view or a
non-blocking copy would be overwritten by the next step.

Sharded trees (DTensor leaves): every rank calls ``save`` (each leaf is
all-gathered whole, in ``named_leaves`` order), rank 0 writes, and the
synchronous ``save`` ends on a barrier, so the file holds the reference's
full leaves and restores on any mesh or none.  ``restore(shardings=…)`` is
the elastic re-shard: the TARGET mesh decides placement, each leaf comes
back as a DTensor of the target's mesh and placements (every rank reads the
file and keeps its own blocks).
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from ..models.sharding import whole


def named_leaves(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """("a/b/c", leaf) pairs in ``jax.tree.leaves`` order: dict keys
    sorted, list and tuple items in order, None an empty subtree.  The
    keys are a checkpoint's leaf keys."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += named_leaves(tree[k], f"{prefix}{k}/")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += named_leaves(v, f"{prefix}{i}/")
        return out
    if tree is None:
        return []
    return [(prefix[:-1], tree)]


def tree_map(fn, tree):
    """``jax.tree.map`` of one tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _unflatten(flat: Dict[str, Any], structure) -> Any:
    def walk(s, prefix=""):
        if isinstance(s, dict):
            return {k: walk(v, f"{prefix}{k}/") for k, v in s.items()}
        if isinstance(s, (list, tuple)):
            t = [walk(v, f"{prefix}{i}/") for i, v in enumerate(s)]
            return type(s)(t) if isinstance(s, tuple) else t
        return flat[prefix[:-1]]
    return walk(structure)


def _structure_of(tree):
    if isinstance(tree, dict):
        return {k: _structure_of(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_structure_of(v) for v in tree]
    return None


def _to_host(x) -> Tuple[np.ndarray, str]:
    """(a host copy of the leaf as numpy, its dtype's name).  A tensor is
    copied (``to("cpu", copy=True)``, synchronous: never a view of a CPU
    tensor the trainer updates in place); bf16 becomes raw 2-byte
    records.  A DTensor is all-gathered whole first."""
    if isinstance(x, DTensor):
        x = whole(x.detach())
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True)
        name = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2")), name
        return t.numpy(), name
    arr = np.array(x)
    return arr, str(arr.dtype)


def to_tensor(arr: np.ndarray, device, dtype: Optional[str] = None
              ) -> torch.Tensor:
    """A numpy leaf as a tensor of its dtype and bits on ``device``.  bf16
    (``dtype`` "bfloat16", by default the array's own dtype's name: an
    ``ml_dtypes.bfloat16`` array, or raw ``|V2`` records that a manifest
    names so) is read from its bits."""
    if (dtype or arr.dtype.name) == "bfloat16":
        bits = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def tree_from_numpy(tree, like, device):
    """A tree of numpy arrays (a reference pytree, e.g.
    ``jax.tree.map(np.asarray, params)``) as tensors of ``like``'s dtypes
    on ``device``, after checking that its leaves are ``like``'s, key for
    key and shape for shape (bfloat16 from its bits).  ``like`` may be on
    the ``meta`` device."""
    want = {k: tuple(t.shape) for k, t in named_leaves(like)}
    got = named_leaves(tree)
    if [k for k, _ in got] != list(want):
        raise ValueError(f"parameter tree {[k for k, _ in got]} is not "
                         f"{list(want)}")
    for k, a in got:
        if tuple(np.shape(a)) != want[k]:
            raise ValueError(f"{k}: shape {np.shape(a)}, expected {want[k]}")

    def convert(t, ref):
        if isinstance(t, dict):
            return {k: convert(t[k], ref[k]) for k in t}
        if isinstance(t, (list, tuple)):
            return [convert(a, b) for a, b in zip(t, ref)]
        return to_tensor(np.array(t), device).to(ref.dtype)
    return convert(tree, like)


def _write(path: str, step: int, host: Dict[str, np.ndarray],
           manifest: Dict) -> str:
    ckpt = os.path.join(path, f"ckpt_{step:08d}.npz")
    fd, tmp = tempfile.mkstemp(dir=path, suffix=".tmp")
    with os.fdopen(fd, "wb") as f:
        np.savez(f, **host)
    os.replace(tmp, ckpt)
    mtmp = ckpt + ".manifest.tmp"
    with open(mtmp, "w") as f:
        json.dump(manifest, f)
    os.replace(mtmp, ckpt + ".manifest.json")
    return ckpt


def _host_snapshot(step: int, tree, extra: Optional[Dict]):
    host, dtypes = {}, {}
    for k, v in named_leaves(tree):
        host[k], dtypes[k] = _to_host(v)
    manifest = {
        "step": int(step),
        "structure": _structure_of(tree),
        "shapes": {k: list(v.shape) for k, v in host.items()},
        "dtypes": dtypes,
        "extra": extra or {},
    }
    return host, manifest


def _sharded(tree) -> bool:
    return any(isinstance(v, DTensor) for _, v in named_leaves(tree))


def _writes(tree) -> bool:
    """Whether this rank writes ``tree``'s checkpoint: rank 0 of a sharded
    tree's ranks, any rank for a tree it holds alone."""
    return not (_sharded(tree) and dist.is_initialized()
                and dist.get_rank() != 0)


def save(path: str, step: int, tree, extra: Optional[Dict] = None) -> str:
    """Atomic synchronous save.  Returns the checkpoint file path.  A
    sharded tree: every rank calls it, rank 0 writes, all return once the
    file is in place."""
    os.makedirs(path, exist_ok=True)
    host, manifest = _host_snapshot(step, tree, extra)
    if not _writes(tree):
        dist.barrier()
        return os.path.join(path, f"ckpt_{step:08d}.npz")
    out = _write(path, step, host, manifest)
    if _sharded(tree) and dist.is_initialized():
        dist.barrier()
    return out


class AsyncCheckpointer:
    """Background-thread checkpointing; at most one write in flight.  A
    sharded tree is gathered on every rank before ``save`` returns and
    written by rank 0's thread alone (other ranks read it after ``wait``
    and a barrier of their own)."""

    def __init__(self, path: str):
        self.path = path
        self._thread: Optional[threading.Thread] = None
        self.last_saved: Optional[str] = None

    def save(self, step: int, tree, extra: Optional[Dict] = None):
        self.wait()
        # the host copy is taken BEFORE returning: the next step updates
        # the tensors in place
        host, manifest = _host_snapshot(step, tree, extra)
        if not _writes(tree):
            self.last_saved = os.path.join(self.path, f"ckpt_{step:08d}.npz")
            return

        def work():
            os.makedirs(self.path, exist_ok=True)
            self.last_saved = _write(self.path, step, host, manifest)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    steps = [int(f[5:13]) for f in os.listdir(path)
             if f.startswith("ckpt_") and f.endswith(".npz")]
    return max(steps) if steps else None


class _Stored:
    """A leaf as read from the file: its array and its manifest dtype."""

    def __init__(self, array: np.ndarray, dtype: str):
        self.array, self.dtype = array, dtype


def _place(tree, shardings, device):
    """Each leaf of ``tree`` (numpy) on ``device``, as a DTensor where its
    sharding ``(mesh, placements)`` is given."""
    if isinstance(tree, dict):
        return {k: _place(v, shardings[k] if shardings is not None else None,
                          device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_place(v, shardings[i] if shardings is not None
                                 else None, device)
                          for i, v in enumerate(tree))
    t = to_tensor(tree.array, device, tree.dtype)
    if shardings is None:
        return t
    mesh, placements = shardings
    return distribute_tensor(t, mesh, placements, src_data_rank=None)


def restore(path: str, step: Optional[int] = None, shardings=None,
            device="cuda") -> Tuple[int, Any, Dict]:
    """Load a checkpoint (the latest when ``step`` is None) as (step, tree
    of tensors on ``device``, the card unless the caller names another,
    extra).  ``shardings``: a tree matching the restored one of ``(mesh,
    placements)`` (``transformer.param_shardings``) or None per leaf: the
    elastic re-shard, each such leaf a DTensor of that mesh and placements,
    whatever layout wrote the file."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    ckpt = os.path.join(path, f"ckpt_{step:08d}.npz")
    with open(ckpt + ".manifest.json") as f:
        manifest = json.load(f)
    with np.load(ckpt) as data:
        flat = {k: _Stored(data[k], manifest["dtypes"][k])
                for k in data.files}
    tree = _place(_unflatten(flat, manifest["structure"]), shardings, device)
    return manifest["step"], tree, manifest.get("extra", {})


def prune(path: str, keep: int = 3):
    """Drop all but the newest ``keep`` checkpoints."""
    if not os.path.isdir(path):
        return
    steps = sorted([int(f[5:13]) for f in os.listdir(path)
                    if f.startswith("ckpt_") and f.endswith(".npz")])
    for s in steps[:-keep]:
        for suffix in (".npz", ".npz.manifest.json"):
            p = os.path.join(path, f"ckpt_{s:08d}{suffix}")
            if os.path.exists(p):
                os.remove(p)
