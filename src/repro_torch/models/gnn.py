"""GNN architectures: GCN, SchNet, DimeNet, MeshGraphNet (PyTorch).

The port of ``repro/models/gnn.py``: the same configs, parameter trees,
batch dicts and arithmetic.  Message passing is an edge-index gather and a
segment sum, as in the reference, written with ``layers.gather`` and
``layers.segment_sum`` over ``RowIndex`` plans: the stable-sort segments
of ``core/incidence`` (the solver's own fixed-order sums), built once per
forward for each index array (``edge_src``, ``edge_dst``, ``tri_kj``,
``tri_ji``, ``graph_ids``, the atom types) and reused by every layer.  Each
gather's backward is the segment sum over the same index and each sum's
backward a gather, so no direction scatters with atomics: a train step on
the card gives the same bits run after run, as ``jax.ops.segment_sum``
does on the reference's backends.

Parameters are the reference's pytree, leaf for leaf: nested dicts and
lists of tensors, with the per-layer parameters of SchNet (``inter``),
DimeNet (``blocks``) and MeshGraphNet (``proc``) stacked along a leading
(L, ...) dim (their biases and norm vectors are 2-D leaves, which AdamW
decays, as the reference's).  ``jax.lax.scan`` over the stacked leaves is
a Python loop over their rows.  ``*_init(cfg, gen, device)`` draws from a
``torch.Generator``; ``params_from_numpy`` carries the reference's
parameters over.

Batch dict convention (all arrays padded to static shapes; tensors on the
parameters' device, ``n_graphs`` a Python int):
  node_feat  f[N, Fin]        (or node_type i32[N] for SchNet/DimeNet)
  edge_src   i32[E], edge_dst i32[E]
  node_mask  f[N], edge_mask  f[E]      (0 = padding)
  edge_dist  f[E]                        (SchNet/DimeNet geometry)
  edge_feat  f[E, Fe]                    (MeshGraphNet)
  tri_kj/tri_ji i32[T], tri_sbf f[T, S]  (DimeNet triplets)
  graph_ids  i32[N], n_graphs            (batched small graphs readout)
  labels     f[...] / i32[...]

``rules``: None or ``sharding.no_sharding()`` change nothing.  With rules
on a mesh (``launch.cells.gnn_rules``: nodes, edges and triplets over every
axis; parameters replicated) each rank holds its block of the nodes, edges
and triplets (a batch leaf is a DTensor sharded along dim 0, or a tensor
every rank holds whole, of which it takes its block; their counts padded to
multiples of the shards, ``pad_batch``), and the collectives are written
out where the reference places its sharding constraints: node features are
all-gathered before an edge gather (``layers.gather_sharded``), sums onto
nodes (or DimeNet's onto edges) are reduce-scattered back to their blocks
(``layers.segment_sum_sharded``), a graph readout and the loss's sums are
all-reduced, and each parameter enters through ``collectives.copy``, whose
backward all-reduces its gradient.  Index arrays hold global ids.  The
forward of GCN and MeshGraphNet returns the rank's block of the nodes; the
losses are the same scalar on every rank.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from ..distributed import collectives as C
from ..train.checkpoint import tree_from_numpy
from .layers import (RowIndex, gather, gather_sharded, mlp, segment_sum,
                     segment_sum_sharded)
from .transformer import as_torch_dtype

def _randn(gen, shape, device):
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device)


def _dense_init(gen, fan_in, fan_out, dtype, device):
    return (_randn(gen, (fan_in, fan_out), device)
            / math.sqrt(fan_in)).to(dtype)


def _mlp_params(gen, dims, dtype, device):
    return {"w": [_dense_init(gen, a, b, dtype, device)
                  for a, b in zip(dims[:-1], dims[1:])],
            "b": [torch.zeros((b,), dtype=dtype, device=device)
                  for b in dims[1:]]}


def _stack(trees):
    """``jax.tree.map(jnp.stack, *trees)`` of same-structured trees."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return [_stack([t[i] for t in trees]) for i in range(len(first))]
    return torch.stack(trees)


def _unstack(tree, n: int):
    """The n per-layer trees of a stacked tree (each leaf unbound once, so
    its gradient is stacked back in one op)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    if isinstance(tree, (list, tuple)):
        parts = [_unstack(v, n) for v in tree]
        return [[p[i] for p in parts] for i in range(n)]
    return list(tree.unbind(0))


def _mlp(p, x, act=torch.relu, final_act=False):
    return mlp(x, p["w"], p["b"], act=act, final_act=final_act)


def _layer_norm(x, scale, bias, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (its formula, and its
    gradient ½ at 0, where a node without edges puts its bias)."""
    return torch.logaddexp(x, x.new_zeros(()))


def _ssp(x):  # shifted softplus, SchNet's activation
    return _softplus(x) - math.log(2.0)


def scatter_mean(vals, idx, n, mask=None):
    """Per-segment means of ``vals``' rows (``idx`` ids or a ``RowIndex``),
    dividing by the (masked) count, at least 1."""
    index = idx if isinstance(idx, RowIndex) else RowIndex(idx, n)
    if mask is not None:
        vals = vals * mask[:, None]
        cnt = segment_sum(mask, index)
    else:
        cnt = segment_sum(torch.ones(vals.shape[0], dtype=vals.dtype,
                                     device=vals.device), index)
    s = segment_sum(vals, index)
    return s / torch.clamp(cnt, min=1.0)[:, None]


def _cfg_dtypes(cfg, *fields):
    for f in fields:
        v = getattr(cfg, f)
        if v is not None:
            object.__setattr__(cfg, f, as_torch_dtype(v))


# ===========================================================================
# The batch's layout on a mesh
# ===========================================================================

# the leading dim of each batch leaf (the reference's cells.batch_sharding);
# the rest lead with nodes, but a graph-level ``labels`` is whole
_EDGE_LEAVES = ("edge_src", "edge_dst", "edge_mask", "edge_dist",
                "edge_feat")
_TRIPLET_LEAVES = ("tri_kj", "tri_ji", "tri_mask", "tri_sbf")


class _Graph:
    """One batch on ``rules``' mesh: this rank's blocks of its leaves
    (``b``), the global node, edge and triplet counts (``n``, ``e``,
    ``t``), and the collectives over the shards' axes.  Without a mesh (or
    on one shard) the blocks are the whole batch and every collective the
    identity: the one-device program."""

    def __init__(self, batch, rules, graph_labels: bool):
        from torch.distributed.tensor import DTensor

        mesh = rules.mesh if rules is not None else None
        self.mesh = mesh
        self.axes = C._active(mesh, rules.axes("nodes")) if mesh is not None \
            else ()
        p = C.mesh_size(mesh, self.axes)
        self.b = {}
        for k, v in batch.items():
            if isinstance(v, DTensor):
                v = v.to_local()
            elif (isinstance(v, torch.Tensor) and p > 1
                  and not (graph_labels and k == "labels")):
                if v.shape[0] % p:
                    raise ValueError(f"{k}: {v.shape[0]} rows do not split "
                                     f"over {p} shards (pad_batch)")
                v = C._slice(v, mesh, self.axes, 0)
            self.b[k] = v
        lead = lambda k: self.b[k].shape[0] * p if k in self.b else 0
        self.n = lead("node_mask")
        self.e = lead("edge_src")
        self.t = lead("tri_kj")
        self._index = {}

    def index(self, ids, n) -> RowIndex:
        """The ``RowIndex`` of ``ids`` into ``n`` rows, built once per
        forward and shared by every layer's gathers and sums over it."""
        key = (id(ids), n)
        if key not in self._index:
            self._index[key] = RowIndex(ids, n)
        return self._index[key]

    def params(self, tree):
        """Every parameter leaf through ``collectives.copy`` (identity; the
        backward all-reduces its gradient over the shards)."""
        if isinstance(tree, dict):
            return {k: self.params(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [self.params(v) for v in tree]
        return C.copy(tree, self.mesh, self.axes)

    def rows(self, x, ids, n):
        """Rows ``ids`` (global) of a tensor sharded like ids' targets."""
        return gather_sharded(x, self.index(ids, n), self.mesh, self.axes)

    def sum_to(self, x, ids, n):
        """Sums of ``x``'s rows onto the ``n`` rows ``ids`` name, this
        rank's block of them."""
        return segment_sum_sharded(x, self.index(ids, n), self.mesh,
                                   self.axes)

    def total(self, x):
        """A partial sum over this rank's rows, summed over the shards."""
        return C.reduce(x, self.mesh, self.axes)


def pad_batch(batch, p: int):
    """A batch with its node, edge and triplet counts padded up to
    multiples of ``p`` (as ``launch.cells.build_gnn_cell`` pads a cell):
    padded rows carry mask 0, index 0 and zero features, so they change no
    sum; a graph-level ``labels`` and ``n_graphs`` are kept."""
    out = dict(batch)

    def pad(k):
        v = batch[k]
        extra = -v.shape[0] % p
        if extra:
            out[k] = torch.cat([v, v.new_zeros((extra,) + tuple(v.shape[1:]))])

    n = batch["node_mask"].shape[0]
    for k, v in batch.items():
        if not isinstance(v, torch.Tensor):
            continue
        if k in _EDGE_LEAVES or k in _TRIPLET_LEAVES:
            pad(k)
        elif v.shape[0] == n and not (k == "labels" and v.dim() == 1
                                      and "graph_ids" in batch):
            pad(k)
    return out


# ===========================================================================
# GCN  (Kipf & Welling) — n_layers=2, hidden=16, sym norm
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class GCNConfig:
    name: str = "gcn-cora"
    n_layers: int = 2
    d_hidden: int = 16
    in_dim: int = 1433
    n_classes: int = 7
    dtype: Any = torch.float32        # a torch, numpy or JAX dtype, or name

    def __post_init__(self):
        _cfg_dtypes(self, "dtype")


def gcn_init(cfg: GCNConfig, gen: Optional[torch.Generator] = None,
             device="cuda"):
    dims = [cfg.in_dim] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]
    return {"w": [_dense_init(gen, a, b, cfg.dtype, device)
                  for a, b in zip(dims[:-1], dims[1:])]}


def _gcn(params, g: _Graph, cfg: GCNConfig):
    b = g.b
    x = b["node_feat"].to(cfg.dtype)
    src, dst = b["edge_src"], b["edge_dst"]
    emask = b["edge_mask"]
    n = g.n
    # symmetric normalization with self-loops: Â = D^-1/2 (A + I) D^-1/2
    deg = g.sum_to(emask, src, n) + g.sum_to(emask, dst, n) + 1.0
    dn = torch.rsqrt(deg)
    coef = (g.rows(dn, src, n) * g.rows(dn, dst, n) * emask).to(cfg.dtype)

    ws = g.params(params)["w"]
    for i, w in enumerate(ws):
        h = x @ w
        m_fwd = g.sum_to(coef[:, None] * g.rows(h, src, n), dst, n)
        m_bwd = g.sum_to(coef[:, None] * g.rows(h, dst, n), src, n)
        x = m_fwd + m_bwd + dn[:, None] ** 2 * h      # self loop
        if i < len(ws) - 1:
            x = torch.relu(x)
    return x


def gcn_forward(params, batch, cfg: GCNConfig, rules=None):
    """Node logits (on a mesh: this rank's block of the nodes)."""
    return _gcn(params, _Graph(batch, rules, False), cfg)


def gcn_loss(params, batch, cfg: GCNConfig, rules=None):
    g = _Graph(batch, rules, False)
    logits = _gcn(params, g, cfg).float()
    labels = g.b["labels"].long()
    mask = g.b["node_mask"]
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[:, None])[:, 0]
    return g.total(((lse - ll) * mask).sum()) / \
        torch.clamp(g.total(mask.sum()), min=1.0)


# ===========================================================================
# SchNet — n_interactions=3, hidden=64, rbf=300, cutoff=10
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class SchNetConfig:
    name: str = "schnet"
    n_interactions: int = 3
    d_hidden: int = 64
    n_rbf: int = 300
    cutoff: float = 10.0
    n_atom_types: int = 100
    dtype: Any = torch.float32

    def __post_init__(self):
        _cfg_dtypes(self, "dtype")


def schnet_init(cfg: SchNetConfig, gen: Optional[torch.Generator] = None,
                device="cuda"):
    h, r = cfg.d_hidden, cfg.n_rbf

    def inter():
        return {"filter": _mlp_params(gen, [r, h, h], cfg.dtype, device),
                "in_lin": _dense_init(gen, h, h, cfg.dtype, device),
                "out": _mlp_params(gen, [h, h, h], cfg.dtype, device)}

    return {
        "embed": (_randn(gen, (cfg.n_atom_types, h), device) * 0.1
                  ).to(cfg.dtype),
        "inter": _stack([inter() for _ in range(cfg.n_interactions)]),
        "head": _mlp_params(gen, [h, h // 2, 1], cfg.dtype, device),
    }


def rbf_expand(dist, n_rbf, cutoff):
    centers = torch.linspace(0.0, cutoff, n_rbf, dtype=torch.float32,
                             device=dist.device)
    gamma = 10.0 / cutoff
    return torch.exp(-gamma * (dist[:, None] - centers[None, :]) ** 2)


def schnet_forward(params, batch, cfg: SchNetConfig, rules=None):
    g = _Graph(batch, rules, True)
    b = g.b
    z = b["node_type"]
    src, dst = b["edge_src"], b["edge_dst"]
    emask = b["edge_mask"].to(cfg.dtype)
    n = g.n
    params = g.params(params)
    x = gather(params["embed"], RowIndex(z, cfg.n_atom_types))
    rbf = rbf_expand(b["edge_dist"], cfg.n_rbf, cfg.cutoff).to(cfg.dtype)

    for p in _unstack(params["inter"], cfg.n_interactions):
        w = _mlp(p["filter"], rbf, act=_ssp, final_act=True)   # [E, h]
        h = x @ p["in_lin"]
        m = g.rows(h, src, n) * w * emask[:, None]
        agg = g.sum_to(m, dst, n)
        m2 = g.rows(h, dst, n) * w * emask[:, None]
        agg = agg + g.sum_to(m2, src, n)
        v = _mlp(p["out"], agg, act=_ssp)
        x = x + v
    atom_e = _mlp(params["head"], x, act=_ssp)[:, 0]           # [N]
    atom_e = atom_e * b["node_mask"]
    return g.total(segment_sum(atom_e, RowIndex(b["graph_ids"],
                                                batch["n_graphs"])))


def schnet_loss(params, batch, cfg: SchNetConfig, rules=None):
    e = schnet_forward(params, batch, cfg, rules).float()
    labels = batch["labels"]
    if hasattr(labels, "to_local"):
        labels = labels.to_local()
    return torch.mean((e - labels) ** 2)


# ===========================================================================
# DimeNet — n_blocks=6, hidden=128, bilinear=8, spherical=7, radial=6
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class DimeNetConfig:
    name: str = "dimenet"
    n_blocks: int = 6
    d_hidden: int = 128
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    cutoff: float = 5.0
    n_atom_types: int = 100
    dtype: Any = torch.float32
    # DimeNet++-style bottleneck (arXiv:2011.14115): messages are
    # down-projected before the triplet gather; gather_dtype (e.g. bf16)
    # is the dtype the gathered messages travel in
    triplet_bottleneck: Optional[int] = None
    gather_dtype: Any = None

    def __post_init__(self):
        _cfg_dtypes(self, "dtype", "gather_dtype")

    @property
    def sbf_dim(self):
        return self.n_spherical * self.n_radial

    @property
    def d_triplet(self):
        return self.triplet_bottleneck or self.d_hidden


def dimenet_init(cfg: DimeNetConfig, gen: Optional[torch.Generator] = None,
                 device="cuda"):
    h, ht, dt = cfg.d_hidden, cfg.d_triplet, cfg.dtype

    def block():
        p = {
            "rbf_lin": _dense_init(gen, cfg.n_radial, h, dt, device),
            "sbf_lin": _dense_init(gen, cfg.sbf_dim, cfg.n_bilinear, dt,
                                   device),
            "bilinear": (_randn(gen, (ht, cfg.n_bilinear, ht), device)
                         / ht).to(dt),
            "msg_mlp": _mlp_params(gen, [h, h, h], dt, device),
            "out_mlp": _mlp_params(gen, [h, h], dt, device),
        }
        if cfg.triplet_bottleneck:
            p["down"] = _dense_init(gen, h, ht, dt, device)
            p["up"] = _dense_init(gen, ht, h, dt, device)
        return p

    return {
        "embed": (_randn(gen, (cfg.n_atom_types, h), device) * 0.1).to(dt),
        "edge_embed": _mlp_params(gen, [2 * h + cfg.n_radial, h], dt, device),
        "blocks": _stack([block() for _ in range(cfg.n_blocks)]),
        "head": _mlp_params(gen, [h, h // 2, 1], dt, device),
    }


def _triplet_bilinear(mk, bilinear, sw):
    """einsum("th,hbi,tb->ti"): the messages through the bilinear layer
    ([T, nb·ht], one matmul), then each triplet's nb rows weighted by its
    angle basis (a batched [1, nb] @ [nb, ht])."""
    T, ht = mk.shape
    nb = bilinear.shape[1]
    u = (mk @ bilinear.reshape(ht, nb * ht)).view(T, nb, ht)
    return torch.bmm(sw[:, None, :], u)[:, 0]


def dimenet_forward(params, batch, cfg: DimeNetConfig, rules=None):
    """Directional message passing: messages live on DIRECTED edges j→i;
    triplets (k→j, j→i) couple via the spherical basis and a bilinear
    layer."""
    g = _Graph(batch, rules, True)
    b = g.b
    z = b["node_type"]
    src, dst = b["edge_src"], b["edge_dst"]      # directed j→i
    emask = b["edge_mask"].to(cfg.dtype)
    tmask = b["tri_mask"].to(cfg.dtype)
    sbf = b["tri_sbf"].to(cfg.dtype)                 # [T, sbf_dim]
    n, E = g.n, g.e
    params = g.params(params)

    x = gather(params["embed"], RowIndex(z, cfg.n_atom_types))
    rbf = rbf_expand(b["edge_dist"], cfg.n_radial, cfg.cutoff).to(cfg.dtype)
    m = _mlp(params["edge_embed"],
             torch.cat([g.rows(x, src, n), g.rows(x, dst, n), rbf], dim=-1),
             act=_ssp, final_act=True)                   # [E, h]
    m = m * emask[:, None]

    for p in _unstack(params["blocks"], cfg.n_blocks):
        rbf_w = rbf @ p["rbf_lin"]                       # [E, h]
        m_rbf = m * rbf_w
        if cfg.triplet_bottleneck:
            m_rbf = m_rbf @ p["down"]                    # [E, ht] bottleneck
        if cfg.gather_dtype is not None:
            m_rbf = m_rbf.to(cfg.gather_dtype)
        # triplet interaction: gather m on k→j edges, couple with angle basis
        mk = g.rows(m_rbf, b["tri_kj"], E).to(cfg.dtype)    # [T, ht]
        sw = sbf @ p["sbf_lin"]                          # [T, nb]
        t = _triplet_bilinear(mk, p["bilinear"], sw)
        t = t * tmask[:, None]
        agg = g.sum_to(t, b["tri_ji"], E)
        if cfg.triplet_bottleneck:
            agg = agg @ p["up"]                          # [E, h]
        m2 = _mlp(p["msg_mlp"], m + agg, act=_ssp, final_act=True)
        m2 = _mlp(p["out_mlp"], m2, act=_ssp) + m        # residual
        m = m2 * emask[:, None]

    node_e = g.sum_to(m, dst, n)
    atom_e = _mlp(params["head"], node_e, act=_ssp)[:, 0] * b["node_mask"]
    return g.total(segment_sum(atom_e, RowIndex(b["graph_ids"],
                                                batch["n_graphs"])))


def dimenet_loss(params, batch, cfg: DimeNetConfig, rules=None):
    e = dimenet_forward(params, batch, cfg, rules).float()
    labels = batch["labels"]
    if hasattr(labels, "to_local"):
        labels = labels.to_local()
    return torch.mean((e - labels) ** 2)


# ===========================================================================
# MeshGraphNet — n_layers=15, hidden=128, sum agg, 2-layer MLPs + LayerNorm
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class MeshGraphNetConfig:
    name: str = "meshgraphnet"
    n_layers: int = 15
    d_hidden: int = 128
    mlp_layers: int = 2
    in_node_dim: int = 12
    in_edge_dim: int = 7
    out_dim: int = 3
    dtype: Any = torch.float32

    def __post_init__(self):
        _cfg_dtypes(self, "dtype")


def _ln_mlp_params(gen, dims, dtype, device):
    p = _mlp_params(gen, dims, dtype, device)
    p["ln_scale"] = torch.ones((dims[-1],), dtype=dtype, device=device)
    p["ln_bias"] = torch.zeros((dims[-1],), dtype=dtype, device=device)
    return p


def _ln_mlp(p, x):
    y = _mlp(p, x, act=torch.relu)
    return _layer_norm(y, p["ln_scale"], p["ln_bias"])


def mgn_init(cfg: MeshGraphNetConfig, gen: Optional[torch.Generator] = None,
             device="cuda"):
    h = cfg.d_hidden
    dims = [h] * (cfg.mlp_layers + 1)

    def proc():
        return {"edge": _ln_mlp_params(gen, [3 * h] + dims[1:], cfg.dtype,
                                       device),
                "node": _ln_mlp_params(gen, [2 * h] + dims[1:], cfg.dtype,
                                       device)}

    return {
        "node_enc": _ln_mlp_params(gen, [cfg.in_node_dim] + dims[1:],
                                   cfg.dtype, device),
        "edge_enc": _ln_mlp_params(gen, [cfg.in_edge_dim] + dims[1:],
                                   cfg.dtype, device),
        "proc": _stack([proc() for _ in range(cfg.n_layers)]),
        "dec": _mlp_params(gen, dims[:-1] + [cfg.out_dim], cfg.dtype, device),
    }


def _mgn(params, g: _Graph, cfg: MeshGraphNetConfig):
    b = g.b
    src, dst = b["edge_src"], b["edge_dst"]
    emask = b["edge_mask"].to(cfg.dtype)[:, None]
    n = g.n
    params = g.params(params)
    x = _ln_mlp(params["node_enc"], b["node_feat"].to(cfg.dtype))
    e = _ln_mlp(params["edge_enc"], b["edge_feat"].to(cfg.dtype))
    e = e * emask

    for p in _unstack(params["proc"], cfg.n_layers):
        e2 = _ln_mlp(p["edge"], torch.cat([e, g.rows(x, src, n),
                                           g.rows(x, dst, n)], dim=-1))
        e2 = (e + e2) * emask
        agg = g.sum_to(e2, dst, n)
        x2 = _ln_mlp(p["node"], torch.cat([x, agg], dim=-1))
        x = x + x2
        e = e2
    return _mlp(params["dec"], x)


def mgn_forward(params, batch, cfg: MeshGraphNetConfig, rules=None):
    """Per-node outputs (on a mesh: this rank's block of the nodes)."""
    return _mgn(params, _Graph(batch, rules, False), cfg)


def mgn_loss(params, batch, cfg: MeshGraphNetConfig, rules=None):
    g = _Graph(batch, rules, False)
    out = _mgn(params, g, cfg).float()
    mask = g.b["node_mask"][:, None]
    return g.total((((out - g.b["labels"]) ** 2) * mask).sum()) / \
        torch.clamp(g.total(mask.sum()) * out.shape[-1], min=1.0)


# ===========================================================================
# By arch id
# ===========================================================================

INITS = {"gcn-cora": gcn_init, "schnet": schnet_init,
         "dimenet": dimenet_init, "meshgraphnet": mgn_init}
LOSSES = {"gcn-cora": gcn_loss, "schnet": schnet_loss,
          "dimenet": dimenet_loss, "meshgraphnet": mgn_loss}


def params_from_numpy(arch: str, tree, cfg, device="cuda"):
    """The reference's parameter pytree of ``arch`` (numpy arrays) as the
    port's, on ``device`` in ``cfg.dtype``."""
    return tree_from_numpy(tree, INITS[arch](cfg, None, "meta"), device)
