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

``rules``: None or ``sharding.no_sharding()`` change nothing; rules on a
mesh raise (``gnn_rules`` comes with ROADMAP queue 1, item 7, "Dry runs").
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from ..train.checkpoint import tree_from_numpy
from .layers import RowIndex, gather, mlp, segment_sum
from .sharding import require_no_mesh
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


def gcn_forward(params, batch, cfg: GCNConfig, rules=None):
    require_no_mesh(rules, "gnn")
    x = batch["node_feat"].to(cfg.dtype)
    src, dst = batch["edge_src"], batch["edge_dst"]
    emask = batch["edge_mask"]
    n = x.shape[0]
    by_src, by_dst = RowIndex(src, n), RowIndex(dst, n)
    # symmetric normalization with self-loops: Â = D^-1/2 (A + I) D^-1/2
    deg = segment_sum(emask, by_src)
    deg = deg + segment_sum(emask, by_dst) + 1.0
    dn = torch.rsqrt(deg)
    coef = (gather(dn, by_src) * gather(dn, by_dst) * emask).to(cfg.dtype)

    ws = params["w"]
    for i, w in enumerate(ws):
        h = x @ w
        m_fwd = segment_sum(coef[:, None] * gather(h, by_src), by_dst)
        m_bwd = segment_sum(coef[:, None] * gather(h, by_dst), by_src)
        x = m_fwd + m_bwd + dn[:, None] ** 2 * h      # self loop
        if i < len(ws) - 1:
            x = torch.relu(x)
    return x


def gcn_loss(params, batch, cfg: GCNConfig, rules=None):
    logits = gcn_forward(params, batch, cfg, rules).float()
    labels = batch["labels"].long()
    mask = batch["node_mask"]
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[:, None])[:, 0]
    return ((lse - ll) * mask).sum() / torch.clamp(mask.sum(), min=1.0)


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
    require_no_mesh(rules, "gnn")
    z = batch["node_type"]
    src, dst = batch["edge_src"], batch["edge_dst"]
    emask = batch["edge_mask"].to(cfg.dtype)
    n = z.shape[0]
    by_src, by_dst = RowIndex(src, n), RowIndex(dst, n)
    x = gather(params["embed"], RowIndex(z, cfg.n_atom_types))
    rbf = rbf_expand(batch["edge_dist"], cfg.n_rbf, cfg.cutoff).to(cfg.dtype)

    for p in _unstack(params["inter"], cfg.n_interactions):
        w = _mlp(p["filter"], rbf, act=_ssp, final_act=True)   # [E, h]
        h = x @ p["in_lin"]
        m = gather(h, by_src) * w * emask[:, None]
        agg = segment_sum(m, by_dst)
        m2 = gather(h, by_dst) * w * emask[:, None]
        agg = agg + segment_sum(m2, by_src)
        v = _mlp(p["out"], agg, act=_ssp)
        x = x + v
    atom_e = _mlp(params["head"], x, act=_ssp)[:, 0]           # [N]
    atom_e = atom_e * batch["node_mask"]
    return segment_sum(atom_e, RowIndex(batch["graph_ids"],
                                        batch["n_graphs"]))


def schnet_loss(params, batch, cfg: SchNetConfig, rules=None):
    e = schnet_forward(params, batch, cfg, rules).float()
    return torch.mean((e - batch["labels"]) ** 2)


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
    require_no_mesh(rules, "gnn")
    z = batch["node_type"]
    src, dst = batch["edge_src"], batch["edge_dst"]      # directed j→i
    emask = batch["edge_mask"].to(cfg.dtype)
    tmask = batch["tri_mask"].to(cfg.dtype)
    sbf = batch["tri_sbf"].to(cfg.dtype)                 # [T, sbf_dim]
    n = z.shape[0]
    E = src.shape[0]
    by_src, by_dst = RowIndex(src, n), RowIndex(dst, n)
    by_kj, by_ji = RowIndex(batch["tri_kj"], E), RowIndex(batch["tri_ji"], E)

    x = gather(params["embed"], RowIndex(z, cfg.n_atom_types))
    rbf = rbf_expand(batch["edge_dist"], cfg.n_radial, cfg.cutoff).to(cfg.dtype)
    m = _mlp(params["edge_embed"],
             torch.cat([gather(x, by_src), gather(x, by_dst), rbf], dim=-1),
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
        mk = gather(m_rbf, by_kj).to(cfg.dtype)          # [T, ht]
        sw = sbf @ p["sbf_lin"]                          # [T, nb]
        t = _triplet_bilinear(mk, p["bilinear"], sw)
        t = t * tmask[:, None]
        agg = segment_sum(t, by_ji)
        if cfg.triplet_bottleneck:
            agg = agg @ p["up"]                          # [E, h]
        m2 = _mlp(p["msg_mlp"], m + agg, act=_ssp, final_act=True)
        m2 = _mlp(p["out_mlp"], m2, act=_ssp) + m        # residual
        m = m2 * emask[:, None]

    node_e = segment_sum(m, by_dst)
    atom_e = _mlp(params["head"], node_e, act=_ssp)[:, 0] * batch["node_mask"]
    return segment_sum(atom_e, RowIndex(batch["graph_ids"],
                                        batch["n_graphs"]))


def dimenet_loss(params, batch, cfg: DimeNetConfig, rules=None):
    e = dimenet_forward(params, batch, cfg, rules).float()
    return torch.mean((e - batch["labels"]) ** 2)


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


def mgn_forward(params, batch, cfg: MeshGraphNetConfig, rules=None):
    require_no_mesh(rules, "gnn")
    src, dst = batch["edge_src"], batch["edge_dst"]
    emask = batch["edge_mask"].to(cfg.dtype)[:, None]
    n = batch["node_feat"].shape[0]
    by_src, by_dst = RowIndex(src, n), RowIndex(dst, n)
    x = _ln_mlp(params["node_enc"], batch["node_feat"].to(cfg.dtype))
    e = _ln_mlp(params["edge_enc"], batch["edge_feat"].to(cfg.dtype))
    e = e * emask

    for p in _unstack(params["proc"], cfg.n_layers):
        e2 = _ln_mlp(p["edge"], torch.cat([e, gather(x, by_src),
                                           gather(x, by_dst)], dim=-1))
        e2 = (e + e2) * emask
        agg = segment_sum(e2, by_dst)
        x2 = _ln_mlp(p["node"], torch.cat([x, agg], dim=-1))
        x = x + x2
        e = e2
    return _mlp(params["dec"], x)


def mgn_loss(params, batch, cfg: MeshGraphNetConfig, rules=None):
    out = mgn_forward(params, batch, cfg, rules).float()
    mask = batch["node_mask"][:, None]
    return (((out - batch["labels"]) ** 2) * mask).sum() / \
        torch.clamp(mask.sum() * out.shape[-1], min=1.0)


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
