"""Dry-run programs: (arch × shape-cell × mesh) → a planning run.

The port of ``repro/launch/cells.py``.  Every cell of the registry resolves
here to a concrete program:

  LM    train_4k     → full train step (fwd + bwd + AdamW update)
        prefill_32k  → prefill (logits + KV-cache fill), attention through
                       the ``flash_fwd`` kernel on its full-attention layers
        decode_32k   → one decode step against a 32k cache (updated in place)
        long_500k    → decode step, batch 1, 524k cache sharded over seq
  GNN   *            → full train step on the cell-sized graph batch
  DIN   train_batch  → train step;  serve_* → scoring;  retrieval_cand →
                       1-user × 1M-candidate scoring
  PIRMCut road_*/grid_* → the sharded IRLS(T)×PCG(K) solver over the
                       flattened mesh (halo schedule)

Arguments are fake tensors (``FakeTensorMode``: nothing is allocated) of
the reference's global shapes and dtypes; a sharded leaf is a DTensor over
the mesh whose local block is this rank's (rank 0 of a fake world, see
``launch.mesh``), a replicated one a tensor every rank holds whole.  Dims
that don't divide the mesh are padded UP to the next multiple (recorded in
``meta["padded_cell"]``), as a production launcher would pad the batch or
graph.  ``DryRunProgram.lower()`` is the planning run
(``launch.hlo_analysis.analyze``): the program on rank 0's blocks under the
op walker.  ``donate_argnums`` names the arguments the program updates in
place (the train step's parameters and moments, decode's cache).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..configs import registry
from ..models import gnn as gnn_m
from ..models import recsys as din_m
from ..models import transformer as tr
# local_shape: a leaf's block on one rank, as the layout tests read it
from ..models.sharding import (ShardingRules, abstract_leaf as _leaf,  # noqa: F401
                               lm_rules, local_shape)
from ..train.optimizer import AdamWConfig


@dataclasses.dataclass
class DryRunProgram:
    arch: str
    cell: str
    fn: Callable
    args: Tuple
    in_shardings: Any          # per argument leaf: (mesh, placements) or None
    out_shardings: Any         # per output leaf, as in_shardings
    out_shapes: Any            # per output leaf: (global shape, dtype)
    donate_argnums: Tuple[int, ...]
    meta: Dict[str, Any]
    fake_mode: Any
    mesh: Any
    solver: Any = None         # the ShardedSolver of a solver cell

    def lower(self):
        """The planning run (``hlo_analysis.Plan``)."""
        from .hlo_analysis import analyze

        if self.solver is not None:
            return self.solver.lower()
        return analyze(self.fn, self.args, self.fake_mode, mesh=self.mesh,
                       donate_argnums=self.donate_argnums)


def _pad_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def _mesh_size(mesh) -> int:
    return math.prod(tuple(mesh.shape))


def _device(mesh) -> torch.device:
    return torch.device(mesh.device_type)


def _abstract(shapes, shardings, device):
    """Fake leaves of a tree of (shape, dtype) with its tree of shardings
    (a None sharding tree: every leaf replicated)."""
    if isinstance(shapes, dict):
        return {k: _abstract(v, None if shardings is None else shardings[k],
                             device) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_abstract(v, None if shardings is None else shardings[i],
                          device) for i, v in enumerate(shapes)]
    shape, dtype = shapes
    return _leaf(shape, tr.as_torch_dtype(dtype), shardings, device)


def _shapes_of(tree):
    """A tree of tensors as a tree of (shape, dtype)."""
    if isinstance(tree, dict):
        return {k: _shapes_of(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes_of(v) for v in tree]
    return (tuple(tree.shape), tree.dtype)


def _tree_of(tree, value):
    if isinstance(tree, dict):
        return {k: _tree_of(v, value) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_of(v, value) for v in tree]
    return value


def _metrics_out():
    """The train step's metrics: three replicated float32 scalars."""
    shapes = {"loss": ((), torch.float32), "grad_norm": ((), torch.float32),
              "lr": ((), torch.float32)}
    return shapes, _tree_of(shapes, None)


def _opt(opt_cfg, pshapes, psh):
    """The optimizer state's (shapes, shardings): moments as the
    parameters, the count a replicated int32 scalar."""
    mshapes = _tree_map_shapes(pshapes, opt_cfg.moments_dtype)
    return ({"m": mshapes, "v": mshapes, "count": ((), torch.int32)},
            {"m": psh, "v": psh, "count": None})


def _tree_map_shapes(shapes, dtype):
    if isinstance(shapes, dict):
        return {k: _tree_map_shapes(v, dtype) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_tree_map_shapes(v, dtype) for v in shapes]
    return (shapes[0], dtype)


def _fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode

    return FakeTensorMode()


# ---------------------------------------------------------------------------
# rules per family
# ---------------------------------------------------------------------------

def gnn_rules(mesh) -> ShardingRules:
    axes = tuple(a for a in ("pod", "data", "model")
                 if mesh is not None and a in mesh.mesh_dim_names)
    return ShardingRules(mesh=mesh, rules={
        "nodes": axes, "edges": axes, "triplets": axes,
        "fsdp": None,
    })


def din_rules(mesh) -> ShardingRules:
    data_axes = tuple(a for a in ("pod", "data")
                      if mesh is not None and a in mesh.mesh_dim_names)
    all_axes = tuple(a for a in ("pod", "data", "model")
                     if mesh is not None and a in mesh.mesh_dim_names)
    return ShardingRules(mesh=mesh, rules={
        "batch": data_axes, "rows": "model", "candidates": all_axes,
    })


# ---------------------------------------------------------------------------
# MODEL_FLOPS (analytic "useful work" for the roofline ratio)
# ---------------------------------------------------------------------------

def lm_model_flops(cfg: tr.LMConfig, cell: dict) -> float:
    n_act = cfg.active_param_count()
    B, S = cell["global_batch"], cell["seq_len"]
    kinds = cfg.layer_kinds()
    H, Dh = cfg.n_heads, cfg.d_head
    if cell["kind"] == "train":
        flops = 6.0 * n_act * B * S
        for k in kinds:                      # causal attention term (fwd+bwd)
            ctx = min(cfg.window, S) if (k == "L" and cfg.window) else S
            flops += 3.0 * B * S * (ctx / (1 if k == "L" and cfg.window else 2)) \
                * 4 * H * Dh
        return flops
    if cell["kind"] == "prefill":
        flops = 2.0 * n_act * B * S
        for k in kinds:
            ctx = min(cfg.window, S) if (k == "L" and cfg.window) else S
            flops += B * S * (ctx / (1 if k == "L" and cfg.window else 2)) \
                * 4 * H * Dh
        return flops
    # decode: one token/step
    flops = 2.0 * n_act * B
    for k in kinds:
        ctx = min(cfg.window, S) if (k == "L" and cfg.window) else S
        flops += 4.0 * B * ctx * H * Dh
    return flops


def gnn_model_flops(arch: str, cfg, cell: dict) -> float:
    n, e = cell["n_nodes"], cell["n_edges"]
    if arch == "gcn-cora":
        f = 2.0 * n * (cfg.in_dim * cfg.d_hidden + cfg.d_hidden * cfg.n_classes)
        f += 2.0 * 2 * e * (cfg.d_hidden + cfg.n_classes)
    elif arch == "schnet":
        h, r = cfg.d_hidden, cfg.n_rbf
        per = e * 2 * (r * h + h * h) + n * 2 * (2 * h * h) + 2 * e * h * 2
        f = cfg.n_interactions * per + n * 2 * (h * h // 2)
    elif arch == "dimenet":
        h, nb = cfg.d_hidden, cfg.n_bilinear
        T = cell["n_triplets"]
        per = (e * 2 * (cfg.n_radial * h + 3 * h * h)
               + T * 2 * (cfg.sbf_dim * nb + h * nb * h))
        f = cfg.n_blocks * per + e * 2 * h * h
    else:  # meshgraphnet
        h = cfg.d_hidden
        per = e * 2 * (3 * h * h + h * h) + n * 2 * (2 * h * h + h * h)
        f = cfg.n_layers * per + n * 2 * (cell["d_feat"] * h) + e * 2 * (7 * h)
    return 3.0 * f  # train: fwd + bwd


def din_model_flops(cfg, cell: dict) -> float:
    d2 = 4 * cfg.embed_dim
    att = cfg.seq_len * 2 * (2 * d2 * cfg.attn_mlp[0]
                             + cfg.attn_mlp[0] * cfg.attn_mlp[1]
                             + cfg.attn_mlp[1])
    head = 2 * ((2 * d2 // 2 + cfg.embed_dim) * cfg.mlp[0]
                + cfg.mlp[0] * cfg.mlp[1] + cfg.mlp[1])
    per_ex = att + head
    if cell["kind"] == "train":
        return 3.0 * cell["batch"] * per_ex
    if cell["kind"] == "retrieval":
        return float(cell["n_candidates"]) * per_ex
    return float(cell["batch"]) * per_ex


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

def _opt_cfg_for(cfg: tr.LMConfig) -> AdamWConfig:
    # llama4's 770B-param stack keeps moments in bf16 (memory table in
    # DESIGN.md); everything else holds f32 moments.
    big = cfg.param_count() > 3e11
    return AdamWConfig(moments_dtype=torch.bfloat16 if big else torch.float32)


def build_lm_cell(arch: str, cell_id: str, mesh, cfg=None,
                  cell: Optional[dict] = None) -> DryRunProgram:
    """``cfg`` and ``cell`` replace the registry's config and shape cell
    (a reduced or cut plan)."""
    from ..train.train_step import build_train_step

    entry = registry.get(arch)
    cfg = cfg or entry.make_config()
    cell = dict(cell or entry.shapes[cell_id])
    rules = lm_rules(mesh)
    B = cell["global_batch"]
    S = cell["seq_len"]
    dev = _device(mesh)
    mode = _fake_mode()
    pshapes = tr.param_shapes(cfg)
    psh = tr.param_shardings(cfg, rules)
    meta = dict(kind=cell["kind"], global_batch=B, seq_len=S,
                params=cfg.param_count(), active_params=cfg.active_param_count(),
                model_flops=lm_model_flops(cfg, cell))
    tok_sh = rules.named_sharding("batch", None, shape=(B, S))
    logits_out = ((B, cfg.vocab), torch.float32)
    logits_sh = rules.named_sharding("batch", "vocab", shape=(B, cfg.vocab))

    if cell["kind"] == "train":
        opt_cfg = _opt_cfg_for(cfg)
        oshapes, osh = _opt(opt_cfg, pshapes, psh)
        with mode:
            params = _abstract(pshapes, psh, dev)
            opt = _abstract(oshapes, osh, dev)
            toks = _leaf((B, S), torch.int32, tok_sh, dev)
        step = build_train_step(lambda p, b: tr.lm_loss(p, b, cfg, rules),
                                opt_cfg)
        mshapes, msh = _metrics_out()
        return DryRunProgram(
            arch, cell_id, step, (params, opt, toks),
            in_shardings=(psh, osh, tok_sh),
            out_shardings=(psh, osh, msh),
            out_shapes=(pshapes, oshapes, mshapes),
            donate_argnums=(0, 1), meta=meta, fake_mode=mode, mesh=mesh)

    cshapes = tr.cache_shapes(cfg, B, S)
    csh = tr.cache_shardings(cfg, B, S, rules)
    if cell["kind"] == "prefill":
        kcfg = dataclasses.replace(cfg, use_pallas_attention=True)
        with mode:
            params = _abstract(pshapes, psh, dev)
            toks = _leaf((B, S), torch.int32, tok_sh, dev)

        def fn(p, t):
            with torch.no_grad():
                return tr.prefill(p, t, kcfg, rules)
        return DryRunProgram(
            arch, cell_id, fn, (params, toks),
            in_shardings=(psh, tok_sh), out_shardings=(logits_sh, csh),
            out_shapes=(logits_out, cshapes),
            donate_argnums=(), meta=meta, fake_mode=mode, mesh=mesh)

    # decode: one step at the cache's last position
    tok1_sh = rules.named_sharding("batch", shape=(B,))
    with mode:
        params = _abstract(pshapes, psh, dev)
        cache = tr.abstract_cache(cfg, B, S, csh, dev)
        toks = _leaf((B,), torch.int32, tok1_sh, dev)

    def fn(p, c, t, i):
        with torch.no_grad():
            return tr.decode_step(p, c, t, i, cfg, rules)
    return DryRunProgram(
        arch, cell_id, fn, (params, cache, toks, S - 1),
        in_shardings=(psh, csh, tok1_sh, None),
        out_shardings=(logits_sh, csh), out_shapes=(logits_out, cshapes),
        donate_argnums=(1,), meta=meta, fake_mode=mode, mesh=mesh)


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------

_GNN_LEAD = {"edge_src": "edges", "edge_dst": "edges", "edge_mask": "edges",
             "edge_dist": "edges", "edge_feat": "edges",
             "tri_kj": "triplets", "tri_ji": "triplets",
             "tri_mask": "triplets", "tri_sbf": "triplets"}


def build_gnn_cell(arch: str, cell_id: str, mesh, cfg=None,
                   cell: Optional[dict] = None) -> DryRunProgram:
    from ..data.graphs import gnn_batch_shapes
    from ..train.train_step import build_train_step

    entry = registry.get(arch)
    cell = dict(cell or entry.shapes[cell_id])
    p = _mesh_size(mesh)
    # pad graph dims to mesh multiples (production padding, recorded)
    for k in ("n_nodes", "n_edges", "n_triplets"):
        cell[k] = _pad_up(cell[k], p) if cell.get(k) else cell.get(k, 0)
    cfg = cfg or entry.make_config(cell)
    rules = gnn_rules(mesh)
    dev = _device(mesh)
    mode = _fake_mode()

    shapes = gnn_batch_shapes(
        arch, cell["n_nodes"], cell["n_edges"], cell["d_feat"],
        n_triplets=cell.get("n_triplets", 0),
        n_graphs=cell.get("n_graphs", 1),
        **({"sbf_dim": cfg.sbf_dim} if arch == "dimenet" else {}),
        **({"out_dim": cfg.out_dim, "in_edge_dim": cfg.in_edge_dim}
           if arch == "meshgraphnet" else {}))
    bshapes = {k: (s, tr.as_torch_dtype(d)) for k, (s, d) in shapes.items()}

    def batch_sharding(name, shape):
        if name == "labels" and len(shape) == 1 and \
                shape[0] == cell.get("n_graphs"):
            return None
        lead = _GNN_LEAD.get(name, "nodes")
        return rules.named_sharding(lead, *(None,) * (len(shape) - 1),
                                    shape=shape)

    bsh = {k: batch_sharding(k, s) for k, (s, _) in bshapes.items()}
    pshapes = _shapes_of(gnn_m.INITS[arch](cfg, None, "meta"))
    psh = _tree_of(pshapes, None)          # GNN params are tiny: replicated
    opt_cfg = AdamWConfig()
    oshapes, osh = _opt(opt_cfg, pshapes, psh)
    with mode:
        params = _abstract(pshapes, psh, dev)
        opt = _abstract(oshapes, osh, dev)
        batch = _abstract(bshapes, bsh, dev)
    n_graphs = cell.get("n_graphs", 1)
    needs_graphs = arch in ("schnet", "dimenet")
    loss_fn = gnn_m.LOSSES[arch]

    def loss(params, batch):
        b = dict(batch, n_graphs=n_graphs) if needs_graphs else batch
        return loss_fn(params, b, cfg, rules)

    step = build_train_step(loss, opt_cfg)
    mshapes, msh = _metrics_out()
    meta = dict(kind="train", model_flops=gnn_model_flops(arch, cfg, cell),
                padded_cell=cell)
    return DryRunProgram(
        arch, cell_id, step, (params, opt, batch),
        in_shardings=(psh, osh, bsh), out_shardings=(psh, osh, msh),
        out_shapes=(pshapes, oshapes, mshapes),
        donate_argnums=(0, 1), meta=meta, fake_mode=mode, mesh=mesh)


# ---------------------------------------------------------------------------
# DIN cells
# ---------------------------------------------------------------------------

def build_din_cell(arch: str, cell_id: str, mesh, cfg=None,
                   cell: Optional[dict] = None) -> DryRunProgram:
    from ..data.recsys import din_batch_shapes, din_retrieval_shapes
    from ..train.train_step import build_train_step

    entry = registry.get(arch)
    cfg = cfg or entry.make_config()
    cell = dict(cell or entry.shapes[cell_id])
    rules = din_rules(mesh)
    p_all = _mesh_size(mesh)
    dev = _device(mesh)
    mode = _fake_mode()

    pshapes = _shapes_of(din_m.din_init(cfg, None, "meta"))
    psh = {k: (rules.named_sharding("rows", None, shape=v[0])
               if k.endswith("_table") else _tree_of(v, None))
           for k, v in pshapes.items()}
    meta = dict(kind=cell["kind"], model_flops=din_model_flops(cfg, cell))

    def tshapes(shapes):
        return {k: (s, tr.as_torch_dtype(d)) for k, (s, d) in shapes.items()}

    if cell["kind"] == "retrieval":
        C = _pad_up(cell["n_candidates"], p_all)
        cell["n_candidates"] = C
        bshapes = tshapes(din_retrieval_shapes(C, cfg.seq_len,
                                               cfg.tag_bag_width))
        bsh = {k: (rules.named_sharding("candidates", shape=s)
                   if k.startswith("cand") else None)
               for k, (s, _) in bshapes.items()}
        with mode:
            params = _abstract(pshapes, psh, dev)
            batch = _abstract(bshapes, bsh, dev)

        def fn(p, b):
            with torch.no_grad():
                return din_m.din_retrieval_scores(p, b, cfg, rules)
        return DryRunProgram(
            arch, cell_id, fn, (params, batch), in_shardings=(psh, bsh),
            out_shardings=rules.named_sharding("candidates", shape=(C,)),
            out_shapes=((C,), torch.float32),
            donate_argnums=(), meta=meta, fake_mode=mode, mesh=mesh)

    B = cell["batch"]
    bshapes = tshapes(din_batch_shapes(B, cfg.seq_len, cfg.tag_bag_width,
                                       with_labels=cell["kind"] == "train"))
    bsh = {k: rules.named_sharding(*("batch",) + (None,) * (len(s) - 1),
                                   shape=s)
           for k, (s, _) in bshapes.items()}

    if cell["kind"] == "train":
        opt_cfg = AdamWConfig()
        oshapes, osh = _opt(opt_cfg, pshapes, psh)
        with mode:
            params = _abstract(pshapes, psh, dev)
            opt = _abstract(oshapes, osh, dev)
            batch = _abstract(bshapes, bsh, dev)
        step = build_train_step(
            lambda p, b: din_m.din_loss(p, b, cfg, rules), opt_cfg)
        mshapes, msh = _metrics_out()
        return DryRunProgram(
            arch, cell_id, step, (params, opt, batch),
            in_shardings=(psh, osh, bsh), out_shardings=(psh, osh, msh),
            out_shapes=(pshapes, oshapes, mshapes),
            donate_argnums=(0, 1), meta=meta, fake_mode=mode, mesh=mesh)

    with mode:
        params = _abstract(pshapes, psh, dev)
        batch = _abstract(bshapes, bsh, dev)

    def fn(p, b):
        with torch.no_grad():
            return din_m.din_logits(p, b, cfg, rules)
    return DryRunProgram(
        arch, cell_id, fn, (params, batch), in_shardings=(psh, bsh),
        out_shardings=rules.named_sharding("batch", shape=(B,)),
        out_shapes=((B,), torch.float32),
        donate_argnums=(), meta=meta, fake_mode=mode, mesh=mesh)


# ---------------------------------------------------------------------------
# PIRMCut solver cells (the paper's workload on the production mesh)
# ---------------------------------------------------------------------------

def solver_config(cfg=None):
    """The solver cells' config: the reference's (T = K = 50, block
    Jacobi), through the kernels (``use_pallas``) and on the unfused halo
    build the abstract plans describe."""
    from ..core.irls import IRLSConfig

    if cfg is None:
        cfg = IRLSConfig(n_irls=50, pcg_max_iters=50, precond="block_jacobi")
    return dataclasses.replace(cfg, use_pallas=True, fuse_edge_sweep=False)


def build_solver_cell(arch: str, cell_id: str, mesh, cfg=None,
                      cell: Optional[dict] = None) -> DryRunProgram:
    """The solver over the mesh flattened to one group of all its ranks
    (the default group of the fake world: ranks in the mesh's order)."""
    from ..distributed.solver import ShardedSolver, abstract_halo_plans

    entry = registry.get(arch)
    cell = dict(cell or entry.shapes[cell_id])
    p = _mesh_size(mesh)
    cfg = solver_config(cfg)
    dev = _device(mesh)
    mode = _fake_mode()
    with mode:
        plan, bplan = abstract_halo_plans(cell["n_nodes"], cell["n_edges"],
                                          p, cell["boundary_frac"],
                                          precond_bs=128, device=dev)
        solver = ShardedSolver(None, cfg, schedule="halo",
                               plans=(plan, bplan), device=dev)
    meta = dict(kind="solve", n_nodes=cell["n_nodes"], n_edges=cell["n_edges"],
                # per PCG iteration: SpMV touches each directed copy once
                # (8 flops: gather-sub-mul-acc) + axpys; × T·K iterations
                model_flops=cfg.n_irls * cfg.pcg_max_iters *
                (8.0 * 2 * cell["n_edges"] + 10.0 * cell["n_nodes"]))
    args = solver.abstract_inputs()
    return DryRunProgram(
        arch, cell_id, solver._body, args,
        in_shardings=tuple(None for _ in args), out_shardings=None,
        out_shapes=None, donate_argnums=(), meta=meta, fake_mode=mode,
        mesh=mesh, solver=solver)


def build_cell(arch: str, cell_id: str, mesh, cfg=None,
               cell: Optional[dict] = None) -> DryRunProgram:
    family = registry.get(arch).family
    if family == "lm":
        return build_lm_cell(arch, cell_id, mesh, cfg, cell)
    if family == "gnn":
        return build_gnn_cell(arch, cell_id, mesh, cfg, cell)
    if family == "recsys":
        return build_din_cell(arch, cell_id, mesh, cfg, cell)
    return build_solver_cell(arch, cell_id, mesh, cfg, cell)
