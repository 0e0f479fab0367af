"""The port's dry runs (``launch.cells``, ``launch.dryrun``, the planning
mesh, the solver's abstract plans) against the JAX package's.

Layout parity: every cell of every arch built by the port on a (2, 2)
mesh over a fake world of 4 ranks (in process) against the reference's
``build_cell`` on a (2, 2) mesh of 4 emulated XLA devices with
``AxisType.Auto`` axes (build only, in a subprocess), and one cell a family
on the production meshes (16, 16) and (2, 16, 16) against 512 emulated
devices: every argument leaf's global shape and dtype, every argument and
output leaf's local block (the reference's ``NamedSharding.shard_shape``),
``meta["padded_cell"]`` and ``model_flops``.  The solver cells' arguments
are the port's uploaded rows of the plan (int64 copies of some index rows
beside them), so theirs are compared as the plan arrays (global shapes and
dtypes) and each row's block.  Then planning runs of each family's reduced
config, the kernels under planning, the CLI in process and the production
meshes without ranks.
"""
import json
import tempfile
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests._torch_ranks import Job  # noqa: E402

from repro_torch.configs import registry  # noqa: E402

CELLS = [(a, c) for a, e in registry.ARCHS.items() for c in e.cells]
# one cell a family on the production meshes
PROD = [("qwen2-1.5b", "decode_32k"), ("gcn-cora", "ogb_products"),
        ("din", "retrieval_cand"), ("pirmcut", "road_asia")]
# the reference's plan arrays, in its ``ShardedSolver.arrays()`` order, and
# the port's uploaded row of each
SOLVER_ROWS = [("heads", "heads32"), ("tails_ext", "tails32"), ("c", "c"),
               ("c_s", "c_s"), ("c_t", "c_t"), ("export", "export"),
               ("node_valid", "valid"), ("copy_b", "copy_b"),
               ("copy_i", "copy_i"), ("copy_j", "copy_j"),
               ("copy_id", "copy_id"), ("copy_valid", "copy_valid"),
               ("node_b", "node_b"), ("node_s", "node_s")]

_REF = """
import jax
from jax.sharding import AxisType
from repro.configs import registry
from repro.launch.cells import build_cell


def walk(x, sh, path, out):
    if isinstance(x, dict):
        for k in sorted(x):
            walk(x[k], sh[k] if isinstance(sh, dict) else sh, path + [k], out)
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            walk(v, sh[i] if isinstance(sh, (list, tuple)) else sh,
                 path + [str(i)], out)
    else:
        out["/".join(path)] = [list(x.shape), str(x.dtype),
                               list(sh.shard_shape(x.shape))]


res = {}
for shape, axes in MESHES:
    n = int(np.prod(shape))
    mesh = jax.make_mesh(tuple(shape), tuple(axes),
                         axis_types=(AxisType.Auto,) * len(shape),
                         devices=jax.devices()[:n])
    for arch, cell in CELLS:
        prog = build_cell(arch, cell, mesh)
        args, outs = {}, {}
        walk(prog.args, prog.in_shardings, [], args)
        if registry.get(arch).family != "solver":
            walk(jax.eval_shape(prog.fn, *prog.args), prog.out_shardings,
                 [], outs)
        res[f"{shape}|{arch}|{cell}"] = dict(
            args=args, outs=outs,
            padded_cell=prog.meta.get("padded_cell"),
            model_flops=float(prog.meta["model_flops"]))
np.savez(OUT, res=np.array(json.dumps(res)))
"""


def _dt(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _walk(x, path, out):
    from torch.distributed.tensor import DTensor

    if isinstance(x, dict):
        for k in sorted(x):
            _walk(x[k], path + [k], out)
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            _walk(v, path + [str(i)], out)
    elif isinstance(x, int):                  # decode's host cache position
        out["/".join(path)] = [[], "int32", []]
    else:
        local = x.to_local().shape if isinstance(x, DTensor) else x.shape
        out["/".join(path)] = [list(x.shape), _dt(x.dtype), list(local)]


def _walk_out(shapes, shardings, path, out):
    from repro_torch.launch.cells import local_shape

    if isinstance(shapes, dict):
        for k in sorted(shapes):
            _walk_out(shapes[k], shardings[k] if isinstance(shardings, dict)
                      else shardings, path + [k], out)
    elif isinstance(shapes, (list, tuple)) and not (
            len(shapes) == 2 and isinstance(shapes[1], torch.dtype)):
        for i, v in enumerate(shapes):
            _walk_out(v, shardings[i] if isinstance(shardings, (list, tuple))
                      else shardings, path + [str(i)], out)
    else:
        shape, dtype = shapes
        out["/".join(path)] = [list(shape), _dt(dtype),
                               list(local_shape(shape, shardings))]


def _port_layout(prog):
    if prog.solver is not None:
        plan, bplan = prog.solver.plan, prog.solver.block_plan
        args = {}
        for i, (name, row) in enumerate(SOLVER_ROWS):
            a = getattr(plan, name) if hasattr(plan, name) \
                else getattr(bplan, name)
            args[str(i)] = [list(a.shape), _dt(a.dtype),
                            [1] + list(prog.solver._t[row].shape)]
        return args, {}
    args, outs = {}, {}
    _walk(prog.args, [], args)
    _walk_out(prog.out_shapes, prog.out_shardings, [], outs)
    return args, outs


def _ref_job(name, d, devices, cells, meshes):
    code = ("import json\n"
            f"CELLS = json.loads({json.dumps(cells)!r})\n"
            f"MESHES = json.loads({json.dumps(meshes)!r})\n") + _REF
    return Job(name, d, code, devices=devices, timeout=600)


@pytest.fixture(scope="module")
def reference():
    """The reference's layouts: (2, 2) for every cell, and the production
    meshes for ``PROD``, in two subprocesses."""
    with tempfile.TemporaryDirectory() as d:
        jobs = [_ref_job("small", d, 4, CELLS,
                         [[[2, 2], ["data", "model"]]]),
                _ref_job("prod", d, 512, PROD,
                         [[[16, 16], ["data", "model"]],
                          [[2, 16, 16], ["pod", "data", "model"]]])]
        try:
            res = {}
            for j in jobs:
                res.update(json.loads(str(j.result()["res"])))
            yield res
        finally:
            for j in jobs:
                j.kill()


@pytest.fixture(scope="module")
def port():
    """The port's layouts, on fake worlds in this process (released
    after)."""
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.mesh import make_plan_mesh, release_plan_world

    res = {}
    warnings.simplefilter("ignore")
    for shape, axes, cells in (((2, 2), ("data", "model"), CELLS),
                               ((16, 16), ("data", "model"), PROD),
                               ((2, 16, 16), ("pod", "data", "model"), PROD)):
        try:
            mesh = make_plan_mesh(shape, axes)
            for arch, cell in cells:
                prog = build_cell(arch, cell, mesh)
                args, outs = _port_layout(prog)
                res[f"{list(shape)}|{arch}|{cell}"] = json.loads(json.dumps(
                    dict(args=args, outs=outs,
                         padded_cell=prog.meta.get("padded_cell"),
                         model_flops=float(prog.meta["model_flops"]))))
        finally:
            release_plan_world()
    return res


def _same_layout(got, want):
    assert sorted(got["args"]) == sorted(want["args"])
    for k, w in want["args"].items():
        assert got["args"][k] == w, ("arg", k, got["args"][k], w)
    assert sorted(got["outs"]) == sorted(want["outs"])
    for k, w in want["outs"].items():
        assert got["outs"][k][0] == w[0] and got["outs"][k][2] == w[2], \
            ("out", k, got["outs"][k], w)
    assert got["padded_cell"] == want["padded_cell"]
    assert got["model_flops"] == pytest.approx(want["model_flops"],
                                               rel=1e-12)


@pytest.mark.parametrize("arch,cell", CELLS)
def test_cell_layout_matches_reference(reference, port, arch, cell):
    """(2, 2): every argument leaf's global shape, dtype and local block,
    every output leaf's shape and local block, the padded cell and the
    model flops (rel 1e-12: the same formula in float64)."""
    _same_layout(port[f"[2, 2]|{arch}|{cell}"],
                 reference[f"[2, 2]|{arch}|{cell}"])


@pytest.mark.parametrize("shape", [[16, 16], [2, 16, 16]])
@pytest.mark.parametrize("arch,cell", PROD)
def test_production_mesh_layout_matches_reference(reference, port, arch,
                                                  cell, shape):
    _same_layout(port[f"{shape}|{arch}|{cell}"],
                 reference[f"{shape}|{arch}|{cell}"])


@pytest.mark.parametrize("cell", ["road_asia", "road_euro", "grid_mri"])
def test_abstract_halo_plans_match_reference(cell):
    """The analytic plan of each solver cell at 256 shards: nl, ml, b_sh,
    nb, bs and every array's shape and dtype as the reference's."""
    from repro.configs.pirmcut import PIRMCUT_SHAPES
    from repro.distributed.solver import abstract_halo_plans as jplans

    from repro_torch.distributed.solver import abstract_halo_plans

    s = PIRMCUT_SHAPES[cell]
    args = (s["n_nodes"], s["n_edges"], 256, s["boundary_frac"])
    (jp, jb), (p, b) = jplans(*args, precond_bs=128), \
        abstract_halo_plans(*args, precond_bs=128)
    assert (p.n, p.nl, p.b_sh, p.p, b.nb, b.bs) == \
        (jp.n, jp.nl, jp.b_sh, jp.p, jb.nb, jb.bs)
    for ours, theirs in ((p, jp), (b, jb)):
        for name in theirs._fields:
            want = getattr(theirs, name)
            got = getattr(ours, name)
            if hasattr(want, "shape"):
                assert tuple(got.shape) == tuple(want.shape), name
                assert _dt(got.dtype) == str(want.dtype), name
                assert got.device.type in ("cpu", "cuda") and \
                    got.untyped_storage().nbytes() >= 0


@pytest.fixture
def plan_mesh():
    from repro_torch.launch.mesh import make_plan_mesh, release_plan_world

    warnings.simplefilter("ignore")
    try:
        yield make_plan_mesh((2, 2), ("data", "model"))
    finally:
        release_plan_world()


def _plan(mesh, arch, cell, cfg=None):
    from repro_torch.launch.cells import build_cell

    prog = build_cell(arch, "_", mesh, cfg or registry.get(arch).make_reduced(),
                      cell) if cell is not None else \
        build_cell(arch, "_", mesh)
    return prog, prog.lower()


def _ratio(prog, plan, n=4, less=0.0):
    return prog.meta["model_flops"] / (n * plan.costs.flops - less)


def test_planned_reduced_lm_train(plan_mesh):
    """The reduced qwen2 train step planned on (2, 2): its useful ratio in
    (0.3, 1] (a ratio above 1 means the walker misses work), the peak a
    rank above its arguments, no kernel launch (training attention is the
    plain flash path)."""
    prog, plan = _plan(plan_mesh, "qwen2-1.5b",
                       dict(kind="train", seq_len=64, global_batch=8))
    assert 0.3 < _ratio(prog, plan) <= 1.0
    m = plan.memory
    assert m["peak_estimate_bytes"] > m["argument_bytes"] > 0
    assert m["alias_bytes"] > 0 and plan.costs.kernel_launches == {}


@pytest.mark.parametrize("arch", ["gcn-cora", "schnet", "dimenet",
                                  "meshgraphnet"])
def test_planned_reduced_gnn_train(plan_mesh, arch):
    """Each reduced GNN's train step on ``REDUCED_CELL``: useful ratio in
    (0.3, 1].  GCN's formula counts the input gradient of its first layer
    (2·N·in·h), which no backward computes (the features are data), so that
    term comes off its model flops first."""
    from repro_torch.configs import gnn as gcfg

    cell = dict(gcfg.REDUCED_CELL)
    prog, plan = _plan(plan_mesh, arch, cell)
    mf = prog.meta["model_flops"]
    if arch == "gcn-cora":
        cfg = registry.get(arch).make_reduced()
        mf -= 2.0 * cell["n_nodes"] * cfg.in_dim * cfg.d_hidden
    assert 0.3 < mf / (4 * plan.costs.flops) <= 1.0


def test_planned_reduced_din(plan_mesh):
    """DIN's reduced train step and retrieval: useful ratio in (0.3, 1]."""
    for cell in (dict(kind="train", batch=64),
                 dict(kind="retrieval", batch=1, n_candidates=1000)):
        prog, plan = _plan(plan_mesh, "din", cell)
        assert 0.3 < _ratio(prog, plan) <= 1.0, cell


def test_planned_reduced_solver(plan_mesh):
    """The reduced solver config on a 4,000-node cell: ``edge_reweight``
    planned once per reweighted IRLS iteration, the census by scope, and
    the useful ratio in (0.3, 1] once the block-Jacobi factor and solves
    come off the walker's flops (the model flops count the SpMV and the
    vector updates only); with them it lies in (0, 1]."""
    cell = dict(kind="solve", n_nodes=4000, n_edges=8000,
                boundary_frac=0.02)
    prog, plan = _plan(plan_mesh, "pirmcut", cell)
    c = plan.costs
    assert c.kernel_launches == {"edge_reweight": 5}
    assert c.collective_counts["pcg_step/all_gather"] == 60
    precond = sum(v for k, v in c.flops_by_op.items()
                  if "cholesky" in k or "triangular" in k)
    assert 0.0 < _ratio(prog, plan) <= 1.0
    assert 0.3 < _ratio(prog, plan, less=4 * precond) <= 1.0


def test_solver_body_once_equals_the_whole_schedule(plan_mesh):
    """``lower``'s plan of T = 4 from 1 and 2 planned iterations equals the
    plan of all four: flops and bytes within rel 1e-12, every collective
    count and kernel launch exactly; ``compiled`` caches it."""
    import dataclasses

    from repro_torch.launch import hlo_analysis as ha

    cell = dict(kind="solve", n_nodes=2000, n_edges=4000,
                boundary_frac=0.02)
    cfg = dataclasses.replace(registry.get("pirmcut").make_reduced(),
                              n_irls=4, pcg_max_iters=3)
    prog, plan = _plan(plan_mesh, "pirmcut", cell, cfg)
    s = prog.solver
    whole = ha.analyze(s._body, s.abstract_inputs(), s._fake_mode(),
                       coll=s.coll)
    for name in ("flops", "hbm_bytes", "collective_bytes"):
        assert getattr(plan.costs, name) == pytest.approx(
            getattr(whole.costs, name), rel=1e-12)
    assert plan.costs.collective_counts == whole.costs.collective_counts
    assert plan.costs.kernel_launches == whole.costs.kernel_launches
    assert s.compiled() is s.compiled()
    assert all(a.shape == t.shape for a, t in zip(s.abstract_inputs(),
                                                  s._t.values()))


ADAPTIVE = dict(irls_tol=1e-3, adaptive_tol=True)
ROUTES = ["cell", "halo_fused", "psum"]


def _route_plan(mesh, route, extra):
    """(plan under ``extra``, T, K) of a route: ``cell`` is the reduced
    solver cell (the unfused halo build on abstract plans), the others a
    12×12 segmentation grid on the fake world of four."""
    import dataclasses

    from repro_torch.core import IRLSConfig
    from repro_torch.distributed.solver import ShardedSolver
    from repro_torch.graphs import generators as gen

    if route == "cell":
        cell = dict(kind="solve", n_nodes=2000, n_edges=4000,
                    boundary_frac=0.02)
        base = registry.get("pirmcut").make_reduced()
        cfg = dataclasses.replace(base, **extra)
        return _plan(mesh, "pirmcut", cell, cfg)[1], cfg.n_irls, \
            cfg.pcg_max_iters
    inst = gen.segmentation_instance(gen.grid_2d(12, 12, seed=1), (12, 12),
                                     seed=2)
    sched, fuse = {"halo_fused": ("halo", True), "psum": ("psum", True)}[route]
    cfg = IRLSConfig(n_irls=3, pcg_max_iters=4, eps=1e-3, use_pallas=True,
                     fuse_edge_sweep=fuse, **extra)
    plan = ShardedSolver(inst, cfg, schedule=sched, precond_bs=32,
                         device="cpu").lower()
    return plan, cfg.n_irls, cfg.pcg_max_iters


@pytest.fixture(scope="module")
def fixed_route_plans():
    """Each route's plan of the fixed schedule, on a fake world of its
    own."""
    from repro_torch.launch.mesh import make_plan_mesh, release_plan_world

    warnings.simplefilter("ignore")
    try:
        mesh = make_plan_mesh((2, 2), ("data", "model"))
        return {r: _route_plan(mesh, r, {})[0] for r in ROUTES}
    finally:
        release_plan_world()


@pytest.mark.parametrize("extra", [ADAPTIVE, dict(reweight_clamp=True),
                                   dict(ADAPTIVE, reweight_clamp=True)],
                         ids=["adaptive", "clamp", "adaptive_clamp"])
@pytest.mark.parametrize("route", ROUTES)
def test_planned_adaptive_and_clamped_solver(fixed_route_plans, plan_mesh,
                                             route, extra):
    """The adaptive schedule and the reweight clamp plan on both schedules
    (the solver cell through ``launch.cells``; a grid through ``lower``).
    An adaptive plan is an upper bound: every PCG takes its K steps of the
    masked loop ((T + 1)·K CG steps, each with the fixed plan's
    collectives; on halo ``dot2`` reduces the pair [r·z, r·r] where the
    fixed PCG reduces r·z, 4 bytes more), one kernel launch per reweighted
    iteration.  Against the fixed plan: on halo the fractional cut's
    all-reduce takes the place of the fixed PCG's last r·r (``dot2`` fuses
    it into the first r·z) and the last voltages' cut needs one more
    exchange; on psum (local dots) it is one more all-reduce a solve.  The
    clamp adds its cap's all-reduce once and its hit count's once a solve
    (each reweighted one on psum)."""
    fixed = fixed_route_plans[route]
    plan, T, K = _route_plan(plan_mesh, route, extra)
    adaptive, clamp = "irls_tol" in extra, "reweight_clamp" in extra
    kernel = "fused_ell_sweep" if route == "halo_fused" else "edge_reweight"
    assert fixed.bound == "exact"
    assert plan.bound == ("upper" if adaptive else "exact")
    assert plan.costs.kernel_launches == {kernel: T}
    solver, fsolver = plan.census["solver"], fixed.census["solver"]
    assert solver["pcg_steps"] == fsolver["pcg_steps"] == (T + 1) * K
    per, fper = dict(solver["per_pcg_step"]), dict(fsolver["per_pcg_step"])
    assert per.pop("bytes") == fper.pop("bytes") + 4 * (
        adaptive and route != "psum")
    assert per == fper
    got, want = plan.costs.collective_counts, fixed.costs.collective_counts
    if route == "psum":
        more = {"irls/all_reduce": (T + 1) * adaptive + T * clamp}
    else:
        more = {"irls/all_reduce": (T + 1) * clamp,
                "irls/all_gather": 1 * adaptive}
    more["setup/all_reduce"] = 1 * clamp
    for key in set(got) | set(want) | set(more):
        assert got.get(key, 0) == want.get(key, 0) + more.get(key, 0), key


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "gemma3-27b"])
def test_planned_prefill_counts_flash_fwd(plan_mesh, arch):
    """A planned prefill reaches ``ops.flash_fwd`` on fake tensors: one
    planned launch per full-attention layer (gemma3's local layers stay on
    the banded path), counted by the kernel's terms (flash_flops of the
    local heads), and nothing in ``ops.launches``."""
    from repro_torch.kernels import ops

    ops.reset_launches()
    prog, plan = _plan(plan_mesh, arch,
                       dict(kind="prefill", seq_len=64, global_batch=8))
    cfg = registry.get(arch).make_reduced()
    flash = sum(k == "G" for k in cfg.layer_kinds())
    assert 0 < flash < len(cfg.layer_kinds()) or arch == "qwen2-1.5b"
    assert plan.costs.kernel_launches == {"flash_fwd": flash}
    want = flash * ops.flash_flops(4 * cfg.n_heads // 2, 64, 64, cfg.d_head,
                                   True)
    assert plan.costs.kernel_flops["flash_fwd"] == want
    assert all(v == 0 for v in ops.launches.values())


def test_planned_long_context_decode_is_split_kv(plan_mesh):
    """Decode with a batch of 1 on (2, 2) (the caches' sequence over data,
    as ``long_500k``): each rank attends over its own cache block, so the
    data dim gathers what a batch of 2 gathers (the parameters) and no
    cache, and each layer all-reduces the softmax's max, its sum and the
    output over data, three calls a layer."""
    cfg = registry.get("qwen2-1.5b").make_reduced()
    census = {}
    for B in (1, 2):
        _, plan = _plan(plan_mesh, "qwen2-1.5b",
                        dict(kind="decode", seq_len=64, global_batch=B))
        census[B] = plan.census["models"]
    assert census[1]["all_gather[data]"] == census[2]["all_gather[data]"]
    assert census[1]["all_reduce[data]"]["calls"] == 3 * cfg.n_layers
    assert "all_reduce[data]" not in census[2]


def test_dryrun_cli_writes_a_record(tmp_path):
    """``launch.dryrun`` in process on one cell at the production mesh:
    its record has the reference's keys where they mean the same thing,
    ``n_ranks``, ``t_plan_s``, ``fits_h100`` and no ``xla_cost``."""
    from repro_torch.launch import dryrun

    warnings.simplefilter("ignore")
    assert dryrun.main(["--arch", "gcn-cora", "--cell", "molecule",
                        "--mesh", "single", "--out", str(tmp_path)]) == 0
    with open(tmp_path / "gcn-cora__molecule__single.json") as f:
        rec = json.load(f)
    for key in ("arch", "cell", "mesh", "n_ranks", "ok", "t_plan_s", "meta",
                "memory", "hlo_costs", "roofline", "fits_h100"):
        assert key in rec, key
    assert rec["ok"] and rec["n_ranks"] == 256 and "xla_cost" not in rec
    for key in ("argument_bytes", "output_bytes", "temp_bytes",
                "peak_estimate_bytes"):
        assert rec["memory"][key] >= 0
    peak = rec["memory"]["peak_estimate_bytes"]
    assert rec["memory"]["peak_with_margin_bytes"] == \
        int(peak * 1.035 + 2 * 2**30)
    for key in ("t_compute", "t_memory", "t_collective", "dominant",
                "model_flops", "useful_ratio"):
        assert key in rec["roofline"]
    assert rec["meta"]["padded_cell"]["n_nodes"] == 3840


@pytest.mark.parametrize("multi", [False, True])
def test_production_mesh_plans_without_ranks(multi):
    """``make_production_mesh(plan=True)`` with no group: a mesh of 256
    (512) ranks over a fake world in this process; without ``plan`` it
    still needs the real ranks."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import (make_production_mesh,
                                         release_plan_world)

    with pytest.raises(RuntimeError, match="needs 256 ranks"):
        make_production_mesh()
    try:
        mesh = make_production_mesh(multi_pod=multi, plan=True)
        assert dist.get_backend() == "fake"
        assert mesh.size() == (512 if multi else 256)
        assert tuple(mesh.mesh_dim_names) == \
            (("pod", "data", "model") if multi else ("data", "model"))
    finally:
        release_plan_world()
    assert not dist.is_initialized()
