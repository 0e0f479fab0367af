"""Multi-pod dry-run CLI: a planning run of every (arch × cell) against
the production mesh.

The port of ``repro/launch/dryrun.py``.  For every (architecture ×
input-shape) cell it builds the sharded program against the production
mesh — (16, 16) = 256 ranks single-pod (32 nodes of 8 H100s) and
(2, 16, 16) = 512 ranks multi-pod — over a fake process group in this one
process (``launch.mesh.make_production_mesh(plan=True)``), and runs rank
0's program once on fake tensors under the op walker
(``launch.hlo_analysis``): nothing is allocated and nothing launched, so
the run needs no card.  Records per cell (``--out``, one JSON a cell):

  · ``memory``: argument, output, alias and temp bytes and the peak a
    rank (the walker's live storages), and ``fits_h100`` (the peak with
    ``hlo_analysis.peak_with_margin``'s margin against the card's memory);
  · ``hlo_costs``: flops, HBM bytes and collective wire bytes a rank (by
    op and mesh dim), the planned kernel launches;
  · ``roofline``: the compute, memory and collective times a rank at the
    H100's datasheet rates, the dominant one, ``model_flops`` and
    ``useful_ratio`` (model flops over the walker's flops × ranks).

Usage:
  python -m repro_torch.launch.dryrun --arch all --mesh both --include-solver
  python -m repro_torch.launch.dryrun --arch din --cell train_batch --mesh single

More than one cell re-execs one subprocess per cell (up to four at once,
each one's output in ``--out``'s ``{arch}__{cell}__{mesh}.log``): a failed
cell doesn't stop the sweep, and each prints ``OK`` or ``FAIL``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def card_memory() -> dict:
    """The H100's memory a rank: read from the card where there is one,
    else the constant ``chip_smoke.py`` phase 19 read there
    (``hlo_analysis.CARD_TOTAL_MEMORY``)."""
    import torch

    from . import hlo_analysis as ha

    if torch.cuda.is_available():
        props = torch.cuda.get_device_properties(0)
        return {"name": props.name, "total_memory": props.total_memory,
                "source": "torch.cuda.get_device_properties(0)"}
    return {"name": ha.CARD_NAME, "total_memory": ha.CARD_TOTAL_MEMORY,
            "source": "hlo_analysis.CARD_TOTAL_MEMORY (chip_smoke phase 19)"}


def _plain(v):
    return v if isinstance(v, (int, float, str, bool, dict)) else str(v)


def record(arch: str, cell: str, mesh_name: str, n_ranks: int, prog,
           plan, t_plan: float, plan_device: str) -> dict:
    """The JSON record of one planned cell (the reference's keys where
    they mean the same thing)."""
    from . import hlo_analysis as ha

    costs = plan.costs
    rec = {"arch": arch, "cell": cell, "mesh": mesh_name,
           "n_ranks": n_ranks, "ok": True, "t_plan_s": t_plan,
           "plan_device": plan_device,
           "meta": {k: _plain(v) for k, v in prog.meta.items()},
           "memory": dict(plan.memory)}
    card = card_memory()
    need = ha.peak_with_margin(plan.memory["peak_estimate_bytes"])
    rec["memory"]["peak_with_margin_bytes"] = need
    rec["fits_h100"] = (None if card["total_memory"] is None
                        else need <= card["total_memory"])
    rec["card_memory"] = card
    rec["hlo_costs"] = {
        "flops_per_rank": costs.flops,
        "hbm_bytes_per_rank": costs.hbm_bytes,
        "collective_bytes_per_rank": costs.collective_bytes,
        "collective_counts": costs.collective_counts,
        "per_collective_bytes": costs.per_collective_bytes,
        "link_bytes": costs.link_bytes,
        "kernel_launches": costs.kernel_launches,
        "kernel_flops": costs.kernel_flops,
        "flops_by_op": costs.flops_by_op,
        "kernel_shapes": plan.launch_shapes,
        "ops": plan.ops,
    }
    rec["roofline"] = ha.roofline_terms(costs)
    mf = prog.meta.get("model_flops")
    if mf:
        total = costs.flops * n_ranks
        rec["roofline"]["model_flops"] = mf
        rec["roofline"]["useful_ratio"] = mf / total if total else None
    return rec


def run_one(arch: str, cell: str, multi_pod: bool, out_dir: str) -> dict:
    """Plan one cell on the production mesh (a fake world of 256 or 512
    ranks, initialized here and taken down after) and write its record to
    ``out_dir/{arch}__{cell}__{mesh}.json``."""
    import torch.distributed as dist

    from .cells import build_cell
    from .mesh import make_production_mesh, release_plan_world

    mesh_name = "multi" if multi_pod else "single"
    n_ranks = 512 if multi_pod else 256
    own = not dist.is_initialized()
    try:
        t0 = time.time()
        mesh = make_production_mesh(multi_pod=multi_pod, plan=True)
        prog = build_cell(arch, cell, mesh)
        plan = prog.lower()
        t_plan = time.time() - t0
        rec = record(arch, cell, mesh_name, n_ranks, prog, plan, t_plan,
                     mesh.device_type)
    finally:
        if own:
            release_plan_world()
    os.makedirs(out_dir, exist_ok=True)
    fname = os.path.join(out_dir, f"{arch}__{cell}__{mesh_name}.json")
    with open(fname, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def _cells(arch: str, cell: str, include_solver: bool):
    from ..configs import registry

    out = []
    for aid, entry in registry.ARCHS.items():
        if arch not in ("all", aid):
            continue
        if entry.family == "solver" and not (include_solver
                                             or arch == "pirmcut"):
            continue
        for c in entry.cells:
            if cell in ("all", c):
                out.append((aid, c))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--cell", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--include-solver", action="store_true",
                    help="also plan the paper's own solver cells")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    cells = _cells(args.arch, args.cell, args.include_solver)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    if not cells:
        raise SystemExit(f"no cell matches --arch {args.arch} --cell "
                         f"{args.cell}")

    if len(cells) == 1 and len(meshes) == 1:
        aid, c = cells[0]
        rec = run_one(aid, c, meshes[0], args.out)
        mem = rec["memory"]
        print(f"[dryrun] OK {aid} × {c} × {rec['mesh']}: plan "
              f"{rec['t_plan_s']:.1f}s, peak/rank "
              f"{mem['peak_estimate_bytes'] / 2**30:.2f} GiB, with margin "
              f"{mem['peak_with_margin_bytes'] / 2**30:.2f} GiB (fits H100: "
              f"{rec['fits_h100']}), dominant={rec['roofline']['dominant']}",
              flush=True)
        return 0

    # sweep mode: one subprocess per cell (fail-soft), half the host's
    # cores at once (a planning run is one core and ~0.3-1 GB of host
    # memory), at most 4
    jobs = max(1, min(4, (os.cpu_count() or 2) // 2))
    todo = []
    for multi in meshes:
        mesh_name = "multi" if multi else "single"
        for aid, c in cells:
            out_json = os.path.join(args.out, f"{aid}__{c}__{mesh_name}.json")
            if args.skip_existing and os.path.exists(out_json):
                print(f"[dryrun] skip {aid} × {c} × {mesh_name} (exists)")
                continue
            todo.append((aid, c, mesh_name, out_json))
    failures, running = [], []
    os.makedirs(args.out, exist_ok=True)

    def finish(job):
        (aid, c, mesh_name, out_json), proc, t0 = job
        proc.wait()
        dt = time.time() - t0
        if proc.returncode == 0:
            print(f"[dryrun] OK   {aid:28s} {c:14s} {mesh_name:6s} "
                  f"({dt:6.1f}s)", flush=True)
            return
        failures.append((aid, c, mesh_name))
        with open(out_json[:-5] + ".log") as f:
            lines = f.read().strip().splitlines()
        print(f"[dryrun] FAIL {aid:28s} {c:14s} {mesh_name:6s} "
              f"({dt:6.1f}s)\n  " + "\n  ".join(lines[-12:]), flush=True)
        with open(out_json, "w") as f:
            json.dump({"arch": aid, "cell": c, "mesh": mesh_name,
                       "ok": False, "stderr": lines[-40:]}, f, indent=1)

    try:
        for job in todo:
            while len(running) >= jobs:
                for r in list(running):
                    if r[1].poll() is not None:
                        running.remove(r)
                        finish(r)
                time.sleep(0.05)
            aid, c, mesh_name, _ = job
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", aid, "--cell", c, "--mesh", mesh_name,
                   "--out", args.out]
            with open(job[3][:-5] + ".log", "w") as log:
                running.append((job, subprocess.Popen(
                    cmd, stdout=log, stderr=subprocess.STDOUT),
                    time.time()))
        for r in running:
            finish(r)
        running = []
    finally:
        for _, proc, _ in running:
            proc.kill()
            proc.wait()
    print(f"[dryrun] done: {len(todo) - len(failures)} ok, "
          f"{len(failures)} failed", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
