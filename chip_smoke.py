#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--side 96] [--n-irls 50] [--seed 0]

Phases (any failure raises and exits non-zero; there is no CPU path):

1. Build the three CUDA kernels from ``src/repro_torch/kernels/csrc`` with
   nvcc for sm_90a (one nvcc per source, all started together) and print
   the card's name and power limit.
2. Make the full-width instance: a 26-connected ``side``³ segmentation grid
   (the repo's grid3d family, the shape of the paper's UWO MRI volumes)
   with 8×8×8 voxel boxes as the block-Jacobi partition.
3. Kernels alone: each kernel's wrapper on card tensors at the shapes the
   main path gives it (the instance's ELL plan and block plan, values drawn
   from a seeded ``torch.Generator``), held against its plain PyTorch
   version, entry by entry against the entry's own scale, then timed with
   CUDA events beside the plain version, its bound and one PyTorch library
   call computing the same function where there is one.
4. The main path: ``pirmcut``'s two steps (``Problem.build``, then
   ``MinCutSession.solve``, whose timings give the setup, IRLS and rounding
   seconds) with the kernel config on the card, launch counters set to 0
   just before and read just after.  Every kernel must have launched,
   exactly as often as the PCG trace says; voltages must be finite.
   Rounded with the sweep cut: the paper's two-level rounding ends in a
   host Dinic whose contour is ~25% of the voxels here (minutes of Python
   at this size).
5. The same solve on the plain path (``use_pallas=False``, on the card) must
   reach the same cut within rel 1e-4, with each IRLS iteration's PCG count
   within two steps of the kernel path's.
6. Two-level rounding at side 32 (kernel path vs plain path, rel 1e-6) and
   at side 16 against the exact min cut of the host Dinic (rel 1e-6).

TF32 is switched off for matmuls and cuDNN, so every float32 product is a
full float32 product.  The last two lines of standard output are the
``kernels`` JSON line and ``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

# NVIDIA H100 SXM data sheet: HBM3 rate and float32 rate outside the tensor
# cores (the kernels do float32 CUDA-core arithmetic)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

KERNELS = {
    "ell_spmv": ("src/repro_torch/kernels/csrc/ell_spmv.cu",
                 "src/repro/kernels/ell_spmv.py:50"),
    "fused_ell_sweep": ("src/repro_torch/kernels/csrc/fused_ell_sweep.cu",
                        "src/repro/kernels/edge_reweight.py:111"),
    "block_diag_matvec": ("src/repro_torch/kernels/csrc/block_diag_matvec.cu",
                          "src/repro/kernels/block_diag_matmul.py:41"),
}


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def box_labels(side: int, box: int = 8):
    """Geometric partition of a side³ grid into box³-voxel boxes (node id =
    z·side² + y·side + x, as grid_3d numbers them).  Returns (labels, P)."""
    import numpy as np

    idx = np.arange(side ** 3)
    z, y, x = idx // (side * side), (idx // side) % side, idx % side
    nb = -(-side // box)
    return (z // box) * nb * nb + (y // box) * nb + x // box, nb ** 3


def segmentation_grid(side: int, seed: int):
    from repro_torch.graphs import generators as gen

    g = gen.grid_3d(side, side, side, conn=26, seed=seed)
    return gen.segmentation_instance(g, (side,) * 3, seed=seed + 1)


def time_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean milliseconds per call over ``reps`` back-to-back calls, between
    two CUDA events, after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(n_bytes: float, n_flops: float):
    """Least time the card could take: bytes over the memory rate or flops
    over the float32 rate, whichever is larger."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / PEAK_F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def check_close(name, got, want, rtol, scales=None):
    """Asserts |got − want| ≤ rtol·s for every entry of every output, where
    s is the entry's own scale: |want|, or for a sum of signed terms the
    same sum over the terms' absolute values (``scales``).  Logs the worst
    |got − want|/s and returns the max |got − want|."""
    import torch

    if scales is None:
        scales = [w.abs() for w in want]
    err = worst = 0.0
    for g, w, s in zip(got, want, scales):
        d = (g - w).abs()
        bad = d > rtol * s
        if bool(bad.any()):
            i = int(torch.argmax(torch.where(bad, d / s, 0.0).flatten()))
            raise AssertionError(
                f"{name}: kernel disagrees with its plain version at "
                f"{int(bad.sum())} entries; worst: got {float(g.flatten()[i])}, "
                f"plain {float(w.flatten()[i])}, scale {float(s.flatten()[i])} "
                f"(rtol {rtol})")
        err = max(err, float(d.max()))
        # s == 0 passed only with d == 0
        worst = max(worst, float(torch.where(s > 0, d / s, 0.0).max()))
    log(f"  {name}: max abs err {err:.3e}, worst err/scale {worst:.3e} "
        f"(tolerance {rtol} of each entry's scale)")
    return err


def kernels_alone(prob, inst, cfg, seed: int):
    """Phase 3: each kernel vs its plain version at the main path's shapes."""
    import torch

    from repro_torch.core import laplacian as lap
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    plan = prob.ell_plan(dev)
    bplan = prob.block_plan(dev)
    g = prob.device_graph(torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    n, k = plan.cols.shape
    valid = torch.zeros((n, k), dtype=torch.bool, device=dev)
    valid[plan.slot_rows, plan.slot_cols] = True
    nnz = int(valid.sum())
    out = {}

    # -- ell_spmv: the instance's column ids, values drawn from the seed
    cols = plan.cols
    vals = -torch.rand((n, k), generator=gen, device=dev) * valid
    diag = torch.rand(n, generator=gen, device=dev) + (-vals).sum(dim=1)
    v = torch.rand(n, generator=gen, device=dev)
    y = ops.ell_spmv(cols, vals, diag, v)
    # 1e-5 of Σ|terms| per row: k + 1 = 33 float32 products summed in two
    # orders differ by at most ~2·33·2⁻²⁴ ≈ 4e-6 of it
    scale = [ref.ell_spmv_ref(cols, vals.abs(), diag.abs(), v.abs())]
    err = check_close("ell_spmv", [y], [ref.ell_spmv_ref(cols, vals, diag, v)],
                      1e-5, scale)
    rows = torch.arange(n, device=dev)
    idx = torch.stack([torch.cat([rows[:, None].expand(n, k)[valid], rows]),
                       torch.cat([cols[valid].long(), rows])])
    csr = torch.sparse_coo_tensor(idx, torch.cat([vals[valid], diag]),
                                  (n, n)).coalesce().to_sparse_csr()
    check_close("ell_spmv library (CSR mv)", [torch.mv(csr, v)], [y], 1e-5,
                scale)
    t_b = bound(nbytes(cols, vals, diag, v, y), 2 * nnz + 2 * n)
    out["ell_spmv"] = dict(
        max_abs_err=err, shape=[n, k],
        ms=time_ms(lambda: ops.ell_spmv(cols, vals, diag, v), 100),
        plain_ms=time_ms(lambda: ref.ell_spmv_ref(cols, vals, diag, v), 20),
        library_ms=time_ms(lambda: torch.mv(csr, v), 100),
        bound_ms=t_b[0], bound_by=t_b[1])
    del vals, diag, csr, idx, scale

    # -- fused_ell_sweep: the instance's weights, voltages from the seed
    c_ell = lap.ell_edge_weights(plan, g.c)
    v = torch.rand(n, generator=gen, device=dev)
    args = (cols, c_ell, g.c_s, g.c_t, v, cfg.eps)
    got = ops.fused_ell_sweep(*args)
    # 3e-5 of each entry itself (no absolute floor; the outputs span eight
    # decades): each r is c²·rsqrt(·) within 2 ulp, each diagonal a sum of
    # positive terms in two orders (≤ 2·34·2⁻²⁴ ≈ 4e-6 relative)
    err = check_close("fused_ell_sweep", got, ref.fused_ell_sweep_ref(*args),
                      3e-5)
    # ~10 flops and one reciprocal square root per stored edge slot, ~12 per row
    t_b = bound(nbytes(cols, c_ell, g.c_s, g.c_t, v, *got), 10 * nnz + 12 * n)
    out["fused_ell_sweep"] = dict(
        max_abs_err=err, shape=[n, k],
        ms=time_ms(lambda: ops.fused_ell_sweep(*args), 50),
        plain_ms=time_ms(lambda: ref.fused_ell_sweep_ref(*args), 10),
        library_ms=None, bound_ms=t_b[0], bound_by=t_b[1])
    del c_ell, got

    # -- block_diag_matvec: P blocks of bs², drawn from the seed
    p, bs = bplan.p, bplan.bs
    A = torch.randn((p, bs, bs), generator=gen, device=dev)
    x = torch.randn((p, bs), generator=gen, device=dev)
    y = ops.block_diag_matvec(A, x)
    # 1e-5 of Σ|A||x| per row: dot products of length bs in two orders; for
    # random signs their gap grows as √bs·2⁻²⁴ ≈ 1.4e-6 of it at bs = 512
    scale = [ref.block_diag_matvec_ref(A.abs(), x.abs())]
    err = check_close("block_diag_matvec", [y], [ref.block_diag_matvec_ref(A, x)],
                      1e-5, scale)
    check_close("block_diag_matvec library (bmm)",
                [torch.bmm(A, x[:, :, None])[:, :, 0]], [y], 1e-5, scale)
    t_b = bound(nbytes(A, x, y), 2 * p * bs * bs)
    out["block_diag_matvec"] = dict(
        max_abs_err=err, shape=[p, bs, bs],
        ms=time_ms(lambda: ops.block_diag_matvec(A, x), 30),
        plain_ms=time_ms(lambda: ref.block_diag_matvec_ref(A, x), 10),
        library_ms=time_ms(lambda: torch.bmm(A, x[:, :, None]), 30),
        bound_ms=t_b[0], bound_by=t_b[1])
    del A, x, y, scale

    # -- where an IRLS iteration's time goes outside the kernels: the block
    # assembly and the batched Cholesky + explicit inverse (torch)
    from repro_torch.core import precond as pc

    rw = lap.initial_weights(g)
    A = pc.assemble_blocks(bplan, rw)
    t_asm = time_ms(lambda: pc.assemble_blocks(bplan, rw), 3, warmup=1)
    t_chol = time_ms(lambda: torch.linalg.cholesky_ex(A), 3, warmup=1)
    del A
    t_fac = time_ms(lambda: pc.factorize_blocks(bplan, rw, True), 3, warmup=1)
    log(f"  per IRLS iteration: factorize_blocks {t_fac:.2f} ms, of which "
        f"assemble_blocks {t_asm:.2f} ms and cholesky_ex {t_chol:.2f} ms "
        f"(the rest: cholesky_solve against I)")
    out["_factorization"] = dict(assemble_ms=t_asm, cholesky_ms=t_chol,
                                 factorize_ms=t_fac)
    torch.cuda.empty_cache()
    for name, r in out.items():
        if name.startswith("_"):
            continue
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        log(f"  {name} {r['shape']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {lib} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--side", type=int, default=96)
    ap.add_argument("--n-irls", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False); this script runs on the card only", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              f"from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.core import (IRLSConfig, MinCutSession, Problem,
                                  max_flow, pirmcut)
    from repro_torch.kernels import build, ops

    t_start = time.perf_counter()
    out_dir = OUT_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    report = {"device": torch.cuda.get_device_name(0),
              "torch": torch.__version__, "cuda": torch.version.cuda}

    # -- 1. build ------------------------------------------------------------
    t = time.perf_counter()
    built = build.build_all()
    report["build_s"] = time.perf_counter() - t
    (out_dir / "chip_smoke_build.log").write_text(
        "\n".join(f"== {name} ({r['seconds']:.1f} s)\n{r['log']}"
                  for name, r in built.items()))
    card = card_line()
    report["card"] = card
    log(f"[build] {len(built)} kernels built in {report['build_s']:.1f} s "
        f"(torch {torch.__version__}, CUDA {torch.version.cuda})")
    log(card)

    # -- 2. full-width instance ---------------------------------------------
    t = time.perf_counter()
    inst = segmentation_grid(args.side, args.seed)
    labels, n_blocks = box_labels(args.side)
    report["generate_s"] = time.perf_counter() - t
    log(f"[instance] side {args.side}: n={inst.n} m={inst.graph.m} "
        f"P={n_blocks} in {report['generate_s']:.1f} s")
    cfg = IRLSConfig(layout="ell", fuse_edge_sweep=True, use_pallas=True,
                     precond="block_jacobi", explicit_block_inverse=True,
                     n_blocks=n_blocks, n_irls=args.n_irls)

    # -- 3. kernels alone -----------------------------------------------------
    # the host setup pirmcut repeats in phase 4, timed part by part here
    t = time.perf_counter()
    prob = Problem.build(inst, n_blocks=n_blocks, labels=labels)
    setup = {"Problem.build": time.perf_counter() - t}
    for part, fn in (("component_labels", prob.component_labels),
                     ("device_graph", lambda: prob.device_graph(device="cuda")),
                     ("ell_plan", lambda: prob.ell_plan("cuda")),
                     ("block_plan", lambda: prob.block_plan("cuda"))):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        setup[part] = time.perf_counter() - t
    report["setup_parts_s"] = setup
    log("[setup] " + ", ".join(f"{k} {v:.2f} s" for k, v in setup.items()))
    kern = kernels_alone(prob, inst, cfg, args.seed)

    # -- 4. the main path ---------------------------------------------------
    # pirmcut's two steps, so that the session's own timings are at hand
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t = time.perf_counter()
    res = MinCutSession(Problem.build(inst, n_blocks=n_blocks, labels=labels),
                        cfg, device="cuda").solve(rounding="sweep")
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t
    launches = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated()
    cut, diag, tm = res.cut, res.diagnostics, res.timings
    steps = sum(1 + it for it in diag.pcg_iters)   # r0 matvec + one per step
    want = {"fused_ell_sweep": args.n_irls, "ell_spmv": steps,
            "block_diag_matvec": steps}
    log(f"[main] solve {wall_s:.2f} s: Problem.build and connectivity check "
        f"{wall_s - tm['total']:.2f} s, setup {tm['setup']:.2f} s, IRLS "
        f"{tm['irls']:.2f} s, rounding {tm['rounding']:.2f} s")
    log(f"[main] PCG iterations per IRLS iteration: {diag.pcg_iters}")
    log(f"[main] launches {launches} (expected {want})")
    log(f"[main] peak device memory {peak / 2**30:.2f} GiB; cut "
        f"{cut.cut_value!r}")
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != {want}")
    if not np.isfinite(res.voltages).all():
        raise AssertionError("non-finite voltages")
    report["main"] = dict(wall_s=wall_s, timings=tm,
                          pcg_iters=diag.pcg_iters, launches=launches,
                          peak_bytes=peak, cut=cut.cut_value,
                          l1_objective=diag.l1_objective)

    # -- 5. the plain path on the card ---------------------------------------
    # The kernels sum in other orders than torch, so the PCG iterates drift
    # apart at float32 roundoff amplified by ε = 1e-6, and the sweep picks
    # its threshold from near-tied voltages.  Three full-width runs read cut
    # gaps of 7.8e-6, 2.4e-7 and 1.6e-7 (PERF.md); the limit leaves ~13×
    # room over the largest.  A faulty kernel shows in how PCG converges,
    # so each IRLS iteration's PCG count must also agree within two steps:
    # the runs read gaps of 0 and 1 where PCG stops at its 1e-3 residual,
    # and the atomic index adds on the card (initial degrees, block
    # assembly) make no two runs bit-equal.
    plain = MinCutSession(prob, dataclasses.replace(cfg, use_pallas=False),
                          device="cuda").solve(rounding="sweep")
    if ops.launches != launches:
        raise AssertionError("the plain path launched a kernel")
    rel = abs(plain.cut_value - cut.cut_value) / abs(plain.cut_value)
    plain_iters = plain.diagnostics.pcg_iters
    iter_gap = max(abs(a - b) for a, b in zip(diag.pcg_iters, plain_iters))
    log(f"[plain] cut {plain.cut_value!r}, rel diff {rel:.3e} (tolerance "
        f"1e-4); PCG iterations {plain_iters}, largest gap {iter_gap} "
        f"(tolerance 2); IRLS {plain.timings['irls']:.2f} s")
    if not rel <= 1e-4:
        raise AssertionError(f"kernel cut {cut.cut_value} vs plain "
                             f"{plain.cut_value}: rel {rel}")
    if len(plain_iters) != len(diag.pcg_iters) or iter_gap > 2:
        raise AssertionError(f"PCG iterations: kernel path {diag.pcg_iters} "
                             f"vs plain path {plain_iters}")
    report["plain"] = dict(cut=plain.cut_value, rel_diff=rel,
                           pcg_iters=plain_iters, iter_gap=iter_gap,
                           irls_s=plain.timings["irls"])
    del prob, plain
    torch.cuda.empty_cache()

    # -- 6. two-level rounding at reduced sides -------------------------------
    small = {}
    for side in (32, 16):
        inst_s = segmentation_grid(side, args.seed)
        labels_s, p_s = box_labels(side)
        cfg_s = dataclasses.replace(cfg, n_blocks=p_s)
        t = time.perf_counter()
        cut_k, v_k, _ = pirmcut(inst_s, cfg_s, labels=labels_s, device="cuda")
        t_k = time.perf_counter() - t
        if side == 32:
            cut_p, _, _ = pirmcut(inst_s, dataclasses.replace(
                cfg_s, use_pallas=False), labels=labels_s, device="cuda")
            want_cut, what = cut_p.cut_value, "plain path"
        else:
            want_cut, what = max_flow(inst_s).value, "exact Dinic"
        rel = abs(cut_k.cut_value - want_cut) / abs(want_cut)
        log(f"[two_level] side {side}: cut {cut_k.cut_value!r} vs {what} "
            f"{want_cut!r} (rel {rel:.2e}, tolerance 1e-6); contour "
            f"{cut_k.meta['coarse_n']} nodes; {t_k:.1f} s")
        if not (np.isfinite(v_k).all() and rel <= 1e-6):
            raise AssertionError(f"two-level cut at side {side}: rel {rel}")
        small[side] = dict(cut=cut_k.cut_value, reference=want_cut,
                           reference_kind=what, rel=rel,
                           contour=cut_k.meta["coarse_n"], seconds=t_k)
    report["two_level"] = small

    line = {"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1], "launches": launches[name],
         "max_abs_err": kern[name]["max_abs_err"], "ms": kern[name]["ms"],
         "plain_ms": kern[name]["plain_ms"],
         "bound_ms": kern[name]["bound_ms"],
         "bound_by": kern[name]["bound_by"],
         "library_ms": kern[name]["library_ms"]}
        for name in KERNELS]}
    report["kernels"] = kern
    report["seconds"] = time.perf_counter() - t_start
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    log(f"[done] {report['seconds']:.1f} s")
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
