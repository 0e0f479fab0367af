"""The port's kernel wrappers and plain versions (CPU) against the JAX
package's kernels (Pallas interpret mode) and its jnp oracles, on the shape
sweeps of tests/test_kernels.py.  Inputs come from numpy seeds and reach
both packages as the same arrays.

On the CPU every wrapper runs its kernel's plain version, so these tests
hold the arithmetic the CUDA kernels implement; tests/test_torch_cuda.py
holds the kernels themselves against the same plain versions on a card."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402


def _both(*arrays):
    return (tuple(jnp.asarray(a) for a in arrays),
            tuple(torch.as_tensor(a) for a in arrays))


# float32: 1e-5 as tests/test_kernels.py — only the summation order differs.
# bfloat16: 3e-2 as there — products round to 8 mantissa bits at other
# points in the two frameworks.
@pytest.mark.parametrize("n,k", [(64, 4), (512, 8), (777, 9), (1531, 33),
                                 (2048, 26)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ell_spmv_sweep(n, k, dtype):
    rng = np.random.default_rng(n * k)
    cols = rng.integers(0, n, size=(n, k)).astype(np.int32)
    vals = rng.standard_normal((n, k)).astype(np.float32)
    vals[rng.uniform(size=(n, k)) < 0.4] = 0.0
    diag = rng.uniform(1, 3, size=n).astype(np.float32)
    v = rng.standard_normal(n).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jargs = (jnp.asarray(cols), jnp.asarray(vals, jd), jnp.asarray(diag, jd),
             jnp.asarray(v, jd))
    targs = (torch.as_tensor(cols), torch.as_tensor(vals).to(td),
             torch.as_tensor(diag).to(td), torch.as_tensor(v).to(td))
    y = ops.ell_spmv(*targs)
    assert y.dtype == td and y.shape == (n,)
    tol = 1e-5 if dtype == "float32" else 3e-2
    y = y.float().numpy()
    for y_ref in (jops.ell_spmv(*jargs), jref.ell_spmv_ref(*jargs)):
        np.testing.assert_allclose(y, np.asarray(y_ref, np.float32),
                                   rtol=tol, atol=tol * 10)


# 3e-5: the bar tests/test_kernels.py sets for its kernel (rsqrt vs 1/sqrt).
@pytest.mark.parametrize("m,n", [(100, 64), (4096, 512), (5000, 300),
                                 (12288, 1024)])
@pytest.mark.parametrize("eps", [1e-6, 1e-2])
def test_edge_reweight_sweep(m, n, eps):
    rng = np.random.default_rng(m + n)
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    c = rng.uniform(0.1, 3.0, m).astype(np.float32)
    v = rng.uniform(0, 1, n).astype(np.float32)
    jargs, targs = _both(src, dst, c, v)
    r = ops.edge_reweight_r(*targs, eps).numpy()
    np.testing.assert_allclose(r, ref.edge_reweight_ref(*targs, eps).numpy(),
                               rtol=0, atol=0)
    for r_ref in (jops.edge_reweight_r(*jargs, eps),
                  jref.edge_reweight_ref(*jargs, eps)):
        np.testing.assert_allclose(r, np.asarray(r_ref), rtol=3e-5)


@pytest.mark.parametrize("n,k", [(64, 4), (512, 8), (777, 9), (1100, 17)])
@pytest.mark.parametrize("eps", [1e-6, 1e-2])
def test_fused_ell_sweep_sweep(n, k, eps):
    """The port's sweep wrapper and its core fallback against the Pallas
    kernel and the jnp oracle: all agree on (vals, diag, r_s, r_t) at the
    rtol 3e-5 / atol 1e-6 of tests/test_kernels.py."""
    from repro_torch.core import laplacian as lap

    rng = np.random.default_rng(n * k)
    cols = rng.integers(0, n, size=(n, k)).astype(np.int32)
    c_ell = rng.uniform(0.1, 3.0, size=(n, k)).astype(np.float32)
    c_ell[rng.uniform(size=(n, k)) < 0.4] = 0.0       # padded slots
    c_s = rng.uniform(0, 2, size=n).astype(np.float32)
    c_t = rng.uniform(0, 2, size=n).astype(np.float32)
    c_s[rng.uniform(size=n) < 0.3] = 0.0              # absent terminals
    c_t[rng.uniform(size=n) < 0.3] = 0.0
    v = rng.uniform(0, 1, size=n).astype(np.float32)
    jargs, targs = _both(cols, c_ell, c_s, c_t, v)
    outs_t = (ops.fused_ell_sweep(*targs, eps), lap.fused_ell_sweep(*targs, eps))
    outs_j = (jops.fused_ell_sweep(*jargs, eps),
              jref.fused_ell_sweep_ref(*jargs, eps))
    for out_t in outs_t:
        for out_j in outs_j:
            for yt, yj in zip(out_t, out_j):
                np.testing.assert_allclose(yt.numpy(), np.asarray(yj),
                                           rtol=3e-5, atol=1e-6)


def test_fused_ell_sweep_halo_extended_v():
    """``v`` longer than the row count: rows read its head, ``cols`` may
    gather from the tail (the halo-extended form)."""
    rng = np.random.default_rng(11)
    n, nv, k = 300, 420, 6
    cols = rng.integers(0, nv, size=(n, k)).astype(np.int32)
    c_ell = rng.uniform(0.1, 3.0, size=(n, k)).astype(np.float32)
    c_s = rng.uniform(0, 2, size=n).astype(np.float32)
    c_t = rng.uniform(0, 2, size=n).astype(np.float32)
    v = rng.uniform(0, 1, size=nv).astype(np.float32)
    jargs, targs = _both(cols, c_ell, c_s, c_t, v)
    for yt, yj in zip(ops.fused_ell_sweep(*targs, 1e-3),
                      jops.fused_ell_sweep(*jargs, 1e-3)):
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj),
                                   rtol=3e-5, atol=1e-6)


# rtol 1e-5 / atol 1e-4 as tests/test_kernels.py: float32 dot products of
# length bs summed in another order.
@pytest.mark.parametrize("p,bs", [(1, 16), (4, 100), (8, 128), (3, 200)])
def test_block_diag_matvec_sweep(p, bs):
    rng = np.random.default_rng(p * bs)
    A = rng.standard_normal((p, bs, bs)).astype(np.float32)
    x = rng.standard_normal((p, bs)).astype(np.float32)
    jargs, targs = _both(A, x)
    y = ops.block_diag_matvec(*targs).numpy()
    for y_ref in (jops.block_diag_matvec(*jargs),
                  jref.block_diag_matvec_ref(*jargs)):
        np.testing.assert_allclose(y, np.asarray(y_ref), rtol=1e-5, atol=1e-4)


# Batches: B lanes over shared indices, against the JAX package's kernels
# vmapped over the lanes (Pallas interpret mode), at the tolerances of the
# single-instance sweeps above.
_B = 3


@pytest.mark.parametrize("m,n", [(100, 64), (5000, 300)])
def test_edge_reweight_batched(m, n):
    import jax

    rng = np.random.default_rng(7 * m + n)
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    c = rng.uniform(0.1, 3.0, (_B, m)).astype(np.float32)
    v = rng.uniform(0, 1, (_B, n)).astype(np.float32)
    jargs, targs = _both(src, dst, c, v)
    r = ops.edge_reweight_r(*targs, 1e-6)
    assert r.shape == (_B, m)
    want = jax.vmap(jops.edge_reweight_r, in_axes=(None, None, 0, 0, None))(
        *jargs, 1e-6)
    np.testing.assert_allclose(r.numpy(), np.asarray(want), rtol=3e-5)
    # each lane is the single-instance result
    for b in range(_B):
        assert torch.equal(r[b], ops.edge_reweight_r(*targs[:2], targs[2][b],
                                                     targs[3][b], 1e-6))


@pytest.mark.parametrize("n,k", [(64, 4), (777, 9)])
def test_ell_kernels_batched(n, k):
    import jax

    rng = np.random.default_rng(n * k + 1)
    cols = rng.integers(0, n, size=(n, k)).astype(np.int32)
    vals = rng.standard_normal((_B, n, k)).astype(np.float32)
    diag = rng.uniform(1, 3, size=(_B, n)).astype(np.float32)
    v = rng.standard_normal((_B, n)).astype(np.float32)
    jargs, targs = _both(cols, vals, diag, v)
    y = ops.ell_spmv(*targs)
    assert y.shape == (_B, n)
    want = jax.vmap(jops.ell_spmv, in_axes=(None, 0, 0, 0))(*jargs)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)

    c_ell = rng.uniform(0.1, 3.0, size=(_B, n, k)).astype(np.float32)
    c_ell[rng.uniform(size=(_B, n, k)) < 0.4] = 0.0
    c_s = rng.uniform(0, 2, size=(_B, n)).astype(np.float32)
    c_t = rng.uniform(0, 2, size=(_B, n)).astype(np.float32)
    c_s[rng.uniform(size=(_B, n)) < 0.3] = 0.0
    vv = rng.uniform(0, 1, size=(_B, n)).astype(np.float32)
    jargs, targs = _both(cols, c_ell, c_s, c_t, vv)
    got = ops.fused_ell_sweep(*targs, 1e-6)
    want = jax.vmap(jops.fused_ell_sweep, in_axes=(None, 0, 0, 0, 0, None))(
        *jargs, 1e-6)
    for yt, yj in zip(got, want):
        assert yt.shape[0] == _B
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=3e-5,
                                   atol=1e-6)


def test_block_jacobi_batched_is_per_lane(road_instance):
    """A batch's blocks form one flat (B·P) block batch: applying the
    batched preconditioner equals applying each lane's own."""
    from repro.graphs import partition as jgp
    from repro_torch.core import laplacian as lap, precond as pc
    from repro_torch.core.incidence import device_graph_from_instance
    from repro_torch.graphs.structures import instance_from_arrays

    inst = road_instance
    pinst = instance_from_arrays(inst.graph.src, inst.graph.dst,
                                 inst.graph.weight, inst.graph.n,
                                 inst.s_weight, inst.t_weight)
    labels = np.sort(jgp.partition_kway(inst.graph, 4))
    g = device_graph_from_instance(pinst, device="cpu")
    plan = pc.build_block_plan(pinst.graph.src, pinst.graph.dst, labels, 4,
                               device="cpu")
    rng = np.random.default_rng(2)
    scale = torch.as_tensor(rng.uniform(0.5, 2.0, (_B, 1)), dtype=torch.float32)
    gb = g._replace(c=g.c * scale, c_s=g.c_s * scale, c_t=g.c_t * scale)
    rw = lap.initial_weights(gb)
    x = torch.as_tensor(rng.standard_normal((_B, g.n)), dtype=torch.float32)
    M = pc.factorize_blocks(plan, rw, explicit_inverse=True)
    assert M.inv.shape == (_B * plan.p, plan.bs, plan.bs)
    y = pc.apply_block_jacobi(M, x)
    for b in range(_B):
        rw_b = lap.Reweighted(*(t[b] for t in rw))
        y_b = pc.apply_block_jacobi(pc.factorize_blocks(plan, rw_b, True), x[b])
        np.testing.assert_allclose(y[b].numpy(), y_b.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_each_kernel_has_one_plain_version():
    """``ref`` names the functions the solver's plain path runs, so a kernel
    held against its plain version is held against that path; the unfused
    reweight takes its r_e from the kernel wrapper under use_pallas."""
    from repro_torch.core import DeviceGraph, laplacian as lap, precond as pc
    from repro_torch.core.incidence import coo_plan

    assert ref.ell_spmv_ref is lap.matvec_ell
    assert ref.fused_ell_sweep_ref is lap.fused_ell_sweep
    assert ref.edge_reweight_ref is lap.edge_conductances
    assert ref.block_diag_matvec_ref is pc.block_diag_matvec
    rng = np.random.default_rng(5)
    n, m = 50, 200
    src = torch.as_tensor(rng.integers(0, n, m))
    dst = torch.as_tensor(rng.integers(0, n, m))
    g = DeviceGraph(src=src, dst=dst,
                    c=torch.as_tensor(rng.uniform(0.1, 3, m), dtype=torch.float32),
                    c_s=torch.as_tensor(rng.uniform(0, 2, n), dtype=torch.float32),
                    c_t=torch.as_tensor(rng.uniform(0, 2, n), dtype=torch.float32),
                    coo=coo_plan(src, dst, n))
    v = torch.as_tensor(rng.uniform(0, 1, n), dtype=torch.float32)
    for a, b in zip(lap.reweight(g, v, 1e-6),
                    lap.reweight(g, v, 1e-6, edge_r=ops.edge_reweight_r)):
        assert torch.equal(a, b)


def test_wrappers_take_plain_version_only_on_cpu():
    """No silent fallback: a tensor on a device other than CPU or CUDA, or
    tensors spread over devices, raise instead of running the plain
    version; CPU calls never count as kernel launches."""
    ops.reset_launches()
    meta = [torch.empty((4, 2), dtype=torch.int32, device="meta"),
            torch.empty((4, 2), device="meta"), torch.empty(4, device="meta"),
            torch.empty(4, device="meta")]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ops.ell_spmv(*meta)
    cpu = torch.zeros(4)
    with pytest.raises(ValueError, match="several devices"):
        ops.block_diag_matvec(torch.zeros((4, 1, 1), device="meta"),
                              cpu[:, None])
    ops.ell_spmv(torch.zeros((4, 2), dtype=torch.int32), torch.zeros((4, 2)),
                 cpu, cpu)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ops.flash_fwd(*(torch.empty((2, 4, 64), device="meta"),) * 3,
                      g_per_kv=1)
    ops.flash_fwd(torch.zeros((2, 4, 8)), torch.zeros((1, 4, 8)),
                  torch.zeros((1, 4, 8)), g_per_kv=2)
    assert ops.launches == {"ell_spmv": 0, "fused_ell_sweep": 0,
                            "block_diag_matvec": 0, "edge_reweight": 0,
                            "flash_fwd": 0}


def test_build_names_each_library_by_its_source(monkeypatch, tmp_path):
    """A kernel library's file name hashes its source, every header in
    csrc/ and its flags (an edited source or header never loads a stale
    build); a missing nvcc raises."""
    paths = {name: build.library_path(name) for name in build.SOURCES}
    assert len(set(paths.values())) == len(paths)
    for name, path in paths.items():
        assert path.parent == build.BUILD_DIR
        assert path.name.startswith(f"lib{name}_") and path.suffix == ".so"
        assert (build.CSRC / build.SOURCES[name]).exists()
        assert build.flags(name)[:len(build.NVCC_FLAGS)] == build.NVCC_FLAGS
    assert list(build.CSRC.glob("*.cuh")), "the kernels share a header"
    # a copy of csrc/: the same files give the same names
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in build.CSRC.iterdir():
        (csrc / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC", csrc)
    assert {n: build.library_path(n) for n in build.SOURCES} == paths
    # an edited header renames every library
    header = sorted(csrc.glob("*.cuh"))[0]
    text = header.read_bytes()
    header.write_bytes(text + b"\n// edited\n")
    assert all(build.library_path(n) != paths[n] for n in build.SOURCES)
    header.write_bytes(text)
    assert {n: build.library_path(n) for n in build.SOURCES} == paths
    # so does a new header, and a source's own flags rename its library only
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert all(build.library_path(n) != paths[n] for n in build.SOURCES)
    (csrc / "extra.cuh").unlink()
    monkeypatch.setitem(build.SOURCE_FLAGS, "ell_spmv", ("-lm",))
    assert build.library_path("ell_spmv") != paths["ell_spmv"]
    assert build.library_path("flash_fwd") == paths["flash_fwd"]
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()


def test_build_log_reads_the_log_beside_the_library(monkeypatch, tmp_path):
    """nvcc's output is kept beside the library it built, under the
    library's own (hashed) name, so a later run reads the current build's
    ptxas lines; a library built without one reads as ""."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    for name in build.SOURCES:
        assert build.build_log(name) == ""
    log = build.library_path("block_diag_matvec").with_suffix(".log")
    log.write_text("ptxas info    : Used 64 registers\n")
    assert "64 registers" in build.build_log("block_diag_matvec")
    assert build.build_log("fused_ell_sweep") == ""


_FAKE_NVCC = """#!{python}
import os, sys, time
out = sys.argv[sys.argv.index("-o") + 1]
with open(os.environ["NVCC_CALLS"], "a") as f:
    f.write(out + "\\n")
with open(out, "w") as f:
    f.write("half")
    f.flush()
    time.sleep(0.5)          # a reader that skips the lock sees half a file
    f.write(" a library")
print("ptxas info    : Used 40 registers")
"""

_RACE = """
import sys
from pathlib import Path
from repro_torch.kernels import build
build.BUILD_DIR = Path(sys.argv[1])
build.build_all(["edge_reweight"])
print(build.library_path("edge_reweight").read_text())
"""


def test_build_is_one_compile_across_processes(tmp_path):
    """Several processes that build a kernel at once (the ranks of a
    sharded solve) run ONE compile under the build directory's lock: the
    others wait and find its library.  nvcc writes a temporary name that
    is moved into place, so nobody reads a half-written library."""
    import os
    import subprocess
    import sys

    cuda = tmp_path / "cuda"
    (cuda / "bin").mkdir(parents=True)
    nvcc = cuda / "bin" / "nvcc"
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    calls = tmp_path / "calls.txt"
    out_dir = tmp_path / "kernels"
    src = str(build.CSRC.parents[2])
    env = dict(os.environ, CUDA_HOME=str(cuda), NVCC_CALLS=str(calls),
               PYTHONPATH=src)
    procs = [subprocess.Popen([sys.executable, "-c", _RACE, str(out_dir)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert [o.strip() for o, _ in outs] == ["half a library"] * 4
    compiled = calls.read_text().split()
    assert len(compiled) == 1 and compiled[0].endswith(".tmp")
    assert sorted(f.name for f in out_dir.iterdir()) == sorted(
        [".lock", build.library_path("edge_reweight").name,
         build.library_path("edge_reweight").with_suffix(".log").name])
    assert "40 registers" in (out_dir / build.library_path(
        "edge_reweight").with_suffix(".log").name).read_text()


def _model_layout(rng, b, sq, sk, h, kv, d):
    return tuple(torch.as_tensor(rng.standard_normal(s).astype(np.float32))
                 for s in ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d)))


@pytest.mark.parametrize("g", [1, 2, 3])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_fwd_4d_equals_3d_on_cpu(g, causal):
    """The model's [B, S, H, D] layout gives exactly the 3-D call's result on
    the regrouped tensors (query head b·H + kv·G + g in lse), with out back
    in q's layout."""
    rng = np.random.default_rng(g + 10 * causal)
    q, k, v = _model_layout(rng, 2, 24, 24 + 5 * (not causal), 2 * g, 2, 16)
    kw = dict(g_per_kv=g, causal=causal, scale=0.3)
    out4, lse4 = ops.flash_fwd(q, k, v, **kw)
    q3 = q.reshape(2, 24, 2, g, 16).permute(0, 2, 3, 1, 4).reshape(4 * g, 24, 16)
    k3, v3 = (t.permute(0, 2, 1, 3).reshape(4, -1, 16) for t in (k, v))
    out3, lse3 = ops.flash_fwd(q3.contiguous(), k3.contiguous(),
                               v3.contiguous(), **kw)
    assert out4.shape == q.shape and lse4.shape == (4 * g, 24)
    assert torch.equal(out4.reshape(2, 24, 2, g, 16).permute(0, 2, 3, 1, 4)
                       .reshape(4 * g, 24, 16), out3)
    assert torch.equal(lse4, lse3)
    assert all(torch.equal(a, b) for a, b in zip(ops._regroup(q, k, v),
                                                 (q3, k3, v3)))


def test_flash_fwd_layout_checks_raise_on_cpu():
    """The layout and shape checks are not the card's: they raise on CPU
    tensors too (the head-dim, dtype-set and alignment rules are the
    kernel's and apply on the card only)."""
    rng = np.random.default_rng(0)
    q, k, v = _model_layout(rng, 2, 8, 8, 4, 2, 16)
    with pytest.raises(ValueError, match="all 3-D or all 4-D"):
        ops.flash_fwd(q, k[0], v[0], g_per_kv=2)
    with pytest.raises(ValueError, match="all 3-D or all 4-D"):
        ops.flash_fwd(q[0, 0], k[0, 0], v[0, 0], g_per_kv=2)
    with pytest.raises(ValueError, match="shapes"):
        ops.flash_fwd(q, k, v, g_per_kv=3)           # H ≠ KV·G
    with pytest.raises(ValueError, match="shapes"):
        ops.flash_fwd(q, k[:1], v[:1], g_per_kv=2)   # batch mismatch
    with pytest.raises(ValueError, match="shapes"):
        ops.flash_fwd(q, k, v[..., :8], g_per_kv=2)
    with pytest.raises(ValueError, match="shapes"):
        ops.flash_fwd(q[:, :, :, :8], k, v, g_per_kv=2)
    with pytest.raises(ValueError, match="dtype"):
        ops.flash_fwd(q, k.double(), v, g_per_kv=2)
    with pytest.raises(ValueError, match="shapes"):
        ops.flash_fwd(*(t.reshape(-1, 8, 16)[:3] for t in (q, k, v)), g_per_kv=2)
    ops.reset_launches()
    out, lse = ops.flash_fwd(q, k, v, g_per_kv=2)
    assert out.shape == q.shape and lse.shape == (8, 8)
    assert ops.launches["flash_fwd"] == 0


# -- the launch geometry of the redesigned kernels (plain Python in ops) ----

def _kernel_constants(source: str) -> dict:
    """``constexpr int NAME = value;`` lines of a kernel source."""
    import re

    text = (build.CSRC / source).read_text()
    return {m.group(1): int(m.group(2)) for m in
            re.finditer(r"constexpr int (\w+) = (\d+);", text)}


def test_block_diag_matvec_plan_matches_kernel_source():
    """The wrapper's warps per block and loads in flight per thread (the
    unit's size) are the kernel's own."""
    k = _kernel_constants("block_diag_matvec.cu")
    assert (k["WARPS"], k["IN_FLIGHT"]) == (ops._BDM_WARPS,
                                            ops._BDM_IN_FLIGHT)


@pytest.mark.parametrize("p,bs", [(1, 16), (7, 100), (300, 200), (2000, 128),
                                  (1728, 512), (864, 512), (5, 4), (3, 8),
                                  (2, 24), (11, 332), (1, 512), (3, 256),
                                  (13, 48), (40, 384), (17, 12), (6, 508),
                                  (9, 64), (100, 200), (2, 36), (1, 4)])
def test_block_diag_matvec_plan_covers_every_row_once(p, bs):
    """Walked as the kernel walks it (block b's range of units, its warp i
    every W-th unit from b's start + i, (p, unit within p) advanced by W),
    the vector plan covers every row of every block exactly once, with
    block and warp loads differing by at most one unit and no warp holding
    more than ``_BDM_UNITS_PER_WARP`` units."""
    plan = ops._bdm_plan(p, bs)
    assert plan.g_log2 >= 0 and plan.nch in (1, 2, 4)
    g = 1 << plan.g_log2
    # a row's G lanes hold all bs/4 float4s; a unit is RPT steps of 32/G rows
    assert plan.nch * g * 4 >= bs and (plan.nch == 1 or g == 32)
    # the units as the kernel's entry derives them
    unit_rows = (32 // g) * (ops._BDM_IN_FLIGHT // plan.nch)
    assert ops._bdm_unit_rows(plan.g_log2, plan.nch) == unit_rows
    units_per_p = -(-bs // unit_rows)
    units = p * units_per_p
    w = ops._BDM_WARPS
    assert plan.grid == -(-units // (w * ops._BDM_UNITS_PER_WARP))
    seen = np.zeros((p, bs), dtype=np.int64)
    per_block, per_warp = [], []
    for b in range(plan.grid):
        u0 = b * units // plan.grid
        u1 = (b + 1) * units // plan.grid
        per_block.append(u1 - u0)
        for i in range(w):
            u = u0 + i
            if u >= u1:
                per_warp.append(0)
                continue
            blk, up = divmod(u, units_per_p)
            count = 0
            while u < u1:
                assert (blk, up) == divmod(u, units_per_p)
                rows = up * unit_rows + np.arange(unit_rows)
                seen[blk, rows[rows < bs]] += 1
                count += 1
                u += w
                up += w
                while up >= units_per_p:
                    up -= units_per_p
                    blk += 1
            per_warp.append(count)
    assert (seen == 1).all()
    assert max(per_block) - min(per_block) <= 1
    busy = [c for c in per_warp if c]
    assert max(busy) - min(busy) <= 1
    assert max(busy) <= ops._BDM_UNITS_PER_WARP


@pytest.mark.parametrize("bs,aligned", [(30, True), (102, True), (513, True),
                                        (600, True), (1000, True),
                                        (512, False), (16, False)])
def test_block_diag_matvec_plan_scalar_for_other_shapes(bs, aligned):
    """A bs that is not a multiple of 4, above 512, or A or x off a 16-byte
    boundary takes the scalar variant: one block per p."""
    plan = ops._bdm_plan(9, bs, aligned)
    assert plan.g_log2 == -1 and plan.grid == 9


@pytest.mark.parametrize("k,want", [(4, 0), (8, 1), (12, 2), (16, 2), (32, 3),
                                    (64, 3), (100, 3), (128, 3), (9, -1),
                                    (17, -1), (26, -1), (33, -1), (132, -1),
                                    (0, -1)])
def test_ell_sweep_variant_by_width(k, want):
    """The sweep's vector variant takes k % 4 == 0 up to 128, with G the
    smallest power of two ≥ k/4 and at most 8 threads a row; every other
    width takes the scalar variant."""
    t = torch.zeros(8)
    assert ops._vector_group_log2(k, t, t) == want
    if want >= 0:
        g = 1 << want
        nch = -(-k // 4 // g)
        assert nch in (1, 2, 4) and nch * g * 4 >= k


def test_ell_sweep_variant_needs_16_byte_boundaries():
    """A tensor of the vector variant's 16-byte loads (``cols``, ``c_ell``)
    that starts off a 16-byte boundary sends the sweep to the scalar
    variant."""
    buf = torch.zeros(4 * 32 + 4)
    aligned = buf[:4 * 32].view(4, 32)
    assert ops._vector_group_log2(32, aligned, aligned) == 3
    for off in (1, 2, 3):
        shifted = buf[off:off + 4 * 32].view(4, 32)
        assert shifted.is_contiguous()
        assert ops._vector_group_log2(32, aligned, shifted) == -1


# -- edge_reweight's variants and grid (ops._er_plan) ------------------------

def test_edge_reweight_plan_matches_kernel_source():
    """The wrapper's threads per block and edges per vector work item are
    the kernel's own."""
    k = _kernel_constants("edge_reweight.cu")
    assert (k["BLOCK"], k["EDGES"]) == (ops._ER_BLOCK, ops._ER_EDGES)


@pytest.mark.parametrize("m,aligned,vector", [
    (11_254_460, True, True), (2_095_104, True, True), (4096, True, True),
    (4, True, True), (4097, True, False), (4098, True, False),
    (4099, True, False), (3, True, False), (1, True, False),
    (11_254_460, False, False), (4096, False, False)])
def test_edge_reweight_plan_by_shape(m, aligned, vector):
    """The vector variant (4 edges a thread) where m % 4 == 0 and the
    tensors are on 16-byte boundaries, the scalar one (1 edge) otherwise."""
    plan = ops._er_plan(m, aligned)
    assert plan.edges == (ops._ER_EDGES if vector else 1)
    assert plan.grid >= 1


def test_edge_reweight_plan_needs_16_byte_boundaries():
    """A 1-D slice at an offset of 1, 2 or 3 entries is off the 16-byte
    boundary the vector variant's loads need; at 4 it is on it."""
    buf = torch.zeros(4096 + 8, dtype=torch.int32)
    for off in (1, 2, 3, 4):
        t = buf[off:off + 4096]
        assert t.is_contiguous()
        aligned = ops._aligned(buf[:4096], t)
        assert aligned == (off % 4 == 0)
        assert ops._er_plan(4096, aligned).edges == (4 if aligned else 1)


@pytest.mark.parametrize("m,cap", [
    (4096, None), (4100, None), (1, None), (4, None), (1001, None),
    (70_000, None), (12_289, None), (9_000, 3), (9_001, 2)])
def test_edge_reweight_plan_covers_every_edge_once(m, cap, monkeypatch):
    """Walked as the kernel walks it (thread t of block b takes work items
    b·BLOCK + t, + grid·BLOCK, ..., each of ``edges`` edges), the plan
    covers every edge exactly once; the vector variant's grid is one-shot
    (no thread takes two items, no block idles), the scalar one's at most
    its cap."""
    if cap is not None:
        monkeypatch.setattr(ops, "_ER_SCALAR_MAX_GRID", cap)
    plan = ops._er_plan(m, True)
    items = m // plan.edges
    assert items * plan.edges == m
    stride = plan.grid * ops._ER_BLOCK
    seen = np.zeros(m, dtype=np.int64)
    for t in range(min(stride, items)):
        for q in range(t, items, stride):
            seen[q * plan.edges:(q + 1) * plan.edges] += 1
    assert (seen == 1).all()
    if plan.edges > 1:
        assert stride >= items > (plan.grid - 1) * ops._ER_BLOCK
    else:
        assert plan.grid <= ops._ER_SCALAR_MAX_GRID
