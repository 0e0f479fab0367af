"""The CUDA kernels against their plain PyTorch versions, on an NVIDIA card.

Marked ``cuda``: without a card (or without nvcc) every test here skips.
The decision is taken inside a fixture, never at import, so every worker
of a parallel run collects the same tests.  On a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build, ops, ref  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is False")
    try:
        build.nvcc_path()
    except RuntimeError as err:
        pytest.skip(str(err))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all()
    return torch.device("cuda")


def _dev(dev, *arrays):
    return tuple(torch.as_tensor(a, device=dev) for a in arrays)


# float32: rtol 1e-5 (sums in another order, FMA contraction); bfloat16:
# 3e-2 (the kernel sums in float32, the plain version in bfloat16)
@pytest.mark.parametrize("n,k", [(64, 4), (512, 8), (777, 9), (1531, 33),
                                 (2048, 26)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ell_spmv_kernel(cuda, n, k, dtype):
    rng = np.random.default_rng(n * k)
    cols = rng.integers(0, n, size=(n, k)).astype(np.int32)
    vals = rng.standard_normal((n, k)).astype(np.float32)
    diag = rng.uniform(1, 3, size=n).astype(np.float32)
    v = rng.standard_normal(n).astype(np.float32)
    td = getattr(torch, dtype)
    c, a, d, x = _dev(cuda, cols, vals, diag, v)
    a, d, x = a.to(td), d.to(td), x.to(td)
    before = ops.launches["ell_spmv"]
    y = ops.ell_spmv(c, a, d, x)
    torch.cuda.synchronize()
    assert ops.launches["ell_spmv"] == before + 1
    tol = 1e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               ref.ell_spmv_ref(c, a, d, x).float().cpu().numpy(),
                               rtol=tol, atol=tol * 10)


# rtol 3e-5 / atol 1e-6: rsqrtf is within 2 ulp; sums in another order
@pytest.mark.parametrize("n,k", [(64, 4), (512, 8), (777, 9), (1100, 17)])
@pytest.mark.parametrize("eps", [1e-6, 1e-2])
def test_fused_ell_sweep_kernel(cuda, n, k, eps):
    rng = np.random.default_rng(n * k)
    cols = rng.integers(0, n, size=(n, k)).astype(np.int32)
    c_ell = rng.uniform(0.1, 3.0, size=(n, k)).astype(np.float32)
    c_ell[rng.uniform(size=(n, k)) < 0.4] = 0.0
    c_s = rng.uniform(0, 2, size=n).astype(np.float32)
    c_t = rng.uniform(0, 2, size=n).astype(np.float32)
    c_s[rng.uniform(size=n) < 0.3] = 0.0
    c_t[rng.uniform(size=n) < 0.3] = 0.0
    v = rng.uniform(0, 1, size=n).astype(np.float32)
    args = _dev(cuda, cols, c_ell, c_s, c_t, v)
    out = ops.fused_ell_sweep(*args, eps)
    want = ref.fused_ell_sweep_ref(*args, eps)
    torch.cuda.synchronize()
    for y, w in zip(out, want):
        np.testing.assert_allclose(y.cpu().numpy(), w.cpu().numpy(),
                                   rtol=3e-5, atol=1e-6)


# rtol 1e-5 / atol 1e-4: float32 dot products of length bs in another order
@pytest.mark.parametrize("p,bs", [(1, 16), (4, 100), (8, 128), (3, 200),
                                  (16, 512)])
def test_block_diag_matvec_kernel(cuda, p, bs):
    rng = np.random.default_rng(p * bs)
    A = rng.standard_normal((p, bs, bs)).astype(np.float32)
    x = rng.standard_normal((p, bs)).astype(np.float32)
    a, xx = _dev(cuda, A, x)
    y = ops.block_diag_matvec(a, xx)
    torch.cuda.synchronize()
    np.testing.assert_allclose(y.cpu().numpy(),
                               ref.block_diag_matvec_ref(a, xx).cpu().numpy(),
                               rtol=1e-5, atol=1e-4)


def test_wrappers_reject_bad_inputs(cuda):
    x = torch.zeros(8, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        ops.ell_spmv(torch.zeros((8, 2), dtype=torch.int64, device=cuda),
                     torch.zeros((8, 2), device=cuda), x, x)
    with pytest.raises(ValueError, match="contiguous"):
        ops.block_diag_matvec(torch.zeros((2, 4, 4), device=cuda).transpose(1, 2),
                              torch.zeros((2, 4), device=cuda))
    with pytest.raises(NotImplementedError, match="queue 2"):
        ops.edge_reweight_r(torch.zeros(2, dtype=torch.int64, device=cuda),
                            torch.zeros(2, dtype=torch.int64, device=cuda),
                            torch.ones(2, device=cuda), x, 1e-6)


def test_solve_through_kernels_matches_plain_path(cuda, grid_instance):
    """The kernel config solves through all three kernels on the card and
    reaches the plain path's cut (rel 1e-6: both round the same polarized
    voltages with two-level rounding)."""
    from repro.graphs import partition as jgp
    from repro_torch.core import IRLSConfig, pirmcut
    from repro_torch.graphs.structures import instance_from_arrays

    inst = grid_instance
    pinst = instance_from_arrays(inst.graph.src, inst.graph.dst,
                                 inst.graph.weight, inst.graph.n,
                                 inst.s_weight, inst.t_weight)
    labels = jgp.partition_kway(inst.graph, 4)
    kw = dict(layout="ell", use_pallas=True, explicit_block_inverse=True,
              n_irls=12, n_blocks=4)
    ops.reset_launches()
    cut_k, v_k, _ = pirmcut(pinst, IRLSConfig(**kw), labels=labels)
    assert all(n > 0 for n in ops.launches.values()), ops.launches
    cut_p, _, _ = pirmcut(pinst, IRLSConfig(**dict(kw, use_pallas=False)),
                          labels=labels)
    assert np.isfinite(v_k).all()
    assert cut_k.cut_value == pytest.approx(cut_p.cut_value, rel=1e-6)
