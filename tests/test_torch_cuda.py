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


def _zero_filled(idx, nv):
    """Indices outside [0, nv) pointed at an appended 0 entry: the plain
    version of the kernels' fill-with-0 gathers."""
    idx = idx.long()
    return torch.where((idx >= 0) & (idx < nv), idx, torch.full_like(idx, nv))


# bit for bit: the kernel rounds each operation once, in the plain
# version's order (correctly rounded square root and division)
@pytest.mark.parametrize("m,n", [(100, 64), (5000, 300), (12288, 1024)])
@pytest.mark.parametrize("lanes", [None, 3])
@pytest.mark.parametrize("eps", [1e-6, 1e-2])
def test_edge_reweight_kernel(cuda, m, n, lanes, eps):
    """One instance and a batch of lanes over shared src/dst; a few indices
    out of range gather 0, as the TPU kernel's fill_value=0 does."""
    rng = np.random.default_rng(m + n)
    b = 1 if lanes is None else lanes
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    src[:3] = [n, n + 7, -1]
    dst[3:5] = [n + 1, -5]
    c = rng.uniform(0.1, 3.0, (b, m)).astype(np.float32)
    v = rng.uniform(0, 1, (b, n)).astype(np.float32)
    if lanes is None:
        c, v = c[0], v[0]
    s, d, cc, vv = _dev(cuda, src, dst, c, v)
    before = ops.launches["edge_reweight"]
    r = ops.edge_reweight_r(s, d, cc, vv, eps)
    torch.cuda.synchronize()
    assert ops.launches["edge_reweight"] == before + 1
    assert r.shape == cc.shape
    v_pad = torch.cat([vv, torch.zeros_like(vv[..., :1])], dim=-1)
    want = ref.edge_reweight_ref(_zero_filled(s, n), _zero_filled(d, n), cc,
                                 v_pad, eps)
    np.testing.assert_array_equal(r.cpu().numpy(), want.cpu().numpy())


# the batched ELL kernels: B lanes of values over one shared cols; the
# tolerances of the single-instance tests above
@pytest.mark.parametrize("n,k", [(64, 4), (777, 9), (1531, 33)])
def test_ell_kernels_batched(cuda, n, k):
    rng = np.random.default_rng(n + k)
    b = 3
    cols = rng.integers(0, n, size=(n, k)).astype(np.int32)
    vals = rng.standard_normal((b, n, k)).astype(np.float32)
    diag = rng.uniform(1, 3, size=(b, n)).astype(np.float32)
    v = rng.standard_normal((b, n)).astype(np.float32)
    c, a, d, x = _dev(cuda, cols, vals, diag, v)
    y = ops.ell_spmv(c, a, d, x)
    np.testing.assert_allclose(y.cpu().numpy(),
                               ref.ell_spmv_ref(c, a, d, x).cpu().numpy(),
                               rtol=1e-5, atol=1e-4)
    c_ell = rng.uniform(0.1, 3.0, size=(b, n, k)).astype(np.float32)
    c_ell[rng.uniform(size=(b, n, k)) < 0.4] = 0.0
    c_s = rng.uniform(0, 2, size=(b, n)).astype(np.float32)
    c_t = rng.uniform(0, 2, size=(b, n)).astype(np.float32)
    vv = rng.uniform(0, 1, size=(b, n + 5)).astype(np.float32)   # halo tail
    args = _dev(cuda, cols, c_ell, c_s, c_t, vv)
    for got, want in zip(ops.fused_ell_sweep(*args, 1e-6),
                         ref.fused_ell_sweep_ref(*args, 1e-6)):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=3e-5, atol=1e-6)
    # one lane of the batch equals the same lane launched alone
    solo = ops.ell_spmv(c, a[1].contiguous(), d[1].contiguous(),
                        x[1].contiguous())
    assert torch.equal(solo, y[1])


def test_wrappers_reject_bad_inputs(cuda):
    x = torch.zeros(8, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        ops.ell_spmv(torch.zeros((8, 2), dtype=torch.int64, device=cuda),
                     torch.zeros((8, 2), device=cuda), x, x)
    with pytest.raises(ValueError, match="contiguous"):
        ops.block_diag_matvec(torch.zeros((2, 4, 4), device=cuda).transpose(1, 2),
                              torch.zeros((2, 4), device=cuda))
    with pytest.raises(ValueError, match="int32"):
        ops.edge_reweight_r(torch.zeros(2, dtype=torch.int64, device=cuda),
                            torch.zeros(2, dtype=torch.int64, device=cuda),
                            torch.ones(2, device=cuda), x, 1e-6)
    with pytest.raises(ValueError, match="shapes"):
        ops.ell_spmv(torch.zeros((8, 2), dtype=torch.int32, device=cuda),
                     torch.zeros((3, 8, 2), device=cuda),
                     torch.zeros((2, 8), device=cuda),
                     torch.zeros((3, 8), device=cuda))


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
    assert all(ops.launches[k] > 0 for k in ("ell_spmv", "fused_ell_sweep",
                                             "block_diag_matvec")), ops.launches
    assert ops.launches["edge_reweight"] == 0     # the fused path sweeps ELL
    cut_p, _, _ = pirmcut(pinst, IRLSConfig(**dict(kw, use_pallas=False)),
                          labels=labels)
    assert np.isfinite(v_k).all()
    assert cut_k.cut_value == pytest.approx(cut_p.cut_value, rel=1e-6)


def test_solve_batch_through_kernels_matches_plain_path(cuda, grid_instance):
    """The serving config (COO, adaptive, point Jacobi) under use_pallas
    solves a batch through the edge-reweight kernel, once per IRLS
    iteration, and reaches the plain path's cuts (rel 1e-4: index_add_
    sums with atomics on the card, in no fixed order)."""
    from repro_torch.core import IRLSConfig, MinCutSession, Problem
    from repro_torch.graphs.structures import instance_from_arrays

    inst = grid_instance
    pinst = instance_from_arrays(inst.graph.src, inst.graph.dst,
                                 inst.graph.weight, inst.graph.n,
                                 inst.s_weight, inst.t_weight)
    rng = np.random.default_rng(3)
    ws = [(np.asarray(inst.graph.weight) * rng.uniform(0.8, 1.2, inst.graph.m),
           inst.s_weight, inst.t_weight) for _ in range(4)]
    kw = dict(n_irls=8, n_blocks=1, precond="jacobi", irls_tol=1e-3,
              adaptive_tol=True, eps=1e-3)
    sess = MinCutSession(Problem.build(pinst, 1), IRLSConfig(**kw),
                         backend="scanned")
    ops.reset_launches()
    got = sess.solve_batch(ws, cfg=IRLSConfig(**kw, use_pallas=True))
    assert ops.launches["edge_reweight"] == kw["n_irls"]
    want = sess.solve_batch(ws)
    for g, w in zip(got, want):
        assert np.isfinite(g.voltages).all()
        assert g.cut_value == pytest.approx(w.cut_value, rel=1e-4)


def _flash_inputs(dev, rng, bkv, g, sq, sk, d, dtype):
    td = getattr(torch, dtype)
    q = rng.standard_normal((bkv * g, sq, d)).astype(np.float32)
    k = rng.standard_normal((bkv, sk, d)).astype(np.float32)
    v = rng.standard_normal((bkv, sk, d)).astype(np.float32)
    return tuple(t.to(td) for t in _dev(dev, q, k, v))


def _check_flash(q, k, v, g, causal, rtol):
    """The kernel against the dense plain version, each entry against its
    own scale (``ref.flash_fwd_scales``); lse at rel 1e-5."""
    scale = 1.0 / np.sqrt(q.shape[-1])
    kw = dict(g_per_kv=g, causal=causal, scale=scale)
    before = ops.launches["flash_fwd"]
    out, lse = ops.flash_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.launches["flash_fwd"] == before + 1
    want, want_lse = ref.flash_fwd_ref(q, k, v, **kw)
    s_out, s_lse = ref.flash_fwd_scales(q, k, v, **kw)
    assert out.dtype == q.dtype and out.shape == q.shape
    assert lse.dtype == torch.float32 and lse.shape == q.shape[:2]
    err = (out.float() - want.float()).abs()
    assert bool((err <= rtol * s_out).all()), float((err / s_out).max())
    err = (lse - want_lse).abs()
    assert bool((err <= 1e-5 * s_lse).all()), float((err / s_lse).max())


# float32: 3e-5 of each entry's scale (the Pallas sweep's tolerance; sums in
# another order).  bfloat16: three roundings to bf16 at u = 2^-8 (p before
# the p·v product on the kernel's side, out on both sides), plus 1e-4 for
# the float32 sums and exponentials.  Sq = Sk = 200 is not a multiple of the
# kernel's 64-row tile.
_FLASH_RTOL = {"float32": 3e-5, "bfloat16": 3 * 2.0 ** -8 + 1e-4}


@pytest.mark.parametrize("g", [1, 2, 6])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_fwd_kernel(cuda, g, d, causal, dtype):
    rng = np.random.default_rng(g * d + causal)
    q, k, v = _flash_inputs(cuda, rng, 2, g, 200, 200, d, dtype)
    _check_flash(q, k, v, g, causal, _FLASH_RTOL[dtype])


@pytest.mark.parametrize("sq,sk,causal", [(1, 1, True), (64, 64, True),
                                          (512, 512, True), (96, 333, False),
                                          (300, 17, False), (130, 70, True)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_fwd_kernel_lengths(cuda, sq, sk, causal, dtype):
    """Tile edges: one row, exact tiles, Sq ≠ Sk (causal aligns position 0
    of q with position 0 of k, as the TPU kernel does)."""
    rng = np.random.default_rng(sq + sk)
    q, k, v = _flash_inputs(cuda, rng, 3, 2, sq, sk, 128, dtype)
    _check_flash(q, k, v, 2, causal, _FLASH_RTOL[dtype])


def test_flash_fwd_rejects_bad_inputs(cuda):
    q = torch.zeros((4, 8, 128), dtype=torch.bfloat16, device=cuda)
    kv = torch.zeros((2, 8, 128), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_fwd(q[..., :32].contiguous(), kv[..., :32].contiguous(),
                      kv[..., :32].contiguous(), g_per_kv=2)
    with pytest.raises(ValueError, match="shapes"):
        ops.flash_fwd(q, kv, kv, g_per_kv=3)
    with pytest.raises(ValueError, match="dtype"):
        ops.flash_fwd(q, kv.float(), kv, g_per_kv=2)
    with pytest.raises(ValueError, match="float32"):
        ops.flash_fwd(q.half(), kv.half(), kv.half(), g_per_kv=2)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_fwd(q.transpose(1, 2).contiguous().transpose(1, 2), kv, kv,
                      g_per_kv=2)


# -- the redesigned kernels: ell_spmv's two variants, flash_fwd in place -----

def _ell_expected(cols, vals, diag, v):
    """y = diag⊙v + Σ vals⊙v[cols] in float64 with out-of-range columns
    gathering 0, and each row's Σ|terms| (the scale of its rounding)."""
    n = cols.shape[0]
    ok = (cols >= 0) & (cols < n)
    g = np.where(ok, v[..., np.where(ok, cols, 0)], 0.0)
    terms = vals * g
    y = diag * v + terms.sum(-1)
    return y, np.abs(diag * v) + np.abs(terms).sum(-1)


# k % 4 == 0 takes the vector variant (k = 4, 8, 32: one 16-byte chunk per
# thread; 64: two; 128: four), k = 9, 33 the scalar one; B = 12 spans two
# chunks of lanes.  float32: 1e-5 of Σ|terms| per row (k + 1 products summed
# in another order); bfloat16: the output's rounding (2^-8 of |y|) on top.
@pytest.mark.parametrize("k", [4, 8, 9, 32, 33, 64, 128])
@pytest.mark.parametrize("lanes", [1, 3, 8, 12])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ell_spmv_variants(cuda, k, lanes, dtype):
    rng = np.random.default_rng(100 * k + lanes)
    n = 1000 + k
    cols = rng.integers(0, n, size=(n, k)).astype(np.int32)
    cols[rng.uniform(size=(n, k)) < 0.02] = -1          # gathers 0
    cols[rng.uniform(size=(n, k)) < 0.02] = n + 3       # gathers 0
    lead = () if lanes == 1 else (lanes,)
    td = getattr(torch, dtype)
    vals, diag, v = (torch.as_tensor(rng.standard_normal(lead + s)
                                     .astype(np.float32)).to(td)
                     for s in ((n, k), (n,), (n,)))
    c, a, d, x = _dev(cuda, cols, vals, diag, v)
    before = ops.launches["ell_spmv"]
    y = ops.ell_spmv(c, a, d, x)
    torch.cuda.synchronize()
    assert ops.launches["ell_spmv"] == before + 1
    assert y.shape == lead + (n,) and y.dtype == td
    want, scale = _ell_expected(cols, *(t.double().numpy()
                                        for t in (vals, diag, v)))
    tol = 1e-5 * scale + (0.0 if dtype == "float32" else 2.0 ** -8 * np.abs(want))
    err = np.abs(y.double().cpu().numpy() - want)
    assert np.all(err <= tol), float((err / np.maximum(tol, 1e-30)).max())


def _flash_4d_inputs(dev, rng, b, g, kv, sq, sk, d, dtype):
    td = getattr(torch, dtype)
    shapes = ((b, sq, kv * g, d), (b, sk, kv, d), (b, sk, kv, d))
    return tuple(torch.as_tensor(rng.standard_normal(s).astype(np.float32),
                                 device=dev).to(td) for s in shapes)


def _check_flash_4d(q, k, v, g, causal, rtol):
    """The kernel on the model's layout against the plain version on the
    regrouped tensors, each entry against its own scale; lse at 1e-5."""
    kw = dict(g_per_kv=g, causal=causal, scale=1.0 / np.sqrt(q.shape[-1]))
    before = ops.launches["flash_fwd"]
    out, lse = ops.flash_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.launches["flash_fwd"] == before + 1
    assert out.shape == q.shape and out.dtype == q.dtype
    q3, k3, v3 = ops._regroup(q, k, v)
    want, want_lse = ref.flash_fwd_ref(q3, k3, v3, **kw)
    s_out, s_lse = ref.flash_fwd_scales(q3, k3, v3, **kw)
    out3, _, _ = ops._regroup(out, k, v)
    err = (out3.float() - want.float()).abs()
    assert bool((err <= rtol * s_out).all()), float((err / s_out).max())
    err = (lse - want_lse).abs()
    assert bool((err <= 1e-5 * s_lse).all()), float((err / s_lse).max())
    return out, lse


@pytest.mark.parametrize("g", [1, 2, 6])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", [(1, 1), (65, 65), (200, 333), (4096, 4096)])
def test_flash_fwd_kernel_4d(cuda, g, d, causal, sq, sk):
    """bf16 in the model's [B, S, H, D] layout, read and written in place:
    tile edges (one row, 65 rows and keys, Sq ≠ Sk) and the path's length."""
    rng = np.random.default_rng(g * d + sq + causal)
    b, kv = (1, 1) if sq == 4096 else (2, 2)
    q, k, v = _flash_4d_inputs(cuda, rng, b, g, kv, sq, sk, d, "bfloat16")
    _check_flash_4d(q, k, v, g, causal, _FLASH_RTOL["bfloat16"])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_fwd_kernel_4d_strided(cuda, dtype, causal):
    """q, k and v as slices of one packed [B, S, H + 2 KV, D] projection:
    row strides that are not the tensors' own widths."""
    rng = np.random.default_rng(5 + causal)
    b, s, g, kv, d = 2, 150, 3, 2, 128
    qkv = torch.as_tensor(rng.standard_normal((b, s, (g + 2) * kv, d))
                          .astype(np.float32), device=cuda).to(getattr(torch, dtype))
    h = g * kv
    q, k, v = qkv[:, :, :h], qkv[:, :, h:h + kv], qkv[:, :, h + kv:]
    assert not q.is_contiguous()
    _check_flash_4d(q, k, v, g, causal, _FLASH_RTOL[dtype])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_fwd_4d_equals_3d(cuda, dtype):
    """A 4-D call gives the same bytes as the 3-D call on the regrouped
    tensors (the same blocks do the same arithmetic)."""
    rng = np.random.default_rng(9)
    q, k, v = _flash_4d_inputs(cuda, rng, 2, 2, 3, 333, 333, 128, dtype)
    kw = dict(g_per_kv=2, causal=True, scale=0.1)
    out4, lse4 = ops.flash_fwd(q, k, v, **kw)
    q3, k3, v3 = (t.contiguous() for t in ops._regroup(q, k, v))
    out3, lse3 = ops.flash_fwd(q3, k3, v3, **kw)
    assert torch.equal(ops._regroup(out4, k, v)[0], out3)
    assert torch.equal(lse4, lse3)


def test_flash_fwd_rejects_misaligned_layouts(cuda):
    q, k, v = _flash_4d_inputs(cuda, np.random.default_rng(0), 1, 2, 1, 64, 64,
                               128, "bfloat16")
    wide = torch.zeros((1, 64, 2, 132), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        ops.flash_fwd(wide[..., :128], k, v, g_per_kv=2)     # row of 264 bytes
    flat = torch.zeros(q.numel() + 8, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="16-byte boundary"):
        ops.flash_fwd(flat[1:1 + q.numel()].view(q.shape), k, v, g_per_kv=2)
    with pytest.raises(ValueError, match="contiguous last dim"):
        ops.flash_fwd(q.transpose(1, 3).contiguous().transpose(1, 3), k, v,
                      g_per_kv=2)
    with pytest.raises(ValueError, match="shapes"):
        ops.flash_fwd(q, k, v, g_per_kv=1)
    with pytest.raises(ValueError, match="positive scale"):
        ops.flash_fwd(q, k, v, g_per_kv=2, scale=-0.1)
