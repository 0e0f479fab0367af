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
# version's order (correctly rounded square root and division).  m % 4 == 0
# takes the vector variant (groups of 4 edges), any other m the scalar one;
# the lane counts run the vector variant's prefetch of the next lane's
# weights with and without a next lane
@pytest.mark.parametrize("m,n", [(100, 64), (5000, 300), (12288, 1024),
                                 (1001, 64), (4, 8), (3, 8), (0, 8)])
@pytest.mark.parametrize("lanes", [None, 3, 1, 2, 5, 8, 16])
@pytest.mark.parametrize("eps", [1e-6, 1e-2])
def test_edge_reweight_kernel(cuda, m, n, lanes, eps):
    """One instance and a batch of lanes over shared src/dst; a few indices
    out of range gather 0, as the TPU kernel's fill_value=0 does.  Where
    m ≥ 32 they sit at every place of the vector variant's groups of 4
    edges, in src and in dst, each in a group of its own; at m = 4 one
    sits at each place of the one group."""
    rng = np.random.default_rng(m + n)
    b = 1 if lanes is None else lanes
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    k = min(m, 8)
    if m // 4 >= k:
        pos = rng.choice(m // 4, k, replace=False) * 4 + np.arange(k) % 4
    else:
        pos = rng.choice(m, k, replace=False)
    src[pos[:k // 2]] = [n, n + 7, -1, 2 ** 31 - 1][:k // 2]
    dst[pos[k // 2:]] = [n + 1, -5, -2 ** 31, n][:k - k // 2]
    c = rng.uniform(0.1, 3.0, (b, m)).astype(np.float32)
    v = rng.uniform(0, 1, (b, n)).astype(np.float32)
    if lanes is None:
        c, v = c[0], v[0]
    s, d, cc, vv = _dev(cuda, src, dst, c, v)
    before = ops.launches["edge_reweight"]
    r = ops.edge_reweight_r(s, d, cc, vv, eps)
    torch.cuda.synchronize()
    assert ops.launches["edge_reweight"] == before + (m > 0)
    assert r.shape == cc.shape
    v_pad = torch.cat([vv, torch.zeros_like(vv[..., :1])], dim=-1)
    want = ref.edge_reweight_ref(_zero_filled(s, n), _zero_filled(d, n), cc,
                                 v_pad, eps)
    np.testing.assert_array_equal(r.cpu().numpy(), want.cpu().numpy())


@pytest.mark.parametrize("off", [1, 2, 3])
def test_edge_reweight_kernel_off_16_byte_boundary(cuda, off):
    """src, dst and c as contiguous 1-D slices that start ``off`` entries
    into their buffers (m % 4 == 0, B = 1): the scalar variant, bit for bit;
    the same slices at offset 0 take the vector variant, with equal r."""
    m, n = 4096, 500
    rng = np.random.default_rng(off)
    src = rng.integers(0, n, m + 4).astype(np.int32)
    dst = rng.integers(0, n, m + 4).astype(np.int32)
    src[off + 9], dst[off + 10] = n + 3, -1
    c = rng.uniform(0.1, 3.0, m + 4).astype(np.float32)
    v = rng.uniform(0, 1, n).astype(np.float32)
    s, d, cc, vv = _dev(cuda, src, dst, c, v)
    s1, d1, c1 = s[off:off + m], d[off:off + m], cc[off:off + m]
    assert all(t.is_contiguous() for t in (s1, d1, c1))
    assert ops._er_plan(m, ops._aligned(s1, d1, c1)).edges == 1
    r = ops.edge_reweight_r(s1, d1, c1, vv, 1e-6)
    v_pad = torch.cat([vv, torch.zeros_like(vv[:1])])
    want = ref.edge_reweight_ref(_zero_filled(s1, n), _zero_filled(d1, n), c1,
                                 v_pad, 1e-6)
    np.testing.assert_array_equal(r.cpu().numpy(), want.cpu().numpy())
    s0, d0, c0 = (t.clone() for t in (s1, d1, c1))
    assert ops._er_plan(m, ops._aligned(s0, d0, c0)).edges == 4
    assert torch.equal(ops.edge_reweight_r(s0, d0, c0, vv, 1e-6), r)


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


# -- the redesigned graph kernels: fused_ell_sweep's two variants,
# block_diag_matvec's persistent vector variant and its scalar one ----------

def _sweep_expected(cols, c_ell, c_s, c_t, v, eps):
    """The plain version with columns outside [0, nv) pointed at an
    appended 0 entry of v (the kernels gather 0 there)."""
    nv = v.shape[-1]
    v_pad = torch.cat([v, torch.zeros_like(v[..., :1])], dim=-1)
    return ref.fused_ell_sweep_ref(_zero_filled(cols, nv), c_ell, c_s, c_t,
                                   v_pad, eps)


def _held(got, want, rtol):
    """|got − want| ≤ rtol·|want| entry by entry, for every output."""
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        d = (g - w).abs()
        assert bool((d <= rtol * w.abs()).all()), float((d / w.abs()).max())


# k % 4 == 0 takes the vector variant (4, 8, 32: one 16-byte chunk per
# thread; 64: two; 128: four), 9 and 33 the scalar one; B = 12 spans two
# chunks of lanes.  rtol 3e-5 of each entry: each r is c²·rsqrt(·) within 2
# ulp, each diagonal a sum of positive terms in another order.
@pytest.mark.parametrize("k", [4, 8, 9, 32, 33, 64, 128])
@pytest.mark.parametrize("lanes", [1, 3, 8, 12])
def test_fused_ell_sweep_variants(cuda, k, lanes):
    """Halo-extended v (nv > n), columns out of range, zero weights and
    absent terminals, one launch per call."""
    rng = np.random.default_rng(10 * k + lanes)
    n = 1000 + k
    nv = n + 37
    lead = () if lanes == 1 else (lanes,)
    cols = rng.integers(0, nv, size=(n, k)).astype(np.int32)
    cols[rng.uniform(size=(n, k)) < 0.02] = -1
    cols[rng.uniform(size=(n, k)) < 0.02] = nv + 3
    c_ell = rng.uniform(0.1, 3.0, size=lead + (n, k)).astype(np.float32)
    c_ell[rng.uniform(size=c_ell.shape) < 0.4] = 0.0
    c_s = rng.uniform(0, 2, size=lead + (n,)).astype(np.float32)
    c_t = rng.uniform(0, 2, size=lead + (n,)).astype(np.float32)
    c_s[rng.uniform(size=c_s.shape) < 0.3] = 0.0
    c_t[rng.uniform(size=c_t.shape) < 0.3] = 0.0
    v = rng.uniform(0, 1, size=lead + (nv,)).astype(np.float32)
    args = _dev(cuda, cols, c_ell, c_s, c_t, v)
    before = ops.launches["fused_ell_sweep"]
    got = ops.fused_ell_sweep(*args, 1e-6)
    torch.cuda.synchronize()
    assert ops.launches["fused_ell_sweep"] == before + 1
    _held(got, _sweep_expected(*args, 1e-6), 3e-5)


def test_fused_ell_sweep_misaligned_takes_scalar_variant(cuda):
    """c_ell off a 16-byte boundary: the scalar variant gives the same
    result as the vector variant on an aligned copy."""
    rng = np.random.default_rng(3)
    n, k = 777, 32
    cols = rng.integers(0, n, size=(n, k)).astype(np.int32)
    c_ell = rng.uniform(0.1, 3.0, size=(n, k)).astype(np.float32)
    c_s, c_t = (rng.uniform(0, 2, size=n).astype(np.float32) for _ in range(2))
    v = rng.uniform(0, 1, size=n).astype(np.float32)
    c, w, s, t, x = _dev(cuda, cols, c_ell, c_s, c_t, v)
    buf = torch.zeros(n * k + 1, device=cuda)
    shifted = buf[1:].view(n, k)
    shifted.copy_(w)
    assert ops._vector_group_log2(k, c, shifted) == -1
    want = ref.fused_ell_sweep_ref(c, w, s, t, x, 1e-6)
    for c_in in (w, shifted):
        _held(ops.fused_ell_sweep(c, c_in, s, t, x, 1e-6), want, 3e-5)


@pytest.mark.parametrize("lead", [(), (3,)])
def test_fused_ell_sweep_no_rows(cuda, lead):
    """n = 0 rows: empty outputs, and no launch is counted (the kernel's
    entry launches nothing)."""
    cols = torch.zeros((0, 8), dtype=torch.int32, device=cuda)
    c_ell = torch.zeros(lead + (0, 8), device=cuda)
    c_s, c_t, v = (torch.zeros(lead + (0,), device=cuda) for _ in range(3))
    before = ops.launches["fused_ell_sweep"]
    got = ops.fused_ell_sweep(cols, c_ell, c_s, c_t, v, 1e-6)
    torch.cuda.synchronize()
    assert ops.launches["fused_ell_sweep"] == before
    assert [tuple(t.shape) for t in got] == [lead + (0, 8)] + [lead + (0,)] * 3


@pytest.mark.parametrize("bs", [16, 30])
def test_block_diag_matvec_no_blocks(cuda, bs):
    """P = 0 blocks: an empty result, and no launch is counted."""
    A = torch.zeros((0, bs, bs), device=cuda)
    x = torch.zeros((0, bs), device=cuda)
    before = ops.launches["block_diag_matvec"]
    y = ops.block_diag_matvec(A, x)
    torch.cuda.synchronize()
    assert ops.launches["block_diag_matvec"] == before
    assert tuple(y.shape) == (0, bs)


def _bdm_held(A, x):
    """The kernel against the plain version at 1e-5 of Σ|A||x| per row (dot
    products of length bs in another order), one launch per call."""
    before = ops.launches["block_diag_matvec"]
    y = ops.block_diag_matvec(A, x)
    torch.cuda.synchronize()
    assert ops.launches["block_diag_matvec"] == before + 1
    want = ref.block_diag_matvec_ref(A, x)
    scale = ref.block_diag_matvec_ref(A.abs(), x.abs())
    d = (y - want).abs()
    assert bool((d <= 1e-5 * scale).all()), float((d / scale).max())


# bs % 4 == 0 up to 512 takes the vector variant (16, 100: one float4 per
# lane, G = 4 and 32; 128; 200: two; 512: four), 30 and 600 the scalar one;
# p from one block of the grid to thousands
@pytest.mark.parametrize("bs", [16, 30, 100, 128, 200, 512, 600])
@pytest.mark.parametrize("p", [1, 7, 300, 2000])
def test_block_diag_matvec_variants(cuda, bs, p):
    if bs == 600 and p == 2000:
        p = 900        # 2.9 GB of blocks is enough for the scalar variant
    gen = torch.Generator(device=cuda).manual_seed(bs * 7 + p)
    A = torch.randn((p, bs, bs), generator=gen, device=cuda)
    x = torch.randn((p, bs), generator=gen, device=cuda)
    _bdm_held(A, x)


def test_block_diag_matvec_lanes_of_blocks(cuda):
    """A batch's explicit inverses as the batched preconditioner makes them,
    [B·P, bs, bs] (B = 3 lanes of a 16³ grid's 8³ boxes), and x gathered
    from the lanes' vectors."""
    from repro_torch.core import DeviceGraph, Problem, laplacian as lap
    from repro_torch.core import precond as pc
    from repro_torch.graphs import generators as gen

    side = 16
    inst = gen.segmentation_instance(gen.grid_3d(side, side, side, conn=26,
                                                 seed=0), (side,) * 3, seed=1)
    idx = np.arange(side ** 3)
    z, y, x = idx // side ** 2, (idx // side) % side, idx % side
    prob = Problem.build(inst, n_blocks=8,
                         labels=(z // 8) * 4 + (y // 8) * 2 + x // 8)
    g = prob.device_graph(torch.float32, device=cuda)
    plan = prob.block_plan(cuda)
    rng = np.random.default_rng(4)
    scale = torch.as_tensor(rng.uniform(0.5, 2.0, (3, 1)), dtype=torch.float32,
                            device=cuda)
    gb = DeviceGraph(src=g.src, dst=g.dst, c=g.c * scale, c_s=g.c_s * scale,
                     c_t=g.c_t * scale)
    M = pc.factorize_blocks(plan, lap.initial_weights(gb), explicit_inverse=True)
    assert M.inv.shape == (3 * plan.p, plan.bs, plan.bs)
    v = torch.as_tensor(rng.standard_normal((3, g.n)), dtype=torch.float32,
                        device=cuda)
    _bdm_held(M.inv, pc.gather_blocks(plan, v))


def test_block_diag_matvec_misaligned_takes_scalar_variant(cuda):
    gen = torch.Generator(device=cuda).manual_seed(5)
    A = torch.randn((40, 128, 128), generator=gen, device=cuda)
    buf = torch.zeros(A.numel() + 1, device=cuda)
    shifted = buf[1:].view(A.shape)
    shifted.copy_(A)
    x = torch.randn((40, 128), generator=gen, device=cuda)
    assert ops._bdm_plan(40, 128, ops._aligned(shifted, x)).g_log2 == -1
    _bdm_held(shifted, x)


# -- delta staging of the fused-ELL weight table on the card ----------------

def test_delta_staged_solve_batch_through_kernels(cuda):
    """The delta-staged fused-ELL ``solve_batch`` on a small grid, through
    the kernels: bit-equal to the unstaged batch (voltages, cuts, PCG
    counts) with the same launch counts, under deterministic algorithms
    (the initial system's scatters then sum in one order)."""
    from repro_torch.core import IRLSConfig, MinCutSession, Problem, Weights
    from repro_torch.graphs import generators as gen

    side, lanes = 32, 4
    inst = gen.segmentation_instance(gen.grid_2d(side, side, seed=0),
                                     (side, side), seed=1)
    cfg = IRLSConfig(n_irls=6, pcg_max_iters=20, precond="jacobi", n_blocks=1,
                     layout="ell", fuse_edge_sweep=True, use_pallas=True)
    sess = MinCutSession(Problem.build(inst, 1), cfg, backend="scanned",
                         device=cuda)
    rng = np.random.default_rng(0)
    c = np.asarray(inst.graph.weight, dtype=np.float64)
    torch.use_deterministic_algorithms(True)
    try:
        for rnd in range(3):
            ws = []
            for _ in range(lanes):
                c = c.copy()
                idx = rng.choice(c.size, size=10, replace=False)
                c[idx] *= np.exp(rng.normal(0.0, 0.3, size=10))
                ws.append(Weights(c, inst.s_weight, inst.t_weight))
            counts = []
            for keys in (["t"] * lanes, None):
                before = dict(ops.launches)
                out = sess.solve_batch(ws, rounding="sweep", delta_keys=keys)
                torch.cuda.synchronize()
                counts.append({k: ops.launches[k] - before[k]
                               for k in before})
                if keys is not None:
                    keyed = out
            for a, b in zip(keyed, out):
                np.testing.assert_array_equal(a.voltages, b.voltages)
                assert a.cut_value == b.cut_value
                np.testing.assert_array_equal(a.pcg_iters, b.pcg_iters)
            assert counts[0] == counts[1], counts
            assert counts[0]["fused_ell_sweep"] == cfg.n_irls
            assert counts[0]["ell_spmv"] > 0
    finally:
        torch.use_deterministic_algorithms(False)
    assert [r.telemetry["delta"]["mode"] for r in keyed] == ["delta"] * lanes
    assert keyed[0].telemetry["delta"]["changed_edges"] == 10


# -- cut trees through edge_reweight ------------------------------------------

# the cut-tree build's batches: up to 64 lanes over grids of side 6, 32, 64
@pytest.mark.parametrize("m,n", [(60, 36), (1984, 1024), (8064, 4096)])
def test_edge_reweight_kernel_cut_tree_lanes(cuda, m, n):
    """B = 64 lanes over one small graph (the cut-tree build's widest
    batch), bit for bit against the plain version."""
    rng = np.random.default_rng(m)
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    c = rng.uniform(0.1, 3.0, (64, m)).astype(np.float32)
    v = rng.uniform(0, 1, (64, n)).astype(np.float32)
    s, d, cc, vv = _dev(cuda, src, dst, c, v)
    before = ops.launches["edge_reweight"]
    r = ops.edge_reweight_r(s, d, cc, vv, 1e-6)
    torch.cuda.synchronize()
    assert ops.launches["edge_reweight"] == before + 1
    want = ref.edge_reweight_ref(s.long(), d.long(), cc, vv, 1e-6)
    np.testing.assert_array_equal(r.cpu().numpy(), want.cpu().numpy())


def test_cut_tree_through_edge_reweight_matches_plain_route(cuda):
    """A side-6 grid's IRLS cut tree built through ``edge_reweight``
    (``use_pallas=True``) under deterministic algorithms: array-equal to
    the same build on the plain route on the card (parent, weight, sides,
    acceptance order), with one launch per IRLS iteration of every
    ``solve_batch`` call."""
    import dataclasses

    from repro_torch.cuttree import DEFAULT_CFG, build_cut_tree
    from repro_torch.graphs import generators as gen

    inst = gen.segmentation_instance(gen.grid_2d(6, 6, seed=2), (6, 6),
                                     seed=3)
    trees = {}
    torch.use_deterministic_algorithms(True)
    try:
        for use_pallas in (True, False):
            cfg = dataclasses.replace(DEFAULT_CFG, use_pallas=use_pallas)
            before = ops.launches["edge_reweight"]
            trees[use_pallas] = build_cut_tree(inst, cfg=cfg, max_batch=8,
                                               device=cuda)
            torch.cuda.synchronize()
            launched = ops.launches["edge_reweight"] - before
            calls = sum(-(-w // 8)
                        for w in trees[use_pallas].meta["wave_sizes"])
            assert launched == (cfg.n_irls * calls if use_pallas else 0)
    finally:
        torch.use_deterministic_algorithms(False)
    a, b = trees[True], trees[False]
    np.testing.assert_array_equal(a.parent, b.parent)
    np.testing.assert_array_equal(a.weight, b.weight)
    np.testing.assert_array_equal(a.sides, b.sides)
    assert a.meta["order"] == b.meta["order"]


# -- the sharded solver at world one (NCCL) -----------------------------------

@pytest.mark.parametrize("schedule,fuse,kernel", [
    ("halo", True, "fused_ell_sweep"), ("halo", False, "edge_reweight"),
    ("psum", True, "edge_reweight")])
def test_sharded_world_one_kernel_route_matches_plain_route(
        cuda, schedule, fuse, kernel):
    """``ShardedSolver`` in a world of one over NCCL, under deterministic
    algorithms: the kernel route (``use_pallas``) launches its kernel once
    per IRLS iteration on the shard's own tensors and reaches the plain
    route's cut; ``edge_reweight`` is bit-equal to its plain version, so
    its routes give the same voltages bit for bit."""
    import dataclasses

    import torch.distributed as dist
    from repro_torch.core import IRLSConfig, two_level
    from repro_torch.distributed.solver import ShardedSolver
    from repro_torch.graphs import generators as gen

    inst = gen.segmentation_instance(gen.grid_2d(24, 24, seed=3), (24, 24),
                                     seed=4)
    cfg = IRLSConfig(n_irls=8, pcg_max_iters=40, fuse_edge_sweep=fuse,
                     use_pallas=True)
    out = {}
    torch.use_deterministic_algorithms(True)
    try:
        for use_pallas in (True, False):
            before = dict(ops.launches)
            s = ShardedSolver(inst, dataclasses.replace(cfg,
                                                        use_pallas=use_pallas),
                              schedule=schedule, precond_bs=64, device=cuda)
            v, _, _ = s.solve()
            torch.cuda.synchronize()
            launched = {k: ops.launches[k] - before[k] for k in before}
            want = {k: 0 for k in before}
            if use_pallas:
                want[kernel] = cfg.n_irls
            assert launched == want
            out[use_pallas] = (v, two_level(inst, v).cut_value)
    finally:
        torch.use_deterministic_algorithms(False)
    assert dist.get_world_size() == 1
    assert "nccl" in str(dist.get_backend()).lower()
    assert out[True][1] == pytest.approx(out[False][1], rel=1e-5)
    if kernel == "edge_reweight":
        np.testing.assert_array_equal(out[True][0], out[False][0])
