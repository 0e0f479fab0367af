"""Wrappers around the hand-written CUDA kernels (``csrc/``).

Each wrapper runs its kernel's plain PyTorch version (``ref.py``) when its
tensors lie on the CPU, and only then.  For CUDA tensors it checks device,
dtype, shape and contiguity, allocates the outputs, launches the kernel on
the current stream and raises if the launch fails; it never falls back.

Every graph-kernel wrapper takes one instance or a batch of B same-topology
lanes: the per-lane tensors carry a leading lane dimension, the index tensors
(``cols``, ``src``, ``dst``) are shared and passed once.

``launches`` counts the kernel launches per wrapper (plain-version calls do
not count), so a run can show that its path went through the kernels.  The
serving engine launches from several worker threads, so the counts change
under ``_launch_lock``.

A wrapper given fake tensors (``torch._subclasses.FakeTensor``: a planning
run of ``launch.hlo_analysis``, shapes without storage) builds and launches
nothing and counts nothing in ``launches``: it returns outputs of the
launch's shapes and hands the launch to the sink that ``planning`` installs,
with the flops and bytes of PERF.md's kernel table (the terms
``chip_smoke.py`` divides by for ``bound_ms``).
"""
from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import Callable, Dict, NamedTuple, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor

from . import build, ref
from ..core.incidence import eps_sq

launches: Dict[str, int] = {"ell_spmv": 0, "fused_ell_sweep": 0,
                            "block_diag_matvec": 0, "edge_reweight": 0,
                            "flash_fwd": 0}
_launch_lock = threading.Lock()

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "ell_spmv_f32": ("ell_spmv", [_P] * 5 + [_I] * 5 + [_P]),
    "ell_spmv_bf16": ("ell_spmv", [_P] * 5 + [_I] * 5 + [_P]),
    "fused_ell_sweep_f32": ("fused_ell_sweep",
                            [_P] * 5 + [_F] + [_P] * 4 + [_I] * 5 + [_P]),
    "block_diag_matvec_f32": ("block_diag_matvec", [_P] * 3 + [_I] * 5 + [_P]),
    "edge_reweight_f32": ("edge_reweight",
                          [_P] * 4 + [_F, _P, _L] + [_I] * 4 + [_P]),
    "flash_fwd_bf16": ("flash_fwd", [_P] * 5 + [_I] * 6
                       + [ctypes.POINTER(_L), _I, _F, _P]),
    "flash_fwd_f32": ("flash_fwd", [_P] * 5 + [_I] * 6
                      + [ctypes.POINTER(_L), _I, _F, _P]),
}
_fns: Dict[str, ctypes._CFuncPtr] = {}


class PlannedLaunch(NamedTuple):
    """One launch of a planning run: the kernel, its operands' shapes, and
    its flops and bytes (each input read once, each output written once)."""
    name: str
    shapes: tuple
    flops: float
    bytes: float


_plan_sink: Optional[Callable[[PlannedLaunch], None]] = None


@contextlib.contextmanager
def planning(sink: Callable[[PlannedLaunch], None]):
    """Hand every planned launch to ``sink`` while the context is open."""
    global _plan_sink
    prev, _plan_sink = _plan_sink, sink
    try:
        yield
    finally:
        _plan_sink = prev


def _fake(*tensors: torch.Tensor) -> bool:
    return any(isinstance(t, FakeTensor) for t in tensors)


def _planned(name: str, inputs, outputs, flops: float):
    """Record a planned launch of ``name`` and return ``outputs``."""
    if _plan_sink is not None:
        nb = sum(t.numel() * t.element_size() for t in (*inputs, *outputs))
        _plan_sink(PlannedLaunch(name, tuple(tuple(t.shape) for t in inputs),
                                 float(flops), float(nb)))
    return outputs


def flash_flops(bh: int, sq: int, sk: int, d: int, causal: bool) -> int:
    """The attention forward's flops for its mask: two products of 2·D
    flops for every (row, key) pair the mask keeps."""
    if not causal:
        pairs = sq * sk
    elif sq <= sk:
        pairs = sq * (sq + 1) // 2
    else:
        pairs = sk * (sk + 1) // 2 + (sq - sk) * sk
    return 4 * d * bh * pairs


def reset_launches() -> None:
    with _launch_lock:
        for name in launches:
            launches[name] = 0


def _count(name: str) -> None:
    with _launch_lock:
        launches[name] += 1


def _fn(symbol: str):
    fn = _fns.get(symbol)
    if fn is None:
        lib_name, argtypes = _SIGNATURES[symbol]
        fn = getattr(build.load(lib_name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


def _launch(symbol: str, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _fn(symbol)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {symbol} failed to launch "
                           f"(cudaError {rc})")


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU; raises when the tensors are
    spread over devices or lie on a device other than CPU or CUDA."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type == "cpu":
        return True
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    return False


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _contiguous(**tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        _require(t.is_contiguous(), f"{name} must be contiguous")


# the ELL kernels put the lane on the grid's y index
_MAX_LANES = 65535


def _lanes(t: torch.Tensor, inner: int) -> int:
    """Lanes of a per-lane tensor whose last ``inner`` dims are the
    instance's own: 1 without a lane dim, B with one."""
    if t.dim() == inner:
        return 1
    _require(t.dim() == inner + 1, f"expected {inner} or {inner + 1} dims, "
             f"got shape {tuple(t.shape)}")
    _require(t.shape[0] <= _MAX_LANES, f"at most {_MAX_LANES} lanes, got "
             f"{t.shape[0]}")
    return t.shape[0]


def _log2_cover(n: int, cap_log2: int) -> int:
    """log2 of the smallest power of two ≥ n, at most 2^cap_log2."""
    g = 0
    while (1 << g) < n and g < cap_log2:
        g += 1
    return g


def _group(k: int) -> int:
    """Lanes per row: the smallest power of two >= k, at most a warp."""
    return 1 << _log2_cover(k, 5)


def _aligned(*tensors: torch.Tensor) -> bool:
    """Every tensor starts on a 16-byte boundary (the kernels' 16-byte
    loads and stores)."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


# the ELL sweep's vector variant loads 4 slots at a time, k/4 ≤ 8 threads
# per row and at most 4 chunks per thread
_VEC_MAX_K = 128


def _vector_group_log2(k: int, *tensors: torch.Tensor) -> int:
    """The variant of the ELL sweep for width ``k``: log2 of the vector
    variant's threads per row (the smallest power of two ≥ k/4, at most 8),
    or −1 for the scalar variant (``_group(k)`` lanes per row, which the
    kernel derives from k) where k % 4 ≠ 0, k > 128, k = 0 or a tensor
    read with 16-byte loads (``cols``, ``c_ell``) does not start on a
    16-byte boundary."""
    if k == 0 or k % 4 or k > _VEC_MAX_K or not _aligned(*tensors):
        return -1
    return _log2_cover(k // 4, 3)


# block_diag_matvec's vector variant (csrc/block_diag_matvec.cu: WARPS,
# IN_FLIGHT): warps per block, float4 loads of A in flight per thread (a
# unit's loads); units per warp (the grid is many short blocks); rows up to
# 512 floats
_BDM_WARPS, _BDM_IN_FLIGHT, _BDM_UNITS_PER_WARP = 8, 8, 2
_BDM_VEC_MAX_BS = 512


class BdmPlan(NamedTuple):
    """Launch geometry of ``block_diag_matvec``: a group of 2^g_log2 lanes
    per row reading ``nch`` float4s each, on ``grid`` thread blocks.  The
    kernel cuts the P·bs rows into units of R = ``_bdm_unit_rows`` rows of
    one block, ⌈bs/R⌉ units per block (unit u holds rows (u mod ⌈bs/R⌉)·R
    + [0, R) of block u div ⌈bs/R⌉, those below bs); thread block b takes
    units [b·U/grid, (b+1)·U/grid) of the U = P·⌈bs/R⌉, and its warp i the
    units b·U/grid + i, + i + W, ... of that range (W = ``_BDM_WARPS``).
    g_log2 = −1: the scalar variant, one block per p."""
    g_log2: int
    nch: int
    grid: int


def _bdm_unit_rows(g_log2: int, nch: int) -> int:
    """Rows of a unit of the vector variant: 32/G rows a warp step, one
    step per ``nch`` of a thread's ``_BDM_IN_FLIGHT`` loads (the kernel's
    entry derives the same)."""
    return (32 >> g_log2) * (_BDM_IN_FLIGHT // nch)


def _bdm_plan(p: int, bs: int, aligned: bool = True) -> BdmPlan:
    """The variant and grid of ``block_diag_matvec`` for P = p blocks of
    bs²: the vector variant where bs % 4 = 0, bs ≤ 512 and A and x are
    ``aligned`` to 16 bytes, with ``_BDM_UNITS_PER_WARP`` units per warp;
    else the scalar one."""
    if bs % 4 or bs > _BDM_VEC_MAX_BS or not aligned:
        return BdmPlan(-1, 0, p)
    k4 = bs // 4
    g_log2 = _log2_cover(k4, 5)
    nch = -(-k4 >> g_log2)
    nch = 4 if nch == 3 else nch           # the kernel has 1, 2 and 4
    units = p * -(-bs // _bdm_unit_rows(g_log2, nch))
    grid = max(1, -(-units // (_BDM_WARPS * _BDM_UNITS_PER_WARP)))
    return BdmPlan(g_log2, nch, grid)


# edge_reweight (csrc/edge_reweight.cu: BLOCK, EDGES): threads per block,
# edges per thread of the vector variant; the scalar variant's grid-stride
# loop runs on at most 64 blocks an SM of the card's 132
_ER_BLOCK, _ER_EDGES = 256, 4
_ER_SCALAR_MAX_GRID = 132 * 64


class ErPlan(NamedTuple):
    """Launch geometry of ``edge_reweight``: ``grid`` blocks of
    ``_ER_BLOCK`` threads in a grid-stride loop; thread t of block b takes
    work items b·_ER_BLOCK + t, + grid·_ER_BLOCK, ..., each of ``edges``
    consecutive edges: ``_ER_EDGES`` for the vector variant, 1 for the
    scalar one."""
    edges: int
    grid: int


def _er_plan(m: int, aligned: bool = True) -> ErPlan:
    """The variant and grid of ``edge_reweight`` for m ≥ 1 edges, any
    number of lanes: the vector variant where m % 4 == 0 and src, dst and c
    are ``aligned`` to 16 bytes (every lane's row then is; the wrapper's
    freshly allocated r always is), on a one-shot grid (one work item a
    thread); else the scalar one on at most ``_ER_SCALAR_MAX_GRID``
    blocks."""
    if m % _ER_EDGES or not aligned:
        return ErPlan(1, min(-(-m // _ER_BLOCK), _ER_SCALAR_MAX_GRID))
    return ErPlan(_ER_EDGES, -(-(m // _ER_EDGES) // _ER_BLOCK))


def ell_spmv(cols: torch.Tensor, vals: torch.Tensor, diag: torch.Tensor,
             v: torch.Tensor) -> torch.Tensor:
    """ELLPACK SpMV  y = diag⊙v + Σ_lane vals⊙v[cols]  (float32 or bfloat16;
    the CUDA kernel sums in float32).  Batched: ``vals`` (B, n, k), ``diag``
    and ``v`` (B, n) over one shared ``cols`` (n, k).  A plan counts every
    slot as stored (the stored count is the data's)."""
    if _fake(cols, vals, diag, v):
        (y,) = _planned("ell_spmv", (cols, vals, diag, v),
                        (v.new_empty(v.shape),),
                        2 * vals.numel() + 2 * v.numel())
        return y
    if _on_cpu(cols, vals, diag, v):
        return ref.ell_spmv_ref(cols, vals, diag, v)
    n, k = cols.shape
    b = _lanes(v, 1)
    lead = tuple(v.shape[:-1])
    _require(cols.dtype == torch.int32, "cols must be int32")
    _require(v.dtype in (torch.float32, torch.bfloat16),
             f"v must be float32 or bfloat16, got {v.dtype}")
    _require(vals.dtype == diag.dtype == v.dtype,
             "vals, diag and v must share one dtype")
    _require(vals.shape == lead + (n, k) and diag.shape == lead + (n,)
             and v.shape == lead + (n,),
             f"shapes: cols {tuple(cols.shape)}, vals {tuple(vals.shape)}, "
             f"diag {tuple(diag.shape)}, v {tuple(v.shape)}")
    _contiguous(cols=cols, vals=vals, diag=diag, v=v)
    y = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    symbol = "ell_spmv_f32" if v.dtype == torch.float32 else "ell_spmv_bf16"
    _launch(symbol, v.device, cols.data_ptr(), vals.data_ptr(),
            diag.data_ptr(), v.data_ptr(), y.data_ptr(), n, k, n, _group(k), b)
    _count("ell_spmv")
    return y


def fused_ell_sweep(cols: torch.Tensor, c_ell: torch.Tensor,
                    c_s: torch.Tensor, c_t: torch.Tensor, v: torch.Tensor,
                    eps):
    """Single-sweep IRLS system build: (vals, diag, r_s, r_t) from one pass
    over the slot-major edge data.  ``v`` may be longer than the row count
    (halo-extended); its first ``cols.shape[0]`` entries are the row
    voltages.  ε² is squared in float32, as the solver squares it.
    Batched: ``c_ell`` (B, n, k), ``c_s``/``c_t`` (B, n) and ``v`` (B, nv)
    over one shared ``cols`` (n, k).  A plan counts every slot as stored."""
    if _fake(cols, c_ell, c_s, c_t, v):
        return _planned("fused_ell_sweep", (cols, c_ell, c_s, c_t, v),
                        (c_ell.new_empty(c_ell.shape),
                         *(c_s.new_empty(c_s.shape) for _ in range(3))),
                        10 * c_ell.numel() + 12 * c_s.numel())
    if _on_cpu(cols, c_ell, c_s, c_t, v):
        return ref.fused_ell_sweep_ref(cols, c_ell, c_s, c_t, v, eps)
    n, k = cols.shape
    nv = v.shape[-1]
    b = _lanes(v, 1)
    lead = tuple(v.shape[:-1])
    _require(cols.dtype == torch.int32, "cols must be int32")
    _require(all(t.dtype == torch.float32 for t in (c_ell, c_s, c_t, v)),
             "c_ell, c_s, c_t and v must be float32")
    _require(c_ell.shape == lead + (n, k) and c_s.shape == lead + (n,)
             and c_t.shape == lead + (n,) and nv >= n,
             f"shapes: cols {tuple(cols.shape)}, c_ell {tuple(c_ell.shape)}, "
             f"c_s {tuple(c_s.shape)}, c_t {tuple(c_t.shape)}, v {tuple(v.shape)}")
    _contiguous(cols=cols, c_ell=c_ell, c_s=c_s, c_t=c_t, v=v)
    vals = torch.empty(c_ell.shape, dtype=v.dtype, device=v.device)
    diag, r_s, r_t = (torch.empty(c_s.shape, dtype=v.dtype, device=v.device)
                      for _ in range(3))
    if diag.numel() == 0:
        # no rows or no lanes: the kernel's entry launches nothing
        return vals, diag, r_s, r_t
    _launch("fused_ell_sweep_f32", v.device, cols.data_ptr(),
            c_ell.data_ptr(), c_s.data_ptr(), c_t.data_ptr(), v.data_ptr(),
            eps_sq(eps), vals.data_ptr(), diag.data_ptr(), r_s.data_ptr(),
            r_t.data_ptr(), n, k, nv, _vector_group_log2(k, cols, c_ell), b)
    _count("fused_ell_sweep")
    return vals, diag, r_s, r_t


# x[p] is staged in the 48 KB of shared memory a block gets without opting in
_MAX_BS = 48 * 1024 // 4


def block_diag_matvec(blocks: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched block-diagonal matvec  y[p] = blocks[p] @ x[p]  (float32)."""
    if _fake(blocks, x):
        (y,) = _planned("block_diag_matvec", (blocks, x),
                        (x.new_empty(x.shape),), 2 * blocks.numel())
        return y
    if _on_cpu(blocks, x):
        return ref.block_diag_matvec_ref(blocks, x)
    p, bs, bs2 = blocks.shape
    _require(bs == bs2 and x.shape == (p, bs),
             f"shapes: blocks {tuple(blocks.shape)}, x {tuple(x.shape)}")
    _require(blocks.dtype == x.dtype == torch.float32,
             "blocks and x must be float32")
    _require(bs <= _MAX_BS, f"block size {bs} exceeds {_MAX_BS}")
    _contiguous(blocks=blocks, x=x)
    y = torch.empty((p, bs), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        # no blocks: the kernel's entry launches nothing
        return y
    plan = _bdm_plan(p, bs, _aligned(blocks, x))
    _launch("block_diag_matvec_f32", x.device, blocks.data_ptr(),
            x.data_ptr(), y.data_ptr(), p, bs, *plan)
    _count("block_diag_matvec")
    return y


def edge_reweight_r(src: torch.Tensor, dst: torch.Tensor, c: torch.Tensor,
                    v: torch.Tensor, eps) -> torch.Tensor:
    """Per-edge reweighted conductances r_e (COO layout), the ``edge_r`` of
    ``core.laplacian.reweight`` under ``use_pallas``.  Batched: ``c`` (B, m)
    and ``v`` (B, nv) over one shared ``src``/``dst`` (m,), int32 on CUDA.
    An index outside [0, nv) gathers 0.  ε² is squared in float32.  The
    kernel's variant and grid come from ``_er_plan``, by shape and
    alignment."""
    if _fake(src, dst, c, v):
        (r,) = _planned("edge_reweight", (src, dst, c, v),
                        (c.new_empty(c.shape),), 7 * c.numel())
        return r
    if _on_cpu(src, dst, c, v):
        return ref.edge_reweight_ref(src, dst, c, v, eps)
    m = src.shape[0]
    nv = v.shape[-1]
    b = _lanes(v, 1)
    lead = tuple(v.shape[:-1])
    _require(src.dtype == dst.dtype == torch.int32, "src and dst must be int32")
    _require(c.dtype == v.dtype == torch.float32, "c and v must be float32")
    _require(src.shape == dst.shape == (m,) and c.shape == lead + (m,),
             f"shapes: src {tuple(src.shape)}, dst {tuple(dst.shape)}, "
             f"c {tuple(c.shape)}, v {tuple(v.shape)}")
    _contiguous(src=src, dst=dst, c=c, v=v)
    r = torch.empty(c.shape, dtype=v.dtype, device=v.device)
    if r.numel() == 0:
        return r
    plan = _er_plan(m, _aligned(src, dst, c))
    _launch("edge_reweight_f32", v.device, src.data_ptr(), dst.data_ptr(),
            c.data_ptr(), v.data_ptr(), eps_sq(eps), r.data_ptr(), m, nv, b,
            *plan)
    _count("edge_reweight")
    return r


# head dims the attention kernel is compiled for
FLASH_HEAD_DIMS = (64, 128)


def _regroup(q, k, v):
    """The model's layout q [B, Sq, H, D], k, v [B, Sk, KV, D] as the 3-D
    one: q [B·H, Sq, D] with head b·H + kv·G + g, k, v [B·KV, Sk, D]."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    q3 = (q.reshape(B, Sq, KV, H // KV, D).permute(0, 2, 3, 1, 4)
          .reshape(B * H, Sq, D))
    k3, v3 = (t.permute(0, 2, 1, 3).reshape(B * KV, Sk, D) for t in (k, v))
    return q3, k3, v3


def _flash_strides(t: torch.Tensor, four_d: bool, heads: int):
    """(batch, head, row) element strides of one operand; the 3-D layout
    [B·KV·G, S, D] is read as B·KV batches of ``heads`` heads (q and out: G,
    k and v: 1)."""
    if four_d:
        return t.stride(0), t.stride(2), t.stride(1)
    return heads * t.stride(0), t.stride(0), t.stride(1)


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              g_per_kv: int, causal: bool = True, scale: float = 1.0):
    """GQA flash-attention forward in one of two layouts:

    * 3-D: q [BH, Sq, D] and k, v [BKV, Sk, D] with BH = BKV·G, contiguous;
      query head bh reads kv head bh // G.
    * 4-D, the model's own: q [B, Sq, H, D] and k, v [B, Sk, KV, D] with
      H = KV·G, read and written in place: the head dim contiguous, the base
      pointers and every other stride (in bytes) multiples of 16.

    Returns (out in q's shape and dtype, lse [BH, Sq] float32) with query
    head bh = b·H + kv·G + g in both layouts.  bfloat16 or float32, D in
    ``FLASH_HEAD_DIMS``, any Sq and Sk ≥ 1; the bfloat16 kernel takes a
    positive ``scale`` only.  On CPU tensors the 4-D layout is
    regrouped and the plain version runs, so both layouts give equal
    results."""
    _require(q.dim() == k.dim() == v.dim() and q.dim() in (3, 4),
             f"q, k, v must be all 3-D or all 4-D, got {tuple(q.shape)}, "
             f"{tuple(k.shape)}, {tuple(v.shape)}")
    four_d = q.dim() == 4
    if four_d:
        b, sq, h, d = q.shape
        _, sk, kv, _ = k.shape
        ok = (k.shape[0] == b and kv * g_per_kv == h)
        bh = b * h
    else:
        bh, sq, d = q.shape
        bkv, sk, _ = k.shape
        ok = bh == bkv * g_per_kv
    _require(g_per_kv >= 1 and ok and k.shape == v.shape
             and k.shape[-1] == d and sk >= 1,
             f"shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
             f"{tuple(v.shape)}, g_per_kv {g_per_kv}")
    _require(k.dtype == v.dtype == q.dtype, "q, k and v must share one dtype")
    if _fake(q, k, v):
        return _planned("flash_fwd", (q, k, v),
                        (q.new_empty(q.shape),
                         q.new_empty((bh, sq), dtype=torch.float32)),
                        flash_flops(bh, sq, sk, d, causal))
    if _on_cpu(q, k, v):
        if not four_d:
            return ref.flash_fwd_ref(q, k, v, g_per_kv=g_per_kv,
                                     causal=causal, scale=scale)
        out, lse = ref.flash_fwd_ref(*_regroup(q, k, v), g_per_kv=g_per_kv,
                                     causal=causal, scale=scale)
        kv = k.shape[2]
        out = (out.reshape(b, kv, g_per_kv, sq, d).permute(0, 3, 1, 2, 4)
               .contiguous().reshape(q.shape))
        return out, lse
    _require(d in FLASH_HEAD_DIMS, f"head dim {d} not in {FLASH_HEAD_DIMS}")
    _require(q.dtype in (torch.bfloat16, torch.float32),
             f"q must be bfloat16 or float32, got {q.dtype}")
    _require(q.dtype == torch.float32 or scale > 0,
             f"the bfloat16 kernel needs a positive scale, got {scale}")
    if four_d:
        _require(all(t.stride(3) == 1 for t in (q, k, v)),
                 "q, k and v must have a contiguous last dim")
    else:
        _contiguous(q=q, k=k, v=v)
    # the kernels move 16 bytes per load (TMA's rule for the bf16 kernel)
    esize = q.element_size()
    _require(all(t.data_ptr() % 16 == 0 for t in (q, k, v)),
             "q, k and v must start on a 16-byte boundary")
    _require(all(s * esize % 16 == 0 for t in (q, k, v) for s in t.stride()[:-1]),
             "every stride of q, k and v but the last must be a multiple of "
             "16 bytes")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(*(
        s for t, heads in ((q, g_per_kv), (k, 1), (v, 1), (out, g_per_kv))
        for s in _flash_strides(t, four_d, heads)))
    nb, nh = (b, h) if four_d else (bh // g_per_kv, g_per_kv)
    symbol = "flash_fwd_bf16" if q.dtype == torch.bfloat16 else "flash_fwd_f32"
    _launch(symbol, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), lse.data_ptr(), nb, nh, g_per_kv, sq, sk, d,
            strides, int(causal), float(scale))
    _count("flash_fwd")
    return out, lse
