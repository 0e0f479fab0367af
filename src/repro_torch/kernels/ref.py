"""Plain PyTorch versions of every kernel.

Each graph kernel of the solver has one plain version, and it is the
function the solver's plain path runs (``use_pallas=False``); this module
names them after the kernels.  The attention kernel's plain version is the
dense function below: the model's plain path (``models.layers``) is the
blockwise online-softmax forward, which reaches the same values in another
order.  The wrappers in ``ops.py`` run these for CPU tensors, the tests
compare them with the JAX package's kernels, and ``chip_smoke.py`` holds
each CUDA kernel against its plain version on the card.

ell_spmv_ref          — ``core.laplacian.matvec_ell``
edge_reweight_ref     — ``core.laplacian.edge_conductances``
fused_ell_sweep_ref   — ``core.laplacian.fused_ell_sweep``
block_diag_matvec_ref — ``core.precond.block_diag_matvec``
flash_fwd_ref         — dense GQA attention forward (below)
"""
from __future__ import annotations

import torch

from ..core.laplacian import edge_conductances as edge_reweight_ref
from ..core.laplacian import fused_ell_sweep as fused_ell_sweep_ref
from ..core.laplacian import matvec_ell as ell_spmv_ref
from ..core.precond import block_diag_matvec as block_diag_matvec_ref

__all__ = ["ell_spmv_ref", "edge_reweight_ref", "fused_ell_sweep_ref",
           "block_diag_matvec_ref", "flash_fwd_ref", "flash_fwd_scales"]

NEG_INF = -1e30


def _softmax_parts(q, k, g_per_kv, causal, scale):
    """(p, m, l) of the dense attention, float32, [BKV, G, Sq, Sk|·]."""
    bh, sq, d = q.shape
    bkv, sk, _ = k.shape
    logits = torch.einsum("kgqd,ksd->kgqs",
                          q.float().reshape(bkv, g_per_kv, sq, d), k.float())
    logits.mul_(scale)
    if causal:
        pos_q = torch.arange(sq, device=q.device)
        pos_k = torch.arange(sk, device=q.device)
        logits.masked_fill_(pos_k[None, :] > pos_q[:, None], NEG_INF)
    m = logits.amax(dim=-1)
    p = logits.sub_(m[..., None]).exp_()
    return p, m, p.sum(dim=-1).clamp_min_(1e-30)


def flash_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  g_per_kv: int, causal: bool = True, scale: float = 1.0):
    """What the TPU kernel ``flash_fwd_pallas`` computes, densely, in float32.

    q [BH, Sq, D] with BH = BKV·G (query head bh reads kv head bh // G);
    k, v [BKV, Sk, D].  Causal masking keeps key j for row i where j ≤ i
    and writes −1e30 elsewhere.  Returns (out [BH, Sq, D] in q's dtype,
    lse [BH, Sq] float32), with the row sum l clamped at 1e-30 as the
    kernel clamps it."""
    bh, sq, d = q.shape
    p, m, l = _softmax_parts(q, k, g_per_kv, causal, scale)
    out = torch.einsum("kgqs,ksd->kgqd", p, v.float()).div_(l[..., None])
    lse = m + torch.log(l)
    return out.reshape(bh, sq, d).to(q.dtype), lse.reshape(bh, sq)


def flash_fwd_scales(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     g_per_kv: int, causal: bool = True, scale: float = 1.0):
    """Each output entry's own scale, for holding a kernel against
    ``flash_fwd_ref`` (float32, the shapes of out and lse).

    out: Σ_j p_ij·|v_j| / l_i.  lse: |m_i| + log l_i + Σ_j p_ij·a_ij / l_i,
    where a_ij = scale·Σ_d |q_id·k_jd| is the summation scale of score s_ij;
    ∂lse_i/∂s_ij = p_ij / l_i, so the last term is the scale of the scores'
    own rounding, which |m_i| + log l_i alone does not hold where m_i ≈ 0
    and l_i ≈ 1."""
    bh, sq, d = q.shape
    bkv = k.shape[0]
    p, m, l = _softmax_parts(q, k, g_per_kv, causal, scale)
    out = torch.einsum("kgqs,ksd->kgqd", p, v.float().abs()).div_(l[..., None])
    k_abs = torch.einsum("kgqs,ksd->kgqd", p, k.float().abs()).div_(l[..., None])
    q_abs = q.float().abs().reshape(bkv, g_per_kv, sq, d)
    terms = (k_abs * q_abs).sum(dim=-1).mul_(scale)
    lse = m.abs() + torch.log(l) + terms
    return out.reshape(bh, sq, d), lse.reshape(bh, sq)
