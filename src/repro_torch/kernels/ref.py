"""Plain PyTorch versions of every graph kernel of the solver.

Each kernel has one plain version, and it is the function the solver's
plain path runs (``use_pallas=False``); this module names them after the
kernels.  The wrappers in ``ops.py`` run them for CPU tensors, the tests
compare them with the JAX package's kernels, and ``chip_smoke.py`` holds
each CUDA kernel against its plain version on the card.

ell_spmv_ref          — ``core.laplacian.matvec_ell``
edge_reweight_ref     — ``core.laplacian.edge_conductances``
fused_ell_sweep_ref   — ``core.laplacian.fused_ell_sweep``
block_diag_matvec_ref — ``core.precond.block_diag_matvec``
"""
from __future__ import annotations

from ..core.laplacian import edge_conductances as edge_reweight_ref
from ..core.laplacian import fused_ell_sweep as fused_ell_sweep_ref
from ..core.laplacian import matvec_ell as ell_spmv_ref
from ..core.precond import block_diag_matvec as block_diag_matvec_ref

__all__ = ["ell_spmv_ref", "edge_reweight_ref", "fused_ell_sweep_ref",
           "block_diag_matvec_ref"]
