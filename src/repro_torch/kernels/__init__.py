"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

ell_spmv           — ELLPACK reduced-Laplacian matvec (PCG inner loop)
fused_ell_sweep    — one-sweep IRLS system build (eq. 4 → eq. 8)
block_diag_matvec  — block-Jacobi apply with explicit block inverses
edge_reweight      — COO per-edge reweighted conductances (eq. 4)
flash_fwd          — GQA flash-attention forward (LM prefill)

``csrc/`` holds the CUDA sources, ``build.py`` compiles them with nvcc at
first use, ``ops.py`` wraps them, ``ref.py`` holds the plain versions.
"""
