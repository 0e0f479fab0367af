"""PIRMCut on PyTorch and CUDA: the port of the ``repro`` JAX package.

Same module layout as ``repro`` (``repro_torch/core/irls.py`` mirrors
``repro/core/irls.py``).  The package imports torch, numpy and scipy only;
its hot-path kernels are hand-written CUDA for Hopper (``kernels/csrc``),
built with nvcc at first use.  Entry points take a ``device`` argument that
defaults to ``"cuda"``; pass ``device="cpu"`` to run the plain PyTorch
versions of the kernels.
"""
