"""The benchmark of the PyTorch and CUDA port (``repro_torch``): a harness
driven by ``BENCHMARK.json`` (``run.py``), its configurations, traffic
mixes and per-metric readers, the plain reference and the comparison that
decides ``correct``."""
