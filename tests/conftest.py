import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
# repo root, so the benchmark harness (benchmarks/) is importable in tests
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import pytest


@pytest.fixture(scope="session")
def grid_instance():
    from repro.graphs import generators as gen
    g = gen.grid_2d(16, 16, seed=3)
    return gen.segmentation_instance(g, (16, 16), seed=4)


@pytest.fixture(scope="session")
def road_instance():
    from repro.graphs import generators as gen
    g = gen.road_like(18, seed=5)
    return gen.flow_improve_instance(g, seed=6)


def tiny_instance(n=8, seed=0):
    from repro.graphs import generators as gen
    g = gen.random_regular(n, 3, seed=seed)
    return gen.flow_improve_instance(g, seed=seed + 1)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card and nvcc (the port's CUDA "
        "kernels); skips without one")
