"""The general traffic generator: what every mode shares, and the lookup of
a traffic mix's mode by name.

A traffic mix is a data file, ``cutbench/traffic/<traffic>.json``, of
parameters.  Its ``mode`` names the module ``cutbench/modes/<mode>.py``
that drives it: a class ``Mode(config, traffic, seed, device)`` that makes
the inputs from the seed and sets the program up (set-up), then
``window(seconds)`` (the measured window; returns the window's record),
``sample()`` (the answers the judge compares), ``checks()`` (numbers of
the run's own structure compared exactly, with their limits) and
``close()``.  After set-up a mode holds ``src``, ``dst`` and ``labels``
(the block partition it handed the program, or None) for the judge.

A configuration's graph and terminals name their generators in
``repro_torch.graphs.generators`` with their arguments; so do the server's
settings (``MinCutServer``'s keywords) and the solver's (``IRLSConfig``'s).
A mix, a configuration, a mode or a metric that a later cell needs is a new
file, found by name; no file here changes for it.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path
from types import ModuleType
from typing import Optional

import numpy as np

HERE = Path(__file__).resolve().parent


def load_mode(name: str, base: Path = HERE) -> ModuleType:
    """The module of mode ``name``: ``<base>/modes/<name>.py``, or the
    benchmark's own where ``base`` holds no such file."""
    path = base / "modes" / f"{name}.py"
    if not path.is_file():
        path = HERE / "modes" / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no traffic mode {name!r}: expected {path}")
    spec = importlib.util.spec_from_file_location(f"cutbench_mode_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _args(spec: dict) -> dict:
    """A generator's arguments from a data file (lists as tuples)."""
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in spec.get("args", {}).items()}


def make_graph(config: dict, seed: int):
    """The configuration's graph (an ``EdgeList``) from the seed:
    ``generators.<graph.generator>(**graph.args, seed=seed)``."""
    from repro_torch.graphs import generators as gen

    spec = config["graph"]
    return getattr(gen, spec["generator"])(**_args(spec), seed=seed)


def make_instance(config: dict, g, seed: int):
    """Terminal weights of ``g`` from the seed:
    ``generators.<terminals.generator>(g, **terminals.args, seed=seed)``."""
    from repro_torch.graphs import generators as gen

    spec = config["terminals"]
    return getattr(gen, spec["generator"])(g, **_args(spec), seed=seed)


def grid_dims(config: dict):
    a = config["graph"]["args"]
    return int(a["d"]), int(a["h"]), int(a["w"])


def box_labels(dims, box: int) -> np.ndarray:
    """Block-Jacobi partition of a grid into box³ boxes (node id =
    (z·h + y)·w + x, as ``grid_3d`` numbers them)."""
    d, h, w = dims
    idx = np.arange(d * h * w)
    z, y, x = idx // (h * w), (idx // w) % h, idx % w
    nh, nw = -(-h // box), -(-w // box)
    return (z // box) * nh * nw + (y // box) * nw + x // box


def partition_labels(config: dict) -> Optional[np.ndarray]:
    """The configuration's block partition, or None: ``boxes`` of a grid."""
    part = config.get("partition")
    if not part:
        return None
    if part["kind"] != "boxes":
        raise ValueError(f"unknown partition kind {part['kind']!r}")
    return box_labels(grid_dims(config), int(part["box"]))


def solver_config(config: dict):
    from repro_torch.core import IRLSConfig

    return IRLSConfig(**config["solver"])


def sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def peak_reset(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak(device) -> Optional[int]:
    import torch

    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return None


def missing_answer(n: int) -> dict:
    """The answer of a request that failed: it fails every comparison."""
    return {"voltages": np.full(n, np.nan), "in_source": np.zeros(n, bool),
            "cut_value": float("nan")}
