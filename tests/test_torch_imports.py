"""The port stands alone: every ``repro_torch`` module imports with ``jax``
blocked, and none of them loads a module of the JAX package ``repro``."""
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

_PROBE = """
import pkgutil, sys
sys.modules["jax"] = None            # any `import jax` now raises
import repro_torch
names = sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                     "repro_torch."))
for name in names:
    __import__(name)
loaded = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
assert not loaded, loaded
assert "jax" not in sys.modules or sys.modules["jax"] is None
print(len(names))
"""


def test_port_imports_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15   # every module was walked


def test_port_serving_and_obs_modules_stand_alone():
    """The serving and observability modules copied from the JAX package
    import with ``jax`` blocked and bring in no ``repro`` module."""
    probe = _PROBE.replace("print(len(names))", "print(' '.join(names))")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", probe], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert names >= {"repro_torch.serve.engine", "repro_torch.serve.cache",
                     "repro_torch.serve.batcher", "repro_torch.serve.metrics",
                     "repro_torch.obs.trace", "repro_torch.obs.metrics",
                     "repro_torch.obs.telemetry"}


def test_port_lm_modules_stand_alone():
    """The LM serving stack (models, configs, the token pipeline and the
    serving driver) imports with ``jax`` blocked and brings in no ``repro``
    module."""
    probe = _PROBE.replace("print(len(names))", "print(' '.join(names))")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", probe], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert names >= {"repro_torch.models.layers",
                     "repro_torch.models.transformer",
                     "repro_torch.configs.lm", "repro_torch.configs.registry",
                     "repro_torch.data.lm", "repro_torch.launch.lm_serve"}


def test_port_cuttree_and_dashboard_modules_stand_alone():
    """The cut-tree modules, their service and CLI, and the span dashboard
    with its CLI import with ``jax`` blocked and bring in no ``repro``
    module."""
    probe = _PROBE.replace("print(len(names))", "print(' '.join(names))")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", probe], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert names >= {"repro_torch.cuttree", "repro_torch.cuttree.tree",
                     "repro_torch.cuttree.pairs",
                     "repro_torch.cuttree.gusfield",
                     "repro_torch.cuttree.repair",
                     "repro_torch.serve.cuttree",
                     "repro_torch.launch.cut_tree",
                     "repro_torch.obs.dashboard", "repro_torch.launch.obs"}


def test_port_distributed_modules_stand_alone():
    """The sharded solver (plans, collectives, solver) imports with ``jax``
    blocked and brings in no ``repro`` module."""
    probe = _PROBE.replace("print(len(names))", "print(' '.join(names))")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", probe], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert names >= {"repro_torch.distributed",
                     "repro_torch.distributed.collectives",
                     "repro_torch.distributed.spmv",
                     "repro_torch.distributed.solver"}


def test_port_perf_gate_modules_stand_alone():
    """The perf gate (``obs.perf``: schema, history, regress and the work
    counts of ``profile``) and its ``launch.bench_diff`` CLI import with
    ``jax`` blocked and bring in no ``repro`` module."""
    probe = _PROBE.replace("print(len(names))", "print(' '.join(names))")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", probe], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert names >= {"repro_torch.obs.perf", "repro_torch.obs.perf.schema",
                     "repro_torch.obs.perf.history",
                     "repro_torch.obs.perf.regress",
                     "repro_torch.obs.perf.profile",
                     "repro_torch.launch.bench_diff"}


def test_port_sources_name_no_jax_or_repro():
    """No source file of the port spells an import of jax or of repro."""
    for path in (SRC / "repro_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax")), (path, s)
            assert not s.startswith(("import repro.", "from repro.",
                                     "from repro import")), (path, s)


@pytest.mark.parametrize("script", ["chip_smoke.py", "kernel_times.py",
                                    "phase_times.py"])
def test_card_scripts_stand_alone_and_need_a_card(script):
    """The port's scripts at the repo's root import neither jax nor repro,
    and without a CUDA card they exit with a code other than 0 and print
    no result."""
    import ast

    path = SRC.parent / script
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""]
        else:
            continue
        for mod in mods:
            assert mod.split(".")[0] not in ("jax", "repro"), (script, mod)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(path)], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout and '"kernels"' not in out.stdout


def test_port_training_modules_stand_alone():
    """The training substrate (optimizer, train step, checkpoints, the fault
    controller), its ``launch.train`` driver and the five thin LM config
    modules import with ``jax`` blocked and bring in no ``repro`` module."""
    probe = _PROBE.replace("print(len(names))", "print(' '.join(names))")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", probe], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert names >= {"repro_torch.train", "repro_torch.train.optimizer",
                     "repro_torch.train.train_step",
                     "repro_torch.train.checkpoint",
                     "repro_torch.train.fault", "repro_torch.launch.train",
                     "repro_torch.configs.minitron_4b",
                     "repro_torch.configs.qwen2_1_5b",
                     "repro_torch.configs.gemma3_27b",
                     "repro_torch.configs.llama4_maverick",
                     "repro_torch.configs.mixtral_8x22b"}


def test_port_sharding_modules_stand_alone():
    """The LM sharding (the rules, the mesh and the GPipe pipeline) imports
    with ``jax`` blocked and brings in no ``repro`` module."""
    probe = _PROBE.replace("print(len(names))", "print(' '.join(names))")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", probe], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert names >= {"repro_torch.models.sharding",
                     "repro_torch.launch.mesh",
                     "repro_torch.train.pipeline"}


def test_port_gnn_and_recsys_modules_stand_alone():
    """The GNN and recsys models, their data builders, the sampler and the
    configs import with ``jax`` blocked and bring in no ``repro``
    module."""
    probe = _PROBE.replace("print(len(names))", "print(' '.join(names))")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", probe], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert names >= {"repro_torch.models.gnn", "repro_torch.models.recsys",
                     "repro_torch.data.graphs", "repro_torch.data.recsys",
                     "repro_torch.data.sampler", "repro_torch.configs.gnn",
                     "repro_torch.configs.din_cfg",
                     "repro_torch.configs.gcn_cora",
                     "repro_torch.configs.schnet",
                     "repro_torch.configs.dimenet",
                     "repro_torch.configs.meshgraphnet",
                     "repro_torch.configs.din"}


def test_port_dry_run_modules_stand_alone():
    """The dry runs (the cells, the CLI, the op walker) and the solver's
    config import with ``jax`` blocked and bring in no ``repro`` module."""
    probe = _PROBE.replace("print(len(names))", "print(' '.join(names))")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", probe], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert names >= {"repro_torch.launch.cells", "repro_torch.launch.dryrun",
                     "repro_torch.launch.hlo_analysis",
                     "repro_torch.configs.pirmcut"}
