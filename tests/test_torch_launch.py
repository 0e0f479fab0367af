"""The port's CLI drivers (``repro_torch.launch.solve``,
``repro_torch.launch.mincut_serve``) and diagnostics (``core.electrical``,
``core.cheeger``) against the JAX package's, on the CPU.

The CLIs run in-process at small sizes (``--side 12``) with
``--device cpu``: the same JSON keys as the JAX package's CLIs, and cuts
within rel 1e-6 of theirs (both are exact two-level roundings).  The
diagnostics run on tests/test_electrical_cheeger.py's seeded instances:
flows at rel 1e-4 of their scale (float32 products in another order), λ₂
at rel 1e-4 (PCG to 1e-9 in float32 in both packages).
"""
import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import tiny_instance  # noqa: E402

from repro_torch.core import cheeger_lambda2, max_flow, phi_of_cut  # noqa: E402
from repro_torch.core import laplacian as lap  # noqa: E402
from repro_torch.core.electrical import (conservation_residual,  # noqa: E402
                                         electrical_flow,
                                         flow_value_quadratic)
from repro_torch.core.incidence import device_graph_from_instance  # noqa: E402
from repro_torch.graphs.structures import instance_from_arrays  # noqa: E402


def _port(inst):
    return instance_from_arrays(inst.graph.src, inst.graph.dst,
                                inst.graph.weight, inst.graph.n,
                                inst.s_weight, inst.t_weight)


def _run_reference(module, args, monkeypatch):
    monkeypatch.setattr(sys, "argv", [module.__name__] + args)
    return module.main()


# ---------------------------------------------------------------------------
# launch/solve.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family,backend,rounding", [
    ("grid", "host", "two_level"), ("road", "host", "both"),
    ("grid", "scanned", "sweep"), ("grid3d", "host", "two_level")])
def test_solve_cli_matches_reference(tmp_path, monkeypatch, capsys, family,
                                     backend, rounding):
    from repro.launch import solve as jsolve
    from repro_torch.launch import solve

    side = "5" if family == "grid3d" else "12"
    args = ["--family", family, "--side", side, "--irls", "12",
            "--backend", backend, "--rounding", rounding]
    solve.main(args + ["--device", "cpu", "--json-out",
                       str(tmp_path / "port.json")])
    out = capsys.readouterr().out
    _run_reference(jsolve, args + ["--json-out", str(tmp_path / "ref.json")],
                   monkeypatch)
    ref_out = capsys.readouterr().out
    got = json.loads((tmp_path / "port.json").read_text())
    want = json.loads((tmp_path / "ref.json").read_text())
    assert sorted(got) == sorted(want)
    assert (got["n"], got["m"], got["backend"]) == (want["n"], want["m"],
                                                    want["backend"])
    for key in want:
        if key.startswith(("cut_", "delta_")):
            assert got[key] == pytest.approx(want[key], rel=1e-6, abs=1e-9), key
    assert got["cut_exact"] == want["cut_exact"]
    # the printout has the reference's lines, in order
    strip = [line.split(":")[0].split("=")[0] for line in out.splitlines()]
    assert strip == [line.split(":")[0].split("=")[0]
                     for line in ref_out.splitlines()]


@pytest.mark.parametrize("argv", [["--backend", "sharded"], ["--sharded"]])
def test_solve_cli_sharded_is_not_ported(argv, tmp_path):
    """The sharded backend is ported: with no ``torchrun`` around it the CLI
    runs a world of one (gloo on the CPU), lands on the exact cut and
    leaves no process group behind."""
    import torch.distributed as dist
    from repro_torch.launch import solve

    owned = not dist.is_initialized()
    out = tmp_path / "sharded.json"
    solve.main(["--side", "6", "--irls", "10", "--device", "cpu",
                "--json-out", str(out)] + argv)
    got = json.loads(out.read_text())
    assert got["backend"] == "sharded"
    assert got["cut_two_level"] == pytest.approx(got["cut_exact"], rel=1e-6)
    if owned:
        assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# launch/mincut_serve.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra", [[], ["--warm", "--presolve",
                                        "--drift-sparsity", "0.05"],
                                   ["--fixed-schedule", "--warmup", "2"]])
def test_mincut_serve_cli_matches_reference(tmp_path, monkeypatch, capsys,
                                            extra):
    from repro.launch import mincut_serve as jserve
    from repro_torch.launch import mincut_serve

    args = ["--topos", "2", "--side", "8", "--requests", "8", "--rate",
            "400", "--irls", "6"] + extra
    rc = mincut_serve.main(args + ["--device", "cpu", "--json-out",
                                   str(tmp_path / "port.json")])
    out = capsys.readouterr().out
    assert rc == 0
    assert rc == _run_reference(
        jserve, args + ["--json-out", str(tmp_path / "ref.json")],
        monkeypatch)
    got = json.loads((tmp_path / "port.json").read_text())
    want = json.loads((tmp_path / "ref.json").read_text())
    # the port's stats add the server's device; its warm store counts the
    # sharded exclusions as the reference's does
    assert set(got) == set(want) | {"device"}
    assert got["device"] == "cpu"
    assert set(got["warm"]) == set(want["warm"])
    assert set(got["telemetry"]) == set(want["telemetry"])
    assert got["completed"] == want["completed"] == 8
    assert got["failed"] == want["failed"] == 0
    assert "completed=8/8 (failed=0, rejected=0)" in out


# ---------------------------------------------------------------------------
# core/electrical.py and core/cheeger.py
# ---------------------------------------------------------------------------

def _exact_wls(inst, v0, eps):
    """The reweighted system at v0 solved exactly (float64), as
    tests/test_electrical_cheeger.py does, on the port's operators."""
    dg = device_graph_from_instance(inst, device="cpu")
    rw = lap.reweight(dg, torch.as_tensor(v0, dtype=torch.float32), eps)
    L = lap.dense_reduced_laplacian(dg, rw).double().numpy()
    b = lap.rhs(rw).double().numpy()
    return dg, rw, np.linalg.solve(L, b)


@pytest.mark.parametrize("seed", range(5))
def test_electrical_flow_matches_reference(seed):
    """Kirchhoff holds at the WLS solution, μ = xᵀLx, and the flows equal
    the JAX package's at rel 1e-4 of their scale."""
    import jax.numpy as jnp
    from repro.core import laplacian as jlap
    from repro.core.electrical import (electrical_flow as jflow,
                                       flow_value_quadratic as jquad)
    from repro.core.incidence import device_graph_from_instance as jdg

    inst = tiny_instance(14, seed)
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(size=inst.n)
    dg, rw, v = _exact_wls(_port(inst), v0, eps=1e-2)
    vt = torch.as_tensor(v, dtype=torch.float32)
    fl = electrical_flow(dg, rw, vt)
    net = conservation_residual(dg, fl)
    scale = float(fl.flow_e.abs().max()) + 1.0
    assert float(net.abs().max()) < 2e-4 * scale
    assert float(fl.value) == pytest.approx(
        float(flow_value_quadratic(dg, rw, vt)), rel=2e-3)
    jg = jdg(inst)
    jrw = jlap.reweight(jg, jnp.asarray(v0, jnp.float32), 1e-2)
    jfl = jflow(jg, jrw, jnp.asarray(v, jnp.float32))
    for a, b in ((fl.flow_e, jfl.flow_e), (fl.flow_s, jfl.flow_s),
                 (fl.flow_t, jfl.flow_t)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4 * scale)
    assert float(fl.value) == pytest.approx(float(jfl.value), rel=1e-4)
    assert float(flow_value_quadratic(dg, rw, vt)) == pytest.approx(
        float(jquad(jg, jrw, jnp.asarray(v, jnp.float32))), rel=1e-4)


@pytest.mark.parametrize("seed", [0, 7, 31, 52, 88])
def test_cheeger_lambda2_matches_reference(seed):
    """λ₂ equals the JAX package's (rel 1e-4) and satisfies Thm 2.7's
    φ²/2 ≤ λ₂ ≤ 2φ."""
    from repro.core import cheeger_lambda2 as jcheeger
    from repro.core.incidence import device_graph_from_instance as jdg

    inst = tiny_instance(12, seed)
    est = cheeger_lambda2(device_graph_from_instance(_port(inst),
                                                     device="cpu"),
                          tol=1e-9, max_iters=5000)
    want = jcheeger(jdg(inst), tol=1e-9, max_iters=5000)
    assert float(est.lam2) == pytest.approx(float(want.lam2), rel=1e-4)
    np.testing.assert_allclose(est.g_voltage.numpy(),
                               np.asarray(want.g_voltage), atol=1e-4)
    mf = max_flow(_port(inst))
    C = 2 * (inst.graph.total_weight() + float(inst.s_weight.sum())
             + float(inst.t_weight.sum()))
    phi = phi_of_cut(mf.value, C)
    lam2 = float(est.lam2)
    assert lam2 <= 2 * phi * (1 + 1e-3)
    assert lam2 >= phi ** 2 / 2 * (1 - 1e-3)
    assert float(est.lower_phi) <= float(est.upper_phi)
