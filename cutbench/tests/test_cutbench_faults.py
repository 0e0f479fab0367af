"""The comparison that decides ``correct`` catches a broken timed path: a
whole run of each cell at a tiny size on the CPU (the look for a card
skipped), with the program broken underneath, comes out not correct."""
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from cutbench import harness  # noqa: E402

TINY = {
    "volume_solve": {"graph": {"generator": "grid_3d",
                               "args": {"d": 8, "h": 8, "w": 8, "conn": 26}},
                     "terminals": {"generator": "segmentation_instance",
                                   "args": {"shape": [8, 8, 8]}},
                     "partition": {"kind": "boxes", "box": 4}},
    "liver_serve": {"graph": {"generator": "grid_3d",
                              "args": {"d": 6, "h": 8, "w": 8, "conn": 6}},
                    "terminals": {"generator": "segmentation_instance",
                                  "args": {"shape": [6, 8, 8]}}},
}


# the limits at the tests' size, set as the cells' are, from single-thread
# runs on seeds 1-12: above the program's largest readings (volume_solve,
# its reference following the program's PCG step counts: frac_gap 0.0026;
# liver_serve, two tenants' bursts of four: frac_gap 0.032, cut_gap
# 0.0014) and below the bfloat16 control's smallest on seeds 1-3
# (volume_solve: 0.027; liver_serve: 0.352, 0.057).  ``prefix_gap``,
# ``value_gap`` and ``stall_res`` are the configuration's stated limits.
LIMITS = {
    "volume_solve": {"frac_gap": 0.01, "prefix_gap": 0,
                     "value_gap": 1e-9, "stall_res": 1.01},
    "liver_serve": {"frac_gap": 0.2, "cut_gap": 0.02,
                    "value_gap": 1e-9},
}


def tiny(workload):
    """The cell's configuration at the tests' size: the graph cut down, for
    block Jacobi as many blocks as the boxes make, and the limits of that
    size."""
    cfg = harness.config_of(harness.find_cell(harness.manifest(), workload))
    over = dict(TINY[workload],
                check=dict(cfg["check"], limits=LIMITS[workload]))
    if cfg.get("partition"):
        a, box = over["graph"]["args"], over["partition"]["box"]
        dims = (a["d"], a["h"], a["w"])
        over["solver"] = dict(cfg["solver"], n_blocks=int(np.prod(
            [-(-d // box) for d in dims])))
    return over


# a window long enough for every tenant's later bursts, warm from its
# earlier ones; at this size two tenants' bursts of four
SECONDS = {"volume_solve": 0.3, "liver_serve": 1.0}
TRAFFIC = {"volume_solve": {}, "liver_serve": {"tenants": 2, "burst": 4}}


def run(workload, seed=7, **kw):
    """A run at the tests' size on one CPU thread: on several, the
    scatters of the bfloat16 control sum in a varying order."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return harness.run_cell(workload, seed, SECONDS[workload], False,
                                device="cpu",
                                config_override=tiny(workload),
                                traffic_override=TRAFFIC[workload], **kw)
    finally:
        torch.set_num_threads(threads)


def _stuck_host(monkeypatch):
    """Every IRLS step after the first returns the voltages it was given."""
    from repro_torch.core import irls

    orig = irls._Stepper._step

    def step(self, v, eps, *, first, **kw):
        out = orig(self, v, eps, first=first, **kw)
        return out if first else (v,) + tuple(out[1:])

    monkeypatch.setattr(irls._Stepper, "_step", step)


def _loose_tolerance(monkeypatch):
    """Every PCG of the host loop stops at ten times the configured
    tolerance: the program departs from its stopping rule, and the
    reference, which follows its step counts, cannot see it in the
    answer."""
    from repro_torch.core import irls

    orig = irls._Stepper._step

    def step(self, v, eps, *, first, tol=None, **kw):
        tol = self.cfg.pcg_tol if tol is None else tol
        return orig(self, v, eps, first=first, tol=10 * tol, **kw)

    monkeypatch.setattr(irls._Stepper, "_step", step)


def _stuck_batched(monkeypatch):
    """Every warm-started PCG (each IRLS iteration's) returns its start."""
    from repro_torch.core import irls

    orig = irls.pcg_masked

    def pcg(matvec, b, x0=None, **kw):
        res = orig(matvec, b, x0=x0, **kw)
        return res if x0 is None else res._replace(x=x0)

    monkeypatch.setattr(irls, "pcg_masked", pcg)


def _altered(monkeypatch):
    """The sweep rounding reports a cut value 1% off its partition's."""
    from repro_torch.core import rounding

    orig = rounding.REGISTRY["sweep"]

    def sweep(*a, **kw):
        res = orig(*a, **kw)
        return res._replace(cut_value=res.cut_value * 1.01)

    monkeypatch.setitem(rounding.REGISTRY, "sweep", sweep)


def _partition_altered(monkeypatch):
    """The sweep rounding moves the sink side's lowest-voltage node to the
    source side and reports that partition's own value: no sweep cut."""
    from repro_torch.core import rounding

    orig = rounding.REGISTRY["sweep"]

    def sweep(instance, v, *a, **kw):
        res = orig(instance, v, *a, **kw)
        side = np.asarray(res.in_source, dtype=bool).copy()
        sink = np.flatnonzero(~side)
        side[sink[np.argmin(np.asarray(v)[sink])]] = True
        return res._replace(in_source=side,
                            cut_value=instance.cut_value(side))

    monkeypatch.setitem(rounding.REGISTRY, "sweep", sweep)


def _half_batch(monkeypatch):
    """A batch solves its first half of lanes; the rest get the answer of
    the last lane solved."""
    from repro_torch.core import session

    orig = session.MinCutSession.solve_batch

    def solve_batch(self, ws, *a, **kw):
        h = max(1, len(ws) // 2)
        kw = dict(kw, pad_to=None)
        for k in ("warm_from", "delta_keys"):
            if kw.get(k) is not None:
                kw[k] = kw[k][:h]
        res = orig(self, ws[:h], *a, **kw)
        return res + [res[-1]] * (len(ws) - h)

    monkeypatch.setattr(session.MinCutSession, "solve_batch", solve_batch)


def _warm_skipped(monkeypatch):
    """The server looks a tenant's voltages up and solves cold all the
    same: the warm chain that the reference follows is broken."""
    from repro_torch.serve import engine

    orig = engine.MinCutServer._warm_lookup

    def lookup(self, tenant, topo_key):
        orig(self, tenant, topo_key)
        return None

    monkeypatch.setattr(engine.MinCutServer, "_warm_lookup", lookup)


FAULTS = {
    ("volume_solve", "state_unchanged"): _stuck_host,
    ("volume_solve", "answer_altered"): _altered,
    ("volume_solve", "loose_tolerance"): _loose_tolerance,
    ("volume_solve", "partition_altered"): _partition_altered,
    ("liver_serve", "state_unchanged"): _stuck_batched,
    ("liver_serve", "answer_altered"): _altered,
    ("liver_serve", "half_batch"): _half_batch,
    ("liver_serve", "warm_start_skipped"): _warm_skipped,
}


@pytest.mark.parametrize("workload,fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(monkeypatch, workload, fault):
    FAULTS[(workload, fault)](monkeypatch)
    out = run(workload)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["compared"].values())
