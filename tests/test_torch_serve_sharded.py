"""The server's sharded backend in gloo ranks against the JAX package's.

``MinCutServer(backend="sharded")`` serves on rank 0 of a
``torch.distributed`` group while the other ranks run ``follow_sharded``;
the JAX package's server is one controller over
``--xla_force_host_platform_device_count`` devices.  Every job is a
subprocess with a timeout (ranks rendezvous through a ``FileStore`` under
a temporary directory, one intra-op thread each), started together by the
module fixture.

The traffic, the same in both packages: on a 20×20 segmentation grid, a
tenant's two requests at eps = 1e-3 (the undrifted weights, then 2% of
the edges drifted), where the packages are held against each other
(voltages at 1e-3, as ``test_torch_distributed.py`` holds the halo
schedule: float32 CG at eps = 1e-6 is chaotic past convergence, ROADMAP
queue 3), then one request at the default eps = 1e-6 whose two-level cut
is the Dinic cut (rel 1e-6).  The port runs it at world 1 and world 4,
with a request under an unknown rounding between the others: it fails its
own future only.  In a second world of 4, one follower's first session
build raises: rank 0's request fails, the next one is served by every
rank, and every rank leaves at the stop.
"""
import json
import os
import subprocess
import sys
import tempfile
import textwrap
import time

import numpy as np
import pytest

pytest.importorskip("torch")

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
_ENV = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
            JAX_PLATFORMS="cpu", PYTHONWARNINGS="ignore")
JOB_TIMEOUT = 300

_COMMON = """
import json, os, warnings
import numpy as np
warnings.simplefilter("ignore")

def traffic(inst):
    rng = np.random.default_rng(5)
    c = np.asarray(inst.graph.weight, np.float64)
    drift = c.copy()
    idx = rng.choice(c.size, c.size // 50, replace=False)
    drift[idx] *= np.exp(rng.normal(0.0, 0.05, idx.size))
    return [c, drift]

def result(r):
    return {"cut": r.cut_value, "v": np.asarray(r.voltages, np.float64).tolist(),
            "refill": (r.telemetry or {}).get("sharded_refill"),
            "backend": r.backend}

def serve(srv, inst, cfg_p, cfg_d):
    out = {"n_workers": srv.n_workers, "requests": []}
    cs = traffic(inst)
    for c in cs:
        w = (c, inst.s_weight, inst.t_weight)
        out["requests"].append(result(
            srv.submit(inst, w, cfg=cfg_p, tenant="a").result(timeout=200)))
    try:
        srv.submit(inst, inst, cfg=cfg_p, rounding="nope").result(timeout=200)
        out["bad"] = None
    except Exception as e:
        out["bad"] = type(e).__name__
    out["dinic"] = result(srv.submit(inst, inst, cfg=cfg_d).result(timeout=200))
    out["exact"] = max_flow(inst).value
    st = srv.stats()
    out["warm"] = st["warm"]
    out["completed"], out["failed"] = st["completed"], st["failed"]
    return out

def grid(side, seed):
    g = gen.grid_2d(side, side, seed=seed)
    return gen.segmentation_instance(g, (side, side), seed=seed + 1)
"""

_CFGS = """
inst = grid(20, 7)
cfg_p = IRLSConfig(n_irls=20, pcg_max_iters=80, eps=1e-3, n_blocks=1,
                   precond="jacobi")
cfg_d = IRLSConfig(n_irls=20, pcg_max_iters=80, n_blocks=1, precond="jacobi")
"""

_REF = """
from repro.graphs import generators as gen
from repro.core import IRLSConfig, max_flow
from repro.serve import MinCutServer
""" + _CFGS + """
srv = MinCutServer(cfg=cfg_p, backend="sharded")
out = serve(srv, inst, cfg_p, cfg_d)
srv.stop()
with open(os.environ["OUT"], "w") as f:
    json.dump(out, f)
"""

# a world of one that the first sharded solve initializes itself
_PORT1 = """
import torch
torch.set_num_threads(1)
from repro_torch.graphs import generators as gen
from repro_torch.core import IRLSConfig, MinCutSession, max_flow
from repro_torch.serve import MinCutServer
""" + _CFGS + """
srv = MinCutServer(cfg=cfg_p, backend="sharded", device="cpu")
out = serve(srv, inst, cfg_p, cfg_d)
srv.stop()
# the session's sharded solve of the same weights in the same process
sess = MinCutSession(inst, cfg_p, backend="sharded", device="cpu")
out["session"] = [sess.solve(weights=(c, inst.s_weight, inst.t_weight),
                             delta_key="a").cut_value
                  for c in traffic(inst)]
with open(os.environ["OUT"], "w") as f:
    json.dump(out, f)
"""

_PORT4 = """
import datetime
import torch
import torch.distributed as dist
torch.set_num_threads(1)
RANK, P = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
dist.init_process_group("gloo", store=dist.FileStore(os.environ["STORE"], P),
                        rank=RANK, world_size=P,
                        timeout=datetime.timedelta(seconds=120))
from repro_torch.graphs import generators as gen
from repro_torch.core import IRLSConfig, max_flow
from repro_torch.serve import MinCutServer, follow_sharded
""" + _CFGS + """
if RANK == 0:
    srv = MinCutServer(cfg=cfg_p, backend="sharded", device="cpu")
    out = serve(srv, inst, cfg_p, cfg_d)
    srv.stop()
else:
    try:
        MinCutServer(cfg=cfg_p, backend="sharded", device="cpu")
        refused = None
    except ValueError as e:
        refused = str(e)
    out = {"follow": follow_sharded(device="cpu"), "refused": refused}
dist.destroy_process_group()
with open(os.environ["OUT"] + f".{RANK}", "w") as f:
    json.dump(out, f)
"""

# follower 2's first session build raises
_FAULT4 = """
import datetime, time
import torch
import torch.distributed as dist
torch.set_num_threads(1)
RANK, P = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
dist.init_process_group("gloo", store=dist.FileStore(os.environ["STORE"], P),
                        rank=RANK, world_size=P,
                        timeout=datetime.timedelta(seconds=120))
from repro_torch.graphs import generators as gen
from repro_torch.core import IRLSConfig, max_flow
from repro_torch.serve import MinCutServer, follow_sharded
from repro_torch.serve import engine
inst = grid(12, 3)
cfg = IRLSConfig(n_irls=20, pcg_max_iters=80, n_blocks=1, precond="jacobi")
if RANK == 0:
    srv = MinCutServer(cfg=cfg, backend="sharded", device="cpu")
    out = {"exact": max_flow(inst).value}
    try:
        srv.submit(inst, inst).result(timeout=200)
        out["first"] = None
    except Exception as e:
        out["first"] = str(e)
    out["second"] = srv.submit(inst, inst).result(timeout=200).cut_value
    t0 = time.time()
    srv.stop()
    out["stop_s"] = time.time() - t0
    st = srv.stats()
    out["completed"], out["failed"] = st["completed"], st["failed"]
else:
    if RANK == 2:
        real, builds = engine.MinCutSession, []

        def flaky(*a, **k):
            builds.append(1)
            if len(builds) == 1:
                raise RuntimeError("planted follower failure")
            return real(*a, **k)
        engine.MinCutSession = flaky
    out = {"follow": follow_sharded(device="cpu")}
dist.destroy_process_group()
with open(os.environ["OUT"] + f".{RANK}", "w") as f:
    json.dump(out, f)
"""


class _Job:
    def __init__(self, name, workdir, code, ranks=None, devices=None):
        self.name, self.ranks = name, ranks
        self.out = os.path.join(workdir, name + ".json")
        env = dict(_ENV, OUT=self.out)
        if devices is not None:
            env["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count="
                                f"{devices}")
        envs = [env]
        if ranks is not None:
            envs = [dict(env, RANK=str(r), WORLD_SIZE=str(ranks),
                         STORE=os.path.join(workdir, name + ".store"))
                    for r in range(ranks)]
        self.logs, self.procs = [], []
        self.t0 = time.time()
        for i, e in enumerate(envs):
            log = os.path.join(workdir, f"{name}.{i}.log")
            self.logs.append(log)
            with open(log, "w") as f:
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-c", textwrap.dedent(code)], env=e,
                    stdout=f, stderr=subprocess.STDOUT))

    def wait(self):
        """Return codes (None: killed at the timeout) and log tails."""
        rcs = []
        for p in self.procs:
            left = max(1.0, JOB_TIMEOUT - (time.time() - self.t0))
            try:
                rcs.append(p.wait(timeout=left))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
                rcs.append(None)
        tails = []
        for log in self.logs:
            with open(log) as f:
                tails.append(f.read()[-3000:])
        return rcs, tails

    def result(self):
        rcs, tails = self.wait()
        assert all(rc == 0 for rc in rcs), (self.name, rcs, tails)
        paths = ([self.out] if self.ranks is None
                 else [f"{self.out}.{r}" for r in range(self.ranks)])
        outs = []
        for path in paths:
            with open(path) as f:
                outs.append(json.load(f))
        return outs[0] if self.ranks is None else outs

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def runs():
    with tempfile.TemporaryDirectory() as workdir:
        jobs = {"ref": _Job("ref", workdir, _COMMON + _REF, devices=4),
                "port1": _Job("port1", workdir, _COMMON + _PORT1),
                "port4": _Job("port4", workdir, _COMMON + _PORT4, ranks=4),
                "fault4": _Job("fault4", workdir, _COMMON + _FAULT4, ranks=4)}
        results = {}
        try:
            for name, job in jobs.items():
                results[name] = job.result()
            yield results
        finally:
            for job in jobs.values():
                job.kill()


def _port(runs, world):
    return runs["port1"] if world == 1 else runs["port4"][0]


@pytest.mark.parametrize("world", [1, 4])
def test_served_voltages_match_reference_server(runs, world):
    """Each tenant request at eps = 1e-3: voltages within 1e-3 of the JAX
    server's (the fused halo path sums its ELL lanes in another order than
    XLA), the same two-level cut (rel 1e-6)."""
    got, want = _port(runs, world)["requests"], runs["ref"]["requests"]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["backend"] == "sharded"
        np.testing.assert_allclose(g["v"], w["v"], rtol=0, atol=1e-3)
        assert g["cut"] == pytest.approx(w["cut"], rel=1e-6)


@pytest.mark.parametrize("world", [1, 4])
def test_served_cut_is_exact(runs, world):
    """At the default eps the served two-level cut is the Dinic cut, as in
    the reference server (rel 1e-6)."""
    port = _port(runs, world)
    assert port["dinic"]["cut"] == pytest.approx(port["exact"], rel=1e-6)
    assert runs["ref"]["dinic"]["cut"] == pytest.approx(runs["ref"]["exact"],
                                                        rel=1e-6)


@pytest.mark.parametrize("world", [1, 4])
def test_warm_state_excluded_and_delta_refill_kept(runs, world):
    """No warm start on the sharded backend: each tenant batch counts as
    ``sharded_excluded``, as in the reference (one worker here, one per
    device there); the tenant's drifted request refills the plans by
    delta."""
    port, ref = _port(runs, world), runs["ref"]
    assert port["warm"] == {"entries": 0, "hits": 0, "misses": 0,
                            "sharded_excluded": 2}
    assert ref["warm"]["sharded_excluded"] == 2
    assert ref["warm"]["hits"] == ref["warm"]["misses"] == 0
    assert port["n_workers"] == 1 and ref["n_workers"] == 4
    assert port["requests"][1]["refill"]["delta"] >= 1


@pytest.mark.parametrize("world", [1, 4])
def test_bad_request_fails_only_its_own_future(runs, world):
    port, ref = _port(runs, world), runs["ref"]
    assert port["bad"] == ref["bad"] == "ValueError"
    assert (port["completed"], port["failed"]) == (3, 1)


def test_world_one_served_cuts_equal_session_solves(runs):
    """A served request gives the cut of ``MinCutSession(backend=
    "sharded").solve`` on the same weights (rel 1e-6)."""
    port = runs["port1"]
    for got, want in zip(port["requests"], port["session"]):
        assert got["cut"] == pytest.approx(want, rel=1e-6)


def test_world_four_equals_world_one(runs):
    """Four ranks serve the cuts of the world of one (rel 1e-6)."""
    for a, b in zip(runs["port4"][0]["requests"] + [runs["port4"][0]["dinic"]],
                    runs["port1"]["requests"] + [runs["port1"]["dinic"]]):
        assert a["cut"] == pytest.approx(b["cut"], rel=1e-6)


def test_followers_leave_on_shutdown(runs):
    """Every follower ran rank 0's batches (the bad request's solve too)
    and left its loop when the server stopped; a follower cannot serve."""
    for out in runs["port4"][1:]:
        assert out["follow"] == {"registrations": 1, "batches": 4,
                                 "solves": 4, "failed": 0, "skipped": 0}
        assert "follows the server on rank 0" in out["refused"]


def test_follower_build_failure_fails_one_request(runs):
    """A follower whose session build raises does not hang rank 0: the
    request fails on rank 0 before any collective of the solver, every
    rank skips that registration, the next request builds the session
    again on every rank and is served (the Dinic cut, rel 1e-6), and every
    rank leaves at the stop, within the job's timeout."""
    head, *followers = runs["fault4"]
    assert "could not build the session" in head["first"]
    assert head["second"] == pytest.approx(head["exact"], rel=1e-6)
    assert (head["completed"], head["failed"]) == (1, 1)
    assert head["stop_s"] < JOB_TIMEOUT
    for out in followers:
        assert out["follow"] == {"registrations": 1, "batches": 1,
                                 "solves": 1, "failed": 0, "skipped": 1}
