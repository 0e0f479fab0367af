"""The port's serving engine (``repro_torch.serve``) on the CPU: the cases of
tests/test_serve.py that need neither presolve nor cut trees, run against
the port's sessions on ``device="cpu"``, plus answers held against the JAX
package's server and against ``solve_batch`` on the same weights.

Tolerances: cuts at rel 1e-4 where tests/test_serve.py holds them there
(batches of other compositions); within the port a served request equals
``solve_batch`` of the same batch exactly (the CPU sums every lane in the
same order); against the JAX package's server, rel 1e-6 as in
tests/test_torch_scanned.py.
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import tiny_instance  # noqa: E402

from repro_torch.core import IRLSConfig, MinCutSession, Problem, Weights  # noqa: E402
from repro_torch.core.session import topology_fingerprint  # noqa: E402
from repro_torch.graphs.structures import instance_from_arrays  # noqa: E402
from repro_torch.serve import (MicroBatcher, MinCutServer,  # noqa: E402
                               ServerOverloaded, SessionCache, bucket_size,
                               default_workers)

# the adaptive early-exit scanned schedule IS the serving default — the
# whole end-to-end suite runs on it
CFG = IRLSConfig(n_irls=8, pcg_max_iters=30, precond="jacobi", n_blocks=1,
                 irls_tol=1e-3, adaptive_tol=True)


def _port(inst):
    return instance_from_arrays(inst.graph.src, inst.graph.dst,
                                inst.graph.weight, inst.graph.n,
                                inst.s_weight, inst.t_weight)


@pytest.fixture(scope="module")
def grid(grid_instance):
    return _port(grid_instance)


@pytest.fixture(scope="module")
def road(road_instance):
    return _port(road_instance)


def _weights(inst, scale=1.0):
    return Weights(np.asarray(inst.graph.weight) * scale,
                   np.asarray(inst.s_weight), np.asarray(inst.t_weight))


def _server(**kw):
    return MinCutServer(cfg=kw.pop("cfg", CFG), device="cpu", **kw)


# ---------------------------------------------------------------------------
# fingerprint
# ---------------------------------------------------------------------------

def test_fingerprint_ignores_weights_not_topology(grid, road, grid_instance):
    from repro.core.session import topology_fingerprint as jfingerprint

    fp = topology_fingerprint(grid)
    assert fp == jfingerprint(grid_instance)     # the packages agree
    scaled = Problem.build(grid, n_blocks=1).instance_with(_weights(grid, 3.0))
    assert topology_fingerprint(scaled) == fp
    assert topology_fingerprint(road) != fp
    assert Problem.build(grid, n_blocks=1).fingerprint == fp


# ---------------------------------------------------------------------------
# micro-batcher (pure, clock-driven)
# ---------------------------------------------------------------------------

def test_bucket_size_pow2_capped():
    assert [bucket_size(k, 8) for k in (1, 2, 3, 4, 5, 7, 8, 9, 20)] == \
        [1, 2, 4, 4, 8, 8, 8, 8, 8]


def test_batcher_size_trigger_flushes_full_batches():
    b = MicroBatcher(max_batch=4, max_wait_ms=1e6)
    for i in range(9):
        b.add("g", i, now=0.0)
    out = b.ready(now=0.0)
    assert [len(x.requests) for x in out] == [4, 4]
    assert all(x.bucket == 4 for x in out)
    assert b.pending == 1


def test_batcher_take_size_deadline_idle_precedence():
    b = MicroBatcher(max_batch=4, max_wait_ms=10.0)
    assert b.take(now=0.0, allow_partial=True) is None
    for i in range(5):
        b.add("g", i, now=0.0)
    b.add("h", "h0", now=0.001)
    full = b.take(now=0.0)
    assert full.key == "g" and len(full.requests) == 4
    assert full.reason == "size"
    assert b.take(now=0.005) is None
    idle = b.take(now=0.005, allow_partial=True)
    assert idle.key == "g" and idle.requests == [4]
    assert idle.reason == "idle" and idle.bucket == 1
    late = b.take(now=0.012, allow_partial=True)
    assert late.key == "h" and late.reason == "deadline"
    assert b.pending == 0 and b.take(now=1.0) is None


def test_batcher_deadline_trigger_and_grouping():
    b = MicroBatcher(max_batch=8, max_wait_ms=10.0)
    b.add("a", "a0", now=0.0)
    b.add("b", "b0", now=0.005)
    assert b.ready(now=0.005) == []
    assert b.next_deadline() == pytest.approx(0.010)
    out = b.ready(now=0.011)
    assert [(x.key, x.requests) for x in out] == [("a", ["a0"])]
    assert b.pending == 1
    out = b.flush_all()
    assert [(x.key, x.requests, x.bucket) for x in out] == [("b", ["b0"], 1)]
    assert b.pending == 0


# ---------------------------------------------------------------------------
# session cache
# ---------------------------------------------------------------------------

def test_session_cache_lru_eviction_and_rebuild():
    insts = [_port(tiny_instance(n=8, seed=s)) for s in range(3)]
    built = []
    cache = SessionCache(capacity=2, device="cpu",
                         build=lambda inst, dev: built.append(dev) or object())
    keys = [cache.register(i) for i in insts]
    assert len(set(keys)) == 3
    cache.get(keys[0]); cache.get(keys[1])
    assert cache.stats.misses == 2 and cache.stats.evictions == 0
    cache.get(keys[0])
    assert cache.stats.hits == 1
    cache.get(keys[2])
    assert cache.stats.evictions == 1
    assert set(cache.cached_keys()) == {keys[0], keys[2]}
    cache.get(keys[1])
    assert cache.stats.rebuilds == 1 and cache.stats.misses == 4
    assert built == [torch.device("cpu")] * 4   # the device reaches every build
    with pytest.raises(KeyError, match="unknown topology"):
        cache.get("deadbeef")


def test_session_cache_compile_race_builds_once():
    inst = _port(tiny_instance(n=8, seed=0))
    built = []
    gate = threading.Barrier(2, timeout=30.0)

    def build(i, dev):
        built.append(i)
        return object()

    cache = SessionCache(capacity=2, build=build, device="cpu")
    key = cache.register(inst)
    got = [None, None]

    def hit(slot):
        gate.wait()
        got[slot] = cache.get(key)

    ts = [threading.Thread(target=hit, args=(s,)) for s in (0, 1)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30.0)
    assert not any(t.is_alive() for t in ts)
    assert len(built) == 1
    assert got[0] is got[1] is not None
    assert cache.stats.misses == 1 and cache.stats.hits == 1


# ---------------------------------------------------------------------------
# engine end-to-end
# ---------------------------------------------------------------------------

def test_server_microbatches_concurrent_topologies(grid, road):
    """Concurrent submissions across 2 topologies are micro-batched and every
    result matches a single-request solve on the same weights to ≤ 1e-4."""
    with _server(capacity=4, max_batch=4, max_wait_ms=250.0) as srv:
        keys = [srv.register(grid), srv.register(road)]
        futs = []
        for inst, key in zip((grid, road), keys):
            futs.append([srv.submit(key, _weights(inst, 1.0 + 0.1 * i))
                         for i in range(5)])
        results = [[f.result(timeout=600.0) for f in fs] for fs in futs]
        assert srv.metrics.max_batch_size() > 1
        assert srv.metrics.completed == 10
        stats = srv.stats()
    assert stats["cache"]["misses"] == 2
    assert stats["device"] == "cpu"
    for inst, res_list in zip((grid, road), results):
        sess = MinCutSession(Problem.build(inst, n_blocks=1), CFG,
                             backend="scanned", device="cpu")
        for i, res in enumerate(res_list):
            single = sess.solve(weights=_weights(inst, 1.0 + 0.1 * i))
            assert res.cut_value == pytest.approx(single.cut_value, rel=1e-4)
            np.testing.assert_allclose(res.voltages, single.voltages,
                                       atol=0.1)
            assert res.timings["queue"] >= 0.0
            assert res.timings["total"] >= res.timings["queue"]


def test_server_answers_equal_solve_batch(grid):
    """A served burst is one batch, and its answers are ``solve_batch``'s on
    the same weights in the same batch: a tenant's second burst warm-starts
    from the first burst's last voltages, as the server's warm store
    holds them."""
    ws = [_weights(grid, 1.0 + 0.05 * i) for i in range(8)]
    ws2 = [_weights(grid, 1.5 + 0.05 * i) for i in range(8)]
    with _server(rounding="sweep") as srv:
        key = srv.register(grid)
        first = [f.result(timeout=600.0)
                 for f in srv.submit_many(key, ws, tenant="t")]
        second = [f.result(timeout=600.0)
                  for f in srv.submit_many(key, ws2, tenant="t")]
        stats = srv.stats()
    assert stats["batch_sizes"] == [8, 8]
    assert stats["flush_reasons"]["size"] == 2
    assert stats["warm"] == {"entries": 1, "hits": 1, "misses": 1,
                             "sharded_excluded": 0}
    sess = MinCutSession(Problem.build(grid, n_blocks=1), CFG,
                         backend="scanned", device="cpu")
    want = sess.solve_batch(ws, rounding="sweep")
    want2 = sess.solve_batch(ws2, rounding="sweep",
                             warm_from=[first[-1].voltages] * 8)
    for got, ref in zip(first + second, want + want2):
        np.testing.assert_array_equal(got.voltages, ref.voltages)
        np.testing.assert_array_equal(got.pcg_iters, ref.pcg_iters)
        assert got.cut_value == ref.cut_value
    assert [r.telemetry["warm_start"] for r in first + second] == \
        [False] * 8 + [True] * 8


def test_server_matches_reference_server(grid_instance, grid):
    """The JAX package's server and the port's answer the same requests
    with the same cuts."""
    from repro.core import IRLSConfig as JConfig, Weights as JWeights
    from repro.serve import MinCutServer as JServer

    jcfg = JConfig(n_irls=8, pcg_max_iters=30, precond="jacobi", n_blocks=1,
                   irls_tol=1e-3, adaptive_tol=True)
    ws = [_weights(grid, s) for s in (0.8, 1.0, 1.3)]
    with JServer(cfg=jcfg, max_batch=4, max_wait_ms=1.0) as jsrv:
        key = jsrv.register(grid_instance)
        want = [f.result(timeout=600.0) for f in
                [jsrv.submit(key, JWeights(*w)) for w in ws]]
    with _server(max_batch=4, max_wait_ms=1.0) as srv:
        key = srv.register(grid)
        got = [f.result(timeout=600.0) for f in
               [srv.submit(key, w) for w in ws]]
    for g, w in zip(got, want):
        assert g.cut_value == pytest.approx(w.cut_value, rel=1e-6)


def test_server_lru_eviction_under_capacity_pressure():
    insts = [_port(tiny_instance(n=8, seed=s)) for s in (0, 1)]
    with _server(capacity=1, max_batch=2, max_wait_ms=1.0) as srv:
        for _ in range(2):
            for inst in insts:
                srv.submit(inst, _weights(inst)).result(timeout=600.0)
        stats = srv.stats()
    assert stats["cache"]["evictions"] >= 2
    assert stats["cache"]["rebuilds"] >= 1
    assert stats["completed"] == 4


def test_server_admission_control_rejects_over_cap(grid):
    with _server(max_batch=4, max_wait_ms=500.0, max_queue=3) as srv:
        key = srv.register(grid)
        futs = [srv.submit(key, _weights(grid)) for _ in range(3)]
        with pytest.raises(ServerOverloaded):
            srv.submit(key, _weights(grid))
        assert srv.metrics.rejected == 1
        for f in futs:
            f.result(timeout=600.0)
        srv.submit(key, _weights(grid)).result(timeout=600.0)
        # a burst that does not fit is refused whole, leaking no slot
        with pytest.raises(ServerOverloaded):
            srv.submit_many(key, [_weights(grid)] * 4)
        assert srv.admission.in_flight == 0
    assert srv.metrics.completed == 4


def test_server_unknown_key_and_stopped_submit(grid):
    srv = _server()
    with pytest.raises(KeyError, match="unknown topology"):
        srv.submit("no-such-key", _weights(grid))
    srv.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        srv.submit(grid, _weights(grid))
    assert srv.admission.in_flight == 0


def test_server_bad_weights_rejected_at_submit(grid):
    with _server(max_batch=2, max_wait_ms=1.0) as srv:
        key = srv.register(grid)
        with pytest.raises(ValueError, match="topology"):
            srv.submit(key, Weights(np.ones(3), np.ones(4), np.ones(4)))
        assert srv.admission.in_flight == 0
        good = srv.submit(key, _weights(grid))
        assert np.isfinite(good.result(timeout=600.0).cut_value)
        assert srv.metrics.failed == 0 and srv.metrics.completed == 1


def test_server_cancelled_future_skipped_not_fatal(grid):
    with _server(max_batch=4, max_wait_ms=100.0) as srv:
        key = srv.register(grid)
        with srv._cond:          # keep the workers off the batcher
            doomed = srv.submit(key, _weights(grid))
            assert doomed.cancel()
        after = srv.submit(key, _weights(grid, 1.2))
        assert np.isfinite(after.result(timeout=600.0).cut_value)
        assert srv.metrics.cancelled == 1
        assert srv.admission.in_flight == 0


def test_server_stop_flushes_pending(grid):
    srv = _server(max_batch=64, max_wait_ms=60_000.0,
                  flush_policy="deadline")
    key = srv.register(grid)
    futs = [srv.submit(key, _weights(grid, 1.0 + 0.2 * i)) for i in range(3)]
    srv.stop()
    for f in futs:
        assert np.isfinite(f.result(timeout=1.0).cut_value)


def test_multiworker_concurrent_submit_during_stop_no_lost_futures(grid):
    """Many threads submit while stop(wait=True) lands in the middle: every
    submit raises or resolves exactly once, at the single-worker cut."""
    w = _weights(grid)
    with _server(n_workers=1, max_batch=4, max_wait_ms=1.0) as ref_srv:
        key = ref_srv.register(grid)
        ref_cut = ref_srv.submit(key, w).result(timeout=600.0).cut_value

    srv = _server(n_workers=4, max_batch=4, max_wait_ms=5.0, max_queue=10_000)
    key = srv.register(grid)
    srv.submit(key, w).result(timeout=600.0)
    accepted, rejected = [], []
    lock = threading.Lock()
    start = threading.Barrier(9, timeout=60.0)

    def submitter():
        start.wait()
        for _ in range(10):
            try:
                f = srv.submit(key, w)
            except RuntimeError as e:
                assert "stopped" in str(e)
                with lock:
                    rejected.append(e)
            else:
                with lock:
                    accepted.append(f)

    def stopper():
        start.wait()
        srv.stop(wait=True)

    threads = [threading.Thread(target=submitter) for _ in range(8)]
    threads.append(threading.Thread(target=stopper))
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600.0)
    assert not any(t.is_alive() for t in threads)
    assert len(accepted) + len(rejected) == 80
    results = [f.result(timeout=60.0) for f in accepted]
    for r in results:
        assert r.cut_value == pytest.approx(ref_cut, rel=1e-4)
    assert srv.metrics.completed == len(accepted) + 1
    assert srv.worker_stats()["n_workers"] == 4


def test_multiworker_parity_and_worker_stats(grid, road):
    insts = [grid, road]
    ws = [[_weights(inst, 1.0 + 0.15 * i) for i in range(6)]
          for inst in insts]

    def serve_all(n_workers, flush_policy):
        with _server(capacity=4, max_batch=4, max_wait_ms=5.0,
                     n_workers=n_workers, flush_policy=flush_policy) as srv:
            keys = [srv.register(inst) for inst in insts]
            futs = [srv.submit(key, w)
                    for key, wlist in zip(keys, ws) for w in wlist]
            out = [f.result(timeout=600.0) for f in futs]
            stats = srv.worker_stats()
            tel = srv.telemetry.snapshot()
        return out, stats, tel

    single, _, _ = serve_all(1, "deadline")
    multi, stats, tel = serve_all(4, "idle")
    for a, b in zip(single, multi):
        assert b.cut_value == pytest.approx(a.cut_value, rel=1e-4)
    assert stats["n_workers"] == 4 and stats["flush_policy"] == "idle"
    assert len(stats["busy_seconds"]) == 4
    assert sum(tel["by_worker"].values()) == tel["solves"] == 12


def test_server_host_backend_per_request_solves(grid):
    ws = [_weights(grid, s) for s in (0.8, 1.5, 2.5)]
    with _server(max_batch=4, max_wait_ms=1.0) as scanned_srv:
        key = scanned_srv.register(grid)
        ref = [f.result(timeout=120)
               for f in [scanned_srv.submit(key, w) for w in ws]]
    with _server(max_batch=4, max_wait_ms=1.0, backend="host") as host_srv:
        key = host_srv.register(grid)
        got = [f.result(timeout=120)
               for f in [host_srv.submit(key, w, tenant="h") for w in ws]]
    for r, g in zip(ref, got):
        assert g.backend == "host"
        assert g.diagnostics is not None
        assert g.cut_value == pytest.approx(r.cut_value, rel=1e-3)


def test_server_rejects_unknown_backend_and_later_slices():
    """No backend is left to a later slice: presolve and the sharded
    backend are ported (the sharded one serves with one worker: its
    batches run one at a time; tests/test_torch_serve_sharded.py serves
    through it)."""
    with pytest.raises(ValueError):
        _server(backend="warp")
    with _server(backend="sharded") as srv:
        assert srv.n_workers == 1
    with _server(presolve=True) as srv:
        assert srv.presolve
    assert default_workers("sharded") == 1
    assert default_workers("scanned") == 4


def test_server_tenant_warm_start_hits_and_parity(grid):
    ws = [_weights(grid, s) for s in (1.0, 1.1, 1.2)]
    with _server(max_batch=2, max_wait_ms=1.0) as srv:
        key = srv.register(grid)
        cold = [srv.submit(key, w).result(timeout=600.0) for w in ws]
        warm = [srv.submit(key, w, tenant="acme").result(timeout=600.0)
                for w in ws]
        stats = srv.stats()
    assert stats["warm"]["entries"] == 1
    assert stats["warm"]["misses"] == 1
    assert stats["warm"]["hits"] == 2
    for c, w_res in zip(cold, warm):
        assert w_res.cut_value == pytest.approx(c.cut_value, rel=1e-4)


def test_launch_counter_is_thread_safe(monkeypatch):
    """The serving workers launch kernels concurrently: counts under the
    lock lose no update (8 threads, a short switch interval)."""
    import sys

    from repro_torch.kernels import ops

    ops.reset_launches()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=lambda: [ops._count("edge_reweight")
                                               for _ in range(2000)])
              for _ in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60.0)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts)
    assert ops.launches["edge_reweight"] == 16000
    ops.reset_launches()
    assert set(ops.launches.values()) == {0}
