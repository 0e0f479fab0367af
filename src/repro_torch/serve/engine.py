"""``MinCutServer`` — continuous-batching request front-end over sessions.

The serving pipeline (a POOL of dispatch workers, ``n_workers`` threads):

  submit(topo, weights) ──► admission control ──► MicroBatcher groups by
                            (topology, cfg, rounding, ...); submit adds
                            under the engine lock and wakes ONE worker
                                     │
        ┌────────────┬───────────────┴─┐
        ▼            ▼                 ▼
     worker 0     worker 1   ...    worker N-1      each idle worker claims
        │            │                 │            one ready batch (size /
        ▼            ▼                 ▼            deadline / idle-flush)
     SessionCache (shared, per-fingerprint build locks — a cold topology
     is built exactly once) ──► MinCutSession.solve_batch (the batched
     scanned program on the server's device, pow2-padded)
        │            │                 │
        ▼            ▼                 ▼
     futures resolve; ServeMetrics records the queue/irls/rounding/total
     breakdown + per-worker utilization and flush-reason counts

Continuous batching: while one worker blocks on an in-flight device solve,
the other workers keep draining the admission queue — batch assembly,
session-cache lookup/compile and device execution of DIFFERENT batches
overlap instead of serializing behind one drain→flush→dispatch loop.  The
idle-aware flush policy (``flush_policy="idle"``, the default) hands a
partial batch to any idle worker immediately: ``max_wait_ms`` only gates
requests when every worker is busy — which is exactly when waiting lets
batches fill and batching pays.  ``flush_policy="deadline"`` restores the
strict size-or-deadline triggers of the single-worker engine.

``submit`` is non-blocking and thread-safe; it returns a
``concurrent.futures.Future[SolveResult]``.  ``submit_many`` enqueues a
burst at once, so an idle worker sees the whole burst and not its first
request.  Topologies are identified by
content hash (``topology_fingerprint``) — submit an ``STInstance`` directly
(registered on first sight) or pre-``register`` it and pass the key.

Requests may override ``cfg``/``rounding`` per call; only requests with
identical ``(topology, cfg, rounding)`` share a batch, so an override can
never change another request's numerics.  Malformed weights are rejected
synchronously at ``submit`` (shape-checked against the registered
topology), so one request can never poison its co-batched neighbours;
errors raised during batch execution (e.g. a cfg whose partition geometry
doesn't match the server's) land on every future of that batch.

The JAX package's ``repro.serve.engine`` over the port's session, on the
server's ``device`` (default ``"cuda"``).  The sharded backend is not
ported yet (ROADMAP queue 1, ``distributed/``) and raises
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..core.irls import IRLSConfig
from ..core.session import (MinCutSession, Problem, SolveResult, Weights,
                            check_weights_for)
from ..graphs.structures import STInstance
from ..obs import trace
from ..obs.metrics import get_registry
from ..obs.telemetry import TelemetryAggregator

from .batcher import MicroBatch, MicroBatcher
from .cache import AdmissionController, ServerOverloaded, SessionCache
from .metrics import ServeMetrics

_DEFAULT = object()      # "use the server default" sentinel (None = skip)

FLUSH_POLICIES = ("idle", "deadline")


def default_workers(backend: str) -> int:
    """Worker-pool width when the caller doesn't pick one.

    host/scanned — a small pool of host threads: while one worker waits on
    the device (PyTorch releases the GIL there) the others assemble and
    dispatch further batches.  sharded (one worker per device in the JAX
    package) is not ported yet.
    """
    if backend == "sharded":
        raise NotImplementedError(_SHARDED)
    return 4


_SHARDED = ("the sharded backend is not ported yet: ROADMAP queue 1, "
            "distributed/")


@dataclasses.dataclass
class _Request:
    topo_key: str
    weights: Weights
    cfg: IRLSConfig
    rounding: Optional[str]
    future: Future
    t_submit: float
    tenant: Optional[str] = None
    presolve: bool = False

    @property
    def group_key(self):
        # tenant and presolve are batch keys too: a micro-batch must share
        # one warm-start source and one solve pipeline
        return (self.topo_key, self.cfg, self.rounding, self.tenant,
                self.presolve)


class MinCutServer:
    """Continuous-batching min-cut serving engine (see module docstring).

    cfg          — default solver config (per-request override via submit)
    capacity     — LRU capacity of the Problem/session cache (topologies)
    max_batch    — flush trigger + padding cap; one micro-batch never
                   exceeds this many requests
    max_wait_ms  — deadline trigger: max batcher residency of the oldest
                   pending request once every worker is busy (under
                   ``flush_policy="idle"`` an idle worker flushes sooner)
    max_queue    — admission cap on in-flight requests (backpressure)
    rounding     — default rounding registry name (None = voltages only)
    backend      — session backend requests execute on.  "scanned"
                   (default) runs each micro-batch as ONE batched program;
                   "host" solves the batch's requests one ``solve()`` at a
                   time through the same cached sessions.  Both honor the
                   adaptive early-exit default below.
    n_workers    — dispatch worker threads pulling ready batches from the
                   shared admission queue (default 4 — see
                   ``default_workers``)
    flush_policy — "idle" (default): a partial batch flushes as soon as
                   any worker is idle; "deadline": strict size-or-deadline
                   triggers (the legacy single-worker behavior)
    device       — where every session of the server solves ("cuda", or
                   "cpu" for the kernels' plain versions)
    """

    # server default: the adaptive early-exit schedule — converged
    # requests stop paying for matvecs, so co-batched easy instances don't
    # ride along for the hard ones' full budget (irls_tol=0 restores the
    # fixed schedule)
    def __init__(self, cfg: IRLSConfig = IRLSConfig(n_irls=20, n_blocks=1,
                                                    precond="jacobi",
                                                    irls_tol=1e-3,
                                                    adaptive_tol=True),
                 capacity: int = 8, max_batch: int = 8,
                 max_wait_ms: float = 2.0, max_queue: int = 256,
                 rounding: Optional[str] = "two_level", seed: int = 0,
                 backend: str = "scanned", presolve: bool = False,
                 warm_capacity: int = 32, n_workers: Optional[int] = None,
                 flush_policy: str = "idle", device="cuda"):
        if backend == "sharded":
            raise NotImplementedError(_SHARDED)
        if backend not in MinCutSession.BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; "
                             f"known: {MinCutSession.BACKENDS}")
        if flush_policy not in FLUSH_POLICIES:
            raise ValueError(f"unknown flush_policy {flush_policy!r}; "
                             f"known: {FLUSH_POLICIES}")
        if n_workers is None:
            n_workers = default_workers(backend)
        if n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {n_workers}")
        self.cfg = cfg
        self.rounding = rounding
        self.seed = seed
        self.backend = backend
        self.presolve = presolve
        self.n_workers = int(n_workers)
        self.flush_policy = flush_policy
        self.device = torch.device(device)
        # warm-start store: (tenant, topology fingerprint) -> last converged
        # voltages for that tenant on that topology.  Tenants replay "same
        # topology, drifting weights" traffic, so the previous optimum is an
        # excellent v0; entries only exist for submits that name a tenant.
        self._warm: "OrderedDict[tuple, np.ndarray]" = OrderedDict()
        self._warm_capacity = warm_capacity
        self._warm_hits = 0
        self._warm_misses = 0
        self._warm_lock = threading.Lock()
        self.metrics = ServeMetrics()
        # cross-request solver telemetry (PCG spend, phase walls, early-exit
        # rates) aggregated from every SolveResult.telemetry this server
        # produced; surfaced under stats()["telemetry"]
        self.telemetry = TelemetryAggregator()
        self.cache = SessionCache(capacity, self._build_session, self.device)
        self.admission = AdmissionController(max_queue)
        self._batcher = MicroBatcher(max_batch=max_batch,
                                     max_wait_ms=max_wait_ms)
        # ONE lock guards the batcher + lifecycle flags; workers sleep on
        # the condition and submit wakes exactly one of them per request.
        # Batch execution always happens OUTSIDE this lock.
        self._cond = threading.Condition()
        self._stopping = False
        self._stopped = False
        self._idle_workers = 0
        self._busy_s = [0.0] * self.n_workers     # per-worker execute time
        self._workers = [
            threading.Thread(target=self._worker_loop, args=(i,),
                             name=f"mincut-serve-worker-{i}", daemon=True)
            for i in range(self.n_workers)]
        for w in self._workers:
            w.start()

    # -- public API -----------------------------------------------------------
    def register(self, instance: STInstance) -> str:
        """Register a topology; returns its content-hash key."""
        return self.cache.register(instance)

    def submit(self, topo: Union[str, STInstance], weights,
               cfg: Optional[IRLSConfig] = None,
               rounding=_DEFAULT, tenant: Optional[str] = None,
               presolve: Optional[bool] = None) -> "Future[SolveResult]":
        """Enqueue one solve; returns a future resolving to a SolveResult.

        ``topo`` — a key from ``register`` or an ``STInstance`` (registered
        on the fly).  ``weights`` — anything ``as_weights`` accepts, in
        ORIGINAL node/edge order for that topology.  Shape mismatches are
        rejected here, synchronously — a malformed request must never reach
        a batch where it would poison its co-batched neighbours.

        ``tenant`` — opt-in warm-start identity: requests naming a tenant
        warm-start from that tenant's previous solution on the same
        topology (keyed on (tenant, topology fingerprint)) and only batch
        with their own tenant's requests.  ``presolve`` — kernelize before
        solving (default: the server's ``presolve`` setting).
        """
        req = self._admit(topo, weights, cfg, rounding, tenant, presolve)
        self._enqueue([req])
        return req.future

    def submit_many(self, topo: Union[str, STInstance], weights_list,
                    cfg: Optional[IRLSConfig] = None, rounding=_DEFAULT,
                    tenant: Optional[str] = None) -> List[Future]:
        """Enqueue a burst of solves at once (the arguments of ``submit``,
        one weight assignment per request); returns their futures in order.
        The burst enters the batcher under one lock, so a worker claims it
        whole (up to ``max_batch`` per batch) and not request by request.
        If admission rejects a request, none of the burst is enqueued."""
        reqs: List[_Request] = []
        try:
            for w in weights_list:
                reqs.append(self._admit(topo, w, cfg, rounding, tenant,
                                        None))
        except Exception:
            for _ in reqs:
                self.admission.release()
            raise
        self._enqueue(reqs)
        return [r.future for r in reqs]

    def _admit(self, topo, weights, cfg, rounding, tenant, presolve
               ) -> "_Request":
        """Validate one request and take its admission slot."""
        if isinstance(topo, str):
            if not self.cache.known(topo):
                raise KeyError(f"unknown topology key {topo!r}; register() "
                               f"its instance first")
            key = topo
        else:
            key = self.register(topo)
        w = check_weights_for(self.cache.instance(key), weights)
        if not self.admission.try_admit():
            self.metrics.record_reject()
            raise ServerOverloaded(
                f"{self.admission.max_queue} requests already in flight")
        return _Request(topo_key=key, weights=w,
                        cfg=cfg or self.cfg,
                        rounding=self.rounding if rounding is _DEFAULT
                        else rounding,
                        future=Future(), t_submit=0.0,   # stamped at enqueue
                        tenant=tenant,
                        presolve=self.presolve if presolve is None
                        else presolve)

    def _enqueue(self, reqs: Sequence["_Request"]) -> None:
        # the stopped-check + enqueue are atomic against stop(): a request
        # admitted under this lock is guaranteed to be drained before the
        # last worker exits, so it either raises here or resolves
        with self._cond:
            if self._stopping:
                for _ in reqs:
                    self.admission.release()
                raise RuntimeError("MinCutServer is stopped")
            for req in reqs:
                now = time.perf_counter()
                req.t_submit = now
                self.metrics.record_submit(now)
                get_registry().counter("serve_requests_total").inc()
                self._batcher.add(req.group_key, req, now)
            get_registry().gauge("serve_queue_depth").set(
                self._batcher.pending)
            self._cond.notify(len(reqs))

    def solve_many(self, topo, weights_list, timeout: Optional[float] = None
                   ) -> List[SolveResult]:
        """Convenience: submit a burst and wait for all results in order."""
        futures = self.submit_many(topo, weights_list)
        return [f.result(timeout=timeout) for f in futures]

    def stats(self) -> Dict[str, object]:
        out = self.metrics.snapshot()
        out["device"] = str(self.device)
        out["cache"] = self.cache.stats.snapshot()
        out["in_flight"] = self.admission.in_flight
        with self._warm_lock:
            out["warm"] = {"entries": len(self._warm),
                           "hits": self._warm_hits,
                           "misses": self._warm_misses}
        out["telemetry"] = self.telemetry.snapshot()
        out["workers"] = self.worker_stats()
        return out

    def worker_stats(self) -> Dict[str, object]:
        """Pool shape + utilization: per-worker busy seconds and the busy
        share of the pool over the metrics window (submit of the first
        request → completion of the latest)."""
        with self._cond:
            busy = list(self._busy_s)
            idle = self._idle_workers
            pending = self._batcher.pending
        window = self.metrics.window_seconds()
        return {
            "n_workers": self.n_workers,
            "flush_policy": self.flush_policy,
            "busy_seconds": busy,
            "utilization": (sum(busy) / (self.n_workers * window)
                            if window > 0 else 0.0),
            "idle_now": idle,
            "queue_depth": pending,
        }

    def reset_measurement(self) -> None:
        """Start a fresh measurement window: new ServeMetrics, cleared
        telemetry AND zeroed per-worker busy clocks — the utilization
        denominator (the metrics window) and its numerator must restart
        together, or a warmup pass inflates every later reading."""
        with self._cond:
            self.metrics = ServeMetrics()
            self._busy_s = [0.0] * self.n_workers
        self.telemetry.clear()

    def stop(self, wait: bool = True) -> None:
        """Drain pending requests, then stop the workers.  Idempotent."""
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        if wait:
            for w in self._workers:
                if w.is_alive():
                    w.join()
        self._stopped = True

    def __enter__(self) -> "MinCutServer":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- workers ---------------------------------------------------------------
    def _build_session(self, instance: STInstance,
                       device: torch.device) -> MinCutSession:
        n_blocks = (self.cfg.n_blocks if self.cfg.precond == "block_jacobi"
                    else 1)
        prob = Problem.build(instance, n_blocks=n_blocks, seed=self.seed)
        return MinCutSession(prob, self.cfg, backend=self.backend,
                             device=device)

    def _claim_batch(self) -> Optional[MicroBatch]:
        """Block until a batch is ready (claimed) or shutdown is complete.

        Runs the engine's flush policy under the condition lock: full
        groups flush by size, aged groups by deadline, and — under
        ``flush_policy="idle"`` — any pending group flushes immediately
        into this (by definition idle) worker.  Returns None only when
        stopping AND the batcher is fully drained.
        """
        with self._cond:
            while True:
                allow_partial = self._stopping or self.flush_policy == "idle"
                batch = self._batcher.take(time.perf_counter(),
                                           allow_partial=allow_partial)
                if batch is not None:
                    get_registry().gauge("serve_queue_depth").set(
                        self._batcher.pending)
                    return batch
                if self._stopping:      # nothing left to take: drained
                    return None
                deadline = self._batcher.next_deadline()
                timeout = (None if deadline is None
                           else max(0.0, deadline - time.perf_counter()))
                self._idle_workers += 1
                get_registry().gauge("serve_idle_workers").set(
                    self._idle_workers)
                try:
                    self._cond.wait(timeout)
                finally:
                    self._idle_workers -= 1
                    get_registry().gauge("serve_idle_workers").set(
                        self._idle_workers)

    def _worker_loop(self, wid: int) -> None:
        while True:
            batch = self._claim_batch()
            if batch is None:
                return
            t0 = time.perf_counter()
            try:
                self._execute(batch, wid)
            finally:
                with self._cond:
                    self._busy_s[wid] += time.perf_counter() - t0

    def _warm_lookup(self, tenant: Optional[str], topo_key: str):
        """Stored voltages for (tenant, topology), None on miss."""
        if tenant is None:
            return None
        with self._warm_lock:
            v0 = self._warm.get((tenant, topo_key))
            if v0 is None:
                self._warm_misses += 1
            else:
                self._warm_hits += 1
                self._warm.move_to_end((tenant, topo_key))
            return v0

    def _warm_store(self, tenant: Optional[str], topo_key: str,
                    res: SolveResult) -> None:
        if tenant is None:
            return
        with self._warm_lock:
            self._warm[(tenant, topo_key)] = np.asarray(res.voltages)
            self._warm.move_to_end((tenant, topo_key))
            while len(self._warm) > self._warm_capacity:
                self._warm.popitem(last=False)

    def _execute(self, batch: MicroBatch, wid: int) -> None:
        reqs: List[_Request] = batch.requests
        topo_key, cfg, rounding, tenant, presolve = batch.key
        t_exec = time.perf_counter()
        get_registry().counter("serve_batches_total").inc()
        get_registry().gauge("serve_in_flight").set(self.admission.in_flight)
        with trace.span("serve.batch", size=len(reqs), bucket=batch.bucket,
                        reason=batch.reason, backend=self.backend,
                        worker=wid, topo=topo_key[:8]):
            try:
                # assembly: everything between batch pickup and solver
                # dispatch — session cache lookup (possibly a compile) and
                # warm-start staging
                with trace.span("serve.assembly", topo=topo_key[:8],
                                worker=wid):
                    sess = self.cache.get(topo_key)
                    v0 = self._warm_lookup(tenant, topo_key)
                t_dispatch = time.perf_counter()
                # tenant doubles as the weight-sequence identity for the
                # session's delta-staging cache: a tenant replaying "same
                # topology, drifting weights" restages only the changed
                # ELL slots (and patches presolve kernels) between solves
                dks = None if tenant is None else [tenant] * len(reqs)
                if self.backend == "scanned" and not presolve:
                    results = sess.solve_batch(
                        [r.weights for r in reqs], rounding=rounding, cfg=cfg,
                        pad_to=batch.bucket,
                        warm_from=None if v0 is None else [v0] * len(reqs),
                        delta_keys=dks)
                elif self.backend == "scanned":
                    # presolve batches group by kernel topology inside the
                    # session and run cold (the kernel basis shifts with
                    # the weights, so prior voltages do not transfer)
                    results = sess.solve_batch([r.weights for r in reqs],
                                               rounding=rounding, cfg=cfg,
                                               presolve=True, delta_keys=dks)
                else:
                    # host: no batched program — the batch still amortizes
                    # the cached session, one solve per request
                    results = [sess.solve(weights=r.weights,
                                          rounding=rounding, cfg=cfg,
                                          presolve=presolve, warm_from=v0,
                                          delta_key=tenant)
                               for r in reqs]
            except Exception as e:
                now = time.perf_counter()
                for r in reqs:
                    self.admission.release()
                    # set_running_or_notify_cancel returns False for a
                    # future the caller already cancelled — resolving it
                    # would raise InvalidStateError and kill the worker
                    if r.future.set_running_or_notify_cancel():
                        self.metrics.record_request({}, now, failed=True)
                        r.future.set_exception(e)
                    else:
                        self.metrics.record_cancelled()
                return
        self.metrics.record_batch(len(reqs), batch.bucket,
                                  reason=batch.reason)
        if results:
            self._warm_store(tenant, topo_key, results[-1])
        now = time.perf_counter()
        assembly = t_dispatch - t_exec
        warm_hit = v0 is not None
        for r, res in zip(reqs, results):
            self.admission.release()
            if not r.future.set_running_or_notify_cancel():
                self.metrics.record_cancelled()
                continue
            timings = dict(res.timings)
            timings["queue"] = t_exec - r.t_submit
            timings["assembly"] = assembly
            # solver wall the request actually waited behind: the FULL
            # dispatch window (a presolve batch runs several kernel-group
            # solves back to back — the session's own irls_wall only covers
            # this request's group), minus the phases accounted separately
            timings["irls_wall"] = max(0.0, (now - t_dispatch) - sum(
                float(timings.get(k, 0.0))
                for k in ("setup", "presolve", "rounding")))
            timings["total"] = now - r.t_submit
            tel = res.telemetry
            if tel is not None:
                tel = dict(tel)
                tel["phases"] = timings
                tel["worker"] = wid
                if tenant is not None:
                    tel["warm_start"] = warm_hit
                self.telemetry.add(tel)
                self.metrics.record_solve_cost(tel.get("flops"),
                                               tel.get("achieved_gflops"))
            res = res._replace(timings=timings, telemetry=tel)
            self.metrics.record_request(timings, now)
            r.future.set_result(res)
        get_registry().gauge("serve_in_flight").set(self.admission.in_flight)
