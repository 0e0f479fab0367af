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
server's ``device`` (default ``"cuda"``).

The sharded backend serves over the ranks of a ``torch.distributed``
group (``group``; None: the default group, or a world of one that the
first solve initializes).  The JAX server is one controller over the whole
mesh; here every rank runs its shard, so rank 0 of the group runs the
server — admission, batcher, session cache, metrics, futures — and every
other rank runs ``follow_sharded``.  Rank 0 broadcasts each session build
(``register``: the topology and how to build its session) and each batch
(``solve``: topology key, weights, cfg, rounding, presolve, delta key) on
the group; a follower builds the same sessions and makes the same
``MinCutSession.solve`` calls in the same order, so the ranks meet in the
same collectives, and leaves its loop when ``stop()`` broadcasts
``stop``.  A batch's broadcast and its solves run under one lock, so the
collectives of two batches never interleave.  After each message every
rank says whether it can act on it (one all-reduced flag): a session that
a follower failed to build, or no longer holds, fails that request's
batch on rank 0 before any collective of the solver, and the next request
builds it again on every rank.  Within a batch, each request fails alone
(its error lands on its own future), since every rank goes on with the
batch's next request.
"""
from __future__ import annotations

import dataclasses
import logging
import threading
import time
from collections import OrderedDict
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from ..core.irls import IRLSConfig
from ..core.session import (MinCutSession, Problem, SolveResult, Weights,
                            check_weights_for, topology_fingerprint)
from ..graphs.structures import STInstance
from ..obs import trace
from ..obs.metrics import get_registry
from ..obs.telemetry import TelemetryAggregator

from .batcher import MicroBatch, MicroBatcher
from .cache import AdmissionController, ServerOverloaded, SessionCache
from .metrics import ServeMetrics

_DEFAULT = object()      # "use the server default" sentinel (None = skip)
_log = logging.getLogger(__name__)

FLUSH_POLICIES = ("idle", "deadline")


def default_workers(backend: str) -> int:
    """Worker-pool width when the caller doesn't pick one.

    host/scanned — a small pool of host threads: while one worker waits on
    the device (PyTorch releases the GIL there) the others assemble and
    dispatch further batches.  sharded — one worker.  The JAX package runs
    one per device, since XLA orders the programs of its one controller;
    here the ranks of the group must meet in the collectives of one batch
    at a time, so sharded batches run one at a time under the server's
    lock whatever the pool, and a second worker would only wait on it.
    """
    if backend == "sharded":
        return 1
    return 4


def _object_device(group) -> torch.device:
    """Where ``broadcast_object_list`` stages its bytes on ``group``: the
    host where the group has gloo, this rank's card for NCCL alone."""
    if "gloo" in str(dist.get_backend(group)):
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


def _broadcast(msg, group):
    """``msg`` from rank 0 of ``group`` to every rank (None on the others:
    they receive it)."""
    box = [msg]
    dist.broadcast_object_list(box, src=dist.get_global_rank(
        group or dist.group.WORLD, 0), group=group,
        device=_object_device(group))
    return box[0]


def _all_ok(ok: bool, group) -> bool:
    """Whether every rank of ``group`` is ``ok``: a MIN all-reduce of one
    flag, after each message, so that rank 0 never enters the collectives
    of a session that a follower lacks."""
    flag = torch.tensor([int(ok)], dtype=torch.int32,
                        device=_object_device(group))
    dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=group)
    return bool(flag.item())


def follow_sharded(group=None, device="cuda") -> Dict[str, int]:
    """The loop of every rank but rank 0 of a sharded ``MinCutServer``.

    Receives rank 0's broadcasts on ``group`` (None: the default group)
    until ``stop``: on ``register`` it builds the session rank 0 built
    (same topology, partition seed, cfg and schedule, this rank's
    ``device``), on ``solve`` it makes the batch's ``MinCutSession.solve``
    calls in rank 0's order — without rounding, whose answer only rank 0
    returns.  After each message it tells the group whether it can act on
    it (``_all_ok``): a message that it cannot receive, a session that it
    cannot build or does not hold, is skipped on every rank (rank 0 fails
    that batch, and repeats a stop).  A solve that raises here raised on
    rank 0 too, or after the collectives only; the loop goes on with the
    next one.  Returns counts of what it did: registrations, batches,
    solves, failed solves, and messages skipped."""
    if not dist.is_initialized():
        raise RuntimeError("follow_sharded needs an initialized "
                           "torch.distributed group (rank 0 serves)")
    if dist.get_rank(group) == 0:
        raise ValueError("rank 0 of the group runs MinCutServer; the other "
                         "ranks follow")
    device = torch.device(device)
    sessions: "OrderedDict[str, MinCutSession]" = OrderedDict()
    counts = {"registrations": 0, "batches": 0, "solves": 0, "failed": 0,
              "skipped": 0}
    while True:
        try:
            msg = _broadcast(None, group)
        except Exception:
            _log.exception("follow_sharded: a message was not received")
            msg = {"op": None}
        op = msg["op"]
        if op == "stop":
            _all_ok(True, group)
            return counts
        sess = None
        if op == "register":
            try:
                prob = Problem.build(msg["instance"], n_blocks=msg["n_blocks"],
                                     labels=msg["labels"], seed=msg["seed"])
                sess = MinCutSession(
                    prob, msg["cfg"], backend="sharded", device=device,
                    schedule=msg["schedule"], precond_bs=msg["precond_bs"],
                    group=group)
            except Exception:
                _log.exception("follow_sharded: a session build raised")
        elif op == "solve":
            sess = sessions.get(msg["key"])
        if not _all_ok(sess is not None, group):
            # rank 0 keeps no session of the key either
            if op is not None:
                sessions.pop(msg["key"], None)
            counts["skipped"] += 1
            continue
        sessions[msg["key"]] = sess
        sessions.move_to_end(msg["key"])
        if op == "register":
            while len(sessions) > msg["capacity"]:
                sessions.popitem(last=False)
            counts["registrations"] += 1
            continue
        counts["batches"] += 1
        for w in msg["weights"]:
            counts["solves"] += 1
            try:
                sess.solve(weights=w, rounding=None, cfg=msg["cfg"],
                           presolve=msg["presolve"],
                           delta_key=msg["delta_key"])
            except Exception:         # the request's own failure, as on rank 0
                counts["failed"] += 1
                _log.exception("follow_sharded: a solve of batch %d raised",
                               counts["batches"])


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
                   "host" and "sharded" solve the batch's requests one
                   ``solve()`` at a time through the same cached sessions
                   ("sharded": over the ranks of ``group``, this server on
                   rank 0 and ``follow_sharded`` on the others).  All honor
                   the adaptive early-exit default below.
    n_workers    — dispatch worker threads pulling ready batches from the
                   shared admission queue (default: 4, one for "sharded" —
                   see ``default_workers``)
    flush_policy — "idle" (default): a partial batch flushes as soon as
                   any worker is idle; "deadline": strict size-or-deadline
                   triggers (the legacy single-worker behavior)
    device       — where every session of the server solves ("cuda", or
                   "cpu" for the kernels' plain versions)
    group        — the sharded backend's process group (None: the default
                   group, or a world of one)
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
                 flush_policy: str = "idle", device="cuda", group=None):
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
        if backend == "sharded" and dist.is_initialized() and \
                dist.get_rank(group) != 0:
            raise ValueError(f"rank {dist.get_rank(group)} of the group "
                             f"follows the server on rank 0: call "
                             f"follow_sharded() there")
        self.cfg = cfg
        self.rounding = rounding
        self.seed = seed
        self.backend = backend
        self.presolve = presolve
        self.n_workers = int(n_workers)
        self.flush_policy = flush_policy
        self.device = torch.device(device)
        self.group = group
        # sharded: one batch's broadcast and solves at a time (the ranks
        # meet in its collectives in order); followers told to stop
        self._sharded_lock = threading.Lock()
        self._followers_stopped = False
        # warm-start store: (tenant, topology fingerprint) -> last converged
        # voltages for that tenant on that topology.  Tenants replay "same
        # topology, drifting weights" traffic, so the previous optimum is an
        # excellent v0; entries only exist for submits that name a tenant.
        self._warm: "OrderedDict[tuple, np.ndarray]" = OrderedDict()
        self._warm_capacity = warm_capacity
        self._warm_hits = 0
        self._warm_misses = 0
        # sharded sessions run a fixed cold schedule, so tenant warm-start
        # state is not kept there; the exclusions are counted so that the
        # gap shows in stats()["warm"] instead of reading as misses
        self._warm_sharded_skips = 0
        self._warm_lock = threading.Lock()
        # registered partitions, by topology key (guarded by _warm_lock)
        self._labels: Dict[str, np.ndarray] = {}
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
    def register(self, instance: STInstance,
                 labels: Optional[np.ndarray] = None) -> str:
        """Register a topology; returns its content-hash key.  ``labels``
        — the topology's block-Jacobi partition when the caller has one
        (``Problem.build(labels=...)``): the server's sessions take it
        instead of partitioning (minutes for a full-width volume)."""
        key = self.cache.register(instance)
        if labels is not None:
            with self._warm_lock:
                self._labels[key] = np.asarray(labels, dtype=np.int64)
        return key

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
                           "misses": self._warm_misses,
                           "sharded_excluded": self._warm_sharded_skips}
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
        """Drain pending requests, then stop the workers (and, sharded,
        the followers, once the workers are done).  Idempotent."""
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        if wait:
            for w in self._workers:
                if w.is_alive():
                    w.join()
            if self.backend == "sharded":
                self._stop_followers()
        self._stopped = True

    def _stop_followers(self) -> None:
        with self._sharded_lock:
            if self._followers_stopped or not dist.is_initialized():
                return
            # a follower that missed the stop says so, and gets it again
            for _ in range(3):
                _broadcast({"op": "stop"}, self.group)
                if _all_ok(True, self.group):
                    break
            else:
                _log.error("a follower rank missed three stops")
            self._followers_stopped = True

    def __enter__(self) -> "MinCutServer":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- workers ---------------------------------------------------------------
    def _build_session(self, instance: STInstance,
                       device: torch.device) -> MinCutSession:
        n_blocks = (self.cfg.n_blocks if self.cfg.precond == "block_jacobi"
                    else 1)
        key = topology_fingerprint(instance)
        with self._warm_lock:
            labels = self._labels.get(key)
        prob = Problem.build(instance, n_blocks=n_blocks, labels=labels,
                             seed=self.seed)
        sess = MinCutSession(prob, self.cfg, backend=self.backend,
                             device=device, group=self.group)
        if self.backend == "sharded" and dist.is_initialized():
            # the followers build the same session (this runs under the
            # sharded lock: the cache builds inside _solve_sharded)
            _broadcast({"op": "register", "key": key,
                        "instance": instance, "n_blocks": n_blocks,
                        "labels": labels, "seed": self.seed, "cfg": self.cfg,
                        "schedule": sess.schedule,
                        "precond_bs": sess.precond_bs,
                        "capacity": self.cache.capacity}, self.group)
            if not _all_ok(True, self.group):
                raise RuntimeError(
                    f"a follower rank could not build the session of "
                    f"topology {key[:8]} (see its log); the next request "
                    f"builds it again")
        return sess

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
        if self.backend == "sharded":
            with self._warm_lock:
                self._warm_sharded_skips += 1
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
        if tenant is None or self.backend == "sharded":
            return
        with self._warm_lock:
            self._warm[(tenant, topo_key)] = np.asarray(res.voltages)
            self._warm.move_to_end((tenant, topo_key))
            while len(self._warm) > self._warm_capacity:
                self._warm.popitem(last=False)

    def _solve(self, batch: MicroBatch, wid: int):
        """One host or scanned batch: ``(t_dispatch, v0, results)``."""
        reqs: List[_Request] = batch.requests
        topo_key, cfg, rounding, tenant, presolve = batch.key
        # assembly: everything between batch pickup and solver dispatch —
        # session cache lookup (possibly a compile) and warm-start staging
        with trace.span("serve.assembly", topo=topo_key[:8], worker=wid):
            sess = self.cache.get(topo_key)
            v0 = self._warm_lookup(tenant, topo_key)
        t_dispatch = time.perf_counter()
        # tenant doubles as the weight-sequence identity for the session's
        # delta-staging cache: a tenant replaying "same topology, drifting
        # weights" restages only the changed ELL slots (and patches presolve
        # kernels) between solves
        dks = None if tenant is None else [tenant] * len(reqs)
        if self.backend == "scanned" and not presolve:
            results = sess.solve_batch(
                [r.weights for r in reqs], rounding=rounding, cfg=cfg,
                pad_to=batch.bucket,
                warm_from=None if v0 is None else [v0] * len(reqs),
                delta_keys=dks)
        elif self.backend == "scanned":
            # presolve batches group by kernel topology inside the session
            # and run cold (the kernel basis shifts with the weights, so
            # prior voltages do not transfer)
            results = sess.solve_batch([r.weights for r in reqs],
                                       rounding=rounding, cfg=cfg,
                                       presolve=True, delta_keys=dks)
        else:
            # host: no batched program — the batch still amortizes the
            # cached session, one solve per request
            results = [sess.solve(weights=r.weights, rounding=rounding,
                                  cfg=cfg, presolve=presolve, warm_from=v0,
                                  delta_key=tenant)
                       for r in reqs]
        return t_dispatch, v0, results

    def _solve_sharded(self, batch: MicroBatch, wid: int):
        """One sharded batch: ``(t_dispatch, results)``, a result or the
        request's own exception per request.  The session lookup (whose
        build broadcasts a registration), the batch's broadcast and its
        solves hold the sharded lock, so every rank sees one order of
        collectives.  No warm state (a fixed cold schedule); the tenant
        still names the solver's delta refill."""
        reqs: List[_Request] = batch.requests
        topo_key, cfg, rounding, tenant, presolve = batch.key
        with self._sharded_lock:
            with trace.span("serve.assembly", topo=topo_key[:8], worker=wid):
                sess = self.cache.get(topo_key)
                self._warm_lookup(tenant, topo_key)
            t_dispatch = time.perf_counter()
            ws = [r.weights for r in reqs]
            if dist.is_initialized():
                _broadcast({"op": "solve", "key": topo_key, "weights": ws,
                            "cfg": cfg, "presolve": presolve,
                            "delta_key": tenant}, self.group)
                if not _all_ok(True, self.group):
                    self.cache.drop(topo_key)
                    raise RuntimeError(
                        f"a follower rank holds no session of topology "
                        f"{topo_key[:8]}; the next request builds it again")
            results = []
            for w in ws:
                try:
                    results.append(sess.solve(weights=w, rounding=rounding,
                                              cfg=cfg, presolve=presolve,
                                              delta_key=tenant))
                except Exception as e:      # this request's own failure
                    results.append(e)
        return t_dispatch, results

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
                if self.backend == "sharded":
                    v0 = None
                    t_dispatch, results = self._solve_sharded(batch, wid)
                else:
                    t_dispatch, v0, results = self._solve(batch, wid)
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
            if isinstance(res, Exception):
                self.metrics.record_request({}, now, failed=True)
                r.future.set_exception(res)
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
                if tenant is not None and self.backend != "sharded":
                    tel["warm_start"] = warm_hit
                self.telemetry.add(tel)
                self.metrics.record_solve_cost(tel.get("flops"),
                                               tel.get("achieved_gflops"))
            res = res._replace(timings=timings, telemetry=tel)
            self.metrics.record_request(timings, now)
            r.future.set_result(res)
        get_registry().gauge("serve_in_flight").set(self.admission.in_flight)
