"""Topology/session cache + admission control for the serving engine.

Two bounded resources sit between ``MinCutServer.submit`` and the solver:

* ``SessionCache`` — an LRU of built ``(Problem, MinCutSession)`` pairs
  keyed on the topology content hash (``core.session.topology_fingerprint``),
  all on the cache's ``device``.
  The expensive per-topology state (k-way partition, plans, compiled
  steppers) is what gets evicted; the raw registered instances are kept in a
  side registry (cheap: plain numpy arrays) so an evicted topology can be
  rebuilt on the next request — at rebuild cost, which the stats make
  visible (``hits`` / ``misses`` / ``evictions`` / ``rebuilds``).
* ``AdmissionController`` — backpressure: a hard cap on requests in flight
  (submitted, not yet completed).  ``submit`` beyond the cap raises
  ``ServerOverloaded`` instead of letting the queue grow without bound.

Both are thread-safe: ``submit`` runs on caller threads while a POOL of
engine dispatch workers executes batches concurrently.  Session builds
(partition + plan construction + compilation — seconds) run outside the
cache lock under a per-fingerprint build lock: two workers hitting the
same cold topology serialize on that one key (exactly one build; the
second waits and reuses it) while builds of DIFFERENT topologies, and all
cache hits, proceed unblocked.

The JAX package's ``repro.serve.cache`` over the port's session, with a
``device`` that the cache hands to its factory for every session it builds.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Callable, Dict, Tuple

import torch

from ..core.session import MinCutSession, topology_fingerprint
from ..graphs.structures import STInstance
from ..obs import trace


class ServerOverloaded(RuntimeError):
    """Raised by ``submit`` when admission control rejects a request."""


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0        # builds: first-ever + rebuilds after eviction
    rebuilds: int = 0      # misses on a key that was previously cached
    evictions: int = 0

    def snapshot(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


class SessionCache:
    """LRU cache of ``MinCutSession`` objects keyed on topology fingerprint.

    ``build`` is the factory the engine supplies ((instance, device) →
    session); the cache owns lifetimes, stats and the device, not policy.
    """

    def __init__(self, capacity: int,
                 build: Callable[[STInstance, torch.device], MinCutSession],
                 device="cuda"):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.device = torch.device(device)
        self._build = build
        self._instances: Dict[str, STInstance] = {}    # never evicted
        self._sessions: "OrderedDict[str, MinCutSession]" = OrderedDict()
        self._ever_cached: set = set()
        self.stats = CacheStats()
        self._lock = threading.Lock()
        # per-fingerprint build serialization (see module docstring); the
        # lock objects are tiny and topologies few, so entries are kept
        # for the cache's lifetime (an evicted key reuses its lock on
        # rebuild)
        self._build_locks: Dict[str, threading.Lock] = {}

    def register(self, instance: STInstance) -> str:
        """Fingerprint + remember an instance; returns the topology key."""
        key = topology_fingerprint(instance)
        with self._lock:
            self._instances.setdefault(key, instance)
        return key

    def update_instance(self, key: str, instance: STInstance) -> None:
        """Replace ``key``'s stored instance with a same-topology,
        new-weights one and drop any cached session, so the next ``get``
        stages the new weights.  Raises if the topology actually changed
        (different fingerprint) — that is a new key, not an update."""
        if topology_fingerprint(instance) != key:
            raise ValueError("update_instance got an instance whose topology "
                             "does not match the key; register() it instead")
        with self._lock:
            if key not in self._instances:
                raise KeyError(f"unknown topology key {key!r}; register the "
                               f"instance first")
            self._instances[key] = instance
            self._sessions.pop(key, None)

    def drop(self, key: str) -> None:
        """Forget ``key``'s session, if one is cached: the next ``get``
        builds it again."""
        with self._lock:
            self._sessions.pop(key, None)

    def known(self, key: str) -> bool:
        with self._lock:
            return key in self._instances

    def instance(self, key: str) -> STInstance:
        with self._lock:
            inst = self._instances.get(key)
        if inst is None:
            raise KeyError(f"unknown topology key {key!r}; register the "
                           f"instance (or submit it directly) first")
        return inst

    def get(self, key: str) -> MinCutSession:
        """Session for ``key``, building (and possibly evicting) on miss.

        Builds run OUTSIDE the cache lock (partition + compile can take
        seconds and must not block submitters or other workers) but UNDER
        a per-key build lock, so concurrent workers racing the same cold
        fingerprint produce exactly one build — the losers block until the
        winner publishes, then hit.
        """
        with self._lock:
            sess = self._sessions.get(key)
            if sess is not None:
                self.stats.hits += 1
                self._sessions.move_to_end(key)
                return sess
            inst = self._instances.get(key)
            if inst is None:
                raise KeyError(f"unknown topology key {key!r}; register the "
                               f"instance (or submit it directly) first")
            build_lock = self._build_locks.setdefault(key, threading.Lock())
        with build_lock:
            with self._lock:
                # double-check: a racing worker may have published while
                # this one waited on the build lock
                sess = self._sessions.get(key)
                if sess is not None:
                    self.stats.hits += 1
                    self._sessions.move_to_end(key)
                    return sess
                self.stats.misses += 1
                rebuild = key in self._ever_cached
                if rebuild:
                    self.stats.rebuilds += 1
            with trace.span("serve.session_build", topo=key[:8],
                            rebuild=rebuild):
                sess = self._build(inst, self.device)
            with self._lock:
                self._sessions[key] = sess
                self._sessions.move_to_end(key)
                self._ever_cached.add(key)
                while len(self._sessions) > self.capacity:
                    self._sessions.popitem(last=False)
                    self.stats.evictions += 1
        return sess

    def __len__(self) -> int:
        with self._lock:
            return len(self._sessions)

    def cached_keys(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(self._sessions)


class AdmissionController:
    """In-flight request cap (submitted − completed ≤ ``max_queue``)."""

    def __init__(self, max_queue: int):
        self.max_queue = int(max_queue)
        self._in_flight = 0
        self._lock = threading.Lock()

    @property
    def in_flight(self) -> int:
        with self._lock:
            return self._in_flight

    def try_admit(self) -> bool:
        with self._lock:
            if self._in_flight >= self.max_queue:
                return False
            self._in_flight += 1
            return True

    def release(self) -> None:
        with self._lock:
            self._in_flight -= 1
