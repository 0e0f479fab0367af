"""Min-cut serving engine: a continuous-batching pipeline over a session cache.

The layer between the solver core (``repro_torch.core``) and traffic, on one
device (``device="cuda"`` by default):

    MinCutServer      — async ``submit(topology, weights) -> Future``
                        front-end over a pool of ``n_workers`` dispatch
                        workers pulling ready batches from the shared
                        admission queue (engine.py); on the sharded
                        backend it serves on rank 0 of a process group
    follow_sharded    — the loop of the group's other ranks: the same
                        sessions and solves, by broadcast (engine.py)
    MicroBatcher      — groups pending requests by topology fingerprint,
                        pads to power-of-two buckets, flushes on
                        max-batch / max-wait-ms / idle-worker triggers
                        (batcher.py)
    SessionCache      — LRU of built ``Problem``/``MinCutSession`` pairs
                        keyed on topology content hash, per-fingerprint
                        build locks, eviction stats (cache.py)
    ServeMetrics      — per-request latency percentiles with a
                        queue/irls/rounding breakdown, throughput
                        counters, flush-reason counts, text dump
                        (metrics.py)
    ServerOverloaded  — admission-control rejection (backpressure)
    CutTreeService    — all-pairs min-cut queries from cut trees built
                        once per topology over the same session cache,
                        repaired under weight drift (cuttree.py)

The port of the JAX package's ``repro.serve``.
"""
from .batcher import MicroBatch, MicroBatcher, bucket_size
from .cache import AdmissionController, CacheStats, ServerOverloaded, SessionCache
from .cuttree import CutTreeService
from .engine import (FLUSH_POLICIES, MinCutServer, default_workers,
                     follow_sharded)
from .metrics import ServeMetrics, percentile
