"""Min-cut serving engine traffic driver — synthetic multi-tenant replay.

The port of ``repro/launch/mincut_serve.py`` (same flags and printout, plus
``--device``), serving on the card:

  PYTHONPATH=src python -m repro_torch.launch.mincut_serve
  PYTHONPATH=src python -m repro_torch.launch.mincut_serve \\
      --topos 3 --requests 48 --rate 200 --max-batch 8 --max-wait-ms 5 \\
      --workers 4 --flush-policy idle [--device cpu]

Builds ``--topos`` distinct small topologies (alternating grid / road
families — mixed tenants), then replays Poisson-arrival traffic against a
``MinCutServer``: each request picks a tenant and the NEXT weight vector of
that tenant's sequence (a multiplicative random walk over its base weights
— the FlowImprove/segmentation "same topology, drifting weights" serving
pattern that warm topology caches exist for).  Prints the metrics dump,
cache/eviction stats and ``completed=N/M``; exits nonzero when nothing
completed (the CI smoke gate).
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def build_topologies(n_topos: int, side: int, seed: int):
    """Alternate grid- and road-family instances (distinct topologies)."""
    from ..graphs import generators as gen

    instances = []
    for i in range(n_topos):
        if i % 2 == 0:
            g = gen.grid_2d(side, side, seed=seed + 7 * i)
            instances.append(
                gen.segmentation_instance(g, (side, side), seed=seed + 7 * i + 1))
        else:
            g = gen.road_like(side + 2, seed=seed + 7 * i)
            instances.append(gen.flow_improve_instance(g, seed=seed + 7 * i + 1))
    return instances


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--topos", type=int, default=3,
                    help="distinct topologies (tenants)")
    ap.add_argument("--side", type=int, default=12)
    ap.add_argument("--requests", type=int, default=48)
    ap.add_argument("--rate", type=float, default=200.0,
                    help="Poisson arrival rate, requests/sec")
    ap.add_argument("--drift", type=float, default=0.05,
                    help="per-step lognormal weight drift of each tenant")
    ap.add_argument("--drift-sparsity", type=float, default=1.0,
                    help="fraction of a tenant's edges drifted per request "
                         "(1.0 = a global scale walk over all edges; < 1 "
                         "drifts a random sparse subset per step — pair "
                         "with --warm so the server's delta-staging path "
                         "restages only the changed ELL slots)")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-wait-ms", type=float, default=5.0)
    ap.add_argument("--workers", type=int, default=None,
                    help="dispatch worker threads (default 4)")
    ap.add_argument("--flush-policy", choices=("idle", "deadline"),
                    default="idle",
                    help="idle: flush a partial batch whenever a worker is "
                         "idle; deadline: wait out max-wait-ms (legacy "
                         "single-worker behavior)")
    ap.add_argument("--capacity", type=int, default=8,
                    help="session cache capacity (topologies)")
    ap.add_argument("--max-queue", type=int, default=256)
    ap.add_argument("--irls", type=int, default=12)
    ap.add_argument("--pcg-iters", type=int, default=40)
    ap.add_argument("--irls-tol", type=float, default=1e-3,
                    help="adaptive early-exit threshold (rel. fractional-cut "
                         "change); the serving default")
    ap.add_argument("--fixed-schedule", action="store_true",
                    help="run the rigid n_irls × pcg_iters schedule instead "
                         "of the adaptive early-exit one")
    ap.add_argument("--warm", action="store_true",
                    help="submit with per-tenant identities so the server "
                         "warm-starts each request from that tenant's "
                         "previous solution on the topology")
    ap.add_argument("--presolve", action="store_true",
                    help="kernelize every request before solving (exact "
                         "reductions; lifted results)")
    ap.add_argument("--warmup", type=int, default=0, metavar="K",
                    help="per tenant, pre-submit batches of 1..K (pow2) "
                         "requests and wait before the timed replay, so "
                         "session builds and bucket compiles land outside "
                         "the measurement window")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="per-future wait cap, seconds")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--trace", default=None, metavar="OUT.JSONL",
                    help="enable span tracing and stream spans to this JSONL "
                         "sink")
    ap.add_argument("--device", default="cuda",
                    help="where the server solves: cuda (the kernels' "
                         "card) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    if args.trace:
        from ..obs import trace as _trace
        _trace.configure(enabled=True, jsonl=args.trace)

    import numpy as np

    from ..core import IRLSConfig, Weights
    from ..serve import MinCutServer, ServerOverloaded

    rng = np.random.default_rng(args.seed)
    instances = build_topologies(args.topos, args.side, args.seed)
    cfg = IRLSConfig(n_irls=args.irls, pcg_max_iters=args.pcg_iters,
                     precond="jacobi", n_blocks=1,
                     irls_tol=0.0 if args.fixed_schedule else args.irls_tol,
                     adaptive_tol=not args.fixed_schedule)
    server = MinCutServer(cfg=cfg, capacity=args.capacity,
                          max_batch=args.max_batch,
                          max_wait_ms=args.max_wait_ms,
                          max_queue=args.max_queue, seed=args.seed,
                          presolve=args.presolve, n_workers=args.workers,
                          flush_policy=args.flush_policy, device=args.device)
    keys = [server.register(inst) for inst in instances]
    for inst, key in zip(instances, keys):
        print(f"tenant {key[:8]}: n={inst.n:,} m={inst.graph.m:,}")

    if args.warmup > 0:
        for inst, key in zip(instances, keys):
            k = 1
            while k <= min(args.warmup, args.max_batch):
                ws = [Weights(np.asarray(inst.graph.weight) * (1.0 + 0.01 * i),
                              np.asarray(inst.s_weight),
                              np.asarray(inst.t_weight)) for i in range(k)]
                for f in [server.submit(key, w) for w in ws]:
                    f.result(timeout=args.timeout)
                k <<= 1
        server.reset_measurement()          # measure steady state only

    # per-tenant weight sequences: a multiplicative random-walk scale over
    # all edges (--drift-sparsity 1.0, the default), or a sparse per-edge
    # walk touching only that fraction of edges per request
    scales = np.ones(args.topos)
    sparse = 0.0 < args.drift_sparsity < 1.0
    cur = [np.asarray(inst.graph.weight, dtype=np.float64).copy()
           for inst in instances] if sparse else None
    futures = []
    t0 = time.perf_counter()
    for _ in range(args.requests):
        tenant = int(rng.integers(args.topos))
        inst = instances[tenant]
        if sparse:
            c = cur[tenant]
            k = max(1, int(round(args.drift_sparsity * c.size)))
            idx = rng.choice(c.size, size=k, replace=False)
            c[idx] *= np.exp(rng.normal(0.0, args.drift, size=k))
            w = Weights(c.copy(), np.asarray(inst.s_weight),
                        np.asarray(inst.t_weight))
        else:
            scales[tenant] *= float(np.exp(rng.normal(0.0, args.drift)))
            w = Weights(np.asarray(inst.graph.weight) * scales[tenant],
                        np.asarray(inst.s_weight),
                        np.asarray(inst.t_weight))
        try:
            futures.append(server.submit(
                keys[tenant], w,
                tenant=f"tenant-{tenant}" if args.warm else None))
        except ServerOverloaded:
            pass                       # counted in metrics as rejected
        time.sleep(float(rng.exponential(1.0 / args.rate)))

    completed, failed = 0, 0
    for f in futures:
        try:
            f.result(timeout=args.timeout)
            completed += 1
        except Exception as e:
            failed += 1
            print(f"request failed: {e!r}", file=sys.stderr)
    t_wall = time.perf_counter() - t0
    server.stop()

    print(server.metrics.dump())
    stats = server.stats()
    tel = stats.get("telemetry", {})
    wk = stats.get("workers", {})
    print(f"  cache    : {stats['cache']}")
    print(f"  warm     : {stats['warm']}")
    print(f"  workers  : {wk.get('n_workers')} "
          f"({wk.get('flush_policy')} flush), "
          f"utilization={wk.get('utilization', 0.0):.2f}, "
          f"by_worker={tel.get('by_worker')}")
    if tel.get("solves"):
        print(f"  telemetry: {tel['solves']} solves, "
              f"{tel['mean_pcg_iters_per_solve']:.1f} mean PCG iters/solve, "
              f"{tel['mean_irls_iters_per_solve']:.1f} mean IRLS iters, "
              f"early_exit_rate={tel['early_exit_rate']:.2f} "
              f"warm_start_rate={tel['warm_start_rate']:.2f}")
    print(f"  wall     : {t_wall:.2f}s "
          f"({completed / max(t_wall, 1e-9):.1f} solves/sec incl. compile)")
    print(f"completed={completed}/{args.requests} "
          f"(failed={failed}, rejected={stats['rejected']})")
    if args.trace:
        from ..obs import trace as _trace
        _trace.fence()
        print(f"  trace    : {len(_trace.spans())} spans ring-buffered, "
              f"sink {args.trace}")

    if args.json_out:
        stats["wall_s"] = t_wall
        with open(args.json_out, "w") as fh:
            json.dump(stats, fh, indent=1)
    return 0 if completed > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
