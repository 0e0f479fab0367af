"""``serve_bursts``: a ``MinCutServer`` with the configuration's solver and
server settings; ``tenants`` tenants, each its own terminal instance of the
topology, send bursts of ``burst`` requests through ``submit_many`` in a
closed loop: each waits for its whole burst, then sends the next, until a
burst completes after ``seconds``.  Each tenant's weights walk on from its
last request, one lognormal step of ``drift`` a request: over every edge at
once (one global scale) where ``drift_share`` is 1, else over that share of
the edges, drawn anew for each request.  A tenant's walk is drawn from the
seed and the tenant alone, so the same seed gives the same requests however
the bursts interleave.  Later bursts warm-start from the server's warm
store, as the server does.

Traffic parameters: ``tenants``, ``burst``, ``drift``, ``drift_share``
(default 1), ``check_sample``.

What the judge sees: every burst the window completed keeps two answers,
its last lane's (the one the server's warm store keeps for the tenant's
next burst) and one lane drawn from the seed; ``check_sample`` of them are
drawn from the seed, a tenant's first burst (cold) and a tenant's last
among them.  The
reference starts a warm answer from the voltages of the previous burst's
last lane, the program's answer that the server's rule ("the last
converged") hands on; ``checks`` holds the server to that rule: one batch a
burst, one warm-store hit for each later burst and one miss for each
tenant's first, and every request's own ``warm_start`` flag.
"""
from __future__ import annotations

import queue
import time
from typing import Dict, List

import numpy as np

from cutbench import drive


class Mode:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        import torch

        from repro_torch.core import Weights
        from repro_torch.serve import MinCutServer

        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.Weights = Weights
        self.burst = int(traffic["burst"])
        self.drift = float(traffic["drift"])
        self.share = float(traffic.get("drift_share", 1.0))
        cfg = drive.solver_config(config)
        g = drive.make_graph(config, seed)
        self.src, self.dst = np.asarray(g.src), np.asarray(g.dst)
        self.labels = drive.partition_labels(config)
        n_t = int(traffic["tenants"])
        self.tenants = [drive.make_instance(config, g, seed + 1 + i)
                        for i in range(n_t)]
        self.base_c = np.asarray(g.weight, dtype=np.float64)
        self.shape = {"n": int(g.n), "m": int(g.m)}
        self.server = MinCutServer(cfg=cfg, rounding=config["rounding"],
                                   device=self.device, seed=0,
                                   **config["server"])
        self.keys = [self.server.register(inst, labels=self.labels)
                     for inst in self.tenants]
        # warm-up: one burst of a tenant of its own, cold, which builds the
        # session (Problem.build, the plans) and loads the kernels
        ws = [self._weights(0, self.base_c * (1.0 + 0.01 * i))
              for i in range(self.burst)]
        for f in self.server.submit_many(self.keys[0], ws, tenant="warmup"):
            f.result()
        drive.sync(self.device)
        self.server.reset_measurement()

    # -- the weight walk -----------------------------------------------------
    def _weights(self, t: int, c: np.ndarray):
        inst = self.tenants[t]
        return self.Weights(c, np.asarray(inst.s_weight),
                            np.asarray(inst.t_weight))

    def _step(self, t: int):
        """Tenant ``t``'s next step: a factor on every edge (a float) or
        factors on a share of them ((edge ids, factors))."""
        rng = self._rngs[t]
        if self.share >= 1.0:
            return float(np.exp(rng.normal(0.0, self.drift)))
        k = max(1, int(round(self.share * self.shape["m"])))
        return (rng.integers(0, self.shape["m"], k),
                np.exp(rng.normal(0.0, self.drift, k)))

    @staticmethod
    def _apply(c, step, scale):
        if isinstance(step, float):
            return c, scale * step
        c = c.copy()
        c[step[0]] *= step[1]
        return c, scale

    def _next(self, t: int):
        step = self._step(t)
        self._steps[t].append(step)
        self._cur[t], self._scale[t] = self._apply(self._cur[t], step,
                                                   self._scale[t])
        return self._weights(t, self._cur[t] * self._scale[t]
                             if self.share >= 1.0 else self._cur[t])

    def weights_of(self, t: int, r: int):
        """The weights of tenant ``t``'s request ``r``, walked again."""
        c, scale = self.base_c, 1.0
        for step in self._steps[t][:r + 1]:
            c, scale = self._apply(c, step, scale)
        return self._weights(t, c * scale if self.share >= 1.0 else c)

    def _pick_lane(self, t: int, j: int) -> int:
        return int(np.random.default_rng([self.seed, 3, t, j])
                   .integers(self.burst))

    # -- the window ----------------------------------------------------------
    def window(self, seconds: float) -> dict:
        n_t, burst = len(self.tenants), self.burst
        self._rngs = [np.random.default_rng([self.seed, 2, t])
                      for t in range(n_t)]
        self._steps = [[] for _ in range(n_t)]
        self._cur = [self.base_c] * n_t
        self._scale = [1.0] * n_t
        sent = [0] * n_t
        done_q: "queue.Queue" = queue.Queue()
        self.bursts: Dict[tuple, dict] = {}
        latencies: List[float] = []
        stats = {"attempted": 0, "failed": 0, "completed": 0}
        self._warm0 = dict(self.server.stats()["warm"])
        drive.peak_reset(self.device)
        t0 = time.perf_counter()

        def send(t: int, j: int):
            ws = [self._next(t) for _ in range(burst)]
            t_sub = time.perf_counter()
            futs = self.server.submit_many(self.keys[t], ws,
                                           tenant=f"tenant-{t}")
            self.bursts[(t, j)] = {"r0": sent[t], "futures": futs,
                                   "t_submit": t_sub, "left": burst}
            sent[t] += burst
            stats["attempted"] += burst
            for f in futs:
                f.add_done_callback(
                    lambda f, t=t, j=j: done_q.put((t, j, time.perf_counter())))

        for t in range(n_t):
            send(t, 0)
        open_bursts = n_t
        t_last = t0
        while open_bursts:
            t, j, t_done = done_q.get()
            b = self.bursts[(t, j)]
            b["left"] -= 1
            latencies.append(t_done - b["t_submit"])
            t_last = max(t_last, t_done)
            if b["left"]:
                continue
            open_bursts -= 1
            results = []
            for f in b["futures"]:
                try:
                    results.append(f.result())
                    stats["completed"] += 1
                except Exception:
                    results.append(None)
                    stats["failed"] += 1
            del b["futures"]
            b["timings"] = [r.timings for r in results if r is not None]
            b["warm_flags"] = [None if r is None or r.telemetry is None
                               else r.telemetry.get("warm_start")
                               for r in results]
            b["answers"] = {}
            for lane in {self._pick_lane(t, j), burst - 1}:
                r = results[lane]
                b["answers"][lane] = (
                    drive.missing_answer(self.shape["n"]) if r is None else
                    {"voltages": r.voltages, "in_source": r.cut.in_source,
                     "cut_value": r.cut.cut_value})
            if time.perf_counter() - t0 < seconds:
                send(t, j + 1)
                open_bursts += 1
        drive.sync(self.device)
        wall = t_last - t0
        self._server_stats = self.server.stats()
        return dict(stats, wall_s=wall, peak_bytes=drive.peak(self.device),
                    latencies=latencies, server=self._server_stats,
                    timings=[tm for b in self.bursts.values()
                             for tm in b["timings"]],
                    shape=self.shape)

    def sample(self) -> List[dict]:
        """``check_sample`` of the kept answers, drawn from the seed: the
        drawn lane of one tenant's first burst (cold) and of one tenant's
        last burst (the end of its warm chain), then any of the rest."""
        rng = np.random.default_rng([self.seed, 1])
        cands = sorted((t, j, lane) for (t, j), b in self.bursts.items()
                       for lane in b["answers"])
        t_cold, t_last = (int(t) for t in rng.integers(len(self.tenants),
                                                       size=2))
        j_last = max(j for t, j in self.bursts if t == t_last)
        forced = list(dict.fromkeys([(t_cold, 0, self._pick_lane(t_cold, 0)),
                                     (t_last, j_last,
                                      self._pick_lane(t_last, j_last))]))
        rest = [c for c in cands if c not in forced]
        k = max(0, min(int(self.traffic["check_sample"]), len(cands))
                - len(forced))
        picks = forced + [rest[i] for i in sorted(
            rng.choice(len(rest), size=k, replace=False).tolist())]
        out = []
        for t, j, lane in picks:
            b = self.bursts[(t, j)]
            x0 = None
            if j > 0:
                x0 = self.bursts[(t, j - 1)]["answers"][self.burst - 1][
                    "voltages"]
            out.append(dict(b["answers"][lane], x0=x0,
                            weights=tuple(self.weights_of(t, b["r0"] + lane))))
        return out

    def checks(self) -> dict:
        """The warm chain the reference follows, counted against the
        server: batches against bursts, warm-store hits and misses against
        later and first bursts, and each request's ``warm_start`` flag
        against its burst's place; the number of departures, exactly 0."""
        warm = self._server_stats["warm"]
        later = sum(1 for _, j in self.bursts if j > 0)
        first = len(self.bursts) - later
        flags = sum(f != (j > 0) for (_, j), b in self.bursts.items()
                    for f in b["warm_flags"])
        off = (abs(self._server_stats["batches"] - len(self.bursts))
               + abs(warm["hits"] - self._warm0["hits"] - later)
               + abs(warm["misses"] - self._warm0["misses"] - first)
               + flags)
        return {"warm_chain": {"value": float(off), "limit": 0.0}}

    def close(self):
        self.server.stop()
        self.server = None
        self.bursts = {}
