"""``solve_loop``: one ``MinCutSession`` on the configuration's topology is
built in set-up; the window solves fresh weight assignments of it one after
another, cold, until ``seconds`` have passed (the last solve runs to its
end).  The assignments are the base instance's weights times lognormal
noise (``edge_sigma``, ``terminal_sigma``), drawn on the card from the seed
in set-up, a pool of ``pool`` used in turn.  ``Problem.build`` and the
plans the session uploads are timed on their own (``problem_build_s``).

Traffic parameters: ``pool``, ``edge_sigma``, ``terminal_sigma``,
``warmup`` (``IRLSConfig`` fields of the warm-up solve), ``check_sample``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List

import numpy as np

from cutbench import drive


class Mode:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        import torch

        from repro_torch.core import MinCutSession, Problem, Weights

        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        cfg = drive.solver_config(config)
        g = drive.make_graph(config, seed)
        inst = drive.make_instance(config, g, seed + 1)
        self.src, self.dst = np.asarray(g.src), np.asarray(g.dst)
        self.labels = drive.partition_labels(config)
        t = time.perf_counter()
        if self.labels is not None:
            prob = Problem.build(inst, n_blocks=int(self.labels.max()) + 1,
                                 labels=self.labels)
        else:
            prob = Problem.build(inst, n_blocks=1)
        prob.device_graph(getattr(torch, cfg.dtype), device=self.device)
        self.shape = {"n": int(inst.n), "m": int(g.m)}
        if cfg.layout == "ell":
            self.shape["k"] = int(prob.ell_plan(self.device).k)
        if cfg.precond == "block_jacobi" and self.labels is not None:
            prob.block_plan(self.device)
        drive.sync(self.device)
        self.problem_build_s = time.perf_counter() - t
        self.session = MinCutSession(prob, cfg, backend=config["driver"],
                                     device=self.device)
        # the pool of weight assignments, drawn on the card from the seed
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        base = [torch.as_tensor(np.asarray(a, dtype=np.float64),
                                device=self.device)
                for a in (g.weight, inst.s_weight, inst.t_weight)]
        sig = (traffic["edge_sigma"], traffic["terminal_sigma"],
               traffic["terminal_sigma"])
        self.pool = []
        for _ in range(int(traffic["pool"])):
            w = [(b * torch.exp(s * torch.randn(b.shape, generator=gen,
                                                 device=self.device,
                                                 dtype=torch.float64))
                  ).cpu().numpy() for b, s in zip(base, sig)]
            self.pool.append(Weights(*w))
        del base
        # warm-up: one solve (under the mix's ``warmup`` fields), which
        # loads the kernels and the solver libraries and grows the
        # allocator's pool to the window's size
        warm = dataclasses.replace(cfg, **traffic.get("warmup", {}))
        self.session.solve(weights=self.pool[0], rounding=config["rounding"],
                           cfg=warm)
        drive.sync(self.device)

    def window(self, seconds: float) -> dict:
        self.answers: List[dict] = []
        drive.peak_reset(self.device)
        t0 = time.perf_counter()
        while True:
            w = self.pool[len(self.answers) % len(self.pool)]
            res = self.session.solve(weights=w,
                                     rounding=self.config["rounding"])
            self.answers.append({
                "voltages": res.voltages, "in_source": res.cut.in_source,
                "cut_value": res.cut.cut_value,
                "pcg_iters": list(res.diagnostics.pcg_iters)})
            if time.perf_counter() - t0 >= seconds:
                break
        drive.sync(self.device)
        wall = time.perf_counter() - t0
        return {"attempted": len(self.answers), "failed": 0,
                "completed": len(self.answers), "wall_s": wall,
                "peak_bytes": drive.peak(self.device),
                "pcg_iters": [a["pcg_iters"] for a in self.answers],
                "shape": self.shape, "problem_build_s": self.problem_build_s}

    def sample(self) -> List[dict]:
        """The answers the judge compares: ``check_sample`` of them, drawn
        from the seed (the first solve among them)."""
        k = min(int(self.traffic["check_sample"]), len(self.answers))
        rng = np.random.default_rng([self.seed, 1])
        pick = [0] + sorted(rng.choice(np.arange(1, len(self.answers)),
                                       size=k - 1, replace=False).tolist()
                            if k > 1 else [])
        return [dict(self.answers[i], weights=tuple(
            self.pool[i % len(self.pool)])) for i in pick]

    def checks(self) -> dict:
        return {}

    def close(self):
        self.session = None
        self.answers = []
