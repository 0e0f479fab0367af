"""Subprocess jobs for the port's multi-rank tests: a job is one Python
program run as ``ranks`` gloo ranks (rendezvous through a FileStore under a
temporary directory, one intra-op thread each) or as one process on
``devices`` emulated XLA devices (the JAX reference).  A job's rank 0 (or
its only process) writes an ``.npz`` of results; ``result()`` waits for it
and fails with the processes' output tails if any exited non-zero or
outlived the timeout."""
import os
import subprocess
import sys
import textwrap
import time

import numpy as np

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
ENV = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
           JAX_PLATFORMS="cpu", PYTHONWARNINGS="ignore")

# the preamble of a rank: the group, then OUT and RANK for the program
RANK_PREAMBLE = """
import datetime, os, warnings
import numpy as np
import torch
import torch.distributed as dist
warnings.simplefilter("ignore")
torch.set_num_threads(1)
RANK, P = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
dist.init_process_group("gloo", store=dist.FileStore(os.environ["STORE"], P),
                        rank=RANK, world_size=P,
                        timeout=datetime.timedelta(seconds=120))
OUT = os.environ["OUT"]
"""

REF_PREAMBLE = """
import os, warnings
import numpy as np
warnings.simplefilter("ignore")
RANK = 0
OUT = os.environ["OUT"]
"""


class Job:
    def __init__(self, name, workdir, code, ranks=None, devices=None,
                 timeout=400):
        self.name, self.timeout = name, timeout
        self.out = os.path.join(workdir, name + ".npz")
        env = dict(ENV, OUT=self.out)
        if devices is not None:
            env["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count="
                                f"{devices}")
        pre = RANK_PREAMBLE if ranks else REF_PREAMBLE
        argv = [sys.executable, "-c", textwrap.dedent(pre)
                + textwrap.dedent(code)]
        envs = [env]
        if ranks:
            store = os.path.join(workdir, name + ".store")
            envs = [dict(env, RANK=str(r), WORLD_SIZE=str(ranks),
                         STORE=store) for r in range(ranks)]
        self.logs, self.procs = [], []
        self.t0 = time.time()
        for i, e in enumerate(envs):
            log = os.path.join(workdir, f"{name}.{i}.log")
            self.logs.append(log)
            with open(log, "w") as f:
                self.procs.append(subprocess.Popen(
                    argv, env=e, stdout=f, stderr=subprocess.STDOUT))
        self._result = None

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    def result(self) -> dict:
        if self._result is None:
            while any(p.poll() is None for p in self.procs):
                if time.time() - self.t0 > self.timeout:
                    self.kill()
                    break
                time.sleep(0.05)
            rcs = [p.returncode for p in self.procs]
            if any(rc != 0 for rc in rcs):
                tails = []
                for log in self.logs:
                    with open(log) as f:
                        tails.append(f.read()[-3000:])
                raise AssertionError((self.name, rcs, tails))
            with np.load(self.out, allow_pickle=False) as data:
                self._result = {k: data[k] for k in data.files}
        return self._result


# numpy parameters of the LM family from a seed, the same in both packages:
# every leaf of ``param_shapes(cfg)`` in sorted key order, N(0, 1/fan_in)
# in float32 (the norm gains too, so that their gradients are exercised)
PARAMS = """
def make_params(shapes, seed):
    rng = np.random.default_rng(seed)

    def walk(tree):
        out = {}
        for k in sorted(tree):
            v = tree[k]
            if isinstance(v, dict):
                out[k] = walk(v)
                continue
            shape = v[0]
            fan = shape[-2] if len(shape) >= 2 else shape[-1]
            out[k] = (rng.standard_normal(shape) / np.sqrt(fan)).astype(
                np.float32)
        return out
    return walk(shapes)


def flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out
"""
