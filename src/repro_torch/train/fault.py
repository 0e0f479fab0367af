"""Fault-tolerant training controller (a copy of ``repro/train/fault.py``,
which is numpy-only, on the port's checkpoints).

What "fault tolerance" means for a gang-scheduled SPMD job (and what this
module implements, sized for 1000+ nodes):

* **checkpoint/restart** — periodic async checkpoints + auto-resume from
  the latest one on (re)start; atomic writes survive mid-write preemption.
* **preemption handling** — SIGTERM (and a sentinel file, for test
  injection) trigger an immediate synchronous checkpoint before exit.
* **straggler mitigation** — SPMD steps are collective, so a straggler
  stalls the gang; the watchdog detects steps slower than
  ``straggler_factor ×`` the running median and (a) logs the event to the
  journal, (b) after ``max_stragglers`` consecutive slow steps requests a
  restart — on a real cluster the launcher would re-schedule minus the slow
  pod, then the ELASTIC restore (checkpoint.py) re-shards onto the smaller
  mesh (``resume_or_init(shardings=...)``).
* **step journal** — JSON-lines audit trail (step, loss, wall time,
  events) for postmortems; replayed on resume to restore telemetry.

The metrics of a step are read as Python floats for the journal: one host
sync a step, as in the reference.  ``resume_or_init`` places a restored
state on ``device``, the card by default as everywhere in the port.
"""
from __future__ import annotations

import json
import os
import signal
import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np

from . import checkpoint as ckpt_lib


class Journal:
    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def append(self, record: Dict):
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def read(self):
        if not os.path.exists(self.path):
            return []
        with open(self.path) as f:
            return [json.loads(line) for line in f if line.strip()]


class PreemptionSignal:
    """SIGTERM flag + sentinel-file flag (the latter for deterministic
    fault-injection in tests)."""

    def __init__(self, sentinel: Optional[str] = None,
                 install_handler: bool = True):
        self.flag = False
        self.sentinel = sentinel
        if install_handler:
            try:
                signal.signal(signal.SIGTERM, self._on_term)
            except ValueError:
                pass  # not on main thread (e.g. under pytest-xdist)

    def _on_term(self, signum, frame):
        self.flag = True

    def fired(self) -> bool:
        if self.flag:
            return True
        if self.sentinel and os.path.exists(self.sentinel):
            return True
        return False


class StragglerWatchdog:
    def __init__(self, factor: float = 3.0, max_consecutive: int = 3,
                 warmup: int = 5):
        self.factor = factor
        self.max_consecutive = max_consecutive
        self.warmup = warmup
        self.times = []
        self.consecutive = 0

    def observe(self, dt: float) -> Optional[str]:
        self.times.append(dt)
        if len(self.times) <= self.warmup:
            return None
        med = float(np.median(self.times[:-1][-50:]))
        if dt > self.factor * med:
            self.consecutive += 1
            if self.consecutive >= self.max_consecutive:
                self.consecutive = 0
                return "restart_requested"
            return "straggler"
        self.consecutive = 0
        return None


class TrainController:
    """Wraps a compiled step function with the full fault-tolerance loop."""

    def __init__(self, step_fn: Callable, ckpt_dir: str,
                 journal_path: Optional[str] = None,
                 ckpt_every: int = 50, keep: int = 3,
                 preemption_sentinel: Optional[str] = None,
                 straggler_factor: float = 3.0,
                 install_signal_handler: bool = True):
        self.step_fn = step_fn
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.keep = keep
        self.journal = Journal(journal_path or os.path.join(ckpt_dir, "journal.jsonl"))
        self.preempt = PreemptionSignal(preemption_sentinel,
                                        install_signal_handler)
        self.watchdog = StragglerWatchdog(straggler_factor)
        self.saver = ckpt_lib.AsyncCheckpointer(ckpt_dir)
        self.restart_requested = False

    def resume_or_init(self, init_fn: Callable, shardings=None,
                       device="cuda"):
        """Latest checkpoint if present (its tensors on ``device``: the
        card unless the caller names another, where ``init_fn``'s state
        lies; with ``shardings``, DTensors of that layout: the elastic
        restore), else init_fn()."""
        step = ckpt_lib.latest_step(self.ckpt_dir)
        if step is not None:
            step, tree, extra = ckpt_lib.restore(self.ckpt_dir, step, shardings,
                                                 device=device)
            self.journal.append({"event": "resumed", "step": step})
            return step, tree
        self.journal.append({"event": "initialized", "step": 0})
        return 0, init_fn()

    def run(self, state, batches: Iterator, start_step: int, n_steps: int,
            inject_slow_step: Optional[int] = None):
        """Run up to n_steps; returns (final_step, state, stop_reason).

        ``state`` is whatever pytree the step_fn consumes/returns alongside
        metrics: step_fn(state, batch) → (state, metrics).
        ``inject_slow_step`` (tests): sleep inside that step to trip the
        straggler watchdog."""
        step = start_step
        stop = "completed"
        for _ in range(n_steps):
            if self.preempt.fired():
                self.saver.wait()
                ckpt_lib.save(self.ckpt_dir, step, state)
                self.journal.append({"event": "preempted", "step": step})
                stop = "preempted"
                break
            batch = next(batches)
            t0 = time.perf_counter()
            state, metrics = self.step_fn(state, batch)
            if inject_slow_step is not None and step == inject_slow_step:
                time.sleep(0.25)
            dt = time.perf_counter() - t0
            event = self.watchdog.observe(dt)
            rec = {"step": step, "dt": dt,
                   **{k: float(v) for k, v in metrics.items()}}
            if event:
                rec["event"] = event
            self.journal.append(rec)
            step += 1
            if event == "restart_requested":
                self.saver.wait()
                ckpt_lib.save(self.ckpt_dir, step, state)
                self.restart_requested = True
                stop = "restart_requested"
                break
            if step % self.ckpt_every == 0:
                self.saver.save(step, state)
                ckpt_lib.prune(self.ckpt_dir, self.keep)
        if stop == "completed":
            self.saver.wait()
            ckpt_lib.save(self.ckpt_dir, step, state)
        return step, state, stop
