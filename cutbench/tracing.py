"""The traced run: ``torch.profiler`` over the measured window, spans around
calls into the program's layers, and the reduction of the trace to what the
per-layer metrics read.

Spans are the benchmark's own: ``Spans`` wraps a function of the program
(looked up by module and name, so the program's files stay as they are) and
marks each call with marker launches on the calling thread.  The profiler
records device kernels and CUDA runtime calls from every thread, but CPU
ranges (``record_function``) only from the thread that started it, and the
server solves on worker threads.  So a span is read from the order of each
thread's launches: a span opens with ``label index + 2`` back-to-back
launches of ATen's spin kernel (``torch.cuda._sleep``) and closes with one
spin launch followed by a one-element add, so that a close and the next
open never merge into one run of spins.  Every kernel a thread launches
between a span's open and close is that span's.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
from collections import defaultdict
from contextlib import contextmanager
from importlib import import_module
from typing import Dict, List, Optional, Sequence, Tuple

MARK = "spin_kernel"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Spans:
    """Marks the calls of each of ``targets`` ("module:function") while
    active; a span's index is its target's position.  ``closes`` counts
    the closing adds issued (the markers' kernels that are not spins)."""

    def __init__(self, targets: Sequence[str], device):
        self.targets = list(targets)
        self.device = device
        self.closes = 0
        self._lock = threading.Lock()
        self._saved: List[Tuple[object, str, object]] = []

    def _mark(self, n_spins: int, close: bool):
        import torch

        for _ in range(n_spins):
            torch.cuda._sleep(0)
        if close:
            self._one.add_(1)
            with self._lock:
                self.closes += 1

    def __enter__(self):
        import torch

        self._one = torch.zeros(1, device=self.device)
        for i, target in enumerate(self.targets):
            mod_name, attr = target.split(":")
            mod = import_module(mod_name)
            orig = getattr(mod, attr)

            def wrapped(*a, _orig=orig, _i=i, **k):
                self._mark(_i + 2, close=False)
                try:
                    return _orig(*a, **k)
                finally:
                    self._mark(1, close=True)

            self._saved.append((mod, attr, orig))
            setattr(mod, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, attr, orig in reversed(self._saved):
            setattr(mod, attr, orig)
        self._saved.clear()


@contextmanager
def profiled(enabled: bool):
    """``torch.profiler`` over CPU and CUDA activity while ``enabled``;
    yields a holder whose ``summary`` is set on exit (a ``TraceSummary``)."""
    holder = type("Holder", (), {"summary": None})()
    if not enabled:
        yield holder
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=False, with_stack=False) as prof:
        yield holder
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    holder.summary = TraceSummary(events)


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


class TraceSummary:
    """What the per-layer metrics read from a chrome trace (times in s)."""

    def __init__(self, events: Sequence[dict]):
        self.device_ops: List[dict] = []
        runtime: List[dict] = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            if cat in DEVICE_CATS:
                self.device_ops.append(e)
            elif cat in ("cuda_runtime", "cuda_driver"):
                runtime.append(e)
        self.runtime = runtime
        self.kernels = [e for e in self.device_ops if e["cat"] == "kernel"]
        self.busy = _merge([(e["ts"], e["ts"] + e.get("dur", 0))
                            for e in self.device_ops])
        self.busy_s = sum(b - a for a, b in self.busy) * 1e-6
        self.device_s = sum(e.get("dur", 0) for e in self.device_ops) * 1e-6
        self._span_s: Optional[Dict[int, float]] = None

    # -- kernels ------------------------------------------------------------
    def kernel(self, name_part: str) -> Tuple[int, float]:
        """(calls, device seconds) of the kernels whose name holds
        ``name_part``."""
        ks = [e for e in self.kernels if name_part in e.get("name", "")]
        return len(ks), sum(e.get("dur", 0) for e in ks) * 1e-6

    def launches(self) -> int:
        """Kernels run on the device, marker kernels of the spans aside
        (their spins; the closing adds are subtracted by the caller)."""
        return sum(1 for e in self.kernels if MARK not in e.get("name", ""))

    # -- spans ---------------------------------------------------------------
    def span_seconds(self, index: int) -> float:
        """Device seconds of the kernels, copies and sets launched inside
        span ``index`` (the position of its target in ``Spans``)."""
        if self._span_s is None:
            self._span_s = self._spans()
        return self._span_s.get(index, 0.0)

    def _spans(self) -> Dict[int, float]:
        by_corr = {}
        for e in self.device_ops:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                by_corr[corr] = e
        per_thread = defaultdict(list)
        for r in self.runtime:
            corr = r.get("args", {}).get("correlation")
            if corr in by_corr:
                per_thread[r.get("tid")].append((r["ts"], by_corr[corr]))
        out: Dict[int, float] = defaultdict(float)
        for launches in per_thread.values():
            launches.sort(key=lambda t: t[0])
            stack: List[int] = []
            run = 0

            def flush(run):
                if run >= 2:
                    stack.append(run - 2)
                elif run == 1 and stack:
                    stack.pop()

            for _, dev in launches:
                if MARK in dev.get("name", ""):
                    run += 1
                    continue
                flush(run)
                run = 0
                if stack:
                    out[stack[-1]] += dev.get("dur", 0) * 1e-6
            flush(run)
        return out

    # -- breakdown ------------------------------------------------------------
    def top_device_ops(self, top: int = 10) -> List[list]:
        by = defaultdict(float)
        for e in self.device_ops:
            by[e.get("name", "?")[:96]] += e.get("dur", 0) * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """The device's idle gaps between its first and last operation, each
        named by the host's runtime call that overlaps it most (``no_host_op``
        where none does), summed by name."""
        if len(self.busy) < 2:
            return []
        rt = sorted((e["ts"], e["ts"] + e.get("dur", 0), e.get("name", "?"))
                    for e in self.runtime)
        by = defaultdict(float)
        active: list = []     # calls that may overlap the gaps still ahead
        j = 0
        for (_, a), (b, _) in zip(self.busy, self.busy[1:]):
            while j < len(rt) and rt[j][0] < b:
                active.append(rt[j])
                j += 1
            # the gaps come in order, so a call ended before this one is done
            active = [r for r in active if r[1] > a]
            best, name = 0.0, "no_host_op"
            for s, e, nm in active:
                ov = min(e, b) - max(s, a)
                if ov > best:
                    best, name = ov, nm
            by[name] += (b - a) * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]
