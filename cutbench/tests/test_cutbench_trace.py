"""The trace reduction on a synthetic chrome trace: spans read from each
thread's marker launches, busy time, launches and idle gaps."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from cutbench.tracing import TraceSummary  # noqa: E402


def _events():
    """Two threads.  Thread 1 opens span 0 (two spins), launches k1 and k2,
    closes it (a spin and an add), then launches k3 outside; thread 2
    launches k4 while thread 1's span is open.  Times in µs."""
    ev, corr = [], [0]

    def launch(tid, t, name, start, dur):
        corr[0] += 1
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                   "tid": tid, "ts": t, "dur": 2, "args": {"correlation": corr[0]}})
        ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": start,
                   "dur": dur, "args": {"correlation": corr[0]}})

    launch(1, 0, "spin_kernel(long)", 10, 1)
    launch(1, 3, "spin_kernel(long)", 11, 1)
    launch(1, 6, "k1", 12, 10)
    launch(2, 7, "k4", 22, 7)
    launch(1, 9, "k2", 29, 20)
    launch(1, 12, "spin_kernel(long)", 49, 1)
    launch(1, 15, "add", 50, 1)
    ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync",
               "tid": 1, "ts": 55, "dur": 40, "args": {}})
    launch(1, 96, "k3", 100, 5)
    ev.append({"ph": "X", "cat": "cpu_op", "name": "aten::add", "tid": 1,
               "ts": 0, "dur": 1})
    return ev


def test_spans_busy_launches_and_gaps():
    t = TraceSummary(_events())
    assert t.span_seconds(0) == pytest.approx(30e-6)      # k1 and k2 only
    assert t.span_seconds(1) == 0.0
    assert t.launches() == 5                               # spins aside
    assert t.kernel("k2") == (1, pytest.approx(20e-6))
    assert t.busy_s == pytest.approx((51 - 10 + 5) * 1e-6)
    gaps = dict(t.idle_gaps())
    assert gaps == {"cudaMemcpyAsync": pytest.approx(49e-6)}
    assert t.top_device_ops()[0] == ["k2", pytest.approx(20e-6)]


def test_every_metric_reader_reads_a_run_or_returns_none():
    """Each file under ``metrics/`` reads a solve's and a server's run,
    with and without a trace, and gives a finite number or None."""
    import math

    from cutbench import harness

    events = _events()
    for name in ("ell_spmv", "fused_ell_sweep", "edge_reweight"):
        events.append({"ph": "X", "cat": "kernel", "name": name + "_kernel",
                       "ts": 200, "dur": 1000, "args": {}})
    solve = {"attempted": 2, "failed": 0, "completed": 2, "wall_s": 10.0,
             "peak_bytes": 2 ** 30, "pcg_iters": [[6, 50, 0], [5, 0, 0]],
             "problem_build_s": 1.0, "shape": {"n": 512, "m": 6000, "k": 32}}
    serve = {"attempted": 16, "failed": 0, "completed": 16, "wall_s": 4.0,
             "peak_bytes": 2 ** 30, "latencies": [0.5] * 16,
             "timings": [{"queue": 0.01, "total": 0.5}] * 16,
             "server": {"mean_batch_size": 8.0, "bucket_sizes": [8, 8]},
             "shape": {"n": 512, "m": 1400}, "marker_adds": 1}
    names = sorted(p.stem for p in (harness.HERE / "metrics").glob("*.py"))
    assert len(names) >= 17
    for name in names:
        reader = harness.metric_module(name)
        record = serve if name.endswith(".serve") or "serve" in name else solve
        for trace in (None, TraceSummary(events)):
            run = harness.Run({}, {}, {}, record, 5.0, trace)
            value = reader.read(run)
            assert value is None or (math.isfinite(value) and value >= 0), name


def test_spans_wrap_the_program_function_and_restore_it(monkeypatch):
    from repro_torch.core import laplacian

    from cutbench import harness
    from cutbench.tracing import Spans

    target = "repro_torch.core.laplacian:matvec_coo"
    orig = laplacian.matvec_coo
    marks = []
    monkeypatch.setattr(Spans, "_mark",
                        lambda self, n, close: marks.append((n, close)))
    spans = Spans([target], "cpu")
    with spans:
        assert laplacian.matvec_coo is not orig
        with pytest.raises(TypeError):
            laplacian.matvec_coo()          # the call fails; the span closes
    assert laplacian.matvec_coo is orig
    assert marks == [(2, False), (1, True)]
    run = harness.Run({}, {}, {}, {}, 0.0, TraceSummary(_events()), spans)
    assert run.span(target) == pytest.approx(30e-6)
