"""The port's span dashboard (``repro_torch.obs.dashboard``) and its CLI
(``repro_torch.launch.obs``) against the JAX package's, on the CPU.

Both read one JSONL sink: the port's tracer writes it (the JAX package's
span schema), and ``load_spans``, ``span_names``, ``aggregate``,
``render`` and ``percentile`` must give equal results in both packages;
the CLIs must print the same text and keep the same exit contract.  A
traced cut-tree build shows its span tree (``cuttree.build`` >
``cuttree.wave`` > ``session.solve_batch``).
"""
import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import tiny_instance  # noqa: E402

from repro.obs import dashboard as jdash  # noqa: E402

from repro_torch.obs import dashboard, trace  # noqa: E402


@pytest.fixture
def traced():
    """The port's tracer on for one test; off, sink closed and empty after."""
    trace.clear()
    trace.configure(enabled=True)
    yield trace
    trace.configure(enabled=False, jsonl="")
    trace.clear()


def _write_sink(tr, path):
    """Nested spans in two roots, one closed by an exception, then a
    partial trailing line (a writer caught mid-line)."""
    tr.configure(jsonl=str(path))
    for i in range(3):
        with tr.span("serve.batch", i=i):
            with tr.span("session.solve_batch"):
                with tr.span("session.irls"):
                    pass
            with tr.span("session.rounding"):
                pass
    with pytest.raises(RuntimeError):
        with tr.span("cuttree.build"):
            with tr.span("cuttree.wave"):
                raise RuntimeError("boom")
    tr.configure(jsonl="")
    with open(path, "a") as fh:
        fh.write('{"name": "partial"')


def test_dashboard_reads_the_sink_as_the_reference_does(traced, tmp_path):
    path = tmp_path / "trace.jsonl"
    _write_sink(traced, path)
    spans, off = dashboard.load_spans(str(path))
    want, want_off = jdash.load_spans(str(path))
    assert spans == want and off == want_off
    assert off < path.stat().st_size          # the partial tail is left
    assert dashboard.span_names(spans) == jdash.span_names(want) == {
        "serve.batch": 3, "session.solve_batch": 3, "session.irls": 3,
        "session.rounding": 3, "cuttree.build": 1, "cuttree.wave": 1}
    agg = dashboard.aggregate(spans)
    assert agg == jdash.aggregate(want)
    assert set(agg) == {"serve.batch", "serve.batch>session.solve_batch",
                        "serve.batch>session.solve_batch>session.irls",
                        "serve.batch>session.rounding", "cuttree.build",
                        "cuttree.build>cuttree.wave"}
    assert agg["cuttree.build>cuttree.wave"]["errors"] == 1
    for path_, d in agg.items():
        assert 0.0 <= d["self_s"] <= d["total_s"], path_
    # the offset resumes after the last whole line
    more, off2 = dashboard.load_spans(str(path), offset=off)
    assert more == [] and off2 == off


@pytest.mark.parametrize("sort", [None, "self", "p99", "count"])
@pytest.mark.parametrize("top", [30, 3])
def test_render_matches_reference(traced, tmp_path, sort, top):
    path = tmp_path / "trace.jsonl"
    _write_sink(traced, path)
    spans, _ = dashboard.load_spans(str(path))
    agg = dashboard.aggregate(spans)
    out = dashboard.render(agg, top=top, sort=sort, title="t")
    assert out == jdash.render(jdash.aggregate(spans), top=top, sort=sort,
                               title="t")
    assert out.splitlines()[0] == "t"
    if top == 3:
        assert out.splitlines()[-1] == "  ... 3 more paths"
    with pytest.raises(ValueError, match="sort must be"):
        dashboard.render(agg, sort="wall")
    assert dashboard.render({}) == jdash.render({})


def test_percentile_matches_reference():
    rng = np.random.default_rng(0)
    for n in (0, 1, 2, 7, 100):
        xs = list(rng.exponential(size=n))
        for q in (0, 1, 50, 90, 99, 100):
            assert dashboard.percentile(xs, q) == jdash.percentile(xs, q)


def test_obs_cli_matches_reference(traced, tmp_path, capsys, monkeypatch):
    """``launch.obs`` in-process: the reference CLI's text for each sort,
    exit 0 on spans, 1 on a missing or empty sink."""
    from repro.launch import obs as jcli
    from repro_torch.launch import obs as cli

    path = tmp_path / "trace.jsonl"
    _write_sink(traced, path)
    monkeypatch.setattr(sys, "argv", ["obs"])
    for extra in ([], ["--sort", "self"], ["--top", "2"]):
        assert cli.main([str(path)] + extra) == 0
        got = capsys.readouterr().out
        assert jcli.main([str(path)] + extra) == 0
        assert got == capsys.readouterr().out
        assert "subsystems: cuttree, serve, session" in got
    assert "closed by exception" in got
    assert cli.main([str(tmp_path / "missing.jsonl")]) == 1
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    assert cli.main([str(empty)]) == 1
    assert "no spans" in capsys.readouterr().err


def test_cut_tree_build_spans(traced, tmp_path):
    """A traced IRLS cut-tree build on the CPU writes the span tree the
    dashboard reads: every wave under the build, every batched solve under
    a wave, and the build's attributes (waves, solves, discarded)."""
    from repro_torch.core import IRLSConfig
    from repro_torch.cuttree import build_cut_tree
    from repro_torch.graphs.structures import instance_from_arrays

    j = tiny_instance(n=10, seed=0)
    p = instance_from_arrays(j.graph.src, j.graph.dst, j.graph.weight, j.n,
                             j.s_weight, j.t_weight)
    path = tmp_path / "build.jsonl"
    traced.configure(jsonl=str(path))
    cfg = IRLSConfig(n_irls=6, pcg_max_iters=20, precond="jacobi",
                     n_blocks=1, irls_tol=1e-3, adaptive_tol=True)
    tree = build_cut_tree(p, cfg=cfg, max_batch=4, device="cpu")
    traced.configure(jsonl="")
    spans, _ = dashboard.load_spans(str(path))
    agg = dashboard.aggregate(spans)
    wave = "cuttree.build>cuttree.wave"
    assert agg["cuttree.build"]["count"] == 1
    assert agg[wave]["count"] == tree.meta["n_waves"]
    assert agg[wave + ">session.solve_batch"]["count"] >= tree.meta["n_waves"]
    assert agg[wave + ">session.solve_batch>session.irls"]["count"] == \
        agg[wave + ">session.solve_batch"]["count"]
    build = [s for s in spans if s["name"] == "cuttree.build"][0]
    attrs = build["attrs"]
    assert attrs["waves"] == tree.meta["n_waves"]
    assert attrs["solves"] == tree.meta["n_solves"]
    assert attrs["discarded"] == tree.meta["speculation_discarded"]
    assert json.loads(json.dumps(agg)) == agg     # plain JSON, as sinks are
    assert "cuttree.wave" in dashboard.render(agg)
