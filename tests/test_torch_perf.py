"""The port's perf sentinel (``repro_torch.obs.perf``, ``launch.bench_diff``)
on the cases of ``tests/test_perf.py``: schema, trajectory store,
comparator and the ``--from-payload`` CLI give the reference's verdicts
and exit codes on the same payloads; the port's ``extract_metrics`` reads
every committed ``BENCH_*.json`` as the reference's does; and the work
counts in ``SolveResult.telemetry`` (``obs.perf.profile``), which do not
depend on the route (kernel or plain).

``test_write_payloads_appends_history`` of the reference tests
``benchmarks.run.write_payloads``, the JAX benches' writer; the port has
no benchmarks yet, so it has no counterpart here (``bench_diff`` without
``--from-payload`` says so, and ``test_record_path_names_missing_benches``
holds that)."""
import glob
import json
import math
import os

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.obs.perf import schema as jschema  # noqa: E402
from repro_torch.obs.perf import history as hist  # noqa: E402
from repro_torch.obs.perf import regress, schema  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# ---------------------------------------------------------------------------
# schema: flatten + classify
# ---------------------------------------------------------------------------

PAYLOAD = {
    "name": "toy",
    "cfg": {"smoke": True, "n_irls": 50},          # config echo: skipped
    "derived": "text",                             # skipped
    "s_per_solve": 0.5,
    "solves_per_sec": 2.0,
    "speedup": 3.0,
    "pcg_iters": 120,
    "cut_value": 10.0,
    "quality_ok": True,
    "max_rel": 1e-6,
    "samples": [1.0, 2.0, 3.0],                    # scalar list: skipped
    "nan_metric": float("nan"),                    # dropped
    "topologies": [
        {"topology": "grid", "s_per_solve": 0.1},
        {"topology": "road", "s_per_solve": 0.2},
    ],
}


class TestSchema:
    def test_flatten_paths_and_values(self):
        ms = {m["metric"]: m for m in schema.extract_metrics(PAYLOAD)}
        assert ms["s_per_solve"]["kind"] == "time"
        assert ms["s_per_solve"]["direction"] == "lower"
        assert ms["solves_per_sec"]["kind"] == "throughput"
        assert ms["speedup"]["kind"] == "ratio"
        assert ms["pcg_iters"]["kind"] == "count"
        assert ms["cut_value"] == {"metric": "cut_value", "value": 10.0,
                                   "kind": "quality", "direction": "equal"}
        assert ms["max_rel"]["kind"] == "quality"
        # bools flatten to 0/1 with kind bool
        assert ms["quality_ok"]["value"] == 1.0
        assert ms["quality_ok"]["kind"] == "bool"
        # lists of dicts key by discriminator, not position
        assert ms["topologies[grid].s_per_solve"]["value"] == 0.1
        assert ms["topologies[road].s_per_solve"]["value"] == 0.2
        # config echo / text / raw samples / NaN never become metrics
        assert not any(m.startswith(("cfg", "derived", "samples")) for m in ms)
        assert "nan_metric" not in ms

    def test_info_rules_shadow_time_rules(self):
        # a config echo like max_wait_ms must NOT classify as wall-clock
        assert schema.classify("cfg_echo.max_wait_ms")[0] == "info"
        assert schema.classify("load_points[2.0].p99_ms")[0] == "time"
        # profiling figures: gflops gate as throughput, raw flops are info
        assert schema.classify("telemetry.mean_achieved_gflops")[0] == \
            "throughput"
        assert schema.classify("telemetry.total_flops")[0] == "info"
        assert schema.classify("unheard_of_metric")[0] == "info"

    def test_committed_bench_payloads_flatten(self):
        """Every committed BENCH_*.json yields classified, finite metrics."""
        files = sorted(glob.glob(os.path.join(ROOT, "BENCH_*.json")))
        assert files, "no committed bench payloads found"
        for f in files:
            with open(f) as fh:
                payload = json.load(fh)
            ms = schema.extract_metrics(payload)
            assert ms, f
            for m in ms:
                assert m["kind"] in schema.KINDS
                assert not math.isnan(m["value"]), m


# ---------------------------------------------------------------------------
# history: append-only trajectory
# ---------------------------------------------------------------------------

class TestHistory:
    def test_roundtrip_and_run_numbering(self, tmp_path):
        path = str(tmp_path / "H.jsonl")
        r0 = hist.append_history(dict(PAYLOAD), path, sha="abc1234")
        r1 = hist.append_history(dict(PAYLOAD), path, sha="abc1234")
        assert {r["run"] for r in r0} == {0}
        assert {r["run"] for r in r1} == {1}
        recs = hist.read_history(path)
        assert len(recs) == len(r0) + len(r1)
        assert all(r["bench"] == "toy" and r["variant"] == "smoke"
                   and r["git_sha"] == "abc1234" for r in recs)

    def test_variants_number_independently(self, tmp_path):
        path = str(tmp_path / "H.jsonl")
        full = {k: v for k, v in PAYLOAD.items() if k != "cfg"}
        hist.append_history(dict(PAYLOAD), path, sha="s")      # smoke run 0
        recs = hist.append_history(full, path, sha="s")        # full run 0
        assert {r["variant"] for r in recs} == {"full"}
        assert {r["run"] for r in recs} == {0}

    def test_corrupt_lines_skipped(self, tmp_path):
        path = str(tmp_path / "H.jsonl")
        hist.append_history(dict(PAYLOAD), path, sha="s")
        n = len(hist.read_history(path))
        with open(path, "a") as fh:
            fh.write("{not json\n\n[1,2]\n")
        assert len(hist.read_history(path)) == n

    def test_missing_file_reads_empty(self, tmp_path):
        assert hist.read_history(str(tmp_path / "absent.jsonl")) == []


# ---------------------------------------------------------------------------
# comparator: median + MAD, direction-aware
# ---------------------------------------------------------------------------

class TestRegress:
    def test_direction_lower(self):
        base = [1.0, 1.0, 1.0]
        up = regress.classify_value("b", "m", "time", "lower", base, 2.0)
        down = regress.classify_value("b", "m", "time", "lower", base, 0.5)
        flat = regress.classify_value("b", "m", "time", "lower", base, 1.1)
        assert up.classification == "regressed"
        assert down.classification == "improved"
        assert flat.classification == "flat"    # within the 35% rtol

    def test_direction_higher(self):
        base = [10.0, 10.0, 10.0]
        v = regress.classify_value("b", "m", "throughput", "higher",
                                   base, 5.0)
        assert v.classification == "regressed"
        assert v.delta == pytest.approx(-5.0)

    def test_direction_equal_both_ways(self):
        base = [10.0] * 5
        for cur in (10.5, 9.5):
            v = regress.classify_value("b", "cut", "quality", "equal",
                                       base, cur)
            assert v.classification == "regressed", cur
        assert regress.classify_value("b", "cut", "quality", "equal",
                                      base, 10.001).classification == "flat"

    def test_noisy_baseline_widens_gate(self):
        # deterministic baseline: 10% count drift fires (rtol 5%)
        tight = regress.classify_value("b", "pcg_total", "count", "lower",
                                       [100.0] * 6, 110.0)
        assert tight.classification == "regressed"
        # same drift against a noisy baseline stays inside z·1.4826·MAD
        noisy = regress.classify_value("b", "pcg_total", "count", "lower",
                                       [90.0, 110.0, 95.0, 105.0, 100.0,
                                        108.0], 110.0)
        assert noisy.classification == "flat"
        assert noisy.threshold > tight.threshold

    def test_bool_flip_fires(self):
        v = regress.classify_value("b", "ok", "bool", "higher",
                                   [1.0, 1.0, 1.0], 0.0)
        assert v.classification == "regressed"

    def test_no_baseline_is_new_and_info_never_gates(self):
        assert regress.classify_value("b", "m", "time", "lower", [],
                                      1.0).classification == "new"
        assert regress.classify_value("b", "m", "info", "higher",
                                      [1.0], 99.0).classification == "flat"

    def test_compare_payload_filters_bench_and_variant(self, tmp_path):
        path = str(tmp_path / "H.jsonl")
        for _ in range(3):
            hist.append_history(dict(PAYLOAD), path, sha="s")
        # pollute with another bench and the full variant of the same bench
        other = dict(PAYLOAD, name="other", s_per_solve=99.0)
        full = {k: v for k, v in PAYLOAD.items() if k != "cfg"}
        full["s_per_solve"] = 99.0
        hist.append_history(other, path, sha="s")
        hist.append_history(full, path, sha="s")
        verdicts = regress.compare_payload(dict(PAYLOAD),
                                           hist.read_history(path))
        v = {x.metric: x for x in verdicts}["s_per_solve"]
        assert v.n_baseline == 3            # the polluters never matched
        assert v.baseline_median == pytest.approx(0.5)
        assert v.classification == "flat"

    def test_gate_kind_restriction(self):
        vs = [regress.classify_value("b", "t", "time", "lower",
                                     [1.0] * 3, 9.0),
              regress.classify_value("b", "c", "count", "lower",
                                     [100.0] * 3, 150.0)]
        assert {v.metric for v in regress.gate(vs)} == {"t", "c"}
        assert {v.metric for v in regress.gate(
            vs, kinds=("count", "quality", "bool"))} == {"c"}

    def test_render_table_mentions_regressions(self):
        vs = [regress.classify_value("toy", "s_per_solve", "time", "lower",
                                     [1.0] * 3, 9.0)]
        out = regress.render_table(vs, show="all")
        assert "regressed" in out and "s_per_solve" in out


# ---------------------------------------------------------------------------
# bench_diff CLI: record → diff → gate
# ---------------------------------------------------------------------------

class TestBenchDiffCLI:
    def _seed(self, tmp_path, n=3):
        path = str(tmp_path / "H.jsonl")
        for _ in range(n):
            hist.append_history(dict(PAYLOAD), path, sha="s")
        return path

    def _payload_file(self, tmp_path, payload, name="p.json"):
        f = str(tmp_path / name)
        with open(f, "w") as fh:
            json.dump(payload, fh)
        return f

    def test_synthetic_2x_slowdown_exits_nonzero(self, tmp_path, capsys):
        from repro_torch.launch import bench_diff
        history = self._seed(tmp_path)
        slow = dict(PAYLOAD, s_per_solve=1.0)          # 2× the 0.5 baseline
        rc = bench_diff.main(["--from-payload",
                              self._payload_file(tmp_path, slow),
                              "--history", history])
        cap = capsys.readouterr()
        assert rc == 1
        assert "regressed" in cap.out
        assert "REGRESSED" in cap.err and "s_per_solve" in cap.err

    def test_unmodified_rerun_classifies_flat_across_repeats(self, tmp_path,
                                                             capsys):
        from repro_torch.launch import bench_diff
        history = self._seed(tmp_path)
        f = self._payload_file(tmp_path, dict(PAYLOAD))
        for _ in range(3):                   # 3 repeats, growing baseline
            rc = bench_diff.main(["--from-payload", f,
                                  "--history", history])
            assert rc == 0
            assert "0 regressed" in capsys.readouterr().out
            hist.append_history(dict(PAYLOAD), history, sha="s")

    def test_gate_missing_baseline_exits_2(self, tmp_path, capsys):
        from repro_torch.launch import bench_diff
        rc = bench_diff.main(["--gate", "--from-payload",
                              self._payload_file(tmp_path, dict(PAYLOAD)),
                              "--history", str(tmp_path / "empty.jsonl")])
        assert rc == 2
        assert "no committed baseline" in capsys.readouterr().err

    def test_gate_ignores_wallclock_regressions(self, tmp_path, capsys):
        from repro_torch.launch import bench_diff
        history = self._seed(tmp_path)
        slow = dict(PAYLOAD, s_per_solve=1.0)          # time-kind only
        rc = bench_diff.main(["--gate", "--from-payload",
                              self._payload_file(tmp_path, slow),
                              "--history", history])
        capsys.readouterr()
        assert rc == 0                       # count/quality/bool unchanged
        bad = dict(PAYLOAD, pcg_iters=200)             # count-kind drift
        rc = bench_diff.main(["--gate", "--from-payload",
                              self._payload_file(tmp_path, bad, "q.json"),
                              "--history", history])
        capsys.readouterr()
        assert rc == 1

    def test_record_path_names_missing_benches(self, capsys):
        """Without ``--from-payload`` there is nothing to run: exit 2 with
        an error that names the JAX benches the port lacks."""
        from repro_torch.launch import bench_diff
        with pytest.raises(SystemExit) as exc:
            bench_diff.main([])
        assert exc.value.code == 2
        err = capsys.readouterr().err
        assert "no torch benchmarks" in err and "irls" in err

    def test_bench_names_are_refused(self, tmp_path, capsys):
        """The port has no benches to name: bench names and ``--smoke``
        are refused, not ignored beside ``--from-payload``."""
        from repro_torch.launch import bench_diff
        f = self._payload_file(tmp_path, dict(PAYLOAD), "p.json")
        with pytest.raises(SystemExit) as exc:
            bench_diff.main(["irls", "--smoke", "--from-payload", f])
        assert exc.value.code == 2
        assert "unrecognized arguments" in capsys.readouterr().err

    def test_default_history_is_the_ports_own(self):
        """The port never records into the JAX package's trajectory."""
        assert hist.HISTORY_FILE == "TORCH_BENCH_HISTORY.jsonl"
        assert hist.history_path(ROOT) != os.path.join(ROOT,
                                                       "BENCH_HISTORY.jsonl")


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(
    ROOT, "BENCH_*.json"))), ids=os.path.basename)
def test_extract_metrics_agree_with_reference(path):
    """The port's schema reads every committed payload as the JAX
    package's does: the same paths, values, kinds and directions."""
    with open(path) as fh:
        payload = json.load(fh)
    assert schema.extract_metrics(payload) == jschema.extract_metrics(payload)


# ---------------------------------------------------------------------------
# continuous profiling: telemetry carries the work counts
# ---------------------------------------------------------------------------

class TestProfiling:
    @pytest.fixture(scope="class")
    def small_instance(self):
        from repro_torch.graphs import generators as gen
        g = gen.grid_2d(8, 8, seed=3)
        return gen.segmentation_instance(g, (8, 8), seed=4)

    def test_host_and_scanned_telemetry_flops(self, small_instance):
        from repro_torch.core import IRLSConfig, MinCutSession
        from repro_torch.distributed import collectives
        cfg = IRLSConfig(n_irls=4, pcg_max_iters=30)
        sess = MinCutSession(small_instance, cfg, profile=True, device="cpu")
        try:
            for backend in ("host", "scanned", "sharded"):
                t = sess.solve(backend=backend).telemetry
                assert t["flops"] and t["flops"] > 0, backend
                assert t["achieved_gflops"] and t["achieved_gflops"] > 0, \
                    backend
                assert t["roofline_fraction"] > 0, backend
        finally:
            collectives.release_world()
        costs = sess.program_costs()
        assert {"host", "scanned/False", "sharded/halo"} <= set(costs)
        snap = sess.telemetry.snapshot()
        assert snap["total_flops"] > 0
        assert snap["profiled_solves"] == 3
        assert snap["mean_achieved_gflops"] > 0

    def test_profile_off_leaves_telemetry_none(self, small_instance):
        from repro_torch.core import IRLSConfig, MinCutSession
        sess = MinCutSession(small_instance,
                             IRLSConfig(n_irls=3, pcg_max_iters=20),
                             profile=False, device="cpu")
        t = sess.solve(backend="host").telemetry
        assert t["flops"] is None and t["achieved_gflops"] is None

    def test_profile_env_switch(self, monkeypatch):
        from repro_torch.obs.perf import profile as perf_profile
        monkeypatch.setenv(perf_profile.PROFILE_ENV, "1")
        assert perf_profile.default_enabled()
        monkeypatch.setenv(perf_profile.PROFILE_ENV, "0")
        assert not perf_profile.default_enabled()

    def test_batch_solves_carry_costs(self, small_instance):
        from repro_torch.core import IRLSConfig, MinCutSession, Weights
        cfg = IRLSConfig(n_irls=3, pcg_max_iters=20)
        sess = MinCutSession(small_instance, cfg, profile=True, device="cpu")
        w = Weights(np.asarray(small_instance.graph.weight),
                    np.asarray(small_instance.s_weight),
                    np.asarray(small_instance.t_weight))
        res = sess.solve_batch([w, w], cfg=cfg)
        assert len(res) == 2
        for r in res:
            assert r.telemetry["flops"] and r.telemetry["flops"] > 0

    @pytest.mark.parametrize("backend", ["host", "scanned"])
    def test_counts_do_not_depend_on_the_route(self, small_instance,
                                               backend):
        """The kernel route (here the kernels' plain versions: CPU
        tensors) and the plain route count the same work for the same
        solve: the count reads the shapes and the PCG trace only."""
        import dataclasses
        from repro_torch.core import IRLSConfig, MinCutSession
        cfg = IRLSConfig(n_irls=4, pcg_max_iters=30, layout="ell",
                         precond="block_jacobi", n_blocks=4,
                         explicit_block_inverse=True)
        got = {}
        for up in (True, False):
            sess = MinCutSession(small_instance,
                                 dataclasses.replace(cfg, use_pallas=up),
                                 profile=True, device="cpu")
            t = sess.solve(backend=backend).telemetry
            got[up] = (t["flops"], t["hbm_bytes"], t["pcg_per_iter"],
                       sess.program_costs())
        assert got[True][2] == got[False][2]
        assert got[True][:2] == got[False][:2]
        assert got[True][3] == got[False][3]

    def test_terms_are_the_kernel_table_bounds(self):
        """The three hot kernels' terms are the bytes of their bounds in
        chip_smoke.py's table: at 96³ (n = 884,736, k = 32) the ELL matvec
        moves 237.1 MB, the sweep 361.0 MB, and 1,728 blocks of 512² take
        1.82 GB to apply."""
        from repro_torch.obs.perf import profile as p
        n, k, slots = 884_736, 32, 2 * 11_254_460
        assert p.ell_matvec(n, k, slots).hbm_bytes == 8 * n * k + 12 * n
        assert p.ell_sweep(n, k, slots).hbm_bytes == 12 * n * k + 24 * n
        apply = p.block_apply(1728, 512)
        assert apply.hbm_bytes == 4 * 1728 * 512 ** 2 + 8 * 1728 * 512
        assert apply.flops == 2 * 1728 * 512 ** 2
        # 0.0708 ms and 0.5430 ms at 3.35 TB/s, as the table's bounds
        assert p.ell_matvec(n, k, slots).hbm_bytes / p.HBM_BYTES_PER_S \
            == pytest.approx(0.0708e-3, rel=2e-3)
        assert apply.hbm_bytes / p.HBM_BYTES_PER_S == \
            pytest.approx(0.5430e-3, rel=2e-3)

    def test_per_solve_cost_keys_and_roofline(self):
        from repro_torch.obs.perf import profile as p
        out = p.per_solve_cost({"flops": 6.7e12, "hbm_bytes": 1.675e12,
                                "collective_bytes": 8.0}, 2.0, calls=2)
        assert set(out) == {"flops", "hbm_bytes", "collective_bytes",
                            "program_calls", "achieved_gflops",
                            "achieved_gbps", "roofline_fraction"}
        assert out["flops"] == 1.34e13 and out["program_calls"] == 2.0
        # 1.34e13 flops need 0.2 s, 3.35e12 bytes 1.0 s: bytes bound it
        assert out["roofline_fraction"] == pytest.approx(0.5)
        assert p.per_solve_cost(None, 1.0) is None
