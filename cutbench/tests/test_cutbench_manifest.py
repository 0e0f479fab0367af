"""``BENCHMARK.json`` against the benchmark's contract, and every cell
resolved by name: its configuration, traffic mix and metrics."""
import json
import re
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from cutbench import harness, judge  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return harness.manifest()


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_manifest_keys_names_and_units(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    assert 1 <= len(bench["command"]) <= 32
    assert all(_line(w) for w in bench["command"])
    assert bench["command"][1].startswith(bench["paths"][0] + "/")
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(bench["paths"][0] + "/")
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4) and _line(w["why"])
        names.append(w["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
        names.append(m["name"])
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert {w["config"] for w in bench["workloads"]} == \
        {c["name"] for c in bench["configs"]}
    fours = sum(w["chips"] == 4 for w in bench["workloads"])
    assert fours <= max(1, len(bench["workloads"]) // 4)


def test_metrics_follow_the_contract(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert _line(m["layer"]) and m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells
            # every cell that reports it reports the metric it moves
            assert cell in e2e[m["moves"]].get("workloads", cells)
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:
        reported = [m["name"] for m in harness.metrics_of(bench, cell, False)]
        assert "setup_s" in reported and len(reported) >= 2
        assert harness.metrics_of(bench, cell, True)


def test_run_budget_fits_the_full_check(bench):
    # 24 cells: 2 + 14 runs a cell, each run_seconds + 60 s, 2 × 90 s a
    # cell to compile, 1200 s spare, within 43200 s
    t = (2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 180 + 1200
    assert t <= 43200


def test_every_cell_resolves_by_name(bench):
    from repro_torch.graphs import generators

    from cutbench import drive

    for cell in bench["workloads"]:
        config = harness.config_of(cell)
        traffic = harness.traffic_of(cell)
        assert config["name"] == cell["config"]
        assert set(config["reduced"]) == set(next(
            c["reduced"] for c in bench["configs"] if c["name"] == cell["config"]))
        assert {"graph", "terminals", "solver", "driver", "rounding", "check",
                "assumed"} <= set(config)
        assert callable(getattr(generators, config["graph"]["generator"]))
        assert callable(getattr(generators, config["terminals"]["generator"]))
        assert {"frac_gap", "value_gap"} <= set(judge.numbers(config))
        mode = drive.load_mode(traffic["mode"]).Mode
        for step in ("window", "sample", "checks", "close"):
            assert callable(getattr(mode, step))
        for trace in (False, True):
            for m in harness.metrics_of(bench, cell["name"], trace):
                assert callable(harness.metric_module(m["name"]).read)
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()


# A mode of its own: the solve loop's set-up, and a window of two solves.
TWO_SOLVES = """
from cutbench import drive

Base = drive.load_mode("solve_loop").Mode


class Mode(Base):
    def window(self, seconds):
        import time

        self.answers = []
        t0 = time.perf_counter()
        for w in self.pool[:2]:
            res = self.session.solve(weights=w,
                                     rounding=self.config["rounding"])
            self.answers.append({"voltages": res.voltages,
                                 "in_source": res.cut.in_source,
                                 "cut_value": res.cut.cut_value})
        return {"attempted": 2, "failed": 0, "completed": 2,
                "wall_s": time.perf_counter() - t0, "peak_bytes": None}
"""


def _new_grid_cell(base, bench):
    """A tiny liver with two tenants whose walks drift a fifth of the edges
    a request, and a metric of its own."""
    (base / "metrics" / "lanes_seen.serve.py").write_text(
        "def read(run):\n    return float(len(run.record['latencies']))\n")
    (base / "traffic" / "two_tenants.json").write_text(json.dumps(
        dict(json.loads((base / "traffic" / "bursts_closed.json").read_text()),
             tenants=2, check_sample=4, drift_share=0.2)))
    cfg = json.loads((base / "configs" / "liver_volume.json").read_text())
    cfg.update(name="tiny_liver",
               graph={"generator": "grid_3d",
                      "args": {"d": 4, "h": 6, "w": 6, "conn": 6}},
               terminals={"generator": "segmentation_instance",
                          "args": {"shape": [4, 6, 6]}})
    (base / "configs" / "tiny_liver.json").write_text(json.dumps(cfg))
    return "tiny_liver", "two_tenants", "lanes_seen.serve", "requests"


def _new_road_cell(base, bench):
    """Another graph family and terminal rule by name, and a mode of its
    own, on the host driver with point Jacobi."""
    (base / "modes").mkdir(exist_ok=True)
    (base / "modes" / "two_solves.py").write_text(TWO_SOLVES)
    (base / "metrics" / "solves_seen.road.py").write_text(
        "def read(run):\n    return float(run.record['completed'])\n")
    (base / "traffic" / "two_solves.json").write_text(json.dumps(
        {"mode": "two_solves", "pool": 2, "edge_sigma": 0.1,
         "terminal_sigma": 0.1, "warmup": {"n_irls": 1}, "check_sample": 2}))
    cfg = json.loads((base / "configs" / "mri_volume.json").read_text())
    cfg.update(name="tiny_road",
               graph={"generator": "road_like", "args": {"side": 10}},
               terminals={"generator": "flow_improve_instance", "args": {}},
               partition=None,
               solver=dict(cfg["solver"], precond="jacobi", n_blocks=1,
                           layout="coo", fuse_edge_sweep=False, n_irls=10))
    (base / "configs" / "tiny_road.json").write_text(json.dumps(cfg))
    return "tiny_road", "two_solves", "solves_seen.road", "solves"


@pytest.mark.parametrize("make", [_new_grid_cell, _new_road_cell],
                         ids=["grid", "road_mode"])
def test_a_metric_added_as_a_file_is_found_without_an_edit(bench, tmp_path,
                                                           make):
    """A new metric, traffic mix, configuration and (road_mode) mode and
    graph family: new files and new manifest entries, and no file of the
    benchmark edited."""
    base = tmp_path / "cutbench"
    for sub in ("configs", "traffic", "metrics", "modes"):
        shutil.copytree(harness.HERE / sub, base / sub)
    before = {p: p.read_bytes() for p in base.rglob("*") if p.is_file()}
    config, traffic, metric, unit = make(base, bench)
    new = json.loads(json.dumps(bench))
    new["configs"].append(dict(new["configs"][1], name=config))
    new["workloads"].append({"name": "tiny_cell", "config": config,
                             "traffic": traffic, "chips": 1, "why": "a test"})
    new["end_to_end"].append({"name": metric, "unit": unit,
                              "better": "higher", "bound": 0.25,
                              "source": "host_clock",
                              "workloads": ["tiny_cell"]})
    out = harness.run_cell("tiny_cell", 5, 0.2, False, device="cpu",
                           bench=new, base=base)
    assert out["metrics"][metric]["value"] >= 2
    assert "setup_s" in out["metrics"]
    assert set(out["compared"]) >= {"frac_gap", "value_gap"}
    assert out["compared"].get("warm_chain", {"value": 0.0})["value"] == 0
    assert all(before[p] == p.read_bytes() for p in before)
