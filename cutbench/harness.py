"""The benchmark's harness: one cell of ``BENCHMARK.json``, run once.

Everything a cell needs is found by name: the cell's configuration in
``cutbench/configs/<config>.json``, its traffic mix in
``cutbench/traffic/<traffic>.json``, the mode that drives the mix in
``cutbench/modes/<mode>.py`` (see ``drive``) and each metric in
``cutbench/metrics/<metric>.py``, whose ``read(run)`` returns the value or
None when the run holds nothing for it to read.  A metric may name a
function of the program as ``SPAN = "module:function"``; in a traced run
the harness marks that function's calls (``tracing.Spans``) and the reader
finds its span by ``run.span(SPAN)``.
"""
from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that must not be loaded in the process that
# prints the result: JAX, and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def find_cell(bench: dict, workload: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == workload:
            return cell
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json; known: "
                   f"{[c['name'] for c in bench['workloads']]}")


def config_of(cell: dict, base: Path = HERE) -> dict:
    return load_json(base / "configs" / f"{cell['config']}.json")


def traffic_of(cell: dict, base: Path = HERE) -> dict:
    return load_json(base / "traffic" / f"{cell['traffic']}.json")


def metric_module(name: str, base: Path = HERE) -> ModuleType:
    """The reader of metric ``name``: ``<base>/metrics/<name>.py``."""
    path = base / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"cutbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(bench: dict, workload: str, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics (``trace`` false) or its per-layer
    metrics (true): those naming the cell, and those naming no cells."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key]
            if workload in m.get("workloads", [workload])]


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


class Run:
    """What a metric's reader sees: the cell, its configuration and mix,
    the window's record (``record``), the set-up seconds and, in a traced
    run, the trace (``trace``, a ``tracing.TraceSummary``)."""

    def __init__(self, cell, config, traffic, record, setup_s, trace=None,
                 spans=None):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.record, self.setup_s, self.trace = record, setup_s, trace
        self._spans = spans

    def span(self, target: str) -> Optional[float]:
        """Device seconds inside the marked calls of ``target``."""
        if self.trace is None or self._spans is None:
            return None
        return self.trace.span_seconds(self._spans.targets.index(target))


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: Optional[float] = None,
             config_override: Optional[dict] = None,
             traffic_override: Optional[dict] = None,
             control: Optional[str] = None, bench: Optional[dict] = None,
             base: Path = HERE) -> dict:
    """One run of a cell; returns the result object that ``main`` prints.
    ``config_override`` and ``traffic_override`` replace keys of the
    configuration and the mix (the tests' small sizes); ``control``
    ("bfloat16") judges the reference computed in that dtype in the
    program's place, beside the program (the calibration of the limits,
    never a benchmark run).  ``bench`` and ``base`` (the folder holding
    ``configs``, ``traffic``, ``modes`` and ``metrics``) default to the
    checkout's."""
    import torch

    from . import drive, judge, tracing

    t_start = time.perf_counter() if t_start is None else t_start
    bench = manifest() if bench is None else bench
    cell = find_cell(bench, workload)
    config = dict(config_of(cell, base), **(config_override or {}))
    traffic = dict(traffic_of(cell, base), **(traffic_override or {}))
    readers = {m["name"]: metric_module(m["name"], base)
               for m in metrics_of(bench, workload, trace)}
    mode = drive.load_mode(traffic["mode"], base).Mode(config, traffic, seed,
                                                       device)
    targets = sorted({r.SPAN for r in readers.values()
                      if getattr(r, "SPAN", None)})
    spans = tracing.Spans(targets, device) if trace and targets else None
    setup_s = time.perf_counter() - t_start
    with tracing.profiled(trace) as prof:
        if spans is not None:
            with spans:
                record = mode.window(seconds)
        else:
            record = mode.window(seconds)
    if spans is not None:
        record["marker_adds"] = spans.closes
    items = mode.sample()
    checks = mode.checks()
    labels, src, dst = mode.labels, mode.src, mode.dst
    mode.close()
    del mode
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    run = Run(cell, config, traffic, record, setup_s, prof.summary, spans)
    metrics = {}
    for m in metrics_of(bench, workload, trace):
        value = readers[m["name"]].read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    t_ref = time.perf_counter()
    refs = judge.reference_answers(config, src, dst, items, labels=labels,
                                   device=device)
    got = judge.readings(src, dst, [it["weights"] for it in items], items,
                         refs, device, config)
    ok, compared = judge.verdict(got, config["check"]["limits"], checks)
    print(f"cutbench: set-up {setup_s:.3f} s, window {record['wall_s']:.3f} s"
          f", reference {time.perf_counter() - t_ref:.3f} s for "
          f"{len(items)} answers", file=sys.stderr)
    out = {"correct": bool(ok and record["failed"] == 0),
           "attempted": int(record["attempted"]),
           "failed": int(record["failed"]), "metrics": metrics}
    if control is not None:
        ctl = judge.control_answers(config, src, dst, items, labels,
                                    getattr(torch, control), device)
        if judge.following(config):
            # the float64 reference along the control's own step counts
            refs = judge.reference_answers(
                config, src, dst,
                [dict(it, pcg_iters=c["pcg_iters"]) for it, c in zip(items, ctl)],
                labels=labels, device=device)
        out["control"] = judge.readings(src, dst,
                                        [it["weights"] for it in items], ctl,
                                        refs, device, config)
    out["device"] = device_info(device, record)
    if trace and prof.summary is not None:
        t = prof.summary
        out["device"].update(busy_s=t.busy_s, window_s=record["wall_s"])
        out["breakdown"] = {"device_ops": t.top_device_ops(),
                            "idle_gaps": t.idle_gaps()}
    out["compared"] = compared
    return out


def device_info(device, record: dict) -> dict:
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": dev.type, "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1, "memory_peak_bytes": int(record["peak_bytes"])}


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json "
                                 "on one NVIDIA card and print its result "
                                 "as the last line of standard output.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = manifest()
    cell = find_cell(bench, args.workload)

    import torch

    if not torch.cuda.is_available():
        print("cutbench: no CUDA device; the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"cutbench: {cell['chips']} cards needed, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   device="cuda", t_start=t_start, bench=bench)
    loaded = forbidden_modules()
    if loaded:
        print(f"cutbench: the run loaded {loaded}: the benchmark measures "
              f"the PyTorch port alone", file=sys.stderr)
        return 3
    for name, c in out["compared"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
