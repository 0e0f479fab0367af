"""The port's examples (``examples/torch/``) on the CPU against the JAX
package's (``examples/``).

The three solver examples run in this process at their own sizes and
seeds, each beside its twin (``runpy``, JAX on the CPU): the same lines,
timings aside, and so the same cut values to the printed 4 decimals (both
packages solve on the COO layout by default, whose sums agree here; the
ELL summation order of ROADMAP queue 3 is not on this path).
``train_lm.py`` takes one step of its 12-layer d768 model on the CPU.
"""
import contextlib
import io
import math
import pathlib
import re
import runpy

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1] / "examples"
SOLVERS = ["quickstart", "segmentation", "flow_improve_sequence"]
# a cut as each example prints it (4 decimals)
CUT = re.compile(r"(?:cut value|min-cut|cut|cut=)\s*:?\s*(-?\d+\.\d{4})\b")


def _port(name, argv):
    """stdout of ``examples/torch/<name>.py``'s ``main(argv)``."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        runpy.run_path(str(ROOT / "torch" / f"{name}.py"))["main"](argv)
    return out.getvalue()


def _reference(name):
    """stdout of ``examples/<name>.py`` run as a script."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        runpy.run_path(str(ROOT / f"{name}.py"), run_name="__main__")
    return out.getvalue()


def _untimed(text):
    """The lines with their wall times (``2.4s``, ``0.177s``) masked."""
    return re.sub(r"\d+\.\d+s\b", "<s>", text).splitlines()


@pytest.mark.parametrize("name", SOLVERS)
def test_solver_example_prints_the_references_lines(name):
    got = _port(name, ["--device", "cpu"])
    want = _reference(name)
    cuts = CUT.findall(got)
    assert cuts and cuts == CUT.findall(want), (cuts, CUT.findall(want))
    assert _untimed(got) == _untimed(want)


def test_train_lm_example_takes_a_step_on_the_cpu(tmp_path):
    got = _port("train_lm", ["--device", "cpu", "--steps", "1", "--batch",
                             "1", "--seq", "32", "--ckpt-dir",
                             str(tmp_path)])
    lines = got.splitlines()
    assert lines[0] == "model: 100.7M params", lines   # the reference's
    step = re.match(r"step\s+1\s+loss (\S+)", lines[1])
    assert step and math.isfinite(float(step.group(1))), lines
    assert lines[-1].startswith("trained to step 1 in ")
    assert (tmp_path / "journal.jsonl").exists()
