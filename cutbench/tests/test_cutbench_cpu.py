"""Each cell at a tiny size on the CPU: the port agrees with the plain
reference, the control (the reference in bfloat16 in the program's place)
fails the comparison, and ``run.py`` refuses to run without a card."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(Path(__file__).parent)]

from test_cutbench_faults import run  # noqa: E402


@pytest.mark.parametrize("workload", ["volume_solve", "liver_serve"])
def test_port_agrees_and_the_bfloat16_control_fails(workload):
    out = run(workload, control="bfloat16")
    assert out["correct"] is True, out["compared"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    limits = {k: c["limit"] for k, c in out["compared"].items()}
    assert any(v > limits[k] for k, v in out["control"].items()), out["control"]


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal without one")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "cutbench" / "run.py"), "--workload",
         "volume_solve", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=""))
    assert proc.returncode != 0
    last = (proc.stdout.strip().splitlines() or [""])[-1]
    with pytest.raises(ValueError):
        json.loads(last)
    assert "no CUDA device" in proc.stderr


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["volume_solve", "liver_serve"])
def test_cell_on_the_card_at_a_small_size(card, workload):
    from cutbench import harness

    from test_cutbench_faults import tiny

    out = harness.run_cell(workload, 11, 0.5, True, device=card,
                           config_override=tiny(workload))
    assert out["correct"] is True, out["compared"]
    assert out["device"]["platform"] == "gpu"
    assert out["device"]["busy_s"] > 0
