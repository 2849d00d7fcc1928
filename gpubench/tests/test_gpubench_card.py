"""The harness on the card: each cell's whole run at a small size through
the program's CUDA kernels, `correct` true; and one run of the command as
the benchmark is run, at full size.  Marked `cuda`: run with
`python -m pytest gpubench/tests -m cuda` on a machine with an NVIDIA
card; elsewhere they skip."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from gpubench import run

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SMALL = {"object_bytes": 3 << 20, "generator_params": {"side": 512}}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_small_run_on_the_card_is_correct(card, name, traced):
    result, info = run.run_cell(run.Cell.load(name, config=SMALL), 2**32 + 17, 1.0, traced, card, t0=0.0)
    assert result["correct"] is True and result["failed"] == 0, (result["checks"], info["errors"])
    assert result["device"]["platform"] == "gpu" and result["device"]["memory_peak_bytes"] > 0
    if traced:
        assert result["device"]["busy_s"] > 0
        assert 0 < result["metrics"]["kernels_roofline"]["value"] <= 100


@pytest.mark.cuda
def test_the_command_prints_one_result_line(card):
    res = subprocess.run([sys.executable, "gpubench/run.py", "--workload", CELLS[0], "--seed", str(2**31 + 3),
                          "--seconds", "2", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["count"] == 1
    assert res.stderr.strip().splitlines()[-1].startswith("check ")
