"""On a machine with a card: one short run of each cell through the
command that runs a cell, correct on a fresh seed."""

import json
import subprocess
import sys

import pytest

from glmbench import spec

pytestmark = pytest.mark.gpu
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card_is_correct(card, cell):
    proc = subprocess.run(
        [sys.executable, "glmbench/run.py", "--workload", cell, "--seed", "2147483651",
         "--seconds", "3", "--trace", "0"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
