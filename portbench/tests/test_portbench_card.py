"""On a card: each cell through ``run.py`` as the benchmark runs it, for a
short window (``python -m pytest portbench/tests -m cuda``)."""

import json
import subprocess
import sys

import pytest

from conftest import CELLS, HERE

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.parametrize("cell", CELLS)
def test_portbench_card_run(card, cell):
    proc = subprocess.run(
        [sys.executable, str(HERE / "run.py"), "--workload", cell,
         "--seed", "2147484201", "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, timeout=600, cwd=str(HERE.parent))
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["failed"] == 0
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["power_limit_w"] is not None
