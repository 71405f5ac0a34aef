"""One short run of each cell on the card through ``run.py``: exit 0,
``correct`` true, the result line's keys and the cell's metrics.  Skips on
a host without a CUDA card (decided inside the test)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["mslr.train", "higgs.score"])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_on_the_card(cell, trace):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "2147483659", "--seconds", "5", "--trace", str(trace)],
        capture_output=True, text=True, timeout=1200, cwd=str(REPO))
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert list(res)[-1] == "checks"
    assert res["device"]["platform"] == "gpu" and res["metrics"]
    if trace:
        assert res["device"]["busy_s"] > 0
