"""Each cell's correctness check at a small size on the CPU: the program
comes out correct under the cell's limits; the control (the plain
reference one precision below the configuration's, in the program's
place) and every fault a cell can have (``faults.py``) come out not
correct.  The look for a card is skipped: the runners run on the CPU."""

import time

import pytest

import lightgbm_tpu_torch as lt
from benchmark import faults, harness
from benchmark.runners import score as dscore
from benchmark.runners import train as dtrain

CASES = [(cell, mode) for cell in ("higgs.train", "mslr.train")
         for mode in ("program", "control") + faults.TRAIN] \
    + [("higgs.score", mode) for mode in ("program", "control") + faults.SCORE]


@pytest.mark.parametrize("cell,mode", CASES)
def test_check_tells_sound_runs_from_unsound_ones(small, cell, mode):
    cfg, traffic = small[cell]
    setup = harness.Setup(time.perf_counter())
    kw = {}
    if traffic["runner"] == "train":
        drv = dtrain
        if mode == "control":
            kw["make_trainer"] = dtrain.ControlTrainer
        elif mode != "program":
            kw["make_trainer"] = faults.trainer(mode, lt)
    else:
        drv = dscore
        if mode == "control":
            kw["make_scorer"] = dscore.ControlScorer
        elif mode != "program":
            kw["make_scorer"] = faults.scorer(mode, lt, setup)
    res = drv.run(lt, {"name": cell}, cfg, traffic, 2**31 + 17, 0.3, False,
                  "cpu", setup, **kw)
    correct, checks = harness.verdict(res["numbers"], harness.load_limits(cell))
    assert correct == (mode == "program"), checks
