"""Small configurations of the benchmark's cells for the CPU tests."""

import copy
import json
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def _load(kind, name):
    return json.loads((REPO / "benchmark" / kind / f"{name}.json").read_text())


@pytest.fixture
def small():
    """(config, traffic) of each cell at a size a CPU test holds: the
    published parameters but fewer rows, leaves and trees."""
    out = {}
    higgs = _load("configs", "higgs")
    higgs.update(rows=6000)
    higgs["params"].update(num_leaves=15, min_sum_hessian_in_leaf=5)
    higgs["forest"].update(trees=20, num_leaves=31, sample_rows=2048)
    mslr = _load("configs", "mslr")
    mslr.update(rows=4000, features=20, queries=40)
    mslr["assumed"]["query_sizes"]["max"] = 400
    mslr["params"].update(num_leaves=15, min_sum_hessian_in_leaf=0.5)
    train = _load("traffic", "train")
    train.update(check_trees=4)
    score = _load("traffic", "score")
    score.update(rows_min=16, rows_max=2048, cycle_calls=64,
                 pool_rows=8192, check_calls=6, trace_calls=4,
                 visit_sample_rows=512)
    out["higgs.train"] = (higgs, train)
    out["mslr.train"] = (copy.deepcopy(mslr), train)
    out["higgs.score"] = (copy.deepcopy(higgs), score)
    return out
