"""The port's device trace window (lightgbm_tpu_torch/obs/trace.py) on
``torch.profiler``, on the CPU: the counterparts of the JAX package's
``tests/test_obs.py`` trace tests.

- a CPU training run with ``trace_dir``, ``trace_start_iter=0`` and
  ``trace_num_iters=1`` writes one Chrome-trace JSON under ``trace_dir``;
  it parses and holds the growers' ``hist`` / ``find_split`` / ``split``
  ranges (for each ``serial_grow``), and the model text is byte-equal with and
  without the window;
- the window counts from where it actually started, and ``close`` is
  idempotent and writes a window the run ended inside;
- ``LIGHTGBM_TPU_TRACE_DIR`` wins over ``trace_dir``; no key gives None,
  as JAX's ``from_config``;
- outside a window the device ranges are one shared null context.
"""

import json
import os

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
from lightgbm_tpu import obs as jobs

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import obs
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.obs import trace

from torch_threads import one_torch_thread  # noqa: F401

PARAMS = {"objective": "binary", "num_leaves": 4, "verbose": -1,
          "min_data_in_leaf": 10}


def _data(n=200, f=3, seed=5):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, f))
    return X, (X[:, 0] > 0).astype(np.float64)


def _files(d):
    return sorted(os.path.join(r, f) for r, _, fs in os.walk(d) for f in fs)


@pytest.mark.parametrize("grower", ["ordered", "cached", "fused"])
def test_window_writes_one_chrome_trace_with_the_phase_ranges(tmp_path,
                                                              grower):
    X, y = _data()
    params = {**PARAMS, "serial_grow": grower}
    bare = lt.train(params, lt.Dataset(X, y), 2, device="cpu",
                    verbose_eval=False)
    trace_dir = tmp_path / "trace"
    traced = lt.train({**params, "trace_dir": str(trace_dir),
                       "trace_start_iter": 0, "trace_num_iters": 1},
                      lt.Dataset(X, y), 2, device="cpu", verbose_eval=False)
    assert traced.model_to_string() == bare.model_to_string()
    files = _files(trace_dir)
    assert [os.path.basename(f) for f in files] == ["trace_iter0.json"]
    with open(files[0]) as fh:
        doc = json.load(fh)
    names = {e.get("name") for e in doc["traceEvents"]}
    assert {"hist", "find_split", "split"} <= names
    assert trace.RECORDING == 0


def test_window_counts_from_actual_start(tmp_path, monkeypatch):
    calls = []

    class FakeProfile:
        def __init__(self, activities):
            calls.append(("activities", len(activities)))

        def start(self):
            calls.append("start")

        def stop(self):
            calls.append("stop")

        def export_chrome_trace(self, path):
            calls.append(os.path.basename(path))

    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    tc = obs.TraceCapture(str(tmp_path), start_iter=5, num_iters=2)
    tc.iter_begin(3)
    assert calls == []
    tc.iter_begin(20)                   # resume point past start_iter
    assert calls == [("activities", 1), "start"]
    assert trace.RECORDING == 1
    tc.iter_end(20, sync=torch.zeros(2))   # 1 iteration inside: open
    assert calls[-1] == "start"
    tc.iter_end(21)                     # 2 iterations inside: written
    assert calls[-2:] == ["stop", "trace_iter20.json"]
    assert trace.RECORDING == 0
    tc.close()                          # idempotent
    tc.iter_begin(30)                   # one-shot
    assert calls.count("start") == 1


def test_close_writes_a_window_the_run_ended_inside(tmp_path):
    X, y = _data(seed=6)
    trace_dir = tmp_path / "t"
    lt.train({**PARAMS, "trace_dir": str(trace_dir), "trace_start_iter": 1,
              "trace_num_iters": 5}, lt.Dataset(X, y), 2, device="cpu",
             verbose_eval=False)
    assert [os.path.basename(f) for f in _files(trace_dir)] == \
        ["trace_iter1.json"]
    assert trace.RECORDING == 0


def test_env_var_wins_and_no_key_gives_none(tmp_path, monkeypatch):
    env_dir = str(tmp_path / "envtrace")
    monkeypatch.setenv("LIGHTGBM_TPU_TRACE_DIR", env_dir)
    keys = {"trace_dir": "/ignored", "trace_start_iter": 1,
            "trace_num_iters": 3}
    tc = obs.TraceCapture.from_config(Config(keys))
    jtc = jobs.TraceCapture.from_config(lgb.Config(keys))
    for t in (tc, jtc):
        assert t.trace_dir == env_dir
        assert t.start_iter == 1 and t.num_iters == 3
    monkeypatch.delenv("LIGHTGBM_TPU_TRACE_DIR")
    assert obs.TraceCapture.from_config(Config({})) is None
    assert jobs.TraceCapture.from_config(lgb.Config({})) is None
    assert obs.TraceCapture.from_config(None) is None
    defaults = obs.TraceCapture.from_config(Config({"trace_dir": "d"}))
    jdefaults = jobs.TraceCapture.from_config(lgb.Config({"trace_dir": "d"}))
    assert (defaults.start_iter, defaults.num_iters) == \
        (jdefaults.start_iter, jdefaults.num_iters) == (5, 2)


def test_ranges_are_free_outside_a_window():
    assert trace.RECORDING == 0
    assert trace.device_range("hist") is trace.device_range("split")
    with trace.device_range("hist"):
        pass
