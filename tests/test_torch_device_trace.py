"""The port's device trace window (lightgbm_tpu_torch/obs/trace.py) on
``torch.profiler``, on the CPU: the counterparts of the JAX package's
``tests/test_obs.py`` trace tests, and the port's phase ranges and
window account.

- a CPU training run with ``trace_dir``, ``trace_start_iter=0`` and
  ``trace_num_iters=1`` writes one Chrome-trace JSON under ``trace_dir``;
  it parses and holds the growers' ``hist`` / ``find_split`` / ``split``
  ranges (for each ``serial_grow``), and the model text is byte-equal with and
  without the window;
- both round shapes (the fused standard round and a custom objective's)
  record the gradient, mask, grower, host-tree and score-update ranges,
  and the model text stays byte-equal;
- a plain ``torch.profiler`` around ``Booster.predict`` records the
  scoring call's ranges, and the predictions do not change;
- the window counts from where it actually started, and ``close`` is
  idempotent and writes a window the run ended inside;
- the window's account: the attribution function on a hand-written
  event list (correlation, not overlap; the innermost range;
  ``unranged``; copies), and a CPU window's iteration count and host
  seconds in the registry;
- ``LIGHTGBM_TPU_TRACE_DIR`` wins over ``trace_dir``; no key gives None,
  as JAX's ``from_config``;
- with no profiler recording the device ranges are one shared null
  context, and ``recording()`` follows a profiler of this thread.
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
    assert not trace.recording()


def test_window_counts_from_actual_start(tmp_path, monkeypatch):
    calls = []
    real_profile = torch.profiler.profile

    class FakeProfile:
        """Records the window's calls around a real CPU profiler, so
        ``recording()`` sees it; its export is an empty trace."""

        def __init__(self, activities):
            calls.append(("activities", len(activities)))
            self._real = real_profile(
                activities=[torch.profiler.ProfilerActivity.CPU])

        def start(self):
            calls.append("start")
            self._real.start()

        def stop(self):
            calls.append("stop")
            self._real.stop()

        def export_chrome_trace(self, path):
            calls.append(os.path.basename(path))
            with open(path, "w") as fh:
                json.dump({"traceEvents": []}, fh)

    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    tc = obs.TraceCapture(str(tmp_path), start_iter=5, num_iters=2)
    tc.iter_begin(3)
    assert calls == []
    assert not trace.recording()
    tc.iter_begin(20)                   # resume point past start_iter
    assert calls == [("activities", 1), "start"]
    assert trace.recording()
    tc.iter_end(20, sync=torch.zeros(2))   # 1 iteration inside: open
    assert calls[-1] == "start"
    tc.iter_begin(21)
    tc.iter_end(21)                     # 2 iterations inside: written
    assert calls[-2:] == ["stop", "trace_iter20.json"]
    assert not trace.recording()
    assert tc.account == {}
    assert obs.get_gauge("trace_window_iterations") == 2
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
    assert not trace.recording()


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
    assert not trace.recording()
    assert trace.device_range("hist") is trace.device_range("split")
    with trace.device_range("hist"):
        pass
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    try:
        assert trace.recording()
        assert trace.device_range("hist") is not trace.device_range("split")
    finally:
        prof.stop()
    assert not trace.recording()
    assert trace.device_range("hist") is trace.device_range("split")


def _range_names(path):
    with open(path) as fh:
        return {e["name"] for e in json.load(fh)["traceEvents"]
                if e.get("cat") == "user_annotation"}


def _fobj(preds, ds):
    p = 1.0 / (1.0 + np.exp(-preds))
    return p - ds.get_label(), p * (1 - p)


ROUND_RANGES = {"GBDT::iteration", "GBDT::boosting", "GBDT::bagging",
                "hist", "find_split", "split", "GBDT::host_tree",
                "GBDT::train_score"}


@pytest.mark.parametrize("custom", [False, True],
                         ids=["fused", "custom_fobj"])
def test_both_round_shapes_record_every_round_range(tmp_path, custom):
    X, y = _data(n=400, seed=8)
    params = {**PARAMS, "bagging_fraction": 0.8, "bagging_freq": 1,
              "feature_fraction": 0.8}
    fobj = _fobj if custom else None
    bare = lt.train(params, lt.Dataset(X, y), 3, fobj=fobj, device="cpu",
                    verbose_eval=False)
    trace_dir = tmp_path / "t"
    traced = lt.train({**params, "trace_dir": str(trace_dir),
                       "trace_start_iter": 1, "trace_num_iters": 2},
                      lt.Dataset(X, y), 3, fobj=fobj, device="cpu",
                      verbose_eval=False)
    assert traced.model_to_string() == bare.model_to_string()
    names = _range_names(_files(trace_dir)[0])
    assert ROUND_RANGES <= names
    assert ("GBDT::tree" in names) and names <= (
        obs.HOST_PHASES | obs.DEVICE_PHASES)


def test_a_plain_profiler_sees_the_scoring_ranges(tmp_path):
    X, y = _data(n=300, seed=9)
    b = lt.train(PARAMS, lt.Dataset(X, y), 3, device="cpu",
                 verbose_eval=False)
    bare = b.predict(X)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        traced = b.predict(X)
    np.testing.assert_array_equal(traced, bare)
    path = str(tmp_path / "score.json")
    prof.export_chrome_trace(path)
    assert {"Predict::forest", "bin_lookup", "forest_walk",
            "transform"} <= _range_names(path)


def _ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_window_account_ties_device_events_by_correlation():
    events = [
        _ev("user_annotation", "GBDT::tree", 0, 1000),
        _ev("user_annotation", "find_split", 100, 200),
        _ev("user_annotation", "split", 400, 100),
        _ev("user_annotation", "not_a_phase", 410, 20),
        _ev("cpu_op", "aten::mul", 120, 30),
        # launches: inside find_split (under an aten op), inside split
        # (under a foreign range), inside GBDT::tree only, outside all
        # ranges, and one on another thread inside find_split's time
        _ev("cuda_runtime", "cudaLaunchKernel", 130, 5, corr=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 415, 5, corr=2),
        _ev("cuda_runtime", "cudaMemcpyAsync", 700, 5, corr=3),
        _ev("cuda_runtime", "cudaLaunchKernel", 1500, 5, corr=4),
        _ev("cuda_runtime", "cudaLaunchKernel", 150, 5, tid=2, corr=5),
        # device events run later, inside other ranges' time: overlap
        # in time would charge them wrongly
        _ev("kernel", "scan", 450, 40, tid=7, corr=1),
        _ev("kernel", "gather", 2000, 10, tid=7, corr=2),
        _ev("gpu_memcpy", "Memcpy DtoH", 150, 6, tid=7, corr=3),
        _ev("gpu_memset", "Memset", 1600, 2, tid=7, corr=4),
        _ev("kernel", "other_thread", 160, 3, tid=7, corr=5),
        _ev("kernel", "launched_before_the_window", 5, 4, tid=7, corr=99),
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 1},
    ]
    acct = trace.window_account(events)
    assert set(acct) == {"GBDT::tree", "find_split", "split", "unranged"}
    assert acct["find_split"]["device_s"] == pytest.approx(40e-6)
    assert acct["split"]["device_s"] == pytest.approx(10e-6)
    assert acct["GBDT::tree"]["device_s"] == pytest.approx(6e-6)
    assert acct["unranged"]["device_s"] == pytest.approx(9e-6)
    assert {k: a["launches"] for k, a in acct.items()} == {
        "GBDT::tree": 1, "find_split": 1, "split": 1, "unranged": 3}
    assert acct["GBDT::tree"]["host_s"] == pytest.approx(1000e-6)
    assert acct["find_split"]["host_s"] == pytest.approx(200e-6)
    assert acct["unranged"]["host_s"] == 0.0
    assert trace.window_account([]) == {}


def test_a_cpu_window_sets_its_iterations_and_host_seconds(tmp_path):
    X, y = _data(seed=10)
    obs.reset()
    lt.train({**PARAMS, "trace_dir": str(tmp_path / "t"),
              "trace_start_iter": 1, "trace_num_iters": 3},
             lt.Dataset(X, y), 5, device="cpu", verbose_eval=False)
    g = obs.snapshot()["gauges"]
    assert g["trace_window_iterations"] == 3
    for phase in ("gbdt_iteration", "gbdt_tree", "hist", "find_split",
                  "split", "gbdt_host_tree"):
        assert g["trace_window_host_seconds_" + phase] > 0.0
        # the CPU records no device events
        assert g["trace_window_device_seconds_" + phase] == 0.0
        assert g["trace_window_launches_" + phase] == 0
    # three whole rounds: each round's phases lie inside its range
    assert g["trace_window_host_seconds_gbdt_iteration"] >= \
        g["trace_window_host_seconds_gbdt_tree"]
    assert g["trace_window_account_seconds"] > 0.0
    assert "trace_window_device_seconds_unranged" not in g
