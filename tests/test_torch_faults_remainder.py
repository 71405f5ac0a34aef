"""The last three fault injectors of the port (lightgbm_tpu_torch/
testing/faults.py), each with the JAX test that uses it, ported:

- ``poison_gradients``: ``nan_policy=skip_tree`` drops the poisoned
  round, retries its index and records it (JAX
  ``tests/test_fault_tolerance.py`` and ``tests/test_metrics.py``);
  the model equals the JAX package's under the same injector;
- ``fail_distributed_init``: ``initialize_with_retry`` retries through
  transient rendezvous failures and names the rendezvous when it runs
  out (JAX ``tests/test_fault_tolerance.py``);
- ``skew_features``: a skewed canary trips the lifecycle drift gate,
  which names exactly the skewed features, while the primary's
  in-distribution traffic trips nothing (JAX ``tests/test_drift.py``).
"""

import datetime

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
from lightgbm_tpu.testing import faults as jfaults

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import LightGBMError, obs
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.obs import prom, report, tracing
from lightgbm_tpu_torch.obs.drift import DriftCollector
from lightgbm_tpu_torch.serve import (Fleet, GuardrailPolicy,
                                      PromotionController)
from lightgbm_tpu_torch.serve.fleet import ModelManager
from lightgbm_tpu_torch.serve.forest import CompiledForest
from lightgbm_tpu_torch.testing import faults

from test_torch_sampling import compare
from torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
BASE = {"objective": "binary", "metric": ["binary_logloss"],
        "num_leaves": 7, "min_data_in_leaf": 5, "max_bin": 31,
        "learning_rate": 0.2, "bagging_fraction": 0.7, "bagging_freq": 1,
        "feature_fraction": 0.8, "verbose": -1}


def _data(seed=7, n=200, f=5):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, f))
    logit = 1.3 * X[:, 0] - X[:, 1] + 0.6 * X[:, 2] * X[:, 3]
    y = (logit + rng.normal(scale=0.4, size=n) > 0).astype(np.float64)
    return X, y


# ---------------------------------------------------------------------------
# poison_gradients


def test_nan_skip_tree_completes_and_records_like_jax(tmp_path):
    X, y = _data()
    params = {**BASE, "nan_policy": "skip_tree"}
    # the params reach the Dataset in both packages: the JAX Booster
    # bins its train_set with the Dataset's own params (max_bin 255 here)
    # and grows with the Booster's max_bin, the port's bins it with the
    # Booster's, as both packages' engine.train do (ROADMAP Queue C)
    bj = lgb.Booster(params=params,
                     train_set=lgb.Dataset(X, label=y, params=params))
    with jfaults.poison_gradients(bj, at_iteration=2):
        for _ in range(6):
            bj.update()
    bst = lt.Booster(params=params,
                     train_set=lt.Dataset(X, y, params=params),
                     device="cpu")
    events = tmp_path / "events.jsonl"
    rec = obs.EventRecorder(str(events))
    bst.set_event_recorder(rec)
    dropped0 = obs.get_counter("nan_iterations_dropped")
    with faults.poison_gradients(bst, at_iteration=2):
        for _ in range(6):
            bst.update()
    rec.close()
    # 6 update calls, one poisoned round dropped, its index re-trained
    assert bst.num_trees() == bj.num_trees() == 5
    assert bst.current_iteration() == 5
    assert obs.get_counter("nan_iterations_dropped") == dropped0 + 1
    recs = obs.read_events(str(events))
    hit = [e for e in recs if e.get("nan_poisoned")]
    assert hit and hit[0]["iter"] == 2
    assert hit[0]["nan_policy"] == "skip_tree"
    assert hit[0]["nan_poisoned"] == "gradients/hessians"
    assert np.isfinite(bst.predict(X)).all()
    assert compare(bst, bj, "poison_gradients") == 5
    # the injector leaves the class method in place
    assert "_gradients" not in vars(bst._booster)


def test_degenerate_objective_all_rounds_skipped():
    X, y = _data()
    bst = lt.Booster(params={**BASE, "nan_policy": "skip_tree"},
                     train_set=lt.Dataset(X, y), device="cpu")
    with faults.poison_gradients(bst, at_iteration=2, times=10 ** 6):
        for _ in range(5):
            bst.update()
    assert bst.num_trees() == 2
    assert np.isfinite(bst.predict(X)).all()


def test_obs_report_nan_incidents(tmp_path):
    X, y = _data(seed=13, n=300, f=4)
    path = str(tmp_path / "events.jsonl")
    booster = lt.Booster(params={"objective": "binary", "num_leaves": 4,
                                 "verbose": -1, "nan_policy": "skip_tree"},
                         train_set=lt.Dataset(X, y), device="cpu")
    rec = obs.EventRecorder(path)
    booster.set_event_recorder(rec)
    with faults.poison_gradients(booster, at_iteration=1):
        for _ in range(4):
            booster.update()
    rec.close()
    booster.set_event_recorder(None)
    rep = report.summarize([path])
    assert rep["incidents"]["nan"] == [
        {"iter": 1, "what": "gradients/hessians", "policy": "skip_tree"}]
    # 4 updates, one dropped and retried at the same index: 3 committed
    assert rep["iterations"] == 3
    assert "non-finite gradients/hessians" in report.render_table(rep)


# ---------------------------------------------------------------------------
# fail_distributed_init


def _dist_cfg(tmp_path, **over):
    mlist = tmp_path / "mlist.txt"
    mlist.write_text("127.0.0.1 12400\n10.255.255.1 12401\n")
    # no heartbeat: the rendezvous is a recorded no-op, there is no peer
    return Config({"task": "train", "objective": "binary",
                   "num_machines": 2, "tree_learner": "data",
                   "machine_list_file": str(mlist), "device": "cpu",
                   "distributed_init_backoff": 0.0,
                   "distributed_heartbeat_ms": 0, **over})


@pytest.fixture
def keep_threads():
    """A CPU rank takes the host's threads and names its device: both
    restored after."""
    from lightgbm_tpu_torch.parallel import multihost
    threads, device = torch.get_num_threads(), multihost.RANK_DEVICE
    yield
    torch.set_num_threads(threads)
    multihost.RANK_DEVICE = device


def test_distributed_init_retries_until_success(tmp_path, keep_threads):
    from lightgbm_tpu_torch.parallel.multihost import \
        maybe_initialize_distributed
    cfg = _dist_cfg(tmp_path, distributed_init_retries=3)
    with faults.fail_distributed_init(times=2) as stats:
        assert maybe_initialize_distributed(cfg) is True
    assert stats["failed"] == 2
    assert stats["succeeded"] == 1
    assert stats["args"][-1] == ("gloo",)
    # time_out is minutes (120 by default): the group's timeout
    assert stats["kwargs"][-1] == {
        "init_method": "tcp://127.0.0.1:12400", "rank": 0, "world_size": 2,
        "timeout": datetime.timedelta(seconds=7200)}
    assert not torch.distributed.is_initialized()


def test_distributed_init_exhaustion_diagnostic(tmp_path, keep_threads):
    from lightgbm_tpu_torch.parallel.multihost import \
        maybe_initialize_distributed
    cfg = _dist_cfg(tmp_path, distributed_init_retries=1)
    real = torch.distributed.init_process_group
    with faults.fail_distributed_init(times=10):
        with pytest.raises(LightGBMError) as ei:
            maybe_initialize_distributed(cfg)
    msg = str(ei.value)
    assert "tcp://127.0.0.1:12400" in msg
    assert "2 attempt(s)" in msg
    assert "injected coordinator connect failure" in msg
    assert torch.distributed.init_process_group is real
    with faults.fail_distributed_init(times=0) as stats:
        pass
    assert stats == {"failed": 0, "succeeded": 0, "args": [], "kwargs": []}


# ---------------------------------------------------------------------------
# skew_features


BUCKETS = [16, 64]


@pytest.fixture
def tracer(tmp_path, monkeypatch):
    path = tmp_path / "trace_events.json"
    tracing.TRACER.reset()
    monkeypatch.setenv(tracing.ENV_PATH, str(path))
    tracing.TRACER.configure()
    yield path
    tracing.TRACER.disable()
    tracing.TRACER.reset()
    tracing.TRACER.path = None


def _train_and_save(tmp_path, name, rounds=3, lr=0.1, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(800, 6))
    y = (X[:, 0] + 0.3 * X[:, 1] > 0).astype(np.float64)
    bst = lt.train({"objective": "binary", "num_leaves": 7, "verbose": -1,
                    "min_data_in_leaf": 20, "learning_rate": lr},
                   lt.Dataset(X, y), rounds, device="cpu",
                   verbose_eval=False)
    path = str(tmp_path / name)
    bst.save_model(path)
    return path


def _forest(path):
    return CompiledForest.from_booster(
        lt.Booster(model_file=path, device="cpu"), device="cpu",
        buckets=BUCKETS)


def _prom_counter(name):
    parsed = prom.parse_text(prom.render())
    vals = [v for n, labels, v in parsed["samples"]
            if n == f"lightgbm_tpu_{name}" and not labels]
    return vals[0] if vals else 0.0


def _prom_labeled(name, **want):
    parsed = prom.parse_text(prom.render())
    vals = [v for n, labels, v in parsed["samples"]
            if n == f"lightgbm_tpu_{name}" and labels == want]
    return vals[0] if vals else 0.0


def _replicas(fleet, model="primary"):
    with fleet._cond:
        rs = fleet._primary if model == "primary" else fleet._canary
        return list(rs.replicas) if rs is not None else []


def test_skewed_canary_trips_drift_gate_names_offenders(tmp_path, tracer):
    path_a = _train_and_save(tmp_path, "a.txt", rounds=3)
    path_b = _train_and_save(tmp_path, "b.txt", rounds=4, lr=0.2)
    fa, fb = _forest(path_a), _forest(path_b)
    fleet = Fleet.build(fa, devices=[CPU], canary_forest=fb,
                        canary_weight=0.5, max_batch=64, max_delay_s=0.0,
                        warm=False, watchdog_interval_s=0.0)
    col_c = DriftCollector(fb.data_fingerprint, model="canary",
                           window_s=3600.0, threshold=0.25,
                           consecutive=2, start_thread=False)
    col_p = DriftCollector(fa.data_fingerprint, model="primary",
                           window_s=3600.0, threshold=0.25,
                           consecutive=2, start_thread=False)
    manager = ModelManager(fleet, state_file=str(tmp_path / "state.json"))
    policy = GuardrailPolicy(min_samples=10_000, latency_ratio=100.0,
                             error_rate=1.0, drift_threshold=0.25,
                             drift_source=col_c.stats)
    ctrl = PromotionController(fleet, manager, policy, window_s=30.0,
                               max_window_s=60.0, cooldown_s=60.0,
                               interval_s=3600.0)
    rng = np.random.RandomState(11)

    def serve_round(n_batches=24):
        for _ in range(n_batches):
            fleet.submit(rng.normal(size=(32, 6)).astype(np.float32),
                         timeout=60.0)
    try:
        for rep in _replicas(fleet, "canary"):
            rep.forest._drift = col_c
        for rep in _replicas(fleet, "primary"):
            rep.forest._drift = col_p
        ctrl.begin(path_b, 2)
        r0 = _prom_counter("lifecycle_rollback_drift")
        o0 = _prom_labeled("lifecycle_drift_offenders_total",
                           feature="Column_3")
        with faults.skew_features(fleet, [1, 3], 6.0,
                                  model="canary") as stats:
            # two completed windows of skewed canary traffic: the gate
            # abstains on one (a noisy window never votes rollback)
            serve_round()
            assert col_c.flush() is not None
            assert col_p.flush() is not None
            ctrl.tick()
            assert ctrl.stats()["last_verdict"] is None or \
                ctrl.stats()["last_verdict"]["reason"] != "drift"
            serve_round()
            assert col_c.flush() is not None
            assert col_p.flush() is not None
            # exactly the skewed features are sustained offenders; the
            # in-distribution primary stream trips nothing
            assert col_c.sustained_offenders() == ["Column_1", "Column_3"]
            assert col_p.sustained_offenders() == []
            for w in col_p.stats()["trajectory"]:
                assert w["max_psi"] < 0.25, w
            ctrl.tick()
        assert stats["features"] == [1, 3] and stats["shift"] == 6.0
        assert sum(p["calls"] for p in stats["per_replica"]) > 0
        verdict = ctrl.stats()["last_verdict"]
        assert verdict is not None and verdict["outcome"] == "rollback"
        assert verdict["reason"] == "drift"
        gate = verdict["verdict"]["gates"]["drift"]
        assert gate["armed"] and not gate["ok"]
        assert gate["offenders"] == ["Column_1", "Column_3"]
        assert gate["max_psi"] is not None and gate["max_psi"] > 0.25
        assert not fleet.has_canary()
        assert _prom_counter("lifecycle_rollback_drift") == r0 + 1
        assert _prom_labeled("lifecycle_drift_offenders_total",
                             feature="Column_3") == o0 + 1
        gauges = obs.snapshot()["gauges"]
        key = obs.labeled_name("drift_psi", model="canary",
                               feature="Column_1")
        assert float(gauges[key]) > 0.25
        spans = [e for e in tracing.TRACER.events()
                 if e.get("name") == "Serve::verdict"]
        assert any((e.get("args") or {}).get("reason") == "drift"
                   and (e.get("args") or {}).get("drift_features")
                   == ["Column_1", "Column_3"] for e in spans), spans
    finally:
        ctrl.close()
        col_c.close()
        col_p.close()
        fleet.close()
