"""TIMETAG phase profiling (lightgbm_tpu_torch/utils/timetag.py, the
span's TIMETAG sink) and memwatch at span exits (obs/memwatch.py),
held against the JAX package on the CPU:

- the same training on both packages with TIMETAG on gives the same
  phase names and call counts, on the standard round (the JAX fused
  step) and on a custom objective's (the JAX per-stage path);
- disabled, a scope is a no-op that keeps nothing;
- the event records' ``phases`` keys equal the JAX booster's (its
  synchronous stream, ``_pipeline = False``);
- a span's ``sync`` is a counted forced sync under TIMETAG only;
- memwatch's switch resolves as JAX's; on, a ``GBDT::iteration`` span
  exit sets ``memwatch_device_bytes_in_use_gbdt_iteration`` (the
  allocator's statistics faked: no card here) and the gauge renders in
  the Prometheus text ``/metrics`` serves; off, nothing.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
from lightgbm_tpu.models.gbdt import GBDT as JaxGBDT
from lightgbm_tpu.obs import events as jevents
from lightgbm_tpu.obs import memwatch as jmemwatch
from lightgbm_tpu.utils import timetag as jtimetag

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import obs
from lightgbm_tpu_torch.obs import events, memwatch, prom
from lightgbm_tpu_torch.utils import timetag

from torch_threads import one_torch_thread  # noqa: F401

PARAMS = {"objective": "binary", "num_leaves": 7, "verbose": -1,
          "min_data_in_leaf": 20, "metric": "auc"}


@pytest.fixture
def timetag_on(monkeypatch):
    monkeypatch.setattr(JaxGBDT, "_pipeline", False)
    for mod in (timetag, jtimetag):
        mod.enable(True)
        mod.reset()
    yield
    for mod in (timetag, jtimetag):
        mod.enable(False)
        mod.reset()


def _data(n=600, f=5, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, f))
    y = (X[:, 0] + 0.3 * rng.normal(size=n) > 0).astype(np.float64)
    return X, y


def _fobj(preds, ds):
    p = 1.0 / (1.0 + np.exp(-preds))
    return p - ds.get_label(), p * (1 - p)


def _train(pkg, X, y, rounds, fobj=None, events_file=None):
    kw = {"device": "cpu"} if pkg is lt else {}
    params = dict(PARAMS)
    if events_file is not None:
        params["events_file"] = str(events_file)
    ds = pkg.Dataset(X, y)
    vs = pkg.Dataset(X[:200], y[:200], reference=ds)
    return pkg.train(params, ds, rounds, valid_sets=[vs], fobj=fobj,
                     verbose_eval=False, **kw)


@pytest.mark.parametrize("custom", [False, True],
                         ids=["standard", "custom_fobj"])
def test_phase_names_and_counts_match_jax(timetag_on, custom):
    X, y = _data()
    fobj = _fobj if custom else None
    _train(lgb, X, y, 3, fobj)
    want = dict(jtimetag._cnt)
    _train(lt, X, y, 3, fobj)
    got = timetag.get_counts()
    assert got == want
    rounds = ({"GBDT::boosting", "GBDT::tree", "GBDT::train_score"}
              if custom else {"GBDT::tree", "GBDT::bagging"})
    for phase in rounds | {"GBDT::valid_score", "GBDT::host_tree",
                           "GBDT::metric"}:
        assert got[phase] >= 3 and timetag.get_timings()[phase] >= 0.0
    # the span feeds the same account
    assert got["GBDT::iteration"] == 3
    # and the registry snapshot carries the totals, as JAX's does
    assert set(obs.snapshot()["phase_seconds"]) == set(got)
    timetag.reset()
    assert timetag.get_timings() == {} and timetag.get_counts() == {}


def test_disabled_is_a_noop():
    timetag.enable(False)
    timetag.reset()
    held = torch.zeros(3)
    with timetag.scope("x") as s:
        s.sync(held)
    assert timetag.get_timings() == {}
    assert not hasattr(s, "value")           # keeps no reference


def test_event_record_phases_keys_match_jax(timetag_on, tmp_path):
    X, y = _data(seed=5)
    _train(lgb, X, y, 3, events_file=tmp_path / "jax.jsonl")
    _train(lt, X, y, 3, events_file=tmp_path / "torch.jsonl")
    want = jevents.read_events(str(tmp_path / "jax.jsonl"))
    got = events.read_events(str(tmp_path / "torch.jsonl"))
    assert [r["iter"] for r in got] == [r["iter"] for r in want]
    for g, w in zip(got, want):
        assert set(g["phases"]) == set(w["phases"]) != set()
        assert all(v > 0 for v in g["phases"].values())


def test_event_record_phases_stay_empty_with_timetag_off(tmp_path):
    timetag.enable(False)
    X, y = _data(seed=6)
    _train(lt, X, y, 2, events_file=tmp_path / "torch.jsonl")
    got = events.read_events(str(tmp_path / "torch.jsonl"))
    assert [r["phases"] for r in got] == [{}, {}]


def test_span_sync_is_a_counted_forced_sync_under_timetag_only():
    name = "forced_syncs_t_tt_span"
    n0 = obs.get_counter("devprof_" + name)
    with obs.span("T::tt_span") as sp:
        sp.sync(torch.ones(2))
    assert obs.get_counter("devprof_" + name) == n0
    timetag.enable(True)
    try:
        with obs.span("T::tt_span") as sp:
            sp.sync(torch.ones(2))
        with timetag.scope("T::tt_span") as tt:
            tt.sync([torch.ones(2), (torch.zeros(1),)])
    finally:
        timetag.enable(False)
    assert obs.get_counter("devprof_" + name) == n0 + 2
    assert timetag.get_counts()["T::tt_span"] == 2
    timetag.reset()


# ---------------------------------------------------------------------------
# memwatch


@pytest.fixture
def memwatch_pristine(monkeypatch):
    for mod in (memwatch, jmemwatch):
        monkeypatch.delenv(mod.ENV, raising=False)
        mod.enable(False)
    yield monkeypatch
    for mod in (memwatch, jmemwatch):
        mod.enable(False)


@pytest.mark.parametrize("env,flag", [("", None), ("", "true"), ("", True),
                                      ("", "false"), ("1", False),
                                      ("0", True), ("true", None)])
def test_memwatch_configure_matches_jax(memwatch_pristine, env, flag):
    if env:
        memwatch_pristine.setenv(memwatch.ENV, env)
    assert memwatch.configure(flag) == jmemwatch.configure(flag)
    assert memwatch.ENABLED == jmemwatch.ENABLED


def _fake_card(monkeypatch, in_use):
    stats = {"allocated_bytes.all.current": in_use,
             "allocated_bytes.all.peak": 2 * in_use,
             "reserved_bytes.all.current": 4 * in_use}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda device=None:
                        dict(stats))


def test_memwatch_samples_at_span_exit_into_the_scrape(memwatch_pristine):
    memwatch_pristine.setenv(memwatch.ENV, "1")
    assert memwatch.configure(None) is True
    _fake_card(memwatch_pristine, 123456)
    with obs.span("GBDT::iteration"):
        pass                                  # the exit samples
    assert obs.get_gauge("memwatch_device_bytes_in_use_gbdt_iteration") \
        == 123456
    assert obs.get_gauge("memwatch_device_peak_bytes") == 246912
    text = prom.render()
    assert "lightgbm_tpu_memwatch_device_bytes_in_use_gbdt_iteration " \
        "123456" in text
    prom.parse_text(text)                     # stays format-valid


def test_memwatch_off_samples_nothing(memwatch_pristine):
    _fake_card(memwatch_pristine, 777)
    assert memwatch.configure(None) is False
    before = obs.get_gauge("memwatch_device_bytes_in_use_t_mw_off")
    with obs.span("T::mw_off"):
        pass
    assert before is None
    assert obs.get_gauge("memwatch_device_bytes_in_use_t_mw_off") is None


def test_train_configures_memwatch_each_run(memwatch_pristine):
    X, y = _data(300, seed=7)
    lt.train({**PARAMS, "memwatch": True}, lt.Dataset(X, y), 1,
             device="cpu", verbose_eval=False)
    assert memwatch.ENABLED is True
    lt.train(PARAMS, lt.Dataset(X, y), 1, device="cpu", verbose_eval=False)
    assert memwatch.ENABLED is False
