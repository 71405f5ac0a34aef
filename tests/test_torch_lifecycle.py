"""The guarded model lifecycle (lightgbm_tpu_torch/serve/lifecycle.py)
and the registry's Prometheus text (obs/prom.py) against the JAX
package, on the CPU.

The same registry contents give the same ``GuardrailPolicy.evaluate``
verdicts and reasons; the same labels give the same ``FeedbackTracker``
logloss and AUC (1e-12); the same scripted windows, on stub fleets with
an injected clock, give the same ``PromotionController`` outcomes
(promote, rollback, extend, the doubling cooldown); the shadow sampler
keeps and drops the same batches; ``prom.render`` writes the same bytes
for the same snapshot.  Then over HTTP with real forests: a good canary
is promoted, a canary skewed by ``skew_predictions`` and fed labels
through ``/feedback`` is rolled back with its reason named, and shadow
scoring fails no primary request.
"""

import time
import types

import numpy as np
import pytest

from lightgbm_tpu import obs as jobs
from lightgbm_tpu import serve as jserve
from lightgbm_tpu.obs import prom as jprom
from lightgbm_tpu.serve import lifecycle as jlife

from lightgbm_tpu_torch import obs, serve
from lightgbm_tpu_torch.obs import prom
from lightgbm_tpu_torch.serve import lifecycle
from lightgbm_tpu_torch.serve.server import serve_from_config
from lightgbm_tpu_torch.testing import faults

from test_torch_fleet import (StubForest, base_url, get, post, serve_config,
                              stub_fleet, train_and_save)

pytestmark = pytest.mark.torch

PACKAGES = ((jobs, jlife), (obs, lifecycle))


def _feed(reg, model, requests=0, errors=0, ejections=0, latencies=()):
    reg.inc(reg.labeled_name("serve_requests", model=model), requests)
    reg.inc(reg.labeled_name("serve_request_errors_total", model=model),
            errors)
    reg.inc(reg.labeled_name("serve_ejections_total", model=model),
            ejections)
    for v in latencies:
        reg.observe(reg.labeled_name("serve_latency_seconds", model=model),
                    float(v))


def _lat(rng, n, scale):
    return rng.gamma(2.0, scale, size=n)


SCENARIOS = {
    "insufficient": dict(canary=10, c_scale=0.002),
    "pass": dict(canary=60, c_scale=0.002),
    "latency": dict(canary=60, c_scale=0.05),
    "errors": dict(canary=60, c_scale=0.002, errors=9, ejections=1),
    "quality": dict(canary=60, c_scale=0.002, quality=True),
    "drift": dict(canary=60, c_scale=0.002, drift=True),
}


def _verdict(reg, life, name):
    sc = SCENARIOS[name]
    rng = np.random.RandomState(7)
    reg.reset()
    _feed(reg, "primary", 40, latencies=_lat(rng, 40, 0.002))
    _feed(reg, "canary", 5, errors=3, latencies=_lat(rng, 5, 0.5))
    drift = {"windows": 3, "sustained": {"offenders": ["f_1", "f_4"]},
             "last": {"score_psi": 0.125,
                      "top": [{"feature": "f_1", "psi": 0.9},
                              {"feature": "f_4", "psi": 0.4}]}}
    policy = life.GuardrailPolicy(
        min_samples=50, latency_ratio=3.0, error_rate=0.05,
        drift_threshold=0.25 if sc.get("drift") else 0.0,
        drift_source=(lambda: drift) if sc.get("drift") else None)
    base = policy.snapshot()
    _feed(reg, "primary", 80, latencies=_lat(rng, 80, 0.002))
    _feed(reg, "canary", sc["canary"], errors=sc.get("errors", 0),
          ejections=sc.get("ejections", 0),
          latencies=_lat(rng, sc["canary"], sc["c_scale"]))
    quality = None
    if sc.get("quality"):
        fb = life.FeedbackTracker()
        y = (rng.rand(200) < 0.5).astype(float)
        for i in range(200):
            model = "canary" if i % 2 else "primary"
            good = 0.8 * y[i] + 0.1
            fb.note(i, model, good if model == "primary" else 1.0 - good)
            fb.feedback(i, y[i])
        quality = fb.quality()
    return policy.evaluate(base, quality)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_guardrail_verdicts_match_jax(name):
    want = _verdict(jobs, jlife, name)
    got = _verdict(obs, lifecycle, name)
    assert got == want
    expect = {"insufficient": ("insufficient", None), "pass": ("pass", None),
              "latency": ("fail", "latency_ratio"),
              "errors": ("fail", "error_rate"),
              "quality": ("fail", "quality"), "drift": ("fail", "drift")}
    assert (got["decision"], got["reason"]) == expect[name]


def test_feedback_tracker_matches_jax():
    rng = np.random.RandomState(3)
    scores = np.round(rng.rand(900), 2)              # ties for the AUC
    labels = (rng.rand(900) < scores).astype(float)
    out = []
    for reg, life in PACKAGES:
        reg.reset()
        fb = life.FeedbackTracker(pending_cap=500, rolling_cap=300)
        known = []
        for i in range(900):
            fb.note(i, ("primary", "canary")[i % 3 == 0], scores[i])
        for i in range(0, 900, 2):
            known.append(fb.feedback(i, labels[i]))
        assert fb.feedback(10 ** 6, 1.0) is False
        gauges = {k: v for k, v in reg.snapshot()["gauges"].items()
                  if k.startswith("lifecycle_")}
        out.append((known, fb.quality(), gauges))
    (kj, qj, gj), (kt, qt, gt) = out
    assert kt == kj and gt == gj and qt.keys() == qj.keys()
    for model in qj:
        assert qt[model]["n"] == qj[model]["n"]
        for key in ("logloss", "auc"):
            assert abs(qt[model][key] - qj[model][key]) <= 1e-12


def _controller_script(pkg, reg, life, tmp_path, monkeypatch):
    """promote; rollback (error_rate); a reload inside the cooldown
    (rolled straight back, cooldown doubled); extend, then rollback for
    insufficient samples (cooldown doubled again)."""
    clock = types.SimpleNamespace(t=5000.0)
    monkeypatch.setattr(life, "time", types.SimpleNamespace(
        monotonic=lambda: clock.t, time=time.time))
    reg.reset()
    fleet = stub_fleet(pkg, [0.0], canary_times=[0.0], canary_weight=0.25)
    manager = pkg.ModelManager(fleet, state_file=str(
        tmp_path / f"{pkg.__name__}.json"))
    ctl = life.PromotionController(
        fleet, manager, life.GuardrailPolicy(min_samples=20),
        window_s=10.0, max_window_s=25.0, cooldown_s=60.0,
        interval_s=3600.0)
    trail = []

    def record(tag):
        st = ctl.stats()
        v = st["last_verdict"] or {}
        trail.append((tag, st["phase"], st["candidate"],
                      st["consecutive_rollbacks"], st["extensions"],
                      st["cooldown_remaining_s"], v.get("outcome"),
                      v.get("reason"), v.get("cooldown_s"),
                      fleet.generation, fleet.has_canary()))

    def new_canary(name):
        rs = fleet.promote(StubForest(value=3.0), target="canary",
                           model_path=name)
        ctl.begin(name, rs.generation)

    try:
        ctl.begin("c1.txt", 2)
        _feed(reg, "primary", 30, latencies=[0.002] * 30)
        _feed(reg, "canary", 30, latencies=[0.002] * 30)
        ctl.tick()
        record("in window")
        clock.t += 11.0
        ctl.tick()
        record("promote")
        new_canary("c2.txt")
        _feed(reg, "canary", 30, errors=6, latencies=[0.002] * 30)
        ctl.tick()
        record("rollback")
        new_canary("c3.txt")
        record("cooldown")
        clock.t += 200.0
        new_canary("c4.txt")
        clock.t += 11.0
        ctl.tick()
        record("extend")
        clock.t += 20.0
        ctl.tick()
        record("insufficient")
    finally:
        ctl.close()
        fleet.close()
    return trail


def test_promotion_controller_outcomes_match_jax(tmp_path, monkeypatch):
    want = _controller_script(jserve, jobs, jlife, tmp_path, monkeypatch)
    got = _controller_script(serve, obs, lifecycle, tmp_path, monkeypatch)
    assert got == want
    outcomes = [(t[0], t[6], t[7], t[8]) for t in got]
    assert outcomes[1][1:] == ("promote", None, None)
    assert outcomes[2][1:] == ("rollback", "error_rate", 60.0)
    assert outcomes[3][1:] == ("rollback", "cooldown", 120.0)
    assert got[4][4] == 1                               # one extension
    assert outcomes[5][1:] == ("rollback", "insufficient_samples", 240.0)


def test_shadow_sampler_keeps_and_drops_like_jax(monkeypatch):
    """The worker held back: the accumulator's picks and the bounded
    queue's drops, offer by offer."""
    runs = []
    for reg, life in PACKAGES:
        reg.reset()
        monkeypatch.setattr(life.threading, "Thread", _IdleThread)
        sc = life.ShadowScorer(fleet=None, fraction=0.3, queue_max=3)
        runs.append(([sc.offer(np.ones((1, 4))) for _ in range(40)],
                     reg.get_counter("lifecycle_shadow_dropped_total"),
                     sc.stats()))
        monkeypatch.undo()
    assert runs[0] == runs[1]
    assert sum(runs[1][0]) == 3 and runs[1][1] == 8


class _IdleThread:
    def __init__(self, *a, **kw):
        pass

    def start(self):
        pass

    def is_alive(self):
        return False


def test_prom_render_and_parse_byte_equal_to_jax():
    snap = {"counters": {"serve_requests": 12,
                         'serve_requests{model="canary"}': 3,
                         'serve_requests{model="primary"}': 9,
                         "Serve::odd name": 1},
            "gauges": {"serve_generation": 2, "flag": True, "text": "x",
                       'drift_psi{feature="a\\"b",model="primary"}': 0.25,
                       "nan_gauge": float("nan"), "inf": float("inf")},
            "histograms": {
                "serve_latency_seconds": {
                    "buckets": [0.001, 0.01, 0.1], "counts": [1, 2, 3, 4],
                    "sum": 1.2345, "count": 10},
                'serve_latency_seconds{model="canary"}': {
                    "buckets": [0.001, 0.01, 0.1], "counts": [0, 1, 0, 0],
                    "sum": 0.005, "count": 1}},
            "phase_seconds": {}}
    text = prom.render(snap)
    assert text == jprom.render(snap)
    parsed = prom.parse_text(text)
    assert str(parsed) == str(jprom.parse_text(text))
    for match in (None, {"model": "canary"}):
        assert prom.histogram_series(parsed, "lightgbm_tpu_serve_latency_"
                                     "seconds", match) == \
            jprom.histogram_series(parsed, "lightgbm_tpu_serve_latency_"
                                   "seconds", match)
    for key in snap["counters"]:
        assert prom.split_series(key) == jprom.split_series(key)
    h = snap["histograms"]["serve_latency_seconds"]
    for q in (0.0, 0.5, 0.99, 1.0):
        assert obs.histogram_quantile(h, q) == jobs.histogram_quantile(h, q)


# ---------------------------------------------------------------------------
# HTTP, real forests


def _wait(cond, timeout_s):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


def test_canary_promoted_then_skewed_canary_rolled_back(tmp_path):
    path_a, X = train_and_save(tmp_path, "a.txt", 3, seed=0)
    path_b, _ = train_and_save(tmp_path, "b.txt", 4, seed=1)
    y = (X[:, 0] + 0.3 * X[:, 1] > 0).astype(float)
    obs.reset()
    srv = serve_from_config(serve_config(
        f"input_model={path_a}", "serve_canary_weight=0.25",
        "lifecycle_window_s=1", "lifecycle_min_samples=20",
        "serve_shadow=0.5", "lifecycle_latency_ratio=50")).start()
    assert srv._ready.wait(60.0)    # the background warm
    srv.controller.interval_s = 0.05
    base = base_url(srv)
    failures = []

    def traffic(n, feedback):
        for i in range(n):
            try:
                r, _ = post(base, "/predict", {"rows": [X[i].tolist()]})
                if feedback:
                    post(base, "/feedback", {"request_id": r["request_id"],
                                             "label": y[i]})
            except Exception as exc:
                failures.append(repr(exc))

    try:
        r, _ = post(base, "/reload", {"model": path_b, "target": "canary"})
        assert r["generation"] == 2
        traffic(120, False)
        assert _wait(lambda: srv.controller.stats()["last_verdict"]
                     is not None, 10)
        st = get(base, "/stats")
        assert st["lifecycle"]["controller"]["last_verdict"]["outcome"] \
            == "promote", st["lifecycle"]
        assert st["fleet"]["generation"] == 3
        assert st["counters"]["lifecycle_shadow_total"] >= 1
        # a window long enough for the labels: the quality gate abstains
        # until both models have lifecycle_min_samples of them
        srv.controller.window_s = srv.controller.max_window_s = 60.0
        r, _ = post(base, "/reload", {"model": path_a, "target": "canary"})
        with faults.skew_predictions(srv.fleet, 0.9, model="canary"):
            traffic(160, True)
            assert _wait(lambda: srv.controller.stats()["consecutive_"
                                                       "rollbacks"] == 1, 10)
        verdict = get(base, "/stats")["lifecycle"]["controller"][
            "last_verdict"]
        assert (verdict["outcome"], verdict["reason"]) == \
            ("rollback", "quality")
        assert not srv.fleet.has_canary()
    finally:
        srv.stop()
    assert not failures
