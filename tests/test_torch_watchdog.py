"""Replica health (lightgbm_tpu_torch/serve/health.py) against the JAX
package, on the CPU.

The same scripted faults (consecutive errors, a stalled batch, a latency
outlier, failing and succeeding probes, clean requests on probation)
drive a three-replica stub fleet in both packages, with the watchdog's
clock injected and ``tick()`` called by hand: the replicas' states and
the health counters must be equal after every step.  Then real forests
through the port's fault injectors: a wedged lone replica is ejected,
requests get 503 (never a hang), the probe re-admits it on probation and
clean requests make it healthy; a poisoned replica's requests hedge onto
its peer.
"""

import threading
import time
import types
import urllib.error

import numpy as np
import pytest

from lightgbm_tpu import obs as jobs
from lightgbm_tpu import serve as jserve
from lightgbm_tpu.serve import health as jhealth

from lightgbm_tpu_torch import obs, serve
from lightgbm_tpu_torch.serve import health
from lightgbm_tpu_torch.serve.server import serve_from_config
from lightgbm_tpu_torch.testing import faults

from test_torch_fleet import (base_url, get, plain_answers, post,
                              serve_config, stub_fleet, train_and_save)

pytestmark = pytest.mark.torch

HEALTH_COUNTERS = ("serve_ejections_total", "serve_probes_total",
                   "serve_probe_failures_total", "serve_readmissions_total",
                   "serve_request_errors_total")


class Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _states(fleet, reg):
    with fleet._cond:
        reps = list(fleet._primary.replicas)
        rows = [(r.health, r.consecutive_errors, r.ejections,
                 r.probation_left, r.outlier_ticks, r.probe_failures)
                for r in reps]
    return rows, {k: reg.get_counter(k) for k in HEALTH_COUNTERS}


def _settle_probes(fleet, wd):
    """Wait for every launched probe, then reap them (the tick's own
    reap may or may not have seen a fast probe finish)."""
    with fleet._cond:
        probes = [r.probe for r in fleet._primary.replicas
                  if r.probe is not None]
    for p in probes:
        assert p["done"].wait(10)
    wd._reap_probes()


def _script(pkg, hmod, reg, monkeypatch):
    clock = Clock()
    monkeypatch.setattr(hmod, "time", types.SimpleNamespace(
        monotonic=clock))
    reg.reset()
    fleet = stub_fleet(pkg, [0.0, 0.0, 0.0], error_threshold=3)
    wd = hmod.Watchdog(fleet, interval_s=3600.0, stall_s=1.0,
                       latency_outlier=4.0)
    reps = fleet._primary.replicas
    trail = []

    def step():
        wd.tick()
        _settle_probes(fleet, wd)
        trail.append(_states(fleet, reg))

    try:
        with fleet._cond:
            for r in reps:
                r.ewma_service_s = 0.01
            fleet._note_error_locked(reps[0])
            fleet._note_error_locked(reps[0])
        step()                                   # two errors: healthy
        with fleet._cond:
            fleet._note_error_locked(reps[0])    # third: suspect
        trail.append(_states(fleet, reg))
        step()                                   # ejected
        with fleet._cond:
            reps[1].ewma_service_s = 0.5         # 50x the median
        step()               # rep1 suspect (outlier tick 1); rep0 probed
        step()               # rep1 ejected (tick 2)
        reps[2].batcher.stalled_for_s = lambda: 5.0
        with fleet._cond:
            for _ in range(3):
                fleet._note_ok_locked(reps[0], 0.01)
        step()               # rep2 stalled -> ejected; rep0 healthy
        del reps[2].batcher.stalled_for_s
        reps[2].forest.batched_fn = lambda: (_ for _ in ()).throw(
            RuntimeError("probe poison"))
        step()                                   # rep2's probe fails
        clock.t += 0.5
        step()                                   # inside the backoff
        clock.t += 7200.0 * 2
        del reps[2].forest.batched_fn
        step()                                   # probe ok: probation
        with fleet._cond:
            fleet._note_error_locked(reps[2])    # one strike on probation
        step()                                   # ejected again
    finally:
        wd.close()
        fleet.close()
    return trail


def test_health_states_match_jax_under_scripted_faults(monkeypatch):
    want = _script(jserve, jhealth, jobs, monkeypatch)
    got = _script(serve, health, obs, monkeypatch)
    assert got == want
    states = [[r[0] for r in rows] for rows, _ in got]
    assert states[2][0] == "ejected" and states[4][1] == "ejected"
    assert "probation" in states[-2] and states[-1][2] == "ejected"


def test_wedged_lone_replica_ejected_503_then_readmitted(tmp_path):
    path, X = train_and_save(tmp_path, "m.txt", 3)
    obs.reset()
    srv = serve_from_config(serve_config(
        f"input_model={path}", "serve_watchdog_ms=20",
        "serve_stall_ms=200", "serve_retry_limit=0")).start()
    assert srv._ready.wait(60.0)    # the background warm
    base = base_url(srv)
    fleet = srv.fleet
    rep = fleet._primary.replicas[0]
    blocked = []
    try:
        with faults.wedge_replica(fleet, 0):
            t = threading.Thread(target=lambda: blocked.append(
                _code(base, X[:2])))
            t.start()
            assert _wait(lambda: rep.health == "ejected", 10)
            t.join(10)
            assert blocked == [503]             # failed, not hung
            t0 = time.monotonic()
            assert _code(base, X[:2]) == 503
            assert time.monotonic() - t0 < 5
        # the wedge is released: the hung probe returns and re-admits
        assert _wait(lambda: rep.health == "probation", 10)
        for n in (1, 2, 3):
            r, _ = post(base, "/predict", {"rows": X[:n].tolist()})
            np.testing.assert_allclose(r["predictions"],
                                       plain_answers(srv.forest, X[:n]),
                                       rtol=0, atol=1e-6)
        assert rep.health == "healthy"
        counters = get(base, "/stats")["counters"]
        assert counters["serve_ejections_total"] == 1
        assert counters["serve_readmissions_total"] == 1
    finally:
        srv.stop()


def test_poisoned_replica_hedges_onto_its_peer(tmp_path):
    path, X = train_and_save(tmp_path, "m.txt", 3)
    obs.reset()
    srv = serve_from_config(serve_config(
        f"input_model={path}", "serve_replicas=2",
        "serve_watchdog_ms=20")).start()
    assert srv._ready.wait(60.0)    # the background warm
    base = base_url(srv)
    try:
        with faults.poison_predict(srv.fleet, 0):
            for i in range(12):
                r, _ = post(base, "/predict", {"rows": X[i:i + 2].tolist()})
                assert r["replica"] == 1
                np.testing.assert_allclose(
                    r["predictions"], plain_answers(srv.forest, X[i:i + 2]),
                    rtol=0, atol=1e-6)
            assert _wait(lambda: srv.fleet._primary.replicas[0].health
                         == "ejected", 10)
        counters = get(base, "/stats")["counters"]
        assert counters["serve_retries_total"] >= 1
        assert counters.get("serve_errors", 0) == 0
    finally:
        srv.stop()


def _code(base, rows):
    try:
        post(base, "/predict", {"rows": rows.tolist()}, timeout=30)
        return 200
    except urllib.error.HTTPError as err:
        return err.code


def _wait(cond, timeout_s):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return cond()
