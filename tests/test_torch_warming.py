"""Serving warms in the background, as the JAX server does, on the CPU.

``PredictServer(warm_in_background=True)`` binds at once and runs
``Fleet.warm_all`` on a thread: ``/healthz`` answers 200 with ``ready:
false`` and ``/readyz`` and ``/predict`` answer 503 ``warming`` until the
warm returns True, then the answers equal the JAX package's CompiledForest
on the same rows (the serving tolerance, 1e-6).  A warm that raises
leaves readiness false with one warning; a shutdown mid-warm stops after
the current bucket.  ``task=serve`` through the port's CLI binds before
its warm ends.  ``Fleet.warm_all`` warms the buckets up to the one a
``max_batch``-row request dispatches to, as the JAX fleet's does, and
``Booster.compile(warmup=True)`` warms every bucket.  The tests of
tests/test_serve_chaos.py:510-560, on the port with real forests.
"""

import json
import logging
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

import lightgbm_tpu as lgb
from lightgbm_tpu import serve as jserve
from lightgbm_tpu.serve.forest import CompiledForest as JaxForest

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import cli, obs, serve
from lightgbm_tpu_torch.serve import server as server_mod
from lightgbm_tpu_torch.serve.forest import CompiledForest
from lightgbm_tpu_torch.utils import log

from test_torch_fleet import StubForest, base_url, get, post, train_and_save
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch

BUCKETS = [16, 64, 256]


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    path, X = train_and_save(tmp_path_factory.mktemp("warm"), "m.txt", 4)
    return path, X


def cpu_forest(path):
    booster = lt.Booster(model_file=path, device="cpu")
    return CompiledForest.from_booster(booster, buckets=BUCKETS)


class HeldWarm:
    """Wraps a forest's ``warmup``: each bucket waits for ``release``,
    then runs the real warm (or raises ``fail``); records the buckets."""

    def __init__(self, forest, fail=None):
        self.release = threading.Event()
        self.started = threading.Event()
        self.buckets = []
        self.fail = fail
        real = forest.warmup

        def warmup(buckets=None, max_bucket=None):
            self.started.set()
            assert self.release.wait(30.0)
            if self.fail is not None:
                raise self.fail
            self.buckets += list(buckets or [])
            return real(buckets=buckets, max_bucket=max_bucket)

        forest.warmup = warmup


def code_of(url, payload=None):
    req = (urllib.request.Request(url, data=json.dumps(payload).encode(),
                                  headers={"Content-Type":
                                           "application/json"})
           if payload is not None else url)
    try:
        resp = urllib.request.urlopen(req, timeout=10)
        return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def test_readiness_gates_traffic_while_warming(model):
    path, X = model
    forest = cpu_forest(path)
    held = HeldWarm(forest)
    srv = server_mod.PredictServer(forest, port=0, max_batch=64,
                                   max_delay_ms=1.0,
                                   warm_in_background=True).start()
    base = base_url(srv)
    rows = X[:5].astype(np.float32)
    try:
        assert held.started.wait(10.0)
        health = get(base, "/healthz")
        assert health["status"] == "ok" and health["ready"] is False
        assert code_of(base + "/readyz") == (503, {
            "status": "warming", "generation": srv.fleet.generation})
        code, body = code_of(base + "/predict", {"rows": rows.tolist()})
        assert code == 503 and body["error"] == "server warming"
        held.release.set()
        assert srv._ready.wait(30.0)
        # the buckets a 64-row request can reach, one warm each
        assert held.buckets == [16, 64]
        assert code_of(base + "/readyz")[1]["status"] == "ready"
        assert get(base, "/healthz")["ready"] is True
        r, _ = post(base, "/predict", {"rows": rows.tolist()})
        want = JaxForest.from_booster(lgb.Booster(model_file=path)).predict(
            rows, device_binning=True)
        np.testing.assert_allclose(r["predictions"], want, rtol=0,
                                   atol=1e-6)
        srv._stop_requested.set()
        assert code_of(base + "/readyz")[1]["status"] == "draining"
        assert get(base, "/healthz")["status"] == "ok"     # still live
    finally:
        held.release.set()
        srv.stop()


def test_a_failed_warm_leaves_readiness_false(model):
    path, X = model
    forest = cpu_forest(path)
    held = HeldWarm(forest, fail=RuntimeError("walk build failed"))
    records = []

    class Capture(logging.Handler):
        def emit(self, record):
            records.append(record)

    logger = log.enable_stdlib_bridge("lightgbm_tpu_torch_warm_test")
    handler = Capture()
    logger.addHandler(handler)
    srv = server_mod.PredictServer(forest, port=0, max_batch=64,
                                   warm_in_background=True).start()
    try:
        held.release.set()
        srv._warm_thread.join(30.0)
        assert not srv._warm_thread.is_alive()
        assert not srv.is_ready() and not srv._ready.is_set()
        assert code_of(base_url(srv) + "/readyz")[1]["status"] == "warming"
        code, _ = code_of(base_url(srv) + "/predict",
                          {"rows": X[:2].tolist()})
        assert code == 503
    finally:
        srv.stop()
        logger.removeHandler(handler)
        log.disable_stdlib_bridge()
    warnings = [r.getMessage() for r in records
                if r.levelno == logging.WARNING]
    assert len(warnings) == 1 and "walk build failed" in warnings[0]


def test_shutdown_mid_warm_stops_after_the_current_bucket(model):
    path, _ = model
    forest = cpu_forest(path)
    held = HeldWarm(forest)
    srv = server_mod.PredictServer(forest, port=0, max_batch=256,
                                   warm_in_background=True).start()
    assert held.started.wait(10.0)
    stopper = threading.Thread(target=srv.stop)
    stopper.start()
    assert srv._stop_requested.wait(10.0)
    held.release.set()
    stopper.join(60.0)
    assert not stopper.is_alive() and not srv._warm_thread.is_alive()
    assert held.buckets == [16] and not srv._ready.is_set()


@pytest.mark.parametrize("max_batch,want", [(40, [16, 64]), (64, [16, 64]),
                                            (4096, BUCKETS), (8, [16])])
def test_warm_all_warms_the_buckets_jax_does(max_batch, want):
    """Both fleets warm the same rungs of the same ladder."""
    seen = {}
    for name, pkg in (("jax", jserve), ("torch", serve)):
        calls = []

        class Laddered(StubForest):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                self.ladder = pkg.BucketLadder(BUCKETS)

            def warmup(self, buckets=None, max_bucket=None):
                calls.extend(buckets)
                return self

        fleet = pkg.Fleet(pkg.ReplicaSet(
            [pkg.Replica(Laddered(), 0, "primary", 1, max_batch=max_batch,
                         max_delay_s=0.0, max_queue=0)], "primary", 1),
            max_batch=max_batch)
        try:
            assert fleet.warm_all() is True
            assert fleet.warm_all(should_abort=lambda: True) is False
        finally:
            fleet.close()
        seen[name] = calls
    assert seen["torch"] == seen["jax"] == want


def test_task_serve_binds_before_its_warm_ends(model, monkeypatch):
    """``python -m lightgbm_tpu_torch task=serve`` through ``cli.main``:
    the port answers liveness while the warm is held, readiness after."""
    path, X = model
    release = threading.Event()
    real = CompiledForest.warmup

    def held(self, buckets=None, max_bucket=None):
        assert release.wait(30.0)
        return real(self, buckets=buckets, max_bucket=max_bucket)

    monkeypatch.setattr(CompiledForest, "warmup", held)
    servers = []
    made = server_mod.serve_from_config

    def capture(config, params=None):
        servers.append(made(config, params))
        return servers[-1]

    monkeypatch.setattr(server_mod, "serve_from_config", capture)
    rc = []
    main = threading.Thread(target=lambda: rc.append(cli.main([
        "task=serve", f"input_model={path}", "serve_port=0", "device=cpu",
        "predict_buckets=16,64", "serve_max_batch=64", "verbose=-1"])))
    main.start()
    try:
        for _ in range(200):
            if servers and servers[0]._thread is not None:
                break
            main.join(0.05)
        srv = servers[0]
        base = base_url(srv)
        assert get(base, "/healthz")["ready"] is False
        assert code_of(base + "/readyz")[1]["status"] == "warming"
        release.set()
        assert srv._ready.wait(30.0)
        r, _ = post(base, "/predict", {"rows": X[:3].tolist()})
        assert r["num_rows"] == 3
    finally:
        release.set()
        if servers:
            servers[0]._stop_requested.set()
        main.join(60.0)
    assert not main.is_alive() and rc == [0]


def test_booster_compile_warmup_warms_every_bucket(model):
    path, X = model
    bst = lt.Booster(model_file=path, device="cpu")
    before = obs.get_counter("forest_warmups")
    cf = bst.compile(buckets=BUCKETS, warmup=True)
    assert obs.get_counter("forest_warmups") == before + 1
    assert bst.compile(buckets=BUCKETS).ladder.sizes == cf.ladder.sizes
    jcf = lgb.Booster(model_file=path).compile(buckets=BUCKETS, warmup=True)
    np.testing.assert_allclose(
        cf.predict(X[:20].astype(np.float32), device_binning=True),
        jcf.predict(X[:20].astype(np.float32), device_binning=True),
        rtol=0, atol=1e-6)
