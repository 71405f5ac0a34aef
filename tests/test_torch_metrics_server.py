"""The training ``/metrics`` listener (lightgbm_tpu_torch/obs/
metrics_server.py) and its wiring in ``engine.train``, against the JAX
package on the CPU.

- A ``/metrics`` scrape while a port training runs parses with the
  port's ``prom`` parser and counts the rounds done in
  ``phase_seconds_gbdt_iteration_count``.
- The listener is gone after ``train`` returns and after it raises.
- ``LIGHTGBM_TPU_METRICS_PORT`` beats ``metrics_port``; an out-of-range
  port, a non-integer or a port already taken warns and the run trains
  on (``resolve_port`` against the JAX package's on the same inputs).
- ``rank_labels()`` labels every sample of a multi-process run, on the
  listener and on the serving front end's ``/metrics``.

Listeners bind port 0 through ``MetricsServer`` or a port from
``parallel.launch.free_port``, so that test workers do not collide.
"""

import json
import socket
import urllib.error
import urllib.request

import numpy as np
import pytest

from lightgbm_tpu.obs import metrics_server as jms
from lightgbm_tpu.obs import prom as jprom

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import obs
from lightgbm_tpu_torch.obs import metrics_server as ms
from lightgbm_tpu_torch.obs import prom
from lightgbm_tpu_torch.parallel import multihost
from lightgbm_tpu_torch.parallel.launch import free_port
from lightgbm_tpu_torch.serve.server import serve_from_config
from lightgbm_tpu_torch.utils import log

from test_torch_fleet import base_url, post, serve_config, train_and_save
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch

PARAMS = {"objective": "binary", "num_leaves": 7, "verbose": -1,
          "min_data_in_leaf": 20}
FAMILY = "lightgbm_tpu_phase_seconds_gbdt_iteration"


@pytest.fixture(autouse=True)
def _no_env_port(monkeypatch):
    monkeypatch.delenv(ms.ENV_PORT, raising=False)
    # warnings print whatever verbosity an earlier CLI run in this
    # process left behind
    monkeypatch.setattr(log, "_current_level", 1)


def _data(n=600):
    rng = np.random.RandomState(4)
    X = rng.normal(size=(n, 5))
    return X, (X[:, 0] + 0.2 * X[:, 1] > 0).astype(np.float64)


def _scrape(port, path="/metrics"):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return r.headers.get("Content-Type"), r.read().decode()


def _listening(port):
    try:
        _scrape(port, "/healthz")
        return True
    except (urllib.error.URLError, OSError):
        return False


def _train(params, rounds=4, callbacks=None, **kw):
    X, y = _data()
    return lt.train({**PARAMS, **params}, lt.Dataset(X, y), rounds,
                    device="cpu", verbose_eval=False, callbacks=callbacks,
                    **kw)


def test_scrape_during_training_counts_the_rounds(tmp_path):
    obs.reset()
    port = free_port()
    seen = []

    def scrape(env):
        ctype, text = _scrape(port)
        assert ctype == prom.CONTENT_TYPE
        hist = prom.histogram_series(prom.parse_text(text), FAMILY)
        seen.append((env.iteration, hist["count"]))
        assert ms.active_server() is not None

    b = _train({"metrics_port": port,
                "events_file": str(tmp_path / "ev.jsonl")}, 5, [scrape])
    assert b.num_trees() == 5
    assert seen == [(i, i + 1) for i in range(5)]
    assert ms.active_server() is None and not _listening(port)


def test_listener_stops_when_train_raises(tmp_path):
    port = free_port()

    def boom(env):
        assert _listening(port)
        if env.iteration == 1:
            raise RuntimeError("callback failed")

    ev, trace = tmp_path / "ev.jsonl", tmp_path / "trace.json"
    with pytest.raises(RuntimeError, match="callback failed"):
        _train({"metrics_port": port, "events_file": str(ev),
                "trace_events_file": str(trace)}, 5, [boom])
    assert ms.active_server() is None and not _listening(port)
    # the run's other sinks were shut down too: the recorder wrote its
    # last round and the span trees were exported
    assert [r["iter"] for r in obs.read_events(str(ev))] == [0, 1]
    names = [e["name"] for e in json.loads(trace.read_text())[
        "traceEvents"]]
    assert names.count("GBDT::iteration") == 2
    # no listener holds the port (connections may linger in TIME_WAIT)
    with socket.socket() as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", port))
        s.listen(1)


@pytest.mark.parametrize("env, params", [
    (None, {"metrics_port": 9123}), ("9124", {"metrics_port": 9123}),
    ("0", {"metrics_port": 9123}), ("70000", {}), ("-3", {}),
    ("nine", {"metrics_port": 9125}), (None, {"metrics_port": "x"}),
    (None, {"metrics_port": 0}), (None, None)])
def test_resolve_port_like_jax(monkeypatch, env, params):
    if env is not None:
        monkeypatch.setenv(ms.ENV_PORT, env)
    assert ms.resolve_port(params) == jms.resolve_port(params)


def test_env_port_wins_and_bad_ports_do_not_stop_training(monkeypatch,
                                                          capsys):
    port = free_port()
    seen = []
    monkeypatch.setenv(ms.ENV_PORT, str(port))
    _train({"metrics_port": free_port(exclude=(port,))}, 2,
           [lambda env: seen.append(_listening(port))])
    assert seen == [True, True]
    monkeypatch.setenv(ms.ENV_PORT, "70000")
    assert _train({}, 2).num_trees() == 2
    assert "out of range" in capsys.readouterr().err
    monkeypatch.delenv(ms.ENV_PORT)
    busy = free_port(exclude=(port,))
    with socket.socket() as taken:
        taken.bind(("127.0.0.1", busy))
        taken.listen(1)
        assert _train({"metrics_port": busy}, 2).num_trees() == 2
    assert "could not bind" in capsys.readouterr().err
    assert ms.active_server() is None
    with pytest.raises(ValueError, match="metrics_port must be in"):
        _train({"metrics_port": 70000}, 1)


def test_metrics_server_on_port_zero():
    obs.reset()
    obs.inc("trees_grown", 3)
    with ms.MetricsServer(port=0) as srv:
        host, port = srv.address
        assert port > 0 and ms.active_server() is srv
        _, text = _scrape(port)
        assert text == prom.render()
        assert "lightgbm_tpu_trees_grown 3" in text.splitlines()
        assert json.loads(_scrape(port, "/healthz")[1]) == {"status": "ok"}
        with pytest.raises(urllib.error.HTTPError) as ei:
            _scrape(port, "/nope")
        assert ei.value.code == 404
    srv.stop()
    assert ms.active_server() is None and not _listening(port)


def test_rank_labels_on_every_sample(monkeypatch, tmp_path):
    assert ms.rank_labels() is None
    snap = {"counters": {"iterations": 4, 'serve_requests{model="a"}': 2},
            "gauges": {"g": 1.5},
            "histograms": {"phase_seconds_gbdt_iteration": {
                "buckets": [0.1, 1.0], "counts": [3, 1, 0], "sum": 0.5,
                "count": 4}}}
    for labels in (None, {"rank": "1"}):
        assert prom.render(snap, labels=labels) == \
            jprom.render(snap, labels=labels)
    monkeypatch.setattr(multihost, "process_rank_world", lambda: (1, 2))
    assert ms.rank_labels() == {"rank": "1"}
    with ms.MetricsServer(port=0) as srv:
        parsed = prom.parse_text(_scrape(srv.address[1])[1])
        assert json.loads(_scrape(srv.address[1], "/healthz")[1]) == \
            {"status": "ok", "rank": "1"}
    assert parsed["samples"] and all(labels.get("rank") == "1"
                                     for _, labels, _ in parsed["samples"])
    path, X = train_and_save(tmp_path, "m.txt", 2)
    srv = serve_from_config(serve_config(f"input_model={path}")).start()
    assert srv._ready.wait(60.0)    # the background warm
    try:
        post(base_url(srv), "/predict", {"rows": X[:2].tolist()})
        text = urllib.request.urlopen(base_url(srv) + "/metrics",
                                      timeout=10).read().decode()
    finally:
        srv.stop()
    parsed = prom.parse_text(text)
    assert parsed["samples"] and all(labels.get("rank") == "1"
                                     for _, labels, _ in parsed["samples"])
