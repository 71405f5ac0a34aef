"""The torch port's serving fleet (lightgbm_tpu_torch/serve/fleet.py,
serve/server.py) against the JAX package, on the CPU.

Stub forests (constant answers, a chosen service time) drive the
scheduling tests in both packages with the same script: the canary
rotation's chosen sets over 1000 submits, admission control's 429 with
``Retry-After`` under ``serve_queue_depth``, the fleet keys' defaults
and checks.  Real forests, trained by the JAX package and saved, drive
the HTTP tests: hot reload under four client threads (every response
held to the plain walk of the generation it names, <= 1e-6), the
``/stats`` and ``/metrics`` key sets against the JAX server's for the
same traffic, 503 at zero healthy replicas, 504 on an expired deadline,
the state-file restore, the CPU replica seam, and ``serve_walk=gather``
against the fused plain walk and the JAX gather walk across the ladder.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import lightgbm_tpu as lgb
from lightgbm_tpu import obs as jobs
from lightgbm_tpu import serve as jserve
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.serve.forest import CompiledForest as JaxForest

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import obs, serve
from lightgbm_tpu_torch.config import Config, parse_cli_args
from lightgbm_tpu_torch.ops.forest_walk import forest_walk_raw_plain
from lightgbm_tpu_torch.serve.server import serve_from_config

pytestmark = pytest.mark.torch

BUCKETS = [16, 64]


class StubForest:
    """A duck-typed CompiledForest: constant answers after a fixed
    service time (the same stub drives both packages)."""

    num_trees = 1
    num_class = 1

    def __init__(self, service_s=0.0, value=1.0, num_features=4,
                 device=None):
        self.service_s = float(service_s)
        self.value = float(value)
        self.num_features = int(num_features)
        self.device = device
        self.data_fingerprint = None

    def batched_fn(self):
        def fn(rows):
            if self.service_s:
                time.sleep(self.service_s)
            out = np.full((1, rows.shape[0]), self.value, np.float32)
            return out, out
        return fn

    def to_device(self, device):
        return StubForest(self.service_s, self.value, self.num_features,
                          device)

    def warmup(self, buckets=None, max_bucket=None):
        return self

    def info(self):
        return {"num_trees": 1, "num_class": 1,
                "num_features": self.num_features}


def stub_fleet(pkg, service_times, canary_times=(), canary_weight=0.0,
               max_queue=0, value=1.0, canary_value=2.0, **kw):
    """The same stub fleet in either package's ``serve`` module."""
    def replicas(times, model, gen, val):
        return [pkg.Replica(StubForest(t, value=val), i, model, gen,
                            max_batch=256, max_delay_s=0.0,
                            max_queue=max_queue)
                for i, t in enumerate(times)]
    primary = pkg.ReplicaSet(replicas(service_times, "primary", 1, value),
                             "primary", 1)
    canary = (pkg.ReplicaSet(replicas(canary_times, "canary", 2,
                                      canary_value), "canary", 2)
              if canary_times else None)
    return pkg.Fleet(primary, canary, canary_weight=canary_weight, **kw)


def train_and_save(tmp_path, name, rounds, seed=0, lr=0.1, n=800):
    """A JAX-trained binary model on 6 features, saved; (path, rows)."""
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, 6))
    y = (X[:, 0] + 0.3 * X[:, 1] > 0).astype(np.float64)
    bst = lgb.train({"objective": "binary", "num_leaves": 7, "verbose": -1,
                     "min_data_in_leaf": 20, "learning_rate": lr},
                    lgb.Dataset(X, label=y), num_boost_round=rounds)
    path = str(tmp_path / name)
    bst.save_model(path)
    return path, X


def post(base, path, payload, timeout=60):
    body = (payload if isinstance(payload, bytes)
            else json.dumps(payload).encode())
    req = urllib.request.Request(base + path, data=body,
                                 headers={"Content-Type":
                                          "application/json"})
    resp = urllib.request.urlopen(req, timeout=timeout)
    return json.loads(resp.read()), dict(resp.headers)


def get(base, path, raw=False):
    body = urllib.request.urlopen(base + path, timeout=30).read()
    return body.decode() if raw else json.loads(body)


def serve_config(*extra):
    return Config(parse_cli_args(["task=serve", "serve_port=0",
                                  "device=cpu", "serve_max_delay_ms=2",
                                  "predict_buckets=16,64,256", *extra]))


def base_url(srv):
    host, port = srv.address
    return f"http://{host}:{port}"


def plain_answers(forest, X):
    """The transformed [N] answers of ``forest``'s plain walk on ``X``
    (the serving path's f32 binning)."""
    raw = forest_walk_raw_plain(forest.walk_tables, *forest.cut_tables(),
                                forest.device_rows(np.asarray(X,
                                                              np.float32)))
    return forest.transform_scores(raw)[0].double().numpy()


# ---------------------------------------------------------------------------
# the dispatcher, against the JAX fleet


@pytest.mark.parametrize("weight", [0.1, 0.25, 0.5])
def test_canary_rotation_matches_jax(weight):
    """The deterministic weight accumulator: the same sequence of chosen
    sets over 1000 submits, and the exact split."""
    seqs = []
    for pkg in (jserve, serve):
        fleet = stub_fleet(pkg, [0.0], canary_times=[0.0],
                           canary_weight=weight)
        try:
            seqs.append([fleet.submit(np.ones((1, 4), np.float32)).model
                         for _ in range(1000)])
        finally:
            fleet.close()
    assert seqs[0] == seqs[1]
    # the share to one request (the f64 accumulator of 0.1 lands one
    # short after 1000 adds)
    assert abs(seqs[1].count("canary") - 1000 * weight) <= 1


def test_queue_depth_sheds_429_with_retry_after_like_jax(tmp_path):
    """``serve_queue_depth=1`` and a slow replica: the port sheds with
    429 and an integral ``Retry-After``, as the JAX server does (the
    port took ``serve_queue_depth`` as inert and queued every request
    before the fleet was ported)."""
    path, _ = train_and_save(tmp_path, "m.txt", 3)
    cfg = serve_config(f"input_model={path}", "serve_queue_depth=1")
    jcfg = JaxConfig(parse_cli_args([f"input_model={path}",
                                     "serve_queue_depth=1"]))
    assert cfg.serve_queue_depth == jcfg.serve_queue_depth == 1
    srv = serve_from_config(cfg)
    try:
        assert all(rep.batcher.max_queue == 1
                   for rep in srv.fleet._primary.replicas)
    finally:
        srv.stop()
    codes = {}
    for name, pkg in (("jax", jserve), ("torch", serve)):
        fleet = stub_fleet(pkg, [0.3], max_queue=1)
        srv = pkg.PredictServer(fleet, port=0).start()
        base = base_url(srv)
        got = []

        def client():
            try:
                post(base, "/predict", {"rows": [[0.0] * 4]})
                got.append((200, None))
            except urllib.error.HTTPError as err:
                got.append((err.code, err.headers.get("Retry-After")))

        try:
            threads = [threading.Thread(target=client) for _ in range(6)]
            for t in threads:
                t.start()
                time.sleep(0.02)
            for t in threads:
                t.join(30)
        finally:
            srv.stop()
        codes[name] = got
    for name, got in codes.items():
        shed = [h for c, h in got if c == 429]
        assert len(got) == 6 and shed, name
        assert all(h is not None and int(h) >= 1 for h in shed), name
        assert {c for c, _ in got} <= {200, 429}, name


FLEET_KEYS = ("serve_replicas", "serve_queue_depth", "serve_max_inflight",
              "serve_canary_model", "serve_canary_weight",
              "serve_retry_limit", "serve_error_threshold",
              "serve_watchdog_ms", "serve_stall_ms", "serve_latency_outlier",
              "serve_state_file", "serve_shadow", "lifecycle_window_s",
              "lifecycle_max_window_s", "lifecycle_min_samples",
              "lifecycle_latency_ratio", "lifecycle_error_rate",
              "lifecycle_cooldown_s", "drift", "drift_window", "drift_top_k",
              "lifecycle_drift_threshold")

BAD_VALUES = [("serve_replicas", -1), ("serve_queue_depth", -1),
              ("serve_max_inflight", -2), ("serve_canary_weight", 1.0),
              ("serve_retry_limit", -1), ("serve_error_threshold", 0),
              ("serve_watchdog_ms", -1), ("serve_stall_ms", -5),
              ("serve_latency_outlier", 1.0), ("serve_shadow", 1.5),
              ("lifecycle_window_s", -1), ("lifecycle_min_samples", 0),
              ("lifecycle_latency_ratio", 0.5), ("lifecycle_error_rate", 2),
              ("lifecycle_cooldown_s", -1), ("drift", "maybe"),
              ("drift_window", 0), ("drift_top_k", 0),
              ("lifecycle_drift_threshold", -0.1)]


def test_fleet_keys_are_read_with_jax_defaults_and_checks():
    ours, theirs = Config({}), JaxConfig({})
    for key in FLEET_KEYS:
        assert ours[key] == theirs[key], key
    given = {"serve_replicas": "3", "serve_canary_weight": "0.2",
             "lifecycle_window_s": "2", "lifecycle_max_window_s": "4",
             "drift": "on", "drift_top_k": "2", "serve_shadow": "0.5"}
    ours, theirs = Config(given), JaxConfig(given)
    for key in FLEET_KEYS:
        assert ours[key] == theirs[key], key
    for key, bad in BAD_VALUES + [("lifecycle_max_window_s", 1)]:
        params = {key: bad}
        if key == "lifecycle_max_window_s":
            params["lifecycle_window_s"] = 2
        with pytest.raises(ValueError) as want:
            JaxConfig(params)
        with pytest.raises(ValueError) as got:
            Config(params)
        assert str(got.value) == str(want.value), key


def test_cpu_replica_seam_and_least_loaded_dispatch():
    """``serve_replicas=k`` builds k replicas on the CPU (0 builds one),
    each a forest of its own; the slow replica gets less traffic."""
    from lightgbm_tpu_torch.serve.fleet import fleet_devices
    assert len(fleet_devices(3, "cpu")) == 3
    assert len(fleet_devices(0, "cpu")) == 1
    fleet = serve.Fleet.build(StubForest(0.0, device=None),
                              devices=fleet_devices(3, "cpu"))
    try:
        forests = [r.forest for r in fleet._primary.replicas]
        assert len({id(f) for f in forests}) == 3
    finally:
        fleet.close()
    fleet = stub_fleet(serve, [0.04, 0.004])
    stop = time.monotonic() + 1.0
    served = []

    def client():
        while time.monotonic() < stop:
            served.append(fleet.submit(np.ones((2, 4), np.float32),
                                       timeout=10.0).replica)

    try:
        threads = [threading.Thread(target=client) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
    finally:
        fleet.close()
    assert served.count(1) > 2 * served.count(0) > 0


# ---------------------------------------------------------------------------
# HTTP, real forests


def test_hot_reload_under_four_clients_zero_failures(tmp_path):
    """4 client threads while ``POST /reload`` swaps a second model in:
    no request fails, each response equals the plain walk of the
    generation it names, the old generation's batchers close."""
    path_a, X = train_and_save(tmp_path, "a.txt", 3, seed=0)
    path_b, _ = train_and_save(tmp_path, "b.txt", 6, seed=1, lr=0.3)
    srv = serve_from_config(serve_config(f"input_model={path_a}",
                                         "serve_replicas=2")).start()
    base = base_url(srv)
    forests = {1: srv.forest}
    old_set = srv.fleet._primary
    rows = {n: X[:n].astype(np.float32) for n in (1, 17, 64)}
    answers, failures = [], []
    stop = threading.Event()

    def client(c):
        i = 0
        while not stop.is_set() or i < 3:
            n = (1, 17, 64)[(c + i) % 3]
            try:
                r, _ = post(base, "/predict", {"rows": rows[n].tolist()})
                answers.append((r["generation"], n, r["predictions"]))
            except Exception as exc:       # counted below
                failures.append(repr(exc))
            i += 1

    threads = [threading.Thread(target=client, args=(c,)) for c in range(4)]
    try:
        for t in threads:
            t.start()
        time.sleep(0.3)
        r, _ = post(base, "/reload", {"model": path_b})
        assert r["generation"] == 2
        forests[2] = srv.forest
        time.sleep(0.3)
        stop.set()
        for t in threads:
            t.join(60)
        stats = get(base, "/stats")
    finally:
        srv.stop()
    assert not failures
    assert {g for g, _, _ in answers} == {1, 2}
    for gen, n, preds in answers:
        want = plain_answers(forests[gen], rows[n])
        np.testing.assert_allclose(preds, want, rtol=0, atol=1e-6)
    assert all(not rep.batcher._worker.is_alive()
               for rep in old_set.replicas)
    assert stats["counters"]["serve_reloads"] == 1
    assert stats["counters"]["serve_generations_drained"] == 1
    assert stats["fleet"]["generation"] == 2


# keys the JAX package's compile instrumentation writes: the port builds
# its kernels once and compiles nothing per bucket
_JAX_ONLY = ("compile", "_calls", "devprof", "h2d_", "d2h_",
             "host_to_device", "device_to_host")


def _key_sets(stats, metrics_text):
    parsed = lt.obs.prom.parse_text(metrics_text)

    def keep(k):
        return not any(s in k for s in _JAX_ONLY)

    return ({k for k in stats if k != "kernel_launches"},
            {k for k in stats["counters"] if keep(k)},
            {k for k in stats["gauges"] if keep(k)},
            {k for k in stats["histograms"] if keep(k)},
            {k for k in stats["fleet"]}, {k for k in stats["lifecycle"]},
            {k for k in stats["drift"]},
            {f for f in parsed["types"] if keep(f)})


def test_stats_and_metrics_key_sets_equal_jax(tmp_path):
    """The same traffic through the JAX server and the port's: equal
    ``/stats`` blocks and registry keys, equal ``/metrics`` families."""
    path, X = train_and_save(tmp_path, "m.txt", 3)
    path_b, _ = train_and_save(tmp_path, "b.txt", 4, seed=2)
    keys = {}
    for name in ("jax", "torch"):
        pkg_obs = jobs if name == "jax" else obs
        pkg_obs.reset()
        if name == "jax":
            cfg = JaxConfig(parse_cli_args([
                "task=serve", f"input_model={path}", "serve_port=0",
                "serve_max_delay_ms=2", "predict_buckets=16,64",
                "serve_canary_weight=0.25", f"serve_canary_model={path_b}",
                "drift=on", "serve_replicas=1"]))
            srv = jserve.serve_from_config(cfg).start()
            deadline = time.monotonic() + 60
            while not srv.is_ready() and time.monotonic() < deadline:
                time.sleep(0.05)
        else:
            srv = serve_from_config(serve_config(
                f"input_model={path}", "predict_buckets=16,64",
                "serve_canary_weight=0.25", f"serve_canary_model={path_b}",
                "drift=on")).start()
        base = base_url(srv)
        try:
            rid = None
            for i in range(8):
                r, _ = post(base, "/predict",
                            {"rows": X[i:i + 1 + i % 3].tolist()})
                if r["num_rows"] == 1:
                    rid = r["request_id"]
            post(base, "/feedback", {"request_id": rid, "label": 1.0})
            with pytest.raises(urllib.error.HTTPError):
                post(base, "/predict", {"rows": [[1.0, 2.0]]})
            for col in srv.drift.values():
                col.flush()
            stats = get(base, "/stats")
            text = get(base, "/metrics", raw=True)
        finally:
            srv.stop()
        keys[name] = _key_sets(stats, text)
    for want, got in zip(keys["jax"], keys["torch"]):
        assert got == want


@pytest.mark.parametrize("fault", ["warmup", "truncate_tree",
                                   "garbage_field"])
def test_failed_reload_keeps_the_serving_generation(tmp_path, fault):
    """A reload that dies mid-warm (500) or reads a damaged file (400, as
    the JAX server answers both) leaves generation 1 serving."""
    from lightgbm_tpu_torch.testing import faults
    path_a, X = train_and_save(tmp_path, "a.txt", 3, seed=0)
    path_b, _ = train_and_save(tmp_path, "b.txt", 5, seed=1)
    srv = serve_from_config(serve_config(f"input_model={path_a}")).start()
    base = base_url(srv)
    try:
        with pytest.raises(urllib.error.HTTPError) as err:
            if fault == "warmup":
                with faults.fail_warmup(1) as st:
                    post(base, "/reload", {"model": path_b})
                assert st["failed"] == 1
            else:
                faults.corrupt_model_file(path_b, fault)
                post(base, "/reload", {"model": path_b})
        assert err.value.code == (500 if fault == "warmup" else 400)
        r, _ = post(base, "/predict", {"rows": X[:3].tolist()})
        assert r["generation"] == 1 and srv.fleet.generation == 1
        np.testing.assert_allclose(r["predictions"],
                                   plain_answers(srv.forest, X[:3]),
                                   rtol=0, atol=1e-6)
    finally:
        srv.stop()


def test_zero_healthy_replicas_503_and_expired_deadline_504(tmp_path):
    from lightgbm_tpu_torch.serve.health import EJECTED
    path, X = train_and_save(tmp_path, "m.txt", 3)
    srv = serve_from_config(serve_config(f"input_model={path}",
                                         "serve_watchdog_ms=0")).start()
    base = base_url(srv)
    try:
        with pytest.raises(urllib.error.HTTPError) as err:
            post(base, "/predict", {"rows": X[:2].tolist(),
                                    "deadline_ms": 0})
        assert err.value.code == 504
        rep = srv.fleet._primary.replicas[0]
        with srv.fleet._cond:
            rep.health = EJECTED
        t0 = time.monotonic()
        with pytest.raises(urllib.error.HTTPError) as err:
            post(base, "/predict", {"rows": X[:2].tolist()}, timeout=10)
        assert err.value.code == 503 and time.monotonic() - t0 < 5
        assert err.value.headers.get("Retry-After") == "1"
        counters = get(base, "/stats")["counters"]
        assert counters["serve_unavailable_total"] >= 1
        assert counters["serve_deadline_expired_total"] >= 1
    finally:
        srv.stop()


def test_state_file_restores_last_good_primary(tmp_path):
    path_a, X = train_and_save(tmp_path, "a.txt", 3, seed=0)
    path_b, _ = train_and_save(tmp_path, "b.txt", 5, seed=1)
    state = str(tmp_path / "serve_state.json")
    args = (f"input_model={path_a}", f"serve_state_file={state}")
    srv = serve_from_config(serve_config(*args)).start()
    try:
        post(base_url(srv), "/reload", {"model": path_b})
    finally:
        srv.stop()
    assert json.load(open(state))["primary"]["model"] == path_b
    srv = serve_from_config(serve_config(*args)).start()
    try:
        r, _ = post(base_url(srv), "/predict", {"rows": X[:3].tolist()})
        want = JaxForest.from_booster(lgb.Booster(model_file=path_b)) \
            .predict(X[:3].astype(np.float32), device_binning=True)
        np.testing.assert_allclose(r["predictions"], want, rtol=0,
                                   atol=1e-6)
    finally:
        srv.stop()
    # a state file naming a missing model boots input_model
    json.dump({"primary": {"model": str(tmp_path / "gone.txt")}},
              open(state, "w"))
    assert serve.ModelManager.restore_path(state) is None


# ---------------------------------------------------------------------------
# serve_walk=gather


@pytest.mark.parametrize("kind", ["binary", "multiclass", "linear"])
def test_gather_walk_matches_fused_and_jax_across_ladder(kind):
    rng = np.random.RandomState(31)
    X = rng.normal(size=(700, 5))
    X[:, 2] = rng.randint(0, 6, size=700)
    X[rng.rand(*X.shape) < 0.05] = np.nan
    X[:, 2] = np.where(np.isnan(X[:, 2]), 1, X[:, 2])
    y = (X[:, 0] + (X[:, 2] > 2) > 0).astype(np.float64)
    params = {"objective": "binary", "num_leaves": 9, "verbose": -1,
              "min_data_in_leaf": 15}
    if kind == "multiclass":
        y = np.digitize(np.nan_to_num(X[:, 0]), [-0.5, 0.5]).astype(float)
        params.update(objective="multiclass", num_class=3)
    if kind == "linear":
        y = np.nan_to_num(X[:, 0]) * 2 + X[:, 2]
        params.update(objective="regression", linear_tree=True)
    bst = lgb.train(params, lgb.Dataset(X, y, categorical_feature=[2]), 4,
                    categorical_feature=[2])
    ours = lt.Booster(model_str=bst.model_to_string(), device="cpu")
    buckets = [16, 64, 256]
    gather = lt.CompiledForest.from_booster(ours, buckets=buckets,
                                            serve_walk="gather")
    fused = lt.CompiledForest.from_booster(ours, buckets=buckets)
    jg = JaxForest.from_booster(bst, buckets=buckets, serve_walk="gather")
    assert gather.info()["serve_walk"] == "gather"
    assert fused.info()["serve_walk"] == "fused"
    Xq = rng.normal(size=(300, 5))
    Xq[:, 2] = rng.randint(0, 8, size=300)          # 6, 7 unseen
    Xq[rng.rand(*Xq.shape) < 0.05] = np.nan
    for n in (1, 15, 16, 17, 64, 65, 300):
        for raw_score in (True, False):
            for dev_bin in (True, False):
                kw = dict(raw_score=raw_score, device_binning=dev_bin)
                g = gather.predict(Xq[:n], **kw)
                np.testing.assert_allclose(g, fused.predict(Xq[:n], **kw),
                                           rtol=0, atol=1e-6)
                np.testing.assert_allclose(
                    g, jg.predict(Xq[:n].astype(np.float32) if dev_bin
                                  else Xq[:n], **kw), rtol=0, atol=1e-6)
