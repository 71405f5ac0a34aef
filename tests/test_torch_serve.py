"""The torch port's serving slice (lightgbm_tpu_torch/) against the JAX
package, end to end on the CPU.

Models are trained and saved by the JAX package; the port loads the text
with ``Booster(model_str=...)`` on ``device="cpu"``, where every kernel
wrapper runs its plain version.  ``Booster.predict`` and
``CompiledForest.predict(device_binning=True)`` are held to the JAX
``Booster.predict`` and ``CompiledForest.predict`` on the same numpy
rows: raw scores and transformed outputs to <= 1e-6 absolute.  A
``PredictServer`` on port 0 answers concurrent ``/predict`` requests with
those numbers and refuses malformed bodies with 400.  Also pinned here:
the device rule (no silent CPU fallback), the import rule (nothing of
JAX in the port), the batcher and the CLI.
"""

import ast
import json
import pathlib
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
from lightgbm_tpu.serve import CompiledForest as JaxForest

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import cli, obs
from lightgbm_tpu_torch.config import Config, parse_cli_args
from lightgbm_tpu_torch.ops import forest_walk as fw
from lightgbm_tpu_torch.serve.batcher import (BatcherClosed, BucketLadder,
                                              MicroBatcher, default_ladder)
from lightgbm_tpu_torch.serve.server import PredictServer, serve_from_config

pytestmark = pytest.mark.torch

REPO = pathlib.Path(__file__).resolve().parent.parent
BUCKETS = [16, 64, 256]
KINDS = ["binary", "multiclass", "categorical"]


def _train(kind: str):
    rng = np.random.RandomState({"binary": 20, "multiclass": 21,
                                 "categorical": 23}[kind])
    X = rng.normal(size=(800, 6))
    X[:, 3] = np.round(X[:, 3] * 4) / 4       # boundary-tied values
    params = {"num_leaves": 15, "verbose": -1, "min_data_in_leaf": 10,
              "objective": "binary"}
    cat = "auto"
    y = (X[:, 0] + 0.3 * X[:, 1] > 0).astype(np.float64)
    if kind == "multiclass":
        y = np.digitize(X[:, 0] + 0.2 * X[:, 2], [-0.5, 0.5]).astype(
            np.float64)
        params.update({"objective": "multiclass", "num_class": 3})
    elif kind == "categorical":
        X[:, 1] = rng.randint(0, 8, size=800)
        y = ((X[:, 0] > 0) ^ (X[:, 1] >= 4)).astype(np.float64)
        cat = [1]
    # train() applies its own categorical_feature (default "auto")
    bst = lgb.train(params, lgb.Dataset(X, label=y, categorical_feature=cat),
                    num_boost_round=6, categorical_feature=cat)
    if cat != "auto":
        assert any((t.decision_type == 1).any()
                   for t in bst._booster.models)
    Xq = rng.normal(size=(300, 6))
    Xq[:, 3] = np.round(Xq[:, 3] * 4) / 4
    if kind == "categorical":
        Xq[:, 1] = rng.randint(0, 10, size=300)       # 8, 9 unseen
        Xq[rng.rand(*Xq.shape) < 0.1] = np.nan
    return bst, Xq


@pytest.fixture(scope="module")
def trained():
    out = {}
    for kind in KINDS:
        bst, X = _train(kind)
        text = bst.model_to_string()
        ours = lt.Booster(model_str=text, device="cpu",
                          params={"predict_buckets": BUCKETS})
        out[kind] = (bst, ours, X)
    return out


# ---------------------------------------------------------------------------
# the slice: Booster and CompiledForest against the JAX package


@pytest.mark.parametrize("kind", KINDS)
def test_booster_predict_matches_jax(trained, kind):
    bst, ours, X = trained[kind]
    for n in (1, 33, 129, 300):
        np.testing.assert_allclose(ours.predict(X[:n], raw_score=True),
                                   bst.predict(X[:n], raw_score=True),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(ours.predict(X[:n]), bst.predict(X[:n]),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind", KINDS)
def test_compiled_forest_matches_jax(trained, kind):
    bst, ours, X = trained[kind]
    jf = JaxForest.from_booster(bst, buckets=BUCKETS)
    tf = lt.CompiledForest.from_booster(ours, device="cpu", buckets=BUCKETS)
    assert tf.info()["num_trees"] == jf.info()["num_trees"]
    for raw in (True, False):
        for dev_bin in (True, False):
            np.testing.assert_allclose(
                tf.predict(X, raw_score=raw, device_binning=dev_bin),
                jf.predict(X, raw_score=raw, device_binning=dev_bin),
                rtol=0, atol=1e-6, err_msg=f"raw={raw} dev={dev_bin}")


def test_num_iteration_limits_the_forest(trained):
    bst, ours, X = trained["multiclass"]
    np.testing.assert_allclose(
        ours.predict(X, num_iteration=2, raw_score=True),
        bst.predict(X, num_iteration=2, raw_score=True), rtol=0, atol=1e-6)
    assert lt.CompiledForest.from_booster(
        ours, num_iteration=2).num_trees == 2 * 3


def test_unported_strategies_raise_named_errors(trained):
    bst, ours, X = trained["binary"]
    # serve_walk=gather is ported since: the plain per-level walk, named
    # by info(); the JAX package's gather walk gives the same answers
    cf = lt.CompiledForest.from_booster(ours, serve_walk="gather")
    assert cf.info()["serve_walk"] == "gather"
    want = JaxForest.from_booster(bst, serve_walk="gather").predict(
        X.astype(np.float32), device_binning=True)
    np.testing.assert_allclose(cf.predict(X, device_binning=True), want,
                               rtol=0, atol=1e-6)
    # bf16 leaves are ported: the pin decides, and info() says which
    cf = lt.CompiledForest.from_booster(ours, quantize_leaves=True)
    assert cf.info()["leaf_dtype"] in ("float32", "bfloat16")
    with pytest.raises(lt.LightGBMError, match="serve_walk must be"):
        lt.CompiledForest.from_booster(ours, serve_walk="xla")


def test_warmup_runs_every_bucket_without_kernel_launches(trained):
    _, ours, _ = trained["binary"]
    fw.reset_launch_counts()
    cf = lt.CompiledForest.from_booster(ours, device="cpu",
                                        buckets=[16, 64, 256, 1024])
    assert cf.warmup(max_bucket=100) is cf
    assert all(v == 0 for v in fw.launch_counts().values())
    info = cf.info()
    assert info["serve_walk"] == "fused" and info["device"] == "cpu"


# ---------------------------------------------------------------------------
# device and import rules


def test_default_device_without_card_raises(trained, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    text = trained["binary"][0].model_to_string()
    for device in (None, "cuda", "cuda:0"):
        with pytest.raises(lt.LightGBMError, match="no CUDA device"):
            lt.Booster(model_str=text, device=device)
    with pytest.raises(lt.LightGBMError, match="not supported"):
        lt.Booster(model_str=text, device="meta")
    assert lt.Booster(model_str=text, device="cpu").device.type == "cpu"


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_nothing_of_jax():
    files = sorted((REPO / "lightgbm_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 15
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "lightgbm_tpu"), \
                f"{path.relative_to(REPO)} imports {mod}"


# ---------------------------------------------------------------------------
# HTTP server


def _post(base, payload, content_type="application/json"):
    body = payload if isinstance(payload, bytes) else \
        json.dumps(payload).encode()
    req = urllib.request.Request(base + "/predict", data=body,
                                 headers={"Content-Type": content_type})
    return json.loads(urllib.request.urlopen(req, timeout=30).read())


def _get(base, path):
    return json.loads(urllib.request.urlopen(base + path, timeout=30).read())


@pytest.fixture
def server(trained):
    bst, ours, X = trained["multiclass"]
    cf = lt.CompiledForest.from_booster(ours, device="cpu", buckets=BUCKETS)
    cf.warmup()
    obs.reset()
    srv = PredictServer(cf, port=0, max_batch=256, max_delay_ms=20.0,
                        max_body_bytes=40000).start()
    host, port = srv.address
    yield srv, f"http://{host}:{port}", bst, X
    srv.stop()


def test_server_concurrent_predict_matches_jax(server):
    srv, base, bst, X = server
    jf = JaxForest.from_booster(bst, buckets=BUCKETS)
    want = jf.predict(X.astype(np.float32), device_binning=True)
    want_raw = jf.predict(X.astype(np.float32), raw_score=True,
                          device_binning=True)
    spans = [(0, 1), (1, 20), (20, 84), (84, 150), (150, 151), (151, 300)]
    got = {}

    def client(lo, hi):
        r = _post(base, {"rows": X[lo:hi].tolist()})
        assert r["num_rows"] == hi - lo and "request_id" in r
        got[lo] = np.asarray(r["predictions"])

    threads = [threading.Thread(target=client, args=s) for s in spans]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    for lo, hi in spans:
        np.testing.assert_allclose(got[lo], want[lo:hi], rtol=0, atol=1e-6)
    r = _post(base, {"rows": X[:4].tolist(), "raw_score": True})
    np.testing.assert_allclose(r["predictions"], want_raw[:4], rtol=0,
                               atol=1e-6)
    csv = "\n".join(",".join(f"{v:.9g}" for v in row) for row in X[:3])
    r = _post(base, csv.encode(), "text/csv")
    np.testing.assert_allclose(r["predictions"], want[:3], rtol=0,
                               atol=1e-6)
    # /stats holds the JAX package's registry contract (the counters of
    # the single-forest server renamed to its serve_* series)
    counters = _get(base, "/stats")["counters"]
    assert counters["serve_requests"] == len(spans) + 2
    assert 1 <= counters["serve_batches"] <= counters["serve_requests"]
    assert counters["serve_rows"] == 300 + 4 + 3
    stats = _get(base, "/stats")
    assert set(stats["kernel_launches"]) == set(fw.VARIANTS)
    assert {"forest_walk", "forest_walk_raw"} <= set(fw.VARIANTS)


@pytest.mark.parametrize("case", ["ragged", "nan", "width", "text",
                                  "malformed", "empty"])
def test_server_rejects_bad_requests_with_400(server, case):
    srv, base, _, X = server
    rows = X[:3].tolist()
    body = {"ragged": {"rows": [rows[0], rows[1][:4]]},
            "nan": {"rows": [rows[0], rows[1][:2] + [float("nan")]
                             + rows[1][3:]]},
            "width": {"rows": [r[:5] for r in rows]},
            "text": {"rows": [rows[0][:5] + ["x"]]},
            "malformed": b"{nope",
            "empty": {"rows": []}}[case]
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(base, body)
    assert err.value.code == 400
    msg = json.loads(err.value.read())["error"]
    if case in ("ragged", "nan"):
        assert "row 1" in msg
    counters = _get(base, "/stats")["counters"]
    assert counters["serve_bad_requests"] == 1
    assert counters.get("serve_requests", 0) == 0


def test_server_oversize_body_gets_413_and_health_endpoints(server):
    srv, base, bst, X = server
    big = {"rows": np.zeros((2000, 6)).tolist()}
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(base, big)
    assert err.value.code == 413
    health = _get(base, "/healthz")
    assert health["status"] == "ok" and health["num_class"] == 3
    assert health["num_trees"] == bst.num_trees()
    assert _get(base, "/readyz")["status"] == "ready"
    srv.stop()
    srv.stop()                                # idempotent
    with pytest.raises(Exception):
        urllib.request.urlopen(base + "/healthz", timeout=1)


def test_serve_from_config_on_port_zero(trained, tmp_path):
    bst, _, X = trained["binary"]
    model = tmp_path / "m.txt"
    bst.save_model(str(model))
    cfg = Config(parse_cli_args([
        "task=serve", f"input_model={model}", "serve_port=0", "device=cpu",
        "serve_max_batch=64", "predict_buckets=16,64,256",
        "serve_nonfinite_policy=propagate"]))
    srv = serve_from_config(cfg).start()
    try:
        host, port = srv.address
        Xn = X[:5].copy()
        Xn[1, 2] = np.nan
        r = _post(f"http://{host}:{port}", {"rows": Xn.tolist()})
        want = JaxForest.from_booster(bst).predict(
            Xn.astype(np.float32), device_binning=True)
        np.testing.assert_allclose(r["predictions"], want, rtol=0,
                                   atol=1e-6)
        assert srv.forest.ladder.sizes == [16, 64]
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# micro-batcher and ladder


def test_bucket_ladder_matches_jax_ladder():
    from lightgbm_tpu.serve import BucketLadder as JaxLadder
    from lightgbm_tpu.serve import default_ladder as jax_default_ladder
    assert default_ladder() == jax_default_ladder()
    for sizes in ([64, 16, 256, 16], [7], None):
        ours, theirs = BucketLadder(sizes), JaxLadder(sizes)
        assert ours.sizes == theirs.sizes
        for n in (0, 1, 16, 17, 255, 256, 600, 70000):
            assert ours.chunks(n) == theirs.chunks(n)
    with pytest.raises(ValueError):
        BucketLadder([0, 16])


def test_microbatcher_coalesces_and_propagates_errors():
    gate = threading.Event()
    seen = []

    def fn(rows):
        gate.wait(5)
        seen.append(rows.shape[0])
        if (rows < 0).any():
            raise ValueError("negative row")
        return rows.T * 2.0, rows.T

    obs.reset()
    mb = MicroBatcher(fn, max_batch=64, max_delay_s=0.05)
    results = {}

    def client(i):
        results[i] = mb.submit(np.full((3, 2), float(i)))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(5)]
    for t in threads:
        t.start()
    gate.set()
    for t in threads:
        t.join(10)
    # the registry's serve_* series (the batcher's own counts before
    # the fleet was ported)
    assert obs.get_counter("serve_requests") == 5
    assert obs.get_counter("serve_batches") < 5 and sum(seen) == 15
    for i, (a, b) in results.items():
        np.testing.assert_array_equal(a, np.full((2, 3), 2.0 * i))
    with pytest.raises(ValueError, match="negative row"):
        mb.submit(-np.ones((1, 2)))
    mb.close()
    with pytest.raises(BatcherClosed):
        mb.submit(np.ones((1, 2)))


# ---------------------------------------------------------------------------
# CLI and config


def test_cli_predict_matches_jax(trained, tmp_path):
    bst, _, X = trained["multiclass"]
    model = tmp_path / "m.txt"
    bst.save_model(str(model))
    data = tmp_path / "rows.csv"
    np.savetxt(data, np.column_stack([np.zeros(len(X)), X]),
               delimiter=",", fmt="%.17g")
    out = tmp_path / "preds.txt"
    rc = cli.main(["task=predict", f"data={data}", f"input_model={model}",
                   f"output_result={out}", "device=cpu"])
    assert rc == 0
    np.testing.assert_allclose(np.loadtxt(out), bst.predict(X), rtol=1e-5,
                               atol=1e-6)


def test_cli_serve_token_and_unported_task(monkeypatch):
    seen = {}

    def fake_serve(config, params):
        seen.update(task=config.task, port=config.serve_port,
                    buckets=config.predict_buckets, device=config.device)

    monkeypatch.setattr(cli, "run_serve", fake_serve)
    assert cli.main(["serve", "input_model=nope.txt", "serve_port=12345",
                     "predict_buckets=16,64"]) == 0
    assert seen == {"task": "serve", "port": 12345, "buckets": [16, 64],
                    "device": "cuda"}
    # a training setting the port refuses, before the data is read
    with pytest.raises(lt.LightGBMError, match="not ported"):
        cli.main(["task=train", "data=x.csv", "tree_learner=data"])


def test_config_defaults_and_aliases_match_jax(tmp_path):
    from lightgbm_tpu.config import Config as JaxConfig
    conf = tmp_path / "serve.conf"
    conf.write_text("model_in = a.txt  # alias\nserve_port = 9000\n"
                    "num_leaves = 63\n")
    params = parse_cli_args([f"config={conf}", "serve_port=9100",
                             "predict_result=out.txt"])
    ours, theirs = Config(params), JaxConfig(params)
    for key in ("task", "input_model", "output_result", "data",
                "serve_host", "serve_port", "serve_max_batch",
                "serve_max_delay_ms", "predict_buckets", "serve_walk",
                "serve_nonfinite_policy", "serve_max_body_bytes",
                "serve_quantize_leaves"):
        assert getattr(ours, key) == getattr(theirs, key), key
    assert ours.input_model == "a.txt" and ours.serve_port == 9100
    with pytest.raises(ValueError, match="serve_nonfinite_policy"):
        Config({"serve_nonfinite_policy": "drop"})
