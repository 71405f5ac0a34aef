"""The drift observatory (lightgbm_tpu_torch/obs/drift.py), the model
file's fingerprint section and ``train_delta`` against the JAX package,
on the CPU.

``DataFingerprint.from_training`` writes the same text, byte for byte,
on the same matrix and labels (numeric and categorical); a port-trained
model carries the section with every line equal to the JAX package's but
``score_hist`` (its edges within 1e-5, its counts within the training
scores that close to an edge); each package parses the other's; a
damaged section raises the same named error.  ``DriftCollector`` gives
the same PSI, KL and L-inf per feature and the same top-k order for the
same row stream; ``compare_to_data`` the same report for the same fresh
matrix; ``train_delta`` the same trees and skew warnings.  Over HTTP
with ``drift=on``, the collector's PSI equals a host recomputation over
the rows sent and the shifted feature leads the top-k.
"""

import urllib.request

import numpy as np
import pytest

import chip_smoke as cs
import lightgbm_tpu as lgb
from lightgbm_tpu import obs as jobs
from lightgbm_tpu.io.dataset import BinnedDataset as JaxBinned
from lightgbm_tpu.obs import drift as jdrift
from lightgbm_tpu.utils.log import LightGBMError as JaxError

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import obs
from lightgbm_tpu_torch.io.dataset import BinnedDataset
from lightgbm_tpu_torch.obs import drift

from test_torch_fleet import base_url, get, post, serve_config
from test_torch_train import assert_fingerprint_tails_match

pytestmark = pytest.mark.torch

PARAMS = {"objective": "binary", "num_leaves": 7, "verbose": -1,
          "min_data_in_leaf": 20, "learning_rate": 0.2}


def _matrix(seed, n=600, categorical=False, shift=0.0):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, 5))
    X[rng.rand(n, 5) < 0.04] = np.nan
    if categorical:
        X[:, 2] = rng.randint(0, 7, size=n)
    X[:, 0] += shift
    X[:, 3] += shift
    y = (np.nan_to_num(X[:, 0]) + 0.5 * np.nan_to_num(X[:, 1]) > shift) \
        .astype(np.float64)
    return X, y


@pytest.mark.parametrize("categorical", [False, True, "bundled"])
def test_fingerprint_from_training_is_byte_equal(categorical):
    X, y = _matrix(1, categorical=categorical is True)
    cat = [2] if categorical is True else []
    kw = dict(max_bin=63, min_data_in_leaf=20, categorical_features=cat)
    if categorical == "bundled":
        # exclusive sparse columns: EFB bundles them (the port counts
        # each feature's bins while it encodes the bundle's column)
        rng = np.random.RandomState(9)
        hot = rng.randint(0, 6, size=len(X))
        X = np.concatenate([X, np.where(
            hot[:, None] == np.arange(6)[None, :],
            rng.randint(1, 4, size=(len(X), 6)), 0).astype(float)], axis=1)
        kw["enable_bundle"] = True
    ds = BinnedDataset.from_matrix(X, y, **kw)
    ours = ds.data_fingerprint
    theirs = JaxBinned.from_matrix(X, y, **kw).data_fingerprint
    assert ours.to_text() == theirs.to_text()
    assert (ds.bundle_plan is not None) == (categorical == "bundled")
    assert any(f["kind"] == "cat" for f in ours.features) == \
        (categorical is True)
    # the label-free form, and the sections each package parses back
    assert BinnedDataset.from_matrix(X, None, **kw).data_fingerprint \
        .to_text() == JaxBinned.from_matrix(X, None, **kw) \
        .data_fingerprint.to_text()
    text = theirs.to_text()
    assert drift.DataFingerprint.parse(text).to_text() == text
    assert jdrift.DataFingerprint.parse(ours.to_text()).to_text() == text


@pytest.mark.parametrize("categorical", [False, True])
def test_port_trained_model_carries_the_jax_section(categorical):
    X, y = _matrix(2, categorical=categorical)
    cat = [2] if categorical else "auto"
    bj = lgb.train(PARAMS, lgb.Dataset(X, y, categorical_feature=cat), 3,
                   categorical_feature=cat)
    bt = lt.train(PARAMS, lt.Dataset(X, y), 3, device="cpu",
                  categorical_feature=cat, verbose_eval=False)
    ours, theirs = bt.model_to_string(), bj.model_to_string()
    assert "\ndata_fingerprint\n" in ours
    assert_fingerprint_tails_match(ours, theirs,
                                   bt._booster.train_data.host_score())
    # each package parses the other's section
    mine = lt.Booster(model_str=theirs, device="cpu")._booster
    assert mine.data_fingerprint.to_text() == \
        jdrift.parse_model_fingerprint(theirs).to_text()
    assert jdrift.parse_model_fingerprint(ours).to_text() == \
        drift.parse_model_fingerprint(ours).to_text()


@pytest.mark.parametrize("mode", ["truncated", "version", "feature",
                                  "counts"])
def test_damaged_section_raises_the_jax_error(mode):
    X, y = _matrix(3)
    text = lgb.train(PARAMS, lgb.Dataset(X, y), 2).model_to_string()
    bad = {"truncated": lambda t: t.replace("end data_fingerprint\n", ""),
           "version": lambda t: t.replace("version=1", "version=7"),
           "feature": lambda t: t.replace("feature=0:num:", "feature=0:x:"),
           "counts": lambda t: t.replace(":num:", ":num:0.5:@,", 1)}[mode](
               text)
    with pytest.raises(JaxError) as want:
        lgb.Booster(model_file=_write(bad))
    with pytest.raises(lt.LightGBMError) as got:
        lt.Booster(model_str=bad, device="cpu")
    assert str(got.value) == str(want.value)


def _write(text):
    import tempfile
    fh = tempfile.NamedTemporaryFile("w", suffix=".txt", delete=False)
    fh.write(text)
    fh.close()
    return fh.name


def _fingerprints():
    X, y = _matrix(4, n=2000, categorical=True)
    fp = JaxBinned.from_matrix(X, y, max_bin=63, min_data_in_leaf=20,
                               categorical_features=[2]).data_fingerprint
    fp.set_score_hist(np.random.RandomState(5).normal(size=2000))
    text = fp.to_text()
    return jdrift.DataFingerprint.parse(text), \
        drift.DataFingerprint.parse(text)


def _windows(mod, reg, fp):
    reg.reset()
    col = mod.DriftCollector(fp, model="canary", top_k=3, threshold=0.25,
                             start_thread=False)
    out = []
    for k, shift in enumerate((0.0, 0.0, 2.5, 2.5)):
        X, _ = _matrix(10 + k, n=700, categorical=True, shift=shift)
        scores = np.random.RandomState(20 + k).normal(size=700) + shift
        for lo in range(0, 700, 97):
            col.offer(X[lo:lo + 97], scores[lo:lo + 97])
        win = col.flush()
        out.append((win, col.sustained_offenders()))
    stats = col.stats()
    stats.pop("overhead_s")
    col.close()
    gauges = {k: v for k, v in reg.snapshot()["gauges"].items()
              if k.startswith("drift_") and "overhead" not in k}
    return out, stats, gauges


def test_drift_collector_matches_jax():
    fj, ft = _fingerprints()
    (wj, sj, gj), (wt, st, gt) = _windows(jdrift, jobs, fj), \
        _windows(drift, obs, ft)
    for (a, oa), (b, ob) in zip(wj, wt):
        assert b["top"] == a["top"] and ob == oa
        assert b["rows"] == a["rows"] and b["score_psi"] == a["score_psi"]
        for name, rec in a["features"].items():
            got = b["features"][name]
            np.testing.assert_array_equal(got["counts"], rec["counts"])
            for key in ("psi", "kl", "linf", "missing_delta"):
                assert abs(got[key] - rec[key]) <= 1e-12, (name, key)
    assert st == sj and gt == gj
    assert wt[-1][1] == sorted(wt[-1][1]) and wt[-1][1]    # sustained
    assert {"Column_0", "Column_3"} <= set(wt[-1][0]["top"])


def test_compare_to_data_matches_jax():
    fj, ft = _fingerprints()
    for shift in (0.0, 3.0):
        X, _ = _matrix(30, n=900, categorical=True, shift=shift)
        assert drift.compare_to_data(ft, X, top_k=4) == \
            jdrift.compare_to_data(fj, X, top_k=4)
    assert drift.compare_fingerprints(ft, ft) == \
        jdrift.compare_fingerprints(fj, fj)
    for fn in ("psi", "kl", "linf"):
        e, a = np.arange(1, 40.0), np.arange(40.0, 1, -1)
        assert getattr(drift, fn)(e, a) == getattr(jdrift, fn)(e, a)
    assert [x.tolist() for x in drift.coarsen(e, a)] == \
        [x.tolist() for x in jdrift.coarsen(e, a)]


@pytest.mark.parametrize("shift", [0.0, 3.0])
def test_train_delta_matches_jax(tmp_path, shift, capsys, monkeypatch):
    # both packages log warnings (other tests leave the levels lower)
    from lightgbm_tpu.utils import log as jlog
    from lightgbm_tpu_torch.utils import log as tlog
    monkeypatch.setattr(jlog, "_current_level", 1)
    monkeypatch.setattr(tlog, "_current_level", 1)
    X, y = _matrix(40, n=800)
    base = str(tmp_path / "base.txt")
    lgb.train(PARAMS, lgb.Dataset(X, y), 3).save_model(base)
    Xf, yf = _matrix(41, n=800, shift=shift)
    for reg in (jobs, obs):
        reg.reset()
    capsys.readouterr()
    bj = lgb.train_delta(base, lgb.Dataset(Xf, yf), num_trees=3,
                         params=PARAMS)
    warn_j = _delta_warning(capsys.readouterr().err)
    bt = lt.train_delta(base, lt.Dataset(Xf, yf), num_trees=3,
                        params=PARAMS, device="cpu", verbose_eval=False)
    warn_t = _delta_warning(capsys.readouterr().err)
    trees, flip, _ = cs.compare_model_texts(
        bt.model_to_string(), bj.model_to_string(), "train_delta",
        names=("torch", "jax"), tie_rtol=1e-5, leaf_rtol=1e-5)
    assert flip is None and trees == 6
    assert warn_t == warn_j
    assert obs.get_counter("drift_skew_warnings_total") == \
        jobs.get_counter("drift_skew_warnings_total") == int(shift > 0)
    # the delta model carries the fresh data's fingerprint
    assert_fingerprint_tails_match(bt.model_to_string(),
                                   bj.model_to_string(),
                                   bt._booster.train_data.host_score())
    assert bt._booster.data_fingerprint.num_rows == 800
    assert bt._booster.data_fingerprint is not \
        lt.Booster(model_file=base, device="cpu")._booster.data_fingerprint


def _delta_warning(err):
    lines = [ln.split("train_delta:", 1)[1] for ln in err.splitlines()
             if "train_delta:" in ln]
    return lines


def test_drift_over_http_psi_equals_host_recompute(tmp_path):
    X, y = _matrix(50, n=1500)
    path = str(tmp_path / "m.txt")
    lt.train(PARAMS, lt.Dataset(X, y), 3, device="cpu",
             verbose_eval=False).save_model(path)
    fp = drift.parse_model_fingerprint(open(path).read())
    obs.reset()
    srv = lt.serve.serve_from_config(serve_config(
        f"input_model={path}", "drift=on", "drift_window=3600",
        "drift_top_k=2", "serve_nonfinite_policy=propagate")).start()
    base = base_url(srv)
    try:
        health = get(base, "/healthz")
        assert health["fingerprint"] is True and health["drift"] is True
        sent = []
        for shift in (0.0, 4.0):
            Xs, _ = _matrix(51, n=400, shift=shift)
            for lo in range(0, 400, 50):
                post(base, "/predict", {"rows": Xs[lo:lo + 50].tolist()})
            sent.append(Xs.astype(np.float32).astype(np.float64))
            srv.drift["primary"].flush()
        stats = get(base, "/stats")["drift"]["primary"]
        text = urllib.request.urlopen(base + "/metrics").read().decode()
    finally:
        srv.stop()
    assert stats["windows"] == 2 and stats["rows"] == 800
    last = {t["feature"]: t["psi"] for t in stats["last"]["top"]}
    want = {}
    for feat, cnt in zip(fp.features, fp.rebin_counts(sent[1])):
        eg, ag = drift.coarsen(feat["counts"], cnt)
        want[feat["name"]] = round(drift.psi(eg, ag), 6)
    for name, psi in last.items():
        assert psi == want[name]
    assert set(last) == {"Column_0", "Column_3"}
    assert stats["trajectory"][0]["max_psi"] < 0.25 < min(last.values())
    parsed = lt.obs.prom.parse_text(text)
    psis = {s[1]["feature"]: s[2] for s in parsed["samples"]
            if s[0] == "lightgbm_tpu_drift_psi"}
    assert psis["Column_0"] == last["Column_0"]
