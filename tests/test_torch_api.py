"""The rest of the torch port's ``Dataset`` and ``Booster`` API against
the JAX package: the scipy and pandas adapters, binary dataset files,
``dump_model``, ``feature_importance``, attributes, pickling, file
prediction, and the two argument faults fixed since the API was first
ported (``Dataset``'s positional order, the binary-file keys).

The same seeded numpy inputs go to both packages on ``device="cpu"``;
trees are held structure-equal and leaf values within 1e-5 (the dumps'
floats within 1e-4), predictions within 1e-6.
``examples/python-guide/advanced_example.py`` runs as written with the
port in place of the JAX package.
"""

import copy
import functools
import json
import os
import pathlib
import pickle
import shutil
import types

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp

import lightgbm_tpu as lgb
from lightgbm_tpu.io.dataset import BinnedDataset as JaxBinned

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.io.dataset import BinnedDataset
from lightgbm_tpu_torch.utils import log

from test_torch_sparse import one_hot_data
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = [pytest.mark.torch, pytest.mark.sparse]

REPO = pathlib.Path(__file__).resolve().parents[1]
PARAMS = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 20,
          "max_bin": 63, "verbose": -1, "metric": "auc"}
ROUNDS = 4


def _dense(n=2000, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, 6))
    y = (X[:, 0] + 0.5 * X[:, 1] ** 2 + 0.3 * rng.normal(size=n)
         > 0.4).astype(np.float64)
    return X, y


def _same_trees(jm, tm, label):
    assert len(jm) == len(tm) > 0, label
    for i, (a, b) in enumerate(zip(jm, tm)):
        n = a.num_leaves - 1
        assert a.num_leaves == b.num_leaves, (label, i)
        for field in ("split_feature", "threshold", "decision_type",
                      "left_child", "right_child"):
            np.testing.assert_array_equal(getattr(b, field),
                                          getattr(a, field)[:n],
                                          err_msg=f"{label} tree {i}")
        np.testing.assert_allclose(
            b.leaf_value, a.leaf_value[:n + 1], rtol=0,
            atol=1e-5 * np.abs(a.leaf_value).max(),
            err_msg=f"{label} tree {i}")


@pytest.fixture(scope="module")
def models():
    """The JAX package's and the port's 3-class models on the same rows
    (a noisy label: without the noise, the classes' gains meet f32
    near-ties, which the two packages may break apart)."""
    X, _ = _dense(1500, seed=3)
    noise = 0.5 * np.random.RandomState(3).normal(size=len(X))
    y = np.digitize(X[:, 0] + X[:, 2] + noise,
                    [-0.5, 0.5]).astype(np.float64)
    params = {**PARAMS, "objective": "multiclass", "num_class": 3,
              "metric": "multi_logloss"}
    bj = lgb.train(params, lgb.Dataset(X, y), ROUNDS, verbose_eval=False)
    bt = lt.train(params, lt.Dataset(X, y), ROUNDS, device="cpu",
                  verbose_eval=False)
    return X, bj, bt


# ---------------------------------------------------------------------------
# the adapters


def test_scipy_csr_trains_and_predicts_like_jax():
    X, y = one_hot_data(2000, seed=2)
    csr = sp.csr_matrix(X)
    bj = lgb.train(PARAMS, lgb.Dataset(csr, y), ROUNDS, verbose_eval=False)
    bt = lt.train(PARAMS, lt.Dataset(csr, y), ROUNDS, device="cpu",
                  verbose_eval=False)
    assert bt._booster.train_set.bundle_plan is not None
    _same_trees(bj._booster.models, bt._booster.models, "csr")
    dense = lt.train(PARAMS, lt.Dataset(X, y), ROUNDS, device="cpu",
                     verbose_eval=False)
    assert dense.model_to_string() == bt.model_to_string()
    for q in (sp.csr_matrix(X[:400]), sp.csc_matrix(X[:400]), X[:400]):
        np.testing.assert_allclose(bt.predict(q), bj.predict(q), rtol=0,
                                   atol=1e-6)


def test_pandas_category_is_a_categorical_feature():
    X, y = _dense(2000, seed=4)
    rng = np.random.RandomState(5)
    cat = rng.randint(0, 6, size=len(y))
    y = ((y + (cat % 3 == 0)) > 0.5).astype(np.float64)
    df = pd.DataFrame(X, columns=[f"f{i}" for i in range(X.shape[1])])
    df["kind"] = pd.Categorical.from_codes(cat, list("abcdef"))
    bj = lgb.train(PARAMS, lgb.Dataset(df, y), ROUNDS, verbose_eval=False)
    bt = lt.train(PARAMS, lt.Dataset(df, y), ROUNDS, device="cpu",
                  verbose_eval=False)
    assert bt.feature_name() == bj.feature_name() == list(df.columns)
    _same_trees(bj._booster.models, bt._booster.models, "pandas")
    kind = list(df.columns).index("kind")
    splits = [(f, d) for t in bt._booster.models
              for f, d in zip(t.split_feature, t.decision_type)]
    assert (kind, 1) in splits, "no categorical split on the category"
    np.testing.assert_allclose(bt.predict(df), bj.predict(df), rtol=0,
                               atol=1e-6)
    assert bt._booster.train_set.is_categorical_per_feature()[kind]


# ---------------------------------------------------------------------------
# the Dataset


def test_positional_max_bin_is_bound_like_jax():
    """Fault 1: the JAX order (data, label, max_bin, reference, ...)."""
    X, y = _dense(1500)
    t = lt.Dataset(X, y, 15).construct()._binned
    j = lgb.Dataset(X, y, 15).construct()._binned
    assert t.max_bin == j.max_bin == 15
    np.testing.assert_array_equal(t.bins, j.bins)
    assert max(m.num_bin for m in t.mappers) <= 15
    # params win over the argument, as in the JAX package
    t = lt.Dataset(X, y, 15, params={"max_bin": 31}).construct()._binned
    j = lgb.Dataset(X, y, 15, params={"max_bin": 31}).construct()._binned
    np.testing.assert_array_equal(t.bins, j.bins)
    ref = lt.Dataset(X, y)
    valid = lt.Dataset(X[:300], y[:300], 255, ref, None, None, True)
    assert valid.reference is ref and valid.silent
    assert lt.Dataset(X, y, init_score=np.ones(len(y))).get_init_score()[0] \
        == 1.0


def test_setters_and_num_feature_like_jax():
    X, y = _dense(1200)
    w = np.linspace(0.5, 1.5, len(y))
    group = [400, 500, 300]
    pairs = []
    for pkg in (lgb, lt):
        ds = pkg.Dataset(X, y)
        ds.set_weight(w).set_group(group)
        ds.construct()
        ds.set_weight(w * 2).set_group([600, 600])
        pairs.append(ds)
    dj, dt = pairs
    np.testing.assert_array_equal(dt.get_weight(), dj.get_weight())
    np.testing.assert_array_equal(dt.get_group(), dj.get_group())
    assert dt.num_feature() == dj.num_feature() == 6
    ref = lt.Dataset(X, y)
    fresh = lt.Dataset(X[:100], y[:100]).set_reference(ref)
    assert fresh.reference is ref
    with pytest.raises(lt.LightGBMError, match="Cannot set reference"):
        dt.set_reference(ref)


def test_binary_files_load_across_packages(tmp_path):
    X, y = one_hot_data(1500, seed=6)
    params = {**PARAMS, "linear_tree": True}
    dt = lt.Dataset(X, y, params=params, weight=np.full(len(y), 0.5))
    dj = lgb.Dataset(X, y, params=params, weight=np.full(len(y), 0.5))
    dt.save_binary(str(tmp_path / "port.bin"))
    dj.save_binary(str(tmp_path / "jax.bin"))
    assert not (tmp_path / "port.bin.tmp").exists()
    for path in ("port.bin", "jax.bin"):
        assert BinnedDataset.is_binary_file(str(tmp_path / path))
        a = BinnedDataset.load_binary(str(tmp_path / path))
        b = JaxBinned.load_binary(str(tmp_path / path))
        assert a.bundle_plan is not None
        assert a.bundle_plan.signature() == b.bundle_plan.signature()
        for key in ("bins", "raw", "real_to_inner"):
            np.testing.assert_array_equal(getattr(a, key), getattr(b, key))
        for key in ("label", "weights"):
            np.testing.assert_array_equal(getattr(a.metadata, key),
                                          getattr(b.metadata, key))
        assert [m.to_state() for m in a.mappers] == \
            [m.to_state() for m in b.mappers]
        assert (a.feature_names, a.max_bin, a.used_feature_map) == \
            (b.feature_names, b.max_bin, b.used_feature_map)
    assert not BinnedDataset.is_binary_file(str(tmp_path / "absent"))
    # a Dataset of the file trains the in-memory Dataset's trees
    want = lt.train(PARAMS, lt.Dataset(X, y, params=params,
                                       weight=np.full(len(y), 0.5)),
                    ROUNDS, device="cpu", verbose_eval=False)
    # (the trees and the footer; a binary file carries no drift
    # fingerprint, in either package, so only the in-memory model has
    # the section after the footer)
    cut = "\ndata_fingerprint\n"
    assert cut in want.model_to_string()
    for path in ("port.bin", "jax.bin"):
        got = lt.train(PARAMS, lt.Dataset(str(tmp_path / path),
                                          params=params),
                       ROUNDS, device="cpu", verbose_eval=False)
        assert got.model_to_string() == \
            want.model_to_string().split(cut)[0]
        assert JaxBinned.load_binary(str(tmp_path / path)) \
            .data_fingerprint is None


# ---------------------------------------------------------------------------
# the Booster


def test_dump_model_and_importance_equal_jax(models):
    X, bj, bt = models
    dj, dt = bj.dump_model(), bt.dump_model()
    assert dt.keys() == dj.keys()
    for key in ("name", "num_class", "label_index", "max_feature_idx",
                "feature_names"):
        assert dt[key] == dj[key], key
    assert len(dt["tree_info"]) == len(dj["tree_info"]) == 3 * ROUNDS

    def close(a, b, path):
        if isinstance(a, dict):
            assert a.keys() == b.keys(), path
            for k in a:
                close(a[k], b[k], f"{path}.{k}")
        elif isinstance(a, float):
            # gains and internal values are f32 sums in another order
            # (up to ~1.4e-5 of a gain here; tests/test_torch_train.py
            # holds values to 1e-4 as well)
            assert abs(a - b) <= 1e-4 * max(1.0, abs(b)), (path, a, b)
        else:
            assert a == b, (path, a, b)
    for i, (a, b) in enumerate(zip(dt["tree_info"], dj["tree_info"])):
        close(a, b, f"tree {i}")
    json.dumps(dt)
    assert bt.dump_model(num_iteration=2)["tree_info"] == \
        dt["tree_info"][:6]
    np.testing.assert_array_equal(bt.feature_importance(),
                                  bj.feature_importance())
    assert bt.feature_importance().dtype == np.int64
    np.testing.assert_allclose(bt.feature_importance("gain"),
                               bj.feature_importance("gain"), rtol=1e-5)
    assert bt.feature_name() == bj.feature_name()
    for a, b in zip(bj._booster.models, bt._booster.models):
        assert b.max_depth() == a.max_depth() > 1


def test_linear_leaves_in_the_dump():
    X, y = _dense(1500, seed=8)
    params = {**PARAMS, "linear_tree": True, "linear_max_leaf_features": 2}
    bt = lt.train(params, lt.Dataset(X, y, params=params), 2, device="cpu",
                  verbose_eval=False)
    leaf = bt.dump_model()["tree_info"][0]["tree_structure"]
    while "leaf_index" not in leaf:
        leaf = leaf["left_child"]
    tree = bt._booster.models[0]
    keep = tree.leaf_feat[leaf["leaf_index"]] >= 0
    assert leaf["leaf_features"] == tree.leaf_feat[
        leaf["leaf_index"]][keep].tolist()
    assert len(leaf["leaf_coeff"]) == len(leaf["leaf_features"]) > 0


def test_attributes_pickle_and_copy(models):
    X, bj, bt = models
    assert bt.attr("note") is None
    bt.set_attr(note="hello", n=3)
    assert bt.attr("note") == "hello" and bt.attr("n") == "3"
    bt.set_attr(n=None)
    assert bt.attr("n") is None
    want = bt.predict(X[:200])
    for clone in (pickle.loads(pickle.dumps(bt)), copy.deepcopy(bt),
                  copy.copy(bt)):
        assert clone.device == bt.device
        assert clone.attr("note") == "hello"
        assert clone.model_to_string() == bt.model_to_string()
        np.testing.assert_array_equal(clone.predict(X[:200]), want)
    bj2 = pickle.loads(pickle.dumps(bj))
    np.testing.assert_allclose(want, bj2.predict(X[:200]), rtol=0, atol=1e-6)


def test_predict_a_file_and_its_chunks(models, tmp_path, monkeypatch):
    X, bj, bt = models
    path = tmp_path / "rows.csv"
    rows = np.column_stack([np.zeros(len(X)), X])
    np.savetxt(path, rows, delimiter=",", fmt="%.17g",
               header=",".join(["y"] + [f"f{i}" for i in range(6)]),
               comments="")
    for kw in ({}, {"is_reshape": False}, {"raw_score": True},
               {"pred_leaf": True}):
        got = bt.predict(str(path), data_has_header=True, **kw)
        want = bj.predict(str(path), data_has_header=True, **kw)
        assert got.shape == want.shape, kw
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6,
                                   err_msg=str(kw))
    # the same in chunks of 256 rows
    monkeypatch.setattr(lt.Booster, "_PREDICT_CHUNK_ROWS", 256)
    monkeypatch.setattr(lgb.Booster, "_PREDICT_CHUNK_ROWS", 256)
    parts_t = list(bt.predict_chunks(str(path), data_has_header=True))
    parts_j = list(bj.predict_chunks(str(path), data_has_header=True))
    assert [p.shape for p in parts_t] == [p.shape for p in parts_j]
    assert parts_t[0].shape == (3, 256)
    for a, b in zip(parts_t, parts_j):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    empty = tmp_path / "empty.csv"
    empty.write_text("")
    assert bt.predict(str(empty)).shape == bj.predict(str(empty)).shape


def test_update_takes_only_its_own_train_set():
    X, y = _dense(800)
    ds = lt.Dataset(X, y)
    b = lt.Booster(params=PARAMS, train_set=ds, device="cpu")
    assert b.update(train_set=ds) is False
    with pytest.raises(lt.LightGBMError, match="Replacing train_set"):
        b.update(train_set=lt.Dataset(X, y))


@pytest.mark.parametrize("key", ["is_save_binary_file", "is_pre_partition"])
def test_binary_keys_train_like_jax_with_one_warning(key, capsys,
                                                     monkeypatch):
    """Fault 2: keys the JAX package reads nowhere outside its config
    train as it trains, with one warning each."""
    monkeypatch.setattr(log, "_current_level", 1)
    log._warned_once.discard(f"config:{key}")
    X, y = _dense(1500, seed=9)
    params = {**PARAMS, key: "true", "verbose": 1}
    bt = lt.train(params, lt.Dataset(X, y), ROUNDS, device="cpu",
                  verbose_eval=False)
    bt2 = lt.train(params, lt.Dataset(X, y), ROUNDS, device="cpu",
                   verbose_eval=False)
    bj = lgb.train(params, lgb.Dataset(X, y), ROUNDS, verbose_eval=False)
    err = capsys.readouterr().err
    assert err.count(f"parameter '{key}' is not read by the torch port") \
        == 1
    _same_trees(bj._booster.models, bt._booster.models, key)
    plain = lt.train(PARAMS, lt.Dataset(X, y), ROUNDS, device="cpu",
                     verbose_eval=False)
    assert bt.model_to_string() == plain.model_to_string() \
        == bt2.model_to_string()


def test_advanced_example_runs_on_the_port(tmp_path, monkeypatch, capsys):
    """examples/python-guide/advanced_example.py as written, with the
    port (on the CPU) in place of the JAX package, in a copy of the
    example tree."""
    guide = tmp_path / "python-guide"
    guide.mkdir()
    shutil.copytree(REPO / "examples" / "binary_classification",
                    tmp_path / "binary_classification")
    src = (REPO / "examples" / "python-guide" /
           "advanced_example.py").read_text()
    port = types.SimpleNamespace(
        Dataset=lt.Dataset, reset_parameter=lt.reset_parameter,
        train=functools.partial(lt.train, device="cpu"))
    monkeypatch.chdir(guide)
    monkeypatch.setitem(__import__("sys").modules, "lightgbm_tpu", port)
    exec(compile(src, "advanced_example.py", "exec"), {"__name__": "main"})
    out = capsys.readouterr().out
    assert "Finish 30 - 40 rounds" in out
    dumped = json.loads((guide / "model.json").read_text())
    assert len(dumped["tree_info"]) == 10
    assert os.path.exists(guide / "model.txt")
