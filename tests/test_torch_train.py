"""The torch port's training slice (lightgbm_tpu_torch: Dataset, train,
Booster.update, the CLI's task=train) against the JAX package.

The same numpy matrix (the bench's Higgs-like generator, copied here)
trains in both packages: binary, 15 leaves, 10 rounds, with a valid set.
Tree structures must be equal in every round; raw predictions within
1e-5; per-round train and valid AUC within 1e-4; and each package loads
the other's model file and predicts the same to 1e-6.  The gradients go
through ``exp`` in XLA and in torch, which may differ in the last bit
and flip a quantized digit, so values are compared by tolerance; a
structural divergence names its round.

Binning must agree exactly: the same bins and bin upper bounds as the
JAX ``BinnedDataset.from_matrix``, and the same bins when the port gets
the JAX mappers' ``to_state()``.
"""

import ast
import json
import pathlib

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
from lightgbm_tpu.io.dataset import BinnedDataset as JaxBinned

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import cli
from lightgbm_tpu_torch.config import Config, parse_cli_args
from lightgbm_tpu_torch.io.binning import BinMapper
from lightgbm_tpu_torch.io.dataset import BinnedDataset

pytestmark = pytest.mark.torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PARAMS = {"objective": "binary", "metric": "auc", "num_leaves": 15,
          "max_bin": 63, "learning_rate": 0.1, "min_data_in_leaf": 20,
          "verbose": -1}
ROUNDS = 10


def make_higgs_like(num_data, num_features=28, seed=42):
    """A copy of bench.py's synthetic stand-in for the Higgs dataset."""
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(num_data, num_features)).astype(np.float32)
    X[:, 7:14] = np.abs(X[:, 7:14])
    X[:, 14:21] = X[:, 0:7] * X[:, 7:14]
    logit = (0.8 * X[:, 0] - 0.6 * X[:, 1] + 0.5 * X[:, 14]
             - 0.4 * X[:, 15] + 0.3 * X[:, 7] * X[:, 2]
             + rng.normal(scale=1.5, size=num_data))
    y = (logit > 0).astype(np.float32)
    return X.astype(np.float64), y


@pytest.fixture(scope="module")
def trained():
    X, y = make_higgs_like(3000, seed=1)
    Xv, yv = make_higgs_like(800, seed=2)
    ej, et = {}, {}
    tj = lgb.Dataset(X, y)
    bj = lgb.train(PARAMS, tj, ROUNDS,
                   valid_sets=[tj, lgb.Dataset(Xv, yv, reference=tj)],
                   evals_result=ej, verbose_eval=False)
    tt = lt.Dataset(X, y)
    bt = lt.train(PARAMS, tt, ROUNDS,
                  valid_sets=[tt, lt.Dataset(Xv, yv, reference=tt)],
                  evals_result=et, device="cpu", verbose_eval=False)
    return dict(X=X, y=y, Xv=Xv, yv=yv, bj=bj, bt=bt, ej=ej, et=et)


def test_tree_structures_equal_every_round(trained):
    mj = trained["bj"]._booster.models
    mt = trained["bt"]._booster.models
    assert len(mj) == len(mt) == ROUNDS
    for r, (a, b) in enumerate(zip(mj, mt), start=1):
        n = a.num_leaves
        assert b.num_leaves == n, f"round {r}: num_leaves"
        for field in ("split_feature", "threshold", "decision_type",
                      "left_child", "right_child", "leaf_parent",
                      "internal_count"):
            np.testing.assert_array_equal(
                getattr(b, field), getattr(a, field)[:len(getattr(b, field))],
                err_msg=f"round {r}: the tree structure diverged ({field})")
        np.testing.assert_array_equal(b.leaf_count, a.leaf_count[:n],
                                      err_msg=f"round {r}: leaf_count")
        for field in ("leaf_value", "internal_value"):
            np.testing.assert_allclose(
                getattr(b, field), getattr(a, field)[:len(getattr(b, field))],
                rtol=1e-4, atol=1e-7, err_msg=f"round {r}: {field}")


def test_raw_predictions_match(trained):
    for X in (trained["X"][:1000], trained["Xv"]):
        pj = trained["bj"].predict(X, raw_score=True)
        pt = trained["bt"].predict(X, raw_score=True)
        np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-5)
    # the training score buffer is the sum of the trees on the train rows
    score = trained["bt"]._booster.train_data.score[0].numpy()
    np.testing.assert_allclose(
        trained["bt"].predict(trained["X"], raw_score=True), score,
        rtol=0, atol=1e-5)


def test_per_round_auc_matches(trained):
    ej, et = trained["ej"], trained["et"]
    assert set(et) == {"training", "valid_1"} and set(ej) == set(et)
    for name in ej:
        a, b = np.asarray(ej[name]["auc"]), np.asarray(et[name]["auc"])
        assert len(a) == len(b) == ROUNDS
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-4, err_msg=name)
    assert et["valid_1"]["auc"][-1] > et["valid_1"]["auc"][0] > 0.5


def test_model_files_cross_load(trained, tmp_path):
    ours, theirs = tmp_path / "torch.txt", tmp_path / "jax.txt"
    trained["bt"].save_model(str(ours))
    trained["bj"].save_model(str(theirs))
    Xq = trained["Xv"][:300]
    for path in (ours, theirs):
        pj = lgb.Booster(model_file=str(path)).predict(Xq)
        pt = lt.Booster(model_file=str(path), device="cpu").predict(Xq)
        np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        lgb.Booster(model_file=str(ours)).predict(Xq),
        trained["bt"].predict(Xq), rtol=0, atol=1e-6)
    head = ours.read_text().split("Tree=0")[0]
    want = theirs.read_text().split("Tree=0")[0]
    assert head == want          # header and feature_infos identical


def test_booster_update_equals_train(trained):
    X, y = trained["X"], trained["y"]
    ds = lt.Dataset(X, y)
    b = lt.Booster(params=PARAMS, train_set=ds, device="cpu")
    b.add_valid(lt.Dataset(trained["Xv"], trained["yv"], reference=ds), "v")
    for _ in range(3):
        assert b.update() is False
    assert b.current_iteration() == 3
    # the trees; the importance footer counts every tree of the model
    want = trained["bt"].model_to_string(num_iteration=3)
    cut = "\nfeature importances"
    assert b.model_to_string().split(cut)[0] == want.split(cut)[0]
    (name, metric, value, bigger), = b.eval_valid()
    assert (name, metric, bigger) == ("v", "auc", True)
    assert value == trained["et"]["valid_1"]["auc"][2]
    assert b._booster.eval_metrics()["valid_1"] == {"auc": value}


def test_saturated_round_is_popped():
    X, y = make_higgs_like(300, seed=3)
    b = lt.train({**PARAMS, "min_data_in_leaf": 200}, lt.Dataset(X, y), 5,
                 device="cpu", verbose_eval=False)
    bj = lgb.train({**PARAMS, "min_data_in_leaf": 200}, lgb.Dataset(X, y), 5,
                   verbose_eval=False)
    assert b.num_trees() == bj._booster.num_trees() == 0
    assert b.current_iteration() == 0


def test_categorical_feature_trains_like_jax():
    rng = np.random.RandomState(12)
    X = rng.normal(size=(2500, 6))
    X[:, 1] = rng.randint(0, 8, size=2500)
    # label noise: a separable label leaves only zero-gain splits whose
    # gains are f32 rounding noise, where the packages may choose apart
    y = ((X[:, 0] + 0.5 * rng.normal(size=2500) > 0)
         ^ np.isin(X[:, 1], [2, 5])).astype(np.float64)
    params = {**PARAMS, "metric": "binary_logloss", "num_leaves": 7}
    # (train() applies its own categorical_feature argument, in both)
    bj = lgb.train(params, lgb.Dataset(X, y), 3, categorical_feature=[1],
                   verbose_eval=False)
    bt = lt.train(params, lt.Dataset(X, y), 3, categorical_feature=[1],
                  device="cpu", verbose_eval=False)
    assert any((t.decision_type == 1).any() for t in bt._booster.models)
    for a, b in zip(bj._booster.models, bt._booster.models):
        n = a.num_leaves
        assert b.num_leaves == n
        for field in ("split_feature", "threshold", "decision_type",
                      "left_child", "right_child"):
            np.testing.assert_array_equal(getattr(b, field),
                                          getattr(a, field)[:n - 1])
    np.testing.assert_allclose(bt.predict(X[:500]), bj.predict(X[:500]),
                               rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# binning


def _matrix(seed=5):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(3000, 9))
    X[:, 1] = rng.randint(0, 6, size=3000)            # categorical
    X[rng.rand(3000) < 0.1, 2] = np.nan              # missing values
    X[rng.rand(3000) < 0.4, 3] = 0.0                 # many zeros
    X[:, 4] = np.round(X[:, 4], 1)                   # few distinct values
    X[:, 5] = 7.0                                    # trivial
    X[:, 6] = rng.exponential(size=3000) * 1000      # skewed
    return X, (X[:, 0] > 0).astype(np.float64)


@pytest.mark.parametrize("max_bin,sample_cnt", [(63, 200000), (300, 1000)])
def test_from_matrix_bins_equal_jax(max_bin, sample_cnt):
    X, y = _matrix()
    kw = dict(max_bin=max_bin, min_data_in_bin=5, min_data_in_leaf=20,
              bin_construct_sample_cnt=sample_cnt, categorical_features=[1],
              data_random_seed=7)
    j = JaxBinned.from_matrix(X, y, **kw)
    t = BinnedDataset.from_matrix(X, y, **kw)
    assert t.used_feature_map == j.used_feature_map
    assert 5 not in t.used_feature_map
    assert t.bins.dtype == j.bins.dtype
    np.testing.assert_array_equal(t.bins, j.bins)
    for a, b in zip(t.mappers, j.mappers):
        np.testing.assert_array_equal(a.bin_upper_bound, b.bin_upper_bound)
        # (json: NaN min/max values compare equal as text)
        assert json.dumps(a.to_state()) == json.dumps(b.to_state())
    assert t.feature_infos() == j.feature_infos()
    Xv = _matrix(seed=6)[0]
    np.testing.assert_array_equal(t.create_valid(Xv).bins,
                                  j.create_valid(Xv).bins)


def test_jax_mapper_state_bins_alike():
    X, y = _matrix()
    j = JaxBinned.from_matrix(X, y, max_bin=63, min_data_in_leaf=20,
                              categorical_features=[1])
    mappers = [None] * X.shape[1]
    for inner, f in enumerate(j.used_feature_map):
        mappers[f] = BinMapper.from_state(j.mappers[inner].to_state())
    Xq = _matrix(seed=9)[0]
    for inner, f in enumerate(j.used_feature_map):
        np.testing.assert_array_equal(
            mappers[f].value_to_bin(Xq[:, f]),
            j.mappers[inner].value_to_bin(Xq[:, f]))
    t = BinnedDataset.from_matrix(X, y, max_bin=63, min_data_in_leaf=20,
                                  predefined_mappers=mappers)
    np.testing.assert_array_equal(t.bins, j.bins)


def test_bundling_is_refused_not_ignored():
    rng = np.random.RandomState(11)
    X = np.zeros((2000, 6))
    for f in range(6):                 # mutually exclusive sparse columns
        rows = np.arange(f, 2000, 6)
        X[rows, f] = rng.randint(1, 4, size=len(rows))
    y = (X.sum(axis=1) > 1.5).astype(np.float64)
    params = {**PARAMS, "min_data_in_leaf": 5}
    assert JaxBinned.from_matrix(X, y, max_bin=63, min_data_in_leaf=5,
                                 enable_bundle=True).bundle_plan is not None
    with pytest.raises(lt.LightGBMError, match="bundling.*not ported"):
        lt.train(params, lt.Dataset(X, y), 2, device="cpu")
    off = {**params, "enable_bundle": False}
    bt = lt.train(off, lt.Dataset(X, y), 2, device="cpu", verbose_eval=False)
    bj = lgb.train(off, lgb.Dataset(X, y), 2, verbose_eval=False)
    for a, b in zip(bj._booster.models, bt._booster.models):
        np.testing.assert_array_equal(b.split_feature,
                                      a.split_feature[:a.num_leaves - 1])


# ---------------------------------------------------------------------------
# entry points and guards


def test_cli_train_model_loads_in_jax(tmp_path, trained):
    X, y = trained["X"][:1500], trained["y"][:1500]
    data = tmp_path / "train.csv"
    np.savetxt(data, np.column_stack([y, X]), delimiter=",", fmt="%.17g")
    model = tmp_path / "model.txt"
    argv = [f"data={data}", f"output_model={model}", "device=cpu",
            "verbose=-1", "num_iterations=4", f"valid_data={data}",
            "is_training_metric=true"] + [
        f"{k}={v}" for k, v in PARAMS.items() if k != "verbose"]
    assert cli.main(["task=train"] + argv) == 0
    want = lt.train(PARAMS, lt.Dataset(X, y), 4, device="cpu",
                    verbose_eval=False).model_to_string()
    assert model.read_text() == want
    pj = lgb.Booster(model_file=str(model)).predict(X)
    pt = lt.Booster(model_file=str(model), device="cpu").predict(X)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-6)


def test_train_without_device_raises_here(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = make_higgs_like(200, seed=4)
    with pytest.raises(lt.LightGBMError, match="no CUDA device"):
        lt.train(PARAMS, lt.Dataset(X, y), 1)
    with pytest.raises(lt.LightGBMError, match="no CUDA device"):
        lt.Booster(params=PARAMS, train_set=lt.Dataset(X, y))


@pytest.mark.parametrize("extra,what", [
    ({"feature_screen_ratio": 0.5}, "feature_screen_ratio"),
    # the JAX config has no alias for it: the CLI's --key=value spelling
    (parse_cli_args(["--feature-screen-ratio=0.5"]),
     "feature_screen_ratio"),
    ({"bad_data_policy": "quarantine"}, "bad_data_policy=quarantine"),
    ({"num_machines": 2}, "num_machines"),
    ({"tree_learner": "data"}, "tree_learner"),
])
def test_unported_training_settings_raise(extra, what):
    X, y = make_higgs_like(200, seed=4)
    with pytest.raises(lt.LightGBMError, match="not ported yet") as exc:
        lt.train({**PARAMS, **extra}, lt.Dataset(X, y), 1, device="cpu")
    assert what in str(exc.value)


def test_config_training_keys_match_jax():
    from lightgbm_tpu.config import Config as JaxConfig
    params = {"application": "binary", "num_leaf": 63, "min_data": 50,
              "shrinkage_rate": 0.05, "max_depth": 4, "metric": "auc,binary",
              "num_round": 7, "model_out": "m.txt", "reg_lambda": 2.0}
    ours, theirs = Config(params), JaxConfig(params)
    for key in ("objective", "num_leaves", "min_data_in_leaf",
                "learning_rate", "max_depth", "metric", "num_iterations",
                "output_model", "lambda_l2", "max_bin", "min_data_in_bin",
                "bin_construct_sample_cnt", "data_random_seed", "sigmoid",
                "min_sum_hessian_in_leaf", "serial_grow", "is_unbalance",
                "scale_pos_weight", "min_gain_to_split", "lambda_l1"):
        assert getattr(ours, key) == getattr(theirs, key), key
    assert Config({"objective": "binary"}).metric == ["binary_logloss"]


def test_training_modules_import_nothing_of_jax():
    new = ["io/binning.py", "io/dataset.py", "objective/__init__.py",
           "metric/__init__.py", "ops/split.py", "ops/leafhist.py",
           "ops/grow.py", "ops/ordered_grow.py", "engine.py",
           "ops/histogram.py", "ops/children_hist.py", "utils/resource.py",
           "io/parser.py", "io/column_roles.py", "basic.py", "cli.py"]
    for rel in new:
        path = REPO / "lightgbm_tpu_torch" / rel
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            for name in names:
                assert name.split(".")[0] not in (
                    "jax", "jaxlib", "lightgbm_tpu"), (rel, name)
    assert (REPO / "lightgbm_tpu_torch/csrc/leaf_hist.cu").is_file()
    assert (REPO / "lightgbm_tpu_torch/csrc/children_hist.cu").is_file()
