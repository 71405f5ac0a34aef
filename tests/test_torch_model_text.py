"""Model text in the torch port (lightgbm_tpu_torch/models/) against the
JAX package.

Models trained by the JAX package (binary, multiclass K=3, categorical
with NaN, DART, piece-wise linear) load into the port through
``Booster(model_str=...)``: every parsed tree array must equal the JAX
parser's, ``model_to_string()`` must reproduce the JAX text byte for
byte, and damaged files must raise ``LightGBMError`` with the JAX
loader's message.  Inputs are made from numpy seeds.
"""

import numpy as np
import pytest

import lightgbm_tpu as lgb
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.models import create_boosting
from lightgbm_tpu.testing.faults import corrupt_model_file
from lightgbm_tpu.utils.log import LightGBMError as JaxError

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.models.gbdt import GBDT
from lightgbm_tpu_torch.models.tree import Tree

pytestmark = pytest.mark.torch

TREE_ARRAYS = ("split_feature", "split_gain", "threshold", "decision_type",
               "left_child", "right_child", "leaf_parent", "leaf_value",
               "leaf_count", "internal_value", "internal_count")


def _train(kind: str):
    rng = np.random.RandomState({"binary": 0, "multiclass": 1,
                                 "categorical": 3, "dart": 5,
                                 "linear": 7}[kind])
    X = rng.normal(size=(600, 6))
    params = {"num_leaves": 7, "verbose": -1, "min_data_in_leaf": 20,
              "objective": "binary"}
    cat = "auto"
    y = (X[:, 0] + 0.3 * X[:, 1] > 0).astype(np.float64)
    if kind == "multiclass":
        y = np.digitize(X[:, 0], [-0.5, 0.5]).astype(np.float64)
        params.update({"objective": "multiclass", "num_class": 3})
    elif kind == "categorical":
        X[:, 1] = rng.randint(0, 8, size=600)
        y = ((X[:, 0] > 0) ^ (X[:, 1] >= 4)).astype(np.float64)
        # missing values off the categorical column, which the JAX
        # package bins without a NaN category
        nan = rng.rand(*X.shape) < 0.05
        nan[:, 1] = False
        X[nan] = np.nan
        cat = [1]
    elif kind == "dart":
        params.update({"boosting": "dart", "drop_rate": 0.4,
                       "drop_seed": 5})
    elif kind == "linear":
        y = X[:, 0] * 2.0 + np.abs(X[:, 1])
        params.update({"objective": "regression", "linear_tree": True,
                       "linear_lambda": 0.01})
    # train() applies its own categorical_feature (default "auto")
    bst = lgb.train(params, lgb.Dataset(X, label=y,
                                        categorical_feature=cat),
                    num_boost_round=4, categorical_feature=cat)
    if cat != "auto":
        assert any((t.decision_type == 1).any()
                   for t in bst._booster.models)
    return bst


@pytest.fixture(scope="module")
def models():
    return {k: _train(k)
            for k in ("binary", "multiclass", "categorical", "dart")}


@pytest.mark.parametrize("kind", ["binary", "multiclass", "categorical",
                                  "dart"])
def test_tree_arrays_equal_jax_parser(models, kind):
    bst = models[kind]
    text = bst.model_to_string()
    ours = lt.Booster(model_str=text, device="cpu")._booster
    theirs = bst._booster
    assert ours.num_class == theirs.num_class
    assert ours.max_feature_idx == theirs.max_feature_idx
    assert ours.sigmoid == theirs.sigmoid
    assert ours.num_trees() == theirs.num_trees()
    for a, b in zip(ours.models, theirs.models):
        assert a.num_leaves == b.num_leaves
        assert a.shrinkage == b.shrinkage
        for name in TREE_ARRAYS:
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                          err_msg=name)


@pytest.mark.parametrize("kind", ["binary", "multiclass", "categorical",
                                  "dart"])
def test_model_to_string_reproduces_jax_text(models, kind):
    text = models[kind].model_to_string()
    ours = lt.Booster(model_str=text, device="cpu")
    again = ours.model_to_string()
    header, trees = again.split("Tree=0", 1)
    assert header == text.split("Tree=0", 1)[0]
    assert again == text
    assert ours.num_trees() == models[kind].num_trees()


def test_save_model_loads_back_in_jax(models, tmp_path):
    text = models["multiclass"].model_to_string()
    path = tmp_path / "m.txt"
    lt.Booster(model_str=text, device="cpu").save_model(str(path))
    back = lgb.Booster(model_file=str(path))
    X = np.random.RandomState(11).normal(size=(50, 6))
    np.testing.assert_array_equal(back.predict(X),
                                  models["multiclass"].predict(X))


def test_host_tree_predict_matches_jax(models):
    X = np.random.RandomState(12).normal(size=(200, 6))
    X[::7, 2] = np.nan
    bst = models["categorical"]
    ours = GBDT.from_string(bst.model_to_string())
    for a, b in zip(ours.models, bst._booster.models):
        np.testing.assert_array_equal(a.predict(X), b.predict(X))
        np.testing.assert_array_equal(a.predict_leaf_index(X),
                                      b.predict_leaf_index(X))


def _jax_load(text: str):
    create_boosting(JaxConfig({"task": "predict"}), None, model_str=text)


def _mutate(text: str, mode: str, tmp_path) -> str:
    if mode == "truncate_in_trees":
        # mid-way through the last tree block, keeping the footer
        footer = text.find("\nfeature importances")
        last = text.rfind("Tree=", 0, footer)
        cut = last + (footer - last) // 2
        return text[:cut] + text[footer:]
    if mode == "reordered":
        return text.replace("Tree=1\n", "Tree=7\n", 1)
    if mode == "bad_num_class":
        return text.replace("num_class=1", "num_class=x", 1)
    if mode == "no_num_class":
        return text.replace("num_class=1\n", "", 1)
    path = tmp_path / "bad.txt"
    path.write_text(text)
    corrupt_model_file(str(path), mode)
    return path.read_text()


@pytest.mark.parametrize("mode", ["truncate_tree", "truncate_in_trees",
                                  "chop_footer",
                                  "garbage_field", "reordered",
                                  "bad_num_class", "no_num_class"])
def test_corrupt_model_raises_jax_message(models, mode, tmp_path):
    bad = _mutate(models["binary"].model_to_string(), mode, tmp_path)
    with pytest.raises(JaxError) as jax_exc:
        _jax_load(bad)
    with pytest.raises(lt.LightGBMError) as ours:
        lt.Booster(model_str=bad, device="cpu")
    assert str(ours.value) == str(jax_exc.value)


def test_text_after_footer_kept_verbatim(models):
    tail = ("\ndata_fingerprint\nversion=1\nnum_rows=600\n"
            "end data_fingerprint\n")
    text = models["binary"].model_to_string() + tail
    assert lt.Booster(model_str=text,
                      device="cpu").model_to_string().endswith(tail)


def test_linear_sections_parse_like_jax():
    bst = _train("linear")
    text = bst.model_to_string()
    assert "leaf_coeff=" in text
    ours = GBDT.from_string(text)
    for a, b in zip(ours.models, bst._booster.models):
        assert a.has_linear() == b.has_linear()
        if b.has_linear():
            np.testing.assert_array_equal(a.leaf_feat, b.leaf_feat)
            np.testing.assert_array_equal(a.leaf_coeff, b.leaf_coeff)
    assert ours.save_model_to_string() == text
    X = np.random.RandomState(13).normal(size=(64, 6))
    np.testing.assert_allclose(ours.predict_raw(X)[0],
                               bst.predict(X, raw_score=True),
                               rtol=0, atol=1e-12)
    # the port serves affine leaves through the linear forest walk
    np.testing.assert_allclose(
        lt.Booster(model_str=text, device="cpu").predict(X),
        bst.predict(X), rtol=0, atol=1e-6)


def test_tree_from_string_rejects_bad_child_index():
    t = Tree(3)
    t.left_child = np.array([1, -1], np.int32)
    t.right_child = np.array([-2, 5], np.int32)
    with pytest.raises(lt.LightGBMError, match="out-of-range node index"):
        Tree.from_string(t.to_string())
