"""The port's scikit-learn estimators (lightgbm_tpu_torch/sklearn.py)
against the JAX package's (lightgbm_tpu/sklearn.py), on the CPU.

The same seeded rows go to both packages' estimators:

* ``LGBMRegressor``, ``LGBMClassifier`` (binary and 3-class, string
  labels) and ``LGBMRanker`` grow the same trees (structure equal, leaf
  values within 1e-5) and predict within 1e-6;
  ``apply``, ``feature_importances_``, ``eval_set`` with early stopping
  and ``evals_result_`` agree too;
* the ``fobj`` / ``feval`` wrappers of 2, 3 and 4 arguments return what
  the JAX package's return, and refuse the same counts;
* ``device`` is a named parameter of every estimator: ``get_params``,
  ``set_params``, ``sklearn.base.clone`` and ``GridSearchCV`` keep it,
  and it never reaches the parameter dict; without scikit-learn the
  module's fallbacks rebuild an estimator with it (scikit-learn is
  optional);
* ``examples/python-guide/sklearn_example.py`` runs as written with the
  port in place of the JAX package.
"""

import functools
import importlib.util
import os
import pathlib
import shutil
import sys
import types

import numpy as np
import pytest
from sklearn.base import clone
from sklearn.model_selection import GridSearchCV

import lightgbm_tpu as lgb
from lightgbm_tpu import sklearn as jsk
from lightgbm_tpu.utils.log import LightGBMError as JaxError

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import sklearn as tsk
from lightgbm_tpu_torch.utils.log import LightGBMError

from chip_smoke import make_higgs_like
from torch_threads import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
PARAMS = dict(n_estimators=8, num_leaves=15, min_child_samples=20)
LEAF_ATOL = 1e-5
PRED_TOL = 1e-6


@pytest.fixture(scope="module")
def data():
    """Higgs-like rows with a noisy binary label, a continuous target, 3
    string classes and relevance labels in 100 queries of 20 rows."""
    X, y = make_higgs_like(2000, seed=11)
    rng = np.random.RandomState(1)
    latent = X[:, 0] - 0.6 * X[:, 1] + rng.normal(size=len(X))
    return {"X": X, "target": X[:, 0] + y,
            "binary": np.where(y > 0, "yes", "no"),
            "classes": np.array(["a", "b", "c"])[
                np.digitize(latent, [-0.5, 0.5])],
            "relevance": np.digitize(latent, [0, 1, 2]).astype(float),
            "group": [20] * 100}


def _same_trees(j_est, t_est, label):
    jm = j_est.booster_._booster.models
    tm = t_est.booster_._booster.models
    assert len(jm) == len(tm) > 0, label
    for i, (a, b) in enumerate(zip(jm, tm)):
        n = a.num_leaves - 1
        assert a.num_leaves == b.num_leaves, (label, i)
        for field in ("split_feature", "threshold", "decision_type",
                      "left_child", "right_child"):
            np.testing.assert_array_equal(getattr(b, field),
                                          getattr(a, field)[:n],
                                          err_msg=f"{label} tree {i}")
        np.testing.assert_allclose(b.leaf_value, a.leaf_value[:n + 1],
                                   rtol=0, atol=LEAF_ATOL,
                                   err_msg=f"{label} tree {i}")


def _fit_both(kind, *args, **kwargs):
    extra = kwargs.pop("params", {})
    params = {**PARAMS, **extra}
    j = getattr(lgb, kind)(**params).fit(*args, **kwargs)
    t = getattr(lt, kind)(**params, device="cpu").fit(*args, **kwargs)
    return j, t


def test_regressor_matches_jax(data):
    j, t = _fit_both("LGBMRegressor", data["X"], data["target"],
                     verbose=False)
    _same_trees(j, t, "regressor")
    np.testing.assert_allclose(t.predict(data["X"]), j.predict(data["X"]),
                               rtol=0, atol=PRED_TOL)
    np.testing.assert_allclose(
        t.predict(data["X"], raw_score=True, num_iteration=3),
        j.predict(data["X"], raw_score=True, num_iteration=3),
        rtol=0, atol=PRED_TOL)


@pytest.mark.parametrize("labels", ["binary", "classes"])
def test_classifier_with_string_labels_matches_jax(data, labels):
    j, t = _fit_both("LGBMClassifier", data["X"], data[labels],
                     verbose=False)
    _same_trees(j, t, labels)
    assert list(t.classes_) == list(j.classes_)
    assert t.n_classes_ == j.n_classes_
    assert t.objective == j.objective
    assert t._other_params == j._other_params
    pt, pj = t.predict_proba(data["X"]), j.predict_proba(data["X"])
    assert pt.shape == pj.shape == (len(data["X"]), t.n_classes_)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=PRED_TOL)
    np.testing.assert_array_equal(t.predict(data["X"]),
                                  j.predict(data["X"]))
    # raw scores: sums of the trees' leaves, each within LEAF_ATOL
    np.testing.assert_allclose(t.predict(data["X"], raw_score=True),
                               j.predict(data["X"], raw_score=True),
                               rtol=0, atol=LEAF_ATOL)


def test_ranker_matches_jax(data):
    j, t = _fit_both("LGBMRanker", data["X"], data["relevance"],
                     group=data["group"], verbose=False)
    _same_trees(j, t, "ranker")
    np.testing.assert_allclose(t.predict(data["X"]), j.predict(data["X"]),
                               rtol=0, atol=PRED_TOL)


def test_eval_set_apply_and_importances_match_jax(data):
    X, y = data["X"], data["binary"]
    fit = dict(eval_set=[(X[1500:], y[1500:])], eval_metric="auc",
               early_stopping_rounds=2, verbose=False)
    j, t = _fit_both("LGBMClassifier", X[:1500], y[:1500],
                     params={"learning_rate": 1.0, "n_estimators": 30},
                     **fit)
    _same_trees(j, t, "early-stopped classifier")
    assert t.best_iteration_ == t.best_iteration == j.best_iteration_
    assert t.booster_.num_trees() == j.booster_.num_trees() < 30
    assert t.evals_result_.keys() == j.evals_result_.keys()
    for name, metrics in j.evals_result_.items():
        for metric, values in metrics.items():
            np.testing.assert_allclose(t.evals_result_[name][metric],
                                       values, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(t.apply(X), j.apply(X))
    np.testing.assert_array_equal(t.feature_importances_,
                                  j.feature_importances_)


class _FakeSet:
    """What the wrappers read of a Dataset."""

    def __init__(self, n):
        rng = np.random.RandomState(n)
        self.label = rng.normal(size=n)
        self.weight = rng.uniform(0.5, 2.0, size=n)
        self.group = np.array([n // 2, n - n // 2])

    def get_label(self):
        return self.label

    def get_weight(self):
        return self.weight

    def get_group(self):
        return self.group


def _objectives():
    return {
        2: lambda y, p: (p - y, np.ones_like(y)),
        3: lambda y, p, g: (p - y + len(g), 2 * np.ones_like(y)),
        4: lambda y, p, g, extra: (p, p),
    }


def _metrics():
    return {
        2: lambda y, p: ("mae", float(np.abs(y - p).mean()), False),
        3: lambda y, p, w: ("wmae", float((w * np.abs(y - p)).sum()),
                            False),
        4: lambda y, p, w, g: ("gsum", float(len(g) + w.sum() + p[0]),
                               True),
        5: lambda y, p, w, g, extra: ("x", 0.0, True),
    }


@pytest.mark.parametrize("argc", [2, 3, 4])
def test_objective_wrapper_matches_jax(argc):
    func = _objectives()[argc]
    ds = _FakeSet(10)
    preds = np.linspace(-1, 1, 10)
    if argc == 4:
        for mod, err in ((jsk, TypeError), (tsk, TypeError)):
            with pytest.raises(err, match="2 or 3 arguments"):
                mod._ObjectiveFunctionWrapper(func)(preds, ds)
        return
    want = jsk._ObjectiveFunctionWrapper(func)(preds, ds)
    got = tsk._ObjectiveFunctionWrapper(func)(preds, ds)
    assert isinstance(got, tuple) and len(got) == 2
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("argc", [2, 3, 4, 5])
def test_eval_wrapper_matches_jax(argc):
    func = _metrics()[argc]
    ds = _FakeSet(12)
    preds = np.linspace(-1, 1, 12)
    if argc == 5:
        for mod in (jsk, tsk):
            with pytest.raises(TypeError, match="2, 3 or 4 arguments"):
                mod._EvalFunctionWrapper(func)(preds, ds)
        return
    assert tsk._EvalFunctionWrapper(func)(preds, ds) == \
        jsk._EvalFunctionWrapper(func)(preds, ds)


def test_custom_objective_and_metric_fit_like_jax(data):
    X, target = data["X"], data["target"]

    def l2(y_true, y_pred):
        return y_pred - y_true, np.ones_like(y_true)

    def wmae(y_true, y_pred, weight):
        return "wmae", float(np.abs(y_true - y_pred).mean()), False
    fit = dict(eval_set=[(X[1500:], target[1500:])], eval_metric=wmae,
               verbose=False)
    j, t = _fit_both("LGBMRegressor", X[:1500], target[:1500],
                     params={"objective": l2}, **fit)
    _same_trees(j, t, "custom objective")
    np.testing.assert_allclose(t.evals_result_["valid_0"]["wmae"],
                               j.evals_result_["valid_0"]["wmae"],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(t.predict(X, raw_score=True),
                               j.predict(X, raw_score=True),
                               rtol=0, atol=PRED_TOL)


@pytest.mark.parametrize("kind", ["LGBMModel", "LGBMRegressor",
                                  "LGBMClassifier", "LGBMRanker"])
def test_device_survives_params_and_clone(kind):
    cls = getattr(lt, kind)
    est = cls(num_leaves=7)
    assert est.device == "cuda" and est.get_params()["device"] == "cuda"
    assert "device" in cls._param_names()
    assert "kwargs" not in cls._param_names()
    est = cls(num_leaves=7, device="cpu")
    assert clone(est).device == "cpu"
    assert clone(est).get_params() == est.get_params()
    assert "device" not in est._params_for_engine()
    est.set_params(device="cuda:0", learning_rate=0.3)
    assert est.device == "cuda:0" and clone(est).device == "cuda:0"
    assert "device" not in est._params_for_engine()
    assert est._params_for_engine()["learning_rate"] == 0.3
    # the rest of the parameters are the JAX package's
    jcls = getattr(lgb, kind)
    assert set(cls._param_names()) - {"device"} == {
        p for p in jcls._param_names() if p != "kwargs"}


def test_grid_search_clones_keep_device(data):
    X, target = data["X"][:600], data["target"][:600]
    search = GridSearchCV(lt.LGBMRegressor(num_leaves=7, device="cpu"),
                          {"learning_rate": [0.1, 0.3],
                           "n_estimators": [3, 5]}, cv=3)
    search.fit(X, target)
    assert search.best_estimator_.device == "cpu"
    assert search.best_estimator_.booster_.device.type == "cpu"


def test_without_sklearn_the_fallbacks_keep_device(monkeypatch, data):
    """The module's fallbacks when scikit-learn does not import: the
    parameters from the ``__init__`` signatures, ``device`` among them,
    and a label encoder of ``np.unique``; an estimator rebuilt from
    ``get_params()`` keeps ``device`` and predicts as with
    scikit-learn."""
    for name in [m for m in sys.modules
                 if m == "sklearn" or m.startswith("sklearn.")]:
        monkeypatch.setitem(sys.modules, name, None)
    spec = importlib.util.spec_from_file_location(
        "lightgbm_tpu_torch._sklearn_without",
        REPO / "lightgbm_tpu_torch" / "sklearn.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert not mod.SKLEARN_INSTALLED
    X, labels = data["X"][:500], data["classes"][:500]
    est = mod.LGBMClassifier(num_leaves=7, n_estimators=3, device="cpu")
    params = est.get_params()
    assert set(params) == set(mod.LGBMClassifier._param_names())
    again = type(est)(**params)
    assert again.device == "cpu"
    again.fit(X, labels, verbose=False)
    with_sk = lt.LGBMClassifier(num_leaves=7, n_estimators=3,
                                device="cpu").fit(X, labels, verbose=False)
    np.testing.assert_array_equal(again.classes_, with_sk.classes_)
    np.testing.assert_array_equal(again.predict_proba(X),
                                  with_sk.predict_proba(X))


def test_errors_are_the_jax_packages(data):
    X, y = data["X"][:100], data["relevance"][:100]
    for pkg, err, dev in ((lgb, JaxError, {}), (lt, LightGBMError,
                                                {"device": "cpu"})):
        est = pkg.LGBMRegressor(**dev)
        for call in (lambda: est.predict(X), lambda: est.apply(X),
                     lambda: est.booster_,
                     lambda: est.feature_importances_):
            with pytest.raises(err):
                call()
        with pytest.raises(ValueError, match="Should set group"):
            pkg.LGBMRanker(**dev).fit(X, y)
        with pytest.raises(ValueError, match="Eval_group cannot be None"):
            pkg.LGBMRanker(**dev).fit(X, y, group=[50, 50],
                                      eval_set=[(X, y)])


def test_without_a_card_fit_raises(monkeypatch, data):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(LightGBMError, match="no CUDA device"):
        lt.LGBMRegressor(n_estimators=1).fit(data["X"][:100],
                                             data["target"][:100])


class CpuRegressor(lt.LGBMRegressor):
    """``LGBMRegressor`` whose ``device`` defaults to the CPU, for the
    example's ``GridSearchCV`` half (it builds ``LGBMRegressor()``)."""

    def __init__(self, boosting_type="gbdt", num_leaves=31, max_depth=-1,
                 learning_rate=0.1, n_estimators=10, max_bin=255,
                 subsample_for_bin=50000, objective="regression",
                 device="cpu", **kwargs):
        super().__init__(boosting_type=boosting_type, num_leaves=num_leaves,
                         max_depth=max_depth, learning_rate=learning_rate,
                         n_estimators=n_estimators, max_bin=max_bin,
                         subsample_for_bin=subsample_for_bin,
                         objective=objective, device=device, **kwargs)


def test_sklearn_example_runs_on_the_port(tmp_path, monkeypatch, capsys):
    """examples/python-guide/sklearn_example.py as written, with the port
    (on the CPU) in place of the JAX package, in a copy of the example
    tree; its grid search fits 13 estimators."""
    guide = tmp_path / "python-guide"
    guide.mkdir()
    shutil.copytree(REPO / "examples" / "regression",
                    tmp_path / "regression")
    src = (REPO / "examples" / "python-guide" /
           "sklearn_example.py").read_text()
    port = types.SimpleNamespace(
        Dataset=lt.Dataset, LGBMRegressor=CpuRegressor,
        train=functools.partial(lt.train, device="cpu"))
    fits = []
    fit = lt.LGBMRegressor.fit

    def counted(est, *args, **kwargs):
        fits.append(est.device)
        return fit(est, *args, **kwargs)
    monkeypatch.setattr(lt.LGBMRegressor, "fit", counted)
    monkeypatch.chdir(guide)
    monkeypatch.setitem(sys.modules, "lightgbm_tpu", port)
    exec(compile(src, "sklearn_example.py", "exec"), {"__name__": "main"})
    out = capsys.readouterr().out
    assert "The rmse of prediction is:" in out
    assert "Best parameters found by grid search are:" in out
    assert fits == ["cpu"] * 14
    assert not os.listdir(guide)
