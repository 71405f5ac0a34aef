"""The model layer's own API against the JAX package, on the CPU.

``create_boosting`` / ``GBDT.train`` / ``eval_and_check_early_stopping``
/ ``predict`` / ``save_model_to_file`` (the loop of
tests/test_engine_core.py:28-40 and its save protocol, :94-102), the
leaf-index walk ``ops.predict.predict_leaf_indices_forest``, the
``Config`` helpers, the objective's ``boost_from_average``, the stdlib
log bridge (tests/test_obs.py:278-305's protocol), and the smaller
names of the JAX surface the port took over: ``BinnedDataset.
from_matrix(label_idx=)`` and ``Dataset.subset(params=)``.

The same seeded numpy inputs go through both packages.  Trees are held
as tests/test_torch_engine.py holds them (structure equal, thresholds
1e-9 relative, leaves within 1e-5 of the tree's largest, a near-tie
within 1e-5 of its gain reported); stopping iterations, best
iterations and leaf indices are exact, and so are the log lines of the
early-stop loop (both packages format the metric with ``%g``).
"""

import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import chip_smoke as cs
import lightgbm_tpu as lgb
from lightgbm_tpu import config as jconfig
from lightgbm_tpu import objective as jobjective
from lightgbm_tpu.io.dataset import BinnedDataset as JaxBinned
from lightgbm_tpu.models import GBDT as JaxGBDT
from lightgbm_tpu.ops.predict import (
    predict_leaf_indices_forest as jax_leaf_indices)
from lightgbm_tpu.utils import log as jlog

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import config as tconfig
from lightgbm_tpu_torch import objective as tobjective
from lightgbm_tpu_torch.io.dataset import BinnedDataset
from lightgbm_tpu_torch.models import GBDT, create_boosting
from lightgbm_tpu_torch.ops.predict import predict_leaf_indices_forest
from lightgbm_tpu_torch.utils import log

from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch

CPU = torch.device("cpu")
TIE_RTOL = 1e-5
LEAF_RTOL = 1e-5


def synthetic_binary(n, seed, f=10):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, f))
    logit = X[:, 0] * 1.5 - X[:, 1] + 0.5 * X[:, 2] * X[:, 3]
    y = (logit + rng.normal(scale=0.5, size=n) > 0).astype(np.float64)
    return X, y


class Lines:
    """The records a package's stdlib bridge forwards."""

    def __init__(self, module, name):
        self.module, self.records = module, []
        outer = self

        class Capture(logging.Handler):
            def emit(self, record):
                outer.records.append(record)

        self.handler = Capture()
        self.logger = module.enable_stdlib_bridge(name)
        self.logger.addHandler(self.handler)
        self.logger.setLevel(logging.DEBUG)

    def close(self):
        self.logger.removeHandler(self.handler)
        self.module.disable_stdlib_bridge()

    def loop_lines(self):
        return [r.getMessage() for r in self.records
                if r.getMessage().startswith(("Iteration:", "Early stopping"))]


def train_both(params, X, y, Xv, yv, rounds):
    """GBDT.train in each package on the same matrices; (JAX model, port
    model, JAX loop lines, port loop lines)."""
    out = []
    for pkg in ("jax", "torch"):
        cfg = (jconfig.Config if pkg == "jax" else tconfig.Config)(params)
        Binned = JaxBinned if pkg == "jax" else BinnedDataset
        ds = Binned.from_matrix(X, y, max_bin=cfg.max_bin,
                                min_data_in_leaf=cfg.min_data_in_leaf)
        lines = Lines(jlog if pkg == "jax" else log, f"model_layer_{pkg}")
        try:
            if pkg == "jax":
                b = JaxGBDT(cfg, ds)
            else:
                b = create_boosting(cfg, ds, device="cpu")
            b.add_valid_dataset(ds.create_valid(Xv, yv))
            b.train(rounds)
        finally:
            lines.close()
        out += [b, lines.loop_lines()]
    return out[0], out[2], out[1], out[3]


@pytest.mark.parametrize("metric,stop", [("binary_logloss", 3),
                                         ("auc,binary_logloss", 2)])
def test_train_early_stops_where_jax_does(metric, stop):
    X, y = synthetic_binary(800, 7)
    Xv, yv = synthetic_binary(400, 9)
    params = {"objective": "binary", "metric": metric, "num_leaves": 15,
              "num_iterations": 60, "min_data_in_leaf": 5,
              "min_sum_hessian_in_leaf": 0.1, "max_bin": 63,
              "learning_rate": 0.5, "early_stopping_round": stop,
              "verbose": -1}
    jb, tb, jlines, tlines = train_both(params, X, y, Xv, yv, 60)
    assert tb.iter_ < 60, "no early stop: the scenario is degenerate"
    assert tb.iter_ == jb.iter_
    assert tb.best_iteration == jb.best_iteration > 0
    assert tlines == jlines
    assert (f"Early stopping at iteration {jb.iter_}, best iteration "
            f"{jb.best_iteration}") in tlines
    assert set(tb.best_score) == set(jb.best_score)
    trees, flip, _ = cs.compare_model_texts(
        tb.save_model_to_string(), jb.save_model_to_string(), metric,
        names=("torch", "jax"), tie_rtol=TIE_RTOL, leaf_rtol=LEAF_RTOL)
    assert flip is None and trees == jb.iter_


def test_train_is_engine_trains_round(tmp_path):
    """``create_boosting`` + ``add_valid_dataset`` + ``GBDT.train(3)``
    writes the model text ``lt.train`` writes for the same parameters."""
    X, y = synthetic_binary(600, 3)
    Xv, yv = synthetic_binary(200, 4)
    params = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
              "min_data_in_leaf": 20, "learning_rate": 0.1, "verbose": -1}
    ds = lt.Dataset(X, y, params=params)
    bst = lt.train(params, ds, 3, valid_sets=[lt.Dataset(Xv, yv,
                                                         reference=ds)],
                   verbose_eval=False, device="cpu")
    cfg = tconfig.Config(params)
    binned = BinnedDataset.from_matrix(X, y, max_bin=63,
                                       min_data_in_leaf=20)
    gb = create_boosting(cfg, binned, device="cpu")
    gb.add_valid_dataset(binned.create_valid(Xv, yv))
    gb.train(3)
    assert gb.save_model_to_string() == bst.model_to_string()


def test_save_model_to_file_round_trip(tmp_path):
    X, y = synthetic_binary(1500, 7)
    cfg = tconfig.Config({"objective": "binary", "num_leaves": 15,
                          "num_iterations": 10, "min_data_in_leaf": 10,
                          "min_sum_hessian_in_leaf": 1.0, "max_bin": 63,
                          "verbose": -1})
    b = create_boosting(cfg, BinnedDataset.from_matrix(
        X, y, max_bin=63, min_data_in_leaf=10), device="cpu")
    b.train()
    assert b.iter_ == 10
    pred = b.predict(X)
    assert pred.shape == (1, 1500) and ((pred > 0) & (pred < 1)).all()
    np.testing.assert_allclose(pred, 1 / (1 + np.exp(-b.predict_raw(X))),
                               rtol=1e-12)
    text = b.save_model_to_string()
    b2 = GBDT(tconfig.Config({"objective": "binary"}), None)
    b2.load_model_from_string(text)
    np.testing.assert_allclose(pred, b2.predict(X), rtol=1e-9)
    path = str(tmp_path / "model.txt")
    b.save_model_to_file(path)
    assert open(path).read() == text
    b3 = GBDT(tconfig.Config({}), None)
    b3.load_model_from_string(open(path).read())
    np.testing.assert_allclose(b.predict_raw(X), b3.predict_raw(X),
                               rtol=1e-9)
    # the JAX model layer reads the file to the same predictions
    jb = JaxGBDT(jconfig.Config({}), None)
    jb.load_model_from_string(open(path).read())
    np.testing.assert_allclose(jb.predict(X), pred, rtol=1e-9)
    # num_iteration cuts the saved forest, as in JAX
    b.save_model_to_file(path, num_iteration=4)
    assert open(path).read() == b.save_model_to_string(4)
    assert open(path).read().count("Tree=") == 4


def test_create_boosting_takes_an_objective_instance():
    X, y = synthetic_binary(500, 1)
    cfg = tconfig.Config({"objective": "regression", "num_leaves": 7,
                          "max_bin": 31, "min_data_in_leaf": 20,
                          "verbose": -1})
    ds = BinnedDataset.from_matrix(X, y, max_bin=31, min_data_in_leaf=20)
    obj = tobjective.RegressionL1Loss(cfg)
    b = create_boosting(cfg, ds, objective=obj, device="cpu")
    assert b.objective is obj and obj.num_data == 500
    b.train(2)
    # the same rounds as the config naming that objective
    ref = create_boosting(tconfig.Config({**cfg.raw_params(),
                                          "objective": "regression_l1"}),
                          ds, device="cpu")
    ref.train(2)
    assert b.save_model_to_string().split("feature importances")[0] \
        .replace("objective=regression_l1", "") == \
        ref.save_model_to_string().split("feature importances")[0] \
        .replace("objective=regression_l1", "")
    with pytest.raises(lt.LightGBMError):
        create_boosting(cfg, ds)          # the card by default, none here


def _toy_stack(F):
    """Two 3-leaf trees (one categorical node) on bins padded to F."""
    sf = np.array([[2, 7], [2, 7]], np.int32)
    sb = np.array([[5, 2], [3, 7]], np.int32)
    ic = np.array([[False, False], [False, True]])
    lc = np.array([[1, ~0], [1, ~0]], np.int32)
    rc = np.array([[~2, ~1], [~2, ~1]], np.int32)
    lv = np.array([[1.0, 2.0, 4.0], [10.0, 20.0, 40.0]], np.float32)
    bins = np.zeros((F, 257), np.int32)
    bins[:10] = np.random.RandomState(3).randint(0, 10, size=(10, 257))
    return sf, sb, ic, lc, rc, lv, bins


@pytest.mark.parametrize("F", [10, 70])
def test_leaf_indices_forest_equals_jax(F):
    arrays = _toy_stack(F)
    want = np.asarray(jax_leaf_indices(*[jnp.asarray(a) for a in arrays],
                                       max_steps=3))
    got = predict_leaf_indices_forest(*[torch.from_numpy(a)
                                        for a in arrays], max_steps=3)
    assert got.dtype == torch.int32 and got.shape == (2, 257)
    np.testing.assert_array_equal(got.numpy(), want)


def test_leaf_indices_forest_equals_predict_leaf_index():
    X, y = synthetic_binary(700, 5)
    cfg = tconfig.Config({"objective": "binary", "num_leaves": 15,
                          "max_bin": 63, "min_data_in_leaf": 10,
                          "verbose": -1})
    ds = BinnedDataset.from_matrix(X, y, max_bin=63, min_data_in_leaf=10)
    b = create_boosting(cfg, ds, device="cpu")
    b.train(4)
    tas = b.tree_arrays
    assert len(tas) == 4

    def stack(field):
        return torch.stack([getattr(ta, field) for ta in tas])

    sf = stack("split_feature")
    is_cat = b.is_cat[sf.clamp(min=0).long()]
    got = predict_leaf_indices_forest(
        sf, stack("split_bin"), is_cat, stack("left_child"),
        stack("right_child"), stack("leaf_value"),
        torch.from_numpy(ds.bins), max_steps=15)
    np.testing.assert_array_equal(got.numpy().T, b.predict_leaf_index(X))


OBJECTIVES = ["regression", "regression_l1", "huber", "fair", "poisson",
              "binary", "multiclass", "lambdarank", "none", "xentropy"]


@pytest.mark.parametrize("objective", OBJECTIVES)
def test_config_helpers_equal_jax(objective):
    assert tconfig.default_metric_for_objective(objective) == \
        jconfig.default_metric_for_objective(objective)
    if objective == "xentropy":
        return
    raw = {"objective": objective, "num_leaves": "31", "shrinkage_rate": 0.2,
           "num_class": 3 if objective == "multiclass" else 1}
    jc, tc = jconfig.Config(raw), tconfig.Config(raw)
    assert tc.raw_params() == jc.raw_params()
    assert tc.raw_params() is not tc.raw
    jd, td = jc.to_dict(), tc.to_dict()
    assert td["metric"] == jd["metric"]
    for key in set(jd) & set(td):
        assert td[key] == jd[key], key
    ju, tu = jc.updated(num_leaves=7, bagging_fraction="0.5"), \
        tc.updated(num_leaves=7, bagging_fraction="0.5")
    assert tu.raw_params() == ju.raw_params()
    assert (tu.num_leaves, tu.bagging_fraction, tu.learning_rate) == \
        (ju.num_leaves, ju.bagging_fraction, ju.learning_rate) == \
        (7, 0.5, 0.2)
    assert tc.num_leaves == 31        # the original is unchanged


@pytest.mark.parametrize("objective", OBJECTIVES[:-1])
def test_objective_surface_equals_jax(objective):
    params = {"objective": objective,
              "num_class": 3 if objective == "multiclass" else 1}
    jo = jobjective.create_objective(jconfig.Config(params))
    to = tobjective.create_objective(tconfig.Config(params))
    assert to.boost_from_average() == jo.boost_from_average() == 0.0
    score = np.random.RandomState(0).normal(
        size=(to.num_tree_per_iteration, 6))
    np.testing.assert_allclose(np.asarray(to.convert_output(score)),
                               np.asarray(jo.convert_output(score)),
                               rtol=1e-12)


def test_gradients_reads_the_objectives_own_arrays():
    from lightgbm_tpu_torch.io.dataset import Metadata
    md = Metadata()
    md.set_label(np.array([0.0, 1.0, 1.0, 0.0]))
    obj = tobjective.create_objective(tconfig.Config({"objective": "binary"}))
    obj.init(md, 4)
    score = torch.tensor([[0.1, -0.2, 0.3, 0.0]])
    g, h = obj.gradients(score)
    g2, h2 = obj.gradients_with(obj.gradient_arrays(CPU), score)
    assert torch.equal(g, g2) and torch.equal(h, h2)


def test_stdlib_bridge_mirrors_records():
    lines = Lines(log, "lightgbm_tpu_torch_test_bridge")
    try:
        log.set_verbosity(-1)       # the console fully suppressed...
        log.info("bridged %s", "yes")
        log.warning("bridged warning")
        log.debug("bridged debug")
        with pytest.raises(lt.LightGBMError):
            log.fatal("bridged fatal")
    finally:
        log.set_verbosity(1)
        lines.close()
    levels = {r.getMessage(): r.levelno for r in lines.records}
    # ...but the bridge sees every record at its mapped level
    assert levels == {"bridged yes": logging.INFO,
                      "bridged warning": logging.WARNING,
                      "bridged debug": logging.DEBUG,
                      "bridged fatal": logging.CRITICAL}
    assert log.enable_stdlib_bridge().name == "lightgbm_tpu_torch"
    log.disable_stdlib_bridge()
    log.info("not bridged")
    assert len(lines.records) == 4


def test_from_matrix_label_idx_and_subset_params():
    X, y = synthetic_binary(300, 2)
    for Binned in (JaxBinned, BinnedDataset):
        assert Binned.from_matrix(X, y, label_idx=3).label_idx == 3
        assert Binned.from_matrix(X, y).label_idx == 0
    sub_params = {"max_bin": 63, "verbose": -1}
    for pkg in (lgb, lt):
        ds = pkg.Dataset(X, y, params={"max_bin": 63})
        assert ds.subset([0, 1, 2]).params == ds.params
        sub = ds.subset(np.arange(100), params=sub_params)
        assert sub.params == sub_params
        assert sub.construct().num_data() == 100
