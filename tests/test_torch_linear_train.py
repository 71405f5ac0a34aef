"""The torch port's piece-wise linear training (models/linear.py,
``linear_tree=true`` in models/gbdt.py) against the JAX package.

The same numpy data goes to both packages.  ``path_features`` is integer
work and must be exact.  ``fit_leaf_models`` sums its normal equations
in f32 in another order than XLA's ``segment_sum`` (``index_add_``), so
on the same tree, bins, raw values and gradients the feature tables and
fallback counts must be equal, and intercepts, slopes and the score
delta within ``FIT_RTOL`` of their largest magnitude.  Binary training
with the bench's Higgs-like matrix (noisy labels, so no split decides on
an f32 near-tie; a few NaN values, read as 0.0 by the fit) must grow the
same tree structures and ``leaf_feat`` tables in every round with every
grower, with values and coefficients within ``TRAIN_RTOL`` of each
tree's largest, the same fallback counts and AUC within 1e-4.  A ridge
(``linear_lambda=0.01``, as in the JAX tests) keeps every leaf's solve
well away from singular, so no ``use_lin`` decision sits on a rounding
edge.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import lightgbm_tpu as lgb
from lightgbm_tpu import obs
from lightgbm_tpu.models import linear as jlin
from lightgbm_tpu.ops.grow import TreeArrays as JaxTreeArrays

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import cli
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.dataset import BinnedDataset
from lightgbm_tpu_torch.models import linear
from lightgbm_tpu_torch.models.gbdt import GBDT
from lightgbm_tpu_torch.ops.grow import GrowParams
from lightgbm_tpu_torch.ops.ordered_grow import grow_tree_ordered
from lightgbm_tpu_torch.ops.predict import predict_binned_tree
from lightgbm_tpu_torch.utils import log

from test_torch_train import PARAMS, make_higgs_like

pytestmark = pytest.mark.torch

ROUNDS = 8
LINEAR = {"linear_tree": True, "linear_lambda": 0.01}
# f32 normal equations summed in another order: relative to the largest
# magnitude of the field in the tree
FIT_RTOL = 1e-4
TRAIN_RTOL = 1e-4
GROWERS = {"ordered": {}, "cached": {"serial_grow": "cached"},
           "fused": {"serial_grow": "fused"},
           "nocache": {"histogram_pool_size": 0.001,
                       "memory_policy": "degrade"}}


def _data(n, seed):
    X, y = make_higgs_like(n, seed=seed)
    X[::13, 2] = np.nan
    return X, y


# ---------------------------------------------------------------------------
# path_features and fit_leaf_models on one grown tree


def _grown(n, min_data, seed):
    """A tree grown by the port's ordered grower from random gradients,
    with its dataset, raw values and gradients."""
    X, y = _data(n, seed)
    ds = BinnedDataset.from_matrix(X, y, max_bin=63, min_data_in_leaf=min_data,
                                   keep_raw=True)
    rng = np.random.RandomState(seed)
    N = ds.num_data
    grad = torch.from_numpy(rng.normal(size=N).astype(np.float32))
    hess = torch.from_numpy(rng.uniform(0.05, 0.25, N).astype(np.float32))
    w = torch.ones(N, dtype=torch.float32)
    params = GrowParams(num_leaves=15, max_bin=63, min_data_in_leaf=min_data,
                        min_sum_hessian_in_leaf=1e-3, lambda_l1=0.0,
                        lambda_l2=0.0, min_gain_to_split=0.0, max_depth=-1)
    F = ds.num_features
    ta, leaf_id, _ = grow_tree_ordered(
        torch.from_numpy(np.ascontiguousarray(ds.bins.T)),
        torch.from_numpy(ds.num_bin_per_feature()),
        torch.zeros(F, dtype=torch.bool), torch.ones(F, dtype=torch.bool),
        grad, hess, w, 0.1, params)
    raw = np.where(np.isnan(ds.raw), 0.0, ds.raw).astype(np.float32)
    return dict(ds=ds, ta=ta, leaf_id=leaf_id, grad=grad, hess=hess, w=w,
                raw=raw, bins=torch.from_numpy(ds.bins))


@pytest.fixture(scope="module")
def grown():
    return {"ridge": _grown(3000, 20, 1), "starved": _grown(300, 3, 2)}


def _jax_ta(ta):
    return JaxTreeArrays(*(jnp.asarray(np.asarray(a)) for a in ta))


@pytest.mark.parametrize("k", [1, 3, 5, 8])
@pytest.mark.parametrize("cats", ["none", "some"])
def test_path_features_exact_against_jax(grown, k, cats):
    g = grown["ridge"]
    ta = g["ta"]
    is_cat = np.zeros(g["ds"].num_features, bool)
    if cats == "some":   # drop the features of the first two splits
        is_cat[np.asarray(ta.split_feature[:2])] = True
    ours = linear.path_features(ta, torch.from_numpy(is_cat), k).numpy()
    theirs = np.asarray(jlin.path_features(_jax_ta(ta), jnp.asarray(is_cat),
                                           k))
    np.testing.assert_array_equal(ours, theirs)
    nl = int(ta.num_leaves)
    assert (ours[:nl] >= 0).any() and (ours[nl:] == -1).all()


@pytest.mark.parametrize("case,k", [("ridge", 5), ("starved", 8)])
def test_fit_leaf_models_matches_jax(grown, case, k):
    g = grown[case]
    ta = g["ta"]
    F = g["ds"].num_features
    is_cat = torch.zeros(F, dtype=torch.bool)
    params = linear.LinearParams(k, 0.01, 0.0)
    const, coeff, feat, delta, fb = linear.fit_leaf_models(
        ta, g["bins"], is_cat, torch.from_numpy(g["raw"]), g["grad"],
        g["hess"], g["w"], 0.1, params)
    j_ta, j_coeff, j_feat, j_delta, j_fb = jlin.fit_leaf_models(
        _jax_ta(ta), jnp.asarray(g["ds"].bins), jnp.asarray(is_cat.numpy()),
        jnp.asarray(g["raw"]), jnp.asarray(g["grad"].numpy()),
        jnp.asarray(g["hess"].numpy()), jnp.asarray(g["w"].numpy()),
        jnp.float32(0.1), jlin.LinearParams(k, 0.01, 0.0))
    np.testing.assert_array_equal(feat.numpy(), np.asarray(j_feat))
    assert int(fb) == int(j_fb)
    if case == "starved":
        assert int(fb) > 0
    else:
        assert int(fb) == 0 and bool((coeff != 0).any())
    for ours, theirs in ((coeff, j_coeff), (const, j_ta.leaf_value),
                         (delta, j_delta)):
        theirs = np.asarray(theirs)
        np.testing.assert_allclose(
            ours.numpy(), theirs, rtol=0,
            atol=FIT_RTOL * max(float(np.abs(theirs).max()), 1e-30))
    # a fallen-back leaf keeps the grown value and no slope, bit for bit
    used = (coeff != 0).any(dim=1)
    nl = int(ta.num_leaves)
    back = ~used[:nl]
    assert torch.equal(const[:nl][back], ta.leaf_value[:nl][back])


def test_fit_with_the_growers_leaf_equals_the_rewalk(grown):
    g = grown["ridge"]
    F = g["ds"].num_features
    args = (g["ta"], g["bins"], torch.zeros(F, dtype=torch.bool),
            torch.from_numpy(g["raw"]), g["grad"], g["hess"], g["w"], 0.1,
            linear.LinearParams(5, 0.01, 0.0))
    a = linear.fit_leaf_models(*args)
    b = linear.fit_leaf_models(*args, leaf=g["leaf_id"])
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("grower", sorted(GROWERS))
def test_every_growers_leaf_of_a_row_is_the_rewalk_leaf(grower):
    X, y = _data(1500, 3)
    b = lt.Booster(params={**PARAMS, **GROWERS[grower], **LINEAR},
                   train_set=lt.Dataset(X, y), device="cpu")
    gb = b._booster
    assert gb.grow_kind == grower
    grad, hess = gb.objective.gradients_with(gb._grad_arrays,
                                             gb.train_data.score)
    ta, leaf_id, _ = gb._grow(grad[0], hess[0])
    L = gb.grow_params.num_leaves
    sf = ta.split_feature.long()
    _, leaf = predict_binned_tree(sf, ta.split_bin, gb.is_cat[sf.clamp(min=0)],
                                  ta.left_child, ta.right_child,
                                  ta.leaf_value, gb.train_data.bins, L)
    assert torch.equal(leaf_id.long(), leaf)


# ---------------------------------------------------------------------------
# training parity


def _train_both(extra, n=3000, rounds=ROUNDS):
    params = {**PARAMS, **LINEAR, **extra}
    X, y = _data(n, 1)
    Xv, yv = _data(800, 2)
    ej, et = {}, {}
    fb_j = obs.snapshot()["counters"].get("linear_fallback_total", 0)
    tj = lgb.Dataset(X, y)
    bj = lgb.train(params, tj, rounds,
                   valid_sets=[tj, lgb.Dataset(Xv, yv, reference=tj)],
                   evals_result=ej, verbose_eval=False)
    bj.model_to_string()          # flushes the JAX package's pending tree
    fb_j = obs.snapshot()["counters"].get("linear_fallback_total", 0) - fb_j
    fb_t = log.counter("linear_fallback_total")
    tt = lt.Dataset(X, y)
    bt = lt.train(params, tt, rounds,
                  valid_sets=[tt, lt.Dataset(Xv, yv, reference=tt)],
                  evals_result=et, device="cpu", verbose_eval=False)
    fb_t = log.counter("linear_fallback_total") - fb_t
    return dict(X=X, Xv=Xv, bj=bj, bt=bt, ej=ej, et=et, fb_j=fb_j, fb_t=fb_t)


RUNS = {"ridge": {},
        # leaves of 5+ rows against K + 2 = 8: some fall back; the larger
        # ridge keeps the small systems that do solve well conditioned
        "starved": {"min_data_in_leaf": 5, "min_sum_hessian_in_leaf": 1e-3,
                    "linear_max_leaf_features": 6, "linear_lambda": 10.0}}


@pytest.fixture(scope="module", params=sorted(RUNS))
def trained(request):
    extra = RUNS[request.param]
    n = 3000 if request.param == "ridge" else 400
    return dict(name=request.param, **_train_both(extra, n=n))


def _assert_same_trees(mj, mt, rtol):
    assert len(mj) == len(mt)
    for r, (a, b) in enumerate(zip(mj, mt), start=1):
        n = a.num_leaves
        assert b.num_leaves == n, f"round {r}: num_leaves"
        for field in ("split_feature", "threshold", "decision_type",
                      "left_child", "right_child", "leaf_parent"):
            np.testing.assert_array_equal(
                getattr(b, field), getattr(a, field)[:len(getattr(b, field))],
                err_msg=f"round {r}: the tree structure diverged ({field})")
        assert a.has_linear() == b.has_linear(), f"round {r}"
        if a.has_linear():
            np.testing.assert_array_equal(b.leaf_feat, a.leaf_feat,
                                          err_msg=f"round {r}: leaf_feat")
            top = float(np.abs(a.leaf_coeff).max())
            np.testing.assert_allclose(b.leaf_coeff, a.leaf_coeff, rtol=0,
                                       atol=rtol * top,
                                       err_msg=f"round {r}: leaf_coeff")
        top = float(np.abs(a.leaf_value[:n]).max())
        np.testing.assert_allclose(b.leaf_value, a.leaf_value[:n], rtol=0,
                                   atol=rtol * top,
                                   err_msg=f"round {r}: leaf_value")


def test_linear_trees_equal_jax_every_round(trained):
    _assert_same_trees(trained["bj"]._booster.models,
                       trained["bt"]._booster.models, TRAIN_RTOL)
    models = trained["bt"]._booster.models
    assert len(models) == ROUNDS and any(t.has_linear() for t in models)


def test_linear_fallback_counts_equal_jax(trained):
    assert trained["fb_t"] == trained["fb_j"]
    assert trained["bt"]._booster.linear_fallbacks == trained["fb_t"]
    if trained["name"] == "starved":
        assert trained["fb_t"] > 0
    else:
        assert trained["fb_t"] == 0


def test_linear_auc_matches_jax(trained):
    ej, et = trained["ej"], trained["et"]
    assert set(et) == set(ej) == {"training", "valid_1"}
    for name in ej:
        np.testing.assert_allclose(et[name]["auc"], ej[name]["auc"], rtol=0,
                                   atol=1e-4, err_msg=name)


def test_linear_predictions_match_jax_and_the_score_buffer(trained):
    bj, bt, X = trained["bj"], trained["bt"], trained["X"]
    for Q in (X[:1000], trained["Xv"]):
        np.testing.assert_allclose(bt.predict(Q, raw_score=True),
                                   bj.predict(Q, raw_score=True), rtol=0,
                                   atol=1e-5)
    # a training row with a NaN took the branch of its training bin,
    # which the model text does not record (the JAX package's score buffer
    # differs from its saved model on those rows alike): compare the rest
    ok = ~np.isnan(X).any(axis=1)
    pred = bt.predict(X[ok], raw_score=True)
    score = bt._booster.train_data.score[0].numpy()[ok]
    np.testing.assert_allclose(pred, score, rtol=0, atol=1e-5)
    # the f64 host walk with its affine part
    np.testing.assert_allclose(bt._booster.predict_raw(X[ok])[0], pred,
                               rtol=0, atol=1e-5)


def test_saved_linear_model_loads_in_jax(trained, tmp_path):
    path = tmp_path / "linear.txt"
    trained["bt"].save_model(str(path))
    text = path.read_text()
    assert "leaf_coeff=" in text and "leaf_feat=" in text
    Q = trained["Xv"][:300]
    pj = lgb.Booster(model_file=str(path)).predict(Q, raw_score=True)
    pt = lt.Booster(model_file=str(path), device="cpu").predict(
        Q, raw_score=True)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-6)
    np.testing.assert_allclose(pt, trained["bt"].predict(Q, raw_score=True),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("grower", ["cached", "fused", "nocache"])
def test_linear_fit_follows_every_grower_like_jax(grower):
    run = _train_both(GROWERS[grower], n=1500, rounds=4)
    assert run["bt"]._booster.grow_kind == grower
    _assert_same_trees(run["bj"]._booster.models, run["bt"]._booster.models,
                       TRAIN_RTOL)
    for name in run["ej"]:
        np.testing.assert_allclose(run["et"][name]["auc"],
                                   run["ej"][name]["auc"], rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# settings, refusals and the CLI


def test_k0_is_identical_to_linear_tree_false():
    X, y = _data(600, 4)
    log._warned_once.discard("linear_tree_k0")
    a = lt.train({**PARAMS, **LINEAR, "linear_max_leaf_features": 0},
                 lt.Dataset(X, y), 3, device="cpu", verbose_eval=False)
    b = lt.train(PARAMS, lt.Dataset(X, y), 3, device="cpu",
                 verbose_eval=False)
    assert a.model_to_string() == b.model_to_string()
    assert "linear_tree_k0" in log._warned_once


def test_linear_config_keys_match_jax():
    from lightgbm_tpu.config import Config as JaxConfig
    for params in ({}, {"linear_lambda": 0.5, "linear_max_leaf_features": 2}):
        ours, theirs = Config(params), JaxConfig(params)
        for key in ("linear_tree", "linear_lambda",
                    "linear_max_leaf_features"):
            assert ours[key] == getattr(theirs, key)
    for bad in ({"linear_lambda": -1.0}, {"linear_max_leaf_features": -1}):
        with pytest.raises(ValueError, match=next(iter(bad))):
            Config(bad)


def test_linear_without_raw_values_is_refused():
    X, y = _data(300, 5)
    ds = BinnedDataset.from_matrix(X, y, max_bin=63, min_data_in_leaf=20)
    assert ds.raw is None
    cfg = Config({**PARAMS, **LINEAR})
    with pytest.raises(lt.LightGBMError, match="raw feature values"):
        GBDT(cfg, ds, torch.device("cpu"))


def test_valid_set_without_raw_values_is_refused():
    X, y = _data(300, 6)
    ds = BinnedDataset.from_matrix(X, y, max_bin=63, min_data_in_leaf=20,
                                   keep_raw=True)
    gb = GBDT(Config({**PARAMS, **LINEAR}), ds, torch.device("cpu"))
    dv = ds.create_valid(*_data(100, 7))
    assert dv.raw is not None and dv.raw.shape == (ds.num_features, 100)
    dv.raw = None
    with pytest.raises(lt.LightGBMError, match="raw feature values"):
        gb.add_valid_dataset(dv)


def test_dataset_keeps_raw_values_like_jax():
    from lightgbm_tpu.io.dataset import BinnedDataset as JaxBinned
    X, y = _data(500, 8)
    X[:, 5] = 1.0                                 # a trivial feature
    ours = BinnedDataset.from_matrix(X, y, max_bin=63, keep_raw=True)
    theirs = JaxBinned.from_matrix(X, y, max_bin=63, keep_raw=True)
    np.testing.assert_array_equal(ours.raw, theirs.raw)
    Xv, yv = _data(50, 9)
    np.testing.assert_array_equal(ours.create_valid(Xv, yv).raw,
                                  theirs.create_valid(Xv, yv).raw)
    assert BinnedDataset.from_matrix(X, y, max_bin=63).raw is None


def test_cli_trains_and_predicts_a_linear_model(tmp_path):
    X, y = _data(1500, 10)
    data = tmp_path / "train.csv"
    np.savetxt(data, np.column_stack([y, X]), delimiter=",", fmt="%.17g")
    model, out = tmp_path / "model.txt", tmp_path / "pred.txt"
    argv = [f"data={data}", f"output_model={model}", "device=cpu",
            "verbose=-1", "num_iterations=3", "linear_tree=true",
            "linear_lambda=0.01"] + [
        f"{k}={v}" for k, v in PARAMS.items() if k != "verbose"]
    assert cli.main(["task=train"] + argv) == 0
    assert "leaf_coeff=" in model.read_text()
    assert cli.main(["task=predict", f"data={data}", f"input_model={model}",
                     f"output_result={out}", "device=cpu"]) == 0
    want = lgb.Booster(model_file=str(model)).predict(X)
    np.testing.assert_allclose(np.loadtxt(out), want, rtol=1e-5, atol=1e-6)
