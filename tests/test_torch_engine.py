"""The port's engine (lightgbm_tpu_torch: ``train(init_model=,
early_stopping_rounds=, learning_rates=, callbacks=)``,
``Booster.rollback_one_iter``, ``reset_parameter``, ``merge``,
``predict(pred_leaf=True)``) against the JAX package on the CPU.

The same seeded numpy matrices (``chip_smoke.make_higgs_like``, the
bench's Higgs-like generator) go through both
packages.  Continued training from a JAX-saved file, a port-saved file
(each package continues from each) and an in-memory Booster: the init
scores within 1e-6 of their largest (the JAX package's predictor walks
in f64 on the host, the port's in f32 with a Kahan fold), the carried
trees' text byte-equal to the init model's, every tree structure-equal
to JAX's (thresholds 1e-9 relative, leaf values within 1e-5 of the
tree's largest; a split whose two best gains lie within 1e-5 of each
other may go either way in f32 sums summed in another order: such a
near-tie is reported and nothing after it compared), and each round's
valid metric within 1e-4.  Rollbacks hold the score buffers to JAX's
and to the buffers before the rolled-back rounds within 1e-6 of the
largest score (``score + d - d`` is not exact in f32, in either
package).  Leaf indices are exact.
"""

import numpy as np
import pytest

import chip_smoke as cs
import lightgbm_tpu as lgb
from lightgbm_tpu.models.gbdt import estimate_train_memory as jax_estimate

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import LightGBMError
from lightgbm_tpu_torch.models.gbdt import estimate_train_memory

pytestmark = pytest.mark.torch

PARAMS = {"objective": "binary", "metric": "auc", "num_leaves": 15,
          "max_bin": 63, "learning_rate": 0.1, "min_data_in_leaf": 20,
          "verbose": -1}
TIE_RTOL = 1e-5
LEAF_RTOL = 1e-5


def _three_class(X, seed):
    """Labels 0-2: the terciles of a noisy latent of the features."""
    rng = np.random.RandomState(seed)
    z = X[:, 0] - 0.5 * X[:, 1] + 0.3 * X[:, 14] + rng.normal(size=len(X))
    return np.digitize(z, np.quantile(z, [1 / 3, 2 / 3])).astype(np.float64)


def compare_models(port, jax, label):
    """Every tree of the two model texts; returns the near-tie flip (or
    None), which the comparison prints."""
    return cs.compare_model_texts(port, jax, label, names=("torch", "jax"),
                                  tie_rtol=TIE_RTOL, leaf_rtol=LEAF_RTOL)[1]


def both(fn):
    """``fn(pkg, extra)`` for the JAX package and for the port on the
    CPU (``extra`` = the port's ``device`` keyword)."""
    return fn(lgb, {}), fn(lt, {"device": "cpu"})


def continue_both(params, X, y, Xv, yv, init_jax, init_port, rounds):
    """Continue ``rounds`` rounds in each package from its init model
    with a valid set; returns ((booster, train Dataset, evals) of JAX,
    the same of the port)."""
    out = []
    for pkg, init, extra in ((lgb, init_jax, {}),
                             (lt, init_port, {"device": "cpu"})):
        ds = pkg.Dataset(X, y)
        ev = {}
        b = pkg.train(params, ds, rounds,
                      valid_sets=[pkg.Dataset(Xv, yv, reference=ds)],
                      init_model=init, evals_result=ev, verbose_eval=False,
                      **extra)
        out.append((b, ds, ev))
    return out


def check_continued(jax_run, port_run, init_text, init_rounds, label,
                    num_class=1):
    (bj, dj, ej), (bt, dt, et) = jax_run, port_run
    ij, it = np.asarray(dj.get_init_score()), np.asarray(dt.get_init_score())
    assert it.shape == ij.shape == (num_class * dj.num_data(),)
    assert np.abs(it - ij).max() <= 1e-6 * np.abs(ij).max(), label
    text = bt.model_to_string()
    K = init_rounds * num_class
    assert cs.trees_text(text, 0, K) == cs.trees_text(init_text, 0, K)
    flip = compare_models(text, bj.model_to_string(), label)
    if flip is None:
        assert bt.num_trees() == bj.num_trees()
    assert bt.current_iteration() == bj.current_iteration()
    assert et.keys() == ej.keys()
    for name in ej:
        for metric in ej[name]:
            np.testing.assert_allclose(et[name][metric], ej[name][metric],
                                       rtol=0, atol=1e-4,
                                       err_msg=f"{label} {name} {metric}")
    return flip


@pytest.fixture(scope="module")
def data():
    X, y = cs.make_higgs_like(2000, seed=1)
    Xv, yv = cs.make_higgs_like(500, seed=2)
    return X, y, Xv, yv


@pytest.fixture(scope="module")
def bases(data, tmp_path_factory):
    """5 rounds in each package, in memory and saved."""
    X, y, _, _ = data
    d = tmp_path_factory.mktemp("bases")
    bj, bt = both(lambda pkg, ex: pkg.train(PARAMS, pkg.Dataset(X, y), 5,
                                            verbose_eval=False, **ex))
    bj.save_model(str(d / "jax5.txt"))
    bt.save_model(str(d / "torch5.txt"))
    return {"jax": bj, "torch": bt, "jax_file": str(d / "jax5.txt"),
            "torch_file": str(d / "torch5.txt")}


@pytest.mark.parametrize("init", ["jax_file", "torch_file", "booster"])
def test_continued_training_matches_jax(data, bases, init):
    """Each package continues 5 rounds from the same file (a JAX one,
    a port one), or each from its own in-memory Booster."""
    X, y, Xv, yv = data
    if init == "booster":
        init_jax, init_port = bases["jax"], bases["torch"]
        init_text = bases["torch"].model_to_string()
    else:
        init_jax = init_port = bases[init]
        with open(bases[init]) as fh:
            init_text = fh.read()
    runs = continue_both(PARAMS, X, y, Xv, yv, init_jax, init_port, 5)
    check_continued(*runs, init_text, 5, init)
    bt = runs[1][0]
    assert bt.num_trees() == 10 and bt.current_iteration() == 10
    # the training score buffer is the continued model's prediction
    np.testing.assert_allclose(
        bt.predict(X, raw_score=True),
        bt._booster.train_data.score[0].numpy(), rtol=0, atol=1e-5)


def test_continued_multiclass_matches_jax(data, tmp_path):
    X, y, Xv, _ = data
    y3, yv3 = _three_class(X, 3), _three_class(Xv, 4)
    params = {**PARAMS, "objective": "multiclass", "num_class": 3,
              "metric": "multi_logloss", "num_leaves": 7}
    path = str(tmp_path / "jax_mc.txt")
    lgb.train(params, lgb.Dataset(X, y3), 2,
              verbose_eval=False).save_model(path)
    with open(path) as fh:
        init_text = fh.read()
    runs = continue_both(params, X, y3, Xv, yv3, path, path, 2)
    check_continued(*runs, init_text, 2, "multiclass", num_class=3)
    assert runs[1][0].num_trees() == 12


def test_continued_linear_matches_jax(data, tmp_path):
    """A linear model continued with ``linear_tree=true``: the loaded
    trees' affine parts replayed onto the valid set."""
    X, y, Xv, yv = data
    params = {**PARAMS, "linear_tree": True, "linear_max_leaf_features": 3,
              "linear_lambda": 0.01, "num_leaves": 7}
    path = str(tmp_path / "lin.txt")
    lt.train(params, lt.Dataset(X, y), 2, device="cpu",
             verbose_eval=False).save_model(path)
    with open(path) as fh:
        init_text = fh.read()
    assert "leaf_coeff=" in init_text
    runs = continue_both(params, X, y, Xv, yv, path, path, 2)
    check_continued(*runs, init_text, 2, "linear")
    bt = runs[1][0]
    assert sum(t.has_linear() for t in bt._booster.models) == 4


def test_continued_init_booster_is_not_touched(data, bases):
    """A Booster as ``init_model`` keeps predicting what it did."""
    X, y, _, _ = data
    before = bases["torch"].predict(X[:200], raw_score=True)
    lt.train(PARAMS, lt.Dataset(X, y), 2, init_model=bases["torch"],
             device="cpu", verbose_eval=False)
    assert bases["torch"].num_trees() == 5
    np.testing.assert_array_equal(
        bases["torch"].predict(X[:200], raw_score=True), before)


def test_predictor_after_construction_is_refused_as_in_jax(data, bases):
    X, y, _, _ = data
    for pkg, extra in ((lgb, {}), (lt, {"device": "cpu"})):
        ds = pkg.Dataset(X, y).construct()
        with pytest.raises(Exception, match="Cannot set predictor"):
            pkg.train(PARAMS, ds, 1, init_model=bases["jax_file"],
                      verbose_eval=False, **extra)
    # with the raw data kept, the Dataset is binned again
    ds = lt.Dataset(X, y, free_raw_data=False).construct()
    bt = lt.train(PARAMS, ds, 1, init_model=bases["jax_file"],
                  device="cpu", verbose_eval=False)
    assert bt.num_trees() == 6 and ds.get_init_score() is not None


def _noisy(n, seed):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, 5))
    y = ((X[:, 0] + 1.5 * rng.normal(size=n)) > 0).astype(np.float64)
    return X, y


ES_PARAMS = {"objective": "binary", "metric": ["binary_logloss", "auc"],
             "num_leaves": 7, "learning_rate": 0.5, "min_data_in_leaf": 10,
             "verbose": -1}


def test_early_stopping_matches_jax():
    """The same stop round, ``best_iteration`` (1-based, the best round
    of the first metric's history) and ``evals_result``, with the
    training set among the evaluated sets under its own name."""
    X, y = _noisy(600, 0)
    Xv, yv = _noisy(300, 1)

    def run(pkg, extra):
        ds = pkg.Dataset(X, y)
        ev = {}
        b = pkg.train(ES_PARAMS, ds, 50,
                      valid_sets=[ds, pkg.Dataset(Xv, yv, reference=ds)],
                      valid_names=["train", "held"],
                      early_stopping_rounds=3, evals_result=ev,
                      verbose_eval=False, **extra)
        return b, ev
    (bj, ej), (bt, et) = both(run)
    assert bt.num_trees() == bj.num_trees() < 50
    assert bt.best_iteration == bj.best_iteration > 0
    assert et.keys() == ej.keys() == {"train", "held"}
    for name in ej:
        for metric in ej[name]:
            assert len(et[name][metric]) == bt.num_trees()
            np.testing.assert_allclose(et[name][metric], ej[name][metric],
                                       rtol=0, atol=1e-4)
    # the pair that stopped it: its best round is best_iteration, 3
    # rounds before the last
    stop = bt.num_trees()
    hits = [m for m, best in (("binary_logloss", np.argmin),
                              ("auc", np.argmax))
            if 1 + int(best(et["held"][m])) == bt.best_iteration]
    assert hits and stop - bt.best_iteration == 3
    assert bt.eval(bt._train_set, "x")[0][0] == "train"


def test_learning_rate_schedules_match_jax():
    """``learning_rates`` as a list and as a function, and a
    ``reset_parameter`` callback that changes ``num_leaves`` (the grower
    is rebuilt): the trees of JAX, with the rates in ``shrinkage``."""
    X, y = _noisy(600, 2)
    rates = [0.3, 0.1, 0.2, 0.05]
    for kwargs in ({"learning_rates": rates},
                   {"learning_rates": lambda i: 0.3 * 0.5 ** i},
                   {"callbacks": [lt.reset_parameter(
                       num_leaves=[3, 7, 5, 7])]}):
        jkw = dict(kwargs)
        if "callbacks" in kwargs:
            jkw["callbacks"] = [lgb.reset_parameter(num_leaves=[3, 7, 5, 7])]
        bj = lgb.train(ES_PARAMS, lgb.Dataset(X, y), 4, verbose_eval=False,
                       **jkw)
        bt = lt.train(ES_PARAMS, lt.Dataset(X, y), 4, device="cpu",
                      verbose_eval=False, **kwargs)
        assert compare_models(bt.model_to_string(), bj.model_to_string(),
                              str(kwargs)) is None
        assert [t.shrinkage for t in bt._booster.models] == \
            [t.shrinkage for t in bj._booster.models]
        assert [t.num_leaves for t in bt._booster.models] == \
            [t.num_leaves for t in bj._booster.models]
    assert [t.shrinkage for t in bt._booster.models] == [0.5] * 4


def test_a_rate_schedule_rebuilds_no_grower():
    X, y = _noisy(300, 3)
    bt = lt.Booster(params=ES_PARAMS, train_set=lt.Dataset(X, y),
                    device="cpu")
    grow = bt._booster._grow
    bt.reset_parameter({"learning_rate": 0.2})
    assert bt._booster._grow is grow and bt._booster.shrinkage_rate == 0.2
    bt.reset_parameter({"num_leaves": 5})
    assert bt._booster._grow is not grow
    # a new tree_learner rebuilds the grower (one rank here: it warns
    # and grows serial, as the JAX package does on one device)
    grow = bt._booster._grow
    bt.reset_parameter({"tree_learner": "data", "num_machines": 2})
    assert bt._booster._grow is not grow
    assert bt._booster.config.tree_learner == "data"
    assert bt._booster.grow_kind == "ordered"
    assert not bt.update()


def test_unresettable_keys_and_short_lists_raise_as_in_jax():
    X, y = _noisy(300, 4)
    for pkg in (lgb, lt):
        for key in ("num_class", "boosting_type", "metric"):
            with pytest.raises(RuntimeError, match=f"cannot reset {key}"):
                pkg.reset_parameter(**{key: [1, 2]})
    for pkg, extra in ((lgb, {}), (lt, {"device": "cpu"})):
        with pytest.raises(ValueError, match="has 2 entries but training "
                                             "runs 3 rounds"):
            pkg.train(ES_PARAMS, pkg.Dataset(X, y), 3,
                      learning_rates=[0.1, 0.2], verbose_eval=False, **extra)


def _scores(booster):
    b = booster._booster
    return [b.train_data.host_score()] + [dd.host_score()
                                          for dd in b.valid_data]


def test_rollback_matches_jax(data):
    """6 rounds, two rolled back: the score buffers of JAX, and those
    after round 4."""
    X, y, Xv, yv = data
    out = []
    for pkg, extra in ((lgb, {}), (lt, {"device": "cpu"})):
        # (the JAX Booster bins with the Dataset's own params)
        ds = pkg.Dataset(X, y, params=PARAMS)
        b = pkg.Booster(params=PARAMS, train_set=ds, **extra)
        b.add_valid(pkg.Dataset(Xv, yv, reference=ds), "valid_1")
        for _ in range(4):
            b.update()
        at4 = _scores(b)
        b.update()
        b.update()
        b.rollback_one_iter().rollback_one_iter()
        out.append((b, at4, _scores(b)))
    (bj, _, sj), (bt, at4, st) = out
    assert bt.num_trees() == bj.num_trees() == 4
    assert bt.current_iteration() == bj.current_iteration() == 4
    for a, b_, c in zip(st, sj, at4):
        top = np.abs(c).max()
        assert np.abs(a - b_).max() <= 1e-6 * top
        assert np.abs(a - c).max() <= 1e-6 * top
    assert compare_models(bt.model_to_string(), bj.model_to_string(),
                          "rollback") is None


def test_rollback_into_the_init_model_matches_jax(data, bases):
    """Continue 2 rounds from a 5-round file and roll back 4: into the
    loaded trees, in the training and the valid scores."""
    X, y, Xv, yv = data
    runs = continue_both(PARAMS, X, y, Xv, yv, bases["jax_file"],
                         bases["jax_file"], 2)
    (bj, _, _), (bt, _, _) = runs
    for b in (bj, bt):
        for _ in range(4):
            b.rollback_one_iter()
    assert bt.num_trees() == bj.num_trees() == 3
    assert bt.current_iteration() == bj.current_iteration() == 3
    for a, b_ in zip(_scores(bt), _scores(bj)):
        assert np.abs(a - b_).max() <= 1e-6 * np.abs(b_).max()
    # what is left is the init model's first 3 rounds on both sets
    want = lt.Booster(model_file=bases["jax_file"], device="cpu").predict(
        Xv, num_iteration=3, raw_score=True)
    np.testing.assert_allclose(_scores(bt)[1][0], want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("num_iteration", [-1, 3])
def test_pred_leaf_equals_jax(data, bases, num_iteration):
    X, _, Xv, _ = data
    rows = np.vstack([Xv, X[:100]])
    rows[::7, 3] = np.nan
    for src in ("jax", "torch"):
        lj = lgb.Booster(model_file=bases[f"{src}_file"]).predict(
            rows, num_iteration=num_iteration, pred_leaf=True)
        for bt in (lt.Booster(model_file=bases[f"{src}_file"],
                              device="cpu"), bases[src]):
            if src == "jax" and bt is bases[src]:
                continue
            lp = bt.predict(rows, num_iteration=num_iteration,
                            pred_leaf=True)
            assert lp.dtype == np.int32 and lp.shape == lj.shape == (
                len(rows), 5 if num_iteration < 0 else 3)
            np.testing.assert_array_equal(lp, lj)
    lp = bases["torch"].predict(rows, pred_leaf=True)
    lj = bases["jax"].predict(rows, pred_leaf=True)
    np.testing.assert_array_equal(lp, lj)


def test_merge_matches_jax(data, bases, tmp_path):
    """``merge(shrinkage_decay=0.5)``: base + 0.5 * other, as JAX's."""
    X, _, Xv, _ = data
    out = []
    for pkg, extra in ((lgb, {}), (lt, {"device": "cpu"})):
        base = pkg.Booster(model_file=bases["jax_file"], **extra)
        other = pkg.Booster(model_file=bases["torch_file"], **extra)
        want = base.predict(Xv, raw_score=True) + 0.5 * other.predict(
            Xv, raw_score=True)
        base.merge(other, shrinkage_decay=0.5)
        got = base.predict(Xv, raw_score=True)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        assert base.num_trees() == 10 and other.num_trees() == 5
        out.append((base, got))
    (bj, pj), (bt, pt) = out
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-6)
    assert bt.current_iteration() == bj.current_iteration() == 10
    path = str(tmp_path / "merged.txt")
    bt.save_model(path)
    np.testing.assert_allclose(
        lgb.Booster(model_file=path).predict(Xv, raw_score=True), pt,
        rtol=0, atol=1e-6)


def test_merge_refusals_match_jax(data, bases, tmp_path):
    X, y, _, _ = data
    y3 = _three_class(X, 5)
    mc = {**PARAMS, "objective": "multiclass", "num_class": 3,
          "metric": "multi_logloss", "num_leaves": 4}
    reg = {**PARAMS, "objective": "regression", "metric": "l2",
           "num_leaves": 4}
    files = {}
    for name, params, Xs, ys in (("mc", mc, X, y3), ("reg", reg, X, y),
                                 ("narrow", PARAMS, X[:, :10], y)):
        files[name] = str(tmp_path / f"{name}.txt")
        lt.train(params, lt.Dataset(Xs, ys), 1, device="cpu",
                 verbose_eval=False).save_model(files[name])
    for name, what in (("mc", "num_class mismatch"),
                       ("narrow", "feature width mismatch"),
                       ("reg", "objective mismatch")):
        messages = []
        for pkg, extra in ((lgb, {}), (lt, {"device": "cpu"})):
            base = pkg.Booster(model_file=bases["jax_file"], **extra)
            with pytest.raises(Exception, match=f"Cannot merge: {what}") \
                    as err:
                base.merge(pkg.Booster(model_file=files[name], **extra))
            assert base.num_trees() == 5
            messages.append(str(err.value))
        assert messages[0] == messages[1]
    for decay in (0.0, 1.5):
        with pytest.raises(LightGBMError, match="shrinkage_decay"):
            bases["torch"].merge(bases["torch"], shrinkage_decay=decay)


def test_linear_memory_term_equals_jax():
    for k in (0, 1, 5):
        got = estimate_train_memory(100_000, 28, 63, 255, 1, linear_k=k)
        want = jax_estimate(100_000, 28, 63, 255, 1, linear_k=k)
        assert got["linear_fit"] == want["linear_fit"]
        assert (got["linear_fit"] > 0) == (k > 0)
