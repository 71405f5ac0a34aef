"""Training the port's new objectives against the JAX package, and the
bookkeeping that only shows past binary training.

* Every objective trains through ``lt.train`` like ``lgb.train`` on the
  same seeded matrix (3 rounds, a valid set, row weights; LambdaRank
  with query sizes): tree structures equal, per-round metrics within
  1e-4, raw predictions within 1e-5.
* The model text of a regression, LambdaRank or multiclass model
  carries the JAX header (``objective=``, ``sigmoid=-1``,
  ``num_class=``), and a loaded model predicts raw scores, or the
  softmax for multiclass, never a sigmoid.  (The port used to write the
  binary ``sigmoid`` whatever the objective.)
* A 3-class model trained from a custom objective: a round where no
  class can split is popped in both packages, and a valid set added
  after it gets the same scores as in the JAX package (which replays
  only the trees it kept); another round after it adds to both alike.
* A round in which one class cannot split and the others can keeps its
  single-leaf tree, so the tree count stays a multiple of ``num_class``
  and the model reloads, as in the JAX package.
* ``fobj`` and ``feval`` through ``lt.train`` as through ``lgb.train``.
"""

import numpy as np
import pytest

import lightgbm_tpu as lgb

import lightgbm_tpu_torch as lt

pytestmark = pytest.mark.torch

BASE = {"num_leaves": 7, "max_bin": 31, "min_data_in_leaf": 20,
        "learning_rate": 0.2, "verbose": -1}
N, NV, F = 900, 300, 5
ROUNDS = 3


def _data(seed, n):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, F))
    latent = X[:, 0] - 0.7 * X[:, 1] + 0.4 * X[:, 2] * X[:, 3] \
        + rng.normal(scale=0.5, size=n)
    return X, latent, rng


def _labels(objective, latent, rng):
    if objective in ("regression", "regression_l1", "huber", "fair"):
        return latent * 2.0
    if objective == "poisson":
        return rng.poisson(np.exp(0.5 * latent)).astype(np.float64)
    if objective == "binary":
        return (latent > 0).astype(np.float64)
    if objective == "multiclass":
        return np.digitize(latent, np.quantile(latent, [0.25, 0.5, 0.75]))
    return np.clip(np.round(latent + 2), 0, 4)          # relevance 0..4


CASES = [
    ("regression", {}),
    ("regression_l1", {}),
    ("huber", {"huber_delta": 0.5}),
    ("fair", {}),
    ("poisson", {}),
    ("multiclass", {"num_class": 4}),
    ("lambdarank", {"ndcg_eval_at": "1,3"}),
]


def _groups(n, seed):
    rng = np.random.RandomState(seed)
    sizes = []
    while sum(sizes) < n:
        sizes.append(int(rng.randint(1, 40)))
    sizes[-1] -= sum(sizes) - n
    return [s for s in sizes if s > 0]


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def trained(request):
    objective, extra = request.param
    X, lat, rng = _data(1, N)
    Xv, latv, rngv = _data(2, NV)
    y, yv = _labels(objective, lat, rng), _labels(objective, latv, rngv)
    w = np.random.RandomState(3).uniform(0.5, 2.0, size=N)
    params = {**BASE, "objective": objective, **extra}
    kw = dict(weight=w)
    if objective == "lambdarank":
        kw["group"], gv = _groups(N, 4), _groups(NV, 5)
    out = {"objective": objective, "Xv": Xv}
    for name, pkg, more in (("jax", lgb, {}),
                            ("torch", lt, {"device": "cpu"})):
        ds = pkg.Dataset(X, y, params=dict(params), **kw)
        vs = pkg.Dataset(Xv, yv, reference=ds,
                         **({"group": gv} if objective == "lambdarank"
                            else {}))
        ev = {}
        b = pkg.train(dict(params), ds, ROUNDS, valid_sets=[ds, vs],
                      valid_names=["train", "valid"], evals_result=ev,
                      verbose_eval=False, **more)
        out[name] = (b, ev)
    return out


def test_objective_trains_like_jax(trained):
    bj, ej = trained["jax"]
    bt, et = trained["torch"]
    mj, mt = bj._booster.models, bt._booster.models
    assert len(mt) == len(mj) > 0
    for i, (a, b) in enumerate(zip(mj, mt)):
        assert b.num_leaves == a.num_leaves, i
        n = a.num_leaves - 1
        for field in ("split_feature", "threshold", "left_child",
                      "right_child", "decision_type"):
            np.testing.assert_array_equal(
                np.asarray(getattr(b, field))[:n],
                np.asarray(getattr(a, field))[:n], err_msg=f"{i} {field}")
        np.testing.assert_allclose(
            np.asarray(b.leaf_value)[:a.num_leaves],
            np.asarray(a.leaf_value)[:a.num_leaves], rtol=1e-5, atol=1e-7)
    assert et.keys() == ej.keys()
    for data in ej:
        assert et[data].keys() == ej[data].keys()
        for metric, values in ej[data].items():
            np.testing.assert_allclose(et[data][metric], values, rtol=0,
                                       atol=1e-4, err_msg=metric)
    Xv = trained["Xv"]
    np.testing.assert_allclose(
        bt.predict(Xv, raw_score=True),
        np.asarray(bj.predict(Xv, raw_score=True)), rtol=0, atol=1e-5)


def test_model_header_and_transform_match_jax(trained, tmp_path):
    bj, _ = trained["jax"]
    bt, _ = trained["torch"]
    tj, tt = bj.model_to_string(), bt.model_to_string()
    head = lambda text: [ln for ln in text.split("Tree=0")[0].splitlines()  # noqa: E731
                         if ln.startswith(("objective=", "sigmoid=",
                                           "num_class=", "label_index="))]
    assert head(tt) == head(tj)
    if trained["objective"] != "binary":
        assert "sigmoid=-1" in head(tt)
    path = tmp_path / "m.txt"
    bt.save_model(str(path))
    loaded = lt.Booster(model_file=str(path), device="cpu")
    Xv = trained["Xv"]
    raw = loaded.predict(Xv, raw_score=True)
    out = loaded.predict(Xv)
    if trained["objective"] == "multiclass":
        e = np.exp(raw - raw.max(axis=1, keepdims=True))
        np.testing.assert_allclose(out, e / e.sum(axis=1, keepdims=True),
                                   rtol=1e-12)
    else:
        np.testing.assert_array_equal(out, raw)
    np.testing.assert_allclose(
        out, np.asarray(lgb.Booster(model_file=str(path)).predict(Xv)),
        rtol=1e-5, atol=1e-6)


def _fobj(phase):
    """A custom 3-class objective: the softmax gradients of the labels,
    or, while ``phase["constant"]``, the same gradient on every row (no
    split can gain: every class saturates)."""
    def fobj(preds, ds):
        y = np.asarray(ds.get_label())
        n = len(y)
        if phase["constant"]:
            return np.full(3 * n, 0.25), np.ones(3 * n)
        onehot = (np.arange(3)[:, None] == y[None, :]).astype(np.float64)
        p = preds.reshape(3, n)
        e = np.exp(p - p.max(axis=0))
        prob = e / e.sum(axis=0)
        return (prob - onehot).ravel(), (2 * prob * (1 - prob)).ravel()
    return fobj


def test_valid_set_added_after_a_popped_round_matches_jax():
    X, lat, _ = _data(6, N)
    Xv, latv, _ = _data(7, NV)
    y = np.digitize(lat, [-0.5, 0.5]).astype(np.float64)
    yv = np.digitize(latv, [-0.5, 0.5]).astype(np.float64)
    params = {**BASE, "objective": "none", "num_class": 3}
    # the JAX Booster bins its Dataset with the Dataset's own params
    jt = lgb.Dataset(X, y, params=dict(params))
    tt = lt.Dataset(X, y, params=dict(params))
    bj = lgb.Booster(params=dict(params), train_set=jt)
    bt = lt.Booster(params=dict(params), train_set=tt, device="cpu")
    phase = {"constant": False}
    fobj = _fobj(phase)
    assert not bj.update(fobj=fobj) and not bt.update(fobj=fobj)
    phase["constant"] = True
    bj.update(fobj=fobj)
    assert bt.update(fobj=fobj), "constant gradients must saturate"
    assert bt.num_trees() == bj.num_trees() == 3
    assert len(bt._booster.tree_arrays) == 3
    # the JAX package pipelines its rounds: it reports the saturation
    # one call late, and trains nothing in that call
    assert bj.update(fobj=fobj) and bj.num_trees() == 3
    bj.add_valid(lgb.Dataset(Xv, yv, reference=jt), "v")
    bt.add_valid(lt.Dataset(Xv, yv, reference=tt), "v")
    np.testing.assert_allclose(bt._inner_predict(1),
                               bj._Booster__inner_predict(1), rtol=0,
                               atol=1e-5)
    phase["constant"] = False
    bj.update(fobj=fobj)
    assert not bt.update(fobj=fobj)
    assert bt.num_trees() == bj.num_trees() == 6
    for i in (0, 1):
        np.testing.assert_allclose(bt._inner_predict(i),
                                   bj._Booster__inner_predict(i), rtol=0,
                                   atol=1e-5)


def test_one_class_saturating_keeps_its_tree_like_jax():
    X, lat, _ = _data(8, N)
    # class 2 never occurs: its round-0 gradients are equal on every
    # row, so no split of it gains more than min_gain_to_split
    y = (lat > 0).astype(np.float64)
    params = {**BASE, "objective": "multiclass", "num_class": 3,
              "min_gain_to_split": 1e-3}
    bj = lgb.train(dict(params), lgb.Dataset(X, y), ROUNDS)
    bt = lt.train(dict(params), lt.Dataset(X, y), ROUNDS, device="cpu",
                  verbose_eval=False)
    leaves = [t.num_leaves for t in bt._booster.models]
    assert leaves == [t.num_leaves for t in bj._booster.models]
    assert len(leaves) == 3 * ROUNDS and leaves[2] == 1
    assert min(leaves[0], leaves[1]) > 1
    text = bt.model_to_string()
    again = lt.Booster(model_str=text, device="cpu")
    assert again.num_trees() == 3 * ROUNDS
    np.testing.assert_allclose(again.predict(X[:50], raw_score=True),
                               bt.predict(X[:50], raw_score=True), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(again.predict(X[:50], raw_score=True),
                               np.asarray(bj.predict(X[:50],
                                                     raw_score=True)),
                               rtol=0, atol=1e-5)


def test_custom_objective_and_metric_match_jax():
    X, lat, _ = _data(9, N)
    Xv, latv, _ = _data(10, NV)
    y, yv = (lat > 0).astype(np.float64), (latv > 0).astype(np.float64)

    def fobj(preds, ds):
        p = 1.0 / (1.0 + np.exp(-preds))
        return p - np.asarray(ds.get_label()), p * (1.0 - p)

    def feval(preds, ds):
        err = ((preds > 0) != (np.asarray(ds.get_label()) > 0)).mean()
        return "my_error", float(err), False

    out = {}
    for name, pkg, more in (("jax", lgb, {}),
                            ("torch", lt, {"device": "cpu"})):
        ds = pkg.Dataset(X, y)
        vs = pkg.Dataset(Xv, yv, reference=ds)
        ev = {}
        b = pkg.train({**BASE, "metric": "none"}, ds, ROUNDS,
                      valid_sets=[vs], valid_names=["v"], fobj=fobj,
                      feval=feval, evals_result=ev, verbose_eval=False,
                      **more)
        out[name] = (b, ev)
    (bj, ej), (bt, et) = out["jax"], out["torch"]
    assert "objective=none" in bt.model_to_string()
    assert [t.num_leaves for t in bt._booster.models] == \
        [t.num_leaves for t in bj._booster.models]
    np.testing.assert_allclose(et["v"]["my_error"], ej["v"]["my_error"],
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(bt.predict(Xv, raw_score=True),
                               np.asarray(bj.predict(Xv, raw_score=True)),
                               rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="don't match training data"):
        bt.update(fobj=lambda p, d: (np.zeros(3), np.zeros(3)))
