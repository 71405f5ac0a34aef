"""The port's ``cv`` and ``Dataset.subset`` against the JAX package on
the CPU.

The same seeded numpy matrices go through ``lightgbm_tpu.cv`` and
``lightgbm_tpu_torch.cv`` (``device="cpu"``): the folds themselves
equal, index for index (they come from ``np.random.RandomState(seed)``
in both), and every round's mean and standard deviation of every metric
within 1e-4, the per-round metric tolerance of
``tests/test_torch_train.py``: plain, stratified, unshuffled folds, a
``data_splitter``, an early stop (the results cut to
``best_iteration``; the JAX package's early stopping raises on
``cv``'s entries, so its full run is cut instead), and LambdaRank with
a splitter that keeps each query in one fold.  A row subset shares the
full set's mappers and carries its bins, raw values, labels, weights,
init scores and queries as the JAX ``BinnedDataset.subset`` does.
"""

import numpy as np
import pytest

import lightgbm_tpu as lgb
from lightgbm_tpu.engine import _make_n_folds as jax_folds
from lightgbm_tpu.io.dataset import BinnedDataset as JaxBinned

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import LightGBMError
from lightgbm_tpu_torch.engine import _make_n_folds as port_folds
from lightgbm_tpu_torch.io.dataset import BinnedDataset

pytestmark = pytest.mark.torch

PARAMS = {"objective": "binary", "metric": ["auc", "binary_logloss"],
          "num_leaves": 7, "max_bin": 63, "min_data_in_leaf": 20,
          "verbose": -1}
ROUNDS = 4


def _data(n=900, seed=1):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, 8))
    y = ((X[:, 0] - 0.5 * X[:, 1] + rng.normal(size=n)) > 0).astype(float)
    return X, y


class _EveryThird:
    """A splitter with ``split``: fold k holds the rows i % 3 == k."""

    def split(self, idx):
        return [(idx[idx % 3 != k], idx[idx % 3 == k]) for k in range(3)]


class _WholeQueries:
    """Query-aligned folds: query q goes to fold q % 3, whole."""

    def __init__(self, sizes):
        self.qid = np.repeat(np.arange(len(sizes)), sizes)

    def split(self, idx):
        fold = self.qid[idx] % 3
        return [(idx[fold != k], idx[fold == k]) for k in range(3)]


CASES = {
    "plain": {"nfold": 3, "seed": 3},
    "stratified": {"nfold": 3, "seed": 5, "stratified": True},
    "unshuffled": {"nfold": 4, "shuffle": False},
    "splitter": {"data_splitter": _EveryThird()},
}


def _check_results(rt, rj, label):
    assert rt.keys() == rj.keys() and rj, label
    for key in rj:
        assert len(rt[key]) == len(rj[key]), (label, key)
        np.testing.assert_allclose(rt[key], rj[key], rtol=0, atol=1e-4,
                                   err_msg=f"{label} {key}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_folds_equal_jax(case):
    X, y = _data()
    kw = dict(CASES[case])
    splitter = kw.pop("data_splitter", None)
    nfold = kw.pop("nfold", 3)
    seed = kw.pop("seed", 0)
    fj = jax_folds(lgb.Dataset(X, y, params=PARAMS), splitter, nfold,
                   dict(PARAMS), seed, **kw)
    ft = port_folds(lt.Dataset(X, y, params=PARAMS), splitter, nfold,
                    dict(PARAMS), seed, device="cpu", **kw)
    assert len(ft.boosters) == len(fj.boosters) == nfold
    cover = np.zeros(len(y), np.int64)
    for bj, bt in zip(fj.boosters, ft.boosters):
        np.testing.assert_array_equal(bt._train_set.used_indices,
                                      bj._train_set.used_indices)
        np.testing.assert_array_equal(bt._valid_sets[0].used_indices,
                                      bj._valid_sets[0].used_indices)
        cover[bt._valid_sets[0].used_indices] += 1
        # a fold shares the full set's mappers
        assert bt._booster.train_set.mappers is \
            bt._valid_sets[0]._binned.mappers
    assert (cover == 1).all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_cv_matches_jax(case):
    X, y = _data()
    rj = lgb.cv(PARAMS, lgb.Dataset(X, y), ROUNDS, **CASES[case])
    rt = lt.cv(PARAMS, lt.Dataset(X, y), ROUNDS, device="cpu",
               **CASES[case])
    _check_results(rt, rj, case)
    assert set(rt) == {"valid auc-mean", "valid auc-stdv",
                       "valid binary_logloss-mean",
                       "valid binary_logloss-stdv"}
    assert all(len(v) == ROUNDS for v in rt.values())


def test_cv_early_stop_truncates_like_jax():
    """The JAX package's early stopping unpacks four fields of each
    evaluation entry and raises on ``cv``'s five; the port's reads them
    by position, as the reference does.  Its early-stopped results are
    JAX's full run cut to ``best_iteration`` rounds, the best round of
    the mean's history (2 rounds before the last it ran)."""
    X, y = _data(600, 7)
    params = {**PARAMS, "learning_rate": 0.8, "metric": "binary_logloss"}
    with pytest.raises(ValueError, match="too many values to unpack"):
        lgb.cv(params, lgb.Dataset(X, y), 10, nfold=3, seed=2,
               early_stopping_rounds=2)
    rj = lgb.cv(params, lgb.Dataset(X, y), 10, nfold=3, seed=2)
    rt = lt.cv(params, lt.Dataset(X, y), 10, nfold=3, seed=2,
               early_stopping_rounds=2, device="cpu")
    full = rj["valid binary_logloss-mean"]
    best = int(np.argmin(full[:len(rt["valid binary_logloss-mean"]) + 2]))
    assert 0 < len(rt["valid binary_logloss-mean"]) == best + 1 < 8
    _check_results(rt, {k: v[:best + 1] for k, v in rj.items()},
                   "early stop")


def test_cv_lambdarank_with_whole_queries_matches_jax():
    rng = np.random.RandomState(11)
    # query q has size base[q % 8] and goes to fold q % 3: every fold
    # gets each base size once, so the folds have equal row counts
    sizes = np.tile(rng.randint(5, 16, size=8), 3)
    n = int(sizes.sum())
    X = rng.normal(size=(n, 6))
    rel = np.clip(np.round(X[:, 0] + 0.7 * rng.normal(size=n) + 1.5), 0, 3)
    params = {"objective": "lambdarank", "metric": "ndcg",
              "ndcg_eval_at": [1, 3], "num_leaves": 7, "max_bin": 63,
              "min_data_in_leaf": 10, "verbose": -1}
    out = []
    for pkg, extra in ((lgb, {}), (lt, {"device": "cpu"})):
        out.append(pkg.cv(params, pkg.Dataset(X, rel, group=sizes), 3,
                          data_splitter=_WholeQueries(sizes), **extra))
    rj, rt = out
    _check_results(rt, rj, "lambdarank")
    assert set(rt) == {"valid ndcg@1-mean", "valid ndcg@1-stdv",
                       "valid ndcg@3-mean", "valid ndcg@3-stdv"}


def test_subset_equals_jax():
    """Bins, raw values, labels, weights, every class's init scores and
    the rebuilt queries of a row subset, as the JAX subset has them."""
    X, y = _data(300, 9)
    rng = np.random.RandomState(4)
    sizes = rng.randint(1, 12, size=60)
    sizes[-1] += 300 - sizes.sum()
    w = rng.uniform(0.5, 1.5, size=300)
    init = rng.normal(size=600)
    built = []
    for cls in (JaxBinned, BinnedDataset):
        ds = cls.from_matrix(X, y, max_bin=63, min_data_in_leaf=5,
                             keep_raw=True)
        md = ds.metadata
        md.set_weights(w)
        md.set_query(sizes)
        md.set_init_score(init)
        built.append(ds)
    idx = np.sort(rng.choice(300, 170, replace=False))
    sj, st = (ds.subset(idx) for ds in built)
    assert st.mappers is built[1].mappers
    np.testing.assert_array_equal(st.bins, sj.bins)
    np.testing.assert_array_equal(st.raw, sj.raw)
    for field in ("label", "weights", "init_score", "query_boundaries",
                  "query_weights"):
        np.testing.assert_array_equal(getattr(st.metadata, field),
                                      getattr(sj.metadata, field), field)
    with pytest.raises(LightGBMError, match="not aligned with query"):
        built[1].subset(idx[::-1])
