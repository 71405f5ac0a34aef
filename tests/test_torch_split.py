"""The torch port's split scan (lightgbm_tpu_torch/ops/split.py) against
the JAX package's ops/split.py.

Both get the same f32 histograms, made from numpy rows.  The chosen
feature and threshold must be equal exactly; the gain and the left sums
within 1e-5 relative (``torch.cumsum`` may associate the prefix sums
differently from ``jnp.cumsum``, so the last bits of a gain can differ).
The data has no near-ties; one test builds exact ties instead and shows
that both packages break them the same way: the largest threshold within
a feature, then the smallest feature.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lightgbm_tpu.ops import split as jsplit

from lightgbm_tpu_torch.ops import split as tsplit

pytestmark = pytest.mark.torch

F, B = 10, 32


def _hists(leaves, seed, cat=()):
    """[leaves, F, B, 3] f32 histograms of random rows, with totals."""
    rng = np.random.RandomState(seed)
    hists, tots = [], []
    for leaf in range(leaves):
        n = rng.randint(300, 3000)
        bins = rng.randint(0, B, size=(n, F))
        g = rng.normal(size=n) + 0.3 * (bins[:, leaf % F] > B // 2)
        h = rng.uniform(0.1, 1.0, size=n)
        hist = np.zeros((F, B, 3))
        for f in range(F):
            for v, x in enumerate((g, h, np.ones(n))):
                hist[f, :, v] = np.bincount(bins[:, f], weights=x,
                                            minlength=B)
        hists.append(hist)
        tots.append((g.sum(), h.sum(), float(n)))
    tots = np.asarray(tots, np.float32)
    num_bin = np.full(F, B, np.int32)
    num_bin[3] = 5                       # a short feature
    is_cat = np.zeros(F, bool)
    is_cat[list(cat)] = True
    return np.asarray(hists, np.float32), tots, num_bin, is_cat


def _run_both(hist, tots, num_bin, is_cat, can, params, feat_mask=None):
    feat_mask = np.ones(F, bool) if feat_mask is None else feat_mask
    js = jsplit.find_best_split(
        jnp.asarray(hist), jnp.asarray(tots[:, 0]), jnp.asarray(tots[:, 1]),
        jnp.asarray(tots[:, 2]), jnp.asarray(num_bin), jnp.asarray(is_cat),
        jnp.asarray(feat_mask), jnp.asarray(can),
        jsplit.SplitParams(*params))
    ts = tsplit.find_best_split(
        torch.from_numpy(hist), torch.from_numpy(tots[:, 0].copy()),
        torch.from_numpy(tots[:, 1].copy()),
        torch.from_numpy(tots[:, 2].copy()), torch.from_numpy(num_bin),
        torch.from_numpy(is_cat), torch.from_numpy(feat_mask),
        torch.from_numpy(can), tsplit.SplitParams(*params))
    return ({k: np.asarray(v) for k, v in js._asdict().items()},
            {k: v.numpy() for k, v in ts._asdict().items()})


def _check(j, t):
    np.testing.assert_array_equal(t["feature"], j["feature"])
    np.testing.assert_array_equal(t["threshold"], j["threshold"])
    assert t["feature"].dtype == np.int32
    for k in ("gain", "left_sum_g", "left_sum_h", "left_count"):
        ok = np.isfinite(j[k])
        np.testing.assert_array_equal(np.isfinite(t[k]), ok, err_msg=k)
        np.testing.assert_allclose(t[k][ok], j[k][ok], rtol=1e-5,
                                   atol=1e-30, err_msg=k)


@pytest.mark.parametrize("cat,params", [
    ((), (20, 1.0, 0.0, 0.0, 0.0)),
    ((1, 6), (20, 1.0, 0.0, 0.0, 0.0)),
    ((2,), (50, 5.0, 0.5, 2.0, 0.1)),
])
def test_find_best_split_matches_jax(cat, params):
    hist, tots, num_bin, is_cat = _hists(6, seed=len(cat), cat=cat)
    can = np.array([True, True, True, True, True, False])
    j, t = _run_both(hist, tots, num_bin, is_cat, can, params)
    _check(j, t)
    assert (t["feature"][:5] >= 0).all()
    assert t["feature"][5] == -1 and np.isneginf(t["gain"][5])


def test_categorical_feature_wins_when_it_should():
    hist, tots, num_bin, is_cat = _hists(1, seed=7, cat=(4,))
    # one category of feature 4 carries a strong signal
    hist[0, 4, 9, 0] -= 150.0
    tots[0, 0] -= 150.0
    j, t = _run_both(hist, tots, num_bin, is_cat, np.array([True]),
                     (20, 1.0, 0.0, 0.0, 0.0))
    _check(j, t)
    assert t["feature"][0] == 4 and t["threshold"][0] == 9


def test_all_invalid_leaf():
    hist, tots, num_bin, is_cat = _hists(2, seed=8)
    # min_data_in_leaf above every leaf's row count: nothing is valid
    j, t = _run_both(hist, tots, num_bin, is_cat, np.array([True, True]),
                     (100000, 1.0, 0.0, 0.0, 0.0))
    _check(j, t)
    np.testing.assert_array_equal(t["feature"], [-1, -1])
    np.testing.assert_array_equal(t["threshold"], [0, 0])
    assert np.isneginf(t["gain"]).all()
    # a feature mask that removes every feature does the same
    j, t = _run_both(hist, tots, num_bin, is_cat, np.array([True, True]),
                     (20, 1.0, 0.0, 0.0, 0.0), feat_mask=np.zeros(F, bool))
    np.testing.assert_array_equal(t["feature"], [-1, -1])


def test_exact_ties_break_alike():
    """Two thresholds of one feature with bit-equal gains, and two
    features with bit-equal histograms: both packages choose the largest
    threshold and then the smallest feature.  (Gains that differ only in
    the last bits are a different matter: there the cumsum association
    can decide, and the packages may choose differently.)"""
    hist = np.zeros((1, F, B, 3), np.float32)
    for f in range(F):            # weak, distinct signal everywhere
        hist[0, f, :, 0] = np.linspace(-1, 1, B) * 0.01 * (f + 1)
        hist[0, f, :, 1] = 1.0
        hist[0, f, :, 2] = 10.0
    for f in (2, 5):              # exact values: bins 0 and 1 tie
        hist[0, f, :, :] = 0.0
        hist[0, f, 0] = [4.0, 1.0, 10.0]
        hist[0, f, 1] = [0.0, 0.0, 0.0]
        hist[0, f, 2] = [-4.0, 1.0, 10.0]
        hist[0, f, 3:] = [0.0, 0.0, 0.0]
    tots = np.array([[0.0, 2.0, 20.0]], np.float32)
    for f in range(F):
        if f not in (2, 5):
            hist[0, f, :, 0] -= hist[0, f, :, 0].mean()
            hist[0, f, :, 1] = 2.0 / B
            hist[0, f, :, 2] = 20.0 / B
    num_bin = np.full(F, B, np.int32)
    j, t = _run_both(hist, tots, num_bin, np.zeros(F, bool),
                     np.array([True]), (1, 0.0, 0.0, 0.0, 0.0))
    _check(j, t)
    assert t["feature"][0] == 2 and t["threshold"][0] == 1
    assert t["gain"][0] == j["gain"][0] == np.float32(32.0)


def test_leaf_output_and_gain_match_jax():
    rng = np.random.RandomState(9)
    g = rng.normal(size=200).astype(np.float32) * 10
    h = rng.uniform(0.5, 5, size=200).astype(np.float32)
    for l1, l2 in ((0.0, 0.0), (0.5, 1.5)):
        np.testing.assert_array_equal(
            tsplit.leaf_output(torch.from_numpy(g), torch.from_numpy(h),
                               l1, l2).numpy(),
            np.asarray(jsplit.leaf_output(jnp.asarray(g), jnp.asarray(h),
                                          l1, l2)))
        np.testing.assert_array_equal(
            tsplit.leaf_split_gain(torch.from_numpy(g), torch.from_numpy(h),
                                   l1, l2).numpy(),
            np.asarray(jsplit.leaf_split_gain(jnp.asarray(g),
                                              jnp.asarray(h), l1, l2)))
