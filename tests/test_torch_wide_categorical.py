"""A categorical feature whose mapper is wider than ``max_bin`` trains on
the CPU through every serial grower of the port.

300 equally frequent categories at ``max_bin=255`` give a 294-bin mapper
(io/binning.py keeps taking categories below 98% coverage, in both
packages), so the histograms, 255 bins wide, see codes up to 293.  Every
histogram of the port drops such codes, as the CUDA kernels and the JAX
package's Pallas kernels do; before that the plain versions filed them
under the next feature's bins, or raised in the last feature.  The
categorical column goes first and last, for 3 rounds of regression.
"""

import numpy as np
import pytest

import lightgbm_tpu_torch as lt

pytestmark = pytest.mark.torch

ROUNDS = 3


def make_wide_categorical(n=3000, f=5, cat_col=0, seed=0):
    """(X, y): 300 equally frequent categories in ``cat_col``, normal
    values elsewhere, a label that depends on both."""
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, f))
    cats = np.arange(n) % 300
    rng.shuffle(cats)
    X[:, cat_col] = cats
    y = np.sin(cats / 17.0) + 0.5 * X[:, (cat_col + 1) % f] \
        + 0.1 * rng.normal(size=n)
    return X, y


@pytest.mark.parametrize("grow", ["ordered", "cached", "fused"])
@pytest.mark.parametrize("cat_col", [0, 4])
def test_a_294_bin_categorical_trains_at_max_bin_255(cat_col, grow):
    X, y = make_wide_categorical(cat_col=cat_col)
    params = {"objective": "regression", "num_leaves": 15, "max_bin": 255,
              "min_data_in_leaf": 5, "serial_grow": grow, "verbose": -1}
    ds = lt.Dataset(X, y, params=params)
    booster = lt.train(params, ds, ROUNDS, categorical_feature=[cat_col],
                       device="cpu")
    widths = [m.num_bin for m in ds._binned.mappers]
    assert widths[cat_col] == 294 and max(widths) == 294
    assert booster.num_trees() == ROUNDS
    pred = booster.predict(X)
    assert pred.shape == (len(y),) and np.isfinite(pred).all()
    assert np.mean((pred - y) ** 2) < np.var(y)
