"""The torch port's leaf-ordered grower (lightgbm_tpu_torch/ops/
ordered_grow.py) against the JAX package's growers.

Both get the same bins and the same f32 gradients, hessians and row
weights, made from numpy seeds.  uint8 bins go through the JAX
``grow_tree_ordered``; uint16 bins (which the JAX ordered grower's word
packing does not take) through the JAX cached grower ``grow_tree``, which
its own tests pin to the ordered one.  Tree structure must be equal
exactly (num_leaves, split_feature, split_bin, left/right child,
leaf_count, and every row's leaf); leaf values, internal values and
split gains within 1e-5 relative.  The root sums and the split scan's
cumulative sums associate differently in the two packages (XLA's
cumulative sum is neither sequential f32 nor the f64-accumulated one
``torch.cumsum`` computes on the CPU), so f32 sums differ in the last
bits.  A split gain is ``L + R - P`` of three such sums, and where it is
small beside them that last-bit noise is large beside the gain: gains
are therefore held to 1e-5 relative OR 1e-6 of the tree's largest gain
(the worst case seen is 1.3e-5 relative, 1e-7 of the largest gain).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lightgbm_tpu.ops.grow import GrowParams as JaxGrowParams
from lightgbm_tpu.ops.grow import grow_tree as jax_grow_tree
from lightgbm_tpu.ops.ordered_grow import grow_tree_ordered as jax_ordered

from lightgbm_tpu_torch import obs
from lightgbm_tpu_torch.ops import leafhist
from lightgbm_tpu_torch.ops.grow import (GrowParams, pack_tree_arrays,
                                         unpack_tree_arrays)
from lightgbm_tpu_torch.ops.ordered_grow import grow_tree_ordered

pytestmark = pytest.mark.torch

EXACT = ("split_feature", "split_bin", "left_child", "right_child",
         "leaf_count", "internal_count", "leaf_parent", "leaf_depth")
CLOSE = ("leaf_value", "internal_value", "split_gain")


def _data(n, f, b, dtype, seed, cat=()):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, b, size=(f, n)).astype(dtype)
    signal = (bins[0].astype(np.float64) / b - 0.5) \
        + 0.5 * (bins[1] % 3 == 0) - 0.3 * (bins[2].astype(np.float64) / b)
    grad = (rng.normal(size=n) * 0.5 - signal).astype(np.float32)
    hess = rng.uniform(0.1, 0.25, size=n).astype(np.float32)
    num_bin = np.full(f, b, np.int32)
    is_cat = np.zeros(f, bool)
    is_cat[list(cat)] = True
    return bins, num_bin, is_cat, grad, hess


def _grow_both(bins, num_bin, is_cat, grad, hess, params, jax_kind):
    f, n = bins.shape
    w = np.ones(n, np.float32)
    mask = np.ones(f, bool)
    rm = np.ascontiguousarray(bins.T)
    grow = jax_ordered if jax_kind == "ordered" else jax_grow_tree
    jt, jleaf, jdelta = grow(
        jnp.asarray(bins), jnp.asarray(num_bin), jnp.asarray(is_cat),
        jnp.asarray(mask), jnp.asarray(grad), jnp.asarray(hess),
        jnp.asarray(w), jnp.float32(0.1), JaxGrowParams(*params),
        bins_rm=jnp.asarray(rm))
    tt, tleaf, tdelta = grow_tree_ordered(
        torch.from_numpy(rm), torch.from_numpy(num_bin),
        torch.from_numpy(is_cat), torch.from_numpy(mask),
        torch.from_numpy(grad), torch.from_numpy(hess),
        torch.from_numpy(w), 0.1, GrowParams(*params))
    return (jt, np.asarray(jleaf), np.asarray(jdelta)), (tt, tleaf, tdelta)


def _check(j, t):
    (jt, jleaf, jdelta), (tt, tleaf, tdelta) = j, t
    assert int(tt.num_leaves) == int(jt.num_leaves)
    for field in EXACT:
        np.testing.assert_array_equal(getattr(tt, field).numpy(),
                                      np.asarray(getattr(jt, field)),
                                      err_msg=field)
    for field in CLOSE:
        want = np.asarray(getattr(jt, field))
        atol = 1e-6 * np.abs(want).max() if field == "split_gain" else 1e-30
        np.testing.assert_allclose(getattr(tt, field).numpy(), want,
                                   rtol=1e-5, atol=atol, err_msg=field)
    np.testing.assert_array_equal(tleaf.numpy(), jleaf)
    np.testing.assert_allclose(tdelta.numpy(), jdelta, rtol=1e-5,
                               atol=1e-30)


@pytest.mark.parametrize("num_leaves,cat,max_depth", [
    (15, (), -1), (31, (1,), -1), (31, (), 3)])
def test_ordered_grower_matches_jax_uint8(num_leaves, cat, max_depth):
    bins, num_bin, is_cat, g, h = _data(6000, 8, 48, np.uint8, seed=1,
                                        cat=cat)
    params = (num_leaves, 48, 20, 1.0, 0.0, 0.0, 0.0, max_depth)
    reads0 = obs.get_counter("grower_host_reads")
    j, t = _grow_both(bins, num_bin, is_cat, g, h, params, "ordered")
    _check(j, t)
    n_leaves = int(t[0].num_leaves)
    # one read for the root, one per split, one to check the partition
    assert obs.get_counter("grower_host_reads") - reads0 == n_leaves + 1
    if max_depth > 0:
        assert int(t[0].leaf_depth.max()) <= max_depth
        assert n_leaves < num_leaves
    else:
        assert n_leaves == num_leaves


def test_ordered_grower_matches_jax_uint16():
    bins, num_bin, is_cat, g, h = _data(5000, 6, 300, np.uint16, seed=2,
                                        cat=(3,))
    params = (15, 300, 30, 1.0, 0.0, 1.0, 0.0, -1)
    j, t = _grow_both(bins, num_bin, is_cat, g, h, params, "cached")
    _check(j, t)
    assert int(t[0].num_leaves) == 15


def test_saturated_tree_has_one_leaf():
    bins, num_bin, is_cat, g, h = _data(500, 4, 16, np.uint8, seed=3)
    params = (15, 16, 400, 1.0, 0.0, 0.0, 0.0, -1)   # min_data > N / 2
    j, t = _grow_both(bins, num_bin, is_cat, g, h, params, "ordered")
    _check(j, t)
    tt, tleaf, tdelta = t
    assert int(tt.num_leaves) == 1
    assert (tt.split_feature.numpy() == -1).all()
    assert not tdelta.any() and not tleaf.any()


def test_histogram_callable_sees_each_window_once():
    bins, num_bin, is_cat, g, h = _data(4000, 5, 32, np.uint8, seed=4)
    windows = []

    def hist(bins_rm, digits, max_bin, start=0, count=None):
        n = bins_rm.shape[0] if count is None else count
        windows.append((start, n))
        return leafhist.digit_histogram_plain(bins_rm, digits, max_bin,
                                              start, count)

    rm = torch.from_numpy(np.ascontiguousarray(bins.T))
    args = (rm, torch.from_numpy(num_bin), torch.from_numpy(is_cat),
            torch.ones(5, dtype=torch.bool), torch.from_numpy(g),
            torch.from_numpy(h), torch.ones(4000), 0.1,
            GrowParams(num_leaves=15, max_bin=32, min_data_in_leaf=20,
                       min_sum_hessian_in_leaf=1.0))
    tt, _, delta = grow_tree_ordered(*args, histogram=hist)
    # the root over all rows, then the smaller child of every split
    assert windows[0] == (0, 4000)
    assert len(windows) == int(tt.num_leaves)
    assert all(2 * n <= 4000 for _, n in windows[1:])
    t2, _, delta2 = grow_tree_ordered(*args)
    ints, flts = pack_tree_arrays(tt)
    ints2, flts2 = pack_tree_arrays(t2)
    assert torch.equal(ints, ints2) and torch.equal(flts, flts2)
    assert torch.equal(delta, delta2)
    back = unpack_tree_arrays(ints, flts, 15)
    for a, b in zip(back, tt):
        assert torch.equal(a, b)
    assert torch.equal(rm, torch.from_numpy(np.ascontiguousarray(bins.T)))
