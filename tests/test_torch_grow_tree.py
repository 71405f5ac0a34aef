"""The torch port's fixed-trip serial grower (lightgbm_tpu_torch/ops/
grow.py ``grow_tree``) against the JAX package's ``grow_tree``.

Both get the same bins and the same f32 gradients, hessians and row
weights, made from numpy seeds, and the same ``SerialComm`` strategy:
``cached`` (the per-leaf digit cache with the smaller child's K1
histogram over compacted rows), ``nocache`` (K2 full passes) and
``fused`` (K3 full passes).  On the CPU every strategy runs the plain
versions of its kernels, as the JAX package's grower does off the TPU.

Structure is held exactly (num_leaves, split feature and bin, children,
leaf and internal counts, leaf parents and depths, and every row's
leaf); values and gains to the tolerance that tests/test_torch_grow.py
states and explains (1e-5 relative, or 1e-6 of the tree's largest gain
for gains, which are small differences of f32 sums that the two packages
associate differently).

The port's cached grower is also held against the port's leaf-ordered
grower: identical structure, gains and values within 1e-6 relative, the
tolerance of the JAX package's own ordered-against-cached test
(tests/test_ordered_grow.py).  Root totals are summed in another order
by the two growers, so bit identity is not expected.
"""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lightgbm_tpu.ops import leafhist as jlh
from lightgbm_tpu.ops.grow import GrowParams as JaxGrowParams
from lightgbm_tpu.ops.grow import SerialComm as JaxSerialComm
from lightgbm_tpu.ops.grow import grow_tree as jax_grow_tree

from lightgbm_tpu_torch import obs
from lightgbm_tpu_torch.ops import leafhist
from lightgbm_tpu_torch.ops.grow import GrowParams, SerialComm, grow_tree
from lightgbm_tpu_torch.ops.ordered_grow import grow_tree_ordered

pytestmark = pytest.mark.torch

EXACT = ("split_feature", "split_bin", "left_child", "right_child",
         "leaf_count", "internal_count", "leaf_parent", "leaf_depth")
CLOSE = ("leaf_value", "internal_value", "split_gain")
STRATEGIES = {"cached": (True, False), "nocache": (False, False),
              "fused": (False, True)}


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


def _torch_args(bins, num_bin, is_cat, grad, hess):
    f, n = bins.shape
    return (torch.from_numpy(bins), torch.from_numpy(num_bin),
            torch.from_numpy(is_cat), torch.ones(f, dtype=torch.bool),
            torch.from_numpy(grad), torch.from_numpy(hess),
            torch.ones(n, dtype=torch.float32), 0.1)


def _grow_both(data, params, strategy):
    bins, num_bin, is_cat, grad, hess = data
    f, n = bins.shape
    comm = STRATEGIES[strategy]
    jt, jleaf, jdelta = jax_grow_tree(
        jnp.asarray(bins), jnp.asarray(num_bin), jnp.asarray(is_cat),
        jnp.ones(f, bool), jnp.asarray(grad), jnp.asarray(hess),
        jnp.ones(n, jnp.float32), jnp.float32(0.1), JaxGrowParams(*params),
        JaxSerialComm(*comm))
    tt, tleaf, tdelta = grow_tree(*_torch_args(*data), GrowParams(*params),
                                  SerialComm(*comm))
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
    assert tleaf.dtype == torch.int32 and tdelta.dtype == torch.float32
    np.testing.assert_array_equal(tleaf.numpy(), jleaf)
    np.testing.assert_allclose(tdelta.numpy(), jdelta, rtol=1e-5,
                               atol=1e-30)


# (num_leaves, max_bin, min_data_in_leaf, min_sum_hessian, l1, l2,
#  min_gain, max_depth), data (n, f, bins, categorical features)
SCENARIOS = {
    "categorical": ((15, 48, 20, 1.0, 0.0, 0.0, 0.0, -1),
                    (5000, 8, 48, (1, 4))),
    "max_depth": ((31, 48, 20, 1.0, 0.0, 1.0, 0.0, 3), (5000, 8, 48, ())),
    "min_data_near_leaf_size": ((15, 32, 700, 1.0, 0.5, 0.0, 0.0, -1),
                                (6000, 6, 32, (2,))),
    "stops_early": ((31, 16, 300, 1.0, 0.0, 0.0, 0.0, -1),
                    (2400, 5, 16, ())),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
def test_grow_tree_matches_jax(strategy, scenario):
    params, (n, f, b, cat) = SCENARIOS[scenario]
    data = _data(n, f, b, np.uint8, seed=len(scenario), cat=cat)
    reads0 = obs.get_counter("grower_host_reads")
    j, t = _grow_both(data, params, strategy)
    _check(j, t)
    num_leaves = int(t[0].num_leaves)
    # one read at the end of the tree; the cached strategy adds one a
    # step for the smaller child's count
    want = 1 + (params[0] - 1 if strategy == "cached" else 0)
    assert obs.get_counter("grower_host_reads") - reads0 == want
    if scenario == "max_depth":
        assert int(t[0].leaf_depth.max()) <= 3 and num_leaves < params[0]
    if scenario == "stops_early":
        assert 1 < num_leaves < params[0]
        assert (t[0].split_feature.numpy()[num_leaves - 1:] == -1).all()


@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
def test_grow_tree_uint16_bins_match_jax(strategy):
    data = _data(4000, 6, 300, np.uint16, seed=2, cat=(3,))
    j, t = _grow_both(data, (15, 300, 30, 1.0, 0.0, 1.0, 0.0, -1), strategy)
    _check(j, t)
    assert int(t[0].num_leaves) == 15


@pytest.mark.parametrize("dtype,b,cat", [(np.uint8, 32, ()),
                                         (np.uint8, 48, (1,)),
                                         (np.uint16, 300, (2,))])
def test_cached_grower_equals_ordered(dtype, b, cat):
    data = _data(8000, 6, b, dtype, seed=5, cat=cat)
    params = GrowParams(num_leaves=15, max_bin=b, min_data_in_leaf=20,
                        min_sum_hessian_in_leaf=1.0)
    args = _torch_args(*data)
    tc, leaf_c, delta_c = grow_tree(*args, params, SerialComm())
    rm = torch.from_numpy(np.ascontiguousarray(data[0].T))
    to, leaf_o, delta_o = grow_tree_ordered(rm, *args[1:], params)
    assert int(tc.num_leaves) == int(to.num_leaves) == 15
    for field in EXACT:
        assert torch.equal(getattr(tc, field), getattr(to, field)), field
    for field in CLOSE:
        np.testing.assert_allclose(getattr(tc, field).numpy(),
                                   getattr(to, field).numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=field)
    assert torch.equal(leaf_c, leaf_o)
    np.testing.assert_allclose(delta_c.numpy(), delta_o.numpy(), rtol=1e-6,
                               atol=1e-7)


def test_strategies_agree_and_bins_rm_is_optional():
    data = _data(3000, 5, 24, np.uint8, seed=7, cat=(0,))
    params = GrowParams(num_leaves=11, max_bin=24, min_data_in_leaf=15,
                        min_sum_hessian_in_leaf=0.5)
    args = _torch_args(*data)
    trees = {s: grow_tree(*args, params, SerialComm(*c))
             for s, c in STRATEGIES.items()}
    rm = torch.from_numpy(np.ascontiguousarray(data[0].T))
    again = grow_tree(*args, params, SerialComm(), bins_rm=rm)
    for s, (tt, leaf, _) in list(trees.items()) + [("bins_rm", again)]:
        for field in EXACT:
            assert torch.equal(getattr(tt, field),
                               getattr(trees["cached"][0], field)), (s, field)
        assert torch.equal(leaf, trees["cached"][1]), s
    # the full-pass strategies scan the same f32 histograms
    for a, b in zip(trees["nocache"][0], trees["fused"][0]):
        assert torch.equal(a, b)
    # one feature a column, through the EFB decode: the same trees
    from lightgbm_tpu_torch.io.bundling import BundlePlan
    from lightgbm_tpu_torch.ops.bundle import BundleDecode
    mappers = [types.SimpleNamespace(num_bin=int(nb), default_bin=0)
               for nb in data[1]]
    dec = BundleDecode.from_plan(BundlePlan.identity(len(mappers)), mappers,
                                 params.max_bin, torch.device("cpu"))
    bundled = grow_tree(*args, params, SerialComm(), bundle=dec)
    for field in EXACT + CLOSE:
        assert torch.equal(getattr(bundled[0], field),
                           getattr(trees["cached"][0], field)), field
    assert torch.equal(bundled[1], trees["cached"][1])


def test_leaf_histogram_matches_jax():
    rng = np.random.RandomState(11)
    n, f, b = 20000, 6, 40
    bins = rng.randint(0, b, size=(n, f)).astype(np.uint8)
    g = rng.normal(size=n).astype(np.float32)
    h = rng.uniform(0.1, 0.3, size=n).astype(np.float32)
    w = np.ones(n, np.float32)
    tg, th, tw = (torch.from_numpy(a) for a in (g, h, w))
    digits = leafhist.quantize_digits(tg, th, tw,
                                      leafhist.compute_scales(tg, th, tw))
    classes = leafhist.size_classes(n)
    assert classes == tuple(jlh.size_classes(n))
    for N in (1, 2, 3, 5, 9000, 16385, 1 << 20):
        assert leafhist.size_classes(N) == tuple(jlh.size_classes(N))
    for frac in (0.001, 0.2, 0.5):
        mask = rng.rand(n) < frac
        cnt = int(mask.sum())
        got = leafhist.leaf_histogram(torch.from_numpy(bins), digits,
                                      torch.from_numpy(mask), cnt, b,
                                      classes)
        want = np.asarray(jlh.leaf_histogram(
            jnp.asarray(bins), jnp.asarray(digits.numpy()),
            jnp.asarray(mask), jnp.int32(cnt), b, classes))
        np.testing.assert_array_equal(got.numpy(), want)
        idx, valid = leafhist.compact_rows(torch.from_numpy(mask), 8192)
        k = min(cnt, 8192)
        np.testing.assert_array_equal(idx[:k].numpy(),
                                      np.nonzero(mask)[0][:k])
        assert int(valid.sum()) == k
