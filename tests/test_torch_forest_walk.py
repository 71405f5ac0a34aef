"""The torch port's forest walk (lightgbm_tpu_torch/ops/forest_walk.py,
ops/predict.py) against the JAX package.

On the CPU the wrappers run their plain versions.  The port builds its
tables with ``CompiledForest.from_arrays`` from the JAX fused forest's
stacked arrays; both packages get the same rows, made from numpy seeds.
Raw scores are held to the JAX fused walk run in interpret mode
(``forest_walk(..., interpret=True)``) and to the JAX gather strategy at
<= 1e-6 absolute (expected bit-equal: both fold f32 leaf values in the
same Kahan order); leaf indices must equal
``predict_leaf_indices_forest`` exactly.  Categorical codes in the rows
are in range (a float outside int32 converts differently per backend).
The kernel itself is held against the plain version on the card by the
``cuda``-marked test, which skips on a host without one.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
from lightgbm_tpu.ops.pallas_walk import (build_walk_tables,
                                          forest_walk as jax_forest_walk,
                                          forest_walk_raw as jax_walk_raw)
from lightgbm_tpu.ops.predict import predict_leaf_indices_forest
from lightgbm_tpu.serve import CompiledForest as JaxForest

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.models.tree import Tree
from lightgbm_tpu_torch.ops import forest_walk as fw
from lightgbm_tpu_torch.serve.forest import CompiledForest

pytestmark = pytest.mark.torch

SIZES = [1, 33, 129, 700]
BUCKETS = [32, 128, 512]


def _train(kind: str):
    rng = np.random.RandomState({"binary": 0, "multiclass": 1,
                                 "categorical": 3}[kind])
    X = rng.normal(size=(700, 6))
    X[:, 3] = np.round(X[:, 3] * 4) / 4       # boundary-tied values
    params = {"num_leaves": 7, "verbose": -1, "min_data_in_leaf": 20,
              "objective": "binary"}
    cat = "auto"
    y = (X[:, 0] + 0.3 * X[:, 1] > 0).astype(np.float64)
    if kind == "multiclass":
        y = np.digitize(X[:, 0], [-0.5, 0.5]).astype(np.float64)
        params.update({"objective": "multiclass", "num_class": 3})
    elif kind == "categorical":
        X[:, 1] = rng.randint(0, 8, size=700)
        y = ((X[:, 0] > 0) ^ (X[:, 1] >= 4)).astype(np.float64)
        cat = [1]
    # train() applies its own categorical_feature (default "auto")
    bst = lgb.train(params, lgb.Dataset(X, label=y, categorical_feature=cat),
                    num_boost_round=4, categorical_feature=cat)
    if cat != "auto":
        assert any((t.decision_type == 1).any()
                   for t in bst._booster.models)
    Xq = X.copy()
    if kind == "categorical":
        Xq[rng.rand(*Xq.shape) < 0.1] = np.nan   # missing values
        Xq[::50, 1] = 97.0                       # unseen category
    return bst, Xq


@pytest.fixture(scope="module")
def forests():
    out = {}
    for kind in ("binary", "multiclass", "categorical"):
        bst, X = _train(kind)
        jf = JaxForest.from_booster(bst, buckets=BUCKETS, serve_walk="fused")
        jg = JaxForest.from_booster(bst, buckets=BUCKETS,
                                    serve_walk="gather")
        stacked = [np.asarray(a) for a in jg._tree_dev]
        tf = CompiledForest.from_arrays(
            *stacked, jg._cuts_num, jg._cuts_cat, jg.num_features,
            jg.transform, jg.sigmoid, device="cpu", buckets=BUCKETS)
        out[kind] = (bst, X, jf, jg, tf, stacked)
    return out


def _bins(jf, X):
    """Host f64 bins in the quantized domain both walks take."""
    b = jf.bin_rows(np.asarray(X, np.float64))
    return np.where(b < 0, int(jf._nan_bin), b).astype(jf._bin_dtype)


@pytest.mark.parametrize("kind", ["binary", "multiclass", "categorical"])
def test_binned_walk_matches_jax_interpret(forests, kind):
    _, X, jf, _, tf, _ = forests[kind]
    for n in SIZES:
        bins = _bins(jf, X[:n])
        ref = np.asarray(jax_forest_walk(
            *jf._walk_dev, bins, num_class=jf.num_class,
            nan_bin=int(jf._nan_bin), interpret=True))
        ours = fw.forest_walk(tf._tables, torch.from_numpy(bins)).numpy()
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6,
                                   err_msg=f"n={n}")


@pytest.mark.parametrize("kind", ["binary", "multiclass", "categorical"])
def test_raw_walk_matches_jax_interpret(forests, kind):
    _, X, jf, _, tf, _ = forests[kind]
    for n in SIZES:
        Xt = np.ascontiguousarray(np.asarray(X[:n], np.float32).T)
        ref = np.asarray(jax_walk_raw(
            *jf._walk_dev, jf._bnd_dev, jf._cats_dev, jf._is_cat_col_dev,
            Xt, num_class=jf.num_class, nan_bin=int(jf._nan_bin),
            max_cuts=int(jf.max_cuts), interpret=True))
        ours = fw.forest_walk_raw(tf._tables, tf._bnd, tf._cats,
                                  tf._is_cat, torch.from_numpy(Xt)).numpy()
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6,
                                   err_msg=f"n={n}")


@pytest.mark.parametrize("kind", ["binary", "multiclass", "categorical"])
def test_forest_matches_jax_gather(forests, kind):
    _, X, _, jg, tf, _ = forests[kind]
    for n in SIZES:
        np.testing.assert_allclose(tf.raw_scores(X[:n]),
                                   jg.raw_scores(X[:n]), rtol=0, atol=1e-6)
        tr, to = tf._device_scores(X[:n])
        gr, go = jg._device_scores(X[:n])
        np.testing.assert_allclose(tr, gr, rtol=0, atol=1e-6)
        np.testing.assert_allclose(to, go, rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind", ["binary", "multiclass", "categorical"])
def test_leaf_indices_equal_jax(forests, kind):
    _, X, jf, jg, tf, stacked = forests[kind]
    bins_j = jg.bin_rows(np.asarray(X, np.float64))
    _, leaves = fw.walk_plain(tf._tables, torch.from_numpy(_bins(jf, X)))
    for k in range(jg.num_class):
        ref = np.asarray(predict_leaf_indices_forest(
            *(a[k] for a in stacked), bins_j, max_steps=jg.num_leaves))
        np.testing.assert_array_equal(leaves[k].numpy(), ref)


def test_from_booster_equals_from_arrays(forests):
    bst, X, _, _, tf, _ = forests["categorical"]
    tb = lt.Booster(model_str=bst.model_to_string(), device="cpu")
    cf = CompiledForest.from_booster(tb, buckets=BUCKETS)
    for a, b in zip(cf._tables, tf._tables):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            assert a == b
    assert cf.info()["bin_dtype"] == "uint8"


def _chain_tree(num_leaves: int, feature: int) -> Tree:
    """A maximally deep tree: node i splits at threshold i and sends the
    rest right, so leaf num_leaves-1 sits num_leaves-1 levels down."""
    t = Tree(num_leaves)
    n = num_leaves - 1
    t.split_feature[:] = feature
    t.threshold[:] = np.arange(n, dtype=np.float64)
    t.left_child[:] = ~np.arange(n)
    t.right_child[:] = np.arange(1, n + 1)
    t.right_child[n - 1] = ~n
    t.leaf_value[:] = np.arange(num_leaves) * 0.25
    return t


def test_deep_tree_and_uint16_bins_follow_host_walk():
    from lightgbm_tpu_torch.models.gbdt import GBDT
    b = GBDT()
    b.max_feature_idx = 1
    # 300 cut values on feature 0 push nan_bin past 255 -> uint16 bins
    b.models = [_chain_tree(255, 0), _chain_tree(47, 1)]
    b.models[1].threshold += 300.0
    b.models.append(_chain_tree(2, 0))
    b.models[2].threshold[:] = [299.5]
    extra = _chain_tree(60, 0)
    extra.threshold = np.arange(60, dtype=np.float64)[:59] + 250.0
    b.models.append(extra)
    cf = CompiledForest.from_booster(b, device="cpu", buckets=[64, 512])
    assert cf.info()["bin_dtype"] == "uint16"
    rng = np.random.RandomState(9)
    X = np.stack([rng.uniform(-2, 320, 600), rng.uniform(290, 360, 600)], 1)
    X[::13, 0] = np.nan
    np.testing.assert_allclose(cf.raw_scores(X)[0], b.predict_raw(X)[0],
                               rtol=0, atol=1e-4)
    assert (cf.raw_scores(X)[0] > 200 * 0.25).any()   # the deep leaves


def test_absorbing_trees_end_at_leaf_zero():
    # a 1-leaf tree and the multiclass ragged tail (left == right == ~0)
    sf = np.zeros((2, 2, 3), np.int32)
    lc = np.full((2, 2, 3), ~0, np.int32)
    rc = np.full((2, 2, 3), ~0, np.int32)
    lv = np.zeros((2, 2, 4), np.float32)
    lv[:, :, 0] = [[1.5, 2.0], [-0.5, 0.0]]
    lv[:, :, 1:] = 99.0                       # never reached
    cf = CompiledForest.from_arrays(sf, sf, sf.astype(bool), lc, rc, lv,
                                    {0: np.array([0.0])}, {}, 1,
                                    "softmax", -1.0, device="cpu")
    raw = cf.raw_scores(np.zeros((5, 1)))
    np.testing.assert_array_equal(raw, [[3.5] * 5, [-0.5] * 5])


def test_wrappers_validate_inputs(forests):
    _, X, jf, _, tf, _ = forests["binary"]
    bins = torch.from_numpy(_bins(jf, X[:8]))
    with pytest.raises(lt.LightGBMError, match="dtype"):
        fw.forest_walk(tf._tables, bins.long())
    with pytest.raises(lt.LightGBMError, match="contiguous"):
        fw.forest_walk(tf._tables, bins.t().contiguous().t())
    with pytest.raises(lt.LightGBMError, match="2-D"):
        fw.forest_walk(tf._tables, bins[0])
    Xt = torch.zeros((tf.num_features + 1, 4), dtype=torch.float32)
    with pytest.raises(lt.LightGBMError, match="do not match"):
        fw.forest_walk_raw(tf._tables, tf._bnd, tf._cats, tf._is_cat, Xt)


def test_plain_version_counts_no_launches(forests):
    _, X, _, _, tf, _ = forests["multiclass"]
    fw.reset_launch_counts()
    tf.predict(X[:40], device_binning=True)
    tf.predict(X[:40])
    assert all(v == 0 for v in fw.launch_counts().values())


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(forests):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda", 0)
    for kind in ("binary", "multiclass", "categorical"):
        _, X, jf, jg, _, stacked = forests[kind]
        cf = CompiledForest.from_arrays(
            *stacked, jg._cuts_num, jg._cuts_cat, jg.num_features,
            jg.transform, jg.sigmoid, device=dev, buckets=BUCKETS)
        for n in SIZES:
            bins = torch.from_numpy(_bins(jf, X[:n])).to(dev)
            before = fw.launch_counts()["forest_walk"]
            got = fw.forest_walk(cf._tables, bins)
            assert fw.launch_counts()["forest_walk"] == before + 1
            ref = fw.forest_walk_plain(cf._tables, bins)
            assert torch.equal(got, ref)
            Xt = torch.from_numpy(np.ascontiguousarray(
                np.asarray(X[:n], np.float32).T)).to(dev)
            got = fw.forest_walk_raw(cf._tables, cf._bnd, cf._cats,
                                     cf._is_cat, Xt)
            ref = fw.forest_walk_raw_plain(cf._tables, cf._bnd, cf._cats,
                                           cf._is_cat, Xt)
            assert torch.equal(got, ref)
