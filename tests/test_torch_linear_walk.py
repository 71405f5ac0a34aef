"""The torch port's linear and bf16 forest walks (ops/forest_walk.py,
ops/predict.py, serve/forest.py) against the JAX package.

Linear forests are trained by the JAX package (``linear_tree=true``):
a regression forest with NaN rows, and a multiclass forest over a
categorical feature whose last two trees are dropped, so the classes
hold ragged numbers of trees; one tree of each keeps constant leaves and
short paths leave ``-1`` slots.  Both packages freeze the same trees.
On the CPU the port's wrappers run their plain versions, which sum each
leaf's affine slots in ascending order; the JAX fused walk (run in
interpret mode) sums the epilogue densely over F and the JAX gather walk
over the slots in XLA's reduce order, so raw scores are held to both at
1e-6 absolute.  bf16 leaf tables must equal the JAX fused forest's bit
for bit, and so must the ``serve_quantize_leaves`` pin's decision on
the JAX tests' two forests.  The kernel itself is held against the plain
version on the card by the ``cuda``-marked test.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
from lightgbm_tpu import obs
from lightgbm_tpu.ops.pallas_walk import (forest_walk as jax_forest_walk,
                                          forest_walk_raw as jax_walk_raw)
from lightgbm_tpu.ops.predict import (
    predict_binned_forest_linear as jax_linear_walk)
from lightgbm_tpu.serve import CompiledForest as JaxForest

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.models.gbdt import GBDT
from lightgbm_tpu_torch.ops import forest_walk as fw
from lightgbm_tpu_torch.ops.predict import predict_binned_forest_linear
from lightgbm_tpu_torch.serve.forest import CompiledForest
from lightgbm_tpu_torch.utils import log

pytestmark = pytest.mark.torch

SIZES = [1, 33, 129, 700]
BUCKETS = [32, 128, 512]
KINDS = ["regression", "multiclass_ragged"]
TOL = 1e-6


def _train(kind: str):
    """(model text, rows): a JAX-trained linear forest and query rows."""
    rng = np.random.RandomState({"regression": 1, "multiclass_ragged": 2}[kind])
    X = rng.normal(size=(800, 6))
    params = {"num_leaves": 7, "verbose": -1, "min_data_in_leaf": 20,
              "linear_tree": True, "linear_lambda": 0.01,
              "linear_max_leaf_features": 3}
    cat = "auto"
    if kind == "regression":
        y = X[:, 0] * 2.0 + np.abs(X[:, 1]) + rng.normal(scale=0.1,
                                                          size=800)
        params["objective"] = "regression"
    else:
        X[:, 2] = rng.randint(0, 6, size=800)
        y = np.digitize(X[:, 0] + 0.5 * (X[:, 2] >= 3), [-0.3, 0.6])
        params.update({"objective": "multiclass", "num_class": 3})
        cat = [2]
    # train() applies its own categorical_feature (default "auto")
    bst = lgb.train(params, lgb.Dataset(X, label=y.astype(np.float64),
                                        categorical_feature=cat),
                    num_boost_round=4, categorical_feature=cat)
    if cat != "auto":
        assert any((t.decision_type == 1).any()
                   for t in bst._booster.models)
    Xq = X.copy()
    Xq[rng.rand(*Xq.shape) < 0.05] = np.nan          # missing values
    if kind == "multiclass_ragged":
        Xq[::40, 2] = 11.0                           # unseen category
    return bst.model_to_string(), Xq


def _jax_booster(text: str):
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "model.txt")
        with open(path, "w") as fh:
            fh.write(text)
        return lgb.Booster(model_file=path)


def _forests(text: str, kind: str):
    """The same trees in both packages: a constant tree among the linear
    ones and, for multiclass, a ragged tail and categorical splits (every
    split on the category column becomes ``x == int(threshold)``; the
    affine slots that name that column read its raw value)."""
    jb = _jax_booster(text)._booster
    tb = GBDT.from_string(text)
    for b in (jb, tb):
        b.models[1].leaf_coeff = None
        b.models[1].leaf_feat = None
        if kind == "multiclass_ragged":
            b.models = b.models[:-2]
            for t in b.models:
                on_cat = t.split_feature[:t.num_leaves - 1] == 2
                t.decision_type[:t.num_leaves - 1][on_cat] = 1
                t.threshold[:t.num_leaves - 1][on_cat] = np.floor(
                    t.threshold[:t.num_leaves - 1][on_cat])
    return jb, tb


@pytest.fixture(scope="module")
def forests():
    out = {}
    for kind in KINDS:
        text, X = _train(kind)
        jb, tb = _forests(text, kind)
        jf = JaxForest.from_booster(jb, buckets=BUCKETS, serve_walk="fused")
        jg = JaxForest.from_booster(jb, buckets=BUCKETS, serve_walk="gather")
        tf = CompiledForest.from_booster(tb, device="cpu", buckets=BUCKETS)
        out[kind] = dict(text=text, X=X, jb=jb, tb=tb, jf=jf, jg=jg, tf=tf)
    return out


def _bins(jf, X):
    b = jf.bin_rows(np.asarray(X, np.float64))
    return np.where(b < 0, int(jf._nan_bin), b).astype(jf._bin_dtype)


def _xt(X):
    return np.ascontiguousarray(
        np.where(np.isnan(X), 0.0, X).T.astype(np.float32))


def test_forests_cover_the_hazards(forests):
    for kind in KINDS:
        f = forests[kind]
        tf, jf = f["tf"], f["jf"]
        assert tf.info()["linear"] and jf._has_linear
        feat = tf.walk_tables.feat
        assert bool((feat < 0).any()) and bool((feat >= 0).any())
        K, T = tf.num_class, tf.trees_per_class
        row = (1 % K) * T + 1 // K            # model 1: constant leaves
        assert not bool(tf.walk_tables.coeff[row].any())
        assert np.isnan(f["X"]).any()
    mc = forests["multiclass_ragged"]
    assert mc["tf"].trees_per_class * 3 > len(mc["tb"].models)
    assert any((t.decision_type == 1).any() for t in mc["tb"].models)
    # the categorical column splits the trees and is never a covariate
    assert not bool((mc["tf"].walk_tables.feat == 2).any())
    assert mc["tf"].info()["max_cuts"] >= 1 and 2 in mc["tf"]._cuts_cat


@pytest.mark.parametrize("kind", KINDS)
def test_linear_binned_walk_matches_jax_interpret(forests, kind):
    f = forests[kind]
    jf, tf, X = f["jf"], f["tf"], f["X"]
    for n in SIZES:
        bins, xt = _bins(jf, X[:n]), _xt(X[:n])
        ref = np.asarray(jax_forest_walk(
            *jf._walk_dev, bins, num_class=jf.num_class,
            nan_bin=int(jf._nan_bin), aff=jf._walk_aff_dev, xt=xt,
            interpret=True))
        ours = fw.forest_walk(tf.walk_tables, torch.from_numpy(bins),
                              torch.from_numpy(xt)).numpy()
        np.testing.assert_allclose(ours, ref, rtol=0, atol=TOL,
                                   err_msg=f"n={n}")


@pytest.mark.parametrize("kind", KINDS)
def test_linear_raw_walk_matches_jax_interpret(forests, kind):
    f = forests[kind]
    jf, tf, X = f["jf"], f["tf"], f["X"]
    for n in SIZES:
        Xt = np.ascontiguousarray(np.asarray(X[:n], np.float32).T)
        ref = np.asarray(jax_walk_raw(
            *jf._walk_dev, jf._bnd_dev, jf._cats_dev, jf._is_cat_col_dev,
            Xt, num_class=jf.num_class, nan_bin=int(jf._nan_bin),
            max_cuts=int(jf.max_cuts), aff=jf._walk_aff_dev,
            interpret=True))
        ours = fw.forest_walk_raw(tf.walk_tables, *tf.cut_tables(),
                                  torch.from_numpy(Xt)).numpy()
        np.testing.assert_allclose(ours, ref, rtol=0, atol=TOL,
                                   err_msg=f"n={n}")


@pytest.mark.parametrize("kind", KINDS)
def test_linear_walk_matches_jax_gather_walk(forests, kind):
    f = forests[kind]
    jf, jg, X = f["jf"], f["jg"], f["X"]
    bins_j = jg.bin_rows(np.asarray(X, np.float64))
    bins = torch.from_numpy(_bins(jf, X).astype(np.int64))
    xt = _xt(X)
    lcf, lft = (np.asarray(a) for a in jg._lin_dev)
    for k in range(jg.num_class):
        arrs = [np.asarray(a)[k] for a in jg._tree_dev]
        ref = np.asarray(jax_linear_walk(*arrs, lcf[k], lft[k], bins_j, xt,
                                         max_steps=jg.num_leaves))
        ours, _ = predict_binned_forest_linear(
            *(torch.from_numpy(a) for a in arrs), torch.from_numpy(lcf[k]),
            torch.from_numpy(lft[k]), bins, torch.from_numpy(xt),
            jg.num_leaves)
        np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_linear_forest_matches_jax_compiled_forest(forests, kind):
    f = forests[kind]
    jg, tf, X = f["jg"], f["tf"], f["X"]
    for n in SIZES:
        np.testing.assert_allclose(tf.raw_scores(X[:n]),
                                   jg.raw_scores(X[:n]), rtol=0, atol=TOL)
        tr, to = tf._device_scores(X[:n])
        gr, go = jg._device_scores(X[:n])
        np.testing.assert_allclose(tr, gr, rtol=0, atol=TOL)
        np.testing.assert_allclose(to, go, rtol=0, atol=TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_from_booster_on_jax_linear_model_text(forests, kind):
    f = forests[kind]
    X = f["X"][:300]
    ours = lt.Booster(model_str=f["text"], device="cpu",
                      params={"predict_buckets": BUCKETS})
    theirs = _jax_booster(f["text"])
    for raw in (True, False):
        np.testing.assert_allclose(ours.predict(X, raw_score=raw),
                                   theirs.predict(X, raw_score=raw),
                                   rtol=0, atol=TOL)
    jf = JaxForest.from_booster(theirs, buckets=BUCKETS)
    tf = ours.compile()
    assert tf.info()["linear_k"] == jf.linear_k == 3
    np.testing.assert_allclose(tf.predict(X, device_binning=True),
                               jf.predict(X, device_binning=True),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_from_arrays_takes_jax_linear_stacks(forests, kind):
    f = forests[kind]
    jg, tf = f["jg"], f["tf"]
    cf = CompiledForest.from_arrays(
        *(np.asarray(a) for a in jg._tree_dev), jg._cuts_num, jg._cuts_cat,
        jg.num_features, jg.transform, jg.sigmoid, device="cpu",
        buckets=BUCKETS, lin=tuple(np.asarray(a) for a in jg._lin_dev))
    for a, b in zip(cf.walk_tables, tf.walk_tables):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            assert a == b
    np.testing.assert_array_equal(cf.raw_scores(f["X"]),
                                  tf.raw_scores(f["X"]))


def _tiny_and_huge():
    """The JAX tests' two quantization forests (tests/test_pallas_walk.py
    :138 and :160): leaves ~1e-5, bf16 error within the pin, and leaves
    ~1e4, far past it."""
    out = {}
    for name, seed, scale in (("tiny", 2, 1e-4), ("huge", 4, 50000.0)):
        rng = np.random.RandomState(seed)
        X = rng.normal(size=(800, 6))
        y = (X[:, 0] + 0.2 * X[:, 1]) * scale
        bst = lgb.train({"objective": "regression", "num_leaves": 7,
                         "verbose": -1, "min_data_in_leaf": 20},
                        lgb.Dataset(X, label=y), num_boost_round=4)
        out[name] = (bst, X)
    return out


@pytest.fixture(scope="module")
def quantized():
    return _tiny_and_huge()


@pytest.mark.parametrize("name,want", [("tiny", "bfloat16"),
                                       ("huge", "float32")])
def test_quantize_pin_decides_like_jax(quantized, name, want):
    bst, X = quantized[name]
    before_j = obs.snapshot()["counters"].get("forest_quantize_fallback", 0)
    jf = JaxForest.from_booster(bst, buckets=BUCKETS, serve_walk="fused",
                                quantize_leaves=True)
    fell_j = obs.snapshot()["counters"].get("forest_quantize_fallback",
                                            0) - before_j
    before = log.counter("forest_quantize_fallback")
    ours = lt.Booster(model_str=bst.model_to_string(), device="cpu")
    tf = CompiledForest.from_booster(ours, buckets=BUCKETS,
                                     quantize_leaves=True)
    assert tf.leaf_dtype == jf.leaf_dtype == want
    assert tf.info()["leaf_dtype"] == want
    assert log.counter("forest_quantize_fallback") - before == fell_j \
        == (1 if want == "float32" else 0)
    # the kernel table is bf16 only when the pin held; the scores follow
    # the JAX fused walk over the same table
    assert tf.walk_tables.leaves.dtype == getattr(torch, want)
    np.testing.assert_allclose(tf.raw_scores(X[:300]),
                               jf.raw_scores(X[:300]), rtol=1e-6, atol=TOL)
    if want == "bfloat16":
        np.testing.assert_allclose(
            tf.raw_scores(X[:300]), bst._booster.predict_raw(X[:300]),
            rtol=0, atol=CompiledForest.QUANTIZE_LEAF_ATOL)


def test_bf16_table_bit_equal_to_jax(quantized):
    bst, X = quantized["tiny"]
    jf = JaxForest.from_booster(bst, buckets=BUCKETS, serve_walk="fused",
                                quantize_leaves=True)
    tf = CompiledForest.from_booster(
        lt.Booster(model_str=bst.model_to_string(), device="cpu"),
        buckets=BUCKETS, quantize_leaves=True)
    theirs = np.asarray(jf._walk_dev[4]).view(np.uint16)
    ours = tf.walk_tables.leaves.view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(ours, theirs.reshape(ours.shape))
    # and the JAX fused walk over that table, interpret mode
    for n in (1, 129):
        bins = _bins(jf, X[:n])
        ref = np.asarray(jax_forest_walk(
            *jf._walk_dev, bins, num_class=1, nan_bin=int(jf._nan_bin),
            interpret=True))
        got = fw.forest_walk(tf.walk_tables, torch.from_numpy(bins))
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=TOL)
    # bf16 -> f32 is exact: the plain walk over the widened table
    f32 = fw.WalkTables(*tf.walk_tables)._replace(
        leaves=tf.walk_tables.leaves.float())
    bins = torch.from_numpy(_bins(jf, X))
    assert torch.equal(fw.forest_walk(tf.walk_tables, bins),
                       fw.forest_walk(f32, bins))


def test_bf16_linear_forest_from_arrays(forests):
    f = forests["regression"]
    jg, tf = f["jg"], f["tf"]
    cf = CompiledForest.from_arrays(
        *(np.asarray(a) for a in jg._tree_dev), jg._cuts_num, jg._cuts_cat,
        jg.num_features, jg.transform, jg.sigmoid, device="cpu",
        buckets=BUCKETS, lin=tuple(np.asarray(a) for a in jg._lin_dev),
        leaf_dtype="bfloat16")
    info = cf.info()
    assert info["leaf_dtype"] == "bfloat16" and info["linear"]
    want = torch.from_numpy(np.asarray(jg._tree_dev[5], np.float32)
                            .reshape(cf.walk_tables.leaves.shape))
    assert torch.equal(cf.walk_tables.leaves, want.to(torch.bfloat16))
    assert cf.walk_tables.variant(raw=True) == "forest_walk_raw_linear_bf16"
    with pytest.raises(lt.LightGBMError, match="leaf_dtype"):
        CompiledForest.from_arrays(
            *(np.asarray(a) for a in jg._tree_dev), jg._cuts_num,
            jg._cuts_cat, jg.num_features, jg.transform, jg.sigmoid,
            device="cpu", leaf_dtype="float16")


def test_block_size_steps_down_then_refuses(forests):
    # the walk's plan takes the widest tile at which one tree's tables fit
    # (sms = 1: no narrower tile to fill more SMs)
    def tile(tables, F, B=4096):
        return fw.plan_walk(
            B, tables.num_class, tables.trees_per_class,
            tables.nodes.shape[1], tables.num_leaves, F, tables.linear_k,
            tables.leaves.element_size(), tables.linear, False, 1).tile

    assert tile(forests["regression"]["tf"].walk_tables, 28) == 512
    # a 255-leaf linear forest takes 6 bytes a feature a row: up to 70
    # features at 512 rows, 141 at 256, 282 at 128, 565 at 64, 1131 at
    # 32; at 2000 features the covariate tile alone is 1 MB at 128 rows
    L, Kf = 255, 5
    wide = fw.WalkTables(
        torch.zeros((1, L - 1, 4), dtype=torch.int32),
        torch.zeros((1, L)), 1, 1, 256, torch.zeros((1, L, Kf)),
        torch.zeros((1, L, Kf), dtype=torch.int32), 0)
    assert fw.walk_smem(1, L - 1, L, 4, Kf, True, 2000, 128) > 1 << 20
    with pytest.raises(lt.LightGBMError, match="more shared memory"):
        tile(wide, 2000)
    assert tile(wide, 70) == 512
    assert tile(wide, 71) == tile(wide, 141) == 256
    assert tile(wide, 282) == 128
    assert tile(wide, 400) == 64
    assert tile(wide, 600) == 32
    assert tile(wide, 600, B=20) == 20          # never wider than B
    # constant f32 tables need no covariate tile: 2000 features fit at 32
    const = wide._replace(coeff=None, feat=None, max_feat=-1)
    assert tile(const, 2000) == 32
    assert fw.walk_smem(1, L - 1, L, 2, 0, False, 28, 256) \
        < fw.walk_smem(1, L - 1, L, 4, 0, False, 28, 256)


def test_linear_wrappers_validate_inputs(forests):
    f = forests["regression"]
    jf, tf, X = f["jf"], f["tf"], f["X"]
    t = tf.walk_tables
    bins = torch.from_numpy(_bins(jf, X[:8]))
    xt = torch.from_numpy(_xt(X[:8]))
    with pytest.raises(lt.LightGBMError, match="needs the covariates"):
        fw.forest_walk(t, bins)
    with pytest.raises(lt.LightGBMError, match="does not match"):
        fw.forest_walk(t, bins, xt[:, :4].contiguous())
    with pytest.raises(lt.LightGBMError, match="dtype"):
        fw.forest_walk(t, bins, xt.double())


def test_affine_feature_past_the_splits_widens_rows():
    from lightgbm_tpu_torch.models.tree import Tree
    t = Tree(2)
    t.split_feature[:] = [0]
    t.threshold[:] = [0.0]
    t.left_child[:] = [~0]
    t.right_child[:] = [~1]
    t.leaf_value[:] = [1.0, -1.0]
    t.leaf_feat = np.array([[4, -1], [0, 4]], np.int32)
    t.leaf_coeff = np.array([[0.5, 0.0], [2.0, -1.0]])
    b = GBDT()
    b.max_feature_idx = 0
    b.models = [t]
    cf = CompiledForest.from_booster(b, device="cpu")
    assert cf.num_features == 5 and cf.info()["linear_k"] == 2
    # NaN routes right (as the f64 walk's ``NaN <= t`` is false) and
    # reads as 0.0 in the affine part
    X = np.array([[-1.0, 0, 0, 0, 2.0], [3.0, 0, 0, 0, np.nan],
                  [np.nan, 0, 0, 0, 1.0]])
    want = [1.0 + 0.5 * 2.0, -1.0 + 2.0 * 3.0, -1.0 - 1.0 * 1.0]
    np.testing.assert_allclose(cf.raw_scores(X)[0], want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(cf.predict(X, raw_score=True,
                                          device_binning=True), want,
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(b.predict_raw(X)[0], want, rtol=0, atol=1e-12)
    with pytest.raises(lt.LightGBMError, match="needs 5"):
        cf.raw_scores(X[:, :4])
    rows = cf.device_rows(X)[:4].contiguous()
    with pytest.raises(lt.LightGBMError, match="reads feature 4"):
        fw.forest_walk_raw(cf.walk_tables, *(a[:4].contiguous()
                                             for a in cf.cut_tables()), rows)


def test_variant_launch_counters(forests):
    assert set(fw.VARIANTS) == set(fw.launch_counts())
    assert len(fw.VARIANTS) == 8
    t = forests["multiclass_ragged"]["tf"].walk_tables
    assert t.variant(raw=False) == "forest_walk_linear"
    fw.reset_launch_counts()
    forests["multiclass_ragged"]["tf"].predict(forests["multiclass_ragged"]
                                               ["X"][:50])
    assert all(v == 0 for v in fw.launch_counts().values())


@pytest.mark.cuda
def test_linear_and_bf16_kernels_match_plain_on_card(forests, quantized):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda", 0)
    cases = [(forests[k]["text"], forests[k]["X"], False) for k in KINDS]
    bst, X = quantized["tiny"]
    cases.append((bst.model_to_string(), X, True))
    for text, X, q in cases:
        cf = CompiledForest.from_booster(
            lt.Booster(model_str=text, device=dev), quantize_leaves=q)
        t = cf.walk_tables
        for n in SIZES:
            bins = cf.device_bins(X[:n])
            xt = cf.device_covariates(X[:n]) if t.linear else None
            assert torch.equal(fw.forest_walk(t, bins, xt),
                               fw.forest_walk_plain(t, bins, xt))
            rows = cf.device_rows(X[:n])
            assert torch.equal(
                fw.forest_walk_raw(t, *cf.cut_tables(), rows),
                fw.forest_walk_raw_plain(t, *cf.cut_tables(), rows))
