"""Wide-sparse data in the torch port against the JAX package: exclusive
feature bundling (EFB) and gain-informed feature screening.

The same seeded one-hot-block matrix (the shape of the JAX package's
``tests/test_bundling.py`` ``one_hot_data``: blocks of features of
which at most one is non-zero on a row, small integer levels) goes to
both packages:

* the bundle plan (members, offsets, conflicts), the encoded columns,
  the decode tables and the expansions equal the JAX package's arrays
  exactly (the f32 histogram expansion to 1e-6 of each column's sum of
  magnitudes: XLA and torch sum the 63 bins of a column in their own
  order);
* every grower and sampler trains the JAX package's trees over the
  bundled columns (structure exact, values within 1e-5), and the cached
  growers' zero-conflict bundled runs equal the port's unbundled runs
  bit for bit;
* screening (``feature_screen_ratio``) trains the JAX package's trees,
  on data whose gains are well apart (a near-tie of f32 gains would flip
  the active set);
* valid sets and subsets ride the training plan.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import lightgbm_tpu as lgb
from lightgbm_tpu.io.bundling import plan_bundles as jax_plan_bundles
from lightgbm_tpu.io.dataset import BinnedDataset as JaxBinned
from lightgbm_tpu.ops import bundle as jbundle

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.io.bundling import plan_bundles
from lightgbm_tpu_torch.io.dataset import BinnedDataset
from lightgbm_tpu_torch.ops import bundle as tbundle
from lightgbm_tpu_torch.ops import leafhist

pytestmark = [pytest.mark.torch, pytest.mark.sparse]

CPU = torch.device("cpu")
BASE = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 20,
        "min_sum_hessian_in_leaf": 1e-3, "max_bin": 63, "verbose": -1,
        "metric": "auc"}
ROUNDS = 4
#: leaf values against the JAX package's, of the tree's largest: f32
#: sums in another order (the torch port's leaf values)
LEAF_RTOL = 1e-5
#: the same over 10 rounds at learning rate 0.2, where a leaf whose right
#: side holds few rows is a small difference of two sums (tests/
#: test_torch_train.py holds values to 1e-4 too)
LONG_RUN_RTOL = 1e-4
#: the linear fit over one-hot path features, which are 0 on most of a
#: leaf's rows: f32 normal equations summed in another order and an
#: ill-conditioned solve (the card's linear tolerance)
LINEAR_RTOL = 1e-3


def one_hot_data(n=2500, blocks=8, block_size=6, seed=0, act=0.7,
                 levels=5):
    """One-hot-ish blocks: at most one active feature per block per row,
    small integer levels (the JAX package's test data)."""
    rng = np.random.RandomState(seed)
    F = blocks * block_size
    X = np.zeros((n, F))
    for b in range(blocks):
        choice = rng.randint(0, block_size, n)
        vals = rng.randint(1, levels, n).astype(float)
        on = rng.rand(n) < act
        X[np.arange(n)[on], (b * block_size + choice)[on]] = vals[on]
    logit = (X[:, 0] - 0.5 * X[:, block_size + 1]
             + 0.3 * X[:, 2 * block_size + 1]
             + rng.normal(0, 0.5, n))
    y = (logit > np.median(logit)).astype(np.float64)
    return X, y


def conflicting_data(n=2000, seed=5):
    """Sparse features that collide on some rows: two blocks whose
    members overlap on ~5% of rows, so a conflict budget changes the
    plan."""
    X, y = one_hot_data(n, blocks=4, block_size=5, seed=seed)
    rng = np.random.RandomState(seed + 1)
    hit = rng.rand(n) < 0.05
    X[hit, 1] = rng.randint(1, 5, hit.sum())
    return X, y


@pytest.fixture(scope="module")
def data():
    return one_hot_data()


def _assert_same_trees(jm, tm, label, rtol=LEAF_RTOL):
    assert len(jm) == len(tm), label
    for i, (a, b) in enumerate(zip(jm, tm)):
        n = a.num_leaves - 1
        assert a.num_leaves == b.num_leaves, (label, i)
        for field in ("split_feature", "left_child", "right_child",
                      "decision_type", "threshold"):
            np.testing.assert_array_equal(getattr(b, field),
                                          getattr(a, field)[:n],
                                          err_msg=f"{label} tree {i}")
        scale = max(np.abs(a.leaf_value).max(), 1e-12)
        np.testing.assert_allclose(b.leaf_value, a.leaf_value[:n + 1],
                                   rtol=0, atol=rtol * scale,
                                   err_msg=f"{label} tree {i}")


# ---------------------------------------------------------------------------
# planning and encoding


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_plan_and_columns_equal_jax(rate):
    X, y = conflicting_data()
    kw = dict(max_bin=63, min_data_in_leaf=20, enable_bundle=True,
              max_conflict_rate=rate)
    j = JaxBinned.from_matrix(X, y, **kw)
    t = BinnedDataset.from_matrix(X, y, **kw)
    assert t.bundle_plan is not None
    jp, tp = j.bundle_plan, t.bundle_plan
    assert tp.column_members == jp.column_members
    assert tp.column_offsets == jp.column_offsets
    assert tp.sample_conflicts == jp.sample_conflicts
    assert tp.signature() == jp.signature()
    assert t.num_columns == j.num_columns < t.num_features
    assert t.bins.dtype == j.bins.dtype
    np.testing.assert_array_equal(t.bins, j.bins)
    if rate > 0:
        assert tp.sample_conflicts > 0
    # the planner alone, on the same sample and mappers
    again = plan_bundles(X, t.mappers, t.used_feature_map,
                         max_conflict_rate=rate, max_total_bin=63)
    want = jax_plan_bundles(X, j.mappers, j.used_feature_map,
                            max_conflict_rate=rate, max_total_bin=63)
    assert again.signature() == want.signature()


def test_no_bundles_on_dense_or_when_disabled(data):
    rng = np.random.RandomState(3)
    Xd = rng.normal(size=(1500, 10))
    yd = (Xd[:, 0] > 0).astype(float)
    kw = dict(max_bin=63, min_data_in_leaf=20, enable_bundle=True)
    assert BinnedDataset.from_matrix(Xd, yd, **kw).bundle_plan is None
    X, y = data
    for off in ({"enable_bundle": False}, {"is_enable_sparse": False}):
        t = BinnedDataset.from_matrix(X, y, **{**kw, **off})
        assert t.bundle_plan is None
        assert t.num_columns == t.num_features


def test_decode_tables_and_expansions_equal_jax(data):
    X, y = data
    t = BinnedDataset.from_matrix(X, y, max_bin=63, min_data_in_leaf=20,
                                  enable_bundle=True)
    plan, B = t.bundle_plan, 63
    nb = [m.num_bin for m in t.mappers]
    db = [m.default_bin for m in t.mappers]
    j = JaxBinned.from_matrix(X, y, max_bin=63, min_data_in_leaf=20,
                              enable_bundle=True)
    want = j.bundle_plan.decode_arrays(nb, db, B)
    got = plan.decode_arrays(nb, db, B)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    tdec = tbundle.BundleDecode.from_plan(plan, t.mappers, B, CPU)
    jdec = jbundle.BundleDecode(**{k: jnp.asarray(v)
                                   for k, v in want.items()})
    rng = np.random.RandomState(1)
    C = plan.num_columns
    # int32 digit sums of two children: an exact expansion
    sums = rng.randint(-5000, 5000, size=(2, C, 9, B)).astype(np.int32)
    got = tbundle.expand_digit_sums(torch.from_numpy(sums), tdec)
    exp = np.asarray(jbundle.expand_digit_sums(jnp.asarray(sums), jdec))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), exp)
    # the f32 histograms: the default bin is one subtraction of sums
    hist = rng.normal(size=(2, C, B, 3)).astype(np.float32)
    got = tbundle.expand_histogram(torch.from_numpy(hist), tdec).numpy()
    exp = np.asarray(jbundle.expand_histogram(jnp.asarray(hist), jdec))
    scale = np.abs(hist).sum(axis=-2).max()
    np.testing.assert_allclose(got, exp, rtol=0, atol=1e-6 * scale)
    # the partition's and the walk's decode of a column
    bins = torch.from_numpy(t.bins)
    for f in range(t.num_features):
        d = tbundle.decode_feature_bins(bins, torch.tensor(f), tdec)
        np.testing.assert_array_equal(
            d.numpy(), t.mappers[f].value_to_bin(X[:, t.used_feature_map[f]]))
    feat = rng.randint(-1, t.num_features, size=t.num_data)
    d = tbundle.decode_feature_bins(bins, torch.from_numpy(feat), tdec)
    e = jbundle.decode_feature_bins(jnp.asarray(t.bins), jnp.asarray(feat),
                                    jdec)
    np.testing.assert_array_equal(d.numpy(), np.asarray(e))


def test_uint16_columns_decode(data):
    """Columns wider than a byte (a feature of more than 256 bins beside
    the bundles) decode through the int16 view."""
    X, y = data
    rng = np.random.RandomState(2)
    Xw = np.column_stack([X, rng.normal(size=X.shape[0])])
    kw = dict(max_bin=300, min_data_in_leaf=2, min_data_in_bin=1,
              enable_bundle=True)
    t = BinnedDataset.from_matrix(Xw, y, **kw)
    j = JaxBinned.from_matrix(Xw, y, **kw)
    assert t.bins.dtype == j.bins.dtype == np.uint16
    np.testing.assert_array_equal(t.bins, j.bins)
    dec = tbundle.BundleDecode.from_plan(t.bundle_plan, t.mappers, 300, CPU)
    bins = torch.from_numpy(t.bins)
    last = t.num_features - 1
    d = tbundle.decode_feature_bins(bins, torch.tensor(last), dec)
    np.testing.assert_array_equal(
        d.numpy(), t.mappers[last].value_to_bin(Xw[:, -1]))


# ---------------------------------------------------------------------------
# trees over the bundled columns


GROWERS = {
    "cached": {"serial_grow": "cached"},
    "ordered": {},                          # falls back to cached
    "nocache": {"serial_grow": "cached", "histogram_pool_size": 0.001,
                "memory_policy": "degrade"},
    "fused": {"serial_grow": "fused"},
    "bagging": {"serial_grow": "cached", "bagging_fraction": 0.8,
                "bagging_freq": 2},
    "goss": {"serial_grow": "cached", "boosting_type": "goss",
             "learning_rate": 0.5, "top_rate": 0.2, "other_rate": 0.2},
    "dart": {"serial_grow": "cached", "boosting_type": "dart",
             "drop_rate": 0.5},
    "linear": {"serial_grow": "cached", "linear_tree": True,
               "linear_max_leaf_features": 3, "linear_lambda": 0.01},
}
#: the growers whose histograms are exact integers: bundled equals
#: unbundled bit for bit (the linear fit too: it reads the raw values)
EXACT_GROWERS = ("cached", "ordered", "bagging", "goss", "dart", "linear")


@pytest.mark.parametrize("kind", list(GROWERS))
def test_bundled_trees_equal_jax(kind, data):
    X, y = data
    params = {**BASE, **GROWERS[kind]}
    bj = lgb.train(params, lgb.Dataset(X, y, params=params), ROUNDS,
                   verbose_eval=False)
    bt = lt.train(params, lt.Dataset(X, y, params=params), ROUNDS,
                  device="cpu", verbose_eval=False)
    gb = bt._booster
    assert gb.train_set.bundle_plan is not None
    assert gb.grow_kind == {"fused": "fused", "nocache": "nocache"}.get(
        kind, "cached")
    linear = kind == "linear"
    _assert_same_trees(bj._booster.models, gb.models, kind,
                       LINEAR_RTOL if linear else LEAF_RTOL)
    if linear:
        for a, b in zip(bj._booster.models, gb.models):
            np.testing.assert_array_equal(b.leaf_feat,
                                          a.leaf_feat[:b.num_leaves])
            top = max(np.abs(a.leaf_coeff).max(), 1e-12)
            np.testing.assert_allclose(b.leaf_coeff,
                                       a.leaf_coeff[:b.num_leaves],
                                       rtol=0, atol=LINEAR_RTOL * top)
    pj = bj.predict(X[:300], raw_score=True)
    pt = bt.predict(X[:300], raw_score=True)
    np.testing.assert_allclose(pt, pj, rtol=0,
                               atol=LINEAR_RTOL if linear else 1e-5)
    if kind in EXACT_GROWERS:
        off = {**params, "enable_bundle": False}
        bu = lt.train(off, lt.Dataset(X, y, params=off), ROUNDS,
                      device="cpu", verbose_eval=False)
        assert bu._booster.train_set.bundle_plan is None
        assert bt.model_to_string() == bu.model_to_string()
        assert torch.equal(gb.train_data.score,
                           bu._booster.train_data.score)


def test_ordered_falls_back_with_one_warning(data, capsys, monkeypatch):
    from lightgbm_tpu_torch.utils import log
    X, y = data
    monkeypatch.setattr(log, "_current_level", 1)
    log._warned_once.discard("serial_grow_decode")
    params = {**BASE, "verbose": 1}
    bt = lt.train(params, lt.Dataset(X, y, params=params), 1, device="cpu",
                  verbose_eval=False)
    assert bt._booster.grow_kind == "cached"
    err = capsys.readouterr().err
    assert err.count("serial_grow=ordered: using the cached serial") == 1
    assert "EFB: 48 sparse feature(s), 48 bundled into 8 bundle(s)" in err


def test_bundled_cached_equals_unbundled_in_the_grower(data):
    """K1's digit sums cached in column space and expanded for the scan:
    the same trees, leaves and deltas as per-feature columns, bit for
    bit (the card holds this at full width)."""
    from lightgbm_tpu_torch.ops.grow import GrowParams, SerialComm, grow_tree
    X, y = data
    t = BinnedDataset.from_matrix(X, y, max_bin=63, min_data_in_leaf=20,
                                  enable_bundle=True)
    u = BinnedDataset.from_matrix(X, y, max_bin=63, min_data_in_leaf=20)
    rng = np.random.RandomState(4)
    g = torch.from_numpy(rng.normal(size=t.num_data).astype(np.float32))
    h = torch.from_numpy(rng.uniform(0.1, 0.3, t.num_data).astype(np.float32))
    w = torch.ones(t.num_data)
    nb = torch.from_numpy(t.num_bin_per_feature())
    cat = torch.zeros(t.num_features, dtype=torch.bool)
    fm = torch.ones(t.num_features, dtype=torch.bool)
    params = GrowParams(num_leaves=15, max_bin=63, min_data_in_leaf=20,
                        min_sum_hessian_in_leaf=1e-3)
    dec = tbundle.BundleDecode.from_plan(t.bundle_plan, t.mappers, 63, CPU)
    leafhist.reset_launch_counts()
    a = grow_tree(torch.from_numpy(t.bins), nb, cat, fm, g, h, w, 0.1,
                  params, SerialComm(), bundle=dec)
    b = grow_tree(torch.from_numpy(u.bins), nb, cat, fm, g, h, w, 0.1,
                  params, SerialComm())
    for x, z in zip(a[0], b[0]):
        assert torch.equal(x, z)
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
    assert leafhist.launch_counts()["digit_histogram"] == 0   # the CPU


# ---------------------------------------------------------------------------
# screening


def screening_data(n=3000, seed=7):
    """Gains well apart: a few strong features over many weak ones, in
    one-hot blocks (bundled) and dense ones."""
    X, _ = one_hot_data(n, blocks=6, block_size=5, seed=seed)
    rng = np.random.RandomState(seed)
    dense = rng.normal(size=(n, 6))
    logit = (2.0 * X[:, 0] - 1.5 * X[:, 6] + 1.2 * dense[:, 0]
             - 0.8 * dense[:, 1] + rng.normal(0, 1.0, n))
    y = (logit > np.median(logit)).astype(np.float64)
    return np.column_stack([X, dense]), y


@pytest.mark.parametrize("bundle", [True, False])
def test_screening_trains_jax_trees(bundle):
    X, y = screening_data()
    params = {**BASE, "enable_bundle": bundle, "feature_screen_ratio": 0.3,
              "feature_screen_warmup": 3, "feature_screen_refresh": 3,
              "learning_rate": 0.2}
    rounds = 10
    bj = lgb.train(params, lgb.Dataset(X, y, params=params), rounds,
                   verbose_eval=False)
    bt = lt.train(params, lt.Dataset(X, y, params=params), rounds,
                  device="cpu", verbose_eval=False)
    gb = bt._booster
    assert (gb.train_set.bundle_plan is not None) == bundle
    _assert_same_trees(bj._booster.models, gb.models, f"bundle={bundle}",
                       LONG_RUN_RTOL)
    # warmup 3, refresh 3: rounds 4, 5, 7, 8 are screened, 3 and 6 refresh
    assert [it for it, _ in gb.screen_periods] == [4, 7]
    np.testing.assert_allclose(gb._screener.ewma, bj._booster._screener.ewma,
                               rtol=1e-4, atol=1e-6)
    # the compacted view is the active columns, and nothing else
    cols = gb.screen_periods[-1][1]
    assert gb._active_view.bins.shape == (len(cols), gb.num_data)
    assert len(cols) == gb._screener.keep_cols < gb.num_columns


def test_screened_kernel_view_and_masks():
    """A screened round grows over the compacted view under the screen
    mask: the split features of screened rounds lie in the active
    columns."""
    X, y = screening_data()
    params = {**BASE, "feature_screen_ratio": 0.5, "feature_screen_warmup": 2,
              "feature_screen_refresh": 4}
    bt = lt.train(params, lt.Dataset(X, y, params=params), 6, device="cpu",
                  verbose_eval=False)
    gb = bt._booster
    (it, cols), = gb.screen_periods
    assert it == 3
    col_of = gb._feature_col
    for tree in gb.models[3:6]:
        n = tree.num_leaves - 1
        assert set(col_of[tree.split_feature_inner[:n]]) <= set(cols)


def test_reset_parameter_rebuilds_the_screener_only_on_a_change():
    X, y = screening_data(1500)
    params = {**BASE, "feature_screen_ratio": 0.3,
              "feature_screen_warmup": 1}
    bt = lt.Booster(params=params, train_set=lt.Dataset(X, y, params=params),
                    device="cpu")
    bt.update()
    bt.update()
    scr = bt._booster._screener
    bt.reset_parameter({"learning_rate": 0.05})
    assert bt._booster._screener is scr
    assert scr.ewma.any()                     # the pending round folded in
    bt.reset_parameter({"feature_screen_ratio": 0.5})
    assert bt._booster._screener is not scr
    assert not bt._booster._screener.ewma.any()
    bt.reset_parameter({"feature_screen_ratio": 0.0})
    assert bt._booster._screener is None
    assert bt._booster.grow_kind == "cached"  # the dataset is bundled


# ---------------------------------------------------------------------------
# valid sets and subsets ride the plan


def test_valid_sets_and_subsets_ride_the_plan(data):
    X, y = data
    Xv, yv = one_hot_data(700, seed=3)
    params = {**BASE, "serial_grow": "cached"}
    dt = lt.Dataset(X, y, params=params)
    dv = dt.create_valid(Xv, yv)
    dj = lgb.Dataset(X, y, params=params)
    jv = dj.create_valid(Xv, yv)
    bt = lt.train(params, dt, ROUNDS, valid_sets=[dv], device="cpu",
                  verbose_eval=False)
    bj = lgb.train(params, dj, ROUNDS, valid_sets=[jv], verbose_eval=False)
    tv, jvb = dv._binned, jv._binned
    assert tv.bundle_plan is dt._binned.bundle_plan
    np.testing.assert_array_equal(tv.bins, jvb.bins)
    # the valid replay decodes the columns: the score equals the model's
    np.testing.assert_allclose(
        bt._booster.valid_data[0].host_score()[0],
        bt.predict(Xv, raw_score=True), rtol=0, atol=1e-5)
    np.testing.assert_allclose(bt.eval_valid()[0][2], bj.eval_valid()[0][2],
                               rtol=0, atol=1e-6)
    idx = np.arange(0, X.shape[0], 3)
    sub = dt.subset(idx).construct()._binned
    want = dj.subset(idx).construct()._binned
    assert sub.bundle_plan is dt._binned.bundle_plan
    np.testing.assert_array_equal(sub.bins, want.bins)
    # a valid set on other bundles is refused
    other = lt.Dataset(Xv, yv, params={**params, "enable_bundle": False})
    with pytest.raises(lt.LightGBMError, match="different bin mappers"):
        bt.add_valid(other, "other")


def test_bundled_train_without_a_card_raises(data, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = data
    with pytest.raises(lt.LightGBMError, match="no CUDA device"):
        lt.train(BASE, lt.Dataset(X, y, params=BASE), 1)


def test_continued_training_and_rollback_replay_the_columns(data,
                                                            tmp_path):
    """Loaded trees replay over the bundled columns (the init model's
    scores of a valid set), and a rollback subtracts a tree through the
    same decode, as in the JAX package."""
    X, y = data
    Xv, yv = one_hot_data(600, seed=8)
    params = {**BASE, "serial_grow": "cached"}
    path = str(tmp_path / "base.txt")
    lt.train(params, lt.Dataset(X, y, params=params), 2, device="cpu",
             verbose_eval=False).save_model(path)
    runs = {}
    for pkg, kw in ((lgb, {}), (lt, {"device": "cpu"})):
        ds = pkg.Dataset(X, y, params=params)
        dv = ds.create_valid(Xv, yv)
        runs[pkg] = pkg.train(params, ds, 2, valid_sets=[dv],
                              init_model=path, verbose_eval=False, **kw)
    bj, bt = runs[lgb], runs[lt]
    assert bt._booster.train_set.bundle_plan is not None
    _assert_same_trees(bj._booster.models, bt._booster.models, "continued")
    want = bt.predict(Xv, raw_score=True)
    np.testing.assert_allclose(bt._booster.valid_data[0].host_score()[0],
                               want, rtol=0, atol=1e-5)
    before = bt._booster.train_data.host_score().copy()
    last = bt._booster.models[-1]
    bt.rollback_one_iter()
    np.testing.assert_allclose(
        bt._booster.train_data.host_score()[0],
        before[0] - last.predict(X), rtol=0, atol=1e-5)


def test_memory_budget_counts_columns(data):
    """The per-leaf histogram cache is [L, C, 9, B]: a pool that holds the
    bundled cache keeps the cached grower, and the unbundled one takes
    the ``hist_cache`` degrade step, in both packages."""
    X, y = data
    # cache: 15 leaves x 9 x 63 bins x 4 B = 34 KB a column; 8 bundled
    # columns take 0.27 MB, 48 features 1.6 MB
    params = {**BASE, "serial_grow": "cached", "histogram_pool_size": 1.0,
              "memory_policy": "degrade"}
    for bundle, kind in ((True, "cached"), (False, "nocache")):
        p = {**params, "enable_bundle": bundle}
        bt = lt.Booster(params=p, train_set=lt.Dataset(X, y, params=p),
                        device="cpu")
        bj = lgb.Booster(params=p, train_set=lgb.Dataset(X, y, params=p))
        assert bt._booster.grow_kind == kind
        assert bj._booster._degrade_leaf_cache_off == (kind == "nocache")
