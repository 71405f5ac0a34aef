"""Row and feature sampling, GOSS and DART in the port
(lightgbm_tpu_torch: ``utils/random.py``, ``models/gbdt.py``'s draws,
``models/goss.py``, ``models/dart.py``), the ordered grower's row
compaction, ``nan_policy`` and the key audit of ``config.py``, against
the JAX package on the CPU.

The same seeded numpy inputs go to both packages.  Every draw is exact:
threefry ``split``/``bits``/``uniform`` against ``jax.random``, the bag
mask against the JAX ``_device_bag_mask`` (its padded draw count too),
the GOSS mask and amplified gradients against the JAX ``GOSS._sample``
on identical gradients with many ties, DART's drops, shrinkage and
tree weights against the JAX ``DART`` — all ``torch.equal`` or ``==``.
Training end to end (bagging with ``feature_fraction`` under each
grower, GOSS, DART, multiclass with ``feature_fraction``) compares the
model texts as ``tests/test_torch_engine.py`` does: structure-equal,
thresholds 1e-9 relative, leaf values within 1e-5 of the tree's
largest, a split whose two best gains lie within 1e-5 of each other
reported as a near-tie and nothing after it compared.  The bagging and
GOSS runs use the regression objective, whose L2 gradients are exact in
f32, so the GOSS ranks see the same numbers in both packages.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

import chip_smoke as cs
import jax
import jax.numpy as jnp
import lightgbm_tpu as lgb
from lightgbm_tpu.config import PARAM_ALIASES as JAX_ALIASES
from lightgbm_tpu.config import _DEFAULTS as JAX_DEFAULTS
from lightgbm_tpu.models.gbdt import _device_bag_mask

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import LightGBMError
from lightgbm_tpu_torch import config as tconfig
from lightgbm_tpu_torch.models import DART, GOSS, create_boosting
from lightgbm_tpu_torch.models.gbdt import device_bag_mask
from lightgbm_tpu_torch.ops.grow import GrowParams
from lightgbm_tpu_torch.ops.ordered_grow import grow_tree_ordered
from lightgbm_tpu_torch.utils import random as jrandom

pytestmark = pytest.mark.torch

BASE = {"num_leaves": 15, "min_data_in_leaf": 20, "max_bin": 63,
        "verbose": -1}
# the DART runs share one shape, so that the JAX package compiles its
# programs once for them
DART_BASE = {**BASE, "num_leaves": 7, "objective": "binary",
             "boosting_type": "dart"}
TIE_RTOL = 1e-5
LEAF_RTOL = 1e-5


def _data(n=3000, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, 8))
    y = X[:, 0] + 0.5 * X[:, 1] ** 2 + 0.3 * rng.normal(size=n)
    return X, y


def compare(port, jax_booster, label):
    """The two models' texts tree by tree; returns the trees compared."""
    trees, _, _ = cs.compare_model_texts(
        port.model_to_string(), jax_booster.model_to_string(), label,
        names=("torch", "jax"), tie_rtol=TIE_RTOL, leaf_rtol=LEAF_RTOL)
    return trees


def train_both(params, X, y, rounds, **kw):
    bj = lgb.train(params, lgb.Dataset(X, y), rounds, verbose_eval=False,
                   **kw)
    bt = lt.train(params, lt.Dataset(X, y), rounds, device="cpu",
                  verbose_eval=False, **kw)
    return bj, bt


# ---------------------------------------------------------------------------
# the draws


@pytest.mark.parametrize("n", [1, 1000, 4097])
@pytest.mark.parametrize("seed", [0, 3, 12345, 2 ** 31 - 1])
def test_threefry_matches_jax_random(seed, n):
    key = jax.random.PRNGKey(seed)
    assert tuple(np.asarray(key).tolist()) == jrandom.prng_key(seed)
    jsplit = np.asarray(jax.random.split(key))
    tsplit = jrandom.split(jrandom.prng_key(seed))
    assert [tuple(r) for r in jsplit.tolist()] == tsplit
    sub = jax.random.split(key)[1]
    want = np.asarray(jax.random.bits(sub, (n,), jnp.uint32))
    got = jrandom.bits(tsplit[1], n)
    assert torch.equal(got, torch.from_numpy(want.astype(np.int64)))
    want_u = np.asarray(jax.random.uniform(sub, (n,)))
    got_u = jrandom.uniform(tsplit[1], n)
    assert got_u.dtype == torch.float32
    assert torch.equal(got_u, torch.from_numpy(want_u))


def test_bucket_rows_matches_jax():
    from lightgbm_tpu.utils.compile_cache import bucket_rows
    for n in (0, 1, 2, 31, 32, 33, 1000, 4097, 100_000, 1_000_000):
        assert jrandom.bucket_rows(n) == bucket_rows(n)


@pytest.mark.parametrize("n,n_real,bag_cnt", [
    (1024, 1000, 800),      # padded, as under row_buckets
    (4224, 4097, 0),        # nothing kept
    (1024, 1000, 1000),     # every real row kept
    (777, 777, 300),        # no pad
])
def test_bag_mask_matches_jax(n, n_real, bag_cnt):
    key = jax.random.split(jax.random.PRNGKey(3))[1]
    want = np.asarray(_device_bag_mask(key, n, bag_cnt, n_real))
    got = device_bag_mask(tuple(np.asarray(key).tolist()), n, bag_cnt,
                          n_real, "cpu")
    assert torch.equal(got, torch.from_numpy(want[:n_real]))
    assert int(got.sum()) == bag_cnt


def _goss_pair(num_class, n=2000, lr=0.05):
    X, y = _data(n, seed=5)
    params = {**BASE, "boosting_type": "goss", "learning_rate": lr,
              "top_rate": 0.2, "other_rate": 0.15}
    if num_class > 1:
        y = np.digitize(y, [-0.5, 0.5]).astype(np.float64)
        params.update(objective="multiclass", num_class=num_class)
    else:
        params["objective"] = "regression"
    # (a JAX Booster bins with its Dataset's params)
    bj = lgb.Booster(params=params, train_set=lgb.Dataset(X, y,
                                                          params=params))
    bt = lt.Booster(params=params, train_set=lt.Dataset(X, y,
                                                        params=params),
                    device="cpu")
    return bj._booster, bt._booster


@pytest.mark.parametrize("num_class", [1, 3])
def test_goss_sample_matches_jax(num_class):
    gj, gt = _goss_pair(num_class)
    assert type(gt) is GOSS and gt._padded_rows == gj._padded_rows
    rng = np.random.RandomState(7)
    n = gt.num_data
    for draw in range(2):
        # gradients on a coarse grid: many rows tie on |g * h|
        g = (np.round(rng.normal(size=(num_class, n)) * 4) / 4).astype(
            np.float32)
        h = rng.choice([0.25, 0.5, 1.0], size=(num_class, n)).astype(
            np.float32)
        mj, grj, hsj = gj._sample(jnp.asarray(g), jnp.asarray(h))
        mt, grt, hst = gt._sample(torch.from_numpy(g), torch.from_numpy(h))
        assert torch.equal(mt, torch.from_numpy(np.asarray(mj)[:n]))
        assert torch.equal(grt, torch.from_numpy(np.asarray(grj)[:, :n]))
        assert torch.equal(hst, torch.from_numpy(np.asarray(hsj)[:, :n]))
        assert int((mt > 0).sum()) > int(0.2 * n)
    assert gt._goss_key == tuple(np.asarray(gj._goss_key).tolist())


@pytest.mark.parametrize("xgboost_dart_mode", [False, True])
@pytest.mark.parametrize("uniform_drop", [False, True])
def test_dart_drops_match_jax(uniform_drop, xgboost_dart_mode):
    X, y = _data(1500, seed=8)
    yb = (y > 0.3).astype(np.float64)
    params = {**DART_BASE, "drop_rate": 0.5, "skip_drop": 0.2, "max_drop": 3,
              "uniform_drop": uniform_drop,
              "xgboost_dart_mode": xgboost_dart_mode, "learning_rate": 0.3}
    bj = lgb.Booster(params=params, train_set=lgb.Dataset(X, yb,
                                                          params=params))
    bt = lt.Booster(params=params, train_set=lt.Dataset(X, yb,
                                                        params=params),
                    device="cpu")
    assert type(bt._booster) is DART
    seq_j, seq_t = [], []
    for _ in range(8):
        bj.update()
        bt.update()
        seq_j.append((list(bj._booster.drop_index),
                      bj._booster.shrinkage_rate))
        seq_t.append((list(bt._booster.drop_index),
                      bt._booster.shrinkage_rate))
    assert seq_t == seq_j
    assert any(d for d, _ in seq_t)
    assert bt._booster.tree_weights == bj._booster.tree_weights
    assert bt._booster.sum_weight == bj._booster.sum_weight


# ---------------------------------------------------------------------------
# training end to end


@pytest.mark.parametrize("grower", ["ordered", "cached", "fused",
                                    "nocache"])
def test_bagging_and_feature_fraction_train_like_jax(grower):
    X, y = _data()
    params = {**BASE, "objective": "regression", "bagging_fraction": 0.8,
              "bagging_freq": 2, "feature_fraction": 0.7,
              "serial_grow": "cached" if grower == "nocache" else grower}
    if grower == "nocache":
        # a pool below the per-leaf histogram cache: the degrade step
        params.update(histogram_pool_size=0.1, memory_policy="degrade")
    bj, bt = train_both(params, X, y, 6)
    assert bt._booster.grow_kind == grower
    assert bt._booster.grow_params.compact_inactive
    assert compare(bt, bj, f"bagging {grower}") == 6
    np.testing.assert_allclose(bt.predict(X[:500]), bj.predict(X[:500]),
                               rtol=0, atol=1e-5)


def test_goss_trains_like_jax():
    X, y = _data()
    params = {**BASE, "objective": "regression", "boosting_type": "goss",
              "learning_rate": 0.5}
    bj, bt = train_both(params, X, y, 6)
    # warmup: int(1 / 0.5) = 2 rounds; 4 rounds sample
    assert bt._booster._bag_cnt == bj._booster._bag_cnt < len(y)
    assert compare(bt, bj, "goss") == 6
    assert bt.model_to_string().splitlines()[0] == "goss"


def test_dart_trains_like_jax():
    X, y = _data(1500, seed=2)
    yb = (y > 0.3).astype(np.float64)
    params = {**DART_BASE, "drop_rate": 0.3}
    bj, bt = train_both(params, X, yb, 8)
    assert compare(bt, bj, "dart") == 8
    assert bt._booster.tree_weights == bj._booster.tree_weights
    # the normalised trees in the model text are what the scores hold
    raw = lt.Booster(model_str=bt.model_to_string(),
                     device="cpu").predict(X, raw_score=True)
    np.testing.assert_allclose(raw, bt._booster.train_data.host_score()[0],
                               rtol=0, atol=1e-5)


def test_multiclass_feature_fraction_trains_like_jax():
    X, y = _data(seed=3)
    ym = np.digitize(y, [-0.5, 0.5, 1.5]).astype(np.float64)
    params = {**BASE, "objective": "multiclass", "num_class": 4,
              "feature_fraction": 0.6, "bagging_fraction": 0.9,
              "bagging_freq": 1}
    bj, bt = train_both(params, X, ym, 3)
    assert compare(bt, bj, "multiclass") == 12


def test_custom_objective_draws_in_the_per_stage_order():
    """fobj gradients: the JAX per-stage round draws the bag mask after
    the gradients and one feature mask per class in the class loop."""
    X, y = _data(seed=4)

    def fobj(preds, ds):
        return preds - ds.get_label(), np.ones_like(preds)
    params = {**BASE, "bagging_fraction": 0.7, "bagging_freq": 1,
              "feature_fraction": 0.5}
    bj, bt = train_both(params, X, y, 4, fobj=fobj)
    assert compare(bt, bj, "fobj") == 4


def test_reset_parameter_keeps_the_generators():
    X, y = _data(seed=6)
    params = {**BASE, "objective": "regression", "bagging_fraction": 0.8,
              "bagging_freq": 1, "feature_fraction": 0.8}
    out = []
    for pkg, kw in ((lgb, {}), (lt, {"device": "cpu"})):
        b = pkg.Booster(params=params,
                        train_set=pkg.Dataset(X, y, params=params), **kw)
        for i in range(6):
            if i == 3:
                b.reset_parameter({"bagging_fraction": 0.5,
                                   "feature_fraction": 0.6})
            b.update()
        out.append(b)
    assert out[1]._booster._bag_cnt == out[0]._booster._bag_cnt == 1500
    assert compare(out[1], out[0], "reset") == 6


# ---------------------------------------------------------------------------
# the ordered grower's row compaction


@pytest.mark.parametrize("mask", ["bagged", "ones", "none_kept"])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.uint16])
def test_compaction_grows_the_same_tree(mask, dtype):
    rng = np.random.RandomState(9)
    N, F, B = 3000, 6, 40 if dtype == torch.uint8 else 300
    bins = rng.randint(0, B, size=(N, F))
    grad = torch.from_numpy((bins[:, 0] / B - 0.5 + 0.1 * rng.normal(
        size=N)).astype(np.float32))
    hess = torch.ones(N, dtype=torch.float32)
    w = {"bagged": (rng.rand(N) < 0.6), "ones": np.ones(N, bool),
         "none_kept": np.zeros(N, bool)}[mask]
    args = (torch.from_numpy(bins.astype(np.int32)).to(dtype),
            torch.full((F,), B, dtype=torch.int32),
            torch.tensor([False, False, True, False, False, False]),
            torch.ones(F, dtype=torch.bool), grad, hess,
            torch.from_numpy(w.astype(np.float32)), 0.1)
    out = [grow_tree_ordered(*args, GrowParams(
        num_leaves=15, max_bin=B, min_data_in_leaf=20,
        compact_inactive=c)) for c in (False, True)]
    (ta, la, da), (tb, lb, db) = out
    for field in ta._fields:
        assert torch.equal(getattr(ta, field), getattr(tb, field)), field
    assert torch.equal(la, lb) and torch.equal(da, db)
    if mask == "bagged":
        assert int(ta.num_leaves) > 4


# ---------------------------------------------------------------------------
# nan_policy


def _poisoning_fobj(bad_round):
    calls = {"n": 0}

    def fobj(preds, ds):
        g = preds - ds.get_label()
        if calls["n"] == bad_round:
            g = g.copy()
            g[5] = np.nan
        calls["n"] += 1
        return g, np.ones_like(preds)
    return fobj


def test_nan_policy_fail_fast_raises_like_jax():
    X, y = _data(800, seed=10)
    params = {**BASE, "nan_policy": "fail_fast", "bagging_fraction": 0.7,
              "bagging_freq": 1}
    errors = []
    for pkg, kw in ((lgb, {}), (lt, {"device": "cpu"})):
        with pytest.raises(Exception) as exc:
            pkg.train(params, pkg.Dataset(X, y), 5,
                      fobj=_poisoning_fobj(2), verbose_eval=False, **kw)
        errors.append(str(exc.value))
    assert errors[1] == errors[0]
    assert "non-finite gradients/hessians at boosting iteration 2" \
        in errors[1]


def test_nan_policy_skip_tree_retries_like_jax():
    X, y = _data(800, seed=11)
    params = {**BASE, "nan_policy": "skip_tree", "bagging_fraction": 0.7,
              "bagging_freq": 1, "feature_fraction": 0.75}
    bj, bt = (pkg.train(params, pkg.Dataset(X, y), 5,
                        fobj=_poisoning_fobj(2), verbose_eval=False, **kw)
              for pkg, kw in ((lgb, {}), (lt, {"device": "cpu"})))
    # the poisoned round is dropped and its index retried, with a new
    # bag draw: four trees, the retried one equal to JAX's
    assert bt.num_trees() == bj.num_trees() == 4
    assert bt._booster._nan_skips == 1
    assert compare(bt, bj, "skip_tree") == 4


@pytest.mark.parametrize("policy", ["fail_fast", "skip_tree"])
def test_nan_policy_objective_rounds_draw_like_jax(policy):
    """An objective's gradients (the JAX fused round): the masks are
    drawn before the check, so a dropped round still advances the bag
    and feature generators, as in the JAX package."""
    X, y = _data(600, seed=12)
    y[7] = np.nan
    params = {**BASE, "objective": "regression", "nan_policy": policy,
              "bagging_fraction": 0.7, "bagging_freq": 1,
              "feature_fraction": 0.5}
    out = []
    for pkg, kw in ((lgb, {}), (lt, {"device": "cpu"})):
        b = pkg.Booster(params=params,
                        train_set=pkg.Dataset(X, y, params=params), **kw)
        msgs = []
        for _ in range(3):
            try:
                b.update()
            except Exception as e:              # noqa: BLE001
                msgs.append(str(e))
        out.append((b, msgs))
    (bj, mj), (bt, mt) = out
    assert mt == mj and len(mt) == (3 if policy == "fail_fast" else 0)
    assert bt.num_trees() == bj.num_trees() == 0
    gj, gt = bj._booster, bt._booster
    assert gt._bag_key == tuple(np.asarray(gj._bag_key).tolist())
    assert gt._feature_rng.randint(1 << 30) == gj._feature_rng.randint(
        1 << 30)
    assert np.isfinite(gt.train_data.host_score()).all()


def test_nan_policy_is_checked_like_jax():
    for pkg in (lgb, lt):
        cfg_cls = pkg.basic.Config
        with pytest.raises(ValueError, match="Unknown nan_policy"):
            cfg_cls({"nan_policy": "sometimes"})


# ---------------------------------------------------------------------------
# the config: keys, aliases, refusals


def test_every_jax_key_is_read_refused_or_inert():
    read = set(tconfig._DEFAULTS) - set(tconfig.REFUSED)
    refused, inert = set(tconfig.REFUSED), set(tconfig.INERT)
    assert not (read & inert) and not (refused & inert)
    assert refused <= set(tconfig._DEFAULTS)
    for key in JAX_DEFAULTS:
        assert (key in read) + (key in refused) + (key in inert) == 1, key
    # the port's own key, and nothing else the JAX package lacks
    assert read - set(JAX_DEFAULTS) == {"device"}
    # the distributed learners' keys are read, and since the
    # crash-safe slice the collective watchdog, the consistency check,
    # the snapshots and the sink policy; memwatch waits for the span
    # hooks
    assert {"num_machines", "tree_learner", "top_k", "machine_list_file",
            "local_listen_port", "time_out", "distributed_init_retries",
            "distributed_init_backoff", "distributed_heartbeat_ms",
            "collective_timeout_s", "distributed_consistency_check",
            "desync_policy", "snapshot_dir", "snapshot_freq",
            "snapshot_keep", "sink_error_policy"} <= read
    assert "memwatch" in inert
    # the data boundary is read since (bad_data_policy, the budgets, the
    # two-round loader): nothing is refused
    assert refused == set()
    assert {"bad_data_policy", "use_two_round_loading", "max_bad_rows",
            "max_bad_row_fraction"} <= read
    assert inert <= set(JAX_DEFAULTS)
    for alias, key in JAX_ALIASES.items():
        assert tconfig.PARAM_ALIASES[alias] == key


def test_sampling_keys_match_jax_defaults_and_aliases():
    from lightgbm_tpu.config import Config as JaxConfig
    keys = ("bagging_seed", "feature_fraction_seed", "top_rate",
            "other_rate", "drop_rate", "skip_drop", "max_drop",
            "uniform_drop", "xgboost_dart_mode", "drop_seed", "row_buckets",
            "nan_policy", "bagging_fraction", "bagging_freq",
            "feature_fraction")
    for params in ({}, {"sub_feature": "0.5", "subsample": "0.7",
                        "subsample_freq": "3", "drop_seed": "9",
                        "uniform_drop": "true", "top_rate": "0.3"},
                   {"colsample_bytree": 0.4, "sub_row": 0.6}):
        ours, theirs = tconfig.Config(params), JaxConfig(params)
        for key in keys:
            assert ours[key] == theirs[key], key
    for pkg in (JaxConfig, tconfig.Config):
        with pytest.raises(ValueError, match="cannot use bagging in GOSS"):
            pkg({"boosting_type": "goss", "bagging_fraction": 0.5,
                 "bagging_freq": 1})


@pytest.mark.parametrize("params,what", [
    ({"feature_screen_ratio": 0.3}, "feature_screen_ratio"),
    ({"snapshot_dir": "snaps"}, "snapshot_dir"),
    ({"num_machine": 2}, "num_machines"),
    ({"pre_partition": "true"}, "is_pre_partition"),
    ({"save_binary": "true"}, "is_save_binary_file"),
    ({"serve_canary_model": "b.txt"}, "serve_canary_model"),
])
def test_keys_that_change_the_answer_are_refused_by_name(params, what):
    from lightgbm_tpu.config import Config as JaxConfig
    from lightgbm_tpu_torch.utils import log
    key = tconfig.apply_aliases(params).popitem()[0]
    if what == "feature_screen_ratio":
        # ported since: read as the JAX package reads it
        assert tconfig.Config(params)[key] == JaxConfig(params)[key] == 0.3
        return
    if what == "snapshot_dir":
        # ported since (crash-safe snapshots): read as the JAX package
        # reads it
        assert tconfig.Config(params)[key] == JaxConfig(params)[key] \
            == "snaps"
        return
    if what == "serve_canary_model":
        # ported since (the serving fleet's canary): read as the JAX
        # package reads it
        assert tconfig.Config(params)[key] == JaxConfig(params)[key] \
            == "b.txt"
        return
    if what in ("is_pre_partition", "is_save_binary_file"):
        # read by nothing in the JAX package outside its config: inert
        # since, with one warning
        log._warned_once.discard(f"config:{key}")
        tconfig.Config(params).check_trainable()
        assert f"config:{key}" in log._warned_once
        return
    if what == "num_machines":
        # ported since (the distributed learners): read as the JAX
        # package reads it (a serial learner runs on one machine); so
        # are the watchdog's deadline and the consistency check since
        for extra in ({}, {"tree_learner": "voting"}):
            ours = tconfig.Config({**params, **extra})
            theirs = JaxConfig({**params, **extra})
            assert ours[key] == theirs[key]
            assert ours.tree_learner == theirs.tree_learner
        for read in ("collective_timeout_s",
                     "distributed_consistency_check"):
            assert tconfig.Config({read: 3})[read] \
                == JaxConfig({read: 3})[read]
        return
    with pytest.raises(LightGBMError, match=f"not ported yet.*{what}"):
        tconfig.Config(params)
    # the JAX default is not refused
    tconfig.Config({key: tconfig._DEFAULTS[key]})


@pytest.mark.parametrize("key", ["seed", "num_threads", "trace_dir",
                                 "serve_replicas", "compile_cache_dir"])
def test_inert_keys_warn_once(key, capsys):
    from lightgbm_tpu.config import Config as JaxConfig
    from lightgbm_tpu_torch.utils import log
    log._warned_once.discard(f"config:{key}")
    if key == "serve_replicas":
        # read since the serving fleet was ported: no warning
        assert tconfig.Config({key: "4"})[key] == JaxConfig({key: "4"})[key]
        assert f"config:{key}" not in log._warned_once
        return
    tconfig.Config({key: "4"}).check_trainable()
    assert f"config:{key}" in log._warned_once
    assert "cannot change a tree" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the boosting factory


@pytest.mark.parametrize("kind", ["goss", "dart"])
def test_a_model_text_continues_as_its_class(kind):
    X, y = _data(800, seed=13)
    params = {**BASE, "objective": "regression", "boosting_type": kind}
    bt = lt.train(params, lt.Dataset(X, y), 2, device="cpu",
                  verbose_eval=False)
    text = bt.model_to_string()
    loaded = lt.Booster(model_str=text, device="cpu")
    cls = {"goss": GOSS, "dart": DART}[kind]
    assert type(loaded._booster) is cls
    assert type(create_boosting(model_str=text)) is cls
    assert loaded.model_to_string() == text


def test_dart_init_model_does_what_jax_does():
    """Continued training under DART: the JAX DART indexes its tree
    weights by round, which hold no entry for an init model's rounds."""
    X, y = _data(800, seed=14)
    gb = {**BASE, "objective": "regression"}
    init = lt.train(gb, lt.Dataset(X, y), 3, device="cpu",
                    verbose_eval=False).model_to_string()
    outcomes = []
    for params in ({**gb, "boosting_type": "dart"},
                   {**gb, "boosting_type": "dart", "uniform_drop": True}):
        row = []
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "init.txt")
            with open(path, "w") as fh:
                fh.write(init)
            for pkg, kw in ((lgb, {}), (lt, {"device": "cpu"})):
                try:
                    b = pkg.train(params, pkg.Dataset(X, y), 3,
                                  init_model=path, verbose_eval=False, **kw)
                    row.append(("ran", b.num_trees()))
                except Exception as e:          # noqa: BLE001
                    row.append(("raised", type(e).__name__))
        assert row[1] == row[0], row
        outcomes.append(row[0])
    assert outcomes[0] == ("raised", "IndexError")
    assert outcomes[1] == ("ran", 6)
