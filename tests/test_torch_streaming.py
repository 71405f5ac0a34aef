"""The port's two-round loader (lightgbm_tpu_torch/io/streaming.py,
``use_two_round_loading``) against the JAX package's, on the CPU: the
cases of the JAX package's tests/test_streaming.py, on the repo's own
example files.

On the regression and binary TSVs and the LibSVM ranking file the two
loaders give bit-equal mappers, bins and labels, and the port's
two-round load equals its one-round load through the same Python parser
(the native loader patched away, as in JAX's tests/test_streaming.py), also
on a sampled binning; a valid file binned on a two-round training set's
mappers, categorical features by index and by header name, the column
roles, EFB over the round-1b sample and continued training (the init
scores of a chunked re-read) follow the JAX package, and through
``Dataset`` and ``train`` the port grows the JAX package's trees.
"""

import pathlib
from unittest import mock

import numpy as np
import pytest

import lightgbm_tpu as lgb
from lightgbm_tpu.io import streaming as jstreaming

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.io import parser as tparser
from lightgbm_tpu_torch.io import streaming as tstreaming
from lightgbm_tpu_torch.io.binning import CATEGORICAL
from lightgbm_tpu_torch.io.dataset import BinnedDataset
from lightgbm_tpu_torch.utils.log import LightGBMError

from torch_threads import one_torch_thread  # noqa: F401

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"
CASES = ["regression/regression.train",
         "binary_classification/binary.train",
         "lambdarank/rank.train"]                  # LibSVM
BIN = dict(max_bin=63, min_data_in_leaf=20)
TRAIN = {"objective": "binary", "num_leaves": 15, "verbose": -1,
         "max_bin": 63, "min_data_in_leaf": 20}


def _no_native():
    return mock.patch("lightgbm_tpu.io.native.parse_file_native",
                      return_value=None)


def _python_read(path):
    """The port's one-round read through its Python parser, the value
    source of the two-round loader: the native loader's decimal
    conversion differs from ``float()`` in the last bits (JAX's
    tests/test_streaming.py reads through Python for the same reason)."""
    with mock.patch("lightgbm_tpu_torch.io.native.parse_file_native",
                    return_value=None):
        return tparser.parse_file(path)


def _same_binned(j, t):
    assert t.used_feature_map == j.used_feature_map
    assert t.num_total_features == j.num_total_features
    assert t.feature_names == j.feature_names
    assert len(t.mappers) == len(j.mappers)
    for mj, mt in zip(j.mappers, t.mappers):
        assert mt.num_bin == mj.num_bin and mt.bin_type == mj.bin_type
        np.testing.assert_array_equal(mt.bin_upper_bound, mj.bin_upper_bound)
    np.testing.assert_array_equal(t.bins, j.bins)
    np.testing.assert_array_equal(t.metadata.label, j.metadata.label)
    for field in ("weights", "query_boundaries", "init_score"):
        a, b = getattr(j.metadata, field), getattr(t.metadata, field)
        assert (a is None) == (b is None), field
        if a is not None:
            np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("sample", [200000, 3000])
def test_two_round_mappers_and_bins_match_jax(name, sample):
    path = str(EXAMPLES / name)
    kw = dict(BIN, bin_construct_sample_cnt=sample, chunk_rows=997)
    j = jstreaming.load_file_two_round(path, **kw)
    t = tstreaming.load_file_two_round(path, **kw)
    _same_binned(j, t)
    # and the port's one-round load through the same parser
    label, X, _ = _python_read(path)
    one = BinnedDataset.from_matrix(X, label, max_bin=63,
                                    min_data_in_leaf=20,
                                    bin_construct_sample_cnt=sample)
    assert t.used_feature_map == one.used_feature_map
    for m1, m2 in zip(one.mappers, t.mappers):
        np.testing.assert_array_equal(m1.bin_upper_bound, m2.bin_upper_bound)
    np.testing.assert_array_equal(t.bins, one.bins)


def test_two_round_reference_aligned_valid_matches_jax():
    train, test = (str(EXAMPLES / "binary_classification" / f)
                   for f in ("binary.train", "binary.test"))
    jt = jstreaming.load_file_two_round(train, **BIN)
    tt = tstreaming.load_file_two_round(train, **BIN)
    jv = jstreaming.load_file_two_round(test, reference=jt, **BIN)
    tv = tstreaming.load_file_two_round(test, reference=tt, **BIN)
    _same_binned(jv, tv)
    label, X, _ = tparser.parse_file(test)
    np.testing.assert_array_equal(tv.bins, tt.create_valid(X, label).bins)


@pytest.mark.parametrize("key", ["use_two_round_loading", "two_round",
                                 "two_round_loading"])
def test_two_round_through_dataset_and_train_matches_jax(key):
    path = str(EXAMPLES / "binary_classification" / "binary.train")
    params = {**TRAIN, key: "true"}
    jd = lgb.Dataset(path, params=params)
    td = lt.Dataset(path, params=params)
    _same_binned(jd.construct()._binned, td.construct()._binned)
    # the side file beside it loads in the two-round path too
    assert td._binned.metadata.weights is not None
    bj = lgb.train(params, lgb.Dataset(path, params=params), 3,
                   verbose_eval=False)
    bt = lt.train(params, lt.Dataset(path, params=params), 3,
                  verbose_eval=False, device="cpu")
    for a, b in zip(bj._booster.models, bt._booster.models):
        n = a.num_leaves - 1
        np.testing.assert_array_equal(b.split_feature, a.split_feature[:n])
        np.testing.assert_array_equal(b.threshold, a.threshold[:n])
        np.testing.assert_allclose(b.leaf_value, a.leaf_value[:n + 1],
                                   rtol=0, atol=1e-5)


def _categorical_file(tmp_path, header):
    rng = np.random.RandomState(0)
    n = 800
    y = rng.randint(0, 2, size=n)
    num = rng.normal(size=n)
    cat = rng.randint(0, 5, size=n)
    path = tmp_path / "cat.tsv"
    with open(path, "w") as fh:
        if header:
            fh.write("y\tnum\tcat\n")
        for i in range(n):
            fh.write(f"{y[i]}\t{num[i]:.6f}\t{cat[i]}\n")
    return str(path)


@pytest.mark.parametrize("cat,header", [([1], False), (["cat"], True)])
def test_two_round_categorical_features_match_jax(tmp_path, cat, header):
    path = _categorical_file(tmp_path, header)
    params = {"use_two_round_loading": True, "max_bin": 31,
              "min_data_in_leaf": 10, "header": header}
    j = lgb.Dataset(path, categorical_feature=cat,
                    params=params).construct()._binned
    t = lt.Dataset(path, categorical_feature=cat,
                   params=params).construct()._binned
    _same_binned(j, t)
    assert t.mappers[t.real_to_inner[1]].bin_type == CATEGORICAL
    if header:
        assert t.feature_names == ["num", "cat"]
        with pytest.raises(LightGBMError, match="two-round loading"):
            lt.Dataset(path, categorical_feature=["nope"],
                       params=params).construct()


def test_two_round_column_roles_match_jax(tmp_path):
    rng = np.random.RandomState(3)
    n = 600
    path = tmp_path / "roles.csv"
    with open(path, "w") as fh:
        fh.write("y,w,qid,a,b,c\n")
        for i in range(n):
            fh.write(f"{rng.randint(0, 3)},{rng.uniform(0.5, 2):.4f},"
                     f"{i // 30},{rng.normal():.5f},{rng.normal():.5f},"
                     f"{rng.randint(0, 4)}\n")
    params = {"use_two_round_loading": True, "header": True,
              "label_column": "name:y", "weight_column": "name:w",
              "group_column": "name:qid", "categorical_column": "name:c",
              "max_bin": 31, "min_data_in_leaf": 10}
    j = lgb.Dataset(str(path), params=params).construct()._binned
    t = lt.Dataset(str(path), params=params).construct()._binned
    _same_binned(j, t)
    assert t.metadata.num_queries() == n // 30


def test_two_round_bundles_like_jax(tmp_path):
    """EFB over the round-1b sample: exclusive one-hot blocks."""
    rng = np.random.RandomState(5)
    n, blocks, width = 1500, 4, 6
    path = tmp_path / "onehot.tsv"
    with open(path, "w") as fh:
        for _ in range(n):
            row = np.zeros(blocks * width)
            for b in range(blocks):
                row[b * width + rng.randint(width)] = rng.randint(1, 4)
            fh.write("\t".join([str(rng.randint(2))]
                               + [f"{v:g}" for v in row]) + "\n")
    params = {"use_two_round_loading": True, "max_bin": 63,
              "min_data_in_leaf": 10}
    j = lgb.Dataset(str(path), params=params).construct()._binned
    t = lt.Dataset(str(path), params=params).construct()._binned
    assert t.bundle_plan is not None
    assert t.bundle_plan.column_members == j.bundle_plan.column_members
    _same_binned(j, t)


@pytest.mark.parametrize("dirty", [False, True])
def test_two_round_continued_training_init_scores_match_jax(tmp_path,
                                                            dirty):
    """A two-round file continuing a model: the init scores come from a
    chunked re-read through a shadow guard, aligned with the binned rows
    when rows were quarantined."""
    src = (EXAMPLES / "binary_classification" / "binary.train").read_text()
    lines = src.splitlines()
    if dirty:
        for i in (3, 500, 4000):
            lines[i] = lines[i].replace("\t", "\t@@\t", 1)
    path = tmp_path / "train.tsv"
    path.write_text("\n".join(lines) + "\n")
    params = {**TRAIN, "use_two_round_loading": True,
              "bad_data_policy": "quarantine"}
    clean = str(EXAMPLES / "binary_classification" / "binary.train")
    init = lt.train(TRAIN, lt.Dataset(clean, params=TRAIN), 2,
                    verbose_eval=False, device="cpu")
    model = str(tmp_path / "init.txt")
    init.save_model(model)
    with _no_native():
        bj = lgb.train(params, lgb.Dataset(str(path), params=params), 2,
                       init_model=model, verbose_eval=False)
    tj = bj._booster.train_set.metadata.init_score
    td = lt.Dataset(str(path), params=params)
    bt = lt.train(params, td, 2, init_model=model, verbose_eval=False,
                  device="cpu")
    tt = bt._booster.train_set.metadata.init_score
    assert len(tt) == len(tj) == len(lines) - 3 * dirty
    np.testing.assert_allclose(tt, tj, rtol=0, atol=1e-6)
    assert bt.num_trees() == bj.num_trees() == 4
