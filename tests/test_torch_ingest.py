"""Sharded ingestion and the distributed FindBin
(``lightgbm_tpu_torch/parallel/ingest.py``) against the JAX package's
``parallel/ingest.py`` and single-host binning.

The mapper codec writes the JAX package's rows, so the port decodes the
JAX package's mappers; the partition is the reference's; one process
(no group) and three gloo ranks on the CPU agree on the mappers the
single-host binning finds, and each rank's bins are its columns of the
single-host dataset.
"""

import json
import os
import sys

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from lightgbm_tpu.io.dataset import BinnedDataset as JBinned
from lightgbm_tpu.parallel import ingest as jingest

from lightgbm_tpu_torch.io.dataset import BinnedDataset
from lightgbm_tpu_torch.parallel import ingest
from lightgbm_tpu_torch.parallel.launch import machine_list, run_ranks

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_parallel_worker.py")
KW = dict(max_bin=63, min_data_in_bin=3, min_data_in_leaf=20,
          bin_construct_sample_cnt=700, categorical_features=[3],
          data_random_seed=5)


def _xy(n=1001, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, 6))
    X[:, 2] = np.where(rng.rand(n) < 0.7, 0.0, X[:, 2])   # sparse
    X[:, 3] = rng.randint(0, 9, size=n)                   # categorical
    X[:, 5] = 1.0                                          # trivial
    y = (X[:, 0] > 0).astype(np.float32)
    return X, y


def _single(X, y):
    kw = dict(KW, categorical_features=KW["categorical_features"])
    return JBinned.from_matrix(X, y, **kw)


@pytest.mark.parametrize("n,k", [(10, 3), (7, 7), (1001, 4), (5, 8)])
def test_row_partition_as_jax(n, k):
    assert ingest.row_partition(n, k) == jingest.row_partition(n, k)
    assert ingest.mapper_width(255) == jingest.mapper_width(255)


def test_codec_rows_equal_jax_and_round_trip():
    X, y = _xy()
    ours = BinnedDataset.from_matrix(X, y, **KW)
    theirs = _single(X, y)
    for m, jm in zip(ours.mappers, theirs.mappers):
        row = ingest.encode_mapper(m, KW["max_bin"])
        np.testing.assert_array_equal(row,
                                      jingest.encode_mapper(jm, KW["max_bin"]))
        back = ingest.decode_mapper(jingest.encode_mapper(jm, KW["max_bin"]))
        want = m.to_state()
        got = back.to_state()
        for state in (want, got):
            state.pop("bin_counts")
            if m.bin_type == 1:
                # a categorical mapper's bounds are unused; the codec
                # (the JAX package's too) carries its categories only
                state.pop("bin_upper_bound")
        assert got == want
    assert ingest.decode_mapper(ingest.encode_mapper(None, 63)) is None
    assert any(m.bin_type == 1 for m in ours.mappers)


def test_one_process_find_bin_equals_jax_and_single_host():
    X, y = _xy()
    shards = [X[a:b] for a, b in jingest.row_partition(len(X), 4)]
    mesh = Mesh(np.array(jax.devices()[:4]), ("shard",))
    theirs = jingest.distributed_find_bin(mesh, "shard", shards, **KW)
    ours = ingest.distributed_find_bin(X, **KW)
    single = _single(X, y)
    for f, (m, jm) in enumerate(zip(ours, theirs)):
        np.testing.assert_array_equal(
            ingest.encode_mapper(m, KW["max_bin"]),
            jingest.encode_mapper(jm, KW["max_bin"]), err_msg=str(f))
    ds = ingest.binned_dataset_from_shards(X, y, **KW)
    assert ds.used_feature_map == list(single.used_feature_map)
    np.testing.assert_array_equal(ds.bins, single.bins)
    idx = ingest.global_sample_indices(len(X), 700, 5)
    np.testing.assert_array_equal(idx,
                                  jingest.global_sample_indices(len(X), 700, 5))


@pytest.fixture(scope="module")
def three_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ingest3")
    X, y = _xy()
    np.savez(tmp / "xy.npz", X=X, y=y)
    jobs = {"world": 3, "out": str(tmp),
            "mlist": machine_list(str(tmp / "mlist.txt"), 3),
            "ingest": [{"name": "ingest", "data": str(tmp / "xy.npz"),
                        "kw": KW}]}
    (tmp / "jobs.json").write_text(json.dumps(jobs))
    codes, outs = run_ranks([[sys.executable, WORKER,
                              str(tmp / "jobs.json")]] * 3, timeout=60)
    assert codes == [0, 0, 0], outs[0][-3000:]
    return tmp, X, y


def test_three_ranks_agree_on_the_single_host_mappers(three_ranks):
    tmp, X, y = three_ranks
    single = _single(X, y)
    want = np.stack([jingest.encode_mapper(m, KW["max_bin"])
                     for m in single.mappers])
    for r in range(3):
        got = np.load(tmp / f"ingest_r{r}.npz")
        np.testing.assert_array_equal(got["enc"], want)
        assert list(got["used"]) == list(single.used_feature_map)


def test_each_rank_bins_its_columns_of_the_single_host_dataset(three_ranks):
    tmp, X, y = three_ranks
    single = _single(X, y)
    for r, (a, b) in enumerate(ingest.row_partition(len(X), 3)):
        got = np.load(tmp / f"ingest_r{r}.npz")
        np.testing.assert_array_equal(got["bins"], single.bins[:, a:b])
        np.testing.assert_array_equal(got["label"], y[a:b])
