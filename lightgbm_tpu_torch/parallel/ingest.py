"""Sharded ingestion and the distributed FindBin.

Port of the JAX package's parallel/ingest.py (reference
dataset_loader.cpp: rank-partitioned loading, 549-655, and the
distributed bin construction, 723-816).  Each rank holds only its rows;
two all-reduces of a ``torch.distributed`` group make every rank agree
on the whole mapper set before it bins its rows:

1. the sample's row indices are drawn from the GLOBAL row count with the
   single-host seed and order (``BinnedDataset.from_matrix``), so the
   mappers equal single-host ones;
2. each rank fills its own sampled rows of an ``[S, F]`` f64 buffer
   (zeros elsewhere) and one all-reduce rebuilds the whole sample on
   every rank (disjoint rows: the sum is the gather);
3. rank ``r`` runs FindBin for the features ``f % world == r``;
4. each rank fills its features' rows of the fixed-width f64 mapper
   table (:func:`encode_mapper`, the JAX package's rows) and a second
   all-reduce distributes the table; :func:`decode_mapper` rebuilds the
   mappers;
5. each rank bins its own rows with them.

The JAX package moves f64 through an f32 x 3 split because a TPU
``psum`` has no f64; the port all-reduces f64 directly (a sum with
zeros, exact).  Without a group (one process) the all-reduces are the
identity.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..io.binning import NUMERICAL, BinMapper
from ..io.dataset import BinnedDataset, Metadata, build_mappers_from_sample
from ..utils import log
from .comm import all_gather, all_reduce


def row_partition(num_data: int, num_shards: int) -> List[Tuple[int, int]]:
    """Contiguous ``[start, stop)`` row ranges, balanced like the
    reference's Partition(num_data, num_machines)."""
    base, rem = divmod(num_data, num_shards)
    out, start = [], 0
    for r in range(num_shards):
        cnt = base + (1 if r < rem else 0)
        out.append((start, start + cnt))
        start += cnt
    return out


def load_file_sharded(path: str, num_shards: int, has_header: bool = False,
                      label_idx: int = 0):
    """Per-shard ``(rows, labels)`` partitions of a data file (parsed
    once, then split by :func:`row_partition`), and its header."""
    from ..io.parser import parse_file
    label, X, header = parse_file(path, has_header=has_header,
                                  label_idx=label_idx)
    shards = [(X[a:b], None if label is None else label[a:b])
              for a, b in row_partition(X.shape[0], num_shards)]
    return shards, header


# ---------------------------------------------------------------------------
# a mapper as a fixed-width f64 row (the JAX package's layout)


def mapper_width(max_bin: int) -> int:
    return 7 + max_bin + 1


def encode_mapper(m: Optional[BinMapper], max_bin: int) -> np.ndarray:
    """``[num_bin, bin_type, is_trivial, sparse_rate, min_val, max_val,
    default_bin, payload...]`` with the upper bounds (numerical) or the
    categories as payload; ``row[0] = -1`` for no mapper."""
    row = np.zeros(mapper_width(max_bin), np.float64)
    if m is None:
        row[0] = -1.0
        return row
    row[0] = m.num_bin
    row[1] = m.bin_type
    row[2] = 1.0 if m.is_trivial else 0.0
    row[3] = m.sparse_rate
    row[4] = m.min_val
    row[5] = m.max_val
    row[6] = m.default_bin
    payload = (np.asarray(m.bin_upper_bound, np.float64)
               if m.bin_type == NUMERICAL
               else np.asarray(m.bin_2_categorical, np.float64))
    row[7:7 + len(payload)] = payload
    return row


def decode_mapper(row: np.ndarray) -> Optional[BinMapper]:
    """Inverse of :func:`encode_mapper`."""
    if row[0] < 0:
        return None
    m = BinMapper()
    m.num_bin = int(row[0])
    m.bin_type = int(row[1])
    m.is_trivial = bool(row[2] > 0.5)
    m.sparse_rate = float(row[3])
    m.min_val = float(row[4])
    m.max_val = float(row[5])
    m.default_bin = int(row[6])
    if m.bin_type == NUMERICAL:
        m.bin_upper_bound = np.asarray(row[7:7 + m.num_bin], np.float64)
        m.bin_2_categorical = []
        m.categorical_2_bin = {}
    else:
        m.bin_upper_bound = np.zeros(0, np.float64)
        m.bin_2_categorical = [int(c) for c in row[7:7 + m.num_bin]]
        m.categorical_2_bin = {c: i for i, c in
                               enumerate(m.bin_2_categorical)}
    return m


# ---------------------------------------------------------------------------
# the distributed FindBin


def global_sample_indices(num_data: int, sample_cnt: int,
                          seed: int) -> np.ndarray:
    """The single-host sample of ``BinnedDataset.from_matrix``."""
    if num_data <= sample_cnt:
        return np.arange(num_data, dtype=np.int64)
    rng = np.random.RandomState(seed)
    return np.sort(rng.choice(num_data, sample_cnt, replace=False))


def _rank_world(group) -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(group), dist.get_world_size(group)
    return 0, 1


def _sum_over_ranks(a: np.ndarray, group) -> np.ndarray:
    """The element-wise sum of every rank's f64 array (the identity in
    one process)."""
    if _rank_world(group)[1] == 1:
        return a
    return all_reduce(torch.from_numpy(np.ascontiguousarray(a)), group,
                      kind="ingest").numpy()


def _row_offsets(n_local: int, group) -> np.ndarray:
    """[world + 1] row offsets of the ranks' shards."""
    if _rank_world(group)[1] == 1:
        return np.asarray([0, n_local])
    counts = all_gather(torch.tensor([n_local], dtype=torch.int64), group,
                        kind="ingest").reshape(-1).numpy()
    return np.concatenate([[0], np.cumsum(counts)])


def distributed_find_bin(local_rows: np.ndarray, group=None, *,
                         max_bin: int = 255, min_data_in_bin: int = 5,
                         min_data_in_leaf: int = 100,
                         bin_construct_sample_cnt: int = 200000,
                         categorical_features: Sequence[int] = (),
                         data_random_seed: int = 1
                         ) -> List[Optional[BinMapper]]:
    """Every feature's mapper, agreed over the group's row shards
    (``local_rows``: this rank's rows, the ranks' shards in rank order);
    equal to the single-host mappers of the concatenated rows."""
    rank, k = _rank_world(group)
    local_rows = np.asarray(local_rows, np.float64)
    F = local_rows.shape[1]
    offsets = _row_offsets(local_rows.shape[0], group)
    num_data = int(offsets[-1])
    sample_idx = global_sample_indices(num_data, bin_construct_sample_cnt,
                                       data_random_seed)
    lo, hi = offsets[rank], offsets[rank + 1]
    owned = (sample_idx >= lo) & (sample_idx < hi)
    contrib = np.zeros((len(sample_idx), F), np.float64)
    contrib[np.nonzero(owned)[0]] = local_rows[sample_idx[owned] - lo]
    sample = _sum_over_ranks(contrib, group)
    per_real = build_mappers_from_sample(
        sample, num_data, max_bin=max_bin, min_data_in_bin=min_data_in_bin,
        min_data_in_leaf=min_data_in_leaf,
        categorical_features={int(c) for c in categorical_features},
        feature_indices=range(rank, F, k))
    enc = np.zeros((F, mapper_width(max_bin)), np.float64)
    for f in range(rank, F, k):
        enc[f] = encode_mapper(per_real[f], max_bin)
    table = _sum_over_ranks(enc, group)
    return [decode_mapper(table[f]) for f in range(F)]


def binned_dataset_from_shards(local_rows: np.ndarray,
                               local_label: Optional[np.ndarray] = None,
                               group=None, *, max_bin: int = 255,
                               min_data_in_bin: int = 5,
                               min_data_in_leaf: int = 100,
                               bin_construct_sample_cnt: int = 200000,
                               categorical_features: Sequence[int] = (),
                               data_random_seed: int = 1) -> BinnedDataset:
    """This rank's rows binned with the agreed mappers
    (:func:`distributed_find_bin`): its bins are the matching columns of
    the single-host dataset of the concatenated rows."""
    local_rows = np.asarray(local_rows, np.float64)
    mappers_per_real = distributed_find_bin(
        local_rows, group, max_bin=max_bin, min_data_in_bin=min_data_in_bin,
        min_data_in_leaf=min_data_in_leaf,
        bin_construct_sample_cnt=bin_construct_sample_cnt,
        categorical_features=categorical_features,
        data_random_seed=data_random_seed)
    ds = BinnedDataset()
    n, F = local_rows.shape
    ds.num_total_features = F
    ds.max_bin = max_bin
    ds.feature_names = [f"Column_{i}" for i in range(F)]
    ds.real_to_inner = np.full(F, -1, dtype=np.int64)
    used, mappers = [], []
    for f, m in enumerate(mappers_per_real):
        if m is None or m.is_trivial:
            continue
        ds.real_to_inner[f] = len(used)
        used.append(f)
        mappers.append(m)
    ds.used_feature_map = used
    ds.mappers = mappers
    if not used:
        log.warning("All features are trivial; dataset has no usable feature")
    dtype = np.uint8 if max([m.num_bin for m in mappers] or [1]) <= 256 \
        else np.uint16
    ds.bins = np.zeros((len(used), n), dtype=dtype)
    for inner, f in enumerate(used):
        ds.bins[inner] = mappers[inner].value_to_bin(
            local_rows[:, f]).astype(dtype)
    ds.metadata = Metadata(n)
    ds.metadata.set_label(np.asarray(local_label, np.float32)
                          if local_label is not None
                          else np.zeros(n, np.float32))
    return ds
