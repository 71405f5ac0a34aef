"""Plain reference of LightGBM's feature binning (bin.cpp FindBin and
ValueToBin, dataset_loader.cpp's row sample), in numpy and torch.

Numerical features only, as both benchmark configurations are.  The
sample is ``bin_construct_sample_cnt`` rows drawn without replacement by
``numpy.random.RandomState(data_random_seed)``, sorted, as the LightGBM
Python package's documented defaults do; the greedy equal-count search
follows bin.cpp:112-191, with the implied zeros of the sample spliced in.
A value goes to the first bin whose upper bound is >= the value.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch


def sample_rows(num_data: int, sample_cnt: int, data_random_seed: int
                ) -> np.ndarray:
    """Sorted row indices of the binning sample (all rows when fewer)."""
    if num_data <= sample_cnt:
        return np.arange(num_data)
    rng = np.random.RandomState(data_random_seed)
    return np.sort(rng.choice(num_data, sample_cnt, replace=False))


def find_bounds(sample: np.ndarray, total_cnt: int, max_bin: int,
                min_data_in_bin: int) -> np.ndarray:
    """Upper bounds of one numerical feature's bins (the last is +inf)
    from its sampled values (zeros included in ``sample``)."""
    values = np.asarray(sample, np.float64)
    nonzero = values[values != 0.0]
    zero_cnt = total_cnt - len(nonzero)
    distinct, counts = np.unique(nonzero, return_counts=True)
    if zero_cnt > 0 or len(nonzero) == 0:
        if not (distinct == 0.0).any():
            pos = int(np.searchsorted(distinct, 0.0))
            distinct = np.insert(distinct, pos, 0.0)
            counts = np.insert(counts, pos, zero_cnt)
    counts = counts.astype(np.int64)
    n = len(distinct)
    if n <= max_bin:
        bounds, cur = [], 0
        for i in range(n - 1):
            cur += counts[i]
            if cur >= min_data_in_bin:
                bounds.append((distinct[i] + distinct[i + 1]) / 2.0)
                cur = 0
        bounds.append(np.inf)
        return np.asarray(bounds, np.float64)
    # greedy equal-count bins; a value holding at least a mean bin's
    # share gets a bin of its own
    if min_data_in_bin > 0:
        max_bin = max(1, min(max_bin, total_cnt // min_data_in_bin))
    mean_size = total_cnt / max_bin
    if zero_cnt > mean_size:
        max_bin = min(max_bin, 1 + len(nonzero) // max(1, min_data_in_bin))
    is_big = counts >= mean_size
    rest_bins = max_bin - int(is_big.sum())
    rest_cnt = total_cnt - int(counts[is_big].sum())
    mean_size = rest_cnt / max(1, rest_bins)
    # bin.cpp's scan closes a bin at the first value i where the bin's
    # count reaches the mean size, i is big, or i + 1 is big and the bin
    # holds half the mean; within one bin the mean is constant, so each
    # bin's end is found by a search on the cumulative counts
    cum = np.cumsum(counts)
    cum_small = np.cumsum(np.where(is_big, 0, counts))
    big = np.nonzero(is_big)[0]
    uppers: List[float] = []
    lowers: List[float] = [float(distinct[0])]
    start = 0
    while start <= n - 2:
        base = int(cum[start - 1]) if start else 0
        end = int(np.searchsorted(cum, base + mean_size, side="left"))
        k = int(np.searchsorted(big, start))
        nxt = int(big[k]) if k < len(big) else n
        end = min(end, nxt)
        if start <= nxt - 1 < end and \
                cum[nxt - 1] - base >= max(1.0, mean_size * 0.5):
            end = nxt - 1
        if end > n - 2:
            break
        uppers.append(float(distinct[end]))
        lowers.append(float(distinct[end + 1]))
        if len(uppers) >= max_bin - 1:
            break
        rest_cnt -= int(cum_small[end] - (cum_small[start - 1] if start
                                          else 0))
        if not is_big[end]:
            rest_bins -= 1
            mean_size = rest_cnt / max(1, rest_bins)
        start = end + 1
    bounds = [(uppers[i] + lowers[i + 1]) / 2.0 for i in range(len(uppers))]
    bounds.append(np.inf)
    return np.asarray(bounds, np.float64)


def bin_bounds(X: np.ndarray, max_bin: int, min_data_in_bin: int,
               sample_cnt: int, data_random_seed: int) -> List[np.ndarray]:
    """Every feature's bin upper bounds from the sample of ``X``."""
    rows = sample_rows(X.shape[0], sample_cnt, data_random_seed)
    sample = X[rows]
    return [find_bounds(sample[:, f], len(rows), max_bin, min_data_in_bin)
            for f in range(X.shape[1])]


def codes(X: torch.Tensor, bounds: List[np.ndarray]) -> torch.Tensor:
    """[N, F] int16 bin codes of ``X`` (f64, on any device): the first bin
    whose upper bound is >= the value."""
    out = torch.empty(X.shape, dtype=torch.int16, device=X.device)
    for f, b in enumerate(bounds):
        cut = torch.from_numpy(np.ascontiguousarray(b[:-1])).to(X.device)
        out[:, f] = torch.searchsorted(cut, X[:, f].contiguous(),
                                       side="left").to(torch.int16)
    return out


def threshold_bins(feature: np.ndarray, threshold: np.ndarray,
                   bounds: List[np.ndarray]) -> Tuple[np.ndarray, int]:
    """Each split's bin index under ``bounds`` and the number of split
    thresholds that are not exactly one of the feature's upper bounds."""
    out = np.zeros(len(feature), np.int64)
    misses = 0
    for i, (f, t) in enumerate(zip(feature, threshold)):
        b = bounds[int(f)]
        j = int(np.searchsorted(b, t, side="left"))
        if j >= len(b) - 1 or b[j] != t:
            misses += 1
        out[i] = min(j, len(b) - 2)
    return out, misses
