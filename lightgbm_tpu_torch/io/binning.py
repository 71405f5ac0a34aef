"""Per-feature value->bin quantization (BinMapper).

The port's own copy of the JAX package's io/binning.py (numpy only, no
JAX): greedy equal-count binning with a distinct-value fast path,
zero-count handling, categorical mode, trivial-feature filtering, and
ValueToBin (reference bin.cpp:71-246, bin.h:385-407): ``searchsorted``,
or for a numerical column of :data:`NATIVE_BIN_MIN` values or more the
native host loader's binary search (``io/native.py``), as in the JAX
package; both give the same codes.
Binning runs once on the host at dataset construction; the card sees
only the dense uint8/uint16 bin codes.  ``from_state`` accepts the dict
the JAX mapper's ``to_state()`` gives, so both packages can share one
binning.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from . import native

NUMERICAL = 0
CATEGORICAL = 1
#: values from which a numerical column bins natively (JAX binning.py:229)
NATIVE_BIN_MIN = 65536


def _need_filter(cnt_in_bin: Sequence[int], total_cnt: int, filter_cnt: int,
                 bin_type: int) -> bool:
    """True when no split of this feature can satisfy min_data (bin.cpp:47-69)."""
    if bin_type == NUMERICAL:
        sum_left = 0
        for i in range(len(cnt_in_bin) - 1):
            sum_left += cnt_in_bin[i]
            if sum_left >= filter_cnt:
                return False
            if total_cnt - sum_left >= filter_cnt:
                return False
    else:
        for i in range(len(cnt_in_bin) - 1):
            sum_left = cnt_in_bin[i]
            if sum_left >= filter_cnt:
                return False
            if total_cnt - sum_left >= filter_cnt:
                return False
    return True


class BinMapper:
    """Maps raw feature values to dense bin codes.

    Attributes mirror the reference BinMapper (bin.h:55-195): ``num_bin``,
    ``bin_upper_bound`` (numerical) or ``bin_2_categorical`` /
    ``categorical_2_bin`` (categorical), ``default_bin`` (= bin of value 0),
    ``is_trivial``, ``sparse_rate``, ``min_val``/``max_val``.
    """

    def __init__(self) -> None:
        self.num_bin: int = 1
        self.bin_type: int = NUMERICAL
        self.is_trivial: bool = True
        self.sparse_rate: float = 0.0
        self.bin_upper_bound: np.ndarray = np.array([np.inf])
        self.bin_2_categorical: List[int] = []
        self.categorical_2_bin: Dict[int, int] = {}
        self.min_val: float = 0.0
        self.max_val: float = 0.0
        self.default_bin: int = 0
        # FindBin sample occupancy per bin (the drift fingerprint's
        # fallback, and the state round trip with the JAX mapper)
        self.bin_counts: Optional[np.ndarray] = None

    # ------------------------------------------------------------------
    def find_bin(self, sample_values: np.ndarray, total_sample_cnt: int,
                 max_bin: int, min_data_in_bin: int, min_split_data: int,
                 bin_type: int = NUMERICAL) -> "BinMapper":
        """Compute bin boundaries from sampled non-zero values.

        ``sample_values`` are the sampled non-zero values of the feature;
        zeros are implied: zero_cnt = total_sample_cnt - len(sample_values)
        (bin.cpp:75).
        """
        self.bin_type = bin_type
        self.default_bin = 0
        values = np.asarray(sample_values, dtype=np.float64)
        num_sample_values = len(values)
        zero_cnt = int(total_sample_cnt - num_sample_values)

        # Distinct values with zero spliced into sorted position, counting
        # the implied zeros (bin.cpp:77-110).  Vectorized via np.unique.
        uniq, ucnt = np.unique(values, return_counts=True)
        if zero_cnt > 0 or num_sample_values == 0:
            if 0.0 not in uniq:
                pos = int(np.searchsorted(uniq, 0.0))
                uniq = np.insert(uniq, pos, 0.0)
                ucnt = np.insert(ucnt, pos, zero_cnt)
        distinct_values = uniq.tolist()
        counts = ucnt.astype(np.int64).tolist()

        self.min_val = distinct_values[0]
        self.max_val = distinct_values[-1]
        num_distinct = len(distinct_values)
        cnt_in_bin: List[int] = []

        if bin_type == NUMERICAL:
            if num_distinct <= max_bin:
                # Distinct-value fast path (bin.cpp:116-131).
                bounds: List[float] = []
                cur_cnt = 0
                for i in range(num_distinct - 1):
                    cur_cnt += counts[i]
                    if cur_cnt >= min_data_in_bin:
                        bounds.append((distinct_values[i] + distinct_values[i + 1]) / 2.0)
                        cnt_in_bin.append(cur_cnt)
                        cur_cnt = 0
                cur_cnt += counts[-1]
                cnt_in_bin.append(cur_cnt)
                bounds.append(np.inf)
                self.bin_upper_bound = np.asarray(bounds, dtype=np.float64)
                self.num_bin = len(bounds)
            else:
                # Greedy equal-count path (bin.cpp:132-191).
                if min_data_in_bin > 0:
                    max_bin = max(1, min(max_bin, total_sample_cnt // min_data_in_bin))
                mean_bin_size = total_sample_cnt / max_bin
                if zero_cnt > mean_bin_size:
                    max_bin = min(max_bin, 1 + num_sample_values // max(1, min_data_in_bin))
                counts_arr = np.asarray(counts, dtype=np.int64)
                is_big = counts_arr >= mean_bin_size
                rest_bin_cnt = max_bin - int(is_big.sum())
                rest_sample_cnt = total_sample_cnt - int(counts_arr[is_big].sum())
                mean_bin_size = rest_sample_cnt / max(1, rest_bin_cnt)
                # Prefix sums for O(max_bin) skip-ahead instead of the
                # reference's O(num_distinct) scan: within one bin the
                # boundary test uses a constant mean_bin_size, so the next
                # boundary index is a searchsorted on cumulative counts.
                cum = np.cumsum(counts_arr)              # cum[i] = counts[0..i]
                small = np.where(is_big, 0, counts_arr)
                cum_small = np.cumsum(small)
                big_idx = np.nonzero(is_big)[0]
                upper_bounds = [np.inf] * max_bin
                lower_bounds = [np.inf] * max_bin
                bin_cnt = 0
                lower_bounds[0] = distinct_values[0]
                i_start = 0                               # first distinct idx of bin
                while i_start <= num_distinct - 2:
                    base = cum[i_start - 1] if i_start > 0 else 0
                    # candidate 1: cumulative count reaches mean_bin_size
                    j = int(np.searchsorted(cum, base + mean_bin_size, side="left"))
                    # candidate 2: a big-count value forces its own boundary
                    bpos = int(np.searchsorted(big_idx, i_start))
                    nb = int(big_idx[bpos]) if bpos < len(big_idx) else num_distinct
                    j = min(j, nb)
                    # candidate 3: value right before a big one closes early at
                    # half the mean size (bin.cpp:166-167)
                    if nb - 1 >= i_start and nb - 1 < j:
                        if cum[nb - 1] - base >= max(1.0, mean_bin_size * 0.5):
                            j = nb - 1
                    if j > num_distinct - 2:
                        break
                    cur_cnt = int(cum[j] - base)
                    upper_bounds[bin_cnt] = distinct_values[j]
                    cnt_in_bin.append(cur_cnt)
                    bin_cnt += 1
                    lower_bounds[bin_cnt] = distinct_values[j + 1]
                    if bin_cnt >= max_bin - 1:
                        break
                    # Non-big values consumed so far always come off
                    # rest_sample_cnt; the running mean is only re-derived at a
                    # non-big boundary (bin.cpp:161-177).
                    consumed = cum_small[j] - (cum_small[i_start - 1] if i_start > 0 else 0)
                    rest_sample_cnt -= int(consumed)
                    if not is_big[j]:
                        rest_bin_cnt -= 1
                        mean_bin_size = rest_sample_cnt / max(1, rest_bin_cnt)
                    i_start = j + 1
                # The rows in the loop after `break` (or the last distinct
                # value) land in the final bin (bin.cpp:180-182).
                remaining = total_sample_cnt - sum(cnt_in_bin)
                cnt_in_bin.append(remaining)
                bin_cnt += 1
                bounds = [np.inf] * bin_cnt
                for i in range(bin_cnt - 1):
                    bounds[i] = (upper_bounds[i] + lower_bounds[i + 1]) / 2.0
                self.bin_upper_bound = np.asarray(bounds, dtype=np.float64)
                self.num_bin = bin_cnt
        else:
            # Categorical: distinct ints sorted by count desc; keep the most
            # frequent until 98% coverage (bin.cpp:193-225).
            dv_int: List[int] = [int(distinct_values[0])]
            cnts_int: List[int] = [counts[0]]
            for i in range(1, num_distinct):
                iv = int(distinct_values[i])
                if iv != dv_int[-1]:
                    dv_int.append(iv)
                    cnts_int.append(counts[i])
                else:
                    cnts_int[-1] += counts[i]
            order = sorted(range(len(dv_int)), key=lambda i: (-cnts_int[i], dv_int[i]))
            dv_int = [dv_int[i] for i in order]
            cnts_int = [cnts_int[i] for i in order]
            cut_cnt = int(total_sample_cnt * 0.98)
            self.categorical_2_bin = {}
            self.bin_2_categorical = []
            self.num_bin = 0
            used_cnt = 0
            max_bin = min(len(dv_int), max_bin)
            while (used_cnt < cut_cnt or self.num_bin < max_bin) and self.num_bin < len(dv_int):
                cat = dv_int[self.num_bin]
                self.bin_2_categorical.append(cat)
                self.categorical_2_bin[cat] = self.num_bin
                used_cnt += cnts_int[self.num_bin]
                self.num_bin += 1
            cnt_in_bin = cnts_int[: self.num_bin]
            cnt_in_bin[-1] += total_sample_cnt - used_cnt

        # Trivial-feature detection (bin.cpp:227-236).
        self.is_trivial = self.num_bin <= 1
        if not self.is_trivial and _need_filter(
                cnt_in_bin, total_sample_cnt, min_split_data, bin_type):
            self.is_trivial = True
        if not self.is_trivial:
            self.default_bin = int(self.value_to_bin(0.0))
        self.sparse_rate = cnt_in_bin[self.default_bin] / max(1, total_sample_cnt)
        self.bin_counts = np.asarray(cnt_in_bin[: self.num_bin], np.int64)
        return self

    # ------------------------------------------------------------------
    def value_to_bin(self, values) -> np.ndarray:
        """Vectorized ValueToBin (bin.h:385-407)."""
        values = np.asarray(values, dtype=np.float64)
        scalar = values.ndim == 0
        values = np.atleast_1d(values)
        if self.bin_type == NUMERICAL:
            if values.size >= NATIVE_BIN_MIN:
                got = native.values_to_bins_native(
                    values, self.bin_upper_bound,
                    np.uint16 if self.num_bin > 256 else np.uint8)
                if got is not None:
                    bins = got.astype(np.int64)
                    return bins[0] if scalar else bins
            # First bound >= value.  NaN lands in bin 0 like the reference's
            # binary search (bin.h:385-407: `upper_bounds[m] < v` is false
            # for NaN) — searchsorted alone would put it in the last bin.
            bins = np.searchsorted(self.bin_upper_bound[:-1], values, side="left")
            bins = np.where(np.isnan(values), 0, bins)
        else:
            bins = np.full(values.shape, self.num_bin - 1, dtype=np.int64)
            ints = values.astype(np.int64)
            for cat, b in self.categorical_2_bin.items():
                bins[ints == cat] = b
        bins = bins.astype(np.int64)
        return bins[0] if scalar else bins

    def bin_to_value(self, bin_idx: int) -> float:
        if self.bin_type == NUMERICAL:
            return float(self.bin_upper_bound[bin_idx])
        return float(self.bin_2_categorical[bin_idx])

    # ------------------------------------------------------------------
    def feature_info(self) -> str:
        """The ``feature_infos`` model-file entry: ``[min:max]`` for numerical,
        colon-joined categories for categorical, ``none`` for trivial
        (mirrors dataset.cpp feature_infos serialization)."""
        if self.is_trivial:
            return "none"
        if self.bin_type == NUMERICAL:
            return f"[{self.min_val:g}:{self.max_val:g}]"
        return ":".join(str(c) for c in self.bin_2_categorical)

    def to_state(self) -> dict:
        return {
            "num_bin": self.num_bin,
            "bin_type": self.bin_type,
            "is_trivial": self.is_trivial,
            "sparse_rate": self.sparse_rate,
            "bin_upper_bound": self.bin_upper_bound.tolist(),
            "bin_2_categorical": list(self.bin_2_categorical),
            "min_val": self.min_val,
            "max_val": self.max_val,
            "default_bin": self.default_bin,
            "bin_counts": (self.bin_counts.tolist()
                           if self.bin_counts is not None else None),
        }

    @classmethod
    def from_state(cls, state: dict) -> "BinMapper":
        m = cls()
        m.num_bin = int(state["num_bin"])
        m.bin_type = int(state["bin_type"])
        m.is_trivial = bool(state["is_trivial"])
        m.sparse_rate = float(state["sparse_rate"])
        m.bin_upper_bound = np.asarray(state["bin_upper_bound"], dtype=np.float64)
        m.bin_2_categorical = [int(c) for c in state["bin_2_categorical"]]
        m.categorical_2_bin = {c: i for i, c in enumerate(m.bin_2_categorical)}
        m.min_val = float(state["min_val"])
        m.max_val = float(state["max_val"])
        m.default_bin = int(state["default_bin"])
        bc = state.get("bin_counts")
        m.bin_counts = np.asarray(bc, np.int64) if bc is not None else None
        return m
