"""Gain-informed feature screening (EMA-FS).

Port of the JAX package's models/screening.py.  Most features stop
earning splits after the early rounds, yet every round pays their
histogram pass.  The screener keeps an exponentially weighted moving
average of each feature's realised split gains and masks the columns
whose best member ranks in the bottom ``feature_screen_ratio`` out of a
round's feature masks.

Schedule: ``feature_screen_warmup`` unscreened rounds seed the average;
after them every ``feature_screen_refresh``-th round is a refresh round
over all features (a dormant feature can come back), and the rounds in
between are screened.  The active set is drawn once a refresh period;
the average is updated every round.

Screening is column-granular, so it composes with EFB bundles: a column
stays active while any of its features does.  ``GBDT`` gathers the
active columns into a compacted view that the histogram kernels run
over (``models/gbdt.py`` ``_build_active_view``).  ``state`` /
``restore`` carry the averages and the refresh count through a snapshot
(``snapshot.py``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np


class GainScreener:
    """Per-feature split-gain EWMA and the screening schedule."""

    def __init__(self, num_features: int, num_columns: int,
                 feature_col: np.ndarray, *, ratio: float, refresh: int,
                 warmup: int, decay: float):
        self.num_features = int(num_features)
        self.num_columns = int(num_columns)
        self.feature_col = np.asarray(feature_col, np.int64)
        self.ratio = float(ratio)
        self.refresh = max(int(refresh), 1)
        self.warmup = max(int(warmup), 0)
        self.decay = float(decay)
        self.keep_cols = max(
            1, int(math.ceil((1.0 - self.ratio) * self.num_columns)))
        self.ewma = np.zeros(self.num_features, np.float64)
        self._round_gain = np.zeros(self.num_features, np.float64)
        self.refresh_total = 0

    def observe_trees(self, trees) -> None:
        """Fold one round's trees into the average.  Split features are
        read in inner (used-feature) space (``Tree.split_feature_inner``)."""
        acc = self._round_gain
        for t in trees:
            n = int(t.num_leaves) - 1
            if n <= 0:
                continue
            feats = np.asarray(t.split_feature_inner[:n], np.int64)
            gains = np.maximum(np.asarray(t.split_gain[:n], np.float64), 0.0)
            ok = (feats >= 0) & (feats < self.num_features)
            np.add.at(acc, feats[ok], gains[ok])
        self.ewma = self.decay * self.ewma + (1.0 - self.decay) * acc
        acc[:] = 0.0

    def round_mode(self, it: int) -> str:
        """'warmup' | 'refresh' | 'screened' for 0-based round ``it``."""
        if it < self.warmup:
            return "warmup"
        if (it - self.warmup) % self.refresh == 0:
            return "refresh"
        return "screened"

    def period(self, it: int) -> int:
        """Refresh-period index; the active set is drawn again when it
        changes."""
        return max(it - self.warmup, 0) // self.refresh

    def active_columns(self) -> np.ndarray:
        """The ``keep_cols`` columns of the largest member average,
        ascending; ties prefer the lower column index."""
        score = np.full(self.num_columns, -np.inf)
        np.maximum.at(score, self.feature_col, self.ewma)
        order = np.lexsort((np.arange(self.num_columns), -score))
        return np.sort(order[:self.keep_cols]).astype(np.int64)

    def screen_mask(self, active_cols: np.ndarray) -> np.ndarray:
        """[F] bool: the feature's column is active."""
        keep = np.zeros(self.num_columns, bool)
        keep[np.asarray(active_cols, np.int64)] = True
        return keep[self.feature_col]

    # -- snapshot / resume (snapshot.py) ---------------------------------
    def state(self) -> Dict:
        return {"ewma": self.ewma.copy(),
                "refresh_total": int(self.refresh_total)}

    def restore(self, state: Optional[Dict]) -> None:
        if not state:
            return
        saved = np.asarray(state.get("ewma", ()), np.float64)
        if saved.shape == self.ewma.shape:
            self.ewma = saved.copy()
        self.refresh_total = int(state.get("refresh_total", 0))
