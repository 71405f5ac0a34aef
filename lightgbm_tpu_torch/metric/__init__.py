"""Evaluation metrics, on the host in float64.

Port of the JAX package's metric/__init__.py for the binary slice:
``Metric``, ``BinaryLoglossMetric``, ``BinaryErrorMetric``, ``AUCMetric``
(reference binary_metric.hpp) and ``create_metric``.  Metrics run once
per evaluation on scores copied from the card, in float64 like the
reference's double accumulators.  ``factor_to_bigger_better`` is +1 when
bigger is better.  Other metrics raise "not ported yet".
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..io.dataset import Metadata
from ..utils import log


class Metric:
    names: List[str] = []
    factor_to_bigger_better = -1.0

    def init(self, metadata: Metadata, num_data: int) -> None:
        self.num_data = num_data
        self.label = np.asarray(metadata.label, np.float64)
        self.weights = (None if metadata.weights is None
                        else np.asarray(metadata.weights, np.float64))
        self.sum_weights = (float(num_data) if self.weights is None
                            else float(self.weights.sum()))

    def eval(self, score: np.ndarray) -> List[float]:
        """score: [K, N] class-major raw scores."""
        raise NotImplementedError


class BinaryLoglossMetric(Metric):
    """binary_metric.hpp:19-139 with the sigmoid transform."""
    names = ["binary_logloss"]

    def __init__(self, config):
        self.sigmoid = float(config.sigmoid)

    def eval(self, score):
        prob = 1.0 / (1.0 + np.exp(-self.sigmoid * score[0]))
        prob = np.clip(prob, 1e-15, 1.0 - 1e-15)
        loss = np.where(self.label > 0, -np.log(prob), -np.log(1.0 - prob))
        if self.weights is not None:
            loss = loss * self.weights
        return [float(loss.sum() / self.sum_weights)]


class BinaryErrorMetric(Metric):
    names = ["binary_error"]

    def __init__(self, config):
        self.sigmoid = float(config.sigmoid)

    def eval(self, score):
        err = ((score[0] > 0) != (self.label > 0)).astype(np.float64)
        if self.weights is not None:
            err = err * self.weights
        return [float(err.sum() / self.sum_weights)]


class AUCMetric(Metric):
    """Single-pass weighted AUC with tie handling
    (binary_metric.hpp:145-252)."""
    names = ["auc"]
    factor_to_bigger_better = 1.0

    def __init__(self, config=None):
        pass

    def eval(self, score):
        s = score[0]
        w = self.weights if self.weights is not None else np.ones_like(s)
        order = np.argsort(-s, kind="stable")
        lbl = self.label[order] > 0
        ws = w[order]
        pos = np.where(lbl, ws, 0.0)
        neg = np.where(~lbl, ws, 0.0)
        ss = s[order]
        new_group = np.empty(len(ss), bool)
        new_group[0] = True
        new_group[1:] = ss[1:] != ss[:-1]
        gid = np.cumsum(new_group) - 1
        ngroups = gid[-1] + 1
        pos_g = np.bincount(gid, weights=pos, minlength=ngroups)
        neg_g = np.bincount(gid, weights=neg, minlength=ngroups)
        sum_pos_before = np.cumsum(pos_g) - pos_g
        accum = float((neg_g * (pos_g * 0.5 + sum_pos_before)).sum())
        sum_pos = float(pos_g.sum())
        if sum_pos > 0.0 and sum_pos != self.sum_weights:
            return [accum / (sum_pos * (self.sum_weights - sum_pos))]
        return [1.0]


_METRICS = {
    "binary_logloss": BinaryLoglossMetric,
    "binary_error": BinaryErrorMetric,
    "auc": AUCMetric,
}


def create_metric(name: str, config) -> Optional[Metric]:
    """Factory (metric.cpp:10-37); None for 'none'."""
    name = str(name).strip().lower()
    if name in ("", "none", "null", "na", "custom"):
        return None
    if name not in _METRICS:
        log.fatal("metric %s is not ported yet to the torch package "
                  "(binary_logloss, binary_error and auc are)", name)
    return _METRICS[name](config)
