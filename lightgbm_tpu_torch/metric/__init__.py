"""Evaluation metrics, on the host in float64.

Port of the JAX package's metric/__init__.py: the regression metrics
(``l2``, which reports the RMSE as the reference's L2Metric does, ``l1``,
``huber``, ``fair``, ``poisson``; regression_metric.hpp), the binary
ones (``binary_logloss``, ``binary_error``, ``auc``), the multiclass
ones (``multi_logloss``, ``multi_error``) and the ranking ones
(``ndcg@k`` and ``map@k`` over queries, with query weights), and
``create_metric``.  Metrics run once per evaluation on scores copied
from the card, in float64 like the reference's double accumulators.
``factor_to_bigger_better`` is +1 when bigger is better.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..io.dataset import Metadata
from ..objective import default_label_gain
from ..utils import log


class Metric:
    names: List[str] = []
    factor_to_bigger_better = -1.0

    def __init__(self, config=None):
        pass

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


class _PointwiseRegressionMetric(Metric):
    """CRTP RegressionMetric equivalent (regression_metric.hpp:16-93)."""

    def _loss(self, label, score):
        raise NotImplementedError

    def eval(self, score):
        loss = self._loss(self.label, score[0])
        if self.weights is not None:
            loss = loss * self.weights
        return [float(loss.sum() / self.sum_weights)]


class L2Metric(_PointwiseRegressionMetric):
    """Reports sqrt(MSE), the RMSE, as the reference's "l2" does
    (L2Metric::AverageLoss, regression_metric.hpp:103-106)."""
    names = ["l2"]

    def _loss(self, label, score):
        return (score - label) ** 2

    def eval(self, score):
        return [float(np.sqrt(super().eval(score)[0]))]


class L1Metric(_PointwiseRegressionMetric):
    names = ["l1"]

    def _loss(self, label, score):
        return np.abs(score - label)


class HuberLossMetric(_PointwiseRegressionMetric):
    names = ["huber"]

    def __init__(self, config):
        self.delta = float(config.huber_delta)

    def _loss(self, label, score):
        diff = score - label
        return np.where(np.abs(diff) <= self.delta,
                        0.5 * diff * diff,
                        self.delta * (np.abs(diff) - 0.5 * self.delta))


class FairLossMetric(_PointwiseRegressionMetric):
    names = ["fair"]

    def __init__(self, config):
        self.c = float(config.fair_c)

    def _loss(self, label, score):
        x = np.abs(score - label)
        c = self.c
        return c * x - c * c * np.log(1.0 + x / c)


class PoissonMetric(_PointwiseRegressionMetric):
    names = ["poisson"]

    def _loss(self, label, score):
        eps = 1e-10
        # the log of a score below eps is computed and then not taken
        with np.errstate(invalid="ignore", divide="ignore"):
            return np.where(score < eps, label * np.log(eps) - eps,
                            label * np.log(score) - score) * -1.0


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


class MultiLoglossMetric(Metric):
    """multiclass_metric.hpp:16-139."""
    names = ["multi_logloss"]

    def __init__(self, config):
        self.num_class = int(config.num_class)

    def eval(self, score):
        # score [K, N]
        p = np.exp(score - score.max(axis=0, keepdims=True))
        p = p / p.sum(axis=0, keepdims=True)
        idx = self.label.astype(np.int64)
        prob_true = np.clip(p[idx, np.arange(len(idx))], 1e-15, None)
        loss = -np.log(prob_true)
        if self.weights is not None:
            loss = loss * self.weights
        return [float(loss.sum() / self.sum_weights)]


class MultiErrorMetric(Metric):
    names = ["multi_error"]

    def __init__(self, config):
        self.num_class = int(config.num_class)

    def eval(self, score):
        pred = score.argmax(axis=0)
        err = (pred != self.label.astype(np.int64)).astype(np.float64)
        if self.weights is not None:
            err = err * self.weights
        return [float(err.sum() / self.sum_weights)]


class _RankMetricBase(Metric):
    factor_to_bigger_better = 1.0

    def __init__(self, config):
        self.eval_at = [int(k) for k in config.ndcg_eval_at] or [1, 2, 3, 4, 5]
        gains = list(config.label_gain) or default_label_gain()
        self.label_gain = np.asarray(gains, np.float64)

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if metadata.query_boundaries is None:
            log.fatal("%s metric requires query information", self.names[0])
        self.query_boundaries = np.asarray(metadata.query_boundaries, np.int64)
        self.num_queries = len(self.query_boundaries) - 1
        self.query_weights = metadata.query_weights
        self.sum_query_weights = (float(self.num_queries)
                                  if self.query_weights is None
                                  else float(self.query_weights.sum()))
        # queries bucketed by power-of-two size and evaluated a bucket
        # at a time (a loop over queries would be slow at MSLR scale);
        # peak memory <= 2N per bucket
        sizes = np.diff(self.query_boundaries)
        buckets = {}
        for q, sz in enumerate(sizes):
            L = 1
            while L < sz:
                L *= 2
            buckets.setdefault(L, []).append(q)
        self._buckets = [(L, np.asarray(qs, np.int64))
                         for L, qs in sorted(buckets.items())]
        self._sizes = sizes

    def _iter_buckets(self, s):
        """Yield (labels [nq, L], scores [nq, L], valid [nq, L], sizes
        [nq], qweights [nq]) per size bucket; pad scores are -inf so pads
        stably sort last."""
        for L, qs in self._buckets:
            starts = self.query_boundaries[qs]
            sz = self._sizes[qs]
            idx = starts[:, None] + np.arange(L)[None, :]
            valid = np.arange(L)[None, :] < sz[:, None]
            idx = np.where(valid, idx, starts[:, None])
            lbl = np.where(valid, self.label[idx], 0)
            sc = np.where(valid, s[idx], -np.inf)
            qw = (np.ones(len(qs)) if self.query_weights is None
                  else np.asarray(self.query_weights)[qs])
            yield lbl, sc, valid, sz, qw


class NDCGMetric(_RankMetricBase):
    """NDCG@k averaged over queries with query weights
    (rank_metric.hpp:16-169, dcg_calculator.cpp)."""

    names = ["ndcg"]

    def __init__(self, config):
        super().__init__(config)
        self.names = [f"ndcg@{k}" for k in self.eval_at]

    def eval(self, score):
        s = score[0]
        results = np.zeros(len(self.eval_at), np.float64)
        for lbl, sc, valid, sz, qw in self._iter_buckets(s):
            L = lbl.shape[1]
            lbl = lbl.astype(np.int64)
            disc = 1.0 / np.log2(np.arange(L) + 2.0)
            order = np.argsort(-sc, axis=1, kind="stable")
            gain_sorted = self.label_gain[
                np.take_along_axis(lbl, order, axis=1)]
            # pads carry label 0; gains can make label 0 nonzero, so mask
            # positions beyond each query's size explicitly
            pos_in = np.arange(L)[None, :] < sz[:, None]
            ideal_gain = self.label_gain[-np.sort(-lbl, axis=1)] * pos_in
            gain_sorted = gain_sorted * pos_in
            for i, k in enumerate(self.eval_at):
                topk = np.arange(L)[None, :] < k
                max_dcg = (ideal_gain * disc * topk).sum(axis=1)
                dcg = (gain_sorted * disc * topk).sum(axis=1)
                ndcg = np.where(max_dcg > 0.0, dcg / np.maximum(max_dcg,
                                                                1e-300), 1.0)
                results[i] += (ndcg * qw).sum()
        return [float(r / self.sum_query_weights) for r in results]


class MapMetric(_RankMetricBase):
    """MAP@k (map_metric.hpp:16-157)."""

    names = ["map"]

    def __init__(self, config):
        super().__init__(config)
        self.names = [f"map@{k}" for k in self.eval_at]

    def eval(self, score):
        s = score[0]
        results = np.zeros(len(self.eval_at), np.float64)
        for lbl, sc, valid, sz, qw in self._iter_buckets(s):
            L = lbl.shape[1]
            order = np.argsort(-sc, axis=1, kind="stable")
            rel = (np.take_along_axis(lbl, order, axis=1) > 0) \
                & (np.arange(L)[None, :] < sz[:, None])
            hits = np.cumsum(rel, axis=1)
            prec = hits / (np.arange(L)[None, :] + 1.0)
            for i, k in enumerate(self.eval_at):
                topk = np.arange(L)[None, :] < k
                num_hits = (rel * topk).sum(axis=1)
                ap_num = (prec * rel * topk).sum(axis=1)
                ap = np.where(num_hits > 0,
                              ap_num / np.maximum(num_hits, 1), 0.0)
                results[i] += (ap * qw).sum()
        return [float(r / self.sum_query_weights) for r in results]


_METRICS = {
    "l2": L2Metric,
    "l1": L1Metric,
    "huber": HuberLossMetric,
    "fair": FairLossMetric,
    "poisson": PoissonMetric,
    "binary_logloss": BinaryLoglossMetric,
    "binary_error": BinaryErrorMetric,
    "auc": AUCMetric,
    "multi_logloss": MultiLoglossMetric,
    "multi_error": MultiErrorMetric,
    "ndcg": NDCGMetric,
    "map": MapMetric,
}


def create_metric(name: str, config) -> Optional[Metric]:
    """Factory (metric.cpp:10-37); None for 'none'."""
    name = str(name).strip().lower()
    if name in ("", "none", "null", "na", "custom"):
        return None
    if name not in _METRICS:
        log.fatal("Unknown metric type name: %s", name)
    return _METRICS[name](config)
