"""Objective functions: gradients and hessians as torch ops.

Port of the JAX package's objective/__init__.py: the
``ObjectiveFunction`` base with its functional
``gradients_with(arrays, score)`` form, the regression losses (L2, L1,
Huber, Fair, Poisson; reference regression_objective.hpp), binary
log-loss, multiclass softmax, LambdaRank with NDCG weighting, the
``none`` placeholder of a custom objective, and ``create_objective``.
The per-dataset arrays (labels, weights, LambdaRank's query tables)
travel in the ``arrays`` dict as tensors on the training device; scalars
live on the instance.  Each objective runs the JAX version's f32
operations in the same order.  Score layout is class-major
``[num_tree_per_iteration, N]`` f32.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..io.dataset import Metadata
from ..utils import log

# sqrt(2 pi) rounded as the JAX version computes it: an f32 square root
# of the f32 constant
_SQRT_2PI = float(np.sqrt(np.float32(2 * np.pi)))


class ObjectiveFunction:
    """Base: subclasses define the gradient math over score [K, N]."""

    name = "none"
    num_tree_per_iteration = 1
    sigmoid = -1.0

    def init(self, metadata: Metadata, num_data: int) -> None:
        self.num_data = num_data
        self.label = np.asarray(metadata.label, np.float32)
        self.weights = (None if metadata.weights is None
                        else np.asarray(metadata.weights, np.float32))

    def gradient_arrays(self, device: torch.device) -> Dict[str,
                                                           Optional[torch.Tensor]]:
        """The per-dataset arrays ``gradients_with`` reads, on ``device``."""
        return {"label": torch.from_numpy(self.label).to(device),
                "weights": (None if self.weights is None
                            else torch.from_numpy(self.weights).to(device))}

    def gradients_with(self, arrays, score: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def gradients(self, score: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``gradients_with`` over this objective's own arrays, on the
        score's device."""
        return self.gradients_with(self.gradient_arrays(score.device), score)

    @staticmethod
    def _apply_weight(arrays, grad, hess):
        w = arrays.get("weights")
        if w is None:
            return grad, hess
        return grad * w, hess * w

    def convert_output(self, score: np.ndarray) -> np.ndarray:
        """Raw score -> prediction transform (GBDT::Predict,
        gbdt.cpp:799-815)."""
        return score

    def boost_from_average(self) -> float:
        return 0.0


class RegressionL2Loss(ObjectiveFunction):
    """g = score - label, h = 1 (regression_objective.hpp:25-53)."""
    name = "regression"

    def __init__(self, config=None):
        pass

    def gradients_with(self, arrays, score):
        g = score[0] - arrays["label"]
        h = torch.ones_like(g)
        g, h = self._apply_weight(arrays, g, h)
        return g[None], h[None]


def _gaussian_hessian(score, label, grad, eta: float, weight):
    """Common::ApproximateHessianWithGaussian (common.h:416-425)."""
    diff = score - label
    x = torch.abs(diff)
    a = 2.0 * torch.abs(grad) * weight
    c = torch.clamp_min((torch.abs(score) + torch.abs(label)) * eta, 1.0e-10)
    return weight * torch.exp(-x * x / (2.0 * c * c)) * a / (c * _SQRT_2PI)


def _weights_or_ones(arrays, s):
    w = arrays["weights"]
    return w if w is not None else torch.ones_like(s)


class RegressionL1Loss(ObjectiveFunction):
    """g = ±weight, h = the Gaussian approximation
    (regression_objective.hpp:58-113)."""
    name = "regression_l1"

    def __init__(self, config):
        self.eta = float(config.gaussian_eta)

    def gradients_with(self, arrays, score):
        s = score[0]
        label = arrays["label"]
        w = _weights_or_ones(arrays, s)
        g = torch.where(s - label >= 0.0, w, -w)
        h = _gaussian_hessian(s, label, g, self.eta, w)
        return g[None], h[None]


class RegressionHuberLoss(ObjectiveFunction):
    """L2 within ``huber_delta``, a clipped gradient and the Gaussian
    hessian outside (regression_objective.hpp:115-180)."""
    name = "huber"

    def __init__(self, config):
        self.delta = float(config.huber_delta)
        self.eta = float(config.gaussian_eta)

    def gradients_with(self, arrays, score):
        s = score[0]
        label = arrays["label"]
        w = _weights_or_ones(arrays, s)
        diff = s - label
        inside = torch.abs(diff) <= self.delta
        g_out = torch.where(diff >= 0.0, self.delta * w, -self.delta * w)
        g = torch.where(inside, diff * w, g_out)
        h = torch.where(inside, w,
                        _gaussian_hessian(s, label, g_out, self.eta, w))
        return g[None], h[None]


class RegressionFairLoss(ObjectiveFunction):
    """g = c x / (|x| + c), h = c^2 / (|x| + c)^2
    (regression_objective.hpp:182-235)."""
    name = "fair"

    def __init__(self, config):
        self.c = float(config.fair_c)

    def gradients_with(self, arrays, score):
        x = score[0] - arrays["label"]
        c = self.c
        g = c * x / (torch.abs(x) + c)
        h = c * c / ((torch.abs(x) + c) ** 2)
        g, h = self._apply_weight(arrays, g, h)
        return g[None], h[None]


class RegressionPoissonLoss(ObjectiveFunction):
    """g = score - label, h = score + ``poisson_max_delta_step``
    (regression_objective.hpp:237-289 at the pinned reference)."""
    name = "poisson"

    def __init__(self, config):
        self.max_delta_step = float(config.poisson_max_delta_step)

    def gradients_with(self, arrays, score):
        s = score[0]
        g = s - arrays["label"]
        h = s + self.max_delta_step
        g, h = self._apply_weight(arrays, g, h)
        return g[None], h[None]


class BinaryLogloss(ObjectiveFunction):
    """label -> ±1; response = -l*sigma/(1+exp(l*sigma*s)); class-imbalance
    reweighting via is_unbalance / scale_pos_weight
    (binary_objective.hpp:13-120)."""
    name = "binary"

    def __init__(self, config):
        self.sigmoid = float(config.sigmoid)
        self.is_unbalance = bool(config.is_unbalance)
        self.scale_pos_weight = float(config.scale_pos_weight)

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        cnt_pos = int((self.label > 0).sum())
        cnt_neg = int(num_data - cnt_pos)
        log.info("Number of positive: %d, number of negative: %d",
                 cnt_pos, cnt_neg)
        if cnt_pos == 0 or cnt_neg == 0:
            log.fatal("Training data only contains one class")
        w_neg, w_pos = 1.0, 1.0
        if self.is_unbalance:
            if cnt_pos > cnt_neg:
                w_neg = cnt_pos / cnt_neg
            else:
                w_pos = cnt_neg / cnt_pos
        w_pos *= self.scale_pos_weight
        self.label_weight_pos = w_pos
        self.label_weight_neg = w_neg

    def gradients_with(self, arrays, score):
        s = score[0]
        is_pos = arrays["label"] > 0
        one = torch.ones_like(s)
        lbl = torch.where(is_pos, one, -one)
        lw = torch.where(is_pos, one * self.label_weight_pos,
                         one * self.label_weight_neg)
        sig = self.sigmoid
        response = -lbl * sig / (1.0 + torch.exp(lbl * sig * s))
        abs_resp = torch.abs(response)
        g = response * lw
        h = abs_resp * (sig - abs_resp) * lw
        g, h = self._apply_weight(arrays, g, h)
        return g[None], h[None]

    def convert_output(self, score):
        return 1.0 / (1.0 + np.exp(-self.sigmoid * score))


class MulticlassLogloss(ObjectiveFunction):
    """Softmax over the class-major scores; g = p - 1{y=k}, h = 2p(1-p),
    times the class weight of ``is_unbalance`` on the true class
    (multiclass_objective.hpp:13-120)."""
    name = "multiclass"

    def __init__(self, config):
        self.num_class = int(config.num_class)
        self.num_tree_per_iteration = self.num_class
        self.is_unbalance = bool(config.is_unbalance)

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        label_int = self.label.astype(np.int32)
        if label_int.min() < 0 or label_int.max() >= self.num_class:
            log.fatal("Label must be in [0, %d)", self.num_class)
        self.label_int = label_int
        pos_w = np.ones(self.num_class, np.float32)
        if self.is_unbalance:
            cnts = np.bincount(label_int, minlength=self.num_class)
            pos_w = ((num_data - cnts)
                     / np.maximum(cnts, 1)).astype(np.float32)
        self.label_pos_weights = pos_w

    def gradient_arrays(self, device):
        arrays = super().gradient_arrays(device)
        arrays["label_int"] = torch.from_numpy(self.label_int).to(device)
        arrays["label_pos_weights"] = torch.from_numpy(
            self.label_pos_weights).to(device)
        return arrays

    def gradients_with(self, arrays, score):
        e = torch.exp(score - score.max(dim=0, keepdim=True).values)
        p = e / e.sum(dim=0, keepdim=True)
        onehot = (torch.arange(self.num_class, dtype=torch.int32,
                               device=score.device)[:, None]
                  == arrays["label_int"][None, :])
        pw = arrays["label_pos_weights"][:, None]
        two_p_q = 2.0 * p * (1.0 - p)
        g = torch.where(onehot, (p - 1.0) * pw, p)
        h = torch.where(onehot, two_p_q * pw, two_p_q)
        weights = arrays["weights"]
        if weights is not None:
            g = g * weights[None, :]
            h = h * weights[None, :]
        return g, h

    def convert_output(self, score):
        e = np.exp(score - score.max(axis=0, keepdims=True))
        return e / e.sum(axis=0, keepdims=True)


def default_label_gain(size: int = 31):
    """2^i - 1 (config.cpp label_gain default)."""
    return [float((1 << i) - 1) for i in range(size)]


def pad_class(n: int) -> int:
    """The padded size of a query of ``n`` documents: the next power of
    two, at least 16."""
    p = 16
    while p < n:
        p *= 2
    return p


#: a block of queries of padded size P holds PAIR_BLOCK // P queries, so
#: its [block, P, P] pair matrices hold PAIR_BLOCK * P entries
PAIR_BLOCK = 65536


class LambdarankNDCG(ObjectiveFunction):
    """Per-query pairwise LambdaRank with NDCG weighting
    (rank_objective.hpp:19-228), in the JAX package's formulation:
    queries are bucketed by padded size (``pad_class``), and each bucket
    is processed in blocks of ``PAIR_BLOCK // P`` queries, each query's
    [P, P] pair matrix masked to its documents.  The documents of a
    query are sorted by score, descending and stable, with the pads at
    -inf so that they sink last; the exact sigmoid 2/(1+exp(2 sigma d))
    stands for the reference's lookup table.  The discounts and each
    query's inverse max DCG are computed in f64 on the host and cast to
    f32.  Each row's lambda is written once: the scatter back to rows
    goes over the valid documents only, whose row indices are unique."""
    name = "lambdarank"

    def __init__(self, config):
        self.sigmoid = float(config.sigmoid)
        if self.sigmoid <= 0:
            log.fatal("Sigmoid param %f should be greater than zero",
                      self.sigmoid)
        gains = list(config.label_gain) or default_label_gain()
        self.label_gain = np.asarray(gains, np.float64)
        self.optimize_pos_at = int(config.max_position)

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if metadata.query_boundaries is None:
            log.fatal("Lambdarank tasks require query information")
        qb = np.asarray(metadata.query_boundaries, np.int64)
        self.num_queries = len(qb) - 1
        sizes = np.diff(qb)
        label = self.label
        disc_len = pad_class(int(sizes.max()))
        discounts = 1.0 / np.log2(np.arange(disc_len) + 2.0)
        self.discounts = discounts.astype(np.float32)
        buckets: Dict[int, list] = {}
        for q in range(self.num_queries):
            buckets.setdefault(pad_class(int(sizes[q])), []).append(q)
        self.query_classes = []
        for P, qlist in sorted(buckets.items()):
            Qc = len(qlist)
            doc_idx = np.zeros((Qc, P), np.int64)
            doc_valid = np.zeros((Qc, P), bool)
            inv_max_dcg = np.zeros(Qc, np.float64)
            for i, q in enumerate(qlist):
                cnt = int(sizes[q])
                doc_idx[i, :cnt] = np.arange(qb[q], qb[q + 1])
                doc_valid[i, :cnt] = True
                # inverse max DCG of the query (rank_objective.hpp:54-64)
                lbl = np.sort(label[qb[q]:qb[q + 1]])[::-1]
                k = min(self.optimize_pos_at, cnt)
                dcg = (self.label_gain[lbl[:k].astype(int)]
                       * discounts[:k]).sum()
                inv_max_dcg[i] = 1.0 / dcg if dcg > 0 else 0.0
            padded_label = np.where(doc_valid, label[doc_idx], 0)
            self.query_classes.append({
                "doc_idx": doc_idx, "doc_valid": doc_valid,
                "label": padded_label.astype(np.int64),
                "inv_max_dcg": inv_max_dcg.astype(np.float32)})

    def gradient_arrays(self, device):
        arrays = super().gradient_arrays(device)
        arrays["discounts"] = torch.from_numpy(self.discounts).to(device)
        arrays["label_gain"] = torch.from_numpy(
            self.label_gain.astype(np.float32)).to(device)
        arrays["classes"] = tuple(
            {k: torch.from_numpy(v).to(device) for k, v in cls.items()}
            for cls in self.query_classes)
        return arrays

    def gradients_with(self, arrays, score):
        s = score[0]
        g = torch.zeros_like(s)
        h = torch.zeros_like(s)
        for cls in arrays["classes"]:
            P = cls["doc_idx"].shape[1]
            block = max(1, PAIR_BLOCK // P)
            for q0 in range(0, cls["doc_idx"].shape[0], block):
                part = {k: v[q0:q0 + block] for k, v in cls.items()}
                g_q, h_q = self._block_gradients(arrays, s, part)
                valid = part["doc_valid"]
                rows = part["doc_idx"][valid]
                g.index_add_(0, rows, g_q[valid])
                h.index_add_(0, rows, h_q[valid])
        g, h = self._apply_weight(arrays, g, h)
        return g[None], h[None]

    def _block_gradients(self, arrays, s, part):
        """[b, P] lambdas and hessians of a block of queries, in each
        query's document order."""
        doc_idx, valid = part["doc_idx"], part["doc_valid"]
        P = doc_idx.shape[1]
        sc = torch.where(valid, s[doc_idx],
                         torch.full_like(s[doc_idx], -float("inf")))
        order = torch.argsort(-sc, dim=1, stable=True)
        sc_sorted = sc.gather(1, order)
        lbl_sorted = part["label"].gather(1, order)
        valid_sorted = valid.gather(1, order)
        gain_sorted = arrays["label_gain"][lbl_sorted]
        disc = arrays["discounts"][:P]
        n_valid = valid.sum(dim=1)
        best = sc_sorted[:, 0]
        worst = sc_sorted.gather(
            1, (n_valid - 1).clamp(min=0)[:, None])[:, 0]
        # pairs [i = high, j = low] in sorted positions
        delta = sc_sorted[:, :, None] - sc_sorted[:, None, :]
        dcg_gap = gain_sorted[:, :, None] - gain_sorted[:, None, :]
        paired_disc = torch.abs(disc[:, None] - disc[None, :])
        delta_ndcg = (dcg_gap * paired_disc
                      * part["inv_max_dcg"][:, None, None])
        norm = torch.where((best != worst)[:, None, None],
                           0.01 + torch.abs(delta),
                           torch.ones_like(delta))
        delta_ndcg = delta_ndcg / norm
        p = 2.0 / (1.0 + torch.exp(2.0 * delta * self.sigmoid))
        lam = -p * delta_ndcg
        hes = p * (2.0 - p) * 2.0 * delta_ndcg
        pair_ok = ((lbl_sorted[:, :, None] > lbl_sorted[:, None, :])
                   & valid_sorted[:, :, None] & valid_sorted[:, None, :])
        zero = torch.zeros_like(lam)
        lam = torch.where(pair_ok, lam, zero)
        hes = torch.where(pair_ok, hes, zero)
        g_sorted = lam.sum(dim=2) - lam.sum(dim=1)
        h_sorted = hes.sum(dim=2) + hes.sum(dim=1)
        # back from sorted positions to the query's document order
        g_q = torch.zeros_like(g_sorted).scatter_(1, order, g_sorted)
        h_q = torch.zeros_like(h_sorted).scatter_(1, order, h_sorted)
        return g_q, h_q


class NoneObjective(ObjectiveFunction):
    """The objective of a custom ``fobj``: the gradients come from the
    callback (``Booster.update(fobj=...)``); this carries only
    ``num_tree_per_iteration`` and the identity transform (the reference
    trains with a NULL objective, c_api.h:372-388)."""
    name = "none"

    def __init__(self, config=None):
        self.num_class = int(getattr(config, "num_class", 1) or 1)
        self.num_tree_per_iteration = max(self.num_class, 1)

    def init(self, metadata, num_data):
        self.num_data = num_data

    def gradient_arrays(self, device):
        return {}

    def gradients_with(self, arrays, score):
        raise RuntimeError("objective=none requires a custom fobj passed "
                           "to train()/update()")

    def convert_output(self, score):
        return score


_OBJECTIVES = {
    "regression": RegressionL2Loss,
    "regression_l1": RegressionL1Loss,
    "huber": RegressionHuberLoss,
    "fair": RegressionFairLoss,
    "poisson": RegressionPoissonLoss,
    "binary": BinaryLogloss,
    "multiclass": MulticlassLogloss,
    "lambdarank": LambdarankNDCG,
    "none": NoneObjective,
}


def create_objective(config) -> ObjectiveFunction:
    """Factory (objective_function.cpp:9-29)."""
    name = config.objective
    if name not in _OBJECTIVES:
        log.fatal("Unknown objective type name: %s", name)
    return _OBJECTIVES[name](config)
