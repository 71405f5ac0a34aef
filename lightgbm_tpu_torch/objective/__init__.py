"""Objective functions: gradients and hessians as torch ops.

Port of the JAX package's objective/__init__.py for the training slice:
the ``ObjectiveFunction`` base with its functional
``gradients_with(arrays, score)`` form, ``BinaryLogloss``
(reference binary_objective.hpp:13-120) and ``create_objective``.  The
per-dataset arrays (label, weights) travel in the ``arrays`` dict as
tensors on the training device; scalars live on the instance.  Score
layout is class-major ``[num_tree_per_iteration, N]`` f32.  Every other
objective raises "not ported yet".
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..io.dataset import Metadata
from ..utils import log


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

    @staticmethod
    def _apply_weight(arrays, grad, hess):
        w = arrays.get("weights")
        if w is None:
            return grad, hess
        return grad * w, hess * w

    def convert_output(self, score: np.ndarray) -> np.ndarray:
        return score


class BinaryLogloss(ObjectiveFunction):
    """label -> ±1; response = -l*sigma/(1+exp(l*sigma*s)); class-imbalance
    reweighting via is_unbalance / scale_pos_weight.  The same f32
    operations in the same order as the JAX version."""
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


_OBJECTIVES = {"binary": BinaryLogloss}


def create_objective(config) -> ObjectiveFunction:
    """Factory (objective_function.cpp:9-29), cut to the ported
    objectives."""
    name = config.objective
    if name not in _OBJECTIVES:
        log.fatal("objective=%s is not ported yet to the torch package "
                  "(binary is)", name)
    return _OBJECTIVES[name](config)
