"""GOSS: Gradient-based One-Side Sampling.

Port of the JAX package's models/goss.py (reference goss.hpp).  Every
row whose ``|g * h|`` (summed over classes) ranks in the top
``top_rate`` is kept; of the others a random ``other_rate / (1 -
top_rate)`` is kept, their gradients and hessians amplified by ``(1 -
top_rate) / other_rate`` (goss.hpp:79-124).  The first
``int(1 / learning_rate)`` rounds do not sample (goss.hpp:129); bagging
with GOSS is refused when the Config is built.

Exactly ``top_cnt`` rows are kept on top: a stable argsort of
``-|g * h|`` ranks every row (ties by row index), as the JAX package
ranks them; the random keep compares the f32 uniforms of
``utils/random.uniform`` (a draw of the JAX package's padded row count,
of which the port keeps the first ``num_data``) with the keep
probability in f32.  The draw runs for an objective's gradients and for
a custom objective's alike (the reference's sampling is
objective-agnostic), on the gradients' device.
"""

from __future__ import annotations

import torch

from ..utils import log
from ..utils import random as jrandom
from .gbdt import GBDT


class GOSS(GBDT):
    submodel_name = "goss"
    _masks_before_gradients = False

    def __init__(self, config=None, train_set=None, device=None):
        super().__init__(config, train_set, device)
        if train_set is None:
            return
        self.top_rate = float(config.top_rate)
        self.other_rate = float(config.other_rate)
        if self.top_rate + self.other_rate >= 1.0:
            log.warning("top_rate + other_rate >= 1.0 in GOSS: no sampling")
        self._goss_key = jrandom.prng_key(config.bagging_seed)

    def _transform_gradients(self, grad, hess):
        warmup = int(1.0 / max(self.config.learning_rate, 1e-12))
        if self.iter_ < warmup:
            self._row_weight = self._ones_weight
            self._bag_cnt = self.num_data
            return grad, hess
        mask, grad, hess = self._sample(grad, hess)
        self._row_weight = mask
        top_cnt = int(self.top_rate * self.num_data)
        kept = top_cnt + int(self.other_rate * self.num_data)
        self._bag_cnt = kept if 0 < top_cnt and kept < self.num_data \
            else self.num_data
        return grad, hess

    def _bagging_mask(self, iter_: int) -> torch.Tensor:
        return self._row_weight

    def _sample(self, grad, hess):
        """(the 0/1 row mask, the amplified gradients and hessians) of
        one GOSS draw from [num_class, N] gradients."""
        n = self.num_data
        top_cnt = int(self.top_rate * n)
        other_cnt = int(self.other_rate * n)
        if top_cnt + other_cnt >= n or top_cnt == 0:
            return self._ones_weight, grad, hess
        score = torch.abs(grad[0] * hess[0])
        for k in range(1, grad.shape[0]):
            score = score + torch.abs(grad[k] * hess[k])
        order = torch.argsort(-score, stable=True)
        rank = torch.empty(n, dtype=torch.int64, device=grad.device)
        rank[order] = torch.arange(n, dtype=torch.int64, device=grad.device)
        self._goss_key, sub = jrandom.split(self._goss_key)
        rand = jrandom.uniform(sub, self._padded_rows, grad.device)[:n]
        keep_prob = torch.tensor(
            self.other_rate / max(1e-12, 1.0 - self.top_rate),
            dtype=torch.float32, device=grad.device)
        is_top = rank < top_cnt
        is_other_kept = ~is_top & (rand < keep_prob)
        mask = (is_top | is_other_kept).to(torch.float32)
        amp = torch.tensor((1.0 - self.top_rate) / max(self.other_rate, 1e-12),
                           dtype=torch.float32, device=grad.device)
        factor = torch.where(is_other_kept, amp, torch.ones_like(amp))
        return mask, grad * factor[None, :], hess * factor[None, :]
