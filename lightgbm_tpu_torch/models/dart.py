"""DART: Dropouts meet Multiple Additive Regression Trees.

Port of the JAX package's models/dart.py (reference dart.hpp).  Each
round drops a random subset of the earlier rounds' trees (each by its
weight unless ``uniform_drop``; the whole drop skipped with probability
``skip_drop``; ``max_drop`` caps the drop rate), takes the gradients
against the scores without them, grows with shrinkage ``lr / (1 + k)``
for ``k`` dropped rounds (``lr / (lr + k)`` in ``xgboost_dart_mode``),
then scales the dropped trees by ``k / (k + 1)`` (``k / (k + lr)``) and
adds them back (Normalize, dart.hpp:84-178), with the reference's
``1 / (k + lr)`` subtraction from the weight sum in xgboost mode.  The
draws come from ``np.random.RandomState(drop_seed)`` in the JAX
package's order, so the drops equal the JAX package's.  A dropped tree
leaves and rejoins the scores through ``_add_host_tree_to``, negated and
scaled by ``Tree.scaled_copy`` as a rollback negates it.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..utils import log
from .gbdt import GBDT


class DART(GBDT):
    submodel_name = "dart"
    # the JAX DART booster materialises each round's trees at once
    _screen_observes_late = False

    def __init__(self, config=None, train_set=None, device=None):
        super().__init__(config, train_set, device)
        self.tree_weights: List[float] = []
        self.sum_weight = 0.0
        self.drop_index: List[int] = []
        if train_set is None:
            return
        self.drop_rate = config.drop_rate
        self.max_drop = config.max_drop
        self.skip_drop = config.skip_drop
        self.uniform_drop = config.uniform_drop
        self.xgboost_dart_mode = config.xgboost_dart_mode
        self._drop_rng = np.random.RandomState(config.drop_seed)
        self.shrinkage_rate = config.learning_rate

    def _select_dropping_trees(self) -> None:
        """DroppingTrees (dart.hpp:84-128): a Bernoulli draw a round;
        ``max_drop`` caps the drop rate, not the count."""
        self.drop_index = []
        lr = self.config.learning_rate
        num_iters = self.iter_
        if num_iters > 0 and not (self._drop_rng.uniform() < self.skip_drop):
            rate = self.drop_rate
            if not self.uniform_drop:
                inv_avg = num_iters / max(self.sum_weight, 1e-12)
                if self.max_drop > 0:
                    rate = min(rate, self.max_drop * inv_avg
                               / max(self.sum_weight, 1e-12))
                for i in range(num_iters):
                    if (self._drop_rng.uniform()
                            < rate * self.tree_weights[i] * inv_avg):
                        self.drop_index.append(i)
            else:
                if self.max_drop > 0:
                    rate = min(rate, self.max_drop / float(num_iters))
                for i in range(num_iters):
                    if self._drop_rng.uniform() < rate:
                        self.drop_index.append(i)
        k = len(self.drop_index)
        if not self.xgboost_dart_mode:
            self.shrinkage_rate = lr / (1.0 + k)
        else:
            self.shrinkage_rate = lr if k == 0 else lr / (lr + k)

    def _add_round(self, it: int, factor: float) -> None:
        """Add round ``it``'s trees scaled by ``factor`` to the training
        and valid scores."""
        for cls in range(self.num_class):
            tree = self.models[it * self.num_class + cls]
            if factor != 1.0:
                tree = tree.scaled_copy(factor)
            for dd in [self.train_data] + self.valid_data:
                self._add_host_tree_to(dd, tree, cls)

    def _apply_drop(self) -> None:
        """Subtract the dropped trees from every score."""
        for it in self.drop_index:
            self._add_round(it, -1.0)

    def _normalize(self) -> None:
        """Normalize (dart.hpp:139-178): each dropped tree scaled by
        ``k / (k + 1)`` (``k / (k + lr)`` in xgboost mode) in ``models``
        and added back at that scale; the weights follow the reference,
        its ``1 / (k + lr)`` subtraction included."""
        k = float(len(self.drop_index))
        lr = self.config.learning_rate
        if not self.xgboost_dart_mode:
            factor_dropped = k / (k + 1.0)
            weight_sub = 1.0 / (k + 1.0)
        else:
            factor_dropped = k / (k + lr)
            weight_sub = 1.0 / (k + lr)
        for it in self.drop_index:
            for cls in range(self.num_class):
                idx = it * self.num_class + cls
                self.models[idx] = self.models[idx].scaled_copy(
                    factor_dropped)
            self._add_round(it, 1.0)
            if not self.uniform_drop:
                self.sum_weight -= self.tree_weights[it] * weight_sub
                self.tree_weights[it] *= factor_dropped

    # -- snapshot / resume (snapshot.py) ---------------------------------
    def snapshot_state(self):
        state = super().snapshot_state()
        state["dart"] = {
            "tree_weights": list(self.tree_weights),
            "sum_weight": float(self.sum_weight),
            "drop_rng": self._drop_rng.get_state(),
        }
        return state

    def restore_state(self, state):
        super().restore_state(state)
        d = state.get("dart")
        if d is None:
            log.fatal("snapshot has no DART state; it was not taken from "
                      "a dart booster")
        self.tree_weights = list(d["tree_weights"])
        self.sum_weight = float(d["sum_weight"])
        self._drop_rng.set_state(d["drop_rng"])
        # drop_index is a round's scratch: snapshots fall between rounds
        self.drop_index = []

    def train_one_iter(self, grad=None, hess=None) -> bool:
        self._select_dropping_trees()
        self._apply_drop()
        stop = super().train_one_iter(grad, hess)
        if not stop:
            self.tree_weights.append(self.shrinkage_rate)
            self.sum_weight += self.shrinkage_rate
            self._normalize()
        else:
            # no tree grew: the dropped trees go back as they were
            for it in self.drop_index:
                self._add_round(it, 1.0)
        return stop
