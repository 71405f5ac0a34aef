"""``train``: the boosting loop of the Python API.

Port of the JAX package's engine.py ``train`` for the training slice: a
Booster on ``device`` (default ``cuda``), valid sets attached in order,
one ``update()`` per round, and per-round metric logging.  There are no
callbacks besides that logging; ``evals_result`` records the metric
history as the JAX ``record_evaluation`` callback does.
"""

from __future__ import annotations

import collections
from typing import Optional

from .basic import Booster, Dataset
from .device import DeviceLike
from .utils import log

_ROUND_ALIASES = ("num_boost_round", "num_iterations", "num_iteration",
                  "num_tree", "num_trees", "num_round", "num_rounds")


def train(params, train_set: Dataset, num_boost_round: int = 100,
          valid_sets=None, valid_names=None, device: DeviceLike = None,
          evals_result: Optional[dict] = None,
          verbose_eval: bool = True) -> Booster:
    """Train a binary GBDT; returns the Booster.

    ``valid_sets`` may include ``train_set`` itself (its metrics are then
    reported under the training name, as in the JAX package).  A round
    count in ``params`` (``num_iterations`` and its aliases) overrides
    ``num_boost_round``.  Training stops early when a tree cannot
    split."""
    params = dict(params or {})
    for alias in _ROUND_ALIASES:
        if alias in params:
            num_boost_round = int(params.pop(alias))
            break
    if not isinstance(train_set, Dataset):
        raise TypeError("Training only accepts Dataset object")
    booster = Booster(params=params, train_set=train_set, device=device)

    train_name, with_train = "training", False
    if isinstance(valid_sets, Dataset):
        valid_sets = [valid_sets]
    if isinstance(valid_names, str):
        valid_names = [valid_names]
    for i, vs in enumerate(valid_sets or []):
        name = valid_names[i] if valid_names is not None else f"valid_{i}"
        if vs is train_set:
            with_train, train_name = True, (
                valid_names[i] if valid_names is not None else train_name)
            continue
        if not isinstance(vs, Dataset):
            raise TypeError("Validation data should be Dataset instance")
        booster.add_valid(vs._update_params(params), name)
    if evals_result is not None:
        evals_result.clear()

    for i in range(num_boost_round):
        finished = booster.update()
        results = []
        if with_train:
            results += [(train_name,) + r[1:] for r in booster.eval_train()]
        results += booster.eval_valid()
        for data_name, metric, value, _ in results:
            if evals_result is not None:
                evals_result.setdefault(
                    data_name, collections.OrderedDict()).setdefault(
                    metric, []).append(value)
        if verbose_eval and results:
            log.info("[%d]\t%s", i + 1, "\t".join(
                f"{d}'s {m}: {v:g}" for d, m, v, _ in results))
        if finished:
            break
    return booster
