"""``train`` and ``cv``: the boosting loops of the Python API.

Port of the JAX package's engine.py.  ``train`` builds a Booster on
``device`` (default ``cuda``), continues from ``init_model`` (a model
file or a Booster: its trees first, the training scores from its raw
predictions), attaches the valid sets, and runs one ``update()`` a round
between the callbacks (callback.py): ``reset_parameter`` before the
round (``learning_rates``), then ``print_evaluation`` (``verbose_eval``),
``record_evaluation`` (``evals_result``) and ``early_stopping``
(``early_stopping_rounds``), which stops the loop and sets the Booster's
``best_iteration``.  ``cv`` trains one Booster a fold (``CVBooster``) on
row subsets that share the full Dataset's mappers and aggregates their
valid metrics into means and standard deviations.  The JAX ``train``'s
snapshots, telemetry, compile cache, metrics port and watchdog are not
ported (their keys are ignored with one warning each), nor is
``train_delta``.
"""

from __future__ import annotations

import collections
from typing import List

import numpy as np

from . import callback
from .basic import Booster, Dataset
from .device import DeviceLike

_ROUND_ALIASES = ("num_boost_round", "num_iterations", "num_iteration",
                  "num_tree", "num_trees", "num_round", "num_rounds")


def _pop_rounds(params: dict, num_boost_round: int) -> int:
    """A round count in ``params`` (any alias) overrides the argument."""
    for alias in _ROUND_ALIASES:
        if alias in params:
            return int(params.pop(alias))
    return num_boost_round


def _order(cb) -> int:
    return getattr(cb, "order", 0)


def _split_callbacks(cbs):
    """(before the round, after it), each sorted by ``order``."""
    before = [cb for cb in cbs if getattr(cb, "before_iteration", False)]
    after = [cb for cb in cbs if cb not in before]
    return sorted(before, key=_order), sorted(after, key=_order)


def train(params, train_set: Dataset, num_boost_round: int = 100,
          valid_sets=None, valid_names=None, fobj=None, feval=None,
          init_model=None, feature_name="auto", categorical_feature="auto",
          early_stopping_rounds=None, evals_result=None, verbose_eval=True,
          learning_rates=None, callbacks=None,
          device: DeviceLike = None) -> Booster:
    """Train a GBDT; returns the Booster.

    ``valid_sets`` may include ``train_set`` itself (its metrics are then
    reported under its name in ``valid_names``).  A round count in
    ``params`` (``num_iterations`` and its aliases) overrides
    ``num_boost_round``.  ``fobj(preds, train_set) -> (grad, hess)`` and
    ``feval(preds, dataset) -> (name, value, bigger is better)`` are a
    custom objective and metric.  ``init_model`` (a model file's path or
    a Booster) continues its model: the rounds run from its iteration
    count on, and a constructed ``train_set`` must keep its raw data
    (``free_raw_data=False``).  ``verbose_eval`` is a bool or a logging
    period; ``learning_rates`` a list (one a round) or a function of the
    round; ``callbacks`` more callables of ``callback.CallbackEnv``.
    Training stops early when a tree cannot split."""
    params = dict(params or {})
    if fobj is not None:
        params["objective"] = "none"
    num_boost_round = _pop_rounds(params, num_boost_round)

    predictor = None
    if isinstance(init_model, str):
        predictor = Booster(model_file=init_model, device=device)
    elif isinstance(init_model, Booster):
        predictor = init_model._to_predictor()
    init_iteration = 0
    if predictor is not None:
        # every earlier round, those the predictor itself continued from
        init_iteration = len(predictor._booster.models) // max(
            predictor._booster.num_class, 1)

    if not isinstance(train_set, Dataset):
        raise TypeError("Training only accepts Dataset object")
    # the predictor first: on a constructed Dataset it unbinds it, and
    # the params then reach the new binning (the JAX package's order of
    # effects)
    train_set._set_predictor(predictor)._update_params(params) \
        .set_feature_name(feature_name) \
        .set_categorical_feature(categorical_feature)
    booster = Booster(params=params, train_set=train_set, device=device)
    if predictor is not None:
        gb = booster._booster
        gb.models = list(predictor._booster.models) + gb.models
        gb.num_init_iteration = init_iteration
        gb.iter_ = init_iteration

    with_train, train_name = False, "training"
    valid = []
    if isinstance(valid_sets, Dataset):
        valid_sets = [valid_sets]
    if isinstance(valid_names, str):
        valid_names = [valid_names]
    for i, vs in enumerate(valid_sets or []):
        if vs is train_set:
            with_train = True
            if valid_names is not None:
                train_name = valid_names[i]
            continue
        if not isinstance(vs, Dataset):
            raise TypeError("Validation data should be Dataset instance")
        valid.append((vs._update_params(params),
                      valid_names[i] if valid_names is not None
                      else f"valid_{i}"))
    booster.set_train_data_name(train_name)
    for vs, name in valid:
        booster.add_valid(vs, name)

    cbs = set(callbacks or [])
    if verbose_eval is True:
        cbs.add(callback.print_evaluation())
    elif isinstance(verbose_eval, int) and verbose_eval is not False:
        cbs.add(callback.print_evaluation(verbose_eval))
    if early_stopping_rounds is not None:
        cbs.add(callback.early_stopping(early_stopping_rounds,
                                        verbose=bool(verbose_eval)))
    if learning_rates is not None:
        cbs.add(callback.reset_parameter(learning_rate=learning_rates))
    if evals_result is not None:
        cbs.add(callback.record_evaluation(evals_result))
    before, after = _split_callbacks(cbs)

    end = init_iteration + num_boost_round
    for i in range(init_iteration, end):
        for cb in before:
            cb(callback.CallbackEnv(model=booster, params=params,
                                    iteration=i,
                                    begin_iteration=init_iteration,
                                    end_iteration=end,
                                    evaluation_result_list=None))
        finished = booster.update(fobj=fobj)
        results = booster.eval_train(feval) if with_train else []
        if valid:
            results += booster.eval_valid(feval)
        try:
            for cb in after:
                cb(callback.CallbackEnv(model=booster, params=params,
                                        iteration=i,
                                        begin_iteration=init_iteration,
                                        end_iteration=end,
                                        evaluation_result_list=results))
        except callback.EarlyStopException as e:
            booster.best_iteration = e.best_iteration + 1
            break
        if finished:
            break
    return booster


class CVBooster:
    """The fold Boosters of ``cv``: a method called on it is called on
    each fold and returns the list of their results."""

    def __init__(self):
        self.boosters: List[Booster] = []
        self.best_iteration = -1

    def append(self, booster: Booster) -> None:
        self.boosters.append(booster)

    def __getattr__(self, name):
        def handler_function(*args, **kwargs):
            return [getattr(b, name)(*args, **kwargs) for b in self.boosters]
        return handler_function


def _make_n_folds(full_data: Dataset, data_splitter, nfold, params, seed,
                  fpreproc=None, stratified=False, shuffle=True,
                  device: DeviceLike = None) -> CVBooster:
    """One Booster a fold, each with its valid rows attached as
    ``valid``.  The folds are ``data_splitter.split`` of the row indices,
    or from ``np.random.RandomState(seed)``: stratified by label class
    (each class's rows shuffled, then dealt round-robin), or a
    permutation dealt ``randidx[k::nfold]``; the same folds as the JAX
    package's, index for index."""
    full_data.construct()
    num_data = full_data.num_data()
    if data_splitter is not None:
        if not hasattr(data_splitter, "split"):
            raise AttributeError("data_splitter has no method 'split'")
        folds = data_splitter.split(np.arange(num_data))
    elif stratified:
        label = np.asarray(full_data.get_label())
        classes, y = np.unique(label, return_inverse=True)
        rng = np.random.RandomState(seed)
        fold_id = np.zeros(num_data, np.int64)
        for c in range(len(classes)):
            idx = np.where(y == c)[0]
            if shuffle:
                rng.shuffle(idx)
            fold_id[idx] = np.arange(len(idx)) % nfold
        folds = [(np.where(fold_id != k)[0], np.where(fold_id == k)[0])
                 for k in range(nfold)]
    else:
        if shuffle:
            randidx = np.random.RandomState(seed).permutation(num_data)
        else:
            randidx = np.arange(num_data)
        test_id = [randidx[i::nfold] for i in range(nfold)]
        folds = [(np.setdiff1d(randidx, test_id[k], assume_unique=False),
                  test_id[k]) for k in range(nfold)]

    ret = CVBooster()
    for train_idx, test_idx in folds:
        train_subset = full_data.subset(np.sort(train_idx))
        valid_subset = full_data.subset(np.sort(test_idx))
        if fpreproc is not None:
            train_subset, valid_subset, tparam = fpreproc(
                train_subset, valid_subset, params.copy())
        else:
            tparam = params
        fold = Booster(params=tparam, train_set=train_subset, device=device)
        fold.add_valid(valid_subset, "valid")
        ret.append(fold)
    return ret


def _agg_cv_result(raw_results):
    """[("cv_agg", "<data> <metric>", mean, bigger is better, stdv)] over
    the folds' evaluation lists."""
    cvmap = collections.OrderedDict()
    metric_type = {}
    for one_result in raw_results:
        for one_line in one_result:
            key = f"{one_line[0]} {one_line[1]}"
            metric_type[key] = one_line[3]
            cvmap.setdefault(key, []).append(one_line[2])
    return [("cv_agg", k, float(np.mean(v)), metric_type[k],
             float(np.std(v))) for k, v in cvmap.items()]


def cv(params, train_set: Dataset, num_boost_round: int = 10,
       data_splitter=None, nfold: int = 5, stratified: bool = False,
       shuffle: bool = True, metrics=None, fobj=None, feval=None,
       init_model=None, feature_name="auto", categorical_feature="auto",
       early_stopping_rounds=None, fpreproc=None, verbose_eval=None,
       show_stdv: bool = True, seed: int = 0, callbacks=None,
       device: DeviceLike = None) -> dict:
    """Cross-validation: ``{"<data> <metric>-mean": [one a round],
    "...-stdv": [...]}`` over ``nfold`` folds (``_make_n_folds``), cut
    to ``best_iteration`` rounds when ``early_stopping_rounds`` stops
    it.  ``init_model`` is accepted and unused, as in the JAX package."""
    if not isinstance(train_set, Dataset):
        raise TypeError("Training only accepts Dataset object")
    params = dict(params or {})
    if fobj is not None:
        params["objective"] = "none"
    num_boost_round = _pop_rounds(params, num_boost_round)
    if metrics is not None:
        params["metric"] = metrics
    train_set._update_params(params) \
        .set_feature_name(feature_name) \
        .set_categorical_feature(categorical_feature)

    results = collections.defaultdict(list)
    cvfolds = _make_n_folds(train_set, data_splitter, nfold, params, seed,
                            fpreproc=fpreproc, stratified=stratified,
                            shuffle=shuffle, device=device)

    cbs = set(callbacks or [])
    if early_stopping_rounds is not None:
        cbs.add(callback.early_stopping(early_stopping_rounds,
                                        verbose=False))
    if verbose_eval is True:
        cbs.add(callback.print_evaluation(show_stdv=show_stdv))
    elif isinstance(verbose_eval, int):
        cbs.add(callback.print_evaluation(verbose_eval, show_stdv=show_stdv))
    before, after = _split_callbacks(cbs)

    for i in range(num_boost_round):
        for cb in before:
            cb(callback.CallbackEnv(model=cvfolds, params=params,
                                    iteration=i, begin_iteration=0,
                                    end_iteration=num_boost_round,
                                    evaluation_result_list=None))
        for fold in cvfolds.boosters:
            fold.update(fobj=fobj)
        res = _agg_cv_result([fold.eval_valid(feval)
                              for fold in cvfolds.boosters])
        for _, key, mean, _, std in res:
            results[key + "-mean"].append(mean)
            results[key + "-stdv"].append(std)
        try:
            for cb in after:
                cb(callback.CallbackEnv(model=cvfolds, params=params,
                                        iteration=i, begin_iteration=0,
                                        end_iteration=num_boost_round,
                                        evaluation_result_list=res))
        except callback.EarlyStopException as e:
            cvfolds.best_iteration = e.best_iteration + 1
            for k in results:
                results[k] = results[k][:cvfolds.best_iteration]
            break
    return dict(results)
