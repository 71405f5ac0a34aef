"""scikit-learn estimators over the port's ``train`` and ``Booster``.

Port of the JAX package's sklearn.py (reference
python-package/lightgbm/sklearn.py): ``LGBMModel`` and its
``LGBMRegressor``, ``LGBMClassifier`` (labels encoded, ``num_class`` set
for more than two classes, ``predict_proba``) and ``LGBMRanker`` (query
groups).  A callable ``objective(y_true, y_pred[, group])`` becomes the
engine's ``fobj(preds, dataset)`` and a callable
``eval_metric(y_true, y_pred[, weight[, group]])`` its ``feval``.

``fit`` trains through ``engine.train`` (the leaf-histogram kernel on a
card) and ``predict`` / ``predict_proba`` / ``apply`` run the booster's
``predict`` (the forest-walk kernel).  ``device`` (default ``"cuda"``)
is a named parameter of every estimator, so it survives
``sklearn.base.clone`` (``GridSearchCV`` rebuilds estimators from
``get_params()``); it reaches ``train`` and never the parameter dict.
"""

from __future__ import annotations

import inspect
from typing import Any, Dict, Optional

import numpy as np

from .basic import Booster, Dataset
from .engine import train as _train
from .utils.log import LightGBMError

try:
    from sklearn.base import BaseEstimator as _SKBase
    from sklearn.base import ClassifierMixin as _SKClassifier
    from sklearn.base import RegressorMixin as _SKRegressor
    from sklearn.preprocessing import LabelEncoder as _LabelEncoder
    SKLEARN_INSTALLED = True
except ImportError:  # pragma: no cover - scikit-learn is optional
    SKLEARN_INSTALLED = False
    _SKBase = object

    class _SKClassifier:  # type: ignore
        pass

    class _SKRegressor:  # type: ignore
        pass

    class _LabelEncoder:  # type: ignore
        def fit(self, y):
            self.classes_ = np.unique(np.asarray(y))
            return self

        def transform(self, y):
            return np.searchsorted(self.classes_, np.asarray(y))

        def fit_transform(self, y):
            return self.fit(y).transform(y)


class _ObjectiveFunctionWrapper:
    """``func(y_true, y_pred[, group]) -> (grad, hess)`` as the engine's
    ``fobj(preds, dataset)``."""

    def __init__(self, func):
        self.func = func

    def __call__(self, preds, dataset):
        labels = np.asarray(dataset.get_label())
        argc = self.func.__code__.co_argcount
        if argc == 2:
            grad, hess = self.func(labels, preds)
        elif argc == 3:
            grad, hess = self.func(labels, preds, dataset.get_group())
        else:
            raise TypeError(f"Self-defined objective should have 2 or 3 "
                            f"arguments, got {argc}")
        return grad, hess


class _EvalFunctionWrapper:
    """``func(y_true, y_pred[, weight[, group]]) -> (name, value,
    is_higher_better)`` as the engine's ``feval(preds, dataset)``."""

    def __init__(self, func):
        self.func = func

    def __call__(self, preds, dataset):
        labels = np.asarray(dataset.get_label())
        argc = self.func.__code__.co_argcount
        if argc == 2:
            return self.func(labels, preds)
        if argc == 3:
            return self.func(labels, preds, dataset.get_weight())
        if argc == 4:
            return self.func(labels, preds, dataset.get_weight(),
                             dataset.get_group())
        raise TypeError(f"Self-defined eval function should have 2, 3 or 4 "
                        f"arguments, got {argc}")


class LGBMModel(_SKBase):
    """The scikit-learn interface of the port (reference sklearn.py:123);
    ``device`` is where ``fit`` trains and ``predict`` scores."""

    def __init__(self, boosting_type="gbdt", num_leaves=31, max_depth=-1,
                 learning_rate=0.1, n_estimators=10, max_bin=255,
                 subsample_for_bin=50000, objective="regression",
                 min_split_gain=0, min_child_weight=5, min_child_samples=10,
                 subsample=1, subsample_freq=1, colsample_bytree=1,
                 reg_alpha=0, reg_lambda=0, scale_pos_weight=1,
                 is_unbalance=False, seed=0, nthread=-1, silent=True,
                 sigmoid=1.0, huber_delta=1.0, gaussian_eta=1.0, fair_c=1.0,
                 poisson_max_delta_step=0.7,
                 max_position=20, label_gain=None,
                 drop_rate=0.1, skip_drop=0.5, max_drop=50,
                 uniform_drop=False, xgboost_dart_mode=False,
                 device="cuda"):
        self.boosting_type = boosting_type
        self.num_leaves = num_leaves
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.n_estimators = n_estimators
        self.max_bin = max_bin
        self.subsample_for_bin = subsample_for_bin
        self.objective = objective
        self.min_split_gain = min_split_gain
        self.min_child_weight = min_child_weight
        self.min_child_samples = min_child_samples
        self.subsample = subsample
        self.subsample_freq = subsample_freq
        self.colsample_bytree = colsample_bytree
        self.reg_alpha = reg_alpha
        self.reg_lambda = reg_lambda
        self.scale_pos_weight = scale_pos_weight
        self.is_unbalance = is_unbalance
        self.seed = seed
        self.nthread = nthread
        self.silent = silent
        self.sigmoid = sigmoid
        self.huber_delta = huber_delta
        self.gaussian_eta = gaussian_eta
        self.fair_c = fair_c
        self.poisson_max_delta_step = poisson_max_delta_step
        self.max_position = max_position
        self.label_gain = label_gain
        self.drop_rate = drop_rate
        self.skip_drop = skip_drop
        self.max_drop = max_drop
        self.uniform_drop = uniform_drop
        self.xgboost_dart_mode = xgboost_dart_mode
        self.device = device
        self._Booster: Optional[Booster] = None
        self._evals_result: Optional[dict] = None
        self._best_iteration = -1
        self._other_params: Dict[str, Any] = {}
        self.class_weight = None

    # sklearn plumbing ---------------------------------------------------
    def get_params(self, deep=True):
        params = super().get_params(deep=deep) if SKLEARN_INSTALLED else {
            k: getattr(self, k) for k in self._param_names()}
        params.update(self._other_params)
        return params

    @classmethod
    def _param_names(cls):
        # the named parameters, as scikit-learn reads them (a subclass's
        # **kwargs is not one)
        return [name for name, p in
                inspect.signature(cls.__init__).parameters.items()
                if name != "self" and p.kind not in (p.VAR_POSITIONAL,
                                                     p.VAR_KEYWORD)]

    def set_params(self, **params):
        for key, value in params.items():
            setattr(self, key, value)
            if not hasattr(type(self), key):
                self._other_params[key] = value
        return self

    def _params_for_engine(self) -> Dict[str, Any]:
        params = {
            "boosting_type": self.boosting_type,
            "objective": self.objective
            if not callable(self.objective) else "none",
            "num_leaves": self.num_leaves,
            "max_depth": self.max_depth,
            "learning_rate": self.learning_rate,
            "max_bin": self.max_bin,
            "bin_construct_sample_cnt": self.subsample_for_bin,
            "min_gain_to_split": self.min_split_gain,
            "min_sum_hessian_in_leaf": self.min_child_weight,
            "min_data_in_leaf": self.min_child_samples,
            "bagging_fraction": self.subsample,
            "bagging_freq": self.subsample_freq,
            "feature_fraction": self.colsample_bytree,
            "lambda_l1": self.reg_alpha,
            "lambda_l2": self.reg_lambda,
            "scale_pos_weight": self.scale_pos_weight,
            "is_unbalance": self.is_unbalance,
            "data_random_seed": self.seed,
            "verbosity": 0 if self.silent else 1,
            "sigmoid": self.sigmoid,
            "huber_delta": self.huber_delta,
            "gaussian_eta": self.gaussian_eta,
            "fair_c": self.fair_c,
            "poisson_max_delta_step": self.poisson_max_delta_step,
            "max_position": self.max_position,
            "drop_rate": self.drop_rate,
            "skip_drop": self.skip_drop,
            "max_drop": self.max_drop,
            "uniform_drop": self.uniform_drop,
            "xgboost_dart_mode": self.xgboost_dart_mode,
        }
        if self.label_gain is not None:
            params["label_gain"] = list(self.label_gain)
        params.update(self._other_params)
        # where the run goes is an argument of train, not a parameter
        params.pop("device", None)
        return params

    # fitting ------------------------------------------------------------
    def fit(self, X, y, sample_weight=None, init_score=None, group=None,
            eval_set=None, eval_sample_weight=None, eval_init_score=None,
            eval_group=None, eval_metric=None, early_stopping_rounds=None,
            verbose=True, feature_name="auto", categorical_feature="auto",
            callbacks=None):
        params = self._params_for_engine()
        fobj = (_ObjectiveFunctionWrapper(self.objective)
                if callable(self.objective) else None)
        feval = (_EvalFunctionWrapper(eval_metric)
                 if callable(eval_metric) else None)
        if eval_metric is not None and not callable(eval_metric):
            params["metric"] = eval_metric

        train_set = Dataset(X, label=y, weight=sample_weight,
                            group=group, params=params)
        if init_score is not None:
            train_set.set_init_score(init_score)

        valid_sets = []
        if eval_set is not None:
            if isinstance(eval_set, tuple):
                eval_set = [eval_set]
            for i, (vx, vy) in enumerate(eval_set):
                if vx is X and vy is y:
                    valid_sets.append(train_set)
                    continue
                vw = eval_sample_weight[i] if eval_sample_weight else None
                vg = eval_group[i] if eval_group else None
                vi = eval_init_score[i] if eval_init_score else None
                vs = train_set.create_valid(vx, vy, weight=vw, group=vg)
                if vi is not None:
                    vs.set_init_score(vi)
                valid_sets.append(vs)

        evals_result: Dict[str, Any] = {}
        self._Booster = _train(
            params, train_set, num_boost_round=self.n_estimators,
            valid_sets=valid_sets or None, fobj=fobj, feval=feval,
            early_stopping_rounds=early_stopping_rounds,
            evals_result=evals_result, verbose_eval=verbose,
            feature_name=feature_name,
            categorical_feature=categorical_feature, callbacks=callbacks,
            device=self.device)
        self._evals_result = evals_result or None
        self._best_iteration = self._Booster.best_iteration
        return self

    # prediction ---------------------------------------------------------
    def predict(self, X, raw_score=False, num_iteration=-1):
        if self._Booster is None:
            raise LightGBMError("Estimator not fitted, call fit first")
        return self._Booster.predict(X, raw_score=raw_score,
                                     num_iteration=num_iteration)

    def apply(self, X, num_iteration=-1):
        """Each row's leaf index in every tree."""
        if self._Booster is None:
            raise LightGBMError("Estimator not fitted, call fit first")
        return self._Booster.predict(X, pred_leaf=True,
                                     num_iteration=num_iteration)

    # accessors ----------------------------------------------------------
    @property
    def booster_(self) -> Booster:
        if self._Booster is None:
            raise LightGBMError("No booster found, call fit first")
        return self._Booster

    @property
    def best_iteration(self) -> int:
        return self._best_iteration

    @property
    def best_iteration_(self) -> int:
        """The scikit-learn spelling of ``best_iteration``."""
        return self._best_iteration

    @property
    def evals_result_(self):
        return self._evals_result

    @property
    def feature_importances_(self) -> np.ndarray:
        if self._Booster is None:
            raise LightGBMError("No booster found, call fit first")
        return self._Booster.feature_importance()

    @property
    def telemetry_(self) -> Dict[str, Any]:
        """The fitted booster's ``telemetry()``: the registry snapshot
        and its collective account."""
        return self.booster_.telemetry()


class LGBMRegressor(LGBMModel, _SKRegressor):

    def __init__(self, boosting_type="gbdt", num_leaves=31, max_depth=-1,
                 learning_rate=0.1, n_estimators=10, max_bin=255,
                 subsample_for_bin=50000, objective="regression",
                 device="cuda", **kwargs):
        super().__init__(boosting_type=boosting_type, num_leaves=num_leaves,
                         max_depth=max_depth, learning_rate=learning_rate,
                         n_estimators=n_estimators, max_bin=max_bin,
                         subsample_for_bin=subsample_for_bin,
                         objective=objective, device=device, **kwargs)


class LGBMClassifier(LGBMModel, _SKClassifier):

    def __init__(self, boosting_type="gbdt", num_leaves=31, max_depth=-1,
                 learning_rate=0.1, n_estimators=10, max_bin=255,
                 subsample_for_bin=50000, objective="binary",
                 device="cuda", **kwargs):
        super().__init__(boosting_type=boosting_type, num_leaves=num_leaves,
                         max_depth=max_depth, learning_rate=learning_rate,
                         n_estimators=n_estimators, max_bin=max_bin,
                         subsample_for_bin=subsample_for_bin,
                         objective=objective, device=device, **kwargs)

    def fit(self, X, y, **kwargs):
        self._le = _LabelEncoder().fit(y)
        y_enc = self._le.transform(y)
        self.classes_ = self._le.classes_
        self.n_classes_ = len(self.classes_)
        if self.n_classes_ > 2:
            if not callable(self.objective):
                self.objective = "multiclass"
            self._other_params["num_class"] = self.n_classes_
        eval_set = kwargs.get("eval_set")
        if eval_set is not None:
            if isinstance(eval_set, tuple):
                eval_set = [eval_set]
            kwargs["eval_set"] = [(vx, self._le.transform(vy))
                                  for vx, vy in eval_set]
        return super().fit(X, y_enc, **kwargs)

    def predict(self, X, raw_score=False, num_iteration=-1):
        probs = self.predict_proba(X, raw_score=raw_score,
                                   num_iteration=num_iteration)
        if raw_score:
            return probs
        if probs.ndim > 1:
            idx = np.argmax(probs, axis=1)
        else:
            idx = (probs > 0.5).astype(np.int64)
        return self._le.classes_[idx]

    def predict_proba(self, X, raw_score=False, num_iteration=-1):
        out = np.asarray(super().predict(X, raw_score=raw_score,
                                         num_iteration=num_iteration))
        if not raw_score and out.ndim == 1 and self.n_classes_ == 2:
            out = np.stack([1.0 - out, out], axis=1)
        return out


class LGBMRanker(LGBMModel):

    def __init__(self, boosting_type="gbdt", num_leaves=31, max_depth=-1,
                 learning_rate=0.1, n_estimators=10, max_bin=255,
                 subsample_for_bin=50000, objective="lambdarank",
                 device="cuda", **kwargs):
        super().__init__(boosting_type=boosting_type, num_leaves=num_leaves,
                         max_depth=max_depth, learning_rate=learning_rate,
                         n_estimators=n_estimators, max_bin=max_bin,
                         subsample_for_bin=subsample_for_bin,
                         objective=objective, device=device, **kwargs)

    def fit(self, X, y, group=None, **kwargs):
        if group is None:
            raise ValueError("Should set group for ranking task")
        eval_set = kwargs.get("eval_set")
        if eval_set is not None and kwargs.get("eval_group") is None:
            raise ValueError("Eval_group cannot be None when eval_set "
                             "is not None")
        return super().fit(X, y, group=group, **kwargs)
