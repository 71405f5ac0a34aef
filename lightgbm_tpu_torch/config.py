"""Parameter surface of the port: defaults, aliases, coercion.

The JAX package's config.py holds every training and serving key, with
the same aliases as here, so a conf file written for the JAX CLI runs
here unchanged.  Every key of the JAX package's defaults lands in
exactly one of three tables (pinned by a test):

* :data:`_DEFAULTS` less :data:`REFUSED`: the keys the port reads, with
  the JAX names, defaults and coercion;
* :data:`REFUSED`: keys whose value away from the JAX default would
  change a tree, a prediction, a file the run writes or the run's
  outcome, and which the port has not ported: such a value raises a
  ``LightGBMError`` naming the key when the ``Config`` is built (under
  the key's aliases too);
* :data:`INERT`: keys that cannot change a tree, a prediction or the
  run's outcome (thread counts, the serving fleet's knobs, telemetry,
  compile caches, and the keys only the refused features read): each
  is accepted with one warning.

A key of neither package is ignored with one warning too.
:meth:`Config.check_trainable` refuses what is still unported in
training: ``tree_learner`` other than ``serial``.  The rest of
training (every objective, ``gbdt``, ``goss`` and ``dart``, bagging,
feature fraction, ``nan_policy``, continued training, early stopping)
is ported.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Mapping, Optional

from .utils import coerce_bool as _coerce_bool
from .utils import log
from .utils.log import LightGBMError

# alias -> canonical name (the JAX config's table)
PARAM_ALIASES: Dict[str, str] = {
    "config": "config_file",
    "nthread": "num_threads",
    "num_thread": "num_threads",
    "random_seed": "seed",
    "boosting": "boosting_type",
    "boost": "boosting_type",
    "application": "objective",
    "app": "objective",
    "train_data": "data",
    "train": "data",
    "model_output": "output_model",
    "model_out": "output_model",
    "model_input": "input_model",
    "model_in": "input_model",
    "predict_result": "output_result",
    "prediction_result": "output_result",
    "valid": "valid_data",
    "test_data": "valid_data",
    "test": "valid_data",
    "is_sparse": "is_enable_sparse",
    "enable_sparse": "is_enable_sparse",
    "pre_partition": "is_pre_partition",
    "tranining_metric": "is_training_metric",
    "train_metric": "is_training_metric",
    "ndcg_at": "ndcg_eval_at",
    "eval_at": "ndcg_eval_at",
    "min_data_per_leaf": "min_data_in_leaf",
    "min_data": "min_data_in_leaf",
    "min_child_samples": "min_data_in_leaf",
    "min_sum_hessian_per_leaf": "min_sum_hessian_in_leaf",
    "min_sum_hessian": "min_sum_hessian_in_leaf",
    "min_hessian": "min_sum_hessian_in_leaf",
    "min_child_weight": "min_sum_hessian_in_leaf",
    "num_leaf": "num_leaves",
    "sub_feature": "feature_fraction",
    "colsample_bytree": "feature_fraction",
    "num_iteration": "num_iterations",
    "num_tree": "num_iterations",
    "num_round": "num_iterations",
    "num_trees": "num_iterations",
    "num_rounds": "num_iterations",
    "sub_row": "bagging_fraction",
    "subsample": "bagging_fraction",
    "subsample_freq": "bagging_freq",
    "shrinkage_rate": "learning_rate",
    "tree": "tree_learner",
    "num_machine": "num_machines",
    "local_port": "local_listen_port",
    "two_round_loading": "use_two_round_loading",
    "two_round": "use_two_round_loading",
    "mlist": "machine_list_file",
    "is_save_binary": "is_save_binary_file",
    "save_binary": "is_save_binary_file",
    "early_stopping_rounds": "early_stopping_round",
    "early_stopping": "early_stopping_round",
    "verbosity": "verbose",
    "header": "has_header",
    "label": "label_column",
    "weight": "weight_column",
    "group": "group_column",
    "query": "group_column",
    "query_column": "group_column",
    "ignore_feature": "ignore_column",
    "blacklist": "ignore_column",
    "categorical_feature": "categorical_column",
    "cat_column": "categorical_column",
    "cat_feature": "categorical_column",
    "save_period": "snapshot_freq",
    "predict_raw_score": "is_predict_raw_score",
    "predict_leaf_index": "is_predict_leaf_index",
    "raw_score": "is_predict_raw_score",
    "leaf_index": "is_predict_leaf_index",
    "min_split_gain": "min_gain_to_split",
    "topk": "top_k",
    "reg_alpha": "lambda_l1",
    "reg_lambda": "lambda_l2",
    "num_classes": "num_class",
    "unbalanced_sets": "is_unbalance",
}

_DEFAULTS: Dict[str, Any] = {
    "task": "train",
    "data": "",
    "input_model": "",
    "output_result": "LightGBM_predict_result.txt",
    "verbose": 1,
    "has_header": False,
    "is_predict_raw_score": False,
    "num_iteration_predict": -1,
    # serving (the JAX config's serve_* defaults)
    "serve_host": "127.0.0.1",
    "serve_port": 8080,
    "serve_max_batch": 8192,
    "serve_max_delay_ms": 5.0,
    "predict_buckets": [],
    "serve_walk": "auto",
    "serve_quantize_leaves": False,
    "serve_max_body_bytes": 33554432,
    "serve_nonfinite_policy": "reject",
    # the port's own: where the forest runs ("cuda" or "cpu")
    "device": "cuda",
    # training (the JAX config's defaults)
    "objective": "regression",
    "boosting_type": "gbdt",
    "tree_learner": "serial",
    "serial_grow": "ordered",
    "num_class": 1,
    "metric": [],
    "valid_data": [],
    "output_model": "LightGBM_model.txt",
    "num_iterations": 10,
    "learning_rate": 0.1,
    "num_leaves": 127,
    "max_bin": 255,
    "min_data_in_leaf": 100,
    "min_sum_hessian_in_leaf": 10.0,
    "lambda_l1": 0.0,
    "lambda_l2": 0.0,
    "min_gain_to_split": 0.0,
    "max_depth": -1,
    "min_data_in_bin": 5,
    "bin_construct_sample_cnt": 200000,
    "data_random_seed": 1,
    "is_enable_sparse": True,
    "enable_bundle": True,
    "max_conflict_rate": 0.0,
    "sigmoid": 1.0,
    "is_unbalance": False,
    "scale_pos_weight": 1.0,
    # the objectives' and metrics' parameters
    "huber_delta": 1.0,
    "fair_c": 1.0,
    "gaussian_eta": 1.0,
    "poisson_max_delta_step": 0.7,
    "label_gain": [],
    "max_position": 20,
    "ndcg_eval_at": [1, 2, 3, 4, 5],
    "is_training_metric": False,
    "output_freq": 1,
    # row and feature sampling (models/gbdt.py), GOSS (models/goss.py)
    # and DART (models/dart.py)
    "bagging_fraction": 1.0,
    "bagging_freq": 0,
    "bagging_seed": 3,
    "feature_fraction": 1.0,
    "feature_fraction_seed": 2,
    "top_rate": 0.2,
    "other_rate": 0.1,
    "drop_rate": 0.1,
    "max_drop": 50,
    "skip_drop": 0.5,
    "xgboost_dart_mode": False,
    "uniform_drop": False,
    "drop_seed": 4,
    # the JAX package's padded row count, which sets how many words a
    # bagging or GOSS draw takes (utils/random.bucket_rows)
    "row_buckets": True,
    # NaN/Inf containment of a boosting round: none | fail_fast |
    # skip_tree (GBDT._contain_poisoned_iter)
    "nan_policy": "none",
    # piece-wise linear trees (models/linear.py): affine leaf models fitted
    # by a batched ridge solve after growth
    "linear_tree": False,
    "linear_lambda": 0.0,            # ridge strength on the slope terms
    "linear_max_leaf_features": 5,   # K: path features per leaf (0 =
                                     # constant leaves)
    # the per-leaf histogram cache bound (MB, <= 0: none) and what to do
    # when it binds (fail_fast: warn that it does not bound memory;
    # degrade: drop the cache for the full-pass grower)
    "histogram_pool_size": -1.0,
    "memory_policy": "fail_fast",
    # in-data column roles of a data file (io/column_roles.py)
    "label_column": "",
    "weight_column": "",
    "group_column": "",
    "ignore_column": "",
    "categorical_column": "",
    # the CLI's early stopping and leaf-index predict (cli.py)
    "early_stopping_round": 0,
    "is_predict_leaf_index": False,
    # the leaf-output decay Booster.merge applies by default
    "shrinkage_decay": 1.0,
    # read only to be refused (REFUSED)
    "bad_data_policy": "fail_fast",
    "use_two_round_loading": False,
    "feature_screen_ratio": 0.0,
    "snapshot_dir": "",
    "num_machines": 1,
    "is_pre_partition": False,
    "is_save_binary_file": False,
    "serve_canary_model": "",
    "serve_canary_weight": 0.0,
    "serve_shadow": 0.0,
    "serve_state_file": "",
}

#: key -> (refused(value), what the JAX package does with it): a value
#: for which ``refused`` holds raises when the Config is built
REFUSED: Dict[str, tuple] = {
    "bad_data_policy": (
        lambda v: v != "fail_fast",
        "the JAX loader quarantines malformed rows; the torch port reads "
        "data files fail-fast: the first malformed line raises"),
    "use_two_round_loading": (
        bool,
        "the JAX package's streaming loader samples the rows it bins "
        "from differently; the torch port loads the whole file"),
    "feature_screen_ratio": (
        lambda v: v > 0.0,
        "gain-informed feature screening masks features out of rounds, "
        "which changes the trees"),
    "snapshot_dir": (
        bool,
        "the JAX package writes snapshots there and resumes training "
        "from the newest one"),
    "num_machines": (
        lambda v: v > 1,
        "distributed training over several machines"),
    "is_pre_partition": (
        bool, "pre-partitioned data of distributed training"),
    "is_save_binary_file": (
        bool, "the JAX package writes the binned dataset to a binary file"),
    "serve_canary_model": (
        bool, "a second model answers a share of the serving traffic"),
    "serve_canary_weight": (
        lambda v: v > 0.0,
        "a canary model answers a share of the serving traffic"),
    "serve_shadow": (
        lambda v: v > 0.0, "serving traffic mirrored onto a canary model"),
    "serve_state_file": (
        bool, "the server restores its last-good model from that file"),
}

#: keys that cannot change a tree, a prediction, a file the run writes
#: or its outcome in the port: accepted with one warning each.  The
#: ``feature_screen_*`` tuning keys and the distributed keys act only
#: under a setting :data:`REFUSED` or ``check_trainable`` refuses; the
#: quarantine budgets only under ``bad_data_policy=quarantine``;
#: ``snapshot_freq`` / ``snapshot_keep`` only with a ``snapshot_dir``;
#: ``top_k`` only in the voting learner; ``seed``,
#: ``enable_load_from_binary_file``, ``tpu_histogram_impl`` and
#: ``tpu_double_hist`` are read by nothing in the JAX package's
#: training (the first through its aliases only).
INERT = frozenset({
    "seed", "num_threads", "enable_load_from_binary_file",
    "feature_screen_refresh", "feature_screen_warmup",
    "feature_screen_decay", "top_k", "local_listen_port", "time_out",
    "machine_list_file", "tpu_histogram_impl", "tpu_double_hist",
    "snapshot_freq", "snapshot_keep", "sink_error_policy",
    "events_flush_every", "max_bad_rows", "max_bad_row_fraction",
    "distributed_init_retries", "distributed_init_backoff",
    "distributed_heartbeat_ms", "collective_timeout_s",
    "distributed_consistency_check", "desync_policy",
    "serve_replicas", "serve_queue_depth", "serve_max_inflight",
    "serve_retry_limit", "serve_error_threshold", "serve_watchdog_ms",
    "serve_stall_ms", "serve_latency_outlier", "lifecycle_window_s",
    "lifecycle_max_window_s", "lifecycle_min_samples",
    "lifecycle_latency_ratio", "lifecycle_error_rate",
    "lifecycle_cooldown_s", "events_file", "trace_dir",
    "trace_start_iter", "trace_num_iters", "metrics_port",
    "metrics_host", "compile_ledger_file", "memwatch", "devprof",
    "trace_events_file", "compile_cache_dir", "drift", "drift_window",
    "drift_top_k", "lifecycle_drift_threshold",
})

_BOOL_KEYS = {k for k, v in _DEFAULTS.items() if isinstance(v, bool)}
_INT_KEYS = {k for k, v in _DEFAULTS.items()
             if isinstance(v, int) and not isinstance(v, bool)}
_FLOAT_KEYS = {k for k, v in _DEFAULTS.items() if isinstance(v, float)}
_LIST_KEYS = {"predict_buckets", "metric", "valid_data", "label_gain",
              "ndcg_eval_at"}

_OBJECTIVE_ALIASES = {
    "regression": "regression", "regression_l2": "regression",
    "mean_squared_error": "regression", "mse": "regression",
    "l2": "regression",
    "regression_l1": "regression_l1", "mean_absolute_error":
    "regression_l1", "mae": "regression_l1", "l1": "regression_l1",
    "huber": "huber", "fair": "fair", "poisson": "poisson",
    "binary": "binary", "multiclass": "multiclass", "softmax": "multiclass",
    "lambdarank": "lambdarank", "rank": "lambdarank",
}

_METRIC_ALIASES = {
    "l2": "l2", "mse": "l2", "mean_squared_error": "l2", "regression": "l2",
    "l1": "l1", "mae": "l1", "mean_absolute_error": "l1",
    "huber": "huber", "fair": "fair", "poisson": "poisson",
    "binary_logloss": "binary_logloss", "binary": "binary_logloss",
    "binary_error": "binary_error", "auc": "auc",
    "multi_logloss": "multi_logloss", "multiclass": "multi_logloss",
    "multi_error": "multi_error", "ndcg": "ndcg",
    "map": "map", "mean_average_precision": "map",
}

#: the objectives the port trains (``none``: gradients from a custom
#: ``fobj``)
OBJECTIVES = ("regression", "regression_l1", "huber", "fair", "poisson",
              "binary", "multiclass", "lambdarank", "none")

#: the boosting types the port trains (models/__init__.create_boosting)
BOOSTING_TYPES = ("gbdt", "goss", "dart")

_DEFAULT_METRIC = {
    "regression": ["l2"], "regression_l1": ["l1"], "huber": ["huber"],
    "fair": ["fair"], "poisson": ["poisson"], "binary": ["binary_logloss"],
    "multiclass": ["multi_logloss"], "lambdarank": ["ndcg"],
}


def apply_aliases(params: Mapping[str, Any]) -> Dict[str, Any]:
    """Canonical keys win over aliases (reference config.h:405-415)."""
    out: Dict[str, Any] = {}
    aliased: Dict[str, Any] = {}
    for key, value in params.items():
        key = key.strip()
        if key in PARAM_ALIASES:
            aliased[PARAM_ALIASES[key]] = value
        else:
            out[key] = value
    for key, value in aliased.items():
        out.setdefault(key, value)
    return out


def _coerce_list(value: Any, elem=str) -> List[Any]:
    if isinstance(value, (list, tuple)):
        return [elem(v) for v in value]
    s = str(value).strip()
    if not s:
        return []
    return [elem(v) for v in s.replace(",", " ").split()]


class Config:
    """Typed view over a params dict after alias resolution
    (``cfg.serve_port``)."""

    def __init__(self, params: Optional[Mapping[str, Any]] = None):
        params = apply_aliases(dict(params or {}))
        self.raw: Dict[str, Any] = params
        self._values: Dict[str, Any] = copy.deepcopy(_DEFAULTS)
        for key, value in params.items():
            if key not in self._values:
                if key == "config_file":
                    continue
                why = ("cannot change a tree or a prediction"
                       if key in INERT else "is not a parameter of the "
                       "JAX package")
                log.warn_once(f"config:{key}", "parameter %r is not read "
                              "by the torch port (it %s); ignored", key,
                              why)
                continue
            self._values[key] = self._coerce(key, value)
        self._check()

    @staticmethod
    def _coerce(key: str, value: Any) -> Any:
        if key == "metric":
            return [_METRIC_ALIASES.get(n, n) for n in _coerce_list(value)
                    if n not in ("", "none", "null", "na")]
        if key == "valid_data":
            return _coerce_list(value)
        if key == "label_gain":
            return _coerce_list(value, float)
        if key in _LIST_KEYS:
            return _coerce_list(value, int)
        if key == "objective":
            name = str(value).strip()
            return _OBJECTIVE_ALIASES.get(name, name)
        if key in _BOOL_KEYS:
            return _coerce_bool(value)
        if key in _INT_KEYS:
            return int(float(value))
        if key in _FLOAT_KEYS:
            return float(value)
        return str(value).strip() if isinstance(value, str) else value

    def _check(self) -> None:
        v = self._values
        if v["bad_data_policy"] not in ("fail_fast", "quarantine"):
            raise ValueError(
                f"Unknown bad_data_policy {v['bad_data_policy']} "
                "(expected fail_fast or quarantine)")
        if not (0.0 <= v["feature_screen_ratio"] < 1.0):
            raise ValueError(
                "feature_screen_ratio must be in [0, 1) (0 disables "
                "gain-informed feature screening; 1 would mask every "
                "feature)")
        if v["nan_policy"] not in ("none", "fail_fast", "skip_tree"):
            raise ValueError(
                f"Unknown nan_policy {v['nan_policy']} "
                "(expected none, fail_fast, or skip_tree)")
        for key, (refused, why) in REFUSED.items():
            if refused(v[key]):
                value = v[key]
                if isinstance(value, bool):
                    value = str(value).lower()
                raise LightGBMError(
                    f"not ported yet to the torch package: {key}={value} "
                    f"({why})")
        if not (0.0 < v["shrinkage_decay"] <= 1.0):
            raise ValueError("shrinkage_decay must be in (0, 1] — 0 would "
                             "merge dead trees, > 1 would amplify them")
        if v["serve_max_batch"] <= 0:
            raise ValueError("serve_max_batch must be > 0")
        if v["serve_max_delay_ms"] < 0:
            raise ValueError("serve_max_delay_ms must be >= 0")
        if v["serve_max_body_bytes"] < 0:
            raise ValueError("serve_max_body_bytes must be >= 0 "
                             "(0 = no request body cap)")
        if v["serve_nonfinite_policy"] not in ("reject", "propagate"):
            raise ValueError(
                f"Unknown serve_nonfinite_policy "
                f"{v['serve_nonfinite_policy']} "
                "(expected reject or propagate)")
        if v["serve_walk"] not in ("auto", "fused", "gather"):
            raise ValueError(
                f"Unknown serve_walk {v['serve_walk']} "
                "(expected auto, fused or gather)")
        if any(b <= 0 for b in v["predict_buckets"]):
            raise ValueError("predict_buckets must be positive sizes")
        # the JAX config's conflict derivation (config.cpp:138-176)
        if v["serial_grow"] not in ("ordered", "cached", "fused"):
            raise ValueError(
                f"Unknown serial_grow strategy {v['serial_grow']}")
        if v["memory_policy"] not in ("fail_fast", "degrade"):
            raise ValueError(
                f"Unknown memory_policy {v['memory_policy']} "
                "(expected fail_fast or degrade)")
        obj = v["objective"]
        if obj == "multiclass":
            if v["num_class"] <= 2:
                raise ValueError(
                    "Number of classes should be specified and greater "
                    "than 2 for multiclass training")
        elif obj != "none" and v["num_class"] != 1 and v["task"] == "train":
            raise ValueError(
                "Number of classes must be 1 for non-multiclass training")
        for metric in v["metric"] if obj != "none" else ():
            if (obj == "multiclass") != (
                    metric in ("multi_logloss", "multi_error")):
                raise ValueError("Objective and metrics don't match")
        if v["boosting_type"] == "goss" and (
                v["bagging_fraction"] < 1.0 and v["bagging_freq"] > 0):
            raise ValueError("cannot use bagging in GOSS")
        if not v["metric"]:
            v["metric"] = list(_DEFAULT_METRIC.get(v["objective"], []))
        if v["num_leaves"] <= 1:
            raise ValueError("num_leaves must be > 1")
        if v["linear_lambda"] < 0.0:
            raise ValueError("linear_lambda must be >= 0 (ridge strength "
                             "on the per-leaf affine slope terms)")
        if v["linear_max_leaf_features"] < 0:
            raise ValueError("linear_max_leaf_features must be >= 0 "
                             "(0 degenerates linear_tree to constant "
                             "leaves)")
        if v["max_depth"] > 0:
            v["num_leaves"] = min(v["num_leaves"], 2 ** v["max_depth"])

    def check_trainable(self) -> None:
        """Raise for every training setting outside the ported slice:
        an unknown objective or boosting type, or a distributed tree
        learner; nothing here is silently ignored (the refused keys of
        :data:`REFUSED` raise when the Config is built, EFB bundles when
        the dataset is binned)."""
        v = self._values
        if v["objective"] not in OBJECTIVES:
            raise LightGBMError(
                f"Unknown objective type name: {v['objective']}")
        if v["boosting_type"] not in BOOSTING_TYPES:
            log.fatal("Unknown boosting type %s", v["boosting_type"])
        if v["tree_learner"] != "serial":
            raise LightGBMError(
                "not ported yet to the torch package: "
                f"tree_learner={v['tree_learner']} (distributed learners)")

    def __getattr__(self, name: str) -> Any:
        values = object.__getattribute__(self, "_values")
        if name in values:
            return values[name]
        raise AttributeError(name)

    def __getitem__(self, name: str) -> Any:
        return self._values[name]

    def get(self, name: str, default: Any = None) -> Any:
        return self._values.get(name, default)


def parse_config_file(path: str) -> Dict[str, str]:
    """``key = value`` conf file with ``#`` comments (reference
    application.cpp:46-104)."""
    params: Dict[str, str] = {}
    with open(path, "r") as fh:
        for line in fh:
            line = line.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            key, value = line.split("=", 1)
            params[key.strip()] = value.strip()
    return params


def parse_cli_args(argv: List[str]) -> Dict[str, str]:
    """``k=v`` CLI tokens; a ``config=`` file is read first and the
    command line overrides it (reference application.cpp:46-76)."""
    params: Dict[str, str] = {}
    for token in argv:
        if "=" not in token:
            if token.startswith("--"):
                log.warning("ignoring CLI flag %r: flags must use the "
                            "--key=value form", token)
            continue
        key, value = token.split("=", 1)
        key = key.strip()
        if key.startswith("--"):
            key = key[2:].replace("-", "_")
        params[key] = value.strip()
    params = apply_aliases(params)
    config_path = params.pop("config_file", None)
    if config_path:
        file_params = apply_aliases(parse_config_file(config_path))
        file_params.update(params)
        params = file_params
    return params
