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
  the key's aliases too).  It is empty now; the mechanism stays for a
  later key;
* :data:`INERT`: keys that cannot change a tree, a prediction or the
  run's outcome and that the port does not read (thread counts, the
  JAX compile cache): each is accepted with one warning.  The telemetry
  keys, device-time attribution's among them, are read.

A key of neither package is ignored with one warning too.
:meth:`Config.check_trainable` refuses an unknown objective or boosting
type.  Every objective, ``gbdt``, ``goss`` and ``dart``, bagging,
feature fraction, ``nan_policy``, continued training, early stopping
and the distributed learners (``tree_learner`` = ``data``, ``feature``
or ``voting`` with ``num_machines > 1``, ``parallel/``) are ported.  As
in the JAX config, ``num_machines <= 1`` makes the learner ``serial``.
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
    # the serving fleet (serve/fleet.py): replicas, admission, canary
    "serve_replicas": 0,          # cards (0 = every card; 1 on the CPU)
    "serve_queue_depth": 128,     # pending requests a replica (0 = no cap)
    "serve_max_inflight": 0,      # fleet-wide in-flight cap (0 = no cap)
    "serve_canary_model": "",     # a second model file (A/B routing)
    "serve_canary_weight": 0.0,   # the canary's traffic share in [0, 1)
    # replica health (serve/health.py)
    "serve_retry_limit": 2,       # hedged retries a request (0 = none)
    "serve_error_threshold": 3,   # consecutive errors -> suspect
    "serve_watchdog_ms": 250.0,   # watchdog interval (0 = off)
    "serve_stall_ms": 5000.0,     # a batch this old -> wedged
    "serve_latency_outlier": 8.0,  # EWMA over the fleet median -> suspect
    "serve_state_file": "",       # last-good model state (crash restore)
    # the guarded model lifecycle (serve/lifecycle.py)
    "serve_shadow": 0.0,          # primary traffic mirrored to the canary
    "lifecycle_window_s": 0.0,    # observation window (0 = manual)
    "lifecycle_max_window_s": 0.0,  # extended-window cap (0 = 4x window)
    "lifecycle_min_samples": 50,  # canary requests before a gate votes
    "lifecycle_latency_ratio": 3.0,  # canary/primary p99 (0 = gate off)
    "lifecycle_error_rate": 0.05,  # canary error+ejection share
    "lifecycle_cooldown_s": 60.0,  # post-rollback cooldown, doubling
    # the drift observatory (obs/drift.py)
    "drift": "off",               # serve-side drift collector: off | on
    "drift_window": 30.0,         # collector window, seconds
    "drift_top_k": 5,             # offending features labeled a window
    "lifecycle_drift_threshold": 0.25,  # sustained PSI -> rollback vote
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
    # gain-informed feature screening (models/screening.py): off unless
    # feature_screen_ratio > 0
    "feature_screen_ratio": 0.0,     # share of the columns masked out of
                                     # screened rounds
    "feature_screen_refresh": 10,    # refresh round period
    "feature_screen_warmup": 20,     # unscreened rounds seeding the
                                     # gain average
    "feature_screen_decay": 0.9,     # per-round decay of the average
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
    # distributed training (parallel/): the machine list, the voting
    # learner's k, the bring-up's timeout (minutes) and retries
    "num_machines": 1,
    "top_k": 20,
    "machine_list_file": "",
    "local_listen_port": 12400,
    "time_out": 120,
    "distributed_init_retries": 3,
    "distributed_init_backoff": 2.0,
    # the collective watchdog (parallel/watchdog.py) and the
    # consistency check (models/gbdt.py)
    "distributed_heartbeat_ms": 500.0,
    "collective_timeout_s": 0.0,
    "distributed_consistency_check": 0,
    "desync_policy": "fail_fast",
    # crash-safe snapshots (snapshot.py) and the sinks' write-failure
    # policy (utils/diskguard.py)
    "snapshot_dir": "",
    "snapshot_freq": 0,
    "snapshot_keep": 3,
    "sink_error_policy": "disable",
    # the data boundary (io/guard.py) and the two-round loader
    # (io/streaming.py)
    "bad_data_policy": "fail_fast",
    "max_bad_rows": 0,
    "max_bad_row_fraction": 0.1,
    "use_two_round_loading": False,
    # run telemetry (obs/): the per-iteration event stream and its flush
    # cadence, the causal trace export, the training /metrics listener
    "events_file": "",
    "events_flush_every": 1,
    "trace_events_file": "",
    "metrics_port": 0,
    "metrics_host": "127.0.0.1",
    # device-time attribution (obs/devprof.py, obs/trace.py,
    # obs/compile_ledger.py, obs/memwatch.py); each env variable wins
    "trace_dir": "",            # LIGHTGBM_TPU_TRACE_DIR
    "trace_start_iter": 5,
    "trace_num_iters": 2,
    "compile_ledger_file": "",  # LIGHTGBM_TPU_COMPILE_LEDGER
    "memwatch": False,          # LIGHTGBM_TPU_MEMWATCH
    "devprof": "off",           # off | full | sample:N
                                # (LIGHTGBM_TPU_DEVPROF)
}

#: key -> (refused(value), what the JAX package does with it): a value
#: for which ``refused`` holds raises when the Config is built.  Empty:
#: every key of the JAX package that changes an answer is ported.
REFUSED: Dict[str, tuple] = {}

#: keys that cannot change a tree, a prediction or the run's outcome in
#: the port: accepted with one warning each.  ``seed``,
#: ``enable_load_from_binary_file``, ``tpu_histogram_impl``,
#: ``tpu_double_hist``, ``is_save_binary_file`` and ``is_pre_partition``
#: are read by nothing in the JAX package outside its config (the first
#: through its aliases only; only ``Dataset.save_binary`` writes a
#: binary file).  ``compile_cache_dir`` has no counterpart (the
#: kernels' builds are cached by hash in ``build/``).
INERT = frozenset({
    "seed", "num_threads", "enable_load_from_binary_file",
    "is_save_binary_file", "is_pre_partition",
    "tpu_histogram_impl", "tpu_double_hist", "compile_cache_dir",
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


def default_metric_for_objective(objective: str) -> List[str]:
    """GetMetricType's default: the metric that matches the objective
    (config.cpp); none for an objective without one."""
    return list(_DEFAULT_METRIC.get(objective, []))


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
        if v["max_bad_rows"] < 0:
            raise ValueError("max_bad_rows must be >= 0 (0 = no absolute "
                             "quarantine budget)")
        if not (0.0 <= v["max_bad_row_fraction"] <= 1.0):
            raise ValueError("max_bad_row_fraction must be in [0, 1] "
                             "(0 = no fractional quarantine budget)")
        if not (0.0 <= v["max_conflict_rate"] < 1.0):
            raise ValueError(
                "max_conflict_rate must be in [0, 1): it bounds the share "
                "of conflicting rows an EFB bundle may absorb (0 = only "
                "perfectly exclusive features bundle)")
        if not (0.0 <= v["feature_screen_ratio"] < 1.0):
            raise ValueError(
                "feature_screen_ratio must be in [0, 1) (0 disables "
                "gain-informed feature screening; 1 would mask every "
                "feature)")
        if v["feature_screen_refresh"] < 1:
            raise ValueError("feature_screen_refresh must be >= 1 (every "
                             "K-th round re-scans the full feature set)")
        if v["feature_screen_warmup"] < 0:
            raise ValueError("feature_screen_warmup must be >= 0")
        if not (0.0 < v["feature_screen_decay"] <= 1.0):
            raise ValueError("feature_screen_decay must be in (0, 1]")
        # the devprof grammar is obs/devprof.parse_mode's: a typo dies
        # here, not as a profile silently off
        from .obs.devprof import parse_mode as _devprof_parse
        _devprof_parse(v["devprof"])
        if v["nan_policy"] not in ("none", "fail_fast", "skip_tree"):
            raise ValueError(
                f"Unknown nan_policy {v['nan_policy']} "
                "(expected none, fail_fast, or skip_tree)")
        if v["snapshot_freq"] < 0:
            raise ValueError("snapshot_freq must be >= 0")
        if v["sink_error_policy"] not in ("disable", "fatal"):
            raise ValueError(
                f"Unknown sink_error_policy {v['sink_error_policy']} "
                "(expected disable or fatal)")
        if v["events_flush_every"] < 1:
            raise ValueError("events_flush_every must be >= 1 (flush "
                             "after every K committed event records)")
        if not (0 <= v["metrics_port"] < 65536):
            raise ValueError("metrics_port must be in [0, 65536) "
                             "(0 disables the metrics listener)")
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
        self._check_fleet(v)
        self._check_distributed(v)
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
            v["metric"] = default_metric_for_objective(v["objective"])
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

    @staticmethod
    def _check_fleet(v: Dict[str, Any]) -> None:
        """The JAX config's checks of the fleet, lifecycle and drift
        keys, with its messages."""
        if v["serve_replicas"] < 0:
            raise ValueError("serve_replicas must be >= 0 "
                             "(0 = one replica per local device)")
        if v["serve_queue_depth"] < 0:
            raise ValueError("serve_queue_depth must be >= 0 (0 = no cap)")
        if v["serve_max_inflight"] < 0:
            raise ValueError("serve_max_inflight must be >= 0 (0 = no cap)")
        if not (0.0 <= v["serve_canary_weight"] < 1.0):
            raise ValueError("serve_canary_weight must be in [0, 1) — the "
                             "canary is a minority share, not the primary")
        if v["serve_retry_limit"] < 0:
            raise ValueError("serve_retry_limit must be >= 0 "
                             "(0 disables hedged retries)")
        if v["serve_error_threshold"] < 1:
            raise ValueError("serve_error_threshold must be >= 1")
        if v["serve_watchdog_ms"] < 0:
            raise ValueError("serve_watchdog_ms must be >= 0 "
                             "(0 disables the health watchdog)")
        if v["serve_stall_ms"] < 0:
            raise ValueError("serve_stall_ms must be >= 0 "
                             "(0 disables the wedge detector)")
        if v["serve_latency_outlier"] <= 1.0:
            raise ValueError("serve_latency_outlier must be > 1 — it "
                             "multiplies the fleet-median service time")
        if not (0.0 <= v["serve_shadow"] <= 1.0):
            raise ValueError("serve_shadow must be in [0, 1] — the "
                             "fraction of primary traffic mirrored onto "
                             "the canary")
        if v["lifecycle_window_s"] < 0:
            raise ValueError("lifecycle_window_s must be >= 0 "
                             "(0 = manual promotion, controller off)")
        if v["lifecycle_max_window_s"] < 0:
            raise ValueError("lifecycle_max_window_s must be >= 0 "
                             "(0 = 4x lifecycle_window_s)")
        if v["lifecycle_max_window_s"] > 0 \
                and v["lifecycle_max_window_s"] < v["lifecycle_window_s"]:
            raise ValueError("lifecycle_max_window_s must be >= "
                             "lifecycle_window_s (or 0 for the 4x default)")
        if v["lifecycle_min_samples"] < 1:
            raise ValueError("lifecycle_min_samples must be >= 1 — a "
                             "guardrail must never vote on zero evidence")
        if v["lifecycle_latency_ratio"] != 0 \
                and v["lifecycle_latency_ratio"] <= 1.0:
            raise ValueError("lifecycle_latency_ratio must be > 1 (it "
                             "multiplies the primary's p99) or 0 to "
                             "disable the latency gate")
        if not (0.0 <= v["lifecycle_error_rate"] <= 1.0):
            raise ValueError("lifecycle_error_rate must be in [0, 1]")
        if v["lifecycle_cooldown_s"] < 0:
            raise ValueError("lifecycle_cooldown_s must be >= 0")
        if v["drift"] not in ("off", "on"):
            raise ValueError(f"drift must be 'off' or 'on', "
                             f"got {v['drift']!r}")
        if v["drift_window"] <= 0:
            raise ValueError("drift_window must be > 0 seconds (disable "
                             "the collector with drift=off instead)")
        if v["drift_top_k"] < 1:
            raise ValueError("drift_top_k must be >= 1")
        if v["lifecycle_drift_threshold"] < 0:
            raise ValueError("lifecycle_drift_threshold must be >= 0 "
                             "(0 disables the drift gate)")

    @staticmethod
    def _check_distributed(v: Dict[str, Any]) -> None:
        """The JAX config's distributed checks and its normalization
        (config.cpp:161-172): ``num_machines <= 1`` trains ``serial``,
        and a ``serial`` learner runs on one machine."""
        if v["tree_learner"] not in ("serial", "feature", "data", "voting"):
            raise ValueError(f"Unknown tree learner type {v['tree_learner']}")
        if v["top_k"] < 1:
            raise ValueError("top_k must be >= 1")
        if not 0 < v["local_listen_port"] < 65536:
            raise ValueError("local_listen_port must be a TCP port "
                             "(1..65535)")
        if v["time_out"] < 0:
            raise ValueError("time_out must be >= 0 minutes")
        if v["distributed_init_retries"] < 0:
            raise ValueError("distributed_init_retries must be >= 0")
        if v["distributed_init_backoff"] < 0:
            raise ValueError("distributed_init_backoff must be >= 0")
        if v["distributed_heartbeat_ms"] < 0:
            raise ValueError("distributed_heartbeat_ms must be >= 0 "
                             "(0 disables the collective watchdog)")
        if v["collective_timeout_s"] < 0:
            raise ValueError("collective_timeout_s must be >= 0 (0 = "
                             "auto, derived from the comm_seconds EWMA)")
        if v["distributed_consistency_check"] < 0:
            raise ValueError("distributed_consistency_check must be >= 0 "
                             "(0 disables the desync detector)")
        if v["desync_policy"] not in ("fail_fast", "resync"):
            raise ValueError(
                f"Unknown desync_policy {v['desync_policy']} "
                "(expected fail_fast or resync)")
        if v["num_machines"] <= 1:
            v["tree_learner"] = "serial"
        elif v["tree_learner"] == "serial":
            v["num_machines"] = 1

    def check_trainable(self) -> None:
        """Raise for an unknown objective or boosting type; nothing here
        is silently ignored (the refused keys of :data:`REFUSED` raise
        when the Config is built)."""
        v = self._values
        if v["objective"] not in OBJECTIVES:
            raise LightGBMError(
                f"Unknown objective type name: {v['objective']}")
        if v["boosting_type"] not in BOOSTING_TYPES:
            log.fatal("Unknown boosting type %s", v["boosting_type"])

    def __getattr__(self, name: str) -> Any:
        values = object.__getattribute__(self, "_values")
        if name in values:
            return values[name]
        raise AttributeError(name)

    def __getitem__(self, name: str) -> Any:
        return self._values[name]

    def get(self, name: str, default: Any = None) -> Any:
        return self._values.get(name, default)

    def raw_params(self) -> Dict[str, Any]:
        """The user-supplied (alias-resolved) parameter dict."""
        return dict(self.raw)

    def to_dict(self) -> Dict[str, Any]:
        """Every canonical key's typed value."""
        return dict(self._values)

    def updated(self, **kwargs: Any) -> "Config":
        """A new Config of the user's parameters with ``kwargs`` over
        them."""
        return Config({**self.raw, **kwargs})


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
