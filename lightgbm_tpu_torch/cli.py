"""Command-line application for the port's train, predict and serve
tasks.

    python -m lightgbm_tpu_torch task=train data=train.csv \\
        objective=<objective> output_model=model.txt \\
        [valid_data=valid.csv] [config=train.conf] \\
        [input_model=init.txt] [early_stopping_round=10] \\
        [num_iterations=100 num_leaves=63 ...] [device=cuda|cpu] \\
        [serial_grow=ordered|cached|fused] \\
        [histogram_pool_size=<MB> memory_policy=fail_fast|degrade] \\
        [snapshot_dir=<dir> snapshot_freq=<K>] \\
        [num_machines=<n> machine_list_file=<file> \\
         collective_timeout_s=<s> distributed_heartbeat_ms=<ms> \\
         distributed_consistency_check=<K> desync_policy=fail_fast|resync]
    python -m lightgbm_tpu_torch task=predict input_model=model.txt \\
        data=rows.csv output_result=preds.txt [device=cuda|cpu] \\
        [is_predict_leaf_index=true]
    python -m lightgbm_tpu_torch task=serve input_model=model.txt \\
        serve_port=8080 [serve_max_batch=8192 serve_max_delay_ms=5]
    python -m lightgbm_tpu_torch obs-report run.jsonl [--traces] \\
        [--format=json|table] [--top=K] [--compile=ledger.jsonl]

Parameters parse as in the JAX CLI (``key=value`` tokens, ``config=``
file first, command line wins, the same aliases); keys this port does not
read are ignored with one warning each, and keys that would change the
answer are refused (``config.py``).  Data files are CSV, TSV or LibSVM
(io/parser.py), with the label in ``label_column`` (default the first
column); ``.weight``, ``.query`` and ``.init`` side files beside a data
or valid file are loaded, and the column roles (``weight_column``,
``group_column``, ``ignore_column``, ``categorical_column``) are taken.
Every objective of the JAX package trains.  Training goes through
``engine.train`` as in the JAX CLI: it continues from ``input_model``,
stops early after ``early_stopping_round`` rounds without a better valid
metric (and still saves every round it trained), and logs the metrics
every ``output_freq`` rounds; with ``snapshot_dir`` it snapshots every
``snapshot_freq`` rounds and resumes from the newest valid snapshot.
A distributed run that the collective watchdog aborts (a dead or hung
peer) exits with code 75, for the launcher to restart it.
``is_predict_leaf_index=true`` writes each row's leaf in every tree
instead of scores.  ``events_file=``, ``trace_events_file=`` and
``metrics_port=`` record a run (``obs/``), and ``obs-report`` summarises
its files (``obs/report.py``).  ``python -m
lightgbm_tpu_torch serve ...`` is sugar for ``task=serve``.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Dict

import numpy as np

from .basic import Booster, Dataset
from .config import Config, parse_cli_args
from .engine import train as engine_train
from .io.column_roles import resolve_label_idx
from .io.parser import parse_file_chunks, read_header
from .utils import log


def _write_prediction_rows(fh, part: np.ndarray) -> None:
    """``[n]`` or ``[n, K]`` predictions (or ``[n, num_trees]`` leaf
    indices) -> ``%g`` lines, tab-joined per row when 2-D."""
    if part.ndim == 1:
        for v in part:
            fh.write(f"{v:g}\n")
        return
    for row in part:
        fh.write("\t".join(f"{v:g}" for v in row) + "\n")


def run_predict(config: Config, params: Dict[str, str]) -> None:
    """task=predict: score ``data`` (CSV, TSV or LibSVM, densified to the
    model's width) with ``input_model`` through the forest-walk kernel,
    or with ``is_predict_leaf_index`` write each row's leaf in every
    tree (the host walk); results stream to ``output_result``.  The
    label column is ``label_column`` when given, else the model's."""
    if not config.input_model:
        log.fatal("No model file specified (input_model=...)")
    if not config.data:
        log.fatal("No prediction data specified (data=...)")
    booster = Booster(model_file=config.input_model, params=dict(params),
                      device=config.device)
    b = booster._booster
    label_idx = b.label_idx
    if config.label_column:
        label_idx = resolve_label_idx(
            config.label_column,
            read_header(config.data)[0] if config.has_header else None)
    start = time.monotonic()
    out = config.output_result or "LightGBM_predict_result.txt"
    n_rows = 0
    # the result is an artifact: a failed write fails the task with a
    # named error that says how many rows landed (utils/diskguard.py)
    from .utils.diskguard import SinkWriteError, artifact_write
    try:
        with artifact_write(out, "predict_output") as fh:
            for _, X in parse_file_chunks(config.data, config.has_header,
                                          label_idx, b.max_feature_idx + 1):
                part = booster.predict(
                    X, num_iteration=config.num_iteration_predict,
                    raw_score=config.is_predict_raw_score,
                    pred_leaf=config.is_predict_leaf_index)
                _write_prediction_rows(fh, np.asarray(part))
                n_rows += X.shape[0]
    except SinkWriteError as exc:
        log.fatal("task=predict: output stream %s died (%s) after %d "
                  "row(s) were written; the partial result file is NOT "
                  "a complete prediction — free space (or point "
                  "output_result elsewhere) and re-run",
                  out, exc.classification, n_rows)
    log.info("%f seconds elapsed, finished prediction of %d rows",
             time.monotonic() - start, n_rows)
    log.info("Finished prediction. Results saved to %s", out)


def run_train(config: Config, params: Dict[str, str]) -> None:
    """task=train (Application::InitTrain + Train): bin ``data`` (with
    its side files and column roles) and each ``valid_data`` file
    against its mappers, then ``engine.train`` on ``device`` as the JAX
    CLI calls it (with ``num_machines > 1`` and a ``machine_list_file``,
    first joining the machine list's group: ``parallel/multihost.py``): the training set first among the evaluated sets when
    ``is_training_metric``, ``valid_<i>`` names, metrics logged every
    ``output_freq`` rounds, early stopping when ``early_stopping_round``
    > 0, continued from ``input_model``.  Saves every trained round to
    ``output_model``."""
    if not config.data:
        log.fatal("No training data specified (data=...)")
    config.check_trainable()          # before reading a large file
    # join the machine list's group before any device use (the JAX
    # CLI's order); one process without a machine list trains alone
    from .parallel.multihost import maybe_initialize_distributed
    distributed = maybe_initialize_distributed(config)
    start = time.monotonic()
    train_set = Dataset(config.data, params=dict(params))
    valid_sets, valid_names = [], []
    if config.is_training_metric:
        valid_sets.append(train_set)
        valid_names.append("training")
    for i, path in enumerate(config.valid_data):
        valid_sets.append(train_set.create_valid(path, params=dict(params)))
        valid_names.append(f"valid_{i + 1}")
    booster = engine_train(
        dict(params), train_set, num_boost_round=config.num_iterations,
        valid_sets=valid_sets or None, valid_names=valid_names or None,
        verbose_eval=max(config.output_freq, 1),
        early_stopping_rounds=(config.early_stopping_round
                               if config.early_stopping_round > 0 else None),
        init_model=config.input_model or None, device=config.device)
    booster.save_model(config.output_model)
    log.info("%f seconds elapsed, finished training",
             time.monotonic() - start)
    log.info("Finished training. Model saved to %s", config.output_model)
    if distributed:
        import torch.distributed as dist

        from .parallel import watchdog
        watchdog.stop_active()
        dist.destroy_process_group()


def run_serve(config: Config, params: Dict[str, str]) -> None:
    """task=serve: freeze ``input_model`` on the card, warm it, and serve
    over HTTP until SIGINT/SIGTERM."""
    from .serve.server import serve_from_config
    serve_from_config(config, params).serve_forever()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: python -m lightgbm_tpu_torch config=<conf> "
              "[key=value ...]\n"
              "       python -m lightgbm_tpu_torch task=train "
              "data=<csv|tsv|libsvm> objective=<regression|regression_l1|"
              "huber|fair|poisson|binary|multiclass|lambdarank> "
              "[output_model=<file>] [valid_data=<file>] "
              "[device=cuda|cpu]\n"
              "       python -m lightgbm_tpu_torch task=predict "
              "input_model=<model> data=<file> [output_result=<file>] "
              "[device=cuda|cpu]\n"
              "       python -m lightgbm_tpu_torch serve "
              "input_model=<model> [serve_port=<p> serve_max_batch=<n> "
              "serve_max_delay_ms=<ms> predict_buckets=<b,...>]\n"
              "       python -m lightgbm_tpu_torch obs-report "
              "<events.jsonl ...> [--format=json|table] [--top=K] "
              "[--compile=<ledger.jsonl>]\n"
              "       python -m lightgbm_tpu_torch obs-report --traces "
              "<trace_events.json ...>")
        return 1
    # the offline run report takes positional files: it routes before
    # the key=value parser
    if argv[0] == "obs-report":
        from .obs.report import main as obs_report_main
        return obs_report_main(argv[1:])
    argv = ["task=serve" if tok == "serve" else tok for tok in argv]
    params = parse_cli_args(argv)
    config = Config(params)
    log.set_verbosity(config.verbose)
    # the sinks' write-failure policy for every task (train sets it
    # again in engine.train)
    from .utils import diskguard
    diskguard.set_default_policy(config.sink_error_policy or None)
    from .parallel.watchdog import (DISTRIBUTED_ABORT_EXIT_CODE,
                                    DistributedAborted)
    try:
        if config.task == "train":
            run_train(config, params)
        elif config.task in ("predict", "prediction", "test"):
            run_predict(config, params)
        elif config.task == "serve":
            run_serve(config, params)
        else:
            log.fatal("task=%s is not ported to the torch package yet "
                      "(train, predict and serve are)", config.task)
    except DistributedAborted as e:
        # a peer died or hung and the watchdog's cooperative check
        # tripped (its hard abort exits with the same code): exit so a
        # launcher restarts the pod, which resumes from the coordinated
        # snapshots.  os._exit: the group's shutdown would wait on the
        # dead peer
        log.warning("%s; exiting with code %d for the launcher to "
                    "restart", e, DISTRIBUTED_ABORT_EXIT_CODE)
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(DISTRIBUTED_ABORT_EXIT_CODE)
    return 0


if __name__ == "__main__":
    sys.exit(main())
