"""Command-line application for the port's train, predict and serve
tasks.

    python -m lightgbm_tpu_torch task=train data=train.csv \\
        objective=<objective> output_model=model.txt \\
        [valid_data=valid.csv] [config=train.conf] \\
        [num_iterations=100 num_leaves=63 ...] [device=cuda|cpu] \\
        [serial_grow=ordered|cached|fused] \\
        [histogram_pool_size=<MB> memory_policy=fail_fast|degrade]
    python -m lightgbm_tpu_torch task=predict input_model=model.txt \\
        data=rows.csv output_result=preds.txt [device=cuda|cpu]
    python -m lightgbm_tpu_torch task=serve input_model=model.txt \\
        serve_port=8080 [serve_max_batch=8192 serve_max_delay_ms=5]

Parameters parse as in the JAX CLI (``key=value`` tokens, ``config=``
file first, command line wins, the same aliases); keys this port does not
read are ignored with one warning each, and keys that would change the
answer are refused (``config.py``).  Data files are CSV, TSV or LibSVM
(io/parser.py), with the label in ``label_column`` (default the first
column); ``.weight``, ``.query`` and ``.init`` side files beside a data
or valid file are loaded, and the column roles (``weight_column``,
``group_column``, ``ignore_column``, ``categorical_column``) are taken.
Every objective of the JAX package trains.  ``python -m
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
from .io.column_roles import resolve_label_idx
from .io.parser import parse_file_chunks, read_header
from .utils import log


def _write_prediction_rows(fh, part: np.ndarray) -> None:
    """``[n]`` or ``[n, K]`` predictions -> ``%g`` lines (tab-joined
    per row for multiclass)."""
    if part.ndim == 1:
        for v in part:
            fh.write(f"{v:g}\n")
        return
    for row in part:
        fh.write("\t".join(f"{v:g}" for v in row) + "\n")


def run_predict(config: Config, params: Dict[str, str]) -> None:
    """task=predict: score ``data`` (CSV, TSV or LibSVM, densified to the
    model's width) with ``input_model`` through the forest-walk kernel;
    results stream to ``output_result``.  The label column is
    ``label_column`` when given, else the model's."""
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
    tmp = f"{out}.tmp{os.getpid()}"
    n_rows = 0
    with open(tmp, "w") as fh:
        for _, X in parse_file_chunks(config.data, config.has_header,
                                      label_idx, b.max_feature_idx + 1):
            part = booster.predict(
                X, num_iteration=config.num_iteration_predict,
                raw_score=config.is_predict_raw_score)
            _write_prediction_rows(fh, np.asarray(part))
            n_rows += X.shape[0]
    os.replace(tmp, out)
    log.info("%f seconds elapsed, finished prediction of %d rows",
             time.monotonic() - start, n_rows)
    log.info("Finished prediction. Results saved to %s", out)


def run_train(config: Config, params: Dict[str, str]) -> None:
    """task=train: bin ``data`` (with its side files and column roles)
    and each ``valid_data`` file against its mappers, boost
    ``num_iterations`` rounds on ``device``, log the metrics each
    ``output_freq`` rounds, save ``output_model``."""
    if not config.data:
        log.fatal("No training data specified (data=...)")
    config.check_trainable()          # before reading a large file
    start = time.monotonic()
    train_set = Dataset(config.data, params=dict(params))
    booster = Booster(params=dict(params), train_set=train_set,
                      device=config.device)
    for i, path in enumerate(config.valid_data):
        booster.add_valid(train_set.create_valid(path, params=dict(params)),
                          f"valid_{i + 1}")
    log.info("Finished loading data in %f seconds",
             time.monotonic() - start)
    for it in range(config.num_iterations):
        finished = booster.update()
        if (it + 1) % max(config.output_freq, 1) == 0:
            results = (booster.eval_train() if config.is_training_metric
                       else []) + booster.eval_valid()
            for name, metric, value, _ in results:
                log.info("Iteration:%d, %s %s : %g", it + 1, name, metric,
                         value)
        if finished:
            break
    booster.save_model(config.output_model)
    log.info("%f seconds elapsed, finished training",
             time.monotonic() - start)
    log.info("Finished training. Model saved to %s", config.output_model)


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
              "serve_max_delay_ms=<ms> predict_buckets=<b,...>]")
        return 1
    argv = ["task=serve" if tok == "serve" else tok for tok in argv]
    params = parse_cli_args(argv)
    config = Config(params)
    log.set_verbosity(config.verbose)
    if config.task == "train":
        run_train(config, params)
    elif config.task in ("predict", "prediction", "test"):
        run_predict(config, params)
    elif config.task == "serve":
        run_serve(config, params)
    else:
        log.fatal("task=%s is not ported to the torch package yet "
                  "(train, predict and serve are)", config.task)
    return 0


if __name__ == "__main__":
    sys.exit(main())
