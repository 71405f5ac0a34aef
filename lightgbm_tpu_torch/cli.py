"""Command-line application for the port's train, predict and serve
tasks.

    python -m lightgbm_tpu_torch task=train data=train.csv \\
        objective=binary output_model=model.txt [valid_data=valid.csv] \\
        [num_iterations=100 num_leaves=63 ...] [device=cuda|cpu] \\
        [serial_grow=ordered|cached|fused] \\
        [histogram_pool_size=<MB> memory_policy=fail_fast|degrade]
    python -m lightgbm_tpu_torch task=predict input_model=model.txt \\
        data=rows.csv output_result=preds.txt [device=cuda|cpu]
    python -m lightgbm_tpu_torch task=serve input_model=model.txt \\
        serve_port=8080 [serve_max_batch=8192 serve_max_delay_ms=5]

Parameters parse as in the JAX CLI (``key=value`` tokens, ``config=``
file first, command line wins, the same aliases); keys this port does not
read are ignored with one warning each.  Data files are dense CSV/TSV
with the label in the first column.  ``python -m lightgbm_tpu_torch
serve ...`` is sugar for ``task=serve``.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Dict, Iterator, List

import numpy as np

from .basic import Booster, Dataset
from .config import Config, parse_cli_args
from .utils import log
from .utils.log import LightGBMError

_CHUNK_ROWS = 1 << 16
_NA = {"", "na", "nan", "null", "none"}


def _value(tok: str) -> float:
    tok = tok.strip()
    if tok.lower() in _NA:
        return float("nan")
    return float(tok)


def _parse_lines(lines: List[str], numbers: List[int], delim: str,
                 path: str) -> np.ndarray:
    rows = []
    width = None
    for ln, no in zip(lines, numbers):
        parts = ln.strip().split(delim)
        if width is None:
            width = len(parts)
        elif len(parts) != width:
            raise LightGBMError(
                f"{path}:{no}: ragged_row: {len(parts)} fields where the "
                f"file has {width}")
        try:
            rows.append([_value(p) for p in parts])
        except ValueError:
            raise LightGBMError(f"{path}:{no}: unparseable_token in "
                                f"{ln.strip()[:80]!r}")
    return np.asarray(rows, np.float64).reshape(len(rows), width or 0)


def _split_label(mat: np.ndarray, label_idx: int, with_label: bool):
    label = None
    if 0 <= label_idx < mat.shape[1]:
        label = mat[:, label_idx].copy()
        mat = np.delete(mat, label_idx, axis=1)
    return (mat, label) if with_label else mat


def read_rows(path: str, has_header: bool, label_idx: int,
              with_label: bool = False) -> Iterator:
    """Dense CSV/TSV feature rows of ``path`` in chunks (the label
    column ``label_idx`` dropped; blank lines skipped; NA -> NaN).  With
    ``with_label`` each chunk is ``(rows, labels)``."""
    delim = None
    lines: List[str] = []
    numbers: List[int] = []
    with open(path, "r", errors="replace") as fh:
        for no, line in enumerate(fh, start=1):
            if has_header and no == 1:
                continue
            if not line.strip():
                continue
            if delim is None:
                if ":" in line and line.count(":") >= max(
                        line.count(","), line.count("\t")):
                    raise LightGBMError(
                        f"{path}: LibSVM input is not supported by the "
                        f"torch port yet (use CSV or TSV)")
                delim = "\t" if line.count("\t") >= line.count(",") \
                    and "\t" in line else ","
            lines.append(line)
            numbers.append(no)
            if len(lines) >= _CHUNK_ROWS:
                yield _split_label(_parse_lines(lines, numbers, delim, path),
                                   label_idx, with_label)
                lines, numbers = [], []
    if lines:
        yield _split_label(_parse_lines(lines, numbers, delim, path),
                           label_idx, with_label)


def read_labeled(path: str, has_header: bool):
    """The whole of a training file: ([N, F] rows, [N] labels from the
    first column)."""
    parts = list(read_rows(path, has_header, 0, with_label=True))
    if not parts:
        raise LightGBMError(f"{path}: no data rows")
    return (np.concatenate([p[0] for p in parts], axis=0),
            np.concatenate([p[1] for p in parts]))


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
    """task=predict: score ``data`` with ``input_model`` through the
    forest-walk kernel; results stream to ``output_result``."""
    if not config.input_model:
        log.fatal("No model file specified (input_model=...)")
    if not config.data:
        log.fatal("No prediction data specified (data=...)")
    booster = Booster(model_file=config.input_model, params=dict(params),
                      device=config.device)
    b = booster._booster
    start = time.monotonic()
    out = config.output_result or "LightGBM_predict_result.txt"
    tmp = f"{out}.tmp{os.getpid()}"
    n_rows = 0
    with open(tmp, "w") as fh:
        for X in read_rows(config.data, config.has_header, b.label_idx):
            if X.shape[1] < b.max_feature_idx + 1:
                pad = np.zeros((X.shape[0], b.max_feature_idx + 1))
                pad[:, :X.shape[1]] = X
                X = pad
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
    """task=train: bin ``data`` (and each ``valid_data`` file against its
    mappers), boost ``num_iterations`` rounds on ``device``, log the
    metrics each ``output_freq`` rounds, save ``output_model``."""
    if not config.data:
        log.fatal("No training data specified (data=...)")
    config.check_trainable()          # before reading a large file
    start = time.monotonic()
    X, y = read_labeled(config.data, config.has_header)
    train_set = Dataset(X, y, params=dict(params))
    booster = Booster(params=dict(params), train_set=train_set,
                      device=config.device)
    for i, path in enumerate(config.valid_data):
        Xv, yv = read_labeled(path, config.has_header)
        booster.add_valid(train_set.create_valid(Xv, yv), f"valid_{i + 1}")
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
        print("usage: python -m lightgbm_tpu_torch task=train "
              "data=<csv> objective=binary [output_model=<file>] "
              "[valid_data=<csv>] [device=cuda|cpu]\n"
              "       python -m lightgbm_tpu_torch task=predict "
              "input_model=<model> data=<csv> [output_result=<file>] "
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
