"""What the torch port refuses instead of silently giving another answer
than the JAX package (lightgbm_tpu_torch/config.py, cli.py).

The JAX package continues training from ``input_model``, stops early on
``early_stopping_round`` and writes leaf indices on
``is_predict_leaf_index``.  The port does none of these yet, so each is
refused with a ``LightGBMError`` that names it, under the JAX config's
aliases too.  Keys that cannot change a tree or a prediction keep one
warning.  (Side files and column roles are loaded since they were
ported: tests/test_torch_data_in.py holds them against the JAX
package.)
"""

import numpy as np
import pytest

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import LightGBMError, cli
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.utils import log

pytestmark = pytest.mark.torch


def _csv(path, n=60, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, 3))
    y = (X[:, 0] > 0).astype(float)
    np.savetxt(path, np.column_stack([y, X]), delimiter=",")
    return str(path)


def _train_args(tmp_path, data, *extra):
    return ["task=train", f"data={data}", "objective=binary", "device=cpu",
            "num_iterations=1", "num_leaves=4", "min_data_in_leaf=5",
            f"output_model={tmp_path / 'm.txt'}", *extra]


def test_train_without_side_files_still_trains(tmp_path):
    data = _csv(tmp_path / "train.csv")
    assert cli.main(_train_args(tmp_path, data)) == 0
    assert (tmp_path / "m.txt").exists()


@pytest.mark.parametrize("key", ["input_model", "model_input", "model_in"])
def test_train_with_input_model_is_refused(tmp_path, key):
    data = _csv(tmp_path / "train.csv")
    with pytest.raises(LightGBMError, match="input_model.*continued"):
        cli.main(_train_args(tmp_path, data, f"{key}=init.txt"))


def test_api_train_with_input_model_is_refused():
    rng = np.random.RandomState(0)
    X = rng.normal(size=(60, 3))
    ds = lt.Dataset(X, (X[:, 0] > 0).astype(float))
    with pytest.raises(LightGBMError, match="continued training"):
        lt.train({"objective": "binary", "input_model": "init.txt"}, ds, 1,
                  device="cpu", verbose_eval=False)


# (key as given, value, task, canonical name in the message): each
# canonical key and one JAX alias of it
REFUSED = [
    ("early_stopping_round", "5", "train", "early_stopping_round"),
    ("early_stopping_rounds", "5", "train", "early_stopping_round"),
    ("early_stopping", "3", "train", "early_stopping_round"),
    ("is_predict_leaf_index", "true", "predict", "is_predict_leaf_index"),
    ("predict_leaf_index", "true", "predict", "is_predict_leaf_index"),
    ("leaf_index", "true", "predict", "is_predict_leaf_index"),
]


@pytest.mark.parametrize("key,value,task,canonical", REFUSED)
def test_answer_changing_key_is_refused_by_the_cli(tmp_path, key, value,
                                                   task, canonical):
    data = _csv(tmp_path / "train.csv")
    args = (_train_args(tmp_path, data, f"{key}={value}") if task == "train"
            else ["task=predict", f"data={data}", "device=cpu",
                  f"input_model={tmp_path / 'm.txt'}", f"{key}={value}"])
    with pytest.raises(LightGBMError, match=canonical):
        cli.main(args)


def test_answer_changing_key_is_refused_by_the_api():
    rng = np.random.RandomState(0)
    X = rng.normal(size=(60, 3))
    with pytest.raises(LightGBMError, match="early_stopping_round"):
        lt.train({"objective": "binary", "early_stopping_rounds": 2},
                 lt.Dataset(X, (X[:, 0] > 0).astype(float)), 1,
                 device="cpu", verbose_eval=False)


def test_neutral_values_are_not_refused():
    Config({"objective": "binary", "early_stopping_round": 0,
            "label_column": "",
            "is_predict_leaf_index": "false"}).check_trainable()
    # leaf indices only change what task=predict writes
    Config({"task": "train", "objective": "binary",
            "is_predict_leaf_index": "true"}).check_trainable()


@pytest.mark.parametrize("key", ["num_threads", "metric_freq"])
def test_keys_that_cannot_change_the_answer_only_warn(key, capsys):
    log._warned_once.discard(f"config:{key}")
    cfg = Config({"objective": "binary", key: "4"})
    cfg.check_trainable()
    assert f"config:{key}" in log._warned_once
    assert "ignored" in capsys.readouterr().err
