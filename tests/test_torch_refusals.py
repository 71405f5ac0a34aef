"""The keys of continued training, early stopping and leaf-index predict
(``input_model`` with ``task=train``, ``early_stopping_round``,
``is_predict_leaf_index``), under the JAX config's aliases, against the
JAX package; and the keys the port only warns about.

Each alias drives its feature and gives the JAX package's answer for
the canonical key: the port's CLI against the JAX CLI on the same CSV
files (trees structure-equal with thresholds to 1e-9 relative, as
``tests/torch_example_parity.py`` compares them: a package whose native
loader does not build parses with Python's ``float``; leaf values within
1e-5 of the tree's largest; the
same stop round; leaf indices equal).  Through the Python API these
keys belong to ``train``'s arguments (``init_model``,
``early_stopping_rounds``): as params they change nothing, in either
package.  The test names are those of the refusals these cases
replaced.  Keys that cannot change a tree or a prediction keep one
warning.  (Side files and column roles: tests/test_torch_data_in.py.)
"""

import os

import numpy as np
import pytest

import chip_smoke as cs
import lightgbm_tpu as lgb
import lightgbm_tpu.cli as jax_cli
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import cli
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.utils import log

pytestmark = pytest.mark.torch


def _csv(path, n=60, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, 3))
    y = (X[:, 0] > 0).astype(float)
    np.savetxt(path, np.column_stack([y, X]), delimiter=",")
    return str(path)


def _noisy_csv(path, n, seed):
    """A label the features explain only in part, so that a valid
    metric bottoms out within a few rounds of learning rate 0.5."""
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, 3))
    y = ((X[:, 0] + rng.normal(size=n)) > 0).astype(float)
    np.savetxt(path, np.column_stack([y, X]), delimiter=",")
    return str(path)


def _train_args(tmp_path, data, *extra):
    return ["task=train", f"data={data}", "objective=binary", "device=cpu",
            "num_iterations=1", "num_leaves=4", "min_data_in_leaf=5",
            f"output_model={tmp_path / 'm.txt'}", *extra]


def _common():
    return ["task=train", "data=tr.csv", "valid_data=va.csv",
            "objective=binary", "num_leaves=4", "min_data_in_leaf=5",
            "learning_rate=0.5"]


class _Work:
    """A directory with the CSV files and a 2-round init model of the
    port; ``jax(*args)`` (cached) and ``port(*args)`` train with
    ``_common() + args`` through each CLI there and return the model
    text and the log."""

    def __init__(self, path):
        self.path = str(path)
        self._jax = {}
        _noisy_csv(path / "tr.csv", 300, 0)
        _noisy_csv(path / "va.csv", 200, 1)
        with cs.in_dir(self.path):
            cs.run_main(cli.main, _common() + [
                "device=cpu", "num_iterations=2", "output_model=init.txt"])

    def _run(self, main, args, out):
        with cs.in_dir(self.path):
            text = cs.run_main(main, _common() + list(args)
                               + [f"output_model={out}"])
            with open(out) as fh:
                return fh.read(), text

    def jax(self, *args):
        if args not in self._jax:
            self._jax[args] = self._run(
                jax_cli.main, args + ("compile_cache_dir=off",),
                f"jax_{len(self._jax)}.txt")
        return self._jax[args]

    def port(self, *args):
        return self._run(cli.main, args + ("device=cpu",), "port.txt")


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return _Work(tmp_path_factory.mktemp("refusals"))


def _best_round(log_text):
    """The round the early-stopping message names as the best."""
    lines = log_text.splitlines()
    at = [i for i, ln in enumerate(lines) if "Early stopping" in ln]
    assert len(at) == 1, "no early stop"
    return lines[at[0] + 1].split("]")[0].lstrip("[")


def test_train_without_side_files_still_trains(tmp_path):
    data = _csv(tmp_path / "train.csv")
    assert cli.main(_train_args(tmp_path, data)) == 0
    assert (tmp_path / "m.txt").exists()


@pytest.mark.parametrize("key", ["input_model", "model_input", "model_in"])
def test_train_with_input_model_is_refused(work, key):
    """Each alias continues the init model as the JAX CLI continues it
    under ``input_model``: its 2 trees byte-equal, then 3 more."""
    jax_text, _ = work.jax("input_model=init.txt", "num_iterations=3")
    text, _ = work.port(f"{key}=init.txt", "num_iterations=3")
    with open(os.path.join(work.path, "init.txt")) as fh:
        init = fh.read()
    carried = init[init.index("Tree=0"):init.index("\nfeature importances")]
    assert carried in text
    trees, flip, _ = cs.compare_model_texts(
        text, jax_text, key, names=("torch", "jax"), tie_rtol=1e-5,
        leaf_rtol=1e-5)
    assert trees == 5 and flip is None


def test_api_train_with_input_model_is_refused(tmp_path):
    """``init_model=`` continues in both packages; an ``input_model``
    param is the CLI's and changes nothing in ``train``, in either."""
    rng = np.random.RandomState(0)
    X = rng.normal(size=(300, 3))
    y = ((X[:, 0] + rng.normal(size=300)) > 0).astype(float)
    params = {"objective": "binary", "num_leaves": 4, "min_data_in_leaf": 5,
              "verbose": -1}
    init = str(tmp_path / "init.txt")
    lt.train(params, lt.Dataset(X, y), 2, device="cpu",
             verbose_eval=False).save_model(init)
    for extra, kwargs, trees in (({}, {"init_model": init}, 3),
                                 ({"input_model": init}, {}, 1)):
        bj = lgb.train({**params, **extra}, lgb.Dataset(X, y), 1,
                       verbose_eval=False, **kwargs)
        bt = lt.train({**params, **extra}, lt.Dataset(X, y), 1,
                      device="cpu", verbose_eval=False, **kwargs)
        assert bt.num_trees() == bj.num_trees() == trees
        cs.compare_model_texts(bt.model_to_string(), bj.model_to_string(),
                               str(extra), tie_rtol=1e-5, leaf_rtol=1e-5)
        np.testing.assert_allclose(bt.predict(X, raw_score=True),
                                   bj.predict(X, raw_score=True), atol=1e-5)


# (key as given, value, task, canonical name): each canonical key and
# two JAX aliases of it
REFUSED = [
    ("early_stopping_round", "5", "train", "early_stopping_round"),
    ("early_stopping_rounds", "5", "train", "early_stopping_round"),
    ("early_stopping", "3", "train", "early_stopping_round"),
    ("is_predict_leaf_index", "true", "predict", "is_predict_leaf_index"),
    ("predict_leaf_index", "true", "predict", "is_predict_leaf_index"),
    ("leaf_index", "true", "predict", "is_predict_leaf_index"),
]


@pytest.mark.parametrize("key,value,task,canonical", REFUSED)
def test_answer_changing_key_is_refused_by_the_cli(work, key, value, task,
                                                   canonical):
    """Early stopping: the stop round (every trained tree saved), the
    best round and every round's metric of the JAX CLI under the
    canonical key.  Leaf-index predict: the JAX CLI's output, equal."""
    if task == "train":
        jax_text, jax_log = work.jax(f"{canonical}={value}",
                                     "num_iterations=40")
        text, port_log = work.port(f"{key}={value}", "num_iterations=40")
        trees, flip, _ = cs.compare_model_texts(
            text, jax_text, key, names=("torch", "jax"), tie_rtol=1e-5,
            leaf_rtol=1e-5)
        assert flip is None and trees < 40, "no early stop"
        assert _best_round(port_log) == _best_round(jax_log)
        pj, pt = cs.round_metrics(jax_log), cs.round_metrics(port_log)
        assert pt.keys() == pj.keys()
        assert max(k[0] for k in pt) == trees
        for k in pj:
            assert abs(pt[k] - pj[k]) <= 1e-4, k
        return
    with cs.in_dir(work.path):
        cs.run_main(jax_cli.main, ["task=predict", "data=va.csv",
                                   "input_model=init.txt",
                                   f"{canonical}={value}",
                                   "output_result=jax_leaf.txt"])
        cs.run_main(cli.main, ["task=predict", "data=va.csv", "device=cpu",
                               "input_model=init.txt", f"{key}={value}",
                               "output_result=port_leaf.txt"])
        with open("jax_leaf.txt") as a, open("port_leaf.txt") as b:
            want, got = a.read(), b.read()
    assert got == want
    assert np.loadtxt(os.path.join(work.path, "port_leaf.txt")).shape \
        == (200, 2)


def test_answer_changing_key_is_refused_by_the_api():
    """``early_stopping_rounds=`` stops ``train`` at JAX's round; as a
    param it is the CLI's and changes nothing in ``train``, in either
    package."""
    rng = np.random.RandomState(0)
    X = rng.normal(size=(300, 3))
    y = ((X[:, 0] + rng.normal(size=300)) > 0).astype(float)
    Xv = rng.normal(size=(200, 3))
    yv = ((Xv[:, 0] + rng.normal(size=200)) > 0).astype(float)
    params = {"objective": "binary", "num_leaves": 4, "min_data_in_leaf": 5,
              "learning_rate": 0.5, "verbose": -1}
    for extra, kwargs in (({}, {"early_stopping_rounds": 2}),
                          ({"early_stopping_rounds": 2}, {})):
        out = []
        for pkg, dev in ((lgb, {}), (lt, {"device": "cpu"})):
            ds = pkg.Dataset(X, y)
            out.append(pkg.train({**params, **extra}, ds, 30,
                                 valid_sets=[pkg.Dataset(Xv, yv,
                                                         reference=ds)],
                                 verbose_eval=False, **kwargs, **dev))
        bj, bt = out
        assert bt.best_iteration == bj.best_iteration
        assert bt.num_trees() == bj.num_trees()
        assert (bt.num_trees() < 30) == bool(kwargs)


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
