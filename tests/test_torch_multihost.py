"""Bring-up from the machine list (``lightgbm_tpu_torch/parallel/
multihost.py``) against the JAX package's, and the repo's
``examples/parallel_learning/train.conf`` through the port's CLI: as
written (one process: the world of one warns and trains serial) and as
two CLI processes over gloo on the CPU, whose model texts are equal and
whose trees are the serial full-pass grower's."""

import os
import shutil
import sys

import numpy as np
import pytest

from lightgbm_tpu.basic import LightGBMError as JaxError
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.parallel import multihost as jmh

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import cli
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.parallel import multihost as mh
from lightgbm_tpu_torch.parallel.launch import machine_list, run_ranks
from lightgbm_tpu_torch.utils import log
from lightgbm_tpu_torch.utils.log import LightGBMError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _both_parse(path):
    """The two packages' results (or error texts) for one list."""
    out = []
    for pkg, err in ((mh, LightGBMError), (jmh, JaxError)):
        try:
            out.append(pkg.parse_machine_list(str(path)))
        except err as exc:
            out.append(str(exc))
    return out


@pytest.mark.parametrize("text,want", [
    ("# cluster\n10.0.0.1 12400\n10.0.0.2,12401\n\nworker-3 12402\n",
     [("10.0.0.1", 12400), ("10.0.0.2", 12401), ("worker-3", 12402)]),
    ("# header\n10.0.0.1 12400\n10.0.0.1\n", ["line 3", "malformed"]),
    ("10.0.0.1 http\n", ["line 1", "not an integer"]),
    ("10.0.0.1 12400\n10.0.0.2 12400\n10.0.0.1 12400\n",
     ["line 3", "line 1", "10.0.0.1 12400", "duplicate"]),
    ("10.0.0.1 12400\n10.0.0.1 12401\n",
     [("10.0.0.1", 12400), ("10.0.0.1", 12401)]),
])
def test_parse_machine_list_as_jax(tmp_path, text, want):
    p = tmp_path / "mlist.txt"
    p.write_text(text)
    ours, theirs = _both_parse(p)
    if isinstance(want[0], tuple):
        assert ours == theirs == want
        return
    for piece in want + [str(p)]:
        assert piece in ours and piece in theirs, piece


def test_find_process_id_as_jax(monkeypatch):
    machines = [("a", 1), ("b", 2), ("c", 3)]
    monkeypatch.setenv("LIGHTGBM_TPU_PROCESS_ID", "2")
    assert mh.find_process_id(machines) == jmh.find_process_id(machines) == 2
    monkeypatch.setenv("LIGHTGBM_TPU_PROCESS_ID", "3")
    with pytest.raises(LightGBMError, match="out of range.*valid ids 0..2"):
        mh.find_process_id(machines)
    monkeypatch.setenv("LIGHTGBM_TPU_PROCESS_ID", "x")
    with pytest.raises(LightGBMError, match="not an integer"):
        mh.find_process_id(machines)
    monkeypatch.delenv("LIGHTGBM_TPU_PROCESS_ID")
    # 127.0.0.1 always matches a local address
    local = [("10.99.0.1", 12400), ("127.0.0.1", 12401)]
    assert mh.find_process_id(local) == jmh.find_process_id(local) == 1
    assert mh.find_process_id([("10.99.0.1", 12400)]) is None
    with pytest.raises(LightGBMError, match="matches this host 2 times"):
        mh.find_process_id([("127.0.0.1", 1), ("127.0.0.1", 2)])


def test_single_process_is_noop_and_the_backend_rule():
    for params in ({"task": "train", "objective": "binary"},
                   {"task": "train", "objective": "binary",
                    "num_machines": 4, "tree_learner": "data"}):
        assert mh.maybe_initialize_distributed(Config(params)) is False
        assert jmh.maybe_initialize_distributed(JConfig(params)) is False
    assert mh.process_rank_world() == (0, 1)
    # nccl only when each local rank has a card of its own
    assert mh.choose_backend(2, 1) == "gloo"
    assert mh.choose_backend(2, 0) == "gloo"
    assert mh.choose_backend(4, 4) == "nccl"
    assert mh.choose_backend(1, 8) == "nccl"
    assert mh.local_ranks([("h1", 1), ("h2", 2), ("h1", 3)], 2) == (1, 2)
    assert str(mh.rank_device(3, on_cpu=True)) == "cpu"


def _example(tmp_path):
    for name in ("parallel_learning", "binary_classification"):
        shutil.copytree(os.path.join(REPO, "examples", name),
                        tmp_path / name)
    return tmp_path / "parallel_learning"


ROUNDS = "num_trees=2"


def test_parallel_learning_conf_as_written_trains_serial(tmp_path,
                                                         monkeypatch,
                                                         capsys):
    work = _example(tmp_path)
    monkeypatch.chdir(work)
    log._warned_once.discard("distributed_heartbeat_ms")
    assert cli.main(["config=train.conf", "device=cpu", ROUNDS]) == 0
    err = capsys.readouterr().err
    assert "tree_learner=data requested but only 1 device(s) available; " \
           "falling back to serial" in err
    model = lt.Booster(model_file=str(work / "LightGBM_model.txt"),
                       device="cpu")
    assert model.num_trees() == 2


def test_parallel_learning_conf_on_two_cli_processes(tmp_path,
                                                     monkeypatch):
    work = _example(tmp_path)
    mlist = machine_list(str(work / "mlist.txt"), 2)
    argv = [[sys.executable, "-m", "lightgbm_tpu_torch", "config=train.conf",
             "num_machines=2", f"machine_list_file={mlist}", "device=cpu",
             ROUNDS, f"output_model=model_{r}.txt"] for r in range(2)]
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    codes, outs = run_ranks(argv, timeout=60, env=env, cwd=str(work))
    assert codes == [0, 0], outs[0][-3000:] + outs[1][-3000:]
    assert "Using data-parallel tree learner over 2 ranks" in outs[0]
    texts = [(work / f"model_{r}.txt").read_text() for r in range(2)]
    assert texts[0] == texts[1]
    # the serial full-pass grower's trees, in this process
    monkeypatch.chdir(work)
    assert cli.main(["config=train.conf", "device=cpu", ROUNDS,
                     "histogram_pool_size=0.001", "memory_policy=degrade",
                     "output_model=serial.txt"]) == 0
    serial = lt.Booster(model_file="serial.txt", device="cpu")._booster
    dist = lt.Booster(model_str=texts[0], device="cpu")._booster
    assert len(serial.models) == len(dist.models) == 2
    for ts, tp in zip(serial.models, dist.models):
        assert ts.num_leaves == tp.num_leaves
        np.testing.assert_array_equal(ts.split_feature, tp.split_feature)
        np.testing.assert_array_equal(ts.threshold, tp.threshold)
        scale = float(np.abs(ts.leaf_value).max())
        np.testing.assert_allclose(tp.leaf_value, ts.leaf_value, rtol=0,
                                   atol=1e-5 * scale)
