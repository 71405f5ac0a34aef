"""Training through the port's fixed-trip growers (``serial_grow=cached``,
``serial_grow=fused``, and the nocache grower that the ``hist_cache``
degrade step selects) against the JAX package.

The same numpy matrix (the bench's Higgs-like generator, as in
tests/test_torch_train.py) trains in both packages with the same params:
binary, 15 leaves, 10 rounds, with a valid set.  Tree structures must be
equal in every round and the per-round valid AUC must match to 1e-4; the
value tolerances are test_torch_train.py's (the gradients' ``exp``
differs in the last bit between XLA and torch).  Each module-scoped
fixture trains one configuration in both packages once.

Also: the memory policy (the degrade warning once, ``fail_fast`` with a
small pool warns and keeps the cache, an unknown policy raises the JAX
text), the per-component estimate against the JAX package's, the CLI,
and that ``device=None`` raises without a card.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.models.gbdt import estimate_train_memory as jax_estimate

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import cli
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.parser import parse_file
from lightgbm_tpu_torch.models.gbdt import estimate_train_memory
from lightgbm_tpu_torch.utils import log

from test_torch_train import PARAMS, make_higgs_like

pytestmark = pytest.mark.torch

ROUNDS = 10
CONFIGS = {
    "cached": ({"serial_grow": "cached"}, "cached"),
    "fused": ({"serial_grow": "fused"}, "fused"),
    "degrade": ({"histogram_pool_size": 0.001, "memory_policy": "degrade"},
                "nocache"),
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def trained(request):
    extra, kind = CONFIGS[request.param]
    params = {**PARAMS, **extra}
    X, y = make_higgs_like(3000, seed=1)
    Xv, yv = make_higgs_like(800, seed=2)
    ej, et = {}, {}
    tj = lgb.Dataset(X, y)
    bj = lgb.train(params, tj, ROUNDS,
                   valid_sets=[lgb.Dataset(Xv, yv, reference=tj)],
                   evals_result=ej, verbose_eval=False)
    tt = lt.Dataset(X, y)
    bt = lt.train(params, tt, ROUNDS,
                  valid_sets=[lt.Dataset(Xv, yv, reference=tt)],
                  evals_result=et, device="cpu", verbose_eval=False)
    return dict(name=request.param, kind=kind, X=X, Xv=Xv, bj=bj, bt=bt,
                ej=ej, et=et)


def test_grower_kind_matches_jax(trained):
    assert trained["bt"]._booster.grow_kind == trained["kind"]
    assert trained["bj"]._booster._serial_grow_kind() == trained["kind"]


def test_tree_structures_equal_every_round(trained):
    mj = trained["bj"]._booster.models
    mt = trained["bt"]._booster.models
    assert len(mj) == len(mt) == ROUNDS
    for r, (a, b) in enumerate(zip(mj, mt), start=1):
        n = a.num_leaves
        assert b.num_leaves == n, f"round {r}: num_leaves"
        for field in ("split_feature", "threshold", "decision_type",
                      "left_child", "right_child", "leaf_parent",
                      "internal_count"):
            np.testing.assert_array_equal(
                getattr(b, field), getattr(a, field)[:len(getattr(b, field))],
                err_msg=f"round {r}: the tree structure diverged ({field})")
        np.testing.assert_array_equal(b.leaf_count, a.leaf_count[:n],
                                      err_msg=f"round {r}: leaf_count")
        for field in ("leaf_value", "internal_value"):
            np.testing.assert_allclose(
                getattr(b, field), getattr(a, field)[:len(getattr(b, field))],
                rtol=1e-4, atol=1e-7, err_msg=f"round {r}: {field}")


def test_per_round_auc_matches(trained):
    a = np.asarray(trained["ej"]["valid_0"]["auc"])
    b = np.asarray(trained["et"]["valid_0"]["auc"])
    assert len(a) == len(b) == ROUNDS
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-4)
    assert b[-1] > b[0] > 0.5


def test_raw_predictions_and_score_buffer(trained):
    Xq = trained["Xv"]
    np.testing.assert_allclose(trained["bt"].predict(Xq, raw_score=True),
                               trained["bj"].predict(Xq, raw_score=True),
                               rtol=0, atol=1e-5)
    score = trained["bt"]._booster.train_data.score[0].numpy()
    np.testing.assert_allclose(
        trained["bt"].predict(trained["X"], raw_score=True), score,
        rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# memory policy


def _warnings(capsys):
    return [ln for ln in capsys.readouterr().err.splitlines()
            if "[Warning]" in ln]


def test_degrade_warns_once(capsys, monkeypatch):
    # an earlier in-process CLI run with verbose=-1 (test_torch_train.py)
    # leaves the process's log level below warnings
    monkeypatch.setattr(log, "_current_level", 1)
    log._warned_once.discard("resource_degrade_hist_cache")
    X, y = make_higgs_like(600, seed=5)
    params = {**PARAMS, "histogram_pool_size": 0.001,
              "memory_policy": "degrade"}
    kinds = []
    for _ in range(2):
        b = lt.Booster(params=params, train_set=lt.Dataset(X, y),
                       device="cpu")
        kinds.append(b._booster.grow_kind)
        assert b._booster._degrade_steps == ("hist_cache",)
    assert kinds == ["nocache", "nocache"]
    warned = [w for w in _warnings(capsys)
              if "memory_policy=degrade: hist_cache" in w]
    assert len(warned) == 1
    assert "histogram_pool_size=0.001MB bounds the per-leaf histogram" \
        in warned[0]


@pytest.mark.parametrize("serial_grow", ["ordered", "cached"])
def test_fail_fast_small_pool_warns_and_keeps_cache(capsys, monkeypatch,
                                                   serial_grow):
    monkeypatch.setattr(log, "_current_level", 1)
    log._warned_once.discard("histogram_pool_size")
    X, y = make_higgs_like(600, seed=6)
    b = lt.Booster(params={**PARAMS, "histogram_pool_size": 0.001,
                           "serial_grow": serial_grow},
                   train_set=lt.Dataset(X, y), device="cpu")
    assert b._booster.grow_kind == serial_grow
    assert b._booster._degrade_steps == ()
    warned = [w for w in _warnings(capsys) if "does NOT bound memory" in w]
    assert len(warned) == 1 and "histogram_pool_size=0MB" in warned[0]
    # a pool the cache fits in, and the fused grower (no cache), are quiet
    for extra in ({"histogram_pool_size": 100.0, "memory_policy": "degrade"},
                  {"histogram_pool_size": 0.001, "serial_grow": "fused",
                   "memory_policy": "degrade"}):
        log._warned_once.clear()
        b = lt.Booster(params={**PARAMS, **extra},
                       train_set=lt.Dataset(X, y), device="cpu")
        assert b._booster._degrade_steps == ()
        assert not _warnings(capsys)


def test_unknown_memory_policy_raises_the_jax_text():
    with pytest.raises(ValueError) as ours:
        Config({"memory_policy": "lenient"})
    with pytest.raises(ValueError) as theirs:
        JaxConfig({"memory_policy": "lenient"})
    assert str(ours.value) == str(theirs.value)
    assert Config({}).memory_policy == JaxConfig({}).memory_policy
    assert Config({}).histogram_pool_size == JaxConfig({}).histogram_pool_size


@pytest.mark.parametrize("leaf_cache", [True, False])
def test_memory_estimate_matches_jax_terms(leaf_cache):
    args = (1_000_000, 28, 63, 255, 1)
    ours = estimate_train_memory(*args, bin_itemsize=1,
                                 leaf_cache=leaf_cache)
    theirs = jax_estimate(*args, bin_itemsize=1, leaf_cache=leaf_cache)
    for key in ("bins_device", "scores_and_gradients", "histogram_cache"):
        assert ours[key] == theirs[key], key
    assert ours["total"] == sum(v for k, v in ours.items() if k != "total")
    assert ours["histogram_cache"] == (63 * 28 * 9 * 255 * 4
                                       if leaf_cache else 0)


# ---------------------------------------------------------------------------
# entry points


def test_cli_train_fused_model_loads_in_jax(tmp_path):
    X, y = make_higgs_like(1500, seed=7)
    data = tmp_path / "train.csv"
    np.savetxt(data, np.column_stack([y, X]), delimiter=",", fmt="%.17g")
    model = tmp_path / "model.txt"
    argv = [f"data={data}", f"output_model={model}", "device=cpu",
            "verbose=-1", "num_iterations=4", "serial_grow=fused"] + [
        f"{k}={v}" for k, v in PARAMS.items() if k != "verbose"]
    assert cli.main(["task=train"] + argv) == 0
    # the API on the arrays the CLI reads (the native loader's values)
    yf, Xf, _ = parse_file(str(data))
    want = lt.train({**PARAMS, "serial_grow": "fused"}, lt.Dataset(Xf, yf),
                    4, device="cpu", verbose_eval=False).model_to_string()
    assert model.read_text() == want
    pj = lgb.Booster(model_file=str(model)).predict(X)
    pt = lt.Booster(model_file=str(model), device="cpu").predict(X)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-6)


def test_fused_train_without_device_raises_here(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = make_higgs_like(200, seed=4)
    params = {**PARAMS, "serial_grow": "fused"}
    with pytest.raises(lt.LightGBMError, match="no CUDA device"):
        lt.train(params, lt.Dataset(X, y), 1)
    with pytest.raises(lt.LightGBMError, match="no CUDA device"):
        lt.Booster(params=params, train_set=lt.Dataset(X, y))
