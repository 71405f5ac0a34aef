"""The port's ingest injectors (lightgbm_tpu_torch/testing/faults.py)
driving dirt through the port's loaders, against the JAX package, on
the CPU: the cases of the JAX package's tests/test_ingest_chaos.py that
the port's surface reaches.

* the injectors damage a file byte for byte as the JAX package's do and
  return the same line numbers;
* a 5%-mangled file under ``bad_data_policy=quarantine`` (one round and
  two) trains byte for byte the model of the clean subset, with
  ``bad_rows_total`` the mangled count and every line in the quarantine
  file, which is byte-equal to the JAX package's; ``fail_fast`` names
  the file, the first bad line and the token as the JAX package does;
  the budgets stop a mostly garbage file by name;
* a concurrent append during a two-round load is the named drift error;
* a mangled copy of ``examples/binary_classification/binary.train``
  trains the JAX package's trees, through the API and both CLIs, with
  the tolerances of ``tests/torch_example_parity.py``.
"""

import shutil
from unittest import mock

import numpy as np
import pytest

import lightgbm_tpu as lgb
import lightgbm_tpu.cli as jax_cli
from lightgbm_tpu import obs as jobs
from lightgbm_tpu.testing import faults as jfaults
from lightgbm_tpu.utils.log import LightGBMError as JaxError

import lightgbm_tpu_torch as lt
import lightgbm_tpu_torch.cli as torch_cli
from lightgbm_tpu_torch import obs as tobs
from lightgbm_tpu_torch.io.guard import read_quarantine
from lightgbm_tpu_torch.io.streaming import load_file_two_round
from lightgbm_tpu_torch.testing import faults
from lightgbm_tpu_torch.utils.log import LightGBMError

import chip_smoke as cs
from torch_example_parity import LEAF_RTOL, NAMES, TIE_RTOL
from torch_threads import one_torch_thread  # noqa: F401

GARBAGE = "##garbage##"
TRAIN_PARAMS = {"objective": "binary", "num_iterations": 5,
                "num_leaves": 7, "min_data_in_leaf": 10,
                "learning_rate": 0.2, "verbose": -1}


def _no_native():
    return mock.patch("lightgbm_tpu.io.native.parse_file_native",
                      return_value=None)


def _write_train_file(path, n=400, seed=7):
    """A TSV: label = f0 > 0 and three features, %.6f."""
    rng = np.random.RandomState(seed)
    rows = []
    for _ in range(n):
        f = rng.normal(size=3)
        rows.append("\t".join([f"{int(f[0] > 0)}"]
                              + [f"{v:.6f}" for v in f]))
    path.write_text("\n".join(rows) + "\n")
    return rows


def _train(pkg, path, extra):
    params = {**TRAIN_PARAMS, **extra}
    dev = {"device": "cpu"} if pkg is lt else {}
    with _no_native():
        return pkg.train(params, pkg.Dataset(str(path), params=params),
                         verbose_eval=False, **dev)


@pytest.mark.parametrize("injector,kwargs", [
    ("mangle_rows", {"fraction": 0.05, "seed": 3, "token": GARBAGE}),
    ("mangle_rows", {"fraction": 0.2, "seed": 1, "skip_header": True}),
    ("ragged_rows", {"fraction": 0.05, "seed": 2, "mode": "drop"}),
    ("ragged_rows", {"fraction": 0.1, "seed": 4, "mode": "add"}),
    ("truncate_mid_row", {}),
])
def test_injectors_damage_files_as_jax(tmp_path, injector, kwargs):
    out = []
    for mod, name in ((jfaults, "j.tsv"), (faults, "t.tsv")):
        path = tmp_path / name
        _write_train_file(path, n=120)
        out.append((getattr(mod, injector)(str(path), **kwargs),
                    path.read_bytes()))
    assert out[1] == out[0]
    with pytest.raises(ValueError, match="unknown mode"):
        faults.ragged_rows(str(tmp_path / "t.tsv"), mode="swap")


@pytest.mark.parametrize("two_round", [True, False])
def test_mangled_quarantine_matches_jax_and_the_clean_subset(tmp_path,
                                                             two_round):
    rows = None
    runs = {}
    for pkg, counters in ((lgb, jobs), (lt, tobs)):
        dirty = tmp_path / "train.tsv"
        rows = _write_train_file(dirty)
        mangled = faults.mangle_rows(str(dirty), fraction=0.05, seed=3,
                                     token=GARBAGE)
        assert len(mangled) == 20
        base = counters.get_counter("bad_rows_total")
        booster = _train(pkg, dirty, {"two_round": two_round,
                                      "bad_data_policy": "quarantine"})
        runs[pkg] = (booster, counters.get_counter("bad_rows_total") - base,
                     (tmp_path / "train.tsv.quarantine").read_bytes())
    (bj, nj, qj), (bt, nt, qt) = runs[lgb], runs[lt]
    assert nt == nj == len(mangled)
    assert qt == qj
    recs = read_quarantine(str(tmp_path / "train.tsv"))
    assert [r["line"] for r in recs] == mangled
    assert all(r["reason"] == "unparseable_token" and GARBAGE in r["raw"]
               for r in recs)
    # the clean subset, byte for byte
    clean = tmp_path / "clean.tsv"
    clean.write_text("\n".join(r for i, r in enumerate(rows, start=1)
                               if i not in mangled) + "\n")
    bc = _train(lt, clean, {"two_round": two_round})
    assert bt.model_to_string() == bc.model_to_string()
    # (this label is a threshold of one feature: its trees meet exact
    # ties of gains, which the two packages may break apart, so the JAX
    # trees are compared on the binary example below)
    assert bt.num_trees() == bj.num_trees() == 5


@pytest.mark.parametrize("two_round", [True, False])
def test_mangled_fail_fast_names_file_line_token_as_jax(tmp_path,
                                                        two_round):
    dirty = tmp_path / "train.tsv"
    _write_train_file(dirty)
    mangled = faults.mangle_rows(str(dirty), fraction=0.05, seed=3,
                                 token=GARBAGE)
    msgs = []
    for pkg, err in ((lgb, JaxError), (lt, LightGBMError)):
        with pytest.raises(err) as exc:
            _train(pkg, dirty, {"two_round": two_round})
        msgs.append(str(exc.value))
    assert msgs[1] == msgs[0]
    assert f"{dirty}:{mangled[0]}" in msgs[1] and GARBAGE in msgs[1]
    assert "fail_fast" in msgs[1]


@pytest.mark.parametrize("budget,what", [
    ({"max_bad_row_fraction": 0.1}, "max_bad_row_fraction=0.1"),
    ({"max_bad_row_fraction": 0.0, "max_bad_rows": 5}, "max_bad_rows=5"),
])
@pytest.mark.parametrize("two_round", [True, False])
def test_error_budget_stops_a_mostly_garbage_file_as_jax(tmp_path, budget,
                                                         what, two_round):
    dirty = tmp_path / "train.tsv"
    _write_train_file(dirty)
    faults.mangle_rows(str(dirty), fraction=0.5, seed=1, token=GARBAGE)
    extra = {"bad_data_policy": "quarantine", "two_round": two_round,
             **budget}
    msgs = []
    for pkg, err in ((lgb, JaxError), (lt, LightGBMError)):
        with pytest.raises(err, match="budget exhausted") as exc:
            _train(pkg, dirty, extra)
        msgs.append(str(exc.value))
    assert msgs[1] == msgs[0] and what in msgs[1]


def test_ragged_and_truncated_rows_quarantined(tmp_path):
    dirty = tmp_path / "train.tsv"
    _write_train_file(dirty, n=120)
    ragged = faults.ragged_rows(str(dirty), fraction=0.05, seed=2,
                                mode="drop")
    trunc_line = faults.truncate_mid_row(str(dirty))
    want = sorted(set(ragged) | {trunc_line})
    from lightgbm_tpu.io.guard import IngestGuard as JGuard
    from lightgbm_tpu.io.streaming import load_file_two_round as jload

    from lightgbm_tpu_torch.io.guard import IngestGuard
    out = []
    for guard, load in ((JGuard, jload), (IngestGuard, load_file_two_round)):
        g = guard(str(dirty), policy="quarantine")
        ds = load(str(dirty), max_bin=63, min_data_in_leaf=10, guard=g)
        out.append((ds.bins, (tmp_path / "train.tsv.quarantine")
                    .read_bytes(), dict(g.by_reason)))
    np.testing.assert_array_equal(out[1][0], out[0][0])
    assert out[1][1:] == out[0][1:]
    assert [r["line"] for r in read_quarantine(str(dirty))] == want
    assert out[1][0].shape[1] == 120 - len(want)


def test_concurrent_append_is_the_named_drift_error(tmp_path):
    p = tmp_path / "train.tsv"
    _write_train_file(p, n=100)
    msgs = []
    for mod, load in ((jfaults, None), (faults, load_file_two_round)):
        if load is None:
            from lightgbm_tpu.io.streaming import load_file_two_round as load
        _write_train_file(p, n=100)
        with mod.concurrent_append(str(p), "1\t0.5\t0.5\t0.5\n",
                                   after_reads=2) as st:
            with pytest.raises((JaxError, LightGBMError)) as exc:
                load(str(p), max_bin=63, min_data_in_leaf=10)
        assert st["appended"] and st["completed"] >= 2
        msgs.append(str(exc.value))
    assert msgs[1] == msgs[0]
    assert "changed between rounds" in msgs[1] and str(p) in msgs[1]
    # quiescent again: the same call loads the 101 rows
    ds = load_file_two_round(str(p), max_bin=63, min_data_in_leaf=10)
    assert ds.metadata.num_data == 101
    # through Dataset too
    _write_train_file(p, n=100)
    with faults.concurrent_append(str(p), "1\t0.5\t0.5\t0.5\n"):
        with pytest.raises(LightGBMError, match="changed between rounds"):
            lt.Dataset(str(p), params={"two_round": True}).construct()


def test_chunked_prediction_rows_align_with_blank_lines(tmp_path):
    train = tmp_path / "train.tsv"
    _write_train_file(train)
    bst = _train(lt, train, {})
    pred = tmp_path / "pred.tsv"
    rng = np.random.RandomState(5)
    lines = []
    for i in range(30):
        f = rng.normal(size=3)
        lines.append("\t".join([f"{int(f[0] > 0)}"]
                               + [f"{v:.6f}" for v in f]))
        if i % 4 == 0:
            lines.append("")
    pred.write_text("\n".join(lines) + "\n\n")
    old = type(bst)._PREDICT_CHUNK_ROWS
    type(bst)._PREDICT_CHUNK_ROWS = 7
    try:
        chunks = list(bst.predict_chunks(str(pred)))
    finally:
        type(bst)._PREDICT_CHUNK_ROWS = old
    assert sum(c.shape[1] for c in chunks) == 30
    whole = bst.predict(np.asarray(
        [[float(v) for v in ln.split("\t")[1:]]
         for ln in lines if ln.strip()], np.float64))
    np.testing.assert_allclose(
        np.concatenate([c.reshape(-1) for c in chunks]), whole,
        rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def mangled_binary(tmp_path_factory):
    """A 3%-mangled copy of the binary example's training file (without
    its .weight side file: quarantined rows make it unalignable) and
    the mangled lines."""
    work = tmp_path_factory.mktemp("binary")
    src = cs.REPO + "/examples/binary_classification/binary.train"
    path = work / "binary.train"
    shutil.copy(src, path)
    return path, faults.mangle_rows(str(path), fraction=0.03, seed=11)


@pytest.mark.parametrize("two_round", [True, False])
def test_mangled_binary_example_trains_jax_trees(mangled_binary, two_round):
    path, mangled = mangled_binary
    params = {"objective": "binary", "num_leaves": 31, "verbose": -1,
              "bad_data_policy": "quarantine", "two_round": two_round}
    with _no_native():
        bj = lgb.train(params, lgb.Dataset(str(path), params=params), 3,
                       verbose_eval=False)
    bt = lt.train(params, lt.Dataset(str(path), params=params), 3,
                  verbose_eval=False, device="cpu")
    assert [r["line"] for r in read_quarantine(str(path))] == mangled
    trees, flip, _ = cs.compare_model_texts(
        bt.model_to_string(), bj._booster.save_model_to_string(),
        "mangled binary.train", names=NAMES, tie_rtol=TIE_RTOL,
        leaf_rtol=LEAF_RTOL)
    assert trees == 3 and flip is None


def test_mangled_binary_example_through_both_clis(mangled_binary, tmp_path):
    path, mangled = mangled_binary
    argv = ["task=train", f"data={path}", "objective=binary",
            "num_leaves=31", "num_iterations=3", "two_round=true",
            "bad_data_policy=quarantine", "max_bad_rows=1000"]
    with _no_native():
        cs.run_main(jax_cli.main,
                    argv + [f"output_model={tmp_path / 'jax.txt'}"])
    jax_q = (path.parent / "binary.train.quarantine").read_bytes()
    cs.run_main(torch_cli.main, argv + [
        "device=cpu", f"output_model={tmp_path / 'torch.txt'}"])
    assert (path.parent / "binary.train.quarantine").read_bytes() == jax_q
    trees, flip, _ = cs.compare_model_texts(
        (tmp_path / "torch.txt").read_text(),
        (tmp_path / "jax.txt").read_text(), "CLI", names=NAMES,
        tie_rtol=TIE_RTOL, leaf_rtol=LEAF_RTOL)
    assert trees == 3 and flip is None
    with pytest.raises(LightGBMError, match="max_bad_rows=2"):
        cs.run_main(torch_cli.main, argv + ["device=cpu", "max_bad_rows=2",
                                            "output_model=never.txt"])
