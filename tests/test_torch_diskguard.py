"""The port's disk-full-safe sinks (lightgbm_tpu_torch/utils/diskguard.py)
against the JAX package's utils/diskguard.py: the errno classes, the
``disable`` and ``fatal`` policies and the last-good rule of the atomic
writes, each failure injected through ``testing/faults.py``
``fail_writes`` / ``disk_full_after`` into the real write paths (the
model file, the binary dataset, the serving fleet's state file, the CLI's
predict output, the snapshots)."""

import errno
import os
import threading

import numpy as np
import pytest

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu.testing import faults as jfaults
from lightgbm_tpu.utils import diskguard as jdg
from lightgbm_tpu.utils import log as jlog
from lightgbm_tpu_torch import obs
from lightgbm_tpu_torch.testing import faults
from lightgbm_tpu_torch.utils import diskguard as tdg
from lightgbm_tpu_torch.utils import log

PARAMS = {"objective": "binary", "num_leaves": 7, "max_bin": 32,
          "min_data_in_leaf": 5, "verbose": -1}


def _data(n=300, f=5, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, f))
    y = (X[:, 0] - 0.7 * X[:, 1] + 0.3 * rng.normal(size=n) > 0)
    return X, y.astype(np.float64)


@pytest.fixture(autouse=True)
def _fresh_sinks():
    for dg in (tdg, jdg):
        dg.reset_disabled()
        dg.set_default_policy("disable")
    log.reset_warn_once()
    jlog.reset_warn_once()
    yield
    for dg in (tdg, jdg):
        dg.reset_disabled()
        dg.set_default_policy("disable")


# ---------------------------------------------------------------------------
# classification and policies, against the JAX package


@pytest.mark.parametrize("code", [errno.ENOSPC, errno.EDQUOT, errno.EROFS,
                                  errno.EMFILE, errno.ENFILE, errno.EIO,
                                  errno.EACCES, None])
def test_classify_oserror_matches_jax(code):
    exc = OSError(code, "injected") if code is not None else OSError("x")
    assert tdg.classify_oserror(exc) == jdg.classify_oserror(exc)
    assert tdg.ERRNO_CLASSES == jdg.ERRNO_CLASSES


def test_default_policy_is_validated_like_jax():
    assert tdg.POLICIES == jdg.POLICIES
    for dg in (tdg, jdg):
        assert dg.set_default_policy(None) == "disable"
        assert dg.set_default_policy("fatal") == "fatal"
        with pytest.raises(Exception, match="Unknown sink_error_policy"):
            dg.set_default_policy("warn")
        dg.set_default_policy("disable")
    for pkg in (lt.basic.Config, lgb.basic.Config):
        with pytest.raises(ValueError, match="Unknown sink_error_policy"):
            pkg({"sink_error_policy": "sometimes"})


def _stream(dg, fl, path, policy):
    """Three writes to a guarded stream under an ENOSPC injection; the
    booleans the writes returned, or the error's class."""
    out = []
    w = dg.GuardedWriter(str(path), "events", policy=policy)
    with fl(errno.ENOSPC, str(path.parent / "*")):
        try:
            for i in range(3):
                out.append(w.write(f"line {i}\n"))
        except dg.SinkWriteError as e:
            out.append((e.sink, e.classification))
    w.close()
    return out, dg.disabled_sinks()


@pytest.mark.parametrize("policy", ["disable", "fatal"])
def test_guarded_stream_policies_match_jax(tmp_path, policy, capfd,
                                           monkeypatch):
    monkeypatch.setattr(log, "_current_level", 1)
    c0 = obs.get_counter("sink_write_errors_events")
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    ours = _stream(tdg, faults.fail_writes, tmp_path / "t" / "ev.jsonl",
                   policy)
    theirs = _stream(jdg, jfaults.fail_writes, tmp_path / "j" / "ev.jsonl",
                     policy)
    assert ours == theirs
    # counted once, warned once (the later writes are dropped unseen)
    assert obs.get_counter("sink_write_errors_events") - c0 == 1
    err = capfd.readouterr().err
    assert err.count("[LightGBM-TPU-torch] [Warning] sink 'events'") == 1
    assert "disk_full" in err


def test_append_line_and_write_text_match_jax(tmp_path):
    for dg, fl, sub in ((tdg, faults.fail_writes, "t"),
                        (jdg, jfaults.fail_writes, "j")):
        d = tmp_path / sub
        d.mkdir()
        assert dg.append_line(str(d / "a.jsonl"), "{}", "ledger")
        with fl(errno.EROFS, str(d / "*")):
            assert not dg.append_line(str(d / "a.jsonl"), "{}", "ledger")
            with pytest.raises(dg.SinkWriteError) as ei:
                dg.write_text(str(d / "b.txt"), "x", "trace")
        assert ei.value.classification == "read_only_fs"
        assert "ledger" in dg.disabled_sinks()
        # a disabled sink stays off until re-armed
        assert not dg.append_line(str(d / "a.jsonl"), "{}", "ledger")
        dg.reset_disabled()
        assert dg.append_line(str(d / "a.jsonl"), "{}", "ledger")
        assert (d / "a.jsonl").read_text() == "{}\n{}\n"
        assert dg.probe_writable(str(d / "probe"), "cache")
        with fl(errno.EDQUOT, str(d / "*")):
            assert not dg.probe_writable(str(d), "cache")


def test_write_file_atomic_keeps_last_good(tmp_path):
    path = tmp_path / "state.bin"
    for dg, fl in ((tdg, faults.disk_full_after),
                   (jdg, jfaults.disk_full_after)):
        dg.write_file_atomic(str(path), b"good", "snapshot")
        with fl(8, str(tmp_path / "*")) as stats:
            dg.write_file_atomic(str(path), b"new", "snapshot")
            with pytest.raises(OSError) as ei:
                dg.write_file_atomic(str(path), b"too big", "snapshot")
        assert stats["fired"] == 1
        assert dg.classify_oserror(ei.value) == "disk_full"
        assert path.read_bytes() == b"new"
        assert not (tmp_path / "state.bin.tmp").exists()


def test_artifact_write_sweeps_tmp_on_a_serializer_error(tmp_path):
    path = tmp_path / "m.txt"
    path.write_text("good")
    with pytest.raises(ZeroDivisionError):
        with tdg.artifact_write(str(path), "model_file", atomic=True) as fh:
            fh.write("half")
            1 / 0
    assert path.read_text() == "good"
    assert not (tmp_path / "m.txt.tmp").exists()


# ---------------------------------------------------------------------------
# the port's sinks: last good kept


@pytest.mark.parametrize("inject", ["fail_writes", "disk_full_after"])
def test_model_file_save_failure_keeps_last_good(tmp_path, inject):
    X, y = _data()
    booster = lt.train(PARAMS, lt.Dataset(X, y), 3, device="cpu",
                       verbose_eval=False)
    model = tmp_path / "model.txt"
    booster.save_model(str(model))
    good = model.read_bytes()
    c0 = obs.get_counter("sink_write_errors_model_file")
    fault = (faults.fail_writes(errno.ENOSPC, str(tmp_path / "*"))
             if inject == "fail_writes"
             else faults.disk_full_after(16, str(tmp_path / "*")))
    with fault:
        with pytest.raises(tdg.SinkWriteError) as ei:
            booster.save_model(str(model))
    assert ei.value.sink == "model_file"
    assert ei.value.classification == "disk_full"
    assert obs.get_counter("sink_write_errors_model_file") - c0 == 1
    assert model.read_bytes() == good
    assert not (tmp_path / "model.txt.tmp").exists()


def test_binary_dataset_save_failure_keeps_last_good(tmp_path):
    X, y = _data(n=200)
    ds = lt.Dataset(X, y, params={"max_bin": 32}).construct()
    path = tmp_path / "train.bin"
    ds.save_binary(str(path))
    good = path.read_bytes()
    with faults.fail_writes(errno.EDQUOT, str(tmp_path / "*")):
        with pytest.raises(tdg.SinkWriteError) as ei:
            ds.save_binary(str(path))
    assert ei.value.sink == "binary_dataset"
    assert ei.value.classification == "quota_exceeded"
    assert path.read_bytes() == good
    assert not (tmp_path / "train.bin.tmp").exists()


@pytest.mark.parametrize("inject", ["fail_writes", "disk_full_after"])
def test_fleet_state_file_keeps_last_good(tmp_path, inject):
    from lightgbm_tpu_torch.serve.fleet import ModelManager
    state = tmp_path / "serve_state.json"
    mgr = ModelManager.__new__(ModelManager)
    mgr.state_file = str(state)
    mgr._state_lock = threading.Lock()
    model = tmp_path / "m.txt"
    model.write_text("x")
    mgr.note_good(str(model), target="primary", generation=4)
    assert ModelManager.restore_path(str(state)) == str(model)
    c0 = obs.get_counter("sink_write_errors_serve_state")
    fault = (faults.fail_writes(errno.EDQUOT, str(tmp_path / "*"))
             if inject == "fail_writes"
             else faults.disk_full_after(0, str(tmp_path / "*")))
    with fault:
        mgr.note_good("/models/never.txt", target="primary", generation=5)
    assert obs.get_counter("sink_write_errors_serve_state") - c0 == 1
    assert ModelManager.restore_path(str(state)) == str(model)
    assert not (tmp_path / "serve_state.json.tmp").exists()
    # the next write retries and lands
    model2 = tmp_path / "m2.txt"
    model2.write_text("y")
    mgr.note_good(str(model2), target="primary", generation=6)
    assert ModelManager.restore_path(str(state)) == str(model2)


def test_predict_output_enospc_is_a_named_fatal(tmp_path):
    from lightgbm_tpu_torch.cli import main as cli_main
    X, y = _data()
    booster = lt.train(PARAMS, lt.Dataset(X, y), 3, device="cpu",
                       verbose_eval=False)
    model = tmp_path / "model.txt"
    booster.save_model(str(model))
    data = tmp_path / "pred.tsv"
    with open(data, "w") as fh:
        for row in X:
            fh.write("0\t" + "\t".join(f"{v:g}" for v in row) + "\n")
    (tmp_path / "out").mkdir()
    out = tmp_path / "out" / "result.txt"
    with faults.fail_writes(errno.ENOSPC, str(tmp_path / "out" / "*")):
        with pytest.raises(lt.LightGBMError) as ei:
            cli_main(["task=predict", f"input_model={model}",
                      f"data={data}", f"output_result={out}",
                      "device=cpu", "verbose=-1"])
    msg = str(ei.value)
    assert "row(s) were written" in msg
    assert "disk_full" in msg


def test_snapshot_enospc_mid_run_is_contained_and_bit_identical(
        tmp_path, capfd, monkeypatch):
    """A full disk from round 5 on: the run finishes with the clean run's
    model, the write failures are counted and named, the last good
    snapshot is round 4's and no ``.tmp`` is left."""
    monkeypatch.setattr(log, "_current_level", 1)
    X, y = _data()
    params = dict(PARAMS, snapshot_freq=2)
    clean = lt.train(dict(params, snapshot_dir=str(tmp_path / "clean")),
                     lt.Dataset(X, y), 8, device="cpu", verbose_eval=False)
    c0 = obs.get_counter("sink_write_errors_total")
    snaps = tmp_path / "injected"
    with faults.fail_writes(errno.ENOSPC, str(snaps / "*"),
                            armed=False) as stats:
        def arm(env):
            if env.iteration >= 5:
                stats["armed"] = True
        arm.before_iteration = True
        arm.order = -99
        hit = lt.train(dict(params, snapshot_dir=str(snaps)),
                       lt.Dataset(X, y), 8, device="cpu",
                       verbose_eval=False, callbacks=[arm])
    assert hit.model_to_string() == clean.model_to_string()
    assert stats["fired"] == 2                  # rounds 6 and 8
    assert obs.get_counter("sink_write_errors_total") - c0 == 2
    assert "sink 'snapshot'" in capfd.readouterr().err
    from lightgbm_tpu_torch.snapshot import load_latest_snapshot
    found = load_latest_snapshot(str(snaps))
    assert found is not None and found[1]["rounds_done"] == 4
    assert not [f for f in os.listdir(snaps) if f.endswith(".tmp")]


def test_snapshot_tmp_sweep(tmp_path):
    """Orphaned ``.tmp`` files (a crash before the replace) are swept by
    ``prune_snapshots`` in both packages."""
    from lightgbm_tpu import snapshot as jsnap
    from lightgbm_tpu_torch import snapshot as tsnap
    for mod, sub in ((tsnap, "t"), (jsnap, "j")):
        d = tmp_path / sub
        d.mkdir()
        mod.write_snapshot(str(d / "snapshot_0000000002.bin"),
                           {"booster": {}, "rounds_done": 2})
        (d / "snapshot_0000000004.bin.tmp").write_bytes(b"torn")
        (d / "snapshot_0000000006.bin.tmp").write_bytes(b"torn too")
        mod.prune_snapshots(str(d), keep=0)
        assert sorted(os.listdir(d)) == ["snapshot_0000000002.bin"]


def test_sink_error_policy_key_sets_the_run_default(tmp_path):
    X, y = _data(n=120)
    lt.train(dict(PARAMS, sink_error_policy="fatal"), lt.Dataset(X, y), 1,
             device="cpu", verbose_eval=False)
    assert tdg.default_policy() == "fatal"
    lt.train(dict(PARAMS, sink_error_policy="disable"), lt.Dataset(X, y),
             1, device="cpu", verbose_eval=False)
    assert tdg.default_policy() == "disable"
