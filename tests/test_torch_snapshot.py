"""Crash-safe snapshots in the port (lightgbm_tpu_torch/snapshot.py,
``GBDT.snapshot_state`` / ``restore_state``, ``engine.train``'s
``snapshot_dir``) against the JAX package's snapshot.py.

The file layer writes the JAX package's bytes for the same payload, and
both packages refuse the same truncated or bit-flipped files.  Resume is
bit-exact (train(N) == train(k) -> crash -> resume(N): the model text,
the predictions, the score buffer and ``evals_result``) for every grower
and sampler, as the JAX package's tests/test_fault_tolerance.py holds
its own; the resumed ordered model has the JAX package's train(N) trees.
The resume consensus of several ranks runs the JAX package's
tests/test_snapshot_dist.py cases under a monkeypatched world, each
beside the JAX package's decision on the same gathered values."""

import os

import numpy as np
import pytest

import chip_smoke as cs
import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu import snapshot as jsnap
from lightgbm_tpu.testing import faults as jfaults
from lightgbm_tpu_torch import obs
from lightgbm_tpu_torch import snapshot as tsnap
from lightgbm_tpu_torch.testing import faults
from lightgbm_tpu_torch.utils import log

# bagging + feature_fraction: the resume must restore both RNG streams
# mid-sequence
BASE = {"objective": "binary", "metric": ["binary_logloss"],
        "num_leaves": 7, "min_data_in_leaf": 5, "max_bin": 31,
        "learning_rate": 0.2, "bagging_fraction": 0.7, "bagging_freq": 1,
        "feature_fraction": 0.8, "verbose": -1}
N_ROUNDS = 6
CRASH_AT = 3
SNAP_FREQ = 2


def _data(seed=7, n=200, f=5, num_class=1):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, f))
    logit = 1.3 * X[:, 0] - X[:, 1] + 0.6 * X[:, 2] * X[:, 3]
    noisy = logit + rng.normal(scale=0.4, size=n)
    if num_class > 1:
        return X, np.digitize(noisy, [-0.8, 0.8]).astype(np.float64)
    return X, (noisy > 0).astype(np.float64)


class _Crash(RuntimeError):
    pass


def _crash_after(iteration):
    def cb(env):
        if env.iteration == iteration:
            raise _Crash(f"injected crash at iteration {iteration}")
    cb.order = 99
    return cb


def _train(params, num_rounds=N_ROUNDS, seed=7, callbacks=None):
    num_class = int(params.get("num_class", 1))
    X, y = _data(seed, f=8 if params.get("feature_screen_ratio") else 5,
                 num_class=num_class)
    Xv, yv = _data(seed + 1, f=X.shape[1], num_class=num_class)
    ds = lt.Dataset(X, y, params={"linear_tree": True}
                    if params.get("linear_tree") else None)
    ev = {}
    bst = lt.train(dict(params), ds, num_rounds,
                   valid_sets=[ds.create_valid(Xv, yv)], valid_names=["v0"],
                   evals_result=ev, verbose_eval=False, callbacks=callbacks,
                   device="cpu")
    return bst, ev


def _crash_then_resume(params, tmp_path, num_rounds=N_ROUNDS,
                       crash_at=CRASH_AT):
    snap = {**params, "snapshot_dir": str(tmp_path),
            "snapshot_freq": SNAP_FREQ}
    with pytest.raises(_Crash):
        _train(snap, num_rounds, callbacks=[_crash_after(crash_at)])
    return _train(snap, num_rounds)


def _assert_bit_identical(a, ev_a, b, ev_b):
    assert a.model_to_string() == b.model_to_string()
    Xq, _ = _data(seed=99, f=a._booster.max_feature_idx + 1)
    assert np.array_equal(a.predict(Xq), b.predict(Xq))
    assert np.array_equal(a._booster.train_data.score.numpy(),
                          b._booster.train_data.score.numpy())
    assert ev_a == ev_b


# ---------------------------------------------------------------------------
# the file layer, against the JAX package's


def _payload():
    return {"booster": {"x": np.arange(5, dtype=np.int64),
                        "w": np.linspace(0.0, 1.0, 7)},
            "rounds_done": 3, "world": {"num_processes": 1, "rank": 0,
                                        "digest": ""}}


def test_file_bytes_equal_jax_for_the_same_payload(tmp_path):
    assert tsnap.SNAPSHOT_MAGIC == jsnap.SNAPSHOT_MAGIC
    assert tsnap._encode(_payload()) == jsnap._encode(_payload())
    for r in (0, 7, 1234567):
        assert os.path.basename(tsnap.snapshot_path("d", r)) \
            == os.path.basename(jsnap.snapshot_path("d", r))
    ours = tsnap.write_snapshot(tsnap.snapshot_path(str(tmp_path / "t"), 3),
                                _payload())
    theirs = jsnap.write_snapshot(
        jsnap.snapshot_path(str(tmp_path / "j"), 3), _payload())
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    # each package reads the other's file of the same payload
    for read, path in ((tsnap.read_snapshot, theirs),
                       (jsnap.read_snapshot, ours)):
        back = read(path)
        assert np.array_equal(back["booster"]["x"], np.arange(5))


@pytest.mark.parametrize("damage", ["flip_last", "flip_header", "truncate",
                                    "truncate_header", "wrong_magic",
                                    "no_booster_key"])
def test_both_packages_refuse_the_same_damaged_files(tmp_path, damage):
    path = tsnap.snapshot_path(str(tmp_path), 3)
    state = _payload()
    if damage == "no_booster_key":
        state = {"rounds_done": 3}
    tsnap.write_snapshot(path, state)
    if damage == "flip_last":
        faults.flip_byte(path)
    elif damage == "flip_header":
        faults.flip_byte(path, offset=len(tsnap.SNAPSHOT_MAGIC) + 2)
    elif damage == "truncate":
        faults.truncate_file(path)
    elif damage == "truncate_header":
        faults.truncate_file(path, keep_bytes=20)
    elif damage == "wrong_magic":
        with open(path, "wb") as fh:
            fh.write(b"not a snapshot")
    assert tsnap.read_snapshot(path) is None
    assert jsnap.read_snapshot(path) is None
    assert tsnap.load_latest_snapshot(str(tmp_path)) is None


def test_list_and_prune_match_jax(tmp_path):
    for mod, sub in ((tsnap, "t"), (jsnap, "j")):
        d = tmp_path / sub
        for r in (2, 4, 6, 8):
            mod.write_snapshot(mod.snapshot_path(str(d), r), _payload())
        (d / "other.bin").write_bytes(b"x")
        mod.prune_snapshots(str(d), keep=2)
    assert [os.path.basename(p) for _, p in
            tsnap.list_snapshots(str(tmp_path / "t"))] \
        == [os.path.basename(p) for _, p in
            jsnap.list_snapshots(str(tmp_path / "j"))] \
        == ["snapshot_0000000008.bin", "snapshot_0000000006.bin"]


# ---------------------------------------------------------------------------
# bit-exact resume, every grower and sampler


@pytest.mark.parametrize("extra", [
    {"serial_grow": "ordered"},
    {"serial_grow": "cached"},
    {"serial_grow": "fused"},
    {"serial_grow": "cached", "histogram_pool_size": 0.001,
     "memory_policy": "degrade"},                          # nocache
    {"boosting_type": "goss", "bagging_fraction": 1.0, "bagging_freq": 0,
     "learning_rate": 0.5, "top_rate": 0.3, "other_rate": 0.2},
    {"boosting_type": "dart", "drop_rate": 0.5, "skip_drop": 0.25},
    {"linear_tree": True},
    {"feature_screen_ratio": 0.4, "feature_screen_warmup": 1,
     "feature_screen_refresh": 3},
    {"objective": "multiclass", "num_class": 3,
     "metric": ["multi_logloss"]},
], ids=["ordered", "cached", "fused", "nocache", "goss", "dart", "linear",
        "screening", "multiclass"])
def test_resume_bit_exact(tmp_path, extra):
    params = {**BASE, **extra}
    plain, ev_plain = _train(params)
    resumed, ev_resumed = _crash_then_resume(params, tmp_path)
    if "histogram_pool_size" in extra:
        assert resumed._booster.grow_kind == "nocache"
    _assert_bit_identical(plain, ev_plain, resumed, ev_resumed)


def test_resumed_ordered_model_has_jax_trees(tmp_path):
    params = {**BASE, "serial_grow": "ordered"}
    resumed, _ = _crash_then_resume(params, tmp_path)
    X, y = _data()
    bj = lgb.train(dict(params), lgb.Dataset(X, y), N_ROUNDS,
                   verbose_eval=False)
    trees, _, _ = cs.compare_model_texts(
        resumed.model_to_string(), bj.model_to_string(), "resumed",
        names=("torch", "jax"), tie_rtol=1e-5, leaf_rtol=1e-5)
    assert trees == N_ROUNDS


def test_corrupt_newest_snapshot_falls_back(tmp_path, capfd, monkeypatch):
    monkeypatch.setattr(log, "_current_level", 1)
    plain, ev_plain = _train(BASE)
    snap = {**BASE, "snapshot_dir": str(tmp_path),
            "snapshot_freq": SNAP_FREQ}
    with pytest.raises(_Crash):
        _train(snap, callbacks=[_crash_after(4)])
    rounds, newest = tsnap.list_snapshots(str(tmp_path))[0]
    assert rounds == 4
    faults.truncate_file(newest)
    before = obs.get_counter("snapshot_corrupt_skipped_total")
    path, state = tsnap.load_latest_snapshot(str(tmp_path))
    assert path.endswith(f"snapshot_{2:010d}.bin")
    assert state["rounds_done"] == 2
    assert obs.get_counter("snapshot_corrupt_skipped_total") == before + 1
    assert os.path.basename(newest) in capfd.readouterr().err
    resumed, ev_resumed = _train(snap)
    _assert_bit_identical(plain, ev_plain, resumed, ev_resumed)


def test_torn_write_never_damages_previous(tmp_path):
    plain, ev_plain = _train(BASE)
    snap = {**BASE, "snapshot_dir": str(tmp_path),
            "snapshot_freq": SNAP_FREQ}
    _train(snap, num_rounds=2)
    good = tsnap.snapshot_path(str(tmp_path), 2)
    good_bytes = open(good, "rb").read()
    with faults.torn_snapshot_write(after_bytes=64) as stats:
        with pytest.raises(faults.InjectedCrash):
            _train(snap)                     # resumes, dies at round 4
    assert stats["torn"] == [tsnap.snapshot_path(str(tmp_path), 4)]
    assert [r for r, _ in tsnap.list_snapshots(str(tmp_path))] == [2]
    assert open(good, "rb").read() == good_bytes
    resumed, ev_resumed = _train(snap)
    _assert_bit_identical(plain, ev_plain, resumed, ev_resumed)


def test_config_mismatch_is_refused_with_the_jax_text(tmp_path):
    msgs = []
    for pkg, sub in ((lt, "t"), (lgb, "j")):
        X, y = _data()
        snap = {**BASE, "snapshot_dir": str(tmp_path / sub),
                "snapshot_freq": 2}
        kw = {"device": "cpu"} if pkg is lt else {}
        pkg.train(dict(snap), pkg.Dataset(X, y), 2, verbose_eval=False,
                  **kw)
        with pytest.raises(pkg.LightGBMError) as ei:
            pkg.train({**snap, "num_leaves": 15}, pkg.Dataset(X, y), 4,
                      verbose_eval=False, **kw)
        msgs.append(str(ei.value))
    assert "mismatch" in msgs[0]
    assert msgs[0] == msgs[1]


def test_cli_string_keys_and_a_noop_resume(tmp_path):
    snap = {**BASE, "snapshot_dir": str(tmp_path), "snapshot_freq": "2",
            "snapshot_keep": "3"}
    bst, _ = _train(snap, num_rounds=4)
    assert [r for r, _ in tsnap.list_snapshots(str(tmp_path))] == [4, 2]
    bst2, _ = _train(snap, num_rounds=4)
    assert bst2.num_trees() == bst.num_trees()
    assert bst2.model_to_string() == bst.model_to_string()
    # save_period is snapshot_freq's alias
    bst3, _ = _train({**BASE, "snapshot_dir": str(tmp_path / "p"),
                      "save_period": "2"}, num_rounds=4)
    assert [r for r, _ in tsnap.list_snapshots(str(tmp_path / "p"))] \
        == [4, 2]
    assert bst3.model_to_string() == bst.model_to_string()


def test_cli_resumes_from_its_snapshot_dir(tmp_path, monkeypatch):
    from lightgbm_tpu_torch.cli import main as cli_main
    X, y = _data(n=300)
    with open(tmp_path / "train.csv", "w") as fh:
        for label, row in zip(y, X):
            fh.write(",".join([f"{label:g}"]
                              + [repr(float(v)) for v in row]) + "\n")
    monkeypatch.chdir(tmp_path)
    common = ["task=train", "data=train.csv", "objective=binary",
              "num_leaves=7", "min_data_in_leaf=5", "max_bin=31",
              "device=cpu", "verbose=-1", "num_trees=6"]
    assert cli_main(common + ["output_model=plain.txt"]) == 0
    snaps = ["snapshot_dir=snaps", "snapshot_freq=2"]
    assert cli_main(common[:-1] + ["num_trees=4", "output_model=a.txt"]
                    + snaps) == 0
    assert [r for r, _ in tsnap.list_snapshots("snaps")] == [4, 2]
    assert cli_main(common + snaps + ["output_model=b.txt"]) == 0
    assert (tmp_path / "b.txt").read_text() \
        == (tmp_path / "plain.txt").read_text()


def test_manual_snapshot_hooks_round_trip(tmp_path):
    X, y = _data()
    params = dict(BASE)
    a = lt.Booster(params=params, train_set=lt.Dataset(X, y), device="cpu")
    for _ in range(3):
        a.update()
    path = a.save_snapshot(str(tmp_path))
    assert path == tsnap.snapshot_path(str(tmp_path), 3)
    b = lt.Booster(params=params, train_set=lt.Dataset(X, y), device="cpu")
    assert b.restore_snapshot(str(tmp_path)) == 3
    for bst in (a, b):
        for _ in range(2):
            bst.update()
    assert a.model_to_string() == b.model_to_string()
    with pytest.raises(lt.LightGBMError, match="no valid snapshot"):
        b.restore_snapshot(str(tmp_path / "empty"))


# ---------------------------------------------------------------------------
# several ranks: the rank-0-writes rule and the resume consensus, under a
# monkeypatched world, beside the JAX package's decisions


DIST = {"objective": "binary", "metric": ["binary_logloss"],
        "num_leaves": 5, "min_data_in_leaf": 5, "max_bin": 31,
        "verbose": -1}


def _dist_pair():
    rng = np.random.RandomState(5)
    X = rng.normal(size=(150, 4))
    y = (X[:, 0] + 0.4 * X[:, 1] > 0).astype(np.float64)
    return (lt.train(dict(DIST), lt.Dataset(X, y), 3, verbose_eval=False,
                     device="cpu"),
            lgb.train(dict(DIST), lgb.Dataset(X, y), 3, verbose_eval=False))


@pytest.fixture(scope="module")
def dist_pair():
    return _dist_pair()


def _fake_world(monkeypatch, rank, world):
    import lightgbm_tpu.parallel.multihost as jmh
    import lightgbm_tpu_torch.parallel.multihost as tmh
    for mh in (jmh, tmh):
        monkeypatch.setattr(mh, "process_rank_world",
                            lambda: (rank, world))


def _canned_allgather(monkeypatch, responses):
    """Scripted ``[world, ...]`` gathers for both packages, in call order;
    later calls echo the caller's value on every rank."""
    import lightgbm_tpu.parallel.comm as jcomm
    import lightgbm_tpu_torch.parallel.comm as tcomm
    for comm in (jcomm, tcomm):
        canned = list(responses)

        def fake(x, *args, canned=canned):
            if canned:
                return np.asarray(canned.pop(0))
            x = np.asarray(x)
            return np.stack([x, x])
        monkeypatch.setattr(comm, "allgather_host_array", fake)


def test_non_zero_rank_never_writes(monkeypatch, tmp_path, dist_pair):
    bt, bj = dist_pair
    _fake_world(monkeypatch, 1, 2)
    assert not tsnap.is_snapshot_writer()
    assert bt.save_snapshot(str(tmp_path / "t")) is None
    assert bj.save_snapshot(str(tmp_path / "j")) is None
    assert not os.path.exists(tmp_path / "t")


def test_non_zero_rank_skips_even_a_torn_write(monkeypatch, tmp_path,
                                               dist_pair):
    bt, _ = dist_pair
    _fake_world(monkeypatch, 0, 2)
    first = bt.save_snapshot(str(tmp_path))
    assert first and tsnap.read_snapshot(first) is not None
    _fake_world(monkeypatch, 1, 2)
    with faults.torn_snapshot_write(after_bytes=16) as stats:
        assert bt.save_snapshot(str(tmp_path), rounds_done=9) is None
    assert stats["torn"] == []
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    assert [p for _, p in tsnap.list_snapshots(str(tmp_path))] == [first]


def test_rank0_torn_write_falls_back_to_previous(monkeypatch, tmp_path,
                                                 dist_pair):
    bt, _ = dist_pair
    _fake_world(monkeypatch, 0, 2)
    first = bt.save_snapshot(str(tmp_path))
    with faults.torn_snapshot_write(after_bytes=16):
        with pytest.raises(faults.InjectedCrash):
            bt.save_snapshot(str(tmp_path), rounds_done=9)
    found = tsnap.load_latest_snapshot(str(tmp_path))
    assert found is not None and found[0] == first


def test_world_block_recorded(monkeypatch, tmp_path, dist_pair):
    bt, bj = dist_pair
    _fake_world(monkeypatch, 0, 2)
    ours = tsnap.read_snapshot(bt.save_snapshot(str(tmp_path / "t")))
    theirs = jsnap.read_snapshot(bj.save_snapshot(str(tmp_path / "j")))
    for state in (ours, theirs):
        w = state["world"]
        assert w["num_processes"] == 2 and w["rank"] == 0
        assert len(w["digest"]) == 64
    assert ours["world"]["digest"] \
        == tsnap.replicated_state_digest(bt._booster)
    assert set(ours) == set(theirs)
    # the booster state carries the JAX package's fields by name
    assert set(theirs["booster"]) <= set(ours["booster"])


def _consensus_dirs(monkeypatch, tmp_path, dist_pair, rounds=(2, 3),
                    world=2):
    bt, bj = dist_pair
    _fake_world(monkeypatch, 0, world)
    for r in rounds:
        bt.save_snapshot(str(tmp_path / "t"), rounds_done=r)
        bj.save_snapshot(str(tmp_path / "j"), rounds_done=r)


def _decide(monkeypatch, tmp_path, responses):
    """Each package's consensus on its own directory, from the same
    gathered values: (rounds agreed or None, or the error's text with
    the directory taken out)."""
    out = []
    for mod, sub in ((tsnap, "t"), (jsnap, "j")):
        _canned_allgather(monkeypatch, [np.array(r) for r in responses])
        try:
            found = mod.coordinated_resume(str(tmp_path / sub))
            out.append(None if found is None else
                       (os.path.basename(found[0]),
                        found[1]["rounds_done"]))
        except Exception as e:  # noqa: BLE001 - compared below
            out.append(("error", type(e).__name__,
                        str(e).replace(str(tmp_path / sub), "<dir>")))
    assert out[0] == out[1], out
    return out[0]


def test_consensus_agreement(monkeypatch, tmp_path, dist_pair):
    _consensus_dirs(monkeypatch, tmp_path, dist_pair)
    assert _decide(monkeypatch, tmp_path, [np.int64([3, 3])]) \
        == ("snapshot_0000000003.bin", 3)


def test_consensus_takes_minimum_common_iteration(monkeypatch, tmp_path,
                                                  dist_pair):
    _consensus_dirs(monkeypatch, tmp_path, dist_pair)
    assert _decide(monkeypatch, tmp_path, [np.int64([3, 2])]) \
        == ("snapshot_0000000002.bin", 2)


def test_consensus_fresh_start_when_any_rank_has_none(monkeypatch,
                                                      tmp_path, dist_pair,
                                                      capfd):
    monkeypatch.setattr(log, "_current_level", 1)
    _consensus_dirs(monkeypatch, tmp_path, dist_pair)
    assert _decide(monkeypatch, tmp_path, [np.int64([3, -1])]) is None
    assert "starts FRESH" in capfd.readouterr().err


def test_consensus_refuses_diverged_replicas(monkeypatch, tmp_path,
                                             dist_pair):
    _consensus_dirs(monkeypatch, tmp_path, dist_pair)
    got = _decide(monkeypatch, tmp_path,
                  [np.int64([3, 3]), np.uint64([1, 2])])
    assert got[0] == "error" and "differs across ranks" in got[2]


def test_consensus_refuses_world_size_mismatch(monkeypatch, tmp_path,
                                               dist_pair):
    _consensus_dirs(monkeypatch, tmp_path, dist_pair, rounds=(2,), world=4)
    _fake_world(monkeypatch, 0, 2)
    got = _decide(monkeypatch, tmp_path, [np.int64([2, 2])])
    assert got[0] == "error" and "4-process" in got[2]


def test_consensus_single_process_is_plain_load(tmp_path, dist_pair):
    bt, _ = dist_pair
    path = bt.save_snapshot(str(tmp_path))
    found = tsnap.coordinated_resume(str(tmp_path))
    assert found is not None and found[0] == path


def test_torn_write_injector_matches_jax(tmp_path):
    # the same torn prefix: both injectors leave a .tmp of the same bytes
    for mod, fl, sub in ((tsnap, faults, "t"), (jsnap, jfaults, "j")):
        path = mod.snapshot_path(str(tmp_path / sub), 5)
        with fl.torn_snapshot_write(after_bytes=40):
            with pytest.raises(fl.InjectedCrash):
                mod.write_snapshot(path, _payload())
    assert (tmp_path / "t" / "snapshot_0000000005.bin.tmp").read_bytes() \
        == (tmp_path / "j" / "snapshot_0000000005.bin.tmp").read_bytes()
