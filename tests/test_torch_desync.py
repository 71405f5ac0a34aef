"""The port's desync detector (``GBDT._maybe_check_consistency``,
``distributed_consistency_check``, ``desync_policy``) and the rank fault
injectors, as the JAX package's tests/test_dist_consistency.py holds its
own: the digests, both policies against scripted gathers of a
monkeypatched world (the ``fail_fast`` and refusal texts compared with
the JAX package's, word for word), the resync on rank 0 and on a rank
other than 0, and no collective at all in one process.  The real
two-rank path is ``tests/test_torch_dist_chaos.py``."""

import pickle
import time
import types

import numpy as np
import pytest

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import obs
from lightgbm_tpu_torch.testing import faults

PARAMS = {"objective": "binary", "metric": ["binary_logloss"],
          "num_leaves": 5, "min_data_in_leaf": 5, "max_bin": 31,
          "learning_rate": 0.2, "verbose": -1}


def _data(seed=11, n=160, f=4):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, f))
    y = (X[:, 0] - 0.5 * X[:, 1] + 0.3 * rng.normal(size=n) > 0)
    return X, y.astype(np.float64)


def _train(params, rounds=4, callbacks=None, pkg=lt):
    X, y = _data()
    kw = {"device": "cpu"} if pkg is lt else {}
    return pkg.train(dict(PARAMS, **params), pkg.Dataset(X, y), rounds,
                     callbacks=callbacks, verbose_eval=False, **kw)


def _fake_world(monkeypatch, rank, world):
    import lightgbm_tpu.parallel.multihost as jmh
    import lightgbm_tpu_torch.parallel.multihost as tmh
    for mh in (jmh, tmh):
        monkeypatch.setattr(mh, "process_rank_world",
                            lambda: (rank, world))


def _comms():
    import lightgbm_tpu.parallel.comm as jcomm
    import lightgbm_tpu_torch.parallel.comm as tcomm
    return tcomm, jcomm


def _divergent_allgather(monkeypatch, comm, field_index, times=1, world=2,
                         odd_rank=1):
    """``comm``'s host gather: ``odd_rank``'s digest of one field differs
    on the first ``times`` calls, then the ranks agree."""
    calls = []

    def fake(x, *args):
        x = np.asarray(x)
        g = np.stack([x.copy() for _ in range(world)])
        calls.append(g)
        if len(calls) <= times:
            g[odd_rank, field_index] ^= np.uint64(1)
        return g

    monkeypatch.setattr(comm, "allgather_host_array", fake)
    return calls


# ---------------------------------------------------------------------------
# one process: no collective


def test_single_process_makes_no_collective_call(monkeypatch):
    tcomm, _ = _comms()

    def refuse(*a, **k):
        raise AssertionError("a collective in a one-process run")
    monkeypatch.setattr(tcomm, "allgather_host_array", refuse)
    monkeypatch.setattr(tcomm, "broadcast_host_bytes", refuse)
    before = obs.get_counter("desync_detected_total")
    base = _train({})
    checked = _train({"distributed_consistency_check": 1})
    assert obs.get_counter("desync_detected_total") == before
    assert base.model_to_string() == checked.model_to_string()


def test_k0_in_a_world_of_two_makes_no_collective_call(monkeypatch):
    tcomm, _ = _comms()
    _fake_world(monkeypatch, 0, 2)
    monkeypatch.setattr(tcomm, "allgather_host_array",
                        lambda *a: (_ for _ in ()).throw(AssertionError()))
    _train({"distributed_consistency_check": 0})


# ---------------------------------------------------------------------------
# the digests


def test_consistency_digests_deterministic_and_field_sensitive():
    a = _train({})._booster
    b = _train({})._booster
    da, db = a._consistency_digests(), b._consistency_digests()
    assert list(da) == ["iter", "trees", "score", "rng"]
    assert da == db
    a.train_data.score[0, 0] += 1.0
    dc = a._consistency_digests()
    assert dc["score"] != da["score"]
    assert (dc["trees"], dc["rng"], dc["iter"]) \
        == (da["trees"], da["rng"], da["iter"])


# ---------------------------------------------------------------------------
# the policies against scripted gathers, beside the JAX package


@pytest.mark.parametrize("field_index,name", [(0, "iter"), (1, "trees"),
                                              (2, "score"), (3, "rng")])
def test_fail_fast_names_rank_and_field_as_jax(monkeypatch, field_index,
                                               name):
    _fake_world(monkeypatch, 0, 2)
    msgs = []
    for pkg, comm in zip((lt, lgb), _comms()):
        calls = _divergent_allgather(monkeypatch, comm, field_index,
                                     times=99)
        with pytest.raises(pkg.LightGBMError) as ei:
            _train({"distributed_consistency_check": 2,
                    "desync_policy": "fail_fast"}, pkg=pkg)
        assert len(calls) == 1
        msgs.append(str(ei.value))
    assert f"field {name!r} diverged on rank(s) [1]" in msgs[0]
    assert "desync" in msgs[0]
    assert msgs[0] == msgs[1]


def test_fail_fast_counts_the_detection(monkeypatch):
    _fake_world(monkeypatch, 0, 3)
    tcomm, _ = _comms()
    _divergent_allgather(monkeypatch, tcomm, 2, times=99, world=3,
                         odd_rank=2)
    before = obs.get_counter("desync_detected_total")
    with pytest.raises(lt.LightGBMError, match=r"rank\(s\) \[2\]"):
        _train({"distributed_consistency_check": 2})
    assert obs.get_counter("desync_detected_total") == before + 1


def test_resync_rank0_continues_with_own_state(monkeypatch):
    _fake_world(monkeypatch, 0, 2)
    tcomm, _ = _comms()
    _divergent_allgather(monkeypatch, tcomm, field_index=2, times=1)
    broadcasts = []

    def fake_broadcast(payload, is_source, *args):
        assert is_source
        broadcasts.append(len(payload))
        return payload

    monkeypatch.setattr(tcomm, "broadcast_host_bytes", fake_broadcast)
    before = obs.get_counter("desync_resyncs_total")
    bst = _train({"distributed_consistency_check": 2,
                  "desync_policy": "resync"})
    ref = _train({})
    assert broadcasts
    assert obs.get_counter("desync_resyncs_total") == before + 1
    assert bst.model_to_string() == ref.model_to_string()


def test_resync_nonzero_rank_restores_the_broadcast_state(monkeypatch):
    _fake_world(monkeypatch, 1, 2)
    tcomm, _ = _comms()
    _divergent_allgather(monkeypatch, tcomm, field_index=2, times=1)
    clean = {}

    def fake_broadcast(payload, is_source, *args):
        assert not is_source
        # rank 0's state: the clean run's, at the same round
        return clean["blob"]

    monkeypatch.setattr(tcomm, "broadcast_host_bytes", fake_broadcast)

    def grab_clean(env):
        if env.iteration == 1:
            clean["blob"] = pickle.dumps(env.model._booster.snapshot_state(),
                                         protocol=pickle.HIGHEST_PROTOCOL)
    grab_clean.order = 50
    _fake_world(monkeypatch, 0, 1)
    ref = _train({}, callbacks=[grab_clean])
    _fake_world(monkeypatch, 1, 2)
    restored = []

    def corrupt_and_watch(env):
        gb = env.model._booster
        if env.iteration == 1:
            gb.train_data.score[0, 0] += 5.0    # this rank's desync
            orig = gb.restore_state

            def counting(state):
                restored.append(int(state["iter_"]))
                return orig(state)
            gb.restore_state = counting
    corrupt_and_watch.order = 60
    bst = _train({"distributed_consistency_check": 2,
                  "desync_policy": "resync"},
                 callbacks=[corrupt_and_watch])
    assert restored == [2]
    assert bst.model_to_string() == ref.model_to_string()


def test_resync_refuses_when_rank0_is_the_diverged_one(monkeypatch):
    _fake_world(monkeypatch, 0, 3)
    msgs = []
    for pkg, comm in zip((lt, lgb), _comms()):
        _divergent_allgather(monkeypatch, comm, field_index=2, times=99,
                             world=3, odd_rank=0)
        with pytest.raises(pkg.LightGBMError) as ei:
            _train({"distributed_consistency_check": 2,
                    "desync_policy": "resync"}, pkg=pkg)
        msgs.append(str(ei.value))
    assert "rank 0" in msgs[0] and "refusing" in msgs[0]
    assert msgs[0] == msgs[1]


def test_majority_and_tie_rules_match_jax(monkeypatch):
    """A 4-rank pod whose ranks 2 and 3 hold another score digest (a tie:
    rank 0's side is the reference) and whose rank 3 alone holds another
    rng digest (the majority wins)."""
    _fake_world(monkeypatch, 1, 4)
    msgs = []
    for pkg, comm in zip((lt, lgb), _comms()):
        def fake(x, *args):
            g = np.stack([np.asarray(x).copy() for _ in range(4)])
            g[2:, 2] ^= np.uint64(7)
            g[3, 3] ^= np.uint64(1)
            return g
        monkeypatch.setattr(comm, "allgather_host_array", fake)
        with pytest.raises(pkg.LightGBMError) as ei:
            _train({"distributed_consistency_check": 1}, pkg=pkg)
        msgs.append(str(ei.value))
    assert "field 'score' diverged on rank(s) [2, 3]" in msgs[0]
    assert "field 'rng' diverged on rank(s) [3]" in msgs[0]
    assert msgs[0] == msgs[1]


def test_broadcast_host_bytes_round_trips_odd_lengths():
    from lightgbm_tpu_torch.parallel.comm import (allgather_host_array,
                                                  broadcast_host_bytes)
    payload = b"\x00\x01hello desync resync payload!\xff" * 3 + b"x"
    assert len(payload) % 4 != 0
    assert broadcast_host_bytes(payload, is_source=True) == payload
    got = allgather_host_array(np.uint64([2 ** 63 + 5, 1]))
    assert got.dtype == np.uint64 and got.shape == (1, 2)
    assert int(got[0, 0]) == 2 ** 63 + 5


# ---------------------------------------------------------------------------
# the rank injectors


def test_rank_injectors_gate_on_rank_and_fire_in_order():
    env = types.SimpleNamespace(iteration=2, model=None)
    wrong = faults.delay_rank(2, delay_s=30.0, rank=7)
    t0 = time.perf_counter()
    wrong(env)
    assert time.perf_counter() - t0 < 1.0
    assert wrong.fired[0] == 0
    faults.kill_rank(2, rank=7)(env)
    slow = faults.delay_rank(2, delay_s=0.01, times=2, rank=0)
    for it in (1, 2, 3, 4):
        slow(types.SimpleNamespace(iteration=it, model=None))
    assert slow.fired[0] == 2
    hung = faults.hang_rank(2, rank=0, hang_s=30.0)
    hung.release.set()
    t0 = time.perf_counter()
    hung(env)
    assert time.perf_counter() - t0 < 1.0
    for cb in (wrong, hung):
        assert cb.before_iteration and cb.order == -99
    with pytest.raises(ValueError, match="unknown field"):
        faults.corrupt_rank_state(1, field="bias")


@pytest.mark.parametrize("field,moved", [("tree", "trees"),
                                         ("score", "score")])
def test_corrupt_rank_state_moves_only_its_digest(field, moved):
    bst = _train({})
    gb = bst._booster
    before = gb._consistency_digests()
    cb = faults.corrupt_rank_state(1, rank=0, field=field, scale=3.0)
    cb(types.SimpleNamespace(iteration=0, model=bst))
    assert not cb.fired[0]                   # before its round
    cb(types.SimpleNamespace(iteration=1, model=bst))
    after = gb._consistency_digests()
    assert cb.fired[0]
    assert [k for k in before if before[k] != after[k]] == [moved]
