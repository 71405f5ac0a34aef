"""The port's data-, feature- and voting-parallel learners
(``lightgbm_tpu_torch/parallel/``) against the JAX package's
``make_parallel_grow`` on a mesh of the host devices ``conftest.py``
forces.

One spawn a world size (2 and 4 gloo ranks on the CPU, each a process
of ``tests/torch_parallel_worker.py``) grows every case and trains every
learner; each test compares one result.  The cases are
``tests/test_parallel.py``'s: both ``hist_reduce`` modes, uneven rows,
uneven features, voting with ``top_k >= F``, a small ``top_k``, and the
election by per-feature maximum.  Splits, leaf ids and counts are
equal; leaf values within ``LEAF_OF_MAX`` of the tree's largest; the
collective bytes each rank counted equal the strategy's account, and
that account's bytes equal the JAX package's kind by kind.
"""

import json
import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from lightgbm_tpu.ops.grow import GrowParams as JaxGrowParams
from lightgbm_tpu.parallel import make_parallel_grow as jax_parallel_grow

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.parallel.launch import machine_list, run_ranks

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_parallel_worker.py")
B = 16
PARAMS = dict(num_leaves=15, max_bin=16, min_data_in_leaf=5,
              min_sum_hessian_in_leaf=1e-3)
TRAIN = {"objective": "binary", "num_leaves": 8, "max_bin": 32,
         "min_data_in_leaf": 10, "min_sum_hessian_in_leaf": 1e-3,
         "top_k": 8, "verbose": -1}
ROUNDS = 3
#: leaf values (and row deltas) against the JAX mesh, as a share of the
#: tree's largest leaf.  A leaf's value is -G / H of its f32 sums, and
#: XLA's ``psum`` and gloo's ``all_reduce`` add the ranks' partial sums
#: in their own orders: a leaf of few rows whose gradients cancel moves
#: by a few ulps of its summed magnitudes (2.7e-5 of the tree's largest
#: leaf on ``data_psum`` at 2 ranks)
LEAF_OF_MAX = 5e-5


def _data(seed=0, n=512, f=6):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, B, size=(f, n)).astype(np.uint8),
            rng.normal(size=n).astype(np.float32),
            (np.abs(rng.normal(size=n)) + 0.1).astype(np.float32))


def _election(world, per=64):
    """``tests/test_parallel.py``'s planted data over ``world`` shards:
    feature 0 a mild gain on every shard, feature 1 a perfect split on
    shard 0 only.  From 4 shards on, the global gain prefers feature 0
    and the per-feature maximum of the votes elects feature 1."""
    n = world * per
    g = np.zeros(n, np.float32)
    f0 = np.zeros(n, np.uint8)
    for s in range(world):
        lo = s * per
        f0[lo + 32:lo + per] = 1
        g[lo:lo + 24] = -1.0
        g[lo + 24:lo + 32] = 1.0
        g[lo + 32:lo + 56] = 1.0
        g[lo + 56:lo + per] = -1.0
    f1 = np.zeros(n, np.uint8)
    f1[:per] = (g[:per] > 0).astype(np.uint8)
    return np.stack([f0, f1]), g, np.ones(n, np.float32)


#: name -> (data, mode, options, params)
CASES = {
    "data_psum": (lambda w: _data(0), "data", {"hist_reduce": "psum"},
                  PARAMS),
    "data_reduce_scatter": (lambda w: _data(0), "data",
                            {"hist_reduce": "reduce_scatter"}, PARAMS),
    "data_uneven_rows": (lambda w: _data(3, n=509), "data", {}, PARAMS),
    "feature": (lambda w: _data(1), "feature", {}, PARAMS),
    "feature_uneven_5": (lambda w: _data(2, f=5), "feature", {}, PARAMS),
    "feature_uneven_10": (lambda w: _data(2, f=10), "feature", {}, PARAMS),
    "voting_full_topk": (lambda w: _data(4), "voting", {"top_k": 6},
                         PARAMS),
    "voting_small_topk": (lambda w: _data(5, f=12), "voting", {"top_k": 3},
                          PARAMS),
    "voting_election": (_election, "voting", {"top_k": 1},
                        dict(PARAMS, num_leaves=2)),
}


def _train_data():
    rng = np.random.RandomState(7)
    X = rng.normal(size=(600, 8))
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2]
         + 0.1 * rng.normal(size=600) > 0).astype(np.float32)
    return X, y


def _spawn(world, tmp):
    jobs = {"world": world, "out": str(tmp),
            "mlist": machine_list(str(tmp / "mlist.txt"), world),
            "grow": [], "train": []}
    for name, (make, mode, opts, params) in CASES.items():
        bins, g, h = make(world)
        path = tmp / f"{name}.npz"
        np.savez(path, bins=bins, g=g, h=h)
        jobs["grow"].append(dict(name=name, data=str(path), mode=mode,
                                 max_bin=B, params=params, **opts))
    X, y = _train_data()
    np.savez(tmp / "xy.npz", X=X, y=y)
    for learner in ("data", "feature", "voting"):
        jobs["train"].append(dict(
            name=f"train_{learner}", data=str(tmp / "xy.npz"),
            rounds=ROUNDS, params=dict(TRAIN, tree_learner=learner,
                                       num_machines=world)))
    (tmp / "jobs.json").write_text(json.dumps(jobs))
    codes, outs = run_ranks([[sys.executable, WORKER,
                              str(tmp / "jobs.json")]] * world, timeout=60)
    assert codes == [0] * world, outs[0][-3000:]
    return tmp


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    return _spawn(2, tmp_path_factory.mktemp("ranks2"))


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    return _spawn(4, tmp_path_factory.mktemp("ranks4"))


def _out(request, world):
    return request.getfixturevalue(f"ranks{world}")


def _jax_grow(world, name):
    make, mode, opts, params = CASES[name]
    bins, g, h = make(world)
    F, N = bins.shape
    mesh = Mesh(np.array(jax.devices()[:world]), ("shard",))
    fn = jax_parallel_grow(mesh, mode, JaxGrowParams(**params), **opts)
    tree, leaf, delta = fn(
        jnp.asarray(bins), jnp.full((F,), B, jnp.int32),
        jnp.zeros((F,), bool), jnp.ones((F,), bool), jnp.asarray(g),
        jnp.asarray(h), jnp.ones((N,), jnp.float32), jnp.float32(0.1))
    return tree, np.asarray(leaf), np.asarray(delta), fn.traffic_per_tree(F)


def _assert_tree_matches(jt, pt):
    assert int(jt.num_leaves) == int(pt["num_leaves"])
    for field in ("split_feature", "split_bin", "left_child",
                  "right_child", "leaf_count", "leaf_parent"):
        np.testing.assert_array_equal(np.asarray(getattr(jt, field)),
                                      pt[field], err_msg=field)
    np.testing.assert_allclose(pt["leaf_value"], np.asarray(jt.leaf_value),
                               rtol=0, atol=_leaf_atol(jt))


def _leaf_atol(jt):
    return LEAF_OF_MAX * float(np.abs(np.asarray(jt.leaf_value)).max())


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", sorted(CASES))
def test_learner_grows_the_jax_tree(request, world, name):
    out = _out(request, world)
    jt, jleaf, jdelta, _ = _jax_grow(world, name)
    for r in range(world):
        pt = np.load(out / f"{name}_r{r}.npz")
        _assert_tree_matches(jt, pt)
        np.testing.assert_array_equal(pt["leaf_id"], jleaf)
        np.testing.assert_allclose(pt["delta"], jdelta, rtol=0,
                                   atol=_leaf_atol(jt))
    if name == "voting_election" and world == 4:
        # the per-feature maximum elects feature 1 (a sum of the votes,
        # or the serial grower, would split on feature 0)
        assert int(jt.split_feature[0]) == 1


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", sorted(CASES))
def test_traffic_equals_the_account_and_jax(request, world, name):
    """Each rank's collectives moved the strategy's account: its calls
    (a split record is one gather) and its bytes, which are the JAX
    account's kind by kind (the row gather after a tree is outside the
    account, as the JAX package's process gather is)."""
    out = _out(request, world)
    _, _, _, jtraffic = _jax_grow(world, name)
    for r in range(world):
        pt = np.load(out / f"{name}_r{r}.npz")
        kinds = [str(k) for k in pt["kinds"]]
        measured = {k: int(b) for k, b in zip(kinds, pt["bytes"])
                    if k != "row_gather"}
        account = {k: int(b) for k, b in zip(kinds, pt["traffic_bytes"])
                   if b}
        calls = {k: int(c) for k, c in zip(kinds, pt["calls"])
                 if k != "row_gather"}
        assert measured == account
        assert calls == {k: int(c) for k, c in
                         zip(kinds, pt["traffic_calls"]) if c}
        assert account == {k: v["bytes"] for k, v in jtraffic.items()}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("learner", ["data", "feature", "voting"])
def test_distributed_train_equals_serial(request, world, learner):
    """``lt.train`` with a distributed learner: every rank writes the
    same model text, whose trees are the serial full-pass grower's
    (``top_k`` = F makes the voting election lossless)."""
    out = _out(request, world)
    texts = [(out / f"train_{learner}_r{r}.txt").read_text()
             for r in range(world)]
    assert all(t == texts[0] for t in texts)
    X, y = _train_data()
    serial = lt.train(dict(TRAIN, histogram_pool_size=0.001,
                           memory_policy="degrade"), lt.Dataset(X, y),
                      ROUNDS, device="cpu", verbose_eval=False)
    assert serial._booster.grow_kind == "nocache"
    dist = lt.Booster(model_str=texts[0], device="cpu")._booster.models
    assert len(dist) == ROUNDS
    for ts, tp in zip(serial._booster.models, dist):
        assert ts.num_leaves == tp.num_leaves
        np.testing.assert_array_equal(ts.split_feature, tp.split_feature)
        np.testing.assert_array_equal(ts.threshold, tp.threshold)
        scale = float(np.abs(ts.leaf_value).max())
        np.testing.assert_allclose(tp.leaf_value, ts.leaf_value, rtol=0,
                                   atol=1e-5 * scale)


@pytest.mark.parametrize("world", [2, 4])
def test_host_collectives(request, world):
    """The host collectives between rounds: every rank's small array
    stacked in rank order, and rank 0's bytes on every rank."""
    out = _out(request, world)
    for r in range(world):
        got = np.load(out / f"host_r{r}.npz")
        np.testing.assert_array_equal(
            got["gathered"], [[k, 10 * k] for k in range(world)])
        assert got["payload"].tobytes() == b"resync payload of rank 0"

