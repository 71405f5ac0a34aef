"""The plain reference against lightgbm_tpu_torch at small sizes on the
CPU (``device="cpu"``): binning, gradients, the grown tree, the judge of
the program's trees, the forest walk and the model text."""

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from benchmark.data import forest, higgs_like, mslr_like
from benchmark.runners import train as dtrain
from benchmark.reference import binning, model_text, walk
from benchmark.reference import tree as rt

GEN = {"higgs.train": higgs_like, "mslr.train": mslr_like}


def _booster(cfg, X, y, group, rounds):
    ds = lt.Dataset(X, y, group=group, params=dict(cfg["params"]))
    b = lt.Booster(params=dict(cfg["params"]), train_set=ds, device="cpu")
    for _ in range(rounds):
        b.update()
    return ds, b


@pytest.fixture(params=["higgs.train", "mslr.train"])
def table(request, small):
    cfg, _ = small[request.param]
    X, y, group = GEN[request.param].make(cfg, 5, "cpu")
    return cfg, X, y, group


def test_bin_bounds_equal_the_programs(table):
    cfg, X, y, group = table
    ds, _ = _booster(cfg, X, y, group, 0)
    p = cfg["params"]
    ref = binning.bin_bounds(X, p["max_bin"], p["min_data_in_bin"],
                             p["bin_construct_sample_cnt"],
                             p["data_random_seed"])
    for mapper, bounds in zip(ds._binned.mappers, ref):
        np.testing.assert_array_equal(mapper.bin_upper_bound, bounds)


def test_gradients_match_the_programs(table):
    cfg, X, y, group = table
    _, b = _booster(cfg, X, y, group, 0)
    gb = b._booster
    rng = np.random.default_rng(3)
    # scores with ties inside queries, as trees leave them
    s = np.round(rng.normal(size=len(y)), 1).astype(np.float32)
    g_p, h_p = gb.objective.gradients_with(gb._grad_arrays,
                                           torch.from_numpy(s)[None])
    ref = dtrain.Reference(X, y, group, cfg, "cpu")
    g_r, h_r = ref.objective.gradients(ref.state,
                                       torch.from_numpy(s.astype(np.float64)))
    for p, r in ((g_p[0], g_r), (h_p[0], h_r)):
        err = (p.double() - r).abs().max() / r.abs().max()
        assert float(err) < 1e-5


def test_grown_tree_equals_the_programs(table):
    cfg, X, y, group = table
    _, b = _booster(cfg, X, y, group, 1)
    prog = model_text.parse_trees(b.model_to_string())[0]
    ref = dtrain.Reference(X, y, group, cfg, "cpu")
    g, h = ref.objective.gradients(ref.state,
                                   torch.zeros(len(y), dtype=torch.float64))
    t = rt.grow(ref.codes, ref.num_bin, g, h, ref.params)
    n = t["num_leaves"] - 1
    assert t["num_leaves"] == prog["num_leaves"]
    bins, misses = binning.threshold_bins(prog["split_feature"][:n],
                                          prog["threshold"][:n], ref.bounds)
    assert misses == 0
    np.testing.assert_array_equal(t["split_feature"], prog["split_feature"])
    np.testing.assert_array_equal(t["split_bin"], bins)
    np.testing.assert_array_equal(t["left_child"], prog["left_child"])
    np.testing.assert_array_equal(t["right_child"], prog["right_child"])
    np.testing.assert_allclose(t["leaf_value"], prog["leaf_value"],
                               rtol=1e-4, atol=1e-7)


def test_judge_reads_the_programs_trees_as_sound(table):
    cfg, X, y, group = table
    _, b = _booster(cfg, X, y, group, 4)
    trees = model_text.parse_trees(b.model_to_string())
    ref = dtrain.Reference(X, y, group, cfg, "cpu")
    got = ref.judge(trees, list(range(len(trees))), [0, 1],
                    b._inner_predict(0))
    assert got["threshold_misses"] == 0
    assert got["split_regret"] < 1e-9
    assert got["hessian_shortfall"] == 0
    assert got["leaf_value_gap"] < 1e-4
    assert got["score_gap"] < 1e-5


def test_walk_equals_the_programs_predict(small):
    cfg, traffic = small["higgs.score"]
    pool = higgs_like.pool(cfg, 4096, 9, "cpu")
    fc = cfg["forest"]
    trees = forest.make(torch.from_numpy(pool[-fc["sample_rows"]:]),
                        fc["trees"], fc["num_leaves"], fc["leaf_value_std"], 9)
    text = model_text.write_model(trees, cfg["features"])
    b = lt.Booster(model_str=text, device="cpu")
    got = b.predict(pool[:1000])
    raw, visits = walk.raw_scores(torch.from_numpy(pool[:1000]),
                                  walk.stack(trees, "cpu"))
    np.testing.assert_allclose(got, walk.sigmoid(raw).numpy(), atol=1e-7)
    assert visits >= 1000 * len(trees)
    # the text round-trips through the program's own writer
    again = model_text.parse_trees(b.model_to_string())
    for t0, t1 in zip(trees, again):
        for k in ("split_feature", "threshold", "left_child", "right_child",
                  "leaf_value"):
            np.testing.assert_array_equal(t0[k], t1[k])


def test_forest_has_the_configured_shape(small):
    cfg, _ = small["higgs.score"]
    pool = higgs_like.pool(cfg, 4096, 2, "cpu")
    trees = forest.make(torch.from_numpy(pool), 7, 31, 0.05, 2)
    assert len(trees) == 7
    for t in trees:
        assert t["num_leaves"] == 31
        kids = np.concatenate([t["left_child"], t["right_child"]])
        # every node but the root is a child once, every leaf once
        assert sorted(kids[kids >= 0].tolist()) == list(range(1, 30))
        assert sorted((~kids[kids < 0]).tolist()) == list(range(31))
        assert np.array_equal(t["leaf_value"],
                              t["leaf_value"].astype(np.float32))


def test_query_sizes_are_one_multiset_in_a_seeded_order(small):
    cfg, _ = small["mslr.train"]
    a = mslr_like.make(cfg, 1, "cpu")[2]
    b = mslr_like.make(cfg, 2, "cpu")[2]
    assert a.sum() == b.sum() == cfg["rows"]
    assert sorted(a.tolist()) == sorted(b.tolist())
    assert a.tolist() != b.tolist()
