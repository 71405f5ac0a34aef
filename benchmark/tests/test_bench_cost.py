"""The cost module against hand counts at tiny shapes."""

import numpy as np
import pytest

from benchmark.cost import (binary, k1, k4, lambdarank, peaks, score_call,
                            train_round)

#: a 3-leaf tree over 10 rows: the root splits 10 -> (4 | 6), then the
#: right child 6 -> (2 | 4); node 1 is the second split
TREE = {"num_leaves": 3, "left_child": np.array([-1, -2]),
        "right_child": np.array([1, -3]), "leaf_count": np.array([4, 2, 4]),
        "internal_count": np.array([10, 6])}


def test_k1_launch_counts_codes_gradients_and_histogram():
    # 10 rows x 2 one-byte codes + 8 bytes of g/h a row, a [2, 4] histogram
    # of three f32 sums; three additions a (row, feature)
    assert k1.launch(10, 2, 1, 4) == (10 * (2 + 8) + 2 * 4 * 3 * 4, 60)


def test_tree_windows_are_the_root_then_each_smaller_child():
    assert k1.tree_windows(TREE, 10) == [10, 4, 2]


def test_k4_launch():
    # 5 rows x 3 two-byte codes, 7 nodes x 16 bytes, 9 leaves x 4, 5 scores
    nbytes, ops = k4.launch(5, 3, 2, 2, 7, 9, visits=20)
    assert nbytes == 5 * 3 * 2 + 7 * 16 + 9 * 4 + 5 * 4
    assert ops == 20 + 5 * 2


def test_score_call_adds_the_transform():
    b, o = k4.launch(5, 3, 2, 2, 7, 9, 20)
    assert score_call.call_cost(5, 3, 2, 2, 7, 9, 20) == (b + 60, o + 20)


def test_train_round_sums_its_parts():
    nbytes, ops = train_round.round_cost(TREE, 10, 2, 1, 4, "binary", {})
    hb = sum(k1.launch(r, 2, 1, 4)[0] for r in (10, 4, 2))
    ho = sum(k1.launch(r, 2, 1, 4)[1] for r in (10, 4, 2))
    scan = 2 * 4
    part = (10 + 6) * (4 + 1 + 4)
    assert nbytes == 160 + hb + 2 * 2 * scan * 12 + part + 10 * 12
    assert ops == 100 + ho + 2 * 2 * scan * 12 + 10


def test_lambdarank_pairs_differ_in_label():
    # query 1: labels 0, 1, 1 -> 2 pairs; query 2: 2, 0 -> 1 pair
    w = lambdarank.pair_work(np.array([0, 1, 1, 2, 0]), np.array([3, 2]))
    assert w["pairs"] == 3
    assert w["sort_ops"] == 3 * 2 + 2 * 1
    assert lambdarank.gradients(5, **w) == (80, 20 * 3 + 8)
    assert binary.gradients(5) == (80, 50)


@pytest.mark.parametrize("nbytes,ops,rule", [(3.35e12, 1.0, "bytes"),
                                             (1.0, 67e12, "ops")])
def test_least_seconds_takes_the_ruling_bound(nbytes, ops, rule):
    assert peaks.least_seconds(nbytes, ops) == (1.0, rule)
