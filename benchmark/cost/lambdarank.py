"""Bytes and operations of the LambdaRank gradient pass: each document's
score and label read and its gradient and hessian written (float32, 16
bytes), the query's sort (log2(n) comparisons a document) and twenty
operations a pair of documents whose labels differ (the NDCG weight, the
score gap's normalisation, an exponential, the sigmoid and the four
accumulations)."""

from __future__ import annotations

import numpy as np


def pair_work(label: np.ndarray, group: np.ndarray) -> dict:
    """The pairs with differing labels and the sort comparisons of the
    queries, from the labels and query sizes."""
    label = np.asarray(label, np.int64)
    pairs = 0
    sort_ops = 0
    start = 0
    for n in np.asarray(group, np.int64):
        cnt = np.bincount(label[start:start + n], minlength=5)
        pairs += (int(n) * int(n) - int((cnt * cnt).sum())) // 2
        sort_ops += int(n) * max(1, int(np.ceil(np.log2(max(int(n), 2)))))
        start += int(n)
    return {"pairs": pairs, "sort_ops": sort_ops}


def gradients(num_data: int, pairs: int = 0, sort_ops: int = 0):
    return num_data * 16, 20 * pairs + sort_ops
