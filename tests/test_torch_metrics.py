"""The torch port's metrics (lightgbm_tpu_torch/metric) against the JAX
package's, on the same seeded scores, labels, row weights and queries.

Both run in host float64, so every value is held within 1e-12 relative:
the regression metrics (``l2`` reports the RMSE), the binary and
multiclass ones, and ``ndcg@k`` and ``map@k`` over queries of 1 to 300
documents (padded buckets of 1 to 512), with query weights (the mean row
weight of each query) when rows are weighted, and custom label gains
and cut-offs.
"""

import numpy as np
import pytest

from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.io.dataset import Metadata as JaxMetadata
from lightgbm_tpu.metric import create_metric as jax_metric

from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.dataset import Metadata
from lightgbm_tpu_torch.metric import create_metric

pytestmark = pytest.mark.torch

SIZES = [1, 17, 300, 5, 2, 64, 33, 1, 120, 9]
N = sum(SIZES)

CASES = [
    ("l2", {"objective": "regression"}, "continuous"),
    ("l1", {"objective": "regression"}, "continuous"),
    ("huber", {"objective": "huber", "huber_delta": 0.7}, "continuous"),
    ("fair", {"objective": "fair", "fair_c": 1.7}, "continuous"),
    ("poisson", {"objective": "poisson"}, "counts"),
    ("binary_logloss", {"objective": "binary"}, "binary"),
    ("binary_error", {"objective": "binary"}, "binary"),
    ("auc", {"objective": "binary"}, "binary"),
    ("multi_logloss", {"objective": "multiclass", "num_class": 4},
     "classes"),
    ("multi_error", {"objective": "multiclass", "num_class": 4}, "classes"),
    ("ndcg", {"objective": "lambdarank"}, "relevance"),
    ("ndcg", {"objective": "lambdarank", "ndcg_eval_at": "1,3,10,1000",
              "label_gain": "0,2,5,11,30"}, "relevance"),
    ("map", {"objective": "lambdarank", "eval_at": "2,7"}, "relevance"),
]


def _data(kind, rng, weighted):
    K = 4 if kind == "classes" else 1
    score = rng.normal(size=(K, N))
    if kind == "continuous":
        label = rng.normal(scale=2.0, size=N)
    elif kind == "counts":
        label = rng.poisson(2.0, size=N).astype(np.float64)
        score = np.abs(score) * 3 - 0.5      # a few below the epsilon
    elif kind == "binary":
        label = (rng.uniform(size=N) < 0.4).astype(np.float64)
        score[0, :50] = 0.25                  # tied scores for the AUC
    elif kind == "classes":
        label = rng.randint(0, K, size=N).astype(np.float64)
    else:
        label = rng.randint(0, 5, size=N).astype(np.float64)
        score = np.round(score, 1)            # ties inside queries
    weights = rng.uniform(0.1, 3.0, size=N) if weighted else None
    return score, label, weights


def _eval(create, config, md_cls, label, weights, score):
    md = md_cls(N)
    md.set_label(label)
    md.set_query(SIZES)
    if weights is not None:
        md.set_weights(weights)
    m = create(config["metric"][0], config)
    m.init(md, N)
    return m.names, m.eval(score)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name,params,kind", CASES)
def test_metric_matches_jax(name, params, kind, weighted):
    rng = np.random.RandomState(sum(map(ord, name + kind)))
    score, label, weights = _data(kind, rng, weighted)
    params = {**params, "metric": name}
    jnames, jvals = _eval(jax_metric, JaxConfig(params), JaxMetadata, label,
                          weights, score)
    tnames, tvals = _eval(create_metric, Config(params), Metadata, label,
                          weights, score)
    assert tnames == jnames
    assert all(np.isfinite(tvals))
    np.testing.assert_allclose(tvals, jvals, rtol=1e-12, atol=0)


def test_query_weights_are_the_mean_row_weight():
    rng = np.random.RandomState(0)
    w = rng.uniform(0.1, 3.0, size=N)
    jm, tm = JaxMetadata(N), Metadata(N)
    for md in (jm, tm):
        md.set_weights(w)
        md.set_query(SIZES)
    np.testing.assert_array_equal(tm.query_weights, jm.query_weights)
    assert tm.query_weights.dtype == np.float32
    b = np.concatenate([[0], np.cumsum(SIZES)])
    np.testing.assert_allclose(
        tm.query_weights,
        [w[b[i]:b[i + 1]].astype(np.float32).mean()
         for i in range(len(SIZES))], rtol=1e-6)
