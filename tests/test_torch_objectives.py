"""The torch port's objectives (lightgbm_tpu_torch/objective) against the
JAX package's, on the same seeded scores, labels and weights.

Every objective's ``gradients_with`` runs the same f32 operations in the
same order as the JAX version; ``exp`` and the reductions of XLA and
torch may differ in the last bits, so gradients and hessians are held
within 1e-6 relative (of each value, plus 1e-6 of the largest magnitude
for values that cancel to near zero).  LambdaRank, whose pair sums XLA
may order otherwise, is held to the same tolerance; its cases are
the all-equal scores of round 0, one-document queries, queries of 17 and
300 documents (three padded classes: 16, 32 and 512), tied labels, and
row weights.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.io.dataset import Metadata as JaxMetadata
from lightgbm_tpu.objective import create_objective as jax_objective

from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.dataset import Metadata
from lightgbm_tpu_torch.objective import (PAIR_BLOCK, create_objective,
                                          pad_class)

pytestmark = pytest.mark.torch

N = 3000
RTOL = 1e-6


def _metadata(cls, label, weights=None, group=None):
    md = cls(len(label))
    md.set_label(label)
    if weights is not None:
        md.set_weights(weights)
    if group is not None:
        md.set_query(group)
    return md


def _both(params, label, score, weights=None, group=None):
    """(JAX grad, JAX hess, port grad, port hess), each [K, N] f64."""
    jo = jax_objective(JaxConfig(params))
    jo.init(_metadata(JaxMetadata, label, weights, group), len(label))
    jg, jh = jo.gradients_with(jo.gradient_arrays(), jnp.asarray(score))
    to = create_objective(Config(params))
    to.init(_metadata(Metadata, label, weights, group), len(label))
    tg, th = to.gradients_with(to.gradient_arrays(torch.device("cpu")),
                               torch.from_numpy(score))
    return (np.asarray(jg, np.float64), np.asarray(jh, np.float64),
            tg.double().numpy(), th.double().numpy())


def _close(got, want, rtol=RTOL):
    top = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * top)


POINTWISE = [
    ({"objective": "regression"}, "continuous"),
    ({"objective": "regression_l1"}, "continuous"),
    ({"objective": "regression_l1", "gaussian_eta": 0.3}, "continuous"),
    ({"objective": "huber"}, "continuous"),
    ({"objective": "huber", "huber_delta": 0.4}, "continuous"),
    ({"objective": "fair"}, "continuous"),
    ({"objective": "fair", "fair_c": 2.5}, "continuous"),
    ({"objective": "poisson"}, "counts"),
    ({"objective": "poisson", "poisson_max_delta_step": 0.2}, "counts"),
    ({"objective": "binary"}, "binary"),
    ({"objective": "binary", "is_unbalance": True}, "binary"),
    ({"objective": "multiclass", "num_class": 5}, "classes"),
    ({"objective": "multiclass", "num_class": 3, "is_unbalance": True},
     "classes"),
]


def _labels(kind, num_class, rng):
    if kind == "continuous":
        return rng.normal(scale=2.0, size=N).astype(np.float32)
    if kind == "counts":
        return rng.poisson(3.0, size=N).astype(np.float32)
    if kind == "binary":
        return (rng.uniform(size=N) < 0.3).astype(np.float32)
    return rng.randint(0, num_class, size=N).astype(np.float32)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("params,kind", POINTWISE)
def test_pointwise_gradients_match_jax(params, kind, weighted):
    rng = np.random.RandomState(7)
    K = params.get("num_class", 1)
    label = _labels(kind, K, rng)
    score = rng.normal(size=(K, N)).astype(np.float32)
    if kind == "counts":
        score = np.abs(score)
    weights = (rng.uniform(0.2, 2.0, size=N).astype(np.float32)
               if weighted else None)
    jg, jh, tg, th = _both(params, label, score, weights)
    assert tg.shape == (K, N)
    _close(tg, jg)
    _close(th, jh)


def _rank_case(name, rng):
    """(query sizes, labels) of a LambdaRank case."""
    if name == "one_doc":
        sizes = [1, 1, 5, 1, 3, 1]
    elif name == "mixed":
        sizes = [17, 300, 1, 16, 33, 2, 17, 120]
    else:                      # "ties": few label values, many ties
        sizes = [40, 17, 64, 9]
    n = sum(sizes)
    levels = 2 if name == "ties" else 5
    label = rng.randint(0, levels, size=n).astype(np.float32)
    return sizes, label


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("scores", ["round0", "random", "tied_scores"])
@pytest.mark.parametrize("name", ["one_doc", "mixed", "ties"])
def test_lambdarank_gradients_match_jax(name, scores, weighted):
    rng = np.random.RandomState(11)
    sizes, label = _rank_case(name, rng)
    n = len(label)
    if scores == "round0":
        score = np.zeros((1, n), np.float32)
    elif scores == "random":
        score = rng.normal(size=(1, n)).astype(np.float32)
    else:                      # ties in the scores, broken by position
        score = rng.randint(0, 3, size=(1, n)).astype(np.float32) * 0.5
    weights = (rng.uniform(0.2, 2.0, size=n).astype(np.float32)
               if weighted else None)
    params = {"objective": "lambdarank"}
    jg, jh, tg, th = _both(params, label, score, weights, sizes)
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    for q in range(len(sizes)):
        a, b = bounds[q], bounds[q + 1]
        if b - a == 1:
            assert tg[0, a] == 0 and th[0, a] == 0
    _close(tg, jg)
    _close(th, jh)


def test_lambdarank_query_blocks_cover_every_query():
    """Padded classes and the blocks of PAIR_BLOCK // P queries: every
    document's row is written once (a query split over two blocks keeps
    its gradients)."""
    assert [pad_class(n) for n in (1, 16, 17, 300, 1024, 1025)] == \
        [16, 16, 32, 512, 1024, 2048]
    rng = np.random.RandomState(3)
    # 300 queries of 200 documents: padded to 256, 256 queries a block,
    # so two blocks
    sizes = [200] * 300
    assert len(sizes) > PAIR_BLOCK // 256
    label = rng.randint(0, 5, size=sum(sizes)).astype(np.float32)
    score = rng.normal(size=(1, len(label))).astype(np.float32)
    jg, jh, tg, th = _both({"objective": "lambdarank"}, label, score,
                           None, sizes)
    _close(tg, jg)
    _close(th, jh)
    assert np.count_nonzero(th) > 0.9 * len(label)


def test_lambdarank_custom_gains_and_position_match_jax():
    rng = np.random.RandomState(5)
    sizes, label = _rank_case("mixed", rng)
    score = rng.normal(size=(1, len(label))).astype(np.float32)
    params = {"objective": "lambdarank", "label_gain": "0,1,3,7,15",
              "max_position": 5, "sigmoid": 2.0}
    jg, jh, tg, th = _both(params, label, score, None, sizes)
    _close(tg, jg)
    _close(th, jh)


def test_none_objective_needs_a_custom_fobj():
    obj = create_objective(Config({"objective": "none", "num_class": 3}))
    assert obj.num_tree_per_iteration == 3
    with pytest.raises(RuntimeError, match="fobj"):
        obj.gradients_with({}, torch.zeros(3, 4))
