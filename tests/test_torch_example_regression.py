"""The repo's ``examples/regression`` conf through the port's CLI
(``device=cpu``) against the JAX CLI, 3 rounds (torch_example_parity.py
says what is compared and to what tolerance)."""

import pytest

import torch_example_parity as parity

pytestmark = pytest.mark.torch


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return parity.run_conf("regression", "regression", tmp_path_factory)


def test_tree_structures_match_jax(run):
    assert parity.compare_trees(run)["trees"] >= 1


def test_metrics_match_jax(run):
    parity.compare_metrics(run)


def test_predictions_match_jax(run):
    parity.compare_predictions(run, parity.compare_trees(run)["flip"])
