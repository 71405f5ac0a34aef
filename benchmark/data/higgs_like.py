"""Synthetic stand-in for the UCI HIGGS table, made on the device: 28
features, the first 7 standard normal "low-level" ones, 7 energy-like
positives, 7 products of the two, 7 more normals; the label is a noisy
threshold of a few of them (the JAX package's ``bench.py``
``make_higgs_like``, here on a ``torch.Generator``).  Values are float32
numbers handed to the program as float64.

A training table is one table (from the configuration's ``table_seed``)
with its rows in an order drawn from the run's seed: every seed trains
on the same rows, so the seed changes the inputs and not the amount of
work.  The scoring pool and forest are drawn from the run's seed."""

from __future__ import annotations

import numpy as np
import torch


def generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + stream) % (1 << 62))
    return g


def features(rows: int, num_features: int, seed: int, stream: int, device
             ) -> torch.Tensor:
    """[rows, num_features] float32 on ``device``."""
    g = generator(seed, stream, device)
    X = torch.randn(rows, num_features, generator=g, device=device)
    X[:, 7:14] = X[:, 7:14].abs()
    X[:, 14:21] = X[:, 0:7] * X[:, 7:14]
    return X


def make(cfg: dict, seed: int, device):
    """(X [rows, F] f64 numpy, label [rows] f64 numpy, None)."""
    rows, F = int(cfg["rows"]), int(cfg["features"])
    table = int(cfg["table_seed"])
    X = features(rows, F, table, 1, device)
    g = generator(table, 2, device)
    noise = torch.randn(rows, generator=g, device=device) * 1.5
    logit = (0.8 * X[:, 0] - 0.6 * X[:, 1] + 0.5 * X[:, 14]
             - 0.4 * X[:, 15] + 0.3 * X[:, 7] * X[:, 2] + noise)
    order = torch.randperm(rows, generator=generator(seed, 5, device),
                           device=device)
    y = (logit[order] > 0).double().cpu().numpy()
    return X[order].double().cpu().numpy(), y, None


def pool(cfg: dict, rows: int, seed: int, device) -> np.ndarray:
    """[rows, F] f64 rows for scoring, from another stream of the seed."""
    return features(rows, int(cfg["features"]), seed, 3, device
                    ).double().cpu().numpy()
