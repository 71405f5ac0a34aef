"""Synthetic stand-in for MSLR-WEB30K's training fold, made on the device:
136 dense features (102 continuous, 34 integer counts), relevance labels
0-4 in MSLR-WEB30K's proportions (51.4, 32.5, 13.4, 1.9 and 0.8%), and
queries whose sizes are one fixed heavy-tailed multiset (a log-normal's
quantiles clipped to 1-1251 and scaled to the fold's rows, mean near
120).  The table comes from the configuration's ``table_seed``; the run's
seed draws the order of its queries and of each query's documents, so
every seed ranks the same documents: the seed changes the inputs and not
the amount of work."""

from __future__ import annotations

import numpy as np
import torch

from .higgs_like import generator

LABEL_SHARES = (0.514, 0.325, 0.134, 0.019, 0.008)
COUNT_FEATURES = 34


def query_sizes(rows: int, queries: int, max_size: int, sigma: float
                ) -> np.ndarray:
    """The fixed multiset of query sizes, summing to ``rows``."""
    p = (np.arange(queries) + 0.5) / queries
    z = np.sqrt(2.0) * torch.special.erfinv(
        torch.from_numpy(2.0 * p - 1.0)).numpy()
    raw = np.exp(sigma * z)
    sizes = np.clip(np.round(raw * rows / raw.sum()), 1, max_size)
    for _ in range(64):
        diff = int(rows - sizes.sum())
        if diff == 0:
            break
        room = sizes < max_size if diff > 0 else sizes > 1
        idx = np.nonzero(room)[0][-abs(diff):]
        sizes[idx] += np.sign(diff)
    assert int(sizes.sum()) == rows
    return sizes.astype(np.int64)


def make(cfg: dict, seed: int, device):
    """(X [rows, 136] f64 numpy, label f64 numpy, query sizes)."""
    rows, F = int(cfg["rows"]), int(cfg["features"])
    a = cfg["assumed"]["query_sizes"]
    sizes = query_sizes(rows, int(cfg["queries"]), int(a["max"]),
                        float(a["sigma"]))
    table = int(cfg["table_seed"])
    sizes = sizes[np.random.default_rng(table).permutation(len(sizes))]
    g = generator(table, 1, device)
    X = torch.randn(rows, F, generator=g, device=device)
    X[:, F - COUNT_FEATURES:] = torch.floor(
        torch.exp(X[:, F - COUNT_FEATURES:] + 1.0))
    w = torch.rand(8, generator=g, device=device) * 0.8 + 0.2
    qid = torch.repeat_interleave(
        torch.arange(len(sizes), device=device),
        torch.from_numpy(sizes).to(device))
    q_effect = torch.randn(len(sizes), generator=g, device=device)[qid]
    latent = X[:, :8] @ w + 0.5 * q_effect \
        + 1.5 * torch.randn(rows, generator=g, device=device)
    cuts = torch.quantile(latent[torch.randperm(rows, generator=g,
                                                device=device)[:1 << 20]],
                          torch.tensor(np.cumsum(LABEL_SHARES)[:-1],
                                       dtype=torch.float32, device=device))
    y = torch.bucketize(latent, cuts)
    # the run's order: queries shuffled, each query's documents shuffled
    gs = generator(seed, 5, device)
    q_rank = torch.argsort(torch.randperm(len(sizes), generator=gs,
                                          device=device))
    key = q_rank[qid].double() + torch.rand(rows, generator=gs,
                                            device=device, dtype=torch.float64)
    order = torch.argsort(key)
    sizes = sizes[np.argsort(q_rank.cpu().numpy())]
    return (X[order].double().cpu().numpy(), y[order].double().cpu().numpy(),
            sizes)
