"""Plain reference of LightGBM's LambdaRank gradients with NDCG weights
(rank_objective.hpp of the 2.x releases, the form the port follows).

Per query, the documents are ranked by score, descending, ties kept in
document order.  Every pair (hi, lo) with label(hi) > label(lo) adds

    d    = |gain(hi) - gain(lo)| * |disc(rank hi) - disc(rank lo)| / maxDCG
    d   /= 0.01 + |s(hi) - s(lo)|     (unless all scores of the query tie)
    p    = 2 / (1 + exp(2 * sigma * (s(hi) - s(lo))))
    g(hi) -= p * d,  g(lo) += p * d
    h(hi) += 2 p (2 - p) d,  h(lo) += 2 p (2 - p) d

with gain(l) = 2^l - 1, disc(r) = 1 / log2(2 + r) and maxDCG the DCG of
the labels sorted descending over the first ``max_position`` ranks.  The
queries are processed in groups of equal padded size, each query's
documents in the rows of a [P, P] pair matrix.
"""

from __future__ import annotations

import numpy as np
import torch

#: pair-matrix elements a group of queries may take at once
PAIR_ELEMS = 1 << 24


def prepare(label: np.ndarray, group, params: dict, device) -> dict:
    label = np.asarray(label, np.int64)
    sizes = np.asarray(group, np.int64)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    max_pos = int(params.get("max_position", 20))
    gains = 2.0 ** np.arange(32) - 1.0
    groups = []
    P_all = 1 << int(np.ceil(np.log2(max(int(sizes.max()), 1))))
    disc = 1.0 / np.log2(np.arange(P_all) + 2.0)
    for P in sorted({1 << int(np.ceil(np.log2(max(int(s), 1))))
                     for s in sizes}):
        qs = np.nonzero([(1 << int(np.ceil(np.log2(max(int(s), 1))))) == P
                         for s in sizes])[0]
        idx = np.zeros((len(qs), P), np.int64)
        valid = np.zeros((len(qs), P), bool)
        inv = np.zeros(len(qs), np.float64)
        for i, q in enumerate(qs):
            n = int(sizes[q])
            idx[i, :n] = np.arange(starts[q], starts[q] + n)
            valid[i, :n] = True
            top = np.sort(label[starts[q]:starts[q] + n])[::-1][:max_pos]
            dcg = float((gains[top] * disc[:len(top)]).sum())
            inv[i] = 1.0 / dcg if dcg > 0 else 0.0
        groups.append({
            "idx": torch.from_numpy(idx).to(device),
            "valid": torch.from_numpy(valid).to(device),
            "gain": torch.from_numpy(np.where(valid, gains[label[idx]], 0.0)
                                     ).to(device),
            "label": torch.from_numpy(np.where(valid, label[idx], -1)
                                      ).to(device),
            "inv_max_dcg": torch.from_numpy(inv).to(device)})
    return {"groups": groups, "disc": torch.from_numpy(disc).to(device),
            "sigmoid": float(params.get("sigmoid", 1.0)),
            "num_data": int(sizes.sum())}


def gradients(state: dict, score: torch.Tensor):
    dt, dev = score.dtype, score.device
    g = torch.zeros(state["num_data"], dtype=dt, device=dev)
    h = torch.zeros_like(g)
    sig = state["sigmoid"]
    for grp in state["groups"]:
        Q, P = grp["idx"].shape
        step = max(1, PAIR_ELEMS // (P * P))
        for q0 in range(0, Q, step):
            sl = slice(q0, q0 + step)
            idx, valid = grp["idx"][sl], grp["valid"][sl]
            s = torch.where(valid, score[idx],
                            torch.full_like(score[idx], -torch.inf))
            # rank: descending score, ties in document order
            order = torch.sort(-s, dim=1, stable=True).indices
            rank = torch.empty_like(order).scatter_(
                1, order, torch.arange(P, device=dev).expand_as(order))
            disc = state["disc"][rank].to(dt)
            sv = torch.where(valid, s, torch.zeros_like(s))
            n = valid.sum(1)
            hi_s = torch.where(valid, s, torch.full_like(s, -torch.inf)).amax(1)
            lo_s = torch.where(valid, s, torch.full_like(s, torch.inf)).amin(1)
            tied = (hi_s == lo_s) | (n <= 1)
            lab = grp["label"][sl]
            pair = (lab[:, :, None] > lab[:, None, :]) \
                & valid[:, :, None] & valid[:, None, :]
            ds = sv[:, :, None] - sv[:, None, :]
            gain = grp["gain"][sl].to(dt)
            d = (gain[:, :, None] - gain[:, None, :]).abs() \
                * (disc[:, :, None] - disc[:, None, :]).abs() \
                * grp["inv_max_dcg"][sl][:, None, None].to(dt)
            d = torch.where(tied[:, None, None], d, d / (0.01 + ds.abs()))
            p = 2.0 / (1.0 + torch.exp(2.0 * sig * ds))
            lam = torch.where(pair, p * d, torch.zeros_like(d))
            hes = torch.where(pair, 2.0 * p * (2.0 - p) * d, torch.zeros_like(d))
            gq = lam.sum(1) - lam.sum(2)
            hq = hes.sum(1) + hes.sum(2)
            g.index_add_(0, idx[valid], gq[valid])
            h.index_add_(0, idx[valid], hq[valid])
    return g, h
