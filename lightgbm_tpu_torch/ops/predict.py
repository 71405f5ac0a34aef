"""Absorbing per-level gather walk on binned rows, in plain PyTorch.

Port of the JAX package's ops/predict.py (``predict_binned_tree`` /
``predict_binned_forest`` / ``predict_binned_forest_linear``): every row
advances one tree level per step; rows that reached a leaf (negative
child code ``~leaf``) stay put.  The per-class forest sum is the same
Kahan fold, in the same tree order, so per-tree contributions and their
f32 total match the JAX walk bit for bit for constant leaves; a linear
leaf's affine part sums its slots in ascending order (the JAX gather
walk leaves that order to XLA's reduce, so the two agree to f32
rounding).  This is the plain version the forest-walk kernel
(csrc/forest_walk.cu) is held against; the serving path on the card
never calls it.
"""

from __future__ import annotations

from typing import Tuple

import torch


def predict_binned_tree(split_feature, split_bin, is_cat_node, left_child,
                        right_child, leaf_value, bins: torch.Tensor,
                        max_steps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One tree on binned rows.

    ``split_feature``/``split_bin``/``left_child``/``right_child`` [M]
    int, ``is_cat_node`` [M] bool, ``leaf_value`` [L] f32, ``bins``
    [F, N] integer bin codes.  ``max_steps`` bounds the walk
    (num_leaves always suffices).  Returns ([N] f32 leaf values, [N]
    int64 leaf indices)."""
    N = bins.shape[1]
    dev = bins.device
    node = torch.zeros(N, dtype=torch.int64, device=dev)
    if leaf_value.shape[0] > 1 and split_feature.shape[0] > 0:
        sf = split_feature.long()
        sb = split_bin.long()
        lc = left_child.long()
        rc = right_child.long()
        b64 = bins.long()
        for _ in range(max_steps):
            live = node >= 0
            if not bool(live.any()):
                break
            idx = node.clamp(min=0)
            fbin = b64.gather(0, sf[idx].unsqueeze(0))[0]
            tbin = sb[idx]
            go_left = torch.where(is_cat_node[idx], fbin == tbin,
                                  fbin <= tbin)
            nxt = torch.where(go_left, lc[idx], rc[idx])
            node = torch.where(live, nxt, node)
        leaf = torch.where(node < 0, ~node, torch.zeros_like(node))
    else:
        leaf = node
    return leaf_value[leaf], leaf


def predict_binned_forest(split_feature, split_bin, is_cat_node, left_child,
                          right_child, leaf_value, bins: torch.Tensor,
                          max_steps: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kahan-compensated f32 sum over a [T, ...] tree stack of one class.

    Returns ([N] f32 sum, [T, N] int64 leaf indices)."""
    N = bins.shape[1]
    acc = torch.zeros(N, dtype=torch.float32, device=bins.device)
    comp = torch.zeros_like(acc)
    leaves = []
    for t in range(split_feature.shape[0]):
        val, leaf = predict_binned_tree(
            split_feature[t], split_bin[t], is_cat_node[t], left_child[t],
            right_child[t], leaf_value[t], bins, max_steps)
        y = val - comp
        tot = acc + y
        comp = (tot - acc) - y
        acc = tot
        leaves.append(leaf)
    if leaves:
        return acc, torch.stack(leaves, 0)
    return acc, torch.zeros((0, N), dtype=torch.int64, device=bins.device)


def affine_rows(coeff_rows: torch.Tensor, feat_rows: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """[N] per-row affine part ``sum_k coeff_rows[n, k] * x[feat_rows[n,
    k], n]`` in ascending k, skipping ``-1`` slots, one rounding per
    product and per add (the order the walk kernel uses).

    ``coeff_rows`` [N, Kf] f32 and ``feat_rows`` [N, Kf] int are each
    row's leaf's tables; ``x`` [F, N] f32 covariates with NaN already
    imputed to 0.0."""
    s = torch.zeros(x.shape[1], dtype=torch.float32, device=x.device)
    for k in range(feat_rows.shape[1]):
        f = feat_rows[:, k].long()
        v = x.gather(0, f.clamp(min=0)[None, :])[0]
        s = torch.where(f >= 0, s + coeff_rows[:, k] * v, s)
    return s


def predict_binned_forest_linear(split_feature, split_bin, is_cat_node,
                                 left_child, right_child, leaf_value,
                                 leaf_coeff, leaf_feat, bins: torch.Tensor,
                                 raw: torch.Tensor, max_steps: int
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sum of piece-wise linear tree predictions (the JAX
    ``predict_binned_forest_linear``): each tree contributes
    ``leaf_value[leaf] + sum_k leaf_coeff[leaf, k] * raw[leaf_feat[leaf,
    k]]`` (:func:`affine_rows`; a ``-1`` slot counts 0), Kahan-folded in
    tree order.

    ``leaf_coeff`` [T, L, Kf] f32, ``leaf_feat`` [T, L, Kf] int rows of
    ``raw`` [F, N] f32 (NaN imputed to 0.0).  Returns ([N] f32 sum,
    [T, N] int64 leaf indices)."""
    N = bins.shape[1]
    acc = torch.zeros(N, dtype=torch.float32, device=bins.device)
    comp = torch.zeros_like(acc)
    leaves = []
    for t in range(split_feature.shape[0]):
        val, leaf = predict_binned_tree(
            split_feature[t], split_bin[t], is_cat_node[t], left_child[t],
            right_child[t], leaf_value[t], bins, max_steps)
        val = val + affine_rows(leaf_coeff[t][leaf], leaf_feat[t][leaf], raw)
        y = val - comp
        tot = acc + y
        comp = (tot - acc) - y
        acc = tot
        leaves.append(leaf)
    if leaves:
        return acc, torch.stack(leaves, 0)
    return acc, torch.zeros((0, N), dtype=torch.int64, device=bins.device)
