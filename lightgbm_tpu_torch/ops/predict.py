"""Absorbing per-level gather walk on binned rows, in plain PyTorch.

Port of the JAX package's ops/predict.py (``predict_binned_tree`` /
``predict_binned_forest``): every row advances one tree level per step;
rows that reached a leaf (negative child code ``~leaf``) stay put.  The
per-class forest sum is the same Kahan fold, in the same tree order, so
per-tree contributions and their f32 total match the JAX walk bit for
bit.  This is the plain version the forest-walk kernel
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
