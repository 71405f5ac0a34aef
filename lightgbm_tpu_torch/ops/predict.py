"""Absorbing per-level gather walk on binned rows, in plain PyTorch.

Port of the JAX package's ops/predict.py (``predict_binned_tree`` /
``predict_binned_forest`` / ``predict_binned_forest_linear``): every row
advances one tree level per step, in every tree of a stack at once
(:func:`forest_leaves`); rows that reached a leaf (negative child code
``~leaf``) stay put.  The per-class forest sum is the same
Kahan fold, in the same tree order, so per-tree contributions and their
f32 total match the JAX walk bit for bit for constant leaves; a linear
leaf's affine part sums its slots in ascending order (the JAX gather
walk leaves that order to XLA's reduce, so the two agree to f32
rounding).  This is the plain version the forest-walk kernel
(csrc/forest_walk.cu) is held against, and the ``serve_walk=gather``
strategy of ``serve/forest.py``, which serves through it when asked for
by name.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .bundle import decode_feature_bins


def predict_binned_tree(split_feature, split_bin, is_cat_node, left_child,
                        right_child, leaf_value, bins: torch.Tensor,
                        max_steps: int, bundle=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One tree on binned rows.

    ``split_feature``/``split_bin``/``left_child``/``right_child`` [M]
    int, ``is_cat_node`` [M] bool, ``leaf_value`` [L] f32, ``bins``
    [F, N] integer bin codes, or EFB columns [C, N] with their
    ``bundle`` (``ops.bundle.BundleDecode``): the splits stay in original
    feature space and each level decodes the split feature's column.
    ``max_steps`` bounds the walk (num_leaves always suffices).  Returns
    ([N] f32 leaf values, [N] int64 leaf indices)."""
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
            if bundle is not None:
                fbin = decode_feature_bins(b64, sf[idx], bundle)
            else:
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


# trees x rows of one block of the forest walks: bounds each [T, N] int64
# temporary of a level (128 MB)
FOREST_BLOCK_ELEMS = 1 << 24


def forest_leaves(split_feature, split_bin, is_cat_node, left_child,
                  right_child, num_leaves: int, bins: torch.Tensor,
                  max_steps: int) -> torch.Tensor:
    """[T, N] int64 leaf indices of a [T, ...] tree stack on binned rows:
    :func:`predict_binned_tree`'s walk, one level of every tree of a
    block at a time (blocks of trees keep a level's [T, N] temporaries
    within FOREST_BLOCK_ELEMS).  ``num_leaves`` is the stack's leaf
    width: a width of 1 (or no nodes) walks nothing, as for one tree."""
    T, N = split_feature.shape[0], bins.shape[1]
    dev = bins.device
    if num_leaves <= 1 or split_feature.shape[1] == 0 or T == 0:
        return torch.zeros((T, N), dtype=torch.int64, device=dev)
    b64 = bins.long()
    step = max(1, FOREST_BLOCK_ELEMS // max(N, 1))
    out = []
    for t0 in range(0, T, step):
        sf = split_feature[t0:t0 + step].long()
        sb = split_bin[t0:t0 + step].long()
        ic = is_cat_node[t0:t0 + step].bool()
        lc = left_child[t0:t0 + step].long()
        rc = right_child[t0:t0 + step].long()
        node = torch.zeros((sf.shape[0], N), dtype=torch.int64, device=dev)
        for _ in range(max_steps):
            live = node >= 0
            if not bool(live.any()):
                break
            idx = node.clamp(min=0)
            fbin = b64.gather(0, sf.gather(1, idx))
            tbin = sb.gather(1, idx)
            go_left = torch.where(ic.gather(1, idx), fbin == tbin,
                                  fbin <= tbin)
            nxt = torch.where(go_left, lc.gather(1, idx), rc.gather(1, idx))
            node = torch.where(live, nxt, node)
        out.append(torch.where(node < 0, ~node, torch.zeros_like(node)))
    return torch.cat(out, 0)


def predict_binned_forest(split_feature, split_bin, is_cat_node, left_child,
                          right_child, leaf_value, bins: torch.Tensor,
                          max_steps: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kahan-compensated f32 sum over a [T, ...] tree stack of one class.

    Returns ([N] f32 sum, [T, N] int64 leaf indices)."""
    N = bins.shape[1]
    acc = torch.zeros(N, dtype=torch.float32, device=bins.device)
    comp = torch.zeros_like(acc)
    leaves = forest_leaves(split_feature, split_bin, is_cat_node,
                           left_child, right_child, leaf_value.shape[1],
                           bins, max_steps)
    for t in range(leaves.shape[0]):
        y = leaf_value[t][leaves[t]] - comp
        tot = acc + y
        comp = (tot - acc) - y
        acc = tot
    return acc, leaves


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
    leaves = forest_leaves(split_feature, split_bin, is_cat_node,
                           left_child, right_child, leaf_value.shape[1],
                           bins, max_steps)
    for t in range(leaves.shape[0]):
        leaf = leaves[t]
        val = leaf_value[t][leaf] + affine_rows(leaf_coeff[t][leaf],
                                                leaf_feat[t][leaf], raw)
        y = val - comp
        tot = acc + y
        comp = (tot - acc) - y
        acc = tot
    return acc, leaves
