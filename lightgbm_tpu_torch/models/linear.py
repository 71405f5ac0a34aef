"""Piece-wise linear trees: per-leaf affine fits after growth, in torch.

Port of the JAX package's models/linear.py (docs/LINEAR_TREES.md).  After
a grower has grown a tree's structure, every leaf gets an affine model
``value(x) = const + sum_k coeff[k] * x[feat[k]]`` over up to
K = ``linear_max_leaf_features`` features from the leaf's own root path.
The fit minimizes the grower's second-order objective; for leaf ``l``
with rows ``i`` (``g``/``h`` scaled by ``row_weight``):

    min_w  sum_i [ g_i * phi_i^T w + 0.5 * h_i * (phi_i^T w)^2 ]
           + 0.5 * linear_lambda * |w_1..K|^2 + 0.5 * lambda_l2 * w_0^2

with ``phi_i = [x_i[f_1] ... x_i[f_K], 1]``: the normal equations
``(A + diag(ridge)) w = b``, ``A = sum h_i phi phi^T``, ``b = -sum g_i
phi``.  ``A`` and ``b`` are ``M(M+1)/2 + M`` segment sums (M = K + 1)
taken by one ``index_add_`` over the leaf of every row, never an
[N, M, M] tensor; all L systems solve in one batched
``torch.linalg.cholesky_ex`` and two ``solve_triangular``.  The JAX
package computes this outside any Pallas kernel (plain XLA), so torch's
``linalg`` and ``index_add_`` are its port.

Pad slots (``feat = -1``) get a unit diagonal, which pins their
coefficient to exactly 0.  A leaf falls back to its grown constant value
(coeff 0) when its solve is not finite (or the factorization fails) or
it holds fewer than K + 2 in-bag rows; the fallbacks are counted.
Coefficients and intercepts are scaled by the learning rate, as the
grower shrinks its leaf values.

NaN policy: raw values read as 0.0 at fit and at predict time, so train
and serve agree.  Categorical path features are skipped.  Sums run in
f32 in another order than XLA's ``segment_sum`` (and ``index_add_`` on a
card adds with atomics, in no fixed order), so fits agree with the JAX
package to f32 rounding, not bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.predict import affine_rows, predict_binned_tree


class LinearParams(NamedTuple):
    """The linear-tree settings of a booster."""
    max_features: int       # K: padded path-feature slots per leaf
    lambda_: float          # ridge on the K slope terms (linear_lambda)
    lambda_l2: float        # ridge on the intercept (the grower's lambda_l2)


def path_features(tree_arrays, is_cat, max_features: int) -> torch.Tensor:
    """[L, K] int32 per-leaf path features (inner indices, -1 pad).

    For each grown leaf: walk the ancestors from ``leaf_parent`` to the
    root, nearest to the leaf first, drop categorical split features and
    repeats (the first occurrence stays), keep the first K.  Integer work
    on the host over the tree's real nodes; exact."""
    L = int(tree_arrays.leaf_value.shape[0])
    K = int(max_features)
    out = np.full((L, max(K, 0)), -1, np.int32)
    if K <= 0 or L < 2:
        return torch.from_numpy(out)
    nl = int(tree_arrays.num_leaves)
    sf = np.asarray(tree_arrays.split_feature.cpu(), np.int64)
    lc = np.asarray(tree_arrays.left_child.cpu(), np.int64)
    rc = np.asarray(tree_arrays.right_child.cpu(), np.int64)
    par = np.asarray(tree_arrays.leaf_parent.cpu(), np.int64)
    cat = np.asarray(torch.as_tensor(is_cat).cpu(), bool)
    parent = np.full(L - 1, -1, np.int64)      # of each real internal node
    for node in range(max(nl - 1, 0)):
        for child in (lc[node], rc[node]):
            if child >= 0:
                parent[child] = node
    for leaf in range(nl):
        seen = []
        node = par[leaf]
        while node >= 0 and len(seen) < K:
            f = int(sf[node])
            if f >= 0 and not cat[f] and f not in seen:
                seen.append(f)
            node = parent[node]
        out[leaf, :len(seen)] = seen
    return torch.from_numpy(out)


def gather_leaf_values(raw: torch.Tensor, feat: torch.Tensor,
                       leaf: torch.Tensor) -> torch.Tensor:
    """[N, K] covariates of each row's leaf: ``raw[feat[leaf], row]`` with
    -1 pad slots zeroed.  ``raw`` is [F_used, N] f32, NaN imputed."""
    f_row = feat.long()[leaf.long()]                       # [N, K]
    vals = raw.gather(0, f_row.clamp(min=0).t()).t()
    return torch.where(f_row >= 0, vals, torch.zeros_like(vals))


def affine_epilogue(leaf: torch.Tensor, coeff: torch.Tensor,
                    feat: torch.Tensor, raw: torch.Tensor) -> torch.Tensor:
    """[N] affine part ``sum_k coeff[leaf, k] * raw[feat[leaf, k]]`` of
    every row, in the walk kernel's order (``ops/predict.affine_rows``):
    what the valid-set replay adds onto the constant leaf walk."""
    leaf = leaf.long()
    return affine_rows(coeff[leaf], feat[leaf], raw)


def fit_leaf_models(tree_arrays, bins: torch.Tensor, is_cat: torch.Tensor,
                    raw: torch.Tensor, grad: torch.Tensor,
                    hess: torch.Tensor, row_weight: torch.Tensor,
                    lr: float, linear: LinearParams,
                    leaf: Optional[torch.Tensor] = None, bundle=None):
    """Fit every leaf's affine model in one batched solve.

    ``tree_arrays`` is the grower's ``TreeArrays`` and ``is_cat`` [F]
    the categorical flags (any device: a host copy spares a read),
    ``bins`` [F, N] the training bins, ``raw`` [F, N] f32 NaN-imputed
    raw values, ``grad``/``hess``/``row_weight`` [N] f32 (the grower's
    inputs, not yet weighted), all on the training device.  ``leaf``
    [N] is each row's leaf; when omitted it comes from re-walking the
    grown structure over ``bins``, as the JAX package does (over EFB
    columns with their ``bundle`` decode tables).

    Returns ``(leaf_value [L] f32, coeff [L, K] f32, feat [L, K] int32,
    delta [N] f32, fallback_count 0-dim int64)`` on the training device:
    the learning-rate scaled intercepts (the grown value where a leaf
    fell back), slopes and inner feature indices, each row's score
    update (replacing the grower's), and the number of grown leaves that
    fell back."""
    ta = tree_arrays
    dev = raw.device
    L = int(ta.leaf_value.shape[0])
    K = int(linear.max_features)
    M = K + 1
    leaf_value = ta.leaf_value.to(dev)
    if leaf is None:
        sf = ta.split_feature.to(dev).long()
        _, leaf = predict_binned_tree(
            sf, ta.split_bin.to(dev), is_cat.to(dev)[sf.clamp(min=0)],
            ta.left_child.to(dev), ta.right_child.to(dev), leaf_value,
            bins, L, bundle=bundle)
    leaf = leaf.long()
    feat = path_features(ta, is_cat, K).to(dev)
    vals = gather_leaf_values(raw, feat, leaf)             # [N, K]
    g = grad * row_weight
    h = hess * row_weight
    phi = [vals[:, i] for i in range(K)] + [torch.ones_like(g)]
    # the normal equations as M(M+1)/2 + M segment sums of [N] products,
    # in one index_add_ over the leaves
    pairs = [(i, j) for i in range(M) for j in range(i, M)]
    cols = [h * phi[i] * phi[j] for i, j in pairs] + [-g * p for p in phi]
    sums = torch.zeros((L, len(cols)), dtype=torch.float32, device=dev)
    sums.index_add_(0, leaf, torch.stack(cols, dim=1))
    cnt = torch.zeros(L, dtype=torch.int64, device=dev).index_add_(
        0, leaf, (row_weight > 0).long())
    A = torch.zeros((L, M, M), dtype=torch.float32, device=dev)
    for p, (i, j) in enumerate(pairs):
        A[:, i, j] = sums[:, p]
        A[:, j, i] = sums[:, p]
    b = sums[:, len(pairs):]                               # [L, M]
    # ridge, and a unit diagonal on pad slots: their phi column is zero,
    # so the solution there is exactly 0 and A stays positive definite
    active_slot = feat >= 0
    diag = torch.cat([
        torch.where(active_slot,
                    torch.tensor(linear.lambda_, dtype=torch.float32,
                                 device=dev),
                    torch.ones((), dtype=torch.float32, device=dev)),
        torch.full((L, 1), linear.lambda_l2, dtype=torch.float32,
                   device=dev)], dim=1)
    A = A + torch.diag_embed(diag)
    chol, info = torch.linalg.cholesky_ex(A)
    y = torch.linalg.solve_triangular(chol, b[..., None], upper=False)
    w = torch.linalg.solve_triangular(chol.transpose(-1, -2), y,
                                      upper=True)[..., 0]   # [L, M]
    num_leaves = ta.num_leaves.to(dev)
    active_leaf = torch.arange(L, device=dev) < num_leaves
    use_lin = (torch.isfinite(w).all(dim=1) & (info == 0) & (cnt >= K + 2)
               & active_leaf)
    fallback = torch.where(num_leaves > 1,
                           (active_leaf & ~use_lin).sum(),
                           torch.zeros((), dtype=torch.int64, device=dev))
    coeff = torch.where(use_lin[:, None] & active_slot, lr * w[:, :K],
                        torch.zeros_like(w[:, :K]))
    const = torch.where(use_lin, lr * w[:, K], leaf_value)
    delta = const[leaf] + affine_rows(coeff[leaf], feat[leaf], raw)
    return const, coeff, feat, delta, fallback


def attach_linear(tree, coeff, feat, used_feature_map):
    """Attach a tree's affine tables to the host ``Tree``, mapping inner
    feature indices to real ones (as ``Tree.from_arrays`` maps splits),
    cropped to the tree's leaves."""
    nl = int(tree.num_leaves)
    coeff = np.asarray(coeff, np.float64)[:nl]
    feat = np.asarray(feat, np.int32)[:nl]
    ufm = np.asarray(list(used_feature_map) + [0], np.int64)
    real = np.where(feat >= 0, ufm[np.maximum(feat, 0)], -1)
    tree.leaf_coeff = coeff
    tree.leaf_feat = real.astype(np.int32)
    return tree
