"""Full-pass f32 histograms of both children of a split, and their
dispatchers.

Port of the JAX package's ops/histogram.py.  The plain versions are one
f32 ``index_add_`` keyed by (child, feature, bin) over every row, with a
dump slot for rows of neither child and for bin codes at or past
``max_bin`` (which K2 and K3 skip, as the TPU kernels do): building both
children of a split in one pass over all rows costs the same as building
one, so the full-pass growers keep no per-leaf histogram state.  Values accumulated
per (feature, bin) are (sum of gradients, sum of hessians, count), with
counts the row-weight sums.

The dispatchers take the device of the tensors they are given: on a
CUDA tensor they launch the hand-written kernels of
``csrc/children_hist.cu`` through ``ops/children_hist.py`` (K2 for the
histograms, K3 for the fused histogram -> per-feature split candidates
pass), on a CPU tensor they run the plain versions.  Over EFB bundled columns
the grower calls :func:`children_histograms` and expands its output
(``ops/bundle.py``); K3 is not launched there, since its in-kernel scan
cannot expand.
"""

from __future__ import annotations

import torch

from .bundle import int_bins
from .split import FeatureCandidates, SplitParams, per_feature_candidates


def children_histograms(bins, grad, hess, weight, leaf_id, parent_leaf,
                        right_leaf, max_bin: int) -> torch.Tensor:
    """[2, F, B, 3]: K2 on a CUDA tensor, the plain scatter on the CPU."""
    if bins.device.type == "cuda":
        from . import children_hist
        return children_hist.children_histograms(
            bins, grad, hess, weight, leaf_id, parent_leaf, right_leaf,
            max_bin)
    return build_children_histograms(bins, grad, hess, weight, leaf_id,
                                     parent_leaf, right_leaf, max_bin)


def root_histogram(bins, grad, hess, weight, max_bin: int) -> torch.Tensor:
    """[F, B, 3] over all rows: K2 with every row in the left child on a
    CUDA tensor, the plain scatter on the CPU."""
    if bins.device.type == "cuda":
        from . import children_hist
        return children_hist.root_histogram(bins, grad, hess, weight,
                                            max_bin)
    return build_root_histogram(bins, grad, hess, weight, max_bin)


def children_split_candidates(bins, grad, hess, weight, leaf_id,
                              parent_leaf, right_leaf, totals, num_bin,
                              is_cat, feat_mask, max_bin: int,
                              params: SplitParams) -> FeatureCandidates:
    """Per-child ``FeatureCandidates`` ([2, F] fields) of the fused
    histogram -> split-gain pass: K3 on a CUDA tensor (the [2, F, B, 3]
    histogram lives only in the kernel's L2-resident scratch), the plain
    histogram plus ``per_feature_candidates`` on the CPU.  ``totals`` is
    [2, 3] f32: (g, h, count) of the left and right child."""
    if bins.device.type == "cuda":
        from . import children_hist
        raw = children_hist.fused_split_candidates(
            bins, grad, hess, weight, leaf_id, parent_leaf, right_leaf,
            totals, num_bin, is_cat, feat_mask, max_bin, params)
        return FeatureCandidates(
            gain=raw[:, :, 0], threshold=raw[:, :, 1].to(torch.int32),
            left_g=raw[:, :, 2], left_h=raw[:, :, 3], left_c=raw[:, :, 4])
    hists = build_children_histograms(bins, grad, hess, weight, leaf_id,
                                      parent_leaf, right_leaf, max_bin)
    return per_feature_candidates(hists, totals[:, 0], totals[:, 1],
                                  totals[:, 2], num_bin, is_cat, feat_mask,
                                  params)


def histogram_scatter(bins, seg, num_seg: int, grad, hess,
                      weight) -> torch.Tensor:
    """Scatter-add histogram: ``seg`` [F, N] flat segment ids in
    [0, num_seg] (``num_seg`` is the dump slot); returns [num_seg, 3]
    f32.  ``bins`` is already encoded in ``seg``."""
    del bins
    vals = torch.stack([grad, hess, weight], dim=-1)          # [N, 3]
    F = seg.shape[0]
    vals = vals[None].expand(F, -1, -1).reshape(-1, 3)
    out = torch.zeros((num_seg + 1, 3), dtype=torch.float32,
                      device=vals.device)
    out.index_add_(0, seg.reshape(-1), vals)
    return out[:num_seg]


def build_children_histograms(bins, grad, hess, weight, leaf_id,
                              parent_leaf, right_leaf,
                              max_bin: int) -> torch.Tensor:
    """Histograms of both children of a just-split leaf in one pass.

    After the partition update the left child's rows carry ``leaf_id ==
    parent_leaf`` and the right child's ``leaf_id == right_leaf`` (ints
    or 0-dim tensors).  ``bins`` [F, N] uint8/uint16, ``grad``/``hess``/
    ``weight`` [N] f32, ``leaf_id`` [N] int32.  Returns [2, F, B, 3] f32:
    [0] the left child, [1] the right."""
    F, N = bins.shape
    B = max_bin
    is_left = leaf_id == parent_leaf
    is_right = leaf_id == right_leaf
    in_leaf = is_left | is_right
    child = is_right.to(torch.int64)                           # [N]
    feat = torch.arange(F, dtype=torch.int64, device=bins.device)[:, None]
    b = int_bins(bins)
    seg = child[None, :] * (F * B) + feat * B + b
    seg = torch.where(in_leaf[None, :] & (b < B), seg,
                      torch.full_like(seg, 2 * F * B))        # dump slot
    flat = histogram_scatter(bins, seg, 2 * F * B, grad, hess, weight)
    return flat.reshape(2, F, B, 3)


def build_root_histogram(bins, grad, hess, weight,
                         max_bin: int) -> torch.Tensor:
    """Histogram of all rows (the root leaf): [F, B, 3] f32."""
    F, N = bins.shape
    B = max_bin
    feat = torch.arange(F, dtype=torch.int64, device=bins.device)[:, None]
    b = int_bins(bins)
    seg = torch.where(b < B, feat * B + b, F * B)             # dump slot
    flat = histogram_scatter(bins, seg, F * B, grad, hess, weight)
    return flat.reshape(F, B, 3)
