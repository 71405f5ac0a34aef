"""Vectorized best-split search over feature histograms, in torch.

Port of the JAX package's ops/split.py: one cumulative sum plus a masked
argmax over the whole ``[F, B]`` histogram instead of the reference's
right-to-left bin scan (feature_histogram.hpp:75-289).  The gain math,
the candidate validity rules and the tie-breaks are the JAX version's:

  * threshold t means "bin <= t goes left" for numerical features
    (t in [0, num_bin-2]) and "bin == t goes left" for categorical ones
    (one-vs-rest, t in [0, num_bin-1]);
  * equal gains pick the LARGEST threshold within a feature and then the
    SMALLEST feature (``torch.argmax`` returns the first maximum, as
    ``jnp.argmax`` does).

The scan is f32.  ``torch.cumsum`` may associate the prefix sums
differently from ``jnp.cumsum`` (on the CPU it accumulates in double),
so gains can differ from the JAX package's in the last bits; only a
near-exact tie between two candidates can then change the choice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

K_EPSILON = 1e-15
K_MIN_SCORE = float("-inf")


class SplitParams(NamedTuple):
    """Split constraints (TreeConfig subset, config.h:172-192)."""
    min_data_in_leaf: int = 100
    min_sum_hessian_in_leaf: float = 10.0
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_gain_to_split: float = 0.0


class BestSplit(NamedTuple):
    """Per-leaf best split record (SplitInfo); fields shaped [...]."""
    gain: torch.Tensor        # f32, -inf when unsplittable
    feature: torch.Tensor     # int32 inner feature index, -1 if none
    threshold: torch.Tensor   # int32 bin threshold
    left_sum_g: torch.Tensor  # f32
    left_sum_h: torch.Tensor  # f32
    left_count: torch.Tensor  # f32 (row-weighted count)


class FeatureCandidates(NamedTuple):
    """Per-feature best candidates, fields shaped [..., F]."""
    gain: torch.Tensor        # f32, parent gain_shift not yet subtracted
    threshold: torch.Tensor   # int32
    left_g: torch.Tensor
    left_h: torch.Tensor
    left_c: torch.Tensor


def leaf_split_gain(sum_g, sum_h, l1: float, l2: float):
    """GetLeafSplitGain (feature_histogram.hpp:270-276)."""
    reg = torch.clamp(torch.abs(sum_g) - l1, min=0.0)
    return (reg * reg) / (sum_h + l2)


def leaf_output(sum_g, sum_h, l1: float, l2: float):
    """CalculateSplittedLeafOutput (feature_histogram.hpp:284-289)."""
    reg = torch.clamp(torch.abs(sum_g) - l1, min=0.0)
    return -torch.sign(sum_g) * reg / (sum_h + l2)


def per_feature_scan(hist, total_g, total_h, total_c, num_bin, is_cat,
                     feat_mask, p: SplitParams):
    """The cumulative-scan half of split finding.

    ``hist`` [..., F, B, 3] f32; totals [...] f32; ``num_bin`` [F] int;
    ``is_cat``/``feat_mask`` [F] bool.  Returns (feat_best_gain [..., F]
    without the parent gain_shift, invalid at -inf; feat_best_t [..., F]
    int32; left_g/left_h/left_c [..., F, B])."""
    F, B = hist.shape[-3], hist.shape[-2]
    tg = total_g[..., None, None]
    th = total_h[..., None, None]
    tc = total_c[..., None, None]
    bins = torch.arange(B, dtype=torch.int32,
                        device=hist.device).expand(F, B)

    cum = torch.cumsum(hist, dim=-2)
    cat = is_cat[:, None]
    left_g = torch.where(cat, hist[..., 0], cum[..., 0])
    left_h = torch.where(cat, hist[..., 1], cum[..., 1])
    left_c = torch.where(cat, hist[..., 2], cum[..., 2])
    right_g = tg - left_g
    right_h = th - left_h
    right_c = tc - left_c

    gain_shift = leaf_split_gain(total_g, total_h, p.lambda_l1, p.lambda_l2)
    min_gain_shift = gain_shift + p.min_gain_to_split
    gain = (leaf_split_gain(left_g, left_h, p.lambda_l1, p.lambda_l2)
            + leaf_split_gain(right_g, right_h, p.lambda_l1, p.lambda_l2))

    num_bin = num_bin.to(torch.int32)
    t_limit = torch.where(is_cat, num_bin, num_bin - 1)
    valid = bins < t_limit[:, None]
    valid = valid & (left_c >= p.min_data_in_leaf)
    valid = valid & (right_c >= p.min_data_in_leaf)
    valid = valid & (left_h >= p.min_sum_hessian_in_leaf)
    valid = valid & (right_h >= p.min_sum_hessian_in_leaf)
    valid = valid & (gain > min_gain_shift[..., None, None])
    valid = valid & feat_mask[:, None]
    valid = valid & (num_bin[:, None] > 1)
    gain = torch.where(valid, gain, torch.full_like(gain, K_MIN_SCORE))

    feat_best_gain = torch.amax(gain, dim=-1)
    is_best_t = gain == feat_best_gain[..., None]
    feat_best_t = torch.amax(
        torch.where(is_best_t, bins, torch.full_like(bins, -1)), dim=-1)
    feat_best_gain = torch.where(
        torch.isfinite(feat_best_gain), feat_best_gain,
        torch.full_like(feat_best_gain, K_MIN_SCORE))
    return feat_best_gain, feat_best_t, left_g, left_h, left_c


def per_feature_candidates(hist, total_g, total_h, total_c, num_bin, is_cat,
                           feat_mask, p: SplitParams) -> FeatureCandidates:
    """Per-feature best candidates with the left sums gathered at each
    feature's own best threshold."""
    feat_best_gain, feat_best_t, left_g, left_h, left_c = per_feature_scan(
        hist, total_g, total_h, total_c, num_bin, is_cat, feat_mask, p)
    t = feat_best_t[..., None].long()

    def _at_t(arr):
        return torch.gather(arr, -1, t)[..., 0]

    return FeatureCandidates(gain=feat_best_gain, threshold=feat_best_t,
                             left_g=_at_t(left_g), left_h=_at_t(left_h),
                             left_c=_at_t(left_c))


def combine_feature_candidates(cand: FeatureCandidates, total_g, total_h,
                               can_split, p: SplitParams) -> BestSplit:
    """Across-features half: max gain (ties to the smallest feature),
    then the parent gain_shift subtraction and the ``can_split`` mask."""
    gain_shift = leaf_split_gain(total_g, total_h, p.lambda_l1, p.lambda_l2)
    best_f = torch.argmax(cand.gain, dim=-1)

    def _at_f(arr):
        return torch.gather(arr, -1, best_f[..., None])[..., 0]

    best_gain = _at_f(cand.gain)
    best_t = _at_f(cand.threshold).to(torch.int32)
    splittable = torch.isfinite(best_gain) & can_split
    best_f = best_f.to(torch.int32)
    return BestSplit(
        gain=torch.where(splittable, best_gain - gain_shift,
                         torch.full_like(best_gain, K_MIN_SCORE)),
        feature=torch.where(splittable, best_f, torch.full_like(best_f, -1)),
        threshold=torch.where(splittable, best_t, torch.zeros_like(best_t)),
        left_sum_g=_at_f(cand.left_g),
        left_sum_h=_at_f(cand.left_h),
        left_count=_at_f(cand.left_c),
    )


def find_best_split(hist, total_g, total_h, total_c, num_bin, is_cat,
                    feat_mask, can_split, p: SplitParams) -> BestSplit:
    """Best split for one leaf, or a batch of leaves via leading dims.

    ``hist`` [..., F, B, 3] (sum_g, sum_h, count); totals and
    ``can_split`` [...]; ``num_bin`` [F]; ``is_cat``/``feat_mask`` [F]
    bool.  Returns a :class:`BestSplit` with fields shaped [...]."""
    cand = per_feature_candidates(hist, total_g, total_h, total_c, num_bin,
                                  is_cat, feat_mask, p)
    return combine_feature_candidates(cand, total_g, total_h, can_split, p)
