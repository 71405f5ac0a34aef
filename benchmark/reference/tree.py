"""Plain reference of LightGBM's leaf-wise tree growth over binned
features (serial_tree_learner.cpp, feature_histogram.hpp), in torch.

A tree is a dict of arrays: ``num_leaves``, ``split_feature``,
``split_bin`` (rows with code <= bin go left), ``left_child`` /
``right_child`` (a child below 0 is the leaf ``~child``) and
``leaf_value``.  Node ``i`` is the ``i``-th split made; the split leaf
keeps its index on the left and the new leaf ``i + 1`` is on the right.

``grow`` grows a tree; ``judge`` takes a tree some other program grew on
the same rows and gradients and measures how far each of its choices
lies from this reference's: the split of every step against the best
split of the leaf it split and of every leaf open at that step, each
split's hessian constraint, and every leaf value.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import numpy as np
import torch


class Params(NamedTuple):
    num_leaves: int
    learning_rate: float
    min_data_in_leaf: float
    min_sum_hessian_in_leaf: float
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_gain_to_split: float = 0.0

    @classmethod
    def from_config(cls, p: dict) -> "Params":
        return cls(int(p["num_leaves"]), float(p["learning_rate"]),
                   float(p.get("min_data_in_leaf", 20)),
                   float(p.get("min_sum_hessian_in_leaf", 1e-3)),
                   float(p.get("lambda_l1", 0.0)),
                   float(p.get("lambda_l2", 0.0)),
                   float(p.get("min_gain_to_split", 0.0)))


def _leaf_gain(g, h, p: Params):
    r = torch.clamp(g.abs() - p.lambda_l1, min=0.0)
    return r * r / (h + p.lambda_l2)


def leaf_output(g, h, p: Params):
    r = torch.clamp(g.abs() - p.lambda_l1, min=0.0)
    return -torch.sign(g) * r / (h + p.lambda_l2)


def histograms(codes: torch.Tensor, leaf: torch.Tensor, g, h, num_leaves: int,
               num_bins: int, dtype) -> torch.Tensor:
    """[num_leaves, F, B, 3] sums of (g, h, count) by leaf, feature, bin."""
    N, F = codes.shape
    vals = torch.stack([g.to(dtype), h.to(dtype),
                        torch.ones_like(g, dtype=dtype)], 1)
    out = torch.zeros(num_leaves * F * num_bins, 3, dtype=dtype,
                      device=codes.device)
    base = leaf.long() * (F * num_bins)
    for f in range(F):
        out.index_add_(0, base + f * num_bins + codes[:, f].long(), vals)
    return out.view(num_leaves, F, num_bins, 3)


def best_splits(hist: torch.Tensor, num_bin: torch.Tensor, p: Params):
    """Each row's best split of ``hist`` [R, F, B, 3]: (gain over the
    unsplit leaf, -inf where none is valid; feature; bin).  Equal gains
    go to the largest bin of a feature, then to the smallest feature."""
    R, F, B, _ = hist.shape
    tot = hist[:, 0].sum(1)                                    # [R, 3]
    left = hist.cumsum(2)
    right = tot[:, None, None, :] - left
    gain = _leaf_gain(left[..., 0], left[..., 1], p) \
        + _leaf_gain(right[..., 0], right[..., 1], p)
    shift = _leaf_gain(tot[:, 0], tot[:, 1], p)
    t = torch.arange(B, device=hist.device)
    valid = (t[None, :] < num_bin[:, None] - 1)[None] \
        & (left[..., 2] >= p.min_data_in_leaf) \
        & (right[..., 2] >= p.min_data_in_leaf) \
        & (left[..., 1] >= p.min_sum_hessian_in_leaf) \
        & (right[..., 1] >= p.min_sum_hessian_in_leaf) \
        & (gain > (shift + p.min_gain_to_split)[:, None, None])
    gain = torch.where(valid, gain, torch.full_like(gain, -torch.inf))
    rev = gain.flip(2)
    fb = B - 1 - rev.argmax(2)                                  # [R, F]
    fg = gain.gather(2, fb[..., None])[..., 0]
    f = fg.argmax(1)
    best = fg.gather(1, f[:, None])[:, 0] - shift
    return best, f, fb.gather(1, f[:, None])[:, 0]


def leaf_of_rows(codes: torch.Tensor, tree: Dict) -> torch.Tensor:
    """[N] leaf index of every row."""
    N = codes.shape[0]
    dev = codes.device
    if tree["num_leaves"] <= 1:
        return torch.zeros(N, dtype=torch.int64, device=dev)
    sf = torch.as_tensor(tree["split_feature"], dtype=torch.int64, device=dev)
    sb = torch.as_tensor(tree["split_bin"], dtype=torch.int64, device=dev)
    lc = torch.as_tensor(tree["left_child"], dtype=torch.int64, device=dev)
    rc = torch.as_tensor(tree["right_child"], dtype=torch.int64, device=dev)
    node = torch.zeros(N, dtype=torch.int64, device=dev)
    for _ in range(tree["num_leaves"]):
        inner = node >= 0
        nd = node.clamp(min=0)
        c = codes.gather(1, sf[nd][:, None])[:, 0].long()
        nxt = torch.where(c <= sb[nd], lc[nd], rc[nd])
        node = torch.where(inner, nxt, node)
        if not bool((node >= 0).any()):
            break
    return ~node


def grow(codes, num_bin, g, h, p: Params, acc_dtype=torch.float64,
         out_dtype=torch.float64) -> Dict:
    """Grow one tree leaf-wise: the leaf with the largest gain splits
    next (ties to the smallest leaf index) until ``num_leaves`` leaves
    or no valid split.  Sums accumulate in ``acc_dtype``; leaf values are
    rounded to ``out_dtype``."""
    N, F = codes.shape
    B = int(num_bin.max())
    L = p.num_leaves
    leaf = torch.zeros(N, dtype=torch.int64, device=codes.device)
    hist = {0: histograms(codes, leaf, g, h, 1, B, acc_dtype)[0]}
    gains = np.full(L, -np.inf)
    split = {}

    def find(leaf_ids):
        b, f, t = best_splits(torch.stack([hist[i] for i in leaf_ids]),
                              num_bin, p)
        for i, bi, fi, ti in zip(leaf_ids, b.tolist(), f.tolist(), t.tolist()):
            gains[i] = bi
            split[i] = (fi, ti)

    find([0])
    sf, sb, lc, rc = [], [], [], []
    parent_node = {0: -1}
    n_leaves = 1
    for node in range(L - 1):
        best = int(np.argmax(gains[:n_leaves]))
        if not gains[best] > 0.0:
            break
        f, t = split[best]
        new = n_leaves
        mask = leaf == best
        right = mask & (codes[:, f].long() > t)
        leaf[right] = new
        n_right = int(right.sum())
        n_left = int(mask.sum()) - n_right
        small, big = (best, new) if n_left <= n_right else (new, best)
        rows = torch.nonzero(leaf == small)[:, 0]
        hs = histograms(codes[rows], torch.zeros_like(rows), g[rows], h[rows],
                        1, B, acc_dtype)[0]
        hist[big] = hist[best] - hs
        hist[small] = hs
        pn = parent_node[best]
        if pn >= 0:
            if lc[pn] == ~best:
                lc[pn] = node
            else:
                rc[pn] = node
        sf.append(f)
        sb.append(t)
        lc.append(~best)
        rc.append(~new)
        parent_node[best] = parent_node[new] = node
        n_leaves += 1
        find([best, new])
    tot = torch.stack([hist[i][0].sum(0) for i in range(n_leaves)])
    gl, hl = tot[:, 0].to(out_dtype), tot[:, 1].to(out_dtype)
    val = (leaf_output(gl, hl, p) * p.learning_rate).to(out_dtype)
    return {"num_leaves": n_leaves, "split_feature": np.array(sf, np.int64),
            "split_bin": np.array(sb, np.int64),
            "left_child": np.array(lc, np.int64),
            "right_child": np.array(rc, np.int64),
            "leaf_value": val.double().cpu().numpy()}


def _region(child: int, L: int) -> int:
    """Region index of a child: nodes keep theirs, leaf l is L - 1 + l."""
    return child if child >= 0 else L - 1 + ~child


def judge(codes, num_bin, tree: Dict, g, h, p: Params, leaf=None) -> Dict:
    """How far ``tree``, grown by another program from these rows and
    gradients, lies from this reference's choices, in f64:

    * ``split_regret``: over the steps, the largest of (best gain of the
      leaf that split - gain of the split made) and (best gain of any
      leaf open at that step - best gain of the leaf that split), as a
      share of the larger gain; a tree that stopped short of
      ``num_leaves`` adds the best gain left among its leaves as a share
      of its root's;
    * ``hessian_shortfall``: the largest share by which a child of a
      split falls below ``min_sum_hessian_in_leaf``;
    * ``leaf_value_gap``: the largest gap between a leaf's value and the
      reference's value of the same rows, as a share of the larger of
      that value and the median leaf value's size.
    """
    L = int(tree["num_leaves"])
    if leaf is None:
        leaf = leaf_of_rows(codes, tree)
    F = codes.shape[1]
    B = int(num_bin.max())
    hl = histograms(codes, leaf, g, h, L, B, torch.float64)
    tot_leaf = hl[:, 0].sum(1)                                  # [L, 3]
    ref_val = leaf_output(tot_leaf[:, 0], tot_leaf[:, 1], p) * p.learning_rate
    prog_val = torch.as_tensor(tree["leaf_value"][:L], dtype=torch.float64,
                               device=codes.device)
    scale = torch.clamp(ref_val.abs(), min=float(ref_val.abs().median()))
    scale = torch.clamp(scale, min=1e-300)
    out = {"leaf_value_gap": float(((prog_val - ref_val).abs() / scale).max()),
           "split_regret": 0.0, "hessian_shortfall": 0.0}
    if L <= 1:
        return out
    R = 2 * L - 1
    hist = torch.empty(R, F, B, 3, dtype=torch.float64, device=codes.device)
    hist[L - 1:] = hl
    lc = [int(c) for c in tree["left_child"][:L - 1]]
    rc = [int(c) for c in tree["right_child"][:L - 1]]
    for node in reversed(range(L - 1)):
        hist[node] = hist[_region(lc[node], L)] + hist[_region(rc[node], L)]
    best, _, _ = best_splits(hist, num_bin, p)
    best = best.cpu().numpy()
    tot = hist[:, 0].sum(1).cpu().numpy()                       # [R, 3]
    # the split actually made at each node, from its children's sums
    li = np.array([_region(c, L) for c in lc])
    ri = np.array([_region(c, L) for c in rc])
    pg = torch.as_tensor(tot)
    made = (_leaf_gain(pg[li, 0], pg[li, 1], p) + _leaf_gain(pg[ri, 0], pg[ri, 1], p)
            - _leaf_gain(pg[:L - 1, 0], pg[:L - 1, 1], p)).numpy()
    regret = 0.0
    # region r is open from the step after its parent split (the root
    # from step 0) until the step that splits it (leaves: never)
    opened = np.zeros(R, np.int64)
    for node in range(L - 1):
        opened[li[node]] = opened[ri[node]] = node + 1
    closes = np.concatenate([np.arange(L - 1), np.full(L, L)])
    for step in range(L - 1):
        b = best[step]
        if b > 0:
            regret = max(regret, max(0.0, b - made[step]) / b)
        elif made[step] <= 0:
            regret = max(regret, 1.0)
        open_ = (opened <= step) & (closes >= step)
        top = best[open_].max()
        if top > 0:
            regret = max(regret, max(0.0, top - max(b, 0.0)) / top)
    if L < p.num_leaves and best[0] > 0:
        regret = max(regret, max(0.0, best[L - 1:].max()) / best[0])
    out["split_regret"] = float(regret)
    if p.min_sum_hessian_in_leaf > 0:
        child_h = np.minimum(tot[li, 1], tot[ri, 1])
        out["hessian_shortfall"] = float(max(
            0.0, (p.min_sum_hessian_in_leaf - child_h.min())
            / p.min_sum_hessian_in_leaf))
    return out


def judge_run(codes, num_bin, trees: List[Dict], check: List[int],
              early: List[int], objective, state, prog_score, p: Params
              ) -> Dict:
    """Walk every tree from a zero score in f64, judge the trees whose
    index is in ``check`` on the gradients of the score before them,
    and compare the final score with ``prog_score`` (the program's
    training scores after the last tree): the largest gap as a share of
    the larger of that row's score and the median score's size.

    ``split_regret`` is the worst of the ``early`` trees (among
    ``check``): late trees split leaves whose gain is a small rest of
    their G^2/H, where a float32 scan's rounding alone moves choices by
    percents."""
    score = torch.zeros(codes.shape[0], dtype=torch.float64,
                        device=codes.device)
    worst = {"split_regret": 0.0, "hessian_shortfall": 0.0,
             "leaf_value_gap": 0.0}
    checked = set(check)
    for i, t in enumerate(trees):
        leaf = leaf_of_rows(codes, t)
        if i in checked:
            g, h = objective.gradients(state, score)
            got = judge(codes, num_bin, t, g, h, p, leaf)
            if i not in early:
                got["split_regret"] = 0.0
            for k in worst:
                worst[k] = max(worst[k], got[k])
        score += torch.as_tensor(t["leaf_value"], dtype=torch.float64,
                                 device=codes.device)[leaf]
    prog = torch.as_tensor(np.asarray(prog_score, np.float64),
                           device=codes.device)
    scale = torch.clamp(score.abs(), min=max(float(score.abs().median()),
                                             1e-300))
    worst["score_gap"] = float(((prog - score).abs() / scale).max())
    return worst
