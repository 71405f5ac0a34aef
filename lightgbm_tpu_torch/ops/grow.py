"""Tree-growth parameters, the flat tree record, and the fixed-trip serial
grower ``grow_tree``.

Port of the JAX package's ops/grow.py: ``GrowParams``, ``TreeArrays``,
the two-vector packing (``pack_tree_arrays`` / ``unpack_tree_arrays``,
shared with the leaf-ordered grower) and ``grow_tree`` with its
``SerialComm`` strategies.  ``grow_tree`` grows one tree leaf-wise in
``num_leaves - 1`` fixed steps, the early stop a masked no-op (once no
leaf can split, no new split ever appears), as the JAX version's
``fori_loop`` does:

  * pick the leaf with the best split (ties to the smallest leaf index);
  * partition: rows of that leaf whose bin is above the threshold
    (numerical) or not equal to it (categorical) take the new leaf index
    in a per-row ``leaf_id`` vector;
  * both children's best splits, by the strategy's histograms.

Node/leaf indexing matches Tree::Split (tree.cpp:52-95): step k creates
internal node k; the left child keeps the parent's leaf index, the right
child becomes leaf k+1; children are ``~leaf`` in the child arrays.

All loop state lives on the device: the per-leaf records as two packed
tables (f32 [L, 8], int32 [L, 4]), the node arrays as two more, the
chosen leaf, ``do_split`` and the new leaf index as 0-dim tensors; rows
are read with ``index_select`` and written with ``index_copy_`` and
``torch.where`` in place of the JAX ``.at[].set``.  The ``nocache`` and
``fused`` strategies therefore read nothing to the host during growth:
one read at the end brings the packed ``TreeArrays`` over.  The
``cached`` strategy reads the smaller child's row count once per split
to pick its compaction size class.  :func:`host_syncs` counts the reads.

Over EFB bundled columns (``bundle``, an ``ops.bundle.BundleDecode``)
``bins`` holds C columns and every histogram pass runs over them: the
cached strategy builds and caches its digit sums in column space and
expands them only for the scan (exact integers); ``nocache`` expands
K2's histograms, and so does ``fused``, which runs the ``nocache`` pass
there (K3's in-kernel scan cannot expand).  The partition decodes the
split feature's bins from its column.
"""

from __future__ import annotations

import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import leafhist
from ..obs.trace import device_range
from .bundle import decode_feature_bins, expand_digit_sums, expand_histogram
from .histogram import (children_histograms, children_split_candidates,
                        root_histogram)
from .split import (BestSplit, FeatureCandidates, SplitParams, K_MIN_SCORE,
                    combine_feature_candidates, find_best_split, leaf_output)


class GrowParams(NamedTuple):
    """Tree-growth configuration.  ``compact_inactive`` (bagging and
    GOSS): the leaf-ordered grower moves the zero-weight rows out of its
    layout once per tree, so its windows cover the sample only; the
    fixed-trip growers take the row weight as it is."""
    num_leaves: int = 31
    max_bin: int = 255
    min_data_in_leaf: int = 100
    min_sum_hessian_in_leaf: float = 10.0
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_gain_to_split: float = 0.0
    max_depth: int = -1
    compact_inactive: bool = False

    def split_params(self) -> SplitParams:
        return SplitParams(self.min_data_in_leaf, self.min_sum_hessian_in_leaf,
                           self.lambda_l1, self.lambda_l2,
                           self.min_gain_to_split)


class TreeArrays(NamedTuple):
    """Flat tree tensors (mirrors tree.h:17-194), padded to ``num_leaves``
    slots like the JAX version: unused nodes have feature -1 and zeros,
    unused leaves parent -1 and zeros.  Leaf values are already scaled by
    the learning rate; internal values are not."""
    num_leaves: torch.Tensor          # 0-dim int32: leaves actually grown
    split_feature: torch.Tensor       # [L-1] int32 inner feature index
    split_bin: torch.Tensor           # [L-1] int32 bin threshold
    split_gain: torch.Tensor          # [L-1] f32
    left_child: torch.Tensor          # [L-1] int32 (~leaf or node)
    right_child: torch.Tensor         # [L-1] int32
    internal_value: torch.Tensor      # [L-1] f32
    internal_count: torch.Tensor      # [L-1] int32
    leaf_value: torch.Tensor          # [L] f32 (shrunk)
    leaf_count: torch.Tensor          # [L] int32
    leaf_parent: torch.Tensor         # [L] int32
    leaf_depth: torch.Tensor          # [L] int32


def pack_tree_arrays(ta: TreeArrays):
    """TreeArrays -> (ints [1 + 5(L-1) + 3L] int32, floats [2(L-1) + L]
    f32): two transfers instead of twelve."""
    ints = torch.cat([
        ta.num_leaves.reshape(1), ta.split_feature, ta.split_bin,
        ta.left_child, ta.right_child, ta.internal_count,
        ta.leaf_count, ta.leaf_parent, ta.leaf_depth])
    flts = torch.cat([ta.split_gain, ta.internal_value, ta.leaf_value])
    return ints, flts


def unpack_tree_arrays(ints, flts, num_leaves: int) -> TreeArrays:
    """Inverse of :func:`pack_tree_arrays`; the fields are views of the
    two vectors, on whatever device they lie."""
    L, n = num_leaves, num_leaves - 1
    io, fo = 1, 0
    out_i = []
    for k in (n, n, n, n, n, L, L, L):
        out_i.append(ints[io:io + k])
        io += k
    out_f = []
    for k in (n, n, L):
        out_f.append(flts[fo:fo + k])
        fo += k
    sf, sb, lc, rc, icnt, leaf_cnt, leaf_par, leaf_dep = out_i
    sg, ival, lval = out_f
    return TreeArrays(num_leaves=ints[0], split_feature=sf, split_bin=sb,
                      split_gain=sg, left_child=lc, right_child=rc,
                      internal_value=ival, internal_count=icnt,
                      leaf_value=lval, leaf_count=leaf_cnt,
                      leaf_parent=leaf_par, leaf_depth=leaf_dep)


# ---------------------------------------------------------------------------
# host reads of grow_tree

_sync_lock = threading.Lock()
_SYNCS = {"host_syncs": 0}


def host_syncs() -> int:
    """Device-to-host reads ``grow_tree`` and the linear fit
    (``models/gbdt.py``) have made since the last reset."""
    with _sync_lock:
        return _SYNCS["host_syncs"]


def reset_host_syncs() -> None:
    with _sync_lock:
        _SYNCS["host_syncs"] = 0


def _read(t: torch.Tensor) -> np.ndarray:
    """One counted device-to-host read."""
    with _sync_lock:
        _SYNCS["host_syncs"] += 1
    return t.cpu().numpy()


# ---------------------------------------------------------------------------
# strategies


class _SerialPrep(NamedTuple):
    """Per-tree device state for the cached serial learner."""
    bins_rm: torch.Tensor     # [N, F] row-major bins
    digits: torch.Tensor      # [N, 9] int8 fixed-point g/h/w digits
    scales: torch.Tensor      # [3] f32 quantization scales


class _StepInfo(NamedTuple):
    """What the partition step already knows about the split being
    applied, handed to the strategy so it never re-derives masks."""
    leaf_id: torch.Tensor      # [N] AFTER the partition update
    in_leaf: torch.Tensor      # [N] bool, rows of the split leaf
    go_right: torch.Tensor     # [N] bool, rows moving to the right child
    parent_leaf: torch.Tensor  # 0-dim int32 (the left child keeps it)
    right_leaf: torch.Tensor   # 0-dim int32
    do_split: torch.Tensor     # 0-dim bool


def _first(cand: FeatureCandidates) -> FeatureCandidates:
    return FeatureCandidates(*(a[0] for a in cand))


class SerialComm(NamedTuple):
    """Single-device strategy of ``grow_tree`` (no collectives).

    ``leaf_cache=True`` (the default, ``serial_grow=cached``): keep every
    live leaf's histogram as int32 digit sums (``[L, F, 9, B]``), build
    only the smaller child of a split over its compacted rows with K1
    (``leafhist.leaf_histogram``) and take the sibling by exact
    subtraction (reference serial_tree_learner.cpp:398-453).

    ``leaf_cache=False`` (the ``hist_cache`` degrade step): one full pass
    over all rows per split builds both children's f32 histograms (K2,
    ``histogram.children_histograms``), then ``find_best_split``.

    ``fused_gain`` with ``leaf_cache=False`` (``serial_grow=fused``): the
    full pass emits only the per-feature candidates (K3,
    ``histogram.children_split_candidates``); the [2, F, B, 3] histogram
    never leaves the kernel's scratch.  Ignored with the cache on, which
    needs the histograms themselves for the subtraction.

    With a ``bundle`` the cache holds column-space sums ``[L, C, 9, B]``
    (the histogram saving lives there) and each scan expands the two
    children's sums to the original features; the full-pass strategies
    expand K2's histograms, ``fused_gain`` running the ``leaf_cache=False``
    pass: K3's scan cannot expand, and the JAX package's half-fused pass
    there (K2, the expansion, ``per_feature_candidates``) chooses the
    splits ``find_best_split`` chooses."""
    leaf_cache: bool = True
    fused_gain: bool = False

    def reduce_sums(self, sums):
        return sums

    def traffic_per_tree(self, num_features: int, max_bin: int,
                         num_leaves: int):
        """The collective account of one tree (``parallel/comm.py``'s
        interface): serial growth issues no collectives."""
        return {}

    def prepare(self, bins, bins_rm, g, h, w, params: GrowParams):
        if not self.leaf_cache:
            return None
        if bins_rm is None:
            bins_rm = bins.T.contiguous()
        scales = leafhist.compute_scales(g, h, w)
        digits = leafhist.quantize_digits(g, h, w, scales)
        return _SerialPrep(bins_rm, digits, scales)

    def root_split(self, prep, bins, g, h, w, root_g, root_h, root_c,
                   num_bin, is_cat, feat_mask, max_bin: int,
                   sp: SplitParams, num_leaves: int, bundle=None):
        dev = bins.device
        true = torch.ones((), dtype=torch.bool, device=dev)
        if not self.leaf_cache:
            if self.fused_gain and bundle is None:
                # all rows in the "left" child; the right child's totals
                # are zero and its candidates are discarded
                totals = torch.stack([
                    torch.stack([root_g, root_h, root_c]),
                    torch.zeros(3, dtype=torch.float32, device=dev)])
                with device_range("hist"):
                    cand = children_split_candidates(
                        bins, g, h, w,
                        torch.zeros(bins.shape[1], dtype=torch.int32,
                                    device=dev),
                        0, -2, totals, num_bin, is_cat, feat_mask, max_bin,
                        sp)
                with device_range("find_split"):
                    return combine_feature_candidates(
                        _first(cand), root_g, root_h, true, sp), None
            with device_range("hist"):
                hist = root_histogram(bins, g, h, w, max_bin)
                if bundle is not None:
                    hist = expand_histogram(hist, bundle)
            with device_range("find_split"):
                return find_best_split(hist, root_g, root_h, root_c,
                                       num_bin, is_cat, feat_mask, true,
                                       sp), None
        F = bins.shape[0]
        with device_range("hist"):
            sums = leafhist.digit_histogram(prep.bins_rm, prep.digits,
                                            max_bin)
            scan_sums = (sums if bundle is None
                         else expand_digit_sums(sums, bundle))
            hist = leafhist.combine_digit_sums(scan_sums, prep.scales)
        with device_range("find_split"):
            split = find_best_split(hist, root_g, root_h, root_c, num_bin,
                                    is_cat, feat_mask, true, sp)
        cache = torch.zeros((num_leaves, F, leafhist.NUM_STREAMS, max_bin),
                            dtype=torch.int32, device=dev)
        cache[0] = sums
        return split, cache

    def children_splits(self, prep, cache, bins, g, h, w, step: _StepInfo,
                        totals_g, totals_h, totals_c, can, num_bin, is_cat,
                        feat_mask, max_bin: int, sp: SplitParams,
                        bundle=None):
        if not self.leaf_cache:
            if self.fused_gain and bundle is None:
                totals = torch.stack([totals_g, totals_h, totals_c], dim=-1)
                with device_range("hist"):
                    cand = children_split_candidates(
                        bins, g, h, w, step.leaf_id, step.parent_leaf,
                        step.right_leaf, totals, num_bin, is_cat, feat_mask,
                        max_bin, sp)
                with device_range("find_split"):
                    return combine_feature_candidates(
                        cand, totals_g, totals_h, can, sp), cache
            with device_range("hist"):
                hists = children_histograms(bins, g, h, w, step.leaf_id,
                                            step.parent_leaf,
                                            step.right_leaf, max_bin)
                if bundle is not None:
                    hists = expand_histogram(hists, bundle)
            with device_range("find_split"):
                return find_best_split(hists, totals_g, totals_h, totals_c,
                                       num_bin, is_cat, feat_mask, can,
                                       sp), cache
        with device_range("hist"):
            hists = self._cached_children_hists(prep, cache, step, max_bin,
                                                bundle)
        with device_range("find_split"):
            return find_best_split(hists, totals_g, totals_h, totals_c,
                                   num_bin, is_cat, feat_mask, can,
                                   sp), cache

    def _cached_children_hists(self, prep, cache, step: _StepInfo,
                               max_bin: int, bundle=None):
        """Both children's histograms from the smaller child's K1 pass
        and the cached parent (the cache updated in place)."""
        classes = leafhist.size_classes(step.leaf_id.shape[0])
        # raw (unweighted) row counts decide which child is smaller, like
        # the reference's data-count rule (serial_tree_learner.cpp:404-420)
        cnt_r = torch.sum((step.in_leaf & step.go_right).to(torch.int32))
        cnt_l = torch.sum(step.in_leaf.to(torch.int32)) - cnt_r
        small_is_left = cnt_l <= cnt_r
        mask_small = step.in_leaf & torch.where(small_is_left,
                                                ~step.go_right,
                                                step.go_right)
        small_cnt = int(_read(torch.minimum(cnt_l, cnt_r)))
        sums_small = leafhist.leaf_histogram(prep.bins_rm, prep.digits,
                                             mask_small, small_cnt, max_bin,
                                             classes)
        pair = torch.stack([step.parent_leaf, step.right_leaf]).long()
        cur = cache.index_select(0, pair)           # parent, right slot
        sums_large = cur[0] - sums_small            # EXACT sibling
        sums_left = torch.where(small_is_left, sums_small, sums_large)
        sums_right = torch.where(small_is_left, sums_large, sums_small)
        both = torch.stack([sums_left, sums_right])
        # in place: the cache is this tree's alone
        cache.index_copy_(0, pair, torch.where(step.do_split, both, cur))
        if bundle is not None:
            both = expand_digit_sums(both, bundle)
        return leafhist.combine_digit_sums(both, prep.scales)


# ---------------------------------------------------------------------------
# the grower

# columns of the per-leaf tables
_BEST_GAIN, _TOTAL_G, _TOTAL_C, _CUR_VALUE = 0, 4, 6, 7   # f32 [L, 8]
_BEST_FEAT, _PARENT, _DEPTH = 0, 2, 3                    # int32 [L, 4]
# columns of the node tables
_SPLIT_GAIN, _INTERNAL_VALUE = 0, 1                      # f32 [L-1, 2]
_LEFT, _RIGHT = 2, 3                                     # int32 [L-1, 5]


class _GrowState(NamedTuple):
    leaf_id: torch.Tensor     # [N] int32
    num_leaves: torch.Tensor  # 0-dim int32
    stopped: torch.Tensor     # 0-dim bool
    # per leaf: best_gain, best_left_g, best_left_h, best_left_c,
    # total_g, total_h, total_c, cur_value (leaf output at creation,
    # unshrunk)
    leaf_f: torch.Tensor      # [L, 8] f32
    # per leaf: best_feat, best_bin, leaf_parent, leaf_depth
    leaf_i: torch.Tensor      # [L, 4] int32
    # per node: split_gain, internal_value
    node_f: torch.Tensor      # [L-1, 2] f32
    # per node: split_feature, split_bin, left_child, right_child,
    # internal_count
    node_i: torch.Tensor      # [L-1, 5] int32


def _split_rows(split: BestSplit):
    """A BestSplit (fields [k] or 0-dim) as its f32 columns [k, 4] and
    int32 columns [k, 2] of the per-leaf tables."""
    f = torch.stack([split.gain, split.left_sum_g, split.left_sum_h,
                     split.left_count], dim=-1).reshape(-1, 4)
    i = torch.stack([split.feature, split.threshold],
                    dim=-1).reshape(-1, 2).to(torch.int32)
    return f, i


def _store_leaf_split(state: _GrowState, leaf: torch.Tensor,
                      split: BestSplit) -> None:
    """Write BestSplit records into the rows ``leaf`` [k] (int64) of the
    per-leaf tables, in place."""
    f, i = _split_rows(split)
    state.leaf_f[:, :4].index_copy_(0, leaf, f)
    state.leaf_i[:, :2].index_copy_(0, leaf, i)


def _feature_bins(bins: torch.Tensor, feat: torch.Tensor,
                  bundle=None) -> torch.Tensor:
    """Feature ``feat`` (0-dim) of ``bins`` as int32 [N]: its row of
    ``bins`` [F, N], or decoded from its column under a ``bundle``."""
    if bundle is not None:
        return decode_feature_bins(bins, feat, bundle).to(torch.int32)
    if bins.dtype == torch.uint16:
        row = bins.view(torch.int16).index_select(0, feat.reshape(1))[0]
        return row.to(torch.int32) & 0xFFFF
    return bins.index_select(0, feat.reshape(1))[0].to(torch.int32)


def grow_tree(bins: torch.Tensor, num_bin: torch.Tensor,
              is_cat: torch.Tensor, feat_mask: torch.Tensor,
              grad: torch.Tensor, hess: torch.Tensor,
              row_weight: torch.Tensor, learning_rate: float,
              params: GrowParams, comm: Optional[SerialComm] = None,
              bins_rm: Optional[torch.Tensor] = None, bundle=None):
    """Grow one tree on the device of ``bins``.

    ``bins`` [F, N] uint8/uint16 feature-major; ``num_bin`` [F] int32,
    ``is_cat`` and ``feat_mask`` [F] bool; ``grad``/``hess`` [N] f32 raw
    gradients and hessians, ``row_weight`` [N] f32 (it also scales
    grad/hess); ``comm`` the strategy (``SerialComm()`` by default);
    ``bins_rm`` an optional [N, F] row-major copy of ``bins`` for the
    cached strategy (transposed from ``bins`` when omitted); ``bundle``
    an optional ``ops.bundle.BundleDecode`` when ``bins`` are EFB
    columns [C, N] (``num_bin``, ``is_cat`` and ``feat_mask`` stay in
    original feature space).

    Returns (TreeArrays on the host CPU, leaf_id [N] int32 and
    output_delta [N] f32 on the device), where output_delta is each
    row's shrunk leaf value (the train-score update)."""
    comm = SerialComm() if comm is None else comm
    L, B = params.num_leaves, params.max_bin
    N = bins.shape[1]
    dev = bins.device
    sp = params.split_params()

    g = grad * row_weight
    h = hess * row_weight
    root_g, root_h, root_c = comm.reduce_sums(
        (torch.sum(g), torch.sum(h), torch.sum(row_weight)))

    prep = comm.prepare(bins, bins_rm, g, h, row_weight, params)
    root_split, cache = comm.root_split(prep, bins, g, h, row_weight,
                                        root_g, root_h, root_c, num_bin,
                                        is_cat, feat_mask, B, sp, L,
                                        bundle=bundle)

    leaf_f = torch.zeros((L, 8), dtype=torch.float32, device=dev)
    leaf_f[:, _BEST_GAIN] = K_MIN_SCORE
    leaf_f[0, _TOTAL_G:_TOTAL_C + 1] = torch.stack([root_g, root_h, root_c])
    leaf_i = torch.zeros((L, 4), dtype=torch.int32, device=dev)
    leaf_i[:, _PARENT] = -1
    node_i = torch.zeros((L - 1, 5), dtype=torch.int32, device=dev)
    node_i[:, 0] = -1
    state = _GrowState(
        leaf_id=torch.zeros(N, dtype=torch.int32, device=dev),
        num_leaves=torch.ones((), dtype=torch.int32, device=dev),
        stopped=torch.zeros((), dtype=torch.bool, device=dev),
        leaf_f=leaf_f, leaf_i=leaf_i,
        node_f=torch.zeros((L - 1, 2), dtype=torch.float32, device=dev),
        node_i=node_i)
    _store_leaf_split(state, torch.zeros(1, dtype=torch.int64, device=dev),
                      root_split)

    for k in range(L - 1):
        state, cache = _step(k, state, cache, comm, prep, bins, g, h,
                             row_weight, num_bin, is_cat, feat_mask, params,
                             sp, bundle)

    shrunk = state.leaf_f[:, _CUR_VALUE] * learning_rate
    tree = TreeArrays(
        num_leaves=state.num_leaves,
        split_feature=state.node_i[:, 0], split_bin=state.node_i[:, 1],
        split_gain=state.node_f[:, _SPLIT_GAIN],
        left_child=state.node_i[:, _LEFT],
        right_child=state.node_i[:, _RIGHT],
        internal_value=state.node_f[:, _INTERNAL_VALUE],
        internal_count=state.node_i[:, 4],
        leaf_value=shrunk,
        leaf_count=state.leaf_f[:, _TOTAL_C].to(torch.int32),
        leaf_parent=state.leaf_i[:, _PARENT],
        leaf_depth=state.leaf_i[:, _DEPTH])
    output_delta = shrunk[state.leaf_id.long()]
    # one read for the whole tree: the int32 vector rides bit for bit in
    # an f32 view beside the floats
    ints, flts = pack_tree_arrays(tree)
    host = _read(torch.cat([ints.view(torch.float32), flts]))
    n_i = ints.shape[0]
    tree = unpack_tree_arrays(torch.from_numpy(host[:n_i].view(np.int32)),
                              torch.from_numpy(host[n_i:].copy()), L)
    return tree, state.leaf_id, output_delta


def _step(k: int, state: _GrowState, cache, comm: SerialComm, prep, bins,
          g, h, w, num_bin, is_cat, feat_mask, params: GrowParams,
          sp: SplitParams, bundle=None):
    """Split step ``k`` (it creates internal node ``k`` when it splits)."""
    dev = bins.device
    # best leaf by gain; ties -> the smallest leaf index, like
    # ArrayArgs::ArgMax over SplitInfo (serial_tree_learner.cpp:204)
    best_leaf = torch.argmax(state.leaf_f[:, _BEST_GAIN]).to(torch.int32)
    rf = state.leaf_f.index_select(0, best_leaf.reshape(1))[0]   # [8]
    ri = state.leaf_i.index_select(0, best_leaf.reshape(1))[0]   # [4]
    gain = rf[_BEST_GAIN]
    do_split = ~state.stopped & (gain > 0.0)
    feat, tbin = ri[_BEST_FEAT], ri[1]
    right_leaf = state.num_leaves          # the new leaf (tree.cpp:89)

    # partition: rows of best_leaf with bin > t (numerical) or bin != t
    # (categorical) move to the right child
    with device_range("split"):
        feat_c = feat.clamp(min=0)
        fbin = _feature_bins(bins, feat_c, bundle)
        cat_f = is_cat.index_select(0, feat_c.reshape(1))[0]
        go_right = torch.where(cat_f, fbin != tbin, fbin > tbin)
        in_leaf = state.leaf_id == best_leaf
        new_leaf_id = torch.where(do_split & in_leaf & go_right, right_leaf,
                                  state.leaf_id)

    # split sums: rows (left, right) x cols (g, h, count)
    left = rf[1:4]
    totals = torch.stack([left, rf[_TOTAL_G:_TOTAL_C + 1] - left])   # [2, 3]
    vals = leaf_output(totals[:, 0], totals[:, 1], sp.lambda_l1,
                       sp.lambda_l2)                                 # [2]

    # tree structure (Tree::Split, tree.cpp:52-95): first the parent
    # node's pointer to this leaf, then node k itself
    node_t = torch.full((), k, dtype=torch.int32, device=dev)
    parent_node = ri[_PARENT]
    p_safe = parent_node.clamp(min=0).reshape(1)
    prow = state.node_i.index_select(0, p_safe)[0]                   # [5]
    was_left = prow[_LEFT] == ~best_leaf
    upd_parent = do_split & (parent_node >= 0)
    prow = torch.cat([prow[:_LEFT], torch.stack([
        torch.where(upd_parent & was_left, node_t, prow[_LEFT]),
        torch.where(upd_parent & ~was_left, node_t, prow[_RIGHT])]),
        prow[_RIGHT + 1:]])
    state.node_i.index_copy_(0, p_safe.long(), prow[None])
    state.node_i[k] = torch.where(do_split, torch.stack([
        feat, tbin, ~best_leaf, ~right_leaf, rf[_TOTAL_C].to(torch.int32)]),
        state.node_i[k])
    state.node_f[k] = torch.where(
        do_split, torch.stack([gain, rf[_CUR_VALUE]]), state.node_f[k])

    # both children's best splits
    depth = ri[_DEPTH]
    child_depth_ok = (torch.ones((), dtype=torch.bool, device=dev)
                      if params.max_depth <= 0
                      else depth + 1 < params.max_depth)
    can = (do_split & child_depth_ok).expand(2)
    info = _StepInfo(leaf_id=new_leaf_id, in_leaf=in_leaf,
                     go_right=go_right, parent_leaf=best_leaf,
                     right_leaf=right_leaf, do_split=do_split)
    child, cache = comm.children_splits(
        prep, cache, bins, g, h, w, info, totals[:, 0], totals[:, 1],
        totals[:, 2], can, num_bin, is_cat, feat_mask, params.max_bin, sp,
        bundle=bundle)

    # the split leaf (left child) and the new leaf (right child): split
    # records, totals, value, parent node and depth; nothing changes
    # when the step does not split (the new leaf's slot keeps its zeros)
    pair = torch.stack([best_leaf, right_leaf]).long()
    cur_f = state.leaf_f.index_select(0, pair)
    cur_f[1, _TOTAL_G:] = 0.0
    cur_i = state.leaf_i.index_select(0, pair)
    cur_i[1, _PARENT] = -1
    cur_i[1, _DEPTH] = 0
    split_f, split_i = _split_rows(child)
    new_f = torch.cat([split_f, totals, vals[:, None]], dim=1)
    new_i = torch.cat([split_i, node_t.expand(2, 1),
                       (depth + 1).expand(2, 1)], dim=1)
    state.leaf_f.index_copy_(0, pair, torch.where(do_split, new_f, cur_f))
    state.leaf_i.index_copy_(0, pair, torch.where(do_split, new_i, cur_i))
    return state._replace(
        leaf_id=new_leaf_id,
        num_leaves=state.num_leaves + do_split.to(torch.int32),
        stopped=~do_split), cache
