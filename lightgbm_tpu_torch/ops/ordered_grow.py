"""Leaf-ordered (DataPartition-style) serial tree growth.

Port of the JAX package's ops/ordered_grow.py ``grow_tree_ordered``.
The grower keeps the reference's
DataPartition invariant (data_partition.hpp) on the data itself: a
row-major ``[N, F]`` bin tensor, an ``[N, 9]`` int8 digit tensor and a
row-id permutation in which every leaf's rows are one contiguous
segment.  Splitting a leaf touches only its segment:

  * a stable left/right partition of the segment: a cumulative count of
    the go-right rows gives every row its destination, and one gather
    per tensor moves the rows (the JAX version partitions int32 words
    packed by :func:`pack_u8_words` with segment sorts, TPU workarounds
    not carried over; the packing itself serves the windowed histogram
    P2, ``ops/window_hist.py``);
  * the smaller child's K1 histogram over its contiguous window, handed
    to the kernel as the base tensors plus a row offset and a count;
  * the sibling by exact int32 subtraction from the parent's cached sums;
  * ``find_best_split`` on both children in one batched call.

With ``compact_inactive`` (bagging, GOSS) the grower first moves the
rows of zero weight out of its layout, stably (the JAX version sorts
them behind the active segment; the port keeps only the active rows):
the root histogram and every later window cover the sample only, and
the rows out of the sample take their leaf from a walk of the grown
tree over their bins (``ops/predict.predict_binned_tree``), as the
reference scores its out-of-bag rows.

The per-leaf bookkeeping (best split, totals, segment start and count)
lives on the host in numpy f32/int32, with the same f32 operations as
the JAX version's packed device buffers; the device holds the rows, the
digits and the histogram cache.  The left child's row count is the
best split's ``left_count``: the w digit stream is the row weight, 0 or
1, so the count is exact when every row of the layout has weight 1 (no
sampling, or a compacted sample), and the host needs no read of the
partition to place the child windows.  Every such count is checked
against the partition once per tree.  A row weight with zeros left in
the layout (sampling without ``compact_inactive``) reads each split's
count from the partition instead.

Host syncs per tree: one to read the root sums and split, one per split
to read the two children's best splits, one at the end to check the
partition counts, and with ``compact_inactive`` one for the sample's
size; the registry's ``grower_host_reads`` counts them (``grow._read``).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..utils.log import LightGBMError
from ..obs.trace import device_range
from . import leafhist
from .grow import GrowParams, TreeArrays, _read
from .predict import predict_binned_tree
from .split import K_MIN_SCORE, find_best_split, leaf_output

# columns of the host per-leaf buffers (the JAX version's packed layout)
_LF = dict(best_gain=0, best_left_g=1, best_left_h=2, best_left_c=3,
           total_g=4, total_h=5, total_c=6, cur_value=7)
_LI = dict(best_feat=0, best_bin=1, parent=2, depth=3, start=4, cnt=5)


def pack_u8_words(x_u8: torch.Tensor) -> torch.Tensor:
    """[N, C] uint8 -> a contiguous [ceil(C/4), N] int32 buffer whose rows
    are the words (the JAX package's tuple of [N] words, stacked):
    column ``c`` sits in word ``c // 4`` at bits ``8 * (c % 4)``
    (little-endian, as the JAX package's bitcast packs it)."""
    n, c = x_u8.shape
    w = -(-c // 4)
    if w * 4 != c:
        x_u8 = torch.nn.functional.pad(x_u8, (0, w * 4 - c))
    return x_u8.contiguous().view(torch.int32).t().contiguous()


def unpack_words(words: torch.Tensor, c: int) -> torch.Tensor:
    """[W, N] int32 words -> [N, c] uint8 (inverse of
    :func:`pack_u8_words`)."""
    # clone, not contiguous(): an empty window's transpose counts as
    # contiguous with its old strides, which view() refuses
    stacked = words.t().clone(memory_format=torch.contiguous_format)
    return stacked.view(torch.uint8)[:, :c].contiguous()


def _upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Host numpy -> ``dev`` without waiting for the device: a pinned
    staging copy and an asynchronous transfer on a card."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.clone()


def _storage(bins_rm: torch.Tensor) -> torch.Tensor:
    """A same-size view the gather ops support on every device (torch's
    uint16 support is partial)."""
    return bins_rm.view(torch.int16) if bins_rm.dtype == torch.uint16 \
        else bins_rm


def _partition(store, dig, row_ord, s: int, c: int, feat: int, tbin: int,
               cat_f: torch.Tensor) -> torch.Tensor:
    """Stable partition of rows [s, s+c) into go-left then go-right, in
    place; returns the device count of left rows."""
    seg_b, seg_d, seg_r = store[s:s + c], dig[s:s + c], row_ord[s:s + c]
    col = seg_b[:, feat].to(torch.int32)
    if store.dtype == torch.int16:
        col = col & 0xFFFF
    go_r = torch.where(cat_f, col != tbin, col > tbin)
    cr = torch.cumsum(go_r.to(torch.int64), 0)       # right rows up to i
    cnt_l = c - cr[-1]
    pos = torch.arange(c, dtype=torch.int64, device=store.device)
    dest = torch.where(go_r, cnt_l + cr - 1, pos - cr)
    src = torch.empty_like(dest).scatter_(0, dest, pos)
    seg_b.copy_(seg_b.index_select(0, src))
    seg_d.copy_(seg_d.index_select(0, src))
    seg_r.copy_(seg_r.index_select(0, src))
    return cnt_l


def grow_tree_ordered(bins_rm: torch.Tensor, num_bin: torch.Tensor,
                      is_cat: torch.Tensor, feat_mask: torch.Tensor,
                      grad: torch.Tensor, hess: torch.Tensor,
                      row_weight: torch.Tensor, learning_rate: float,
                      params: GrowParams,
                      histogram: Optional[Callable] = None):
    """Grow one tree leaf-wise on the device of ``bins_rm``.

    ``bins_rm`` [N, F] uint8/uint16 row-major bins (left untouched: the
    grower permutes a copy); ``num_bin`` [F] int32, ``is_cat`` and
    ``feat_mask`` [F] bool; ``grad``/``hess``/``row_weight`` [N] f32.
    ``histogram`` is the digit-histogram function, by default the K1
    wrapper ``leafhist.digit_histogram``; ``leafhist.digit_histogram_plain``
    re-grows the same tree through the plain version.

    Returns (TreeArrays on the host CPU, leaf_id [N] int32 and
    output_delta [N] f32 on the device, in original row order)."""
    histogram = histogram or leafhist.digit_histogram
    L, B = params.num_leaves, params.max_bin
    N, F = bins_rm.shape
    dev = bins_rm.device
    sp = params.split_params()

    g = grad * row_weight
    h = hess * row_weight
    scales = leafhist.compute_scales(g, h, row_weight)
    digits = leafhist.quantize_digits(g, h, row_weight, scales)  # [N, 9]
    root_tot = torch.stack([torch.sum(g), torch.sum(h),
                            torch.sum(row_weight)])

    row_ord = torch.arange(N, dtype=torch.int64, device=dev)
    n_act, inactive = N, None
    if params.compact_inactive:
        # one stable sort a tree puts the sample first; the layout keeps
        # only its rows
        perm = torch.argsort((row_weight <= 0.0).to(torch.uint8),
                             stable=True)
        n_act = int(_read(torch.sum(row_weight > 0.0)))
        row_ord, inactive = perm[:n_act], perm[n_act:]
        store = _storage(bins_rm).index_select(0, row_ord)
        digits = digits.index_select(0, row_ord)
    else:
        store = _storage(bins_rm.clone())
    work_bins = store.view(bins_rm.dtype)

    with device_range("hist"):
        sums_root = histogram(work_bins, digits, B)
    with device_range("find_split"):
        root_split = find_best_split(
            leafhist.combine_digit_sums(sums_root, scales), root_tot[0],
            root_tot[1], root_tot[2], num_bin, is_cat, feat_mask,
            torch.ones((), dtype=torch.bool, device=dev), sp)
    root = _read(torch.cat([root_tot, _split_vector(root_split)]))
    cache = [None] * L
    cache[0] = sums_root

    leaf_f32 = np.zeros((L, 8), np.float32)
    leaf_f32[:, _LF["best_gain"]] = K_MIN_SCORE
    leaf_i32 = np.zeros((L, 8), np.int32)
    leaf_i32[:, _LI["parent"]] = -1
    leaf_f32[0] = [root[3], root[6], root[7], root[8], root[0], root[1],
                   root[2], 0.0]
    leaf_i32[0, _LI["best_feat"]] = int(root[4])
    leaf_i32[0, _LI["best_bin"]] = int(root[5])
    leaf_i32[0, _LI["cnt"]] = n_act
    # the histogram's count is the rows of the layout when each has
    # weight 1; else each split reads its count from the partition
    host_counts = params.compact_inactive or float(root[2]) == N
    n_nodes = max(L - 1, 0)
    node_feat = np.full(n_nodes, -1, np.int32)
    node_bin = np.zeros(n_nodes, np.int32)
    node_gain = np.zeros(n_nodes, np.float32)
    node_left = np.zeros(n_nodes, np.int32)
    node_right = np.zeros(n_nodes, np.int32)
    node_value = np.zeros(n_nodes, np.float32)
    node_count = np.zeros(n_nodes, np.int32)

    counts_dev, counts_host = [], []
    num_leaves = 1
    for node in range(L - 1):
        gains = leaf_f32[:, _LF["best_gain"]]
        best_leaf = int(np.argmax(gains))
        gain = gains[best_leaf]
        if not gain > 0.0:
            break
        right_leaf = num_leaves
        rb_f, rb_i = leaf_f32[best_leaf].copy(), leaf_i32[best_leaf].copy()
        feat, tbin = int(rb_i[_LI["best_feat"]]), int(rb_i[_LI["best_bin"]])
        s, c = int(rb_i[_LI["start"]]), int(rb_i[_LI["cnt"]])
        depth, parent_node = int(rb_i[_LI["depth"]]), int(rb_i[_LI["parent"]])

        with device_range("split"):
            cnt_dev = _partition(store, digits, row_ord, s, c, feat, tbin,
                                 is_cat[feat])
        if host_counts:
            cnt_l = int(rb_f[_LF["best_left_c"]])
            counts_dev.append(cnt_dev)
            counts_host.append(cnt_l)
        else:
            cnt_l = int(_read(cnt_dev))
        small_left = cnt_l <= c - cnt_l
        with device_range("hist"):
            sums_small = histogram(work_bins, digits, B,
                                   s if small_left else s + cnt_l,
                                   min(cnt_l, c - cnt_l))
            sums_large = cache[best_leaf] - sums_small
        sums_left = sums_small if small_left else sums_large
        sums_right = sums_large if small_left else sums_small
        cache[best_leaf], cache[right_leaf] = sums_left, sums_right

        parent_g, parent_h, parent_c = rb_f[4], rb_f[5], rb_f[6]
        left_g, left_h, left_c = rb_f[1], rb_f[2], rb_f[3]
        right_g, right_h, right_c = (parent_g - left_g, parent_h - left_h,
                                     parent_c - left_c)
        left_val, right_val = leaf_output(
            torch.from_numpy(np.array([left_g, right_g])),
            torch.from_numpy(np.array([left_h, right_h])),
            sp.lambda_l1, sp.lambda_l2).numpy()

        if parent_node >= 0:
            if node_left[parent_node] == ~best_leaf:
                node_left[parent_node] = node
            else:
                node_right[parent_node] = node
        node_feat[node], node_bin[node] = feat, tbin
        node_gain[node] = gain
        node_left[node], node_right[node] = ~best_leaf, ~right_leaf
        node_value[node] = rb_f[_LF["cur_value"]]
        node_count[node] = np.int32(parent_c)

        can = params.max_depth <= 0 or depth + 1 < params.max_depth
        totals = _upload(np.array([left_g, right_g, left_h, right_h, left_c,
                                   right_c], np.float32), dev)
        with device_range("find_split"):
            child = find_best_split(
                leafhist.combine_digit_sums(
                    torch.stack([sums_left, sums_right]), scales),
                totals[0:2], totals[2:4], totals[4:6], num_bin, is_cat,
                feat_mask,
                torch.full((2,), can, dtype=torch.bool, device=dev), sp)
            cs = _read(_split_vector(child).reshape(6, 2).T)   # [2, 6]
        for leaf, ci, tot, val, seg_s, seg_c in (
                (best_leaf, 0, (left_g, left_h, left_c), left_val, s, cnt_l),
                (right_leaf, 1, (right_g, right_h, right_c), right_val,
                 s + cnt_l, c - cnt_l)):
            leaf_f32[leaf] = [cs[ci, 0], cs[ci, 3], cs[ci, 4], cs[ci, 5],
                              tot[0], tot[1], tot[2], val]
            leaf_i32[leaf] = [int(cs[ci, 1]), int(cs[ci, 2]), node,
                              depth + 1, seg_s, seg_c, 0, 0]
        num_leaves += 1

    if counts_dev:
        got = _read(torch.stack(counts_dev))
        if not np.array_equal(got, np.asarray(counts_host)):
            raise LightGBMError(
                f"ordered grower: partition counts {got.tolist()} disagree "
                f"with the histogram counts {counts_host} (the w digit "
                f"stream must be an all-ones row weight)")

    shrunk = leaf_f32[:, _LF["cur_value"]] * np.float32(learning_rate)
    tree = TreeArrays(
        num_leaves=torch.tensor(num_leaves, dtype=torch.int32),
        split_feature=torch.from_numpy(node_feat),
        split_bin=torch.from_numpy(node_bin),
        split_gain=torch.from_numpy(node_gain),
        left_child=torch.from_numpy(node_left),
        right_child=torch.from_numpy(node_right),
        internal_value=torch.from_numpy(node_value),
        internal_count=torch.from_numpy(node_count),
        leaf_value=torch.from_numpy(shrunk),
        leaf_count=torch.from_numpy(
            leaf_f32[:, _LF["total_c"]].astype(np.int32)),
        leaf_parent=torch.from_numpy(leaf_i32[:, _LI["parent"]].copy()),
        leaf_depth=torch.from_numpy(leaf_i32[:, _LI["depth"]].copy()),
    )

    # leaf of every position from the contiguous segments, then back to
    # the original row order
    order = np.argsort(leaf_i32[:num_leaves, _LI["start"]], kind="stable")
    seg = _upload(np.stack([order, leaf_i32[order, _LI["cnt"]]]).astype(
        np.int64), dev)
    leaf_of_pos = torch.repeat_interleave(seg[0], seg[1],
                                          output_size=n_act)
    leaf_id = torch.empty(N, dtype=torch.int32, device=dev)
    leaf_id[row_ord] = leaf_of_pos.to(torch.int32)
    shrunk_dev = _upload(shrunk, dev)
    if inactive is not None and inactive.numel() and num_leaves > 1:
        # the rows out of the sample: the grown tree walked over their
        # bins (the reference's out-of-bag AddPredictionToScore)
        sf = _upload(node_feat.astype(np.int64), dev)
        out_bins = _storage(bins_rm).index_select(0, inactive).to(
            torch.int32) & 0xFFFF
        _, leaf_out = predict_binned_tree(
            sf, _upload(node_bin, dev), is_cat[sf.clamp(min=0)],
            _upload(node_left, dev), _upload(node_right, dev), shrunk_dev,
            out_bins.t(), L)
        leaf_id[inactive] = leaf_out.to(torch.int32)
    elif inactive is not None:
        leaf_id[inactive] = 0
    output_delta = shrunk_dev[leaf_id.long()]
    return tree, leaf_id, output_delta


def _split_vector(bs) -> torch.Tensor:
    """A BestSplit as one f32 vector (gain, feature, threshold, left g,
    h, count), so it crosses to the host in one read; feature and
    threshold are small integers, exact in f32."""
    return torch.cat([bs.gain.reshape(-1), bs.feature.reshape(-1).float(),
                      bs.threshold.reshape(-1).float(),
                      bs.left_sum_g.reshape(-1), bs.left_sum_h.reshape(-1),
                      bs.left_count.reshape(-1)])
