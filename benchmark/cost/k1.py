"""Bytes and operations of one histogram pass (K1,
``digit_hist_kernel``) over ``rows`` rows of a leaf: what the inputs
need, not what the kernel does.  Every bin code and the row's gradient
and hessian (two float32) are read once; the [F, B] histogram of
(gradient, hessian, count) sums is written once as float32; each
(row, feature) takes three additions."""

from __future__ import annotations


def launch(rows: int, features: int, bin_bytes: int, max_bin: int):
    nbytes = rows * (features * bin_bytes + 8) + features * max_bin * 3 * 4
    ops = 3 * rows * features
    return nbytes, ops


def tree_windows(tree: dict, num_data: int):
    """Rows of each histogram pass a leaf-wise tree needs: the root, then
    the smaller child of every split (the larger is the parent's
    histogram minus the smaller)."""
    L = int(tree["num_leaves"])
    out = [num_data]
    for i in range(L - 1):
        sizes = []
        for c in (tree["left_child"][i], tree["right_child"][i]):
            c = int(c)
            sizes.append(int(tree["internal_count"][c]) if c >= 0
                         else int(tree["leaf_count"][~c]))
        out.append(min(sizes))
    return out
