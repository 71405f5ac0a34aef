"""Tree-growth parameters and the flat tree record, shared by the growers.

Port of the parts of the JAX package's ops/grow.py that the leaf-ordered
grower needs: ``GrowParams``, ``TreeArrays`` and the two-vector packing
(``pack_tree_arrays`` / ``unpack_tree_arrays``).  The cached grower
``grow_tree`` is a later slice (its ``nocache`` and ``fused`` strategies
need the kernels K2/K3).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .split import SplitParams


class GrowParams(NamedTuple):
    """Tree-growth configuration.  The JAX version's
    ``compact_inactive`` (bagging/GOSS row compaction) is not ported:
    row sampling raises in ``Config.check_trainable``."""
    num_leaves: int = 31
    max_bin: int = 255
    min_data_in_leaf: int = 100
    min_sum_hessian_in_leaf: float = 10.0
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_gain_to_split: float = 0.0
    max_depth: int = -1

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
