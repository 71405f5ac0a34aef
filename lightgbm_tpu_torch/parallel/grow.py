"""The distributed grower over a ``torch.distributed`` group.

Port of the JAX package's parallel/grow.py (``make_comm``,
``make_parallel_grow``) with the part of parallel/multihost.py's
``globalize_grow_fn`` that the port needs.  Every rank runs this
process's ``ops/grow.grow_tree`` with the strategy of the requested
``tree_learner`` (``data``, ``feature`` or ``voting``; the reference's
TreeLearner factory, tree_learner.cpp) and grows the same tree.

The inputs are replicated: every rank holds the whole ``[F, N]`` bins,
gradients, hessians and row weights, as every JAX process holds its
replicated round state.  For ``data`` and ``voting`` each rank takes its
contiguous slice of the rows padded to a multiple of the world (pad rows
weigh 0); for ``feature`` each rank keeps every row and the features pad
to a multiple of the world with dead ones (``feat_mask`` false).  After
the tree, the row-sharded ``leaf_id`` and score delta are all-gathered
back, so the score update stays local and the same on every rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.grow import GrowParams, grow_tree
from .comm import (DataParallelComm, FeatureParallelComm,
                   VotingParallelComm, all_gather)


def make_comm(mode: str, group, num_shards: int, rank: int,
              num_features: int, top_k: int = 20,
              hist_reduce: str = "reduce_scatter"):
    """The strategy of ``mode`` for rank ``rank`` of ``num_shards``
    (``num_features``: after the feature padding of ``feature`` mode)."""
    if mode == "data":
        return DataParallelComm(group, num_shards, rank, hist_reduce)
    if mode == "feature":
        return FeatureParallelComm(group, num_shards, rank,
                                   -(-num_features // num_shards))
    if mode == "voting":
        return VotingParallelComm(group, num_shards, rank, top_k)
    raise ValueError(f"unknown parallel tree learner mode: {mode!r}")


def _pad_cols(t: torch.Tensor, n: int) -> torch.Tensor:
    """``t`` [..., N] zero-padded (or cut) to ``n`` columns."""
    if t.shape[-1] >= n:
        return t[..., :n]
    pad = t.new_zeros(tuple(t.shape[:-1]) + (n - t.shape[-1],))
    return torch.cat([t, pad], dim=-1)


def make_parallel_grow(group, mode: str, params: GrowParams,
                       top_k: int = 20,
                       hist_reduce: str = "reduce_scatter"):
    """A ``grow(bins, num_bin, is_cat, feat_mask, grad, hess, row_weight,
    learning_rate, bundle=None) -> (TreeArrays, leaf_id, delta)`` over
    ``group`` (``None``: the default group), with unpadded replicated
    inputs and whole-row outputs, as ``ops/grow.grow_tree`` returns them.

    ``grow.traffic_per_tree(num_features, bundled=False)`` is the
    strategy's account of one tree at that (unpadded) feature count;
    ``bundled`` mirrors the EFB path, which all-reduces whole column
    histograms in ``data`` mode."""
    k = dist.get_world_size(group)
    rank = dist.get_rank(group)
    row_sharded = mode in ("data", "voting")
    shard_cache = {}

    def _local_bins(bins: torch.Tensor) -> torch.Tensor:
        """This rank's bins: its padded row slice, or every row with the
        features padded; built once per bins tensor."""
        key = (bins.data_ptr(), tuple(bins.shape))
        hit = shard_cache.get("bins")
        if hit is not None and hit[0] == key:
            return hit[1]
        F, N = bins.shape
        if row_sharded:
            n_loc = -(-N // k)
            lo = rank * n_loc
            out = _pad_cols(bins[:, lo:min(lo + n_loc, N)].contiguous()
                            if lo < N else bins[:, :0], n_loc)
        else:
            pad_f = (-F) % k
            out = bins if not pad_f else torch.cat(
                [bins, bins.new_zeros((pad_f, N))])
        shard_cache["bins"] = (key, out.contiguous())
        return shard_cache["bins"][1]

    def grow(bins, num_bin, is_cat, feat_mask, grad, hess, row_weight,
             learning_rate, bundle=None):
        F, N = bins.shape
        local = _local_bins(bins)
        pad_f = ((-F) % k) if mode == "feature" else 0
        if row_sharded:
            n_loc = local.shape[1]
            lo = rank * n_loc
            grad, hess, row_weight = (_pad_cols(v[lo:], n_loc)
                                      for v in (grad, hess, row_weight))
        elif pad_f and bundle is None:
            # EFB keeps the metadata in original feature space; only the
            # column matrix pads (a zero column owns no feature)
            z = torch.zeros(pad_f, dtype=num_bin.dtype, device=bins.device)
            f = torch.zeros(pad_f, dtype=torch.bool, device=bins.device)
            num_bin = torch.cat([num_bin, z])
            is_cat = torch.cat([is_cat, f])
            feat_mask = torch.cat([feat_mask, f])
        comm = make_comm(mode, group, k, rank, F + pad_f, top_k,
                         "psum" if bundle is not None else hist_reduce)
        tree, leaf_id, delta = grow_tree(local, num_bin, is_cat, feat_mask,
                                         grad, hess, row_weight,
                                         learning_rate, params, comm,
                                         bundle=bundle)
        if row_sharded:
            # leaf ids and deltas back to every rank, in one gather: the
            # delta's f32 bits ride in the int32 tensor
            both = torch.stack([leaf_id, delta.view(torch.int32)])
            rows = all_gather(both, group, kind="row_gather")  # [k, 2, n]
            leaf_id = rows[:, 0].reshape(-1)[:N]
            delta = rows[:, 1].reshape(-1)[:N].view(torch.float32)
        return tree, leaf_id, delta

    def traffic_per_tree(num_features: int, bundled: bool = False):
        pad_f = ((-num_features) % k) if mode == "feature" else 0
        comm = make_comm(mode, group, k, rank, num_features + pad_f, top_k,
                         "psum" if bundled else hist_reduce)
        return comm.traffic_per_tree(num_features + pad_f, params.max_bin,
                                     params.num_leaves)

    grow.traffic_per_tree = traffic_per_tree
    return grow
