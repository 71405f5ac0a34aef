"""The distributed learners' communication strategies, over a
``torch.distributed`` process group.

Port of the JAX package's parallel/comm.py.  The reference's three
parallel tree learners:

  * feature-parallel (feature_parallel_tree_learner.cpp): every rank
    holds all rows; each scans its own block of features, and the only
    exchange is Allreduce(SplitInfo::MaxReducer);
  * data-parallel (data_parallel_tree_learner.cpp): rows are sharded;
    each rank's histograms are reduce-scattered so that every rank owns
    the global histograms of a block of features (142-160), finds the
    best split there, and the candidates are max-reduced (219-242);
  * voting-parallel (PV-tree, voting_parallel_tree_learner.cpp): data-
    parallel with the exchange cut to ``O(2 * top_k * max_bin)``: local
    top-k features, a gather of the votes, an election by per-feature
    maximum (GlobalVoting, 157-186), a reduce of only the elected
    features' histograms, and the exact split against global totals.

Each strategy plugs into ``ops/grow.grow_tree`` through the interface
of ``SerialComm``: ``reduce_sums``, ``prepare``, ``root_split`` and
``children_splits``.  Each rank's histograms are K2
(``ops/histogram.py`` -> ``ops/children_hist.py`` on a card, the plain
scatter on the CPU) over the rank's row shard, or for feature-parallel
over the rank's block of features.  The JAX collectives become:

  * ``psum`` -> ``all_reduce`` (sum);
  * ``psum_scatter`` along features -> ``reduce_scatter_tensor`` of the
    histogram with its feature axis moved first;
  * ``all_gather`` -> ``all_gather_into_tensor``; a ``BestSplit`` is
    packed into one f32 tensor of its six fields (the integer fields are
    feature and bin indices, exact in f32), so one call carries what the
    JAX package sends as six.

The traffic account (:func:`traffic_per_tree` of each strategy) counts
the port's own calls; its bytes equal the JAX package's account kind by
kind, and :func:`stats` counts what the collectives really moved.

**Backends.** ``parallel/multihost.py`` fixes the backend when the
group is built: ``nccl`` when every local rank has a card of its own,
``gloo`` when ranks share a card or run on the CPU.  Under gloo every
collective here takes CUDA tensors as they are:
:data:`GLOO_CUDA_COLLECTIVES` is what ``tools/probe_gloo.py`` found on
the H100's PyTorch 2.11, and ``chip_smoke.py`` fails if the probe finds
another set.
"""

from __future__ import annotations

import threading
import warnings
from typing import Dict, NamedTuple, Tuple

import torch
import torch.distributed as dist

from ..ops.bundle import BundleDecode, expand_histogram
from ..ops.histogram import children_histograms, root_histogram
from ..ops.split import (BestSplit, SplitParams, K_MIN_SCORE,
                         combine_gathered_splits, find_best_split,
                         leaf_split_gain, per_feature_scan)

# recent PyTorch renames the tensor collectives; the old names stay
warnings.filterwarnings("ignore", category=FutureWarning,
                        message=r".*is deprecated\. Please use.*")

#: the collectives of this module, each of which gloo takes with CUDA
#: tensors (``tools/probe_gloo.py`` on the card)
GLOO_CUDA_COLLECTIVES = frozenset({
    "all_reduce", "reduce_scatter_tensor", "all_gather_into_tensor",
    "broadcast"})

_SPLITINFO_FIELDS = 6
_HIST_ITEM = 3 * 4          # <sum_g, sum_h, count> f32 a bin

# ---------------------------------------------------------------------------
# collective accounting

_lock = threading.Lock()
_STATS: Dict[str, object] = {}


def reset_stats() -> None:
    """Zero the counts of :func:`stats`."""
    with _lock:
        _STATS.clear()
        _STATS.update(calls={}, bytes={})


reset_stats()


def stats() -> Dict[str, object]:
    """What the collectives did since :func:`reset_stats`: ``calls`` and
    ``bytes`` by kind (``psum``, ``psum_scatter``, ``all_gather`` for the
    tree's account; ``row_gather`` for the leaf ids and score deltas
    gathered back after a tree)."""
    with _lock:
        return {"calls": dict(_STATS["calls"]),
                "bytes": dict(_STATS["bytes"])}


def _collective(kind: str, fn, nbytes: int) -> None:
    """Run the collective ``fn()`` and count it under ``kind``."""
    fn()
    with _lock:
        _STATS["calls"][kind] = _STATS["calls"].get(kind, 0) + 1
        _STATS["bytes"][kind] = _STATS["bytes"].get(kind, 0) + int(nbytes)


def all_reduce(t: torch.Tensor, group=None, kind: str = "psum"
               ) -> torch.Tensor:
    """Sum ``t`` over the group, in place (JAX ``psum``)."""
    _collective(kind, lambda: dist.all_reduce(t, group=group),
                t.numel() * t.element_size())
    return t


def reduce_scatter(inp: torch.Tensor, group=None) -> torch.Tensor:
    """``inp`` [k * m, ...] summed over the group; this rank's [m, ...]
    block of the first axis (JAX ``psum_scatter(tiled=True)``)."""
    k = dist.get_world_size(group)
    inp = inp.contiguous()
    out = inp.new_empty((inp.shape[0] // k,) + tuple(inp.shape[1:]))
    _collective("psum_scatter",
                lambda: dist.reduce_scatter_tensor(out, inp, group=group),
                inp.numel() * inp.element_size())
    return out


def all_gather(inp: torch.Tensor, group=None, kind: str = "all_gather"
               ) -> torch.Tensor:
    """``[k, *inp.shape]``: every rank's ``inp``, in rank order (JAX
    ``all_gather``; the bytes counted are this rank's contribution)."""
    shape = tuple(inp.shape)
    k = dist.get_world_size(group)
    inp = inp.contiguous().reshape((-1,) + tuple(inp.shape[1:]))
    out = inp.new_empty((k * inp.shape[0],) + tuple(inp.shape[1:]))
    _collective(kind,
                lambda: dist.all_gather_into_tensor(out, inp, group=group),
                inp.numel() * inp.element_size())
    return out.reshape((k,) + shape)


def broadcast(t: torch.Tensor, src: int = 0, group=None,
              kind: str = "broadcast") -> torch.Tensor:
    """``t`` of rank ``src`` on every rank, in place."""
    _collective(kind, lambda: dist.broadcast(t, src=src, group=group),
                t.numel() * t.element_size())
    return t


# ---------------------------------------------------------------------------
# traffic account


def _traffic(**kinds):
    """A ``{kind: {"calls", "bytes"}}`` dict without the empty kinds."""
    return {k: {"calls": int(c), "bytes": int(b)}
            for k, (c, b) in kinds.items() if c}


def traffic_totals(traffic) -> Tuple[int, int]:
    """(calls, bytes) over a ``traffic_per_tree`` dict."""
    if not traffic:
        return 0, 0
    return (sum(v["calls"] for v in traffic.values()),
            sum(v["bytes"] for v in traffic.values()))


def observe_traffic(traffic, trees: int = 1) -> None:
    """Feed ``trees`` trees' account into the registry: one
    ``comm_bytes_<kind>`` histogram sample a tree a kind, and the
    ``comm_bytes`` total (the JAX package's series)."""
    if not traffic or trees <= 0:
        return
    from .. import obs
    from ..obs.registry import DEFAULT_BYTE_BUCKETS
    total = sum(v["bytes"] for v in traffic.values())
    for _ in range(trees):
        for kind, v in traffic.items():
            obs.observe(f"comm_bytes_{kind}", float(v["bytes"]),
                        buckets=DEFAULT_BYTE_BUCKETS)
        obs.observe("comm_bytes", float(total),
                    buckets=DEFAULT_BYTE_BUCKETS)


# ---------------------------------------------------------------------------
# host collectives (between rounds, outside the growers)


def allgather_host_array(x, group=None):
    """Every rank's small host array, stacked ``[P, ...]`` (numpy)."""
    import numpy as np
    a = torch.from_numpy(np.ascontiguousarray(np.asarray(x)))
    if not dist.is_initialized():
        return a.numpy()[None]
    return all_gather(a, group, kind="host").numpy()


def broadcast_host_bytes(payload, is_source: bool, group=None) -> bytes:
    """A byte string of the source rank (rank 0) on every rank: the
    lengths first (a gather, so every rank sizes its buffer), then one
    broadcast of the bytes."""
    import numpy as np
    n = len(payload) if is_source else 0
    size = int(np.max(allgather_host_array(np.int64(n), group)))
    buf = torch.zeros(size, dtype=torch.uint8)
    if is_source:
        buf[:size] = torch.frombuffer(bytearray(payload), dtype=torch.uint8)
    if dist.is_initialized():
        broadcast(buf, 0, group, kind="host")
    return buf.numpy().tobytes()


# ---------------------------------------------------------------------------
# split records over the wire


def _pack_split(split: BestSplit) -> torch.Tensor:
    """A ``BestSplit`` (fields ``[...]``) as one f32 tensor ``[..., 6]``."""
    return torch.stack([split.gain, split.feature.to(torch.float32),
                        split.threshold.to(torch.float32), split.left_sum_g,
                        split.left_sum_h, split.left_count], dim=-1)


def _unpack_split(t: torch.Tensor) -> BestSplit:
    return BestSplit(gain=t[..., 0], feature=t[..., 1].to(torch.int32),
                     threshold=t[..., 2].to(torch.int32),
                     left_sum_g=t[..., 3], left_sum_h=t[..., 4],
                     left_count=t[..., 5])


def _allgather_combine(split: BestSplit, group, k: int) -> BestSplit:
    """Allreduce(SplitInfo::MaxReducer): one gather of the packed
    records, then the tournament."""
    return combine_gathered_splits(
        _unpack_split(all_gather(_pack_split(split), group)), k)


def _offset_features(split: BestSplit, offset: int) -> BestSplit:
    """A shard-local feature index as the global one."""
    return split._replace(feature=torch.where(
        split.feature >= 0, split.feature + offset, split.feature))


def _pad_features(num_bin, is_cat, feat_mask, f_pad: int):
    """Feature metadata padded to ``f_pad`` (a dead feature: one bin,
    masked out)."""
    pad = f_pad - num_bin.shape[0]
    if pad <= 0:
        return num_bin, is_cat, feat_mask
    z = torch.zeros(pad, dtype=num_bin.dtype, device=num_bin.device)
    f = torch.zeros(pad, dtype=torch.bool, device=num_bin.device)
    return (torch.cat([num_bin, z]), torch.cat([is_cat, f]),
            torch.cat([feat_mask, f]))


def _stable_topk(x: torch.Tensor, k: int):
    """``lax.top_k`` along the last axis: descending, an equal value to
    the lower index first."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _true(dev) -> torch.Tensor:
    return torch.ones((), dtype=torch.bool, device=dev)


# ---------------------------------------------------------------------------
# the strategies


class DataParallelComm(NamedTuple):
    """Rows sharded over the group; histograms reduced globally.

    ``hist_reduce``:
      * ``reduce_scatter`` (the reference's): reduce-scatter the
        ``[*, F, B, 3]`` histogram along features, find the best split in
        the owned block, then gather the split records;
      * ``psum``: all-reduce the whole histogram and find the split on
        every rank.
    Under EFB the column histogram is all-reduced and expanded (a column
    block cannot be expanded on its own)."""
    group: object = None
    num_shards: int = 1
    rank: int = 0
    hist_reduce: str = "reduce_scatter"

    def reduce_sums(self, sums):
        # root Allreduce of <sum_g, sum_h, count> (data_parallel:112-139)
        t = all_reduce(torch.stack(list(sums)), self.group)
        return t[0], t[1], t[2]

    def traffic_per_tree(self, num_features: int, max_bin: int,
                         num_leaves: int):
        """The collective account of one tree (its bytes are the JAX
        account's; its calls the port's)."""
        steps = max(num_leaves - 1, 0)
        root = (1, 3 * 4)
        if self.hist_reduce == "psum":
            hist_b = num_features * max_bin * _HIST_ITEM
            return _traffic(psum=(root[0] + 1 + steps,
                                  root[1] + hist_b * (1 + 2 * steps)))
        f_pad = num_features + (-num_features) % self.num_shards
        hist_b = f_pad * max_bin * _HIST_ITEM
        return _traffic(
            psum=root,
            psum_scatter=(1 + steps, hist_b * (1 + 2 * steps)),
            all_gather=(1 + steps,
                        _SPLITINFO_FIELDS * 4 * (1 + 2 * steps)))

    def _split_from_hist(self, hist, totals_g, totals_h, totals_c, can,
                         num_bin, is_cat, feat_mask, sp, bundle=None):
        if bundle is not None or self.hist_reduce == "psum":
            hist = all_reduce(hist, self.group)
            if bundle is not None:
                hist = expand_histogram(hist, bundle)
            return find_best_split(hist, totals_g, totals_h, totals_c,
                                   num_bin, is_cat, feat_mask, can, sp)
        k = self.num_shards
        F = hist.shape[-3]
        f_pad = F + (-F) % k
        f_blk = f_pad // k
        if f_pad > F:
            pad = list(hist.shape)
            pad[-3] = f_pad - F
            hist = torch.cat([hist, hist.new_zeros(pad)], dim=-3)
        nb, ic, fm = _pad_features(num_bin, is_cat, feat_mask, f_pad)
        blk = reduce_scatter(hist.movedim(-3, 0), self.group)
        blk = blk.movedim(0, -3)
        lo = self.rank * f_blk
        local = find_best_split(blk, totals_g, totals_h, totals_c,
                                nb[lo:lo + f_blk], ic[lo:lo + f_blk],
                                fm[lo:lo + f_blk], can, sp)
        return _allgather_combine(_offset_features(local, lo), self.group,
                                  k)

    def prepare(self, bins, bins_rm, g, h, w, params):
        return None

    def root_split(self, prep, bins, g, h, w, root_g, root_h, root_c,
                   num_bin, is_cat, feat_mask, max_bin: int,
                   sp: SplitParams, num_leaves: int, bundle=None):
        hist = root_histogram(bins, g, h, w, max_bin)
        return self._split_from_hist(hist, root_g, root_h, root_c,
                                     _true(bins.device), num_bin, is_cat,
                                     feat_mask, sp, bundle=bundle), None

    def children_splits(self, prep, cache, bins, g, h, w, step,
                        totals_g, totals_h, totals_c, can, num_bin, is_cat,
                        feat_mask, max_bin: int, sp: SplitParams,
                        bundle=None):
        hists = children_histograms(bins, g, h, w, step.leaf_id,
                                    step.parent_leaf, step.right_leaf,
                                    max_bin)
        return self._split_from_hist(hists, totals_g, totals_h, totals_c,
                                     can, num_bin, is_cat, feat_mask, sp,
                                     bundle=bundle), cache


class FeatureParallelComm(NamedTuple):
    """Every rank holds all rows; each scans its block of ``f_block``
    features (a uniform block: the caller pads the features to
    ``num_shards * f_block`` with dead ones), then the split records are
    max-reduced (feature_parallel_tree_learner.cpp:47-69).  Every rank
    applies the winner to its rows alike: no row data moves."""
    group: object = None
    num_shards: int = 1
    rank: int = 0
    f_block: int = 1

    def reduce_sums(self, sums):
        return sums            # every rank holds every row

    def traffic_per_tree(self, num_features: int, max_bin: int,
                         num_leaves: int):
        """Split records only: no histogram byte crosses ranks."""
        steps = max(num_leaves - 1, 0)
        return _traffic(all_gather=(
            1 + steps, _SPLITINFO_FIELDS * 4 * (1 + 2 * steps)))

    def prepare(self, bins, bins_rm, g, h, w, params):
        return None

    def _expand_block(self, hist_blk, bundle: BundleDecode, offset: int):
        """EFB: this rank's column block expanded to every original
        feature; a feature of another rank's column reads a zero column
        and is masked out (``owned``)."""
        fb = self.f_block
        owned = (bundle.col >= offset) & (bundle.col < offset + fb)
        pad = list(hist_blk.shape)
        pad[-3] = 1
        hist_pad = torch.cat([hist_blk, hist_blk.new_zeros(pad)], dim=-3)
        local = bundle._replace(col=torch.where(
            owned, bundle.col - offset, torch.full_like(bundle.col, fb)))
        return expand_histogram(hist_pad, local), owned

    def _local(self, hist_fn, bins, totals, can, num_bin, is_cat,
               feat_mask, sp, bundle):
        lo = self.rank * self.f_block
        hist = hist_fn(bins[lo:lo + self.f_block])
        if bundle is not None:
            hist, owned = self._expand_block(hist, bundle, lo)
            local = find_best_split(hist, *totals, num_bin, is_cat,
                                    feat_mask & owned, can, sp)
        else:
            sl = slice(lo, lo + self.f_block)
            local = _offset_features(find_best_split(
                hist, *totals, num_bin[sl], is_cat[sl], feat_mask[sl], can,
                sp), lo)
        return _allgather_combine(local, self.group, self.num_shards)

    def root_split(self, prep, bins, g, h, w, root_g, root_h, root_c,
                   num_bin, is_cat, feat_mask, max_bin: int,
                   sp: SplitParams, num_leaves: int, bundle=None):
        return self._local(
            lambda b: root_histogram(b, g, h, w, max_bin), bins,
            (root_g, root_h, root_c), _true(bins.device), num_bin, is_cat,
            feat_mask, sp, bundle), None

    def children_splits(self, prep, cache, bins, g, h, w, step,
                        totals_g, totals_h, totals_c, can, num_bin, is_cat,
                        feat_mask, max_bin: int, sp: SplitParams,
                        bundle=None):
        return self._local(
            lambda b: children_histograms(b, g, h, w, step.leaf_id,
                                          step.parent_leaf, step.right_leaf,
                                          max_bin),
            bins, (totals_g, totals_h, totals_c), can, num_bin, is_cat,
            feat_mask, sp, bundle), cache


class VotingParallelComm(NamedTuple):
    """PV-tree: data-parallel with a top-k feature election.

    A leaf: per-feature best gains on the LOCAL histogram with locally
    derived totals and constraints scaled by ``1 / num_shards``
    (voting_parallel_tree_learner.cpp:52-54); the local top-k features by
    unweighted local gain; the votes gathered; the election by the
    per-feature MAX of count-weighted local gains (GlobalVoting, 157-186);
    an all-reduce of only the elected features' histograms; the exact
    split on them against the GLOBAL totals.  The winner is already the
    same on every rank."""
    group: object = None
    num_shards: int = 1
    rank: int = 0
    top_k: int = 20

    def reduce_sums(self, sums):
        t = all_reduce(torch.stack(list(sums)), self.group)
        return t[0], t[1], t[2]

    def traffic_per_tree(self, num_features: int, max_bin: int,
                         num_leaves: int):
        """Per election one gather of the ``[C, K]`` votes (weights and
        feature ids in one tensor) and an all-reduce of the K elected
        features' histograms: ``O(2 * top_k * max_bin)``."""
        steps = max(num_leaves - 1, 0)
        K = min(self.top_k, num_features)
        hist_b = K * max_bin * _HIST_ITEM
        return _traffic(
            psum=(1 + 1 + steps, 3 * 4 + hist_b * (1 + 2 * steps)),
            all_gather=(1 + steps, 2 * K * 4 * (1 + 2 * steps)))

    def _local_sp(self, sp: SplitParams) -> SplitParams:
        # min_data_in_leaf /= num_machines is C++ integer division
        # (voting_parallel_tree_learner.cpp:52-54); the hessian divides
        k = self.num_shards
        return sp._replace(min_data_in_leaf=int(sp.min_data_in_leaf) // k,
                           min_sum_hessian_in_leaf=(
                               sp.min_sum_hessian_in_leaf / k))

    def _elect_and_split(self, hist, totals_g, totals_h, totals_c, can,
                         num_bin, is_cat, feat_mask, sp) -> BestSplit:
        """``hist`` [C, F, B, 3]: the local histograms of C leaves."""
        C, F = hist.shape[0], hist.shape[1]
        K = min(self.top_k, F)
        loc = hist.sum(dim=2)                              # [C, F, 3]
        loc_g = loc[..., 0].amax(dim=1)                    # any feature's
        loc_h = loc[..., 1].amax(dim=1)                    # sums are the
        loc_c = loc[..., 2].amax(dim=1)                    # leaf's
        local_sp = self._local_sp(sp)
        feat_gain = per_feature_scan(hist, loc_g, loc_h, loc_c, num_bin,
                                     is_cat, feat_mask, local_sp)[0]
        # local proposals: the top-k features by the local split gain,
        # unweighted (voting_parallel_tree_learner.cpp:322-326)
        shift = leaf_split_gain(loc_g, loc_h, local_sp.lambda_l1,
                                local_sp.lambda_l2)
        gain_local = torch.where(torch.isfinite(feat_gain),
                                 feat_gain - shift[:, None],
                                 torch.full_like(feat_gain, K_MIN_SCORE))
        top_gain, top_ids = _stable_topk(gain_local, K)     # [C, K]
        # the vote's weight: gain * local leaf count / mean leaf count
        mean_cnt = torch.clamp(totals_c / self.num_shards, min=1.0)
        top_w = torch.where(torch.isfinite(top_gain),
                            top_gain * loc_c[:, None] / mean_cnt[:, None],
                            torch.full_like(top_gain, K_MIN_SCORE))
        votes_all = all_gather(torch.stack(
            [top_w, top_ids.to(torch.float32)], dim=-1), self.group)
        flat_w = votes_all[..., 0].permute(1, 0, 2).reshape(C, -1)
        flat_ids = votes_all[..., 1].permute(1, 0, 2).reshape(C, -1).long()
        # GlobalVoting: the per-feature MAX over ranks, then the top k
        votes = torch.full((C, F), K_MIN_SCORE, dtype=torch.float32,
                           device=hist.device)
        votes.scatter_reduce_(1, flat_ids, flat_w, reduce="amax")
        vote_val, elected = _stable_topk(votes, K)          # [C, K]
        # a feature nobody proposed is not elected (cpp:177-185)
        voted = torch.isfinite(vote_val)
        # ascending feature order: the final tie-break is the serial one
        key = torch.where(voted, elected, torch.full_like(elected, 1 << 30))
        order = torch.argsort(key, dim=-1, stable=True)
        elected = torch.gather(elected, 1, order)
        voted = torch.gather(voted, 1, order)
        hist_el = torch.stack([hist[c].index_select(0, elected[c])
                               for c in range(C)])           # [C, K, B, 3]
        hist_el = all_reduce(hist_el.contiguous(), self.group)
        out = []
        for c in range(C):
            e = elected[c]
            best = find_best_split(
                hist_el[c], totals_g[c], totals_h[c], totals_c[c],
                num_bin[e], is_cat[e], feat_mask[e] & voted[c], can[c], sp)
            real = e[best.feature.clamp(min=0).long()].to(torch.int32)
            out.append(best._replace(feature=torch.where(
                best.feature >= 0, real, best.feature)))
        return BestSplit(*(torch.stack(f) for f in zip(*out)))

    def prepare(self, bins, bins_rm, g, h, w, params):
        return None

    def root_split(self, prep, bins, g, h, w, root_g, root_h, root_c,
                   num_bin, is_cat, feat_mask, max_bin: int,
                   sp: SplitParams, num_leaves: int, bundle=None):
        hist = root_histogram(bins, g, h, w, max_bin)
        if bundle is not None:
            # the election runs in original feature space
            hist = expand_histogram(hist, bundle)
        best = self._elect_and_split(
            hist[None], root_g.reshape(1), root_h.reshape(1),
            root_c.reshape(1), _true(bins.device).reshape(1), num_bin,
            is_cat, feat_mask, sp)
        return BestSplit(*(f[0] for f in best)), None

    def children_splits(self, prep, cache, bins, g, h, w, step,
                        totals_g, totals_h, totals_c, can, num_bin, is_cat,
                        feat_mask, max_bin: int, sp: SplitParams,
                        bundle=None):
        hists = children_histograms(bins, g, h, w, step.leaf_id,
                                    step.parent_leaf, step.right_leaf,
                                    max_bin)
        if bundle is not None:
            hists = expand_histogram(hists, bundle)
        return self._elect_and_split(hists, totals_g, totals_h, totals_c,
                                     can, num_bin, is_cat, feat_mask,
                                     sp), cache
