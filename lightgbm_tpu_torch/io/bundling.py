"""Exclusive feature bundling (EFB): the host-side planner.

Port of the JAX package's io/bundling.py.  Wide-sparse tables (CTR-style
one-hot blocks) pay a histogram pass for every feature although most
features are zero on most rows.  EFB packs mutually exclusive sparse
features (rarely non-default on the same row) into shared columns whose
bin space is split into one sub-range per member (offset encoding).  The
bin matrix shrinks from ``[F, N]`` to ``[C, N]``; histograms are built
per column and expanded back to the original features before the split
scan (``ops/bundle.py``), so trees, the model text and prediction stay
in original feature space.

The planner (:func:`plan_bundles`) is a greedy colouring over the row
sample FindBin saw: candidates are non-trivial numerical features whose
default bin is 0 with ``sparse_rate >= MIN_BUNDLE_SPARSE_RATE``,
sparsest first; a feature joins the first bundle whose conflicts (rows
where the bundle and the feature are both non-default) stay within
``max_conflict_rate * sample_rows`` and whose bins stay within
``max_bin``.  On a conflicting row the last member in column order
keeps its value; ``max_conflict_rate=0`` admits only exclusive
features, which is what makes a bundled run equal an unbundled one.
The JAX package's multihost switch-off has no counterpart: the port
loads on one process.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np

from .. import obs
from ..utils import log
from .binning import NUMERICAL

# Candidates must be at least this sparse (BinMapper.sparse_rate = share
# of rows in the default bin).
MIN_BUNDLE_SPARSE_RATE = 0.8


class BundlePlan:
    """Which used features share which column.

    ``column_members[c]`` lists the inner (used) feature indices stored
    in column ``c``; ``column_offsets[c]`` gives each member's offset,
    the column slot of its local bin 1, with offset 0 marking an
    identity-encoded singleton (its column holds its own bin codes)."""

    def __init__(self, column_members: List[List[int]],
                 column_offsets: List[List[int]], num_features: int,
                 sample_conflicts: int = 0):
        self.column_members = [list(m) for m in column_members]
        self.column_offsets = [list(o) for o in column_offsets]
        self.num_features = int(num_features)
        self.sample_conflicts = int(sample_conflicts)

    @property
    def num_columns(self) -> int:
        return len(self.column_members)

    @property
    def bundles(self) -> List[List[int]]:
        """The columns of more than one member."""
        return [m for m in self.column_members if len(m) > 1]

    @property
    def features_bundled(self) -> int:
        return sum(len(m) for m in self.bundles)

    def signature(self) -> tuple:
        """Equality key of two layouts (a valid set must share its
        training set's)."""
        return (tuple(tuple(m) for m in self.column_members),
                tuple(tuple(o) for o in self.column_offsets))

    def encode_columns(self, feature_bins: Callable[[int], np.ndarray],
                       n: int, dtype) -> np.ndarray:
        """[C, n] column bin codes from ``feature_bins(inner)``, a used
        feature's own bin codes for the n rows.  A member writes its
        non-default bins at ``offset + bin - 1``; on a conflicting row the
        last member in column order wins."""
        out = np.zeros((self.num_columns, n), dtype)
        for c, (members, offsets) in enumerate(
                zip(self.column_members, self.column_offsets)):
            if len(members) == 1 and offsets[0] == 0:
                out[c] = feature_bins(members[0]).astype(dtype)
                continue
            col = np.zeros(n, np.int64)
            for f, off in zip(members, offsets):
                vb = np.asarray(feature_bins(f), np.int64)
                nz = vb > 0          # candidates have default_bin == 0
                col[nz] = off + vb[nz] - 1
            out[c] = col.astype(dtype)
        return out

    def decode_arrays(self, num_bins: Sequence[int],
                      default_bins: Sequence[int], max_bin: int) -> dict:
        """The numpy tables of ``ops.bundle.BundleDecode``.
        ``num_bins``/``default_bins`` are per used feature; the slot map
        sends each feature's default bin (and any bin past its range) to
        the zero slot ``max_bin``, so the default bin's reconstruction
        ``total - sum(non-default)`` counts nothing twice."""
        F, B = self.num_features, int(max_bin)
        col = np.zeros(F, np.int32)
        off = np.zeros(F, np.int32)
        width = np.zeros(F, np.int32)
        slot_map = np.full((F, B), B, np.int32)
        default = np.zeros(F, np.int32)
        for c, (members, offsets) in enumerate(
                zip(self.column_members, self.column_offsets)):
            for f, o in zip(members, offsets):
                nb = int(num_bins[f])
                col[f] = c
                off[f] = o
                width[f] = max(nb - 1, 0)
                default[f] = int(default_bins[f])
                if o == 0:
                    b = np.arange(min(nb, B))
                    slot_map[f, b] = b
                else:
                    b = np.arange(1, min(nb, B + 1))
                    slot_map[f, b] = o + b - 1
                if 0 <= default[f] < B:
                    slot_map[f, default[f]] = B
        return {"col": col, "off": off, "width": width,
                "slot_map": slot_map, "default_bin": default}

    def to_state(self) -> dict:
        return {"column_members": self.column_members,
                "column_offsets": self.column_offsets,
                "num_features": self.num_features,
                "sample_conflicts": self.sample_conflicts}

    @classmethod
    def from_state(cls, state: Optional[dict]) -> Optional["BundlePlan"]:
        if not state:
            return None
        return cls([list(map(int, m)) for m in state["column_members"]],
                   [list(map(int, o)) for o in state["column_offsets"]],
                   int(state["num_features"]),
                   int(state.get("sample_conflicts", 0)))

    @classmethod
    def identity(cls, num_features: int) -> "BundlePlan":
        """Every feature in a column of its own (the decode tables of an
        unbundled dataset's compacted screening view)."""
        return cls([[f] for f in range(num_features)],
                   [[0]] * num_features, num_features)


def _is_candidate(mapper) -> bool:
    return (not mapper.is_trivial
            and mapper.bin_type == NUMERICAL
            and mapper.default_bin == 0
            and mapper.num_bin > 1
            and mapper.sparse_rate >= MIN_BUNDLE_SPARSE_RATE)


def plan_bundles(sample: np.ndarray, mappers, used_feature_map, *,
                 max_conflict_rate: float, max_total_bin: int,
                 enable_bundle: bool = True,
                 is_enable_sparse: bool = True) -> Optional[BundlePlan]:
    """Greedy conflict-bounded bundling over the mapper sample.

    ``sample`` [S, F_real] the raw rows FindBin saw, ``mappers`` per used
    feature, ``used_feature_map`` used -> real column of ``sample``,
    ``max_conflict_rate`` the share of conflicting rows a bundle may
    hold, ``max_total_bin`` a bundled column's bin budget (``max_bin``).
    Returns a plan when at least one bundle of two or more formed, else
    None (the plain per-feature layout)."""
    if not enable_bundle or not is_enable_sparse or len(mappers) == 0:
        return None
    with obs.span("Bin::bundle"):
        plan = _plan_bundles_impl(sample, mappers, used_feature_map,
                                  max_conflict_rate, max_total_bin)
    if plan is not None:
        n_sparse = sum(1 for m in mappers if _is_candidate(m))
        log.info("EFB: %d sparse feature(s), %d bundled into %d bundle(s) "
                 "(%d -> %d columns, %d conflicting sample rows)",
                 n_sparse, plan.features_bundled, len(plan.bundles),
                 plan.num_features, plan.num_columns,
                 plan.sample_conflicts)
    return plan


def _plan_bundles_impl(sample, mappers, used_feature_map,
                       max_conflict_rate, max_total_bin):
    F = len(mappers)
    S = sample.shape[0]
    cand = [f for f in range(F) if _is_candidate(mappers[f])]
    if len(cand) < 2:
        return None
    # sparsest first: the emptiest features pack tightest and burn the
    # least conflict budget
    cand.sort(key=lambda f: (-mappers[f].sparse_rate, f))
    nondefault = {f: np.asarray(mappers[f].value_to_bin(
        sample[:, used_feature_map[f]])) != 0 for f in cand}
    budget = int(float(max_conflict_rate) * S)

    bundles: List[List[int]] = []       # member lists
    occupied: List[np.ndarray] = []     # a member non-default on the row
    conflicts: List[int] = []           # cumulative conflicts a bundle
    bins_used: List[int] = []           # 1 + sum(num_bin - 1)
    for f in cand:
        nd = nondefault[f]
        nb = int(mappers[f].num_bin)
        for bi in range(len(bundles)):
            if bins_used[bi] + (nb - 1) > max_total_bin:
                continue
            c = int(np.count_nonzero(occupied[bi] & nd))
            if conflicts[bi] + c > budget:
                continue
            bundles[bi].append(f)
            occupied[bi] |= nd
            conflicts[bi] += c
            bins_used[bi] += nb - 1
            break
        else:
            bundles.append([f])
            occupied.append(nd.copy())
            conflicts.append(0)
            bins_used.append(nb)
    keep = {}
    total_conflicts = 0
    for bi, members in enumerate(bundles):
        if len(members) > 1:
            for f in members:
                keep[f] = bi
            total_conflicts += conflicts[bi]
    if not keep:
        return None

    # column order: used features ascending; a bundle's column sits at
    # its first member's position, members ascending (the order that
    # decides a conflicting row)
    emitted = set()
    column_members: List[List[int]] = []
    column_offsets: List[List[int]] = []
    for f in range(F):
        if f in emitted:
            continue
        bi = keep.get(f)
        if bi is None:
            column_members.append([f])
            column_offsets.append([0])
            emitted.add(f)
            continue
        members = sorted(bundles[bi])
        offs = []
        o = 1
        for m in members:
            offs.append(o)
            o += int(mappers[m].num_bin) - 1
        column_members.append(members)
        column_offsets.append(offs)
        emitted.update(members)
    return BundlePlan(column_members, column_offsets, F,
                      sample_conflicts=total_conflicts)
