"""Freeze a loaded booster into an immutable forest on one device.

Port of the JAX package's serve/forest.py ``CompiledForest``, served by
the forest-walk kernel (``ops/forest_walk.py``, ``csrc/forest_walk.cu``):

- every tree is padded to a common leaf count and stacked into
  ``[num_class, T, L]`` SoA arrays (1-leaf trees and the multiclass
  ragged tail use the absorbing ``left=right=~0`` encoding);
- feature cut tables are the forest's own sorted unique split
  thresholds, so ``value <= t`` is exactly
  ``searchsorted(cuts, value, 'left') <= index(t)``: binning on the host
  in f64 (:meth:`raw_scores`) routes every row as the f64 tree walk
  does; the serving path (:meth:`_device_scores`) bucketizes in f32
  inside the kernel, so a row closer to a threshold than f32 resolution
  may route differently (the standard f32-inference trade);
- piece-wise linear forests (docs/LINEAR_TREES.md) carry per-class
  ``[K, T, L, Kf]`` affine stacks (real feature indices, -1 pad; the
  ragged tail and constant trees all pad), and F widens to the largest
  affine feature.  The covariates are the request rows with NaN read as
  0.0: built on the host for the binned path, read by the kernel from
  ``X`` on the raw path;
- ``serve_quantize_leaves`` stores the leaf table in bf16 when the
  per-class sum over trees of the largest per-leaf bf16 rounding error
  is within :attr:`CompiledForest.QUANTIZE_LEAF_ATOL`; otherwise the
  forest stays f32 with a named ``forest_quantize_fallback`` warning.
  Either way the kernel runs;
- batch shapes are padded up the ``serve/batcher.py`` ladder; the
  output transform (sigmoid / softmax) runs in torch after the kernel
  with the padding masked.

``serve_walk=auto|fused`` runs the kernel.  ``gather`` runs the
per-level walk of ``ops/predict.py`` in plain torch (the JAX package's
XLA gather walk, which is not a Pallas kernel), only when asked for by
name; ``info()`` then reports ``serve_walk=gather``.  ``auto`` is always
``fused``: the kernel reads its tables from device memory, so the JAX
package's VMEM sizing rule (``auto`` falls back to ``gather`` when the
walk's operands outgrow VMEM) has no counterpart on the card.

Device-time attribution: each padded bucket is one unit under the OOM
guard ``predict``, profiled (``devprof``) as the JAX program doing the
same work: ``predict_forest_walk`` binned on the host,
``serve_forest_walk`` binned in the kernel, ``predict_forest`` /
``serve_forest`` under ``serve_walk=gather``.  Each bucket is one
``Predict::forest`` TIMETAG scope; the kernel call is a ``forest_walk``
profiler range; the tables' upload is the ``forest`` transfer account
and a bucket's rows and scores the ``serve`` one (``predict`` when a
``Booster`` predicts through its own forest).

A replica's forest is :meth:`CompiledForest.to_device`: the same frozen
arrays on another device.  The drift hook (``_drift``, a shared
``obs/drift.py`` ``DriftCollector`` or ``None``) gets every predicted
batch's real (unpadded) rows and raw scores on the host, after the
kernel; ``data_fingerprint`` is the booster's training fingerprint.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models.gbdt import _PredictionObjective
from .. import obs
from ..ops import _build
from ..ops.predict import predict_binned_forest, predict_binned_forest_linear
from ..ops.forest_walk import (WalkTables, bin_index_dtype,
                               build_walk_tables, forest_walk,
                               forest_walk_raw)
from ..obs.trace import device_range
from ..utils import log, resource, timetag
from ..utils.log import LightGBMError
from .batcher import BucketLadder, pad_rows

_I32_SENTINEL = np.iinfo(np.int32).max


def _tree_class_lists(models, num_class: int, n_models: int):
    """Class-major model rows -> per-class tree lists."""
    return [[models[i] for i in range(n_models) if i % num_class == k]
            for k in range(num_class)]


def build_cut_tables(trees) -> Tuple[Dict[int, np.ndarray],
                                     Dict[int, np.ndarray]]:
    """Per-feature sorted unique split thresholds across the forest:
    ``(numerical f64, categorical int64)`` keyed by feature index."""
    num: Dict[int, set] = {}
    cat: Dict[int, set] = {}
    for tree in trees:
        for i in range(tree.num_leaves - 1):
            f = int(tree.split_feature[i])
            if int(tree.decision_type[i]) == 1:
                cat.setdefault(f, set()).add(int(np.int64(tree.threshold[i])))
            else:
                num.setdefault(f, set()).add(float(tree.threshold[i]))
    both = set(num) & set(cat)
    if both:
        raise LightGBMError(
            f"features {sorted(both)} carry both numerical and categorical "
            f"splits; cannot build a single cut table per feature")
    return ({f: np.asarray(sorted(v), np.float64) for f, v in num.items()},
            {f: np.asarray(sorted(v), np.int64) for f, v in cat.items()})


def stack_class_trees(trees, num_leaves: int, cuts_num, cuts_cat):
    """One class's trees -> SoA arrays ``[T, L-1]`` / ``[T, L]``;
    ``split_bin`` is each threshold's index in its feature's cut table."""
    T = len(trees)
    L = max(num_leaves, 2)
    M = L - 1
    sf = np.zeros((T, M), np.int32)
    sb = np.zeros((T, M), np.int32)
    ic = np.zeros((T, M), bool)
    lc = np.full((T, M), ~0, np.int32)
    rc = np.full((T, M), ~0, np.int32)
    lv = np.zeros((T, L), np.float32)
    for t, tree in enumerate(trees):
        k = tree.num_leaves - 1
        if k <= 0:
            lv[t, 0] = tree.leaf_value[0] if tree.num_leaves else 0.0
            continue
        sf[t, :k] = tree.split_feature[:k]
        ic[t, :k] = tree.decision_type[:k] == 1
        for i in range(k):
            f = int(tree.split_feature[i])
            if ic[t, i]:
                sb[t, i] = int(np.searchsorted(
                    cuts_cat[f], np.int64(tree.threshold[i])))
            else:
                sb[t, i] = int(np.searchsorted(
                    cuts_num[f], np.float64(tree.threshold[i])))
        lc[t, :k] = tree.left_child[:k]
        rc[t, :k] = tree.right_child[:k]
        lv[t, :tree.num_leaves] = tree.leaf_value[:tree.num_leaves]
    return sf, sb, ic, lc, rc, lv


def stack_class_linear(trees, num_leaves: int, linear_k: int):
    """One class's per-leaf affine tables -> ``[T, L, Kf]`` coeff (f32)
    and feat (int32 real feature indices, -1 pad); constant trees get
    all-pad rows, which add nothing."""
    T = len(trees)
    L = max(num_leaves, 2)
    kf = max(linear_k, 1)
    lcf = np.zeros((T, L, kf), np.float32)
    lft = np.full((T, L, kf), -1, np.int32)
    for t, tree in enumerate(trees):
        if not tree.has_linear():
            continue
        nl, tk = tree.leaf_coeff.shape
        lcf[t, :nl, :tk] = tree.leaf_coeff
        lft[t, :nl, :tk] = tree.leaf_feat
    return lcf, lft


def _zero_tree(num_leaves: int):
    """SoA padding block for one absorbing 0-valued 1-leaf tree."""
    L = max(num_leaves, 2)
    M = L - 1
    return (np.zeros((1, M), np.int32), np.zeros((1, M), np.int32),
            np.zeros((1, M), bool), np.full((1, M), ~0, np.int32),
            np.full((1, M), ~0, np.int32), np.zeros((1, L), np.float32))


def _resolve_walk(serve_walk: Optional[str]) -> str:
    walk = str(serve_walk or "auto")
    if walk not in ("auto", "fused", "gather"):
        raise LightGBMError(
            f"serve_walk must be auto, fused or gather (got {walk!r})")
    return "gather" if walk == "gather" else "fused"


class CompiledForest:
    """Immutable inference artifact: the forest's kernel tables and cut
    tables on one device.  Build with :meth:`from_booster` or
    :meth:`from_arrays`."""

    #: the training fingerprint (obs/drift.py) and the serve-side drift
    #: collector fed after every predict (None: drift off)
    data_fingerprint = None
    _drift = None

    #: bound on the output error of bf16 leaf storage (the JAX
    #: package's ``QUANTIZE_LEAF_ATOL``): ``serve_quantize_leaves`` keeps
    #: bf16 only when the worst-case per-class rounding stays within it
    QUANTIZE_LEAF_ATOL = 1e-3

    def __init__(self):
        raise TypeError("use CompiledForest.from_booster()")

    @classmethod
    def from_booster(cls, booster, device: DeviceLike = None,
                     buckets: Optional[Sequence[int]] = None,
                     serve_walk: Optional[str] = None,
                     num_iteration: int = -1,
                     quantize_leaves: Optional[bool] = None
                     ) -> "CompiledForest":
        """Freeze ``booster`` (a ``Booster`` or a ``models/gbdt.py``
        ``GBDT``).  ``device`` defaults to the booster's (else ``cuda``);
        ``buckets`` overrides the ladder; ``serve_walk`` and
        ``quantize_leaves`` default to the booster's config (bf16 leaf
        storage behind :attr:`QUANTIZE_LEAF_ATOL`)."""
        b = getattr(booster, "_booster", booster)
        cfg = getattr(booster, "config", None)
        if device is None:
            device = getattr(booster, "device", None)
        if serve_walk is None:
            serve_walk = getattr(cfg, "serve_walk", "auto")
        if quantize_leaves is None:
            quantize_leaves = bool(getattr(cfg, "serve_quantize_leaves",
                                           False))
        walk = _resolve_walk(serve_walk)
        models = list(b.models)
        K = max(int(b.num_class), 1)
        n_models = len(models)
        if num_iteration > 0:
            n_models = min(n_models, num_iteration * K)
        models = models[:n_models]
        linear = any(t.has_linear() for t in models)
        linear_k = max([t.leaf_feat.shape[1] for t in models
                        if t.has_linear()] + [1])
        num_leaves = max([t.num_leaves for t in models] + [2])
        cuts_num, cuts_cat = build_cut_tables(models)
        F = int(b.max_feature_idx) + 1
        for f in list(cuts_num) + list(cuts_cat):
            F = max(F, f + 1)
        for t in models:      # affine covariates widen the rows too
            if t.has_linear():
                F = max(F, int(t.leaf_feat.max(initial=-1)) + 1)
        per_class = _tree_class_lists(models, K, n_models)
        T = max([len(ts) for ts in per_class] + [0])
        zero = _zero_tree(num_leaves)
        stacks = []
        for ts in per_class:
            arrs = stack_class_trees(ts, num_leaves, cuts_num, cuts_cat)
            if len(ts) < T:    # ragged tail: pad with absorbing 0-trees
                arrs = tuple(
                    np.concatenate([a, np.repeat(z, T - len(ts), axis=0)],
                                   axis=0)
                    for a, z in zip(arrs, zero))
            stacks.append(arrs)
        stacked = tuple(np.stack([s[i] for s in stacks], axis=0)
                        for i in range(6))
        lin = None
        if linear:
            lin_stacks = []
            for ts in per_class:
                lcf, lft = stack_class_linear(ts, num_leaves, linear_k)
                pad = T - len(ts)
                if pad:       # ragged tail: all-pad epilogue rows
                    lcf = np.concatenate(
                        [lcf, np.zeros((pad,) + lcf.shape[1:], np.float32)])
                    lft = np.concatenate(
                        [lft, np.full((pad,) + lft.shape[1:], -1, np.int32)])
                lin_stacks.append((lcf, lft))
            lin = tuple(np.stack([s[i] for s in lin_stacks], axis=0)
                        for i in range(2))
        sigmoid = float(getattr(b, "sigmoid", -1.0) or -1.0)
        transform = ("softmax" if K > 1
                     else "sigmoid" if sigmoid > 0 else "identity")
        lv = stacked[5]
        # bf16 storage is a property of the kernel's table (the JAX
        # package quantizes only its fused walk)
        leaf_dtype = (cls._quantize_pin(lv.reshape(K * T, lv.shape[2]), K, T)
                      if quantize_leaves and walk == "fused" else "float32")
        self = cls._assemble(stacked, cuts_num, cuts_cat, F, transform,
                             sigmoid, device, buckets, n_models, walk, lin,
                             leaf_dtype)
        self.data_fingerprint = getattr(b, "data_fingerprint", None)
        obs.inc("forest_compile_artifacts")
        obs.set_gauge("forest_trees", int(n_models))
        obs.set_gauge("forest_leaves_padded", int(self.num_leaves))
        return self

    @classmethod
    def from_arrays(cls, sf, sb, ic, lc, rc, lv, cuts_num, cuts_cat,
                    num_features: int, transform: str, sigmoid: float,
                    device: DeviceLike = None,
                    buckets: Optional[Sequence[int]] = None,
                    lin=None, leaf_dtype: str = "float32"
                    ) -> "CompiledForest":
        """Build from another freeze's stacked SoA arrays ([K, T, M] /
        [K, T, L], e.g. the JAX ``CompiledForest._tree_dev`` as numpy)
        and its cut tables (``_cuts_num`` / ``_cuts_cat`` dicts).  A
        linear forest passes ``lin``, its ``(coeff, feat)`` [K, T, L, Kf]
        stacks (the JAX ``_lin_dev``); ``leaf_dtype`` is the JAX forest's
        (``float32`` or ``bfloat16``: the table is stored so, rounded to
        nearest even)."""
        stacked = tuple(np.asarray(a) for a in (sf, sb, ic, lc, rc, lv))
        K, T = stacked[0].shape[:2]
        if leaf_dtype not in ("float32", "bfloat16"):
            raise LightGBMError(f"leaf_dtype must be float32 or bfloat16 "
                                f"(got {leaf_dtype!r})")
        if lin is not None:
            lin = tuple(np.asarray(a) for a in lin)
        return cls._assemble(stacked, dict(cuts_num), dict(cuts_cat),
                             int(num_features), str(transform),
                             float(sigmoid), device, buckets, K * T,
                             "fused", lin, leaf_dtype)

    @classmethod
    def _quantize_pin(cls, lvf: np.ndarray, K: int, T: int) -> str:
        """``bfloat16`` when storing the [K*T, L] f32 leaf table in bf16
        moves no class's output by more than QUANTIZE_LEAF_ATOL: every row
        takes exactly one leaf per tree, so the bound is the per-class sum
        over trees of the largest per-leaf rounding error.  Otherwise
        ``float32``, with a named warning and the
        ``forest_quantize_fallback`` counter."""
        lv_q = torch.from_numpy(lvf).to(torch.bfloat16).float().numpy()
        per_tree = np.abs(lv_q - lvf).max(axis=1)
        bound = float(per_tree.reshape(K, T).sum(axis=1).max()
                      if per_tree.size else 0.0)
        if bound <= cls.QUANTIZE_LEAF_ATOL:
            return "bfloat16"
        log.inc("forest_quantize_fallback")
        log.warning("forest_quantize_fallback: serve_quantize_leaves=true "
                    "but bf16 leaves could move a score by up to %g > "
                    "QUANTIZE_LEAF_ATOL=%g; the leaf table stays float32",
                    bound, cls.QUANTIZE_LEAF_ATOL)
        return "float32"

    @classmethod
    def _assemble(cls, stacked, cuts_num, cuts_cat, F: int, transform: str,
                  sigmoid: float, device: DeviceLike, buckets,
                  num_trees: int, walk: str, lin=None,
                  leaf_dtype: str = "float32") -> "CompiledForest":
        self = object.__new__(cls)
        dev = resolve_device(device)
        self.device = dev
        # the host arrays a replica re-freezes on its own device
        self._frozen = (stacked, cuts_num, cuts_cat, F, transform, sigmoid,
                        num_trees, walk, lin, leaf_dtype)
        sf, sb, ic, lc, rc, lv = stacked
        self.num_class = int(sf.shape[0])
        self.trees_per_class = int(sf.shape[1])
        self.num_leaves = int(lv.shape[2])
        self.num_features = int(F)
        self.num_trees = int(num_trees)
        self.transform = transform
        self.sigmoid = sigmoid
        self.walk_strategy = walk
        self.ladder = BucketLadder(buckets)
        self._cuts_num, self._cuts_cat = cuts_num, cuts_cat
        self.max_cuts = max([len(v) for v in cuts_num.values()]
                            + [len(v) for v in cuts_cat.values()] + [1])
        self._nan_bin = int(self.max_cuts + 1)    # > any threshold index
        self._bin_dtype = bin_index_dtype(self._nan_bin)
        bnd = np.full((F, self.max_cuts), np.inf, np.float32)
        cats = np.full((F, self.max_cuts), _I32_SENTINEL, np.int32)
        is_cat = np.zeros(F, np.uint8)
        for f, v in cuts_num.items():
            bnd[f, :len(v)] = np.asarray(v, np.float64).astype(np.float32)
        for f, v in cuts_cat.items():
            cats[f, :len(v)] = np.clip(v, -2**31, _I32_SENTINEL - 1)
            is_cat[f] = 1
        self._bnd = torch.from_numpy(bnd).to(dev)
        self._cats = torch.from_numpy(cats).to(dev)
        self._is_cat = torch.from_numpy(is_cat).to(dev)
        self.leaf_dtype = leaf_dtype
        self._tables = build_walk_tables(
            sf, sb, ic, lc, rc, lv, self._nan_bin, dev,
            *(lin if lin is not None else (None, None)),
            leaf_dtype=getattr(torch, leaf_dtype))
        self._objective = _PredictionObjective(
            transform, sigmoid if transform == "sigmoid" else -1.0,
            self.num_class)
        self._tree_dev = self._lin_dev = None
        if walk == "gather":
            # the per-level walk's operands: the SoA stacks as they are
            # ([K, T, M] / [K, T, L]; categorical misses stay -1)
            self._tree_dev = tuple(self._to_device(a) for a in stacked)
            if lin is not None:
                self._lin_dev = tuple(self._to_device(a) for a in lin)
        t = self._tables
        up = [self._bnd, self._cats, self._is_cat, t.nodes, t.leaves,
              t.coeff, t.feat, *(self._tree_dev or ()),
              *(self._lin_dev or ())]
        up = [a for a in up if a is not None]
        obs.devprof.transfer("h2d", "forest",
                             sum(int(a.nbytes) for a in up), len(up))
        self._xfer_phase = "serve"
        return self

    def to_device(self, device: DeviceLike) -> "CompiledForest":
        """The same frozen forest on ``device`` (a replica's own copy):
        every table moved there, the fingerprint carried, no drift
        collector (the server attaches one per model)."""
        (stacked, cuts_num, cuts_cat, F, transform, sigmoid, num_trees,
         walk, lin, leaf_dtype) = self._frozen
        clone = self._assemble(stacked, cuts_num, cuts_cat, F, transform,
                               sigmoid, device, self.ladder.sizes, num_trees,
                               walk, lin, leaf_dtype)
        clone.data_fingerprint = self.data_fingerprint
        return clone

    # ------------------------------------------------------------------
    # host-side exact binning (f64 compares; feeds the binned kernel)
    def bin_rows(self, X: np.ndarray) -> np.ndarray:
        """[N, F] raw f64 -> [F, N] int32 cut-table bins (exact); a
        categorical miss is -1."""
        N = X.shape[0]
        bins = np.zeros((self.num_features, N), np.int32)
        for f, cuts in self._cuts_num.items():
            col = X[:, f]
            isnan = np.isnan(col)
            b = np.searchsorted(cuts, np.where(isnan, 0.0, col), side="left")
            bins[f] = np.where(isnan, self._nan_bin, b)
        for f, cats in self._cuts_cat.items():
            col = X[:, f]
            isnan = np.isnan(col)
            iv = np.where(isnan, 0, col).astype(np.int64)
            j = np.searchsorted(cats, iv, side="left")
            jc = np.minimum(j, len(cats) - 1)
            hit = (cats[jc] == iv) & ~isnan
            bins[f] = np.where(hit, jc, -1)
        return bins

    def host_transform(self, raw: np.ndarray) -> np.ndarray:
        """The output transform in host f64."""
        return np.asarray(self._objective.convert_output(np.asarray(raw)))

    def transform_scores(self, raw: torch.Tensor) -> torch.Tensor:
        """The output transform on [K, B] f32 raw scores, in torch on the
        scores' device (what the serving path applies after the kernel)."""
        if self.transform == "softmax":
            e = torch.exp(raw - raw.max(dim=0, keepdim=True).values)
            return e / e.sum(dim=0, keepdim=True)
        if self.transform == "sigmoid":
            return 1.0 / (1.0 + torch.exp(-self.sigmoid * raw))
        return raw

    def _check_width(self, X: np.ndarray) -> np.ndarray:
        if X.ndim != 2:
            X = np.atleast_2d(X)
        if X.shape[1] < self.num_features:
            raise LightGBMError(
                f"input has {X.shape[1]} features; the forest needs "
                f"{self.num_features}")
        return X[:, :self.num_features]

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ------------------------------------------------------------------
    # the kernels' operands (ops/forest_walk.py)
    @property
    def walk_tables(self) -> WalkTables:
        return self._tables

    def cut_tables(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(bnd [F, C] f32, cats [F, C] int32, is_cat_col [F] uint8)``
        on the forest's device: what ``forest_walk_raw`` bins against."""
        return self._bnd, self._cats, self._is_cat

    def device_bins(self, X: np.ndarray) -> torch.Tensor:
        """[N, F] raw rows -> [F, N] ``forest_walk`` operand: host f64
        bins, a categorical miss (-1) mapped to the nan bin, which routes
        the same way (neither ever equals a threshold index)."""
        bins = self.bin_rows(np.asarray(X, np.float64))
        np_dtype = np.uint8 if self._bin_dtype == torch.uint8 else np.uint16
        return self._to_device(
            np.where(bins < 0, self._nan_bin, bins).astype(np_dtype))

    def device_rows(self, X: np.ndarray) -> torch.Tensor:
        """[N, F] raw rows -> [F, N] f32 ``forest_walk_raw`` operand."""
        return self._to_device(np.asarray(X, np.float32).T)

    def device_covariates(self, X: np.ndarray) -> torch.Tensor:
        """[N, F] raw rows -> [F, N] f32 affine covariates of a linear
        forest's binned walk: the same rows, NaN read as 0.0."""
        return self._to_device(
            np.where(np.isnan(X), 0.0, X).T.astype(np.float32))

    def _gather_walk(self, bins: torch.Tensor,
                     xt: Optional[torch.Tensor]) -> torch.Tensor:
        """``serve_walk=gather``: [K, B] raw scores of the per-level
        walk (``ops/predict.py``) over ``bins`` [F, B] int32 (a
        categorical miss -1); ``xt`` [F, B] f32 covariates (NaN as 0.0)
        of a linear forest."""
        sf, sb, ic, lc, rc, lv = self._tree_dev
        steps = self.num_leaves
        if self._lin_dev is not None:
            lcf, lft = self._lin_dev
            outs = [predict_binned_forest_linear(
                sf[k], sb[k], ic[k], lc[k], rc[k], lv[k], lcf[k], lft[k],
                bins, xt, steps)[0] for k in range(self.num_class)]
        else:
            outs = [predict_binned_forest(sf[k], sb[k], ic[k], lc[k],
                                          rc[k], lv[k], bins, steps)[0]
                    for k in range(self.num_class)]
        return torch.stack(outs, dim=0)

    def _device_cut_bins(self, xt: torch.Tensor):
        """[F, B] raw f32 rows -> ([F, B] int32 cut-table bins, the rows
        with NaN read as 0.0), binned in f32 on the device: the JAX
        gather walk's ``bin_lookup``."""
        isnan = torch.isnan(xt)
        safe = torch.where(isnan, 0.0, xt)
        nbin = torch.searchsorted(self._bnd, safe.contiguous(),
                                  side="left").to(torch.int32)
        nbin = torch.where(isnan, self._nan_bin, nbin)
        iv = safe.to(torch.int32)
        j = torch.searchsorted(self._cats, iv.contiguous(),
                               side="left").to(torch.int64)
        jc = j.clamp(max=self._cats.shape[1] - 1)
        hit = self._cats.gather(1, jc) == iv
        cbin = torch.where(hit & ~isnan, jc.to(torch.int32), -1)
        return torch.where(self._is_cat.bool()[:, None], cbin, nbin), safe

    def _uploaded(self, *tensors) -> None:
        """A bucket's rows moved to the card: the transfer account."""
        up = [t for t in tensors if t is not None]
        obs.devprof.transfer("h2d", self._xfer_phase,
                             sum(int(t.nbytes) for t in up), len(up))

    def _dispatch_binned(self, Xp: np.ndarray, mask: np.ndarray):
        """[K, B] raw scores of one padded bucket, binned on the host
        (the K4 predict, under the OOM guard ``predict``)."""
        with resource.oom_guard(
                "predict", lambda: resource.render_shapes(Xp, mask),
                self.device, profile=("predict_forest"
                                      if self.walk_strategy == "gather"
                                      else "predict_forest_walk"),
                bucket=len(mask)):
            return self._walk_binned(Xp, mask)

    def _walk_binned(self, Xp: np.ndarray, mask: np.ndarray):
        xt = self.device_covariates(Xp) if self._tables.linear else None
        if self.walk_strategy == "gather":
            bins = self._to_device(self.bin_rows(np.asarray(Xp, np.float64)))
            raw = self._gather_walk(bins, xt)
        else:
            bins = self.device_bins(Xp)
            with device_range("forest_walk"):
                raw = forest_walk(self._tables, bins, xt)
        m = self._to_device(mask)
        self._uploaded(bins, xt, m)
        return torch.where(m[None, :], raw, 0.0)

    def _dispatch_raw(self, Xp: np.ndarray, mask: np.ndarray):
        """(raw, transformed) [K, B] of one padded f32 bucket, binned
        inside the kernel (gather: binned in f32 by torch ops); the K4
        predict of every fleet replica, under the OOM guard
        ``predict``."""
        with resource.oom_guard(
                "predict", lambda: resource.render_shapes(Xp, mask),
                self.device, profile=("serve_forest"
                                      if self.walk_strategy == "gather"
                                      else "serve_forest_walk"),
                bucket=len(mask)):
            return self._walk_raw(Xp, mask)

    def _walk_raw(self, Xp: np.ndarray, mask: np.ndarray):
        xr = self.device_rows(Xp)
        if self.walk_strategy == "gather":
            bins, safe = self._device_cut_bins(xr)
            raw = self._gather_walk(bins, safe)
        else:
            with device_range("forest_walk"):
                raw = forest_walk_raw(self._tables, self._bnd, self._cats,
                                      self._is_cat, xr)
        m = self._to_device(mask)
        self._uploaded(xr, m)
        m = m[None, :]
        raw = torch.where(m, raw, 0.0)
        out = torch.where(m, self.transform_scores(raw), 0.0)
        return raw, out

    def raw_scores(self, X) -> np.ndarray:
        """[K, N] f64 raw scores: host f64 binning, then the binned
        kernel, bucket by bucket."""
        X = self._check_width(np.asarray(X, np.float64))
        N = X.shape[0]
        if N == 0 or self.num_trees == 0:
            return np.zeros((self.num_class, N), np.float64)
        parts = []
        for off, n, bucket in self.ladder.chunks(N):
            Xp, mask = pad_rows(X[off:off + n], bucket)
            with timetag.scope("Predict::forest"):
                raw = self._dispatch_binned(Xp, mask)
            host = raw[:, :n].cpu().numpy()
            obs.devprof.transfer("d2h", self._xfer_phase, int(host.nbytes))
            parts.append(host.astype(np.float64))
        raw_all = np.concatenate(parts, axis=1)
        col = self._drift
        if col is not None:
            col.offer(X, raw_all)
        return raw_all

    def _device_scores(self, X) -> Tuple[np.ndarray, np.ndarray]:
        """(raw, transformed) [K, N] f32 through the raw kernel (the
        serving hot path; f32 binning inside the kernel)."""
        X = self._check_width(np.asarray(X, np.float32))
        N = X.shape[0]
        if N == 0 or self.num_trees == 0:
            z = np.zeros((self.num_class, N), np.float32)
            return z, self.host_transform(z.astype(np.float64))
        raws, outs = [], []
        for off, n, bucket in self.ladder.chunks(N):
            Xp, mask = pad_rows(X[off:off + n], bucket)
            with timetag.scope("Predict::forest"):
                raw, out = self._dispatch_raw(Xp, mask)
            raws.append(raw[:, :n].cpu().numpy())
            outs.append(out[:, :n].cpu().numpy())
            obs.devprof.transfer(
                "d2h", self._xfer_phase,
                int(raws[-1].nbytes) + int(outs[-1].nbytes), 2)
        raw_all = np.concatenate(raws, axis=1)
        # drift hook: the real rows and raw scores, on the host after
        # the kernel; drift=off is this one attribute read
        col = self._drift
        if col is not None:
            col.offer(X, raw_all)
        return raw_all, np.concatenate(outs, axis=1)

    def predict(self, X, raw_score: bool = False,
                device_binning: bool = False) -> np.ndarray:
        """Shaped like ``Booster.predict``: ``[N]`` for one class,
        ``[N, K]`` for multiclass.  ``device_binning`` takes the serving
        path (f32 binning in the kernel, f32 transform); the default bins
        on the host in f64 and transforms in f64."""
        if device_binning:
            raw, out = self._device_scores(X)
            res = raw if raw_score else out
        else:
            raw = self.raw_scores(X)
            res = raw if raw_score else self.host_transform(raw)
        res = np.asarray(res)
        return res[0] if res.shape[0] == 1 else res.T

    def batched_fn(self):
        """``rows -> (raw, transformed)`` [K, n] callable for the
        micro-batcher (the serving path)."""
        return self._device_scores

    def warmup(self, buckets: Optional[Sequence[int]] = None,
               max_bucket: Optional[int] = None) -> "CompiledForest":
        """Build the walk kernel's library (on a card) and run both paths once
        per ladder bucket (``buckets``, default the ladder) up to the one
        ``max_bucket`` rows dispatch to, so the first request pays
        neither the build nor a first launch."""
        if self.device.type == "cuda" and self.walk_strategy == "fused":
            _build.build_all(("forest_walk",))
        sizes = list(buckets) if buckets else list(self.ladder.sizes)
        if max_bucket:
            cap = self.ladder.bucket_for(int(max_bucket))
            sizes = [s for s in sizes if s <= cap] or sizes[:1]
        for s in sizes:
            dummy = np.zeros((min(s, 2), self.num_features))
            Xp, mask = pad_rows(dummy, s)
            self._dispatch_binned(Xp, mask)
            self._dispatch_raw(Xp.astype(np.float32), mask)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        obs.inc("forest_warmups")
        return self

    def info(self) -> Dict[str, object]:
        return {
            "num_trees": int(self.num_trees),
            "num_class": int(self.num_class),
            "num_features": int(self.num_features),
            "num_leaves_padded": int(self.num_leaves),
            "transform": self.transform,
            "buckets": list(self.ladder.sizes),
            "max_cuts": int(self.max_cuts),
            "linear": bool(self._tables.linear),
            "fingerprint": self.data_fingerprint is not None,
            "drift": self._drift is not None,
            "linear_k": self._tables.linear_k,
            "serve_walk": self.walk_strategy,
            "leaf_dtype": self.leaf_dtype,
            "bin_dtype": str(self._bin_dtype).replace("torch.", ""),
            "device": str(self.device),
        }
