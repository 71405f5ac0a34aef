"""Forest-walk serving kernel: freeze-time tables and launch wrappers.

Port of the JAX package's ops/pallas_walk.py (K4) with both of its
optional parts: piece-wise linear forests (the affine leaf epilogue) and
bf16 leaf tables.  The kernel itself is ``csrc/forest_walk.cu``, a
direct walk with one thread per row (see the note at the top of that
file); this module builds its node tables at freeze time and wraps its
two C entry points:

- :func:`forest_walk` walks pre-binned rows ``bins`` [F, B] (uint8 or
  uint16 codes, categorical misses already mapped to ``nan_bin``); a
  linear forest also takes the NaN-imputed f32 covariates ``xt`` [F, B];
- :func:`forest_walk_raw` bucketizes raw f32 rows ``X`` [F, B] inside
  the kernel against the cut tables, then walks (a linear forest reads
  its covariates from ``X``, NaN as 0.0).

Both return [num_class, B] f32 raw scores.  On a CUDA tensor a wrapper
launches the kernel or raises; on a CPU tensor it runs the plain version
(:func:`bucketize_plain` + ``ops/predict.py``'s gather walk, the bf16
table dequantized to f32, which is exact), which is also what
``chip_smoke.py`` holds the kernel against on the card.  Each wrapper
counts its kernel launches in :data:`LAUNCHES`, one counter per variant:
``forest_walk[_raw][_linear][_bf16]``.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..utils.log import LightGBMError
from .predict import predict_binned_forest, predict_binned_forest_linear

#: the kernel's variants: binned or raw rows, constant or affine leaves,
#: f32 or bf16 leaf tables
VARIANTS = tuple(f"forest_walk{raw}{lin}{q}" for raw in ("", "_raw")
                 for lin in ("", "_linear") for q in ("", "_bf16"))
#: kernel launches per variant; reset with :func:`reset_launch_counts`
LAUNCHES: Dict[str, int] = {name: 0 for name in VARIANTS}
_count_lock = threading.Lock()

#: dynamic shared memory one block may use on Hopper (bytes)
SMEM_LIMIT = 232448
BLOCK_SIZES = (128, 64, 32)


def reset_launch_counts() -> None:
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def launch_counts() -> Dict[str, int]:
    with _count_lock:
        return dict(LAUNCHES)


def _count(name: str) -> None:
    with _count_lock:
        LAUNCHES[name] += 1


class WalkTables(NamedTuple):
    """A frozen forest in the kernel's layout, on one device.

    ``nodes`` [K*T, M, 4] int32 rows of (split feature << 1 | is_cat,
    threshold bin, left child, right child); ``leaves`` [K*T, L] f32 or
    bfloat16; trees are class-major (tree t of class k is row k*T + t).
    A linear forest adds ``coeff`` [K*T, L, Kf] f32 and ``feat``
    [K*T, L, Kf] int32 (real feature indices, -1 pad; constant trees and
    the ragged tail carry all-pad rows) and ``max_feat``, the largest
    index in ``feat``."""
    nodes: torch.Tensor
    leaves: torch.Tensor
    num_class: int
    trees_per_class: int
    nan_bin: int
    coeff: Optional[torch.Tensor] = None
    feat: Optional[torch.Tensor] = None
    max_feat: int = -1

    @property
    def num_leaves(self) -> int:
        return int(self.leaves.shape[1])

    @property
    def linear(self) -> bool:
        return self.coeff is not None

    @property
    def linear_k(self) -> int:
        return int(self.coeff.shape[2]) if self.linear else 0

    def variant(self, raw: bool) -> str:
        """The :data:`LAUNCHES` key of this forest's kernel variant."""
        return ("forest_walk" + ("_raw" if raw else "")
                + ("_linear" if self.linear else "")
                + ("_bf16" if self.leaves.dtype == torch.bfloat16 else ""))

    def stacks(self):
        """The [K, T, M] / [K, T, L] SoA arrays the plain walk takes:
        (split_feature, split_bin, is_cat, left, right, leaf_value), the
        leaf values in f32 (a bf16 table widens exactly)."""
        K, T = self.num_class, self.trees_per_class
        n = self.nodes.reshape(K, T, -1, 4)
        return (n[..., 0] >> 1, n[..., 1], (n[..., 0] & 1).bool(),
                n[..., 2], n[..., 3],
                self.leaves.float().reshape(K, T, -1))

    def linear_stacks(self):
        """The [K, T, L, Kf] (coeff, feat) stacks of a linear forest."""
        K, T = self.num_class, self.trees_per_class
        return (self.coeff.reshape(K, T, *self.coeff.shape[1:]),
                self.feat.reshape(K, T, *self.feat.shape[1:]))


def bin_index_dtype(nan_bin: int) -> torch.dtype:
    """The narrowest unsigned dtype holding every bin code up to
    ``nan_bin`` (the kernel keeps bins as u16 in shared memory)."""
    if nan_bin <= 255:
        return torch.uint8
    if nan_bin <= 65535:
        return torch.uint16
    raise LightGBMError(
        f"nan_bin={nan_bin} exceeds 65535: the forest walk keeps bins as "
        f"uint16; a forest with that many cut values per feature is not "
        f"supported")


def build_walk_tables(sf, sb, ic, lc, rc, lv, nan_bin: int,
                      device: torch.device, lcf=None, lft=None,
                      leaf_dtype: torch.dtype = torch.float32) -> WalkTables:
    """Stacked [K, T, M] / [K, T, L] numpy SoA forest -> :class:`WalkTables`
    on ``device``.  ``lcf``/``lft`` [K, T, L, Kf] are a linear forest's
    affine stacks; ``leaf_dtype`` float32 or bfloat16 (round to nearest
    even, as ``jnp.bfloat16`` rounds)."""
    sf = np.asarray(sf, np.int64)
    K, T, M = sf.shape
    bin_index_dtype(int(nan_bin))            # refuse what the kernel can't
    if (sf < 0).any() or (sf >= (1 << 30)).any():
        raise LightGBMError("split feature index out of range")
    if leaf_dtype not in (torch.float32, torch.bfloat16):
        raise LightGBMError(
            f"leaf tables are float32 or bfloat16, not {leaf_dtype}")
    nodes = np.stack([(sf << 1) | np.asarray(ic, np.int64),
                      np.asarray(sb, np.int64), np.asarray(lc, np.int64),
                      np.asarray(rc, np.int64)], axis=-1).astype(np.int32)
    leaves = torch.from_numpy(np.asarray(lv, np.float32).reshape(K * T, -1)
                              .copy()).to(leaf_dtype)
    coeff = feat = None
    max_feat = -1
    if lcf is not None:
        lcf = np.asarray(lcf, np.float32)
        lft = np.asarray(lft, np.int64)
        if lcf.shape != lft.shape or lcf.shape[:3] != (K, T, leaves.shape[1]):
            raise LightGBMError(
                f"affine tables {lcf.shape}/{lft.shape} do not match the "
                f"forest's [K={K}, T={T}, L={leaves.shape[1]}, Kf]")
        if (lft < -1).any() or (lft >= (1 << 30)).any():
            raise LightGBMError("affine feature index out of range")
        max_feat = int(lft.max(initial=-1))
        Kf = lcf.shape[3]
        coeff = torch.from_numpy(lcf.reshape(K * T, -1, Kf).copy()).to(device)
        feat = torch.from_numpy(lft.astype(np.int32).reshape(K * T, -1, Kf)
                                .copy()).to(device)
    return WalkTables(
        torch.from_numpy(nodes.reshape(K * T, M, 4)).to(device),
        leaves.to(device), int(K), int(T), int(nan_bin), coeff, feat,
        max_feat)


# ---------------------------------------------------------------------------
# plain versions


def bucketize_plain(bnd: torch.Tensor, cats: torch.Tensor,
                    is_cat_col: torch.Tensor, X: torch.Tensor,
                    nan_bin: int) -> torch.Tensor:
    """[F, B] raw f32 -> [F, B] int64 bins: the count of cuts strictly
    below each value (``searchsorted`` left on the sorted, +inf padded
    rows of ``bnd``); NaN -> ``nan_bin``; categorical values truncate to
    int and map to their index in ``cats``, or ``nan_bin`` on a miss."""
    isnan = torch.isnan(X)
    safe = torch.where(isnan, torch.zeros_like(X), X)
    nbin = torch.searchsorted(bnd, safe, side="left")
    iv = safe.to(torch.int32)
    j = torch.searchsorted(cats, iv, side="left")
    hit = cats.gather(1, j.clamp(max=cats.shape[1] - 1)) == iv
    nan_t = torch.full_like(nbin, int(nan_bin))
    cbin = torch.where(hit & ~isnan, j, nan_t)
    nbin = torch.where(isnan, nan_t, nbin)
    return torch.where(is_cat_col.bool()[:, None], cbin, nbin)


def impute_plain(X: torch.Tensor) -> torch.Tensor:
    """Raw rows -> the affine covariates: NaN read as 0.0."""
    return torch.where(torch.isnan(X), torch.zeros_like(X), X)


def walk_plain(tables: WalkTables, bins: torch.Tensor,
               xt: Optional[torch.Tensor] = None):
    """The plain walk: ([K, B] f32 raw scores, [K, T, B] int64 leaf
    indices) via ``ops/predict.py`` on ``bins`` [F, B]; a linear forest
    adds each leaf's affine part over ``xt`` [F, B]."""
    sf, sb, ic, lc, rc, lv = tables.stacks()
    if tables.linear:
        cf, ft = tables.linear_stacks()
    outs, leaves = [], []
    for k in range(tables.num_class):
        if tables.linear:
            o, leaf = predict_binned_forest_linear(
                sf[k], sb[k], ic[k], lc[k], rc[k], lv[k], cf[k], ft[k],
                bins, xt, tables.num_leaves)
        else:
            o, leaf = predict_binned_forest(sf[k], sb[k], ic[k], lc[k],
                                            rc[k], lv[k], bins,
                                            tables.num_leaves)
        outs.append(o)
        leaves.append(leaf)
    return torch.stack(outs, 0), torch.stack(leaves, 0)


def forest_walk_plain(tables: WalkTables, bins: torch.Tensor,
                      xt: Optional[torch.Tensor] = None) -> torch.Tensor:
    return walk_plain(tables, bins, xt)[0]


def forest_walk_raw_plain(tables: WalkTables, bnd, cats, is_cat_col,
                          X: torch.Tensor) -> torch.Tensor:
    bins = bucketize_plain(bnd, cats, is_cat_col, X, tables.nan_bin)
    xt = impute_plain(X) if tables.linear else None
    return walk_plain(tables, bins, xt)[0]


# ---------------------------------------------------------------------------
# kernel wrappers


def _check(t: torch.Tensor, name: str, dtypes, device: torch.device,
           ndim: int) -> None:
    if not isinstance(t, torch.Tensor):
        raise LightGBMError(f"{name} must be a torch.Tensor")
    if t.device != device:
        raise LightGBMError(
            f"{name} is on {t.device}, the forest tables on {device}")
    if t.dtype not in dtypes:
        raise LightGBMError(
            f"{name} has dtype {t.dtype}; expected one of {dtypes}")
    if t.dim() != ndim:
        raise LightGBMError(f"{name} must be {ndim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise LightGBMError(f"{name} must be contiguous")


def _check_tables(tables: WalkTables, F: int) -> None:
    dev = tables.nodes.device
    _check(tables.nodes, "tables.nodes", (torch.int32,), dev, 3)
    _check(tables.leaves, "tables.leaves", (torch.float32, torch.bfloat16),
           dev, 2)
    if tables.nodes.shape[2] != 4 \
            or tables.nodes.shape[0] != tables.leaves.shape[0] \
            or tables.leaves.shape[0] != (tables.num_class
                                          * tables.trees_per_class):
        raise LightGBMError(
            f"walk tables disagree: nodes {tuple(tables.nodes.shape)}, "
            f"leaves {tuple(tables.leaves.shape)}, "
            f"K={tables.num_class}, T={tables.trees_per_class}")
    if tables.linear:
        _check(tables.coeff, "tables.coeff", (torch.float32,), dev, 3)
        _check(tables.feat, "tables.feat", (torch.int32,), dev, 3)
        if tables.coeff.shape != tables.feat.shape \
                or tables.coeff.shape[:2] != tables.leaves.shape \
                or tables.coeff.shape[2] < 1:
            raise LightGBMError(
                f"affine tables {tuple(tables.coeff.shape)}/"
                f"{tuple(tables.feat.shape)} do not match the leaves "
                f"{tuple(tables.leaves.shape)}")
        if tables.max_feat >= F:
            raise LightGBMError(
                f"an affine leaf reads feature {tables.max_feat}; the rows "
                f"have {F}")


def smem_bytes(tables: WalkTables, F: int, block: int) -> int:
    """Shared memory of one block (``csrc/forest_walk.cu``
    ``smem_bytes``): nodes, the leaf table padded to 16 bytes, and the
    [F][block] u16 bin tile; a linear forest adds one tree's affine
    tables (8 bytes a slot) and the [F][block] f32 covariate tile."""
    M, L = tables.nodes.shape[1], tables.leaves.shape[1]
    leaf_bytes = -(-L * tables.leaves.element_size() // 16) * 16
    b = 16 * M + leaf_bytes + 2 * F * block
    if tables.linear:
        b += 8 * L * tables.linear_k + 4 * F * block
    return b


def block_size(tables: WalkTables, F: int) -> int:
    """The largest of :data:`BLOCK_SIZES` whose shared memory fits a
    block; raises when not even the smallest does."""
    for blk in BLOCK_SIZES:
        if smem_bytes(tables, F, blk) <= SMEM_LIMIT:
            return blk
    raise LightGBMError(
        f"forest walk needs more shared memory than a block has "
        f"({F} features, {tables.num_leaves} leaves, "
        f"{tables.linear_k} affine slots: "
        f"{smem_bytes(tables, F, BLOCK_SIZES[-1])} bytes at "
        f"{BLOCK_SIZES[-1]} rows > {SMEM_LIMIT})")


def _lib():
    from . import _build
    lib = _build.load("forest_walk")
    if lib.lgbt_forest_walk_raw.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.lgbt_forest_walk_binned.argtypes = [
            p, p, i, i, i, i, i, p, i, i, i, p, p, i, p, p, i, p]
        lib.lgbt_forest_walk_binned.restype = i
        lib.lgbt_forest_walk_raw.argtypes = [
            p, p, i, i, i, i, i, p, p, p, p, i, i, i, i, p, p, i, p, i, p]
        lib.lgbt_forest_walk_raw.restype = i
    return lib


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise LightGBMError(f"{what} kernel launch failed: CUDA error {err}")


def _affine_args(tables: WalkTables):
    if not tables.linear:
        return None, None, 0
    return (tables.coeff.data_ptr(), tables.feat.data_ptr(),
            tables.linear_k)


def forest_walk(tables: WalkTables, bins: torch.Tensor,
                xt: Optional[torch.Tensor] = None) -> torch.Tensor:
    """All trees on pre-binned rows ``bins`` [F, B] (uint8/uint16) ->
    [K, B] f32 raw scores.  A linear forest needs ``xt`` [F, B] f32, the
    same rows' covariates with NaN imputed to 0.0."""
    dev = tables.nodes.device
    _check(bins, "bins", (torch.uint8, torch.uint16), dev, 2)
    F, B = bins.shape
    _check_tables(tables, F)
    if tables.linear:
        if xt is None:
            raise LightGBMError("a linear forest's binned walk needs the "
                                "covariates xt [F, B]")
        _check(xt, "xt", (torch.float32,), dev, 2)
        if xt.shape != bins.shape:
            raise LightGBMError(f"xt {tuple(xt.shape)} does not match bins "
                                f"{tuple(bins.shape)}")
    K = tables.num_class
    if dev.type != "cuda":
        return forest_walk_plain(tables, bins, xt)
    out = torch.empty((K, B), dtype=torch.float32, device=dev)
    if B == 0 or tables.trees_per_class == 0:
        return out.zero_()
    lib = _lib()
    coeff, feat, kf = _affine_args(tables)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lgbt_forest_walk_binned(
            tables.nodes.data_ptr(), tables.leaves.data_ptr(),
            tables.leaves.element_size(), K, tables.trees_per_class,
            tables.nodes.shape[1], tables.leaves.shape[1], bins.data_ptr(),
            bins.element_size(), F, B, coeff, feat, kf,
            xt.data_ptr() if tables.linear else None, out.data_ptr(),
            block_size(tables, F), stream)
    name = tables.variant(raw=False)
    _raise_on(err, name)
    _count(name)
    return out


def forest_walk_raw(tables: WalkTables, bnd: torch.Tensor,
                    cats: torch.Tensor, is_cat_col: torch.Tensor,
                    X: torch.Tensor) -> torch.Tensor:
    """Bucketize raw rows ``X`` [F, B] f32 against ``bnd`` [F, C] f32
    (+inf padded), ``cats`` [F, C] int32 (INT32_MAX padded) and
    ``is_cat_col`` [F] uint8, then walk all trees -> [K, B] f32 (a linear
    forest's covariates are ``X`` with NaN as 0.0)."""
    dev = tables.nodes.device
    _check(X, "X", (torch.float32,), dev, 2)
    F, B = X.shape
    _check_tables(tables, F)
    _check(bnd, "bnd", (torch.float32,), dev, 2)
    _check(cats, "cats", (torch.int32,), dev, 2)
    _check(is_cat_col, "is_cat_col", (torch.uint8,), dev, 1)
    C = bnd.shape[1]
    if bnd.shape[0] != F or cats.shape != bnd.shape \
            or is_cat_col.shape[0] != F:
        raise LightGBMError(
            f"cut tables {tuple(bnd.shape)}/{tuple(cats.shape)}/"
            f"{tuple(is_cat_col.shape)} do not match X {tuple(X.shape)}")
    if dev.type != "cuda":
        return forest_walk_raw_plain(tables, bnd, cats, is_cat_col, X)
    K = tables.num_class
    out = torch.empty((K, B), dtype=torch.float32, device=dev)
    if B == 0 or tables.trees_per_class == 0:
        return out.zero_()
    lib = _lib()
    coeff, feat, kf = _affine_args(tables)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lgbt_forest_walk_raw(
            tables.nodes.data_ptr(), tables.leaves.data_ptr(),
            tables.leaves.element_size(), K, tables.trees_per_class,
            tables.nodes.shape[1], tables.leaves.shape[1], X.data_ptr(),
            bnd.data_ptr(), cats.data_ptr(), is_cat_col.data_ptr(), C,
            tables.nan_bin, F, B, coeff, feat, kf, out.data_ptr(),
            block_size(tables, F), stream)
    name = tables.variant(raw=True)
    _raise_on(err, name)
    _count(name)
    return out
