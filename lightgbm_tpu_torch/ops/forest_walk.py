"""Forest-walk serving kernel: freeze-time tables and launch wrappers.

Port of the JAX package's ops/pallas_walk.py (K4) for constant-leaf
forests.  The kernel itself is ``csrc/forest_walk.cu``, a direct walk
with one thread per row (see the note at the top of that file); this
module builds its node tables at freeze time and wraps its two C entry
points:

- :func:`forest_walk` walks pre-binned rows ``bins`` [F, B] (uint8 or
  uint16 codes, categorical misses already mapped to ``nan_bin``);
- :func:`forest_walk_raw` bucketizes raw f32 rows ``X`` [F, B] inside
  the kernel against the cut tables, then walks.

Both return [num_class, B] f32 raw scores.  On a CUDA tensor a wrapper
launches the kernel or raises; on a CPU tensor it runs the plain version
(:func:`bucketize_plain` + ``ops/predict.py``'s gather walk), which is
also what ``chip_smoke.py`` holds the kernel against on the card.  Each
wrapper counts its kernel launches in :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, NamedTuple

import numpy as np
import torch

from ..utils.log import LightGBMError
from .predict import predict_binned_forest

#: kernel launches per wrapper; reset with :func:`reset_launch_counts`
LAUNCHES: Dict[str, int] = {"forest_walk": 0, "forest_walk_raw": 0}
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
    threshold bin, left child, right child); ``leaves`` [K*T, L] f32;
    trees are class-major (tree t of class k is row k*T + t)."""
    nodes: torch.Tensor
    leaves: torch.Tensor
    num_class: int
    trees_per_class: int
    nan_bin: int

    @property
    def num_leaves(self) -> int:
        return int(self.leaves.shape[1])

    def stacks(self):
        """The [K, T, M] / [K, T, L] SoA arrays the plain walk takes:
        (split_feature, split_bin, is_cat, left, right, leaf_value)."""
        K, T = self.num_class, self.trees_per_class
        n = self.nodes.reshape(K, T, -1, 4)
        return (n[..., 0] >> 1, n[..., 1], (n[..., 0] & 1).bool(),
                n[..., 2], n[..., 3], self.leaves.reshape(K, T, -1))


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
                      device: torch.device) -> WalkTables:
    """Stacked [K, T, M] / [K, T, L] numpy SoA forest -> :class:`WalkTables`
    on ``device``."""
    sf = np.asarray(sf, np.int64)
    K, T, M = sf.shape
    bin_index_dtype(int(nan_bin))            # refuse what the kernel can't
    if (sf < 0).any() or (sf >= (1 << 30)).any():
        raise LightGBMError("split feature index out of range")
    nodes = np.stack([(sf << 1) | np.asarray(ic, np.int64),
                      np.asarray(sb, np.int64), np.asarray(lc, np.int64),
                      np.asarray(rc, np.int64)], axis=-1).astype(np.int32)
    leaves = np.asarray(lv, np.float32)
    return WalkTables(
        torch.from_numpy(nodes.reshape(K * T, M, 4)).to(device),
        torch.from_numpy(leaves.reshape(K * T, -1).copy()).to(device),
        int(K), int(T), int(nan_bin))


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


def walk_plain(tables: WalkTables, bins: torch.Tensor):
    """The plain walk: ([K, B] f32 raw scores, [K, T, B] int64 leaf
    indices) via ``ops/predict.py`` on ``bins`` [F, B]."""
    sf, sb, ic, lc, rc, lv = tables.stacks()
    outs, leaves = [], []
    for k in range(tables.num_class):
        o, leaf = predict_binned_forest(sf[k], sb[k], ic[k], lc[k], rc[k],
                                        lv[k], bins, tables.num_leaves)
        outs.append(o)
        leaves.append(leaf)
    return torch.stack(outs, 0), torch.stack(leaves, 0)


def forest_walk_plain(tables: WalkTables, bins: torch.Tensor) -> torch.Tensor:
    return walk_plain(tables, bins)[0]


def forest_walk_raw_plain(tables: WalkTables, bnd, cats, is_cat_col,
                          X: torch.Tensor) -> torch.Tensor:
    bins = bucketize_plain(bnd, cats, is_cat_col, X, tables.nan_bin)
    return walk_plain(tables, bins)[0]


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


def _check_tables(tables: WalkTables) -> torch.device:
    dev = tables.nodes.device
    _check(tables.nodes, "tables.nodes", (torch.int32,), dev, 3)
    _check(tables.leaves, "tables.leaves", (torch.float32,), dev, 2)
    if tables.nodes.shape[2] != 4 \
            or tables.nodes.shape[0] != tables.leaves.shape[0] \
            or tables.leaves.shape[0] != (tables.num_class
                                          * tables.trees_per_class):
        raise LightGBMError(
            f"walk tables disagree: nodes {tuple(tables.nodes.shape)}, "
            f"leaves {tuple(tables.leaves.shape)}, "
            f"K={tables.num_class}, T={tables.trees_per_class}")
    return dev


def _block_size(tables: WalkTables, F: int) -> int:
    M, L = tables.nodes.shape[1], tables.leaves.shape[1]
    for blk in BLOCK_SIZES:
        if 16 * M + 4 * L + 2 * F * blk <= SMEM_LIMIT:
            return blk
    raise LightGBMError(
        f"forest walk needs more shared memory than a block has "
        f"({F} features, {L} leaves)")


def _lib():
    from . import _build
    lib = _build.load("forest_walk")
    if lib.lgbt_forest_walk_raw.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.lgbt_forest_walk_binned.argtypes = [
            p, p, i, i, i, i, p, i, i, i, p, i, p]
        lib.lgbt_forest_walk_binned.restype = i
        lib.lgbt_forest_walk_raw.argtypes = [
            p, p, i, i, i, i, p, p, p, p, i, i, i, i, p, i, p]
        lib.lgbt_forest_walk_raw.restype = i
    return lib


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise LightGBMError(f"{what} kernel launch failed: CUDA error {err}")


def forest_walk(tables: WalkTables, bins: torch.Tensor) -> torch.Tensor:
    """All trees on pre-binned rows ``bins`` [F, B] (uint8/uint16) ->
    [K, B] f32 raw scores."""
    dev = _check_tables(tables)
    _check(bins, "bins", (torch.uint8, torch.uint16), dev, 2)
    K = tables.num_class
    F, B = bins.shape
    if dev.type != "cuda":
        return forest_walk_plain(tables, bins)
    out = torch.empty((K, B), dtype=torch.float32, device=dev)
    if B == 0 or tables.trees_per_class == 0:
        return out.zero_()
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lgbt_forest_walk_binned(
            tables.nodes.data_ptr(), tables.leaves.data_ptr(), K,
            tables.trees_per_class, tables.nodes.shape[1],
            tables.leaves.shape[1], bins.data_ptr(), bins.element_size(),
            F, B, out.data_ptr(), _block_size(tables, F), stream)
    _raise_on(err, "forest_walk")
    _count("forest_walk")
    return out


def forest_walk_raw(tables: WalkTables, bnd: torch.Tensor,
                    cats: torch.Tensor, is_cat_col: torch.Tensor,
                    X: torch.Tensor) -> torch.Tensor:
    """Bucketize raw rows ``X`` [F, B] f32 against ``bnd`` [F, C] f32
    (+inf padded), ``cats`` [F, C] int32 (INT32_MAX padded) and
    ``is_cat_col`` [F] uint8, then walk all trees -> [K, B] f32."""
    dev = _check_tables(tables)
    _check(X, "X", (torch.float32,), dev, 2)
    _check(bnd, "bnd", (torch.float32,), dev, 2)
    _check(cats, "cats", (torch.int32,), dev, 2)
    _check(is_cat_col, "is_cat_col", (torch.uint8,), dev, 1)
    F, B = X.shape
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
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lgbt_forest_walk_raw(
            tables.nodes.data_ptr(), tables.leaves.data_ptr(), K,
            tables.trees_per_class, tables.nodes.shape[1],
            tables.leaves.shape[1], X.data_ptr(), bnd.data_ptr(),
            cats.data_ptr(), is_cat_col.data_ptr(), C, tables.nan_bin, F, B,
            out.data_ptr(), _block_size(tables, F), stream)
    _raise_on(err, "forest_walk_raw")
    _count("forest_walk_raw")
    return out
