"""Forest-walk serving kernel: freeze-time tables and launch wrappers.

Port of the JAX package's ops/pallas_walk.py (K4) with both of its
optional parts: piece-wise linear forests (the affine leaf epilogue) and
bf16 leaf tables.  The kernel itself is ``csrc/forest_walk.cu``, a
tree-parallel walk: blocks over (tree chunks) x (row tiles) write each
tree's value of each row to a scratch, and a second pass folds them in
tree order (see the note at the top of that file).  This module builds
its node tables at freeze time, plans its launch (:func:`plan_walk`, a
pure function) and wraps its two C entry points:

- :func:`forest_walk` walks pre-binned rows ``bins`` [F, B] (uint8 or
  uint16 codes, categorical misses already mapped to ``nan_bin``); a
  linear forest also takes the NaN-imputed f32 covariates ``xt`` [F, B];
- :func:`forest_walk_raw` bucketizes raw f32 rows ``X`` [F, B] on the
  card against the cut tables (the kernel's pass 0), then walks (a
  linear forest reads its covariates from ``X``, NaN as 0.0).

Both return [num_class, B] f32 raw scores.  On a CUDA tensor a wrapper
launches the kernel or raises; on a CPU tensor it runs the plain version
(:func:`bucketize_plain` + ``ops/predict.py``'s gather walk, the bf16
table dequantized to f32, which is exact), which is also what
``chip_smoke.py`` holds the kernel against on the card.  Each wrapper
counts its kernel launches in :data:`LAUNCHES`, one counter per variant
(``forest_walk[_raw][_linear][_bf16]``), one a call: the call's passes
(two, three for raw rows; more for row waves) together.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..obs import devprof
from ..utils.log import LightGBMError
from . import _build
from .predict import predict_binned_forest, predict_binned_forest_linear

#: the kernel's variants: binned or raw rows, constant or affine leaves,
#: f32 or bf16 leaf tables
VARIANTS = tuple(f"forest_walk{raw}{lin}{q}" for raw in ("", "_raw")
                 for lin in ("", "_linear") for q in ("", "_bf16"))
#: kernel launches per variant; reset with :func:`reset_launch_counts`
LAUNCHES: Dict[str, int] = {name: 0 for name in VARIANTS}
_count_lock = threading.Lock()

#: dynamic shared memory one block may use on Hopper (bytes), and all of
#: one SM's (a block's 1 KB of system use aside)
SMEM_LIMIT = 232448
SM_SMEM = 233472
#: rows a pass-1 block walks, the widest first: the plan takes the first
#: at which one tree's tables and the tile fit (the smallest, 32 rows as
#: in the first port's walk, decides what is refused)
WALK_TILES = (512, 256, 128, 64, 32)
#: rows a thread walks at once (the kernel's ``kRows``; its entry points
#: refuse another) and most threads a pass-1 block (at most the kernel's
#: ``kWalkThreads``, 1024)
WALK_ROWS_PER_THREAD = 4
WALK_THREADS = 1024
#: the most bytes of the [K*T, rows] f32 scratch of one wave of rows
WALK_SCRATCH_BYTES = 256 << 20
#: pass 2 folds with a warp a (class, row) up to this many pairs a wave
#: (a thread a pair beyond)
WALK_WARP_FOLD_MAX = 1024
MAX_ROW_TILES = 65535


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


def launch_cost(tables: "WalkTables", F: int, B: int, raw: bool,
                bin_itemsize: int = 1, cut_cols: int = 0) -> int:
    """Bytes one K4 launch must move: its input rows read once (binned:
    the [F, B] bins of ``bin_itemsize`` bytes and a linear forest's f32
    covariates; raw: the [F, B] f32 rows and the [F, ``cut_cols``] f32
    and int32 cut tables with the [F] uint8 flags), the tables once
    (nodes, leaves, a linear forest's coefficients and features) and
    the [K, B] f32 output written once.  ``obs/devprof.py``'s roofline
    and ``chip_smoke.py``'s ``bound_ms`` both read it."""
    table = (tables.nodes.numel() * 4
             + tables.leaves.numel() * tables.leaves.element_size())
    if tables.linear:
        table += tables.coeff.numel() * 4 + tables.feat.numel() * 4
    if raw:
        rows = F * B * 4 + F * cut_cols * 8 + F
    else:
        rows = F * B * bin_itemsize + (F * B * 4 if tables.linear else 0)
    return rows + table + tables.num_class * B * 4


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


def walk_smem(chunk: int, M: int, L: int, leaf_bytes: int, Kf: int,
              linear: bool, F: int, tile: int) -> int:
    """Shared bytes of one pass-1 block (``csrc/forest_walk.cu``
    ``smem_bytes``): ``chunk`` trees' nodes (16 bytes each), their leaf
    table padded to 16 bytes and the [F][tile] u16 bin tile; a linear
    forest adds the chunk's affine tables (8 bytes a slot) and the
    [F][tile] f32 covariate tile."""
    b = 16 * M * chunk + -(-chunk * L * leaf_bytes // 16) * 16 + 2 * F * tile
    if linear:
        b += 8 * L * Kf * chunk + 4 * F * tile
    return b


class WalkPlan(NamedTuple):
    """One call of the walk: ``tile`` rows a block, ``rows_per_thread``
    rows a thread walks at once, ``chunk`` trees a block stages,
    ``chunks`` x ``row_tiles`` blocks a wave (the first; the last may have
    fewer row tiles), ``threads`` a block, ``smem`` shared bytes a block,
    ``wave`` rows a pass-1/pass-2 pair covers (the scratch is [K*T, wave]
    f32), ``fold_warps`` (pass 2 folds a (class, row) a warp, not a
    thread) and ``bin_scratch`` bytes of pass 0's [F, B] u16 bins (raw
    rows; 0 for binned).  The kernel takes every field from here."""
    tile: int
    rows_per_thread: int
    chunk: int
    chunks: int
    row_tiles: int
    threads: int
    smem: int
    wave: int
    fold_warps: bool
    bin_scratch: int

    @property
    def grid(self) -> int:
        return self.chunks * self.row_tiles


def _resident(smem: int, threads: int) -> int:
    """Blocks of ``smem`` shared bytes and ``threads`` threads one SM
    holds (its shared memory, 2048 threads, 32 blocks)."""
    return max(1, min(SM_SMEM // (smem + 1024), 2048 // threads, 32))


def _threads(chunk: int, tile: int) -> int:
    slots = -(-tile // WALK_ROWS_PER_THREAD)
    return min(WALK_THREADS, 32 * -(-chunk * slots // 32))


@functools.lru_cache(maxsize=None)
def plan_walk(B: int, K: int, T: int, M: int, L: int, F: int, Kf: int,
              leaf_bytes: int, linear: bool, raw: bool,
              sms: int) -> WalkPlan:
    """The walk's launch for ``B`` rows, ``K`` classes of ``T`` trees of
    ``M`` nodes and ``L`` leaves (``leaf_bytes`` 4 or 2), ``F`` features,
    ``Kf`` affine slots a leaf when ``linear``, raw rows or binned, on a
    card of ``sms`` SMs.

    Tile: the widest of :data:`WALK_TILES` at which one tree's tables fit
    beside it, no wider than B; where even one tree a chunk leaves fewer
    blocks than SMs, narrower tiles (B * K * T >= sms gives a grid of at
    least ``sms``).  Chunk: as many trees as shared memory holds, fewer
    where the grid would not fill the SMs; then, where the blocks take
    several waves, the trees spread so that the last wave is full.
    Refuses only a forest whose one tree's tables and a 32-row tile do not
    fit a block, as the first port's walk did."""
    KT = K * T
    if B < 1 or KT < 1:
        raise LightGBMError(f"forest walk: nothing to walk (B={B}, "
                            f"K*T={KT})")

    def smem(chunk, tile):
        return walk_smem(chunk, M, L, leaf_bytes, Kf, linear, F, tile)

    fits = [t for t in WALK_TILES if smem(1, t) <= SMEM_LIMIT]
    if not fits:
        raise LightGBMError(
            f"forest walk needs more shared memory than a block has "
            f"({F} features, {L} leaves, {Kf if linear else 0} affine "
            f"slots: {smem(1, WALK_TILES[-1])} bytes at "
            f"{WALK_TILES[-1]} rows > {SMEM_LIMIT})")
    tile = min(fits[0], B)
    if -(-B // tile) * KT < sms:
        tile = max(1, B // -(-sms // KT))
    cap = WALK_SCRATCH_BYTES // (4 * KT)
    wave = min(B, max(tile, cap // tile * tile), MAX_ROW_TILES * tile)
    row_tiles = -(-wave // tile)
    per = 16 * M + L * leaf_bytes + (8 * L * Kf if linear else 0)
    most = max(1, min(KT, (SMEM_LIMIT - smem(0, tile) - 15) // per))
    while most < KT and smem(most + 1, tile) <= SMEM_LIMIT:
        most += 1
    want = -(-sms // row_tiles)            # chunks that fill the SMs
    chunk = max(1, min(most, KT // want))
    chunks = -(-KT // chunk)
    slots = sms * _resident(smem(chunk, tile), _threads(chunk, tile))
    if row_tiles * chunks > slots:
        waves = -(-row_tiles * chunks // slots)
        spread = waves * slots // row_tiles
        if spread > chunks:
            chunk = max(1, -(-KT // spread))
            chunks = -(-KT // chunk)
    return WalkPlan(tile, WALK_ROWS_PER_THREAD, chunk, chunks, row_tiles,
                    _threads(chunk, tile), smem(chunk, tile), wave,
                    K * wave <= WALK_WARP_FOLD_MAX, 2 * F * B if raw else 0)


def walk_items(p: WalkPlan, KT: int, B: int):
    """Every (tree, row, block, thread) the kernel walks, as the kernel
    computes them (``walk_trees_kernel``'s tile and item loops): numpy
    arrays over all waves, each (tree, row) of a slot a thread takes.
    Block ids count (wave, row tile, chunk) in launch order."""
    R = p.rows_per_thread
    trees, rows, blocks, threads = [], [], [], []
    block = 0
    for r0 in range(0, B, p.wave):
        nrows = min(p.wave, B - r0)
        for y in range(-(-nrows // p.tile)):
            t0 = y * p.tile
            nr = min(p.tile, nrows - t0)
            G = -(-nr // R)
            for x in range(p.chunks):
                c0 = x * p.chunk
                nt = min(p.chunk, KT - c0)
                item = np.arange(nt * G)
                j, g = item // G, item % G
                r = g[:, None] + np.arange(R)[None, :] * G
                ok = r < nr
                trees.append(np.broadcast_to((c0 + j)[:, None], r.shape)[ok])
                rows.append((r0 + t0 + r)[ok])
                threads.append(np.broadcast_to((item % p.threads)[:, None],
                                               r.shape)[ok])
                blocks.append(np.full(int(ok.sum()), block))
                block += 1
    cat = (lambda a: np.concatenate(a) if a else np.zeros(0, np.int64))
    return cat(trees), cat(rows), cat(blocks), cat(threads)


def _check_aligned(tables: WalkTables) -> None:
    """The kernel copies node records 16 bytes at a time."""
    if tables.nodes.data_ptr() % 16:
        raise LightGBMError("tables.nodes must start on a 16-byte boundary")


def _lib():
    lib = _build.load("forest_walk")
    if lib.lgbt_forest_walk_raw.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        plan = [i] * 7
        lib.lgbt_forest_walk_binned.argtypes = [
            p, p, i, i, i, i, i, p, i, i, i, p, p, i, p, *plan, p, p, p]
        lib.lgbt_forest_walk_binned.restype = i
        lib.lgbt_forest_walk_raw.argtypes = [
            p, p, i, i, i, i, i, p, p, p, p, i, i, i, i, p, p, i, *plan, p,
            p, p, p]
        lib.lgbt_forest_walk_raw.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index) \
        .multi_processor_count


def walk_plan(tables: WalkTables, F: int, B: int, raw: bool) -> WalkPlan:
    """:func:`plan_walk` for ``tables`` on their card: B rows of F
    features, raw or binned."""
    return plan_walk(B, tables.num_class, tables.trees_per_class,
                     tables.nodes.shape[1], tables.num_leaves, F,
                     tables.linear_k, tables.leaves.element_size(),
                     tables.linear, raw, _sm_count(tables.nodes.device.index))


def _plan_args(p: WalkPlan):
    """The plan's fields in the C entry points' order."""
    return (p.tile, p.rows_per_thread, p.chunk, p.threads, p.smem, p.wave,
            int(p.fold_warps))


def _scratch(tables: WalkTables, p: WalkPlan, dev):
    """One ``torch.empty`` for the [K*T, wave] f32 scratch and pass 0's
    bins: (buffer, scratch pointer, bins pointer)."""
    n = tables.num_class * tables.trees_per_class * p.wave
    buf = torch.empty(n + -(-p.bin_scratch // 4), dtype=torch.float32,
                      device=dev)
    return buf, buf.data_ptr(), buf.data_ptr() + 4 * n


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
    _check_aligned(tables)
    p = walk_plan(tables, F, B, raw=False)
    buf, scratch, _ = _scratch(tables, p, dev)
    coeff, feat, kf = _affine_args(tables)
    err = _build.launch(
        dev, _lib().lgbt_forest_walk_binned, tables.nodes.data_ptr(),
        tables.leaves.data_ptr(),
        tables.leaves.element_size(), K, tables.trees_per_class,
        tables.nodes.shape[1], tables.leaves.shape[1], bins.data_ptr(),
        bins.element_size(), F, B, coeff, feat, kf,
        xt.data_ptr() if tables.linear else None, *_plan_args(p), scratch,
        out.data_ptr())
    del buf                        # alive until the launch is enqueued
    name = tables.variant(raw=False)
    _raise_on(err, name)
    _count(name)
    if devprof.ENABLED:
        devprof.add_bytes(launch_cost(tables, F, B, False,
                                      bins.element_size()))
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
    _check_aligned(tables)
    p = walk_plan(tables, F, B, raw=True)
    buf, scratch, bin_scratch = _scratch(tables, p, dev)
    coeff, feat, kf = _affine_args(tables)
    err = _build.launch(
        dev, _lib().lgbt_forest_walk_raw, tables.nodes.data_ptr(),
        tables.leaves.data_ptr(),
        tables.leaves.element_size(), K, tables.trees_per_class,
        tables.nodes.shape[1], tables.leaves.shape[1], X.data_ptr(),
        bnd.data_ptr(), cats.data_ptr(), is_cat_col.data_ptr(), C,
        tables.nan_bin, F, B, coeff, feat, kf, *_plan_args(p), bin_scratch,
        scratch, out.data_ptr())
    del buf                        # alive until the launch is enqueued
    name = tables.variant(raw=True)
    _raise_on(err, name)
    _count(name)
    if devprof.ENABLED:
        devprof.add_bytes(launch_cost(tables, F, B, True, cut_cols=C))
    return out
