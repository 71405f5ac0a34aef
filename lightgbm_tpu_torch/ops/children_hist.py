"""Kernels K2 and K3: both children's f32 histograms in one pass, and the
same pass fused with the per-feature split scan.

Port of the JAX package's ops/pallas_histogram.py.  On a CUDA tensor
each wrapper launches its hand-written kernel in ``csrc/children_hist.cu``
or raises; on a CPU tensor it runs its plain version:

  * :func:`children_histograms` (K2, replaces
    ``children_histograms_pallas``) -> [2, F, B, 3] f32; plain version
    ``histogram.build_children_histograms``;
  * :func:`root_histogram` (K2 with every row in the left child, replaces
    ``root_histogram_pallas``) -> [F, B, 3]; plain version
    ``histogram.build_root_histogram``; the kernel gets no leaf array;
  * :func:`fused_split_candidates` (K3, replaces
    ``fused_children_split_candidates_pallas``) -> raw [2, F, 8] f32
    candidates (gain, threshold, left g, left h, left count, 3 zeros);
    plain version :func:`fused_split_candidates_plain`, the plain
    histogram and ``split.per_feature_candidates``.

K2 and K3 are one kernel body, K2 without the scan.  The split leaf,
the right leaf and K3's child totals go to the kernels as device
pointers or values, so a caller holding them as 0-dim device tensors
never reads them to the host.  Both launches are planned by the pure
function :func:`launch_plan` (:func:`plan_fused`: one persistent block
per SM, as many features a block as shared memory holds, a cooperative
grid no larger than the resident blocks).  Each writes its output whole
(``torch.empty``); the partials (f64) and K3's reduced histogram are
``torch.empty`` a call from PyTorch's caching allocator
(stream-ordered, no device work), never zeroed: the kernel writes every
slot it reads.  Kernel launches are counted in :data:`LAUNCHES`.

Tolerance.  The kernel adds in f64 and rounds each entry once; the plain
version adds f32 values with f32 atomics, in an order that changes from
run to run.  They agree only up to the plain version's rounding, whose
scale is the sum of the absolute values added: histogram
entries and left sums within :data:`HIST_RTOL` of their sums of |g|,
|h|, |w| plus :data:`HIST_ATOL` (the JAX package's own
kernel-against-scatter constants; a bin of 4000 rows of gradients that
cancel to 60 sums 3200 in absolute value).  A candidate's gain moves
with its left sums and with the right sums ``total - left``;
:func:`gain_tolerance` carries the left-sum tolerance through the gain
to first order.  Where the right side holds few rows, its sums are small
differences of two sums over most of the child's rows, and a few ulps of
those become a large share of the gain (3e-4 of the largest gain at 1M
rows).  Where two thresholds' gains differ by less than their
tolerances, the two versions may pick either (a near-tie); features and
thresholds are otherwise equal.  An f32 sum over many rows can drift
past this tolerance where the values repeat (the second round's
gradients take two values a first-round leaf) and one entry holds most
rows (a sparse feature's default bin): the plain version does on the
card's wide-sparse data, which is why the kernel adds in f64.

Preconditions: every bin code is below ``max_bin`` (the kernel skips
larger codes, the plain version would index the next feature).
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, NamedTuple, Tuple

import torch

from ..obs import devprof
from ..utils.log import LightGBMError
from . import _build
from .histogram import build_children_histograms, build_root_histogram
from .split import SplitParams, per_feature_candidates

#: kernel launches per wrapper; reset with :func:`reset_launch_counts`
LAUNCHES: Dict[str, int] = {"children_histograms": 0,
                            "fused_split_candidates": 0}
_count_lock = threading.Lock()

HIST_RTOL = 1e-5
HIST_ATOL = 1e-4

#: dynamic shared memory one block may use on Hopper (bytes)
SMEM_LIMIT = 232448
#: K2 and K3: threads a block, and consecutive rows a thread takes per
#: tile (the kernel's 4-wide loads; its entry points refuse another tile)
FUSED_THREADS = 1024
FUSED_ROWS_PER_THREAD = 4
#: the queue of a tile's child rows (row, g, h, w: 16 bytes each, one a
#: thread) and its 3 counters (16 bytes), beside the histogram in shared
#: memory
FUSED_QUEUE_ROWS = FUSED_THREADS
FUSED_QUEUE_BYTES = FUSED_QUEUE_ROWS * 16 + 16


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


def launch_cost(N: int, F: int, itemsize: int, max_bin: int, scan: bool,
                leaf: bool = True) -> int:
    """Bytes one K2 (``scan`` False) or K3 launch must move: the bins
    (``itemsize`` bytes each), g, h and w f32 and, unless the root form
    takes none, the int32 leaf ids of the ``N`` rows read once; the
    output written once (K2's [2, F, max_bin, 3] f32 sums, K3's
    [2, F, 8] f32 candidates; K3's scratch stays in L2).
    ``obs/devprof.py``'s roofline and ``chip_smoke.py``'s ``bound_ms``
    both read it."""
    out = 2 * F * 8 * 4 if scan else 2 * F * max_bin * 3 * 4
    return N * F * itemsize + (16 if leaf else 12) * N + out


def gain_tolerance(left_g, left_h, total_g, total_h, abs_g, abs_h,
                   lambda_l2: float = 0.0):
    """How far a candidate's gain ``G_L^2/H_L + G_R^2/H_R`` may move, to
    first order, when its left sums move by :data:`HIST_RTOL` of their
    sums of absolute values (``abs_g``, ``abs_h``) plus
    :data:`HIST_ATOL`, and the right sums ``total - left`` with them.
    Elementwise over tensors."""
    eg = HIST_RTOL * abs_g + HIST_ATOL
    eh = HIST_RTOL * abs_h + HIST_ATOL
    right_g = total_g - left_g
    hl, hr = left_h + lambda_l2, total_h - left_h + lambda_l2
    return (2 * (left_g.abs() / hl + right_g.abs() / hr) * eg
            + ((left_g / hl) ** 2 + (right_g / hr) ** 2) * eh)


class FusedPlan(NamedTuple):
    """One launch of K2 or K3: ``fg`` features a block in ``groups``
    groups, ``per_group`` blocks a group (each writes one partial slot),
    ``grid`` blocks in all, ``tile`` rows a block takes at a time,
    ``queue`` child rows its shared queue holds and ``smem`` shared bytes
    a block.  The kernel takes every field from here."""
    fg: int
    groups: int
    per_group: int
    grid: int
    tile: int
    queue: int
    smem: int


@functools.lru_cache(maxsize=None)
def fused_feature_group(F: int, max_bin: int) -> int:
    """K2's and K3's features a block: as many ``[2, B, 3]`` f64
    histograms as one block's shared memory holds beside the child-row
    queue (17 at 255 bins: 28 features in two groups of 14, 171 KB +
    16 KB), spread evenly over the groups."""
    per = 2 * max_bin * 3 * 8
    room = SMEM_LIMIT - FUSED_QUEUE_BYTES
    if per > room:
        raise LightGBMError(
            f"children histograms: max_bin={max_bin} needs {per} bytes "
            f"of shared memory per feature, more than a block has beside "
            f"its {FUSED_QUEUE_BYTES}-byte row queue")
    most = max(1, min(F, room // per))
    return -(-F // -(-F // most))


@functools.lru_cache(maxsize=None)
def plan_fused(F: int, max_bin: int, sms: int,
               blocks_per_sm: int) -> FusedPlan:
    """K2's and K3's launch for ``F`` features at ``max_bin`` bins on a
    card of ``sms`` SMs that holds ``blocks_per_sm`` blocks of this size
    at once (the occupancy the kernel's launcher reports).  Features:
    :func:`fused_feature_group`.  Blocks: one a SM, and never more than
    can be resident (the cooperative launch's grid barrier needs every
    block resident); with more groups than blocks, each block takes
    several groups in turn."""
    fg = fused_feature_group(F, max_bin)
    groups = -(-F // fg)
    per = 2 * max_bin * 3 * 8
    if blocks_per_sm < 1 or sms < 1:
        raise LightGBMError(
            f"children histograms: no block of {fg * per} shared bytes "
            f"is resident on this card")
    if groups <= sms:
        per_group = sms // groups
        grid = per_group * groups
    else:
        per_group, grid = 1, sms
    return FusedPlan(fg, groups, per_group, grid,
                     FUSED_THREADS * FUSED_ROWS_PER_THREAD, FUSED_QUEUE_ROWS,
                     fused_smem(F, max_bin))


def fused_smem(F: int, max_bin: int) -> int:
    """Shared bytes a block of K2 or K3 takes: its features' histograms
    beside the row queue."""
    return 2 * max_bin * 3 * 8 * fused_feature_group(F, max_bin) \
        + FUSED_QUEUE_BYTES


def launch_plan(F: int, max_bin: int, occupancy) -> FusedPlan:
    """The launch of K2 and K3 alike: :func:`plan_fused` for the blocks
    one SM holds at :func:`fused_smem` bytes and the SM count, which
    ``occupancy(smem)`` returns (the kernel launcher's query on the
    card)."""
    blocks_per_sm, sms = occupancy(fused_smem(F, max_bin))
    return plan_fused(F, max_bin, sms, blocks_per_sm)


def fused_block_rows(p: FusedPlan, N: int, block: int):
    """(groups, row ranges) that block ``block`` of K2 or K3 scans, as the
    kernel computes them (``fused_split_kernel``'s group and tile loops):
    each group it takes, the rows of its tiles."""
    step = p.grid // p.per_group
    groups = list(range(block // p.per_group, p.groups, step))
    ntiles = -(-N // p.tile)
    rows = [(t * p.tile, min((t + 1) * p.tile, N))
            for t in range(block % p.per_group, ntiles, p.per_group)]
    return groups, rows


def _check(name, bins, grad, hess, weight, leaf_id):
    """``leaf_id`` None: no leaf array (the root form)."""
    if bins.dim() != 2 or bins.shape[0] == 0:
        raise LightGBMError(f"{name}: bins {tuple(bins.shape)} must be "
                            f"[F, N] with F > 0")
    if bins.dtype not in (torch.uint8, torch.uint16):
        raise LightGBMError(f"{name}: bins has dtype {bins.dtype}; expected "
                            f"uint8 or uint16")
    N = bins.shape[1]
    rows = [(grad, "grad", torch.float32), (hess, "hess", torch.float32),
            (weight, "weight", torch.float32)]
    if leaf_id is not None:
        rows.append((leaf_id, "leaf_id", torch.int32))
    for t, what, dtype in rows:
        if t.dtype != dtype or tuple(t.shape) != (N,):
            raise LightGBMError(
                f"{name}: {what} is {t.dtype} {tuple(t.shape)}; expected "
                f"{dtype} ({N},)")
    for t in (bins, *(r[0] for r in rows)):
        if t.device != bins.device:
            raise LightGBMError(f"{name}: inputs are on different devices")
        if not t.is_contiguous():
            raise LightGBMError(f"{name}: inputs must be contiguous")


def _leaf_arg(v, dev):
    """(tensor to keep alive, device pointer or None, value) of a leaf
    index for K2 and K3: a 0-dim int32 tensor on ``dev`` goes to the
    kernel as its address (no host read, no launch), an int as its
    value."""
    if isinstance(v, torch.Tensor):
        if v.numel() != 1 or v.device != dev:
            raise LightGBMError("children histograms: a leaf index must be "
                                "one value on the bins' device")
        if v.dtype != torch.int32:
            v = v.to(torch.int32)
        return v, v.data_ptr(), 0
    return None, None, int(v)


def _lib():
    lib = _build.load("children_hist")
    if lib.lgbt_children_histograms.argtypes is None:
        p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
        lib.lgbt_children_histograms.argtypes = [
            p, i, p, p, p, p, p, p, i, i, ll, i, i, i, i, i, i, ll, i, i, i,
            p, p, i, p]
        lib.lgbt_children_histograms.restype = i
        lib.lgbt_fused_split_candidates.argtypes = [
            p, i, p, p, p, p, p, p, i, i, p, p, p, p, f, f, f, f, f,
            ll, i, i, i, i, i, i, ll, i, i, i, p, p, p, i, p]
        lib.lgbt_fused_split_candidates.restype = i
        lib.lgbt_fused_resident_blocks.argtypes = [
            i, i, i, i, ctypes.POINTER(i), ctypes.POINTER(i)]
        lib.lgbt_fused_resident_blocks.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _resident(device_index: int, bin_bytes: int, scan: bool,
              smem: int) -> Tuple[int, int]:
    """(blocks of K3 (``scan``) or K2 one SM holds at once, SMs) on the
    card."""
    bps, sms = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = _lib().lgbt_fused_resident_blocks(
            bin_bytes, int(scan), smem, FUSED_THREADS, ctypes.byref(bps),
            ctypes.byref(sms))
    if err != 0:
        raise LightGBMError(
            f"{'fused_split_candidates' if scan else 'children_histograms'}"
            f": occupancy query failed: CUDA error {err}")
    return bps.value, sms.value


def _card_plan(bins, max_bin: int, scan: bool) -> FusedPlan:
    return launch_plan(bins.shape[0], max_bin, functools.partial(
        _resident, bins.device.index, bins.element_size(), scan))


def _vec_rows(N: int, *tensors) -> int:
    """1 where the kernel may take 4 rows in one 16-byte load: N % 4 == 0
    and every base 16-byte aligned."""
    return int(N % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors
                                  if t is not None))


def children_histograms(bins, grad, hess, weight, leaf_id, parent_leaf,
                        right_leaf, max_bin: int) -> torch.Tensor:
    """[2, F, max_bin, 3] f32 (g, h, w sums) of the rows whose leaf id is
    ``parent_leaf`` (left) or ``right_leaf`` (right).  ``bins`` [F, N]
    uint8/uint16, ``grad``/``hess``/``weight`` [N] f32 (already
    weighted), ``leaf_id`` [N] int32, all contiguous on one device."""
    _check("children_histograms", bins, grad, hess, weight, leaf_id)
    if bins.device.type != "cuda":
        return build_children_histograms(bins, grad, hess, weight, leaf_id,
                                         parent_leaf, right_leaf, max_bin)
    return _children_kernel(bins, grad, hess, weight, leaf_id, parent_leaf,
                            right_leaf, max_bin)


def root_histogram(bins, grad, hess, weight, max_bin: int) -> torch.Tensor:
    """[F, max_bin, 3] over all rows: on a card, K2 in its root form (no
    leaf array: every row in the left child)."""
    _check("root_histogram", bins, grad, hess, weight, None)
    if bins.device.type != "cuda":
        return build_root_histogram(bins, grad, hess, weight, max_bin)
    return _children_kernel(bins, grad, hess, weight, None, 0, -2,
                            max_bin)[0]


def _children_kernel(bins, grad, hess, weight, leaf_id, parent_leaf,
                     right_leaf, max_bin: int) -> torch.Tensor:
    dev = bins.device
    F, N = bins.shape
    p = _card_plan(bins, max_bin, scan=False)
    partials = torch.empty(p.per_group * 2 * F * max_bin * 3,
                           dtype=torch.float64, device=dev)
    (parent_t, parent_p, parent_v), (right_t, right_p, right_v) = (
        _leaf_arg(v, dev) for v in (parent_leaf, right_leaf))
    out = torch.empty((2, F, max_bin, 3), dtype=torch.float32, device=dev)
    err = _build.launch(
        dev, _lib().lgbt_children_histograms,
        bins.data_ptr(), bins.element_size(), grad.data_ptr(),
        hess.data_ptr(), weight.data_ptr(),
        None if leaf_id is None else leaf_id.data_ptr(), parent_p, right_p,
        parent_v, right_v, N, F, max_bin, p.fg, p.groups, p.per_group,
        p.grid, p.tile, p.queue, p.smem,
        _vec_rows(N, bins, grad, hess, weight, leaf_id),
        partials.data_ptr(), out.data_ptr(), FUSED_THREADS)
    del parent_t, right_t          # alive until the launch is enqueued
    if err != 0:
        raise LightGBMError(
            f"children_histograms kernel launch failed: CUDA error {err}")
    _count("children_histograms")
    if devprof.ENABLED:
        devprof.add_bytes(launch_cost(N, F, bins.element_size(), max_bin,
                                      False, leaf_id is not None))
    return out


def _raw_candidates(cand) -> torch.Tensor:
    z = torch.zeros_like(cand.gain)
    return torch.stack([cand.gain, cand.threshold.to(torch.float32),
                        cand.left_g, cand.left_h, cand.left_c, z, z, z],
                       dim=-1)


def fused_split_candidates_plain(bins, grad, hess, weight, leaf_id,
                                 parent_leaf, right_leaf, totals, num_bin,
                                 is_cat, feat_mask, max_bin: int,
                                 params: SplitParams) -> torch.Tensor:
    """K3's plain version: the plain histogram, then
    ``per_feature_candidates``, as raw [2, F, 8] f32."""
    hists = build_children_histograms(bins, grad, hess, weight, leaf_id,
                                      parent_leaf, right_leaf, max_bin)
    return _raw_candidates(per_feature_candidates(
        hists, totals[:, 0], totals[:, 1], totals[:, 2], num_bin, is_cat,
        feat_mask, params))


def fused_split_candidates(bins, grad, hess, weight, leaf_id, parent_leaf,
                           right_leaf, totals, num_bin, is_cat, feat_mask,
                           max_bin: int, params: SplitParams) -> torch.Tensor:
    """Raw [2, F, 8] f32 per-feature candidates of both children: lanes
    0..4 are (gain without the parent's gain shift, threshold, left g,
    left h, left count).  ``totals`` [2, 3] f32 are the children's
    (g, h, count); ``num_bin`` [F] int32, ``is_cat``/``feat_mask`` [F]
    bool; the rest as :func:`children_histograms`."""
    _check("fused_split_candidates", bins, grad, hess, weight, leaf_id)
    dev = bins.device
    F, N = bins.shape
    for t, what, dtype, shape in (
            (totals, "totals", torch.float32, (2, 3)),
            (num_bin, "num_bin", torch.int32, (F,)),
            (is_cat, "is_cat", torch.bool, (F,)),
            (feat_mask, "feat_mask", torch.bool, (F,))):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise LightGBMError(
                f"fused_split_candidates: {what} is {t.dtype} "
                f"{tuple(t.shape)}; expected {dtype} {shape}")
        if t.device != dev or not t.is_contiguous():
            raise LightGBMError(f"fused_split_candidates: {what} must be "
                                f"contiguous on the bins' device")
    if dev.type != "cuda":
        return fused_split_candidates_plain(
            bins, grad, hess, weight, leaf_id, parent_leaf, right_leaf,
            totals, num_bin, is_cat, feat_mask, max_bin, params)
    p = _card_plan(bins, max_bin, scan=True)
    E = 2 * F * max_bin * 3
    # f64 partials [per_group, 2, F, B, 3] and the reduced [2, F, B, 3]
    partials = torch.empty(p.per_group * E, dtype=torch.float64, device=dev)
    reduced = torch.empty(E, dtype=torch.float32, device=dev)
    (parent_t, parent_p, parent_v), (right_t, right_p, right_v) = (
        _leaf_arg(v, dev) for v in (parent_leaf, right_leaf))
    out = bins.new_empty((2, F, 8), dtype=torch.float32)
    err = _build.launch(
        dev, _lib().lgbt_fused_split_candidates,
        bins.data_ptr(), bins.element_size(), grad.data_ptr(),
        hess.data_ptr(), weight.data_ptr(), leaf_id.data_ptr(), parent_p,
        right_p, parent_v, right_v, totals.data_ptr(), num_bin.data_ptr(),
        is_cat.data_ptr(), feat_mask.data_ptr(),
        float(params.min_data_in_leaf),
        float(params.min_sum_hessian_in_leaf), float(params.lambda_l1),
        float(params.lambda_l2), float(params.min_gain_to_split),
        N, F, max_bin, p.fg, p.groups, p.per_group, p.grid, p.tile, p.queue,
        p.smem, _vec_rows(N, bins, grad, hess, weight, leaf_id),
        partials.data_ptr(), reduced.data_ptr(), out.data_ptr(),
        FUSED_THREADS)
    del parent_t, right_t          # alive until the launch is enqueued
    if err != 0:
        raise LightGBMError(
            f"fused_split_candidates kernel launch failed: CUDA error {err}")
    _count("fused_split_candidates")
    if devprof.ENABLED:
        devprof.add_bytes(launch_cost(N, F, bins.element_size(), max_bin,
                                      True))
    return out
