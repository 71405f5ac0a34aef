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
    ``histogram.build_root_histogram``;
  * :func:`fused_split_candidates` (K3, replaces
    ``fused_children_split_candidates_pallas``) -> raw [2, F, 8] f32
    candidates (gain, threshold, left g, left h, left count, 3 zeros);
    plain version :func:`fused_split_candidates_plain`, the plain
    histogram and ``split.per_feature_candidates``.

The split leaf, the right leaf and K3's child totals go to the kernels
as device tensors, so a caller holding them as 0-dim device tensors
never reads them to the host.  Every output, scratch and counter is
allocated and zeroed here with ``torch.zeros``.  Kernel launches are
counted in :data:`LAUNCHES`.

Tolerance.  Kernel and plain version both sum f32 values with atomics,
in an order that changes from run to run, so they agree only up to
rounding, whose scale is the sum of the absolute values added: histogram
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
thresholds are otherwise equal.

Preconditions: every bin code is below ``max_bin`` (the kernel skips
larger codes, the plain version would index the next feature).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict

import torch

from ..utils.log import LightGBMError
from .histogram import build_children_histograms, build_root_histogram
from .split import SplitParams, per_feature_candidates

#: kernel launches per wrapper; reset with :func:`reset_launch_counts`
LAUNCHES: Dict[str, int] = {"children_histograms": 0,
                            "fused_split_candidates": 0}
_count_lock = threading.Lock()

HIST_RTOL = 1e-5
HIST_ATOL = 1e-4

#: shared memory one block may use (bytes): a third of an H100 SM's
#: 227 KB, so three blocks can be resident on one SM
SMEM_PER_BLOCK = 232448 // 3
SMEM_LIMIT = 232448
THREADS = 256
#: blocks per feature group the wrapper aims for (132 SMs x 3)
TARGET_BLOCKS = 396


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


def feature_group(F: int, max_bin: int) -> int:
    """Features per block: as many [2, B, 3] f32 histograms as fit in
    :data:`SMEM_PER_BLOCK`, spread evenly over the groups (28 features at
    255 bins: 3 groups of 10, 61 KB each; 30 at 1000 bins: 10 of 3)."""
    per = 2 * max_bin * 3 * 4
    if per > SMEM_LIMIT:
        raise LightGBMError(
            f"children histograms: max_bin={max_bin} needs {per} bytes of "
            f"shared memory per feature, more than a block has")
    most = max(1, min(F, SMEM_PER_BLOCK // per))
    groups = -(-F // most)
    return -(-F // groups)


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


def _grid(F: int, N: int, max_bin: int):
    fg = feature_group(F, max_bin)
    groups = -(-F // fg)
    chunks = max(1, min(-(-N // THREADS), TARGET_BLOCKS // groups))
    return fg, groups, max(1, -(-N // chunks))


def _check(name, bins, grad, hess, weight, leaf_id):
    if bins.dim() != 2 or bins.shape[0] == 0:
        raise LightGBMError(f"{name}: bins {tuple(bins.shape)} must be "
                            f"[F, N] with F > 0")
    if bins.dtype not in (torch.uint8, torch.uint16):
        raise LightGBMError(f"{name}: bins has dtype {bins.dtype}; expected "
                            f"uint8 or uint16")
    N = bins.shape[1]
    for t, what, dtype in ((grad, "grad", torch.float32),
                           (hess, "hess", torch.float32),
                           (weight, "weight", torch.float32),
                           (leaf_id, "leaf_id", torch.int32)):
        if t.dtype != dtype or tuple(t.shape) != (N,):
            raise LightGBMError(
                f"{name}: {what} is {t.dtype} {tuple(t.shape)}; expected "
                f"{dtype} ({N},)")
    for t in (bins, grad, hess, weight, leaf_id):
        if t.device != bins.device:
            raise LightGBMError(f"{name}: inputs are on different devices")
        if not t.is_contiguous():
            raise LightGBMError(f"{name}: inputs must be contiguous")


def _leaves(parent_leaf, right_leaf, dev) -> torch.Tensor:
    """[2] int32 on ``dev`` from ints or 0-dim tensors, without a host
    read."""
    out = []
    for v in (parent_leaf, right_leaf):
        if isinstance(v, torch.Tensor):
            if v.numel() != 1 or v.device != dev:
                raise LightGBMError("children histograms: a leaf index "
                                    "must be one value on the bins' device")
            out.append(v.reshape(()).to(torch.int32))
        else:
            out.append(torch.full((), int(v), dtype=torch.int32, device=dev))
    return torch.stack(out)


def _lib():
    from . import _build
    lib = _build.load("children_hist")
    if lib.lgbt_children_histograms.argtypes is None:
        p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
        lib.lgbt_children_histograms.argtypes = [
            p, i, p, p, p, p, p, ll, i, i, i, ll, p, i, p]
        lib.lgbt_children_histograms.restype = i
        lib.lgbt_fused_split_candidates.argtypes = [
            p, i, p, p, p, p, p, p, p, p, p, f, f, f, f, f,
            ll, i, i, i, ll, p, p, p, i, p]
        lib.lgbt_fused_split_candidates.restype = i
    return lib


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def children_histograms(bins, grad, hess, weight, leaf_id, parent_leaf,
                        right_leaf, max_bin: int) -> torch.Tensor:
    """[2, F, max_bin, 3] f32 (g, h, w sums) of the rows whose leaf id is
    ``parent_leaf`` (left) or ``right_leaf`` (right).  ``bins`` [F, N]
    uint8/uint16, ``grad``/``hess``/``weight`` [N] f32 (already
    weighted), ``leaf_id`` [N] int32, all contiguous on one device."""
    _check("children_histograms", bins, grad, hess, weight, leaf_id)
    dev = bins.device
    if dev.type != "cuda":
        return build_children_histograms(bins, grad, hess, weight, leaf_id,
                                         parent_leaf, right_leaf, max_bin)
    F, N = bins.shape
    leaves = _leaves(parent_leaf, right_leaf, dev)
    out = torch.zeros((2, F, max_bin, 3), dtype=torch.float32, device=dev)
    fg, _, rows_per_block = _grid(F, N, max_bin)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.lgbt_children_histograms(
            bins.data_ptr(), bins.element_size(), grad.data_ptr(),
            hess.data_ptr(), weight.data_ptr(), leaf_id.data_ptr(),
            leaves.data_ptr(), N, F, max_bin, fg, rows_per_block,
            out.data_ptr(), THREADS, _stream(dev))
    if err != 0:
        raise LightGBMError(
            f"children_histograms kernel launch failed: CUDA error {err}")
    _count("children_histograms")
    return out


def root_histogram(bins, grad, hess, weight, max_bin: int) -> torch.Tensor:
    """[F, max_bin, 3] over all rows: K2 with every row in the left child
    (leaf 0, right leaf -2) on a card."""
    if bins.device.type != "cuda":
        return build_root_histogram(bins, grad, hess, weight, max_bin)
    leaf = torch.zeros(bins.shape[1], dtype=torch.int32, device=bins.device)
    return children_histograms(bins, grad, hess, weight, leaf, 0, -2,
                               max_bin)[0]


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
    leaves = _leaves(parent_leaf, right_leaf, dev)
    fg, groups, rows_per_block = _grid(F, N, max_bin)
    scratch = torch.zeros((2, F, max_bin, 3), dtype=torch.float32,
                          device=dev)
    tickets = torch.zeros(groups, dtype=torch.int32, device=dev)
    out = torch.zeros((2, F, 8), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.lgbt_fused_split_candidates(
            bins.data_ptr(), bins.element_size(), grad.data_ptr(),
            hess.data_ptr(), weight.data_ptr(), leaf_id.data_ptr(),
            leaves.data_ptr(), totals.data_ptr(), num_bin.data_ptr(),
            is_cat.data_ptr(), feat_mask.data_ptr(),
            float(params.min_data_in_leaf),
            float(params.min_sum_hessian_in_leaf), float(params.lambda_l1),
            float(params.lambda_l2), float(params.min_gain_to_split),
            N, F, max_bin, fg, rows_per_block, scratch.data_ptr(),
            tickets.data_ptr(), out.data_ptr(), THREADS, _stream(dev))
    if err != 0:
        raise LightGBMError(
            f"fused_split_candidates kernel launch failed: CUDA error {err}")
    _count("fused_split_candidates")
    return out
