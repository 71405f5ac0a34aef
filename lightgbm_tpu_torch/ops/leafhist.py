"""Exact leaf histograms from int8 radix-256 digits, and kernel K1.

Port of the JAX package's ops/leafhist.py.  Gradient, hessian and row
weight are quantized per tree to 24-bit fixed point and split into three
balanced radix-256 int8 digits each (:func:`quantize_digits`), so a
histogram is nine streams of exact int32 digit sums, and the sibling of
a split is the parent's sums minus the smaller child's, exactly
(reference serial_tree_learner.cpp:398-453 with the HistogramPool cache).

:func:`digit_histogram` sums the digits of a contiguous window of rows,
``[start, start + count)`` of a row-major ``[N, F]`` bin tensor and an
``[N, 9]`` digit tensor, into ``[F, 9, max_bin]`` int32.  On a CUDA
tensor it launches the hand-written kernel ``csrc/leaf_hist.cu`` (which
replaces the TPU kernel ``digit_histogram_pallas``) or raises; on a CPU
tensor it runs :func:`digit_histogram_plain`, one ``index_add_`` keyed by
``feature * max_bin + bin``.  Both are exact integer sums, so they agree
bit for bit in any summation order.  Kernel launches are counted in
:data:`LAUNCHES`.

:func:`leaf_histogram` serves the cached grower (``ops/grow.py``): it
compacts the rows of a mask into a window of a power-of-two size class
(:func:`size_classes`, :func:`compact_rows`: a stable sort of the mask)
and hands the window to :func:`digit_histogram`.

Preconditions: every bin code is below ``max_bin``, and a window holds
fewer than 2^24 rows (|digit| <= 128, so 128 * rows stays below 2^31).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Sequence, Tuple

import torch

from ..utils.log import LightGBMError

# 24-bit fixed point: values quantized to round(x / scale * 2^QBITS),
# |q| <= 2^QBITS, split into 3 balanced radix-256 int8 digits.
QBITS = 22
_DIGIT_W = (65536.0, 256.0, 1.0)
NUM_STREAMS = 9  # 3 values (g, h, w) x 3 digits
MAX_WINDOW_ROWS = 1 << 24

#: kernel launches per wrapper; reset with :func:`reset_launch_counts`
LAUNCHES: Dict[str, int] = {"digit_histogram": 0}
_count_lock = threading.Lock()

#: shared memory one block of the kernel may use (bytes): a third of an
#: H100 SM's 227 KB, so three blocks can be resident on one SM
SMEM_PER_BLOCK = 232448 // 3
#: the most shared memory one block can have at all
SMEM_LIMIT = 232448
THREADS = 256
#: blocks per feature group the wrapper aims for, over all row chunks
#: (132 SMs x 3 resident blocks)
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


# ---------------------------------------------------------------------------
# quantization


def compute_scales(g, h, w) -> torch.Tensor:
    """Per-tree quantization scales [3] f32 (max |value| per stream)."""
    return torch.stack([
        torch.clamp(torch.amax(torch.abs(g)), min=1e-30),
        torch.clamp(torch.amax(torch.abs(h)), min=1e-30),
        torch.clamp(torch.amax(torch.abs(w)), min=1e-30),
    ])


def quantize_digits(g, h, w, scales) -> torch.Tensor:
    """[N, 9] int8 balanced radix-256 digits of the 24-bit fixed-point
    g/h/w, in the order (g2, g1, g0, h2, h1, h0, w2, w1, w0) with weights
    (65536, 256, 1).  ``torch.round`` rounds half to even like
    ``jnp.round``, and the digit split uses floor remainder and floor
    division like Python's ``%`` and ``//`` on negative int32 (``fmod``
    or truncating division would corrupt negative digits)."""
    vals = torch.stack([g, h, w])                       # [3, N]
    q = torch.round(vals / scales[:, None]
                    * float(1 << QBITS)).to(torch.int32)
    d0 = torch.remainder(q + 128, 256) - 128             # balanced low digit
    q1 = torch.div(q - d0, 256, rounding_mode="floor")
    d1 = torch.remainder(q1 + 128, 256) - 128
    d2 = torch.div(q1 - d1, 256, rounding_mode="floor")  # |d2| <= 65
    digits = torch.stack([d2, d1, d0], dim=1)            # [3, 3, N]
    return digits.reshape(9, -1).T.to(torch.int8).contiguous()


def combine_digit_sums(sums_i32, scales) -> torch.Tensor:
    """int32 digit sums [..., 9, B] -> f32 histogram [..., B, 3]; exact
    up to one f32 rounding per entry."""
    s = sums_i32.to(torch.float32)
    out = []
    for v in range(3):
        acc = (s[..., 3 * v, :] * _DIGIT_W[0]
               + s[..., 3 * v + 1, :] * _DIGIT_W[1]
               + s[..., 3 * v + 2, :] * _DIGIT_W[2])
        out.append(acc * (scales[v] / float(1 << QBITS)))
    return torch.stack(out, dim=-1)


# ---------------------------------------------------------------------------
# plain version and kernel wrapper


def _window(bins_rm, digits, start: int, count):
    if bins_rm.dim() != 2 or digits.dim() != 2 \
            or digits.shape[1] != NUM_STREAMS \
            or digits.shape[0] != bins_rm.shape[0]:
        raise LightGBMError(
            f"digit_histogram: bins_rm {tuple(bins_rm.shape)} and digits "
            f"{tuple(digits.shape)} must be [N, F] and [N, 9]")
    n = bins_rm.shape[0]
    count = n - start if count is None else int(count)
    if start < 0 or count < 0 or start + count > n:
        raise LightGBMError(
            f"digit_histogram: window [{start}, {start + count}) is outside "
            f"the {n} rows")
    if count >= MAX_WINDOW_ROWS:
        raise LightGBMError(
            f"digit_histogram: {count} rows in one window; int32 digit "
            f"sums stay exact below {MAX_WINDOW_ROWS}")
    return int(start), count


def digit_histogram_plain(bins_rm: torch.Tensor, digits: torch.Tensor,
                          max_bin: int, start: int = 0,
                          count=None) -> torch.Tensor:
    """[F, 9, max_bin] int32 digit sums over rows [start, start + count):
    one ``index_add_`` keyed by ``feature * max_bin + bin`` accumulating
    the 9 digit streams in int32 (the JAX ``digit_histogram_scatter``).
    It materializes ``count * F * 9`` int32 values."""
    start, count = _window(bins_rm, digits, start, count)
    F = bins_rm.shape[1]
    b = bins_rm[start:start + count]
    d = digits[start:start + count]
    if b.dtype == torch.uint16:
        b = b.view(torch.int16).to(torch.int32) & 0xFFFF
    feat = torch.arange(F, dtype=torch.int64, device=b.device)[None, :]
    seg = feat * max_bin + b.to(torch.int64)                       # [S, F]
    vals = d.to(torch.int32)[:, None, :].expand(count, F, NUM_STREAMS)
    out = torch.zeros((F * max_bin, NUM_STREAMS), dtype=torch.int32,
                      device=b.device)
    out.index_add_(0, seg.reshape(-1), vals.reshape(-1, NUM_STREAMS))
    return out.reshape(F, max_bin, NUM_STREAMS).permute(0, 2, 1).contiguous()


def feature_group(F: int, max_bin: int) -> int:
    """Features per block: as many ``[9, max_bin]`` int32 histograms as
    fit in :data:`SMEM_PER_BLOCK` (at least one, if one fits in a block
    at all), spread evenly over the groups (28 features at 255 bins: 4
    groups of 7, 63 KB each)."""
    per = NUM_STREAMS * max_bin * 4
    if per > SMEM_LIMIT:
        raise LightGBMError(
            f"digit_histogram: max_bin={max_bin} needs {per} bytes of "
            f"shared memory per feature, more than a block has")
    most = max(1, min(F, SMEM_PER_BLOCK // per)) if F else 1
    groups = -(-F // most) if F else 1
    return -(-F // groups) if F else 1


def _lib():
    from . import _build
    lib = _build.load("leaf_hist")
    if lib.lgbt_digit_histogram.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.lgbt_digit_histogram.argtypes = [
            p, i, p, ll, ll, i, i, i, ll, p, i, p]
        lib.lgbt_digit_histogram.restype = i
    return lib


def digit_histogram(bins_rm: torch.Tensor, digits: torch.Tensor,
                    max_bin: int, start: int = 0,
                    count=None) -> torch.Tensor:
    """[F, 9, max_bin] int32 digit sums over rows [start, start + count)
    of ``bins_rm`` [N, F] (uint8/uint16, contiguous) and ``digits``
    [N, 9] int8.  The window is passed to the kernel as the base
    pointers plus a row offset and a count: no copy, no padding."""
    start, count = _window(bins_rm, digits, start, count)
    for t, name, dtypes in ((bins_rm, "bins_rm", (torch.uint8,
                                                  torch.uint16)),
                            (digits, "digits", (torch.int8,))):
        if t.dtype not in dtypes:
            raise LightGBMError(
                f"digit_histogram: {name} has dtype {t.dtype}; expected "
                f"one of {dtypes}")
        if not t.is_contiguous():
            raise LightGBMError(f"digit_histogram: {name} must be "
                                f"contiguous")
    if digits.device != bins_rm.device:
        raise LightGBMError("digit_histogram: bins_rm and digits are on "
                            "different devices")
    dev = bins_rm.device
    if dev.type != "cuda":
        return digit_histogram_plain(bins_rm, digits, max_bin, start, count)
    F = bins_rm.shape[1]
    out = torch.zeros((F, NUM_STREAMS, max_bin), dtype=torch.int32,
                      device=dev)
    fg = feature_group(F, max_bin)
    groups = -(-F // fg) if F else 1
    chunks = max(1, min(-(-count // THREADS), TARGET_BLOCKS // groups))
    rows_per_block = max(1, -(-count // chunks))
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lgbt_digit_histogram(
            bins_rm.data_ptr(), bins_rm.element_size(), digits.data_ptr(),
            start, count, F, max_bin, fg, rows_per_block, out.data_ptr(),
            THREADS, stream)
    if err != 0:
        raise LightGBMError(
            f"digit_histogram kernel launch failed: CUDA error {err}")
    _count("digit_histogram")
    return out


# ---------------------------------------------------------------------------
# compaction + size classes (the cached grower's smaller child)


def size_classes(num_data: int, min_size: int = 8192) -> Tuple[int, ...]:
    """Power-of-two compaction sizes covering [1, ceil(N/2)]."""
    top = max(num_data + 1, 2) // 2
    smax = 1
    while smax < top:
        smax *= 2
    sizes = []
    s = min(min_size, smax)
    while s < smax:
        sizes.append(s)
        s *= 2
    sizes.append(smax)
    return tuple(sizes)


def compact_rows(mask: torch.Tensor, size: int):
    """Indices of the up-to-``size`` True rows of ``mask``, in row order,
    padded with other rows: a stable sort of the mask (selected rows
    first).  Returns (idx [size] int64, valid [size] bool)."""
    cnt = torch.sum(mask.to(torch.int32))
    key = (~mask).to(torch.uint8)
    _, idx_sorted = torch.sort(key, stable=True)
    idx = idx_sorted[:size]
    valid = torch.arange(size, dtype=torch.int32, device=mask.device) < cnt
    return idx, valid


def leaf_histogram(bins_rm: torch.Tensor, digits: torch.Tensor,
                   mask: torch.Tensor, count: int, max_bin: int,
                   classes: Sequence[int]) -> torch.Tensor:
    """[F, 9, max_bin] int32 digit sums over the rows selected by ``mask``
    [N] bool: the rows are compacted into a window of the smallest size
    class that holds ``count`` (== sum(mask), a host int), rows past the
    count get zero digits, and the window goes to :func:`digit_histogram`
    (K1 on a card)."""
    sizes = list(classes)
    cls = min(sum(int(count) > s for s in sizes), len(sizes) - 1)
    idx, valid = compact_rows(mask, sizes[cls])
    store = bins_rm.view(torch.int16) if bins_rm.dtype == torch.uint16 \
        else bins_rm
    gathered_bins = store.index_select(0, idx).view(bins_rm.dtype)
    gathered_dig = digits.index_select(0, idx)
    gathered_dig = torch.where(valid[:, None], gathered_dig,
                               torch.zeros_like(gathered_dig))
    return digit_histogram(gathered_bins, gathered_dig, max_bin)
