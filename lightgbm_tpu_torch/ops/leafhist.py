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
``feature * max_bin + bin``.  The launch is planned by the pure function
:func:`plan`: windows up to :data:`SMALL_WINDOW_MAX_ROWS` rows take the
small-window path (one thread-block cluster a feature group, the
cluster's sums stored whole: one launch, nothing zero-filled), larger
ones the large-window path (each block's non-zero sums added with global
atomics into an output the kernel's launcher zeroes).  Both are exact
integer sums, so they agree bit for bit in any summation order.  Kernel
launches are counted in :data:`LAUNCHES`.

:func:`leaf_histogram` serves the cached grower (``ops/grow.py``): it
compacts the rows of a mask into a window of a power-of-two size class
(:func:`size_classes`, :func:`compact_rows`: a stable sort of the mask)
and hands the window to :func:`digit_histogram`.

Preconditions: every bin code is below ``max_bin``, and a window holds
fewer than 2^24 rows (|digit| <= 128, so 128 * rows stays below 2^31).
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from ..utils.log import LightGBMError
from . import _build

# 24-bit fixed point: values quantized to round(x / scale * 2^QBITS),
# |q| <= 2^QBITS, split into 3 balanced radix-256 int8 digits.
QBITS = 22
_DIGIT_W = (65536.0, 256.0, 1.0)
NUM_STREAMS = 9  # 3 values (g, h, w) x 3 digits
_BIN_DTYPES = (torch.uint8, torch.uint16)
MAX_WINDOW_ROWS = 1 << 24

#: kernel launches per wrapper; reset with :func:`reset_launch_counts`
LAUNCHES: Dict[str, int] = {"digit_histogram": 0}
_count_lock = threading.Lock()

#: blocks of the large-window path resident on one SM: each may use a
#: third of an H100 SM's 227 KB of shared memory (:data:`SMEM_PER_BLOCK`)
BLOCKS_PER_SM = 3
#: the most shared memory one block can have at all
SMEM_LIMIT = 232448
SMEM_PER_BLOCK = SMEM_LIMIT // BLOCKS_PER_SM
THREADS = 256
#: windows of at most this many rows take the small-window path (one
#: cluster a feature group, plain stores); larger ones the large-window
#: path.  The crossover of the two paths that chip_smoke.py measures over
#: the train phase's window classes (PERF.md) fixes it.
SMALL_WINDOW_MAX_ROWS = 1 << 16
#: blocks a cluster on the small-window path (16 needs the non-portable
#: cluster size); the large-window path launches no clusters
CLUSTER_SMALL = 16


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
    """Features per block of the large-window path: as many
    ``[9, max_bin]`` int32 histograms as fit in :data:`SMEM_PER_BLOCK`
    (at least one, if one fits in a block at all), spread evenly over the
    groups (28 features at 255 bins: 4 groups of 7, 63 KB each)."""
    per = NUM_STREAMS * max_bin * 4
    if per > SMEM_LIMIT:
        raise LightGBMError(
            f"digit_histogram: max_bin={max_bin} needs {per} bytes of "
            f"shared memory per feature, more than a block has")
    most = max(1, min(F, SMEM_PER_BLOCK // per)) if F else 1
    groups = -(-F // most) if F else 1
    return -(-F // groups) if F else 1


class Plan(NamedTuple):
    """One launch of K1: ``path`` ("small": one cluster a feature group,
    plain stores; "large": many row chunks a group, global atomics into
    a zeroed output), ``fg`` features a block, ``cluster`` blocks a
    cluster, ``chunks`` row chunks a group (a multiple of ``cluster``),
    ``rows_per_block`` rows a chunk, ``groups`` feature groups and
    ``smem`` shared bytes a block."""
    path: str
    fg: int
    cluster: int
    chunks: int
    rows_per_block: int
    groups: int
    smem: int


@functools.lru_cache(maxsize=4096)
def plan(count: int, F: int, max_bin: int, sms: int,
         path: Optional[str] = None) -> Plan:
    """The launch of K1 for a window of ``count`` rows of ``F`` features
    at ``max_bin`` bins on a card of ``sms`` SMs.  ``path`` None picks
    "small" up to :data:`SMALL_WINDOW_MAX_ROWS` rows, else "large";
    either can be asked for (``chip_smoke.py`` times both at every window
    class).

    Small: a cluster of up to :data:`CLUSTER_SMALL` blocks, one a
    :data:`THREADS` rows, covers each feature group's window; 2 features
    a block where that still gives a block per SM, else 1.  Large: the
    groups of :func:`feature_group`, one wave of :data:`BLOCKS_PER_SM`
    blocks a SM over all groups, no clusters."""
    if path is None:
        path = "small" if count <= SMALL_WINDOW_MAX_ROWS else "large"
    if path not in ("small", "large"):
        raise LightGBMError(f"digit_histogram: unknown path {path!r}")
    F = max(F, 1)
    fg = feature_group(F, max_bin)     # raises if one feature cannot fit
    if path == "small":
        cluster = min(CLUSTER_SMALL, max(1, -(-count // THREADS)))
        fg = min(fg, 2 if -(-F // 2) * cluster >= sms else 1)
        chunks = cluster
    else:
        cluster = 1
        chunks = max(1, min(-(-count // THREADS),
                            BLOCKS_PER_SM * sms // -(-F // fg)))
    groups = -(-F // fg)
    return Plan(path, fg, cluster, chunks, max(1, -(-count // chunks)),
                groups, fg * NUM_STREAMS * max_bin * 4)


def block_rows(p: Plan, count: int, chunk: int) -> Tuple[int, int]:
    """Rows ``[lo, hi)`` of the window that chunk ``chunk`` of every
    feature group scans, as the kernel computes them."""
    lo = chunk * p.rows_per_block
    return min(lo, count), min(lo + p.rows_per_block, count)


_fn = None


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """The SMs of card ``device_index`` (132 on an H100 SXM)."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("leaf_hist").lgbt_digit_histogram
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, i, p, ll, ll, i, i, i, ll, ll, i, i, p, i, p]
        fn.restype = i
        _fn = fn
    return _fn


def digit_histogram(bins_rm: torch.Tensor, digits: torch.Tensor,
                    max_bin: int, start: int = 0, count=None,
                    path: Optional[str] = None) -> torch.Tensor:
    """[F, 9, max_bin] int32 digit sums over rows [start, start + count)
    of ``bins_rm`` [N, F] (uint8/uint16, contiguous) and ``digits``
    [N, 9] int8.  The window is passed to the kernel as the base
    pointers plus a row offset and a count: no copy, no padding.
    ``path`` forces the small or large launch (:func:`plan`); it only
    matters on a card."""
    start, count = _window(bins_rm, digits, start, count)
    if bins_rm.dtype not in _BIN_DTYPES or digits.dtype != torch.int8:
        raise LightGBMError(
            f"digit_histogram: bins_rm has dtype {bins_rm.dtype} and "
            f"digits {digits.dtype}; expected one of {_BIN_DTYPES} and "
            f"torch.int8")
    if not (bins_rm.is_contiguous() and digits.is_contiguous()):
        raise LightGBMError("digit_histogram: bins_rm and digits must be "
                            "contiguous")
    dev = bins_rm.device
    if digits.device != dev:
        raise LightGBMError("digit_histogram: bins_rm and digits are on "
                            "different devices")
    if dev.type != "cuda":
        return digit_histogram_plain(bins_rm, digits, max_bin, start, count)
    F = bins_rm.shape[1]
    out = bins_rm.new_empty((F, NUM_STREAMS, max_bin), dtype=torch.int32)
    if F == 0:
        return out
    p = plan(count, F, max_bin, sm_count(dev.index), path)
    err = _build.launch(dev, _kernel(), bins_rm.data_ptr(),
                        bins_rm.element_size(), digits.data_ptr(), start,
                        count, F, max_bin, p.fg, p.rows_per_block, p.chunks,
                        p.cluster, int(p.path == "large"), out.data_ptr(),
                        THREADS)
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
