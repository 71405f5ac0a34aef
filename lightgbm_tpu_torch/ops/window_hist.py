"""The digit histogram of a window of rows given on the device (kernel P2).

Port of the JAX package's dynamic-window histogram probe
``tools/probe_dynhist.py``: K1's int32 digit sums (``ops/leafhist.py``)
over the rows ``[off, off + count)``, where ``window = [off, count]`` is
an int32 tensor on the device.  The caller never reads the window on the
host, so the window of one call can come from the output of the last one
with no host read in between (the probe chains ten calls that way).  A
window is clamped to the rows there are: rows outside ``[0, N)`` are
never read, and a window that runs past ``N`` (or starts below 0) sums
only its rows inside, in the kernel and in the plain version alike.

Inputs, in the probe's packed layouts (``ordered_grow.pack_u8_words``):

* ``bin_words``: ``ceil(F / 4)`` int32 ``[N]`` words, feature ``f`` in
  byte ``f % 4`` of word ``f // 4``;
* ``digits``: three int32 ``[N]`` words holding the 9 int8 digit streams
  the same way (``laneconcat`` and ``subconcat_T`` on the TPU), or an
  ``[N, 9]`` int8 matrix (``digmat``).

The output is ``[F, 9, max_bin]`` int32, K1's layout.

:func:`window_digit_histogram` launches the hand-written kernel
``csrc/window_hist.cu`` (which replaces the TPU kernel behind
``tools/probe_dynhist.py`` ``make_variant``) for CUDA tensors, or raises;
for CPU tensors it runs :func:`window_digit_histogram_plain`, which reads
the window on the host, unpacks the window's rows and hands them to
``leafhist.digit_histogram_plain``.  Both are exact integer sums, so they
agree bit for bit.  Kernel launches are counted in :data:`LAUNCHES`.

Preconditions (K1's): every bin code is below ``max_bin`` (the kernel
skips a code at or above it), and ``N`` is below 2^24 rows.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional

import torch

from ..utils.log import LightGBMError
from . import leafhist
from .ordered_grow import unpack_words

DIGIT_WORDS = 3
#: the most bin words the kernel takes (64 features)
MAX_BIN_WORDS = 16

#: kernel launches per wrapper; reset with :func:`reset_launch_counts`
LAUNCHES: Dict[str, int] = {"window_digit_histogram": 0}
_count_lock = threading.Lock()


def reset_launch_counts() -> None:
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def launch_counts() -> Dict[str, int]:
    with _count_lock:
        return dict(LAUNCHES)


def _is_matrix(digits) -> bool:
    return isinstance(digits, torch.Tensor)


def _check(bin_words, digits, window, num_features: int, max_bin: int):
    """Validates the inputs (shapes, types, devices, never the window's
    values); returns N."""
    bin_words = tuple(bin_words)
    if not bin_words:
        raise LightGBMError("window_digit_histogram: no bin words")
    n = bin_words[0].shape[0]
    need = -(-num_features // 4)
    if num_features < 1 or need > len(bin_words) or need > MAX_BIN_WORDS:
        raise LightGBMError(
            f"window_digit_histogram: {num_features} features need "
            f"{need} bin words (at most {MAX_BIN_WORDS}); "
            f"{len(bin_words)} given")
    if not 1 <= max_bin <= 256:
        raise LightGBMError(
            f"window_digit_histogram: max_bin={max_bin}; uint8 bins take "
            f"1..256")
    words = list(bin_words)
    if _is_matrix(digits):
        if digits.dtype != torch.int8 or tuple(digits.shape) != (
                n, leafhist.NUM_STREAMS) or not digits.is_contiguous():
            raise LightGBMError(
                f"window_digit_histogram: a digit matrix must be a "
                f"contiguous [{n}, 9] torch.int8; got "
                f"{tuple(digits.shape)} {digits.dtype}")
        dev_of = [digits]
    else:
        digits = tuple(digits)
        if len(digits) != DIGIT_WORDS:
            raise LightGBMError(
                f"window_digit_histogram: {len(digits)} digit words; "
                f"expected {DIGIT_WORDS}")
        words += digits
        dev_of = []
    for w in words:
        if w.dtype != torch.int32 or tuple(w.shape) != (n,) \
                or not w.is_contiguous():
            raise LightGBMError(
                f"window_digit_histogram: every word must be a contiguous "
                f"[{n}] torch.int32; got {tuple(w.shape)} {w.dtype}")
    if window.dtype != torch.int32 or tuple(window.shape) != (2,):
        raise LightGBMError(
            f"window_digit_histogram: window must be an int32 [off, count] "
            f"tensor; got {tuple(window.shape)} {window.dtype}")
    dev = bin_words[0].device
    if any(t.device != dev for t in words + dev_of + [window]):
        raise LightGBMError("window_digit_histogram: the inputs are on "
                            "different devices")
    if n >= leafhist.MAX_WINDOW_ROWS:
        raise LightGBMError(
            f"window_digit_histogram: {n} rows; int32 digit sums stay "
            f"exact below {leafhist.MAX_WINDOW_ROWS}")
    return n


def clamp_window(off: int, count: int, n: int):
    """``[off, off + count)`` intersected with ``[0, n)`` as (lo, hi)."""
    lo = min(max(off, 0), n)
    return lo, min(max(off + count, lo), n)


def window_digit_histogram_plain(bin_words, digits, window: torch.Tensor,
                                 num_features: int,
                                 max_bin: int) -> torch.Tensor:
    """[F, 9, max_bin] int32 digit sums over the window's rows in plain
    PyTorch.  Reads ``window`` on the host (one device read on a card)."""
    n = _check(bin_words, digits, window, num_features, max_bin)
    off, count = (int(v) for v in window.tolist())
    lo, hi = clamp_window(off, count, n)
    bins = unpack_words([w[lo:hi] for w in bin_words], num_features)
    if _is_matrix(digits):
        dig = digits[lo:hi]
    else:
        dig = unpack_words([w[lo:hi] for w in digits],
                           leafhist.NUM_STREAMS).view(torch.int8)
    return leafhist.digit_histogram_plain(bins, dig, max_bin)


def _lib():
    from . import _build
    lib = _build.load("window_hist")
    if lib.lgbt_window_digit_histogram.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.lgbt_window_digit_histogram.argtypes = [
            p, i, p, p, p, ll, i, i, i, ll, i, p, i, p]
        lib.lgbt_window_digit_histogram.restype = i
    return lib


def _pointers(tensors):
    ptrs = [t.data_ptr() for t in tensors]
    return (ctypes.c_void_p * max(len(ptrs), 1))(*ptrs)


def window_digit_histogram(bin_words, digits, window: torch.Tensor,
                           num_features: int, max_bin: int,
                           block_rows: Optional[int] = None) -> torch.Tensor:
    """[F, 9, max_bin] int32 digit sums over the rows of ``window``
    ([off, count] int32 on the inputs' device, read only by the kernel).

    The grid is fixed by N, since the window is not known on the host:
    with ``block_rows`` every block takes that many rows of the window
    (``ceil(N / block_rows)`` blocks a feature group, enough for a window
    of all N rows); without it, the window is split over at most
    ``leafhist.BLOCKS_PER_SM`` blocks a SM, as K1's large path splits a
    window of the same size.  Blocks past the window return at once."""
    n = _check(bin_words, digits, window, num_features, max_bin)
    dev = bin_words[0].device
    if dev.type != "cuda":
        return window_digit_histogram_plain(bin_words, digits, window,
                                            num_features, max_bin)
    if block_rows is not None and block_rows < 1:
        raise LightGBMError(
            f"window_digit_histogram: block_rows={block_rows} must be >= 1")
    F = num_features
    out = torch.zeros((F, leafhist.NUM_STREAMS, max_bin), dtype=torch.int32,
                      device=dev)
    fg = leafhist.feature_group(F, max_bin)
    groups = -(-F // fg)
    if block_rows is None:
        chunks = max(1, min(-(-n // leafhist.THREADS),
                            leafhist.BLOCKS_PER_SM
                            * leafhist.sm_count(dev.index) // groups))
    else:
        chunks = max(1, -(-n // block_rows))
    matrix = _is_matrix(digits)
    bw = _pointers(tuple(bin_words)[:-(-F // 4)])
    dw = _pointers(() if matrix else tuple(digits))
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lgbt_window_digit_histogram(
            ctypes.addressof(bw), len(bw), ctypes.addressof(dw),
            digits.data_ptr() if matrix else None, window.data_ptr(), n, F,
            max_bin, fg, block_rows or 0, chunks, out.data_ptr(),
            leafhist.THREADS, stream)
    if err != 0:
        raise LightGBMError(
            f"window_digit_histogram kernel launch failed: CUDA error {err}")
    with _count_lock:
        LAUNCHES["window_digit_histogram"] += 1
    return out
