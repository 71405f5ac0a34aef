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

Inputs, in the probe's packed layouts (``ordered_grow.pack_u8_words``
gives them), the words of each kind as the rows of one buffer:

* ``bin_words``: a ``[W, N]`` int32 tensor, ``W >= ceil(F / 4)`` words,
  feature ``f`` in byte ``f % 4`` of word (row) ``f // 4``;
* ``digits``: a ``[3, N]`` int32 tensor of three words holding the 9 int8
  digit streams the same way (``laneconcat`` and ``subconcat_T`` on the
  TPU), or an ``[N, 9]`` int8 matrix (``digmat``); the dtype tells them
  apart.

The kernel reads word ``q`` at the buffer's address plus ``q * N``: one
base pointer and a stride, no pointer table and no copy.  The output is
``[F, 9, max_bin]`` int32, K1's layout.

:func:`window_digit_histogram` launches the hand-written kernel
``csrc/window_hist.cu`` (which replaces the TPU kernel behind
``tools/probe_dynhist.py`` ``make_variant``) for CUDA tensors, or raises;
for CPU tensors it runs :func:`window_digit_histogram_plain`, which reads
the window on the host, unpacks the window's rows and hands them to
``leafhist.digit_histogram_plain``.  Both are exact integer sums, so they
agree bit for bit.  The launch is planned by the pure function
:func:`plan_window` from the card and ``N``, never from the window:
one bin word (4 features) a block, one wave of blocks, each block an
equal share of the clamped window found on the device.  The kernel
writes the output whole in its one launch (per-block partials summed in
chunk order after a grid barrier): nothing is zero-filled before it.  The
TPU probe's ``nb`` (rows a VMEM tile holds) has no counterpart here and
sets nothing on the card.  Kernel launches are counted in
:data:`LAUNCHES`.

Preconditions (K1's): every bin code is below ``max_bin`` (the kernel
skips a code at or above it), and ``N`` is below 2^24 rows.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, NamedTuple, Tuple

import torch

from ..utils.log import LightGBMError
from . import _build, leafhist
from .ordered_grow import unpack_words

DIGIT_WORDS = 3
#: the most bin words the kernel takes (64 features)
MAX_BIN_WORDS = 16
#: features a block: one bin word
WORD_FEATURES = 4
#: threads a block, and the most blocks a SM the plan takes (the
#: kernel's occupancy on the card may allow fewer)
THREADS = 1024
BLOCKS_PER_SM = 1

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


def _is_matrix(digits: torch.Tensor) -> bool:
    return digits.dtype == torch.int8


def _check(bin_words, digits, window, num_features: int, max_bin: int):
    """Validates the inputs (shapes, types, devices, never the window's
    values); returns N."""
    if bin_words.dim() != 2 or bin_words.dtype != torch.int32 \
            or not bin_words.is_contiguous():
        raise LightGBMError(
            f"window_digit_histogram: the bin words must be a contiguous "
            f"[W, N] torch.int32; got {tuple(bin_words.shape)} "
            f"{bin_words.dtype}")
    words, n = bin_words.shape
    need = -(-num_features // WORD_FEATURES)
    if num_features < 1 or need > words or need > MAX_BIN_WORDS:
        raise LightGBMError(
            f"window_digit_histogram: {num_features} features need "
            f"{need} bin words (at most {MAX_BIN_WORDS}); {words} given")
    if not 1 <= max_bin <= 256:
        raise LightGBMError(
            f"window_digit_histogram: max_bin={max_bin}; uint8 bins take "
            f"1..256")
    if _is_matrix(digits):
        if digits.shape != (n, leafhist.NUM_STREAMS) \
                or not digits.is_contiguous():
            raise LightGBMError(
                f"window_digit_histogram: a digit matrix must be a "
                f"contiguous [{n}, 9] torch.int8; got "
                f"{tuple(digits.shape)}")
    elif digits.dtype != torch.int32 or digits.shape != (DIGIT_WORDS, n) \
            or not digits.is_contiguous():
        raise LightGBMError(
            f"window_digit_histogram: the digit words must be a contiguous "
            f"[{DIGIT_WORDS}, {n}] torch.int32; got {tuple(digits.shape)} "
            f"{digits.dtype}")
    if window.dtype != torch.int32 or window.shape != (2,):
        raise LightGBMError(
            f"window_digit_histogram: window must be an int32 [off, count] "
            f"tensor; got {tuple(window.shape)} {window.dtype}")
    dev = bin_words.get_device()
    if digits.get_device() != dev or window.get_device() != dev:
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
    bins = unpack_words(bin_words[:, lo:hi], num_features)
    if _is_matrix(digits):
        dig = digits[lo:hi]
    else:
        dig = unpack_words(digits[:, lo:hi],
                           leafhist.NUM_STREAMS).view(torch.int8)
    return leafhist.digit_histogram_plain(bins, dig, max_bin)


def block_smem(max_bin: int) -> int:
    """Shared bytes a block takes: one bin word's [4][9][max_bin] int32
    histogram."""
    return WORD_FEATURES * leafhist.NUM_STREAMS * max_bin * 4


class WindowPlan(NamedTuple):
    """One cooperative launch of P2: ``groups`` feature groups (one bin
    word each), ``chunks`` blocks a group (equal shares of the window),
    ``threads`` a block, ``smem`` shared bytes a block and ``partials``
    int32 entries of the per-block partials buffer."""
    groups: int
    chunks: int
    threads: int
    smem: int
    partials: int


@functools.lru_cache(maxsize=1024)
def plan_window(n: int, F: int, max_bin: int, sms: int,
                blocks_per_sm: int) -> WindowPlan:
    """The launch of P2 over ``n`` rows of ``F`` features at ``max_bin``
    bins on a card of ``sms`` SMs that holds ``blocks_per_sm`` blocks at
    once (the kernel's occupancy; the plan takes at most
    :data:`BLOCKS_PER_SM` of them).  It never sees the window: a window of
    any size, up to all ``n`` rows, runs on this grid.

    One wave of ``sms * min(blocks_per_sm, BLOCKS_PER_SM)`` blocks, the
    same number of chunks for every group, and no more chunks than ``n``
    rows give :data:`THREADS` rows each.  Raises for features or bins the
    kernel does not take, and where the groups cannot all be resident."""
    if not 1 <= F <= WORD_FEATURES * MAX_BIN_WORDS \
            or not 1 <= max_bin <= 256:
        raise LightGBMError(
            f"window_digit_histogram: F={F}, max_bin={max_bin}; the kernel "
            f"takes 1..{WORD_FEATURES * MAX_BIN_WORDS} features of "
            f"1..256 bins")
    groups = -(-F // WORD_FEATURES)
    smem = block_smem(max_bin)
    slots = max(sms, 0) * min(max(blocks_per_sm, 0), BLOCKS_PER_SM)
    if slots < groups:
        raise LightGBMError(
            f"window_digit_histogram: {groups} feature groups need as many "
            f"resident blocks; the card holds {slots}")
    chunks = max(1, min(slots // groups, -(-max(n, 1) // THREADS)))
    return WindowPlan(groups, chunks, THREADS, smem,
                      groups * chunks * smem // 4)


def _lib():
    lib = _build.load("window_hist")
    if lib.lgbt_window_digit_histogram.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.lgbt_window_digit_histogram.argtypes = [
            p, ll, p, ll, p, p, ll, i, i, i, i, p, p, p]
        lib.lgbt_window_digit_histogram.restype = i
        lib.lgbt_window_resident_blocks.argtypes = [
            i, i, i, ctypes.POINTER(i), ctypes.POINTER(i)]
        lib.lgbt_window_resident_blocks.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _resident(device_index: int, matrix: bool, threads: int,
              smem: int) -> Tuple[int, int]:
    """(SMs, blocks of ``threads`` threads and ``smem`` shared bytes one
    SM holds at once) on the card."""
    bps, sms = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = _lib().lgbt_window_resident_blocks(
            int(matrix), threads, smem, ctypes.byref(bps),
            ctypes.byref(sms))
    if err != 0:
        raise LightGBMError(
            f"window_digit_histogram: occupancy query failed: CUDA error "
            f"{err}")
    return sms.value, bps.value


def card_plan(bin_words, digits, num_features: int,
              max_bin: int) -> WindowPlan:
    """:func:`plan_window` for these inputs on their card."""
    sms, bps = _resident(bin_words.get_device(), _is_matrix(digits),
                         THREADS, block_smem(max_bin))
    return plan_window(bin_words.shape[1], num_features, max_bin, sms, bps)


def launch_cost(count: int, words: int, matrix: bool, num_features: int,
                max_bin: int) -> int:
    """Bytes one P2 launch must move over a window of ``count`` rows:
    ``words`` int32 bin words and the digits (a 9-byte int8 row, or 3
    int32 words) of each row read once, the [off, count] window read
    once and the [F, 9, max_bin] int32 output written once
    (``chip_smoke.py``'s ``bound_ms`` reads it).  The window lies in
    device memory, so the wrapper adds nothing to a devprof sample:
    counting it would need a device read."""
    return (count * (words * 4 + (9 if matrix else 12)) + 8
            + 4 * num_features * leafhist.NUM_STREAMS * max_bin)


def window_digit_histogram(bin_words, digits, window: torch.Tensor,
                           num_features: int, max_bin: int) -> torch.Tensor:
    """[F, 9, max_bin] int32 digit sums over the rows of ``window``
    ([off, count] int32 on the inputs' device, read only by the kernel).

    The grid is :func:`plan_window`'s, fixed by the card and N, since the
    window is not known on the host.  One kernel launch a call, which
    writes the output whole.  The TPU probe's ``nb`` has no
    counterpart: it sets nothing on the card."""
    n = _check(bin_words, digits, window, num_features, max_bin)
    dev = bin_words.device
    if dev.type != "cuda":
        return window_digit_histogram_plain(bin_words, digits, window,
                                            num_features, max_bin)
    p = card_plan(bin_words, digits, num_features, max_bin)
    matrix = _is_matrix(digits)
    out = torch.empty((num_features, leafhist.NUM_STREAMS, max_bin),
                      dtype=torch.int32, device=dev)
    partials = torch.empty((p.partials,), dtype=torch.int32, device=dev)
    err = _build.launch(
        dev, _lib().lgbt_window_digit_histogram, bin_words.data_ptr(), n,
        None if matrix else digits.data_ptr(), n,
        digits.data_ptr() if matrix else None, window.data_ptr(), n,
        num_features, max_bin, p.chunks, p.threads, partials.data_ptr(),
        out.data_ptr())
    if err != 0:
        raise LightGBMError(
            f"window_digit_histogram kernel launch failed: CUDA error {err}")
    with _count_lock:
        LAUNCHES["window_digit_histogram"] += 1
    return out
