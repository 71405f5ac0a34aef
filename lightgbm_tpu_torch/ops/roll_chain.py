"""The roll/compare/select stage chain of a bitonic-style stable partition
(kernel P1).

Port of the JAX package's roll-chain probe ``tools/probe_roll.py``.  One
instance is a ``[WORDS, NB]`` int32 block: row 0 is the key, and all
``WORDS`` rows (the key included) are the words that move with it.  Each
of the ``STAGES`` stages rolls every row along the column axis by
``shift = 1 << (s % 7)``, so that ``rolled[:, i] = x[:, (i - shift) mod
NB]`` (``np.roll``'s direction), compares the rolled key with the key as
signed int32 (``rolled[0] < x[0]``) and, where that holds, takes the
rolled column: every row of a column moves together.

:func:`roll_chain` launches the hand-written kernel ``csrc/roll_chain.cu``
(which replaces the TPU kernel ``tools/probe_roll.py`` ``kernel``) for a
CUDA tensor, or raises; for a CPU tensor it runs :func:`roll_chain_plain`
(``torch.roll`` + ``torch.where``, stage for stage).  Both are exact
integer selects, so they agree bit for bit.  The kernel carries each
column's key and source column through the stages and gathers the 12
words once at the end (the stages compose into one permutation of the
columns).  Kernel launches are counted in :data:`LAUNCHES`;
:func:`empty_launches` gives the floor a launch stands on.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict

import torch

from ..obs import devprof
from ..utils.log import LightGBMError
from . import _build

STAGES = 28
WORDS = 12
NB = 2048

#: kernel launches per wrapper; reset with :func:`reset_launch_counts`
LAUNCHES: Dict[str, int] = {"roll_chain": 0}
_count_lock = threading.Lock()


def reset_launch_counts() -> None:
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def launch_counts() -> Dict[str, int]:
    with _count_lock:
        return dict(LAUNCHES)


def roll_chain_plain(x: torch.Tensor) -> torch.Tensor:
    """The stage chain on ``x`` [WORDS, NB] int32 in plain PyTorch."""
    words = x
    for s in range(STAGES):
        rolled = torch.roll(words, 1 << (s % 7), dims=1)
        words = torch.where((rolled[0] < words[0])[None, :], rolled, words)
    return words


def _check(x: torch.Tensor) -> None:
    if x.dtype != torch.int32 or x.shape != (WORDS, NB):
        raise LightGBMError(
            f"roll_chain: x is {tuple(x.shape)} {x.dtype}; expected "
            f"({WORDS}, {NB}) torch.int32")
    if not x.is_contiguous():
        raise LightGBMError("roll_chain: x must be contiguous")


def _lib():
    lib = _build.load("roll_chain")
    if lib.lgbt_roll_chain.argtypes is None:
        p = ctypes.c_void_p
        lib.lgbt_roll_chain.argtypes = [p, p, p]
        lib.lgbt_roll_chain.restype = ctypes.c_int
        lib.lgbt_empty_launches.argtypes = [ctypes.c_int, p]
        lib.lgbt_empty_launches.restype = ctypes.c_int
    return lib


def launch_cost(numel: int) -> int:
    """Bytes one P1 launch must move: the ``numel`` int32 input words
    read once and the output written once (``chip_smoke.py``'s
    ``bound_ms`` reads it)."""
    return 2 * numel * 4


def roll_chain(x: torch.Tensor) -> torch.Tensor:
    """The stage chain on ``x`` [WORDS, NB] int32 (contiguous) into a new
    tensor: the kernel on a card, the plain version on the CPU."""
    _check(x)
    if not x.is_cuda:
        return roll_chain_plain(x)
    out = torch.empty_like(x)
    err = _build.launch(x.device, _lib().lgbt_roll_chain, x.data_ptr(),
                        out.data_ptr())
    if err != 0:
        raise LightGBMError(
            f"roll_chain kernel launch failed: CUDA error {err}")
    with _count_lock:
        LAUNCHES["roll_chain"] += 1
    if devprof.ENABLED:
        devprof.add_bytes(launch_cost(x.numel()))
    return out


def empty_launches(device: torch.device, count: int = 1) -> None:
    """``count`` launches of an empty kernel on ``device``'s current
    stream, back to back from one C call (not counted): the floor under
    any launch of :func:`roll_chain`."""
    err = _build.launch(device, _lib().lgbt_empty_launches, count)
    if err != 0:
        raise LightGBMError(f"empty kernel launch failed: CUDA error {err}")
