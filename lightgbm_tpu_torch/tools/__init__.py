"""Probe entry points: the port's counterparts of the JAX package's TPU
timing probes ``tools/probe_roll.py`` (P1) and ``tools/probe_dynhist.py``
(P2), which stay as the reference.

    python -m lightgbm_tpu_torch.tools.probe_roll [--device cpu]
    python -m lightgbm_tpu_torch.tools.probe_dynhist [--device cpu] [--rows N]

Each makes the JAX probe's inputs from ``np.random.RandomState(0)``, runs
its protocol on the card (the default device) and prints the JAX probe's
lines, then one JSON line with the same numbers.  Times on a card come
from CUDA events; on the CPU (``--device cpu``, the plain versions) from
the host clock, and the JSON line says which.
"""

from __future__ import annotations

import time
from typing import Callable, Tuple

import torch


def clock_name(dev: torch.device) -> str:
    return "cuda_events" if dev.type == "cuda" else "host"


def elapsed_ms(fn: Callable, dev: torch.device) -> Tuple[object, float]:
    """``fn()`` and its time in ms: CUDA events around it on a card (the
    work it enqueues, waited for), the host clock on the CPU."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def first_run_s(fn: Callable, dev: torch.device) -> Tuple[object, float]:
    """``fn()`` and its host seconds until its work is done: the first
    run, which includes building the kernel."""
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0
