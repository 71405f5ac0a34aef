"""Device-memory watermarks from the CUDA caching allocator.

Port of the JAX package's obs/memwatch.py.  ``sample()`` reads
``torch.cuda.memory_stats(dev)`` of the card: the bytes allocated now
and their peak (``allocated_bytes.all.current`` / ``.peak``) and the
bytes the allocator holds reserved (``reserved_bytes.all.current``),
and publishes them as the ``memwatch_device_bytes_in_use``,
``memwatch_device_peak_bytes`` and ``memwatch_device_reserved_bytes``
gauges (with ``phase``, also ``memwatch_device_bytes_in_use_<phase>``).
A process without a card reports nothing.  The JAX version's live-array
walk (``jax.live_arrays``) has no counterpart: the allocator's own
count is what the port reads.

The switch is the JAX module's: the ``memwatch`` key or
``LIGHTGBM_TPU_MEMWATCH`` (the variable wins), resolved for each run by
``configure`` (``engine.train``, ``serve_from_config``).  While it is
on, ``obs.span`` samples at every span exit under the span's name, so
``memwatch_device_bytes_in_use_gbdt_iteration`` is a round's watermark.
``sample()`` also serves the device-OOM diagnosis
(``utils/resource.py``) whatever the switch.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch

from ..utils import coerce_bool as _coerce
from . import registry
from .prom import sanitize

ENV = "LIGHTGBM_TPU_MEMWATCH"

ENABLED = False


def enable(on: bool = True) -> None:
    global ENABLED
    ENABLED = bool(on)


def configure(flag: Any = None) -> bool:
    """The switch of a run: ``LIGHTGBM_TPU_MEMWATCH`` wins over the
    ``memwatch`` flag; neither disarms (each run's configuration holds).
    Returns the new state."""
    env = os.environ.get(ENV, "").strip()
    if env:
        enable(_coerce(env))
    else:
        enable(_coerce(flag) if flag is not None else False)
    return ENABLED


def reset_peak(device: Optional[torch.device] = None) -> None:
    """Restart the allocator's peak (``memwatch_device_peak_bytes``) at
    what is allocated now; nothing without a card."""
    if device is None:
        if not torch.cuda.is_available():
            return
        device = torch.device("cuda", torch.cuda.current_device())
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def sample(phase: Optional[str] = None,
           reg: Optional[registry.Registry] = None,
           device: Optional[torch.device] = None) -> Dict[str, int]:
    """One watermark sample of ``device`` (the current card by default):
    sets the gauges and returns them; empty without a card."""
    r = reg if reg is not None else registry.REGISTRY
    if device is None:
        if not torch.cuda.is_available():
            return {}
        device = torch.device("cuda", torch.cuda.current_device())
    if torch.device(device).type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    out: Dict[str, int] = {}
    for key, name in (("allocated_bytes.all.current", "device_bytes_in_use"),
                      ("allocated_bytes.all.peak", "device_peak_bytes"),
                      ("reserved_bytes.all.current",
                       "device_reserved_bytes")):
        if key in stats:
            out[name] = int(stats[key])
            r.set_gauge("memwatch_" + name, out[name])
    if phase and "device_bytes_in_use" in out:
        r.set_gauge("memwatch_device_bytes_in_use_" + sanitize(phase),
                    out["device_bytes_in_use"])
    return out
