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

The JAX package samples at every span exit when its ``memwatch`` key
is on; those hooks wait for the port's span tracer, and until then the
key is inert (``config.INERT``).  Here ``sample()`` serves the
device-OOM diagnosis (``utils/resource.py``) and the estimate check of
``chip_smoke.py``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from . import registry
from .prom import sanitize


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
