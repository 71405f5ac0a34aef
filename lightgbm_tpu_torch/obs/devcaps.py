"""Per-device capability table for roofline attribution.

The port's counterpart of the JAX package's obs/devcaps.py.
``devprof`` (obs/devprof.py) turns sampled per-program device times
into percent-of-roofline gauges; that needs the peak operation rate and
memory bandwidth of the device running.  This module is that table,
small, static and overridable:

- the ``h100`` row is 67e12 f32 operations/s and 3.35e12 B/s, the f32
  CUDA-core peak and the HBM3 bandwidth of an H100 SXM.  The port's
  kernels use no tensor cores (int32 and f32 adds, compares and
  selects), so the f32 CUDA-core peak is the right comparator, not the
  dense-matmul one.  ``chip_smoke.py``'s ``bound_ms`` uses the same two
  numbers.  ``torch.cuda.get_device_name`` ("NVIDIA H100 80GB HBM3")
  selects the row by the longest lowercase substring;
- the TPU rows are the JAX table's, kept so the readers of a JAX run's
  files resolve its rows alike;
- the ``cpu`` row is the JAX table's nominal order of magnitude, not a
  measurement: it renders the roofline column on CPU runs;
- ``LIGHTGBM_TPU_PEAK_FLOPS`` / ``LIGHTGBM_TPU_PEAK_BYTES_PER_SEC``
  override both numbers for any device.

``roofline_pct`` is a comparative instrument: the sampled times are
times charged to a program (device gaps inside it included, see
obs/devprof.py), and the port's byte counts are what its kernels must
move, not what the whole program moves.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

ENV_PEAK_FLOPS = "LIGHTGBM_TPU_PEAK_FLOPS"
ENV_PEAK_BYTES = "LIGHTGBM_TPU_PEAK_BYTES_PER_SEC"

# device name substring (lowercase) -> (peak operations/s, peak memory
# bytes/s) per device.  Longest match wins, so "tpu v5p" beats "tpu v5".
_TABLE: Dict[str, tuple] = {
    "tpu v2": (45.0e12, 700.0e9),
    "tpu v3": (123.0e12, 900.0e9),
    "tpu v4": (275.0e12, 1228.0e9),
    "tpu v5 lite": (197.0e12, 819.0e9),
    "tpu v5e": (197.0e12, 819.0e9),
    "tpu v5p": (459.0e12, 2765.0e9),
    "tpu v5": (459.0e12, 2765.0e9),
    "tpu v6e": (918.0e12, 1640.0e9),
    # f32 CUDA-core peak and HBM3 bandwidth (H100 SXM)
    "h100": (67.0e12, 3.35e12),
    # nominal host order of magnitude, NOT a measurement
    "cpu": (1.0e11, 2.0e10),
}


def _env_float(name: str) -> Optional[float]:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return None
    try:
        v = float(raw)
    except ValueError:
        from ..utils import log
        log.warning("%s=%r is not a number; ignoring", name, raw)
        return None
    return v if v > 0 else None


def _describe(device: Any):
    """(platform, device name) of a torch device, a device string or
    index, or of the current card (the CPU without one)."""
    import torch
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if torch.cuda.is_available() else torch.device("cpu"))
    elif not isinstance(device, torch.device):
        device = torch.device(device)
    if device.type == "cuda":
        index = device.index if device.index is not None \
            else torch.cuda.current_device()
        return "gpu", str(torch.cuda.get_device_name(index))
    return device.type, device.type


def capabilities(device: Any = None) -> Dict[str, Any]:
    """Capability row of ``device`` (default: the current card, else the
    CPU): ``{"platform", "device_kind", "peak_flops",
    "peak_bytes_per_sec", "source"}``.  ``source`` says where the peaks
    came from (``env`` / ``table`` / ``unknown``); an unknown device gets
    None peaks rather than a guess."""
    platform, kind = _describe(device)
    flops = bw = None
    source = "unknown"
    key = kind.lower()
    best = ""
    for sub in _TABLE:
        if sub in key and len(sub) > len(best):
            best = sub
    if not best and platform.lower() in _TABLE:
        best = platform.lower()
    if best:
        flops, bw = _TABLE[best]
        source = "table"
    env_flops = _env_float(ENV_PEAK_FLOPS)
    env_bw = _env_float(ENV_PEAK_BYTES)
    if env_flops is not None or env_bw is not None:
        flops = env_flops if env_flops is not None else flops
        bw = env_bw if env_bw is not None else bw
        source = "env"
    return {"platform": platform, "device_kind": kind,
            "peak_flops": flops, "peak_bytes_per_sec": bw,
            "source": source}


def roofline(flops: Optional[float], bytes_accessed: Optional[float],
             seconds: float,
             caps: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Roofline math for one sampled execution (the JAX function's):

    - ``achieved_flops``: flops / seconds (None without a flop count);
    - ``roofline_pct``: 100 * (roofline-optimal time / measured time),
      the optimal time being ``max(flops/peak_flops,
      bytes/peak_bandwidth)``.

    A missing ingredient (no counts, unknown peaks, a non-positive
    measurement) gives None for the field it feeds."""
    if seconds is None or seconds <= 0.0:
        return {"achieved_flops": None, "roofline_pct": None}
    caps = caps if caps is not None else capabilities()
    achieved = (float(flops) / seconds) if flops else None
    peak_f = caps.get("peak_flops")
    peak_b = caps.get("peak_bytes_per_sec")
    bounds = []
    if flops and peak_f:
        bounds.append(float(flops) / float(peak_f))
    if bytes_accessed and peak_b:
        bounds.append(float(bytes_accessed) / float(peak_b))
    pct = (100.0 * max(bounds) / seconds) if bounds else None
    return {"achieved_flops": achieved, "roofline_pct": pct}
