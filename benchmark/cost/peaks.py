"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet at the full 700 W
power limit; the same values as the port's ``obs/devcaps.py`` ``h100``
row): 67e12 float32 operations a second outside the tensor cores and
3.35e12 bytes a second of HBM3.  A share of these peaks is stated with
the card's ``power.limit`` beside it."""

from __future__ import annotations

import subprocess

F32_OPS_PER_S = 67e12
BYTES_PER_S = 3.35e12


def least_seconds(nbytes: float, ops: float):
    """(the least time the chip needs for this work, the bound that rules:
    ``bytes`` or ``ops``)."""
    tb, to = nbytes / BYTES_PER_S, ops / F32_OPS_PER_S
    return (tb, "bytes") if tb >= to else (to, "ops")


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
            else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"
