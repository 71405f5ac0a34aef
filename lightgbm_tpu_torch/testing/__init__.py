"""Fault injection (``faults``): the serving fleet, distributed ranks,
crash-safe training and the data boundary."""

from . import faults

__all__ = ["faults"]
