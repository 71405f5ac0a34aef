"""Leveled logger gated by ``verbose`` (the JAX package's utils/log.py,
which follows the reference include/LightGBM/utils/log.h)."""

from __future__ import annotations

import sys
from typing import Dict, Set

_current_level = 1
_warned_once: Set[str] = set()


def set_verbosity(verbose: int) -> None:
    global _current_level
    _current_level = int(verbose)


def _emit(tag: str, level: int, msg: str, *args) -> None:
    if level <= _current_level:
        text = msg % args if args else msg
        print(f"[LightGBM-TPU-torch] [{tag}] {text}", file=sys.stderr,
              flush=True)


def debug(msg: str, *args) -> None:
    _emit("Debug", 2, msg, *args)


def info(msg: str, *args) -> None:
    _emit("Info", 1, msg, *args)


def warning(msg: str, *args) -> None:
    _emit("Warning", 0, msg, *args)


def warn_once(key: str, msg: str, *args) -> None:
    """``warning(msg, *args)`` the first time ``key`` is seen in this
    process; repeats are dropped."""
    if key in _warned_once:
        return
    _warned_once.add(key)
    warning(msg, *args)


_counters: Dict[str, int] = {}


def inc(name: str, n: int = 1) -> None:
    """Add ``n`` to the named process-wide counter (the JAX package's
    ``obs.inc``: ``forest_quantize_fallback``, ``linear_fallback_total``)."""
    _counters[name] = _counters.get(name, 0) + int(n)


def counter(name: str) -> int:
    return _counters.get(name, 0)


class LightGBMError(Exception):
    """Raised where the reference would Log::Fatal."""


def fatal(msg: str, *args) -> None:
    raise LightGBMError(msg % args if args else msg)
