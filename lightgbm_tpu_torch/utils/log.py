"""Leveled logger gated by ``verbose`` (the JAX package's utils/log.py,
which follows the reference include/LightGBM/utils/log.h).

``enable_stdlib_bridge()`` mirrors every record into a stdlib
``logging.Logger`` at its mapped level, whatever ``set_verbosity`` says,
so an embedder routes, filters and formats with its own handlers; the
``verbose`` gate controls only the print to stderr.
"""

from __future__ import annotations

import sys
from typing import Set

_current_level = 1
_warned_once: Set[str] = set()

_bridge_logger = None
# stderr tag -> stdlib logging level
_STDLIB_LEVELS = {"Fatal": 50, "Warning": 30, "Info": 20, "Debug": 10}


def set_verbosity(verbose: int) -> None:
    global _current_level
    _current_level = int(verbose)


def enable_stdlib_bridge(name: str = "lightgbm_tpu_torch"):
    """Mirror every record into ``logging.getLogger(name)`` and return
    that logger.  The bridge forwards each record at its mapped level
    whatever ``set_verbosity`` says: filtering is the embedder's."""
    global _bridge_logger
    import logging
    _bridge_logger = logging.getLogger(name)
    return _bridge_logger


def disable_stdlib_bridge() -> None:
    global _bridge_logger
    _bridge_logger = None


def _emit(tag: str, level: int, msg: str, *args) -> None:
    bridge = _bridge_logger
    if bridge is None and level > _current_level:
        return
    text = msg % args if args else msg
    if bridge is not None:
        bridge.log(_STDLIB_LEVELS.get(tag, 20), "%s", text)
    if level <= _current_level:
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


def reset_warn_once(prefix: str = "") -> None:
    """Forget the warn_once history; with a ``prefix``, only the keys
    that start with it (``diskguard.reset_disabled`` re-arms the
    per-sink warnings so a re-armed sink's next failure is named
    again)."""
    if prefix:
        for key in [k for k in _warned_once if k.startswith(prefix)]:
            _warned_once.discard(key)
    else:
        _warned_once.clear()


def inc(name: str, n: int = 1) -> None:
    """Add ``n`` to the named counter of the process registry
    (``obs/registry.py``; the JAX package's ``obs.inc``:
    ``forest_quantize_fallback``, ``linear_fallback_total``)."""
    from ..obs import registry
    registry.inc(name, n)


def counter(name: str) -> int:
    from ..obs import registry
    return registry.get_counter(name)


class LightGBMError(Exception):
    """Raised where the reference would Log::Fatal."""


def fatal(msg: str, *args) -> None:
    text = msg % args if args else msg
    if _bridge_logger is not None:
        _bridge_logger.log(_STDLIB_LEVELS["Fatal"], "%s", text)
    raise LightGBMError(text)
