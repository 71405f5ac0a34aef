"""Memory policy of training: the ``memory_policy`` values and the degrade
note.

Port of the parts of the JAX package's utils/resource.py that the
histogram-pool bound reads (``MEMORY_POLICIES``, ``check_memory_policy``
and the ``note_degrade`` warning text).  The JAX package's admission
gate against the device budget (``MemoryBudgetExceeded``, ``refuse``),
its other degrade steps and its obs counters are not ported.
"""

from __future__ import annotations

from . import log
from .log import LightGBMError

MEMORY_POLICIES = ("fail_fast", "degrade")


def check_memory_policy(policy: str) -> str:
    policy = str(policy or "fail_fast")
    if policy not in MEMORY_POLICIES:
        raise LightGBMError(
            f"Unknown memory_policy {policy!r} "
            f"(expected one of {', '.join(MEMORY_POLICIES)})")
    return policy


def note_degrade(step: str, saved_bytes: int, detail: str) -> None:
    """Warn once per process about one applied degrade step."""
    log.warn_once(
        f"resource_degrade_{step}",
        "memory_policy=degrade: %s (saves ~%.1fMB). %s",
        step, saved_bytes / (1 << 20), detail)
