"""Device-memory admission and device-OOM diagnosis.

Port of the JAX package's utils/resource.py.  Two halves, both on the
host:

**Admission** (``models/gbdt.py`` ``_check_memory_budget``): the booster
hands its per-component estimate (``estimate_train_memory``) and the
card's budget here.  Under ``memory_policy=fail_fast`` an estimate over
the budget is refused before training allocates, with a
:class:`MemoryBudgetExceeded` carrying the component table (:func:`refuse`).
Under ``memory_policy=degrade`` the booster walks the ladder
:data:`DEGRADE_STEPS`, each applied step noted once with a warning and
the ``resource_degrade_total`` / ``resource_degrade_<step>`` counters of
``obs/registry.py`` (:func:`note_degrade`), and refuses only when the
ladder ends still over the budget.

**OOM diagnosis** (:func:`oom_guard`): the JAX package routes every
jitted program through one dispatch that calls :func:`reraise_if_oom`;
the port has no such dispatch, so each named unit of work (``train_step``,
``train_gradients``, ``score_update``, the valid-set replay, ``bag_mask``,
``linear_fit``, the K4 predict) runs inside ``oom_guard(program,
shapes)``.  A CUDA allocation failure escaping it becomes a
:class:`DeviceOOM` naming the program, the shapes of its inputs, a
memwatch line of what the card held and the last admission table;
anything else passes through untouched.  The same guard is the seam of
device-time attribution: with ``devprof`` on, the unit runs inside one
``obs/devprof.py`` ``dispatch`` under the JAX program name ``profile``
(default: ``program``) on ``device``.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

from ..obs import devprof
from . import log
from .log import LightGBMError

#: the degrade ladder's steps, in the order they are applied
DEGRADE_STEPS = ("score_donation", "hist_cache", "row_pad")

MEMORY_POLICIES = ("fail_fast", "degrade")

# the last admission table a memory gate published: the OOM diagnosis
# shows what the gate predicted beside what the allocator saw
_budget_table: Optional[Dict[str, int]] = None
_budget_context: str = ""


class MemoryBudgetExceeded(LightGBMError):
    """The admission gate refused a configuration: its estimated device
    footprint is over the budget (after the degrade ladder, under
    ``memory_policy=degrade``).  ``estimate`` / ``limit`` /
    ``steps_taken`` are the table, the budget and the steps applied."""

    def __init__(self, msg: str, estimate: Dict[str, int], limit: int,
                 steps_taken: Tuple[str, ...] = ()):
        super().__init__(msg)
        self.estimate = dict(estimate)
        self.limit = int(limit)
        self.steps_taken = tuple(steps_taken)


class DeviceOOM(LightGBMError):
    """A named unit of device work died in a CUDA allocation: raised by
    :func:`reraise_if_oom` with the program name, its input shapes, a
    memwatch line and the last admission table."""

    def __init__(self, msg: str, program: str, shapes: str):
        super().__init__(msg)
        self.program = str(program)
        self.shapes = str(shapes)


def format_table(est: Dict[str, int]) -> str:
    """A per-component byte table as one line:
    ``bins_device=12.0MB, histogram_cache=340.0MB, ... (total=400.0MB)``."""
    parts = [f"{k}={v / (1 << 20):.1f}MB" for k, v in est.items()
             if k != "total"]
    return (", ".join(parts)
            + f" (total={est.get('total', 0) / (1 << 20):.1f}MB)")


def set_budget_table(est: Optional[Dict[str, int]],
                     context: str = "") -> None:
    """Publish the latest admission estimate for the OOM diagnosis;
    ``None`` clears it."""
    global _budget_table, _budget_context
    _budget_table = dict(est) if est else None
    _budget_context = str(context)


def budget_table() -> Optional[Dict[str, int]]:
    return dict(_budget_table) if _budget_table else None


def check_memory_policy(policy: str) -> str:
    policy = str(policy or "fail_fast")
    if policy not in MEMORY_POLICIES:
        raise LightGBMError(
            f"Unknown memory_policy {policy!r} "
            f"(expected one of {', '.join(MEMORY_POLICIES)})")
    return policy


def note_degrade(step: str, saved_bytes: int, detail: str) -> None:
    """Account one applied degrade step: one warning a step a process,
    and the ``resource_degrade_total`` / ``resource_degrade_<step>``
    counters."""
    from .. import obs
    if step not in DEGRADE_STEPS:
        raise ValueError(f"unknown degrade step {step!r}")
    obs.inc("resource_degrade_total")
    obs.inc("resource_degrade_" + step)
    log.warn_once(
        f"resource_degrade_{step}",
        "memory_policy=degrade: %s (saves ~%.1fMB). %s",
        step, saved_bytes / (1 << 20), detail)


def refuse(est: Dict[str, int], limit: int, what: str,
           steps_taken: Tuple[str, ...] = ()) -> "MemoryBudgetExceeded":
    """The named admission refusal with the component table (the caller
    raises it); the JAX package's text."""
    tried = (f"  Degrade ladder already applied: "
             f"{', '.join(steps_taken)}." if steps_taken else "")
    return MemoryBudgetExceeded(
        f"estimated {what} memory {est['total'] / (1 << 20):.0f}MB "
        f"exceeds the device budget {limit / (1 << 20):.0f}MB "
        f"({format_table(est)}).{tried}  The dense-only design has no "
        f"sparse spill (SURVEY §7.2): shrink num_leaves/max_bin or "
        f"train on fewer rows (memory_policy=degrade walks the "
        f"footprint-reduction ladder first; docs/FAULT_TOLERANCE.md "
        f"§Resource exhaustion).",
        est, limit, steps_taken)


# ---------------------------------------------------------------------------
# device-OOM classification and diagnosis

#: the text of a CUDA allocation failure that reaches Python as a plain
#: ``RuntimeError`` (the caching allocator's and the CUDA runtime's)
_OOM_MARKERS = ("CUDA out of memory", "CUDA error: out of memory")


def is_resource_exhausted(exc: BaseException) -> bool:
    """True for a device or host allocation failure:
    ``torch.OutOfMemoryError``, a ``RuntimeError`` saying ``CUDA out of
    memory``, or ``MemoryError``.  An ``OSError`` (a full disk) or any
    other error is not one."""
    if isinstance(exc, MemoryError):
        return True
    if isinstance(exc, torch.OutOfMemoryError):
        return True
    return isinstance(exc, RuntimeError) and any(
        m in str(exc) for m in _OOM_MARKERS)


def _memwatch_snapshot() -> str:
    """One line of what the card held, for the diagnosis; it never
    raises its own error."""
    try:
        from ..obs import memwatch
        s = memwatch.sample()
    except Exception:  # noqa: BLE001 - a diagnosis must not fail
        return "memwatch unavailable"
    parts: List[str] = []
    for key, label in (("device_bytes_in_use", "device_in_use"),
                       ("device_peak_bytes", "device_peak"),
                       ("device_reserved_bytes", "device_reserved")):
        if key in s:
            parts.append(f"{label}={s[key] / (1 << 20):.1f}MB")
    return " ".join(parts) or "memwatch saw no device stats"


def _shape_token(x: Any) -> str:
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is None or dtype is None:
        return repr(x)[:24]
    name = str(dtype).replace("torch.", "")
    kind = ("f" if name.startswith(("float", "bfloat")) else
            "b" if name == "bool" else
            "u" if name.startswith("uint") else "i")
    bits = getattr(x, "element_size", lambda: dtype.itemsize)() * 8
    return f"{kind}{bits}[{','.join(str(int(d)) for d in shape)}]"


def render_shapes(*tensors: Any, limit: int = 16) -> str:
    """The JAX diagnosis's shape signature of a call's inputs:
    ``f32[1000000], u8[28,1000000]`` (``None`` entries dropped)."""
    parts = [_shape_token(t) for t in tensors if t is not None]
    if len(parts) > limit:
        parts = parts[:limit] + [f"+{len(parts) - limit} more"]
    return ", ".join(parts)


def reraise_if_oom(exc: BaseException, program: str, shapes: str) -> None:
    """If ``exc`` is an allocation failure, raise it as a
    :class:`DeviceOOM` naming ``program``, ``shapes``, a memwatch line and
    the last admission table; otherwise return (the caller re-raises
    the original)."""
    if not is_resource_exhausted(exc):
        return
    from .. import obs
    from ..obs.prom import sanitize
    obs.inc("device_oom_total")
    obs.inc("device_oom_" + sanitize(program))
    table = ("admission estimate: " + format_table(_budget_table)
             + (f" [{_budget_context}]" if _budget_context else "")
             if _budget_table else
             "admission estimate: none published (prediction-only or "
             "pre-gate allocation)")
    first = (str(exc).splitlines() or [type(exc).__name__])[0][:300]
    raise DeviceOOM(
        f"device out of memory while dispatching program "
        f"{program!r} over shapes [{shapes}].  {table}.  "
        f"memwatch: {_memwatch_snapshot()}.  The allocator said: {first}.  "
        f"Shrink num_leaves/max_bin/rows, or set memory_policy=degrade "
        f"to let the admission gate walk the footprint ladder "
        f"(docs/FAULT_TOLERANCE.md §Resource exhaustion).",
        program, shapes) from exc


#: ``testing.faults.oom_on_program`` arms this: program -> its stats
#: (``fired`` of ``times``)
_injected: Dict[str, Dict[str, int]] = {}


@contextlib.contextmanager
def oom_guard(program: str, shapes: Any = "", device=None,
              profile: Optional[str] = None,
              bucket: Optional[int] = None) -> Iterator[None]:
    """Run a named unit of device work: an allocation failure escaping
    it is raised as a :class:`DeviceOOM` (:func:`reraise_if_oom`), any
    other error passes through untouched.  ``shapes`` is the rendered
    signature or a callable that renders it (called only on failure).
    A guarded unit commits nothing before it returns, so the booster
    trains on after a ``DeviceOOM``.  With ``devprof`` on the unit is
    one profiled dispatch of ``profile`` (default ``program``) on
    ``device`` (a serving bucket's under ``devprof.bucket_scope(
    bucket)``); off, that costs one attribute read."""
    try:
        armed = _injected.get(program)
        if armed is not None and armed["fired"] < armed["times"]:
            armed["fired"] += 1
            from ..testing.faults import make_resource_exhausted
            raise make_resource_exhausted(program)
        if devprof.ENABLED:
            with devprof.bucket_scope(bucket), \
                    devprof.dispatch(profile or program, device):
                yield
        else:
            yield
    except Exception as exc:
        if is_resource_exhausted(exc):
            reraise_if_oom(exc, program,
                           shapes() if callable(shapes) else str(shapes))
        raise
