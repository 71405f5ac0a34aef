"""Disk-full-safe write sinks: a failed write is classified, counted and
named, and a whole-file write never leaves a torn file behind.

The port's own copy of the JAX package's utils/diskguard.py:

- :func:`classify_oserror` names the resource-exhaustion class of an
  ``OSError``: ``disk_full`` (ENOSPC), ``quota_exceeded`` (EDQUOT),
  ``read_only_fs`` (EROFS), ``fd_exhausted`` (EMFILE/ENFILE), and the
  catch-all ``io_error``.
- :class:`GuardedWriter` wraps a streaming text sink.  Its policy:
  ``disable`` (the default) warns once naming the sink, the path and the
  class, counts into ``sink_write_errors_total`` /
  ``sink_write_errors_<sink>`` and drops the sink's later writes for the
  rest of the run; ``fatal`` raises :class:`SinkWriteError`.  The
  ``sink_error_policy`` key sets the default of every sink that does not
  pin one (:func:`set_default_policy`).
- :func:`append_line` is the one-shot append; :func:`write_text` a whole
  text file that raises a classified error.
- :func:`write_file_atomic` is tmp + fsync + ``os.replace``: on any
  write error the ``.tmp`` is removed and the destination is left as it
  was (snapshots, the serving fleet's state file keep their last good
  file and retry on their next interval).
- :func:`artifact_write` / :func:`write_artifact_atomic`: writes whose
  failure fails the operation, as a named :class:`SinkWriteError` (the
  CLI's predict output streams in place; the model file and the binary
  dataset are replaced atomically, so a failed save keeps the previous
  file).
- :func:`probe_writable` tries a directory once.

Every guarded write passes through one hook (:func:`_maybe_inject`), so
``testing/faults.py`` ``fail_writes`` / ``disk_full_after`` raise real
``OSError`` s through the real call stacks.  Nothing here touches the
device.
"""

from __future__ import annotations

import errno
import os
from typing import Any, Callable, Dict, Optional, Set

from . import log
from .log import LightGBMError

#: errno -> resource-exhaustion class
ERRNO_CLASSES: Dict[int, str] = {
    errno.ENOSPC: "disk_full",
    errno.EDQUOT: "quota_exceeded",
    errno.EROFS: "read_only_fs",
    errno.EMFILE: "fd_exhausted",
    errno.ENFILE: "fd_exhausted",
}

POLICIES = ("disable", "fatal")

# the default of sinks that pin no policy (``sink_error_policy``)
_default_policy = "disable"

# sinks a classified error disabled for the rest of the process
_disabled_sinks: Set[str] = set()

# fault-injection seam (testing/faults.py): called with (path, nbytes)
# before every guarded write; raises to inject
_fault_hook: Optional[Callable[[str, int], None]] = None


class SinkWriteError(LightGBMError):
    """A guarded sink's write failed; carries the sink name, the path
    and the classification."""

    def __init__(self, sink: str, path: str, classification: str,
                 cause: BaseException):
        super().__init__(
            f"sink {sink!r} ({path}): {classification}: {cause} — "
            f"see docs/FAULT_TOLERANCE.md §Resource exhaustion")
        self.sink = str(sink)
        self.path = str(path)
        self.classification = str(classification)
        self.cause = cause


def classify_oserror(exc: BaseException) -> str:
    """The resource-exhaustion class of an ``OSError`` (``io_error`` for
    an errno without a named class)."""
    return ERRNO_CLASSES.get(getattr(exc, "errno", None) or -1, "io_error")


def set_default_policy(policy: Optional[str]) -> str:
    """Set the process default sink policy (``sink_error_policy``);
    ``None`` or empty keeps it.  Returns the effective default."""
    global _default_policy
    if policy:
        policy = str(policy)
        if policy not in POLICIES:
            raise LightGBMError(
                f"Unknown sink_error_policy {policy!r} "
                f"(expected one of {', '.join(POLICIES)})")
        _default_policy = policy
    return _default_policy


def default_policy() -> str:
    return _default_policy


def disabled_sinks() -> Set[str]:
    """The sinks a classified write error disabled (a copy)."""
    return set(_disabled_sinks)


def reset_disabled() -> None:
    """Re-arm every disabled sink and its warn-once key (a fresh run)."""
    _disabled_sinks.clear()
    log.reset_warn_once("sink_write_")


def _maybe_inject(path: str, nbytes: int) -> None:
    hook = _fault_hook
    if hook is not None:
        hook(str(path), int(nbytes))


def note_sink_error(sink: str, path: str, exc: BaseException,
                    action: str = "the sink is disabled for the rest "
                    "of this run — the job it observes continues") -> str:
    """Count and warn (once a sink) one classified write failure;
    returns the classification.  Callers with their own retry (the
    snapshots, the fleet's state file) report through it too."""
    cls = classify_oserror(exc)
    log.inc("sink_write_errors_total")
    log.inc("sink_write_errors_" + str(sink))
    log.warn_once(
        f"sink_write_{sink}",
        "sink %r (%s) hit %s (%s); %s (docs/FAULT_TOLERANCE.md "
        "§Resource exhaustion)", sink, path, cls, exc, action)
    return cls


class GuardedWriter:
    """A streaming text sink under a policy.  ``write()`` returns True
    when the text reached the OS, False once the sink is disabled."""

    def __init__(self, path: str, sink: str,
                 policy: Optional[str] = None, mode: str = "w",
                 buffering: int = 1):
        self.path = str(path)
        self.sink = str(sink)
        self.policy = policy or _default_policy
        if self.policy not in POLICIES:
            raise LightGBMError(
                f"Unknown sink policy {self.policy!r} for sink "
                f"{self.sink!r} (expected one of {', '.join(POLICIES)})")
        self._mode = mode
        self._buffering = buffering
        self._fh: Optional[Any] = None
        self._closed = False

    @property
    def disabled(self) -> bool:
        return self.sink in _disabled_sinks

    @property
    def closed(self) -> bool:
        return self._closed

    def _fail(self, exc: BaseException) -> bool:
        cls = note_sink_error(self.sink, self.path, exc)
        _disabled_sinks.add(self.sink)
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None
        if self.policy == "fatal":
            raise SinkWriteError(self.sink, self.path, cls, exc) from exc
        return False

    def _ensure_open(self) -> bool:
        if self._fh is not None:
            return True
        if self._closed or self.disabled:
            return False
        try:
            _maybe_inject(self.path, 0)
            directory = os.path.dirname(self.path)
            if directory:
                os.makedirs(directory, exist_ok=True)
            self._fh = open(self.path, self._mode,
                            buffering=self._buffering)
            return True
        except OSError as exc:
            return self._fail(exc)

    def touch(self) -> bool:
        """Create (or truncate) the file before the first record."""
        return self._ensure_open()

    def write(self, text: str) -> bool:
        if not self._ensure_open():
            return False
        try:
            _maybe_inject(self.path, len(text))
            self._fh.write(text)
            return True
        except OSError as exc:
            return self._fail(exc)

    def flush(self) -> bool:
        if self._fh is None:
            return False
        try:
            _maybe_inject(self.path, 0)
            self._fh.flush()
            return True
        except OSError as exc:
            return self._fail(exc)

    def close(self) -> None:
        self._closed = True
        if self._fh is None:
            return
        try:
            self._fh.close()
        except OSError as exc:
            self._fh = None
            self._fail(exc)
            return
        self._fh = None

    def __enter__(self) -> "GuardedWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def append_line(path: str, text: str, sink: str,
                policy: Optional[str] = None) -> bool:
    """Append one line to ``path`` (open, write, close).  False when the
    sink is disabled or the write failed under ``disable``."""
    policy = policy or _default_policy
    sink = str(sink)
    if sink in _disabled_sinks:
        return False
    try:
        _maybe_inject(str(path), len(text) + 1)
        with open(path, "a") as fh:
            fh.write(text + "\n")
        return True
    except OSError as exc:
        cls = note_sink_error(sink, str(path), exc)
        _disabled_sinks.add(sink)
        if policy == "fatal":
            raise SinkWriteError(sink, str(path), cls, exc) from exc
        return False


def write_text(path: str, text: str, sink: str) -> str:
    """Write a whole text file; a failure raises a classified
    :class:`SinkWriteError` (the caller owns the policy)."""
    try:
        _maybe_inject(str(path), len(text))
        with open(path, "w") as fh:
            fh.write(text)
        return str(path)
    except OSError as exc:
        cls = note_sink_error(sink, str(path), exc,
                              action="the write is abandoned")
        raise SinkWriteError(sink, str(path), cls, exc) from exc


def write_file_atomic(path: str, blob: bytes, sink: str,
                      fsync: bool = True) -> str:
    """tmp + fsync + ``os.replace``: a reader sees the previous file or
    the new one, never a torn one.  On any failure the ``.tmp`` is
    removed, the destination is left as it was, and the ``OSError``
    propagates (the caller classifies it)."""
    path = str(path)
    directory = os.path.dirname(path)
    if directory:
        os.makedirs(directory, exist_ok=True)
    tmp = path + ".tmp"
    try:
        _maybe_inject(tmp, len(blob))
        with open(tmp, "wb") as fh:
            fh.write(blob)
            fh.flush()
            if fsync:
                os.fsync(fh.fileno())
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def write_artifact_atomic(path: str, blob: bytes, sink: str) -> str:
    """An artifact written atomically (the model file): a failure is a
    named :class:`SinkWriteError` and the previous file survives."""
    with artifact_write(path, sink, mode="wb", atomic=True) as fh:
        fh.write(blob)
    return str(path)


class _ArtifactHandle:
    """File proxy of :func:`artifact_write`: every write passes the
    fault-injection seam."""

    def __init__(self, fh, path: str):
        self._fh = fh
        self._path = path

    def write(self, data) -> int:
        _maybe_inject(self._path, len(data))
        return self._fh.write(data)

    def __getattr__(self, name: str):
        return getattr(self._fh, name)


class artifact_write:
    """Context manager of a streaming artifact write whose failure fails
    the operation as a named, counted :class:`SinkWriteError`.
    ``atomic=False`` writes the destination in place (the CLI's predict
    output, whose partial rows are part of the diagnosis);
    ``atomic=True`` writes ``<path>.tmp`` and replaces the destination
    on a clean exit (the binary dataset)::

        with diskguard.artifact_write(path, "predict_output") as fh:
            fh.write(text)
    """

    def __init__(self, path: str, sink: str, mode: str = "w",
                 atomic: bool = False):
        self.path = str(path)
        self.sink = str(sink)
        self.mode = mode
        self.atomic = bool(atomic)
        self._target = self.path + ".tmp" if atomic else self.path
        self._fh = None

    def _raise(self, exc: OSError) -> None:
        if self.atomic:
            try:
                os.unlink(self._target)
            except OSError:
                pass
        cls = note_sink_error(
            self.sink, self.path, exc,
            action="the write is abandoned" +
                   ("; the previous file is kept" if self.atomic else
                    " — the operation fails with a named error"))
        raise SinkWriteError(self.sink, self.path, cls, exc) from exc

    def __enter__(self) -> _ArtifactHandle:
        try:
            _maybe_inject(self._target, 0)
            directory = os.path.dirname(self.path)
            if directory:
                os.makedirs(directory, exist_ok=True)
            self._fh = open(self._target, self.mode)
        except OSError as exc:
            self._raise(exc)
        return _ArtifactHandle(self._fh, self._target)

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._fh is None:
            return
        try:
            self._fh.close()
        except OSError as cexc:
            # the body's own error, if any, wins below
            if exc_type is None:
                self._raise(cexc)
        finally:
            self._fh = None
        if exc_type is not None:
            if isinstance(exc, OSError):
                self._raise(exc)
            if self.atomic:
                try:
                    os.unlink(self._target)
                except OSError:
                    pass
            return
        if self.atomic:
            try:
                os.replace(self._target, self.path)
            except OSError as rexc:
                self._raise(rexc)


def probe_writable(directory: str, sink: str) -> bool:
    """True when a probe file can be created in ``directory`` and
    removed; a classified failure warns once and returns False."""
    probe = os.path.join(str(directory), ".lgbt_write_probe")
    try:
        os.makedirs(str(directory), exist_ok=True)
        _maybe_inject(probe, 1)
        with open(probe, "w") as fh:
            fh.write("x")
        os.unlink(probe)
        return True
    except OSError as exc:
        note_sink_error(sink, str(directory), exc)
        return False
