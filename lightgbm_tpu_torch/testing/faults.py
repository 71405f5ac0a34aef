"""Fault injectors: make the failures the port claims to survive
happen, deterministically, through the real code paths.

The port's own copy of the JAX package's testing/faults.py.

Training rounds and bring-up:

- ``poison_gradients``: the objective emits NaN (or any value) for every
  gradient of a round, at an iteration, ``times`` times (``nan_policy``
  is what must contain it);
- ``fail_distributed_init``: ``torch.distributed.init_process_group``
  raises for the first calls (the rendezvous ``initialize_with_retry``
  must retry, then name).

Crash-safe training (``snapshot.py``, ``utils/diskguard.py``):

- ``torn_snapshot_write``: every snapshot write dies after N bytes of
  its ``.tmp``; ``truncate_file`` / ``flip_byte``: a committed file
  torn or bit-rotted afterwards;
- ``fail_writes`` / ``disk_full_after``: every guarded write (through
  diskguard's one hook) raises a real ``OSError`` (ENOSPC, EDQUOT,
  EROFS, EMFILE), at once or after a byte budget.

Ranks of a distributed learner (``parallel/watchdog.py``, the
consistency check): callback factories for ``engine.train``'s loop, each
gated on a rank:

- ``kill_rank``: SIGKILL at a round (the preempted worker);
- ``hang_rank``: a round blocks until its ``release`` event (alive, its
  heartbeats flowing, its collectives never arriving);
- ``delay_rank``: added latency (the straggler);
- ``corrupt_rank_state``: one rank's score buffer or newest tree
  silently changed after a round (the desync).

Serving, over the port's ``serve/fleet.py`` ``Replica``.  Each injector
is a context manager that patches one seam and restores it on exit:

- ``wedge_replica``: a replica's predict blocks until release (the hung
  device the watchdog's stall detector is for);
- ``poison_predict``: predict raises on one replica;
- ``slow_replica``: added service latency (the straggler);
- ``skew_predictions``: every replica of one model answers shifted by a
  constant (the silently wrong model only the quality gate can see);
- ``skew_features``: every row one model's replicas serve arrives with
  some feature columns shifted (upstream drift only the drift gate can
  localise);
- ``fail_warmup``: ``CompiledForest.warmup`` raises (a hot reload dying
  mid-warm);
- ``corrupt_model_file``: a truncated, footer-less or bit-rotted model
  file (``POST /reload`` must answer 400 and keep serving);
- ``oom_on_program``: the next dispatches of one named unit of device
  work die in an allocation failure (``make_resource_exhausted``), at the
  port's OOM guard (``utils/resource.py`` ``oom_guard``).

The predict injectors patch the replica's forest as well as its live
batcher, so the watchdog's synthetic probes see the fault the traffic
sees, and a probe succeeds only once the fault is lifted.

Data files, for the ingest guard (``io/guard.py``) and the two-round
loader (``io/streaming.py``); each returns the 1-based line numbers it
damaged, the ground truth the quarantine file is checked against:

- ``mangle_rows``: one feature field of a share of the rows replaced by
  an unparseable token;
- ``ragged_rows``: the last field of a share of the rows dropped or
  repeated;
- ``truncate_mid_row``: the file cut in the middle of its last row;
- ``concurrent_append``: rows appended while the two-round loader reads
  (its named drift error).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Iterator, Optional


class InjectedCrash(RuntimeError):
    """The error an injector raises where the real failure would."""


@contextlib.contextmanager
def poison_gradients(booster, at_iteration: int,
                     value: float = float("nan"),
                     times: int = 1) -> Iterator[object]:
    """Make the objective emit ``value`` for every gradient, ``times``
    times, from boosting iteration ``at_iteration`` (0-based, absolute
    ``iter_``) on.  Transient by default: one poisoned round, whose retry
    of the same iteration under ``nan_policy=skip_tree`` then grows from
    clean gradients; a large ``times`` is a persistently degenerate
    objective.

    Takes a ``basic.Booster`` or a ``models.gbdt.GBDT`` and wraps the
    instance's ``_gradients`` hook.  The port's round has no fused step
    (the JAX injector forces ``LGBT_NO_FUSED_STEP``): every round calls
    the hook."""
    gb = getattr(booster, "_booster", booster)
    orig = gb._gradients
    fired = [0]

    def poisoned_gradients():
        grad, hess = orig()
        if gb.iter_ >= at_iteration and fired[0] < times:
            fired[0] += 1
            import torch
            grad = torch.full_like(grad, value)
        return grad, hess

    gb._gradients = poisoned_gradients
    try:
        yield gb
    finally:
        gb.__dict__.pop("_gradients", None)


@contextlib.contextmanager
def fail_distributed_init(times: int = 1,
                          message: str = "injected coordinator connect "
                          "failure") -> Iterator[dict]:
    """Patch ``torch.distributed.init_process_group`` to raise
    ``RuntimeError`` for the first ``times`` calls; later calls succeed
    as recorded no-ops (one test process cannot bring up a real
    rendezvous).  Yields a stats dict: ``failed`` / ``succeeded`` call
    counts and the ``args`` and ``kwargs`` of every attempt."""
    import torch.distributed as dist

    stats = {"failed": 0, "succeeded": 0, "args": [], "kwargs": []}
    orig = dist.init_process_group

    def flaky_init(*args, **kwargs):
        stats["args"].append(args)
        stats["kwargs"].append(kwargs)
        if stats["failed"] < times:
            stats["failed"] += 1
            raise RuntimeError(message)
        stats["succeeded"] += 1

    dist.init_process_group = flaky_init
    try:
        yield stats
    finally:
        dist.init_process_group = orig


# ---------------------------------------------------------------------------
# snapshots and disk


@contextlib.contextmanager
def torn_snapshot_write(after_bytes: int = 64) -> Iterator[dict]:
    """Every ``snapshot.write_snapshot`` writes ``after_bytes`` bytes of
    its ``.tmp`` and dies (a preemption mid-checkpoint): no snapshot file
    is made or damaged.  Yields stats with the ``torn`` paths."""
    from .. import snapshot as snapmod

    stats = {"torn": []}
    orig = snapmod.write_snapshot

    def torn_write(path, state):
        blob = snapmod._encode(state)
        directory = os.path.dirname(path)
        if directory:
            os.makedirs(directory, exist_ok=True)
        with open(path + ".tmp", "wb") as fh:
            fh.write(blob[:max(int(after_bytes), 0)])
        stats["torn"].append(path)
        raise InjectedCrash(
            f"snapshot write to {path} torn after {after_bytes} bytes")

    snapmod.write_snapshot = torn_write
    try:
        yield stats
    finally:
        snapmod.write_snapshot = orig


def truncate_file(path: str, keep_bytes: Optional[int] = None) -> None:
    """Truncate ``path`` in place (default: to half its size)."""
    size = os.path.getsize(path)
    keep = size // 2 if keep_bytes is None else max(int(keep_bytes), 0)
    with open(path, "r+b") as fh:
        fh.truncate(keep)


def flip_byte(path: str, offset: int = -1) -> None:
    """XOR one byte of ``path`` (default the last: past every header
    field), bit rot under a valid length."""
    with open(path, "r+b") as fh:
        fh.seek(0, os.SEEK_END)
        size = fh.tell()
        pos = offset if offset >= 0 else size + offset
        fh.seek(pos)
        b = fh.read(1)
        fh.seek(pos)
        fh.write(bytes([b[0] ^ 0xFF]))


def _install_write_hook(hook) -> None:
    from ..utils import diskguard
    if diskguard._fault_hook is not None:
        raise RuntimeError("a diskguard fault hook is already installed")
    diskguard._fault_hook = hook


def _remove_write_hook() -> None:
    from ..utils import diskguard
    diskguard._fault_hook = None


@contextlib.contextmanager
def fail_writes(errno_code: int, path_glob: str = "*",
                armed: bool = True) -> Iterator[dict]:
    """Every guarded write to a path matching ``path_glob`` raises a real
    ``OSError(errno_code)`` while ``stats["armed"]`` holds (start with
    ``armed=False`` and set it from a callback to strike mid-run).
    Yields stats: ``fired``, ``paths`` and ``armed``."""
    import fnmatch
    stats = {"fired": 0, "paths": [], "armed": bool(armed)}

    def hook(path: str, nbytes: int) -> None:
        if stats["armed"] and fnmatch.fnmatch(path, path_glob):
            stats["fired"] += 1
            stats["paths"].append(path)
            raise OSError(int(errno_code), os.strerror(int(errno_code)),
                          path)

    _install_write_hook(hook)
    try:
        yield stats
    finally:
        _remove_write_hook()


@contextlib.contextmanager
def disk_full_after(n_bytes: int, path_glob: str = "*") -> Iterator[dict]:
    """The disk takes ``n_bytes`` more guarded writes (to paths matching
    ``path_glob``), then every write raises ENOSPC.  Yields stats:
    ``written``, ``fired``, ``budget``."""
    import errno
    import fnmatch
    stats = {"written": 0, "fired": 0, "budget": int(n_bytes)}

    def hook(path: str, nbytes: int) -> None:
        if not fnmatch.fnmatch(path, path_glob):
            return
        if stats["written"] + int(nbytes) > stats["budget"]:
            stats["fired"] += 1
            raise OSError(errno.ENOSPC, os.strerror(errno.ENOSPC), path)
        stats["written"] += int(nbytes)

    _install_write_hook(hook)
    try:
        yield stats
    finally:
        _remove_write_hook()


# ---------------------------------------------------------------------------
# ranks of a distributed learner: callbacks of engine.train's loop


def _this_rank() -> int:
    from ..parallel.multihost import process_rank_world
    return process_rank_world()[0]


def _rank_matches(rank: Optional[int]) -> bool:
    return rank is None or int(rank) == _this_rank()


def kill_rank(at_iteration: int, rank: Optional[int] = None):
    """Before-round callback: SIGKILL this process when round
    ``at_iteration`` begins on ``rank`` (None: any rank).  The other
    ranks wait in that round's collectives until the watchdog aborts
    them."""
    import signal

    def cb(env):
        if env.iteration >= int(at_iteration) and _rank_matches(rank):
            os.kill(os.getpid(), signal.SIGKILL)
    cb.before_iteration = True
    cb.order = -99
    return cb


def hang_rank(at_iteration: int, rank: Optional[int] = None,
              hang_s: float = 3600.0):
    """Before-round callback: round ``at_iteration`` on ``rank`` blocks
    for ``hang_s`` or until ``cb.release`` is set; its heartbeats keep
    flowing, so the peers' round deadline is what trips."""
    release = threading.Event()

    def cb(env):
        if env.iteration == int(at_iteration) and _rank_matches(rank):
            release.wait(float(hang_s))
    cb.before_iteration = True
    cb.order = -99
    cb.release = release
    return cb


def delay_rank(at_iteration: int, delay_s: float, times: int = 1,
               rank: Optional[int] = None):
    """Before-round callback: ``delay_s`` more latency on ``times``
    rounds from ``at_iteration`` on ``rank`` (the straggler; the answers
    stay right)."""
    fired = [0]

    def cb(env):
        if env.iteration >= int(at_iteration) and fired[0] < int(times) \
                and _rank_matches(rank):
            fired[0] += 1
            time.sleep(float(delay_s))
    cb.before_iteration = True
    cb.order = -99
    cb.fired = fired
    return cb


def corrupt_rank_state(at_iteration: int, rank: Optional[int] = None,
                       field: str = "score", scale: float = 2.0):
    """After-round callback: after round ``at_iteration``, silently
    corrupt ``rank``'s replicated state, which
    ``distributed_consistency_check`` must catch.  ``field``: ``score``
    adds ``scale`` to one element of the training score buffer, in place
    (every later gradient of that rank changes); ``tree`` scales the
    newest tree's leaf values."""
    if field not in ("score", "tree"):
        raise ValueError(f"corrupt_rank_state: unknown field {field!r}")
    fired = [False]

    def cb(env):
        if fired[0] or env.iteration < int(at_iteration) \
                or not _rank_matches(rank):
            return
        fired[0] = True
        gb = getattr(env.model, "_booster", env.model)
        if field == "score":
            gb.train_data.score[0, 0] += float(scale)
        elif gb._models:
            tree = gb._models[-1]
            tree.leaf_value = tree.leaf_value * float(scale)
    cb.order = 99
    cb.fired = fired
    return cb


def _find_replica(fleet, replica_id: int, model: str = "primary"):
    with fleet._cond:
        rs = fleet._primary if model == "primary" else fleet._canary
        if rs is None:
            raise ValueError(f"fleet has no {model!r} replica set")
        for rep in rs.replicas:
            if rep.replica_id == int(replica_id):
                return rep
    raise ValueError(f"no replica {replica_id} in {model!r}")


@contextlib.contextmanager
def _patched_predict(fleet, replica_id: int, wrap,
                     model: str = "primary") -> Iterator[dict]:
    """Shared plumbing: wrap ``replica.forest.batched_fn`` with ``wrap``
    (fault view for future batchers AND the watchdog's probes) and swap
    the live batcher's ``predict_fn`` to the same faulty callable (fault
    view for traffic already flowing).  Restores both on exit — but a
    batcher REPLACED meanwhile (ejection -> re-admission builds a fresh
    one from the forest) is left alone: it was built from the restored
    forest or will be on the next probe."""
    rep = _find_replica(fleet, replica_id, model)
    stats = {"replica": rep, "calls": 0}
    orig_batched_fn = rep.forest.batched_fn

    def faulty_batched_fn():
        inner = orig_batched_fn()

        def fn(rows):
            stats["calls"] += 1
            return wrap(inner, rows)
        return fn

    rep.forest.batched_fn = faulty_batched_fn
    patched_batcher = rep.batcher
    orig_predict_fn = patched_batcher.predict_fn
    patched_batcher.predict_fn = faulty_batched_fn()
    try:
        yield stats
    finally:
        del rep.forest.batched_fn          # instance attr -> class method
        if rep.batcher is patched_batcher:
            patched_batcher.predict_fn = orig_predict_fn


@contextlib.contextmanager
def wedge_replica(fleet, replica_id: int,
                  model: str = "primary") -> Iterator[dict]:
    """Wedge one replica: its device predict (traffic AND probes)
    blocks until the context exits — the hung-device failure the health
    watchdog's stall detector exists for.  On exit the wedge releases,
    so the next probe succeeds and the replica can be re-admitted.
    Yields a stats dict whose ``release`` event can lift the wedge
    early."""
    release = threading.Event()

    def wedged(inner, rows):
        release.wait()
        return inner(rows)

    with _patched_predict(fleet, replica_id, wedged, model) as stats:
        stats["release"] = release
        try:
            yield stats
        finally:
            release.set()


@contextlib.contextmanager
def poison_predict(fleet, replica_id: int, model: str = "primary",
                   error: Optional[BaseException] = None) -> Iterator[dict]:
    """Every predict on one replica raises (a poisoned compile, a
    device in a bad state).  Probes fail too, so the replica stays
    ejected until the context exits."""
    exc = error or InjectedCrash(
        f"injected predict poison on replica {replica_id}")

    def poisoned(inner, rows):
        raise exc

    with _patched_predict(fleet, replica_id, poisoned, model) as stats:
        stats["error"] = exc
        yield stats


@contextlib.contextmanager
def slow_replica(fleet, replica_id: int, delay_s: float,
                 model: str = "primary") -> Iterator[dict]:
    """One replica serves ``delay_s`` slower than it should — the
    straggler the EWMA latency-outlier rule is for.  Results stay
    correct; only time is poisoned."""
    def slowed(inner, rows):
        time.sleep(float(delay_s))
        return inner(rows)

    with _patched_predict(fleet, replica_id, slowed, model) as stats:
        stats["delay_s"] = float(delay_s)
        yield stats


@contextlib.contextmanager
def skew_predictions(fleet, offset: float,
                     model: str = "canary") -> Iterator[dict]:
    """Every prediction from EVERY replica of ``model`` comes back
    shifted by ``offset`` — the silently-wrong model (a mis-exported
    artifact, a feature-pipeline skew) that serves fast, errors never,
    and is purely WORSE.  Latency and error guardrails cannot see it;
    the labeled-feedback quality gate (rolling logloss/AUC,
    serve/lifecycle.py) is the one that must trip.  Results stay
    shaped/typed correctly; only the values are poisoned."""
    import numpy as np

    off = float(offset)

    def skewed(inner, rows):
        raw, out = inner(rows)
        return np.asarray(raw) + off, np.asarray(out) + off

    with fleet._cond:
        rs = fleet._primary if model == "primary" else fleet._canary
        if rs is None:
            raise ValueError(f"fleet has no {model!r} replica set")
        ids = [rep.replica_id for rep in rs.replicas]
    with contextlib.ExitStack() as stack:
        stats = {"offset": off, "replicas": ids, "per_replica": [
            stack.enter_context(_patched_predict(fleet, rid, skewed, model))
            for rid in ids]}
        yield stats


@contextlib.contextmanager
def skew_features(fleet, features, shift: float,
                  model: str = "canary") -> Iterator[dict]:
    """Every row served by every replica of ``model`` arrives with the
    ``features`` columns shifted by ``shift``: upstream feature-pipeline
    drift (a stale join, a units change) that predictions alone cannot
    localise.  The skewed rows flow through the real device path, so the
    forest's drift collector observes them as served traffic."""
    import numpy as np

    feats = [int(f) for f in features]
    off = float(shift)

    def skewed(inner, rows):
        rows = np.array(rows, copy=True)
        rows[:, feats] += off
        return inner(rows)

    with fleet._cond:
        rs = fleet._primary if model == "primary" else fleet._canary
        if rs is None:
            raise ValueError(f"fleet has no {model!r} replica set")
        ids = [rep.replica_id for rep in rs.replicas]
    with contextlib.ExitStack() as stack:
        stats = {"features": feats, "shift": off, "replicas": ids,
                 "per_replica": [
                     stack.enter_context(
                         _patched_predict(fleet, rid, skewed, model))
                     for rid in ids]}
        yield stats


@contextlib.contextmanager
def fail_warmup(times: int = 1) -> Iterator[dict]:
    """The next ``times`` ``CompiledForest.warmup`` calls raise — a hot
    reload crashing mid-warm on a replica device.  The reload contract
    under test: the serving generation and its predictions stay
    untouched (ModelManager.reload rolls back)."""
    from ..serve.forest import CompiledForest

    stats = {"failed": 0}
    orig = CompiledForest.warmup

    def failing_warmup(self, *args, **kwargs):
        if stats["failed"] < int(times):
            stats["failed"] += 1
            raise InjectedCrash(
                f"injected warmup failure ({stats['failed']}/{times})")
        return orig(self, *args, **kwargs)

    CompiledForest.warmup = failing_warmup
    try:
        yield stats
    finally:
        CompiledForest.warmup = orig


# ---------------------------------------------------------------------------
# data-file injectors: seeded mutators making exactly the dirt the
# ingest guard (io/guard.py) classifies


def _detect_delim(line: str) -> str:
    if "\t" in line:
        return "\t"
    if "," in line:
        return ","
    return " "


def mangle_rows(path: str, fraction: float = 0.05, seed: int = 0,
                token: str = "##garbage##", skip_header: bool = False
                ) -> list:
    """Replace one feature field of ~``fraction`` of the data rows with
    an unparseable token (the classic exporter bug: a stray string in a
    numeric column).  Returns the SORTED 1-based file line numbers
    mangled — the ground truth the quarantine sink is checked against."""
    import numpy as np

    with open(path, "r") as fh:
        lines = fh.read().splitlines()
    first = 1 if skip_header else 0
    data_idx = [i for i in range(first, len(lines)) if lines[i].strip()]
    k = max(1, int(round(fraction * len(data_idx))))
    rng = np.random.RandomState(seed)
    chosen = sorted(rng.choice(len(data_idx), size=min(k, len(data_idx)),
                               replace=False))
    mangled = []
    for c in chosen:
        i = data_idx[int(c)]
        delim = _detect_delim(lines[i])
        parts = lines[i].split(delim)
        parts[min(1, len(parts) - 1)] = token  # a feature, not the label
        lines[i] = delim.join(parts)
        mangled.append(i + 1)
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return mangled


def ragged_rows(path: str, fraction: float = 0.05, seed: int = 0,
                mode: str = "drop", skip_header: bool = False) -> list:
    """Drop (``mode="drop"``) or duplicate (``mode="add"``) the last
    field of ~``fraction`` of the data rows — the torn-write /
    schema-drift shape of dirt.  Returns sorted 1-based line numbers."""
    import numpy as np

    if mode not in ("drop", "add"):
        raise ValueError(f"ragged_rows: unknown mode {mode!r}")
    with open(path, "r") as fh:
        lines = fh.read().splitlines()
    first = 1 if skip_header else 0
    data_idx = [i for i in range(first, len(lines)) if lines[i].strip()]
    k = max(1, int(round(fraction * len(data_idx))))
    rng = np.random.RandomState(seed)
    chosen = sorted(rng.choice(len(data_idx), size=min(k, len(data_idx)),
                               replace=False))
    out = []
    for c in chosen:
        i = data_idx[int(c)]
        delim = _detect_delim(lines[i])
        parts = lines[i].split(delim)
        if mode == "drop" and len(parts) > 1:
            parts = parts[:-1]
        else:
            parts = parts + [parts[-1]]
        lines[i] = delim.join(parts)
        out.append(i + 1)
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return out


def truncate_mid_row(path: str) -> int:
    """Chop the file in the MIDDLE of its last data row (a torn
    write/partial download): the resulting final line is ragged or
    holds a half-number.  Returns the 1-based line number truncated."""
    with open(path, "rb") as fh:
        blob = fh.read()
    body = blob.rstrip(b"\n")
    last_nl = body.rfind(b"\n")
    last_line = body[last_nl + 1:]
    keep = last_nl + 1 + max(1, len(last_line) // 2)
    with open(path, "wb") as fh:
        fh.write(blob[:keep])
    return body[:last_nl + 1].count(b"\n") + 1


@contextlib.contextmanager
def concurrent_append(path: str, extra_text: str,
                      after_reads: int = 2) -> Iterator[dict]:
    """Append ``extra_text`` to ``path`` after its ``after_reads``-th
    full read pass (patching ``io/streaming.py``'s line reader): for the
    two-round loader (round 1a count, round 1b sample, round 2 fill) the
    default lands the append between rounds 1 and 2, a producer still
    writing the file.  The loader must refuse with its named drift
    ``LightGBMError``.  Yields ``completed`` read passes and the
    ``appended`` flag."""
    from ..io import streaming

    orig = streaming._numbered_data_lines
    state = {"completed": 0, "appended": False}

    def racing_lines(p, skip_header):
        if os.path.abspath(str(p)) == os.path.abspath(path):
            if state["completed"] >= int(after_reads) \
                    and not state["appended"]:
                state["appended"] = True
                with open(path, "a") as fh:
                    fh.write(extra_text)
            yield from orig(p, skip_header)
            state["completed"] += 1
        else:
            yield from orig(p, skip_header)

    streaming._numbered_data_lines = racing_lines
    try:
        yield state
    finally:
        streaming._numbered_data_lines = orig


def corrupt_model_file(path: str, mode: str = "truncate_tree") -> str:
    """Damage a saved model file the way real storage does:

    - ``"truncate_tree"``: chop the text mid-way through the last tree
      block (half-written upload);
    - ``"chop_footer"``: cut everything from the last ``Tree=`` on —
      whole trees missing AND no ``feature importances`` footer;
    - ``"garbage_field"``: replace the first ``leaf_value`` number with
      a non-numeric token (bit rot under a valid length).

    Returns a short description of what was done.  The loader contract
    under test: ``LightGBMError`` naming the damage — serve ``/reload``
    turns it into a clean 400, never a half-loaded forest."""
    with open(path, "r") as fh:
        text = fh.read()
    if mode == "truncate_tree":
        last = text.rfind("Tree=")
        if last < 0:
            raise ValueError(f"{path} has no Tree= blocks")
        cut = last + (len(text) - last) // 2
        out = text[:cut]
        what = f"truncated mid-tree at byte {cut}"
    elif mode == "chop_footer":
        last = text.rfind("Tree=")
        if last < 0:
            raise ValueError(f"{path} has no Tree= blocks")
        out = text[:last]
        what = f"chopped from last Tree= (byte {last})"
    elif mode == "garbage_field":
        if "leaf_value=" not in text:
            raise ValueError(f"{path} has no leaf_value section")
        out = text.replace("leaf_value=", "leaf_value=@@rot@@ ", 1)
        what = "first leaf_value poisoned with a non-numeric token"
    else:
        raise ValueError(f"corrupt_model_file: unknown mode {mode!r}")
    with open(path, "w") as fh:
        fh.write(out)
    return what


def make_resource_exhausted(program: str,
                            nbytes: int = 123456789) -> BaseException:
    """A device-OOM exception shaped like the real thing: the
    ``torch.OutOfMemoryError`` the caching allocator raises, with its
    text."""
    import torch
    return torch.OutOfMemoryError(
        f"CUDA out of memory. Tried to allocate {int(nbytes)} bytes. "
        f"(injected for program {program!r})")


@contextlib.contextmanager
def oom_on_program(program: str, times: int = 1) -> Iterator[dict]:
    """The next ``times`` runs of the unit named ``program`` (an
    ``oom_guard`` name: ``train_step``, ``train_gradients``,
    ``score_update``, ``valid_replay``, ``bag_mask``, ``linear_fit``,
    ``predict``) die in an allocation failure when their guard is
    entered, before any work of theirs: the late failure the admission
    gate cannot always predict.  It must surface as a named
    ``DeviceOOM``.  Yields stats with the ``fired`` count."""
    from ..utils import resource
    stats = {"fired": 0, "times": int(times)}
    prev = resource._injected.get(program)
    resource._injected[program] = stats
    try:
        yield stats
    finally:
        if prev is None:
            resource._injected.pop(program, None)
        else:
            resource._injected[program] = prev
