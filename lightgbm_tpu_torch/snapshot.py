"""Crash-safe training snapshots: atomic, checksummed, bit-exact resume.

The port's own copy of the JAX package's snapshot.py.  A snapshot taken
every ``snapshot_freq`` rounds into ``snapshot_dir`` makes a dead run
recoverable: ``engine.train`` (and so the CLI) resumes from the newest
valid snapshot, and the resumed run equals an uninterrupted one:
train(N) == train(k) -> crash -> resume(N).

What a snapshot holds (``GBDT.snapshot_state`` and the subclass hooks):
the host trees (pickled ``Tree`` objects, their bin-space arrays
exact), the training and valid score buffers read from the device and
written back on resume (a replay of the trees would add in another
order), the bagging key with the live row mask and bag count, the
feature-fraction RNG, DART's drop RNG and tree weights, GOSS's key, the
screener's averages, the engine's ``evals_result`` and best iteration,
and the process registry (``obs``), so the counters stay cumulative.
A snapshot's payload pickles the port's own objects, so neither package
loads the other's; the file layer is the JAX package's.

File format (``write_snapshot``): ``MAGIC | payload_len (8 B LE) |
sha256(payload) | payload (pickle)``, written to ``<path>.tmp``, fsynced
and moved over ``<path>`` (``utils/diskguard.write_file_atomic``).
``read_snapshot`` returns None for a file that fails the magic, length,
checksum or unpickle check, and ``load_latest_snapshot`` walks the
directory newest first, skipping such a file with a warning that names
it (and a ``snapshot_corrupt_skipped_total`` count).

Several ranks: the state is replicated, so rank 0 alone writes
(``is_snapshot_writer``).  Each record carries a ``world`` block
(process count, rank, digest of the replicated state), and a resume of
more than one rank runs ``coordinated_resume``: the ranks agree on the
smallest iteration every rank holds a valid snapshot of and check that
they read byte-identical files.
"""

from __future__ import annotations

import contextlib
import copy
import hashlib
import os
import pickle
import re
from typing import Any, Dict, List, Optional, Tuple

from .utils import log

SNAPSHOT_MAGIC = b"LGBTSNAP\x01"
SNAPSHOT_VERSION = 1

_HEADER_LEN = len(SNAPSHOT_MAGIC) + 8 + 32
_FILE_RE = re.compile(r"^snapshot_(\d+)\.bin$")


# ---------------------------------------------------------------------------
# file layer


def snapshot_path(directory: str, rounds_done: int) -> str:
    return os.path.join(directory, f"snapshot_{int(rounds_done):010d}.bin")


def _encode(state: Dict[str, Any]) -> bytes:
    payload = pickle.dumps(state, protocol=pickle.HIGHEST_PROTOCOL)
    return (SNAPSHOT_MAGIC + len(payload).to_bytes(8, "little")
            + hashlib.sha256(payload).digest() + payload)


def write_snapshot(path: str, state: Dict[str, Any]) -> str:
    """Write ``state`` to ``path`` atomically: a crash at any byte leaves
    the previous file or a ``.tmp`` the reader ignores; a failed write
    removes the ``.tmp`` and raises the ``OSError``."""
    from .utils import diskguard
    return diskguard.write_file_atomic(path, _encode(state),
                                       sink="snapshot")


def read_snapshot(path: str) -> Optional[Dict[str, Any]]:
    """The state dict of one snapshot file, or None when it is missing,
    truncated, corrupt (checksum) or not a snapshot."""
    try:
        with open(path, "rb") as fh:
            blob = fh.read()
    except OSError:
        return None
    if len(blob) < _HEADER_LEN or not blob.startswith(SNAPSHOT_MAGIC):
        return None
    n = int.from_bytes(blob[len(SNAPSHOT_MAGIC):len(SNAPSHOT_MAGIC) + 8],
                       "little")
    digest = blob[len(SNAPSHOT_MAGIC) + 8:_HEADER_LEN]
    payload = blob[_HEADER_LEN:]
    if len(payload) != n or hashlib.sha256(payload).digest() != digest:
        return None
    try:
        state = pickle.loads(payload)
    except Exception:
        return None
    if not isinstance(state, dict) or "booster" not in state:
        return None
    return state


def list_snapshots(directory: str) -> List[Tuple[int, str]]:
    """``(rounds_done, path)`` of the snapshot files in ``directory``,
    newest first (existence only)."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    out = []
    for name in names:
        m = _FILE_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(directory, name)))
    out.sort(reverse=True)
    return out


def load_latest_snapshot(directory: str) \
        -> Optional[Tuple[str, Dict[str, Any]]]:
    """The newest snapshot in ``directory`` that passes validation, or
    None; a corrupt one is skipped with a warning that names it."""
    for _, path in list_snapshots(directory):
        state = read_snapshot(path)
        if state is not None:
            return path, state
        log.inc("snapshot_corrupt_skipped_total")
        log.warning("snapshot %s is corrupt or truncated; falling back "
                    "to an older snapshot", path)
    return None


def prune_snapshots(directory: str, keep: int) -> None:
    """Delete all but the newest ``keep`` snapshots (``keep <= 0``: none),
    and always sweep orphaned ``snapshot_*.bin.tmp`` files (a write that
    died before its replace)."""
    try:
        for name in os.listdir(directory):
            if _FILE_RE.match(name[:-4]) and name.endswith(".tmp"):
                with contextlib.suppress(OSError):
                    os.remove(os.path.join(directory, name))
    except OSError:
        pass
    if keep <= 0:
        return
    for _, path in list_snapshots(directory)[keep:]:
        with contextlib.suppress(OSError):
            os.remove(path)


# ---------------------------------------------------------------------------
# several ranks


def _rank_world() -> Tuple[int, int]:
    from .parallel.multihost import process_rank_world
    return process_rank_world()


def is_snapshot_writer() -> bool:
    """Rank 0 owns the snapshot directory: the state is replicated, and
    concurrent writers would race ``prune_snapshots`` and each other's
    ``.tmp`` files."""
    return _rank_world()[0] == 0


def replicated_state_digest(gb) -> str:
    """Hex fingerprint of a booster's replicated state, built from the
    desync detector's field digests (``GBDT._consistency_digests``)."""
    fields = gb._consistency_digests()
    blob = b"".join(k.encode() + int(v).to_bytes(8, "little")
                    for k, v in sorted(fields.items()))
    return hashlib.sha256(blob).hexdigest()


# ---------------------------------------------------------------------------
# booster capture / restore


def capture_booster_state(booster, rounds_done: int,
                          evals_result: Optional[dict] = None) \
        -> Dict[str, Any]:
    """The resumable state of a training ``Booster`` after
    ``rounds_done`` rounds of the engine's loop."""
    from . import obs
    gb = booster._booster
    obs_snap = obs.snapshot()
    rank, world = _rank_world()
    return {
        "version": SNAPSHOT_VERSION,
        "rounds_done": int(rounds_done),
        "world": {
            "num_processes": int(world),
            "rank": int(rank),
            "digest": (replicated_state_digest(gb) if world > 1 else ""),
        },
        "booster": gb.snapshot_state(),
        "evals_result": (copy.deepcopy(evals_result)
                         if evals_result else None),
        "best_iteration": int(booster.best_iteration),
        "obs_counters": obs_snap["counters"],
        "obs_state": {"counters": obs_snap["counters"],
                      "gauges": obs_snap["gauges"],
                      "histograms": obs_snap["histograms"]},
    }


def restore_booster_state(booster, state: Dict[str, Any]) -> int:
    """Restore a ``capture_booster_state`` snapshot onto a new ``Booster``
    of the same params and data; returns the rounds done."""
    from . import obs
    booster._booster.restore_state(state["booster"])
    booster.best_iteration = int(state.get("best_iteration", -1))
    obs_state = state.get("obs_state")
    if obs_state:
        obs.REGISTRY.restore(obs_state)
    elif state.get("obs_counters"):
        obs.REGISTRY.restore({"counters": state["obs_counters"]})
    return int(state.get("rounds_done", 0))


def save_snapshot(directory: str, booster, rounds_done: int,
                  evals_result: Optional[dict] = None,
                  keep: int = 0) -> Optional[str]:
    """Capture and write one snapshot, then keep the newest ``keep``.
    Returns the path, or None on a rank other than 0 and when the write
    failed (the last good snapshot is kept; the next interval retries)."""
    if not is_snapshot_writer():
        log.warn_once("snapshot_writer_rank",
                      "snapshots are written by rank 0 only (state is "
                      "replicated); this rank skips the write")
        return None
    state = capture_booster_state(booster, rounds_done, evals_result)
    path = snapshot_path(directory, rounds_done)
    try:
        write_snapshot(path, state)
    except OSError as exc:
        from .utils import diskguard
        diskguard.note_sink_error(
            "snapshot", path, exc,
            action="the last-good snapshot is kept; the write retries "
            "on the next snapshot_freq interval")
        prune_snapshots(directory, keep)
        return None
    prune_snapshots(directory, keep)
    return path


def coordinated_resume(directory: str) \
        -> Optional[Tuple[str, Dict[str, Any]]]:
    """The resume consensus of several ranks: each reports its newest
    valid snapshot, the pod takes the smallest, and each checks it read
    the byte-identical file.  Returns the same ``(path, state)`` on every
    rank, or None on every rank when any rank has none (a fresh start is
    the one state all can agree on).  One process: the plain
    ``load_latest_snapshot``."""
    rank, world = _rank_world()
    if world <= 1:
        return load_latest_snapshot(directory)
    from .parallel.watchdog import active_watchdog
    wd = active_watchdog()
    # a rank dying in the consensus' collectives becomes a bounded,
    # named abort, as in Comm::grow
    with (wd.guard("Dist::resume") if wd is not None
          else contextlib.nullcontext()):
        return _coordinated_resume_body(directory, rank, world)


def _coordinated_resume_body(directory: str, rank: int, world: int) \
        -> Optional[Tuple[str, Dict[str, Any]]]:
    import numpy as np

    from .parallel import comm
    found = load_latest_snapshot(directory)
    newest = -1 if found is None else int(found[1].get("rounds_done", 0))
    got = comm.allgather_host_array(np.int64(newest))
    agreed = int(got.min())
    if agreed < 0:
        if int(got.max()) >= 0:
            have = [i for i, v in enumerate(got) if int(v) >= 0]
            log.warning(
                "resume consensus: rank(s) %s hold snapshots but rank(s) "
                "%s hold none — snapshot_dir is not shared or was "
                "partially cleared; the pod starts FRESH (the only state "
                "every rank can agree on)", have,
                [i for i in range(len(got)) if i not in have])
        return None
    if agreed != newest:
        log.warning("resume consensus: this rank's newest snapshot holds "
                    "%d rounds but the pod agrees on %d; resuming from "
                    "the common iteration", newest, agreed)
    path = snapshot_path(directory, agreed)
    state = read_snapshot(path)
    if state is None:
        log.fatal("resume consensus agreed on %s but rank %d cannot read "
                  "it; clear snapshot_dir (or restore the file) and "
                  "restart the pod", path, rank)
    w = state.get("world") or {}
    if w and int(w.get("num_processes", world)) != world:
        log.fatal("snapshot %s was written by a %d-process run but this "
                  "pod has %d processes; the replicated state is only "
                  "meaningful at the same world size", path,
                  int(w["num_processes"]), world)
    with open(path, "rb") as fh:
        blob = fh.read()
    mine = np.frombuffer(hashlib.sha256(blob).digest()[:8], np.uint64)[0]
    digests = comm.allgather_host_array(np.uint64(mine))
    if int((digests != digests[0]).sum()):
        bad = [i for i, d in enumerate(digests)
               if int(d) != int(digests[0])]
        log.fatal("resume consensus: snapshot %s differs across ranks "
                  "(rank(s) %s hold different bytes than rank 0); refusing "
                  "to resume desynced — re-replicate the snapshot "
                  "directory and restart", path, bad)
    log.info("resume consensus: %d ranks agreed on %s (%d rounds done)",
             world, path, agreed)
    return path, state
