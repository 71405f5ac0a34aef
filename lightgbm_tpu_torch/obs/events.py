"""Per-iteration structured JSONL event stream.

The port's copy of the JAX package's obs/events.py: one line per
boosting iteration, the same fields under the same names (``schema``,
``iter``, ``wall_s``, ``phases``, ``bag_cnt``, ``comm_bytes_cum``,
``comm_calls_cum``, ``trees``, ``eval``, and on an incident
``saturated``, ``discarded``, ``nan_poisoned`` / ``nan_policy``; ``rank``
under a multi-process run).  An iteration's fields come from several
producers:

- ``GBDT.train_one_iter`` notes the wall time, the bag count, the
  cumulative collective account and the grown trees' shapes (the trees
  the round already brought to the host: the stream adds no device
  read);
- the eval callback (``callback.log_telemetry``) notes the metric values
  after the engine evaluates the round.

The recorder therefore commits on advance: a record is written the
first time any field of a later iteration is noted, by when every
producer of the earlier one has run; ``close()`` writes what is still
pending.  (The JAX booster pipelines its rounds and notes a round's
trees during the next call; the port's rounds are synchronous, and the
records come out the same.)
"""

from __future__ import annotations

import json
import math
import os
from typing import Any, Dict, List

SCHEMA_VERSION = 1


def _json_default(o):
    """Producers hand over numpy scalars (tree depths, counts); coerce
    instead of burdening every call site."""
    if hasattr(o, "item"):
        return o.item()
    raise TypeError(f"Object of type {type(o).__name__} "
                    f"is not JSON serializable")


def _sanitize(v):
    """Non-finite metric values (nan auc on a one-class fold, inf loss)
    would serialize as bare NaN/Infinity tokens — valid for Python's
    json but rejected by strict consumers (jq, JSON.parse).  Map them to
    null; the record stays parseable everywhere."""
    if isinstance(v, float):
        return v if math.isfinite(v) else None
    if isinstance(v, dict):
        return {k: _sanitize(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_sanitize(x) for x in v]
    return v


class EventRecorder:
    """Append-only JSONL writer with per-iteration field merging.

    The sink is a ``diskguard.GuardedWriter`` (line-buffered, flushed
    every ``flush_every`` committed records — default every record), so
    (a) a crashed run keeps every record committed before the crash: the
    tail of exactly the iterations you need to debug the crash is on
    disk, not in a userspace buffer (pinned by
    tests/test_torch_events.py), and (b) a full disk mid-run disables
    the stream with one warning and a ``sink_write_errors_total`` count
    instead of crashing training from inside its own telemetry."""

    def __init__(self, path: str, flush_every: int = 1):
        self._path = str(path)
        self._flush_every = max(int(flush_every), 1)
        self._pending: Dict[int, Dict[str, Any]] = {}
        self._written = 0
        self._since_flush = 0
        # a multi-process run: every record carries this process's rank
        # (obs-report over the per-rank files can then name a
        # straggler) and the path a .rank<r> suffix, since every rank
        # gets the same events_file from the one conf and N ranks
        # opening one path with mode "w" would truncate each other
        from ..parallel.multihost import process_rank_world
        from ..utils.diskguard import GuardedWriter
        self._rank: Any = None
        rank, world = process_rank_world()
        if world > 1:
            self._rank = int(rank)
            root, ext = os.path.splitext(self._path)
            self._path = f"{root}.rank{rank}{ext or '.jsonl'}"
        # policy=None: honor the run's sink_error_policy (disable by
        # default; fatal for runs where lost telemetry is unacceptable).
        # Line-buffered only at the every-record cadence — with a
        # flush_every batch the block buffer is the point (one syscall
        # per cadence, not per record).
        self._fh = GuardedWriter(self._path, sink="events", policy=None,
                                 buffering=1 if self._flush_every == 1
                                 else -1)
        # eager create: readers (obs-report, tests) expect the stream
        # file to exist from the moment the run starts
        self._fh.touch()

    # -- producers -------------------------------------------------------
    def note(self, iteration: int, **fields: Any) -> None:
        """Merge ``fields`` into iteration ``iteration``'s record.  Dict
        fields (``eval``, ``phases``) merge key-wise so multiple producers
        can contribute; scalars are last-write-wins.  Noting any field for
        an iteration commits every pending record of earlier iterations."""
        it = int(iteration)
        rec = self._pending.setdefault(it, {})
        for key, value in fields.items():
            if isinstance(value, dict) and isinstance(rec.get(key), dict):
                rec[key].update(value)
            else:
                rec[key] = value
        for old in sorted(k for k in self._pending if k < it):
            self._commit(old)

    # -- sink ------------------------------------------------------------
    def _commit(self, it: int) -> None:
        rec = self._pending.pop(it)
        line = {"schema": SCHEMA_VERSION, "iter": it}
        if self._rank is not None:
            line["rank"] = self._rank
        line.update(rec)
        ok = self._fh.write(
            json.dumps(_sanitize(line), default=_json_default) + "\n")
        if not ok:
            return              # sink disabled (disk full): drop, run on
        self._written += 1
        self._since_flush += 1
        if self._since_flush >= self._flush_every:
            self._fh.flush()
            self._since_flush = 0

    def close(self) -> None:
        """Commit all pending records (ascending) and close the file."""
        if self._fh.closed:
            return
        for it in sorted(self._pending):
            self._commit(it)
        self._fh.close()

    # -- introspection ---------------------------------------------------
    @property
    def path(self) -> str:
        return self._path

    @property
    def events_written(self) -> int:
        return self._written

    def __enter__(self) -> "EventRecorder":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_events(path: str) -> List[Dict[str, Any]]:
    """Parse an events file back into a list of dicts (schema round-trip)."""
    out: List[Dict[str, Any]] = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
