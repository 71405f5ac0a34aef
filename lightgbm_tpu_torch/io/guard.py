"""Malformed rows at the file-ingest boundary: classify, then fail fast or
quarantine under an error budget.

Port of the JAX package's io/guard.py.  Every parser entry point
(``io/parser.py``, ``io/streaming.py``) routes each bad line through the
file's :class:`IngestGuard`:

- ``bad_data_policy=fail_fast`` (default): the first bad line raises a
  ``LightGBMError`` naming ``file:line``, the reason and the token;
- ``bad_data_policy=quarantine``: the line is skipped, appended to
  ``<data>.quarantine`` (``line  reason  detail  raw`` records, tab
  separated, under a ``#`` header, byte for byte the JAX package's) and
  counted in the ``bad_rows_total`` / ``bad_rows_<reason>`` counters of
  ``obs/registry.py``, until the error budget (``max_bad_rows``
  absolute, ``max_bad_row_fraction`` relative, armed after 100 rows) is
  spent: then the load fails naming the budget.

Reasons (:data:`REASONS`): ``unparseable_token``, ``ragged_row`` (a
field count other than the file's first data row's),
``bad_column_index`` (a LibSVM index that is negative, not an integer or
out of range) and ``empty``.  The token helpers :func:`feature_value`
(NA spellings and empty fields are NaN) and :func:`column_index` are the
one place file tokens become numbers.

Line numbers are 1-based physical lines (header included), and the guard
counts each line once: the two-round loader meets a sampled bad line in
round 1b and again in round 2.  ``record=False`` is the shadow mode of a
second pass over a file already guarded (the init-score re-read of a
continued run): the same skips, no counter and no sink.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Set, Tuple

from .. import obs
from ..utils import log
from ..utils.log import LightGBMError

#: classification vocabulary — the ``bad_rows_<reason>`` counter suffixes
REASONS = ("unparseable_token", "ragged_row", "bad_column_index", "empty")

POLICIES = ("fail_fast", "quarantine")

#: NA spellings mapped to missing (NaN), case-insensitive, plus the
#: empty field (reference CommonC::AtofPrecise NA handling)
NA_TOKENS = frozenset({"", "na", "nan", "null", "none"})

#: rows examined before the fractional budget arms — a 3-bad-of-5-rows
#: prefix of a million-row file must not abort a 0.1 budget
_FRACTION_GRACE_ROWS = 100

_QUARANTINE_SUFFIX = ".quarantine"


def quarantine_path_for(data_path: str) -> str:
    """Where rejected rows of ``data_path`` land."""
    return data_path + _QUARANTINE_SUFFIX


def feature_value(token: str) -> float:
    """One feature or label token -> float.  NA spellings and empty
    fields become NaN (missing: the bin mappers put NaN in bin 0).
    Raises ``ValueError`` on anything else, for the caller's guard to
    classify the row."""
    t = token.strip()
    if t.lower() in NA_TOKENS:
        return float("nan")
    return float(t)


#: LibSVM column indices above this are refused: the rows are densified,
#: so one corrupt index must not size the matrix
MAX_COLUMN_INDEX = 1 << 20


def column_index(token: str) -> int:
    """One LibSVM column-index token -> an int in [0,
    :data:`MAX_COLUMN_INDEX`].  Raises ``ValueError`` on a non-integer, a
    negative index (it would write into another feature through
    negative indexing) and an index past the ceiling."""
    idx = int(token.strip())
    if idx < 0:
        raise ValueError(f"negative column index {idx}")
    if idx > MAX_COLUMN_INDEX:
        raise ValueError(
            f"column index {idx} exceeds the dense-layout ceiling "
            f"{MAX_COLUMN_INDEX}")
    return idx


class IngestGuard:
    """Per-file bad-row policy: classify, then fail fast or quarantine
    under an error budget.

    Parameters
    ----------
    path: the data file (diagnostics + quarantine sink location).
    policy: ``fail_fast`` | ``quarantine``.
    max_bad_rows: absolute quarantine budget (0 = no absolute cap).
    max_bad_row_fraction: relative budget over rows seen so far
        (0 = no fractional cap); armed after a small grace so tiny
        prefixes cannot abort a long file.
    sink: write the ``<path>.quarantine`` file (quarantine policy only).
    record: count/sink at all.  ``record=False`` is the *shadow* mode
        for a second pass over an already-guarded file (e.g. the
        continued-training re-read): identical skip decisions, zero
        double-counted ``bad_rows_*`` counters, no sink rewrite.
    """

    def __init__(self, path: str, policy: str = "fail_fast",
                 max_bad_rows: int = 0,
                 max_bad_row_fraction: float = 0.0,
                 sink: bool = True, record: bool = True):
        if policy not in POLICIES:
            raise LightGBMError(
                f"Unknown bad_data_policy {policy!r} "
                f"(expected one of {', '.join(POLICIES)})")
        self.path = str(path)
        self.policy = policy
        self.max_bad_rows = max(int(max_bad_rows), 0)
        self.max_bad_row_fraction = float(max_bad_row_fraction)
        self.record = bool(record)
        self._sink_enabled = bool(sink) and self.record
        self._sink = None
        self.bad_total = 0
        self.rows_seen = 0           # good + bad data rows examined
        self.by_reason: Dict[str, int] = {}
        self.records: List[Tuple[int, str, str]] = []  # (line, reason, detail)
        self._seen_lines: Set[int] = set()
        self._expected_fields: Optional[int] = None
        self._finished = False
        if self.policy == "quarantine" and self._sink_enabled:
            # a stale quarantine file from a previous load must not be
            # mistaken for this load's verdict
            try:
                os.unlink(self.quarantine_path)
            except OSError:
                pass

    # -- context manager: finish() on clean exit only ------------------
    def __enter__(self) -> "IngestGuard":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.finish()
        else:
            self._close_sink()

    @property
    def quarantine_path(self) -> str:
        return quarantine_path_for(self.path)

    # -- field-count memory (ragged-row detection across chunks) -------
    def expect_fields(self, n: int) -> int:
        """Record (first call) or return the file's delimited field
        count, so ragged detection is consistent across parse chunks."""
        if self._expected_fields is None:
            self._expected_fields = int(n)
        return self._expected_fields

    # -- the classification entry point --------------------------------
    def bad_row(self, line_no: int, raw_line: str, reason: str,
                detail: str) -> bool:
        """One classified bad line.  ``fail_fast``: raises immediately.
        ``quarantine``: records, sinks, counts, budget-checks.  Returns
        True when the caller must SKIP the row (always, under
        quarantine); returns False when this line number was already
        accounted (two-round dedupe) — still skip, but silently."""
        if reason not in REASONS:
            raise ValueError(f"unknown bad-row reason {reason!r}")
        line_no = int(line_no)
        if self.policy == "fail_fast":
            raise LightGBMError(
                f"{self.path}:{line_no}: {reason}: {detail} "
                f"(bad_data_policy=fail_fast; set bad_data_policy="
                f"quarantine to skip bad rows under an error budget)")
        if line_no in self._seen_lines:
            return False
        self._seen_lines.add(line_no)
        self.bad_total += 1
        self.rows_seen += 1
        self.by_reason[reason] = self.by_reason.get(reason, 0) + 1
        self.records.append((line_no, reason, detail))
        if self.record:
            obs.inc("bad_rows_total")
            obs.inc(f"bad_rows_{reason}")
            self._sink_write(line_no, raw_line, reason, detail)
            if self.bad_total == 1:
                log.warning(
                    "%s:%d: %s: %s — quarantining to %s "
                    "(bad_data_policy=quarantine; further bad rows "
                    "logged to the sink only)",
                    self.path, line_no, reason, detail,
                    self.quarantine_path)
        self._check_budget(line_no, reason, detail)
        return True

    def good_rows(self, n: int) -> None:
        """Account ``n`` successfully parsed data rows (feeds the
        fractional budget's denominator)."""
        self.rows_seen += int(n)

    def rewind_good_rows(self, n: int) -> None:
        """Un-count ``n`` good rows that will be parsed AGAIN by a later
        pass over the same file (the two-round loader's round-1b sample
        lines reappear in round 2): bad rows dedupe by line number, good
        rows must not inflate the fractional budget's denominator."""
        self.rows_seen = max(self.rows_seen - int(n), 0)

    def is_quarantined(self, line_no: int) -> bool:
        return int(line_no) in self._seen_lines

    # -- budgets --------------------------------------------------------
    def _budget_error(self, line_no: int, reason: str, detail: str,
                      why: str) -> LightGBMError:
        return LightGBMError(
            f"{self.path}: bad-row budget exhausted ({why}) at line "
            f"{line_no} ({reason}: {detail}) — {self.bad_total} bad "
            f"row(s) so far, quarantined to {self.quarantine_path}. "
            f"The file is the problem, not the rows; raise "
            f"max_bad_rows/max_bad_row_fraction only if this much dirt "
            f"is expected.")

    def _check_budget(self, line_no: int, reason: str, detail: str) -> None:
        if self.max_bad_rows and self.bad_total > self.max_bad_rows:
            self._close_sink()
            raise self._budget_error(
                line_no, reason, detail,
                f"max_bad_rows={self.max_bad_rows}")
        frac = self.max_bad_row_fraction
        if frac > 0 and self.rows_seen >= _FRACTION_GRACE_ROWS \
                and self.bad_total > frac * self.rows_seen:
            self._close_sink()
            raise self._budget_error(
                line_no, reason, detail,
                f"max_bad_row_fraction={frac:g} over "
                f"{self.rows_seen} rows")

    def finish(self) -> None:
        """End-of-file bookkeeping: the fractional budget gets a final
        check (files shorter than the in-flight grace window), and the
        sink is flushed/closed.  Idempotent."""
        if self._finished:
            return
        self._finished = True
        frac = self.max_bad_row_fraction
        if frac > 0 and self.bad_total and self.rows_seen \
                and self.bad_total > frac * self.rows_seen:
            last = self.records[-1]
            self._close_sink()
            raise self._budget_error(
                last[0], last[1], last[2],
                f"max_bad_row_fraction={frac:g} over "
                f"{self.rows_seen} rows")
        self._close_sink()
        if self.bad_total and self.record:
            log.warning(
                "%s: quarantined %d bad row(s) (%s) -> %s",
                self.path, self.bad_total,
                ", ".join(f"{k}={v}"
                          for k, v in sorted(self.by_reason.items())),
                self.quarantine_path)

    # -- quarantine sink -------------------------------------------------
    def _sink_write(self, line_no: int, raw_line: str, reason: str,
                    detail: str) -> None:
        if not self._sink_enabled:
            return
        if self._sink is None:
            # a guarded writer (utils/diskguard.py): a full disk
            # disables the sink (one warning), while the accounting and
            # the budgets go on; policy=None is the run's
            # sink_error_policy
            from ..utils.diskguard import GuardedWriter
            self._sink = GuardedWriter(self.quarantine_path,
                                       sink="quarantine",
                                       policy=None, buffering=1)
            self._sink.write(
                "# lightgbm_tpu quarantine v1\n"
                f"# source: {self.path}\n"
                "# columns: line\treason\tdetail\traw\n")
        clean = raw_line.replace("\t", "\\t").replace("\n", "\\n")
        self._sink.write(f"{line_no}\t{reason}\t{detail}\t{clean}\n")

    def _close_sink(self) -> None:
        if self._sink is not None:
            self._sink.close()
            self._sink = None


#: row-aligned companion files (metadata.cpp side-loading)
SIDE_FILE_SUFFIXES = (".weight", ".query", ".init")


def check_side_files_alignment(data_path: str, bad_total: int) -> None:
    """Refuse quarantine when row-aligned side files exist.  A
    ``.weight`` / ``.query`` / ``.init`` companion is positional
    against the DATA FILE's rows; once quarantine drops rows, every
    side value after the first dropped line would silently apply to
    the wrong row — exactly the corruption class this layer exists to
    eliminate, so it is a named refusal, not a crop."""
    if not bad_total:
        return
    present = [data_path + s for s in SIDE_FILE_SUFFIXES
               if os.path.exists(data_path + s)]
    if present:
        raise LightGBMError(
            f"{data_path}: {bad_total} row(s) were quarantined but "
            f"row-aligned side file(s) exist ({', '.join(present)}) — "
            f"their values cannot be re-aligned to the surviving rows. "
            f"Clean the data file (see {data_path}.quarantine) and "
            f"regenerate the side files, or use "
            f"bad_data_policy=fail_fast.")


def read_quarantine(path: str) -> List[Dict[str, object]]:
    """Parse a quarantine sink back into records (tests, tooling).
    ``path`` may be the data file or the sink itself."""
    if not path.endswith(_QUARANTINE_SUFFIX):
        path = quarantine_path_for(path)
    out: List[Dict[str, object]] = []
    with open(path, "r") as fh:
        for ln in fh:
            if ln.startswith("#") or not ln.strip():
                continue
            parts = ln.rstrip("\n").split("\t", 3)
            if len(parts) != 4:
                continue
            out.append({"line": int(parts[0]), "reason": parts[1],
                        "detail": parts[2], "raw": parts[3]})
    return out
