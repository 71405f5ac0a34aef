"""Text parsers: CSV, TSV and LibSVM, with the format detected from the
first lines.

Port of the JAX package's io/parser.py.  The format is guessed from the
delimiter counts of the first 32 non-blank lines (reference
parser.cpp:10-72); the label column defaults to column 0; LibSVM column
indices are 0-based and the rows are densified, to ``num_features``
columns when the caller gives the width (a valid or predict file against
its training set) and to the largest index + 1 otherwise.  NA spellings
and empty fields become NaN.  Blank lines are not data: they are skipped
and not counted toward a chunk, so chunked predictions stay aligned with
the data rows.

Every bad line (an unparseable token, a ragged row, a bad LibSVM column
index, a row of empty fields) goes through the file's
:class:`~.guard.IngestGuard`: under ``bad_data_policy=fail_fast`` (the
default) it raises a ``LightGBMError`` naming ``file:line``, the reason
and the token; under ``quarantine`` the row is skipped into
``<data>.quarantine`` under an error budget.  The JAX package's native
C++ loader is not ported: its one-round path reads a clean file with
it and a dirty one with the Python path this module ports.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.log import LightGBMError
from .guard import IngestGuard, column_index, feature_value

#: lines that decide the format
PROBE_LINES = 32


def detect_format(lines: Sequence[str]) -> str:
    """'csv', 'tsv' or 'libsvm' from delimiter counts (parser.cpp:10-72)."""
    num_comma = sum(line.count(",") for line in lines)
    num_tab = sum(line.count("\t") for line in lines)
    num_colon = sum(line.count(":") for line in lines)
    if num_colon > 0 and num_colon >= max(num_comma, num_tab):
        return "libsvm"
    if num_tab >= num_comma:
        return "tsv" if num_tab > 0 else "csv"
    return "csv"


def _line_no(line_numbers: Optional[Sequence[int]], i: int) -> int:
    return int(line_numbers[i]) if line_numbers is not None else i + 1


class _BadLine(Exception):
    """One classified bad line (reason, detail), turned into the guard's
    verdict (raise or skip) by the per-line loop."""

    def __init__(self, reason: str, detail: str):
        super().__init__(f"{reason}: {detail}")
        self.reason = reason
        self.detail = detail


def _parse_delimited(lines: Sequence[str], delim: str, label_idx: int,
                     guard: Optional[IngestGuard] = None,
                     line_numbers: Optional[Sequence[int]] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """(label [n], features [n, F]) of delimited lines; ``label_idx`` < 0
    reads every column as a feature and gives zero labels.  The field
    count is the guard's: the first data row it has seen, in this call
    or an earlier chunk of the file."""
    g = guard if guard is not None else IngestGuard("<data>")
    rows: List[List[float]] = []
    good = 0        # good rows not yet given to the guard

    def bad(i, line, reason, detail):
        nonlocal good
        g.good_rows(good)       # the budget sees the rows before this one
        good = 0
        g.bad_row(_line_no(line_numbers, i), line, reason, detail)

    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        parts = line.split(delim)
        if len(parts) == g._expected_fields:
            try:
                # the common row: float() of a token it accepts is
                # feature_value()'s value, and a row of empty fields
                # fails it
                rows.append(list(map(float, parts)))
                good += 1
                continue
            except ValueError:
                pass
        # the full classification, in the JAX package's order
        if all(not p.strip() for p in parts):
            bad(i, line, "empty", "row has no fields")
            continue
        expected = g.expect_fields(len(parts))
        if len(parts) != expected:
            bad(i, line, "ragged_row",
                f"{len(parts)} fields where the file has {expected}")
            continue
        try:
            vals = [feature_value(p) for p in parts]
        except ValueError:
            token = next(p for p in parts if not _is_value(p))
            bad(i, line, "unparseable_token", f"token {token!r}")
            continue
        rows.append(vals)
        good += 1
    g.good_rows(good)
    width = len(rows[0]) if rows else (g._expected_fields or 0)
    mat = np.asarray(rows, dtype=np.float64).reshape(len(rows), width)
    if label_idx >= mat.shape[1] and mat.shape[0]:
        raise LightGBMError(
            f"{g.path}: label column index {label_idx} out of range (file "
            f"rows have {mat.shape[1]} fields)")
    if label_idx < 0:
        return np.zeros(mat.shape[0]), mat
    if label_idx >= width:
        return np.zeros(0), np.zeros((0, max(width - 1, 0)))
    label = mat[:, label_idx].copy()
    return label, np.delete(mat, label_idx, axis=1)


def _is_value(token: str) -> bool:
    try:
        feature_value(token)
        return True
    except ValueError:
        return False


def _libsvm_entries(line: str, num_features: Optional[int]
                    ) -> Tuple[float, List[Tuple[int, float]]]:
    """(label, [(column, value)]) of one LibSVM line: an optional leading
    label, then ``index:value`` pairs with 0-based indices.  Raises
    :class:`_BadLine` on the first malformed token."""
    parts = line.split()
    lab, start = 0.0, 0
    if ":" not in parts[0]:
        try:
            lab = feature_value(parts[0])
        except ValueError:
            raise _BadLine("unparseable_token",
                           f"label token {parts[0]!r}")
        start = 1
    entries: List[Tuple[int, float]] = []
    for tok in parts[start:]:
        col_s, sep, val_s = tok.partition(":")
        if not sep:
            raise _BadLine("unparseable_token",
                           f"token {tok!r} is not index:value")
        try:
            col = column_index(col_s)
        except ValueError:
            raise _BadLine("bad_column_index",
                           f"column index {col_s!r} in token {tok!r}")
        if num_features is not None and col >= num_features:
            raise _BadLine("bad_column_index",
                           f"column index {col} out of range (file has "
                           f"{num_features} feature columns) in token "
                           f"{tok!r}")
        try:
            val = feature_value(val_s)
        except ValueError:
            raise _BadLine("unparseable_token",
                           f"value {val_s!r} in token {tok!r}")
        entries.append((col, val))
    return lab, entries


def _parse_libsvm(lines: Sequence[str], num_features: Optional[int] = None,
                  guard: Optional[IngestGuard] = None,
                  line_numbers: Optional[Sequence[int]] = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(label [n], dense features [n, F]) of LibSVM lines."""
    g = guard if guard is not None else IngestGuard("<data>")
    labels: List[float] = []
    rows: List[int] = []
    cols: List[int] = []
    vals: List[float] = []
    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        try:
            lab, entries = _libsvm_entries(line, num_features)
        except _BadLine as bl:
            g.bad_row(_line_no(line_numbers, i), line, bl.reason,
                      bl.detail)
            continue
        for col, val in entries:
            rows.append(len(labels))
            cols.append(col)
            vals.append(val)
        labels.append(lab)
        g.good_rows(1)
    ncol = num_features if num_features is not None else (
        max(cols) + 1 if cols else 0)
    feats = np.zeros((len(labels), ncol), dtype=np.float64)
    # a repeated index keeps its last value, as the JAX loop does
    feats[rows, cols] = vals
    return np.asarray(labels, dtype=np.float64), feats


def _numbered_lines(path: str, has_header: bool
                    ) -> Iterator[Tuple[int, str]]:
    """(1-based line number, line) of every non-blank data line; the
    header line is consumed.  Undecodable bytes are replaced, so they
    fail token parsing and are classified."""
    with open(path, "r", errors="replace") as fh:
        lineno = 0
        if has_header:
            fh.readline()
            lineno = 1
        for line in fh:
            lineno += 1
            if line.strip():
                yield lineno, line


def _parse_chunk(lines: Sequence[str], fmt: str, label_idx: int,
                 num_features: Optional[int],
                 guard: Optional[IngestGuard] = None,
                 line_numbers: Optional[Sequence[int]] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    if fmt == "libsvm":
        label, feats = _parse_libsvm(lines, num_features, guard=guard,
                                     line_numbers=line_numbers)
    else:
        label, feats = _parse_delimited(lines, "," if fmt == "csv" else "\t",
                                        label_idx, guard=guard,
                                        line_numbers=line_numbers)
    if num_features is not None and feats.shape[1] != num_features:
        fixed = np.zeros((feats.shape[0], num_features), np.float64)
        upto = min(num_features, feats.shape[1])
        fixed[:, :upto] = feats[:, :upto]
        feats = fixed
    return label, feats


def parse_file_chunks(path: str, has_header: bool = False,
                      label_idx: int = 0,
                      num_features: Optional[int] = None,
                      chunk_rows: int = 1 << 16,
                      guard: Optional[IngestGuard] = None):
    """Yield (label, features) chunks of at most ``chunk_rows`` data rows
    (blank lines not counted).  The format comes from the first 32 data
    lines; each chunk is widened or cut to ``num_features`` columns when
    it is given, so every chunk has the same width.  ``guard`` defaults
    to a fail-fast guard on ``path`` (predictions are positional: a
    skipped row would shift every later one); it is finished after the
    last chunk."""
    g = guard if guard is not None else IngestGuard(path)
    probe: List[str] = []
    fmt: Optional[str] = None
    chunk: List[str] = []
    nums: List[int] = []
    for lineno, line in _numbered_lines(path, has_header):
        if fmt is None and len(probe) < PROBE_LINES:
            probe.append(line)
        chunk.append(line)
        nums.append(lineno)
        if len(chunk) >= chunk_rows:
            fmt = fmt or detect_format(probe)
            yield _parse_chunk(chunk, fmt, label_idx, num_features,
                               guard=g, line_numbers=nums)
            chunk, nums = [], []
    if chunk:
        fmt = fmt or detect_format(probe)
        yield _parse_chunk(chunk, fmt, label_idx, num_features, guard=g,
                           line_numbers=nums)
    g.finish()


def read_header(path: str) -> Tuple[List[str], str]:
    """(the first line's column names, the format of the data lines)."""
    numbered = _numbered_lines(path, False)
    first = next(numbered, (0, ""))[1]
    probe = [ln for _, (_, ln) in zip(range(PROBE_LINES), numbered)]
    fmt = detect_format(probe)
    delim = {"csv": ",", "tsv": "\t"}.get(fmt, "\t")
    return first.rstrip("\r\n").split(delim), fmt


def parse_file(path: str, has_header: bool = False, label_idx: int = 0,
               num_features: Optional[int] = None,
               guard: Optional[IngestGuard] = None
               ) -> Tuple[np.ndarray, np.ndarray, Optional[List[str]]]:
    """(label [N], features [N, F], the header's feature names or None)
    of a whole data file, its bad lines through ``guard`` (default: fail
    fast).  The header's names leave out the label column (not for
    LibSVM, whose header is not column-aligned)."""
    header: Optional[List[str]] = None
    if has_header:
        names, fmt = read_header(path)
        if label_idx >= 0 and fmt != "libsvm" and len(names) > label_idx:
            names = names[:label_idx] + names[label_idx + 1:]
        header = names
    parts = list(parse_file_chunks(path, has_header, label_idx,
                                   num_features, guard=guard))
    if not parts:
        return np.zeros(0), np.zeros((0, num_features or 0)), header
    # LibSVM chunks densify to their own widths without num_features
    width = max(p[1].shape[1] for p in parts)
    parts = [(lab, np.pad(X, ((0, 0), (0, width - X.shape[1]))))
             for lab, X in parts]
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts], axis=0), header)
