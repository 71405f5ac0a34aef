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

Reading is fail-fast: the first malformed line (an unparseable token, a
ragged row, a bad LibSVM column index) raises a ``LightGBMError`` naming
the file, the line and the token.  The JAX package's ``IngestGuard``
quarantine policies and its native C++ loader are not ported
(``bad_data_policy`` other than ``fail_fast`` is refused by
``config.py``).
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.log import LightGBMError

#: NA spellings read as missing (NaN), case-insensitive, plus the empty
#: field (the JAX io/guard.py NA_TOKENS)
NA_TOKENS = frozenset({"", "na", "nan", "null", "none"})
#: LibSVM column indices above this are refused: the rows are densified,
#: so one corrupt index must not size the matrix
MAX_COLUMN_INDEX = 1 << 20
#: lines that decide the format
PROBE_LINES = 32


def feature_value(token: str) -> float:
    """One label or feature token -> float (NA and empty -> NaN); raises
    ``ValueError`` on anything else."""
    t = token.strip()
    if t.lower() in NA_TOKENS:
        return float("nan")
    return float(t)


def column_index(token: str) -> int:
    """One LibSVM column-index token -> an int in [0, MAX_COLUMN_INDEX];
    raises ``ValueError`` otherwise."""
    idx = int(token.strip())
    if idx < 0:
        raise ValueError(f"negative column index {idx}")
    if idx > MAX_COLUMN_INDEX:
        raise ValueError(f"column index {idx} exceeds {MAX_COLUMN_INDEX}")
    return idx


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


def _bad(path: str, line_no: int, reason: str, detail: str):
    return LightGBMError(f"{path}:{line_no}: {reason}: {detail}")


def _parse_delimited(lines: Sequence[str], line_numbers: Sequence[int],
                     delim: str, label_idx: int, path: str,
                     width: Optional[int] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """(label [n], features [n, F]) of delimited lines; ``label_idx`` < 0
    reads every column as a feature and gives zero labels.  ``width``:
    the field count of the file's earlier rows, if any."""
    rows: List[List[float]] = []
    for line, no in zip(lines, line_numbers):
        parts = line.strip().split(delim)
        if all(not p.strip() for p in parts):
            raise _bad(path, no, "empty", "row has no fields")
        if width is None:
            width = len(parts)
        elif len(parts) != width:
            raise _bad(path, no, "ragged_row",
                       f"{len(parts)} fields where the file has {width}")
        try:
            rows.append([feature_value(p) for p in parts])
        except ValueError:
            bad = next(p for p in parts if not _is_value(p))
            raise _bad(path, no, "unparseable_token", f"token {bad!r}")
    mat = np.asarray(rows, dtype=np.float64).reshape(len(rows), width or 0)
    if label_idx >= mat.shape[1] and mat.shape[0]:
        raise LightGBMError(
            f"{path}: label column index {label_idx} out of range (file "
            f"rows have {mat.shape[1]} fields)")
    if label_idx < 0:
        return np.zeros(mat.shape[0]), mat
    label = mat[:, label_idx].copy() if mat.shape[0] else np.zeros(0)
    return label, np.delete(mat, label_idx, axis=1)


def _is_value(token: str) -> bool:
    try:
        feature_value(token)
        return True
    except ValueError:
        return False


def _parse_libsvm(lines: Sequence[str], line_numbers: Sequence[int],
                  num_features: Optional[int], path: str
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(label [n], dense features [n, F]) of LibSVM lines: an optional
    leading label, then ``index:value`` pairs with 0-based indices."""
    labels: List[float] = []
    rows: List[int] = []
    cols: List[int] = []
    vals: List[float] = []
    for r, (line, no) in enumerate(zip(lines, line_numbers)):
        parts = line.split()
        lab, start = 0.0, 0
        if ":" not in parts[0]:
            try:
                lab = feature_value(parts[0])
            except ValueError:
                raise _bad(path, no, "unparseable_token",
                           f"label token {parts[0]!r}")
            start = 1
        for tok in parts[start:]:
            col_s, sep, val_s = tok.partition(":")
            if not sep:
                raise _bad(path, no, "unparseable_token",
                           f"token {tok!r} is not index:value")
            try:
                col = column_index(col_s)
            except ValueError:
                raise _bad(path, no, "bad_column_index",
                           f"column index {col_s!r} in token {tok!r}")
            if num_features is not None and col >= num_features:
                raise _bad(path, no, "bad_column_index",
                           f"column index {col} out of range (the data has "
                           f"{num_features} feature columns) in token "
                           f"{tok!r}")
            try:
                val = feature_value(val_s)
            except ValueError:
                raise _bad(path, no, "unparseable_token",
                           f"value {val_s!r} in token {tok!r}")
            rows.append(r)
            cols.append(col)
            vals.append(val)
        labels.append(lab)
    ncol = num_features if num_features is not None else (
        max(cols) + 1 if cols else 0)
    feats = np.zeros((len(labels), ncol), dtype=np.float64)
    # a repeated index keeps its last value, as the JAX loop does
    feats[rows, cols] = vals
    return np.asarray(labels, dtype=np.float64), feats


def _numbered_lines(path: str, has_header: bool
                    ) -> Iterator[Tuple[int, str]]:
    """(1-based line number, line) of every non-blank data line; the
    header line is consumed."""
    with open(path, "r", errors="replace") as fh:
        lineno = 0
        if has_header:
            fh.readline()
            lineno = 1
        for line in fh:
            lineno += 1
            if line.strip():
                yield lineno, line


def _parse_chunk(lines: Sequence[str], line_numbers: Sequence[int],
                 fmt: str, label_idx: int, num_features: Optional[int],
                 path: str, width: Optional[int] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    if fmt == "libsvm":
        label, feats = _parse_libsvm(lines, line_numbers, num_features, path)
    else:
        label, feats = _parse_delimited(lines, line_numbers,
                                        "," if fmt == "csv" else "\t",
                                        label_idx, path, width)
    if num_features is not None and feats.shape[1] != num_features:
        fixed = np.zeros((feats.shape[0], num_features), np.float64)
        upto = min(num_features, feats.shape[1])
        fixed[:, :upto] = feats[:, :upto]
        feats = fixed
    return label, feats


def parse_file_chunks(path: str, has_header: bool = False,
                      label_idx: int = 0,
                      num_features: Optional[int] = None,
                      chunk_rows: int = 1 << 16):
    """Yield (label, features) chunks of at most ``chunk_rows`` data rows
    (blank lines not counted).  The format comes from the first 32 data
    lines; each chunk is widened or cut to ``num_features`` columns when
    it is given, so every chunk has the same width."""
    probe: List[str] = []
    fmt: Optional[str] = None
    width = None              # fields per delimited row, from chunk 1
    chunk: List[str] = []
    nums: List[int] = []
    for lineno, line in _numbered_lines(path, has_header):
        if fmt is None and len(probe) < PROBE_LINES:
            probe.append(line)
        chunk.append(line)
        nums.append(lineno)
        if len(chunk) >= chunk_rows:
            fmt = fmt or detect_format(probe)
            if width is None and fmt != "libsvm":
                width = len(chunk[0].strip().split(
                    "," if fmt == "csv" else "\t"))
            yield _parse_chunk(chunk, nums, fmt, label_idx, num_features,
                               path, width)
            chunk, nums = [], []
    if chunk:
        fmt = fmt or detect_format(probe)
        yield _parse_chunk(chunk, nums, fmt, label_idx, num_features, path,
                           width)


def read_header(path: str) -> Tuple[List[str], str]:
    """(the first line's column names, the format of the data lines)."""
    numbered = _numbered_lines(path, False)
    first = next(numbered, (0, ""))[1]
    probe = [ln for _, (_, ln) in zip(range(PROBE_LINES), numbered)]
    fmt = detect_format(probe)
    delim = {"csv": ",", "tsv": "\t"}.get(fmt, "\t")
    return first.rstrip("\r\n").split(delim), fmt


def parse_file(path: str, has_header: bool = False, label_idx: int = 0,
               num_features: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray, Optional[List[str]]]:
    """(label [N], features [N, F], the header's feature names or None)
    of a whole data file.  The header's names leave out the label
    column (not for LibSVM, whose header is not column-aligned)."""
    header: Optional[List[str]] = None
    if has_header:
        names, fmt = read_header(path)
        if label_idx >= 0 and fmt != "libsvm" and len(names) > label_idx:
            names = names[:label_idx] + names[label_idx + 1:]
        header = names
    parts = list(parse_file_chunks(path, has_header, label_idx,
                                   num_features))
    if not parts:
        return np.zeros(0), np.zeros((0, num_features or 0)), header
    # LibSVM chunks densify to their own widths without num_features
    width = max(p[1].shape[1] for p in parts)
    parts = [(lab, np.pad(X, ((0, 0), (0, width - X.shape[1]))))
             for lab, X in parts]
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts], axis=0), header)
