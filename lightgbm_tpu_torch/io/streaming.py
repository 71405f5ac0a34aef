"""Two-round (streaming) loading of a data file.

Port of the JAX package's io/streaming.py (reference
dataset_loader.cpp:191-206, ``use_two_round_loading`` and its aliases
``two_round_loading`` / ``two_round``).  The one-round path holds the
whole ``[N, F]`` f64 matrix before binning; this loader holds one text
chunk and the bin sample at a time:

  round 1a: read the file once: count the rows (and, for LibSVM, the
            largest column index; a malformed LibSVM line is classified
            here, so a garbage index cannot widen the matrix);
  round 1b: read again, keeping only the sampled lines, drawn as the
            in-memory path draws them (``np.random.RandomState(
            data_random_seed)`` over the global row count), so the
            mappers are bit-equal to ``BinnedDataset.from_matrix``'s on
            the same rows; the EFB plan is drawn over that sample too;
  round 2:  read in chunks, parse each and bin it into the preallocated
            uint8/uint16 ``[C, N]`` matrix.

Bad lines go through the file's :class:`~.guard.IngestGuard`, which
counts each line once: a bad line sampled in round 1b and met again in
round 2 is quarantined, counted and budgeted once, and the bins and
labels are cropped to the clean rows.  A file that changes between the
rounds (its size, or its row count) is a named ``LightGBMError``.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..utils import log
from ..utils.log import LightGBMError
from .binning import BinMapper
from .bundling import plan_bundles
from .dataset import (BinnedDataset, Metadata, _bins_dtype,
                      build_mappers_from_sample)
from .guard import IngestGuard, check_side_files_alignment
from .parser import _BadLine, _libsvm_entries, _parse_chunk, detect_format


def _numbered_data_lines(path: str, skip_header: bool
                         ) -> Iterator[Tuple[int, str]]:
    """Yield (1-based physical line number, newline-stripped line) for
    every non-blank data line, skipping the header.  Undecodable bytes
    are replaced so they reach the classifier instead of raising
    ``UnicodeDecodeError`` mid-stream."""
    with open(path, "r", errors="replace") as fh:
        lineno = 0
        if skip_header:
            fh.readline()
            lineno = 1
        for line in fh:
            lineno += 1
            line = line.rstrip("\r\n")
            if line.strip():
                yield lineno, line


def _data_lines(path: str, skip_header: bool):
    """Yield raw data lines (newline-stripped), skipping the header."""
    for _, line in _numbered_data_lines(path, skip_header):
        yield line


def _probe_format(path: str, has_header: bool) -> str:
    probe: List[str] = []
    for line in _data_lines(path, has_header):
        probe.append(line)
        if len(probe) >= 32:
            break
    return detect_format(probe)


def read_full_header_names(path: str) -> Tuple[List[str], str]:
    """(all header column names, detected format) from the first line."""
    fmt = _probe_format(path, True)
    with open(path, "r", errors="replace") as fh:
        first = fh.readline().rstrip("\r\n")
    delim = {"csv": ",", "tsv": "\t"}.get(fmt, "\t")
    return first.split(delim), fmt


def read_header_names(path: str, label_idx: int = 0) -> List[str]:
    """Feature names from the header line (label column removed)."""
    header, fmt = read_full_header_names(path)
    if label_idx >= 0 and fmt != "libsvm" and len(header) > label_idx:
        header = header[:label_idx] + header[label_idx + 1:]
    return header


def _scan_libsvm_max_col(line: str) -> int:
    """Max column index of one LibSVM line, through the parser's own
    token checks: raises :class:`_BadLine` on a malformed token, so a
    corrupt row cannot widen the matrix round 1a sizes."""
    return max((col for col, _ in _libsvm_entries(line, None)[1]),
               default=-1)


def _drift_error(path: str, why: str) -> None:
    raise LightGBMError(
        f"Two-round loader: {path} changed between rounds ({why}) — a "
        f"concurrent writer is mutating the file; re-run the load "
        f"against a quiescent copy")


def load_file_two_round(path: str, *, has_header: bool = False,
                        label_idx: int = 0, max_bin: int = 255,
                        min_data_in_bin: int = 5, min_data_in_leaf: int = 100,
                        bin_construct_sample_cnt: int = 200000,
                        categorical_features: Sequence[int] = (),
                        ignore_features: Sequence[int] = (),
                        weight_idx: int = -1, group_idx: int = -1,
                        data_random_seed: int = 1,
                        reference: Optional[BinnedDataset] = None,
                        chunk_rows: int = 1 << 16,
                        guard: Optional[IngestGuard] = None,
                        enable_bundle: bool = False,
                        max_conflict_rate: float = 0.0,
                        is_enable_sparse: bool = True,
                        ) -> BinnedDataset:
    """Load ``path`` into a BinnedDataset in two rounds, without the
    float matrix: the same mappers, bins and labels as ``parse_file`` +
    ``BinnedDataset.from_matrix``; with ``reference`` the file is binned
    with the reference's mappers (a valid set).

    ``weight_idx`` / ``group_idx`` name in-data columns (feature-space
    indices, dataset_loader.cpp SetHeader) whose values stream into
    Metadata instead of features; callers put them in ignore_features.

    ``guard`` carries the bad-row policy (default: fail fast on the
    first malformed line, naming file:line + token).  Round 2 parses
    ``chunk_rows`` lines at a time, the one-round parser's chunk (the
    JAX package's is 262144; the result is the same for any chunk)."""
    g = guard if guard is not None else IngestGuard(path)
    fmt = _probe_format(path, has_header)
    try:
        size_r1 = os.path.getsize(path)
    except OSError:
        size_r1 = -1

    # round 1a: row count (+ LibSVM feature count; skipped when the
    # reference already fixes the feature space).  LibSVM lines are
    # fully token-validated here — a malformed line is classified NOW
    # (fail fast / quarantine) instead of donating a garbage column
    # index to the matrix allocation.
    num_data = 0
    max_col = -1
    scan_cols = fmt == "libsvm" and reference is None
    delim = {"csv": ",", "tsv": "\t"}.get(fmt)
    width_seeded = False
    for lineno, line in _numbered_data_lines(path, has_header):
        if not width_seeded and delim is not None:
            # the ragged-row width is the file's FIRST data line with
            # any fields: round 1b parses a random sample, and one
            # ragged line sampled first would otherwise invert the
            # classification of the whole file (and desync the shadow
            # guard of the init-score re-read, which reads from line 1)
            parts = line.split(delim)
            if any(p.strip() for p in parts):
                g.expect_fields(len(parts))
                width_seeded = True
        num_data += 1
        if scan_cols:
            try:
                max_col = max(max_col, _scan_libsvm_max_col(line))
            except _BadLine as bl:
                g.bad_row(lineno, line, bl.reason, bl.detail)
    if num_data == 0:
        log.fatal("Two-round loader: %s contains no data rows", path)

    if reference is not None:
        # mappers come from the reference: no sampling pass needed
        sample = None
        F = reference.num_total_features
    else:
        # round 1b: the sample — same indices as the in-memory path
        rng = np.random.RandomState(data_random_seed)
        if num_data > bin_construct_sample_cnt:
            sample_idx = np.sort(rng.choice(num_data,
                                            bin_construct_sample_cnt,
                                            replace=False))
        else:
            sample_idx = np.arange(num_data)
        wanted = np.zeros(num_data, bool)
        wanted[sample_idx] = True
        sample_lines: List[str] = []
        sample_nums: List[int] = []
        for i, (lineno, ln) in enumerate(
                _numbered_data_lines(path, has_header)):
            if i >= num_data:
                break       # late concurrent append: round 2 names it
            if wanted[i]:
                sample_lines.append(ln)
                sample_nums.append(lineno)
        num_features = (max_col + 1) if fmt == "libsvm" else None
        seen0, bad0 = g.rows_seen, g.bad_total
        # parsed chunk by chunk like round 2, so that the sample's rows
        # are never all Python lists at once
        sample = np.concatenate([
            _parse_chunk(sample_lines[i:i + chunk_rows], fmt, label_idx,
                         num_features, guard=g,
                         line_numbers=sample_nums[i:i + chunk_rows])[1]
            for i in range(0, len(sample_lines), chunk_rows)], axis=0)
        del sample_lines, sample_nums     # not held through round 2
        # the sampled GOOD lines will be parsed again in round 2: keep
        # their bad-row classifications (deduped by line number) but
        # give back their budget-denominator contribution, or a big
        # sample would make max_bad_row_fraction silently looser
        sample_good = (g.rows_seen - seen0) - (g.bad_total - bad0)
        g.rewind_good_rows(sample_good)
        F = sample.shape[1]

    ds = BinnedDataset()
    ds.num_total_features = F
    ds.max_bin = max_bin
    ds.feature_names = [f"Column_{i}" for i in range(F)]
    if has_header:
        header = read_header_names(path, label_idx)
        if len(header) == F:
            ds.feature_names = header

    if reference is not None:
        ds.num_total_features = reference.num_total_features
        ds.feature_names = list(reference.feature_names)
        ds.used_feature_map = list(reference.used_feature_map)
        ds.real_to_inner = reference.real_to_inner.copy()
        ds.mappers = reference.mappers
        ds.bundle_plan = reference.bundle_plan
    else:
        # trivial-feature filtering scales to the (estimated) CLEAN row
        # count: bad rows already classified never reach the bins, so
        # they must not count toward the filter denominator either
        per_real = build_mappers_from_sample(
            sample, max(num_data - g.bad_total, 1), max_bin=max_bin,
            min_data_in_bin=min_data_in_bin,
            min_data_in_leaf=min_data_in_leaf,
            categorical_features=set(int(c) for c in categorical_features),
            ignore_features=set(int(c) for c in ignore_features))
        ds.real_to_inner = np.full(F, -1, dtype=np.int64)
        used: List[int] = []
        mappers: List[BinMapper] = []
        for f, m in enumerate(per_real):
            if m is None or m.is_trivial:
                continue
            ds.real_to_inner[f] = len(used)
            used.append(f)
            mappers.append(m)
        ds.used_feature_map = used
        ds.mappers = mappers
        if not used:
            log.warning("All features are trivial; dataset has no usable "
                        "feature")
        # EFB over the round-1b sample — the SAME sample the in-memory
        # path would draw (identical seed + global row count), so both
        # loaders agree on bundles for identical files
        ds.bundle_plan = plan_bundles(
            sample, mappers, used,
            max_conflict_rate=max_conflict_rate, max_total_bin=max_bin,
            enable_bundle=enable_bundle, is_enable_sparse=is_enable_sparse)

    dtype = _bins_dtype(ds.mappers, ds.bundle_plan)
    num_columns = (ds.bundle_plan.num_columns
                   if ds.bundle_plan is not None
                   else len(ds.used_feature_map))
    ds.bins = np.zeros((num_columns, num_data), dtype=dtype)
    labels = np.zeros(num_data, np.float32)
    F_total = ds.num_total_features
    if weight_idx >= F_total:
        log.fatal("weight_column index %d out of range (file has %d "
                  "feature columns)", weight_idx, F_total)
    if group_idx >= F_total:
        log.fatal("group_column index %d out of range (file has %d "
                  "feature columns)", group_idx, F_total)
    weights = np.zeros(num_data, np.float64) if weight_idx >= 0 else None
    qids = np.zeros(num_data, np.float64) if group_idx >= 0 else None

    # drift gate: the file must not have changed since round 1 (size
    # now, exact row count re-verified during the round-2 stream)
    try:
        size_r2 = os.path.getsize(path)
    except OSError:
        size_r2 = -2
    if size_r2 != size_r1:
        _drift_error(path, f"size {size_r1} -> {size_r2} bytes")

    # round 2: chunked parse + bin
    off = 0
    lines_seen = 0
    buf: List[str] = []
    nums: List[int] = []
    nf = ds.num_total_features if fmt == "libsvm" else None

    def flush():
        nonlocal off, buf, nums
        if not buf:
            return
        lab, feats = _parse_chunk(buf, fmt, label_idx, nf, guard=g,
                                  line_numbers=nums)
        n = feats.shape[0]

        def _feature_bins(inner):
            f = ds.used_feature_map[inner]
            col = feats[:, f] if f < feats.shape[1] else \
                np.zeros(n, np.float64)
            return ds.mappers[inner].value_to_bin(col)

        if ds.bundle_plan is not None:
            ds.bins[:, off:off + n] = ds.bundle_plan.encode_columns(
                _feature_bins, n, dtype)
        else:
            for inner in range(len(ds.used_feature_map)):
                ds.bins[inner, off:off + n] = \
                    _feature_bins(inner).astype(dtype)
        labels[off:off + n] = lab.astype(np.float32)
        if weights is not None and weight_idx < feats.shape[1]:
            weights[off:off + n] = feats[:, weight_idx]
        if qids is not None and group_idx < feats.shape[1]:
            qids[off:off + n] = feats[:, group_idx]
        off += n
        buf = []
        nums = []

    for lineno, line in _numbered_data_lines(path, has_header):
        lines_seen += 1
        if lines_seen > num_data:
            break               # named below — not an assert, not a hang
        buf.append(line)
        nums.append(lineno)
        if len(buf) >= chunk_rows:
            flush()
    flush()

    if lines_seen != num_data:
        _drift_error(path, f"{num_data} data rows counted in round 1, "
                           f"{'>' if lines_seen > num_data else ''}"
                           f"{lines_seen} seen in round 2")
    if off + g.bad_total != num_data:
        _drift_error(path, f"{num_data} rows counted, {off} binned + "
                           f"{g.bad_total} quarantined")
    if off == 0:
        raise LightGBMError(
            f"Two-round loader: every row of {path} was quarantined "
            f"({g.bad_total} bad rows, see {g.quarantine_path}) — "
            f"no clean data to train on")

    if off < num_data:
        # quarantined rows: crop the preallocated arrays to the clean
        # count so bins/labels/metadata stay aligned
        ds.bins = np.ascontiguousarray(ds.bins[:, :off])
        labels = labels[:off]
        if weights is not None:
            weights = weights[:off]
        if qids is not None:
            qids = qids[:off]

    check_side_files_alignment(path, g.bad_total)
    ds.metadata = Metadata(off)
    ds.metadata.set_label(labels)
    ds.metadata.load_side_files(path)
    if weights is not None:
        ds.metadata.set_weights(weights)
    if qids is not None:
        ds.metadata.set_query_id(qids)
    g.finish()
    return ds
