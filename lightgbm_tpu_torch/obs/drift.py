"""Data-drift observatory: the training-data fingerprint and the
serve-side collector.

The port's own copy of the JAX package's obs/drift.py (host numpy in
f64; for the same inputs it writes the same text, byte for byte):

- ``DataFingerprint``: what the training data looked like, built where
  ``io/dataset.py`` bins a matrix, from each mapper's FindBin occupancy
  and the full matrix (per-feature bin occupancy, missing rates, a label
  histogram; a raw-score histogram filled at the first model save).  It
  rides in the model text as an optional section after the ``feature
  importances`` footer; an absent section is no fingerprint, a truncated
  or garbled one a named ``LightGBMError``.  It carries its bin edges and
  category tables, so raw rows re-bin without the mappers.
- ``DriftCollector``: what served traffic looks like, accumulated off
  the response path.  ``CompiledForest`` offers every real (unpadded)
  batch and its raw scores through one attribute read (``_drift``); a
  daemon thread closes a window every ``drift_window`` seconds, re-bins
  the rows against the fingerprint and publishes ``drift_psi{model=,
  feature=}``, ``drift_score_psi{model=}`` and
  ``drift_missing_delta{model=,feature=}`` gauges, with KL and L-inf in
  ``stats()``.  ``drift=off`` leaves ``_drift`` as ``None``.

PSI = sum((a-e)*ln(a/e)) over eps-floored proportions; KL = actual
relative to expected; L-inf = max absolute proportion gap; feature
distances are taken over ``coarsen``-ed occupancy (<= ``PSI_GROUPS``
baseline-equal-mass groups).  PSI >= 0.25 is the classic "major shift",
the ``lifecycle_drift_threshold`` default.
"""

from __future__ import annotations

import collections
import re
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..utils.log import LightGBMError
from .prom import labeled_name
from .registry import inc as _inc
from .registry import set_gauge as _set_gauge

#: eps floor for PSI/KL proportions — standard practice so empty bins
#: contribute a bounded, not infinite, term
EPS = 1e-4

#: default number of label/score histogram bins
HIST_BINS = 16

SECTION_HEADER = "data_fingerprint"
SECTION_FOOTER = "end data_fingerprint"

_KIND_NUM = "num"
_KIND_CAT = "cat"


# ---------------------------------------------------------------------------
# distance vocabulary
# ---------------------------------------------------------------------------

def _props(counts, eps: float = EPS) -> Optional[np.ndarray]:
    """Counts -> eps-floored proportions; None when the histogram is
    empty (a distance against nothing is not zero, it is unknowable)."""
    c = np.asarray(counts, np.float64)
    total = c.sum()
    if not np.isfinite(total) or total <= 0:
        return None
    return np.maximum(c / total, eps)


def psi(expected, actual, eps: float = EPS) -> float:
    """Population stability index between two same-length histograms."""
    e, a = _props(expected, eps), _props(actual, eps)
    if e is None or a is None or e.shape != a.shape:
        return 0.0
    return float(np.sum((a - e) * np.log(a / e)))


def kl(expected, actual, eps: float = EPS) -> float:
    """KL(actual || expected) — how surprising the window is if the
    training distribution were still true."""
    e, a = _props(expected, eps), _props(actual, eps)
    if e is None or a is None or e.shape != a.shape:
        return 0.0
    return float(np.sum(a * np.log(a / e)))


def linf(expected, actual) -> float:
    """Max absolute per-bin proportion gap (no eps floor needed)."""
    e = np.asarray(expected, np.float64)
    a = np.asarray(actual, np.float64)
    if e.shape != a.shape or e.sum() <= 0 or a.sum() <= 0:
        return 0.0
    return float(np.max(np.abs(a / a.sum() - e / e.sum())))


#: distance group resolution: feature distances compare occupancy
#: coarsened to at most this many baseline-equal-mass groups
PSI_GROUPS = 16


def coarsen(expected, actual, groups: int = PSI_GROUPS):
    """Merge two aligned histograms into <= ``groups`` runs of adjacent
    bins holding roughly equal BASELINE mass.

    Full-resolution occupancy (up to max_bin bins) makes PSI a noise
    amplifier: a few hundred served rows against 255 bins reads as
    ~(bins-1)/rows =~ 0.6 of pure multinomial sampling noise — far past
    the 0.25 "major shift" line with zero real drift.  Practitioner PSI
    uses 10-20 buckets; equal-mass grouping against the TRAINING
    occupancy keeps every group populated and bounds in-distribution
    noise near (groups-1)/rows, while a genuine shift still piles whole
    groups of served mass where the baseline holds almost none.  Only
    the distances coarsen — raw counts stay full resolution everywhere
    (the collector-exactness pins compare them bin for bin)."""
    e = np.asarray(expected, np.float64)
    a = np.asarray(actual, np.float64)
    if e.shape != a.shape or e.size <= groups or e.sum() <= 0:
        return e, a
    cdf = np.cumsum(e) / e.sum()
    cut = np.searchsorted(cdf, np.arange(1, groups) / groups,
                          side="left") + 1
    starts = np.unique(np.concatenate([[0], cut]))
    starts = starts[starts < e.size]
    return np.add.reduceat(e, starts), np.add.reduceat(a, starts)


# ---------------------------------------------------------------------------
# fingerprint
# ---------------------------------------------------------------------------

def _fail(msg: str, *args) -> None:
    raise LightGBMError("Model file data_fingerprint section: " + msg % args)


def _fmt(values) -> str:
    return ",".join(f"{float(v):.17g}" for v in values)


def _fmt_int(values) -> str:
    return ",".join(str(int(v)) for v in values)


def _parse_floats(blob: str, what: str) -> np.ndarray:
    try:
        return np.asarray([float(v) for v in blob.split(",") if v != ""],
                          np.float64)
    except ValueError:
        _fail("%s is not a comma-separated float list — corrupt "
              "model file?", what)


def _parse_counts(blob: str, what: str) -> np.ndarray:
    try:
        out = np.asarray([int(v) for v in blob.split(",") if v != ""],
                         np.int64)
    except (ValueError, OverflowError):
        _fail("%s is not a comma-separated integer list — corrupt "
              "model file?", what)
    if out.size and out.min() < 0:
        _fail("%s has negative counts — corrupt model file?", what)
    return out


def _parse_hist(blob: str, what: str) -> Dict[str, np.ndarray]:
    parts = blob.split(":")
    if len(parts) != 2:
        _fail("%s must be '<edges>:<counts>'", what)
    edges = _parse_floats(parts[0], what + " edges")
    counts = _parse_counts(parts[1], what + " counts")
    if edges.size != counts.size + 1:
        _fail("%s has %d edges for %d counts (need counts+1)",
              what, edges.size, counts.size)
    return {"edges": edges, "counts": counts}


def _make_hist(values: np.ndarray, bins: int = HIST_BINS
               ) -> Optional[Dict[str, np.ndarray]]:
    v = np.asarray(values, np.float64).ravel()
    v = v[np.isfinite(v)]
    if v.size == 0:
        return None
    counts, edges = np.histogram(v, bins=bins)
    return {"edges": edges, "counts": counts.astype(np.int64)}


def _hist_counts(hist: Dict[str, np.ndarray],
                 values: np.ndarray) -> np.ndarray:
    """Re-histogram ``values`` onto an existing hist's edges; out-of-range
    values clamp into the end bins (a shifted score is drift evidence,
    not discardable)."""
    edges = hist["edges"]
    v = np.asarray(values, np.float64).ravel()
    v = v[np.isfinite(v)]
    v = np.clip(v, edges[0], edges[-1])
    counts, _ = np.histogram(v, bins=edges)
    return counts.astype(np.int64)


class DataFingerprint:
    """Training-data summary carried in the model artifact.

    ``features`` is a list of dicts, one per non-trivial training
    feature: ``{"index": real column index, "name": str, "kind":
    "num"|"cat", "missing_rate": float, "edges": float array (kind num,
    the bin upper bounds, last = +inf) or "cats": int list (kind cat),
    "counts": int64 bin-occupancy array}``.
    """

    __slots__ = ("version", "num_rows", "features", "label_hist",
                 "score_hist")

    def __init__(self, num_rows: int = 0,
                 features: Optional[List[Dict[str, Any]]] = None,
                 label_hist: Optional[Dict[str, np.ndarray]] = None,
                 score_hist: Optional[Dict[str, np.ndarray]] = None):
        self.version = 1
        self.num_rows = int(num_rows)
        self.features = list(features or [])
        self.label_hist = label_hist
        self.score_hist = score_hist

    # -- construction ---------------------------------------------------
    @classmethod
    def from_training(cls, mappers: Sequence, real_indices: Sequence[int],
                      feature_names: Sequence[str], data: np.ndarray,
                      label: Optional[np.ndarray],
                      occupancy: Optional[Sequence[np.ndarray]] = None,
                      nan_counts: Optional[np.ndarray] = None
                      ) -> "DataFingerprint":
        """Built once at bin time (io/dataset.py from_matrix): occupancy
        straight from each mapper's retained FindBin ``bin_counts``,
        missing rates exact over the full column.  A caller that has
        binned the full matrix already passes ``occupancy`` (each
        mapper's ``bincount`` of its ``value_to_bin`` codes, the same
        bins ``rebin_counts`` gives) and ``nan_counts`` (NaNs per real
        column), which spare two passes over ``data``'s columns."""
        feats: List[Dict[str, Any]] = []
        n = int(data.shape[0])
        for mapper, real in zip(mappers, real_indices):
            real = int(real)
            name = (str(feature_names[real])
                    if real < len(feature_names) else f"Column_{real}")
            counts = np.asarray(
                getattr(mapper, "bin_counts", None)
                if getattr(mapper, "bin_counts", None) is not None
                else [], np.int64)
            if counts.size != mapper.num_bin:
                # defensive: a mapper restored from a pre-drift binary
                # cache has no sample counts — fingerprint this feature
                # as uniform-unknown rather than lying
                counts = np.zeros(mapper.num_bin, np.int64)
            if not n:
                missing = 0.0
            elif nan_counts is not None:
                missing = int(nan_counts[real]) / n
            else:
                missing = float(np.isnan(
                    np.asarray(data[:, real], np.float64)).mean())
            rec: Dict[str, Any] = {
                "index": real, "name": name, "missing_rate": missing,
                "counts": counts,
            }
            if getattr(mapper, "bin_type", 0) == 1:  # CATEGORICAL
                rec["kind"] = _KIND_CAT
                rec["cats"] = [int(c) for c in mapper.bin_2_categorical]
            else:
                rec["kind"] = _KIND_NUM
                edges = np.asarray(mapper.bin_upper_bound, np.float64)
                # a NaN-bearing FindBin sample can poison one midpoint
                # boundary; for searchsorted a trailing NaN compares
                # exactly like +inf, so this rewrite changes no bin
                # assignment — and keeps the serialized section NaN-free
                rec["edges"] = np.where(np.isnan(edges), np.inf, edges)
            feats.append(rec)
        label_hist = _make_hist(label) if label is not None else None
        fp = cls(num_rows=int(data.shape[0]), features=feats,
                 label_hist=label_hist)
        if n:
            # baseline occupancy = an exact value_to_bin rebin of the
            # full matrix, not the FindBin sample counts: the sample
            # files NaN under the last distinct value while serving bins
            # NaN to bin 0, and that asymmetry would read as permanent
            # drift on any NaN-bearing dataset.  Same bin space either
            # way — the mapper's own edges.
            if occupancy is None:
                occupancy = fp.rebin_counts(data)
            for feat, counts in zip(fp.features, occupancy):
                feat["counts"] = np.asarray(counts, np.int64)
        return fp

    def set_score_hist(self, raw_scores: np.ndarray) -> None:
        """Fill the training raw-score histogram (called at model-save
        time from the live training score buffer; idempotent-by-caller)."""
        self.score_hist = _make_hist(raw_scores)

    # -- re-binning serve rows into training-bin space ------------------
    def rebin_counts(self, X: np.ndarray) -> List[np.ndarray]:
        """Per-feature occupancy of ``X``'s rows in this fingerprint's
        bin space — the exact ``BinMapper.value_to_bin`` semantics
        (io/binning.py): first upper bound >= value, NaN in bin 0,
        unknown categories in the last bin."""
        X = np.asarray(X, np.float64)
        out: List[np.ndarray] = []
        for feat in self.features:
            nb = len(feat["counts"])
            idx = feat["index"]
            if idx >= X.shape[1] or X.shape[0] == 0:
                out.append(np.zeros(nb, np.int64))
                continue
            col = X[:, idx]
            if feat["kind"] == _KIND_NUM:
                edges = feat["edges"]
                bins = np.searchsorted(edges[:-1], col, side="left")
                bins = np.where(np.isnan(col), 0, bins)
            else:
                bins = np.full(col.shape, nb - 1, np.int64)
                with np.errstate(invalid="ignore"):
                    ints = col.astype(np.int64)
                for pos, cat in enumerate(feat["cats"]):
                    if pos < nb:
                        bins[ints == cat] = pos
            out.append(np.bincount(bins.astype(np.int64),
                                   minlength=nb)[:nb].astype(np.int64))
        return out

    def missing_rates(self, X: np.ndarray) -> List[float]:
        X = np.asarray(X, np.float64)
        out = []
        for feat in self.features:
            idx = feat["index"]
            if idx >= X.shape[1] or X.shape[0] == 0:
                out.append(0.0)
            else:
                out.append(float((~np.isfinite(X[:, idx])).mean()))
        return out

    # -- text serialization --------------------------------------------
    def to_text(self) -> str:
        """The optional model-file section (see module docstring)."""
        lines = [SECTION_HEADER, f"version={self.version}",
                 f"num_rows={self.num_rows}"]
        if self.label_hist is not None:
            lines.append("label_hist=%s:%s"
                         % (_fmt(self.label_hist["edges"]),
                            _fmt_int(self.label_hist["counts"])))
        if self.score_hist is not None:
            lines.append("score_hist=%s:%s"
                         % (_fmt(self.score_hist["edges"]),
                            _fmt_int(self.score_hist["counts"])))
        for feat in self.features:
            vals = (_fmt(feat["edges"]) if feat["kind"] == _KIND_NUM
                    else _fmt_int(feat["cats"]))
            lines.append("feature=%d:%s:%.17g:%s:%s:%s"
                         % (feat["index"], feat["kind"],
                            feat["missing_rate"], vals,
                            _fmt_int(feat["counts"]), feat["name"]))
        lines.append(SECTION_FOOTER)
        return "\n".join(lines) + "\n"

    @classmethod
    def parse(cls, text: str) -> Optional["DataFingerprint"]:
        """Parse the fingerprint section out of a model-text tail.

        Absent header -> ``None`` (pre-drift files load unchanged).
        Present but truncated (no ``end data_fingerprint``) or garbled
        in any field -> a named ``LightGBMError`` — the fuzz contract:
        dirt is a classified event, never an unclassified crash."""
        m = re.search(r"(?m)^data_fingerprint\s*$", text)
        if m is None:
            return None
        end = re.search(r"(?m)^end data_fingerprint\s*$", text[m.end():])
        if end is None:
            _fail("no '%s' terminator — truncated mid-write? (re-save "
                  "the model or restore from a good copy)", SECTION_FOOTER)
        body = text[m.end():m.end() + end.start()]
        fp = cls()
        saw_version = False
        for raw_line in body.splitlines():
            line = raw_line.strip()
            if not line:
                continue
            if "=" not in line:
                _fail("unparseable line %r", raw_line[:80])
            key, val = line.split("=", 1)
            key = key.strip()
            if key == "version":
                try:
                    ver = int(val)
                except ValueError:
                    _fail("version=%r is not an integer", val[:40])
                if ver != 1:
                    _fail("version=%d is not supported (this build "
                          "reads version 1)", ver)
                fp.version = ver
                saw_version = True
            elif key == "num_rows":
                try:
                    fp.num_rows = int(val)
                except ValueError:
                    _fail("num_rows=%r is not an integer", val[:40])
                if fp.num_rows < 0:
                    _fail("num_rows=%d is negative", fp.num_rows)
            elif key == "label_hist":
                fp.label_hist = _parse_hist(val, "label_hist")
            elif key == "score_hist":
                fp.score_hist = _parse_hist(val, "score_hist")
            elif key == "feature":
                fp.features.append(cls._parse_feature(val))
            else:
                _fail("unknown key %r — corrupt model file?", key[:40])
        if not saw_version:
            _fail("missing version line")
        return fp

    @staticmethod
    def _parse_feature(val: str) -> Dict[str, Any]:
        parts = val.split(":", 5)
        if len(parts) != 6:
            _fail("feature line needs 6 ':'-fields "
                  "(idx:kind:missing:values:counts:name), got %d",
                  len(parts))
        idx_s, kind, miss_s, vals_s, counts_s, name = parts
        try:
            idx = int(idx_s)
        except ValueError:
            _fail("feature index %r is not an integer", idx_s[:40])
        if idx < 0:
            _fail("feature index %d is negative", idx)
        if kind not in (_KIND_NUM, _KIND_CAT):
            _fail("feature kind %r is not 'num' or 'cat'", kind[:40])
        try:
            miss = float(miss_s)
        except ValueError:
            _fail("feature missing_rate %r is not a number", miss_s[:40])
        if not (np.isfinite(miss) and 0.0 <= miss <= 1.0):
            _fail("feature missing_rate %r is outside [0, 1]", miss_s[:40])
        counts = _parse_counts(counts_s, f"feature {idx} counts")
        if counts.size < 1:
            _fail("feature %d has an empty counts list", idx)
        rec: Dict[str, Any] = {"index": idx, "kind": kind,
                               "missing_rate": miss, "counts": counts,
                               "name": name}
        if kind == _KIND_NUM:
            edges = _parse_floats(vals_s, f"feature {idx} edges")
            if edges.size != counts.size:
                _fail("feature %d has %d edges for %d counts (bin "
                      "upper bounds must match bins)", idx, edges.size,
                      counts.size)
            if np.isnan(edges).any():
                _fail("feature %d has NaN bin edges", idx)
            rec["edges"] = edges
        else:
            cats = _parse_counts(vals_s, f"feature {idx} categories") \
                if vals_s else np.zeros(0, np.int64)
            rec["cats"] = [int(c) for c in cats]
        return rec


def parse_model_fingerprint(text: str) -> Optional[DataFingerprint]:
    """Fingerprint of a full model text (searches the post-footer tail
    only, so tree/header content can never alias the section marker).
    ``None`` when the file predates fingerprints."""
    footer = text.find("\nfeature importances")
    tail = text[footer:] if footer >= 0 else text
    return DataFingerprint.parse(tail)


# ---------------------------------------------------------------------------
# fingerprint-vs-fingerprint comparison (train_delta skew check)
# ---------------------------------------------------------------------------

def compare_fingerprints(expected: DataFingerprint,
                         actual: DataFingerprint,
                         top_k: int = 5) -> Dict[str, Any]:
    """PSI/KL/L-inf per feature name shared by both fingerprints (same
    vocabulary as the serve collector).  Features whose bin counts
    disagree in length (different max_bin across retrains) abstain."""
    by_name = {f["name"]: f for f in expected.features}
    rows: List[Dict[str, Any]] = []
    for feat in actual.features:
        base = by_name.get(feat["name"])
        if base is None or len(base["counts"]) != len(feat["counts"]):
            continue
        eg, ag = coarsen(base["counts"], feat["counts"])
        rows.append({
            "feature": feat["name"],
            "psi": round(psi(eg, ag), 6),
            "kl": round(kl(eg, ag), 6),
            "linf": round(linf(eg, ag), 6),
            "missing_delta": round(feat["missing_rate"]
                                   - base["missing_rate"], 6),
        })
    rows.sort(key=lambda r: -r["psi"])
    score_psi = None
    if (expected.score_hist is not None and actual.score_hist is not None
            and expected.score_hist["counts"].size
            == actual.score_hist["counts"].size):
        score_psi = round(psi(expected.score_hist["counts"],
                              actual.score_hist["counts"]), 6)
    label_psi = None
    if (expected.label_hist is not None and actual.label_hist is not None
            and expected.label_hist["edges"].size
            == actual.label_hist["edges"].size
            and np.allclose(expected.label_hist["edges"],
                            actual.label_hist["edges"])):
        # label PSI only when the histograms share edges (two datasets
        # binned over different label ranges abstain — per-feature PSI
        # is the load-bearing signal)
        label_psi = round(psi(expected.label_hist["counts"],
                              actual.label_hist["counts"]), 6)
    return {"max_psi": rows[0]["psi"] if rows else 0.0,
            "features": rows[:max(int(top_k), 1)],
            "score_psi": score_psi, "label_psi": label_psi,
            "expected_rows": expected.num_rows,
            "actual_rows": actual.num_rows}


def compare_to_data(expected: DataFingerprint, X,
                    top_k: int = 5) -> Dict[str, Any]:
    """PSI/KL/L-inf of a RAW feature matrix against a fingerprint,
    rebinned under the fingerprint's own edges — the same comparison
    the serve collector makes.  This is the train/serve skew check's
    path: two models' fingerprints bin their own data under their own
    ladders (shifted data re-binned by its own quantiles looks uniform
    again), so fingerprint-vs-fingerprint occupancy is blind to shift;
    data-vs-fingerprint is not."""
    X = np.asarray(X, np.float64)
    if X.ndim == 1:
        X = X.reshape(-1, 1)
    counts = expected.rebin_counts(X)
    missing = expected.missing_rates(X)
    rows: List[Dict[str, Any]] = []
    for feat, cnt, miss in zip(expected.features, counts, missing):
        eg, ag = coarsen(feat["counts"], cnt)
        rows.append({
            "feature": feat["name"],
            "psi": round(psi(eg, ag), 6),
            "kl": round(kl(eg, ag), 6),
            "linf": round(linf(eg, ag), 6),
            "missing_delta": round(miss - feat["missing_rate"], 6),
        })
    rows.sort(key=lambda r: -r["psi"])
    return {"max_psi": rows[0]["psi"] if rows else 0.0,
            "features": rows[:max(int(top_k), 1)],
            "score_psi": None, "label_psi": None,
            "expected_rows": expected.num_rows,
            "actual_rows": int(X.shape[0])}


# ---------------------------------------------------------------------------
# serve-side streaming collector
# ---------------------------------------------------------------------------

class DriftCollector:
    """Windowed serve-traffic drift accumulator for ONE model.

    ``offer(rows, scores)`` is the CompiledForest hook: O(1) under a
    lock, bounded buffer (past ``max_rows`` the batch is dropped and
    counted — drift math is best-effort and must never slow, shed, or
    block a predict).  A daemon thread closes a window every
    ``window_s`` seconds: re-bins the buffered rows against the
    training fingerprint, publishes the ``drift_*`` gauges, and appends
    the window to a bounded history the lifecycle drift gate reads
    (``sustained`` = PSI above ``threshold`` in >= ``consecutive``
    completed windows).  ``flush()`` closes a window synchronously
    (tests, bench).  One collector instance is shared by every replica
    clone of the model, so fleet dispatch and micro-batch coalescing
    aggregate into a single occupancy — tests pin that the counts equal
    a single-replica offline rebin of the same rows, exactly.
    """

    def __init__(self, fingerprint: DataFingerprint, model: str = "primary",
                 window_s: float = 30.0, top_k: int = 5,
                 threshold: float = 0.0, max_rows: int = 1 << 16,
                 history: int = 64, consecutive: int = 2,
                 start_thread: bool = True):
        if window_s <= 0:
            raise ValueError("drift_window must be > 0")
        self.fingerprint = fingerprint
        self.model = str(model)
        self.window_s = float(window_s)
        self.top_k = max(int(top_k), 1)
        self.threshold = float(threshold)
        self.max_rows = max(int(max_rows), 1)
        self.consecutive = max(int(consecutive), 1)
        self._cond = threading.Condition()
        self._compute_lock = threading.Lock()
        self._rows_buf: List[np.ndarray] = []
        self._scores_buf: List[np.ndarray] = []
        self._buf_rows = 0
        self._stop = False
        self._windows: "collections.deque[Dict[str, Any]]" = \
            collections.deque(maxlen=max(int(history), self.consecutive))
        self._streak: Dict[str, int] = {}
        self._rows_total = 0
        self._rows_dropped = 0
        self._windows_total = 0
        self._overhead_s = 0.0
        self._thread: Optional[threading.Thread] = None
        if start_thread:
            self._thread = threading.Thread(
                target=self._run, name=f"lgbt-serve-drift-{self.model}",
                daemon=True)
            self._thread.start()

    # -- hot-path hook --------------------------------------------------
    def offer(self, rows: np.ndarray,
              scores: Optional[np.ndarray] = None) -> bool:
        """Record one predicted batch (REAL rows — padding never reaches
        this).  Returns True when buffered (tests)."""
        n = int(np.shape(rows)[0]) if np.ndim(rows) else 0
        if n == 0:
            return False
        with self._cond:
            if self._stop:
                return False
            if self._buf_rows + n > self.max_rows:
                self._rows_dropped += n
                return False
            self._rows_buf.append(rows)
            if scores is not None:
                self._scores_buf.append(np.asarray(scores, np.float64))
            self._buf_rows += n
            return True

    # -- window machinery ----------------------------------------------
    def _run(self) -> None:
        while True:
            with self._cond:
                self._cond.wait(timeout=self.window_s)
                if self._stop:
                    break
            self._close_window()
        self._close_window()  # final drain on close()

    def flush(self) -> Optional[Dict[str, Any]]:
        """Close one window synchronously on the calling thread; returns
        the window record (None when no rows were buffered)."""
        return self._close_window()

    def _close_window(self) -> Optional[Dict[str, Any]]:
        with self._compute_lock:
            with self._cond:
                rows_buf = self._rows_buf
                scores_buf = self._scores_buf
                n = self._buf_rows
                self._rows_buf, self._scores_buf, self._buf_rows = [], [], 0
            if n == 0:
                return None
            t0 = time.perf_counter()
            win = self._compute(rows_buf, scores_buf, n)
            dt = time.perf_counter() - t0
            with self._cond:
                self._windows.append(win)
                self._windows_total += 1
                self._rows_total += n
                self._overhead_s += dt
                for name, rec in win["features"].items():
                    if self.threshold > 0 and rec["psi"] > self.threshold:
                        self._streak[name] = self._streak.get(name, 0) + 1
                    else:
                        self._streak.pop(name, None)
            self._publish(win)
            return win

    def _compute(self, rows_buf: List[np.ndarray],
                 scores_buf: List[np.ndarray], n: int) -> Dict[str, Any]:
        fp = self.fingerprint
        X = np.concatenate(
            [np.asarray(r, np.float64).reshape(np.shape(r)[0], -1)
             for r in rows_buf], axis=0)
        counts = fp.rebin_counts(X)
        missing = fp.missing_rates(X)
        feats: Dict[str, Dict[str, Any]] = {}
        for feat, cnt, miss in zip(fp.features, counts, missing):
            eg, ag = coarsen(feat["counts"], cnt)
            feats[feat["name"]] = {
                "psi": round(psi(eg, ag), 6),
                "kl": round(kl(eg, ag), 6),
                "linf": round(linf(eg, ag), 6),
                "missing_delta": round(miss - feat["missing_rate"], 6),
                "counts": cnt,
            }
        score_psi = None
        if fp.score_hist is not None and scores_buf:
            sc = np.concatenate([s.ravel() for s in scores_buf])
            score_psi = round(psi(fp.score_hist["counts"],
                                  _hist_counts(fp.score_hist, sc)), 6)
        top = sorted(feats, key=lambda f: -feats[f]["psi"])[:self.top_k]
        return {"rows": n, "features": feats, "score_psi": score_psi,
                "top": top}

    def _publish(self, win: Dict[str, Any]) -> None:
        m = self.model
        for name in win["top"]:
            rec = win["features"][name]
            _set_gauge(labeled_name("drift_psi", model=m, feature=name),
                       rec["psi"])
            _set_gauge(labeled_name("drift_missing_delta", model=m,
                                    feature=name), rec["missing_delta"])
        if win["score_psi"] is not None:
            _set_gauge(labeled_name("drift_score_psi", model=m),
                       win["score_psi"])
        _inc(labeled_name("drift_windows_total", model=m))
        _inc(labeled_name("drift_rows_total", model=m), win["rows"])
        _set_gauge(labeled_name("drift_overhead_seconds", model=m),
                   round(self._overhead_s, 6))
        if self._rows_dropped:
            _set_gauge(labeled_name("drift_rows_dropped_total", model=m),
                       self._rows_dropped)

    # -- consumers ------------------------------------------------------
    def sustained_offenders(self) -> List[str]:
        """Features whose window PSI exceeded ``threshold`` in the last
        ``consecutive`` completed windows — the lifecycle gate's
        evidence (one noisy window never votes rollback)."""
        with self._cond:
            return sorted(name for name, k in self._streak.items()
                          if k >= self.consecutive)

    def stats(self) -> Dict[str, Any]:
        with self._cond:
            last = self._windows[-1] if self._windows else None
            trajectory = [
                {"rows": w["rows"], "score_psi": w["score_psi"],
                 "max_psi": (max((r["psi"] for r in w["features"].values()),
                                 default=0.0)),
                 "top": list(w["top"])}
                for w in self._windows]
            out: Dict[str, Any] = {
                "model": self.model, "window_s": self.window_s,
                "windows": self._windows_total, "rows": self._rows_total,
                "dropped": self._rows_dropped,
                "buffered_rows": self._buf_rows,
                "overhead_s": round(self._overhead_s, 6),
                "trajectory": trajectory,
                "sustained": {
                    "threshold": self.threshold,
                    "consecutive": self.consecutive,
                    "offenders": sorted(
                        name for name, k in self._streak.items()
                        if k >= self.consecutive)},
            }
            if last is not None:
                out["last"] = {
                    "rows": last["rows"], "score_psi": last["score_psi"],
                    "top": [{"feature": name, **{
                        k: v for k, v in last["features"][name].items()
                        if k != "counts"}}
                        for name in last["top"]]}
            return out

    def close(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=5.0)
        else:
            self._close_window()
