"""Prometheus text exposition (format 0.0.4) over the obs registry.

The port's own copy of the JAX package's obs/prom.py: ``render()`` turns
a ``Registry.snapshot()`` into the text every scraper reads (counters,
gauges, histograms with cumulative ``_bucket{le=...}`` series whose
``+Inf`` bucket equals ``_count``), under the JAX package's
``lightgbm_tpu_`` namespace so one dashboard reads either server.
``parse_text()`` and ``histogram_series()`` are the matching minimal
parser the tests and ``chip_smoke.py`` validate a scrape with.

Labels ride inside the flat registry key in the sample syntax:
``labeled_name("serve_requests", model="canary")`` is the key
``serve_requests{model="canary"}``; ``render()`` groups keys sharing a
base name into one family with the labels attached per sample.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Mapping, Optional, Tuple

from .phases import sanitize

NAMESPACE = "lightgbm_tpu_"
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def metric_name(name: str) -> str:
    """A registry series name as a namespaced Prometheus metric name."""
    return NAMESPACE + sanitize(name)


def _escape_label(value: str) -> str:
    return (str(value).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _unescape_label(value: str) -> str:
    return re.sub(r"\\(.)",
                  lambda e: {"n": "\n"}.get(e.group(1), e.group(1)), value)


def _labels_inner(labels: Mapping[str, str]) -> str:
    return ",".join(f'{k}="{_escape_label(v)}"'
                    for k, v in sorted(labels.items()))


def labeled_name(name: str, labels: Optional[Mapping[str, str]] = None,
                 **kw: str) -> str:
    """Canonical flat registry key of a labeled series
    (``serve_requests{model="canary"}``): labels sorted, values
    escaped, so writers and readers agree on the key."""
    merged: Dict[str, str] = dict(labels or {})
    merged.update(kw)
    if not merged:
        return name
    return f"{name}{{{_labels_inner(merged)}}}"


def split_series(key: str) -> Tuple[str, Dict[str, str]]:
    """A registry key back into ``(base_name, labels)``; a key without a
    well-formed ``{k="v",...}`` suffix comes back verbatim, unlabeled."""
    if not key.endswith("}"):
        return key, {}
    brace = key.find("{")
    if brace <= 0:
        return key, {}
    body = key[brace + 1:-1]
    if re.sub(r"[,\s]", "", _LABEL_RE.sub("", body)):
        return key, {}
    labels = {m.group(1): _unescape_label(m.group(2))
              for m in _LABEL_RE.finditer(body)}
    return key[:brace], labels


def _labels_str(labels: Optional[Mapping[str, str]],
                extra: Optional[Mapping[str, str]] = None) -> str:
    merged: Dict[str, str] = dict(labels or {})
    merged.update(extra or {})
    return "{" + _labels_inner(merged) + "}" if merged else ""


def _fmt(v: float) -> str:
    """Integers bare (exact counter lines), non-finites spelled as the
    format says."""
    f = float(v)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if math.isnan(f):
        return "NaN"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _families(keys):
    """Registry keys grouped by base name, families and their samples in
    key order."""
    fams: Dict[str, List[Tuple[str, Dict[str, str]]]] = {}
    for key in keys:
        base, embedded = split_series(key)
        fams.setdefault(base, []).append((key, embedded))
    for base in sorted(fams):
        yield base, sorted(fams[base], key=lambda e: e[0])


def render(snap: Optional[Mapping[str, Any]] = None,
           labels: Optional[Mapping[str, str]] = None) -> str:
    """A registry snapshot (default: the process registry) as
    exposition text; ``labels`` (``{"rank": "1"}`` under a multi-process
    run, ``metrics_server.rank_labels``) go on every sample."""
    if snap is None:
        from . import registry
        snap = registry.snapshot()
    lines: List[str] = []
    for base, entries in _families(snap.get("counters", {})):
        m = metric_name(base)
        lines.append(f"# TYPE {m} counter")
        for key, embedded in entries:
            lines.append(f"{m}{_labels_str(labels, embedded)} "
                         f"{_fmt(snap['counters'][key])}")
    gauges = {k: v for k, v in snap.get("gauges", {}).items()
              if not isinstance(v, bool) and isinstance(v, (int, float))}
    for base, entries in _families(gauges):
        m = metric_name(base)
        lines.append(f"# TYPE {m} gauge")
        for key, embedded in entries:
            lines.append(f"{m}{_labels_str(labels, embedded)} "
                         f"{_fmt(gauges[key])}")
    for base, entries in _families(snap.get("histograms", {})):
        m = metric_name(base)
        lines.append(f"# TYPE {m} histogram")
        for key, embedded in entries:
            h = snap["histograms"][key]
            cum = 0
            for bound, c in zip(h["buckets"], h["counts"]):
                cum += int(c)
                lines.append(
                    f"{m}_bucket"
                    f"{_labels_str(labels, {**embedded, 'le': _fmt(bound)})}"
                    f" {cum}")
            cum += int(h["counts"][len(h["buckets"])])
            lines.append(
                f"{m}_bucket"
                f"{_labels_str(labels, {**embedded, 'le': '+Inf'})} {cum}")
            lines.append(
                f"{m}_sum{_labels_str(labels, embedded)} {_fmt(h['sum'])}")
            lines.append(
                f"{m}_count{_labels_str(labels, embedded)} "
                f"{_fmt(h['count'])}")
    return "\n".join(lines) + "\n"


def _parse_value(s: str) -> float:
    if s == "+Inf":
        return math.inf
    if s == "-Inf":
        return -math.inf
    if s == "NaN":
        return math.nan
    return float(s)


def parse_text(text: str) -> Dict[str, Any]:
    """An exposition -> ``{"types": {family: type}, "samples": [(name,
    labels, value), ...]}``; ValueError on any line that is neither a
    comment, blank, nor a well-formed sample."""
    types: Dict[str, str] = {}
    samples: List[Tuple[str, Dict[str, str], float]] = []
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) != 4:
                raise ValueError(f"line {lineno}: malformed TYPE: {line!r}")
            types[parts[2]] = parts[3]
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"line {lineno}: malformed sample: {line!r}")
        name, rawlabels, value = m.group(1), m.group(2), m.group(3)
        labels: Dict[str, str] = {}
        if rawlabels:
            if re.sub(r"[,\s]", "", _LABEL_RE.sub("", rawlabels)):
                raise ValueError(
                    f"line {lineno}: malformed labels: {rawlabels!r}")
            for lm in _LABEL_RE.finditer(rawlabels):
                labels[lm.group(1)] = _unescape_label(lm.group(2))
        samples.append((name, labels, _parse_value(value)))
    return {"types": types, "samples": samples}


def histogram_series(parsed: Mapping[str, Any], family: str,
                     match: Optional[Mapping[str, str]] = None
                     ) -> Dict[str, Any]:
    """One histogram of a family from parsed samples: ``{"buckets":
    [(le, cumulative), ...], "sum": x, "count": n}``.  ``match`` filters
    on non-``le`` labels; of several label sets left, the one with the
    fewest labels (the unlabeled aggregate) wins."""
    groups: Dict[Tuple, Dict[str, Any]] = {}
    for name, labels, value in parsed["samples"]:
        if match and any(labels.get(k) != v for k, v in match.items()):
            continue
        if name not in (family + "_bucket", family + "_sum",
                        family + "_count"):
            continue
        key = tuple(sorted((k, v) for k, v in labels.items() if k != "le"))
        g = groups.setdefault(key, {"buckets": [], "sum": None,
                                    "count": None})
        if name == family + "_bucket" and "le" in labels:
            g["buckets"].append((_parse_value(labels["le"]), value))
        elif name == family + "_sum":
            g["sum"] = value
        else:
            g["count"] = value
    if not groups:
        return {"buckets": [], "sum": None, "count": None}
    out = groups[min(groups, key=lambda k: (len(k), k))]
    out["buckets"].sort(key=lambda t: t[0])
    return out
