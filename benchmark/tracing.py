"""Reads a ``torch.profiler`` Chrome trace into the numbers the per-layer
readers take: the device's kernels by name, its busy time (the union of
kernel, copy and set intervals), the traced window's length, the host's
named ranges and the longest device idle gaps with what the host was
doing in each."""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Tuple

_DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST = ("user_annotation", "cpu_op", "python_function", "cuda_runtime")


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _innermost(spans, points):
    """For each point (sorted), the name of the latest-starting span that
    still covers it (spans of one thread nest), or None."""
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in spans)
    out, stack, i = [], [], 0
    for p in points:
        while i < len(spans) and spans[i][0] <= p:
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def summarize(path: str) -> Dict:
    """Times in seconds."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    dev = [e for e in xs if e.get("cat") in _DEVICE]
    host = [e for e in xs if e.get("cat") in _HOST]
    t0 = min(e["ts"] for e in xs)
    t1 = max(e["ts"] + e["dur"] for e in xs)
    busy = _union([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    kernels: Dict[str, List[float]] = defaultdict(list)
    for e in dev:
        if e.get("cat") == "kernel":
            kernels[e["name"]].append(e["dur"] * 1e-6)
    ranges: Dict[str, float] = defaultdict(float)
    for e in host:
        if e.get("cat") == "user_annotation":
            ranges[e["name"]] += e["dur"] * 1e-6
    # every idle gap, named by the innermost program range and host
    # operation running at its middle
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    idle = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    mids = [(a + b) / 2 for a, b in idle]
    inner_range = _innermost([e for e in host
                              if e.get("cat") == "user_annotation"], mids)
    inner_op = _innermost([e for e in host if e.get("cat") != "user_annotation"],
                          mids)
    gaps: Dict[str, float] = defaultdict(float)
    for (a, b), r, o in zip(idle, inner_range, inner_op):
        gaps[f"{r or 'no range'}: {o or 'no host op'}"] += (b - a) * 1e-6
    return {
        "window_s": (t1 - t0) * 1e-6,
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "kernels": {k: (len(v), sum(v)) for k, v in kernels.items()},
        "kernel_count": sum(len(v) for v in kernels.values()),
        "ranges": dict(ranges),
        "idle_gaps": sorted(gaps.items(), key=lambda kv: -kv[1])[:10],
        "device_ops": sorted(((k, sum(v)) for k, v in kernels.items()),
                             key=lambda kv: -kv[1])[:10],
    }


def kernel_seconds(summary: Dict, fragment: str) -> Tuple[int, float]:
    """(launches, device seconds) of the kernels whose name holds
    ``fragment``."""
    n, s = 0, 0.0
    for name, (cnt, sec) in summary["kernels"].items():
        if fragment in name:
            n += cnt
            s += sec
    return n, s


def idle_pct(summary: Dict):
    if not summary or summary["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])
