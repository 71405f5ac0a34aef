"""Offline run report over per-iteration JSONL event streams.

The port's copy of the JAX package's obs/report.py.  ``python -m
lightgbm_tpu_torch obs-report run.jsonl [more.jsonl ...]
[--format=json|table] [--top=5]`` summarizes what a training run did
from its ``events_file`` stream alone (no model, no live process):

- the per-phase wall-time breakdown (the TIMETAG deltas each record
  carries, summed; empty until the port's device-time attribution
  lands, as in a JAX run without TIMETAG),
- committed iteration counts and the total wall time,
- the slowest-k iterations,
- NaN-containment and saturation incidents (``nan_poisoned`` /
  ``saturated`` / ``discarded``),
- collective-traffic totals (the distributed learners' cumulative
  bytes and calls),
- each dataset's metric trajectory: first, best, last.

Several files concatenate (a multi-process run writes one stream a
rank); per-file counts are reported so overlapping indices show.  The
same command reads the sibling inputs, with the JAX package's formats:

- ``--compile=<ledger.jsonl>``: a compile section (totals, seconds a
  program, the slowest events with their shapes);
- ``--traces``: the positional files are Chrome trace-event JSON (the
  ``trace_events_file`` export): per-root span stats, coalesce fan-in
  and the critical path of the slowest traces;
- ``--profile``: the positional files are registry snapshots
  (``obs.snapshot()`` dumps; none = the live registry), read for the
  device-time series (``devprof_*``, ``h2d_*`` / ``d2h_*``);
- ``--drift``: the drift observatory's offender table from registry
  snapshots or ``/stats`` drift blocks.

The compile ledger and the device-time series are written by the port's
``obs/compile_ledger.py`` (one event an nvcc build) and
``obs/devprof.py``, or by the JAX package's: each section reads either
package's files alike.  ``--profile``'s device row is
``devcaps.capabilities()``, the card's peaks.
"""

from __future__ import annotations

import json
import sys
from typing import Any, Dict, List, Optional, Sequence

from . import devcaps
from .compile_ledger import read_ledger
from .events import read_events


def _merge_by_iter(evs: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Collapse multiple records sharing one iteration index into one,
    with the recorder's own merge semantics (dict fields key-wise,
    scalars last-write-wins).  The commit-on-advance stream can emit a
    late producer's fields as a second record for an already-committed
    index (e.g. a pipelined tree shape landing after a NaN-poisoned
    round forced an early commit) — per iteration they are ONE event."""
    merged: Dict[int, Dict[str, Any]] = {}
    order: List[int] = []
    for e in evs:
        it = int(e.get("iter", -1))
        rec = merged.get(it)
        if rec is None:
            merged[it] = rec = {}
            order.append(it)
        for k, v in e.items():
            if isinstance(v, dict) and isinstance(rec.get(k), dict):
                rec[k].update(v)
            else:
                rec[k] = dict(v) if isinstance(v, dict) else v
    return [merged[it] for it in order]


def summarize_compile(path: str, top_k: int = 5) -> Dict[str, Any]:
    """Summarize a compile_ledger.jsonl: totals, per-program seconds,
    slowest-k events with shapes (the ``--compile=`` section)."""
    evs = read_ledger(path)
    per_program: Dict[str, Dict[str, Any]] = {}
    for e in evs:
        st = per_program.setdefault(str(e.get("program", "?")),
                                    {"count": 0, "seconds": 0.0})
        st["count"] += 1
        st["seconds"] += float(e.get("seconds", 0.0))
    for st in per_program.values():
        st["seconds"] = round(st["seconds"], 3)
    evs.sort(key=lambda e: -float(e.get("seconds", 0.0)))
    return {
        "file": str(path),
        "count": len(evs),
        "seconds_total": round(sum(float(e.get("seconds", 0.0))
                                   for e in evs), 3),
        "programs": per_program,
        "slowest": [{"program": e.get("program"),
                     "shapes": e.get("shapes"),
                     "seconds": e.get("seconds")}
                    for e in evs[: max(int(top_k), 0)]],
    }


def summarize(paths: Sequence[str], top_k: int = 5,
              compile_path: Optional[str] = None) -> Dict[str, Any]:
    """Aggregate one or more event files into a report dict (the
    ``--format=json`` payload; ``render_table`` prints the same dict).
    Records are merged per iteration index WITHIN each file (ranks/folds
    in separate files stay separate events)."""
    events: List[Dict[str, Any]] = []
    per_file: Dict[str, int] = {}
    comm_bytes = 0
    comm_calls = 0
    for p in paths:
        evs = read_events(p)
        per_file[str(p)] = len(evs)
        merged = _merge_by_iter(evs)
        events.extend(merged)
        # the comm counters are CUMULATIVE within one stream, and each
        # file (rank/fold) is an independent account: take the max per
        # file, then sum across files — max over the concatenation would
        # report one worker's traffic as the whole run's
        comm_bytes += max((int(e.get("comm_bytes_cum", 0) or 0)
                           for e in merged), default=0)
        comm_calls += max((int(e.get("comm_calls_cum", 0) or 0)
                           for e in merged), default=0)

    phases: Dict[str, float] = {}
    wall_total = 0.0
    timed: List[Dict[str, Any]] = []
    nan_incidents: List[Dict[str, Any]] = []
    saturated: List[int] = []
    discarded: List[int] = []
    eval_traj: Dict[str, Dict[str, List]] = {}
    committed = 0

    for e in events:
        it = int(e.get("iter", -1))
        if "wall_s" in e:
            wall_total += float(e["wall_s"])
            timed.append({"iter": it, "wall_s": float(e["wall_s"])})
        for k, v in (e.get("phases") or {}).items():
            phases[k] = phases.get(k, 0.0) + float(v)
        if e.get("nan_poisoned"):
            nan_incidents.append({"iter": it,
                                  "what": e["nan_poisoned"],
                                  "policy": e.get("nan_policy")})
        if e.get("saturated"):
            saturated.append(it)
        if e.get("discarded"):
            discarded.append(it)
        if not e.get("saturated") and not e.get("discarded"):
            committed += 1
        for ds, metrics in (e.get("eval") or {}).items():
            for name, v in (metrics or {}).items():
                if v is None:
                    continue
                eval_traj.setdefault(ds, {}).setdefault(name, []).append(
                    (it, float(v)))

    timed.sort(key=lambda d: -d["wall_s"])
    eval_summary: Dict[str, Dict[str, Dict[str, Any]]] = {}
    for ds, metrics in eval_traj.items():
        eval_summary[ds] = {}
        for name, series in metrics.items():
            values = [v for _, v in series]
            # direction-agnostic extremes: report both, the reader knows
            # which way the metric improves
            mn_i, mn = min(series, key=lambda t: t[1])
            mx_i, mx = max(series, key=lambda t: t[1])
            eval_summary[ds][name] = {
                "first": values[0], "last": values[-1],
                "min": mn, "min_iter": mn_i,
                "max": mx, "max_iter": mx_i,
                "n": len(values),
            }

    rep: Dict[str, Any] = {
        "files": per_file,
        "events": len(events),
        "iterations": committed,
        "wall_s_total": round(wall_total, 6),
        "phase_seconds": {k: round(v, 6)
                          for k, v in sorted(phases.items())},
        "slowest": timed[:max(int(top_k), 0)],
        "incidents": {
            "nan": nan_incidents,
            "saturated_iters": saturated,
            "discarded_iters": discarded,
        },
        "comm": {"bytes_cum": comm_bytes, "calls_cum": comm_calls},
        "eval": eval_summary,
    }
    if compile_path:
        rep["compile"] = summarize_compile(compile_path, top_k=top_k)
    return rep


def profile_summary(snap: Optional[Dict[str, Any]] = None,
                    top_k: int = 5) -> Dict[str, Any]:
    """The devprof decomposition as one JSON-ready dict, computed from a
    registry snapshot (default: the live process registry) — every field
    derives from series devprof already published, so a snapshot written
    by one process reports identically in another."""
    from . import registry as _registry
    if snap is None:
        snap = _registry.REGISTRY.snapshot()
    g = dict(snap.get("gauges", {}))
    c = dict(snap.get("counters", {}))
    h = dict(snap.get("histograms", {}))
    interval = int(g.get("devprof_sample_interval", 0) or 0)
    mode = "off" if interval <= 0 else \
        ("full" if interval == 1 else f"sample:{interval}")

    programs: Dict[str, Dict[str, Any]] = {}
    prefix = "devprof_device_seconds_est_"
    for k, v in g.items():
        if not k.startswith(prefix):
            continue
        prog = k[len(prefix):]
        if prog == "total":
            continue
        programs[prog] = {
            "device_seconds_est": float(v),
            "samples": int(c.get("devprof_samples_" + prog, 0)),
            "dispatches": int(c.get("devprof_dispatches_" + prog, 0)),
            "flops": g.get("devprof_flops_" + prog),
            "bytes_accessed": g.get("devprof_bytes_accessed_" + prog),
            "output_bytes": g.get("devprof_output_bytes_" + prog),
            "achieved_flops": g.get("devprof_achieved_flops_" + prog),
            "roofline_pct": g.get("devprof_roofline_pct_" + prog),
        }
    top = sorted(programs,
                 key=lambda p: -programs[p]["device_seconds_est"])
    top = top[: max(int(top_k), 0)]

    def _phase_bytes(short: str) -> Dict[str, int]:
        pre = short + "_bytes_"
        return {k[len(pre):]: int(v) for k, v in sorted(c.items())
                if k.startswith(pre) and k != short + "_bytes_total"}

    rh = h.get("devprof_round_host_seconds") or {}
    rd = h.get("devprof_round_device_seconds") or {}
    fs = h.get("devprof_forced_sync_seconds") or {}
    buckets = {k: {"samples": int(v.get("count", 0)),
                   "seconds": round(float(v.get("sum", 0.0)), 6)}
               for k, v in sorted(h.items())
               if k.startswith("device_seconds_") and "_bucket_" in k}
    return {
        "mode": mode,
        "device": devcaps.capabilities(),
        "rounds": {
            "count": int(c.get("devprof_rounds_total", 0)),
            "host_seconds": round(float(rh.get("sum", 0.0)), 6),
            "device_seconds": round(float(rd.get("sum", 0.0)), 6),
        },
        "device_seconds_est_total": float(
            g.get("devprof_device_seconds_est_total", 0.0) or 0.0),
        "samples_total": int(c.get("devprof_samples_total", 0)),
        "dispatches_total": int(c.get("devprof_dispatches_total", 0)),
        "programs": programs,
        "top": top,
        "transfers": {
            "h2d_bytes_total": int(c.get("h2d_bytes_total", 0)),
            "h2d_transfers_total": int(c.get("h2d_transfers_total", 0)),
            "h2d_by_phase": _phase_bytes("h2d"),
            "d2h_bytes_total": int(c.get("d2h_bytes_total", 0)),
            "d2h_transfers_total": int(c.get("d2h_transfers_total", 0)),
            "d2h_by_phase": _phase_bytes("d2h"),
        },
        "forced_syncs": {
            "count": int(c.get("devprof_forced_syncs_total", 0)),
            "seconds": round(float(fs.get("sum", 0.0)), 6),
        },
        "serve_buckets": buckets,
    }


def profile_summary_from_files(paths: Sequence[str],
                               top_k: int = 5) -> Dict[str, Any]:
    """``--profile`` over registry-snapshot JSON files: fold them through
    a fresh Registry (counters/histograms add, gauges last-write-wins)
    and summarize the merged account.  No files = the live registry."""
    if not paths:
        return profile_summary(top_k=top_k)
    from .registry import Registry
    r = Registry()
    for p in paths:
        with open(p) as fh:
            r.merge(json.load(fh))
    return profile_summary(r.snapshot(), top_k=top_k)


def drift_summary(snap: Optional[Dict[str, Any]] = None,
                  top_k: int = 5) -> Dict[str, Any]:
    """The drift observatory's published account as one JSON-ready dict,
    computed from a registry snapshot (default: the live process
    registry).  Only the LAST window's gauges live in the registry; the
    per-window trajectory needs a drift-stats file (``/stats`` drift
    block) — ``drift_summary_from_files`` accepts either."""
    from . import registry as _registry
    from .prom import split_series
    if snap is None:
        snap = _registry.REGISTRY.snapshot()
    g = dict(snap.get("gauges", {}))
    c = dict(snap.get("counters", {}))
    models: Dict[str, Dict[str, Any]] = {}

    def _m(model: str) -> Dict[str, Any]:
        return models.setdefault(model, {
            "windows": 0, "rows": 0, "dropped": 0, "overhead_s": 0.0,
            "score_psi": None, "features": {}})

    for k, v in g.items():
        base, labels = split_series(k)
        if not base.startswith("drift_"):
            continue
        model = labels.get("model", "primary")
        feat = labels.get("feature")
        if base == "drift_psi" and feat is not None:
            _m(model)["features"].setdefault(feat, {})["psi"] = float(v)
        elif base == "drift_missing_delta" and feat is not None:
            _m(model)["features"].setdefault(
                feat, {})["missing_delta"] = float(v)
        elif base == "drift_score_psi":
            _m(model)["score_psi"] = float(v)
        elif base == "drift_overhead_seconds":
            _m(model)["overhead_s"] = round(float(v), 6)
        elif base == "drift_rows_dropped_total":
            _m(model)["dropped"] = int(v)
    for k, v in c.items():
        base, labels = split_series(k)
        model = labels.get("model", "primary")
        if base == "drift_windows_total":
            _m(model)["windows"] = int(v)
        elif base == "drift_rows_total":
            _m(model)["rows"] = int(v)

    for m in models.values():
        feats = sorted(m.pop("features").items(),
                       key=lambda t: -(t[1].get("psi") or 0.0))
        m["offenders"] = [
            {"feature": f, "psi": d.get("psi"),
             "missing_delta": d.get("missing_delta")}
            for f, d in feats[: max(int(top_k), 0)]]
    return {"models": models}


def drift_summary_from_files(paths: Sequence[str],
                             top_k: int = 5) -> Dict[str, Any]:
    """``--drift`` over files: registry-snapshot JSON files fold through
    a fresh Registry (last published gauges); drift-stats JSON files
    (the ``/stats`` ``drift`` block, or one collector's ``stats()``
    dict) carry the window trajectory and sustained offenders and
    overlay per model.  No files = the live registry."""
    if not paths:
        return drift_summary(top_k=top_k)
    from .registry import Registry
    r = Registry()
    any_snap = False
    live: Dict[str, Dict[str, Any]] = {}

    def _take_stats(model: str, st: Dict[str, Any]) -> None:
        live[str(model)] = st

    for p in paths:
        with open(p) as fh:
            obj = json.load(fh)
        if not isinstance(obj, dict):
            raise ValueError(f"{p}: expected a JSON object")
        if "counters" in obj or "gauges" in obj:
            r.merge(obj)
            any_snap = True
        elif "window_s" in obj:                 # one collector's stats()
            _take_stats(obj.get("model", "primary"), obj)
        else:                                   # a /stats drift block
            for model, st in obj.items():
                if isinstance(st, dict) and "window_s" in st:
                    _take_stats(model, st)

    rep = (drift_summary(r.snapshot(), top_k=top_k)
           if any_snap else {"models": {}})
    for model, st in live.items():
        m = rep["models"].setdefault(model, {})
        last = st.get("last") or {}
        m.update({
            "windows": int(st.get("windows", 0)),
            "rows": int(st.get("rows", 0)),
            "dropped": int(st.get("dropped", 0)),
            "overhead_s": round(float(st.get("overhead_s", 0.0)), 6),
            "score_psi": last.get("score_psi"),
            "offenders": list(last.get("top") or [])[: max(int(top_k), 0)],
            "trajectory": list(st.get("trajectory") or []),
            "sustained": st.get("sustained"),
        })
    return rep


def render_drift_table(rep: Dict[str, Any]) -> str:
    """Human-readable ``--drift`` offender table."""
    out: List[str] = []
    out.append("== obs-report (drift) ==")
    if not rep["models"]:
        out.append("(no drift series — serve with drift=on, or point at "
                   "a registry snapshot / /stats drift block)")
    for model in sorted(rep["models"]):
        m = rep["models"][model]
        out.append(f"-- model {model}: {m.get('windows', 0)} windows, "
                   f"{m.get('rows', 0)} rows "
                   f"({m.get('dropped', 0)} dropped), collector "
                   f"{m.get('overhead_s', 0.0):.4f}s --")
        sp = m.get("score_psi")
        if sp is not None:
            out.append(f"  score PSI {sp:.4f}")
        for off in m.get("offenders") or []:
            parts = [f"  {off.get('feature', '?'):<28}"]
            for key in ("psi", "kl", "linf", "missing_delta"):
                v = off.get(key)
                if v is not None:
                    parts.append(f"{key} {v:.4f}")
            out.append("  ".join(parts))
        sus = m.get("sustained") or {}
        if sus.get("offenders"):
            out.append(f"  sustained (psi > {sus.get('threshold')} for "
                       f">= {sus.get('consecutive')} windows): "
                       + ", ".join(sus["offenders"]))
        traj = m.get("trajectory") or []
        if traj:
            out.append(f"  -- trajectory ({len(traj)} windows) --")
            for w in traj:
                top = ", ".join(w.get("top") or [])
                mp = w.get("max_psi")
                spw = w.get("score_psi")
                out.append(
                    f"    rows {w.get('rows', 0):>7}"
                    + (f"  max_psi {mp:.4f}" if mp is not None else "")
                    + (f"  score_psi {spw:.4f}" if spw is not None else "")
                    + (f"  top [{top}]" if top else ""))
    return "\n".join(out)


def _fmt_bytes(n: int) -> str:
    v = float(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if v < 1024.0 or unit == "TiB":
            return f"{v:.1f}{unit}" if unit != "B" else f"{int(v)}B"
        v /= 1024.0
    return f"{n}B"


def render_table(rep: Dict[str, Any]) -> str:
    """Human-readable report (the ``--format=table`` default)."""
    out: List[str] = []
    out.append("== obs-report ==")
    for path, n in rep["files"].items():
        out.append(f"file: {path} ({n} events)")
    out.append(f"iterations: {rep['iterations']} committed / "
               f"{rep['events']} events, "
               f"wall {rep['wall_s_total']:.3f}s")

    if rep["phase_seconds"]:
        out.append("-- per-phase wall time --")
        total = sum(rep["phase_seconds"].values()) or 1.0
        for name, v in sorted(rep["phase_seconds"].items(),
                              key=lambda t: -t[1]):
            out.append(f"  {name:<24} {v:>10.3f}s  {100 * v / total:5.1f}%")
    else:
        out.append("-- per-phase wall time: none recorded "
                   "(run without LIGHTGBM_TPU_TIMETAG=1) --")

    if rep["slowest"]:
        out.append(f"-- slowest {len(rep['slowest'])} iterations --")
        for d in rep["slowest"]:
            out.append(f"  iter {d['iter']:>6}  {d['wall_s']:.4f}s")

    inc = rep["incidents"]
    n_inc = (len(inc["nan"]) + len(inc["saturated_iters"])
             + len(inc["discarded_iters"]))
    out.append(f"-- incidents: {n_inc} --")
    for d in inc["nan"]:
        out.append(f"  iter {d['iter']}: non-finite {d['what']} "
                   f"(nan_policy={d['policy']})")
    if inc["saturated_iters"]:
        out.append(f"  saturated (no more splits): "
                   f"{inc['saturated_iters']}")
    if inc["discarded_iters"]:
        out.append(f"  discarded (dispatched past saturation): "
                   f"{inc['discarded_iters']}")

    comm = rep["comm"]
    out.append(f"-- collective traffic: {_fmt_bytes(comm['bytes_cum'])} "
               f"over {comm['calls_cum']} calls --")

    if rep.get("compile"):
        comp = rep["compile"]
        out.append(f"-- compile ledger: {comp['count']} compiles, "
                   f"{comp['seconds_total']:.3f}s total --")
        for name, st in sorted(comp["programs"].items(),
                               key=lambda t: -t[1]["seconds"]):
            out.append(f"  {name:<24} {st['seconds']:>10.3f}s  "
                       f"x{st['count']}")
        for e in comp["slowest"]:
            out.append(f"  slowest: {e['program']} {e['seconds']:.3f}s  "
                       f"{e['shapes']}")

    if rep["eval"]:
        out.append("-- eval trajectory --")
        for ds in sorted(rep["eval"]):
            for name, s in sorted(rep["eval"][ds].items()):
                out.append(
                    f"  {ds}/{name}: first {s['first']:g} -> last "
                    f"{s['last']:g}  (min {s['min']:g}@{s['min_iter']}, "
                    f"max {s['max']:g}@{s['max_iter']}, {s['n']} points)")
    return "\n".join(out)


def render_traces_table(rep: Dict[str, Any]) -> str:
    """Human-readable ``--traces`` summary."""
    out: List[str] = []
    out.append("== obs-report (traces) ==")
    for path, n in rep["files"].items():
        out.append(f"file: {path} ({n} events)")
    out.append(f"traces: {rep['traces']}")
    if rep["roots"]:
        out.append("-- per-root span stats --")
        for name, st in sorted(rep["roots"].items(),
                               key=lambda t: -t[1]["total_s"]):
            out.append(f"  {name:<20} x{st['count']:<6} "
                       f"total {st['total_s']:.4f}s  "
                       f"mean {st['mean_s'] * 1000.0:.2f}ms  "
                       f"max {st['max_s'] * 1000.0:.2f}ms")
    co = rep["coalesce"]
    out.append(f"-- coalescing: {co['batches']} batches, fan-in "
               f"mean {co['mean_fan_in']} max {co['max_fan_in']} --")
    if rep["slowest"]:
        out.append(f"-- slowest {len(rep['slowest'])} traces "
                   f"(critical path) --")
        for t in rep["slowest"]:
            path = " -> ".join(
                f"{s['name']} {s['dur_s'] * 1000.0:.2f}ms"
                for s in t["critical_path"])
            out.append(f"  [{t['trace_id']}] {path}")
    return "\n".join(out)


def render_profile_table(rep: Dict[str, Any]) -> str:
    """Human-readable ``--profile`` decomposition."""
    out: List[str] = []
    out.append("== obs-report (profile) ==")
    dev = rep["device"]
    peaks = ""
    if dev.get("peak_flops") or dev.get("peak_bytes_per_sec"):
        peaks = (f", peaks {dev.get('peak_flops'):.3g} FLOP/s / "
                 f"{dev.get('peak_bytes_per_sec'):.3g} B/s "
                 f"({dev.get('source')})")
    out.append(f"mode: {rep['mode']}   device: {dev.get('device_kind')} "
               f"[{dev.get('platform')}]{peaks}")
    r = rep["rounds"]
    if r["count"]:
        total = (r["host_seconds"] + r["device_seconds"]) or 1.0
        out.append(f"rounds: {r['count']}  host {r['host_seconds']:.3f}s / "
                   f"device {r['device_seconds']:.3f}s "
                   f"(device {100.0 * r['device_seconds'] / total:.1f}%)")
    out.append(f"sampled dispatches: {rep['samples_total']} of "
               f"{rep['dispatches_total']}, estimated device total "
               f"{rep['device_seconds_est_total']:.3f}s")
    if rep["top"]:
        out.append(f"-- top {len(rep['top'])} programs by estimated "
                   f"device seconds --")
        for prog in rep["top"]:
            p = rep["programs"][prog]
            fl = p.get("flops")
            af = p.get("achieved_flops")
            rl = p.get("roofline_pct")
            out.append(
                f"  {prog:<28} {p['device_seconds_est']:>9.4f}s  "
                f"x{p['samples']}/{p['dispatches']}"
                + (f"  flops {fl:.3g}" if fl is not None else "")
                + (f"  {af:.3g} FLOP/s" if af is not None else "")
                + (f"  {rl:.2f}% roofline" if rl is not None else ""))
    tr = rep["transfers"]
    for short in ("h2d", "d2h"):
        by = tr[f"{short}_by_phase"]
        phases = ", ".join(f"{k} {_fmt_bytes(v)}" for k, v in by.items())
        out.append(f"-- {short}: {_fmt_bytes(tr[f'{short}_bytes_total'])} "
                   f"over {tr[f'{short}_transfers_total']} transfers"
                   + (f" ({phases})" if phases else "") + " --")
    fsn = rep["forced_syncs"]
    if fsn["count"]:
        out.append(f"-- forced syncs (TIMETAG/span serialization): "
                   f"{fsn['count']}, {fsn['seconds']:.4f}s --")
    if rep["serve_buckets"]:
        out.append("-- per-bucket device seconds (serve) --")
        for name, st in rep["serve_buckets"].items():
            out.append(f"  {name:<40} {st['seconds']:>9.4f}s  "
                       f"x{st['samples']}")
    if rep["mode"] == "off" and not rep["programs"]:
        out.append("(devprof was off — run with devprof=sample:N or "
                   "LIGHTGBM_TPU_DEVPROF=full to populate this report)")
    return "\n".join(out)


def main(argv: Optional[Sequence[str]] = None) -> int:
    """CLI entry: ``python -m lightgbm_tpu_torch obs-report <events.jsonl ...>
    [--format=json|table] [--top=K] [--compile=<ledger.jsonl>]``,
    ``obs-report --traces <trace.json ...>``,
    ``obs-report --profile [<registry_snapshot.json ...>]``, or
    ``obs-report --drift [<snapshot_or_drift_stats.json ...>]``."""
    argv = list(sys.argv[1:] if argv is None else argv)
    fmt = "table"
    top_k = 5
    compile_path: Optional[str] = None
    traces_mode = False
    profile_mode = False
    drift_mode = False
    paths: List[str] = []
    for tok in argv:
        if tok.startswith("--format="):
            fmt = tok.split("=", 1)[1].strip().lower()
        elif tok.startswith("--top="):
            try:
                top_k = int(tok.split("=", 1)[1])
            except ValueError:
                print(f"obs-report: bad --top value in {tok!r}",
                      file=sys.stderr)
                return 2
        elif tok.startswith("--compile="):
            compile_path = tok.split("=", 1)[1]
        elif tok == "--traces":
            traces_mode = True
        elif tok == "--profile":
            profile_mode = True
        elif tok == "--drift":
            drift_mode = True
        elif tok.startswith("-"):
            print(f"obs-report: unknown flag {tok!r}", file=sys.stderr)
            return 2
        else:
            paths.append(tok)
    if not paths and not profile_mode and not drift_mode:
        print("usage: python -m lightgbm_tpu_torch obs-report "
              "<events.jsonl ...> [--format=json|table] [--top=K] "
              "[--compile=<compile_ledger.jsonl>]\n"
              "       python -m lightgbm_tpu_torch obs-report --traces "
              "<trace_events.json ...> [--format=json|table] [--top=K]\n"
              "       python -m lightgbm_tpu_torch obs-report --profile "
              "[<registry_snapshot.json ...>] [--format=json|table] "
              "[--top=K]\n"
              "       python -m lightgbm_tpu_torch obs-report --drift "
              "[<snapshot_or_drift_stats.json ...>] "
              "[--format=json|table] [--top=K]",
              file=sys.stderr)
        return 2
    if fmt not in ("json", "table"):
        print(f"obs-report: unknown format {fmt!r} (json|table)",
              file=sys.stderr)
        return 2
    try:
        if drift_mode:
            rep = drift_summary_from_files(paths, top_k=top_k)
        elif profile_mode:
            rep = profile_summary_from_files(paths, top_k=top_k)
        elif traces_mode:
            from .tracing import summarize_traces
            rep = summarize_traces(paths, top_k=top_k)
        else:
            rep = summarize(paths, top_k=top_k, compile_path=compile_path)
    except (OSError, ValueError, KeyError) as exc:
        # ValueError covers json.JSONDecodeError: a crashed run can leave
        # a torn final line — report it as a one-liner, not a traceback
        print(f"obs-report: {exc}", file=sys.stderr)
        return 1
    if fmt == "json":
        print(json.dumps(rep, indent=2, sort_keys=True))
    elif drift_mode:
        print(render_drift_table(rep))
    elif profile_mode:
        print(render_profile_table(rep))
    elif traces_mode:
        print(render_traces_table(rep))
    else:
        print(render_table(rep))
    return 0
