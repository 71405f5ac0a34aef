"""Share of the chip's peak over the window's untraced scoring calls: the
least time their work needs (``cost/score_call.py``: the binned rows,
the forest's tables, the walk's node visits, the transform) over the
calls' wall time."""

from benchmark.cost import peaks, score_call


def read(ctx):
    s = (ctx or {}).get("score")
    if not s or not s["untraced_walls"]:
        return None
    least = 0.0
    for rows in s["untraced_rows"]:
        least += peaks.least_seconds(*score_call.call_cost(
            rows, s["features"], s["bin_bytes"], s["trees"], s["nodes"],
            s["leaves"], rows * s["visits_per_row"]))[0]
    return 100.0 * least / sum(s["untraced_walls"])
