"""Share of the chip's peak over the window's untraced boosting rounds:
the least time their work needs (``cost/train_round.py``, the larger of
bytes over the peak bandwidth and operations over the peak f32 rate,
round by round) over their wall time."""

from benchmark.cost import peaks, train_round


def read(ctx):
    t = (ctx or {}).get("train")
    if not t or not t["untraced_walls"]:
        return None
    least = 0.0
    for tree in t["untraced_trees"]:
        nbytes, ops = train_round.round_cost(
            tree, t["num_data"], t["features"], t["bin_bytes"], t["max_bin"],
            t["objective"], t["objective_work"])
        least += peaks.least_seconds(nbytes, ops)[0]
    return 100.0 * least / sum(t["untraced_walls"])
