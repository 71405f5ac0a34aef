"""K4's share of its roofline in the traced calls: the least time their
walks need (``cost/k4.py``; operations rule: the node visits of the
rows' paths, from the reference walk of a sample of rows) over the
device time of ``walk_trees_kernel`` and its fold.  K4 is bound by its
dependent loads, which this share does not yet count."""

from benchmark import tracing
from benchmark.cost import k4, peaks


def read(ctx):
    tr, s = (ctx or {}).get("trace"), (ctx or {}).get("score")
    if not tr or not s or not s["traced_rows"]:
        return None
    n1, s1 = tracing.kernel_seconds(tr, "walk_trees")
    n2, s2 = tracing.kernel_seconds(tr, "fold_trees")
    if n1 == 0 or s1 + s2 <= 0:
        return None
    least = 0.0
    for rows in s["traced_rows"]:
        least += peaks.least_seconds(*k4.launch(
            rows, s["features"], s["bin_bytes"], s["trees"], s["nodes"],
            s["leaves"], rows * s["visits_per_row"]))[0]
    return 100.0 * least / (s1 + s2)
