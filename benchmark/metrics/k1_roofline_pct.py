"""K1's share of its roofline in the traced rounds: the least time the
histogram passes of the traced trees need (``cost/k1.py``: the root and
each split's smaller child; bytes rule) over the device time of the
kernels named ``digit_hist_kernel``."""

from benchmark import tracing
from benchmark.cost import k1, peaks


def read(ctx):
    tr, t = (ctx or {}).get("trace"), (ctx or {}).get("train")
    if not tr or not t or not t["traced_trees"]:
        return None
    n, sec = tracing.kernel_seconds(tr, "digit_hist")
    if n == 0 or sec <= 0:
        return None
    least = 0.0
    for tree in t["traced_trees"]:
        for rows in k1.tree_windows(tree, t["num_data"]):
            least += peaks.least_seconds(*k1.launch(
                rows, t["features"], t["bin_bytes"], t["max_bin"]))[0]
    return 100.0 * least / sec
