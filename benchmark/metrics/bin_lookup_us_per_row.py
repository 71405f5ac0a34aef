"""Host time of the frozen forest's f64 binning (the program's
``bin_lookup`` ranges in the benchmark's ``torch.profiler`` window) per
row of the traced calls."""


def read(ctx):
    tr, s = (ctx or {}).get("trace"), (ctx or {}).get("score")
    if not tr or not s or not s["traced_rows"]:
        return None
    sec = tr["ranges"].get("bin_lookup")
    return None if sec is None else 1e6 * sec / sum(s["traced_rows"])
