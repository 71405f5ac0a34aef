"""Wall time of the grower's ``find_split`` ranges (the split scan and
its host read of the children's best splits), per traced round."""


def read(ctx):
    tr = (ctx or {}).get("trace")
    if not tr or not (ctx.get("train") and ctx.get("trace_rounds")):
        return None
    s = tr["ranges"].get("find_split")
    return None if s is None else 1e3 * s / ctx["trace_rounds"]
