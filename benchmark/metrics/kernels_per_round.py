"""Device kernels launched in the traced boosting rounds, per round."""


def read(ctx):
    tr = (ctx or {}).get("trace")
    if not tr or not (ctx.get("train") and ctx.get("trace_rounds")):
        return None
    return tr["kernel_count"] / ctx["trace_rounds"]
