"""Share of the traced boosting rounds' window in which no kernel, copy
or set ran on the device (the program's ``trace_dir`` window)."""

from benchmark import tracing


def read(ctx):
    if not (ctx or {}).get("train"):
        return None
    return tracing.idle_pct(ctx.get("trace"))
