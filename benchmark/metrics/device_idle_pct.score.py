"""Share of the traced scoring calls' window in which no kernel, copy or
set ran on the device (the benchmark's ``torch.profiler`` window)."""

from benchmark import tracing


def read(ctx):
    if not (ctx or {}).get("score"):
        return None
    return tracing.idle_pct(ctx.get("trace"))
