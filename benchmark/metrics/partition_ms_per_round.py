"""Device time of the partition (the grower's ``split`` ranges: the
gathers that reorder each split leaf's rows) per iteration of the
program's trace window, from the window's per-phase account."""

from benchmark import program_registry


def read(ctx):
    return program_registry.window_ms_per_iter(ctx, "split")
