"""Device time of the gradient (the program's ``GBDT::boosting`` ranges:
LambdaRank's pairwise pass) per iteration of the program's trace
window, from the window's per-phase account."""

from benchmark import program_registry


def read(ctx):
    return program_registry.window_ms_per_iter(ctx, "gbdt_boosting")
