"""The growers' device-to-host reads (the program's ``grower_host_reads``
counter) per tree grown in the run's process: the ``GBDT::iteration``
spans' count times the classes (one for the training cells' objectives,
or the context's ``train.num_class``)."""

from benchmark import program_registry


def read(ctx):
    t = (ctx or {}).get("train")
    snap = program_registry.snapshot(ctx) if t else None
    if not snap:
        return None
    reads = snap.get("counters", {}).get("grower_host_reads")
    rounds = (snap.get("histograms", {})
              .get("phase_seconds_gbdt_iteration") or {}).get("count")
    if reads is None or not rounds:
        return None
    return reads / (rounds * int(t.get("num_class", 1)))
