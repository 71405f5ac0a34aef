"""Canonical phase taxonomies: the names every span, histogram series
and transfer account of the port may carry.

The port's literal copy of the JAX package's obs/phases.py, so the two
packages name their phases, and therefore their trace spans and their
``phase_seconds_*`` series, alike (``tests/test_torch_tracing.py`` holds
the sets equal and scans the port's span sites against them):

- HOST_PHASES are the names of ``obs.span`` / ``obs.trace_span`` sites:
  host wall-clock phases of a boosting round (the reference's TIMETAG
  taxonomy, gbdt.cpp:20-59), the distributed learner's, and the serving
  fleet's (request, queue, batch, device predict, dispatch, reload,
  drain, hedge, eject, probe, verdict, shadow).
- DEVICE_PHASES are the device-side phases inside the growers and the
  frozen forest's walk (the reference's serial_tree_learner.cpp:10-37
  hist/find_split/split, the walk's bin lookup and epilogue).
- DEVICE_PARENT maps each device phase to the host phase whose dispatch
  contains it; JITTED_HOST_PHASES are the host phases whose time is
  device work.
- TRANSFER_PHASES close the namespace of host<->device transfer
  accounts.

The trace window's per-phase account (``obs/trace.py``) keeps the
ranges named in HOST_PHASES and DEVICE_PHASES.  This module stays
import-free (pure literals).
"""

HOST_PHASES = frozenset({
    "Bin::bundle",        # EFB bundle planning over the mapper sample
                          # (io/bundling.py)
    "Bin::linear_fit",    # per-stage batched leaf ridge solve
                          # (models/linear.py)
    "GBDT::iteration",    # whole boosting round (obs.span, always on)
    "GBDT::boosting",
    "GBDT::bagging",
    "GBDT::tree",
    "GBDT::train_score",
    "GBDT::valid_score",
    "GBDT::host_tree",
    "GBDT::metric",
    # distributed training (parallel/, models/gbdt.py)
    "Comm::grow",         # one round's cross-process growth, collectives
                          # included
    "Dist::consistency",  # periodic replicated-state digest allgather
                          # (distributed_consistency_check)
    # serving (serve/)
    "Serve::request",     # whole HTTP request (causal-trace root)
    "Serve::queue",       # enqueue -> coalesced-batch pickup wait
    "Serve::batch",       # micro-batch assembly + device dispatch
    "Predict::forest",    # one CompiledForest call (the walk kernel K4)
    # serving fleet (serve/fleet.py: replicas, hot reload, admission)
    "Serve::dispatch",    # routing decision: canary split + least-loaded
    "Serve::reload",      # hot swap: build + warm a new generation
    "Serve::drain",       # old generation: wait out in-flight, close
    # serving fault tolerance (serve/health.py)
    "Serve::hedge",       # one retried dispatch onto a different replica
    "Serve::eject",       # watchdog removing a bad replica from dispatch
    "Serve::probe",       # synthetic probe of an ejected replica
    # guarded model lifecycle (serve/lifecycle.py)
    "Serve::verdict",     # promotion controller ending an observation
                          # window: promote / rollback
    "Serve::shadow",      # one mirrored batch scored on the canary off
                          # the response path
})

DEVICE_PHASES = frozenset({
    "hist",
    "find_split",
    "split",
    # the frozen forest's walk (serve/forest.py)
    "bin_lookup",
    "forest_walk",
    "linear_fit",         # per-leaf affine epilogue of a linear forest
                          # (also the training-side solve in
                          # models/linear.py)
    "transform",
})

DEVICE_PARENT = {
    "hist": "GBDT::tree",
    "find_split": "GBDT::tree",
    "split": "GBDT::tree",
    "bin_lookup": "Predict::forest",
    "forest_walk": "Predict::forest",
    "linear_fit": "Predict::forest",
    "transform": "Predict::forest",
}

JITTED_HOST_PHASES = frozenset({
    "GBDT::tree",
    "Predict::forest",
})

# Host<->device transfer accounting phases: every H2D/D2H feed point
# charges its bytes to one of these, so the h2d_bytes_<phase> /
# d2h_bytes_<phase> counter namespace stays closed.
TRANSFER_PHASES = frozenset({
    "dataset",     # device data construction: binned matrix + labels up
    "host_tree",   # grown-tree materialization: device tree arrays down
    "predict",     # chunked training-side predict feeding
    "forest",      # CompiledForest build / weight placement
    "serve",       # serve-path request payloads (batcher/forest calls)
})


def sanitize(name):
    """Deterministic Prometheus-safe stem for any series or phase name:
    ``GBDT::tree`` -> ``gbdt_tree``.  The one sanitization rule of the
    metrics namespace: ``span_series`` below and ``prom.metric_name``
    both build on it."""
    stem = []
    for ch in str(name).replace("::", "_").lower():
        stem.append(ch if (ch.isalnum() or ch == "_") else "_")
    s = "".join(stem).strip("_") or "unnamed"
    if s[0].isdigit():
        s = "_" + s
    return s


def span_series(name):
    """Histogram series of a phase's span timer (obs/spans.py):
    ``GBDT::tree`` -> ``phase_seconds_gbdt_tree``."""
    return "phase_seconds_" + sanitize(name)
