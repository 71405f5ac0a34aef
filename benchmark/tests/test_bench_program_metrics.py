"""The readers of the program's own instruments, each on a hand-made
context and registry snapshot: the window account's gradient and
partition per round, the growers' host reads a tree, host binning per
row; and None wherever the input is absent, as a program without the
instrument leaves it."""

from pathlib import Path

import pytest

from benchmark import harness

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def _reader(name):
    return harness.load_file(METRICS / f"{name}.py",
                             "test_metric_" + name).read


def _snap(gauges=None, counters=None, iterations=None):
    hist = {} if iterations is None else {
        "phase_seconds_gbdt_iteration": {"buckets": [1.0], "counts": [0, 0],
                                         "sum": 0.0, "count": iterations}}
    return {"counters": counters or {}, "gauges": gauges or {},
            "histograms": hist}


WINDOW = {"trace_window_device_seconds_gbdt_boosting": 0.21,
          "trace_window_device_seconds_split": 0.037,
          "trace_window_iterations": 2}


@pytest.mark.parametrize("name,want", [("gradient_ms_per_round", 105.0),
                                       ("partition_ms_per_round", 18.5)])
def test_window_account_per_round(name, want):
    read = _reader(name)
    ctx = {"train": {"num_data": 10}, "registry": _snap(WINDOW)}
    assert read(ctx) == pytest.approx(want)
    # a program whose window sets no account, no window, no training
    assert read({"train": {"num_data": 10}, "registry": _snap()}) is None
    no_iters = {k: v for k, v in WINDOW.items() if "iterations" not in k}
    assert read({"train": {"num_data": 10},
                 "registry": _snap(no_iters)}) is None
    assert read({"score": {}, "registry": _snap(WINDOW)}) is None
    assert read(None) is None


def test_host_reads_per_tree():
    read = _reader("host_reads_per_tree")
    snap = _snap(counters={"grower_host_reads": 1024}, iterations=4)
    assert read({"train": {"num_data": 10}, "registry": snap}) == 256.0
    assert read({"train": {"num_data": 10, "num_class": 2}, "registry": snap}) == 128.0
    # the parent's registry: no counter; no round; a scoring cell
    assert read({"train": {"num_data": 10}, "registry": _snap(iterations=4)}) is None
    assert read({"train": {"num_data": 10}, "registry": _snap(
        counters={"grower_host_reads": 9})}) is None
    assert read({"score": {}, "registry": snap}) is None


def test_bin_lookup_us_per_row():
    read = _reader("bin_lookup_us_per_row")
    score = {"traced_rows": [1000, 3000]}
    ctx = {"trace": {"ranges": {"bin_lookup": 0.02, "forest_walk": 1.0}},
           "score": score}
    assert read(ctx) == pytest.approx(5.0)
    assert read({"trace": {"ranges": {}}, "score": score}) is None
    assert read({"trace": None, "score": score}) is None
    assert read({"trace": ctx["trace"], "score": {"traced_rows": []}}) \
        is None
    assert read({"trace": ctx["trace"], "train": {"num_data": 10}}) is None


def test_registry_falls_back_to_the_loaded_program():
    """Without a hand-made snapshot the readers take the port's registry
    from the run's own process."""
    from lightgbm_tpu_torch import obs
    obs.reset()
    try:
        obs.set_gauge("trace_window_device_seconds_split", 0.03)
        obs.set_gauge("trace_window_iterations", 3)
        assert _reader("partition_ms_per_round")({"train": {"num_data": 10}}) == \
            pytest.approx(10.0)
    finally:
        obs.reset()
