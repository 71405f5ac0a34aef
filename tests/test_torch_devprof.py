"""Device-time attribution of the port (lightgbm_tpu_torch/obs/devprof.py
and devcaps.py) held against the JAX package's modules on the CPU:

- ``parse_mode`` / ``configure`` answer alike (the env wins, a malformed
  env disarms, a malformed param raises);
- the same dispatch sequence under the same monkeypatched clock writes
  equal ``devprof_*`` / ``device_seconds_*`` series into each package's
  registry, under ``full`` and ``sample:3`` (the sampling correction);
- ``round_scope``'s partition, ``transfer``'s names, ``bucket_scope``'s
  restore and Prometheus text, nested dispatches counted once, a sample
  during a kernel build discarded;
- ``devprof=off`` creates no ``torch.cuda.Event`` and calls no
  synchronize over three training rounds;
- the program names the port profiles are JAX program names;
- each kernel wrapper's ``launch_cost`` equals the byte count
  ``chip_smoke.py``'s ``bound_ms`` uses;
- ``devcaps.roofline`` equals JAX's on a grid, the CPU row and the env
  override too, and the H100's name resolves to the H100 row.

Process-global state (both registries, both accumulators) is compared
by delta, with program names unique to each test.
"""

import ast
import math
import pathlib

import numpy as np
import pytest
import torch

from lightgbm_tpu.obs import devcaps as jdevcaps
from lightgbm_tpu.obs import devprof as jdevprof
from lightgbm_tpu.obs import registry as jregistry
from lightgbm_tpu.config import Config as JaxConfig

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import config as tconfig
from lightgbm_tpu_torch.obs import compile_ledger, devcaps, devprof, prom
from lightgbm_tpu_torch.obs import registry
from lightgbm_tpu_torch.utils import resource
from lightgbm_tpu_torch.ops import (children_hist, forest_walk, leafhist,
                                    roll_chain, window_hist)

from torch_threads import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def pristine(monkeypatch):
    """Both packages start disarmed, with a clean env and empty
    accumulators, and are left so."""
    monkeypatch.delenv(devprof.ENV, raising=False)
    for mod in (devprof, jdevprof):
        mod.reset()
        mod.configure(None)
    yield
    for mod in (devprof, jdevprof):
        mod.reset()
        mod.configure(None)


class _FakeClock:
    """``perf_counter`` advancing 1.0 a read (the JAX tests' clock)."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 1.0
        return self.t


def _snap(reg):
    return reg.snapshot()


def _delta(before, after, keep):
    """The series named by ``keep(name)`` that changed: counters and
    histogram (count, sum) by difference, gauges by value."""
    out = {}
    for name, v in after["counters"].items():
        d = v - before["counters"].get(name, 0)
        if keep(name) and d:
            out["c:" + name] = d
    for name, h in after["histograms"].items():
        h0 = before["histograms"].get(name, {"count": 0, "sum": 0.0})
        if keep(name) and h["count"] != h0["count"]:
            out["h:" + name] = (h["count"] - h0["count"],
                                round(h["sum"] - h0["sum"], 9))
    for name, v in after["gauges"].items():
        if keep(name) and before["gauges"].get(name) != v:
            out["g:" + name] = v
    return out


def _is_devprof(name):
    return (name.startswith("devprof_") or name.startswith("device_seconds")
            or name.startswith("h2d_") or name.startswith("d2h_")
            or name.startswith("host_to_device")
            or name.startswith("device_to_host"))


# ---------------------------------------------------------------------------
# the mode


@pytest.mark.parametrize("raw", [None, "", "off", "0", "false", "full",
                                 "1", "true", "on", "sample:1", "sample:3",
                                 " Sample:8 ", "sample:0", "sample:x",
                                 "sampel:4", "sideways"])
def test_parse_mode_matches_jax(raw):
    try:
        want = jdevprof.parse_mode(raw)
    except ValueError:
        with pytest.raises(ValueError):
            devprof.parse_mode(raw)
        return
    assert devprof.parse_mode(raw) == want


@pytest.mark.parametrize("env,flag", [("", None), ("", "full"),
                                      ("", "sample:4"), ("sample:3", "full"),
                                      ("off", "full"), ("sideways", "full"),
                                      ("1", None)])
def test_configure_precedence_matches_jax(env, flag, monkeypatch):
    if env:
        monkeypatch.setenv(devprof.ENV, env)
    assert devprof.configure(flag) == jdevprof.configure(flag)
    assert devprof.ENABLED == jdevprof.ENABLED
    assert registry.get_gauge("devprof_sample_interval") == \
        jregistry.get_gauge("devprof_sample_interval")


def test_malformed_param_raises_like_jax():
    with pytest.raises(ValueError):
        jdevprof.configure("sampel:4")
    with pytest.raises(ValueError):
        devprof.configure("sampel:4")
    with pytest.raises(ValueError, match="sampel"):
        JaxConfig({"devprof": "sampel:4"})
    with pytest.raises(ValueError, match="sampel"):
        tconfig.Config({"devprof": "sampel:4"})


# ---------------------------------------------------------------------------
# the same dispatches, the same series


def _drive(mod, prefix):
    """One dispatch sequence through ``mod``: two programs, one in a
    serving bucket, a cost row for one, a round around some, a nested
    dispatch (the port's) and a transfer."""
    a, b = prefix + "a", prefix + "b"
    mod.note_cost(a, {"flops": None, "bytes_accessed": 4.0e6,
                      "output_bytes": None})

    def nested():
        with devprof.dispatch(a):               # passes through
            return np.zeros(3)

    def call(prog):
        mod.timed_dispatch(prog, nested if mod is devprof
                           else (lambda: np.zeros(3)), (), {})

    for i in range(6):
        call(a)
        with mod.bucket_scope(64):
            call(b)
    for _ in range(2):
        with mod.round_scope():
            call(a)
            call(a)
    mod.transfer("h2d", "serve", 1024, transfers=2)
    mod.transfer("d2h", "host_tree", 96)


@pytest.mark.parametrize("mode", ["full", "sample:3"])
def test_same_dispatches_same_series(mode, monkeypatch):
    prefix = f"t_dp_{mode.replace(':', '')}_"
    got = {}
    for name, mod, reg in (("jax", jdevprof, jregistry.REGISTRY),
                           ("torch", devprof, registry.REGISTRY)):
        monkeypatch.setattr(mod, "time", _FakeClock())
        mod.enable(mode)
        before = _snap(reg)
        _drive(mod, prefix)
        got[name] = (_delta(before, _snap(reg),
                            lambda n: _is_devprof(n) and (
                                prefix in n or n.endswith("_total")
                                or n.startswith("devprof_round")
                                or n.startswith("h2d")
                                or n.startswith("d2h")
                                or n.startswith("host_to")
                                or n.startswith("device_to"))),
                     mod.estimates())
    assert got["torch"] == got["jax"]
    est = got["torch"][1][prefix + "a"]
    assert est["dispatches"] == 10
    # 1.0 a sample, corrected by the stride: every dispatch counted once
    assert est["device_seconds_est"] == pytest.approx(10.0, abs=3.0)
    assert f"g:devprof_roofline_pct_{prefix}a" in got["torch"][0]


def test_round_scope_partition_and_off_is_a_noop(monkeypatch):
    clock = _FakeClock()
    monkeypatch.setattr(devprof, "time", clock)
    before = _snap(registry.REGISTRY)
    with devprof.round_scope():
        # the seam: off, the guard never opens a dispatch
        with resource.oom_guard("t_dp_off"):
            pass
    assert clock.t == 0.0
    assert _delta(before, _snap(registry.REGISTRY), _is_devprof) == {}
    devprof.enable("full")
    before = _snap(registry.REGISTRY)
    with devprof.round_scope():
        with devprof.dispatch("t_dp_round"):
            pass
    d = _delta(before, _snap(registry.REGISTRY), _is_devprof)
    # wall 3 reads apart = 3.0; the sample 1.0 is device, the rest host
    assert d["h:devprof_round_device_seconds"] == (1, 1.0)
    assert d["h:devprof_round_host_seconds"] == (1, 2.0)
    assert d["c:devprof_rounds_total"] == 1


def test_transfer_names_match_jax():
    got = {}
    for name, mod, reg in (("jax", jdevprof, jregistry.REGISTRY),
                           ("torch", devprof, registry.REGISTRY)):
        before = _snap(reg)
        mod.transfer("h2d", "dataset", 4096, transfers=3)
        mod.transfer("d2h", "predict", 80)
        mod.transfer("h2d", "forest", 7)
        with pytest.raises(ValueError):
            mod.transfer("sideways", "serve", 1)
        got[name] = _delta(before, _snap(reg), _is_devprof)
    assert got["torch"] == got["jax"]
    assert got["torch"]["c:host_to_device_bytes"] == 4103
    assert got["torch"]["c:d2h_bytes_predict"] == 80


def test_bucket_scope_restores_and_renders_prometheus():
    devprof.enable("full")
    assert getattr(devprof._tls, "bucket", None) is None
    with devprof.bucket_scope(64):
        with devprof.bucket_scope(4096):
            with devprof.dispatch("t_dp_bucket"):
                pass
        assert devprof._tls.bucket == 64
        with devprof.dispatch("t_dp_bucket"):
            pass
    assert devprof._tls.bucket is None
    h = registry.get_histogram("device_seconds_t_dp_bucket_bucket_4096")
    assert h["count"] == 1
    text = prom.render(registry.snapshot())
    parsed = prom.parse_text(text)
    fams = parsed["types"]
    assert fams["lightgbm_tpu_device_seconds_t_dp_bucket_bucket_64"] == \
        "histogram"
    series = prom.histogram_series(
        parsed, "lightgbm_tpu_device_seconds_t_dp_bucket_bucket_4096")
    assert series["count"] == 1


def test_nested_dispatches_count_once():
    devprof.enable("full")
    before = _snap(registry.REGISTRY)
    with devprof.dispatch("t_dp_outer"):
        with devprof.dispatch("t_dp_inner"):
            pass
        with devprof.dispatch("t_dp_outer"):
            pass
    d = _delta(before, _snap(registry.REGISTRY), _is_devprof)
    assert d["c:devprof_dispatches_total"] == 1
    assert d["c:devprof_samples_t_dp_outer"] == 1
    assert "c:devprof_dispatches_t_dp_inner" not in d
    assert set(devprof.estimates()) == {"t_dp_outer"}


def test_a_sample_during_a_build_is_discarded():
    devprof.enable("full")
    skipped = registry.get_counter("devprof_samples_skipped_compile")
    with devprof.dispatch("t_dp_build"):
        compile_ledger.record("leaf_hist", "sm_90a,0123456789abcdef", 0.5)
    assert "t_dp_build" not in devprof.estimates()
    assert registry.get_counter("devprof_samples_skipped_compile") == \
        skipped + 1
    with devprof.dispatch("t_dp_build"):
        pass
    st = devprof.estimates()["t_dp_build"]
    assert st["dispatches"] == 2 and st["samples"] == 1


def test_kernel_bytes_feed_the_roofline_gauges():
    devprof.enable("full")
    with devprof.dispatch("t_dp_bytes"):
        devprof.add_bytes(1000)
        devprof.add_bytes(24)
    devprof.add_bytes(5)               # outside a sample: nothing
    with devprof.dispatch("t_dp_nobytes"):
        pass
    assert registry.get_gauge("devprof_bytes_accessed_t_dp_bytes") == 1024.0
    assert registry.get_gauge("devprof_roofline_pct_t_dp_bytes") is not None
    assert registry.get_gauge("devprof_roofline_pct_t_dp_nobytes") is None
    assert devprof.estimates()["t_dp_bytes"]["bytes_accessed"] == 1024
    assert devprof.estimates()["t_dp_bytes"]["flops"] is None


# ---------------------------------------------------------------------------
# off is free, on the round


def test_off_creates_no_event_and_no_synchronize(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("devprof=off touched the card")

    for name in ("Event", "synchronize", "current_stream"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    rng = np.random.RandomState(3)
    X = rng.normal(size=(300, 4))
    y = (X[:, 0] > 0).astype(np.float64)
    before = registry.get_counter("devprof_dispatches_total")
    bst = lt.train({"objective": "binary", "num_leaves": 7,
                    "verbose": -1, "devprof": "off"},
                   lt.Dataset(X, y), 3, device="cpu", verbose_eval=False)
    assert bst.num_trees() == 3
    assert registry.get_counter("devprof_dispatches_total") == before
    assert devprof.estimates() == {}


def test_full_on_a_round_samples_each_unit_once():
    rng = np.random.RandomState(4)
    X = rng.normal(size=(300, 4))
    y = (X[:, 0] > 0).astype(np.float64)
    base = lt.train({"objective": "binary", "num_leaves": 7, "verbose": -1},
                    lt.Dataset(X, y), 3, device="cpu", verbose_eval=False)
    bst = lt.train({"objective": "binary", "num_leaves": 7, "verbose": -1,
                    "devprof": "full"},
                   lt.Dataset(X, y), 3, device="cpu", verbose_eval=False)
    assert bst.model_to_string() == base.model_to_string()
    est = devprof.estimates()
    assert {"bag_mask", "train_gradients", "train_step",
            "score_update"} <= set(est)
    for prog in ("train_step", "train_gradients", "bag_mask"):
        assert est[prog]["dispatches"] == est[prog]["samples"] == 3
    assert registry.get_histogram("devprof_round_host_seconds")["count"] \
        >= 3


# ---------------------------------------------------------------------------
# the program names


def _jax_program_names():
    names = set()
    for path in (REPO / "lightgbm_tpu").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            fname = getattr(fn, "attr", getattr(fn, "id", ""))
            if fname in ("instrumented_jit", "_shared_jit"):
                for kw in node.keywords:
                    if kw.arg == "program" and \
                            isinstance(kw.value, ast.Constant):
                        names.add(kw.value.value)
            if fname == "CountingJit" and len(node.args) >= 2 and \
                    isinstance(node.args[1], ast.Constant):
                names.add(node.args[1].value)
    return names


def _port_profiled_names():
    """The devprof name of every ``oom_guard`` call of the port: its
    ``profile`` keyword, else its program."""
    names = set()
    for path in (REPO / "lightgbm_tpu_torch").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if not (isinstance(node, ast.Call)
                    and getattr(node.func, "attr", "") == "oom_guard"):
                continue
            prof = [kw.value for kw in node.keywords if kw.arg == "profile"]
            names |= _names_of(prof[0] if prof else node.args[0])
    return names


def _names_of(expr):
    """The names a ``profile`` expression can take: a string, or either
    branch of a conditional."""
    if isinstance(expr, ast.Constant):
        return {expr.value}
    if isinstance(expr, ast.IfExp):
        return _names_of(expr.body) | _names_of(expr.orelse)
    raise AssertionError(f"profile name not literal: {ast.dump(expr)}")


def test_program_names_are_jax_program_names():
    jax_names = _jax_program_names()
    assert {"train_step", "predict_forest", "serve_forest_walk"} <= jax_names
    assert set(devprof.PROGRAMS) <= jax_names
    assert _port_profiled_names() == set(devprof.PROGRAMS)


# ---------------------------------------------------------------------------
# launch_cost: the byte counts of chip_smoke.py's bound_ms


@pytest.mark.parametrize("S,F,itemsize,B", [(1 << 20, 28, 1, 255),
                                            (4097, 28, 2, 1023),
                                            (1, 3, 1, 2)])
def test_k1_launch_cost_is_the_bound_ms_count(S, F, itemsize, B):
    assert leafhist.launch_cost(S, F, itemsize, B) == \
        S * F * itemsize + 9 * S + 4 * F * 9 * B


@pytest.mark.parametrize("S,F,itemsize,B", [(1 << 20, 28, 1, 255),
                                            (5000, 7, 2, 63)])
def test_k2_k3_launch_cost_is_the_bound_ms_count(S, F, itemsize, B):
    in_bytes = S * F * itemsize + 16 * S
    assert children_hist.launch_cost(S, F, itemsize, B, False) == \
        in_bytes + 2 * F * B * 3 * 4
    assert children_hist.launch_cost(S, F, itemsize, B, True) == \
        in_bytes + 2 * F * 8 * 4
    # the root form reads no leaf ids
    assert children_hist.launch_cost(S, F, itemsize, B, False, False) == \
        in_bytes - 4 * S + 2 * F * B * 3 * 4


def _tables(K, T, M, L, linear, bf16):
    rows = K * T
    coeff = torch.zeros((rows, L, 3)) if linear else None
    feat = torch.zeros((rows, L, 3), dtype=torch.int32) if linear else None
    return forest_walk.WalkTables(
        nodes=torch.zeros((rows, M, 4), dtype=torch.int32),
        leaves=torch.zeros((rows, L), dtype=torch.bfloat16 if bf16
                           else torch.float32),
        num_class=K, trees_per_class=T, nan_bin=9, coeff=coeff, feat=feat,
        max_feat=2 if linear else -1)


@pytest.mark.parametrize("K,T,linear,bf16", [(1, 500, False, False),
                                             (3, 7, True, False),
                                             (1, 20, False, True)])
@pytest.mark.parametrize("B", [1, 64, 4096])
def test_k4_launch_cost_is_the_bound_ms_count(K, T, linear, bf16, B):
    t = _tables(K, T, 254, 255, linear, bf16)
    F, C = 28, 200
    table_bytes = (t.nodes.numel() * 4
                   + t.leaves.numel() * t.leaves.element_size())
    if linear:
        table_bytes += t.coeff.numel() * 4 + t.feat.numel() * 4
    bins_numel = xr_numel = F * B
    cut_bytes = F * C * 4 + F * C * 4 + F
    raw = xr_numel * 4 + cut_bytes + table_bytes + K * B * 4
    binned = bins_numel * 1 + (F * B * 4 if linear else 0) + table_bytes \
        + K * B * 4
    assert forest_walk.launch_cost(t, F, B, True, cut_cols=C) == raw
    assert forest_walk.launch_cost(t, F, B, False, 1) == binned


def test_probe_launch_costs_are_the_bound_ms_counts():
    assert roll_chain.launch_cost(12 * 2048) == 2 * 12 * 2048 * 4
    F, B, count = 28, 256, 1 << 19
    for words, matrix in ((7, True), (3, False)):
        want = count * (words * 4 + (9 if matrix else 12)) + 8 \
            + 4 * F * 9 * B
        assert window_hist.launch_cost(count, words, matrix, F, B) == want


# ---------------------------------------------------------------------------
# devcaps


_GRID = [(f, b, s) for f in (None, 0.0, 1e9, 3.5e12)
         for b in (None, 0.0, 1e8, 2.1e10) for s in (None, -1.0, 0.0, 1e-3,
                                                       2.5)]


def test_roofline_equals_jax_on_a_grid():
    caps_list = [{"peak_flops": 1e12, "peak_bytes_per_sec": 1e11},
                 {"peak_flops": None, "peak_bytes_per_sec": 3.35e12},
                 {"peak_flops": None, "peak_bytes_per_sec": None},
                 devcaps.capabilities(torch.device("cpu"))]
    for caps in caps_list:
        for f, b, s in _GRID:
            got = devcaps.roofline(f, b, s, caps)
            want = jdevcaps.roofline(f, b, s, caps)
            assert got.keys() == want.keys()
            for k in got:
                if want[k] is None:
                    assert got[k] is None
                else:
                    assert math.isclose(got[k], want[k], rel_tol=1e-15)


def test_cpu_row_and_env_override_equal_jax(monkeypatch):
    import jax
    jrow = jdevcaps.capabilities(jax.devices("cpu")[0])
    row = devcaps.capabilities(torch.device("cpu"))
    assert row == jrow
    assert row["source"] == "table" and row["peak_flops"] == 1.0e11
    monkeypatch.setenv(devcaps.ENV_PEAK_FLOPS, "2e12")
    monkeypatch.setenv(devcaps.ENV_PEAK_BYTES, "bogus")
    row = devcaps.capabilities(torch.device("cpu"))
    assert row == jdevcaps.capabilities(jax.devices("cpu")[0])
    assert row["peak_flops"] == 2e12 and row["source"] == "env"


def test_the_h100_name_resolves_to_the_h100_row(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda index=None: "NVIDIA H100 80GB HBM3")
    row = devcaps.capabilities(torch.device("cuda", 0))
    assert row == {"platform": "gpu", "device_kind": "NVIDIA H100 80GB HBM3",
                   "peak_flops": 67e12, "peak_bytes_per_sec": 3.35e12,
                   "source": "table"}
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda index=None: "Some Other Card")
    assert devcaps.capabilities(torch.device("cuda", 0))["source"] == \
        "unknown"


# ---------------------------------------------------------------------------
# the config keys


_ATTRIBUTION_KEYS = ("trace_dir", "trace_start_iter", "trace_num_iters",
                     "compile_ledger_file", "memwatch", "devprof")


@pytest.mark.parametrize("key", _ATTRIBUTION_KEYS)
def test_attribution_keys_are_read_with_the_jax_defaults(key, capsys):
    from lightgbm_tpu_torch.utils import log
    assert key not in tconfig.INERT
    log._warned_once.discard(f"config:{key}")
    jcfg = JaxConfig({})
    assert tconfig.Config({})[key] == jcfg[key]
    value = {"trace_dir": "t", "trace_start_iter": "3",
             "trace_num_iters": "4", "compile_ledger_file": "l.jsonl",
             "memwatch": "true", "devprof": "sample:4"}[key]
    assert tconfig.Config({key: value})[key] == JaxConfig({key: value})[key]
    assert f"config:{key}" not in log._warned_once
    assert "not read" not in capsys.readouterr().err
