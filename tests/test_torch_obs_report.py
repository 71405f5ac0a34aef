"""``obs-report`` (lightgbm_tpu_torch/obs/report.py and the CLI route)
against the JAX package's, on the CPU.

- The port's ``summarize`` over the port's stream equals the JAX
  ``summarize`` over the JAX stream of the same run, apart from the
  wall-clock fields and the metric values' last bits (1e-6 relative);
  over one file the two readers give equal reports, and each
  ``render_table`` renders the other's file to the same text.
- ``python -m lightgbm_tpu_torch obs-report`` prints what the JAX
  command prints for the same files: ``--format=json|table``,
  ``--top``, ``--traces``, ``--compile=`` (a hand-written ledger with a
  torn line), ``--profile`` and ``--drift`` (registry snapshots; the
  device row differs: the port has no capability table yet).
- A torn events file, an unknown flag and the NaN incident of a
  ``nan_policy=skip_tree`` run give the JAX command's output.
"""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import lightgbm_tpu as lgb
from lightgbm_tpu.models.gbdt import GBDT as JaxGBDT
from lightgbm_tpu.obs import report as jreport

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import cli
from lightgbm_tpu_torch.obs import devcaps as lt_devcaps
from lightgbm_tpu_torch.obs import report

from test_torch_sampling import BASE, _poisoning_fobj
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PARAMS = {"objective": "binary", "num_leaves": 15, "verbose": -1,
          "min_data_in_leaf": 20, "bagging_fraction": 0.8,
          "bagging_freq": 1, "metric": "binary_logloss,auc"}
EVAL_RTOL = 1e-6


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """6 rounds of the same bagged run in each package, with
    ``events_file`` and ``trace_events_file``: their files."""
    out = tmp_path_factory.mktemp("report")
    rng = np.random.RandomState(5)
    X = rng.normal(size=(1200, 6))
    y = (X[:, 0] - 0.4 * X[:, 2] + 0.3 * rng.normal(size=1200) > 0)
    files = {}
    for name, pkg, kw in (("jax", lgb, {}),
                          ("torch", lt, {"device": "cpu"})):
        files[name] = (str(out / f"{name}.jsonl"),
                       str(out / f"{name}_trace.json"))
        ds = pkg.Dataset(X, y.astype(np.float64))
        vs = pkg.Dataset(X[:400], y[:400].astype(np.float64), reference=ds)
        pkg.train({**PARAMS, "events_file": files[name][0],
                   "trace_events_file": files[name][1]}, ds, 6,
                  valid_sets=[vs], verbose_eval=False, **kw)
    return files


def _without_wall(rep):
    rep = dict(rep)
    rep.pop("wall_s_total")
    rep.pop("files")
    rep["slowest"] = sorted(d["iter"] for d in rep["slowest"])
    return rep


def _cli(module, argv, capsys):
    """(exit code, stdout, stderr) of one obs-report call in-process."""
    rc = module(argv)
    out, err = capsys.readouterr()
    return rc, out, err


def _port_cli(argv):
    return cli.main(["obs-report", *argv])


# ---------------------------------------------------------------------------
# the report of a run


def test_report_of_the_port_run_equals_jax(runs):
    want = jreport.summarize([runs["jax"][0]], top_k=10)
    got = report.summarize([runs["torch"][0]], top_k=10)
    assert list(got["files"].values()) == list(want["files"].values())
    assert got["wall_s_total"] > 0
    evals = (got.pop("eval"), want.pop("eval"))
    assert _without_wall(got) == _without_wall(want)
    assert got["iterations"] == 6 and got["phase_seconds"] == {}
    assert evals[0].keys() == evals[1].keys()
    for ds in evals[1]:
        for metric, w in evals[1][ds].items():
            g = evals[0][ds][metric]
            for key in ("min_iter", "max_iter", "n"):
                assert g[key] == w[key]
            for key in ("first", "last", "min", "max"):
                assert abs(g[key] - w[key]) <= EVAL_RTOL * abs(w[key])


@pytest.mark.parametrize("src", ["jax", "torch"])
def test_each_reader_renders_the_others_file(runs, src):
    path = runs[src][0]
    got = report.summarize([path], top_k=3)
    want = jreport.summarize([path], top_k=3)
    assert got == want
    assert report.render_table(got) == jreport.render_table(want)
    assert "-- eval trajectory --" in report.render_table(got)


# ---------------------------------------------------------------------------
# the command


def test_cli_prints_the_jax_commands_output(runs, capsys, tmp_path):
    ev, trace = runs["torch"]
    ledger = tmp_path / "ledger.jsonl"
    ledger.write_text(
        json.dumps({"program": "leaf_hist", "shapes": "u8[28,4096]",
                    "seconds": 2.5}) + "\n"
        + json.dumps({"program": "forest_walk", "shapes": "f32[28,64]",
                      "seconds": 0.75}) + "\n"
        + json.dumps({"program": "leaf_hist", "shapes": "u8[28,512]",
                      "seconds": 1.25}) + "\n"
        + '{"program": "torn", "seco\n')
    calls = ([ev], ["--format=json", ev], ["--top=1", ev],
             ["--format=json", "--top=2", ev, runs["jax"][0]],
             [f"--compile={ledger}", ev],
             ["--format=json", f"--compile={ledger}", ev],
             ["--traces", trace], ["--traces", "--format=json", "--top=2",
                                   trace, runs["jax"][1]])
    for argv in calls:
        want = _cli(jreport.main, argv, capsys)
        got = _cli(_port_cli, argv, capsys)
        assert got == want, argv
        assert got[0] == 0 and got[1]
    rep = json.loads(_cli(_port_cli, ["--format=json", "--top=1", ev],
                          capsys)[1])
    assert len(rep["slowest"]) == 1 and rep["iterations"] == 6
    comp = json.loads(_cli(_port_cli, ["--format=json",
                                       f"--compile={ledger}", ev],
                           capsys)[1])["compile"]
    assert comp["count"] == 3 and comp["seconds_total"] == 4.5
    assert comp["programs"]["leaf_hist"] == {"count": 2, "seconds": 3.75}
    assert comp["slowest"][0]["shapes"] == "u8[28,4096]"
    traces = json.loads(_cli(_port_cli, ["--traces", "--format=json",
                                         trace], capsys)[1])
    assert traces["roots"]["GBDT::iteration"]["count"] == 6


def test_module_entry_point_runs(runs):
    ev = runs["torch"][0]
    proc = subprocess.run(
        [sys.executable, "-m", "lightgbm_tpu_torch", "obs-report",
         "--format=json", ev], cwd=str(REPO), capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout) == report.summarize([ev])


SNAPSHOT = {
    "counters": {
        "devprof_rounds_total": 4, "devprof_samples_total": 9,
        "devprof_dispatches_total": 40,
        "devprof_samples_leaf_hist": 6, "devprof_dispatches_leaf_hist": 30,
        "h2d_bytes_total": 4096, "h2d_transfers_total": 3,
        "h2d_bytes_dataset": 4000, "h2d_bytes_serve": 96,
        "d2h_bytes_total": 512, "d2h_transfers_total": 4,
        "d2h_bytes_host_tree": 512, "devprof_forced_syncs_total": 2,
        'drift_windows_total{model="primary"}': 3,
        'drift_rows_total{model="primary"}': 900},
    "gauges": {
        "devprof_sample_interval": 4,
        "devprof_device_seconds_est_leaf_hist": 0.25,
        "devprof_device_seconds_est_forest_walk": 0.125,
        "devprof_device_seconds_est_total": 0.375,
        "devprof_flops_leaf_hist": 1.0e9,
        "devprof_roofline_pct_leaf_hist": 3.5,
        'drift_psi{feature="f_1",model="primary"}': 0.4,
        'drift_psi{feature="f_3",model="primary"}': 0.05,
        'drift_missing_delta{feature="f_1",model="primary"}': 0.01,
        'drift_score_psi{model="primary"}': 0.2,
        'drift_overhead_seconds{model="primary"}': 0.0125},
    "histograms": {
        "devprof_round_host_seconds": {"buckets": [1.0], "counts": [4, 0],
                                       "sum": 0.5, "count": 4},
        "devprof_round_device_seconds": {"buckets": [1.0],
                                         "counts": [4, 0], "sum": 0.25,
                                         "count": 4}},
}


def test_profile_and_drift_readers_like_jax(tmp_path, capsys):
    snap = tmp_path / "snap.json"
    snap.write_text(json.dumps(SNAPSHOT))
    for flag in ("--profile", "--drift"):
        want = _cli(jreport.main, [flag, "--format=json", str(snap)],
                    capsys)
        got = _cli(_port_cli, [flag, "--format=json", str(snap)], capsys)
        assert got[0] == want[0] == 0
        w, g = json.loads(want[1]), json.loads(got[1])
        if flag == "--profile":
            # the port's capability row: the JAX row of this host's CPU
            assert g.pop("device") == w.pop("device") == \
                lt_devcaps.capabilities()
            assert g["top"] == ["leaf_hist", "forest_walk"]
            assert g["rounds"]["count"] == 4 and g["mode"] == "sample:4"
        else:
            assert g["models"]["primary"]["offenders"][0]["feature"] == \
                "f_1"
            assert _cli(_port_cli, [flag, str(snap)], capsys)[1] == \
                _cli(jreport.main, [flag, str(snap)], capsys)[1]
        assert g == w


# ---------------------------------------------------------------------------
# bad input


def test_torn_file_and_bad_flags_like_jax(runs, tmp_path, capsys):
    torn = tmp_path / "torn.jsonl"
    text = pathlib.Path(runs["torch"][0]).read_text()
    torn.write_text(text[:len(text) - 25])
    for argv in ([str(torn)], ["--bogus", str(torn)], ["--top=x", "a"],
                 ["--format=xml", str(torn)], [], [str(tmp_path / "no")]):
        want = _cli(jreport.main, argv, capsys)
        rc, out, err = _cli(_port_cli, argv, capsys)
        # the usage names the port's module
        assert (rc, out, err.replace("lightgbm_tpu_torch",
                                     "lightgbm_tpu")) == want, argv
        assert rc in (1, 2)
    assert _cli(_port_cli, [str(torn)], capsys)[2].startswith(
        "obs-report: ")


def test_nan_incident_report_like_jax(tmp_path, monkeypatch, capsys):
    rng = np.random.RandomState(11)
    X = rng.normal(size=(800, 5))
    y = (X[:, 0] > 0).astype(np.float64)
    params = {**BASE, "nan_policy": "skip_tree", "bagging_fraction": 0.7,
              "bagging_freq": 1}
    paths = {name: str(tmp_path / f"{name}.jsonl")
             for name in ("jax", "jax_sync", "torch")}
    lgb.train({**params, "events_file": paths["jax"]}, lgb.Dataset(X, y),
              5, fobj=_poisoning_fobj(2), verbose_eval=False)
    # the port's rounds are synchronous: its stream is the JAX
    # booster's with pipelining off (pipelined, a dropped round makes
    # the JAX stream write its previous round as two records)
    monkeypatch.setattr(JaxGBDT, "_pipeline", False)
    lgb.train({**params, "events_file": paths["jax_sync"]},
              lgb.Dataset(X, y), 5, fobj=_poisoning_fobj(2),
              verbose_eval=False)
    monkeypatch.undo()
    lt.train({**params, "events_file": paths["torch"]}, lt.Dataset(X, y),
             5, fobj=_poisoning_fobj(2), verbose_eval=False, device="cpu")
    got = report.summarize([paths["torch"]])
    assert got["incidents"] == jreport.summarize([paths["jax"]])[
        "incidents"] == {"nan": [{"iter": 2, "what": "gradients/hessians",
                                  "policy": "skip_tree"}],
                         "saturated_iters": [], "discarded_iters": []}
    want = jreport.summarize([paths["jax_sync"]])
    assert list(got["files"].values()) == list(want["files"].values())
    assert _without_wall(got) == _without_wall(want)
    table = _cli(_port_cli, [paths["torch"]], capsys)[1]
    assert "iter 2: non-finite gradients/hessians (nan_policy=skip_tree)" \
        in table
