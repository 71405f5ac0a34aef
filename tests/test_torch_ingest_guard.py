"""The port's ingest guard (lightgbm_tpu_torch/io/guard.py) and the
guarded parsers (io/parser.py, io/streaming.py) against the JAX
package's, on the CPU: the cases of the JAX package's
tests/test_ingest_guard.py that the port's surface reaches.

The same tokens, lines and files go through both packages: token
helpers (NA spellings are NaN), the fail-fast message naming
``file:line``, the reason and the token, the quarantine file byte for
byte, the ``bad_rows_*`` counters, the error budgets (absolute, and
fractional after 100 rows), the shadow guard, every classification
reason of the delimited and LibSVM parsers, physical line numbers past
a header and blank lines, undecodable bytes, and the two-round loader's
accounting (a bad line sampled in round 1b and met again in round 2
counted once, the field count from the first data line, the sampled
good rows counted once in the fraction, LibSVM indices validated before
they size the matrix) and its refusal of positional side files.  Both
packages' native C++ loaders are patched away: their one-round paths
read a dirty file with the Python paths these tests compare.
"""

import contextlib
import os
import types
from unittest import mock

import numpy as np
import pytest

from lightgbm_tpu import obs as jobs
from lightgbm_tpu.io import guard as jguard
from lightgbm_tpu.io import parser as jparser
from lightgbm_tpu.io import streaming as jstreaming
from lightgbm_tpu.utils.log import LightGBMError as JaxError

from lightgbm_tpu_torch import obs as tobs
from lightgbm_tpu_torch.io import guard as tguard
from lightgbm_tpu_torch.io import parser as tparser
from lightgbm_tpu_torch.io import streaming as tstreaming
from lightgbm_tpu_torch.utils.log import LightGBMError

JAX = types.SimpleNamespace(guard=jguard, parser=jparser,
                            streaming=jstreaming, obs=jobs, Error=JaxError)
PORT = types.SimpleNamespace(guard=tguard, parser=tparser,
                             streaming=tstreaming, obs=tobs,
                             Error=LightGBMError)


@contextlib.contextmanager
def _no_native():
    """Both packages' native loaders patched away: every read goes through
    the Python parsers these tests compare."""
    with mock.patch("lightgbm_tpu.io.native.parse_file_native",
                    return_value=None), \
            mock.patch("lightgbm_tpu_torch.io.native.parse_file_native",
                       return_value=None):
        yield


def _outcome(pkg, fn):
    """(result, None) or (None, the error's class name and text)."""
    try:
        with _no_native():
            return fn(pkg), None
    except (pkg.Error, ValueError, TypeError) as exc:
        kind = "LightGBMError" if isinstance(exc, pkg.Error) \
            else type(exc).__name__
        return None, (kind, str(exc))


def _same_outcome(fn):
    (rj, ej), (rt, et) = _outcome(JAX, fn), _outcome(PORT, fn)
    assert et == ej
    return rj, rt


def _same_arrays(a, b):
    assert len(a) == len(b)
    for x, z in zip(a, b):
        np.testing.assert_array_equal(np.asarray(z), np.asarray(x))


# ---------------------------------------------------------------------------
# token helpers


@pytest.mark.parametrize("token", [
    "na", "NA", "NaN", "nan", "null", "NULL", "none", "", "  ", " 1.5 ",
    "-2e3", "1.5x", "@@", "inf", "-0"])
def test_feature_value_matches_jax(token):
    rj, rt = _same_outcome(lambda p: p.guard.feature_value(token))
    if rj is not None:
        assert (np.isnan(rj) and np.isnan(rt)) or rt == rj


@pytest.mark.parametrize("token", ["7", " 12 ", "-2", "x", "1.5",
                                   str(1 << 20), str((1 << 20) + 1)])
def test_column_index_matches_jax(token):
    rj, rt = _same_outcome(lambda p: p.guard.column_index(token))
    assert rt == rj


def test_vocabulary_matches_jax():
    assert tguard.REASONS == jguard.REASONS
    assert tguard.POLICIES == jguard.POLICIES
    assert tguard.NA_TOKENS == jguard.NA_TOKENS
    assert tguard.MAX_COLUMN_INDEX == jguard.MAX_COLUMN_INDEX
    assert tguard.quarantine_path_for("a/b.tsv") == \
        jguard.quarantine_path_for("a/b.tsv")
    _same_outcome(lambda p: p.guard.IngestGuard("d", policy="skip"))
    _same_outcome(lambda p: p.guard.IngestGuard("d").bad_row(
        1, "x", "bogus", "no"))


# ---------------------------------------------------------------------------
# the guard's policy


def test_fail_fast_message_matches_jax(tmp_path):
    path = str(tmp_path / "d.csv")
    rj, rt = _same_outcome(lambda p: p.guard.IngestGuard(path).bad_row(
        42, "1,xx,3", "unparseable_token", "token 'xx'"))


def _quarantine_calls(pkg, path, calls, **kw):
    g = pkg.guard.IngestGuard(path, policy="quarantine", **kw)
    base = {name: pkg.obs.get_counter(name) for name in
            ["bad_rows_total"] + [f"bad_rows_{r}" for r in jguard.REASONS]}
    verdicts = [g.bad_row(*c) for c in calls]
    g.finish()
    counted = {name: pkg.obs.get_counter(name) - n
               for name, n in base.items()}
    blob = open(g.quarantine_path, "rb").read() \
        if os.path.exists(g.quarantine_path) else None
    return verdicts, counted, blob, (g.bad_total, g.rows_seen,
                                     dict(g.by_reason), list(g.records))


def test_quarantine_sink_bytes_and_counters_match_jax(tmp_path):
    path = str(tmp_path / "d.csv")
    calls = [(3, "1,xx,3", "unparseable_token", "token 'xx'"),
             (9, "1\t2\n", "ragged_row", "2 fields"),
             (3, "1,xx,3", "unparseable_token", "token 'xx'"),
             (11, "", "empty", "row has no fields")]
    rj = _quarantine_calls(JAX, path, calls)
    rt = _quarantine_calls(PORT, path, calls)
    assert rt == rj
    assert rt[0] == [True, True, False, True]
    assert rt[1]["bad_rows_total"] == 3
    assert rt[2].startswith(b"# lightgbm_tpu quarantine v1\n")
    recs = tguard.read_quarantine(path)
    assert recs == jguard.read_quarantine(path)
    assert [r["line"] for r in recs] == [3, 9, 11]
    assert recs[1]["raw"] == "1\\t2\\n"


def test_stale_quarantine_file_removed_on_new_guard(tmp_path):
    p = str(tmp_path / "d.csv")
    g = tguard.IngestGuard(p, policy="quarantine")
    g.bad_row(1, "x", "empty", "no fields")
    g.finish()
    assert os.path.exists(g.quarantine_path)
    tguard.IngestGuard(p, policy="quarantine")
    assert not os.path.exists(g.quarantine_path)


@pytest.mark.parametrize("budget,calls", [
    ({"max_bad_rows": 2}, 3),
    ({"max_bad_row_fraction": 0.1}, 200),
])
def test_budgets_match_jax(tmp_path, budget, calls):
    path = str(tmp_path / "d.csv")

    def run(p):
        g = p.guard.IngestGuard(path, policy="quarantine", **budget)
        g.good_rows(99)
        g.bad_row(100, "x", "empty", "no fields")
        g.good_rows(900)
        for i in range(calls):
            g.bad_row(2000 + i, "x", "empty", "no fields")
    _, _ = _same_outcome(run)
    with pytest.raises(LightGBMError, match="budget exhausted"):
        run(PORT)


def test_fraction_budget_at_finish_matches_jax(tmp_path):
    path = str(tmp_path / "e.csv")

    def run(p):
        g = p.guard.IngestGuard(path, policy="quarantine",
                                max_bad_row_fraction=0.1)
        g.good_rows(4)
        g.bad_row(5, "x", "empty", "no fields")      # 1 of 5: 20%
        g.finish()
    _same_outcome(run)
    with pytest.raises(LightGBMError, match="max_bad_row_fraction=0.1"):
        run(PORT)


def test_shadow_guard_skips_without_counting(tmp_path):
    p = str(tmp_path / "d.csv")
    base = tobs.get_counter("bad_rows_total")
    g = tguard.IngestGuard(p, policy="quarantine", record=False)
    assert g.bad_row(3, "1,xx,3", "unparseable_token", "token 'xx'")
    assert g.is_quarantined(3) and not g.is_quarantined(4)
    g.finish()
    assert tobs.get_counter("bad_rows_total") == base
    assert not os.path.exists(g.quarantine_path)


# ---------------------------------------------------------------------------
# the parsers' classification


@pytest.mark.parametrize("lines", [
    ["1,2,3", "1,zz,3", "1,2", ",,", "1,4,5"],
    ["1,na,2", "0,3,NaN", " ", "1,,4"],
    ["x,y,z", "1,2,3"],
])
def test_delimited_classification_matches_jax(tmp_path, lines):
    path = str(tmp_path / "d.csv")

    def run(p):
        g = p.guard.IngestGuard(path, policy="quarantine")
        label, feats = p.parser._parse_delimited(lines, ",", 0, guard=g)
        return label, feats, dict(g.by_reason), list(g.records)
    rj, rt = _same_outcome(run)
    _same_arrays(rj[:2], rt[:2])
    assert rt[2:] == rj[2:]


@pytest.mark.parametrize("lines,num_features", [
    (["1 0:1.5 2:2.5", "0 -3:9.9", "1 1:2.0"], None),
    (["1 0:1 9:9", "0 1:2"], 3),
    (["1 0:1.5", "0 junk", "1 2:zz", "badlabel 0:1"], None),
    (["1 0:1", "1 a:2", "0 99999999:1"], None),
])
@pytest.mark.parametrize("policy", ["fail_fast", "quarantine"])
def test_libsvm_classification_matches_jax(tmp_path, lines, num_features,
                                           policy):
    path = str(tmp_path / "f.svm")

    def run(p):
        g = p.guard.IngestGuard(path, policy=policy)
        label, feats = p.parser._parse_libsvm(lines, num_features,
                                              guard=g)
        return label, feats, dict(g.by_reason)
    rj, rt = _same_outcome(run)
    if rj is not None:
        _same_arrays(rj[:2], rt[:2])
        assert rt[2] == rj[2]


@pytest.mark.parametrize("text,header", [
    ("1,2,3\n1,zz,3\n", False),
    ("lab,a,b\n1,2,3\n\n1,zz,3\n1,4,5\n", True),
    ("1\t2\t3\n\n1\t2\n1\t4\t5\n", False),
])
@pytest.mark.parametrize("policy", ["fail_fast", "quarantine"])
def test_parse_file_matches_jax(tmp_path, text, header, policy):
    path = tmp_path / "d.csv"

    def run(p):
        path.write_text(text)
        g = p.guard.IngestGuard(str(path), policy=policy)
        out = p.parser.parse_file(str(path), has_header=header, guard=g)
        blob = open(g.quarantine_path, "rb").read()
        return out, blob
    rj, rt = _same_outcome(run)
    if rj is not None:
        _same_arrays(rj[0][:2], rt[0][:2])
        assert rt[0][2] == rj[0][2]
        assert rt[1] == rj[1]
    elif policy == "fail_fast":
        with pytest.raises(LightGBMError, match=f"{path}:"):
            run(PORT)


def test_undecodable_bytes_are_classified(tmp_path):
    p = tmp_path / "d.csv"

    def run(pkg, policy):
        p.write_bytes(b"1,2,3\n1,\xff\xfe,3\n1,4,5\n")
        g = pkg.guard.IngestGuard(str(p), policy=policy)
        return pkg.parser.parse_file(str(p), guard=g)[1], dict(g.by_reason)
    for policy in ("fail_fast", "quarantine"):
        rj, rt = _same_outcome(lambda pkg: run(pkg, policy))
        if rj is not None:
            np.testing.assert_array_equal(rt[0], rj[0])
            assert rt[1] == rj[1] == {"unparseable_token": 1}


def test_parse_file_chunks_blank_lines_and_fail_fast_match_jax(tmp_path):
    p = tmp_path / "b.csv"
    rows = []
    for i in range(10):
        rows.append(f"{i % 2},{i},.5")
        if i % 3 == 0:
            rows.append("")
    p.write_text("\n".join(rows) + "\n\n")
    got = list(tparser.parse_file_chunks(str(p), chunk_rows=2))
    want = list(jparser.parse_file_chunks(str(p), chunk_rows=2))
    assert len(got) == len(want) == 5
    for (lt_, xt), (lj, xj) in zip(got, want):
        np.testing.assert_array_equal(xt, xj)
        np.testing.assert_array_equal(lt_, lj)
    p.write_text("1,2,3\n\n1,zz,3\n")
    _same_outcome(lambda pkg: list(pkg.parser.parse_file_chunks(
        str(p), chunk_rows=1)))
    with pytest.raises(LightGBMError, match=f"{p}:3"):
        list(tparser.parse_file_chunks(str(p), chunk_rows=1))


# ---------------------------------------------------------------------------
# the two-round loader's accounting


def _write_tsv(path, n=60, bad_lines=(), seed=0):
    rng = np.random.RandomState(seed)
    rows = []
    for _ in range(n):
        rows.append("\t".join([f"{int(rng.rand() < 0.5)}"]
                              + [f"{v:.6f}" for v in rng.normal(size=3)]))
    for ln in bad_lines:
        rows[ln - 1] = rows[ln - 1] + "\t@@junk@@"
    path.write_text("\n".join(rows) + "\n")
    return rows


def _two_round(pkg, path, guard_kw=None, **kw):
    """The two-round load of ``path`` under a quarantining guard: bins,
    labels, counters, the guard's accounting and the sink's bytes."""
    g = pkg.guard.IngestGuard(str(path), policy="quarantine",
                              **(guard_kw or {}))
    base = pkg.obs.get_counter("bad_rows_total")
    ds = pkg.streaming.load_file_two_round(str(path), guard=g, **kw)
    blob = open(g.quarantine_path, "rb").read() \
        if os.path.exists(g.quarantine_path) else None
    return (ds.bins, ds.metadata.label, ds.num_total_features,
            pkg.obs.get_counter("bad_rows_total") - base, g.rows_seen,
            dict(g.by_reason), blob,
            [(m.num_bin, list(m.bin_upper_bound)) for m in ds.mappers])


@pytest.mark.parametrize("case", ["dedupe", "ragged_first", "budget_rows"])
def test_two_round_accounting_matches_jax(tmp_path, case):
    p = tmp_path / "t.tsv"
    kw = dict(max_bin=15, min_data_in_leaf=5)
    if case == "dedupe":
        _write_tsv(p, n=60, bad_lines=(7, 41))
        kw["chunk_rows"] = 13
    elif case == "ragged_first":
        # line 2 ragged: the field count is line 1's, whichever line
        # the 5-row sample parses first
        rows = _write_tsv(p, n=150)
        rows[1] = "\t".join(rows[1].split("\t")[:3])
        p.write_text("\n".join(rows) + "\n")
        kw.update(bin_construct_sample_cnt=5, data_random_seed=1)
    else:
        _write_tsv(p, n=120, bad_lines=(5,))
        kw["bin_construct_sample_cnt"] = 120
    rj, rt = _same_outcome(lambda pkg: _two_round(pkg, p, **kw))
    _same_arrays(rj[:2], rt[:2])
    assert rt[2:] == rj[2:]
    want = {"dedupe": (2, 58), "ragged_first": (1, 149),
            "budget_rows": (1, 119)}[case]
    assert (rt[3], rt[0].shape[1]) == want
    if case == "budget_rows":
        assert rt[4] == 120          # not 239: the sample counted once


def test_two_round_all_rows_bad_is_named(tmp_path):
    p = tmp_path / "t.tsv"
    p.write_text("a\tb\nx\ty\n")
    _same_outcome(lambda pkg: _two_round(pkg, p))
    with pytest.raises(LightGBMError, match="quarantined"):
        _two_round(PORT, p)


def test_two_round_libsvm_bad_index_cannot_inflate_features(tmp_path):
    p = tmp_path / "t.svm"
    lines = [f"{i % 2} 0:{i}.5 2:{i}.25" for i in range(1, 40)]
    lines[10] = "1 999999:zz"
    p.write_text("\n".join(lines) + "\n")
    rj, rt = _same_outcome(lambda pkg: _two_round(pkg, p, max_bin=15,
                                                  min_data_in_leaf=5))
    _same_arrays(rj[:2], rt[:2])
    assert rt[2:] == rj[2:]
    assert rt[2] == 3 and rt[0].shape[1] == 38
    assert rt[5] == {"unparseable_token": 1}


@pytest.mark.parametrize("side", [".weight", ".query", ".init"])
def test_quarantine_refuses_row_aligned_side_files(tmp_path, side):
    p = tmp_path / "t.tsv"
    _write_tsv(p, n=60, bad_lines=(7,))
    (tmp_path / f"t.tsv{side}").write_text(
        "\n".join("1" for _ in range(60 if side != ".query" else 1)) + "\n")
    rj, rt = _same_outcome(lambda pkg: _two_round(pkg, p, max_bin=15,
                                                  min_data_in_leaf=5))
    with pytest.raises(LightGBMError, match=r"re-align") as exc:
        _two_round(PORT, p, max_bin=15, min_data_in_leaf=5)
    assert side in str(exc.value)
    # without a bad row the side file loads
    c = tmp_path / "c.tsv"
    _write_tsv(c, n=60)
    (tmp_path / "c.tsv.weight").write_text("1.0\n" * 60)
    ds = tstreaming.load_file_two_round(str(c), max_bin=15,
                                        min_data_in_leaf=5)
    assert ds.metadata.weights is not None
