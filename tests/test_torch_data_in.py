"""The torch port's data in (lightgbm_tpu_torch/io/parser.py,
io/column_roles.py, the Metadata of io/dataset.py and ``Dataset``)
against the JAX package's.

The same files and matrices go through both packages:

* the parser: format detection, CSV/TSV with and without a header,
  blank lines (skipped and not counted toward a chunk), NA spellings,
  LibSVM with and without labels, its width (largest index + 1) and its
  densification to a given width, against the JAX package's Python
  parse path; malformed lines raise naming the file and the line;
* ``.weight``, ``.query`` and ``.init`` beside a training and a valid
  file, every column role by index and by ``name:`` (the label against
  the full header, the others with the label removed), in-data weight
  and group columns over the side files, and ``Dataset(weight=,
  group=, init_score=)``: the bins, the used features, the categorical
  flags and every ``Metadata`` array equal to the JAX package's;
* the CLI trains with each role key, and its model header marks the
  ignored columns as the JAX dataset does;
* ``bad_data_policy=quarantine`` and ``use_two_round_loading=true``
  (refused until the data boundary was ported) read as in the JAX
  package: the CLI's model, the bins and the quarantine file are its.
"""

import numpy as np
import pytest

import lightgbm_tpu as lgb
from lightgbm_tpu.io import parser as jparser

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import LightGBMError, cli
from lightgbm_tpu_torch.io import column_roles, parser

pytestmark = pytest.mark.torch

HEADER = ["f0", "y", "f1", "wt", "qid", "f2", "cat", "f3"]


def _table(n=240, seed=0):
    """[n, 8] rows: features f0..f3, a label y, a weight wt, a query id
    qid (runs of 4..20 rows) and a small-integer column cat."""
    rng = np.random.RandomState(seed)
    qid = np.repeat(np.arange(n), rng.randint(4, 21, size=n))[:n]
    tab = np.column_stack([
        rng.normal(size=n).round(4), rng.randint(0, 3, size=n),
        rng.normal(size=n).round(4), rng.uniform(0.5, 2, size=n).round(3),
        qid, rng.normal(size=n).round(4), rng.randint(0, 4, size=n),
        rng.normal(size=n).round(4)])
    return tab


def _write(path, tab, header=False, delim=","):
    lines = ([delim.join(HEADER)] if header else []) + [
        delim.join(f"{v:g}" for v in row) for row in tab]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _both_construct(data, params, valid=None, **kw):
    """The JAX and the port Dataset of ``data`` (a path or a matrix) with
    ``params``; with ``valid``, the valid set of that path instead."""
    jd = lgb.Dataset(data, params=dict(params), **kw)
    td = lt.Dataset(data, params=dict(params), **kw)
    if valid is not None:
        jd = jd.create_valid(valid)._update_params(dict(params))
        td = td.create_valid(valid, params=dict(params))
    return jd.construct()._binned, td.construct()._binned


def _same_binned(j, t):
    np.testing.assert_array_equal(t.bins, j.bins)
    assert list(t.used_feature_map) == list(j.used_feature_map)
    np.testing.assert_array_equal(t.real_to_inner, j.real_to_inner)
    np.testing.assert_array_equal(t.is_categorical_per_feature(),
                                  j.is_categorical_per_feature())
    assert t.feature_infos() == j.feature_infos()
    assert list(t.feature_names) == list(j.feature_names)
    _same_metadata(j.metadata, t.metadata)


def _same_metadata(jm, tm):
    for field in ("label", "weights", "query_boundaries", "query_weights",
                  "init_score"):
        a, b = getattr(jm, field), getattr(tm, field)
        assert (a is None) == (b is None), field
        if a is not None:
            assert b.dtype == a.dtype, field
            np.testing.assert_array_equal(b, a, err_msg=field)
    assert tm.num_queries() == jm.num_queries()


# ---------------------------------------------------------------------------
# the parser


@pytest.mark.parametrize("lines,fmt", [
    (["1,2,3", "4,5,6"], "csv"),
    (["1\t2\t3"], "tsv"),
    (["1 0:2 3:4", "0 1:1"], "libsvm"),
    (["a,b:c,d"], "csv"),
    (["1 2 3"], "csv"),
])
def test_detect_format_matches_jax(lines, fmt):
    assert parser.detect_format(lines) == jparser.detect_format(lines) == fmt


@pytest.mark.parametrize("delim", [",", "\t"])
@pytest.mark.parametrize("header", [False, True])
def test_delimited_file_matches_jax(tmp_path, delim, header):
    tab = _table()
    path = _write(tmp_path / "d.txt", tab, header, delim)
    # blank lines and NA spellings inside the file
    text = open(path).read().splitlines()
    text.insert(5, "")
    text.insert(9, "   ")
    text[12] = text[12].replace(text[12].split(delim)[2], "NA", 1)
    open(path, "w").write("\n".join(text) + "\n")
    for label_idx in (0, 1, -1):
        jchunks = list(jparser.parse_file_chunks(path, header, label_idx,
                                                 chunk_rows=50))
        tchunks = list(parser.parse_file_chunks(path, header, label_idx,
                                                chunk_rows=50))
        assert [c[1].shape for c in tchunks] == [c[1].shape for c in jchunks]
        for (jl, jx), (tl, tx) in zip(jchunks, tchunks):
            np.testing.assert_array_equal(tl, jl)
            np.testing.assert_array_equal(tx, jx)
    label, X, names = parser.parse_file(path, header, 1)
    assert X.shape == (len(tab), 7) and np.isnan(X).sum() == 1
    np.testing.assert_array_equal(label, tab[:, 1])
    assert names == (HEADER[:1] + HEADER[2:] if header else None)


LIBSVM = """1 0:1.5 3:-2 7:0.25

0 2:1 3:nan
2 1:3e-2
0 9:1
1 0:2 0:3
3:4 5:1
"""


@pytest.mark.parametrize("width", [None, 10, 12])
def test_libsvm_matches_jax(tmp_path, width):
    path = tmp_path / "r.svm"
    path.write_text(LIBSVM)
    jl, jx = zip(*jparser.parse_file_chunks(str(path), num_features=width,
                                            chunk_rows=2))
    tl, tx = zip(*parser.parse_file_chunks(str(path), num_features=width,
                                           chunk_rows=2))
    for a, b in zip(jx + jl, tx + tl):
        np.testing.assert_array_equal(b, a)
    label, X, _ = parser.parse_file(str(path), num_features=width)
    assert X.shape == (6, width or 10)
    np.testing.assert_array_equal(label, [1, 0, 2, 0, 1, 0])
    assert X[0, 7] == 0.25 and X[4, 0] == 3 and X[5, 3] == 4


def test_libsvm_valid_file_densifies_to_the_training_width(tmp_path):
    rng = np.random.RandomState(1)
    tr = tmp_path / "tr.svm"
    va = tmp_path / "va.svm"
    rows = lambda n, top: "\n".join(  # noqa: E731
        f"{rng.randint(0, 2)} " + " ".join(
            f"{c}:{rng.normal():.3f}" for c in sorted(
                rng.choice(top, 4, replace=False))) for _ in range(n))
    tr.write_text(rows(200, 12) + "\n")
    va.write_text(rows(60, 6) + "\n")          # a narrower file
    params = {"min_data_in_leaf": 5, "min_data_in_bin": 1}
    jd = lgb.Dataset(str(tr), params=params)
    j = jd.construct()._binned
    td = lt.Dataset(str(tr), params=params)
    t = td.construct()._binned
    _same_binned(j, t)
    assert t.num_total_features == 12
    tv = td.create_valid(str(va), params=params).construct()._binned
    assert tv.bins.shape == (t.num_features, 60)
    _, Xv, _ = jparser.parse_file(str(va), num_features=12)
    want = j.create_valid(Xv, None)
    np.testing.assert_array_equal(tv.bins, want.bins)
    va.write_text("1 12:1\n")                  # past the training width
    with pytest.raises(LightGBMError, match=r"va.svm:1: bad_column_index"):
        td.create_valid(str(va), params=params).construct()


@pytest.mark.parametrize("text,reason,line", [
    ("1,2,3\n4,5\n", "ragged_row", 2),
    ("1,2,3\n\n4,x,6\n", "unparseable_token", 3),
    ("1 0:1\n1 a:2\n", "bad_column_index", 2),
    ("1 0:1\n1 -3:2\n", "bad_column_index", 2),
    ("1 0:1\n1 2\n", "unparseable_token", 2),
])
def test_malformed_line_raises_naming_file_and_line(tmp_path, text, reason,
                                                    line):
    path = tmp_path / "bad.txt"
    path.write_text(text)
    with pytest.raises(LightGBMError, match=rf"bad.txt:{line}: {reason}"):
        parser.parse_file(str(path))


# ---------------------------------------------------------------------------
# side files and column roles


def _side_files(path, tab, which):
    n = len(tab)
    rng = np.random.RandomState(9)
    if ".weight" in which:
        np.savetxt(path + ".weight", rng.uniform(0.2, 3, size=n), "%.6g")
    if ".query" in which:
        sizes = np.diff(np.concatenate(
            [[0], np.nonzero(np.diff(tab[:, 4]))[0] + 1, [n]]))
        np.savetxt(path + ".query", sizes, "%d")
    if ".init" in which:
        np.savetxt(path + ".init", rng.normal(size=n), "%.6g")


@pytest.mark.parametrize("ext", [".weight", ".init", ".query"])
def test_side_file_beside_data_matches_jax(tmp_path, ext):
    tab = _table()
    path = _write(tmp_path / "train.csv", tab)
    _side_files(path, tab, [ext])
    j, t = _both_construct(path, {"min_data_in_leaf": 5})
    _same_binned(j, t)
    field = {".weight": "weights", ".init": "init_score",
             ".query": "query_boundaries"}[ext]
    assert getattr(t.metadata, field) is not None


def test_side_file_beside_valid_data_matches_jax(tmp_path):
    tab = _table()
    path = _write(tmp_path / "train.csv", tab)
    vtab = _table(90, seed=3)
    vpath = _write(tmp_path / "valid.csv", vtab)
    _side_files(vpath, vtab, [".weight", ".query", ".init"])
    j, t = _both_construct(path, {"min_data_in_leaf": 5}, valid=vpath)
    _same_binned(j, t)
    assert t.metadata.query_weights is not None


# (key as given, value, header) for each role key and one JAX alias:
# indices of the roles other than the label count with the label removed
ROLES = [
    ("label_column", "1", False),
    ("label", "name:y", True),
    ("weight_column", "2", False),
    ("weight", "name:wt", True),
    ("group_column", "3", False),
    ("query", "name:qid", True),
    ("ignore_column", "0,4", False),
    ("blacklist", "name:f1,f3", True),
    ("categorical_column", "5", False),
    ("cat_feature", "name:cat", True),
]


@pytest.mark.parametrize("key,value,header", ROLES)
def test_column_role_matches_jax(tmp_path, key, value, header):
    tab = _table()
    path = _write(tmp_path / "train.csv", tab, header)
    params = {key: value, "has_header": header, "min_data_in_leaf": 5}
    if key not in ("label_column", "label"):
        params["label_column"] = "1"
    j, t = _both_construct(path, params)
    _same_binned(j, t)
    np.testing.assert_array_equal(t.metadata.label, tab[:, 1])


@pytest.mark.parametrize("key,value,header", ROLES)
def test_cli_trains_with_column_role(tmp_path, key, value, header):
    tab = _table()
    data = _write(tmp_path / "train.csv", tab, header)
    args = ["task=train", f"data={data}", "objective=regression",
            "device=cpu", "num_iterations=1", "num_leaves=4",
            "min_data_in_leaf=5", f"header={str(header).lower()}",
            f"output_model={tmp_path / 'm.txt'}", f"{key}={value}"]
    if key not in ("label_column", "label"):
        args.append("label_column=1")
    assert cli.main(args) == 0
    params = {k: v for k, v in (a.split("=", 1) for a in args[5:])
              if k not in ("output_model", "device")}
    want = lgb.Dataset(data, params=params).construct()._binned
    text = (tmp_path / "m.txt").read_text()
    infos = next(ln for ln in text.splitlines()
                 if ln.startswith("feature_infos="))
    assert infos == "feature_infos=" + " ".join(want.feature_infos())
    assert "max_feature_idx=6" in text


def test_in_data_columns_override_side_files(tmp_path):
    tab = _table()
    path = _write(tmp_path / "train.csv", tab)
    _side_files(path, tab, [".weight", ".query"])
    params = {"label_column": "1", "weight_column": "2",
              "group_column": "3", "min_data_in_leaf": 5}
    j, t = _both_construct(path, params)
    _same_binned(j, t)
    np.testing.assert_array_equal(t.metadata.weights,
                                  tab[:, 3].astype(np.float32))
    qb = t.metadata.query_boundaries
    np.testing.assert_array_equal(
        np.diff(qb), column_roles.qid_to_query_sizes(tab[:, 4]))


def test_dataset_weight_group_init_score_match_jax(tmp_path):
    tab = _table()
    X = np.delete(tab, 1, axis=1)
    rng = np.random.RandomState(4)
    w = rng.uniform(0.5, 2, size=len(tab))
    group = column_roles.qid_to_query_sizes(tab[:, 4])
    init = rng.normal(size=len(tab))
    kw = dict(label=tab[:, 1], weight=w, group=group, init_score=init)
    j = lgb.Dataset(X, params={"min_data_in_leaf": 5}, weight=w,
                    group=group, label=tab[:, 1])
    j.init_score = init
    t = lt.Dataset(X, params={"min_data_in_leaf": 5}, **kw)
    _same_binned(j.construct()._binned, t.construct()._binned)
    np.testing.assert_array_equal(t.get_group(), group)
    np.testing.assert_array_equal(t.get_weight(), w.astype(np.float32))
    # a file's side files override the arguments, as in the JAX package
    path = _write(tmp_path / "train.csv", tab)
    _side_files(path, tab, [".weight"])
    j, t = _both_construct(path, {"min_data_in_leaf": 5}, weight=w)
    _same_binned(j, t)


@pytest.mark.parametrize("weighted", [False, True])
def test_set_query_id_matches_jax(weighted):
    from lightgbm_tpu.io.dataset import Metadata as JaxMetadata
    from lightgbm_tpu_torch.io.dataset import Metadata
    qid = [3, 3, 1, 1, 1, 7, 3, 3, 9]
    w = np.random.RandomState(5).uniform(0.5, 2, size=len(qid))
    jm, tm = JaxMetadata(len(qid)), Metadata(len(qid))
    for md in (jm, tm):
        md.set_label(np.zeros(len(qid)))
        if weighted:
            md.set_weights(w)
        md.set_query_id(qid)
    _same_metadata(jm, tm)
    assert tm.num_queries() == 5


def test_column_roles_on_a_matrix_are_ignored_like_jax():
    rng = np.random.RandomState(0)
    X = rng.normal(size=(60, 3))
    y = (X[:, 0] > 0).astype(float)
    j, t = _both_construct(X, {"label_column": "0", "weight_column": "1"},
                           label=y)
    _same_binned(j, t)


def test_name_role_without_header_raises():
    with pytest.raises(LightGBMError, match="Could not find"):
        column_roles.resolve_roles(weight_column="name:w")
    with pytest.raises(LightGBMError, match="not a number"):
        column_roles.resolve_roles(ignore_column="a,b")
    assert column_roles.resolve_label_idx("name:y", HEADER) == 1
    roles = column_roles.resolve_roles("2", "name:qid", "0", "name:cat",
                                       HEADER[:1] + HEADER[2:])
    assert roles.weight_idx == 2 and roles.group_idx == 3
    assert roles.ignore == {0, 2, 3} and roles.categorical == {5}


@pytest.mark.parametrize("key,value,what", [
    ("bad_data_policy", "quarantine", "bad_data_policy=quarantine"),
    ("use_two_round_loading", "true", "use_two_round_loading"),
    ("two_round", "true", "use_two_round_loading"),
])
def test_unported_loading_keys_are_refused(tmp_path, key, value, what):
    """Ported since (the data boundary): the key is read as the JAX
    package reads it.  On a file with one malformed row the CLI trains
    the JAX CLI's model under it, the Dataset bins as the JAX package's
    does, and the quarantine file is the JAX package's."""
    from unittest import mock

    from lightgbm_tpu import cli as jax_cli

    import chip_smoke as cs
    tab = _table()
    path = _write(tmp_path / "train.csv", tab)
    lines = open(path).read().splitlines()
    lines[17] = lines[17].replace(",", ",@@,", 1)   # a ragged, bad row
    open(path, "w").write("\n".join(lines) + "\n")
    quarantine = {key: value, "bad_data_policy": "quarantine"}
    out = {}
    for name, main, extra in (("jax", jax_cli.main, []),
                              ("torch", cli.main, ["device=cpu"])):
        model = tmp_path / f"{name}.txt"
        with mock.patch("lightgbm_tpu.io.native.parse_file_native",
                        return_value=None):
            cs.run_main(main, ["task=train", f"data={path}",
                               "objective=regression", "num_leaves=4",
                               "num_iterations=2", "min_data_in_leaf=5",
                               f"output_model={model}"] + extra
                        + [f"{k}={v}" for k, v in quarantine.items()])
        out[name] = (model.read_text(),
                     open(path + ".quarantine", "rb").read())
    assert out["torch"][1] == out["jax"][1]
    assert out["torch"][1].splitlines()[3].startswith(b"18\tragged_row\t")
    trees, flip, _ = cs.compare_model_texts(
        out["torch"][0], out["jax"][0], what, names=("torch", "jax"),
        tie_rtol=1e-5, leaf_rtol=1e-5)
    assert trees == 2 and flip is None
    with mock.patch("lightgbm_tpu.io.native.parse_file_native",
                    return_value=None):
        j, t = _both_construct(path, {**quarantine, "min_data_in_leaf": 5})
    _same_binned(j, t)
    assert t.num_data == len(tab) - 1
    # without quarantine the malformed row is named, in both packages
    if key != "bad_data_policy":
        with pytest.raises(LightGBMError, match=f"train.csv:18: "):
            lt.Dataset(path, params={key: value}).construct()


def test_cli_predict_honours_label_column_and_libsvm(tmp_path):
    tab = _table()
    X = np.delete(tab, 1, axis=1)
    b = lt.train({"objective": "regression", "num_leaves": 4,
                  "min_data_in_leaf": 5, "verbose": -1},
                 lt.Dataset(X, tab[:, 1]), 2, device="cpu",
                 verbose_eval=False)
    model = tmp_path / "m.txt"
    b.save_model(str(model))
    want = b.predict(X)
    data = _write(tmp_path / "rows.csv", tab, header=True)
    out = tmp_path / "p.txt"
    assert cli.main(["task=predict", f"data={data}", "device=cpu",
                     f"input_model={model}", "header=true",
                     "label_column=name:y", f"output_result={out}"]) == 0
    np.testing.assert_allclose(np.loadtxt(out), want, rtol=1e-5, atol=1e-6)
    # the same rows as LibSVM without a label, densified to the model
    svm = tmp_path / "rows.svm"
    svm.write_text("\n".join(" ".join(f"{j}:{v:g}" for j, v in enumerate(row)
                                      if v != 0) for row in X) + "\n")
    assert cli.main(["task=predict", f"data={svm}", "device=cpu",
                     f"input_model={model}", f"output_result={out}"]) == 0
    np.testing.assert_allclose(np.loadtxt(out), want, rtol=1e-5, atol=1e-6)
