"""The port's plots (lightgbm_tpu_torch/plotting.py) against the JAX
package's (lightgbm_tpu/plotting.py), on matplotlib's Agg backend.

One model (trained by the port on the CPU) is loaded into both
packages' Boosters, and one ``evals_result`` feeds both
``plot_metric``s: the bars, the line data and the node labels drawn
are the JAX package's.  ``examples/python-guide/plot_example.py`` runs
as written with the port in place of the JAX package.
"""

import functools
import pathlib
import shutil
import sys
import types

import matplotlib
import pytest

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

import lightgbm_tpu as lgb  # noqa: E402
from lightgbm_tpu.utils.log import LightGBMError as JaxError  # noqa: E402

import lightgbm_tpu_torch as lt  # noqa: E402
from lightgbm_tpu_torch.utils.log import LightGBMError  # noqa: E402

from chip_smoke import make_higgs_like  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def boosters(tmp_path_factory):
    """(the JAX Booster, the port's Booster, evals_result) of one model."""
    X, y = make_higgs_like(1500, seed=21)
    evals = {}
    params = {"objective": "binary", "num_leaves": 7, "verbose": -1,
              "metric": ["binary_logloss", "auc"]}
    train = lt.Dataset(X[:1000], y[:1000])
    bt = lt.train(params, train, 6,
                  valid_sets=[train, lt.Dataset(X[1000:], y[1000:],
                                                reference=train)],
                  valid_names=["train", "eval"], evals_result=evals,
                  verbose_eval=False, device="cpu")
    path = str(tmp_path_factory.mktemp("plots") / "model.txt")
    bt.save_model(path)
    return (lgb.Booster(model_file=path),
            lt.Booster(model_file=path, device="cpu"), evals)


@pytest.fixture(autouse=True)
def close_figures():
    yield
    plt.close("all")


def _bars(ax):
    return [(p.get_x(), p.get_y(), p.get_width(), p.get_height())
            for p in ax.patches]


def _texts(ax):
    return [(t.get_text(), t.get_position()) for t in ax.texts]


def _frame(ax):
    return (ax.get_title(), ax.get_xlabel(), ax.get_ylabel(),
            ax.get_xlim(), ax.get_ylim(),
            [t.get_text() for t in ax.get_yticklabels()])


@pytest.mark.parametrize("kwargs", [
    {},
    {"importance_type": "gain", "max_num_features": 4},
    {"ignore_zero": False, "title": None, "xlim": (0, 50)},
])
def test_plot_importance_draws_jax_bars(boosters, kwargs):
    bj, bt, _ = boosters
    aj = lgb.plot_importance(bj, **kwargs)
    at = lt.plot_importance(bt, **kwargs)
    assert _bars(at) == _bars(aj) and len(_bars(at)) > 0
    assert _texts(at) == _texts(aj)
    assert _frame(at) == _frame(aj)


@pytest.mark.parametrize("kwargs", [
    {},
    {"metric": "auc", "dataset_names": ["eval"], "ylabel": "AUC",
     "xlim": (0, 7)},
])
def test_plot_metric_draws_jax_lines(boosters, kwargs):
    _, _, evals = boosters
    aj = lgb.plot_metric(evals, **kwargs)
    at = lt.plot_metric(evals, **kwargs)
    lines = lambda ax: [(ln.get_label(), list(ln.get_xdata()),  # noqa: E731
                         list(ln.get_ydata())) for ln in ax.get_lines()]
    assert lines(at) == lines(aj) and len(lines(at)) > 0
    assert _frame(at) == _frame(aj)
    assert [t.get_text() for t in at.get_legend().get_texts()] == \
        [t.get_text() for t in aj.get_legend().get_texts()]


@pytest.mark.parametrize("tree_index,show_info", [(0, None), (5, True)])
def test_plot_tree_draws_jax_nodes(boosters, tree_index, show_info):
    bj, bt, _ = boosters
    aj = lgb.plot_tree(bj, tree_index=tree_index, show_info=show_info)
    at = lt.plot_tree(bt, tree_index=tree_index, show_info=show_info)
    assert _texts(at) == _texts(aj) and len(_texts(at)) == 13
    assert [list(ln.get_xydata().ravel()) for ln in at.get_lines()] == \
        [list(ln.get_xydata().ravel()) for ln in aj.get_lines()]
    assert at.get_title() == aj.get_title() == f"Tree {tree_index}"


def test_plots_take_an_estimator_and_refuse_as_jax(boosters):
    X, y = make_higgs_like(600, seed=22)
    est = lt.LGBMRegressor(n_estimators=3, num_leaves=5, device="cpu")
    est.fit(X, y, eval_set=[(X, y)], verbose=False)
    jest = lgb.LGBMRegressor(n_estimators=3, num_leaves=5)
    jest.fit(X, y, eval_set=[(X, y)], verbose=False)
    assert _bars(lt.plot_importance(est)) == _bars(lgb.plot_importance(jest))
    at, aj = lt.plot_metric(est), lgb.plot_metric(jest)
    assert [ln.get_label() for ln in at.get_lines()] == \
        [ln.get_label() for ln in aj.get_lines()]
    for pkg, err in ((lt, LightGBMError), (lgb, JaxError)):
        with pytest.raises(TypeError, match="Booster or LGBMModel"):
            pkg.plot_importance("model.txt")
        with pytest.raises(TypeError, match="dict or LGBMModel"):
            pkg.plot_metric([1, 2])
        with pytest.raises(ValueError, match="cannot be empty"):
            pkg.plot_metric({})
        with pytest.raises(TypeError, match="tuple of 2 elements"):
            pkg.plot_importance(boosters[1] if pkg is lt else boosters[0],
                                figsize=(1, 2, 3))
        unfitted = (pkg.LGBMRegressor(device="cpu") if pkg is lt
                    else pkg.LGBMRegressor())
        unfitted._evals_result = None
        with pytest.raises(err, match="eval results are unavailable"):
            pkg.plot_metric(unfitted)
    with pytest.raises(IndexError, match="out of range"):
        lt.plot_tree(boosters[1], tree_index=99)


def test_plotting_is_exported_with_matplotlib():
    for name in ("plot_importance", "plot_metric", "plot_tree"):
        assert name in lt.__all__ and callable(getattr(lt, name))


def test_plot_example_runs_on_the_port(tmp_path, monkeypatch, capsys):
    """examples/python-guide/plot_example.py as written, with the port
    (on the CPU) in place of the JAX package, in a copy of the example
    tree: it writes its three figures."""
    guide = tmp_path / "python-guide"
    guide.mkdir()
    shutil.copytree(REPO / "examples" / "regression",
                    tmp_path / "regression")
    src = (REPO / "examples" / "python-guide" /
           "plot_example.py").read_text()
    port = types.SimpleNamespace(
        Dataset=lt.Dataset, record_evaluation=lt.record_evaluation,
        plot_metric=lt.plot_metric, plot_importance=lt.plot_importance,
        plot_tree=lt.plot_tree,
        train=functools.partial(lt.train, device="cpu"))
    monkeypatch.chdir(guide)
    monkeypatch.setitem(sys.modules, "lightgbm_tpu", port)
    exec(compile(src, "plot_example.py", "exec"), {"__name__": "main"})
    assert "wrote metric.png importance.png tree.png" in \
        capsys.readouterr().out
    for name in ("metric.png", "importance.png", "tree.png"):
        assert (guide / name).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
