"""Plotting over the port's models: ``plot_importance``, ``plot_metric``
and ``plot_tree``.

Port of the JAX package's plotting.py (reference
python-package/lightgbm/plotting.py).  ``plot_tree`` draws one tree of
``Booster.dump_model`` with matplotlib alone (the reference shells out
to graphviz).  matplotlib is imported inside each function, so the
module imports without it.
"""

from __future__ import annotations

import numpy as np

from .basic import Booster
from .sklearn import LGBMModel
from .utils.log import LightGBMError


def _check_not_tuple_of_2_elements(obj, obj_name="obj"):
    if not isinstance(obj, tuple) or len(obj) != 2:
        raise TypeError(f"{obj_name} must be a tuple of 2 elements.")


def _to_booster(booster) -> Booster:
    if isinstance(booster, LGBMModel):
        return booster.booster_
    if isinstance(booster, Booster):
        return booster
    raise TypeError("booster must be Booster or LGBMModel.")


def plot_importance(booster, ax=None, height=0.2,
                    xlim=None, ylim=None, title="Feature importance",
                    xlabel="Feature importance", ylabel="Features",
                    importance_type="split", max_num_features=None,
                    ignore_zero=True, figsize=None, grid=True, **kwargs):
    """Horizontal bars of the feature importances (reference
    plotting.py:22-123)."""
    import matplotlib.pyplot as plt

    booster = _to_booster(booster)
    importance = booster.feature_importance(importance_type=importance_type)
    names = booster.feature_name()
    if not len(importance):
        raise ValueError("Booster's feature_importance is empty.")

    tuples = sorted(zip(names, importance), key=lambda x: x[1])
    if ignore_zero:
        tuples = [x for x in tuples if x[1] > 0]
    if max_num_features is not None and max_num_features > 0:
        tuples = tuples[-max_num_features:]
    labels, values = zip(*tuples) if tuples else ((), ())

    if ax is None:
        if figsize is not None:
            _check_not_tuple_of_2_elements(figsize, "figsize")
        _, ax = plt.subplots(1, 1, figsize=figsize)

    ylocs = np.arange(len(values))
    ax.barh(ylocs, values, align="center", height=height, **kwargs)
    for x, y in zip(values, ylocs):
        ax.text(x + 1, y, str(x), va="center")
    ax.set_yticks(ylocs)
    ax.set_yticklabels(labels)
    if xlim is not None:
        _check_not_tuple_of_2_elements(xlim, "xlim")
    else:
        xlim = (0, max(values) * 1.1 if values else 1)
    ax.set_xlim(xlim)
    if ylim is not None:
        _check_not_tuple_of_2_elements(ylim, "ylim")
    else:
        ylim = (-1, len(values))
    ax.set_ylim(ylim)
    if title is not None:
        ax.set_title(title)
    if xlabel is not None:
        ax.set_xlabel(xlabel)
    if ylabel is not None:
        ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def plot_metric(booster, metric=None, dataset_names=None,
                ax=None, xlim=None, ylim=None,
                title="Metric during training",
                xlabel="Iterations", ylabel="auto",
                figsize=None, grid=True):
    """Metric curves from an ``evals_result`` dict or a fitted
    ``LGBMModel`` (reference plotting.py:126-240)."""
    import matplotlib.pyplot as plt

    if isinstance(booster, LGBMModel):
        eval_results = booster.evals_result_
        if eval_results is None:
            raise LightGBMError(
                "eval results are unavailable; pass eval_set to fit()")
    elif isinstance(booster, dict):
        eval_results = booster
    else:
        raise TypeError("booster must be dict or LGBMModel.")
    if not eval_results:
        raise ValueError("eval results cannot be empty.")

    if ax is None:
        if figsize is not None:
            _check_not_tuple_of_2_elements(figsize, "figsize")
        _, ax = plt.subplots(1, 1, figsize=figsize)

    if dataset_names is None:
        dataset_names = iter(eval_results.keys())
    name_first = None
    num_iters = 0
    for name in dataset_names:
        metrics = eval_results.get(name)
        if not metrics:
            continue
        if metric is None:
            metric_name, results = list(metrics.items())[0]
        else:
            if metric not in metrics:
                raise KeyError(f"No given metric {metric!r} in eval results")
            metric_name, results = metric, metrics[metric]
        num_iters = max(num_iters, len(results))
        ax.plot(range(1, len(results) + 1), results, label=name)
        name_first = name_first or metric_name
    ax.legend(loc="best")
    if xlim is not None:
        _check_not_tuple_of_2_elements(xlim, "xlim")
        ax.set_xlim(xlim)
    if ylim is not None:
        _check_not_tuple_of_2_elements(ylim, "ylim")
        ax.set_ylim(ylim)
    if ylabel == "auto":
        ylabel = name_first
    if title is not None:
        ax.set_title(title)
    if xlabel is not None:
        ax.set_xlabel(xlabel)
    if ylabel is not None:
        ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def plot_tree(booster, ax=None, tree_index=0, figsize=None,
              show_info=None, precision=3, **kwargs):
    """Draw one tree of the model with matplotlib (reference plot_tree,
    plotting.py:281-356, drawn without graphviz)."""
    import matplotlib.pyplot as plt

    booster = _to_booster(booster)
    model = booster.dump_model()
    if tree_index >= len(model["tree_info"]):
        raise IndexError("tree_index is out of range.")
    tree = model["tree_info"][tree_index]
    names = model["feature_names"]

    if ax is None:
        if figsize is not None:
            _check_not_tuple_of_2_elements(figsize, "figsize")
        _, ax = plt.subplots(1, 1, figsize=figsize or (12, 8))

    # layout: depth-first x positions of leaves, y = -depth
    positions = {}
    leaf_x = [0.0]

    def layout(node, depth):
        if "leaf_index" in node or "leaf_value" in node and \
                "split_index" not in node:
            x = leaf_x[0]
            leaf_x[0] += 1.0
            positions[id(node)] = (x, -depth)
            return x
        xl = layout(node["left_child"], depth + 1)
        xr = layout(node["right_child"], depth + 1)
        x = (xl + xr) / 2.0
        positions[id(node)] = (x, -depth)
        return x

    root = tree["tree_structure"]
    layout(root, 0)

    def draw(node):
        x, y = positions[id(node)]
        if "split_index" in node:
            feat = node.get("split_feature", 0)
            fname = names[feat] if feat < len(names) else f"f{feat}"
            op = "==" if node.get("decision_type") == "is" else "<="
            thr = node.get("threshold", 0.0)
            label = f"{fname} {op} {thr:.{precision}g}"
            for child in (node["left_child"], node["right_child"]):
                cx, cy = positions[id(child)]
                ax.plot([x, cx], [y, cy], "-", color="gray", zorder=1)
                draw(child)
            box = dict(boxstyle="round", fc="lightblue", ec="steelblue")
        else:
            label = f"leaf: {node.get('leaf_value', 0.0):.{precision}g}"
            if show_info and "leaf_count" in node:
                label += f"\ncount: {node['leaf_count']}"
            box = dict(boxstyle="round", fc="lightyellow", ec="olive")
        ax.text(x, y, label, ha="center", va="center", bbox=box, zorder=2)

    draw(root)
    ax.set_axis_off()
    ax.set_title(f"Tree {tree_index}")
    return ax
