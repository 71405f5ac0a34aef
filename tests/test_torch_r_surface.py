"""The R binding's contract held against the port.

``R-package/`` drives the Python package through reticulate; there is
no R runtime here, so, as tests/test_r_surface.py does for the JAX
package, the contract is pinned on the Python side: every attribute the
R sources call on the package (``lgb$name(``), on the callback module
(``cb_mod$name(``), on a ``Booster`` or on a ``Dataset`` (``$py$name(``)
exists in the port, and each call site binds to the port's signature
(its positional count and its argument names).  The R files themselves
are not touched.
"""

import inspect
import os
import re

import numpy as np
import pytest

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import callback as cb
from lightgbm_tpu_torch.basic import Booster, Dataset

from torch_threads import one_torch_thread  # noqa: F401

R_DIR = os.path.join(os.path.dirname(__file__), "..", "R-package", "R")

_CALL = re.compile(r"(lgb|cb_mod|\$py)\$`?([A-Za-z_]+)`?\(")
_NAMED = re.compile(r"^\s*([A-Za-z_][A-Za-z0-9_.]*)\s*=(?!=)")


def _args(src: str, start: int):
    """The top-level arguments of the call whose '(' is at ``start``."""
    depth, quote, cur, out = 0, None, [], []
    for ch in src[start + 1:]:
        if quote:
            quote = None if ch == quote else quote
        elif ch in "\"'":
            quote = ch
        elif ch in "([{":
            depth += 1
        elif ch in ")]}":
            if depth == 0:
                break
            depth -= 1
        elif ch == "," and depth == 0:
            out.append("".join(cur))
            cur = []
            continue
        cur.append(ch)
    if "".join(cur).strip():
        out.append("".join(cur))
    return out


def r_calls():
    """[(file, receiver, name, n_positional, named)] of every call site."""
    calls = []
    for fname in sorted(os.listdir(R_DIR)):
        src = open(os.path.join(R_DIR, fname)).read()
        for m in _CALL.finditer(src):
            args = _args(src, m.end() - 1)
            named = [_NAMED.match(a).group(1) for a in args
                     if _NAMED.match(a)]
            calls.append((fname, m.group(1), m.group(2),
                          len(args) - len(named), named))
    return calls


def _targets(receiver: str, name: str):
    if receiver == "lgb":
        return [getattr(lt, name, None)]
    if receiver == "cb_mod":
        return [getattr(cb, name, None)]
    return [getattr(Booster, name, None), getattr(Dataset, name, None)]


def _binds(fn, receiver: str, n_pos: int, named) -> bool:
    sig = inspect.signature(fn)
    pos = [None] * n_pos
    if receiver == "$py" and not isinstance(
            inspect.getattr_static(Booster, fn.__name__, None)
            or inspect.getattr_static(Dataset, fn.__name__, None),
            staticmethod):
        pos = [None] + pos          # self
    try:
        sig.bind(*pos, **{k: None for k in named})
    except TypeError:
        return False
    return True


def test_r_sources_call_python():
    calls = r_calls()
    assert len(calls) >= 30
    assert {c[1] for c in calls} == {"lgb", "cb_mod", "$py"}


@pytest.mark.parametrize("call", r_calls(),
                         ids=lambda c: f"{c[0]}:{c[1]}${c[2]}")
def test_r_call_site_binds_to_the_port(call):
    fname, receiver, name, n_pos, named = call
    fns = [f for f in _targets(receiver, name) if f is not None]
    assert fns, f"{receiver}${name} (called from {fname}) missing in the port"
    assert any(_binds(f, receiver, n_pos, named) for f in fns), (
        f"{fname}: {receiver}${name}({n_pos} positional, {named}) does not "
        f"bind to {[str(inspect.signature(f)) for f in fns]}")


def test_booster_and_dataset_surface_for_r():
    for method in ("add_valid", "update", "rollback_one_iter",
                   "current_iteration", "eval", "eval_train", "eval_valid",
                   "save_model", "model_to_string", "dump_model", "predict",
                   "feature_importance", "num_trees"):
        assert callable(getattr(Booster, method)), method
    for method in ("construct", "num_data", "num_feature", "set_label",
                   "set_weight", "set_init_score", "set_group", "get_label",
                   "get_weight", "get_init_score", "get_group", "subset",
                   "save_binary", "set_reference", "set_categorical_feature",
                   "set_feature_name"):
        assert callable(getattr(Dataset, method)), method


def test_r_dump_model_and_attributes_on_the_port():
    """lgb.model.dt.tree and lgb.interprete read these dump fields;
    lgb.Booster$num_class() the private GBDT handle; lgb.Dataset's
    dimnames the constructed dataset's feature names."""
    rng = np.random.RandomState(0)
    X = rng.normal(size=(300, 4))
    y = (X[:, 0] > 0).astype(float)
    ds = lt.Dataset(X, label=y)
    bst = lt.train({"objective": "binary", "num_leaves": 4,
                    "min_data_in_leaf": 20, "verbose": -1}, ds,
                   num_boost_round=2, device="cpu")
    dump = bst.dump_model()
    assert "feature_names" in dump and "tree_info" in dump
    node = dump["tree_info"][0]["tree_structure"]
    for key in ("split_index", "split_feature", "split_gain", "threshold",
                "decision_type", "internal_value", "internal_count",
                "left_child", "right_child"):
        assert key in node, key
    leaf = node["left_child"]
    while "leaf_index" not in leaf:
        leaf = leaf["left_child"]
    for key in ("leaf_index", "leaf_parent", "leaf_value", "leaf_count"):
        assert key in leaf, key
    assert bst._booster.num_class == 1 and bst.num_trees() == 2
    assert ds.construct()._binned.feature_names == [f"Column_{i}"
                                                    for i in range(4)]
    # lgb.train reads py_booster$best_iteration
    assert isinstance(bst.best_iteration, int)
