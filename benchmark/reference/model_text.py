"""Reads and writes the trees of LightGBM's model text (tree.cpp
ToString / the Tree(str) constructor): numerical splits only, ``bin <=
threshold`` (value <= threshold) goes left, a child below 0 is the leaf
``~child``.  The benchmark reads the program's trees from it to judge
them, and writes its own generated forest into it."""

from __future__ import annotations

import re
from typing import Dict, List

import numpy as np

_INT_KEYS = ("split_feature", "left_child", "right_child", "leaf_count",
             "internal_count", "leaf_parent", "decision_type")
_FLOAT_KEYS = ("threshold", "leaf_value", "split_gain", "internal_value")


def parse_trees(text: str) -> List[Dict[str, np.ndarray]]:
    """Every ``Tree=`` block of a model text as arrays."""
    end = text.find("\nfeature importances")
    body = text if end < 0 else text[:end]
    blocks = re.split(r"(?m)^Tree=\d+\s*$", body)[1:]
    trees = []
    for blk in blocks:
        kv = {}
        for line in blk.splitlines():
            if "=" in line:
                k, v = line.split("=", 1)
                kv[k.strip()] = v.strip()
        t = {"num_leaves": int(kv["num_leaves"])}
        for k in _INT_KEYS:
            t[k] = np.array(kv.get(k, "").split(), np.int64)
        for k in _FLOAT_KEYS:
            t[k] = np.array(kv.get(k, "").split(), np.float64)
        t["shrinkage"] = float(kv.get("shrinkage", "1"))
        trees.append(t)
    return trees


def _fmt(arr, integer=False) -> str:
    if integer:
        return " ".join(str(int(v)) for v in arr)
    return " ".join(f"{float(v):.17g}" for v in arr)


def write_model(trees: List[Dict[str, np.ndarray]], num_features: int,
                objective: str = "binary sigmoid:1") -> str:
    """A binary model text of ``trees`` (arrays as :func:`parse_trees`
    gives them) over ``num_features`` numerical features."""
    names = " ".join(f"Column_{i}" for i in range(num_features))
    out = ["tree", "version=v2", "num_class=1", "num_tree_per_iteration=1",
           "label_index=0", f"max_feature_idx={num_features - 1}",
           f"objective={objective}", "sigmoid=1",
           f"feature_names={names}",
           "feature_infos=" + " ".join(["none"] * num_features), ""]
    for i, t in enumerate(trees):
        n = t["num_leaves"] - 1
        out += [f"Tree={i}", f"num_leaves={t['num_leaves']}",
                f"split_feature={_fmt(t['split_feature'], True)}",
                f"split_gain={_fmt(np.ones(n))}",
                f"threshold={_fmt(t['threshold'])}",
                f"decision_type={_fmt(np.zeros(n), True)}",
                f"left_child={_fmt(t['left_child'], True)}",
                f"right_child={_fmt(t['right_child'], True)}",
                f"leaf_parent={_fmt(t['leaf_parent'], True)}",
                f"leaf_value={_fmt(t['leaf_value'])}",
                f"leaf_count={_fmt(t['leaf_count'], True)}",
                f"internal_value={_fmt(np.zeros(n))}",
                f"internal_count={_fmt(t['internal_count'], True)}",
                "shrinkage=1", "", ""]
    out += ["", "feature importances:", ""]
    return "\n".join(out)
