"""Host-side decision tree: flat arrays + reference-compatible text.

The port's copy of the JAX package's models/tree.py, cut to what loading,
saving, host prediction, building a tree from a grower's arrays
(``from_arrays``), replaying a tree on a binned dataset
(``ensure_inner``), scaling its outputs (rollback, merge) and the JSON
dump (``to_json``, ``max_depth``) need.  Leaves are encoded as ``~leaf_index``
in the child arrays; decision_type 0 is numerical ``value <= threshold``
and 1 is categorical ``int(value) == int(threshold)``; the ``Tree=``
text block is the reference layout (tree.cpp:295-338).
"""

from __future__ import annotations

import copy
from typing import Dict, Optional

import numpy as np

from ..utils.log import LightGBMError


def _fmt(x: float) -> str:
    """C++ ostream with setprecision(digits10+2) ~ %.17g."""
    return f"{x:.17g}"


def _fmt_arr(arr) -> str:
    return " ".join(_fmt(float(v)) for v in arr)


def _fmt_int_arr(arr) -> str:
    return " ".join(str(int(v)) for v in arr)


class Tree:
    """A trained decision tree (host representation)."""

    # piece-wise linear leaves: leaf l predicts
    #   leaf_value[l] + sum_k leaf_coeff[l, k] * x[leaf_feat[l, k]]
    # (leaf_feat holds real feature indices, -1 = unused slot)
    leaf_coeff: Optional[np.ndarray] = None   # [num_leaves, K] float64
    leaf_feat: Optional[np.ndarray] = None    # [num_leaves, K] int32

    def __init__(self, num_leaves: int):
        self.num_leaves = num_leaves
        n = max(num_leaves - 1, 0)
        # the bin-space form of the splits (inner feature index, bin
        # threshold) against the mappers in ``_inner_mappers``: a grown
        # tree's own, or those ``ensure_inner`` rebuilt it for
        self.split_feature_inner = np.zeros(n, dtype=np.int32)
        self.threshold_in_bin = np.zeros(n, dtype=np.int32)
        self._inner_mappers = None
        self.split_feature = np.zeros(n, dtype=np.int32)
        self.split_gain = np.zeros(n, dtype=np.float64)
        self.threshold = np.zeros(n, dtype=np.float64)
        self.decision_type = np.zeros(n, dtype=np.int8)
        self.left_child = np.zeros(n, dtype=np.int32)
        self.right_child = np.zeros(n, dtype=np.int32)
        self.leaf_parent = np.zeros(num_leaves, dtype=np.int32)
        self.leaf_value = np.zeros(num_leaves, dtype=np.float64)
        self.leaf_count = np.zeros(num_leaves, dtype=np.int32)
        self.internal_value = np.zeros(n, dtype=np.float64)
        self.internal_count = np.zeros(n, dtype=np.int32)
        self.shrinkage = 1.0

    @classmethod
    def from_arrays(cls, tree_arrays, mappers, used_feature_map,
                    learning_rate: float) -> "Tree":
        """Build from a grower's ``TreeArrays`` (ops/grow.py).  Split
        features map back to real feature indices and bin thresholds to
        values through the training mappers (``bin_to_value``); leaf
        values arrive already shrunk and ``shrinkage`` records the rate
        (Tree::Shrinkage)."""
        ta = type(tree_arrays)(*(np.asarray(a) for a in tree_arrays))
        num_leaves = int(ta.num_leaves)
        t = cls(num_leaves)
        n = num_leaves - 1
        sf, sb = ta.split_feature[:n], ta.split_bin[:n]
        t.split_feature_inner = sf.astype(np.int32)
        t.threshold_in_bin = sb.astype(np.int32)
        t._inner_mappers = mappers
        t.split_feature = np.asarray(
            [used_feature_map[f] for f in sf], dtype=np.int32)
        t.split_gain = ta.split_gain[:n].astype(np.float64)
        t.threshold = np.asarray(
            [mappers[f].bin_to_value(b) for f, b in zip(sf, sb)],
            dtype=np.float64)
        t.decision_type = np.asarray(
            [1 if mappers[f].bin_type == 1 else 0 for f in sf], dtype=np.int8)
        t.left_child = ta.left_child[:n].astype(np.int32)
        t.right_child = ta.right_child[:n].astype(np.int32)
        t.leaf_parent = ta.leaf_parent[:num_leaves].astype(np.int32)
        t.leaf_value = ta.leaf_value[:num_leaves].astype(np.float64)
        t.leaf_count = ta.leaf_count[:num_leaves].astype(np.int32)
        t.internal_value = ta.internal_value[:n].astype(np.float64)
        t.internal_count = ta.internal_count[:n].astype(np.int32)
        t.shrinkage = learning_rate
        return t

    def ensure_inner(self, real_to_inner, mappers) -> bool:
        """Make ``split_feature_inner`` / ``threshold_in_bin`` valid for a
        dataset with these ``mappers``: each real threshold's bin by
        ``value_to_bin`` (the reference's threshold_in_bin_ of a loaded
        model).  False when a split feature is trivial in that dataset
        (no bins to walk).  A grown tree keeps its own bins on its own
        mappers; on other mappers (a dataset binned again) it is rebuilt
        like a loaded one."""
        if self._inner_mappers is mappers:
            return True
        n = self.num_leaves - 1
        if n <= 0:
            self._inner_mappers = mappers
            return True
        inner = np.asarray([int(real_to_inner[f])
                            for f in self.split_feature], np.int32)
        if (inner < 0).any():
            return False
        self.threshold_in_bin = np.asarray(
            [int(mappers[inner[i]].value_to_bin(
                np.asarray([self.threshold[i]]))[0]) for i in range(n)],
            np.int32)
        self.split_feature_inner = inner
        self._inner_mappers = mappers
        return True

    def scale_leaf_outputs(self, factor: float) -> "Tree":
        """Scale every leaf output by ``factor`` in place (Tree::Shrinkage):
        the constant values and the affine coefficients together, the
        internal values and the recorded ``shrinkage``.  Returns self."""
        f = float(factor)
        if f == 1.0:
            return self
        self.leaf_value = np.asarray(self.leaf_value, np.float64) * f
        if self.leaf_coeff is not None:
            self.leaf_coeff = np.asarray(self.leaf_coeff, np.float64) * f
        self.internal_value = np.asarray(self.internal_value,
                                         np.float64) * f
        self.shrinkage = float(self.shrinkage) * f
        return self

    def scaled_copy(self, factor: float) -> "Tree":
        """A copy with every leaf output scaled by ``factor`` (merge
        decay, the negated tree of a rollback); the tree itself is not
        touched."""
        out = copy.copy(self)
        for key, value in vars(self).items():
            if isinstance(value, np.ndarray):
                setattr(out, key, value.copy())
        return out.scale_leaf_outputs(factor)

    def has_linear(self) -> bool:
        """True when some leaf carries a non-zero affine coefficient."""
        return (self.leaf_coeff is not None and self.leaf_coeff.size > 0
                and bool(np.any(self.leaf_coeff != 0.0)))

    def _affine_part(self, X: np.ndarray, leaf_idx: np.ndarray) -> np.ndarray:
        lf = self.leaf_feat[leaf_idx]
        vals = X[np.arange(X.shape[0])[:, None], np.maximum(lf, 0)]
        vals = np.where((lf >= 0) & ~np.isnan(vals), vals, 0.0)
        return (self.leaf_coeff[leaf_idx] * vals).sum(axis=1)

    def _walk(self, X: np.ndarray) -> np.ndarray:
        """Leaf index per row: the vectorized node walk (tree.h:197-227)
        in f64, bounded by num_leaves steps."""
        n = X.shape[0]
        if self.num_leaves <= 1:
            return np.zeros(n, dtype=np.int64)
        node = np.zeros(n, dtype=np.int32)
        for _ in range(self.num_leaves):
            live = node >= 0
            if not live.any():
                break
            idx = node[live]
            fv = X[live, self.split_feature[idx]]
            th = self.threshold[idx]
            is_cat = self.decision_type[idx] == 1
            go_left = np.where(is_cat,
                               fv.astype(np.int64) == th.astype(np.int64),
                               fv <= th)
            node[live] = np.where(go_left, self.left_child[idx],
                                  self.right_child[idx])
        return np.where(node < 0, ~node, 0).astype(np.int64)

    def predict(self, X: np.ndarray) -> np.ndarray:
        """Raw-value f64 prediction on ``X`` [n, F]."""
        if self.num_leaves <= 1:
            return np.full(X.shape[0],
                           self.leaf_value[0] if self.num_leaves else 0.0)
        leaf = self._walk(X)
        out = self.leaf_value[leaf].astype(np.float64)
        if self.leaf_coeff is not None and self.leaf_coeff.size > 0:
            out = out + self._affine_part(X, leaf)
        return out

    def predict_leaf_index(self, X: np.ndarray) -> np.ndarray:
        return self._walk(X).astype(np.int32)

    def max_depth(self) -> int:
        """Levels of the deepest leaf (0 for a one-leaf tree)."""
        if self.num_leaves <= 1:
            return 0
        depth = np.zeros(self.num_leaves - 1, dtype=np.int32)
        best = 1
        for node in range(self.num_leaves - 1):
            for child in (self.left_child[node], self.right_child[node]):
                if child >= 0:
                    depth[child] = depth[node] + 1
                    best = max(best, depth[child] + 1)
                else:
                    best = max(best, depth[node] + 1)
        return best

    def to_json(self) -> dict:
        """Tree::ToJSON structure (tree.cpp:326-366); a linear leaf also
        lists its ``leaf_features`` and ``leaf_coeff`` (unused slots
        left out)."""
        def node_json(index: int):
            if index >= 0:
                return {
                    "split_index": int(index),
                    "split_feature": int(self.split_feature[index]),
                    "split_gain": float(self.split_gain[index]),
                    "threshold": float(self.threshold[index]),
                    "decision_type": ("no_greater"
                                      if self.decision_type[index] == 0
                                      else "is"),
                    "internal_value": float(self.internal_value[index]),
                    "internal_count": int(self.internal_count[index]),
                    "left_child": node_json(int(self.left_child[index])),
                    "right_child": node_json(int(self.right_child[index])),
                }
            leaf = ~index
            out = {
                "leaf_index": int(leaf),
                "leaf_parent": int(self.leaf_parent[leaf]),
                "leaf_value": float(self.leaf_value[leaf]),
                "leaf_count": int(self.leaf_count[leaf]),
            }
            if self.has_linear():
                keep = self.leaf_feat[leaf] >= 0
                out["leaf_features"] = [
                    int(f) for f in self.leaf_feat[leaf][keep]]
                out["leaf_coeff"] = [
                    float(c) for c in self.leaf_coeff[leaf][keep]]
            return out
        if self.num_leaves > 1:
            structure = node_json(0)
        else:
            structure = {"leaf_value": float(self.leaf_value[0])
                         if self.num_leaves else 0.0}
        return {"num_leaves": int(self.num_leaves),
                "shrinkage": float(self.shrinkage),
                "tree_structure": structure}

    # ------------------------------------------------------------------
    def to_string(self) -> str:
        """Tree::ToString (tree.cpp:295-324) layout."""
        n = self.num_leaves - 1
        lines = [
            f"num_leaves={self.num_leaves}",
            f"split_feature={_fmt_int_arr(self.split_feature[:n])}",
            f"split_gain={_fmt_arr(self.split_gain[:n])}",
            f"threshold={_fmt_arr(self.threshold[:n])}",
            f"decision_type={_fmt_int_arr(self.decision_type[:n])}",
            f"left_child={_fmt_int_arr(self.left_child[:n])}",
            f"right_child={_fmt_int_arr(self.right_child[:n])}",
            f"leaf_parent={_fmt_int_arr(self.leaf_parent[:self.num_leaves])}",
            f"leaf_value={_fmt_arr(self.leaf_value[:self.num_leaves])}",
            f"leaf_count={_fmt_int_arr(self.leaf_count[:self.num_leaves])}",
            f"internal_value={_fmt_arr(self.internal_value[:n])}",
            f"internal_count={_fmt_int_arr(self.internal_count[:n])}",
            f"shrinkage={_fmt(self.shrinkage)}",
        ]
        if self.has_linear():
            nl, k = self.leaf_coeff.shape
            lines += [
                f"num_linear_features={k}",
                f"leaf_feat={_fmt_int_arr(self.leaf_feat.ravel())}",
                f"leaf_coeff={_fmt_arr(self.leaf_coeff.ravel())}",
            ]
        lines.append("")
        return "\n".join(lines) + "\n"

    @classmethod
    def from_string(cls, text: str) -> "Tree":
        """Tree(str) parser (tree.cpp:368-430).  A missing section, a
        short array, an unparseable number or an out-of-range child or
        feature index raises :class:`LightGBMError` naming the section."""
        kv: Dict[str, str] = {}
        for line in text.splitlines():
            if "=" in line:
                k, v = line.split("=", 1)
                k, v = k.strip(), v.strip()
                if k and v:
                    kv[k] = v
        required = ("num_leaves", "split_feature", "split_gain", "threshold",
                    "left_child", "right_child", "leaf_parent", "leaf_value",
                    "internal_value", "internal_count", "leaf_count",
                    "shrinkage", "decision_type")
        missing = [k for k in required if k not in kv]
        if missing and kv.get("num_leaves") != "1":
            raise LightGBMError(
                f"Tree model string format error: missing section(s) "
                f"{missing} — truncated or corrupt model file?")
        try:
            num_leaves = int(kv["num_leaves"])
        except ValueError:
            raise LightGBMError(
                f"Tree model string format error: num_leaves="
                f"{kv['num_leaves']!r} is not an integer")
        if num_leaves < 1:
            raise LightGBMError(
                f"Tree model string format error: num_leaves="
                f"{num_leaves} must be >= 1")
        if num_leaves > (1 << 20):
            raise LightGBMError(
                f"Tree model string format error: num_leaves="
                f"{num_leaves} is absurd (corrupt header digit?) — "
                f"refusing the allocation")
        t = cls(num_leaves)

        def _values(key, count, conv, dtype):
            if count <= 0 or key not in kv:
                return np.zeros(max(count, 0), dtype=dtype)
            toks = kv[key].split()
            if len(toks) < count:
                raise LightGBMError(
                    f"Tree model string format error: section {key} has "
                    f"{len(toks)} value(s), expected {count} — file "
                    f"truncated mid-row?")
            try:
                return np.asarray([conv(x) for x in toks[:count]],
                                  dtype=dtype)
            except (ValueError, OverflowError) as exc:
                raise LightGBMError(
                    f"Tree model string format error: section {key}: "
                    f"{exc}")

        def ints(key, count):
            return _values(key, count, lambda x: int(float(x)), np.int32)

        def floats(key, count):
            return _values(key, count, float, np.float64)

        n = num_leaves - 1
        t.split_feature = ints("split_feature", n)
        t.split_gain = floats("split_gain", n)
        t.threshold = floats("threshold", n)
        t.decision_type = ints("decision_type", n).astype(np.int8)
        t.left_child = ints("left_child", n)
        t.right_child = ints("right_child", n)
        t.leaf_parent = ints("leaf_parent", num_leaves)
        t.leaf_value = floats("leaf_value", num_leaves)
        t.leaf_count = ints("leaf_count", num_leaves)
        t.internal_value = floats("internal_value", n)
        t.internal_count = ints("internal_count", n)
        try:
            t.shrinkage = float(kv["shrinkage"])
        except ValueError:
            raise LightGBMError(
                f"Tree model string format error: shrinkage="
                f"{kv['shrinkage']!r} is not a number")
        for key, arr in (("left_child", t.left_child),
                         ("right_child", t.right_child)):
            if arr.size and ((arr >= n).any() or (arr < -num_leaves).any()):
                raise LightGBMError(
                    f"Tree model string format error: section {key} "
                    f"holds an out-of-range node index (num_leaves="
                    f"{num_leaves}) — corrupt model file?")
        if t.split_feature.size and (t.split_feature < 0).any():
            raise LightGBMError(
                "Tree model string format error: negative "
                "split_feature index — corrupt model file?")
        if "num_linear_features" in kv or "leaf_coeff" in kv \
                or "leaf_feat" in kv:
            t._parse_linear(kv, num_leaves, _values)
        return t

    def _parse_linear(self, kv, num_leaves: int, _values) -> None:
        """Optional affine-leaf sections (absent => constant leaves)."""
        try:
            k = int(kv.get("num_linear_features", ""))
        except ValueError:
            raise LightGBMError(
                "Tree model string format error: num_linear_features="
                f"{kv.get('num_linear_features')!r} is not an integer "
                "(linear sections present but header missing/corrupt?)")
        if k < 0 or k > (1 << 16):
            raise LightGBMError(
                "Tree model string format error: "
                f"num_linear_features={k} is out of range")
        if k == 0:
            return
        for key in ("leaf_feat", "leaf_coeff"):
            if key not in kv:
                raise LightGBMError(
                    "Tree model string format error: "
                    f"num_linear_features={k} but section {key} "
                    "is missing — file truncated mid-tree?")
        feat = _values("leaf_feat", num_leaves * k,
                       lambda x: int(float(x)), np.int32)
        coeff = _values("leaf_coeff", num_leaves * k, float, np.float64)
        if (feat < -1).any():
            raise LightGBMError(
                "Tree model string format error: section "
                "leaf_feat holds an index below -1 — corrupt "
                "model file?")
        self.leaf_feat = feat.reshape(num_leaves, k)
        self.leaf_coeff = coeff.reshape(num_leaves, k)
