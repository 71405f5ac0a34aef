"""Plain reference of LightGBM's prediction over raw rows (tree.h
GetLeaf / NumericalDecision, gbdt.cpp Predict): every tree walked from
its root, ``value <= threshold`` goes left, the leaf values summed in
f64 and the binary objective's sigmoid applied."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

#: (trees x rows) elements walked at once
BLOCK_ELEMS = 1 << 24


def stack(trees: List[Dict], device) -> Dict[str, torch.Tensor]:
    """The trees as [T, M] node and [T, L] leaf tables."""
    T = len(trees)
    M = max(max(t["num_leaves"] - 1, 1) for t in trees)
    L = max(t["num_leaves"] for t in trees)
    feat = np.zeros((T, M), np.int64)
    thr = np.zeros((T, M), np.float64)
    lc = np.full((T, M), -1, np.int64)
    rc = np.full((T, M), -1, np.int64)
    val = np.zeros((T, L), np.float64)
    root = np.zeros(T, np.int64)
    for i, t in enumerate(trees):
        n = t["num_leaves"] - 1
        feat[i, :n] = t["split_feature"][:n]
        thr[i, :n] = t["threshold"][:n]
        lc[i, :n] = t["left_child"][:n]
        rc[i, :n] = t["right_child"][:n]
        val[i, :t["num_leaves"]] = t["leaf_value"][:t["num_leaves"]]
        root[i] = 0 if n > 0 else -1
    to = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return {"feat": to(feat), "thr": to(thr), "lc": to(lc), "rc": to(rc),
            "val": to(val), "root": to(root)}


def raw_scores(X: torch.Tensor, forest: Dict[str, torch.Tensor],
               value_dtype=torch.float64) -> Tuple[torch.Tensor, int]:
    """([n] summed leaf values, node visits) of the rows ``X`` [n, F]
    (f64).  Leaf values are read in ``value_dtype`` and summed in f64,
    or in f32 when ``value_dtype`` is narrower than f32."""
    T = forest["feat"].shape[0]
    n = X.shape[0]
    acc = torch.float64 if value_dtype == torch.float64 else torch.float32
    out = torch.zeros(n, dtype=acc, device=X.device)
    vals = forest["val"].to(value_dtype).to(acc)
    step = max(1, BLOCK_ELEMS // max(T, 1))
    visits = 0
    for r0 in range(0, n, step):
        xt = X[r0:r0 + step].t().contiguous()                   # [F, b]
        b = xt.shape[1]
        node = forest["root"][:, None].expand(T, b).clone()
        tix = torch.arange(T, device=X.device)[:, None]
        while True:
            inner = node >= 0
            cnt = int(inner.sum())
            if cnt == 0:
                break
            visits += cnt
            nd = node.clamp(min=0)
            f = forest["feat"][tix, nd]
            v = xt.gather(0, f)
            go_left = v <= forest["thr"][tix, nd]
            nxt = torch.where(go_left, forest["lc"][tix, nd],
                              forest["rc"][tix, nd])
            node = torch.where(inner, nxt, node)
        leaf = ~node
        out[r0:r0 + b] = vals.gather(1, leaf).sum(0)
    return out, visits


def sigmoid(raw: torch.Tensor) -> torch.Tensor:
    return 1.0 / (1.0 + torch.exp(-raw))
