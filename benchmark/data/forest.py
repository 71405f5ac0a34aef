"""A random forest of a configuration's shape, made on the device from the
seed: every tree grows leaf-wise over a sample of the data's rows, each
step splitting a leaf drawn in proportion to the sample rows it holds, on
a random feature, at the midpoint of two neighbouring sample values
between the leaf's 20th and 80th percentiles.  Leaf values are
N(0, std) rounded to float32.  All trees grow at once, one step at a
time."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .higgs_like import generator


def make(sample: torch.Tensor, trees: int, num_leaves: int, leaf_std: float,
         seed: int) -> List[Dict[str, np.ndarray]]:
    """``trees`` trees of ``num_leaves`` leaves over ``sample`` [S, F]
    (f64, on the device), as model-text arrays."""
    dev = sample.device
    g = generator(seed, 4, dev)
    S, F = sample.shape
    T, L = trees, num_leaves
    xt = sample.t().contiguous()                                # [F, S]
    tix = torch.arange(T, device=dev)
    assign = torch.zeros(T, S, dtype=torch.int64, device=dev)
    count = torch.zeros(T, L, dtype=torch.int64, device=dev)
    count[:, 0] = S
    feat = torch.zeros(T, L - 1, dtype=torch.int64, device=dev)
    thr = torch.zeros(T, L - 1, dtype=torch.float64, device=dev)
    lc = torch.zeros(T, L - 1, dtype=torch.int64, device=dev)
    rc = torch.zeros(T, L - 1, dtype=torch.int64, device=dev)
    icount = torch.zeros(T, L - 1, dtype=torch.int64, device=dev)
    parent = torch.full((T, L), -1, dtype=torch.int64, device=dev)
    for step in range(L - 1):
        w = (count * (count >= 2)).double()
        leaf = torch.multinomial(w, 1, generator=g)[:, 0]       # [T]
        f = torch.randint(0, F, (T,), generator=g, device=dev)
        vals = xt[f]                                            # [T, S]
        inside = assign == leaf[:, None]
        srt = torch.sort(torch.where(inside, vals,
                                     torch.full_like(vals, torch.inf)), 1)[0]
        k = count[tix, leaf]
        q = torch.rand(T, generator=g, device=dev, dtype=torch.float64)
        lo = torch.floor((0.2 + 0.6 * q) * (k - 1).double()).long()
        lo = torch.minimum(lo, k - 2)
        a, b = srt[tix, lo], srt[tix, lo + 1]
        # equal neighbours: move to the first larger value inside the leaf
        nxt = torch.where(srt > a[:, None], srt, torch.full_like(srt, torch.inf))
        b = torch.where(b > a, b, nxt.amin(1))
        t = torch.where(torch.isfinite(b), (a + b) / 2.0, a)
        right = inside & (vals > t[:, None])
        new = step + 1
        assign = torch.where(right, torch.full_like(assign, new), assign)
        nr = right.sum(1)
        count[tix, new] = nr
        count[tix, leaf] = k - nr
        pn = parent[tix, leaf]
        has = pn >= 0
        pn0 = pn.clamp(min=0)
        was_left = lc[tix, pn0] == ~leaf
        lc[tix, pn0] = torch.where(has & was_left, step, lc[tix, pn0])
        rc[tix, pn0] = torch.where(has & ~was_left, step, rc[tix, pn0])
        feat[:, step], thr[:, step] = f, t
        lc[:, step], rc[:, step] = ~leaf, torch.full_like(leaf, ~new)
        icount[:, step] = k
        parent[tix, leaf] = step
        parent[:, new] = step
    val = (torch.randn(T, L, generator=g, device=dev) * leaf_std).float().double()
    out = []
    cpu = [x.cpu().numpy() for x in (feat, thr, lc, rc, val, count, icount,
                                     parent)]
    for i in range(T):
        out.append({"num_leaves": L, "split_feature": cpu[0][i],
                    "threshold": cpu[1][i], "left_child": cpu[2][i],
                    "right_child": cpu[3][i], "leaf_value": cpu[4][i],
                    "leaf_count": cpu[5][i], "internal_count": cpu[6][i],
                    "leaf_parent": cpu[7][i]})
    return out
