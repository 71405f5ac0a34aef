"""Bytes and operations of one boosting round of a leaf-wise tree over
``num_data`` rows of ``features`` binned columns: what the inputs need.

* the objective's gradient pass (``cost/<objective>.py``);
* the histogram passes (``cost/k1.py``): the root and the smaller child
  of every split;
* each split's best-threshold scan: 12 operations a (feature, bin) of
  both children, the histograms read once;
* the partition of each split leaf's rows: its row indices and the
  split feature's codes read once, the indices written once;
* the score update: each row's leaf index and score read, the score
  written.
"""

from __future__ import annotations

import importlib

from . import k1


def round_cost(tree: dict, num_data: int, features: int, bin_bytes: int,
               max_bin: int, objective: str, objective_work: dict):
    obj = importlib.import_module(f"{__package__}.{objective}")
    nbytes, ops = obj.gradients(num_data, **objective_work)
    for rows in k1.tree_windows(tree, num_data):
        b, o = k1.launch(rows, features, bin_bytes, max_bin)
        nbytes += b
        ops += o
    L = int(tree["num_leaves"])
    scan = features * max_bin
    nbytes += (L - 1) * 2 * scan * 3 * 4
    ops += (L - 1) * 2 * scan * 12
    for i in range(L - 1):
        nbytes += int(tree["internal_count"][i]) * (4 + bin_bytes + 4)
    nbytes += num_data * (4 + 4 + 4)
    ops += num_data
    return nbytes, ops
