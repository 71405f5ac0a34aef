"""Bytes and operations of one forest walk (K4, ``walk_trees_kernel`` and
its fold) over ``rows`` binned rows: each row's bin codes read once,
the forest's tables (per node: feature, bin, two children, 16 bytes; per
leaf a float32 value) read once, one float32 score written a row.
Operations: one comparison a node visited on the rows' paths, one
addition a tree a row for the sum."""

from __future__ import annotations


def launch(rows: int, features: int, bin_bytes: int, trees: int,
           nodes: int, leaves: int, visits: float):
    nbytes = rows * features * bin_bytes + nodes * 16 + leaves * 4 + rows * 4
    ops = visits + rows * trees
    return nbytes, ops
