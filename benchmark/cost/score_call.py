"""Bytes and operations of one scoring call of ``rows`` raw rows: the
host's binning output (one code a feature a row) read by the walk
(``cost/k4.py``), then the transform: each raw score read (float32) and
each probability written (float64), about four operations a row."""

from __future__ import annotations

from . import k4


def call_cost(rows: int, features: int, bin_bytes: int, trees: int,
              nodes: int, leaves: int, visits: float):
    nbytes, ops = k4.launch(rows, features, bin_bytes, trees, nodes, leaves,
                            visits)
    return nbytes + rows * 12, ops + rows * 4
