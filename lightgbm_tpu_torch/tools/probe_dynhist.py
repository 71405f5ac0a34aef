"""What does K1's digit histogram cost on the card over a window that is
known only on the device?  The port of the JAX package's TPU probe
``tools/probe_dynhist.py`` (P2): 2^20 rows of 28 uint8 bins packed into 7
int32 words and 9 int8 digits (3 packed words, or an ``[N, 9]`` matrix),
a window of N/2 rows, and ten chained calls, the offset of each computed
on the card from the last output (``out[0, 0, 0] % 128``, the first 5).

    python -m lightgbm_tpu_torch.tools.probe_dynhist [--device cpu] [--rows N]

Runs the JAX probe's five (layout, nb) pairs and prints per run the
build + first loop seconds, ms a call and ns a row, then one JSON line.
On the TPU ``nb`` is the rows of a VMEM tile, which sets the grid.  On
the card it sets nothing: the grid is ``window_hist.plan_window``'s,
planned from the card and N (each run's ``plan``), and the words or
matrix kernel runs the same for every ``nb``.  ``subconcat_T`` differs
from ``laneconcat`` only in a TPU tile's orientation.  So each run whose
kernel and plan an earlier run already timed says which
(``"same_as": "laneconcat nb=2048"``).  A failure raises.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..ops.ordered_grow import pack_u8_words
from ..ops.window_hist import card_plan, window_digit_histogram
from . import clock_name, elapsed_ms, first_run_s

N = 1 << 20
F, B = 28, 256
CALLS = 10
FIRST_OFF = 5
#: the JAX probe's runs: (layout, the TPU's nb, digits as a matrix)
RUNS = (("laneconcat", 2048, False), ("laneconcat", 4096, False),
        ("subconcat_T", 8192, False), ("digmat", 8192, True),
        ("digmat", 4096, True))
NB_ON_CARD = "sets nothing on the card: the grid is plan_window's"


def make_inputs(rows: int = N):
    """The JAX probe's seeded inputs: bins [rows, F] uint8 in 0..B-2 and
    digits [rows, 9] int8 in -128..126."""
    rng = np.random.RandomState(0)
    bins = rng.randint(0, B - 1, size=(rows, F)).astype(np.uint8)
    digits = rng.randint(-128, 127, size=(rows, 9)).astype(np.int8)
    return bins, digits


def device_inputs(bins: np.ndarray, digits: np.ndarray, dev):
    """(bin words [7, rows] int32, digit words [3, rows] int32, digit
    matrix [rows, 9] int8) on ``dev``: each kind of word stacked as the
    rows of one buffer, as ``window_digit_histogram`` takes them."""
    b = torch.from_numpy(bins).to(dev)
    d = torch.from_numpy(digits).to(dev)
    return pack_u8_words(b), pack_u8_words(d.view(torch.uint8)), d


def loop(bin_words, digits, window: torch.Tensor, count: torch.Tensor,
         calls: int = CALLS):
    """The JAX probe's loop: ``calls`` calls, each window's offset
    ``out[0, 0, 0] % 128`` of the call before, on the device; returns the
    last window and the sum of ``out[0, 0, 1]``.  Reads nothing on the
    host."""
    acc = torch.zeros((), dtype=torch.int32, device=window.device)
    for _ in range(calls):
        o = window_digit_histogram(bin_words, digits, window, F, B)
        window = torch.stack([torch.remainder(o[0, 0, 0], 128), count])
        acc = acc + o[0, 0, 1]
    return window, acc


def run(device=None, rows: int = N) -> dict:
    dev = resolve_device(device)
    bw, dw, dmat = device_inputs(*make_inputs(rows), dev)
    count = torch.tensor(rows // 2, dtype=torch.int32, device=dev)
    out = []
    first = {}
    for name, nb, matrix in RUNS:
        digits = dmat if matrix else dw
        start = torch.tensor([FIRST_OFF, rows // 2], dtype=torch.int32,
                             device=dev)
        (win, _), build_s = first_run_s(
            lambda: loop(bw, digits, start, count), dev)
        (win, acc), ms = elapsed_ms(
            lambda: loop(bw, digits, win, count), dev)
        per_call = ms / CALLS
        entry = {"name": name, "nb": nb,
                 "digits": "matrix" if matrix else "words",
                 "build_run_s": build_s, "ms_per_call": per_call,
                 "ns_per_row": per_call * 1e6 / (rows // 2),
                 "last_off": int(win[0]), "acc": int(acc),
                 "plan": card_plan(bw, digits, F, B)._asdict()
                 if dev.type == "cuda" else None}
        if matrix in first:
            entry["same_as"] = first[matrix]
        else:
            first[matrix] = f"{name} nb={nb}"
        out.append(entry)
    return {"probe": "window_digit_histogram", "device": str(dev),
            "clock": clock_name(dev), "rows": rows, "features": F,
            "max_bin": B, "window": rows // 2, "calls": CALLS,
            "nb": NB_ON_CARD, "runs": out}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain version)")
    ap.add_argument("--rows", type=int, default=N)
    args = ap.parse_args(argv)
    res = run(args.device, args.rows)
    for r in res["runs"]:
        print(f"{r['name']:14s} nb={r['nb']:5d}: build+run "
              f"{r['build_run_s']:5.1f}s  {r['ms_per_call']:7.3f} ms/call  "
              f"{r['ns_per_row']:6.3f} ns/row")
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
