"""What does the roll/compare/select stage chain of a bitonic-style stable
partition cost on the card?  The port of the JAX package's TPU probe
``tools/probe_roll.py`` (P1): 28 stages x (roll + compare + 12 selects)
over one ``[12, 2048]`` int32 block, chained 50 times as
``roll_chain(acc) ^ 1``.

    python -m lightgbm_tpu_torch.tools.probe_roll [--device cpu] [--reps 20]

Prints the build + first chain seconds, the time a call in the chain
(the kernel and the ``^ 1``) and of the kernel alone (the mean of
``--reps`` launches back to back), then one JSON line.  A failure
raises.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..ops.roll_chain import NB, STAGES, WORDS, roll_chain
from . import clock_name, elapsed_ms, first_run_s

CHAIN = 50


def make_input() -> np.ndarray:
    """The JAX probe's seeded input: [WORDS, NB] int32 over the full
    signed range."""
    rng = np.random.RandomState(0)
    return rng.randint(-2**31, 2**31 - 1, (WORDS, NB),
                       np.int64).astype(np.int32)


def chain(x: torch.Tensor, calls: int = CHAIN) -> torch.Tensor:
    """The JAX probe's loop body ``call(acc) ^ 1``, ``calls`` times."""
    acc = x
    for _ in range(calls):
        acc = roll_chain(acc) ^ 1
    return acc


def run(device=None, reps: int = 20) -> dict:
    dev = resolve_device(device)
    x = torch.from_numpy(make_input()).to(dev)
    out, build_s = first_run_s(lambda: chain(x), dev)
    out, chain_ms = elapsed_ms(lambda: chain(out), dev)
    # back to back: the card waits for the host only where a launch is
    # shorter than the host's time to enqueue the next one
    kernel_ms = elapsed_ms(lambda: [roll_chain(out) for _ in range(reps)],
                           dev)[1] / reps
    per_call = chain_ms / CHAIN
    return {"probe": "roll_chain", "device": str(dev),
            "clock": clock_name(dev), "stages": STAGES, "words": WORDS,
            "nb": NB, "chain": CHAIN, "build_run_s": build_s,
            "us_per_call": per_call * 1e3,
            "ns_per_row": per_call * 1e6 / NB,
            "kernel_us": kernel_ms * 1e3, "reps": reps,
            "checksum": int(out.to(torch.int64).sum())}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain version)")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    res = run(args.device, args.reps)
    print(f"build+run {res['build_run_s']:.1f}s")
    print(f"roll-chain kernel: {res['us_per_call']:8.1f} us/block  "
          f"{res['ns_per_row']:6.2f} ns/row "
          f"({STAGES} stages x {WORDS} words); kernel alone "
          f"{res['kernel_us']:.1f} us")
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
