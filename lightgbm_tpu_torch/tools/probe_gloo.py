"""Which gloo collectives take tensors on a CUDA card.

    python -m lightgbm_tpu_torch.tools.probe_gloo [--world 2] [--timeout 120]

Starts ``--world`` processes on card 0, joined by a gloo group over
``tcp://127.0.0.1``, and calls each collective the distributed learners
use (``parallel/comm.py``) once on CUDA tensors: ``all_reduce``,
``reduce_scatter_tensor``, ``all_gather_into_tensor`` and
``broadcast``.  Each call is checked against the same call on host
tensors.  Prints one JSON line: ``{"torch": ..., "cuda": {name: true |
"<error>"}}``; ``comm.GLOO_CUDA_COLLECTIVES`` is the set this probe
finds true, and ``chip_smoke.py`` fails when the two disagree.

This is a probe, not a path: the learners never try a collective and
fall back.  They call every collective on CUDA tensors as they are, so
a PyTorch whose gloo refuses one fails this check first.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys

#: the collectives the learners call, in probe order
COLLECTIVES = ("all_reduce", "reduce_scatter_tensor",
               "all_gather_into_tensor", "broadcast")


def _call(name: str, dev, rank: int, world: int):
    import torch
    import torch.distributed as dist
    x = (torch.arange(4 * world, dtype=torch.float32) + rank).to(dev)
    if name == "all_reduce":
        dist.all_reduce(x)
        return x
    if name == "reduce_scatter_tensor":
        out = torch.empty(4, dtype=torch.float32, device=dev)
        dist.reduce_scatter_tensor(out, x)
        return out
    if name == "all_gather_into_tensor":
        out = torch.empty(4 * world * world, dtype=torch.float32, device=dev)
        dist.all_gather_into_tensor(out, x)
        return out
    dist.broadcast(x, src=0)
    return x


def _rank_main(rank: int, world: int, port: int) -> None:
    import warnings
    import torch
    import torch.distributed as dist
    warnings.simplefilter("ignore", FutureWarning)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    out = {}
    for name in COLLECTIVES:
        want = _call(name, torch.device("cpu"), rank, world)
        try:
            got = _call(name, torch.device("cuda", 0), rank, world)
            torch.cuda.synchronize()
            out[name] = bool(torch.equal(got.cpu(), want)) or "wrong values"
        except Exception as exc:  # noqa: BLE001 - the probe records it
            out[name] = f"{type(exc).__name__}: {str(exc)[:200]}"
        # a failed call on one rank must not leave the other waiting
        dist.barrier()
    if rank == 0:
        print(json.dumps({"torch": torch.__version__, "cuda": out}),
              flush=True)
    dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=120.0)
    ap.add_argument("--rank", type=int, default=-1)
    ap.add_argument("--port", type=int, default=0)
    args = ap.parse_args(argv)
    if args.rank >= 0:
        _rank_main(args.rank, args.world, args.port)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("probe_gloo: no CUDA card", file=sys.stderr)
        return 1
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "lightgbm_tpu_torch.tools.probe_gloo",
         "--rank", str(r), "--world", str(args.world), "--port", str(port)],
        start_new_session=True) for r in range(args.world)]
    rc = 0
    try:
        for p in procs:
            rc |= p.wait(timeout=args.timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, 9)
                rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
