"""Local ranks: a machine list of free localhost ports and a launcher
that runs one process a rank and leaves none behind.

    from lightgbm_tpu_torch.parallel.launch import machine_list, run_ranks
    mlist = machine_list("mlist.txt", 2)
    run_ranks([[sys.executable, "-m", "lightgbm_tpu_torch",
                "config=train.conf", "num_machines=2",
                f"machine_list_file={mlist}"]] * 2, timeout=300)

Each rank runs in a session of its own with ``LIGHTGBM_TPU_PROCESS_ID``
set to its index (``parallel/multihost.py`` reads it: every entry of the
list names this host).  A rank that fails or outlives ``timeout`` ends
the run: every rank's process group is killed, on any exit.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def machine_list(path: str, world: int) -> str:
    """Write ``world`` lines ``127.0.0.1 <free port>``; returns ``path``."""
    with open(path, "w") as fh:
        for _ in range(world):
            fh.write(f"127.0.0.1 {free_port()}\n")
    return path


def run_ranks(argvs: Sequence[Sequence[str]], timeout: float,
              env: Optional[Dict[str, str]] = None,
              cwd: Optional[str] = None) -> Tuple[List[int], List[str]]:
    """Run rank ``i`` as ``argvs[i]``; returns (exit codes, outputs).

    A rank still running at ``timeout`` seconds gets exit code ``-9``,
    and so do the others once one rank exits non-zero.  Every rank's
    process group is killed before this returns."""
    procs, files = [], []
    codes: List[Optional[int]] = []
    try:
        for i, argv in enumerate(argvs):
            e = dict(os.environ if env is None else env)
            e["LIGHTGBM_TPU_PROCESS_ID"] = str(i)
            fh = tempfile.TemporaryFile("w+")
            files.append(fh)
            procs.append(subprocess.Popen(
                list(argv), env=e, cwd=cwd, start_new_session=True,
                stdout=fh, stderr=subprocess.STDOUT, text=True))
        deadline = time.monotonic() + timeout
        codes = [p.poll() for p in procs]
        while any(c is None for c in codes) \
                and not any(c not in (None, 0) for c in codes) \
                and time.monotonic() < deadline:
            time.sleep(0.05)
            codes = [p.poll() for p in procs]
    finally:
        for p in procs:
            # the rank's whole group: it and anything it left behind
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError, OSError):
                pass
            p.wait()
    outs = []
    for fh in files:
        fh.seek(0)
        outs.append(fh.read())
        fh.close()
    return [-9 if c is None else int(c) for c in codes], outs
