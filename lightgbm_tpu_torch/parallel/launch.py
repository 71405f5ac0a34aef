"""Local ranks: a machine list of free localhost ports and a launcher
that runs one process a rank and leaves none behind.

    from lightgbm_tpu_torch.parallel.launch import machine_list, run_ranks
    mlist = machine_list("mlist.txt", 2)
    run_ranks([[sys.executable, "-m", "lightgbm_tpu_torch",
                "config=train.conf", "num_machines=2",
                f"machine_list_file={mlist}"]] * 2, timeout=300)

Each rank runs in a session of its own with ``LIGHTGBM_TPU_PROCESS_ID``
set to its index (``parallel/multihost.py`` reads it: every entry of the
list names this host).  A rank that outlives ``timeout`` ends the run,
and so, unless ``wait_all``, does a rank that fails: every rank's
process group is killed, on any exit.

**Ports.**  Entry 0's port takes the rendezvous over TCP, and the
collective watchdog binds every entry's port as a UDP socket
(``parallel/watchdog.py``).  ``machine_list`` draws its ports at random
below the kernel's ephemeral range
(``/proc/sys/net/ipv4/ip_local_port_range``), each free for TCP and for
UDP when drawn: a port from ``bind(0)`` lies inside that range, where
any process's outgoing connection (gloo opens many) can take it between
the draw and the rank's bind.

**Threads.**  The ranks of one host share its cores: each gets
``cores // ranks`` intra-op threads (``OMP_NUM_THREADS``, which
``torch`` reads at start), unless the environment sets it.
"""

from __future__ import annotations

import os
import random
import signal
import socket
import subprocess
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

#: the lowest port ``machine_list`` draws
PORT_FLOOR = 20000


def _ephemeral_floor() -> int:
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as fh:
            return int(fh.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 32768


def _port_is_free(port: int) -> bool:
    """``port`` binds on every address, over TCP and over UDP."""
    for kind in (socket.SOCK_STREAM, socket.SOCK_DGRAM):
        with socket.socket(socket.AF_INET, kind) as s:
            try:
                s.bind(("", port))
            except OSError:
                return False
    return True


def free_port(exclude: Sequence[int] = ()) -> int:
    """A port in ``[PORT_FLOOR, ephemeral floor)``, free for TCP and UDP.

    Only where the ephemeral range starts at or below ``PORT_FLOOR``
    does the draw fall back to ``[floor // 2, floor)``, under it."""
    hi = _ephemeral_floor()
    lo = PORT_FLOOR if PORT_FLOOR < hi else hi // 2
    rng = random.SystemRandom()
    for _ in range(1000):
        port = rng.randrange(lo, hi)
        if port not in exclude and _port_is_free(port):
            return port
    raise OSError(f"no free port in [{lo}, {hi}) for both TCP and UDP")


def machine_list(path: str, world: int) -> str:
    """Write ``world`` lines ``127.0.0.1 <free port>``; returns ``path``."""
    ports: List[int] = []
    for _ in range(world):
        ports.append(free_port(exclude=ports))
    with open(path, "w") as fh:
        for port in ports:
            fh.write(f"127.0.0.1 {port}\n")
    return path


def _rank_env(env: Optional[Dict[str, str]], rank: int,
              world: int) -> Dict[str, str]:
    e = dict(os.environ if env is None else env)
    e["LIGHTGBM_TPU_PROCESS_ID"] = str(rank)
    e.setdefault("OMP_NUM_THREADS",
                 str(max(1, (os.cpu_count() or 1) // max(world, 1))))
    return e


def run_ranks(argvs: Sequence[Sequence[str]], timeout: float,
              env: Optional[Dict[str, str]] = None,
              cwd: Optional[str] = None,
              wait_all: bool = False) -> Tuple[List[int], List[str]]:
    """Run rank ``i`` as ``argvs[i]``; returns (exit codes, outputs).

    A rank still running at ``timeout`` seconds gets exit code ``-9``,
    and, unless ``wait_all``, so do the others once one rank exits
    non-zero (``wait_all``: every rank runs to its own end or to
    ``timeout``; a kill test needs the survivor's own exit).  Every
    rank's process group is killed before this returns."""
    procs, files = [], []
    codes: List[Optional[int]] = []
    try:
        for i, argv in enumerate(argvs):
            fh = tempfile.TemporaryFile("w+")
            files.append(fh)
            procs.append(subprocess.Popen(
                list(argv), env=_rank_env(env, i, len(argvs)), cwd=cwd,
                start_new_session=True, stdout=fh,
                stderr=subprocess.STDOUT, text=True))
        deadline = time.monotonic() + timeout
        codes = [p.poll() for p in procs]
        while any(c is None for c in codes) \
                and (wait_all or not any(c not in (None, 0)
                                         for c in codes)) \
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
