"""Bring-up of a ``torch.distributed`` group from the reference's
machine list.

Port of the JAX package's parallel/multihost.py.  Every process reads
the same ``ip port`` list (``machine_list_file``), finds its own entry
and joins a group whose rendezvous is the first entry:

  * the rendezvous = ``tcp://<entry 0 host>:<entry 0 port>``;
  * the rank = this process's index in the list, found by matching the
    host's addresses (``LIGHTGBM_TPU_PROCESS_ID=<idx>`` overrides it, as
    it must when several processes share a host);
  * the world = ``num_machines``.

The backend is fixed once, when the group is built, by a rule
(:func:`choose_backend`), and logged: ``nccl`` when every local rank has
a card of its own, ``gloo`` when ranks share a card or run on the CPU.
A rank's card is ``cuda:<local rank % device_count>``
(:func:`rank_device`).  Once the group is up, ``distributed_heartbeat_ms
> 0`` arms the collective watchdog (``parallel/watchdog.py``) over the
same machine list, with ``collective_timeout_s`` as its deadline.
"""

from __future__ import annotations

import datetime
import os
import socket
import time
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from ..utils import log


def parse_machine_list(path: str) -> List[Tuple[str, int]]:
    """``ip port`` a line (the reference's machine_list_file format).
    Every error names the file and the line; a duplicate ``host port``
    entry is fatal here."""
    out: List[Tuple[str, int]] = []
    seen: dict = {}
    with open(path) as fh:
        for line_no, line in enumerate(fh, 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.replace(",", " ").split()
            if len(parts) < 2:
                log.fatal("machine_list_file %s line %d: malformed entry "
                          "%r (expected 'ip port')", path, line_no, line)
            try:
                port = int(parts[1])
            except ValueError:
                log.fatal("machine_list_file %s line %d: port %r is not "
                          "an integer", path, line_no, parts[1])
            entry = (parts[0], port)
            if entry in seen:
                log.fatal("machine_list_file %s line %d: duplicate entry "
                          "'%s %d' (first seen on line %d) — every "
                          "process needs a distinct host:port pair",
                          path, line_no, parts[0], port, seen[entry])
            seen[entry] = line_no
            out.append(entry)
    return out


def _local_addresses() -> set:
    names = {socket.gethostname()}
    try:
        names.add(socket.getfqdn())
        for info in socket.getaddrinfo(socket.gethostname(), None):
            names.add(info[4][0])
    except OSError:
        pass
    names.update({"127.0.0.1", "localhost"})
    return names


def find_process_id(machines: List[Tuple[str, int]]) -> Optional[int]:
    """This process's rank in the machine list, or None when no entry
    matches (``LIGHTGBM_TPU_PROCESS_ID`` overrides the search)."""
    override = os.environ.get("LIGHTGBM_TPU_PROCESS_ID")
    if override is not None:
        try:
            pid = int(override)
        except ValueError:
            log.fatal("LIGHTGBM_TPU_PROCESS_ID=%r is not an integer",
                      override)
        if not 0 <= pid < len(machines):
            log.fatal("LIGHTGBM_TPU_PROCESS_ID=%d is out of range: the "
                      "machine list has %d entr%s (valid ids 0..%d)",
                      pid, len(machines),
                      "y" if len(machines) == 1 else "ies",
                      len(machines) - 1)
        return pid
    local = _local_addresses()
    matches = [i for i, (host, _) in enumerate(machines) if host in local]
    if len(matches) > 1:
        # several processes on one host: the launcher must number them
        log.fatal("machine_list_file matches this host %d times; set "
                  "LIGHTGBM_TPU_PROCESS_ID per process", len(matches))
    return matches[0] if matches else None


def process_rank_world() -> Tuple[int, int]:
    """``(rank, world)`` of the default group; ``(0, 1)`` without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_ranks(machines: List[Tuple[str, int]], pid: int) -> Tuple[int, int]:
    """(this rank's index among the ranks on its host, the ranks on its
    host): the entries that name the same host as entry ``pid``."""
    host = machines[pid][0]
    same = [i for i, (h, _) in enumerate(machines) if h == host]
    return same.index(pid), len(same)


def choose_backend(local_count: int, device_count: int) -> str:
    """``nccl`` when each of the ``local_count`` ranks on this host has a
    card of its own, else ``gloo`` (ranks sharing a card, or no card:
    NCCL will not put two ranks of one group on one card)."""
    if device_count >= local_count >= 1 and device_count > 0:
        return "nccl"
    return "gloo"


def rank_device(local_rank: int, on_cpu: bool = False) -> torch.device:
    """A rank's device: ``cuda:<local rank % device_count>``, or the CPU
    when asked (or when the host has no card, where the caller's own
    device check refuses the card)."""
    n = torch.cuda.device_count() if not on_cpu else 0
    if n <= 0:
        return torch.device("cpu")
    return torch.device("cuda", local_rank % n)


def initialize_with_retry(init_method: str, world_size: int, rank: int,
                          backend: str, *, retries: int = 3,
                          backoff_s: float = 2.0,
                          timeout_s: float = 0.0) -> bool:
    """``torch.distributed.init_process_group`` with exponential backoff:
    ``retries`` more attempts ``backoff_s * 2^i`` apart, within
    ``timeout_s`` overall (<= 0: no deadline; each attempt then waits
    PyTorch's default).  A group already up is kept.  Running out of
    attempts is fatal, naming the rendezvous, the rank and the last
    error."""
    if dist.is_initialized():
        log.warning("torch.distributed already initialized; keeping the "
                    "existing group")
        return True
    deadline = (time.monotonic() + timeout_s) if timeout_s > 0 else None
    attempts = max(int(retries), 0) + 1
    delay = max(float(backoff_s), 0.0)
    last_err: Optional[BaseException] = None
    made = 0
    kwargs = {}
    if timeout_s > 0:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout_s)
    for attempt in range(attempts):
        if attempt > 0:
            if deadline is not None and time.monotonic() + delay > deadline:
                break
            log.warning("torch.distributed init attempt %d/%d failed (%s); "
                        "retrying in %.1fs", attempt, attempts, last_err,
                        delay)
            time.sleep(delay)
            delay *= 2
        made += 1
        try:
            dist.init_process_group(backend, init_method=init_method,
                                    rank=rank, world_size=world_size,
                                    **kwargs)
            return True
        except Exception as e:  # noqa: BLE001 - the rendezvous raises many
            last_err = e
    log.fatal(
        "torch.distributed could not reach the rendezvous %s as rank %d/%d "
        "after %d attempt(s): %s.  Check that the first machine_list_file "
        "entry names a host every worker can reach, that rank 0 is "
        "running, and that the port is open; raise "
        "distributed_init_retries / distributed_init_backoff / time_out "
        "for a slow bring-up.", init_method, rank, world_size, made,
        last_err)


#: the device of this process's rank, set by maybe_initialize_distributed
RANK_DEVICE: Optional[torch.device] = None


def maybe_initialize_distributed(config) -> bool:
    """Join the group that ``num_machines`` and ``machine_list_file``
    describe.  Returns True when a group of more than one rank is up (or
    was already); False for one process (Network::Init is a no-op for
    ``num_machines <= 1``, and without a machine list the run trains
    serial with the JAX package's warning).  ``device=cpu`` in the
    config makes it a gloo group on the CPU."""
    global RANK_DEVICE
    num_machines = int(config.num_machines or 1)
    mlist = config.machine_list_file or ""
    if num_machines <= 1 or not mlist:
        return False
    if dist.is_initialized():
        # a group the caller built: the machine list only arms the
        # watchdog, and a bad one degrades to a warning
        try:
            machines = parse_machine_list(mlist)[:num_machines]
            _maybe_start_watchdog(config, machines, dist.get_rank())
        except Exception as e:  # noqa: BLE001 - never fatal here
            log.warning("machine_list_file %s is unusable for the "
                        "collective watchdog (%s); watchdog disabled",
                        mlist, e)
        return dist.get_world_size() > 1
    machines = parse_machine_list(mlist)
    if len(machines) < num_machines:
        log.fatal("machine_list_file has %d entries but num_machines=%d",
                  len(machines), num_machines)
    machines = machines[:num_machines]
    pid = find_process_id(machines)
    if pid is None:
        log.fatal("Could not find the local machine in machine_list_file; "
                  "set LIGHTGBM_TPU_PROCESS_ID explicitly")
    local_rank, local_count = local_ranks(machines, pid)
    on_cpu = str(config.get("device", "") or "").lower() == "cpu"
    cards = 0 if on_cpu else torch.cuda.device_count()
    backend = choose_backend(local_count, cards)
    RANK_DEVICE = rank_device(local_rank, on_cpu)
    host, port = machines[0]
    log.info("torch.distributed: rendezvous %s:%d, rank %d/%d, backend %s "
             "(%d rank(s) on this host, %d card(s)), device %s", host,
             port, pid, num_machines, backend, local_count, cards,
             RANK_DEVICE)
    if RANK_DEVICE.type == "cuda":
        torch.cuda.set_device(RANK_DEVICE)
    else:
        # ranks on the CPU share the host's cores: each takes its share
        # (all of them each, the ranks' threads and gloo's polling
        # oversubscribe the host several times over)
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // local_count))
    # the reference's time_out is minutes (config.h network section)
    timeout_s = 60.0 * float(config.time_out or 0)
    initialize_with_retry(
        f"tcp://{host}:{port}", num_machines, pid, backend,
        retries=int(config.distributed_init_retries or 0),
        backoff_s=float(config.distributed_init_backoff or 0.0),
        timeout_s=timeout_s)
    _maybe_start_watchdog(config, machines, pid)
    return True


def _maybe_start_watchdog(config, machines: List[Tuple[str, int]],
                          pid: int):
    """Arm the collective watchdog for this rank once the group is up;
    ``distributed_heartbeat_ms=0`` leaves it off."""
    hb_ms = float(config.get("distributed_heartbeat_ms", 0.0) or 0.0)
    if hb_ms <= 0:
        return None
    from . import watchdog
    return watchdog.start_watchdog(
        machines, int(pid), heartbeat_s=hb_ms / 1000.0,
        timeout_s=float(config.get("collective_timeout_s", 0.0) or 0.0))
