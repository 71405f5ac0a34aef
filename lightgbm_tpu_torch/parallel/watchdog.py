"""Collective watchdog: a dead or hung rank becomes a bounded, named,
restartable event instead of a silent deadlock of every rank.

The port's own copy of the JAX package's parallel/watchdog.py.  Every
round of a distributed learner synchronizes its ranks through
``torch.distributed`` collectives (``parallel/comm.py``).  A killed peer
surfaces in gloo as a connection error, or as nothing at all: the other
ranks wait in the collective until gloo's own timeout.  Two pieces, both
outside the collectives they guard:

- ``HeartbeatMesh``: a UDP full mesh over the machine list's own
  ``host port`` entries (each rank binds its listed port as a datagram
  socket; the rendezvous takes entry 0's port over TCP only).  A daemon
  thread sends a beat every ``distributed_heartbeat_ms``, another
  records ``last_seen`` per peer.  The beats keep flowing while a rank
  waits in a collective (the wait releases the GIL), so silence means
  death or a wedged process, not work.

- ``CollectiveWatchdog``: a daemon thread armed around each round's
  collectives (``GBDT`` wraps the distributed grower in
  ``watchdog.phase("Comm::grow")``).  Two trips:

  * cooperative: entering a phase ``check()``s the peers' staleness and
    raises ``DistributedAborted(rank, last_seen, phase)`` in the
    training thread;
  * hard: while a phase is active, the watchdog thread compares the
    clock with the phase's deadline and the peers' heartbeat ages; on
    expiry it runs the registered flushes (the event stream's close
    among them), exports the causal trace, logs the diagnostic and
    ``os._exit``s with ``DISTRIBUTED_ABORT_EXIT_CODE`` (75), the code a
    launcher restarts on (the restart resumes from the coordinated
    snapshots, ``snapshot.py``).

The phase deadline is ``collective_timeout_s`` when set, else derived
from the ``comm_seconds`` EWMA the grower feeds back (a multiple over a
floor, so a first round's kernel builds and a slow round never trip it;
before the first sample only a peer's death can abort).
"""

from __future__ import annotations

import contextlib
import os
import socket
import struct
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..utils import log
from ..utils.log import LightGBMError

# EX_TEMPFAIL: "try again later" — the launcher contract is exactly
# that (restart the pod; resume from the coordinated snapshot)
DISTRIBUTED_ABORT_EXIT_CODE = 75

_MAGIC = b"LGBTHB1"
_PACK = struct.Struct("!7sII")        # magic, rank, seq


class DistributedAborted(LightGBMError):
    """A peer rank died or a guarded collective blew its deadline.

    ``rank`` is the suspect peer (the stalest one when only the
    deadline tripped), ``last_seen`` the seconds since its last
    heartbeat, ``phase`` the guarded phase that was active."""

    def __init__(self, rank: int, last_seen: float, phase: str,
                 reason: str = ""):
        self.rank = int(rank)
        self.last_seen = float(last_seen)
        self.phase = str(phase)
        msg = (f"distributed training aborted in phase {phase!r}: "
               f"rank {rank} last seen {last_seen:.1f}s ago")
        if reason:
            msg += f" ({reason})"
        super().__init__(msg)


class HeartbeatMesh:
    """UDP heartbeat full mesh over the machine-list addresses.

    Rank ``i`` binds ``machines[i]`` (falling back to the wildcard
    address when the listed name is a VIP this host cannot bind) and
    datagrams every peer each ``interval_s``.  ``peer_ages()`` reports
    seconds since each peer's last heartbeat — peers never heard from
    age from mesh start, so a slow-to-arrive worker gets a full timeout
    of grace rather than an instant abort."""

    def __init__(self, machines: Sequence[Tuple[str, int]], rank: int,
                 interval_s: float = 0.5):
        self.rank = int(rank)
        self.interval_s = max(float(interval_s), 0.01)
        self._peers = [(i, (host, int(port)))
                       for i, (host, port) in enumerate(machines)
                       if i != self.rank]
        self._started = time.monotonic()
        self._last_seen: Dict[int, float] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        host, port = machines[self.rank]
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            self._sock.bind((host, int(port)))
        except OSError:
            # the listed address may be a VIP/NAT name the host cannot
            # bind; the port number is what peers aim at
            self._sock.bind(("", int(port)))
        self._sock.settimeout(self.interval_s)
        self._seq = 0
        self._recv_thread = threading.Thread(
            target=self._recv_loop, name="lgbt-hb-recv", daemon=True)
        self._send_thread = threading.Thread(
            target=self._send_loop, name="lgbt-hb-send", daemon=True)
        self._recv_thread.start()
        self._send_thread.start()

    # -- wire ------------------------------------------------------------
    def _send_loop(self) -> None:
        while not self._stop.is_set():
            self._seq += 1
            payload = _PACK.pack(_MAGIC, self.rank & 0xFFFFFFFF,
                                 self._seq & 0xFFFFFFFF)
            for _, addr in self._peers:
                try:
                    self._sock.sendto(payload, addr)
                except OSError:
                    pass              # unresolvable/dead peer: silence IS
                    # the signal, the ager reports it
            self._stop.wait(self.interval_s)

    def _recv_loop(self) -> None:
        while not self._stop.is_set():
            try:
                data, _ = self._sock.recvfrom(64)
            except socket.timeout:
                continue
            except OSError:
                return                # socket closed by stop()
            if len(data) != _PACK.size:
                continue
            magic, rank, _ = _PACK.unpack(data)
            if magic != _MAGIC or rank == self.rank:
                continue
            with self._lock:
                self._last_seen[int(rank)] = time.monotonic()

    # -- readers ---------------------------------------------------------
    def peer_ages(self) -> Dict[int, float]:
        """Seconds since each peer's last heartbeat — ONLY for peers
        heard at least once.  A peer we have NEVER heard from is not
        evidence of death: on a network that drops inter-host UDP (or a
        VIP the host could not bind) every peer would look silent
        forever, and aborting a healthy pod over an undeliverable side
        channel is strictly worse than the hang the watchdog prevents.
        Never-heard peers are reported by ``unheard_peers`` and degrade
        to a one-shot warning instead (watchdog deadline still works)."""
        now = time.monotonic()
        with self._lock:
            return {r: now - t for r, t in self._last_seen.items()}

    def unheard_peers(self) -> List[int]:
        """Peers never heard from since mesh start."""
        with self._lock:
            return [r for r, _ in self._peers if r not in self._last_seen]

    @property
    def started(self) -> float:
        return self._started

    def stop(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass


class CollectiveWatchdog:
    """Arm a deadline + peer-liveness guard around guarded phases.

    ``mesh`` only needs ``peer_ages() -> {rank: seconds}`` (tests pass
    fakes).  ``abort_fn`` replaces the hard ``os._exit`` for tests."""

    # auto-timeout shape: never tighter than the floor, scaled off the
    # comm EWMA once one real round has been measured.  The floor is
    # deliberately generous — a false abort costs a whole pod restart,
    # a true one only costs the timeout.
    AUTO_FLOOR_S = 60.0
    AUTO_HEARTBEAT_MULT = 20.0
    AUTO_EWMA_MULT = 8.0
    EWMA_ALPHA = 0.3

    def __init__(self, rank: int, num_processes: int,
                 mesh: Optional[HeartbeatMesh] = None,
                 heartbeat_s: float = 0.5, timeout_s: float = 0.0,
                 abort_fn: Optional[Callable[[int], None]] = None,
                 tick_s: Optional[float] = None):
        self.rank = int(rank)
        self.num_processes = int(num_processes)
        self.mesh = mesh
        self._heartbeat_s = max(float(heartbeat_s), 0.01)
        self._timeout_s = max(float(timeout_s), 0.0)
        self._comm_ewma = 0.0
        self._abort_fn = abort_fn or self._hard_exit
        self._flush_hooks: List[Callable[[], None]] = []
        self._lock = threading.Lock()
        self._phase: Optional[Tuple[str, float, Optional[float]]] = None
        self._aborted = False
        self._stop = threading.Event()
        self._tick_s = float(tick_s) if tick_s else \
            min(1.0, max(self._heartbeat_s, 0.05))
        self._thread = threading.Thread(
            target=self._run, name="lgbt-collective-watchdog", daemon=True)
        self._thread.start()

    # -- timeout policy --------------------------------------------------
    def note_comm_seconds(self, dt: float) -> None:
        """Feed one completed round's collective wall time into the EWMA
        the auto timeout derives from (the distributed grower calls
        this)."""
        dt = float(dt)
        with self._lock:
            self._comm_ewma = (dt if self._comm_ewma <= 0.0 else
                               (1 - self.EWMA_ALPHA) * self._comm_ewma
                               + self.EWMA_ALPHA * dt)

    def effective_timeout(self) -> float:
        """Peer-staleness threshold: ``collective_timeout_s`` when
        configured, else a generous auto bound."""
        if self._timeout_s > 0:
            return self._timeout_s
        base = max(self.AUTO_FLOOR_S,
                   self.AUTO_HEARTBEAT_MULT * self._heartbeat_s)
        with self._lock:
            ewma = self._comm_ewma
        if ewma > 0:
            base = max(base, self.AUTO_EWMA_MULT * ewma)
        return base

    def _phase_deadline(self) -> Optional[float]:
        """Per-phase soft deadline in seconds, or None before the first
        completed round has fed the EWMA — the first distributed round
        may include the kernels' first build, which neither the
        configured timeout nor any a-priori bound should guess at.  Peer DEATH still aborts
        during that window via the heartbeat-staleness path."""
        with self._lock:
            ewma = self._comm_ewma
        if ewma <= 0:
            return None
        if self._timeout_s > 0:
            return self._timeout_s
        return max(self.AUTO_FLOOR_S,
                   self.AUTO_HEARTBEAT_MULT * self._heartbeat_s,
                   self.AUTO_EWMA_MULT * ewma)

    # -- guarded phases --------------------------------------------------
    @contextlib.contextmanager
    def phase(self, name: str):
        """Guard a blocking collective region.  Entry runs the
        cooperative peer check (raises ``DistributedAborted`` in the
        calling thread); while inside, the watchdog thread owns the
        hard-abort path."""
        self.check(name)
        deadline = self._phase_deadline()
        with self._lock:
            self._phase = [str(name), time.monotonic(),
                           None if deadline is None else
                           time.monotonic() + deadline,
                           False]          # extended-once flag
        try:
            yield self
        finally:
            with self._lock:
                self._phase = None

    def stale_peers(self) -> List[Tuple[int, float]]:
        """``(rank, age_s)`` for peers beyond the staleness threshold,
        stalest first."""
        if self.mesh is None:
            return []
        timeout = self.effective_timeout()
        out = [(r, age) for r, age in self.mesh.peer_ages().items()
               if age > timeout]
        out.sort(key=lambda ra: -ra[1])
        return out

    def check(self, phase: str = "idle") -> None:
        """Cooperative trip: raise ``DistributedAborted`` if any peer's
        heartbeat is stale (called at phase entry, i.e. while THIS rank
        can still run Python)."""
        stale = self.stale_peers()
        if stale:
            rank, age = stale[0]
            raise DistributedAborted(
                rank, age, phase,
                reason=f"no heartbeat for {age:.1f}s "
                       f"(timeout {self.effective_timeout():.1f}s)")

    @contextlib.contextmanager
    def guard(self, name: str):
        """``phase`` + error classification in one wrapper, for host
        collectives outside the grow path (consistency digests, resume
        consensus): entry runs the cooperative peer check, a wedge
        inside is bounded by the hard-abort path, and a raised
        collective error is classified against the heartbeats before it
        is allowed to unwind.  ``LightGBMError``s pass straight through
        — they are OUR deliberate diagnostics, not collective
        failures."""
        try:
            with self.phase(name):
                yield self
        except LightGBMError:
            raise                     # includes DistributedAborted
        except Exception as e:
            self.classify_collective_error(e, name)
            raise

    def classify_collective_error(self, err: BaseException,
                                  phase: str) -> None:
        """A guarded collective RAISED ``err`` (gloo surfaces a killed
        peer as a connection reset instead of hanging).  Wait up to the
        staleness timeout for the heartbeats to confirm a peer death; on
        confirmation take the abort path — once a peer is gone the
        process group cannot recover in-process, and the raw error
        would end the process with a code no launcher restarts on.
        Returns normally when every peer stayed alive (a genuine
        collective error: the caller re-raises it)."""
        if self.mesh is None:
            return
        detail = str(err).splitlines()[0][:200] if str(err) else ""
        t_err = time.monotonic()
        deadline = t_err + self.effective_timeout() + 5 * self._heartbeat_s
        while time.monotonic() < deadline:
            stale = self.stale_peers()
            if stale:
                rank, age = stale[0]
                self._abort(DistributedAborted(
                    rank, age, phase,
                    reason=f"collective failed "
                           f"({type(err).__name__}: {detail}) and the "
                           f"peer's heartbeat stopped"))
                return            # reached only under a test abort_fn
            # early exoneration: once EVERY peer has been heard AFTER
            # the error was raised, nobody died — this is a genuine
            # error, re-raise it now instead of stalling the pod for
            # the full timeout on e.g. a shape bug
            ages = self.mesh.peer_ages()
            unheard = getattr(self.mesh, "unheard_peers", lambda: [])()
            now = time.monotonic()
            if unheard and not ages:
                return            # channel silent: cannot classify
            if (not unheard and ages
                    and now - t_err > 2 * self._heartbeat_s
                    and all(age < now - t_err for age in ages.values())):
                return
            time.sleep(min(0.1, self._heartbeat_s))

    # -- hard-abort machinery --------------------------------------------
    def register_flush(self, fn: Callable[[], None]) -> None:
        """Telemetry sink to drain before a hard abort (events recorder
        close, etc.).  Best-effort, exceptions swallowed."""
        with self._lock:
            if fn not in self._flush_hooks:
                self._flush_hooks.append(fn)

    def unregister_flush(self, fn: Callable[[], None]) -> None:
        with self._lock:
            if fn in self._flush_hooks:
                self._flush_hooks.remove(fn)

    def _warn_if_channel_silent(self) -> None:
        """One-shot diagnostic when NO peer has ever been heard past the
        timeout: the heartbeat channel itself is undeliverable (blocked
        UDP, unroutable machine-list address) — peer-death detection is
        degraded to the phase deadline, and saying so once beats either
        silence or a false abort loop."""
        mesh = self.mesh
        if mesh is None:
            return
        unheard = getattr(mesh, "unheard_peers", lambda: [])()
        started = getattr(mesh, "started", None)
        if not unheard or started is None:
            return
        if len(unheard) == len(getattr(mesh, "_peers", unheard)) \
                and time.monotonic() - started > self.effective_timeout():
            log.warn_once(
                "watchdog_channel_silent",
                "collective watchdog: no heartbeat has EVER arrived from "
                "any peer (%s) — the UDP side channel looks undeliverable "
                "(blocked port, unroutable machine-list address).  "
                "Peer-death detection is degraded; the per-round deadline "
                "(collective_timeout_s) still applies.", unheard)

    def _run(self) -> None:
        while not self._stop.wait(self._tick_s):
            self._warn_if_channel_silent()
            with self._lock:
                phase = self._phase
            if phase is None:
                continue              # hard aborts only fire while a
                # collective can actually be wedged
            name, t0, deadline, extended = phase
            stale = self.stale_peers()
            now = time.monotonic()
            if stale:
                rank, age = stale[0]
                self._abort(DistributedAborted(
                    rank, age, name,
                    reason="peer heartbeat lost while this rank was "
                           "blocked in the collective"))
            elif deadline is not None and now > deadline:
                if not extended:
                    # every peer is still heartbeating: grant ONE
                    # extension of the full deadline before giving up —
                    # a one-off slow round (a mid-run recompile, a
                    # peer's slow snapshot fsync) is absorbed, a true
                    # wedge is still bounded at 2x the timeout
                    span = deadline - t0
                    log.warning(
                        "collective watchdog: phase %r exceeded its "
                        "%.1fs deadline with every peer still alive; "
                        "extending once (abort at %.1fs total)",
                        name, span, 2 * span)
                    with self._lock:
                        if self._phase is phase:
                            phase[2] = now + span
                            phase[3] = True
                    continue
                ages = (self.mesh.peer_ages() if self.mesh is not None
                        else {})
                suspect, age = ((max(ages.items(), key=lambda ra: ra[1]))
                                if ages else (-1, 0.0))
                self._abort(DistributedAborted(
                    suspect, age, name,
                    reason=f"collective exceeded its "
                           f"{deadline - t0:.1f}s deadline (after one "
                           f"extension)"))

    def _abort(self, err: DistributedAborted) -> None:
        with self._lock:
            if self._aborted:
                return
            self._aborted = True
            hooks = list(self._flush_hooks)
        log.warning(
            "%s — flushing telemetry and exiting with code %d so the "
            "launcher can restart the pod (resume rides the coordinated "
            "snapshots, docs/FAULT_TOLERANCE.md §Distributed)",
            err, DISTRIBUTED_ABORT_EXIT_CODE)
        for fn in hooks:
            try:
                fn()
            except Exception:
                pass
        try:
            from ..obs import tracing
            tracing.TRACER.maybe_export()
        except Exception:
            pass
        log.inc("distributed_aborts_total")
        self._abort_fn(DISTRIBUTED_ABORT_EXIT_CODE)

    @staticmethod
    def _hard_exit(code: int) -> None:
        # not sys.exit: the training thread is wedged inside a C++
        # collective and will never unwind a SystemExit
        os._exit(code)

    def stop(self) -> None:
        self._stop.set()
        if self.mesh is not None:
            self.mesh.stop()


# ---------------------------------------------------------------------------
# process-wide singleton (armed by multihost.maybe_initialize_distributed,
# read by the distributed grower, the consistency check, the resume
# consensus and engine.train)

_active_lock = threading.Lock()
_active: Optional[CollectiveWatchdog] = None


def start_watchdog(machines: Sequence[Tuple[str, int]], rank: int,
                   heartbeat_s: float = 0.5,
                   timeout_s: float = 0.0) -> Optional[CollectiveWatchdog]:
    """Bring up the heartbeat mesh + watchdog for this process (idempotent:
    a running watchdog is kept).  Returns None when the mesh socket
    cannot be bound — degraded, but never fatal to training."""
    global _active
    with _active_lock:
        if _active is not None:
            return _active
    try:
        mesh = HeartbeatMesh(machines, rank, interval_s=heartbeat_s)
    except OSError as exc:
        log.warning("collective watchdog disabled: could not bind the "
                    "heartbeat socket for rank %d (%s)", rank, exc)
        return None
    wd = CollectiveWatchdog(rank, len(machines), mesh=mesh,
                            heartbeat_s=heartbeat_s, timeout_s=timeout_s)
    log.info("collective watchdog armed: rank %d/%d, heartbeat %.0fms, "
             "timeout %s", rank, len(machines), heartbeat_s * 1000.0,
             (f"{timeout_s:.1f}s" if timeout_s > 0
              else "auto (comm_seconds EWMA)"))
    with _active_lock:
        _active = wd
    return wd


def active_watchdog() -> Optional[CollectiveWatchdog]:
    with _active_lock:
        return _active


def stop_active() -> None:
    global _active
    with _active_lock:
        wd, _active = _active, None
    if wd is not None:
        wd.stop()
