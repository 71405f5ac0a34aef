"""The port's collective watchdog (lightgbm_tpu_torch/parallel/
watchdog.py): the heartbeat mesh, the staleness and deadline trips, the
abort machinery and the timeout policy, as the JAX package's
tests/test_watchdog.py holds its own, with ``effective_timeout`` and the
phase deadline compared with the JAX package's on the same comm samples.
All in one process (two meshes on localhost stand in for two ranks; the
real two-rank path is ``tests/test_torch_dist_chaos.py``)."""

import time

import pytest

from lightgbm_tpu.parallel import watchdog as jwd
from lightgbm_tpu_torch import obs
from lightgbm_tpu_torch.parallel.launch import free_port
from lightgbm_tpu_torch.parallel.watchdog import (
    DISTRIBUTED_ABORT_EXIT_CODE, CollectiveWatchdog, DistributedAborted,
    HeartbeatMesh)
from lightgbm_tpu_torch.utils import log


def _free_ports(n):
    ports = []
    for _ in range(n):
        ports.append(free_port(exclude=ports))
    return ports


def _machines(ports):
    return [("127.0.0.1", p) for p in ports]


def _wait_for(cond, timeout_s=5.0, step=0.02):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(step)
    return cond()


class FakeMesh:
    """Scripted peer ages for the deadline path."""

    def __init__(self, ages):
        self.ages = dict(ages)
        self.stopped = False

    def peer_ages(self):
        return dict(self.ages)

    def stop(self):
        self.stopped = True


def test_exit_code_and_error_text_match_jax():
    assert DISTRIBUTED_ABORT_EXIT_CODE == jwd.DISTRIBUTED_ABORT_EXIT_CODE \
        == 75
    ours = DistributedAborted(1, 12.34, "Comm::grow", reason="why")
    theirs = jwd.DistributedAborted(1, 12.34, "Comm::grow", reason="why")
    assert str(ours) == str(theirs)
    assert (ours.rank, ours.last_seen, ours.phase) == (1, 12.34,
                                                       "Comm::grow")


def test_heartbeat_mesh_sees_live_peer_and_ages_dead_one():
    machines = _machines(_free_ports(2))
    m0 = HeartbeatMesh(machines, 0, interval_s=0.05)
    m1 = HeartbeatMesh(machines, 1, interval_s=0.05)
    try:
        assert _wait_for(lambda: m0.peer_ages().get(1, 99) < 0.5)
        assert _wait_for(lambda: m1.peer_ages().get(0, 99) < 0.5)
        m1.stop()
        time.sleep(0.4)
        assert m0.peer_ages()[1] > 0.3
    finally:
        m0.stop()
        m1.stop()


def test_port_mesh_and_jax_mesh_hear_each_other():
    # the same wire format: a port rank and a JAX rank beat to each other
    machines = _machines(_free_ports(2))
    m0 = HeartbeatMesh(machines, 0, interval_s=0.05)
    m1 = jwd.HeartbeatMesh(machines, 1, interval_s=0.05)
    try:
        assert _wait_for(lambda: m0.peer_ages().get(1, 99) < 0.5)
        assert _wait_for(lambda: m1.peer_ages().get(0, 99) < 0.5)
    finally:
        m0.stop()
        m1.stop()


def test_cooperative_check_raises_named_distributed_aborted():
    machines = _machines(_free_ports(2))
    m0 = HeartbeatMesh(machines, 0, interval_s=0.05)
    m1 = HeartbeatMesh(machines, 1, interval_s=0.05)
    wd = CollectiveWatchdog(0, 2, mesh=m0, heartbeat_s=0.05,
                            timeout_s=0.4, abort_fn=lambda code: None)
    try:
        assert _wait_for(lambda: m0.peer_ages().get(1, 99) < 0.5)
        m1.stop()
        assert _wait_for(lambda: bool(wd.stale_peers()), timeout_s=3.0)
        with pytest.raises(DistributedAborted) as ei:
            wd.check("Comm::grow")
        err = ei.value
        assert err.rank == 1
        assert err.phase == "Comm::grow"
        assert err.last_seen > 0.3
        assert "rank 1" in str(err)
        with pytest.raises(DistributedAborted):
            with wd.phase("Comm::grow"):
                pass
    finally:
        wd.stop()
        m1.stop()


def test_never_heard_peers_degrade_instead_of_aborting():
    log.reset_warn_once()
    machines = _machines(_free_ports(2))
    m0 = HeartbeatMesh(machines, 0, interval_s=0.05)
    aborts = []
    wd = CollectiveWatchdog(0, 2, mesh=m0, heartbeat_s=0.05,
                            timeout_s=0.3, tick_s=0.05,
                            abort_fn=aborts.append)
    try:
        time.sleep(0.6)
        assert wd.stale_peers() == []
        assert m0.unheard_peers() == [1]
        wd.check("Comm::grow")
        with wd._lock:
            wd._phase = ["Comm::grow", time.monotonic(), None, False]
        time.sleep(0.5)
        assert aborts == []
        assert "watchdog_channel_silent" in log._warned_once
    finally:
        wd.stop()


def test_hard_abort_fires_in_phase_on_stale_peer_and_flushes():
    machines = _machines(_free_ports(2))
    m0 = HeartbeatMesh(machines, 0, interval_s=0.05)
    m1 = HeartbeatMesh(machines, 1, interval_s=0.05)
    aborts, flushed = [], []
    wd = CollectiveWatchdog(0, 2, mesh=m0, heartbeat_s=0.05,
                            timeout_s=0.5, tick_s=0.05,
                            abort_fn=aborts.append)
    wd.register_flush(lambda: flushed.append(True))
    try:
        assert _wait_for(lambda: m0.peer_ages().get(1, 99) < 0.5)
        m1.stop()
        # out of a phase a stale peer does not hard-abort
        time.sleep(0.8)
        assert aborts == []
        # wedged inside the collective: the phase without its check
        with wd._lock:
            wd._phase = ["Comm::grow", time.monotonic(), None, False]
        assert _wait_for(lambda: aborts, timeout_s=3.0)
        assert aborts[0] == DISTRIBUTED_ABORT_EXIT_CODE
        assert flushed == [True]
    finally:
        wd.stop()
        m1.stop()


def test_guard_classifies_collective_errors_and_passes_own_errors():
    from lightgbm_tpu_torch.utils.log import LightGBMError
    fake = FakeMesh({1: 0.01})
    aborts = []
    wd = CollectiveWatchdog(0, 2, mesh=fake, heartbeat_s=0.05,
                            timeout_s=0.3, tick_s=10.0,
                            abort_fn=aborts.append)
    try:
        # peers alive: a genuine error re-raises after the wait
        with pytest.raises(RuntimeError, match="gloo exploded"):
            with wd.guard("Dist::resume"):
                raise RuntimeError("gloo exploded")
        assert aborts == []
        # the port's own diagnostics pass through at once
        t0 = time.monotonic()
        with pytest.raises(LightGBMError, match="deliberate"):
            with wd.guard("Dist::resume"):
                raise LightGBMError("deliberate diagnostic")
        assert time.monotonic() - t0 < 0.2
        # the peer goes silent as the collective fails: the abort path
        with pytest.raises(RuntimeError):
            with wd.guard("Dist::resume"):
                fake.ages[1] = 99.0
                raise RuntimeError("Connection closed by peer")
        assert aborts == [DISTRIBUTED_ABORT_EXIT_CODE]
    finally:
        wd.stop()


def test_phase_deadline_trips_without_peer_death():
    aborts = []
    wd = CollectiveWatchdog(0, 2, mesh=FakeMesh({1: 0.01}),
                            heartbeat_s=0.05, timeout_s=0.3, tick_s=0.05,
                            abort_fn=aborts.append)
    try:
        with wd._lock:
            wd._phase = ["Comm::grow", time.monotonic(),
                         time.monotonic() + 0.2, False]
        assert _wait_for(lambda: aborts, timeout_s=3.0)
    finally:
        wd.stop()


@pytest.mark.parametrize("heartbeat_s,timeout_s,samples", [
    (0.5, 0.0, []),
    (0.5, 0.0, [0.5]),
    (0.5, 0.0, [30.0] * 50),
    (0.5, 0.0, [2.0, 9.0, 0.1, 12.5, 7.7]),
    (5.0, 0.0, [0.2, 0.3]),
    (0.5, 7.0, []),
    (0.5, 7.0, [30.0]),
    (0.1, 20.0, [1.5, 0.4]),
])
def test_effective_timeout_equals_jax(heartbeat_s, timeout_s, samples):
    ours = CollectiveWatchdog(0, 2, mesh=None, heartbeat_s=heartbeat_s,
                              timeout_s=timeout_s,
                              abort_fn=lambda code: None)
    theirs = jwd.CollectiveWatchdog(0, 2, mesh=None,
                                    heartbeat_s=heartbeat_s,
                                    timeout_s=timeout_s,
                                    abort_fn=lambda code: None)
    try:
        for dt in samples:
            ours.note_comm_seconds(dt)
            theirs.note_comm_seconds(dt)
        assert ours.effective_timeout() == theirs.effective_timeout()
        assert ours._phase_deadline() == theirs._phase_deadline()
    finally:
        ours.stop()
        theirs.stop()


def test_effective_timeout_policy():
    wd = CollectiveWatchdog(0, 2, mesh=None, heartbeat_s=0.5,
                            timeout_s=0.0, abort_fn=lambda code: None)
    try:
        # auto: a 60 s floor, and no phase deadline before a sample
        assert wd.effective_timeout() == pytest.approx(60.0)
        assert wd._phase_deadline() is None
        wd.note_comm_seconds(0.5)
        assert wd.effective_timeout() == pytest.approx(60.0)
        assert wd._phase_deadline() == pytest.approx(60.0)
        for _ in range(50):
            wd.note_comm_seconds(30.0)
        assert wd.effective_timeout() > 60.0
    finally:
        wd.stop()
    wd2 = CollectiveWatchdog(0, 2, mesh=None, heartbeat_s=0.5,
                             timeout_s=7.0, abort_fn=lambda code: None)
    try:
        wd2.note_comm_seconds(30.0)
        assert wd2.effective_timeout() == pytest.approx(7.0)
        assert wd2._phase_deadline() == pytest.approx(7.0)
    finally:
        wd2.stop()


def test_abort_is_once_and_counts():
    before = obs.get_counter("distributed_aborts_total")
    aborts = []
    wd = CollectiveWatchdog(0, 2, mesh=FakeMesh({1: 100.0}),
                            heartbeat_s=0.05, timeout_s=0.1, tick_s=0.02,
                            abort_fn=aborts.append)
    try:
        with wd._lock:
            wd._phase = ["Comm::grow", time.monotonic(), None, False]
        assert _wait_for(lambda: aborts, timeout_s=3.0)
        time.sleep(0.2)
        assert len(aborts) == 1
        assert obs.get_counter("distributed_aborts_total") == before + 1
    finally:
        wd.stop()


def test_start_watchdog_is_idempotent_and_stops(monkeypatch):
    from lightgbm_tpu_torch.parallel import watchdog
    monkeypatch.setattr(watchdog, "_active", None)
    machines = _machines(_free_ports(2))
    wd = watchdog.start_watchdog(machines, 0, heartbeat_s=0.05,
                                 timeout_s=3.0)
    try:
        assert wd is not None and watchdog.active_watchdog() is wd
        assert watchdog.start_watchdog(machines, 0) is wd
        assert wd.effective_timeout() == 3.0
    finally:
        watchdog.stop_active()
    assert watchdog.active_watchdog() is None


def test_multihost_arms_the_watchdog_only_with_a_heartbeat(monkeypatch,
                                                           tmp_path):
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.parallel import multihost, watchdog
    monkeypatch.setattr(watchdog, "_active", None)
    machines = _machines(_free_ports(2))
    off = Config({"distributed_heartbeat_ms": 0})
    assert multihost._maybe_start_watchdog(off, machines, 0) is None
    on = Config({"distributed_heartbeat_ms": 50,
                 "collective_timeout_s": 4})
    wd = multihost._maybe_start_watchdog(on, machines, 1)
    try:
        assert wd is watchdog.active_watchdog()
        assert (wd.rank, wd.num_processes, wd.effective_timeout()) \
            == (1, 2, 4.0)
    finally:
        watchdog.stop_active()


def test_cli_exits_75_on_a_distributed_abort(monkeypatch, capfd):
    from lightgbm_tpu_torch import cli

    def aborted(config, params):
        raise DistributedAborted(1, 21.5, "Comm::grow", reason="injected")

    def exit_(code):
        raise SystemExit(code)
    monkeypatch.setattr(cli, "run_train", aborted)
    monkeypatch.setattr(cli.os, "_exit", exit_)
    monkeypatch.setattr(log, "_current_level", 1)
    with pytest.raises(SystemExit) as ei:
        cli.main(["task=train", "data=none.csv", "device=cpu"])
    assert ei.value.code == DISTRIBUTED_ABORT_EXIT_CODE
    err = capfd.readouterr().err
    assert "distributed training aborted in phase 'Comm::grow': rank 1" \
        in err
    assert "exiting with code 75" in err
