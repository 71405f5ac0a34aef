"""Rank failures on real gloo ranks on the CPU (``tests/
torch_chaos_worker.py`` through ``parallel.launch.run_ranks(wait_all=
True)``), the JAX package's tests/test_dist_chaos.py for the port:

- rank 1 SIGKILLed mid-training: rank 0 leaves with exit code 75, its
  message naming ``Comm::grow`` and ``rank 1``;
- the pod restarted on fresh ports resumes from the coordinated
  snapshot, and its model equals an uninterrupted two-rank run's, byte
  for byte, on both ranks;
- rank 1 hung in a round (its heartbeats flowing): rank 0's round
  deadline trips, exit code 75, and rank 1, waking to a dead peer,
  leaves with 75 too;
- a corrupted rank: ``fail_fast`` names rank 1 and ``score``, then
  ``resync`` trains the clean model, in one launch."""

import os
import signal
import sys

from lightgbm_tpu_torch.parallel.launch import machine_list, run_ranks

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "torch_chaos_worker.py")

# one pair's bound: two torch imports and a few rounds take ~10 s alone
LAUNCH_TIMEOUT_S = 150
# the launcher restarts on the number, not the symbol
DISTRIBUTED_ABORT_EXIT_CODE = 75


def _launch(scenario, workdir):
    mlist = machine_list(str(workdir / f"mlist_{scenario}.txt"), 2)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    return run_ranks([[sys.executable, WORKER, scenario, mlist,
                       str(workdir)]] * 2, timeout=LAUNCH_TIMEOUT_S,
                     env=env, cwd=REPO, wait_all=True)


def _verdicts(workdir, scenario, tag):
    texts = []
    for rank in range(2):
        path = workdir / f"verdict_{scenario}_{rank}.txt"
        assert path.exists(), f"rank {rank} wrote no {scenario} verdict"
        text = path.read_text()
        assert text.startswith(tag), text[:200]
        texts.append(text)
    assert texts[0] == texts[1]
    return texts


def test_rank_kill_aborts_survivor_then_pod_resumes_bit_exact(tmp_path):
    codes, outs = _launch("kill", tmp_path)
    assert codes == [DISTRIBUTED_ABORT_EXIT_CODE, -signal.SIGKILL], \
        outs[0][-3000:] + outs[1][-3000:]
    assert "UNEXPECTED_COMPLETION" not in outs[0]
    assert "distributed training aborted in phase 'Comm::grow'" in outs[0]
    assert "rank 1 last seen" in outs[0]
    snaps = sorted(os.listdir(tmp_path / "snaps"))
    assert snaps and snaps[-1] == "snapshot_0000000003.bin", snaps
    codes, outs = _launch("resume", tmp_path)
    assert codes == [0, 0], outs[0][-3000:] + outs[1][-3000:]
    assert "resume consensus: 2 ranks agreed" in outs[0]
    _verdicts(tmp_path, "resume", "RESUME_OK")


def test_rank_hang_trips_the_round_deadline(tmp_path):
    codes, outs = _launch("hang", tmp_path)
    assert codes == [DISTRIBUTED_ABORT_EXIT_CODE] * 2, \
        outs[0][-3000:] + outs[1][-3000:]
    assert "UNEXPECTED_COMPLETION" not in outs[0]
    assert "distributed training aborted in phase 'Comm::grow'" in outs[0]
    assert "deadline" in outs[0]


def test_desync_fail_fast_then_resync_heals(tmp_path):
    codes, outs = _launch("desync", tmp_path)
    assert codes == [0, 0], outs[0][-3000:] + outs[1][-3000:]
    for out in outs:
        assert "fail_fast: distributed state desync detected" in out
    _verdicts(tmp_path, "desync", "DESYNC_OK")
