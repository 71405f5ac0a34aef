"""One rank of the port's distributed chaos tests (not collected): joins
a two-rank gloo group on the CPU through ``parallel/multihost.py`` (the
collective watchdog armed) and runs one scenario of
``tests/test_torch_dist_chaos.py``:

    python tests/torch_chaos_worker.py <scenario> <mlist> <workdir>

* ``kill``: data-parallel training with a snapshot every round while
  ``faults.kill_rank`` SIGKILLs rank 1 as round ``KILL_AT`` begins.
  Rank 0 must leave through the watchdog with exit code 75; reaching the
  end of the scenario is the failure.
* ``hang``: ``faults.hang_rank`` blocks rank 1 in round ``HANG_AT`` (its
  heartbeats flowing); rank 0's round deadline must trip, exit code 75.
  Rank 1 wakes after rank 0 is gone and leaves with 75 too.
* ``resume``: a restarted pod agrees on the newest common snapshot
  (``coordinated_resume``), resumes, and its model must equal an
  uninterrupted two-rank run's, byte for byte.
* ``desync``: ``faults.corrupt_rank_state`` on rank 1's scores with
  ``distributed_consistency_check=1``: ``fail_fast`` stops both ranks
  naming rank 1 and ``score``, then ``resync`` trains the clean model.

``LIGHTGBM_TPU_PROCESS_ID`` numbers the rank.  A scenario that passes
writes ``verdict_<scenario>_<rank>.txt``: a tag line, then the model.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import numpy as np  # noqa: E402

import lightgbm_tpu_torch as lt  # noqa: E402
from lightgbm_tpu_torch.config import Config  # noqa: E402
from lightgbm_tpu_torch.parallel.multihost import (  # noqa: E402
    maybe_initialize_distributed, process_rank_world)
from lightgbm_tpu_torch.parallel.watchdog import (  # noqa: E402
    DISTRIBUTED_ABORT_EXIT_CODE, DistributedAborted)
from lightgbm_tpu_torch.testing import faults  # noqa: E402

ROUNDS = 6
KILL_AT = 3          # rank 1 dies entering this round
HANG_AT = 2          # rank 1 blocks entering this round
HANG_S = 12.0        # for longer than rank 0's two 3 s deadlines
CORRUPT_AT = 2       # rank 1's scores change after this round


def dataset():
    rng = np.random.RandomState(9)
    X = rng.normal(size=(400, 6))
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2]
         + 0.1 * rng.normal(size=400) > 0).astype(np.float64)
    return lt.Dataset(X, y)


def main() -> int:
    scenario, mlist, workdir = sys.argv[1], sys.argv[2], sys.argv[3]
    dist = {"objective": "binary", "metric": ["binary_logloss"],
            "num_leaves": 6, "max_bin": 32, "min_data_in_leaf": 10,
            "feature_fraction": 0.8, "learning_rate": 0.2,
            "tree_learner": "data", "num_machines": 2,
            "machine_list_file": mlist, "device": "cpu", "verbose": 0,
            "distributed_heartbeat_ms": 100.0,
            "collective_timeout_s": 3.0}
    assert maybe_initialize_distributed(Config(dist))
    rank, world = process_rank_world()
    assert world == 2, world
    snap_dir = os.path.join(workdir, "snaps")

    def train(params, rounds=ROUNDS, callbacks=None):
        return lt.train(dict(params), dataset(), rounds, verbose_eval=False,
                        callbacks=callbacks, device="cpu")

    def verdict(tag, booster):
        with open(os.path.join(workdir, f"verdict_{scenario}_{rank}.txt"),
                  "w") as fh:
            fh.write(tag + "\n" + booster.model_to_string())

    if scenario in ("kill", "hang"):
        fault = (faults.kill_rank(KILL_AT, rank=1) if scenario == "kill"
                 else faults.hang_rank(HANG_AT, rank=1, hang_s=HANG_S))
        try:
            train(dict(dist, snapshot_dir=snap_dir, snapshot_freq=1),
                  callbacks=[fault])
        except DistributedAborted as e:
            # the cooperative trip: the launcher's contract, as the CLI
            print(f"worker abort: {e}", flush=True)
            os._exit(DISTRIBUTED_ABORT_EXIT_CODE)
        print("UNEXPECTED_COMPLETION", flush=True)
        return 1
    if scenario == "resume":
        from lightgbm_tpu_torch.snapshot import coordinated_resume
        found = coordinated_resume(snap_dir)
        assert found is not None, "no coordinated snapshot to resume from"
        state = found[1]
        assert int(state["rounds_done"]) == KILL_AT, state["rounds_done"]
        assert int(state["world"]["num_processes"]) == 2
        resumed = train(dict(dist, snapshot_dir=snap_dir, snapshot_freq=1))
        ref = train(dist)
        assert resumed.model_to_string() == ref.model_to_string(), \
            "the resumed model differs from the uninterrupted run's"
        verdict("RESUME_OK", resumed)
        return 0
    if scenario == "desync":
        base = dict(dist, distributed_consistency_check=1)
        try:
            train(dict(base, desync_policy="fail_fast"),
                  callbacks=[faults.corrupt_rank_state(
                      CORRUPT_AT, rank=1, field="score")])
            raise AssertionError("fail_fast did not trip on a desync")
        except lt.LightGBMError as e:
            msg = str(e)
            assert "desync" in msg, msg
            assert "field 'score' diverged on rank(s) [1]" in msg, msg
            print(f"fail_fast: {msg}", flush=True)
        healed = train(dict(base, desync_policy="resync"),
                       callbacks=[faults.corrupt_rank_state(
                           CORRUPT_AT, rank=1, field="score")])
        ref = train(dist)
        assert healed.model_to_string() == ref.model_to_string(), \
            "the resync did not bring back the clean model"
        verdict("DESYNC_OK", healed)
        return 0
    raise SystemExit(f"unknown scenario {scenario!r}")


if __name__ == "__main__":
    sys.exit(main())
