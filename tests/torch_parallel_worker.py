"""One rank of the port's distributed tests (not collected): joins the
group of a machine list through ``parallel/multihost.py`` on the CPU
(gloo), then runs every job of a JSON file and writes one ``.npz`` (a
grow job) or one model text (a train job) per job and rank.

    python tests/torch_parallel_worker.py <jobs.json>

``LIGHTGBM_TPU_PROCESS_ID`` numbers the rank
(``parallel.launch.run_ranks`` sets it).  The jobs:

* ``grow``: ``parallel.make_parallel_grow`` on the bins, gradients and
  hessians of an ``.npz``: the tree's arrays, the leaf ids, the deltas,
  the collective bytes and calls by kind, and the strategy's
  ``traffic_per_tree``;
* ``train``: ``lightgbm_tpu_torch.train`` of an ``.npz``'s ``X``/``y``
  with the job's params (``tree_learner``, ``num_machines`` = world);
* ``ingest``: ``parallel.ingest.binned_dataset_from_shards`` of this
  rank's ``row_partition`` of an ``.npz``'s ``X``/``y``: the encoded
  mappers and the rank's bins.

Every run also writes ``host_r<rank>.npz``: ``comm.allgather_host_array``
of ``[rank, 10 * rank]`` and ``comm.broadcast_host_bytes`` of rank 0's
payload.
"""

import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import torch  # noqa: E402

import lightgbm_tpu_torch as lt  # noqa: E402
from lightgbm_tpu_torch.config import Config  # noqa: E402
from lightgbm_tpu_torch.ops.grow import GrowParams  # noqa: E402
from lightgbm_tpu_torch.parallel import comm, make_parallel_grow  # noqa
from lightgbm_tpu_torch.parallel.multihost import (  # noqa: E402
    maybe_initialize_distributed, process_rank_world)


def run_grow(job, out_dir, rank):
    d = np.load(job["data"])
    bins = torch.from_numpy(d["bins"])
    F, N = bins.shape
    B = int(job["max_bin"])
    params = GrowParams(**job["params"])
    fn = make_parallel_grow(None, job["mode"], params,
                            top_k=int(job.get("top_k", 20)),
                            hist_reduce=job.get("hist_reduce",
                                                "reduce_scatter"))
    comm.reset_stats()
    tree, leaf, delta = fn(
        bins, torch.full((F,), B, dtype=torch.int32),
        torch.zeros(F, dtype=torch.bool), torch.ones(F, dtype=torch.bool),
        torch.from_numpy(d["g"]), torch.from_numpy(d["h"]),
        torch.ones(N, dtype=torch.float32), 0.1)
    st = comm.stats()
    traffic = fn.traffic_per_tree(F)
    kinds = sorted(set(st["bytes"]) | set(traffic))
    out = {k: np.asarray(v) for k, v in tree._asdict().items()}
    out.update(
        leaf_id=leaf.numpy(), delta=delta.numpy(),
        kinds=np.asarray(kinds),
        bytes=np.asarray([st["bytes"].get(k, 0) for k in kinds]),
        calls=np.asarray([st["calls"].get(k, 0) for k in kinds]),
        traffic_bytes=np.asarray([traffic.get(k, {}).get("bytes", 0)
                                  for k in kinds]),
        traffic_calls=np.asarray([traffic.get(k, {}).get("calls", 0)
                                  for k in kinds]))
    np.savez(os.path.join(out_dir, f"{job['name']}_r{rank}.npz"), **out)


def run_train(job, out_dir, rank):
    d = np.load(job["data"])
    b = lt.train(dict(job["params"]), lt.Dataset(d["X"], d["y"]),
                 int(job["rounds"]), device="cpu")
    with open(os.path.join(out_dir, f"{job['name']}_r{rank}.txt"),
              "w") as fh:
        fh.write(b.model_to_string())


def run_ingest(job, out_dir, rank, world):
    from lightgbm_tpu_torch.parallel import ingest
    d = np.load(job["data"])
    lo, hi = ingest.row_partition(d["X"].shape[0], world)[rank]
    ds = ingest.binned_dataset_from_shards(d["X"][lo:hi], d["y"][lo:hi],
                                           **job["kw"])
    np.savez(os.path.join(out_dir, f"{job['name']}_r{rank}.npz"),
             bins=ds.bins, used=np.asarray(ds.used_feature_map),
             label=ds.metadata.label,
             enc=np.stack([ingest.encode_mapper(m, job["kw"]["max_bin"])
                           for m in ds.mappers]))


def main() -> int:
    with open(sys.argv[1]) as fh:
        jobs = json.load(fh)
    cfg = Config({"num_machines": jobs["world"], "tree_learner": "data",
                  "machine_list_file": jobs["mlist"], "device": "cpu",
                  "time_out": 1, "distributed_heartbeat_ms": 0})
    assert maybe_initialize_distributed(cfg)
    rank, world = process_rank_world()
    assert world == jobs["world"], world
    for job in jobs.get("grow", []):
        run_grow(job, jobs["out"], rank)
    for job in jobs.get("train", []):
        run_train(job, jobs["out"], rank)
    for job in jobs.get("ingest", []):
        run_ingest(job, jobs["out"], rank, world)
    gathered = comm.allgather_host_array(np.asarray([rank, 10 * rank]))
    payload = comm.broadcast_host_bytes(
        b"resync payload of rank 0" if rank == 0 else b"", rank == 0)
    np.savez(os.path.join(jobs["out"], f"host_r{rank}.npz"),
             gathered=gathered, payload=np.frombuffer(payload, np.uint8))
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
