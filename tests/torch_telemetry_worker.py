"""One rank of a torch.distributed gloo group on the CPU, for
tests/test_torch_telemetry_export.py: records rank-dependent observations
in the port's telemetry registry and writes its local and reduced
snapshots.

    python tests/torch_telemetry_worker.py RANK WORLD STORE CASES OUT

STORE is the path of a file store for init_process_group, CASES a pickle
(unused), OUT the pickle this rank writes: {"local": snapshot(),
"reduced": snapshot(reduce=True)}. It imports torch and the port only,
never JAX.
"""

import datetime
import pickle
import sys

import torch


def observe(telemetry, rank):
    """The observations rank `rank` makes (shared with the test, which sums
    them)."""
    telemetry.counter("w_total", "h", labels=("k",)).labels(k="a").inc(
        rank + 1)
    telemetry.counter("w_total", "h", labels=("k",)).labels(
        k=f"r{rank}").inc()
    telemetry.gauge("w_depth", "h").set(10 * (rank + 1))
    h = telemetry.histogram("w_seconds", "h")
    for v in (1e-5 * (rank + 1), 0.3, 2.0 * rank):
        h.observe(v)


def main(argv):
    rank, world, store, _cases, out_path = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    from paddle_tpu_torch import telemetry
    telemetry.reset()
    observe(telemetry, rank)
    out = {"local": telemetry.snapshot(),
           "reduced": telemetry.snapshot(reduce=True)}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
