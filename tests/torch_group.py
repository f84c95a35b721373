"""Gloo process groups of fresh interpreters for the port's multi-rank CPU
tests (tests/test_torch_ring_attention.py, tests/test_torch_parallel_ranks.py,
tests/test_torch_smoke_parallel.py).

`launch(worker, world, cases, tmp)` pickles `cases` under `tmp`, starts
`world` processes of `python worker RANK WORLD STORE CASES OUT` (STORE a
file store for init_process_group, OUT the pickle each rank writes)
through the port's `parallel.multihost.launch_local` (one hard timeout for
the whole group, every process still alive after killed, whatever
happened), and returns each rank's unpickled results and (exit code,
output tail) pairs. A rank that exits non-zero fails the caller with its
output."""

import os
import pickle
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def launch(worker, world, cases, tmp, timeout=300, env=None):
    from paddle_tpu_torch.parallel import multihost
    tmp = Path(tmp)
    cases_path, store = tmp / "cases.pkl", tmp / "store"
    with open(cases_path, "wb") as f:
        pickle.dump(cases, f)
    run_env = dict(os.environ, PYTHONPATH=f"{REPO}{os.pathsep}"
                   + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    run_env.update(env or {})
    tails = multihost.launch_local(
        lambda r: [sys.executable, worker, r, world, store, cases_path,
                   tmp / f"out{r}.pkl"], world, tmp, timeout, env=run_env,
        cwd=tmp)
    for r, (rc, tail) in enumerate(tails):
        assert rc == 0, (f"rank {r} of {world} exited {rc} (timeout "
                         f"{timeout} s for the group):\n{tail}")
    out = []
    for r in range(world):
        with open(tmp / f"out{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out, tails
