"""Spawn-context workers for tests/test_torch_master.py: this file imports
only the standard library, numpy and the port's parallel/master.py loaded
by file path (never the paddle_tpu_torch package, and never jax), as the
JAX package's tests/_master_worker.py and tests/_elastic_worker.py do with
theirs.

`consume` drains the elastic stream, optionally crashing (os._exit)
mid-task; `train` is one elastic trainer: it leases tasks from the shared
TaskQueue, computes each task's gradient against the pass-start parameters,
writes it to an idempotent per-task file (a re-execution after a crash
overwrites the same file), and marks the task finished."""

import json
import os
import sys
import time


def load_master():
    """The port's master.py as a module of its own, by path."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "paddle_tpu_torch", "parallel",
        "master.py")
    spec = importlib.util.spec_from_file_location("_torch_master", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert "jax" not in sys.modules
    return mod


def consume(d, wid, die_after, out_q):
    """Consume the elastic stream; with `die_after`, crash after that many
    samples without finishing the task."""
    master = load_master()
    q = master.TaskQueue(d, timeout_s=2.0)
    seen = []
    for s in master.elastic_reader(q, chunk_fetch=lambda c: c,
                                   worker=wid)():
        seen.append(s)
        if die_after is not None and len(seen) >= die_after:
            os._exit(17)
    out_q.put((wid, seen))


def train(qdir, wid, data_path, params_path, grads_dir, log_path,
          slow_s=0.0, marker_path=None):
    """Drain the current pass: for each leased task, the gradient of
    0.5 * ||Xw - y||^2 over the task's sample ids, saved as
    grads_dir/task_<tid>.npy; the consumed ids logged at the end."""
    import numpy as np

    master = load_master()
    q = master.TaskQueue(qdir, timeout_s=2.0)
    blob = np.load(data_path)
    x_all, y_all = blob["x"], blob["y"]
    w = np.load(params_path)
    consumed = []
    first = True
    while True:
        leased = q.get_task(wid)
        if leased is None:
            if q.pass_done():
                break
            time.sleep(0.05)
            continue
        tid, chunks = leased
        ids = [s for chunk in chunks for s in chunk]
        if first and marker_path is not None:
            with open(marker_path, "w") as f:
                f.write(wid)
        first = False
        if slow_s:
            time.sleep(slow_s)         # a window for the parent's SIGKILL
        sel = np.asarray(ids)
        xb, yb = x_all[sel], y_all[sel]
        grad = xb.T @ (xb @ w - yb)    # a sum over samples: task-additive
        tmp = os.path.join(grads_dir, f".task_{tid}.tmp.{wid}")
        np.save(tmp, grad)
        os.replace(tmp + ".npy", os.path.join(grads_dir, f"task_{tid}.npy"))
        consumed.extend(int(i) for i in ids)
        q.task_finished(tid)
    with open(log_path, "w") as f:
        json.dump(consumed, f)
