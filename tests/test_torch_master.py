"""The port's elastic task queue (paddle_tpu_torch/parallel/master.py, the
reference's go/master/service.go without etcd) held to the JAX package's
tests: the six cases of tests/test_master_queue.py (partition, leases,
the timeout requeue, the failure budget, snapshot recovery, a new pass,
and a worker that crashes mid-task) and the SIGKILL mid-pass job of
tests/test_elastic_training.py, whose workers load the port's master.py
by path and import no jax (tests/torch_master_workers.py). Both packages'
queues are also driven through one script and must leave the same
snapshot."""

import json
import multiprocessing as mp
import os
import signal
import time

import numpy as np

from paddle_tpu.parallel import master as jax_master
from paddle_tpu_torch.parallel import master
from paddle_tpu_torch.parallel.master import TaskQueue

import torch_master_workers as workers


class TestTaskQueueSemantics:
    def test_partition_idempotent_and_lease_cycle(self, tmp_path):
        q = TaskQueue(str(tmp_path), timeout_s=60)
        q.partition(list(range(10)), chunks_per_task=2)
        q.partition(list(range(999)), chunks_per_task=1)   # no-op
        assert q.stats() == {"todo": 5, "pending": 0, "done": 0,
                             "failed": 0}
        tid, chunks = q.get_task("w0")
        assert chunks == [0, 1]
        assert q.stats()["pending"] == 1
        q.task_finished(tid)
        assert q.stats()["done"] == 1
        assert not q.pass_done()

    def test_timeout_requeues_to_other_worker(self, tmp_path):
        now = [1000.0]
        q = TaskQueue(str(tmp_path), timeout_s=10, clock=lambda: now[0])
        q.partition([["a"], ["b"]])
        t1, _ = q.get_task("w0")           # w0 leases and "crashes"
        now[0] += 5
        t2, _ = q.get_task("w1")
        assert q.get_task("w1") is None    # nothing left while leased
        now[0] += 6                        # only w0's lease expires
        t3 = q.get_task("w1")
        assert t3 is not None and t3[0] == t1   # requeued, not lost
        q.task_finished(t2)
        q.task_finished(t3[0])
        assert q.pass_done()

    def test_failure_budget_discards(self, tmp_path):
        q = TaskQueue(str(tmp_path), timeout_s=60, failure_max=2)
        q.partition([["x"]])
        for _ in range(2):
            tid, _ = q.get_task()
            q.task_failed(tid)
        assert q.get_task() is None
        assert q.stats()["failed"] == 1
        assert q.pass_done()

    def test_snapshot_recovery(self, tmp_path):
        d = str(tmp_path)
        q1 = TaskQueue(d, timeout_s=60)
        q1.partition(list(range(6)), chunks_per_task=2)
        tid, _ = q1.get_task("w0")
        q1.task_finished(tid)
        q2 = TaskQueue(d, timeout_s=60)    # a "master" restart
        assert q2.stats() == {"todo": 2, "pending": 0, "done": 1,
                              "failed": 0}
        got = {tuple(q2.get_task()[1]) for _ in range(2)}
        assert got == {(2, 3), (4, 5)}

    def test_reset_pass(self, tmp_path):
        q = TaskQueue(str(tmp_path), timeout_s=60)
        q.partition([["a"], ["b"]])
        for _ in range(2):
            tid, _ = q.get_task()
            q.task_finished(tid)
        assert q.pass_done()
        q.reset_pass()
        assert q.stats()["todo"] == 2


def _script(mod, d):
    """One script of queue calls (an injected clock, an expiry, a failure,
    a finished pass and a new one) -> the snapshots after each call."""
    now = [50.0]
    q = mod.TaskQueue(d, timeout_s=5, failure_max=2, clock=lambda: now[0])
    snaps = []

    def snap():
        with open(os.path.join(d, "queue.json")) as f:
            snaps.append(json.load(f))
    q.partition([[i, i + 1] for i in range(0, 12, 2)], chunks_per_task=2)
    snap()
    t0, _ = q.get_task("a")
    t1, _ = q.get_task("b")
    q.task_failed(t1)
    snap()
    now[0] += 6                            # a's lease expires
    got = []
    while True:
        leased = q.get_task("c")
        if leased is None:
            break
        got.append(leased)
        q.task_finished(leased[0])
    snap()
    q.pass_done()
    q.reset_pass()
    snap()
    return snaps, got, list(mod.elastic_reader(
        q, chunk_fetch=lambda c: [c], worker="d")())


def test_same_snapshots_as_the_jax_queue(tmp_path):
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    assert _script(master, str(tmp_path / "t")) == \
        _script(jax_master, str(tmp_path / "j"))
    assert not hasattr(master, "torch")


class TestElasticWorkers:
    def test_crashed_worker_task_requeues_no_loss(self, tmp_path):
        d = str(tmp_path)
        q = TaskQueue(d, timeout_s=2.0)
        chunks = [[i * 10 + j for j in range(5)] for i in range(4)]
        q.partition(chunks)
        ctx = mp.get_context("spawn")
        out = ctx.Queue()
        w0 = ctx.Process(target=workers.consume, args=(d, "w0", 2, out))
        w0.start()
        w0.join(timeout=30)
        assert w0.exitcode == 17
        w1 = ctx.Process(target=workers.consume, args=(d, "w1", None, out))
        w1.start()
        w1.join(timeout=60)
        assert w1.exitcode == 0, w1.exitcode
        _, seen1 = out.get(timeout=10)
        # w1 alone covers every sample: w0's partial task requeued whole
        assert sorted(seen1) == sorted(s for c in chunks for s in c)


N, D = 64, 4
TASKS = 8
PASSES = 3
LR = 0.01


def _spawn(ctx, wid, qdir, data, params, grads, log, **kw):
    p = ctx.Process(target=workers.train,
                    args=(qdir, wid, data, params, grads, log), kwargs=kw)
    p.start()
    return p


def test_sigkill_mid_pass_job_finishes_and_matches_oracle(tmp_path):
    """tests/test_elastic_training.py's job on the port's queue: three
    workers, one SIGKILLed mid-task in pass 0, two workers for passes 1
    and 2; every sample covered every pass, duplicates only from the
    killed worker's task, the parameters the uninterrupted oracle's."""
    rng = np.random.RandomState(3)
    x = rng.randn(N, D).astype(np.float64)
    y = x @ rng.randn(D).astype(np.float64)
    data_path = str(tmp_path / "data.npz")
    np.savez(data_path, x=x, y=y)
    qdir, grads = str(tmp_path / "queue"), str(tmp_path / "grads")
    os.makedirs(qdir)
    os.makedirs(grads)
    params_path = str(tmp_path / "params.npy")
    w = np.zeros(D)
    np.save(params_path, w)
    sample_ids = [list(range(i, N, TASKS)) for i in range(TASKS)]
    chunk_of = {str(t): set(ids) for t, ids in enumerate(sample_ids)}
    q = TaskQueue(qdir, timeout_s=2.0)
    q.partition(sample_ids, chunks_per_task=1)

    ctx = mp.get_context("spawn")
    logs, killed = [], None
    for pass_no in range(PASSES):
        procs = {}
        if pass_no == 0:
            marker = str(tmp_path / "w0_started")
            log0 = str(tmp_path / f"log_w0_{pass_no}.json")
            procs["w0"] = _spawn(ctx, "w0", qdir, data_path, params_path,
                                 grads, log0, slow_s=30.0,
                                 marker_path=marker)
            logs.append(("w0", log0))
            deadline = time.time() + 60
            while not os.path.exists(marker) and time.time() < deadline:
                time.sleep(0.02)
            assert os.path.exists(marker), "w0 never leased a task"
            for wid in ("w1", "w2"):
                log = str(tmp_path / f"log_{wid}_{pass_no}.json")
                procs[wid] = _spawn(ctx, wid, qdir, data_path, params_path,
                                    grads, log)
                logs.append((wid, log))
            os.kill(procs["w0"].pid, signal.SIGKILL)
            procs["w0"].join(timeout=30)
            assert procs["w0"].exitcode == -signal.SIGKILL
            state = json.load(open(os.path.join(qdir, "queue.json")))
            held = [t for t, lease in state["pending"].items()
                    if lease["worker"] == "w0"]
            assert len(held) <= 1
            if held:
                killed = chunk_of[held[0]]
            del procs["w0"]
        else:
            for wid in ("w1", "w2"):
                log = str(tmp_path / f"log_{wid}_{pass_no}.json")
                procs[wid] = _spawn(ctx, wid, qdir, data_path, params_path,
                                    grads, log)
                logs.append((wid, log))
        for wid, p in procs.items():
            p.join(timeout=120)
            assert p.exitcode == 0, (wid, p.exitcode)
        assert q.pass_done()
        files = sorted(os.listdir(grads))
        assert files == [f"task_{t}.npy" for t in range(TASKS)], files
        w = w - LR * sum(np.load(os.path.join(grads, f)) for f in files)
        np.save(params_path, w)
        for f in files:
            os.remove(os.path.join(grads, f))
        q.reset_pass()

    w_oracle = np.zeros(D)
    for _ in range(PASSES):
        order = sorted(range(TASKS), key=lambda t: f"task_{t}.npy")
        w_oracle = w_oracle - LR * sum(
            x[sample_ids[t]].T @ (x[sample_ids[t]] @ w_oracle
                                  - y[sample_ids[t]]) for t in order)
    np.testing.assert_allclose(w, w_oracle, rtol=1e-12)
    assert 0.5 * np.mean((x @ w - y) ** 2) < 0.5 * np.mean(y ** 2)
    for pass_no in range(PASSES):
        seen = []
        for _, log in logs:
            if log.endswith(f"_{pass_no}.json") and os.path.exists(log):
                seen.extend(json.load(open(log)))
        assert set(seen) == set(range(N)), f"pass {pass_no} lost samples"
        dupes = {s for s in set(seen) if seen.count(s) > 1}
        if pass_no == 0 and killed is not None:
            assert dupes <= killed, dupes
        else:
            assert not dupes
