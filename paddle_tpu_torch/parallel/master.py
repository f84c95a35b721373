"""Elastic data dispatch (the port's copy of paddle_tpu/parallel/master.py,
which is pure stdlib): the Go master's task queue without etcd (reference
go/master/service.go — partition :106, GetTask :368, TaskFinished :411,
TaskFailed :455 with failureMax, timeout requeue :341, snapshot each
mutation :207, recover :166).

The queue state is ONE JSON snapshot in a shared directory; every mutation
happens under an exclusive flock and replaces the snapshot atomically. Any
trainer process mutates the queue directly — the "master" is the file, so
master failover is free (recover = read the snapshot), and trainer counts
can change between or during passes: a crashed trainer's leased tasks time
out and requeue to whoever asks next (at-least-once dispatch, the Go
master's guarantee).

CORRECTNESS REQUIREMENT: the queue directory's filesystem must honor flock
ACROSS the participating hosts — true for a local disk shared by same-host
processes and for NFSv4 (or NFSv3/Lustre mounted with flock enabled), NOT
for NFSv3/Lustre default "localflock" mounts.

todo/pending(leased)/done/failed states mirror service.go's taskQueues
{Todo, Pending, Done, Failed}. The module imports the standard library
alone (no torch), so a worker process can load it by file path without
importing the package.
"""

from __future__ import annotations

import fcntl
import json
import os
import time
from typing import Any, Callable, List, Optional, Tuple

__all__ = ["TaskQueue", "elastic_reader"]


class TaskQueue:
    def __init__(self, dirname: str, timeout_s: float = 60.0,
                 failure_max: int = 3, clock: Callable[[], float] = None):
        self.dirname = dirname
        self.timeout_s = timeout_s
        self.failure_max = failure_max
        self.clock = clock or time.time
        os.makedirs(dirname, exist_ok=True)
        self._snap = os.path.join(dirname, "queue.json")
        self._lock = os.path.join(dirname, "queue.lock")

    # --- locked snapshot mutation (service.go:207 snapshot per mutation) --
    def _mutate(self, fn, readonly_ok: bool = False):
        with open(self._lock, "w") as lk:
            fcntl.flock(lk, fcntl.LOCK_EX)
            state = self._read()
            expired = False
            if state is not None:
                expired = self._requeue_expired(state)
            out = fn(state)
            state = out[0] if isinstance(out, tuple) else out
            if state is not None and not (readonly_ok and not expired):
                tmp = self._snap + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(state, f)
                os.replace(tmp, self._snap)
            return out[1] if isinstance(out, tuple) else None

    def _read(self) -> Optional[dict]:
        if not os.path.exists(self._snap):
            return None
        with open(self._snap) as f:
            return json.load(f)

    def _requeue_expired(self, state) -> bool:
        """Timeout requeue (service.go:341 checkTimeoutFunc); returns
        whether anything changed."""
        now = self.clock()
        expired = [tid for tid, lease in state["pending"].items()
                   if lease["deadline"] <= now]
        for tid in expired:
            del state["pending"][tid]
            self._fail_task(state, tid)
        return bool(expired)

    def _fail_task(self, state, tid):
        """Failure budget (service.go:313 processFailedTask)."""
        state["failures"][tid] = state["failures"].get(tid, 0) + 1
        if state["failures"][tid] >= self.failure_max:
            state["failed"].append(tid)        # discarded for this pass
        else:
            state["todo"].append(tid)

    # --- public API (service.go RPC surface) ------------------------------
    def partition(self, items: List[Any], chunks_per_task: int = 1):
        """Idempotent pass initialization (service.go:106 partition): the
        first caller splits `items` into tasks; later callers are no-ops,
        so every trainer can race to call it."""
        def fn(state):
            if state is not None and state.get("epoch", 0) > 0:
                return state
            tasks = {}
            order = []
            for i in range(0, len(items), chunks_per_task):
                tid = str(len(order))
                tasks[tid] = items[i:i + chunks_per_task]
                order.append(tid)
            return {"epoch": 1, "tasks": tasks, "todo": order,
                    "pending": {}, "done": [], "failed": [],
                    "failures": {}}
        self._mutate(fn)

    def get_task(self, worker: str = "") -> Optional[Tuple[str, List[Any]]]:
        """Lease the next task (service.go:368 GetTask); None when the
        pass is drained (todo empty and nothing pending)."""
        def fn(state):
            assert state is not None, "partition() first"
            if not state["todo"]:
                return state, None
            tid = state["todo"].pop(0)
            state["pending"][tid] = {
                "worker": worker, "deadline": self.clock() + self.timeout_s}
            return state, (tid, state["tasks"][tid])
        return self._mutate(fn)

    def task_finished(self, task_id: str):
        """(service.go:411 TaskFinished)"""
        def fn(state):
            if task_id in state["pending"]:
                del state["pending"][task_id]
                state["done"].append(task_id)
            return state
        self._mutate(fn)

    def task_failed(self, task_id: str):
        """Explicit failure report (service.go:455 TaskFailed)."""
        def fn(state):
            if task_id in state["pending"]:
                del state["pending"][task_id]
                self._fail_task(state, task_id)
            return state
        self._mutate(fn)

    def pass_done(self) -> bool:
        # read-mostly: expired-lease requeue is the only mutation that can
        # matter here; skip the snapshot rewrite when nothing expired
        # (idle workers poll this in the drain-wait loop)
        def fn(state):
            return state, (state is not None and not state["todo"]
                           and not state["pending"])
        return self._mutate(fn, readonly_ok=True)

    def reset_pass(self):
        """Start the next pass over the same tasks (the reference's
        NewPass / todo re-fill)."""
        def fn(state):
            assert state is not None
            state["epoch"] += 1
            state["todo"] = sorted(state["tasks"], key=int)
            state["pending"] = {}
            state["done"] = []
            state["failed"] = []
            state["failures"] = {}
            return state
        self._mutate(fn)

    def stats(self) -> dict:
        def fn(state):
            if state is None:
                return state, {}
            return state, {k: len(state[k])
                           for k in ("todo", "pending", "done", "failed")}
        return self._mutate(fn, readonly_ok=True)


def elastic_reader(queue: TaskQueue, chunk_fetch: Callable[[Any], List],
                   worker: str = ""):
    """Sample stream driven by the task queue (go/master/client.go:244
    NextRecord): lease a task, yield its chunks' samples, mark finished;
    repeat until the pass drains. A trainer that dies mid-task simply
    never calls task_finished — the lease times out and the task requeues
    to another trainer (at-least-once, exactly the Go master's
    guarantee)."""
    def reader():
        while True:
            leased = queue.get_task(worker)
            if leased is None:
                if queue.pass_done():
                    return
                time.sleep(0.05)       # wait out other workers' leases
                continue
            tid, chunks = leased
            for chunk in chunks:
                for sample in chunk_fetch(chunk):
                    yield sample
            queue.task_finished(tid)
    return reader
