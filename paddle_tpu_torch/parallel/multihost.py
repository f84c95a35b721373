"""Multi-process bring-up, data sharding and checkpoint-restart (the port's
counterpart of paddle_tpu/parallel/multihost.py, whose reader and
checkpoint code it copies).

`initialize()` wires the trainer processes into one torch.distributed
process group from the reference's env conventions (PADDLE_COORDINATOR,
PADDLE_TRAINERS, PADDLE_TRAINER_ID): NCCL when there are cards, gloo on
the CPU. `shard_reader` partitions the sample stream by rank;
`CheckpointableReader` gives a stream a resumable position;
`save_checkpoint` / `load_checkpoint` write and restore persistables with
a step-metadata file, atomically, the leader (rank 0) writing the
parameters and every rank its own reader position. A sharded run's scope
holds each rank's shards (parallel/spmd.py): save the whole state with
`spmd.gather_state` before the leader writes, as `save_checkpoint` does
for a program with a mesh. `launch_local` starts a group's rank processes
on this host and reaps them all, whatever happens.
"""

from __future__ import annotations

import datetime
import json
import os
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["initialize", "shard_reader", "CheckpointableReader",
           "save_checkpoint", "load_checkpoint", "latest_checkpoint",
           "is_save_leader", "allgather_bytes", "process_index",
           "process_count", "launch_local"]


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, backend: Optional[str] = None,
               timeout_s: float = 300.0):
    """Bring up the process group (one process per rank) from the
    arguments or PADDLE_COORDINATOR (host:port of rank 0), PADDLE_TRAINERS
    and PADDLE_TRAINER_ID. The backend is NCCL when a card is visible,
    else gloo, unless `backend` names one. A no-op (False) with one process
    or no coordinator."""
    coordinator_address = coordinator_address or \
        os.environ.get("PADDLE_COORDINATOR")
    num_processes = num_processes if num_processes is not None else \
        int(os.environ.get("PADDLE_TRAINERS", "1"))
    process_id = process_id if process_id is not None else \
        int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    if num_processes <= 1 or coordinator_address is None:
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    addr = coordinator_address if "://" in coordinator_address \
        else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=addr,
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))
    os.environ.setdefault("PADDLE_TRAINER_ID", str(process_id))
    from .. import telemetry
    telemetry.counter("multihost_initialize_total",
                      "process-group bring-ups in this process").inc()
    telemetry.gauge("multihost_processes",
                    "process count of the process group").set(num_processes)
    return True


def launch_local(argv: Callable[[int], Sequence[str]], world: int, logdir,
                 timeout: float, env=None, cwd=None,
                 tail: int = 4000) -> List[Tuple[int, str]]:
    """Run the `world` rank processes of one group on this host: rank r
    runs `argv(r)` with its output in `logdir`/log<r>.txt. Waits under one
    hard timeout for the whole group, then kills every process still
    alive, whatever happened. -> (exit code, the output's last `tail`
    characters) by rank; a killed process's code is negative."""
    logdir = Path(logdir)
    logs = [open(logdir / f"log{r}.txt", "w+") for r in range(world)]
    procs = []
    try:
        for r in range(world):
            procs.append(subprocess.Popen(
                [str(a) for a in argv(r)], env=env, cwd=cwd,
                stdout=logs[r], stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        for p in procs:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out = []
    for log, p in zip(logs, procs):
        log.seek(0)
        out.append((p.returncode, log.read()[-tail:]))
        log.close()
    return out


def allgather_bytes(payload: bytes) -> list:
    """One bytes payload per process, in rank order
    (parallel/_collectives.py process_allgather_bytes)."""
    from . import _collectives
    return _collectives.process_allgather_bytes(payload)


def shard_reader(reader: Callable[[], Iterable], num_shards=None,
                 shard_id=None):
    """Process i consumes every num_shards-th sample starting at i (the Go
    master's chunk queue, go/master/service.go:106, made static)."""
    if num_shards is None:
        num_shards = process_count()
    if shard_id is None:
        shard_id = process_index()

    def sharded():
        for i, sample in enumerate(reader()):
            if i % num_shards == shard_id:
                yield sample

    return sharded


class CheckpointableReader:
    """A sample stream with a checkpointable position: (pass_id, offset)
    ride the checkpoint metadata, so a restart resumes mid-pass. Each call
    yields the rest of the current pass, then moves to the next pass at
    offset 0. The wrapped factory must yield the same stream each pass.
    Samples sitting in a prefetch buffer count as consumed: pass the
    buffer's depth as `in_flight` to state()/save_checkpoint, so a restart
    re-reads them instead of losing them."""

    def __init__(self, reader_factory: Callable[[], Iterable]):
        self.reader_factory = reader_factory
        self.pass_id = 0
        self.offset = 0

    def state(self, in_flight: int = 0) -> dict:
        off = max(0, self.offset - int(in_flight))
        return {"reader_pass": self.pass_id, "reader_offset": off}

    def restore(self, state: dict):
        self.pass_id = int(state.get("reader_pass", 0))
        self.offset = int(state.get("reader_offset", 0))

    def __call__(self):
        skip = self.offset
        for i, sample in enumerate(self.reader_factory()):
            if i < skip:
                continue
            self.offset = i + 1
            yield sample
        self.pass_id += 1
        self.offset = 0


_META = "checkpoint_meta.json"


def is_save_leader() -> bool:
    """Rank 0 writes the checkpoints (the reference elects one trainer,
    go/master/service.go:481)."""
    return process_index() == 0


def _reader_state_file(process_index_: int) -> str:
    return f"reader_state_p{process_index_}.json"


def _checkpoint_done(op: str, step, t0: float):
    from .. import telemetry
    dt = time.perf_counter() - t0
    telemetry.histogram(f"checkpoint_{op}_seconds",
                        f"wall seconds per checkpoint {op}").observe(dt)
    telemetry.log_event("checkpoint", op=op, step=step, seconds=dt)


def save_checkpoint(executor, dirname: str, step: int, main_program=None,
                    extra_meta: Optional[dict] = None, reader=None,
                    reader_in_flight: int = 0, leader_only: bool = True):
    """Persistables and step metadata, written atomically (temp file, then
    rename). Every rank writes its own reader position; the leader writes
    the parameters and the metadata. A program run sharded over a process
    group has its shards gathered into whole tensors first (every rank
    takes part). Returns True where this process wrote the checkpoint."""
    from ..framework.framework import default_main_program
    t0 = time.perf_counter()
    os.makedirs(dirname, exist_ok=True)
    program = main_program or default_main_program()
    rstate = None
    if reader is not None:
        rstate = reader.state(in_flight=reader_in_flight)
        fd, tmp = tempfile.mkstemp(dir=dirname, suffix=".rdr.tmp")
        with os.fdopen(fd, "w") as f:
            json.dump({"step": step, **rstate}, f)
        os.replace(tmp, os.path.join(dirname,
                                     _reader_state_file(process_index())))
    from . import spmd
    whole = spmd.gather_state(program)
    if dist.is_initialized() and process_count() > 1:
        dist.barrier()
    if leader_only and not is_save_leader():
        if dist.is_initialized() and process_count() > 1:
            dist.barrier()
        _checkpoint_done("save", step, t0)
        return False
    from .. import io as io_mod
    from ..executor import global_scope
    ckpt_dir = os.path.join(dirname, f"step_{step}")
    os.makedirs(ckpt_dir, exist_ok=True)
    scope = global_scope()
    saved = {n: scope.find_var(n) for n in whole}
    try:
        for n, v in whole.items():
            scope.set_var(n, v)
        io_mod.save_persistables(executor, ckpt_dir, main_program=program)
    finally:
        for n, v in saved.items():
            scope.set_var(n, v)
    meta = {"step": step, **(extra_meta or {})}
    if rstate is not None:
        meta.update(rstate)
    fd, tmp = tempfile.mkstemp(dir=dirname, suffix=".meta.tmp")
    with os.fdopen(fd, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, os.path.join(dirname, _META))
    if leader_only and dist.is_initialized() and process_count() > 1:
        dist.barrier()
    from .. import telemetry
    telemetry.counter("checkpoint_saves_total",
                      "checkpoints written by this process").inc()
    telemetry.gauge("checkpoint_last_step",
                    "step of the newest checkpoint written").set(step)
    _checkpoint_done("save", step, t0)
    return True


def latest_checkpoint(dirname: str) -> Optional[dict]:
    """Metadata of the newest complete checkpoint, or None."""
    path = os.path.join(dirname, _META)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        meta = json.load(f)
    ckpt_dir = os.path.join(dirname, f"step_{meta['step']}")
    return meta if os.path.isdir(ckpt_dir) else None


def load_checkpoint(executor, dirname: str, main_program=None,
                    reader=None) -> Optional[dict]:
    """Restore the persistables of the newest checkpoint (whole tensors: a
    sharded run narrows each to its rank's shard at its next step) and
    return its metadata, or None when there is none. With a
    CheckpointableReader, its position too: this rank's own file when it
    was written at this step, else the leader's metadata on the leader."""
    from .. import io as io_mod
    meta = latest_checkpoint(dirname)
    if meta is None:
        return None
    t0 = time.perf_counter()
    ckpt_dir = os.path.join(dirname, f"step_{meta['step']}")
    io_mod.load_persistables(executor, ckpt_dir, main_program=main_program)
    _checkpoint_done("load", meta["step"], t0)
    if reader is not None:
        rpath = os.path.join(dirname, _reader_state_file(process_index()))
        rstate = None
        if os.path.exists(rpath):
            with open(rpath) as f:
                cand = json.load(f)
            if cand.get("step") == meta["step"]:
                rstate = cand
        if rstate is None and is_save_leader():
            rstate = meta
        if rstate is not None:
            reader.restore(rstate)
    return meta
