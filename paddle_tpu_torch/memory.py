"""Memory observability: device-memory accounting, peak attribution, OOM
forensics (the port's counterpart of paddle_tpu/memory.py).

The JAX package reads XLA's buffer assignment (`Compiled.memory_analysis()`
and the scheduled HLO). The port has no compiler between the program and
the card: the executor interprets the block op by op and PyTorch's caching
allocator serves every tensor. So:

1. **Static analysis** — `program_peak_liveness` walks the IR: the bytes of
   the live variables at each op (shapes from analysis/infer's rules with
   the batch dim substituted, the executor's own `liveness` drops over the
   fusion windows), giving the high-water mark and the variables live at
   it, each with the op that made it. `Executor.static_memory_analysis`
   wraps it into a `ProgramMemory` record without running a step or
   allocating a feed (feeds as meta tensors or (shape, dtype) specs). It
   does not see the allocator's traffic that no variable holds (K3's
   split-K workspace, K6's cooperative buffers, cuBLAS's workspace): it is
   an estimate beside the measurement, never a substitute for it.
2. **Measured peaks** — `Executor.measure_memory` runs one eager step on
   the card under `torch.cuda.reset_peak_memory_stats()` and records the
   peak over the bytes held before the step, plus the state the step
   reads.
3. **Live accounting** — a `MemoryTracker` records the caching
   allocator's allocated bytes and their peak (one read of its nested
   statistics) after each `Executor.run`; when the gauges are read it
   classifies state into params / opt-state / feeds / activations by scope
   metadata, takes the limit (`torch.cuda.mem_get_info`, asked once a
   card, and the process's memory fraction) and sets the
   `hbm_bytes_in_use` / `hbm_peak_bytes` / `hbm_limit_bytes` /
   `hbm_class_bytes` gauges from the last run's numbers. On the CPU it
   sums the run's tensors, as the JAX package sums `jax.live_arrays()`.
4. **What-if estimation** — `HeadroomModel` fits peak(b) = fixed +
   per_item*b from measured peaks at two or more batch sizes (the JAX
   package's least-squares arithmetic), predicts the largest batch under a
   budget, and `what_if` validates the extrapolation with a fresh
   measurement at the predicted batch.
5. **OOM forensics** — `maybe_oom_error` turns torch.cuda.OutOfMemoryError
   (the caching allocator's "CUDA out of memory") into a structured
   `errors.OOMError` carrying the byte breakdown, the largest live tensors
   named by their variables, the static record and suggestions (the
   fitted HeadroomModel's max batch among them), and drops the failed
   step's frames so that their tensors go back to the allocator.

No counterpart: `hlo_peak_liveness` reads XLA's scheduled HLO (the IR
walk above takes its place); the donation audit has nothing to audit (the
port updates state in place: `ProgramMemory.alias_bytes` holds the bytes
of state written in place, `donation_lost_bytes` stays 0); there is no
compile, so no `on_compile` hook.

Everything here is advisory: a failure of the analysis or the tracker is
caught at the executor's call sites and never fails a step.
"""

from __future__ import annotations

import gc
import math
import re
import threading
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import flags
from . import telemetry

__all__ = [
    "ProgramMemory", "MemoryTracker", "HeadroomModel",
    "analyze", "program_peak_liveness", "shape_bytes", "nbytes_of",
    "classify", "tracker", "top_live_buffers", "live_tensor_bytes",
    "is_oom", "maybe_oom_error", "what_if", "default_budget",
    "records", "latest_record", "reset", "memory_report", "bench_summary",
    "crash_section", "build_smoke", "on_run", "per_shard_param_bytes",
    "set_headroom", "headroom_for",
]


def per_shard_param_bytes(program, scope=None):
    """Per-device parameter bytes under the program's mesh, with the
    per-axis breakdown the planner's byte validation pins against.
    Delegates to parallel.per_shard_param_bytes."""
    from .parallel import per_shard_param_bytes as _impl
    return _impl(program, scope)


GiB = 1 << 30

flags.define("memory_analysis", True,
             "keep the static IR liveness record of each program analysed "
             "(memory.analyze; live-read)")
flags.define("memory_tracker", True,
             "sample the CUDA caching allocator's statistics (the run's "
             "tensors on the CPU) per Executor.run into hbm_* gauges "
             "(memory.MemoryTracker; live-read)")
flags.define("hbm_budget_bytes", 0,
             "device-memory budget for what-if headroom estimates where no "
             "card reports its capacity (0 = 16 GiB default)")


# ---------------------------------------------------------------------------
# Shape/byte helpers
# ---------------------------------------------------------------------------

_DTYPE_BYTES = {
    "pred": 1, "s2": 1, "s4": 1, "u2": 1, "u4": 1, "s8": 1, "u8": 1,
    "f8e5m2": 1, "f8e4m3": 1, "f8e4m3fn": 1, "f8e4m3b11fnuz": 1,
    "f8e5m2fnuz": 1, "f8e4m3fnuz": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "tf32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

_SHAPE_TOKEN = re.compile(r"([a-z][a-z0-9]*)\[([0-9,]*)\]")


def shape_bytes(shape_str: str) -> int:
    """Bytes of an HLO-style shape string — 'f32[128,13]{1,0}' -> 6656;
    tuple shapes '(f32[8], s32[])' sum their elements; unknown element
    types (token, opaque) count zero. Kept from the JAX package, which
    reads HLO with it, for reports written in its notation."""
    total = 0
    for dt, dims in _SHAPE_TOKEN.findall(shape_str):
        isz = _DTYPE_BYTES.get(dt)
        if isz is None:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += isz * n
    return total


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return np.dtype(dtype).itemsize


def nbytes_of(value) -> int:
    """Bytes of an array-like from shape/dtype metadata ONLY — never reads
    the data, so meta tensors and tensors of another device are safe to
    measure."""
    if value is None:
        return 0
    if isinstance(value, torch.Tensor):
        return value.nbytes            # any device, meta included
    shape = getattr(value, "shape", None)
    dtype = getattr(value, "dtype", None)
    if shape is None or dtype is None:
        arr = getattr(value, "array", None)
        if callable(arr):          # LoDTensor
            return nbytes_of(arr())
        dense = getattr(value, "to_dense", None)
        if callable(dense) and not isinstance(value, torch.Tensor):
            return nbytes_of(getattr(value, "values", None))  # SelectedRows
        try:
            a = np.asarray(value)
        except Exception:
            return 0
        shape, dtype = a.shape, a.dtype
    try:
        n = 1
        for d in shape:
            n *= int(d)
        return n * _itemsize(dtype)
    except Exception:
        return 0


def _spec_tensor(value):
    """A feed given as (shape, dtype) -> a meta tensor of that shape and
    dtype; anything with .shape/.dtype passes through."""
    if isinstance(value, tuple) and len(value) == 2 and \
            isinstance(value[0], (tuple, list, torch.Size)):
        shape, dtype = value
        if not isinstance(dtype, torch.dtype):
            from .analysis.infer import torch_dtype
            dtype = torch_dtype(np.dtype(dtype).name)
        return torch.empty(tuple(int(d) for d in shape), dtype=dtype,
                           device="meta")
    return value


# ---------------------------------------------------------------------------
# Static analysis: the IR liveness walk
# ---------------------------------------------------------------------------

_LOW_PRECISION_LEVELS = ("O2", "O3")


def program_peak_liveness(program, feed_vals: Dict[str, Any],
                          state_vals: Dict[str, Any],
                          fetch_names: Sequence[str] = (),
                          top_k: int = 8) -> Dict[str, Any]:
    """The high-water mark of the bytes of live variables over one run of
    `program`'s global block, in the executor's order: the state and the
    feeds live from the start, each op's (or fusion window's) outputs
    appear when it runs, and each temporary goes after its last reader
    (executor.liveness over fusion.plan's windows, as `_run_block` drops
    them), unless it is fetched, a persistable output or state.

    Shapes are analysis/infer's, re-derived from the feeds' shapes (the
    batch substituted for -1); a var whose shape stays unknown counts its
    declared shape with the batch for -1. Under AMP O2/O3 an f32
    temporary counts 2 bytes an element (the lowerings compute in bf16);
    state keeps its own dtype. Returns {peak_bytes, peak_pos (the op index
    whose unit ends at the peak), n_instructions (ops), live_at_peak,
    argument_bytes, output_bytes, alias_bytes, top: [{var, bytes, op}]}."""
    from .analysis import infer as infer_mod
    from .executor import liveness
    from .ops import fusion

    feed_vals = {n: _spec_tensor(v) for n, v in feed_vals.items()}
    feed_shapes = {n: tuple(int(d) for d in v.shape)
                   for n, v in feed_vals.items() if hasattr(v, "shape")}
    clone = infer_mod.infer_block(program, feed_shapes)
    descs = clone.global_block().desc.vars
    batch = next((s[0] for s in feed_shapes.values() if s), 1)
    low = (getattr(program, "_amp_dtype", None) is not None
           and getattr(program, "_amp_level", "O1") in _LOW_PRECISION_LEVELS)

    def var_bytes(name: str) -> int:
        if name in state_vals:
            return nbytes_of(state_vals[name])
        if name in feed_vals:
            return nbytes_of(feed_vals[name])
        v = descs.get(name)
        if v is None or v.shape is None:
            return 0
        dt = infer_mod.torch_dtype(v.dtype)
        if dt is None:
            return 0
        size = dt.itemsize
        if low and dt == torch.float32 and not v.persistable:
            size = 2
        return size * math.prod(batch if d == -1 else max(int(d), 0)
                                for d in v.shape)

    block = program.global_block()
    ops = block.ops
    groups = fusion.plan(program) or {}
    drops = liveness(ops, groups)
    persistable = {n for n, v in block.desc.vars.items() if v.persistable}
    written = {n for op in ops for n in op.output_arg_names}
    persist_out = written & persistable
    keep = set(state_vals) | set(fetch_names) | persist_out
    live: Dict[str, int] = {}
    made_by: Dict[str, str] = {}
    for n in list(state_vals) + list(feed_vals):
        live[n] = var_bytes(n)
        made_by[n] = "state" if n in state_vals else "feed"
    argument = sum(live.values())
    running = argument

    def snapshot():
        rows = sorted(live.items(), key=lambda kv: -kv[1])[:top_k]
        return [{"var": n, "bytes": b, "op": made_by.get(n, "?")}
                for n, b in rows if b]

    peak, peak_pos, n_live, top = running, -1, len(live), snapshot()
    i = 0
    while i < len(ops):
        g = groups.get(i)
        members, end = (g.members, g.end) if g is not None else \
            ((ops[i],), i + 1)
        for m in members:
            if m.type in ("feed", "fetch"):
                continue
            for n in m.output_arg_names:
                if n not in live:
                    b = var_bytes(n)
                    live[n] = b
                    made_by[n] = m.type
                    running += b
        if running > peak:
            peak, peak_pos, n_live, top = running, end - 1, len(live), \
                snapshot()
        for n in drops.get(end - 1, ()):
            if n not in keep and n in live:
                running -= live.pop(n)
        i = end
    alias = sum(var_bytes(n) for n in persist_out if n in state_vals)
    output = sum(var_bytes(n) for n in set(fetch_names) | persist_out)
    return {"peak_bytes": int(peak), "peak_pos": peak_pos,
            "n_instructions": len(ops),
            "live_at_peak": n_live, "argument_bytes": int(argument),
            "output_bytes": int(output), "alias_bytes": int(alias),
            "top": top}


class ProgramMemory:
    """One program's memory footprint at one signature: the static IR walk
    (`analyze`) or a measured step (`Executor.measure_memory`), in the JAX
    package's record shape."""

    __slots__ = ("program", "place", "signature", "argument_bytes",
                 "output_bytes", "temp_bytes", "alias_bytes",
                 "generated_code_bytes", "donated_bytes",
                 "donation_lost_bytes", "peak", "source")

    def __init__(self, program="?", place="?", signature=None,
                 source="static"):
        self.program = program
        self.place = place
        self.signature = signature
        self.argument_bytes = 0
        self.output_bytes = 0
        self.temp_bytes = 0
        self.alias_bytes = 0
        self.generated_code_bytes = 0
        self.donated_bytes = 0
        self.donation_lost_bytes = 0
        self.peak: Optional[Dict] = None
        self.source = source

    @property
    def total_bytes(self) -> int:
        """High-water estimate: arguments + (non-aliased) outputs +
        temporaries (+ code, 0 here)."""
        return (self.argument_bytes + self.output_bytes - self.alias_bytes
                + self.temp_bytes + self.generated_code_bytes)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "program": self.program, "place": self.place,
            "signature": ([list(s) for s in self.signature]
                          if self.signature else None),
            "source": self.source,
            "argument_bytes": self.argument_bytes,
            "output_bytes": self.output_bytes,
            "temp_bytes": self.temp_bytes,
            "alias_bytes": self.alias_bytes,
            "generated_code_bytes": self.generated_code_bytes,
            "donated_bytes": self.donated_bytes,
            "donation_lost_bytes": self.donation_lost_bytes,
            "total_bytes": self.total_bytes,
            "peak": self.peak,
        }


_LOCK = threading.Lock()
_RECORDS: Dict[str, ProgramMemory] = {}   # prog_label -> latest record
_MAX_RECORDS = 256


def _remember(rec: ProgramMemory):
    with _LOCK:
        _RECORDS.pop(rec.program, None)
        _RECORDS[rec.program] = rec
        while len(_RECORDS) > _MAX_RECORDS:
            _RECORDS.pop(next(iter(_RECORDS)))


def records() -> List[ProgramMemory]:
    with _LOCK:
        return list(_RECORDS.values())


def latest_record(prog_label: str) -> Optional[ProgramMemory]:
    with _LOCK:
        return _RECORDS.get(prog_label)


def _signature(feed_vals) -> List[Tuple]:
    return [(n, tuple(int(d) for d in getattr(v, "shape", ())),
             str(getattr(v, "dtype", "?")).replace("torch.", ""))
            for n, v in sorted(feed_vals.items())]


def analyze(program, feed_vals: Dict[str, Any], state_vals: Dict[str, Any],
            fetch_names: Sequence[str] = (), *, program_label="?",
            place="?", top_k: int = 8) -> ProgramMemory:
    """The static record of one run of `program` on feeds of these shapes
    (meta tensors or (shape, dtype) specs are enough; nothing is
    allocated): program_peak_liveness's high-water mark as a
    ProgramMemory, kept in records() and published as the
    `memory_analysis` event."""
    feed_vals = {n: _spec_tensor(v) for n, v in feed_vals.items()}
    walk = program_peak_liveness(program, feed_vals, state_vals,
                                 fetch_names, top_k=top_k)
    rec = ProgramMemory(program=program_label, place=place,
                        signature=_signature(feed_vals), source="static")
    rec.argument_bytes = walk["argument_bytes"]
    rec.output_bytes = walk["output_bytes"]
    rec.alias_bytes = walk["alias_bytes"]
    rec.donated_bytes = walk["alias_bytes"]
    rec.temp_bytes = max(walk["peak_bytes"] - rec.argument_bytes
                         - (rec.output_bytes - rec.alias_bytes), 0)
    rec.peak = {k: walk[k] for k in ("peak_bytes", "peak_pos",
                                      "n_instructions", "live_at_peak",
                                      "top")}
    if flags.get("memory_analysis"):
        _remember(rec)
        telemetry.log_event(
            "memory_analysis", program=rec.program, place=rec.place,
            source=rec.source, argument_bytes=rec.argument_bytes,
            output_bytes=rec.output_bytes, temp_bytes=rec.temp_bytes,
            alias_bytes=rec.alias_bytes, total_bytes=rec.total_bytes,
            peak_bytes=walk["peak_bytes"])
    return rec


def measured(program_label, place, feed_vals, state_bytes: int,
             step_bytes: int, feed_bytes: int) -> ProgramMemory:
    """The record of a measured step: the state it read (`state_bytes`,
    already on the card) as arguments with the feeds, and the allocator's
    peak over the bytes held before the step, less the feeds' copies, as
    temporaries (Executor.measure_memory)."""
    rec = ProgramMemory(program=program_label, place=place,
                        signature=_signature(feed_vals), source="measured")
    rec.argument_bytes = int(state_bytes) + int(feed_bytes)
    rec.temp_bytes = max(int(step_bytes) - int(feed_bytes), 0)
    rec.peak = {"peak_bytes": rec.total_bytes}
    _remember(rec)
    telemetry.log_event(
        "memory_measured", program=program_label, place=place,
        argument_bytes=rec.argument_bytes, temp_bytes=rec.temp_bytes,
        total_bytes=rec.total_bytes)
    return rec


# ---------------------------------------------------------------------------
# Live accounting
# ---------------------------------------------------------------------------

def live_tensor_bytes(tensors) -> int:
    """Bytes of distinct tensors (by identity) — the CPU fallback of the
    tracker, over a run's state and feeds."""
    seen, total = set(), 0
    for t in tensors:
        if id(t) in seen:
            continue
        seen.add(id(t))
        total += nbytes_of(t)
    return total


def _on_device(t: torch.Tensor, device) -> bool:
    if device is None:
        return t.device.type != "meta"
    device = torch.device(device)
    return t.device.type == device.type and (
        device.index is None or t.device.index in (None, device.index))


def top_live_buffers(limit: int = 10,
                     names_by_id: Optional[Dict[int, str]] = None,
                     device=None) -> List[Dict[str, Any]]:
    """The largest live tensors on `device` (every non-meta device when
    None), one per storage, named where the caller maps tensor identity
    back to scope, feed or block variables (OOM forensics). Found through
    the garbage collector's objects: a tensor only C++ holds does not
    show."""
    names_by_id = names_by_id or {}
    best: Dict[int, Dict[str, Any]] = {}
    try:
        objs = gc.get_objects()
    except Exception:
        return []
    for o in objs:
        try:
            # type(), not isinstance(): isinstance asks __class__, which
            # some of the collector's objects (deprecated aliases) warn on
            if not issubclass(type(o), torch.Tensor) or \
                    not _on_device(o, device):
                continue
            st = o.untyped_storage()
            key = st.data_ptr()
            nb = int(st.nbytes())
            name = names_by_id.get(id(o))
            cur = best.get(key)
            if cur is None or (name is not None and cur["name"] is None):
                best[key] = {"nbytes": nb,
                             "shape": [int(d) for d in o.shape],
                             "dtype": str(o.dtype).replace("torch.", ""),
                             "name": name}
        except Exception:
            continue
    rows = sorted(best.values(), key=lambda r: -r["nbytes"])
    return rows[:limit]


_CLASS_CACHE: Dict[Tuple, Tuple] = {}


def classify(program, state_vals: Dict[str, Any],
             feed_vals: Dict[str, Any]) -> Dict[str, int]:
    """Split a run's inputs into params / opt_state / feeds bytes by scope
    metadata: parameters are the block's Parameter vars, every other
    persistable state (optimizer accumulators, LR vars, batch-norm
    statistics) is opt_state. Bytes come from shapes and dtypes only.

    Bytes are PER-DEVICE: vars sharded under the program's mesh divide by
    their shard factor (parallel/embedding.state_shard_factor), rounded
    up, so the breakdown and HeadroomModel inputs describe what one device
    holds."""
    key = (id(program), getattr(program, "_version", 0))
    hit = _CLASS_CACHE.get(key)
    if hit is None or hit[0] is not program:
        params = {p.name for p in program.global_block().all_parameters()}
        factors: Dict[str, int] = {}
        if getattr(program, "_mesh", None) is not None and (
                getattr(program, "_param_shardings", None)
                or getattr(program, "_sharded_tables", None)):
            from .parallel import embedding as embedding_mod
            for n in state_vals:
                f = embedding_mod.state_shard_factor(program, n)
                if f > 1:
                    factors[n] = f
        _CLASS_CACHE[key] = (program, params, factors)
        while len(_CLASS_CACHE) > 64:
            _CLASS_CACHE.pop(next(iter(_CLASS_CACHE)))
        hit = _CLASS_CACHE[key]
    params, factors = hit[1], hit[2]
    out = {"params": 0, "opt_state": 0, "feeds": 0}
    for n, v in state_vals.items():
        b = nbytes_of(v)
        f = factors.get(n, 1)
        if f > 1:
            b = -(-b // f)
        out["params" if n in params else "opt_state"] += b
    for v in feed_vals.values():
        out["feeds"] += nbytes_of(v)
    return out


_TOTALS: Dict[int, int] = {}


def _device_total(device) -> int:
    """The card's capacity as this process may use it: total memory (asked
    of CUDA once a card) times the per-process fraction where one
    was set."""
    idx = torch.device(device).index
    if idx is None:
        idx = torch.cuda.current_device()
    total = _TOTALS.get(idx)
    if total is None:
        total = _TOTALS[idx] = int(torch.cuda.mem_get_info(idx)[1])
    frac = getattr(torch.cuda, "get_per_process_memory_fraction", None)
    if frac is not None:
        try:
            total = int(total * min(float(frac(idx)), 1.0))
        except Exception:
            pass
    return total


def _allocator_stats(device) -> Optional[Dict[str, int]]:
    """{bytes_in_use, peak_bytes_in_use, bytes_reserved, bytes_limit} of
    the caching allocator on a CUDA `device`, else None. Read from the
    allocator's nested statistics: torch.cuda.memory_stats would flatten
    all of them in Python first."""
    if device is None or torch.device(device).type != "cuda":
        return None
    s = torch.cuda.memory_stats_as_nested_dict(device)
    alloc = s.get("allocated_bytes", {}).get("all", {})
    return {"bytes_in_use": int(alloc.get("current", 0)),
            "peak_bytes_in_use": int(alloc.get("peak", 0)),
            "bytes_reserved": int(s.get("reserved_bytes", {})
                                  .get("all", {}).get("current", 0)),
            "bytes_limit": _device_total(device)}


class MemoryTracker:
    """Per-run device-memory sampler: the caching allocator's allocated
    bytes and their peak on a card; on the CPU the run's own tensors
    summed. The per-run hook (`note`, from `on_run`) keeps those numbers
    and a running peak; the hbm_* gauges, the limit and the classes are
    published when they are read (`flush`: at telemetry.snapshot(),
    prometheus_text() and read_gauge(), a flight record, a crash report,
    or `last`), from the last run's numbers, so read at any moment they
    hold what a full sample after every run would have given."""

    def __init__(self):
        self.peak_bytes = 0
        self._last: Dict[str, Any] = {}
        self._pending = None
        # (gauge, label values) -> (its family, its series): a flush sets
        # seven series, and resolving each by its labels costs more than
        # the allocator's read
        self._series: Dict[Tuple, Tuple] = {}

    @property
    def last(self) -> Dict[str, Any]:
        self.flush()
        return self._last

    @last.setter
    def last(self, value: Dict[str, Any]):
        self._pending = None
        self._last = value

    def _set(self, name: str, help_str: str, value, **labels):
        fam = telemetry.gauge(name, help_str, labels=tuple(labels))
        key = (name,) + tuple(labels.values())
        hit = self._series.get(key)
        if hit is None or hit[0] is not fam:
            hit = self._series[key] = (fam, fam.labels(**labels))
        hit[1].set(value)

    def note(self, device, program: Optional[str], classes, feed_bytes,
             in_use: int, dev_peak: int, reserved: Optional[int],
             source: str):
        """The per-run record: a few numbers, no gauge touched."""
        self.peak_bytes = max(self.peak_bytes, dev_peak, in_use)
        self._pending = (device, program, classes, feed_bytes, in_use,
                         reserved, source,
                         telemetry.registry().generation())

    def flush(self):
        """Publish the last run's record into the gauges and `last`."""
        p = self._pending
        if p is None:
            return
        self._pending = None
        device, program, classes, feed_bytes, in_use, reserved, source, \
            gen = p
        # a registry cleared since the run (telemetry.reset) gets no gauge
        # of it, as one set at the run would have been cleared
        publish = gen == telemetry.registry().generation()
        if source == "device":
            limit = _device_total(device)
        else:
            limit = int(flags.get("hbm_budget_bytes") or 0)
        label = str(device) if device is not None else "?"
        cls = {}
        if classes is not None:
            cls = dict(classes, feeds=feed_bytes)
            cls["activations"] = max(in_use - sum(cls.values()), 0)
        if publish:
            self._set("hbm_bytes_in_use", "device memory in use after the "
                      "last run (the allocator's, or the run's tensors on "
                      "the CPU)", in_use, device=label)
            self._set("hbm_peak_bytes", "high-water device memory across "
                      "the process", self.peak_bytes, device=label)
            if limit:
                self._set("hbm_limit_bytes", "device memory capacity (the "
                          "card's, or the hbm_budget_bytes flag)", limit,
                          device=label)
            for kind, v in cls.items():
                self._set("hbm_class_bytes", "live bytes by class: "
                          "params/opt_state/feeds/activations", v,
                          device=label, kind=kind)
        self._last = {"device": label, "source": source, "program": program,
                      "bytes_in_use": in_use, "peak_bytes": self.peak_bytes,
                      "limit_bytes": limit, "classes": cls}
        if reserved is not None:
            self._last["bytes_reserved"] = reserved

    def sample(self, device=None, program: Optional[str] = None,
               classes: Optional[Dict[str, int]] = None,
               tensors=()) -> Dict[str, Any]:
        """One full sample now: the allocator's statistics on a card (else
        `tensors` summed), published at once. `classes` includes the
        feeds."""
        stats = None
        try:
            stats = _allocator_stats(device)
        except Exception:
            stats = None
        feeds = None
        if classes is not None:
            classes = dict(classes)
            feeds = classes.pop("feeds", 0)
        if stats:
            self.note(device, program, classes, feeds, stats["bytes_in_use"],
                      stats["peak_bytes_in_use"], stats["bytes_reserved"],
                      "device")
        else:
            in_use = live_tensor_bytes(tensors)
            self.note(device, program, classes, feeds, in_use, in_use, None,
                      "tensors")
        return self.last


_TRACKER = MemoryTracker()


def tracker() -> MemoryTracker:
    return _TRACKER


def reset():
    """Forget records, fitted models and tracker state (test isolation)."""
    with _LOCK:
        _RECORDS.clear()
        _HEADROOM.clear()
    _CLASS_CACHE.clear()
    _RUN_CLASSES.clear()
    _TRACKER.peak_bytes = 0
    _TRACKER.last = {}


# ---------------------------------------------------------------------------
# Executor hook
# ---------------------------------------------------------------------------

_RUN_CLASSES: Dict[Tuple, Tuple] = {}


def _allocated(device) -> Tuple[int, int, int]:
    """(allocated bytes, their peak, reserved bytes) of the caching
    allocator on a CUDA `device`, from one read of its nested statistics:
    torch.cuda.memory_allocated and max_memory_allocated each flatten all
    of them in Python (memory_stats), the cost this hook avoids."""
    s = torch.cuda.memory_stats_as_nested_dict(device)
    alloc = s.get("allocated_bytes", {}).get("all", {})
    return (int(alloc.get("current", 0)), int(alloc.get("peak", 0)),
            int(s.get("reserved_bytes", {}).get("all", {}).get("current", 0)))


def on_run(exe, program, prog_label, feed_vals, state_vals) -> None:
    """Executor hook after every run: the tracker's per-run record, gated
    on the live memory_tracker flag. On a card it reads the allocator's
    allocated bytes and their peak; on the CPU it sums the run's tensors.
    The state's classes are classified once per program version and state
    count (a step changes no state shape) and the feeds summed each run;
    the gauges, the limit and the classes publish when read
    (MemoryTracker.flush)."""
    if not flags.get("memory_tracker"):
        return None
    key = (id(program), getattr(program, "_version", 0), len(state_vals))
    hit = _RUN_CLASSES.get(key)
    if hit is None or hit[0] is not program:
        try:
            cls = classify(program, state_vals, {})
        except Exception:
            cls = None
        hit = _RUN_CLASSES[key] = (program, cls)
        while len(_RUN_CLASSES) > 64:
            _RUN_CLASSES.pop(next(iter(_RUN_CLASSES)))
    feed_bytes = None
    if hit[1] is not None:
        feed_bytes = sum(nbytes_of(v) for v in feed_vals.values())
    device = getattr(exe, "device", None)
    if device is not None and torch.device(device).type == "cuda":
        in_use, peak, reserved = _allocated(device)
        _TRACKER.note(device, prog_label, hit[1], feed_bytes, in_use, peak,
                      reserved, "device")
    else:
        in_use = live_tensor_bytes(list(state_vals.values())
                                   + list(feed_vals.values()))
        _TRACKER.note(device, prog_label, hit[1], feed_bytes, in_use, in_use,
                      None, "tensors")
    return None


telemetry.add_read_hook(_TRACKER.flush)


# ---------------------------------------------------------------------------
# OOM forensics
# ---------------------------------------------------------------------------

_OOM_PAT = re.compile(r"CUDA out of memory|RESOURCE_EXHAUSTED|"
                      r"[Oo]ut of memory|[Aa]llocation .* exceeds|"
                      r"OOM when allocating")


def _chain(exc: BaseException):
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        yield exc
        exc = exc.__cause__ or exc.__context__


def is_oom(exc: BaseException) -> bool:
    """Did the card run out of memory? torch.cuda.OutOfMemoryError, or the
    caching allocator's message, anywhere in the exception's chain (a
    capture that failed on an allocation may end in another error)."""
    for e in _chain(exc):
        if isinstance(e, torch.cuda.OutOfMemoryError) or \
                bool(_OOM_PAT.search(str(e))):
            return True
    return False


def _fmt_bytes(n) -> str:
    if n is None:
        return "?"
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:.0f}{unit}" if unit == "B" else f"{n:.2f}{unit}"
        n /= 1024.0
    return f"{n:.2f}TiB"


_HEADROOM: Dict[str, Tuple["HeadroomModel", int]] = {}


def set_headroom(prog_label: str, model: "HeadroomModel",
                 budget_bytes: int):
    """Remember `model` fitted for a program (what_if does it when given
    the program's label): an OOM of that program suggests the model's
    largest batch under `budget_bytes`."""
    with _LOCK:
        _HEADROOM.pop(prog_label, None)
        _HEADROOM[prog_label] = (model, int(budget_bytes))


def headroom_for(prog_label: str):
    """(model, budget) fitted for the program, else the latest fit, else
    None."""
    with _LOCK:
        hit = _HEADROOM.get(prog_label)
        if hit is None and _HEADROOM:
            hit = next(reversed(_HEADROOM.values()))
    return hit


def maybe_oom_error(exe, program, prog_label, exc, feed_vals=None,
                    state_vals=None):
    """If `exc` is the card running out of memory, the structured
    errors.OOMError that should replace it (breakdown, largest live
    tensors, the static record, suggestions); otherwise None. The failed
    step's finished frames are cleared afterwards, so the tensors they
    held go back to the allocator once the caller drops the error. Never
    raises: forensics that fail must not mask the original error."""
    from .errors import OOMError
    if isinstance(exc, OOMError) or not is_oom(exc):
        return None
    try:
        return _build_oom_error(exe, program, prog_label, exc,
                                feed_vals or {}, state_vals or {})
    except Exception:
        return None
    finally:
        _drop_frames(exc)


def _drop_frames(exc):
    """Clear the locals of every finished frame of the exception chain's
    tracebacks (a lowering's and the interpreter's frames hold the step's
    tensors) and the step's environment the executor pinned on it."""
    for e in _chain(exc):
        e.__dict__.pop("step_env", None)
        try:
            traceback.clear_frames(e.__traceback__)
        except Exception:
            pass


def _step_env_names(exc) -> Dict[int, str]:
    """id(tensor) -> variable name over the environment of the failed step
    (`step_env`, which the executor pins on an exception of its
    interpreter: an eager step's, a capture's, a served program's). Frame
    locals are not read: a snapshot of an executing
    frame's locals would hold the exception in a cycle."""
    names: Dict[int, str] = {}
    for e in _chain(exc):
        env = e.__dict__.get("step_env")
        if isinstance(env, dict):
            for n, v in env.items():
                if isinstance(v, torch.Tensor):
                    names.setdefault(id(v), n)
    return names


def _build_oom_error(exe, program, prog_label, exc, feed_vals, state_vals):
    from .errors import OOMError
    telemetry.counter(
        "oom_errors_total", "device OOMs surfaced as errors.OOMError",
        labels=("program",)).labels(program=prog_label).inc()

    breakdown: Dict[str, Any] = {}
    try:
        breakdown.update(classify(program, state_vals, feed_vals))
    except Exception:
        pass
    device = getattr(exe, "device", None)
    stats = None
    try:
        stats = _allocator_stats(device)
    except Exception:
        stats = None
    if stats:
        breakdown.update(stats)
    else:
        breakdown["bytes_in_use"] = live_tensor_bytes(
            list(state_vals.values()) + list(feed_vals.values()))

    rec = latest_record(prog_label)
    if rec is None or rec.source != "static":
        try:
            rec = analyze(program, feed_vals, state_vals,
                          program_label=prog_label, place=str(device))
        except Exception:
            pass
    params = {p.name for p in program.global_block().all_parameters()}
    kinds: Dict[str, str] = {}
    names_by_id = _step_env_names(exc)
    for n in names_by_id.values():
        kinds[n] = "activation"
    for n, v in state_vals.items():
        names_by_id[id(v)] = n
        kinds[n] = "param" if n in params else "opt_state"
    for n, v in feed_vals.items():
        names_by_id[id(v)] = n
        kinds[n] = "feed"
    rows = top_live_buffers(1 << 30, names_by_id, device)
    top = rows[:10]
    # the model's own state and input beside the activations: the largest
    # scope variable and the largest feed, when not among the ten
    for want in (("param", "opt_state"), ("feed",)):
        if not any(kinds.get(r["name"]) in want for r in top):
            extra = next((r for r in rows[10:]
                          if kinds.get(r["name"]) in want), None)
            if extra is not None:
                top.append(extra)
    for r in top:
        r["kind"] = kinds.get(r["name"])

    suggestions: List[str] = []
    fitted = headroom_for(prog_label)
    if fitted is not None:
        model, budget = fitted
        bmax = model.max_batch(budget)
        suggestions.append(
            f"the fitted HeadroomModel (fixed {_fmt_bytes(model.fixed_bytes)}"
            f", {_fmt_bytes(model.per_item_bytes)} per item) predicts "
            f"max_batch={bmax} under {_fmt_bytes(budget)}: run at batch "
            f"{bmax} or less")
    if getattr(program, "_amp_dtype", None) is None:
        suggestions.append(
            "enable mixed precision (amp.decorate, level O2) to roughly "
            "halve activation bytes")
    if rec is not None and rec.temp_bytes > max(rec.argument_bytes, 1):
        suggestions.append(
            f"temporaries dominate ({_fmt_bytes(rec.temp_bytes)} live at "
            f"the static peak vs {_fmt_bytes(rec.argument_bytes)} of state "
            f"and feeds) — reduce the batch or shard the model "
            f"(parallel.shard_all_params_zero)")
    suggestions.append(
        "reduce the batch size — memory.what_if over "
        "Executor.measure_memory predicts the largest batch that fits")

    lines = [f"out of device memory running program '{prog_label}'",
             f"  backend error: {str(exc).splitlines()[0][:300]}"]
    cls = {k: v for k, v in breakdown.items()
           if k in ("params", "opt_state", "feeds")}
    if cls:
        lines.append("  live breakdown: " + ", ".join(
            f"{k}={_fmt_bytes(v)}" for k, v in cls.items()))
    if stats:
        lines.append(f"  allocator: in use {_fmt_bytes(stats['bytes_in_use'])}"
                     f", reserved {_fmt_bytes(stats['bytes_reserved'])}, "
                     f"limit {_fmt_bytes(stats['bytes_limit'])}")
    if rec is not None:
        lines.append(
            f"  static analysis: args={_fmt_bytes(rec.argument_bytes)} "
            f"out={_fmt_bytes(rec.output_bytes)} "
            f"temp={_fmt_bytes(rec.temp_bytes)} "
            f"total={_fmt_bytes(rec.total_bytes)}")
    for s in suggestions:
        lines.append(f"  suggestion: {s}")
    lines.append("  (CUDA out of memory)")
    return OOMError("\n".join(lines), program=prog_label,
                    breakdown=breakdown, top_buffers=top,
                    donation_lost_bytes=0,
                    analysis=rec.to_dict() if rec else None,
                    suggestions=suggestions,
                    device=str(device) if device is not None else None)


# ---------------------------------------------------------------------------
# What-if headroom estimation
# ---------------------------------------------------------------------------

class HeadroomModel:
    """peak(b) = fixed_bytes + per_item_bytes * b, least-squares fit from
    measured peaks at >= 2 batch sizes (the JAX package's model and
    arithmetic). Linear in the batch because every per-sample buffer
    (feeds, activations, logits) scales with b while params/opt-state do
    not; the allocator's rounding and the kernels' workspaces keep it only
    approximately linear — which is why what_if() validates the
    extrapolation with a measurement at the predicted batch.

    For sharded programs both inputs are per-device numbers (classify()
    divides sharded state by its shard factor), so max_batch() answers
    against one device's budget, the one that runs out."""

    def __init__(self, fixed_bytes: float, per_item_bytes: float,
                 points: Optional[Sequence[Tuple[int, int]]] = None):
        self.fixed_bytes = float(fixed_bytes)
        self.per_item_bytes = float(per_item_bytes)
        self.points = [(int(b), int(y)) for b, y in (points or [])]

    @classmethod
    def fit(cls, points: Sequence[Tuple[int, int]]) -> "HeadroomModel":
        pts = sorted({(int(b), int(y)) for b, y in points})
        if len({b for b, _ in pts}) < 2:
            raise ValueError("HeadroomModel.fit needs analyses at >= 2 "
                             "distinct batch sizes")
        xs = [b for b, _ in pts]
        ys = [y for _, y in pts]
        mx = sum(xs) / len(xs)
        my = sum(ys) / len(ys)
        var = sum((x - mx) ** 2 for x in xs)
        slope = sum((x - mx) * (y - my) for x, y in pts) / var
        slope = max(slope, 0.0)
        fixed = max(my - slope * mx, 0.0)
        return cls(fixed, slope, pts)

    def predict(self, batch: int) -> int:
        return int(round(self.fixed_bytes + self.per_item_bytes * batch))

    def max_batch(self, budget_bytes: int) -> Optional[int]:
        """Largest batch fitting the budget; None when the footprint does
        not grow with the batch (nothing to bound)."""
        if self.per_item_bytes <= 0:
            return None
        if budget_bytes <= self.fixed_bytes:
            return 0
        return int((budget_bytes - self.fixed_bytes) // self.per_item_bytes)

    def headroom(self, budget_bytes: int, batch: int) -> int:
        """Device bytes left under `budget_bytes` after the predicted peak
        at `batch` — what is free for extra resident state (the hot-row
        cache sizes its slab from it: emb_cache.budget_from_headroom).
        Clamped at 0."""
        return max(0, int(budget_bytes) - self.predict(batch))

    def to_dict(self) -> Dict[str, Any]:
        return {"fixed_bytes": int(self.fixed_bytes),
                "per_item_bytes": round(self.per_item_bytes, 2),
                "points": self.points}


def default_budget(device=None) -> int:
    """Budget for headroom estimates: the card's memory (as the process
    may use it; `device`, else the current card when there is one), else
    the hbm_budget_bytes flag, else 16 GiB (the JAX package's default)."""
    try:
        if device is None and torch.cuda.is_available():
            device = torch.device("cuda", torch.cuda.current_device())
        if device is not None and torch.device(device).type == "cuda":
            return _device_total(device)
    except Exception:
        pass
    v = int(flags.get("hbm_budget_bytes") or 0)
    return v if v > 0 else 16 * GiB


def what_if(measure: Callable[[int], ProgramMemory],
            batches: Sequence[int] = (8, 32),
            budget_bytes: Optional[int] = None,
            validate: bool = True,
            max_validate_batch: Optional[int] = None,
            program: Optional[str] = None) -> Dict[str, Any]:
    """'Will batch B fit?' — fit a HeadroomModel from `measure(b)` at
    `batches`, predict the max batch under `budget_bytes`, then validate
    the model with `measure` AT the predicted batch and report the
    relative error. `measure(b)` returns the ProgramMemory of the program
    at batch b — a closure over Executor.measure_memory (or, for the IR
    estimate, Executor.static_memory_analysis). Given `program` (its
    label), the fit is remembered for that program's OOM suggestions."""
    points = []
    for b in batches:
        points.append((int(b), measure(int(b)).total_bytes))
    model = HeadroomModel.fit(points)
    budget = int(budget_bytes) if budget_bytes else default_budget()
    if program is not None:
        set_headroom(program, model, budget)
    bmax = model.max_batch(budget)
    out: Dict[str, Any] = {"model": model.to_dict(),
                           "budget_bytes": budget, "max_batch": bmax,
                           "points": points}
    if validate and bmax:
        vb = bmax if max_validate_batch is None else min(
            bmax, int(max_validate_batch))
        measured_bytes = measure(vb).total_bytes
        predicted = model.predict(vb)
        out["validate_batch"] = vb
        out["predicted_bytes"] = predicted
        out["measured_bytes"] = measured_bytes
        out["rel_err"] = abs(predicted - measured_bytes) / max(
            measured_bytes, 1)
    return out


# ---------------------------------------------------------------------------
# Reports
# ---------------------------------------------------------------------------

def memory_report() -> Dict[str, Any]:
    """One JSON-able view of everything this module knows."""
    return {"programs": [r.to_dict() for r in records()],
            "tracker": dict(_TRACKER.last),
            "peak_bytes": _TRACKER.peak_bytes}


def bench_summary() -> Optional[Dict[str, Any]]:
    """peak_hbm_bytes (+ hbm_utilization when a capacity is known) for a
    benchmark record; None when nothing was measured."""
    peak = _TRACKER.peak_bytes
    limit = int(_TRACKER.last.get("limit_bytes") or 0) if _TRACKER.last else 0
    if not peak:
        peak = max((r.total_bytes for r in records()), default=0)
    if not peak:
        return None
    out: Dict[str, Any] = {"peak_hbm_bytes": int(peak),
                           "hbm_utilization": None}
    if limit:
        out["hbm_utilization"] = round(peak / limit, 4)
    return out


def crash_section() -> Dict[str, Any]:
    """The 'memory' section of a crash report (the tracker's last run,
    published first)."""
    return {"tracker": dict(_TRACKER.last),
            "peak_bytes": _TRACKER.peak_bytes,
            "programs": [r.to_dict() for r in records()[-8:]],
            "live_buffers": top_live_buffers(5)}


# ---------------------------------------------------------------------------
# Smoke programs (tests and the chip smoke)
# ---------------------------------------------------------------------------

def build_smoke(name: str) -> Dict[str, Any]:
    """Build one of the named smoke programs for memory measurements:
    'fit_a_line' (13->1 linear regression, SGD) or 'resnet' (CIFAR-shaped
    ResNet classifier, Momentum), the JAX package's. Returns {main,
    startup, loss, feed_fn, data_fn, label}: feed_fn(b) yields
    (shape, dtype) specs only (static analysis never materializes them,
    whatever the batch), data_fn(b) real zero arrays for executed
    steps."""
    from . import framework as fw
    from . import layers, models, optimizer
    from .framework import unique_name

    with unique_name.guard():
        main, startup = fw.Program(), fw.Program()
        with fw.program_guard(main, startup):
            if name == "fit_a_line":
                x = layers.data(name="x", shape=[13], dtype="float32")
                y = layers.data(name="y", shape=[1], dtype="float32")
                pred = layers.fc(input=x, size=1, act=None)
                cost = layers.square_error_cost(input=pred, label=y)
                loss = layers.mean(cost)
                optimizer.SGD(learning_rate=0.01).minimize(
                    loss, startup_program=startup)
                feeds = {"x": ((13,), np.float32), "y": ((1,), np.float32)}
            elif name == "resnet":
                img = layers.data(name="img", shape=[3, 32, 32],
                                  dtype="float32")
                label = layers.data(name="label", shape=[1], dtype="int64")
                loss, _, _ = models.build_image_classifier(
                    models.resnet_cifar10, img, label, class_dim=10,
                    depth=20)
                optimizer.Momentum(learning_rate=0.001, momentum=0.9).minimize(
                    loss, startup_program=startup)
                feeds = {"img": ((3, 32, 32), np.float32),
                         "label": ((1,), np.int64)}
            else:
                raise ValueError(f"unknown smoke program '{name}' "
                                 f"(known: fit_a_line, resnet)")

    def feed_fn(batch: int):
        return {n: ((batch,) + shape, dtype)
                for n, (shape, dtype) in feeds.items()}

    def data_fn(batch: int):
        return {n: np.zeros((batch,) + shape, dtype)
                for n, (shape, dtype) in feeds.items()}

    return {"main": main, "startup": startup, "loss": loss,
            "feed_fn": feed_fn, "data_fn": data_fn, "label": name}
