"""Telemetry: the process-wide metrics registry, the structured step-event
log and their exports (the port's counterpart of paddle_tpu/telemetry.py).

One registry of counters, gauges and log-scale histograms, labeled, with
read-only peeks (`read_gauge`, `read_series`, `read_histogram`,
`histogram_quantile`) that never create a series; a bounded ring of
structured events (`log_event`, `recent_events`), mirrored one JSON line an
event to the step log (`enable_step_log`, or `PADDLE_TPU_STEP_LOG` read at
import); `snapshot()` of every series, summed over the ranks of a process
group with `reduce=True` (`parallel/multihost.allgather_bytes`);
`prometheus_text()`; and `export_chrome_trace`, the step events as one
Perfetto timeline. The series keys, the histogram bucket edges, the
quantile interpolation, the exposition text and the snapshot layout are
the reference's, so a reader of either package gets the same numbers from
the same observations. The executor (executor.py: `executor_*`, the `run`,
`run_window`, `compile` and `cache_miss` events), serving, span tracing
(tracing.py), the sparse applies, the hot-row embedding cache, memory.py
and the numeric-health plane (inspector.py, dynamics.py) publish here;
METRIC_CATALOG lists every family the port creates.

Compile time. The reference's accumulator `jax_compile_seconds` sums XLA's
backend compiles, heard through jax.monitoring. What costs the port compile
time is capturing a step as a CUDA graph (`graph_capture_seconds_total`,
`graph_captures_total`) and building a kernel library with nvcc
(ops/cuda_build.py: `kernel_build_seconds_total`, `kernel_builds_total`);
both add to `compile_seconds()`, the accumulator in its role, which the
executor reads before and after a run to split its time into compile and
execute. Triton's first-launch compiles (K5, T1) are not heard.

Gauges that are costly to sample (memory.py's hbm_*) register a read hook
(`add_read_hook`): it runs before `snapshot()` and `prometheus_text()`
read the registry, so the per-run sample stays two numbers.

Hot-path cost: one lock and a dict update per metric operation; an event
is a dict build and a deque append, and one JSON line when the step log
is on. The kernel wrappers' and the executor's `COUNTERS` dataclasses stay
where they are.
"""

from __future__ import annotations

import bisect
import collections
import json
import math
import os
import threading
import time
from typing import (Any, Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple)

__all__ = [
    "counter", "gauge", "histogram", "registry", "MetricsRegistry",
    "log_event", "recent_events", "default_buckets", "reset",
    "program_label", "read_gauge", "read_series", "read_histogram",
    "histogram_quantile", "METRIC_CATALOG", "snapshot", "prometheus_text",
    "enable_step_log", "disable_step_log", "step_log_path", "read_step_log",
    "export_chrome_trace", "signature_of", "compile_seconds", "note_compile",
    "add_read_hook",
]


# ---------------------------------------------------------------------------
# Metric primitives
# ---------------------------------------------------------------------------

def default_buckets() -> Tuple[float, ...]:
    """Fixed log-scale histogram buckets: powers of 4 from 1 microsecond to
    ~67 seconds (the reference's edges, so bucket counts of either package
    compare cell by cell)."""
    return tuple(1e-6 * (4.0 ** i) for i in range(14))


def _label_key(labels: Dict[str, str]) -> str:
    """Canonical serialized label set: the snapshot's series key and the
    cross-rank merge key."""
    return ",".join(f"{k}={labels[k]}" for k in sorted(labels))


# one lock for all series mutations: += on an attribute is a
# read-modify-write, and client threads and the batcher's worker update
# series concurrently
_VALUES_LOCK = threading.Lock()


class _Child:
    """One (metric, label-values) time series."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, amount: float = 1.0):
        with _VALUES_LOCK:
            self.value += amount

    def set(self, value: float):
        with _VALUES_LOCK:
            self.value = float(value)


class _HistChild:
    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets: Sequence[float]):
        self.buckets = tuple(buckets)
        self.counts = [0] * (len(self.buckets) + 1)   # last = +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float):
        value = float(value)
        # the first bucket whose edge is >= value (the last, +Inf, past
        # them all)
        i = (bisect.bisect_left(self.buckets, value) if value == value
             else len(self.buckets))        # NaN: the +Inf bucket
        with _VALUES_LOCK:
            self.sum += value
            self.count += 1
            self.counts[i] += 1


class _Family:
    """A named metric with a fixed label-name schema; `.labels(**kw)`
    resolves (and lazily creates) one child series per label-value tuple.
    Label-free families proxy inc/set/observe to their single () child."""

    kind = "counter"

    def __init__(self, reg: "MetricsRegistry", name: str, help: str,
                 labelnames: Sequence[str], buckets=None):
        self._reg = reg
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._buckets = tuple(buckets) if buckets else None
        self._children: Dict[Tuple[str, ...], Any] = {}

    def _make_child(self):
        if self.kind == "histogram":
            return _HistChild(self._buckets or default_buckets())
        return _Child()

    def labels(self, **kw):
        if set(kw) != set(self.labelnames):
            raise ValueError(
                f"metric '{self.name}' takes labels {self.labelnames}, "
                f"got {sorted(kw)}")
        key = tuple(str(kw[k]) for k in self.labelnames)
        with self._reg._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._make_child()
            return child

    def _default_child(self):
        if self.labelnames:
            raise ValueError(
                f"metric '{self.name}' is labeled {self.labelnames}; "
                f"use .labels(...)")
        return self.labels()

    # label-free conveniences
    def inc(self, amount: float = 1.0):
        self._default_child().inc(amount)

    def set(self, value: float):
        self._default_child().set(value)

    def observe(self, value: float):
        self._default_child().observe(value)

    def series(self) -> Dict[str, Any]:
        """{serialized labels: child}, the snapshot's view."""
        with self._reg._lock:
            return {_label_key(dict(zip(self.labelnames, k))): c
                    for k, c in self._children.items()}


class _Counter(_Family):
    kind = "counter"


class _Gauge(_Family):
    kind = "gauge"


class _Histogram(_Family):
    kind = "histogram"


class MetricsRegistry:
    """Thread-safe name -> metric family registry. Re-registering the same
    name with the same kind returns the existing family (idempotent, so
    instrumented modules declare metrics at their call sites)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._families: Dict[str, _Family] = {}
        self._generation = 0

    def _get_or_make(self, cls, name, help, labels, buckets=None):
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != cls.kind:
                    raise ValueError(
                        f"metric '{name}' already registered as {fam.kind}")
                return fam
            fam = cls(self, name, help, labels, buckets)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> _Counter:
        return self._get_or_make(_Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> _Gauge:
        return self._get_or_make(_Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "", labels: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> _Histogram:
        return self._get_or_make(_Histogram, name, help, labels, buckets)

    def families(self) -> List[_Family]:
        with self._lock:
            return list(self._families.values())

    def clear(self):
        with self._lock:
            self._families.clear()
            self._generation += 1

    def generation(self) -> int:
        """Bumped by clear(): a hot path that keeps a family's child (the
        executor's per-program series) checks it with one int compare."""
        return self._generation

    def local_snapshot(self) -> Dict[str, Any]:
        """Every series of this process, JSON-serializable (the reference's
        layout: {host, counters, gauges, histograms}, series keyed by
        `_label_key`)."""
        snap = {"host": _host_index(), "counters": {}, "gauges": {},
                "histograms": {}}
        for fam in self.families():
            if fam.kind == "histogram":
                dst = snap["histograms"].setdefault(fam.name, {})
                for lk, ch in fam.series().items():
                    with _VALUES_LOCK:
                        dst[lk] = {"buckets": list(ch.buckets),
                                   "counts": list(ch.counts),
                                   "sum": ch.sum, "count": ch.count}
            else:
                dst = snap[fam.kind + "s"].setdefault(fam.name, {})
                for lk, ch in fam.series().items():
                    dst[lk] = ch.value
        return snap


_REG = MetricsRegistry()


def registry() -> MetricsRegistry:
    return _REG


def counter(name: str, help: str = "", labels: Sequence[str] = ()):
    return _REG.counter(name, help, labels)


def gauge(name: str, help: str = "", labels: Sequence[str] = ()):
    return _REG.gauge(name, help, labels)


def histogram(name: str, help: str = "", labels: Sequence[str] = (),
              buckets: Optional[Sequence[float]] = None):
    return _REG.histogram(name, help, labels, buckets)


def _child_of(name: str, kind: str, labels):
    """The `kind` family's child for exactly `labels`, or None; never
    creates one. Caller holds _REG._lock."""
    fam = _REG._families.get(name)
    if fam is None or fam.kind != kind:
        return None
    if set(labels) != set(fam.labelnames):
        return None
    return fam._children.get(tuple(str(labels[k]) for k in fam.labelnames))


def read_gauge(name: str, **labels) -> Optional[float]:
    """Last value of one gauge series, or None when the family or the exact
    label set does not exist yet. A read-only peek: it never creates the
    series (the read hooks publish first)."""
    _run_read_hooks()
    with _REG._lock:
        child = _child_of(name, "gauge", labels)
        return None if child is None else child.value


def read_series(name: str) -> Dict[str, float]:
    """All series of one counter/gauge family as {label_key: value}
    (label_key is the 'k=v,k=v' form in the family's label order; the
    unlabeled series maps from ''). Never creates the family or any child.
    Empty when the family is absent or a histogram."""
    _run_read_hooks()
    with _REG._lock:
        fam = _REG._families.get(name)
        if fam is None or fam.kind == "histogram":
            return {}
        return {
            ",".join(f"{k}={v}" for k, v in zip(fam.labelnames, key)):
                child.value
            for key, child in fam._children.items()}


def read_histogram(name: str, **labels) -> Optional[Dict[str, float]]:
    """{'sum', 'count'} of one histogram series, or None when the family or
    the exact label set does not exist. Never creates the family or a
    child."""
    with _REG._lock:
        child = _child_of(name, "histogram", labels)
        if child is None:
            return None
        with _VALUES_LOCK:
            return {"sum": child.sum, "count": child.count}


def histogram_quantile(name: str, q: float, **labels) -> Optional[float]:
    """Quantile estimate of one histogram series from its cumulative bucket
    counts (Prometheus histogram_quantile semantics: find the bucket whose
    cumulative count crosses rank q*total, interpolate linearly inside it).
    With default_buckets()'s powers-of-4 ladder an estimate is within 4x of
    the true value: enough to rank p50 against p99 and follow trends. None
    when the series does not exist or has no observations. A rank in the
    +Inf bucket returns the last finite edge (a floor) and counts
    `telemetry_quantile_tail_clamped_total`."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    with _REG._lock:
        child = _child_of(name, "histogram", labels)
        if child is None:
            return None
        with _VALUES_LOCK:
            counts = list(child.counts)
            edges = list(child.buckets)
            total = child.count
    if total <= 0:
        return None
    rank = q * total
    cum = 0.0
    for i, c in enumerate(counts[:-1]):
        prev = cum
        cum += c
        if cum >= rank and c > 0:
            lo = edges[i - 1] if i > 0 else 0.0
            hi = edges[i]
            frac = min(max((rank - prev) / c, 0.0), 1.0)
            return lo + (hi - lo) * frac
    counter("telemetry_quantile_tail_clamped_total",
            "histogram_quantile ranks that fell in the +Inf bucket and "
            "were clamped to the last finite edge (the returned quantile "
            "is a floor)", labels=("name",)).labels(name=name).inc()
    return edges[-1]


_HOST: List[int] = []


def _host_index() -> int:
    # the launcher's trainer id (reference PADDLE_TRAINER_ID), never a
    # process group query from a metrics call; read once (a launcher sets
    # it before the process starts), since every event carries it
    if not _HOST:
        _HOST.append(int(os.environ.get("PADDLE_TRAINER_ID", "0") or 0))
    return _HOST[0]


# ---------------------------------------------------------------------------
# Read hooks, snapshots and the cross-rank reduce
# ---------------------------------------------------------------------------

_READ_HOOKS: List[Callable[[], None]] = []


def add_read_hook(fn: Callable[[], None]):
    """Run `fn` before every snapshot() and prometheus_text() reads the
    registry: a gauge whose full sample is costly (memory.py's hbm_*)
    publishes there, from the few numbers its per-run hook kept."""
    if fn not in _READ_HOOKS:
        _READ_HOOKS.append(fn)


def _run_read_hooks():
    for fn in list(_READ_HOOKS):
        try:
            fn()
        except Exception:
            pass        # advisory gauges never fail a read


def _merge_snapshots(snaps: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Sum-merge per-rank snapshots into totals. Counters, histogram cells
    and gauges all add (a reduced gauge is the total: queue depths sum to
    the backlog); per-rank values stay in the unreduced snapshot."""
    out = {"hosts": len(snaps), "counters": {}, "gauges": {},
           "histograms": {}}
    for snap in snaps:
        for kind in ("counters", "gauges"):
            for name, series in snap.get(kind, {}).items():
                dst = out[kind].setdefault(name, {})
                for lk, v in series.items():
                    dst[lk] = dst.get(lk, 0.0) + v
        for name, series in snap.get("histograms", {}).items():
            dst = out["histograms"].setdefault(name, {})
            for lk, h in series.items():
                acc = dst.get(lk)
                if acc is None or list(acc["buckets"]) != list(h["buckets"]):
                    if acc is None:
                        dst[lk] = {"buckets": list(h["buckets"]),
                                   "counts": list(h["counts"]),
                                   "sum": h["sum"], "count": h["count"]}
                    else:   # bucket-schema skew: keep the first layout,
                        acc["sum"] += h["sum"]         # fold scalars only
                        acc["count"] += h["count"]
                    continue
                acc["counts"] = [a + b for a, b in
                                 zip(acc["counts"], h["counts"])]
                acc["sum"] += h["sum"]
                acc["count"] += h["count"]
    return out


def snapshot(reduce: bool = False) -> Dict[str, Any]:
    """Registry snapshot. reduce=True returns the totals over the ranks of
    the torch.distributed process group: every rank's snapshot rides
    parallel/multihost.allgather_bytes and the series sum-merge by
    (metric, labels) (one process: the local snapshot's series)."""
    _run_read_hooks()
    local = _REG.local_snapshot()
    if not reduce:
        return local
    from .parallel import multihost
    payloads = multihost.allgather_bytes(
        json.dumps(local, sort_keys=True).encode("utf-8"))
    return _merge_snapshots([json.loads(p.decode("utf-8"))
                             for p in payloads])


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------

def _prom_labels(label_key: str, extra: str = "") -> str:
    if not label_key and not extra:
        return ""
    parts = []
    if label_key:
        for pair in label_key.split(","):
            k, _, v = pair.partition("=")
            v = v.replace("\\", "\\\\").replace('"', '\\"')
            parts.append(f'{k}="{v}"')
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}"


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def prometheus_text(snap: Optional[Dict[str, Any]] = None) -> str:
    """A snapshot (default: this process's) in the Prometheus text
    exposition format: counters and gauges as single samples, histograms
    as cumulative `_bucket{le=...}`, `_sum` and `_count`."""
    if snap is None:
        _run_read_hooks()
        snap = _REG.local_snapshot()
    helps = {f.name: (f.help, f.kind) for f in _REG.families()}
    lines: List[str] = []
    for kind_key, prom_kind in (("counters", "counter"), ("gauges", "gauge")):
        for name in sorted(snap.get(kind_key, {})):
            help_, _ = helps.get(name, ("", prom_kind))
            if help_:
                lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} {prom_kind}")
            for lk in sorted(snap[kind_key][name]):
                lines.append(f"{name}{_prom_labels(lk)} "
                             f"{_fmt(snap[kind_key][name][lk])}")
    for name in sorted(snap.get("histograms", {})):
        help_, _ = helps.get(name, ("", "histogram"))
        if help_:
            lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} histogram")
        for lk in sorted(snap["histograms"][name]):
            h = snap["histograms"][name][lk]
            cum = 0
            for le, c in zip(list(h["buckets"]) + [math.inf], h["counts"]):
                cum += c
                le_label = 'le="%s"' % _fmt(le)
                lines.append(
                    f"{name}_bucket{_prom_labels(lk, le_label)} {cum}")
            lines.append(f"{name}_sum{_prom_labels(lk)} {_fmt(h['sum'])}")
            lines.append(f"{name}_count{_prom_labels(lk)} {h['count']}")
    return "\n".join(lines) + ("\n" if lines else "")


# ---------------------------------------------------------------------------
# Structured events and the JSONL step log
# ---------------------------------------------------------------------------

_EVENTS_MAX = 4096
_events: "collections.deque" = collections.deque(maxlen=_EVENTS_MAX)
_events_lock = threading.Lock()
_log_path: Optional[str] = None
_log_file = None


def enable_step_log(path: str):
    """Mirror every event to `path`, one JSON line an event, beside the
    in-memory ring. Also set by PADDLE_TPU_STEP_LOG, read at import."""
    global _log_path, _log_file
    # open() before the lock: a slow open must not stall log_event
    f = open(path, "a", buffering=1)   # line-buffered
    with _events_lock:
        old, _log_file = _log_file, f
        _log_path = path
    if old is not None:
        old.close()


def disable_step_log():
    global _log_path, _log_file
    with _events_lock:
        old, _log_file = _log_file, None
        _log_path = None
    if old is not None:
        old.close()


def step_log_path() -> Optional[str]:
    with _events_lock:
        return _log_path


def log_event(kind: str, **fields) -> Dict[str, Any]:
    """Record a structured event: wall timestamp, monotonic timestamp
    (perf_counter, the chrome trace's timebase), host, kind and the
    caller's fields. Returns the record."""
    rec = {"ts": time.time(), "mono": time.perf_counter(),
           "host": _host_index(), "kind": kind}
    rec.update(fields)
    with _events_lock:
        _events.append(rec)
        if _log_file is not None:
            try:
                _log_file.write(json.dumps(rec, default=str) + "\n")
            except (OSError, ValueError):
                pass    # a torn sink never fails the step
    return rec


def recent_events(n: Optional[int] = None,
                  kind: Optional[str] = None) -> List[Dict[str, Any]]:
    with _events_lock:
        evs = list(_events)
    if kind is not None:
        evs = [e for e in evs if e.get("kind") == kind]
    return evs[-n:] if n else evs


def read_step_log(path: str) -> List[Dict[str, Any]]:
    """Parse a JSONL step log; a torn last line (a crash mid-write) is
    skipped."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return out


if os.environ.get("PADDLE_TPU_STEP_LOG"):
    enable_step_log(os.environ["PADDLE_TPU_STEP_LOG"])


# ---------------------------------------------------------------------------
# Chrome-trace export
# ---------------------------------------------------------------------------

# the timeline's zero, on the events' perf_counter clock
_EPOCH = time.perf_counter()


def export_chrome_trace(path: str, events: Optional[Iterable[Dict]] = None):
    """The step events (run / run_window / compile / cache_miss rows, tid
    1) as one Perfetto-loadable timeline, each a complete "X" event ending
    at its `mono` time and lasting its `seconds`, in the reference's
    layout. The reference's host-event row (tid 0, its profiler's ranges)
    comes with the port's profiler (ROADMAP 10b-2); the spans of
    tracing.py have their own export (tracing.export_chrome_trace)."""
    trace = []
    for e in (events if events is not None else recent_events()):
        dur = float(e.get("seconds", 0.0) or 0.0)
        start = float(e.get("mono", 0.0)) - _EPOCH - dur
        args = {k: v for k, v in e.items()
                if k not in ("mono", "kind") and _json_ok(v)}
        trace.append({"name": e.get("kind", "event"), "ph": "X",
                      "pid": 0, "tid": 1, "ts": start * 1e6,
                      "dur": dur * 1e6, "cat": "step", "args": args})
    with open(path, "w") as f:
        json.dump({"traceEvents": trace, "displayTimeUnit": "ms"}, f)
    return path


def _json_ok(v) -> bool:
    return isinstance(v, (str, int, float, bool, list, tuple, type(None)))


# ---------------------------------------------------------------------------
# Program labels
# ---------------------------------------------------------------------------

_prog_seq = [0]
_prog_lock = threading.Lock()


def program_label(program) -> str:
    """Stable short label for a Program within this process ("p0", "p1"…)."""
    lbl = getattr(program, "_telemetry_label", None)
    if lbl is None:
        # the seq bump is a read-modify-write; two threads labelling
        # concurrently must not mint the same "pN"
        with _prog_lock:
            lbl = getattr(program, "_telemetry_label", None)
            if lbl is None:
                lbl = f"p{_prog_seq[0]}"
                _prog_seq[0] += 1
                try:
                    program._telemetry_label = lbl
                except AttributeError:
                    pass
    return lbl


def signature_of(feed_vals: Dict[str, Any]
                 ) -> Tuple[Tuple[str, str, str], ...]:
    """(name, shape, dtype) triples of a feed dict, the retrace identity
    (a new one is a new graph signature). Dtypes read as numpy names
    ("float32", not "torch.float32"), as the reference's."""
    sig = []
    for name in sorted(feed_vals):
        v = feed_vals[name]
        shape = getattr(v, "shape", None)
        dtype = getattr(v, "dtype", None)
        sig.append((name, str(tuple(shape) if shape is not None else ()),
                    str(dtype).replace("torch.", "")))
    return tuple(sig)


# the compile-time accumulator (reference jax_compile_seconds): graph
# captures and kernel builds add to it, each counted in its families
_compile_secs = [0.0]
_COMPILE_FAMILIES = {
    "graph_capture": ("graph_capture_seconds_total", "graph_captures_total",
                      "CUDA graph capture"),
    "kernel_build": ("kernel_build_seconds_total", "kernel_builds_total",
                     "nvcc kernel library build"),
}


def note_compile(kind: str, seconds: float):
    """Count one graph capture (`kind` "graph_capture") or kernel build
    ("kernel_build") of `seconds` and add them to compile_seconds()."""
    secs_name, n_name, what = _COMPILE_FAMILIES[kind]
    _compile_secs[0] += float(seconds)
    counter(secs_name, f"{what} wall seconds").inc(float(seconds))
    counter(n_name, f"{what}s").inc()


def compile_seconds() -> float:
    """Monotone accumulator of the seconds this process spent capturing
    graphs and building kernels (the reference's jax_compile_seconds)."""
    return _compile_secs[0]


def reset():
    """Clear every metric series and the event ring (tests). The step log,
    program labels and the compile accumulator survive: they are
    process-lifetime state."""
    _REG.clear()
    with _events_lock:
        _events.clear()


# --- declared metric catalog -------------------------------------------------
# Every family the port creates: name -> (kind, label set, help), the
# reference's entries for the same names (tests/test_torch_telemetry.py
# holds the call sites to it).

def _m(kind, labels=(), help=""):
    return {"kind": kind, "labels": tuple(labels), "help": help}


METRIC_CATALOG = {
    "serving_request_seconds": _m("histogram", ("program", "phase"),
                                  "per-request latency by phase"),
    "serving_batches_total": _m("counter", ("program", "close"),
                                "batches closed, by close cause"),
    "serving_shed_total": _m("counter", ("program", "reason"),
                             "requests shed by overload control"),
    "serving_queue_depth": _m("gauge", ("program",),
                              "requests waiting in the batcher"),
    "serving_bucket_runs_total": _m("counter", ("program", "bucket"),
                                    "batches executed per bucket"),
    "serving_cache_hit_total": _m("counter", ("program", "bucket"),
                                  "bucket graph cache hits"),
    "serving_cache_miss_total": _m("counter", ("program", "bucket"),
                                   "bucket graph cache misses"),
    "serving_cache_evictions_total": _m(
        "counter", ("program",), "bucket graphs LRU-evicted"),
    "serving_compile_seconds": _m("histogram", ("program", "bucket"),
                                  "bucket warm-up plus capture seconds"),
    "serving_fallback_total": _m("counter", ("program", "reason"),
                                 "bucket runs on the eager path"),
    "slo_burn_rate": _m("gauge", ("model", "window"),
                        "error-budget burn rate by window"),
    "telemetry_quantile_tail_clamped_total": _m(
        "counter", ("name",),
        "quantiles clamped to the last finite bucket edge"),
    "trace_spans_total": _m("counter", ("name",),
                            "finished (sampled) trace spans"),
    "trace_spans_dropped_total": _m(
        "counter", (), "spans evicted from the trace ring buffer"),
    # sparse / embedding
    "sparse_apply_rows_total": _m("counter", ("op",),
                                  "rows touched by sparse applies"),
    "sparse_densify_fallback_total": _m(
        "counter", ("op", "reason"), "sparse paths densified"),
    "emb_cache_hits_total": _m("counter", ("table",),
                               "embedding hot-row cache hits"),
    "emb_cache_misses_total": _m("counter", ("table",),
                                 "embedding hot-row cache misses"),
    "emb_cache_hit_rate": _m("gauge", ("table",),
                             "embedding cache rolling hit rate"),
    "emb_cache_evictions_total": _m("counter", ("policy",),
                                    "embedding cache evictions"),
    "emb_cache_flush_bytes_total": _m(
        "counter", (), "dirty embedding bytes flushed to host"),
    "emb_cache_prefetch_total": _m("counter", (),
                                   "embedding prefetch batches staged"),
    "emb_cache_prefetch_overlap_fraction": _m(
        "gauge", (), "prefetch time hidden under compute"),
    # memory (memory.py)
    "oom_errors_total": _m("counter", ("program",),
                           "device OOMs classified by the executor"),
    "hbm_bytes_in_use": _m("gauge", ("device",),
                           "live device bytes (tracker)"),
    "hbm_peak_bytes": _m("gauge", ("device",), "peak device bytes"),
    "hbm_limit_bytes": _m("gauge", ("device",), "device memory capacity"),
    "hbm_class_bytes": _m("gauge", ("device", "kind"),
                          "device bytes by allocation class"),
    # the executor's step telemetry (executor.py)
    "executor_runs_total": _m("counter", ("program", "place", "mode"),
                              "Executor.run calls"),
    "executor_steps_total": _m("counter", ("program", "place"),
                               "training/eval steps executed"),
    "executor_run_seconds": _m("histogram", ("program", "mode"),
                               "Executor.run wall seconds"),
    "executor_last_step_seconds": _m("gauge", (),
                                     "wall seconds of the latest step"),
    "executor_compiles_total": _m("counter", ("program", "place"),
                                  "block graph captures"),
    "executor_compile_seconds_total": _m(
        "counter", ("program", "place"),
        "graph capture wall seconds inside Executor.run"),
    "executor_cache_hits_total": _m(
        "counter", ("program", "place"),
        "runs served by an already-captured signature"),
    "executor_cache_misses_total": _m("counter", ("program", "place"),
                                      "signature-cache misses"),
    "executor_window_fallback_total": _m(
        "counter", ("program", "reason"),
        "run_steps windows that fell back to per-step execution"),
    "optimizer_steps_total": _m("counter", ("program",),
                                "runs of optimizer-carrying programs"),
    # families of earlier slices the catalog had missed
    "optimizer_minimize_total": _m("counter", ("optimizer",),
                                   "Optimizer.minimize calls"),
    "optimizer_global_norm": _m("gauge", ("program",),
                                "pre-clip gradient global norm"),
    "checkpoint_last_step": _m("gauge", (), "step of the newest checkpoint"),
    "checkpoint_saves_total": _m("counter", (),
                                 "checkpoints written by this process"),
    "multihost_initialize_total": _m("counter", (), "distributed init calls"),
    "multihost_processes": _m("gauge", (), "process count at init"),
    # compile time (this module's note_compile): the port's own families,
    # in the place of the reference's jax_backend_compile*_total
    "graph_capture_seconds_total": _m("counter", (),
                                      "CUDA graph capture wall seconds"),
    "graph_captures_total": _m("counter", (), "CUDA graph captures"),
    "kernel_build_seconds_total": _m("counter", (),
                                     "nvcc kernel library build seconds"),
    "kernel_builds_total": _m("counter", (), "nvcc kernel library builds"),
    # the numeric-health plane (inspector.py, dynamics.py)
    "nonfinite_detections_total": _m(
        "counter", ("program", "source"),
        "non-finite values caught by checks/probes"),
    "grad_l2": _m("gauge", ("program", "param"), "per-param grad L2"),
    "grad_abs_mean": _m("gauge", ("program", "param"),
                        "per-param grad |mean|"),
    "grad_audit_flags_total": _m("counter", ("program", "param", "status"),
                                 "grad audit anomaly flags"),
    "inspector_crash_reports_total": _m("counter", (),
                                        "crash reports written"),
    "dynamics_update_ratio": _m("gauge", ("program", "series"),
                                "per-series |dW|/(|W|+eps)"),
    "dynamics_grad_rms": _m("gauge", ("program", "series"),
                            "per-series gradient RMS"),
    "dynamics_weight_rms": _m("gauge", ("program", "series"),
                              "per-series parameter RMS"),
    "dynamics_dead_layers": _m("gauge", ("program",),
                               "series currently classified dead-layer"),
    "dynamics_frozen_params": _m("gauge", ("program",),
                                 "series currently classified frozen-param"),
    "dynamics_unhealthy_series": _m("gauge", ("program",),
                                    "series with any non-ok verdict"),
    "dynamics_samples_total": _m("counter", ("program",),
                                 "dynamics samples recorded"),
}

# the families the reference has no entry for: the port's compile-time
# counters (see note_compile)
PORT_ONLY = frozenset({"graph_capture_seconds_total", "graph_captures_total",
                       "kernel_build_seconds_total", "kernel_builds_total"})
