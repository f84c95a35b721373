"""Telemetry: the process-wide metrics registry and the structured event
ring (the port's counterpart of the core of paddle_tpu/telemetry.py).

One registry of counters, gauges and log-scale histograms, labeled, with
read-only peeks (`read_gauge`, `read_series`, `read_histogram`,
`histogram_quantile`) that never create a series; and a bounded ring of
structured events (`log_event`, `recent_events`). The series keys, the
histogram bucket edges and the quantile interpolation are the reference's,
so a reader of either package gets the same numbers from the same
observations. Serving (serving/engine.py, batcher.py, slo.py), span
tracing (tracing.py), the sparse applies (ops/sparse_ops.py) and the
hot-row embedding cache (parallel/emb_cache.py) publish here;
METRIC_CATALOG lists every family the port creates.

The reference's cross-host snapshots, Prometheus text, JSONL step log,
chrome-trace export and compile listener are later work (ROADMAP item
10). The kernel wrappers' and the executor's `COUNTERS` dataclasses stay
where they are.

Hot-path cost: one lock and a dict update per metric operation; an event
is a dict build and a deque append.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "counter", "gauge", "histogram", "registry", "MetricsRegistry",
    "log_event", "recent_events", "default_buckets", "reset",
    "program_label", "read_gauge", "read_series", "read_histogram",
    "histogram_quantile", "METRIC_CATALOG",
]


# ---------------------------------------------------------------------------
# Metric primitives
# ---------------------------------------------------------------------------

def default_buckets() -> Tuple[float, ...]:
    """Fixed log-scale histogram buckets: powers of 4 from 1 microsecond to
    ~67 seconds (the reference's edges, so bucket counts of either package
    compare cell by cell)."""
    return tuple(1e-6 * (4.0 ** i) for i in range(14))


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
        with _VALUES_LOCK:
            self.sum += value
            self.count += 1
            for i, le in enumerate(self.buckets):
                if value <= le:
                    self.counts[i] += 1
                    return
            self.counts[-1] += 1


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
    series."""
    with _REG._lock:
        child = _child_of(name, "gauge", labels)
        return None if child is None else child.value


def read_series(name: str) -> Dict[str, float]:
    """All series of one counter/gauge family as {label_key: value}
    (label_key is the 'k=v,k=v' form in the family's label order; the
    unlabeled series maps from ''). Never creates the family or any child.
    Empty when the family is absent or a histogram."""
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


# ---------------------------------------------------------------------------
# Structured events
# ---------------------------------------------------------------------------

_EVENTS_MAX = 4096
_events: "collections.deque" = collections.deque(maxlen=_EVENTS_MAX)
_events_lock = threading.Lock()


def log_event(kind: str, **fields) -> Dict[str, Any]:
    """Record a structured event: wall timestamp, monotonic timestamp
    (perf_counter), host, kind and the caller's fields. Returns the
    record."""
    rec = {"ts": time.time(), "mono": time.perf_counter(), "host": 0,
           "kind": kind}
    rec.update(fields)
    with _events_lock:
        _events.append(rec)
    return rec


def recent_events(n: Optional[int] = None,
                  kind: Optional[str] = None) -> List[Dict[str, Any]]:
    with _events_lock:
        evs = list(_events)
    if kind is not None:
        evs = [e for e in evs if e.get("kind") == kind]
    return evs[-n:] if n else evs


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


def reset():
    """Clear every metric series and the event ring (tests). Program labels
    survive: they are process-lifetime state."""
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
}
