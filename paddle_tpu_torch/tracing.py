"""Causal span tracing for serving requests (the port's counterpart of the
span core of paddle_tpu/tracing.py).

The metrics registry (telemetry.py) answers "how is serving doing in
aggregate"; spans answer "where did *this* request's 40 ms go". Spans
carry a trace id / span id / parent id, monotonic timestamps, attrs and
point events, and finished spans land in a bounded process-wide ring
(`recent_spans`, `trace_tree`).

  * **Off by default, cheap when off.** `enabled()` is one attribute
    read; every instrumentation site guards on it. Enable with `enable()`
    or `PADDLE_TPU_TRACE` (``1`` for everything, a float like ``0.1`` for
    head sampling), read at import.
  * **Head sampling at the root.** The keep/drop decision is made once,
    when a root span starts, and inherited by every child. The sampler is
    a deterministic error-feedback accumulator (no RNG), so a 0.25 rate
    keeps exactly every 4th trace.
  * **Two span styles.** `span()`/`start_span()` bracket live code with
    thread-local context propagation; `record_span()` creates a span
    retroactively from timestamps already measured (the batcher's phase
    marks), so tracing adds no second clock read on the hot path.

  * **Exports.** `export_chrome_trace` writes the ring as chrome-trace /
    Perfetto JSON (one row a trace), `export_jsonl` as JSON lines, and
    `enable(jsonl=path)` (or `PADDLE_TPU_TRACE_JSONL`) mirrors each
    finished span to a file as it ends. The executor records a `step`
    span a run, with a `compile` child on a capture (executor.py).
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from . import telemetry

_DEFAULT_CAPACITY = 4096

_LOCK = threading.Lock()
_SPANS: "list" = []          # ring of finished span dicts (bounded)
_CAPACITY = _DEFAULT_CAPACITY
_ENABLED = False
_SAMPLE = 1.0
_SAMPLE_ACC = 0.0            # error-feedback accumulator for head sampling
_IDS = itertools.count(1)
_LOCAL = threading.local()   # .stack — list of live Span objects
_JSONL_PATH: Optional[str] = None   # live sink: one JSON line a span

# offset from time.monotonic() to wall-clock, so spans recorded from
# monotonic timestamps can still report a wall "ts"
_WALL_OFFSET = time.time() - time.monotonic()


class Span:
    """One live span. End it with `.end()` (or let the `span()` context
    manager do it); only ended spans reach the ring buffer."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "start",
                 "end_t", "attrs", "events", "sampled")

    def __init__(self, name: str, trace_id: str, span_id: str,
                 parent_id: Optional[str], start: float, sampled: bool,
                 attrs: Optional[Dict[str, Any]] = None):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.start = start
        self.end_t: Optional[float] = None
        self.attrs: Dict[str, Any] = dict(attrs) if attrs else {}
        self.events: List[Dict[str, Any]] = []
        self.sampled = sampled

    def set_attr(self, key: str, value: Any) -> "Span":
        if self.sampled:
            self.attrs[key] = value
        return self

    def add_event(self, name: str, **attrs) -> "Span":
        if self.sampled:
            ev = {"name": name, "t": time.monotonic()}
            if attrs:
                ev.update(attrs)
            self.events.append(ev)
        return self

    def end(self, end: Optional[float] = None, **attrs):
        if self.end_t is not None:  # idempotent: first end wins
            return
        self.end_t = time.monotonic() if end is None else end
        if attrs and self.sampled:
            self.attrs.update(attrs)
        _finish(self)

    def to_dict(self) -> Dict[str, Any]:
        end = self.end_t if self.end_t is not None else time.monotonic()
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "start": self.start,
            "end": end,
            "dur_s": max(end - self.start, 0.0),
            "ts": self.start + _WALL_OFFSET,
            "attrs": self.attrs,
            "events": self.events,
        }


class _NullSpan:
    """Returned when tracing is off or the trace was head-sampled out.
    Accepts the whole Span surface and does nothing; `sampled` stays
    False so children created under it stay null too."""

    __slots__ = ()
    sampled = False
    trace_id = span_id = parent_id = None
    name = ""

    def set_attr(self, key, value):
        return self

    def add_event(self, name, **attrs):
        return self

    def end(self, end=None, **attrs):
        pass

    def to_dict(self):
        return {}


_NULL = _NullSpan()


def _next_id() -> str:
    return f"{os.getpid():x}.{next(_IDS):x}"


def _stack() -> list:
    st = getattr(_LOCAL, "stack", None)
    if st is None:
        st = _LOCAL.stack = []
    return st


def _sample_root() -> bool:
    """Deterministic head sampling: keep when the accumulated rate
    crosses 1.0 (an error-feedback quantizer: exact long-run rate, no RNG,
    so traces are reproducible)."""
    global _SAMPLE_ACC
    with _LOCK:
        s = _SAMPLE
        if s >= 1.0:
            return True
        if s <= 0.0:
            return False
        _SAMPLE_ACC += s
        if _SAMPLE_ACC >= 1.0:
            _SAMPLE_ACC -= 1.0
            return True
    return False


def _finish(sp: Span):
    if not sp.sampled:
        return
    d = sp.to_dict()
    with _LOCK:
        _SPANS.append(d)
        dropped = len(_SPANS) - _CAPACITY
        if dropped > 0:
            del _SPANS[:dropped]
            telemetry.counter(
                "trace_spans_dropped_total",
                "finished spans evicted from the bounded ring buffer").inc(
                    dropped)
        path = _JSONL_PATH
    telemetry.counter(
        "trace_spans_total", "finished (sampled) spans, by span name",
        labels=("name",)).labels(name=sp.name).inc()
    if path:
        try:
            with open(path, "a") as f:
                f.write(json.dumps(d) + "\n")
        except OSError:
            pass


# --- lifecycle ---------------------------------------------------------------

def enable(sample: float = 1.0, capacity: Optional[int] = None,
           jsonl: Optional[str] = None):
    """Turn tracing on. `sample` in (0, 1] head-samples root spans;
    `capacity` bounds the finished-span ring; `jsonl` mirrors finished
    spans to a file, one JSON object per line."""
    global _ENABLED, _SAMPLE, _CAPACITY, _JSONL_PATH
    with _LOCK:
        _SAMPLE = min(max(float(sample), 0.0), 1.0)
        if capacity is not None:
            _CAPACITY = max(int(capacity), 1)
        if jsonl is not None:
            _JSONL_PATH = jsonl
    _ENABLED = True


def disable():
    global _ENABLED
    _ENABLED = False


def enabled() -> bool:
    return _ENABLED


def reset():
    """Drop all recorded spans and restore defaults (tests)."""
    global _SPANS, _ENABLED, _SAMPLE, _SAMPLE_ACC, _CAPACITY, _JSONL_PATH
    with _LOCK:
        _SPANS = []
        _SAMPLE_ACC = 0.0
        _SAMPLE = 1.0
        _CAPACITY = _DEFAULT_CAPACITY
        _JSONL_PATH = None
    _ENABLED = False
    _LOCAL.stack = []


def maybe_enable_from_env():
    """Honor PADDLE_TPU_TRACE: '1'/'true'/'on' → full tracing, a float
    like '0.1' → head sampling at that rate, '0' → leave off.
    PADDLE_TPU_TRACE_JSONL names the live JSONL sink."""
    raw = os.environ.get("PADDLE_TPU_TRACE", "").strip().lower()
    if not raw:
        return
    if raw in ("1", "true", "on", "yes"):
        sample = 1.0
    elif raw in ("0", "false", "off", "no"):
        return
    else:
        try:
            sample = float(raw)
        except ValueError:
            return
    if sample > 0.0:
        enable(sample=sample,
               jsonl=os.environ.get("PADDLE_TPU_TRACE_JSONL") or None)


# --- span creation -----------------------------------------------------------

def current_span():
    """The innermost live span on this thread's context stack (or a null
    span): leaf code attaches attrs and events without plumbing handles."""
    st = _stack()
    return st[-1] if st else _NULL


def start_span(name: str, parent=None, attrs: Optional[Dict] = None):
    """Start a span without touching the context stack — for handles
    carried across threads (a serving request whose children are recorded
    by the batcher's worker). Caller must `.end()` it."""
    if not _ENABLED:
        return _NULL
    if parent is None:
        st = _stack()
        parent = st[-1] if st else None
    if parent is not None and not parent.sampled:
        return _NULL
    if parent is None:
        if not _sample_root():
            return _NULL
        trace_id = _next_id()
        parent_id = None
    else:
        trace_id = parent.trace_id
        parent_id = parent.span_id
    return Span(name, trace_id, _next_id(), parent_id,
                time.monotonic(), True, attrs)


class _SpanCtx:
    __slots__ = ("name", "attrs", "sp")

    def __init__(self, name, attrs):
        self.name = name
        self.attrs = attrs
        self.sp = _NULL

    def __enter__(self):
        self.sp = start_span(self.name, attrs=self.attrs)
        if self.sp.sampled:
            _stack().append(self.sp)
        return self.sp

    def __exit__(self, exc_type, exc, tb):
        if self.sp.sampled:
            st = _stack()
            if st and st[-1] is self.sp:
                st.pop()
            if exc_type is not None:
                self.sp.set_attr("error", f"{exc_type.__name__}: {exc}")
        self.sp.end()
        return False


def span(name: str, **attrs):
    """Context manager: start a span as a child of the current thread
    context, push it, end and pop it on exit (recording any exception)."""
    return _SpanCtx(name, attrs or None)


def capture_context():
    """This thread's innermost live span as a handle another thread can
    `adopt()`; None (and adopt(None) is a no-op) when nothing is live."""
    st = _stack()
    return st[-1] if st else None


class _AdoptCtx:
    __slots__ = ("ctx", "pushed")

    def __init__(self, ctx):
        self.ctx = ctx
        self.pushed = False

    def __enter__(self):
        if self.ctx is not None and getattr(self.ctx, "sampled", False):
            _stack().append(self.ctx)
            self.pushed = True
        return self.ctx

    def __exit__(self, exc_type, exc, tb):
        if self.pushed:
            st = _stack()
            if st and st[-1] is self.ctx:
                st.pop()
            elif self.ctx in st:
                st.remove(self.ctx)
        return False


def adopt(ctx):
    """Context manager: make a `capture_context()` handle (taken on
    another thread) this thread's current span, so children recorded here
    join the owning trace. The adopted span is not ended on exit: its
    owner ends it."""
    return _AdoptCtx(ctx)


def record_span(name: str, start: float, end: float, parent=None,
                trace_id: Optional[str] = None,
                attrs: Optional[Dict] = None):
    """Create an already-finished span from monotonic timestamps measured
    by the caller. Returns the span (its span_id can parent further
    retroactive spans)."""
    if not _ENABLED:
        return _NULL
    if parent is not None:
        if not parent.sampled:
            return _NULL
        tid, pid = parent.trace_id, parent.span_id
    elif trace_id is not None:
        tid, pid = trace_id, None
    else:
        if not _sample_root():
            return _NULL
        tid, pid = _next_id(), None
    sp = Span(name, tid, _next_id(), pid, float(start), True, attrs)
    sp.end(end=float(end))
    return sp


# --- read ------------------------------------------------------------------------

def recent_spans(n: Optional[int] = None, name: Optional[str] = None,
                 trace_id: Optional[str] = None) -> List[Dict[str, Any]]:
    """Finished spans, oldest first, optionally filtered by span name or
    trace id, optionally the last `n` after filtering."""
    with _LOCK:
        out = list(_SPANS)
    if name is not None:
        out = [s for s in out if s["name"] == name]
    if trace_id is not None:
        out = [s for s in out if s["trace_id"] == trace_id]
    if n is not None:
        out = out[-int(n):]
    return out


def trace_tree(trace_id: str) -> List[Dict[str, Any]]:
    """The spans of one trace as a forest: roots with nested "children"
    lists, children sorted by start time."""
    spans = recent_spans(trace_id=trace_id)
    by_id = {s["span_id"]: dict(s, children=[]) for s in spans}
    roots = []
    for s in by_id.values():
        parent = by_id.get(s["parent_id"]) if s["parent_id"] else None
        (parent["children"] if parent else roots).append(s)
    for s in by_id.values():
        s["children"].sort(key=lambda c: c["start"])
    roots.sort(key=lambda c: c["start"])
    return roots


def export_chrome_trace(path: str,
                        spans: Optional[List[Dict]] = None) -> int:
    """Write spans as chrome-trace / Perfetto JSON (`traceEvents` with
    complete "X" events, microsecond timestamps), one display row a trace.
    Returns the number of events written."""
    spans = recent_spans() if spans is None else spans
    pid = os.getpid()
    tids: Dict[str, int] = {}
    events = []
    for s in spans:
        tid = tids.setdefault(s["trace_id"], len(tids) + 1)
        args = {"span_id": s["span_id"], "trace_id": s["trace_id"]}
        args.update(s.get("attrs") or {})
        events.append({
            "name": s["name"], "ph": "X", "pid": pid, "tid": tid,
            "ts": s["start"] * 1e6,
            "dur": max(s["end"] - s["start"], 0.0) * 1e6,
            "cat": "paddle_tpu", "args": args,
        })
    for trace_id, tid in tids.items():
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": tid,
                       "args": {"name": f"trace {trace_id}"}})
    with open(path, "w") as f:
        json.dump({"traceEvents": events,
                   "displayTimeUnit": "ms"}, f)
    return len(events)


def export_jsonl(path: str, spans: Optional[List[Dict]] = None) -> int:
    """Write spans (default: the whole ring) as JSONL; returns the count."""
    spans = recent_spans() if spans is None else spans
    with open(path, "w") as f:
        for s in spans:
            f.write(json.dumps(s) + "\n")
    return len(spans)


maybe_enable_from_env()
