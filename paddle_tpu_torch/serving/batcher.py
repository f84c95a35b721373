"""Dynamic request batching and overload control for the serving engine
(the port's counterpart of paddle_tpu/serving/batcher.py, whole).

`DynamicBatcher` is the concurrency layer between many client threads and
one `ServingEngine`: clients `submit(feed)` and get a
`concurrent.futures.Future`; a single worker thread coalesces queued
requests into the largest batch that fits the engine's top bucket, closes
the batch on **size-full OR deadline** (whichever first — small batches
don't wait forever, hot queues don't fragment), executes it through the
engine's bucket graphs, and scatters per-request result slices back to
the futures. On a CUDA place the worker makes the engine's card its
current device before its first call, and captures the bucket graphs
the engine has not captured yet (a capture checks only its own thread's
calls, so client threads building feeds run on beside it).

Overload control is reject-not-collapse: the queue is bounded
(`max_queue_depth` requests) and a full queue sheds new submissions with
`ServingOverloadError(reason="queue_full")` instead of letting latency
grow without bound; requests whose per-request deadline expires while
still queued are shed at batch-close with `reason="deadline"` rather than
wasting device time on answers nobody is waiting for. Goodput under
overload — the fraction of submitted requests that complete in time —
is the metric this policy optimizes, and `stats()`/telemetry expose it:
`serving_queue_depth` (gauge), `serving_shed_total{reason}`,
`serving_batches_total{close}`, and `serving_request_seconds{phase}`
histograms with phase in queue/compute/total (p50/p99 via
telemetry.histogram_quantile).
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import telemetry
from .. import tracing
from ..errors import ServingOverloadError
from . import slo as slo_mod


class _Request:
    __slots__ = ("feed", "rows", "future", "submit_t", "deadline_t",
                 "span")

    def __init__(self, feed, rows, deadline_t):
        self.feed = feed
        self.rows = rows
        self.future: Future = Future()
        self.submit_t = time.monotonic()
        self.deadline_t = deadline_t
        self.span = None


class DynamicBatcher:
    """Coalesce concurrent variable-size requests into bucketed batches.

    Not started by construction: call `start()` (or use as a context
    manager). A constructed-but-unstarted batcher accepts submissions into
    the bounded queue without draining it — deterministic ground for
    queue-full shedding tests.
    """

    def __init__(self, engine, max_batch: Optional[int] = None,
                 max_delay_ms: float = 5.0, max_queue_depth: int = 64,
                 slo: Optional["slo_mod.SLO"] = None):
        self.engine = engine
        self.max_batch = int(max_batch or engine.max_batch)
        if self.max_batch > engine.max_batch:
            raise ValueError(
                f"batcher max_batch {self.max_batch} exceeds the engine's "
                f"top bucket {engine.max_batch}")
        self.max_delay = float(max_delay_ms) / 1000.0
        self.max_queue_depth = int(max_queue_depth)
        self._label = getattr(engine, "_label", "p?")
        # every request outcome (completed / shed / failed) feeds the
        # model's burn-rate monitor, shared process-wide by model label
        self.slo_monitor = slo_mod.monitor_for(self._label, slo=slo)
        self._cond = threading.Condition()
        self._queue: "collections.deque[_Request]" = collections.deque()
        self._pending_rows = 0
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        # python-side mirrors of the telemetry series (tests + stats())
        self.submitted = 0
        self.completed = 0
        self.shed = 0
        self.close_counts: Dict[str, int] = {}

    # --- client side --------------------------------------------------------
    def submit(self, feed: Dict[str, np.ndarray],
               deadline_ms: Optional[float] = None) -> Future:
        """Enqueue one request; returns a Future resolving to the list of
        fetch arrays (this request's rows only). Sheds immediately —
        ServingOverloadError raised here, not via the future — when the
        queue is full or the batcher is stopped."""
        rows = None
        for name in self.engine.feed_names:
            if name not in feed:
                raise KeyError(f"missing feed '{name}'; engine feeds: "
                               f"{self.engine.feed_names}")
            n = np.asarray(feed[name]).shape[0]
            rows = n if rows is None else rows
            if n != rows:
                raise ValueError(f"feeds disagree on rows: '{name}' has "
                                 f"{n}, expected {rows}")
        if rows == 0:
            raise ValueError("empty request")
        if rows > self.max_batch:
            raise ValueError(
                f"request of {rows} rows exceeds max_batch "
                f"{self.max_batch}; split it client-side or call "
                f"engine.infer() directly")
        deadline_t = (time.monotonic() + deadline_ms / 1000.0
                      if deadline_ms is not None else None)
        with self._cond:
            self.submitted += 1
            if self._stop:
                self._shed_locked("shutdown")
                raise ServingOverloadError(
                    "serving batcher is stopped", reason="shutdown",
                    queue_depth=len(self._queue))
            if len(self._queue) >= self.max_queue_depth:
                self._shed_locked("queue_full")
                raise ServingOverloadError(
                    f"serving queue full ({len(self._queue)} requests "
                    f">= max_queue_depth {self.max_queue_depth})",
                    reason="queue_full", queue_depth=len(self._queue))
            req = _Request(feed, rows, deadline_t)
            if tracing.enabled():
                req.span = tracing.start_span(
                    "serving_request", parent=None,
                    attrs={"program": self._label, "rows": rows})
                # pin the span start to the submit timestamp so the
                # queue child tiles the parent exactly
                if req.span.sampled:
                    req.span.start = req.submit_t
            self._queue.append(req)
            self._pending_rows += rows
            self._depth_gauge_locked()
            self._cond.notify_all()
        return req.future

    # --- lifecycle ----------------------------------------------------------
    def start(self) -> "DynamicBatcher":
        with self._cond:
            if self._thread is not None:
                return self
            self._stop = False
            self._thread = threading.Thread(
                target=self._worker, name="serving-batcher", daemon=True)
            self._thread.start()
        return self

    def stop(self, drain: bool = True):
        """Stop the worker. With drain=True (default) queued requests are
        still executed; with drain=False they are shed with
        reason="shutdown"."""
        with self._cond:
            self._stop = True
            if not drain:
                while self._queue:
                    req = self._queue.popleft()
                    self._pending_rows -= req.rows
                    self._shed_locked("shutdown")
                    if req.span is not None:
                        req.span.end(outcome="shed", reason="shutdown")
                    req.future.set_exception(ServingOverloadError(
                        "serving batcher shut down", reason="shutdown",
                        queue_depth=len(self._queue)))
                self._depth_gauge_locked()
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # --- worker -------------------------------------------------------------
    def _worker(self):
        # a new thread's current CUDA device is 0 whatever the engine's: the
        # replays and captures run on the engine's card
        device = getattr(self.engine, "device", None)
        on_card = (torch.cuda.device(device)
                   if device is not None and device.type == "cuda"
                   else contextlib.nullcontext())
        with on_card:
            while True:
                batch, close = self._collect()
                if batch is None:
                    return
                if batch:
                    self._execute(batch, close)

    def _collect(self):
        """Block until a batch is ready; return (requests, close_reason).
        (None, _) signals worker exit. The batch window opens at the first
        queued request and closes when pending rows reach max_batch
        ("size") or max_delay elapses ("deadline")."""
        with self._cond:
            while not self._queue:
                if self._stop:
                    return None, ""
                self._cond.wait(0.05)
            close_t = self._queue[0].submit_t + self.max_delay
            while self._pending_rows < self.max_batch and not self._stop:
                remaining = close_t - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
            close = ("size" if self._pending_rows >= self.max_batch
                     else "deadline")
            batch: List[_Request] = []
            rows = 0
            while self._queue and rows + self._queue[0].rows \
                    <= self.max_batch:
                req = self._queue.popleft()
                self._pending_rows -= req.rows
                batch.append(req)
                rows += req.rows
            self._depth_gauge_locked()
            self.close_counts[close] = self.close_counts.get(close, 0) + 1
        telemetry.counter(
            "serving_batches_total",
            "batches closed, by close cause (size-full vs deadline)",
            labels=("program", "close")).labels(
                program=self._label, close=close).inc()
        return batch, close

    def _execute(self, batch: List[_Request], close: str):
        pop_t = time.monotonic()
        live: List[_Request] = []
        for req in batch:
            if req.deadline_t is not None and pop_t > req.deadline_t:
                # deadline-aware shedding: the answer would arrive after
                # the client stopped waiting — don't spend device time
                with self._cond:
                    self._shed_locked("deadline")
                if req.span is not None:
                    req.span.end(outcome="shed", reason="deadline")
                req.future.set_exception(ServingOverloadError(
                    f"deadline expired after "
                    f"{(pop_t - req.submit_t) * 1e3:.1f}ms in queue",
                    reason="deadline", queue_depth=len(self._queue)))
            else:
                live.append(req)
        if not live:
            return
        feed = {name: np.concatenate(
                    [np.asarray(r.feed[name]) for r in live], axis=0)
                for name in self.engine.feed_names}
        # phase marks: run_batch fills (start, end) monotonic pairs for
        # pad / bucket_select / compute so per-request child spans can be
        # recorded retroactively without a second clock on the hot path
        marks = ({} if any(r.span is not None and r.span.sampled
                           for r in live) else None)
        try:
            fetch = self.engine.run_batch(feed, _phase_marks=marks)
        except Exception as e:  # scatter the failure, keep serving
            for req in live:
                self.slo_monitor.record(ok=False)
                if req.span is not None:
                    req.span.end(outcome="error",
                                 error=f"{type(e).__name__}: {e}")
                if not req.future.cancelled():
                    req.future.set_exception(e)
            return
        done_t = time.monotonic()
        hist = telemetry.histogram(
            "serving_request_seconds",
            "per-request latency by phase (queue wait / device compute / "
            "total)", labels=("program", "phase"))
        off = 0
        # every scatter child starts where the compute mark ended: the
        # slice/convert/set_result stretch after compute is delivery
        # latency from each request's point of view, even though the
        # batch scatters results one request at a time
        scatter_t = (marks or {}).get("compute",
                                      (done_t, done_t))[1]
        with self._cond:
            # one bulk update, not a bare += per request: stats() reads
            # `completed` under the condition from client threads
            self.completed += len(live)
        for req in live:
            out = [f[off:off + req.rows] for f in fetch]
            off += req.rows
            req.future.set_result(out)
            hist.labels(program=self._label, phase="queue").observe(
                pop_t - req.submit_t)
            hist.labels(program=self._label, phase="compute").observe(
                done_t - pop_t)
            hist.labels(program=self._label, phase="total").observe(
                done_t - req.submit_t)
            self.slo_monitor.record(ok=True,
                                    latency_s=done_t - req.submit_t)
            if req.span is not None and req.span.sampled:
                self._record_children(
                    req, pop_t, done_t, marks or {}, close, scatter_t)

    def _record_children(self, req: _Request, pop_t: float, done_t: float,
                         marks: Dict, close: str,
                         scatter_start: float) -> float:
        """Record this request's queue/pad/bucket_select/compute/scatter
        children and end the parent span. The children tile the parent
        interval contiguously: queue ends at pop_t, pad absorbs the
        coalesce+validate+pad stretch up to the marks' pad end,
        bucket_select and compute come from the engine's marks, and
        scatter runs from the batch's compute end to the moment this
        request's result was delivered — so each request's child
        durations sum to its parent's within measurement noise (scatter
        children of co-batched requests overlap; they live in different
        traces)."""
        sp = req.span
        tracing.record_span("queue", req.submit_t, pop_t, parent=sp,
                            attrs={"close": close})
        pad = marks.get("pad")
        sel = marks.get("bucket_select")
        comp = marks.get("compute")
        pad_end = pad[1] if pad else pop_t
        tracing.record_span("pad", pop_t, pad_end, parent=sp,
                            attrs={"rows": req.rows})
        if sel:
            tracing.record_span("bucket_select", sel[0], sel[1],
                                parent=sp,
                                attrs={"bucket": marks.get("bucket")})
        if comp:
            tracing.record_span("compute", comp[0], comp[1], parent=sp,
                                attrs={"bucket": marks.get("bucket")})
        end_t = time.monotonic()
        tracing.record_span("scatter", scatter_start, end_t, parent=sp)
        sp.end(end=end_t, outcome="ok",
               bucket=marks.get("bucket"))
        return end_t

    # --- accounting ---------------------------------------------------------
    def _shed_locked(self, reason: str):
        self.shed += 1
        self.slo_monitor.record(ok=False)
        telemetry.counter(
            "serving_shed_total",
            "requests rejected by overload control, by cause",
            labels=("program", "reason")).labels(
                program=self._label, reason=reason).inc()

    def _depth_gauge_locked(self):
        telemetry.gauge(
            "serving_queue_depth",
            "requests waiting in the batcher queue",
            labels=("program",)).labels(program=self._label).set(
                len(self._queue))

    def queue_depth(self) -> int:
        with self._cond:
            return len(self._queue)

    def stats(self) -> Dict[str, object]:
        with self._cond:
            out = {
                "submitted": self.submitted,
                "completed": self.completed,
                "shed": self.shed,
                "queue_depth": len(self._queue),
                "close_counts": dict(self.close_counts),
                "goodput_fraction": (self.completed / self.submitted
                                     if self.submitted else 1.0),
            }
        out["slo"] = self.slo_monitor.report()
        return out
