"""Per-model SLOs with multi-window burn-rate evaluation (the port's
counterpart of paddle_tpu/serving/slo.py, whole).

An `SLO` declares what "good" means for one served model: an
availability objective (fraction of submitted requests answered — sheds,
deadline expiries, and engine failures all spend the error budget) and
an optional latency objective (a request slower than `latency_ms` counts
as bad even though it completed). `SLOMonitor` consumes one outcome per
request from the batcher and evaluates **burn rate** over two sliding
windows, the standard multi-window alerting shape:

    burn = (bad / total in window) / (1 - availability)

A burn rate of 1.0 means the error budget is being spent exactly at the
sustainable rate; the fast window (5 min) catches an active incident in
minutes, the slow window (1 h) confirms it is not a blip. Both surface
as `slo_burn_rate{model,window}` gauges, in `batcher.stats()["slo"]`,
and in `overload_report`'s `slo` sub-dict (the reference's `/healthz`
waits for the port's obs server, ROADMAP item 10).

Monitors register in a process-wide table (`monitor_for`), so a reader
can report on every served model without holding batcher refs.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Dict, Optional

from .. import telemetry

FAST_WINDOW_S = 300.0     # 5 min: page-fast incident detection
SLOW_WINDOW_S = 3600.0    # 1 h: sustained-burn confirmation

_REGISTRY_LOCK = threading.Lock()
_MONITORS: "Dict[str, SLOMonitor]" = {}


class SLO:
    """Objectives for one model. `availability` is the target fraction of
    good requests (error budget = 1 - availability); `latency_ms`, when
    set, marks slower-than-objective successes as bad too."""

    __slots__ = ("model", "availability", "latency_ms")

    def __init__(self, model: str, availability: float = 0.999,
                 latency_ms: Optional[float] = None):
        if not 0.0 < availability < 1.0:
            raise ValueError(
                f"availability must be in (0, 1), got {availability}")
        self.model = model
        self.availability = float(availability)
        self.latency_ms = float(latency_ms) if latency_ms is not None \
            else None

    @property
    def error_budget(self) -> float:
        return 1.0 - self.availability

    def to_dict(self) -> Dict[str, object]:
        return {"model": self.model, "availability": self.availability,
                "latency_ms": self.latency_ms,
                "error_budget": self.error_budget}


class SLOMonitor:
    """Sliding-window burn-rate evaluator for one SLO.

    `record()` is O(1) append under a lock (called from the batcher's
    worker and submit paths); `burn_rate()`/`report()` prune expired
    samples lazily. `clock` is injectable for deterministic tests."""

    def __init__(self, slo: SLO, max_samples: int = 65536,
                 clock: Callable[[], float] = time.monotonic):
        self.slo = slo
        self.clock = clock
        self._lock = threading.Lock()
        # (t, bad) pairs; bounded so a scrape-less process can't grow it
        self._samples: "collections.deque" = collections.deque(
            maxlen=int(max_samples))

    def record(self, ok: bool, latency_s: Optional[float] = None):
        """One request outcome. `ok=False` for sheds/failures; a
        completed request is still bad when it misses the latency
        objective."""
        bad = not ok
        if (not bad and latency_s is not None
                and self.slo.latency_ms is not None
                and latency_s * 1e3 > self.slo.latency_ms):
            bad = True
        with self._lock:
            self._samples.append((self.clock(), bad))

    def _window_counts(self, window_s: float, now: float):
        cutoff = now - window_s
        # only ever prune to the slow window — a fast-window query must
        # not destroy history the slow window still needs
        keep_cutoff = now - SLOW_WINDOW_S
        with self._lock:
            while self._samples and self._samples[0][0] < keep_cutoff:
                self._samples.popleft()
            # deque is time-ordered; after pruning to the slow window,
            # count the sub-window by scanning from the newest end
            total = bad = 0
            for t, b in reversed(self._samples):
                if t < cutoff:
                    break
                total += 1
                bad += b
        return total, bad

    def burn_rate(self, window_s: float = FAST_WINDOW_S,
                  now: Optional[float] = None) -> float:
        """Error-budget burn over the window; 0.0 when no traffic."""
        now = self.clock() if now is None else now
        total, bad = self._window_counts(window_s, now)
        if total == 0:
            return 0.0
        return (bad / total) / self.slo.error_budget

    def report(self, now: Optional[float] = None) -> Dict[str, object]:
        """Burn rates for both windows + raw counts; refreshes the
        `slo_burn_rate{model,window}` gauges as a side effect so scrapes
        see what the report saw."""
        now = self.clock() if now is None else now
        gauge = telemetry.gauge(
            "slo_burn_rate",
            "error-budget burn rate (1.0 = sustainable spend), by window",
            labels=("model", "window"))
        windows = {}
        for wname, wsec in (("fast", FAST_WINDOW_S), ("slow",
                                                      SLOW_WINDOW_S)):
            total, bad = self._window_counts(wsec, now)
            burn = ((bad / total) / self.slo.error_budget if total
                    else 0.0)
            gauge.labels(model=self.slo.model, window=wname).set(burn)
            windows[wname] = {"window_s": wsec, "total": total,
                              "bad": bad,
                              "error_rate": bad / total if total else 0.0,
                              "burn_rate": burn}
        return {"objective": self.slo.to_dict(), "windows": windows}


def monitor_for(model: str, slo: Optional[SLO] = None,
                **slo_kwargs) -> SLOMonitor:
    """Get-or-create the process-wide monitor for `model`. The first
    caller's objectives stick; later callers get the same monitor."""
    with _REGISTRY_LOCK:
        mon = _MONITORS.get(model)
        if mon is None:
            mon = SLOMonitor(slo or SLO(model, **slo_kwargs))
            _MONITORS[model] = mon
        return mon


def all_reports(now: Optional[float] = None) -> Dict[str, Dict]:
    """`report()` for every registered model."""
    with _REGISTRY_LOCK:
        mons = dict(_MONITORS)
    return {model: mon.report(now=now) for model, mon in mons.items()}


def reset():
    """Drop all registered monitors (tests)."""
    with _REGISTRY_LOCK:
        _MONITORS.clear()
