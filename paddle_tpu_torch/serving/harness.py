"""Concurrent-client load harness for the serving stack (the port's
counterpart of paddle_tpu/serving/harness.py).

Drives a `DynamicBatcher` with N client threads issuing back-to-back
requests and reports the serving numbers: p50/p99 end-to-end latency,
throughput (qps), the bucket-hit distribution from the engine's bucket
graphs, shed fraction, and goodput. `overload_report` runs the two-phase
experiment — a normal phase at N clients, then a 2x overload phase
against a bounded queue — showing the load-shedding policy holding
accepted-request latency while goodput (not availability) absorbs the
excess. The payload keys are the reference's. Its sentinel hang watchdog
around a load phase waits for the port's sentinel (ROADMAP item 10).
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import TimeoutError as _FutureTimeout
from typing import Callable, Dict, List, Optional

import numpy as np

from .. import telemetry
from ..errors import ServingOverloadError

_RESULT_TIMEOUT_S = 60.0


def run_load(batcher, make_feed: Callable[[int, int], Dict],
             clients: int = 4, requests_per_client: int = 8,
             deadline_ms: Optional[float] = None,
             label: str = "normal") -> Dict[str, object]:
    """Run `clients` threads, each submitting `requests_per_client`
    requests built by `make_feed(client_idx, request_idx)` and blocking on
    the future. Returns one phase payload with the serving trajectory
    keys (p50_ms/p99_ms/qps/shed_fraction/bucket_hits/goodput_fraction)."""
    engine = batcher.engine
    runs_before = dict(engine.bucket_runs)
    latencies_ms: List[float] = []
    ok = [0]
    shed = [0]
    timeouts = [0]
    errors = [0]
    lock = threading.Lock()

    def client(ci: int):
        for ri in range(requests_per_client):
            feed = make_feed(ci, ri)
            t0 = time.monotonic()
            try:
                fut = batcher.submit(feed, deadline_ms=deadline_ms)
                fut.result(timeout=_RESULT_TIMEOUT_S)
            except ServingOverloadError:
                with lock:
                    shed[0] += 1
                continue
            except _FutureTimeout:
                # a stuck future must not kill the client thread: count
                # the timeout outcome and keep issuing this client's
                # remaining requests
                with lock:
                    timeouts[0] += 1
                continue
            except Exception:
                # engine failure scattered onto the future — account it,
                # keep the load going
                with lock:
                    errors[0] += 1
                continue
            dt_ms = (time.monotonic() - t0) * 1e3
            with lock:
                ok[0] += 1
                latencies_ms.append(dt_ms)

    threads = [threading.Thread(target=client, args=(i,), daemon=True,
                                name=f"pd-serving-client-{i}")
               for i in range(clients)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall_s = max(time.monotonic() - t0, 1e-9)

    submitted = ok[0] + shed[0] + timeouts[0] + errors[0]
    bucket_hits = {
        str(b): engine.bucket_runs.get(b, 0) - runs_before.get(b, 0)
        for b in engine.buckets
        if engine.bucket_runs.get(b, 0) - runs_before.get(b, 0)}
    lat = np.asarray(latencies_ms, dtype=np.float64)
    payload = {
        "phase": label,
        "clients": clients,
        "requests": submitted,
        "p50_ms": float(np.percentile(lat, 50)) if lat.size else None,
        "p99_ms": float(np.percentile(lat, 99)) if lat.size else None,
        "qps": ok[0] / wall_s,
        "shed_fraction": shed[0] / submitted if submitted else 0.0,
        "goodput_fraction": ok[0] / submitted if submitted else 1.0,
        "timeouts": timeouts[0],
        "errors": errors[0],
        "bucket_hits": bucket_hits,
        "wall_s": wall_s,
    }
    # the telemetry path to the same percentiles (bucket-resolution): kept
    # in the payload so dashboards reading only metric series agree with
    # the harness's exact ones on rank ordering
    q50 = telemetry.histogram_quantile(
        "serving_request_seconds", 0.5,
        program=getattr(engine, "_label", "p?"), phase="total")
    q99 = telemetry.histogram_quantile(
        "serving_request_seconds", 0.99,
        program=getattr(engine, "_label", "p?"), phase="total")
    payload["telemetry_p50_ms"] = q50 * 1e3 if q50 is not None else None
    payload["telemetry_p99_ms"] = q99 * 1e3 if q99 is not None else None
    return payload


def overload_report(batcher, make_feed, clients: int = 4,
                    requests_per_client: int = 8,
                    deadline_ms: Optional[float] = None) -> Dict[str, object]:
    """The two-phase serving experiment: a normal phase at N clients, then
    an overload phase at 2N clients with a per-request deadline, against
    the batcher's bounded queue. The overload phase is expected to shed
    (shed_fraction > 0 under real pressure) while accepted requests keep
    completing — goodput degrades gracefully instead of latency
    collapsing."""
    mon = getattr(batcher, "slo_monitor", None)
    normal = run_load(batcher, make_feed, clients=clients,
                      requests_per_client=requests_per_client,
                      deadline_ms=deadline_ms, label="normal")
    # evaluate burn before the overload phase starts so the "normal"
    # rates reflect only normal-phase traffic inside the windows
    slo_normal = mon.report() if mon is not None else None
    overload = run_load(batcher, make_feed, clients=2 * clients,
                        requests_per_client=requests_per_client,
                        deadline_ms=deadline_ms, label="overload")
    slo_overload = mon.report() if mon is not None else None
    slo = None
    if mon is not None:
        slo = {
            "objective": mon.slo.to_dict(),
            "normal": {w: slo_normal["windows"][w]["burn_rate"]
                       for w in ("fast", "slow")},
            "overload": {w: slo_overload["windows"][w]["burn_rate"]
                         for w in ("fast", "slow")},
            "windows": slo_overload["windows"],
        }
    return {
        "normal": normal,
        "overload": overload,
        "engine": batcher.engine.stats(),
        "batcher": batcher.stats(),
        "slo": slo,
    }
