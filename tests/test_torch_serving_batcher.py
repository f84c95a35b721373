"""The rest of serving on the CPU: the port's ServingEngine bucket cache,
DynamicBatcher, load harness and SLOs, against the JAX package's.

The model is the fc classifier of tests/test_serving.py (16 -> fc 32 relu
-> fc 4, Adam), built through either package's layers DSL; the JAX
startup (and a few JAX Adam steps) make the weights, which are carried
into the port's scope by name (interop.load_numpy_params).

  * The reference's scenarios (tests/test_serving.py), on the port: the
    ladder; bitwise parity within one bucket; hit/miss/eviction with their
    telemetry series; feed validation and chunking; coalesce and scatter,
    bitwise; size against deadline close; queue_full sheds with accepted
    parity; the expired deadline shed at pop; the latency histograms of
    the concurrent harness; the SLO burn of overload_report.
  * The same sequences through both packages: results within f32 1e-5
    relative (both sum in f32, in another order); for the deterministic
    sequences the engines' and batchers' stats dicts and the serving
    series (read_series, the program label normalized) are equal.
  * Spans: with tracing on, a request's queue, pad, bucket_select, compute
    and scatter children tile the parent, with the JAX batcher's names and
    attributes.

On a CPU place every bucket runs eager (the graph gate's "cpu"): a
bucket's first run counts a miss, later runs hits, as in the reference.
"""

import torch_threads  # noqa: F401  (the cores shared among xdist workers)
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import executor as jexec
from paddle_tpu import serving as jserving
from paddle_tpu import telemetry as jtelemetry
from paddle_tpu import tracing as jtracing
from paddle_tpu.errors import ServingOverloadError as JaxOverloadError
from paddle_tpu.serving import slo as jslo
import paddle_tpu_torch as pt
from paddle_tpu_torch import serving, telemetry, tracing
from paddle_tpu_torch.errors import ServingOverloadError
from paddle_tpu_torch.serving import (DynamicBatcher, ServingEngine,
                                      bucket_ladder, overload_report,
                                      run_load)
from paddle_tpu_torch.serving import slo as slo_mod

IN, CLASSES = 16, 4
F32_RTOL = 1e-5


def _fc(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[IN], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="int64")
        h = fluid.layers.fc(input=x, size=32, act="relu")
        logits = fluid.layers.fc(input=h, size=CLASSES)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, y))
        fluid.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main, startup, logits.name, loss


def _models(train_steps=0):
    """The JAX package's classifier after `train_steps` Adam steps and the
    port's on the same weights: ((jax main, scope), (port main, scope),
    logits name)."""
    jmain, jstartup, logits, loss = _fc(jfluid)
    jscope = jexec.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    rng = np.random.RandomState(0)
    with jexec.scope_guard(jscope):
        exe.run(jstartup)
        for _ in range(train_steps):
            exe.run(jmain, feed={"x": rng.randn(8, IN).astype(np.float32),
                                 "y": rng.randint(0, CLASSES, (8, 1))
                                 .astype(np.int64)},
                    fetch_list=[loss])
    arrays = {n: np.array(jscope.find_var(n))
              for n, v in jmain.global_block().desc.vars.items()
              if v.persistable and jscope.find_var(n) is not None}
    pmain, _, plogits, _ = _fc(pt)
    assert plogits == logits
    pscope = pt.Scope()
    pt.interop.load_numpy_params(pscope, arrays, "cpu")
    return (jmain, jscope), (pmain, pscope), logits


def _engine(model, logits, **kw):
    main, scope = model
    return ServingEngine(main, ["x"], [logits], place=pt.CPUPlace(),
                         scope=scope, **kw)


def _jax_engine(model, logits, **kw):
    main, scope = model
    return jserving.ServingEngine(main, ["x"], [logits],
                                  place=jfluid.CPUPlace(), scope=scope, **kw)


def _port(train_steps=0, **kw):
    _, port, logits = _models(train_steps)
    return _engine(port, logits, **kw), port, logits


def _feed(rng, n):
    return {"x": rng.randn(n, IN).astype(np.float32)}


def _ctr(name, **labels):
    """One port counter series' value (0.0 when absent), labels in the
    family's declared order."""
    key = ",".join(f"{k}={v}" for k, v in labels.items())
    return telemetry.read_series(name).get(key, 0.0)


def _series(tel, name, label):
    """The series of one family that belong to program (or model) `label`,
    with the label written P, so the two packages' keys compare."""
    out = {}
    for key, v in tel.read_series(name).items():
        parts = key.split(",")
        if f"program={label}" in parts or f"model={label}" in parts:
            out[",".join("program=P" if p == f"program={label}" else
                         "model=P" if p == f"model={label}" else p
                         for p in parts)] = v
    return out


def _norm_stats(stats, label):
    """A batcher's stats() with the SLO objective's model label written P."""
    out = dict(stats)
    slo = dict(out["slo"])
    slo["objective"] = dict(slo["objective"], model="P")
    out["slo"] = slo
    return out


SERVING_SERIES = ("serving_cache_hit_total", "serving_cache_miss_total",
                  "serving_cache_evictions_total", "serving_bucket_runs_total",
                  "serving_shed_total", "serving_batches_total",
                  "serving_queue_depth", "slo_burn_rate")


def _same_series(jeng, eng, names=SERVING_SERIES):
    for name in names:
        assert _series(telemetry, name, eng._label) == \
            _series(jtelemetry, name, jeng._label), name


@pytest.fixture(autouse=True)
def _fresh_monitors():
    slo_mod.reset()
    jslo.reset()
    yield
    slo_mod.reset()
    jslo.reset()


# --- the reference's scenarios, on the port ---------------------------------

@pytest.mark.parametrize("max_batch", [1, 2, 3, 6, 8, 16, 64])
def test_bucket_ladder_shape(max_batch):
    assert bucket_ladder(max_batch) == jserving.bucket_ladder(max_batch)
    assert bucket_ladder(max_batch)[-1] == max_batch
    assert bucket_ladder(8) == (1, 2, 4, 8)
    with pytest.raises(ValueError):
        bucket_ladder(0)


def test_exports_match_reference():
    assert sorted(serving.__all__) == sorted(jserving.__all__)
    assert serving.training_only_op_types() == \
        jserving.training_only_op_types()


def test_batch_parity_bitwise():
    """Rows served alone == their slice of a padded batched run == a
    classic Executor.run on the same pruned program (within one bucket:
    bitwise); across buckets within f32 reassociation; and the JAX engine's
    answer within F32_RTOL."""
    jax_model, port, logits = _models(train_steps=3)
    eng = _engine(port, logits, buckets=[4])
    rng = np.random.RandomState(1)
    batch = _feed(rng, 3)                       # pads into bucket 4
    batched = eng.run_batch(dict(batch))[0]
    assert batched.shape == (3, CLASSES) and batched.dtype == np.float32
    for i in range(3):                          # same bucket: bitwise
        alone = eng.run_batch({"x": batch["x"][i:i + 1]})[0]
        assert np.array_equal(alone[0], batched[i])
    classic = pt.Executor(pt.CPUPlace()).run(
        eng.program, feed=dict(batch), fetch_list=[logits], scope=port[1])[0]
    assert np.array_equal(classic, batched)
    want = np.asarray(_jax_engine(jax_model, logits, buckets=[4])
                      .run_batch(dict(batch))[0])
    np.testing.assert_allclose(batched, want, rtol=F32_RTOL, atol=1e-6)
    eng.close()
    eng2 = _engine(port, logits, max_batch=8)
    batched2 = eng2.run_batch(dict(batch))[0]
    for i in range(3):
        alone = eng2.run_batch({"x": batch["x"][i:i + 1]})[0]
        np.testing.assert_allclose(alone[0], batched2[i], rtol=1e-6,
                                   atol=1e-6)
    eng2.close()


def test_bucket_cache_hit_miss_and_eviction():
    """First touch of a bucket is a miss, repeats are hits, and a
    capacity-1 cache LRU-evicts — mirrored in the serving_cache_* series;
    the same sequence through the JAX engine gives the same stats and
    series."""
    jax_model, port, logits = _models()
    rng = np.random.RandomState(2)
    sizes = [1, 1, 3, 4]
    feeds = [_feed(rng, n) for n in sizes]
    eng = _engine(port, logits, max_batch=8)
    jeng = _jax_engine(jax_model, logits, max_batch=8)
    for f in feeds:
        got = eng.run_batch(dict(f))[0]
        want = np.asarray(jeng.run_batch(dict(f))[0])
        np.testing.assert_allclose(got, want, rtol=F32_RTOL, atol=1e-6)
    assert (eng.cache_misses, eng.cache_hits) == (2, 2)
    label = eng._label
    assert _ctr("serving_cache_miss_total", program=label, bucket="1") == 1
    assert _ctr("serving_cache_hit_total", program=label, bucket="4") == 1
    assert eng.bucket_runs == {1: 2, 4: 2}
    hist = telemetry.read_histogram("serving_compile_seconds",
                                    program=label, bucket="1")
    assert hist and hist["count"] == 1
    assert eng.stats() == jeng.stats()
    _same_series(jeng, eng)
    eng.close()
    jeng.close()

    eng2 = _engine(port, logits, max_batch=8, cache_capacity=1)
    jeng2 = _jax_engine(jax_model, logits, max_batch=8, cache_capacity=1)
    for e in (eng2, jeng2):
        e.run_batch(_feed(rng, 1))
        e.run_batch(_feed(rng, 2))              # evicts bucket 1
        e.run_batch(_feed(rng, 1))              # miss again
    assert eng2.evictions == 2 and eng2.cache_misses == 3
    assert _ctr("serving_cache_evictions_total", program=eng2._label) == 2
    assert eng2.stats() == jeng2.stats()
    _same_series(jeng2, eng2)
    kinds = [(e["kind"], e.get("bucket")) for e in telemetry.recent_events()
             if e.get("program") == eng2._label]
    assert kinds == [("serving_admit", None), ("serving_compile", 1),
                     ("serving_compile", 2), ("serving_evict", 1),
                     ("serving_compile", 1), ("serving_evict", 2)]
    assert kinds == [(e["kind"], e.get("bucket"))
                     for e in jtelemetry.recent_events()
                     if e.get("program") == jeng2._label]
    eng2.close()
    jeng2.close()


def test_cpu_place_runs_eager_counted_by_reason():
    """On a CPU place the graph gate refuses every bucket ("cpu"): each
    bucket run is counted in serving_fallback_total, never silently."""
    eng, _, _ = _port(max_batch=4)
    rng = np.random.RandomState(12)
    for n in (1, 3, 4):
        eng.run_batch(_feed(rng, n))
    assert _ctr("serving_fallback_total", program=eng._label,
                reason="cpu") == 3
    assert eng._graphs and all(g is None for g in eng._graphs.values())
    eng.close()


def _staged(eng, n=2):
    return {"x": torch.from_numpy(np.random.RandomState(18)
                                  .randn(n, IN).astype(np.float32))}


def test_capture_refuses_a_program_that_writes_its_state():
    """A bucket graph reads the resident state in place, so a served
    program whose warm-up writes a persistable (here a `scale` of an fc
    weight into itself) raises before anything is captured."""
    main, startup, logits, _ = _fc(pt)
    block = main.global_block()
    w = block.var("fc_0.w_0")
    block.append_op(type="scale", inputs={"X": [w]}, outputs={"Out": [w]},
                    attrs={"scale": 2.0})
    scope = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(startup, scope=scope)
    eng = ServingEngine(main, ["x"], [logits, "fc_0.w_0"],
                        place=pt.CPUPlace(), scope=scope, max_batch=2)
    with pytest.raises(RuntimeError, match="writes persistables"):
        eng._prepared.capture(_staged(eng), eng._state)
    eng.close()


def test_capture_failure_raises():
    """Batch-norm-free serving passes the write check; a capture that then
    fails (no CUDA here) raises, naming the bucket, and nothing runs in its
    place."""
    eng, _, _ = _port(max_batch=2)
    with pytest.raises(RuntimeError, match="CUDA graph capture of a serving"):
        eng._prepared.capture(_staged(eng), eng._state)
    eng.close()


@pytest.mark.parametrize("feed,exc", [
    ({}, KeyError),
    ({"x": np.zeros((0, IN), np.float32)}, ValueError),
    ({"x": np.zeros((5, IN), np.float32)}, ValueError),      # over max_batch
    ({"x": np.zeros((2, IN, 1), np.float32)}, ValueError),   # rank
], ids=["missing", "empty", "over_max_batch", "rank"])
def test_run_batch_feed_validation(feed, exc):
    eng, _, _ = _port(max_batch=4)
    with pytest.raises(exc):
        eng.run_batch(feed)
    eng.close()


def test_infer_chunks_and_close():
    eng, _, _ = _port(max_batch=4)
    rng = np.random.RandomState(3)
    big = _feed(rng, 6)
    out = eng.infer(big)[0]
    assert out.shape == (6, CLASSES)
    assert np.array_equal(out[:4], eng.run_batch({"x": big["x"][:4]})[0])
    eng.close()
    assert eng.closed and eng.stats()["resident_state"] == 0
    with pytest.raises(RuntimeError):
        eng.infer(_feed(rng, 1))
    with pytest.raises(RuntimeError):
        eng.run_batch(_feed(rng, 1))


def test_batcher_coalesce_scatter_parity():
    """Requests from different clients coalesce into one bucket and each
    future gets exactly its own rows back, bitwise; the JAX batcher serves
    the same requests within F32_RTOL."""
    jax_model, port, logits = _models(train_steps=2)
    eng = _engine(port, logits, max_batch=8)
    rng = np.random.RandomState(4)
    feeds = [_feed(rng, n) for n in (1, 2, 3)]
    concat = eng.run_batch(
        {"x": np.concatenate([f["x"] for f in feeds])})[0]
    singles = [concat[0:1], concat[1:3], concat[3:6]]
    b = DynamicBatcher(eng, max_delay_ms=40.0, max_queue_depth=16)
    futs = [b.submit(f) for f in feeds]         # queue while stopped...
    b.start()                                   # ...so they coalesce
    try:
        got = [fut.result(timeout=30.0)[0] for fut in futs]
    finally:
        b.stop()
    for g, want in zip(got, singles):
        assert np.array_equal(g, want)
    st = b.stats()
    assert st["completed"] == 3 and st["shed"] == 0
    assert st["goodput_fraction"] == 1.0
    jb = jserving.DynamicBatcher(_jax_engine(jax_model, logits, max_batch=8),
                                 max_delay_ms=40.0, max_queue_depth=16)
    jfuts = [jb.submit(f) for f in feeds]
    jb.start()
    try:
        for g, fut in zip(got, jfuts):
            np.testing.assert_allclose(g, np.asarray(fut.result(30.0)[0]),
                                       rtol=F32_RTOL, atol=1e-6)
    finally:
        jb.stop()


def test_size_close_vs_deadline_close():
    eng, _, _ = _port(max_batch=4)
    rng = np.random.RandomState(5)
    # a full bucket must close on size long before a 5s deadline
    b = DynamicBatcher(eng, max_delay_ms=5000.0, max_queue_depth=16)
    futs = [b.submit(_feed(rng, 1)) for _ in range(4)]
    t0 = time.monotonic()
    b.start()
    try:
        for fut in futs:
            fut.result(timeout=30.0)
        assert time.monotonic() - t0 < 4.0      # did not wait out 5s
        assert b.close_counts.get("size", 0) >= 1
    finally:
        b.stop()
    # a lone request must close on deadline, not hang for size
    b = DynamicBatcher(eng, max_delay_ms=20.0, max_queue_depth=16).start()
    try:
        b.submit(_feed(rng, 1)).result(timeout=30.0)
        assert b.close_counts.get("deadline", 0) >= 1
    finally:
        b.stop()
    assert _ctr("serving_batches_total", program=eng._label,
                close="size") >= 1
    assert _ctr("serving_batches_total", program=eng._label,
                close="deadline") >= 1
    eng.close()


def test_overload_sheds_but_accepted_requests_keep_parity():
    """Bounded queue: overflow is rejected with ServingOverloadError
    (reason queue_full), and the accepted requests still return
    bitwise-correct results."""
    eng, _, _ = _port(train_steps=2, buckets=[2])
    rng = np.random.RandomState(6)
    feeds = [_feed(rng, 1) for _ in range(4)]
    singles = [eng.run_batch(dict(f))[0] for f in feeds]
    b = DynamicBatcher(eng, max_delay_ms=20.0, max_queue_depth=2)
    accepted = [b.submit(feeds[0]), b.submit(feeds[1])]
    shed = []
    for f in feeds[2:]:
        with pytest.raises(ServingOverloadError) as ei:
            b.submit(f)
        shed.append(ei.value)
    assert all(e.reason == "queue_full" and e.queue_depth == 2
               for e in shed)
    assert shed[0].to_dict() == {"type": "ServingOverloadError",
                                 "message": str(shed[0]),
                                 "reason": "queue_full", "queue_depth": 2}
    b.start()
    try:
        for fut, want in zip(accepted, singles):
            assert np.array_equal(fut.result(timeout=30.0)[0], want)
    finally:
        b.stop()
    st = b.stats()
    assert st["shed"] == 2 and st["completed"] == 2
    assert st["goodput_fraction"] == pytest.approx(0.5)
    assert _ctr("serving_shed_total", program=eng._label,
                reason="queue_full") == 2
    eng.close()


def test_expired_deadline_sheds_at_pop():
    eng, _, _ = _port(max_batch=4)
    rng = np.random.RandomState(7)
    b = DynamicBatcher(eng, max_delay_ms=30.0, max_queue_depth=8)
    fut = b.submit(_feed(rng, 1), deadline_ms=0.0)  # expired on arrival
    live = b.submit(_feed(rng, 2))                  # rides the same batch
    b.start()
    try:
        with pytest.raises(ServingOverloadError) as ei:
            fut.result(timeout=30.0)
        assert ei.value.reason == "deadline"
        assert live.result(timeout=30.0)[0].shape == (2, CLASSES)
    finally:
        b.stop()
    assert _ctr("serving_shed_total", program=eng._label,
                reason="deadline") == 1
    eng.close()


def test_engine_failure_scatters_and_keeps_serving():
    """An engine failure reaches every future of its batch, counts against
    the SLO, and the worker goes on serving."""
    eng, _, _ = _port(max_batch=4)
    rng = np.random.RandomState(13)
    real = eng.run_batch
    calls = []

    def failing_once(feed, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("device lost")
        return real(feed, **kw)

    eng.run_batch = failing_once
    b = DynamicBatcher(eng, max_delay_ms=5.0, max_queue_depth=8)
    bad = b.submit(_feed(rng, 1))
    b.start()
    try:
        with pytest.raises(RuntimeError, match="device lost"):
            bad.result(timeout=30.0)
        ok = b.submit(_feed(rng, 2)).result(timeout=30.0)
        assert ok[0].shape == (2, CLASSES)
    finally:
        b.stop()
        eng.run_batch = real
    win = b.stats()["slo"]["windows"]["fast"]
    assert (win["total"], win["bad"]) == (2, 1)
    eng.close()


def test_concurrent_client_smoke_latency_histograms():
    """In-process concurrent-client harness: non-degenerate p50 <= p99,
    and the same quantiles recoverable from the serving_request_seconds
    histogram."""
    eng, _, _ = _port(max_batch=8)
    rng = np.random.RandomState(11)
    for n in (1, 2, 4):                         # warm the ladder
        eng.run_batch(_feed(rng, n))
    lock = threading.Lock()

    def make_feed(ci, ri):
        with lock:                              # RandomState is not thread-safe
            return _feed(rng, 1 + (ci + ri) % 3)

    b = DynamicBatcher(eng, max_delay_ms=3.0, max_queue_depth=32)
    b.start()
    try:
        payload = run_load(b, make_feed, clients=3, requests_per_client=4)
    finally:
        b.stop()
    assert set(payload) == {
        "phase", "clients", "requests", "p50_ms", "p99_ms", "qps",
        "shed_fraction", "goodput_fraction", "timeouts", "errors",
        "bucket_hits", "wall_s", "telemetry_p50_ms", "telemetry_p99_ms"}
    assert payload["requests"] == 12
    assert 0.0 < payload["p50_ms"] <= payload["p99_ms"]
    assert payload["qps"] > 0 and payload["goodput_fraction"] == 1.0
    assert sum(payload["bucket_hits"].values()) >= 1
    assert payload["telemetry_p50_ms"] is not None
    assert payload["telemetry_p50_ms"] <= payload["telemetry_p99_ms"]
    for phase in ("queue", "compute", "total"):
        h = telemetry.read_histogram("serving_request_seconds",
                                     program=eng._label, phase=phase)
        assert h and h["count"] >= 12
    eng.close()


def test_overload_report_slo_and_latency_bound():
    """Injected overload drives the SLO fast-window burn above 1.0 while
    the normal phase stays below, and the accepted-request p99 under
    overload stays within a bound of the normal phase's; the report
    carries the reference's keys."""
    eng, _, _ = _port(train_steps=2, buckets=[4])
    rng = np.random.RandomState(8)
    eng.run_batch(_feed(rng, 4))                # warm the only bucket
    real_run_batch = eng.run_batch

    def slow_run_batch(feed, **kw):
        time.sleep(0.015)
        return real_run_batch(feed, **kw)

    eng.run_batch = slow_run_batch
    b = DynamicBatcher(eng, max_delay_ms=30.0, max_queue_depth=4)
    b.start()
    try:
        report = overload_report(
            b, lambda ci, ri: _feed(np.random.RandomState(ci * 97 + ri), 2),
            clients=4, requests_per_client=6)
    finally:
        b.stop()
        eng.run_batch = real_run_batch
        eng.close()
    assert set(report) == {"normal", "overload", "engine", "batcher", "slo"}
    normal, over = report["normal"], report["overload"]
    assert over["shed_fraction"] > 0.0
    assert normal["p99_ms"] is not None and over["p99_ms"] is not None
    assert over["p99_ms"] <= 6.0 * normal["p99_ms"] + 150.0
    slo = report["slo"]
    assert set(slo) == {"objective", "normal", "overload", "windows"}
    assert set(slo["windows"]) == {"fast", "slow"}
    assert slo["objective"]["availability"] == pytest.approx(0.999)
    assert slo["overload"]["fast"] > 1.0
    assert slo["normal"]["fast"] <= 1.0
    assert report["batcher"]["slo"]["windows"]["fast"]["bad"] > 0
    assert report["engine"]["cache_misses"] == 1


# --- the same sequences through both packages --------------------------------

def _unstarted(b, feeds):
    """Submit to a batcher that was never started; -> the outcome of each
    submit ("ok" or the shed reason)."""
    out = []
    for f in feeds:
        try:
            b.submit(f)
            out.append("ok")
        except (ServingOverloadError, JaxOverloadError) as e:
            out.append(e.reason)
    return out


def _shutdown(b, feeds):
    """Submit, then stop(drain=False): queued requests shed at shutdown,
    and a submit after the stop sheds too."""
    futs = [b.submit(f) for f in feeds[:-1]]
    b.stop(drain=False)
    reasons = []
    for fut in futs:
        with pytest.raises((ServingOverloadError, JaxOverloadError)) as ei:
            fut.result(timeout=5.0)
        reasons.append(ei.value.reason)
    with pytest.raises((ServingOverloadError, JaxOverloadError)) as ei:
        b.submit(feeds[-1])
    return reasons + [ei.value.reason]


@pytest.mark.parametrize("sequence,depth,n", [
    (_unstarted, 3, 5), (_unstarted, 8, 4), (_shutdown, 8, 4),
    (_shutdown, 2, 3)], ids=["queue_full", "within_depth", "shutdown",
                             "shutdown_full"])
def test_deterministic_sequences_match_reference(sequence, depth, n):
    """A batcher that never starts (queue_full sheds past the depth), and
    submits followed by stop(drain=False): the outcomes, both batchers'
    stats() and the serving series are equal."""
    jax_model, port, logits = _models()
    rng = np.random.RandomState(14)
    feeds = [_feed(rng, 1 + i % 2) for i in range(n)]
    eng, jeng = _engine(port, logits, max_batch=4), \
        _jax_engine(jax_model, logits, max_batch=4)
    b = DynamicBatcher(eng, max_delay_ms=5.0, max_queue_depth=depth)
    jb = jserving.DynamicBatcher(jeng, max_delay_ms=5.0,
                                 max_queue_depth=depth)
    assert sequence(b, feeds) == sequence(jb, feeds)
    assert _norm_stats(b.stats(), eng._label) == \
        _norm_stats(jb.stats(), jeng._label)
    assert eng.stats() == jeng.stats()
    _same_series(jeng, eng)
    eng.close()
    jeng.close()


@pytest.mark.parametrize("sizes,max_delay_ms", [
    ((1, 2, 3), 20.0),              # 6 rows < 8: one deadline close
    ((4, 4, 2, 1), 2000.0),         # 8 rows: a size close, then a deadline
    ((3, 3, 3, 3, 1), 20.0),        # 13 rows over two batches
], ids=["deadline", "size_then_deadline", "two_batches"])
def test_same_requests_through_both_batchers(sizes, max_delay_ms):
    """The same requests, queued before start, through the port's and the
    JAX batcher: each future's rows within F32_RTOL, equal close counts,
    bucket runs and stats."""
    jax_model, port, logits = _models(train_steps=2)
    rng = np.random.RandomState(15)
    feeds = [_feed(rng, n) for n in sizes]
    results, stats = [], []
    for make, mk_batcher, model in (
            (_engine, DynamicBatcher, port),
            (_jax_engine, jserving.DynamicBatcher, jax_model)):
        eng = make(model, logits, max_batch=8)
        b = mk_batcher(eng, max_delay_ms=max_delay_ms, max_queue_depth=16)
        futs = [b.submit(f) for f in feeds]
        b.start()
        try:
            results.append([np.asarray(f.result(timeout=30.0)[0])
                            for f in futs])
        finally:
            b.stop()
        st = _norm_stats(b.stats(), eng._label)
        stats.append((st, eng.stats()))
        eng.close()
    for got, want, f in zip(*results, feeds):
        assert got.shape == (f["x"].shape[0], CLASSES)
        np.testing.assert_allclose(got, want, rtol=F32_RTOL, atol=1e-6)
    assert stats[0] == stats[1]


# --- spans ---------------------------------------------------------------------

SPAN_CHILDREN = ["queue", "pad", "bucket_select", "compute", "scatter"]


def _request_tree(tr, batcher_cls, eng, feed):
    """One request through a fresh batcher with tracing on: its span tree."""
    tr.reset()
    tr.enable()
    try:
        b = batcher_cls(eng, max_delay_ms=5.0, max_queue_depth=4)
        fut = b.submit(feed)
        b.start()
        try:
            fut.result(timeout=30.0)
        finally:
            b.stop()
        root = tr.recent_spans(name="serving_request")
        assert len(root) == 1
        tree = tr.trace_tree(root[0]["trace_id"])
    finally:
        tr.reset()
    assert len(tree) == 1
    return tree[0]


def _shape_of(tree, label):
    def attrs(a):
        return {k: ("P" if k == "program" and v == label else v)
                for k, v in a.items()}
    return (tree["name"], attrs(tree["attrs"]),
            [(c["name"], attrs(c["attrs"])) for c in tree["children"]])


@pytest.mark.parametrize("rows", [1, 3])
def test_request_spans_tile_the_parent_like_the_reference(rows):
    jax_model, port, logits = _models()
    feed = _feed(np.random.RandomState(16), rows)
    eng = _engine(port, logits, max_batch=4)
    jeng = _jax_engine(jax_model, logits, max_batch=4)
    tree = _request_tree(tracing, DynamicBatcher, eng, feed)
    jtree = _request_tree(jtracing, jserving.DynamicBatcher, jeng, feed)
    assert [c["name"] for c in tree["children"]] == SPAN_CHILDREN
    assert _shape_of(tree, eng._label) == _shape_of(jtree, jeng._label)
    assert tree["attrs"] == {"program": eng._label, "rows": rows,
                             "outcome": "ok", "bucket": eng.bucket_for(rows)}
    kids = tree["children"]
    assert kids[0]["start"] == tree["start"]
    assert kids[-1]["end"] == tree["end"]
    for a, b in zip(kids, kids[1:]):
        assert a["end"] == b["start"], (a["name"], b["name"])
    assert sum(k["dur_s"] for k in kids) == pytest.approx(tree["dur_s"],
                                                          abs=1e-9)
    assert all(k["trace_id"] == tree["trace_id"] and
               k["parent_id"] == tree["span_id"] for k in kids)
    eng.close()
    jeng.close()


def test_no_spans_when_tracing_is_off():
    tracing.reset()
    eng, _, _ = _port(max_batch=4)
    b = DynamicBatcher(eng, max_delay_ms=2.0).start()
    try:
        b.submit(_feed(np.random.RandomState(17), 1)).result(timeout=30.0)
    finally:
        b.stop()
    assert tracing.recent_spans() == []
    eng.close()
