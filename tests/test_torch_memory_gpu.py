"""Memory accounting and OOM forensics on the card (paddle_tpu_torch.memory
with Executor.measure_memory, the tracker, and OOMError from an eager step
and from a CUDA graph capture).

  * measure_memory's peaks grow with the batch, hold at least the state
    and the feeds, and fit a HeadroomModel whose prediction at a third
    batch is within 10 % of the measurement there.
  * The tracker reads the caching allocator (source "device", the card's
    capacity as the limit); default_budget is the card's memory.
  * Under set_per_process_memory_fraction, a step past the limit raises
    errors.OOMError (breakdown, named buffers, the static record), the
    allocated bytes come back within 64 MiB once the error is dropped, and
    the next step runs; a capture past the limit (its warm-up with the
    limit lifted) raises OOMError naming the captured step's tensors,
    leaves the stream out of capture mode, and the next signature captures
    and replays. The tracker's read of the allocator's nested statistics
    equals torch.cuda.memory_stats().

Every test skips without a CUDA device. This file imports no JAX: run it
on the card without the suite's conftest,

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_memory_gpu.py
"""

import torch_threads  # noqa: F401  (the cores shared among xdist workers)
import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import errors, memory, telemetry
from paddle_tpu_torch import executor as E

pytestmark = pytest.mark.gpu

SLACK = 64 << 20


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    yield torch.device("cuda", 0)
    torch.cuda.set_per_process_memory_fraction(1.0)
    torch.cuda.empty_cache()


def _mlp(width=4096, depth=3):
    """An MLP whose activations dominate at large batches."""
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[width], dtype="float32")
        y = pt.layers.data(name="y", shape=[1], dtype="float32")
        h = x
        for _ in range(depth):
            h = pt.layers.fc(input=h, size=width, act="relu")
        pred = pt.layers.fc(input=h, size=1)
        loss = pt.layers.mean(pt.layers.square_error_cost(pred, y))
        pt.optimizer.Momentum(learning_rate=1e-4, momentum=0.9).minimize(loss)
    return main, startup, loss


def _feed(batch, width=4096, seed=0):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((batch, width), dtype=np.float32),
            "y": rng.standard_normal((batch, 1), dtype=np.float32)}


def _setup():
    main, startup, loss = _mlp()
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    return main, loss, exe, scope


def test_measured_peaks_fit_a_headroom_model(device):
    main, loss, exe, scope = _setup()
    recs = {}
    for b in (256, 512, 1024, 2048):
        exe.measure_memory(main, feed=_feed(b), fetch_list=[loss],
                           scope=scope)
        recs[b] = exe.measure_memory(main, feed=_feed(b), fetch_list=[loss],
                                     scope=scope)
        assert recs[b].source == "measured"
        assert recs[b].argument_bytes >= 4 * 4096 * 4096 * 3
    totals = [recs[b].total_bytes for b in sorted(recs)]
    assert totals == sorted(totals) and totals[0] < totals[-1]
    model = memory.HeadroomModel.fit(
        [(b, recs[b].total_bytes) for b in (256, 512, 1024)])
    assert abs(model.predict(2048) - recs[2048].total_bytes) <= \
        0.10 * recs[2048].total_bytes
    static = exe.static_memory_analysis(
        main, feed={"x": ((2048, 4096), np.float32),
                    "y": ((2048, 1), np.float32)},
        fetch_list=[loss], scope=scope)
    assert 0.3 < static.total_bytes / recs[2048].total_bytes < 3


def test_tracker_reads_the_allocator(device):
    main, loss, exe, scope = _setup()
    exe.run(main, feed=_feed(64), fetch_list=[loss], scope=scope)
    last = memory.tracker().last
    total = torch.cuda.mem_get_info()[1]
    assert last["source"] == "device" and last["limit_bytes"] == total
    assert 0 < last["bytes_in_use"] <= last["peak_bytes"] <= total
    assert last["classes"]["params"] > 4 * 4096 * 4096 * 3
    assert memory.default_budget() == total
    assert telemetry.read_gauge("hbm_limit_bytes", device="cuda:0") == total
    # the sample's nested read is the flat statistics' own numbers
    torch.cuda.synchronize()
    got, flat = memory._allocator_stats(device), torch.cuda.memory_stats()
    assert (got["bytes_in_use"], got["peak_bytes_in_use"],
            got["bytes_reserved"]) == (
        flat["allocated_bytes.all.current"], flat["allocated_bytes.all.peak"],
        flat["reserved_bytes.all.current"])


def _limit(nbytes):
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.set_per_process_memory_fraction(
        nbytes / torch.cuda.mem_get_info()[1])


def test_eager_oom_is_structured_and_recovers(device):
    main, loss, exe, scope = _setup()
    exe.run(main, feed=_feed(64), fetch_list=[loss], scope=scope,
            use_jit=False)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    # room for the batch-64 step (an eager Momentum step makes new
    # parameters and velocities beside the old ones), not for a batch of
    # 65536 rows: its 1 GiB feed crosses, its first 1 GiB activation fails
    _limit(before + (3 << 29))
    label = telemetry.program_label(main)
    memory.set_headroom(label, memory.HeadroomModel(before, 1 << 20),
                        before + (3 << 29))
    with pytest.raises(errors.OOMError) as ei:
        exe.run(main, feed=_feed(65536), fetch_list=[loss], scope=scope,
                use_jit=False)
    err = ei.value
    assert isinstance(err.__cause__, torch.cuda.OutOfMemoryError)
    assert err.breakdown["bytes_limit"] > 0 and err.breakdown["params"] > 0
    assert any(r["kind"] == "feed" and r["name"] == "x"
               for r in err.top_buffers)
    assert any("max_batch=1536" in s for s in err.suggestions)
    del err, ei
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    assert abs(torch.cuda.memory_allocated() - before) <= SLACK
    out, = exe.run(main, feed=_feed(64), fetch_list=[loss], scope=scope,
                   use_jit=False)
    assert np.isfinite(out).all()


def test_capture_oom_ends_the_capture_and_the_next_graph_replays(device):
    main, loss, exe, scope = _setup()
    big, small = _feed(16384), _feed(64)
    exe.run(main, feed=big, fetch_list=[loss], scope=scope)   # warm-up
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    _limit(before + (1 << 30))
    captures = E.COUNTERS.captures
    with pytest.raises(errors.OOMError) as ei:
        exe.run(main, feed=big, fetch_list=[loss], scope=scope)
    # the captured step's tensors are named among the ten largest
    assert any(r["name"] for r in ei.value.top_buffers[:10])
    del ei
    assert not torch.cuda.is_current_stream_capturing()
    assert E.COUNTERS.captures == captures
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    assert abs(torch.cuda.memory_allocated() - before) <= SLACK
    # the next signature's graph, the limit lifted: a graphed Momentum step
    # holds the state twice (its static buffers beside the scope's)
    torch.cuda.set_per_process_memory_fraction(1.0)
    replays = E.COUNTERS.replays
    outs = [exe.run(main, feed=small, fetch_list=[loss], scope=scope)[0]
            for _ in range(3)]
    assert E.COUNTERS.captures == captures + 1
    assert E.COUNTERS.replays == replays + 2
    assert all(np.isfinite(o).all() for o in outs)
