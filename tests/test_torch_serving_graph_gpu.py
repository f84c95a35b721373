"""Serving on the card through one CUDA graph per bucket (ServingEngine on
a CUDA place), against the eager run of the same prepared program.

  * A small ResNet (a 3x3 stem conv_bn_layer of 64, a bottleneck of 64, two
    basicblocks 256->128 and 128->256 of stride 2, pool, fc 10, softmax)
    under AMP O2, in int8 and in fp8 (quantize=), and a small LM (2
    layers, d_model 128, 2 heads of 64, T 256, use_flash=True, logits) in
    O2: each bucket's first answer (warm-up, capture, replay in one call)
    and a later replay are bitwise the eager run of `engine._prepared.run`
    on the same padded input; the miss's warm-up and capture launch each
    kernel twice an eager run's count (K1, K11, Q1, K7 by the wrappers),
    a replay calls no wrapper.
  * LRU eviction at cache_capacity=1 drops the graph (its pinned staging
    buffers with it) and captures it again; hit and miss counts; a graph captured by the batcher's worker
    thread; PADDLE_TPU_QUANT (quant.QUANT) flipped between requests
    captures a new graph and never replays the old one under the new
    switch; close() gives the pool back.

The card has no CPU mode for the graphs, so every test here skips without a
CUDA device. This file imports no JAX: run it on the card without the
suite's conftest,

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_serving_graph_gpu.py

Tolerances: none; every comparison is bitwise.
"""

import torch_threads  # noqa: F401  (the cores shared among xdist workers)
import gc
import threading
import weakref

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import quant
from paddle_tpu_torch.models import resnet
from paddle_tpu_torch.ops import attention_cuda, conv_cuda, quant_cuda
from paddle_tpu_torch.serving import DynamicBatcher, ServingEngine
from paddle_tpu_torch.serving.engine import _pad_rows

BUCKETS = (1, 2, 4)
T, VOCAB = 256, 512


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("CUDA graphs need a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _resnet(amp):
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        img = pt.layers.data(name="img", shape=[3, 16, 16], dtype="float32")
        x = resnet.conv_bn_layer(img, 64, 3, 1, 1, is_test=True)
        x = resnet.bottleneck(x, 64, 64, 1, is_test=True)
        x = resnet.basicblock(x, 256, 128, 2, is_test=True)
        x = resnet.basicblock(x, 128, 256, 2, is_test=True)
        x = pt.layers.pool2d(x, pool_size=4, pool_type="avg",
                             global_pooling=True)
        logits = pt.layers.fc(x, size=10)
        prob = pt.layers.softmax(logits)
    if amp:
        pt.amp.enable(main, level="O2")
    return main, startup, [prob.name, logits.name]


def _lm():
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        tok = pt.layers.data(name="tok", shape=[-1, T], dtype="int64",
                             append_batch_size=False)
        lab = pt.layers.data(name="lab", shape=[-1, T], dtype="int64",
                             append_batch_size=False)
        _, logits = pt.models.transformer_lm(
            tok, lab, vocab_size=VOCAB, d_model=128, n_head=2, n_layer=2,
            use_flash=True, is_test=True, return_logits=True)
    pt.amp.enable(main, level="O2")
    return main, startup, [logits.name]


def _feeds(kind, sizes, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "lm":
        return [{"tok": rng.integers(0, VOCAB, (n, T)).astype(np.int64)}
                for n in sizes]
    return [{"img": rng.standard_normal((n, 3, 16, 16)).astype(np.float32)}
            for n in sizes]


def _engine(kind, **kw):
    """ServingEngine of `kind` (o2, int8, fp8, lm) on the card."""
    main, startup, fetch = _lm() if kind == "lm" else \
        _resnet(amp=kind == "o2")
    scope = pt.Scope()
    pt.Executor().run(startup, scope=scope)
    feed = ["tok"] if kind == "lm" else ["img"]
    quantize = kind if kind in ("int8", "fp8") else None
    kw.setdefault("buckets", BUCKETS)
    return ServingEngine(main, feed, fetch, scope=scope, quantize=quantize,
                         **kw)


def _eager(engine, feed):
    """The request through `engine._prepared.run` eagerly, padded as the
    engine pads it: the valid rows of each fetch on the host."""
    n = next(iter(feed.values())).shape[0]
    b = engine.bucket_for(n)
    padded = {k: torch.from_numpy(_pad_rows(np.asarray(v), b)).to(engine.device)
              for k, v in feed.items()}
    out = engine._prepared.run(padded, engine._state)
    return [o[:n].float().cpu().numpy() if o.dtype == torch.bfloat16
            else o[:n].cpu().numpy() for o in out]


def _launches():
    q1 = quant_cuda.COUNTERS.launches
    return {"k1": conv_cuda.COUNTERS.launches,
            "k11": conv_cuda.COUNTERS.q8_launches,
            "q1": sum(q1.values()) if isinstance(q1, dict) else q1,
            "k7": attention_cuda.COUNTERS.launches}


def _delta(before):
    return {k: v - before[k] for k, v in _launches().items()}


def _same(a, b):
    return len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["o2", "int8", "fp8", "lm"])
def test_bucket_replay_is_bitwise_its_eager_warmup(device, kind):
    engine = _engine(kind)
    for b, feed in zip(BUCKETS, _feeds(kind, (1, 2, 3))):
        c0 = _launches()
        want = _eager(engine, feed)
        eager = _delta(c0)
        assert any(eager.values()), eager
        c0 = _launches()
        first = engine.run_batch(feed)          # warm-up, capture, replay
        miss = _delta(c0)
        c0 = _launches()
        again = engine.run_batch(feed)          # replay
        replay = _delta(c0)
        assert _same(first, want), (kind, b)
        assert _same(again, want), (kind, b)
        assert miss == {k: 2 * v for k, v in eager.items()}, (kind, miss)
        assert not any(replay.values()), (kind, replay)
    assert (engine.cache_misses, engine.cache_hits) == (3, 3)
    assert all(g is not None for g in engine._graphs.values())
    engine.close()


@pytest.mark.gpu
def test_lru_eviction_frees_and_recaptures(device):
    engine = _engine("o2", buckets=(1, 2), cache_capacity=1)
    one, two = _feeds("o2", (1, 2), seed=1)
    first = engine.run_batch(one)
    held = next(iter(engine._graphs.values()))
    assert all(t.is_pinned() and t.shape[0] == 1
               for t in held.staging.values())
    graph = weakref.ref(held)
    staging = [weakref.ref(t) for t in held.staging.values()]
    del held
    engine.run_batch(two)                       # evicts bucket 1
    gc.collect()
    assert graph() is None
    assert all(t() is None for t in staging)    # its pinned buffers too
    again = engine.run_batch(one)               # captured again
    assert _same(first, again)
    st = engine.stats()
    assert (st["cache_misses"], st["cache_hits"], st["evictions"]) == (3, 0, 2)
    assert len(engine._graphs) == 1
    engine.close()


@pytest.mark.gpu
def test_hit_and_miss_counts(device):
    engine = _engine("o2")
    for feed in _feeds("o2", (1, 1, 2, 3, 4, 1, 2)):
        engine.run_batch(feed)
    st = engine.stats()
    assert (st["cache_misses"], st["cache_hits"], st["evictions"]) == (3, 4, 0)
    assert st["bucket_runs"] == {1: 3, 2: 2, 4: 2}
    engine.close()


@pytest.mark.gpu
def test_graph_captured_from_the_batchers_worker(device):
    """The batcher's worker thread captures the bucket graph (with client
    threads building feeds beside it), and the coalesced rows equal the
    same batch replayed afterwards."""
    engine = _engine("o2")
    feeds = _feeds("o2", (1, 2), seed=2)
    captured_on = []
    real = engine._prepared.capture

    def capture(*args, **kw):
        captured_on.append(threading.current_thread().name)
        return real(*args, **kw)

    engine._prepared.capture = capture
    b = DynamicBatcher(engine, max_delay_ms=20.0, max_queue_depth=8)
    futs = [b.submit(f) for f in feeds]
    stop = threading.Event()

    def client():
        rng = np.random.default_rng(3)
        while not stop.is_set():
            rng.standard_normal((4, 3, 16, 16)).astype(np.float32)

    t = threading.Thread(target=client)
    t.start()
    b.start()
    try:
        got = [f.result(timeout=120.0) for f in futs]
    finally:
        b.stop()
        stop.set()
        t.join(timeout=10.0)
    assert not t.is_alive()
    assert captured_on == ["serving-batcher"]
    whole = engine.run_batch({"img": np.concatenate([f["img"] for f in feeds])})
    assert _same(got[0], [w[0:1] for w in whole])
    assert _same(got[1], [w[1:3] for w in whole])
    assert engine.stats()["cache_misses"] == 1
    engine.close()


@pytest.mark.gpu
def test_quant_switch_captures_a_new_graph(device, monkeypatch):
    """quant.QUANT (PADDLE_TPU_QUANT) is in the graph key: flipped off
    between requests, the next request captures a graph of its own that
    runs no K11, bitwise the eager run under the new switch; flipped back,
    the first graph is hit again."""
    engine = _engine("int8")
    feed, = _feeds("int8", (2,), seed=4)
    on = engine.run_batch(feed)
    monkeypatch.setattr(quant, "QUANT", False)
    want_off = _eager(engine, feed)
    c0 = _launches()
    off = engine.run_batch(feed)
    assert _delta(c0)["k11"] == 0
    assert _same(off, want_off) and not _same(off, on)
    assert engine.stats()["cache_misses"] == 2
    monkeypatch.setattr(quant, "QUANT", True)
    back = engine.run_batch(feed)
    assert _same(back, on)
    st = engine.stats()
    assert (st["cache_misses"], st["cache_hits"]) == (2, 1)
    engine.close()


def _settled_reserved():
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved()


@pytest.mark.gpu
def test_close_gives_the_pool_back(device):
    """After a first engine's life (one-time workspaces), a second engine's
    graphs, pool and resident state go with its close()."""
    for _ in range(2):
        base = _settled_reserved()
        engine = _engine("o2")
        for feed in _feeds("o2", (1, 2, 4)):
            engine.run_batch(feed)
        assert _settled_reserved() > base
        engine.close()
        assert not engine._graphs and engine._pool is None
        with pytest.raises(RuntimeError):
            engine.run_batch(_feeds("o2", (1,))[0])
        del engine
    assert _settled_reserved() <= base
