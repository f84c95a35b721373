"""The hot-row embedding cache of the port (paddle_tpu_torch.parallel.
emb_cache) on the CPU, held to the JAX package's (the port's counterpart of
tests/test_emb_cache.py): training through the cache equals the uncached
port (bitwise for sgd and momentum, whose remap is elementwise and whose
sums see the same values in the same order) and the JAX package's cached
run (within rtol 1e-5, atol 1e-6: the packages' update arithmetic rounds
in their own order), across a checkpoint save and restore; hits, misses,
evictions and compulsory misses equal to the reference's on one zipf id
stream; the residency machinery (LRU with a frequency tie-break, prefetch
counted by its consumer, flush); enable's validation; the read-only
serving cache; and DoubleBufferedFeeder.next_window(sparse_slots=).
"""

import torch_threads  # noqa: F401  (the cores shared among xdist workers)
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import executor as jax_executor
from paddle_tpu.parallel import emb_cache as jcache
from paddle_tpu.reader.pipeline import DoubleBufferedFeeder as JFeeder
import paddle_tpu_torch as pt
from paddle_tpu_torch.parallel import emb_cache
from paddle_tpu_torch.reader.pipeline import DoubleBufferedFeeder

ROWS, DIM, BSZ = 120, 8, 16
RTOL, ATOL = 1e-5, 1e-6
CPU = torch.device("cpu")

OPTS = {
    "sgd": lambda f: f.optimizer.SGD(learning_rate=0.1),
    "momentum": lambda f: f.optimizer.Momentum(learning_rate=0.1,
                                               momentum=0.9),
    "adam": lambda f: f.optimizer.Adam(learning_rate=0.01),
}


@pytest.fixture(autouse=True)
def _keep_jax_op_census():
    before = set(jax_executor._RECORDED_OPS)
    yield
    jax_executor._RECORDED_OPS.intersection_update(before)


def _build(fluid, opt, rows=ROWS, **emb_kw):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        ids = fluid.layers.data(name="ids", shape=[1], dtype="int64")
        lab = fluid.layers.data(name="lab", shape=[1], dtype="float32")
        emb = fluid.layers.embedding(
            input=ids, size=[rows, DIM],
            param_attr=fluid.ParamAttr(name="emb_w"),
            **({"is_sparse": True} | emb_kw))
        pred = fluid.layers.fc(input=emb, size=1,
                               param_attr=fluid.ParamAttr(name="fc_w"))
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, lab))
        OPTS[opt](fluid).minimize(loss)
    return main, startup, loss, pred


def _batches(n, rows=ROWS, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, rows, (BSZ, 1)).astype(np.int64),
             rng.standard_normal((BSZ, 1)).astype(np.float32))
            for _ in range(n)]


_STATE = {}


def _jax_state(opt):
    """The JAX startup's persistables of the test model, once per opt."""
    if opt not in _STATE:
        main, startup, _, _ = _build(jfluid, opt)
        scope = jax_executor.Scope()
        jfluid.Executor(jfluid.CPUPlace()).run(startup, scope=scope)
        _STATE[opt] = {n: np.array(scope.find_var(n))
                       for n, v in startup.global_block().desc.vars.items()
                       if v.persistable}
    return _STATE[opt]


def _port_setup(opt, cache_rows, **emb_kw):
    """(scope, exe, main, loss, pred, cache) of the port from the JAX
    startup's weights, the cache enabled when cache_rows is given."""
    main, _, loss, pred = _build(pt, opt, **emb_kw)
    scope = pt.Scope()
    pt.interop.load_numpy_params(scope, _jax_state(opt), "cpu")
    cache = None
    if cache_rows:
        cache = emb_cache.enable(main, tables={"emb_w": cache_rows},
                                 scope=scope)
        assert cache is not None
    return scope, pt.Executor(pt.CPUPlace()), main, loss, pred, cache


def _table(scope, cache, name="emb_w"):
    if cache is not None:
        cache.flush()
        return np.array(cache.host_value(name))
    return scope.find_var(name).numpy().copy()


def _port_train(opt, cache_rows, data):
    scope, exe, main, loss, _, cache = _port_setup(opt, cache_rows)
    losses = [float(np.ravel(exe.run(main, feed={"ids": i, "lab": l},
                                     fetch_list=[loss], scope=scope)[0])[0])
              for i, l in data]
    return np.asarray(losses, np.float32), _table(scope, cache), cache


def _jax_train(opt, cache_rows, data):
    main, _, loss, _ = _build(jfluid, opt)
    scope = jax_executor.Scope()
    for n, a in _jax_state(opt).items():
        scope.set_var(n, a.copy())
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jax_executor.scope_guard(scope):
        cache = jcache.enable(main, tables={"emb_w": cache_rows})
        losses = [float(np.ravel(exe.run(main, feed={"ids": i, "lab": l},
                                         fetch_list=[loss])[0])[0])
                  for i, l in data]
    cache.flush()
    return (np.asarray(losses, np.float32),
            np.array(cache.host_value("emb_w")), cache)


@pytest.mark.parametrize("opt", ["sgd", "momentum"])
def test_cached_training_parity(opt):
    """TestParity: 10 steps with a 48-row slab over the 120-row table,
    crossing real evictions: bitwise the uncached port, within tolerance of
    the JAX package's cached run, whose hit, miss and eviction counts it
    equals."""
    data = _batches(10, seed={"sgd": 0, "momentum": 1}[opt])
    l0, w0, _ = _port_train(opt, None, data)
    l1, w1, cache = _port_train(opt, 48, data)
    np.testing.assert_array_equal(l0, l1)
    np.testing.assert_array_equal(w0, w1)
    jl, jw, jc = _jax_train(opt, 48, data)
    np.testing.assert_allclose(l1, jl, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(w1, jw, rtol=RTOL, atol=ATOL)
    got, ref = cache.stats(), jc.stats()
    for k in ("hits", "misses", "compulsory_misses", "evictions",
              "flush_bytes"):
        assert got[k] == ref[k], k
    assert got["evictions"] > 0
    if opt == "momentum":
        assert len(cache.tables()["emb_w"].state_names) == 2


def _windowed(fluid, opt, cache_rows, ckpt_dir, data):
    """run_steps(K=4) fed by a DoubleBufferedFeeder(window_prefetch=2), a
    save/load_persistables round trip half way, Adam's moments cached
    beside the table."""
    if fluid is pt:
        scope, exe, main, loss, _, cache = _port_setup(opt, cache_rows)
        guard = pt.scope_guard(scope)
        feeder = lambda d: DoubleBufferedFeeder(  # noqa: E731
            lambda: ({"ids": i, "lab": l} for i, l in d), device=CPU,
            window_prefetch=2)
    else:
        main, _, loss, _ = _build(jfluid, opt)
        scope = jax_executor.Scope()
        for n, a in _jax_state(opt).items():
            scope.set_var(n, a.copy())
        exe = jfluid.Executor(jfluid.CPUPlace())
        guard = jax_executor.scope_guard(scope)
        with guard:
            cache = (jcache.enable(main, tables={"emb_w": cache_rows})
                     if cache_rows else None)
        guard = jax_executor.scope_guard(scope)
        feeder = lambda d: JFeeder(  # noqa: E731
            lambda: ({"ids": i, "lab": l} for i, l in d), window_prefetch=2)

    def train(lo, hi):
        f = feeder(data[lo:hi])
        out = []
        try:
            while True:
                o = exe.run_steps(main, reader=f, steps=4, fetch_list=[loss],
                                  fetch_mode="stack")
                out.extend(np.asarray(o[0]).ravel().tolist())
        except StopIteration:
            pass
        finally:
            f.stop()
        return out

    with guard:
        losses = train(0, 8)
        fluid.io.save_persistables(exe, str(ckpt_dir), main)
        fluid.io.load_persistables(exe, str(ckpt_dir), main)
        losses += train(8, 16)
        if cache is not None:
            cache.flush()
            w = np.array(cache.host_value("emb_w"))
            m = np.array(cache.host_value("emb_w_moment1_0"))
            assert len(cache.tables()["emb_w"].state_names) == 3
        else:
            w = np.array(scope.find_var("emb_w"))
            m = np.array(scope.find_var("emb_w_moment1_0"))
    return np.asarray(losses), w, m


def test_adam_windowed_with_checkpoint(tmp_path):
    """The training shape of bench.py's cache driver: the cached port
    equals the uncached port and the JAX package's cached run within
    tolerance across a checkpoint, whose save flushes first and writes the
    full host table (the restore invalidates the residency)."""
    data = _batches(16, seed=2)
    l0, w0, m0 = _windowed(pt, "adam", None, tmp_path / "dense", data)
    l1, w1, m1 = _windowed(pt, "adam", 64, tmp_path / "cached", data)
    jl, jw, jm = _windowed(jfluid, "adam", 64, tmp_path / "jax", data)
    assert l0.size == l1.size == jl.size == 16
    for a, b in ((l1, l0), (w1, w0), (m1, m0), (l1, jl), (w1, jw),
                 (m1, jm)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    with open(tmp_path / "cached" / "emb_w", "rb") as f:
        import pickle
        assert pickle.load(f)["tensor"].shape == (ROWS, DIM)


# --- residency ------------------------------------------------------------------

def _caches(cache_rows=3, rows=6):
    """The port's and the JAX package's cache over the same tiny program."""
    cache = _port_setup_rows(cache_rows, rows)[-1]
    jmain, jstartup, _, _ = _build(jfluid, "sgd", rows=rows)
    scope = jax_executor.Scope()
    with jax_executor.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(jstartup)
        jc = jcache.enable(jmain, tables={"emb_w": cache_rows})
    return cache, jc


def _port_setup_rows(cache_rows, rows):
    main, startup, loss, pred = _build(pt, "sgd", rows=rows)
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    cache = emb_cache.enable(main, tables={"emb_w": cache_rows}, scope=scope)
    return scope, exe, main, loss, pred, cache


def _feed(cache, ids):
    return cache.prepare_feed(
        {"ids": np.asarray(ids, np.int64).reshape(-1, 1)})


def _same(c, jc):
    s, r = c.stats(), jc.stats()
    for k in ("hits", "misses", "compulsory_misses", "evictions"):
        assert s[k] == r[k], (k, s, r)
    t, jt = c.tables()["emb_w"], jc.tables()["emb_w"]
    np.testing.assert_array_equal(t.id2slot, jt.id2slot)
    np.testing.assert_array_equal(t.dirty, jt.dirty)


def test_counting_and_compulsory_split():
    c, jc = _caches()
    for ids, want in (([0, 0, 1, 2], (0, 4, 4, 0)), ([0, 1, 3], (2, 5, 5, 1)),
                      ([2], (2, 6, 5, 2))):
        _feed(c, ids)
        _feed(jc, ids)
        s = c.stats()
        assert (s["hits"], s["misses"], s["compulsory_misses"],
                s["evictions"]) == want
        _same(c, jc)


def test_lru_freq_victim_choice():
    c, jc = _caches()
    for ids in ([0, 0, 1, 2], [1], [3]):
        _feed(c, ids)
        _feed(jc, ids)
    t = c.tables()["emb_w"]
    assert t.id2slot[2] == -1 and t.id2slot[0] >= 0 and t.id2slot[1] >= 0
    _same(c, jc)


@pytest.mark.parametrize("skew", [1.1, 1.3, 2.0])
def test_counts_equal_reference_on_a_zipf_stream(skew):
    """Thirty windows of zipf ids (clamped to the table) through both
    caches: hits, misses, compulsory misses, evictions and the maps equal
    after every window, prefetched and not, alternately."""
    c, jc = _caches(cache_rows=40, rows=200)
    rng = np.random.default_rng(int(skew * 10))
    for i in range(30):
        ids = np.minimum(rng.zipf(skew, (BSZ, 1)) - 1, 199).astype(np.int64)
        if i % 2:
            c.prefetch({"ids": np.unique(ids)}).wait()
            jc.prefetch({"ids": np.unique(ids)}).wait()
        out = c.prepare_feed({"ids": ids})
        jout = jc.prepare_feed({"ids": ids})
        np.testing.assert_array_equal(out["ids"], jout["ids"])
        _same(c, jc)


def test_remap_matches_slots_and_marks_dirty():
    c, _ = _caches()
    out = _feed(c, [4, 1, 4])
    t = c.tables()["emb_w"]
    np.testing.assert_array_equal(out["ids"].ravel(), t.id2slot[[4, 1, 4]])
    assert out["ids"].dtype == np.int64
    assert t.dirty[t.id2slot[[4, 1]]].all()


@pytest.mark.parametrize("ids,err,match", [
    ([0, 1, 2, 3], RuntimeError, "window union must fit"),
    ([0, 6], ValueError, "out of range")])
def test_rejected_feeds(ids, err, match):
    c, _ = _caches()
    with pytest.raises(err, match=match):
        _feed(c, ids)


def test_flush_writes_host_and_clears_dirty():
    scope, _, _, _, _, c = _port_setup_rows(3, 6)
    _feed(c, [0, 1])
    slab = scope.find_var("emb_w")
    t = c.tables()["emb_w"]
    slab[t.id2slot[0]] = 5.0          # what a step would have written
    assert c.flush() == 2 * DIM * 4 * len(t.state_names)
    assert not t.dirty.any()
    np.testing.assert_array_equal(c.host_value("emb_w")[0], np.full(DIM, 5.0))
    assert c.flush() == 0


def test_slab_keeps_its_storage():
    """Staging writes the slab in place: the scope's tensor, and its
    storage, never change."""
    scope, _, _, _, _, c = _port_setup_rows(3, 6)
    slab = scope.find_var("emb_w")
    ptr = slab.data_ptr()
    for ids in ([0, 1], [2, 3, 4], [5]):
        _feed(c, ids)
    assert scope.find_var("emb_w") is slab and slab.data_ptr() == ptr
    t = c.tables()["emb_w"]
    np.testing.assert_array_equal(slab[t.id2slot[5]].numpy(),
                                  c.host_value("emb_w")[5])


# --- prefetch ----------------------------------------------------------------------

def test_prefetched_rows_still_count_as_misses():
    c, jc = _caches(cache_rows=48, rows=ROWS)
    ids = np.array([[3], [5], [3], [9]], np.int64)
    for cache in (c, jc):
        cache.prefetch({"ids": np.unique(ids)}).wait()
    s = c.stats()
    assert (s["hits"], s["misses"]) == (0, 0)
    assert (c.tables()["emb_w"].id2slot[[3, 5, 9]] >= 0).all()
    for cache in (c, jc):
        cache.prepare_feed({"ids": ids})
    assert (c.stats()["hits"], c.stats()["misses"]) == (0, 4)
    for cache in (c, jc):
        cache.prepare_feed({"ids": ids})
    assert c.stats()["hits"] == 4
    _same(c, jc)


def test_partial_coverage_prefetch_is_discarded():
    c, _ = _caches(cache_rows=48, rows=ROWS)
    c.prefetch({"ids": np.array([1, 2])}).wait()
    c.prepare_feed({"ids": np.array([[1], [2], [7]], np.int64)})
    assert (c.stats()["hits"], c.stats()["misses"]) == (2, 1)


def test_overlap_accounting():
    c, _ = _caches(cache_rows=48, rows=ROWS)
    c.prefetch({"ids": np.arange(16)}).wait()
    s = c.stats()
    assert s["prefetch_seconds"] > 0
    assert 0.0 <= s["overlap_fraction"] <= 1.0


# --- enable -----------------------------------------------------------------------

def _prog(**emb_kw):
    main, startup, _, _ = _build(pt, "sgd", **emb_kw)
    return main, startup


@pytest.mark.parametrize("kw,match", [
    ({"is_sparse": False}, "is_sparse=False"),
    ({"padding_idx": 0}, "padding_idx")])
def test_enable_rejects(kw, match):
    main, _ = _prog(**kw)
    with pytest.raises(ValueError, match=match):
        emb_cache.enable(main, tables={"emb_w": 32})


def test_enable_rejects_a_table_read_outside_the_cache_aware_ops():
    main, _ = _prog()
    with pt.program_guard(main):
        pt.layers.scale(main.global_block().var("emb_w"), scale=2.0)
    with pytest.raises(ValueError, match="no slot-remap path"):
        emb_cache.enable(main, tables={"emb_w": 32})


def test_kill_switch(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_EMB_CACHE", "0")
    main, _ = _prog()
    assert emb_cache.enable(main, tables={"emb_w": 32}) is None


def test_table_fitting_in_budget_stays_uncached():
    main, startup = _prog()
    scope = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(startup, scope=scope)
    assert emb_cache.enable(main, budget_bytes=ROWS * DIM * 4 * 8,
                            scope=scope) is None
    # a budget of 40 rows of table and no accumulator (sgd)
    c = emb_cache.enable(main, budget_bytes=40 * DIM * 4, scope=scope)
    assert c.tables()["emb_w"].cache_rows == 40
    assert emb_cache.rows_for_budget(64 << 20, 64, 4, 3) == 87381


def test_layer_cache_rows_request_routes_to_enable():
    main, startup = _prog(cache_rows=40)
    scope = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(startup, scope=scope)
    c = emb_cache.enable(main, scope=scope)
    assert c.tables()["emb_w"].cache_rows == 40
    assert tuple(scope.find_var("emb_w").shape) == (40, DIM)
    assert isinstance(c.host_value("emb_w"), np.ndarray)


# --- serving ------------------------------------------------------------------------

def test_read_only_serving_cache(tmp_path):
    """TestServing: a model trained through the cache and saved (the save
    flushes and writes the full table) served by the uncached and the
    cached engine, both on the CPU: answers bitwise equal to each other
    and within tolerance of the JAX package's engine on the same
    directory; repeated ids hit; nothing flushed."""
    from paddle_tpu.serving import ServingEngine as JEngine
    from paddle_tpu_torch.serving import ServingEngine
    scope, exe, main, loss, pred, cache = _port_setup("sgd", 48)
    with pt.scope_guard(scope):
        for ids, lab in _batches(6, seed=3):
            exe.run(main, feed={"ids": ids, "lab": lab}, fetch_list=[loss])
        pt.io.save_inference_model(str(tmp_path), ["ids"], [pred], exe, main)
    eng0 = ServingEngine(str(tmp_path), place=pt.CPUPlace())
    eng1 = ServingEngine(str(tmp_path), place=pt.CPUPlace(),
                         emb_cache_budget_bytes=48 * DIM * 4)
    assert eng1.stats()["emb_cache"]["tables"]["emb_w"]["cache_rows"] == 48
    q = np.random.default_rng(3).integers(0, ROWS, (8, 1)).astype(np.int64)
    (a0,), (a1,) = eng0.run_batch({"ids": q}), eng1.run_batch({"ids": q})
    np.testing.assert_array_equal(a0, a1)
    (ja,) = JEngine(str(tmp_path)).run_batch({"ids": q})
    np.testing.assert_allclose(a1, np.asarray(ja), rtol=RTOL, atol=ATOL)
    eng1.run_batch({"ids": q})
    st = eng1.stats()["emb_cache"]
    assert st["hits"] > 0 and st["flush_bytes"] == 0


# --- the feeder's sparse slots -----------------------------------------------------

@pytest.mark.parametrize("prefetch", [1, 2])
def test_next_window_sparse_slots(prefetch):
    """next_window(k, sparse_slots=["ids"]) returns (window, {"ids": unique
    ids}) equal to the reference's, the ids kept on the host; windows and
    the dropped remainder as without sparse slots."""
    data = _batches(10, seed=7)
    mk = lambda: ({"ids": i, "lab": l} for i, l in data)  # noqa: E731
    port = DoubleBufferedFeeder(mk, device=CPU, window_prefetch=prefetch)
    ref = JFeeder(mk, window_prefetch=prefetch)
    try:
        for _ in range(2):
            w, u = port.next_window(4, sparse_slots=["ids"])
            jw, ju = ref.next_window(4, sparse_slots=["ids"])
            assert set(u) == set(ju) == {"ids"}
            np.testing.assert_array_equal(u["ids"], ju["ids"])
            for n in ("ids", "lab"):
                np.testing.assert_array_equal(np.asarray(w[n]),
                                              np.asarray(jw[n]))
            assert w["ids"].device.type == "cpu"
        with pytest.raises(StopIteration):
            port.next_window(4, sparse_slots=["ids"])
    finally:
        port.stop()
        ref.stop()
