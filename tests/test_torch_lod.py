"""The port's LoD core (paddle_tpu_torch/executor.py: LoDTensor, the padded
convention with `@SEQLEN` lengths, their propagation) held against the JAX
package on the CPU: `_bucket_len` and both pack/unpack functions bitwise
the reference's at LoD levels 1 and 2 (empty sequences included); LoDTensor
feeds and fetches through both executors; lengths through a window and a
plain op; run_steps' per-step fallback; DataFeeder's LoD slots;
ServingEngine.infer on a LoD request (reason "lod"); and on the graph path
(the capture stood in for on the CPU), LoD feeds and dropout replayed
bitwise the eager steps.

Tolerances: the pack functions, fetches of fed values and the DataFeeder
arrays are compared bitwise; computed values with f32 rtol 1e-5, atol 1e-6.
"""

import torch_threads  # noqa: F401  (the cores shared among xdist workers)
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import data_feeder as jax_feeder
from paddle_tpu import executor as jax_executor
from paddle_tpu.serving import ServingEngine as JaxServingEngine
import paddle_tpu_torch as pt
from paddle_tpu_torch import executor as E
from paddle_tpu_torch import telemetry
from paddle_tpu_torch.serving import ServingEngine

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _keep_jax_op_census():
    before = set(jax_executor._RECORDED_OPS)
    yield
    jax_executor._RECORDED_OPS.intersection_update(before)


def _lod(fluid, rows, lod):
    cls = pt.LoDTensor if fluid is pt else jax_executor.LoDTensor
    return cls(rows, lod)


def _offsets(lens):
    return np.concatenate([[0], np.cumsum(lens)]).astype(int).tolist()


# --- the pack functions ---------------------------------------------------------

def test_bucket_len_is_the_reference():
    for n in range(0, 1300):
        assert E._bucket_len(n) == jax_executor._bucket_len(n), n


LEVEL1 = [[3, 0, 5, 1], [0, 0], [9], [17, 2, 64, 65], []]
LEVEL2 = [[[2, 3], [1], [4, 2, 1]], [[0], [3, 0]], [[], [5]],
          [[70], [1, 1, 1, 1, 1, 1, 1, 1, 1]]]


@pytest.mark.parametrize("lens", LEVEL1, ids=[str(x) for x in LEVEL1])
def test_pack_level1_bitwise(lens):
    rng = np.random.default_rng(0)
    flat = rng.standard_normal((int(sum(lens)), 3)).astype(np.float32)
    lod = [_offsets(lens)]
    got = E.pack_to_padded(flat, lod)
    want = jax_executor.pack_to_padded(flat, lod)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] is None and want[2] is None
    back = E.padded_to_pack(got[0], got[1])
    ref = jax_executor.padded_to_pack(want[0], want[1])
    np.testing.assert_array_equal(back[0], ref[0])
    assert back[1] == ref[1] == lod
    np.testing.assert_array_equal(back[0], flat)


@pytest.mark.parametrize("docs", LEVEL2, ids=[str(x) for x in LEVEL2])
def test_pack_level2_bitwise(docs):
    outer = _offsets([len(d) for d in docs])
    inner = _offsets([n for d in docs for n in d])
    flat = np.arange(inner[-1] * 2, dtype=np.float32).reshape(-1, 2)
    got = E.pack_to_padded(flat, [outer, inner])
    want = jax_executor.pack_to_padded(flat, [outer, inner])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    back = E.padded_to_pack(*got)
    ref = jax_executor.padded_to_pack(*want)
    np.testing.assert_array_equal(back[0], ref[0])
    assert back[1] == ref[1]


# --- feeds, fetches, propagation ----------------------------------------------

def _run_both(build, feed, return_numpy=True):
    outs = []
    for fluid in (jfluid, pt):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            fetch = build(fluid)
        exe = fluid.Executor(fluid.CPUPlace())
        scope = pt.Scope() if fluid is pt else jax_executor.Scope()
        exe.run(startup, scope=scope)
        outs.append(exe.run(main, feed=feed(fluid), fetch_list=fetch,
                            scope=scope, return_numpy=return_numpy))
    return outs


@pytest.mark.parametrize("level", [1, 2])
def test_lod_feed_fetch_round_trip(level):
    rng = np.random.default_rng(1)
    if level == 1:
        lod = [_offsets([4, 1, 6])]
    else:
        lod = [_offsets([2, 1, 3]), _offsets([2, 3, 1, 4, 2, 1])]
    rows = rng.standard_normal((lod[-1][-1], 3)).astype(np.float32)

    def build(fluid):
        x = fluid.layers.data(name="x", shape=[3], dtype="float32",
                              lod_level=level)
        return [x, fluid.layers.scale(x, scale=2.0)]

    want, got = _run_both(build, lambda f: {"x": _lod(f, rows, lod)},
                          return_numpy=False)
    for w, g in zip(want, got):
        assert isinstance(g, pt.LoDTensor) and g.lod == w.lod == lod
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    np.testing.assert_array_equal(np.asarray(got[0]), rows)
    # numpy mode: the packed rows
    want, got = _run_both(build, lambda f: {"x": _lod(f, rows, lod)})
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    assert got[1].shape == rows.shape


def test_lengths_propagate_through_a_window_and_a_plain_op():
    """A chain window (relu, scale: run by fusion.execute_group), an fc_act
    window and a plain op (softmax) all pass the feed's lengths on: their
    fetches come back packed with the feed's LoD in both packages; a
    reduction over time drops them."""
    rng = np.random.default_rng(2)
    lod = [_offsets([3, 5, 2])]
    rows = rng.standard_normal((10, 4)).astype(np.float32)

    def build(fluid):
        L = fluid.layers
        x = L.data(name="x", shape=[4], dtype="float32", lod_level=1)
        chain = L.scale(L.relu(x), scale=3.0)
        fc = L.fc(chain, size=6, num_flatten_dims=2, act="relu")
        sm = L.softmax(fc)
        pooled = L.sequence_pool(sm, "sum")
        return [chain, fc, sm, pooled]

    jmain, jfetch, jscope, jexe, arrays = _jax_start(build)
    main, fetch, scope, exe = _port_start(build, arrays)
    want = jexe.run(jmain, feed={"x": _lod(jfluid, rows, lod)},
                    fetch_list=jfetch, scope=jscope, return_numpy=False)
    got = exe.run(main, feed={"x": _lod(pt, rows, lod)}, fetch_list=fetch,
                  scope=scope, return_numpy=False)
    for w, g in zip(want[:3], got[:3]):
        assert isinstance(g, pt.LoDTensor) and g.lod == w.lod == lod
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), **TOL)
    assert not isinstance(got[3], pt.LoDTensor)
    np.testing.assert_allclose(np.asarray(got[3]), np.asarray(want[3]), **TOL)


def test_dense_feed_to_a_sequence_var_is_full_length():
    rng = np.random.default_rng(3)
    dense = rng.standard_normal((2, 5, 3)).astype(np.float32)

    def build(fluid):
        x = fluid.layers.data(name="x", shape=[3], dtype="float32",
                              lod_level=1)
        return [fluid.layers.sequence_pool(x, "average"),
                fluid.layers.mean(x)]

    want, got = _run_both(build, lambda f: {"x": dense})
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, np.asarray(w), **TOL)
    np.testing.assert_allclose(got[0], dense.mean(1), **TOL)


# --- run_steps, DataFeeder, serving -------------------------------------------

def _seq_model(fluid):
    L = fluid.layers
    w = L.data(name="w", shape=[1], dtype="int64", lod_level=1)
    y = L.data(name="y", shape=[1], dtype="int64")
    emb = L.embedding(w, size=[20, 8])
    h, _ = L.dynamic_lstm(L.fc(emb, size=16, num_flatten_dims=2), size=16)
    logits = L.fc(L.sequence_pool(h, "max"), size=2)
    loss = L.mean(L.softmax_with_cross_entropy(logits, y))
    fluid.optimizer.Adam(0.01).minimize(loss)
    return loss


def _lod_batches(fluid, n, seed=4):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        lens = rng.integers(1, 10, 3)
        out.append({"w": _lod(fluid, rng.integers(0, 20, (int(lens.sum()), 1))
                              .astype(np.int64), [_offsets(lens)]),
                    "y": rng.integers(0, 2, (3, 1)).astype(np.int64)})
    return out


def _jax_start(build):
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.unique_name.guard(), jfluid.program_guard(main, startup):
        fetch = build(jfluid)
    scope = jax_executor.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(startup, scope=scope)
    arrays = {n: np.asarray(scope.find_var(n))
              for n, v in startup.global_block().desc.vars.items()
              if v.persistable}
    return main, fetch, scope, exe, arrays


def _port_start(build, arrays):
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        fetch = build(pt)
    scope = pt.Scope()
    pt.interop.load_numpy_params(scope, arrays, "cpu")
    return main, fetch, scope, pt.Executor(pt.CPUPlace())


def test_run_steps_lod_window_falls_back_per_step():
    """A window of per-step dicts holding LoDTensors runs one run() a step
    (counted `lod_feed`): bitwise K run() calls of the port, and within
    tolerance of the JAX package's run_steps (its own per-step fallback)."""
    jmain, jloss, jscope, jexe, arrays = _jax_start(_seq_model)
    want = jexe.run_steps(jmain, _lod_batches(jfluid, 4),
                          fetch_list=[jloss], scope=jscope,
                          fetch_mode="stack")[0]
    main, loss, scope, exe = _port_start(_seq_model, arrays)
    E.COUNTERS.reset()
    got = exe.run_steps(main, _lod_batches(pt, 4), fetch_list=[loss],
                        scope=scope, fetch_mode="stack")[0]
    assert E.COUNTERS.window_fallbacks == {"lod_feed": 1}
    assert scope.find_var("__rng_counter__") == 4
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-5)
    _, loss2, scope2, exe2 = _port_start(_seq_model, arrays)
    main2 = main
    singles = [exe2.run(main2, feed=f, fetch_list=[loss], scope=scope2)[0]
               for f in _lod_batches(pt, 4)]
    np.testing.assert_array_equal(got, np.stack(singles))
    for n, v in scope.vars.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, scope2.find_var(n)), n


def test_data_feeder_lod_slots_match_the_reference():
    samples = [([3, 1, 4], [[1, 2], [3]], [0.5]),
               ([1], [[4, 5, 6], [], [7]], [1.5]),
               ([5, 9], [[8]], [2.5])]
    feeds = []
    for fluid in (jfluid, pt):
        prog = fluid.Program()
        with fluid.program_guard(prog, fluid.Program()):
            a = fluid.layers.data(name="a", shape=[1], dtype="int64",
                                  lod_level=1)
            b = fluid.layers.data(name="b", shape=[1], dtype="int64",
                                  lod_level=2)
            c = fluid.layers.data(name="c", shape=[1], dtype="float32")
            feeder = fluid.DataFeeder([a, b, c], fluid.CPUPlace(),
                                      program=prog)
        feeds.append(feeder.feed(samples))
    want, got = feeds
    for n in ("a", "b"):
        assert isinstance(got[n], pt.LoDTensor)
        assert isinstance(want[n], jax_feeder.LoDTensor)
        assert got[n].lod == want[n].lod
        np.testing.assert_array_equal(np.asarray(got[n]),
                                      np.asarray(want[n]))
        assert np.asarray(got[n]).dtype == np.asarray(want[n]).dtype
    assert got["b"].lod == [[0, 2, 5, 6], [0, 2, 3, 6, 6, 7, 8]]
    np.testing.assert_array_equal(got["c"], want["c"])


def _served(fluid):
    L = fluid.layers
    w = L.data(name="w", shape=[1], dtype="int64", lod_level=1)
    emb = L.embedding(w, size=[20, 8])
    pooled = L.sequence_pool(L.sequence_conv(emb, num_filters=4,
                                             filter_size=3), "sqrt")
    return L.softmax(L.fc(pooled, size=3))


def test_serving_engine_lod_request_falls_back_to_the_executor():
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 20, (9, 1)).astype(np.int64)
    lod = [[0, 4, 5, 9]]
    jmain, jprob, jscope, _, arrays = _jax_start(_served)
    jeng = JaxServingEngine(jmain, ["w"], [jprob.name],
                            place=jfluid.CPUPlace(), scope=jscope)
    want = jeng.infer({"w": jax_executor.LoDTensor(ids, lod)})[0]
    main, prob, scope, _ = _port_start(_served, arrays)
    eng = ServingEngine(main, ["w"], [prob.name], place=pt.CPUPlace(),
                        scope=scope)
    before = telemetry.read_series("serving_fallback_total")
    got = eng.infer({"w": pt.LoDTensor(ids, lod)})[0]
    after = telemetry.read_series("serving_fallback_total")
    key = next(k for k in after if "reason=lod" in k)
    assert after[key] - before.get(key, 0) == 1
    assert got.shape == (3, 3)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)


# --- the graph path, the capture stood in for on the CPU ----------------------

class _Rerun:
    """A captured CUDA graph stood in for on the CPU: the capture runs the
    body once, a replay runs it again on the same buffers."""

    def __init__(self, body, pool=None, generators=()):
        self.body = body
        self.generators = list(generators)
        body()

    def pool(self):
        return None

    def replay(self):
        self.body()


@pytest.fixture
def graphed(monkeypatch):
    gate = pt.Executor.graph_gate

    def cuda_gate(self, program, feed, use_jit=None, use_program_cache=True):
        device, self.device = self.device, torch.device("cuda", 0)
        try:
            return gate(self, program, feed, use_jit, use_program_cache)
        finally:
            self.device = device
    monkeypatch.setattr(E, "capture_graph", _Rerun)
    monkeypatch.setattr(pt.Executor, "graph_gate", cuda_gate)
    E.COUNTERS.reset()
    return E.COUNTERS


def test_graphed_lod_steps_match_eager_steps(graphed):
    """Each padded-length bucket is a signature of its own; a replay reads
    its batch's lengths from the feed buffers and matches the eager step
    bitwise."""
    _, _, _, _, arrays = _jax_start(_seq_model)
    main, loss, sg, exe = _port_start(_seq_model, arrays)
    _, _, se, _ = _port_start(_seq_model, arrays)
    rng = np.random.default_rng(6)
    for top in (5, 12, 5, 12, 7, 12):           # buckets 8, 16, 8, 16, 8, 16
        lens = rng.integers(1, top + 1, 3)
        lens[0] = top
        feed = {"w": pt.LoDTensor(rng.integers(0, 20, (int(lens.sum()), 1)),
                                  [_offsets(lens)]),
                "y": rng.integers(0, 2, (3, 1))}
        a = exe.run(main, feed=feed, fetch_list=[loss], scope=sg)[0]
        b = exe.run(main, feed=feed, fetch_list=[loss], scope=se,
                    use_jit=False)[0]
        np.testing.assert_array_equal(a, b)
    assert (graphed.warmups, graphed.captures, graphed.replays) == (2, 2, 4)
    for n, v in se.vars.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, sg.find_var(n)), n


def test_graphed_dropout_reseeds_each_replay(graphed):
    """A block holding dropout is graphed; each replay draws what the eager
    step of the same run counter draws, and steps draw different masks."""
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[16], dtype="float32")
        d = pt.layers.dropout(pt.layers.fc(x, size=16), dropout_prob=0.5)
        loss = pt.layers.mean(d)
        pt.optimizer.SGD(0.1).minimize(loss)
    mask = next(o for o in main.global_block().ops
                if o.type == "dropout").output("Mask")[0]
    exe = pt.Executor(pt.CPUPlace())
    sg, se = pt.Scope(), pt.Scope()
    exe.run(startup, scope=sg)
    for n, v in sg.vars.items():
        se.set_var(n, v.clone() if isinstance(v, torch.Tensor) else v)
    graphed.reset()
    feed = {"x": np.ones((8, 16), np.float32)}
    masks = []
    for _ in range(4):
        lg, mg = exe.run(main, feed=feed, fetch_list=[loss, mask], scope=sg)
        le, me = exe.run(main, feed=feed, fetch_list=[loss, mask], scope=se,
                         use_jit=False)
        np.testing.assert_array_equal(mg, me)
        np.testing.assert_array_equal(lg, le)
        masks.append(mg)
    assert (graphed.captures, graphed.replays) == (1, 3)
    assert all(not np.array_equal(a, b) for a, b in zip(masks, masks[1:]))
