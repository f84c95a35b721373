"""The port's memory module (paddle_tpu_torch.memory) against the JAX
package's (paddle_tpu/memory.py), and its executor, overlap and hot-row
cache hooks, on the CPU.

  * shape_bytes, nbytes_of, HeadroomModel (fit/predict/max_batch/
    headroom/to_dict), what_if over a stub measure, classify and
    per_shard_param_bytes (the weights carried across by
    interop.load_numpy_params), choose_steps_per_call over a grid of its
    arguments, budget_from_headroom and enable(headroom=...)'s cache_rows:
    equal to the reference's, exactly (the same Python float arithmetic).
  * OOM forensics: an allocation failure raised inside a step (a
    synthetic torch.cuda.OutOfMemoryError) comes out of Executor.run as
    errors.OOMError with its fields filled and names resolved, the failed
    step's tensors freed as soon as the error is dropped (no cycle keeps
    them); a capture that fails on an allocation rolls its signature back.
  * static_memory_analysis on build_smoke("resnet") at batches 8 and 32:
    its state bytes equal the reference classify's, and the footprint
    grows with the batch.
"""

import torch_threads  # noqa: F401  (the cores shared among xdist workers)
import gc
import itertools
import weakref
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import executor as jax_executor
from paddle_tpu import memory as jmemory
from paddle_tpu.parallel import emb_cache as jcache
from paddle_tpu.parallel import overlap as joverlap
import paddle_tpu_torch as pt
from paddle_tpu_torch import errors, memory, telemetry
from paddle_tpu_torch import executor as E
from paddle_tpu_torch.ops import registry
from paddle_tpu_torch.parallel import emb_cache, overlap
from paddle_tpu_torch.parallel.mesh import Mesh


@pytest.fixture(autouse=True)
def _fresh():
    before = set(jax_executor._RECORDED_OPS)
    memory.reset()
    jmemory.reset()
    yield
    memory.reset()
    jmemory.reset()
    jax_executor._RECORDED_OPS.intersection_update(before)


# --- pure helpers -------------------------------------------------------------

@pytest.mark.parametrize("s", [
    "f32[128,13]{1,0}", "bf16[8]", "(f32[8,16], s8[4])", "pred[]",
    "token[]", "(s32[], u8[3,3], f8e4m3fn[2])", "c64[2,2]", "opaque[]"])
def test_shape_bytes(s):
    assert memory.shape_bytes(s) == jmemory.shape_bytes(s)


def _values(pkg):
    return [None, np.zeros((2, 3), np.float64), np.zeros((5,), np.int8),
            np.float32(1.0), [1.0, 2.0, 3.0], "not an array",
            SimpleNamespace(shape=(1 << 20, 13), dtype=np.float32),
            pkg.LoDTensor(np.ones((4, 2), np.float32), [[0, 1, 4]])]


def test_nbytes_of():
    for mine, ref in zip(_values(pt), _values(jfluid)):
        assert memory.nbytes_of(mine) == jmemory.nbytes_of(ref), ref
    # and the port's own kinds: tensors of any device, meta ones included
    assert memory.nbytes_of(torch.empty((1 << 20, 13), device="meta")) == \
        jmemory.nbytes_of(SimpleNamespace(shape=(1 << 20, 13),
                                          dtype=np.float32))
    assert memory.nbytes_of(torch.zeros(3, 4, dtype=torch.bfloat16)) == 24
    assert memory.nbytes_of(((8, 3), np.float32)) == \
        jmemory.nbytes_of(((8, 3), np.float32))


POINTS = [[(4, 1400), (16, 2600), (64, 7400)],
          [(8, 1_000_003), (32, 3_400_017)],
          [(8, 5_123_456_789), (16, 7_000_000_001), (32, 13_345_678_901)],
          [(2, 900), (8, 700)],                   # shrinking: slope 0
          [(1, 10), (3, 10), (3, 14), (9, 40)]]


@pytest.mark.parametrize("pts", POINTS)
def test_headroom_model_equals_the_reference(pts):
    m, j = memory.HeadroomModel.fit(pts), jmemory.HeadroomModel.fit(pts)
    assert (m.fixed_bytes, m.per_item_bytes, m.points) == \
        (j.fixed_bytes, j.per_item_bytes, j.points)
    assert m.to_dict() == j.to_dict()
    for b in (0, 1, 7, 33, 1000):
        assert m.predict(b) == j.predict(b)
    for budget in (0, 500, 11_000, 1 << 30, 16 << 30, 80 << 30):
        assert m.max_batch(budget) == j.max_batch(budget)
        for b in (1, 32):
            assert m.headroom(budget, b) == j.headroom(budget, b)


def test_headroom_model_refuses_one_batch():
    for mod in (memory, jmemory):
        with pytest.raises(ValueError):
            mod.HeadroomModel.fit([(8, 100), (8, 100)])
        assert mod.HeadroomModel(1000, 0.0).max_batch(1 << 30) is None


def _stub_measure(mod, curve):
    def measure(b):
        rec = mod.ProgramMemory(program="stub")
        rec.argument_bytes = 1_000_000
        rec.temp_bytes = int(curve(b))
        return rec
    return measure


@pytest.mark.parametrize("curve", [
    lambda b: 250_000 * b, lambda b: 250_000 * b + 3_000 * b * b,
    lambda b: 1_000 * b ** 1.5 + 7])
@pytest.mark.parametrize("kw", [
    {"batches": (8, 32), "budget_bytes": 64 << 20},
    {"batches": (8, 16, 32), "budget_bytes": 1 << 30,
     "max_validate_batch": 100},
    {"batches": (2, 4), "budget_bytes": 10, "validate": True},
    {"batches": (8, 32), "budget_bytes": 1 << 28, "validate": False}])
def test_what_if_equals_the_reference(curve, kw):
    got = memory.what_if(_stub_measure(memory, curve), **kw)
    want = jmemory.what_if(_stub_measure(jmemory, curve), **kw)
    assert got == want


def test_what_if_remembers_the_fit_for_the_program():
    res = memory.what_if(_stub_measure(memory, lambda b: 1000 * b),
                         budget_bytes=1 << 20, program="p_fit")
    model, budget = memory.headroom_for("p_fit")
    assert model.max_batch(budget) == res["max_batch"] and budget == 1 << 20


def test_choose_steps_per_call_equals_the_reference():
    grid = itertools.product(
        (None, 0.0, 0.5, 3.0), (None, 1.0, 20.0), (None, 0, 4096, 1 << 20),
        (None, 1 << 20, 1 << 30), (None, 0, 1 << 24, 1 << 31), (0.02, 0.1),
        ((1, 64), (4, 16)))
    n = 0
    for over, step, feed, peak, budget, frac, (lo, hi) in grid:
        kw = dict(python_overhead_ms=over, step_time_ms=step,
                  feed_bytes_per_step=feed, peak_bytes=peak,
                  budget_bytes=budget, target_overhead_frac=frac, lo=lo,
                  hi=hi)
        assert overlap.choose_steps_per_call(**kw) == \
            joverlap.choose_steps_per_call(**kw), kw
        n += 1
    assert n > 1000


# --- classify, per-shard bytes -------------------------------------------------

def _momentum_fc(fl):
    main, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        x = fl.layers.data(name="x", shape=[16], dtype="float32")
        y = fl.layers.data(name="y", shape=[1], dtype="float32")
        pred = fl.layers.fc(input=x, size=8)
        pred = fl.layers.fc(input=pred, size=1)
        loss = fl.layers.mean(fl.layers.square_error_cost(input=pred,
                                                          label=y))
        fl.optimizer.Momentum(learning_rate=0.1, momentum=0.9).minimize(
            loss, startup_program=startup)
    return main, startup, loss


def _carried(build_net):
    """(port program, port scope, JAX program, JAX scope) with the JAX
    startup's persistables carried into the port's scope."""
    jmain, jstartup, _ = build_net(jfluid)
    jscope = jax_executor.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(jstartup, scope=jscope)
    arrays = {n: np.array(jscope.find_var(n))
              for n, v in jstartup.global_block().desc.vars.items()
              if v.persistable}
    main, _, _ = build_net(pt)
    scope = pt.Scope()
    pt.interop.load_numpy_params(scope, arrays, "cpu")
    return main, scope, jmain, jscope, arrays


def _shard(jmain, main, w):
    import jax
    from jax.sharding import Mesh as JMesh
    jmain._mesh = JMesh(np.array(jax.devices()[:4]), ("dp",))
    jmain._param_shardings = {w: ("dp", None)}
    main._mesh = Mesh(("dp",), (4,), None, 0, torch.device("cpu"))
    main._param_shardings = {w: ("dp", None)}


@pytest.mark.parametrize("sharded", [False, True])
def test_classify_and_per_shard_param_bytes(sharded):
    main, scope, jmain, jscope, arrays = _carried(_momentum_fc)
    w = sorted(p.name for p in main.global_block().all_parameters()
               if p.name.endswith(".w_0"))[0]
    if sharded:
        _shard(jmain, main, w)
    state = {n: scope.find_var(n) for n in arrays}
    feeds = {"x": np.zeros((4, 16), np.float32),
             "y": np.zeros((4, 1), np.float32)}
    got = memory.classify(main, state, feeds)
    want = jmemory.classify(jmain, dict(arrays), feeds)
    assert got == want and got["params"] > 0 and got["opt_state"] > 0
    mine = memory.per_shard_param_bytes(main, scope)
    ref = jmemory.per_shard_param_bytes(jmain, jscope)
    for k in ("devices", "replicated_bytes", "sharded_bytes_per_device",
              "per_device_bytes"):
        assert mine[k] == ref[k], k
    assert mine["params"][w]["factor"] == ref["params"][w]["factor"] == \
        (4 if sharded else 1)


def test_tracker_classifies_a_run():
    telemetry.reset()
    main, startup, loss = _momentum_fc(pt)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    exe.run(main, feed={"x": np.zeros((4, 16), np.float32),
                        "y": np.zeros((4, 1), np.float32)},
            fetch_list=[loss], scope=scope)
    last = memory.tracker().last
    assert last["source"] == "tensors" and last["bytes_in_use"] > 0
    cls = last["classes"]
    assert cls["params"] == (16 * 8 + 8 + 8 + 1) * 4
    assert cls["opt_state"] > 0 and cls["feeds"] == 4 * 16 * 4 + 4 * 4
    assert telemetry.read_gauge("hbm_class_bytes", device="cpu",
                                kind="params") == cls["params"]
    assert memory.bench_summary()["peak_hbm_bytes"] > 0


def test_the_run_sample_classifies_the_state_once_a_version(monkeypatch):
    """The sample after each run classifies the state once for a program
    version and state count, and sums the feeds of every run."""
    main, startup, loss = _momentum_fc(pt)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    calls = []
    orig = memory.classify
    monkeypatch.setattr(memory, "classify",
                        lambda *a: calls.append(1) or orig(*a))
    for b in (4, 8, 8):
        exe.run(main, feed={"x": np.zeros((b, 16), np.float32),
                            "y": np.zeros((b, 1), np.float32)},
                fetch_list=[loss], scope=scope)
    assert len(calls) == 1
    cls = memory.tracker().last["classes"]
    assert cls["params"] == (16 * 8 + 8 + 8 + 1) * 4
    assert cls["feeds"] == 8 * 16 * 4 + 8 * 4
    main._version += 1
    exe.run(main, feed={"x": np.zeros((2, 16), np.float32),
                        "y": np.zeros((2, 1), np.float32)},
            fetch_list=[loss], scope=scope)
    assert len(calls) == 2


# --- the hot-row cache sized from headroom ------------------------------------

def _table_net(fl):
    main, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        ids = fl.layers.data(name="ids", shape=[4], dtype="int64")
        lab = fl.layers.data(name="lab", shape=[1], dtype="float32")
        emb = fl.layers.embedding(input=ids, size=[5000, 16], is_sparse=True,
                                  param_attr=fl.ParamAttr(name="emb_w"))
        pred = fl.layers.fc(input=emb, size=1)
        loss = fl.layers.mean(fl.layers.square_error_cost(pred, lab))
        fl.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return main, startup, loss


@pytest.mark.parametrize("kw", [
    {"batch": 64, "limit_bytes": 2_000_000},
    {"batch": 16, "limit_bytes": 900_000, "window_feed_bytes": 100_000},
    {"batch": 64, "limit_bytes": None}])
def test_cache_sized_from_headroom_equals_the_reference(kw):
    model_pts = [(8, 300_000), (32, 420_000)]
    mm, jm = (memory.HeadroomModel.fit(model_pts),
              jmemory.HeadroomModel.fit(model_pts))
    args = dict(kw)
    assert emb_cache.budget_from_headroom(mm, **args) == \
        jcache.budget_from_headroom(jm, **args)
    main, scope, jmain, jscope, _ = _carried(_table_net)
    cache = emb_cache.enable(main, scope=scope, headroom=mm, **args)
    with jax_executor.scope_guard(jscope):
        jc = jcache.enable(jmain, headroom=jm, **args)
    assert (cache is None) == (jc is None)
    if cache is not None:
        assert cache.tables()["emb_w"].cache_rows == \
            jc.tables()["emb_w"].cache_rows
    with pytest.raises(ValueError, match="batch"):
        emb_cache.enable(_table_net(pt)[0], scope=scope, headroom=mm)


# --- static analysis ------------------------------------------------------------

def test_static_analysis_of_the_smoke_resnet():
    spec = memory.build_smoke("resnet")
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(spec["startup"], scope=scope)
    jspec = jmemory.build_smoke("resnet")
    jscope = jax_executor.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(jspec["startup"], scope=jscope)
    jstate = {n: np.array(jscope.find_var(n))
              for n, v in jspec["startup"].global_block().desc.vars.items()
              if v.persistable}
    recs = {}
    for b in (8, 32):
        recs[b] = exe.static_memory_analysis(
            spec["main"], feed=spec["feed_fn"](b),
            fetch_list=[spec["loss"]], scope=scope)
        cls = jmemory.classify(jspec["main"], jstate,
                               {n: np.zeros(s, d) for n, (s, d)
                                in spec["feed_fn"](b).items()})
        feeds = cls.pop("feeds")
        assert recs[b].argument_bytes - feeds == cls["params"] + \
            cls["opt_state"]
        assert recs[b].alias_bytes > 0 and recs[b].temp_bytes > 0
        top = recs[b].peak["top"]
        assert top and all(r["var"] and r["op"] for r in top)
    slope = (recs[32].total_bytes - recs[8].total_bytes) / 24
    assert slope > 0
    assert memory.latest_record(recs[32].program) is recs[32]


def test_static_analysis_never_allocates_the_feeds():
    spec = memory.build_smoke("fit_a_line")
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(spec["startup"], scope=scope)
    big = 1_000_000_000
    for feed in (spec["feed_fn"](big),
                 {n: torch.empty(s, dtype=torch.float32, device="meta")
                  for n, (s, _) in spec["feed_fn"](big).items()}):
        rec = exe.static_memory_analysis(spec["main"], feed=feed,
                                         fetch_list=[spec["loss"]],
                                         scope=scope)
        assert rec.argument_bytes > 52 * (1 << 30)


def test_measure_memory_needs_a_card():
    spec = memory.build_smoke("fit_a_line")
    exe = pt.Executor(pt.CPUPlace())
    with pytest.raises(ValueError, match="CUDA"):
        exe.measure_memory(spec["main"], feed=spec["data_fn"](4))


# --- OOM forensics --------------------------------------------------------------

def test_is_oom():
    for mod in (memory, jmemory):
        assert mod.is_oom(RuntimeError(
            "RESOURCE_EXHAUSTED: Out of memory allocating 123 bytes"))
        assert not mod.is_oom(ValueError("shapes do not match"))
    assert memory.is_oom(torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB"))
    chained = RuntimeError("operation failed during capture")
    chained.__cause__ = torch.cuda.OutOfMemoryError("x")
    assert memory.is_oom(chained)


class _Planted:
    """A lowering of `op_type` that makes a large temporary, keeps a weak
    reference to it, and runs out of memory."""

    def __init__(self, monkeypatch, op_type="square"):
        self.refs = []
        opdef = registry.get(op_type)
        orig = opdef.lower

        def lower(ctx, op, ins):
            out = orig(ctx, op, ins)
            big = torch.ones(1 << 18)
            ctx.env["__planted__"] = big
            self.refs.append(weakref.ref(big))
            raise torch.cuda.OutOfMemoryError(
                "CUDA out of memory. Tried to allocate 20.00 GiB. GPU 0 has "
                "a total capacity of 79.11 GiB")
        monkeypatch.setattr(opdef, "lower", lower)


def _fit_a_line_exe():
    spec = memory.build_smoke("fit_a_line")
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(spec["startup"], scope=scope)
    return spec, exe, scope


def test_oom_becomes_a_structured_error(monkeypatch):
    telemetry.reset()
    spec, exe, scope = _fit_a_line_exe()
    memory.set_headroom(telemetry.program_label(spec["main"]),
                        memory.HeadroomModel(1000.0, 100.0), 21_000)
    planted = _Planted(monkeypatch)
    feed = spec["data_fn"](8)
    gc.disable()
    try:
        with pytest.raises(errors.OOMError) as ei:
            exe.run(spec["main"], feed=feed, fetch_list=[spec["loss"]],
                    scope=scope)
        err = ei.value
        assert isinstance(err, MemoryError) and isinstance(err, RuntimeError)
        assert "out of memory" in str(err)
        assert isinstance(err.__cause__, torch.cuda.OutOfMemoryError)
        state = {n: scope.find_var(n)
                 for n in exe._resolve_state(spec["main"], feed, scope)}
        cls = memory.classify(spec["main"], state, feed)
        assert err.breakdown["params"] + err.breakdown["opt_state"] == \
            cls["params"] + cls["opt_state"]
        assert err.breakdown["feeds"] == 8 * 14 * 4
        assert err.analysis and err.analysis["total_bytes"] > 0
        names = {r["name"]: r["kind"] for r in err.top_buffers}
        assert names.get("__planted__") == "activation"
        assert {"param", "feed"} <= set(names.values())
        assert any("max_batch=200" in s for s in err.suggestions)
        assert any("mixed precision" in s for s in err.suggestions)
        assert err.to_dict()["type"] == "OOMError"
        assert telemetry.read_series("oom_errors_total")
        del err, ei
        # the failed step's temporaries went with the error, no collector
        assert planted.refs and planted.refs[-1]() is None
    finally:
        gc.enable()


def test_non_oom_errors_pass_through(monkeypatch):
    spec, exe, scope = _fit_a_line_exe()

    def boom(ctx, op, ins):
        raise RuntimeError("not a memory problem")
    monkeypatch.setattr(registry.get("mean"), "lower", boom)
    with pytest.raises(RuntimeError, match="not a memory") as ei:
        exe.run(spec["main"], feed=spec["data_fn"](4),
                fetch_list=[spec["loss"]], scope=scope)
    assert not isinstance(ei.value, errors.OOMError)


class _Graph:
    def __init__(self, body):
        self.body = body

    def replay(self):
        self.body()

    def pool(self):
        return None


def test_a_capture_out_of_memory_rolls_its_signature_back(monkeypatch):
    """On a card (stood in for) the signature's second run captures; a
    capture that runs out of memory raises OOMError and leaves no graph,
    no entry and no state buffer behind; the next run warms up again and
    the one after captures and replays."""
    spec, exe, scope = _fit_a_line_exe()
    gate = E.Executor.graph_gate
    monkeypatch.setattr(E.Executor, "graph_gate",
                        lambda self, *a, **k: None)
    fail = [True]

    def capture(body, pool=None, keep=False, generators=()):
        if fail[0]:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory.")
        return _Graph(body)
    monkeypatch.setattr(E, "capture_graph", capture)
    feed = spec["data_fn"](4)
    run = lambda: exe.run(spec["main"], feed=feed,  # noqa: E731
                          fetch_list=[spec["loss"]], scope=scope)
    before = dict(vars(E.COUNTERS))
    run()                                   # warm-up
    assert len(exe._graphs) == 1
    with pytest.raises(errors.OOMError):
        run()                               # the capture fails
    assert not exe._graphs and not exe._buffers
    fail[0] = False
    run()
    run()
    c = E.COUNTERS
    assert (c.warmups - before["warmups"], c.captures - before["captures"],
            c.replays - before["replays"]) == (2, 1, 1)
    monkeypatch.setattr(E.Executor, "graph_gate", gate)


def test_a_capture_out_of_memory_names_its_activations(monkeypatch):
    """An allocation failure inside a capture's body: the OOMError names
    the captured step's tensors among the ten largest (the capture's env
    pinned on the exception), and they go with the error."""
    spec, exe, scope = _fit_a_line_exe()
    monkeypatch.setattr(E.Executor, "graph_gate",
                        lambda self, *a, **k: None)
    feed = spec["data_fn"](4)
    exe.run(spec["main"], feed=feed, fetch_list=[spec["loss"]],
            scope=scope)                        # warm-up
    monkeypatch.setattr(E, "capture_graph",
                        lambda body, *a, **k: body() or _Graph(body))
    planted = _Planted(monkeypatch)
    gc.disable()
    try:
        with pytest.raises(errors.OOMError) as ei:
            exe.run(spec["main"], feed=feed, fetch_list=[spec["loss"]],
                    scope=scope)
        names = {r["name"]: r["kind"] for r in ei.value.top_buffers[:10]}
        assert names.get("__planted__") == "activation"
        del ei
        assert planted.refs and planted.refs[-1]() is None
    finally:
        gc.enable()


def test_a_served_program_out_of_memory_is_an_oom_error(monkeypatch):
    """PreparedProgram.run, the serving engine's eager bucket and warm-up,
    raises errors.OOMError with the failed run's tensors named; a
    bucket's capture that runs out of memory raises it too."""
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[13], dtype="float32")
        y = pt.layers.data(name="y", shape=[1], dtype="float32")
        cost = pt.layers.mean(pt.layers.square_error_cost(
            pt.layers.fc(input=x, size=1), y))
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    feed = {"x": torch.ones(4, 13), "y": torch.ones(4, 1)}
    prep = exe.prepare_serving(main, list(feed), [cost.name], scope)
    state = {n: scope.find_var(n) for n in prep.state_names}
    planted = _Planted(monkeypatch)
    with pytest.raises(errors.OOMError) as ei:
        prep.run(feed, state)
    assert isinstance(ei.value.__cause__, torch.cuda.OutOfMemoryError)
    names = {r["name"]: r["kind"] for r in ei.value.top_buffers}
    assert names.get("__planted__") == "activation"
    del ei
    assert planted.refs[-1]() is None
    monkeypatch.undo()

    def capture(body, *a, **k):
        # the warm-up ran; the capture's own run fails on an allocation
        _Planted(monkeypatch)
        body()
        return _Graph(body)
    monkeypatch.setattr(E, "capture_graph", capture)
    with pytest.raises(errors.OOMError):
        prep.capture(feed, state)
