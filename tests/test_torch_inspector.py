"""The port's inspector (paddle_tpu_torch/inspector.py) against the JAX
package's, on the CPU:

  * `tensor_stats` on the same f32, bf16 and fp16 inputs, with NaN, Inf,
    empty and integer cases: min, max and the counts exact; mean, abs-mean
    and l2 within rtol 1e-6 (the port's plain version sums in f64, the
    JAX package in f32).
  * `select_ops` / `instrument` give the same sites on the same program
    for `names`, `types`, `regex`, `every` and `auto`.
  * `attribute_nonfinite` names the same op index and var, in the same
    number of runs, on a forward MLP with a poisoned weight; on a training
    MLP the port names the poisoned weight's reader (each replay starts
    from the failed step's state: the JAX package replays every round on
    one scratch scope, which the first round's optimizer update poisons).
  * check_nan_inf's NonFiniteError: the eager per-op scan's fields equal
    the JAX package's eager scan's, the graphed step's flag path's equal
    its jitted step's (the card's graph stood in for: tests/torch_standin.py);
    after a raise the scope, the rng counter included, equals its state
    before the step, eager and graphed, a sparse table updated in place
    included.
  * `GradientAudit.report()` statuses are equal on a net with a detached
    and an exploding parameter.
  * The crash report's keys are equal, its program section is
    pprint_program's text, and `format_crash_report` gives the same text
    from either package for the same report dict. The env section takes
    PADDLE_TPU_*, PADDLE_TRAINER*, TORCH_* and CUDA_* variables where the
    JAX package's takes PADDLE_TPU_*, PADDLE_TRAINER*, JAX_* and XLA_*.

Weights cross from the JAX package's startup with
interop.load_numpy_params."""

import torch_threads  # noqa: F401  (the cores shared among xdist workers)
import math
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import executor as jexecutor
from paddle_tpu import inspector as jinspector
from paddle_tpu import telemetry as jtelemetry
import paddle_tpu_torch as pt
from paddle_tpu_torch import errors, inspector, telemetry
from paddle_tpu_torch import executor as E
from paddle_tpu_torch.ops import stats_cuda

import torch_standin


@pytest.fixture(autouse=True)
def _keep_jax_op_census():
    """The JAX executor's op census (executor._RECORDED_OPS) gets back the
    types it had before the test: the parity runs here execute reference
    programs, and tests/test_zz_op_coverage.py gates the census of the
    reference's own tests."""
    before = set(jexecutor._RECORDED_OPS)
    yield
    jexecutor._RECORDED_OPS.intersection_update(before)


EXACT = ("min", "max", "nan_count", "inf_count", "size")
SUMS = ("mean", "abs_mean", "l2")


@pytest.fixture(autouse=True)
def _fresh():
    telemetry.reset()
    jtelemetry.reset()
    yield
    inspector.disable_flight_recorder()
    jinspector.disable_flight_recorder()
    telemetry.reset()
    jtelemetry.reset()


# --- tensor_stats -----------------------------------------------------------

def _stats_case(case, n=257):
    rng = np.random.default_rng(5)
    x = rng.standard_normal(n).astype(np.float32) * 3 + 0.5
    if case == "nonfinite":
        x[[3, 50, 51]] = np.nan
        x[[7, 200]] = np.inf
        x[9] = -np.inf
    elif case == "all_nan":
        x[:] = np.nan
    elif case == "empty":
        x = x[:0]
    elif case == "wide":
        x = (rng.standard_normal((33, 65)) * 1e3).astype(np.float32)
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("case", ["finite", "nonfinite", "all_nan", "empty",
                                  "wide"])
def test_tensor_stats_matches_the_jax_package(dtype, case):
    x = _stats_case(case)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = np.asarray(jinspector._tensor_stats_lower(
        None, None, {"X": [jx]})["Out"][0])
    got = inspector._tensor_stats_lower(
        None, None, {"X": [tx]})["Out"][0].numpy()
    assert got.dtype == np.float32 and got.shape == (8,)
    fields = dict(zip(inspector.STAT_FIELDS, range(8)))
    for f in EXACT:
        assert got[fields[f]] == want[fields[f]], f
    for f in SUMS:
        np.testing.assert_allclose(got[fields[f]], want[fields[f]],
                                   rtol=1e-6, atol=0, err_msg=f)


@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_tensor_stats_integer_input(dtype):
    x = np.arange(-7, 30, dtype=dtype)
    want = np.asarray(jinspector._tensor_stats_lower(
        None, None, {"X": [jnp.asarray(x)]})["Out"][0])
    got = inspector._tensor_stats_lower(
        None, None, {"X": [torch.from_numpy(x)]})["Out"][0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_tensor_stats_wrapper_on_the_cpu_is_the_plain_version():
    """On a CPU tensor the T1 wrapper computes its plain version and counts
    no launch; the gate names what T1 refuses."""
    stats_cuda.COUNTERS.reset()
    x = torch.randn(100)
    assert torch.equal(stats_cuda.tensor_stats(x),
                       stats_cuda.tensor_stats_reference(x))
    assert stats_cuda.COUNTERS.launches == 0
    assert stats_cuda.ineligible(x) is None
    assert stats_cuda.ineligible(x.double()) == "float64"
    assert stats_cuda.ineligible(x[:0]) == "empty"
    assert stats_cuda.ineligible(x.int()) == "dtype"
    assert stats_cuda.bytes_read(x.bfloat16()) == 200


def test_probe_compatible_predicate():
    for t in ("relu", "elementwise_add", "mul"):
        assert inspector.probe_compatible(t) == jinspector.probe_compatible(t)
    for t in ("while", "feed", "tensor_stats", "not_a_registered_op"):
        assert not inspector.probe_compatible(t)


# --- probe sites -------------------------------------------------------------

def _mlp(fl, train=True, hidden=8, extra_param=False):
    main, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        x = fl.layers.data(name="x", shape=[4], dtype="float32")
        y = fl.layers.data(name="y", shape=[1], dtype="float32")
        h = fl.layers.fc(input=x, size=hidden, act="relu")
        h = fl.layers.fc(input=h, size=hidden, act="tanh")
        if extra_param:
            # a parameter off the loss path: GradientAudit's "zero"
            fl.layers.fc(input=x, size=3)
        pred = fl.layers.fc(input=h, size=1)
        loss = fl.layers.mean(fl.layers.square_error_cost(pred, y))
        if train:
            fl.optimizer.Momentum(learning_rate=0.05,
                                  momentum=0.9).minimize(loss)
    return main, startup, loss


def _carried(build, **kw):
    """(port main, port scope, JAX main, JAX scope, loss name): the JAX
    startup's persistables carried into the port's scope."""
    jmain, jstartup, jloss = build(jfluid, **kw)
    jscope = jexecutor.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    arrays = {n: np.array(jscope.find_var(n))
              for n, v in jstartup.global_block().desc.vars.items()
              if v.persistable}
    main, _, loss = build(pt, **kw)
    scope = pt.Scope()
    pt.interop.load_numpy_params(scope, arrays, "cpu")
    return main, scope, jmain, jscope, loss.name


def _feed(batch=8, seed=0, yscale=1.0):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((batch, 4)).astype(np.float32),
            "y": (rng.standard_normal((batch, 1)) * yscale).astype(
                np.float32)}


def _sites(p):
    return [(s.op_index, s.op_type, s.var, s.stat_var, s.kind)
            for s in p._probe_sites]


@pytest.mark.parametrize("sel", [
    {"names": ["fc_1.tmp_0"]}, {"types": ["relu", "mean"]},
    {"regex": r"fc_0.*@GRAD"}, {"every": True}, {"auto": True},
    {"indices": [0, 3]}])
def test_instrument_gives_the_same_sites(sel):
    main, _, _ = _mlp(pt)
    jmain, _, _ = _mlp(jfluid)
    assert inspector.select_ops(main, **sel) == \
        jinspector.select_ops(jmain, **sel)
    assert _sites(inspector.instrument(main, **sel)) == \
        _sites(jinspector.instrument(jmain, **sel))


def test_probed_run_matches_and_reports():
    """A probed run's fetch equals the unprobed run's, and probe_report has
    each site's stats, equal to the JAX package's in its exact fields."""
    main, scope, jmain, jscope, loss = _carried(_mlp, train=False)
    feed = _feed()
    exe = pt.Executor(pt.CPUPlace())
    plain = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0]
    probed = inspector.instrument(main, every=True)
    got = exe.run(probed, feed=feed, fetch_list=[loss], scope=scope)[0]
    assert np.array_equal(plain, got)
    jprobed = jinspector.instrument(jmain, every=True)
    jfluid.Executor(jfluid.CPUPlace()).run(jprobed, feed=feed,
                                            fetch_list=[loss], scope=jscope)
    rep, jrep = inspector.probe_report(probed), jinspector.probe_report(
        jprobed)
    assert [r["var"] for r in rep] == [r["var"] for r in jrep]
    for r, jr in zip(rep, jrep):
        for f in ("nan_count", "inf_count", "size"):
            assert r["stats"][f] == jr["stats"][f]
        np.testing.assert_allclose(r["stats"]["l2"], jr["stats"]["l2"],
                                   rtol=1e-5)


# --- attribution -------------------------------------------------------------

def _poison(scope, name, arrays=None):
    v = scope.find_var(name)
    if isinstance(v, torch.Tensor):
        v = v.clone()
        v.view(-1)[0] = float("inf")
    else:
        v = np.array(v)
        v.reshape(-1)[0] = np.inf
    scope.set_var(name, v)


def _first_reader(main, name):
    return next(i for i, op in enumerate(main.global_block().ops)
                if name in op.input_arg_names)


def test_attribution_matches_on_a_forward_mlp():
    main, scope, jmain, jscope, loss = _carried(_mlp, train=False)
    _poison(scope, "fc_1.w_0")
    _poison(jscope, "fc_1.w_0")
    feed = _feed()
    att = inspector.attribute_nonfinite(pt.Executor(pt.CPUPlace()), main,
                                        feed, scope=scope)
    jatt = jinspector.attribute_nonfinite(jfluid.Executor(jfluid.CPUPlace()),
                                          jmain, feed, scope=jscope)
    assert (att.op_index, att.op_type, att.var, att.runs) == \
        (jatt.op_index, jatt.op_type, jatt.var, jatt.runs)
    assert att.op_index == _first_reader(main, "fc_1.w_0")
    assert att.inputs == jatt.inputs and att.outputs == jatt.outputs
    assert att.stats.nan_count + att.stats.inf_count > 0
    assert att.seconds is not None and att.seconds >= 0


def test_attribution_on_a_training_mlp_names_the_weights_reader():
    main, scope, jmain, jscope, loss = _carried(_mlp)
    _poison(scope, "fc_1.w_0")
    n = sum(1 for op in main.global_block().ops
            if inspector._probe_target(main.global_block(), op))
    att = inspector.attribute_nonfinite(pt.Executor(pt.CPUPlace()), main,
                                        _feed(), scope=scope)
    assert att.op_index == _first_reader(main, "fc_1.w_0")
    assert att.var == "fc_1.tmp_0"
    assert att.runs <= math.ceil(math.log2(n / 8)) + 2
    # the scope it replayed from is untouched
    assert torch.isinf(scope.find_var("fc_1.w_0")).any()


def test_attribution_inconclusive_on_a_finite_step():
    main, scope, _, _, _ = _carried(_mlp, train=False)
    assert inspector.attribute_nonfinite(pt.Executor(pt.CPUPlace()), main,
                                         _feed(), scope=scope) is None


# --- check_nan_inf -----------------------------------------------------------

def _state_copy(scope):
    return {n: (v.clone() if isinstance(v, torch.Tensor) else v)
            for n, v in scope.vars.items()}


def _same(before, scope):
    assert set(before) == set(scope.vars)
    for n, v in before.items():
        w = scope.vars[n]
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, w) or (torch.isnan(v).any()
                                         and torch.equal(v.isnan(), w.isnan())
                                         and torch.equal(v.nan_to_num(),
                                                         w.nan_to_num())), n
        else:
            assert v == w, n


def _nonfinite_fields(e):
    d = e.to_dict()
    att = d["attribution"]
    if att is not None:
        att = {k: att[k] for k in ("op_index", "op_type", "var", "runs",
                                   "inputs", "outputs", "feed_signature")}
    return {k: d[k] for k in ("var_name", "dtype", "op_type", "op_index",
                              "feed_signature")}, att


@pytest.mark.parametrize("route", ["eager", "graphed"])
def test_check_nan_inf_matches_and_leaves_the_scope(route, monkeypatch):
    main, scope, jmain, jscope, loss = _carried(_mlp)
    feed = _feed()
    exe, jexe = pt.Executor(pt.CPUPlace()), jfluid.Executor(jfluid.CPUPlace())
    if route == "graphed":
        torch_standin.graphed(monkeypatch)
    for _ in range(3):      # graphed: warm-up, capture, replay
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        jexe.run(jmain, feed=feed, fetch_list=[loss], scope=jscope,
                 use_jit=route == "graphed")
    _poison(scope, "fc_1.w_0")
    _poison(jscope, "fc_1.w_0")
    before = _state_copy(scope)
    monkeypatch.setattr(E, "_CHECK_NAN_INF", True)
    monkeypatch.setattr(jexecutor, "_CHECK_NAN_INF", True)
    use_jit = None if route == "graphed" else False
    with pytest.raises(errors.NonFiniteError) as ei:
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                use_jit=use_jit)
    with pytest.raises(jfluid.errors.NonFiniteError) as jei:
        jexe.run(jmain, feed=feed, fetch_list=[loss], scope=jscope,
                 use_jit=route == "graphed")
    fields, att = _nonfinite_fields(ei.value)
    jfields, jatt = _nonfinite_fields(jei.value)
    assert fields == jfields
    if route == "eager":
        assert att is None and jatt is None
        assert fields["op_type"] == "mul"
    else:
        # the port replays each round from the failed step's state; the
        # JAX package's later rounds start from its diverged scratch state
        assert att["op_index"] == _first_reader(main, "fc_1.w_0")
        assert (att["op_type"], att["var"]) == ("mul", "fc_1.tmp_0")
        assert att["feed_signature"] == jatt["feed_signature"]
    _same(before, scope)
    assert telemetry.read_series("nonfinite_detections_total") == (
        {} if route == "eager" else
        {f"program={telemetry.program_label(main)},source=fetch": 1.0})


@pytest.mark.parametrize("route", ["eager", "graphed"])
def test_a_raise_restores_a_sparse_table_updated_in_place(route,
                                                         monkeypatch):
    """A sparse apply advances its table in place; a step that raises puts
    it back from the pre-step copy, bitwise."""
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        ids = pt.layers.data(name="ids", shape=[1], dtype="int64")
        y = pt.layers.data(name="y", shape=[1], dtype="float32")
        emb = pt.layers.embedding(ids, size=[50, 4], is_sparse=True)
        pred = pt.layers.fc(input=emb, size=1)
        loss = pt.layers.mean(pt.layers.square_error_cost(pred, y))
        pt.optimizer.Adam(learning_rate=0.01).minimize(loss)
    if route == "graphed":
        torch_standin.graphed(monkeypatch)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.default_rng(1)
    feed = {"ids": rng.integers(0, 50, (8, 1)),
            "y": rng.standard_normal((8, 1)).astype(np.float32)}
    for _ in range(3):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    table = [p.name for p in main.global_block().all_parameters()
             if p.shape[0] == 50][0]
    assert table in exe._program_facts(main)[1]
    _poison(scope, "fc_0.w_0")
    before = _state_copy(scope)
    tab = scope.find_var(table)
    monkeypatch.setattr(E, "_CHECK_NAN_INF", True)
    with pytest.raises(errors.NonFiniteError) as ei:
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                use_jit=None if route == "graphed" else False)
    assert scope.find_var(table) is tab
    _same(before, scope)
    if route == "graphed":
        # the table went back before the attribution replayed the step
        assert ei.value.attribution.op_index == _first_reader(main,
                                                              "fc_0.w_0")


def test_trap_fp_runs_eager_with_the_scan(monkeypatch):
    main, scope, _, _, loss = _carried(_mlp, train=False)
    _poison(scope, "fc_0.w_0")
    monkeypatch.setattr(E, "_TRAP_FP", True)
    torch_standin.graphed(monkeypatch)
    exe = pt.Executor(pt.CPUPlace())
    assert exe.graph_gate(main, {}) == "trap_fp"
    E.COUNTERS.reset()
    with pytest.raises(errors.NonFiniteError) as ei:
        exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)
    assert (ei.value.op_type, ei.value.var_name) == ("mul", "fc_0.tmp_0")
    assert E.COUNTERS.eager == {"trap_fp": 1}


def test_probe_hit_raises_before_the_commit(monkeypatch):
    """A probe that sees a NaN raises from record_probes with the
    attribution, and the rng counter does not move."""
    main, scope, _, _, loss = _carried(_mlp)
    _poison(scope, "fc_1.w_0")
    probed = inspector.instrument(main, auto=True)
    exe = pt.Executor(pt.CPUPlace())
    scope.set_var("__rng_counter__", 5)
    with pytest.raises(errors.NonFiniteError) as ei:
        exe.run(probed, feed=_feed(), fetch_list=[loss], scope=scope)
    assert scope.find_var("__rng_counter__") == 5
    assert ei.value.attribution.op_index == _first_reader(main, "fc_1.w_0")
    assert "NaN/Inf detected by probe" in str(ei.value)
    assert telemetry.read_series("nonfinite_detections_total") == {
        f"program={telemetry.program_label(probed)},source=probe": 1.0}


# --- gradient audit ----------------------------------------------------------

def test_gradient_audit_statuses_match():
    main, scope, jmain, jscope, loss = _carried(_mlp, extra_param=True)
    feed = _feed(yscale=1e6)        # the head's weight gradient explodes
    audit, jaudit = inspector.GradientAudit(main), jinspector.GradientAudit(
        jmain)
    assert audit.missing == jaudit.missing == ["fc_2.w_0", "fc_2.b_0"]
    pt.Executor(pt.CPUPlace()).run(audit.program, feed=feed,
                                   fetch_list=[loss], scope=scope)
    jfluid.Executor(jfluid.CPUPlace()).run(jaudit.program, feed=feed,
                                           fetch_list=[loss], scope=jscope)
    rep, jrep = audit.report(), jaudit.report()
    assert {p: r["status"] for p, r in rep.items()} == \
        {p: r["status"] for p, r in jrep.items()}
    statuses = {r["status"] for r in rep.values()}
    assert {"zero", "exploding"} <= statuses
    for p, r in rep.items():
        if "l2" in r:
            np.testing.assert_allclose(r["l2"], jrep[p]["l2"], rtol=1e-4)
    assert telemetry.read_gauge("grad_l2", program=telemetry.program_label(
        audit.program), param="fc_0.w_0") == rep["fc_0.w_0"]["l2"]


def test_gradient_audit_keeps_an_instrumented_programs_probes():
    main, _, _ = _mlp(pt)
    inst = inspector.instrument(main, auto=True)
    audit = inspector.GradientAudit(inst)
    kinds = [s.kind for s in audit.program._probe_sites]
    assert kinds.count("probe") == len(inst._probe_sites)
    assert kinds.count("grad") == len(audit.params)
    names = [s.stat_var for s in audit.program._probe_sites]
    assert len(names) == len(set(names))


# --- flight recorder and crash reports --------------------------------------

def _crash(fl, insp, execmod, build_scope, tmp, monkeypatch):
    main, scope, loss = build_scope
    path = str(tmp / f"{fl.__name__}.json")
    insp.enable_flight_recorder(path)
    monkeypatch.setattr(execmod, "_CHECK_NAN_INF", True)
    exe = fl.Executor(fl.CPUPlace())
    with pytest.raises(Exception):
        exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope,
                use_jit=False)
    return insp.read_crash_report(path), main


def test_crash_reports_match(tmp_path, monkeypatch, capsys):
    main, scope, jmain, jscope, loss = _carried(_mlp)
    _poison(scope, "fc_1.w_0")
    _poison(jscope, "fc_1.w_0")
    monkeypatch.setenv("TORCH_SHOW_CPP_STACKTRACES", "0")
    rep, prog = _crash(pt, inspector, E, (main, scope, loss), tmp_path,
                       monkeypatch)
    jrep, _ = _crash(jfluid, jinspector, jexecutor, (jmain, jscope, loss),
                     tmp_path, monkeypatch)
    assert set(rep) == set(jrep)
    assert rep["format"] == jrep["format"] and rep["version"] == 1
    assert rep["error"]["type"] == jrep["error"]["type"] == "NonFiniteError"
    assert rep["error"]["var_name"] == jrep["error"]["var_name"]
    assert "TORCH_SHOW_CPP_STACKTRACES" in rep["env"]
    assert not any(k.startswith(("JAX_", "XLA_")) for k in rep["env"])
    lines = []
    pt.debugger.pprint_program(prog, print_fn=lines.append)
    assert rep["program"] == "\n".join(lines)
    assert rep["steps"] == [] or all("mode" in s for s in rep["steps"])
    assert set(rep["memory"]) == set(jrep["memory"])
    # the same report dict reads the same from either package
    for r in (rep, jrep):
        assert inspector.format_crash_report(r, show_program=True) == \
            jinspector.format_crash_report(r, show_program=True)
    assert "crash report written" in capsys.readouterr().err


def test_flight_ring_is_bounded_and_records_steps(tmp_path):
    main, scope, _, _, loss = _carried(_mlp)
    rec = inspector.enable_flight_recorder(str(tmp_path / "c.json"),
                                           capacity=3)
    exe = pt.Executor(pt.CPUPlace())
    for _ in range(5):
        exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)
    assert len(rec.records) == 3
    assert [r["rng_counter"] for r in rec.records] == [2, 3, 4]
    assert all(r["mode"] == "eager" and r["hbm_bytes_in_use"] > 0
               for r in rec.records)


def test_signal_handlers_only_from_the_main_thread(tmp_path):
    got = []
    t = threading.Thread(target=lambda: got.append(
        inspector.enable_flight_recorder(str(tmp_path / "c.json"),
                                         signals=True)))
    t.start()
    t.join()
    assert got[0].enabled and got[0]._signals_installed == []
    inspector.enable_flight_recorder(str(tmp_path / "c.json"), signals=True)
    assert inspector._RECORDER._signals_installed
    inspector.disable_flight_recorder()
    assert inspector._RECORDER._signals_installed == []


def test_reader_rejects_non_reports(tmp_path):
    p = tmp_path / "x.json"
    p.write_text('{"format": "other"}')
    with pytest.raises(ValueError):
        inspector.read_crash_report(str(p))


def _windows(fu, program):
    out = {}
    for g in fu.plan(program).values():
        out.setdefault(g.kind, set()).add(
            tuple(n for m in g.members for n in m.output_arg_names))
    return out


def test_probes_break_the_same_fusion_windows_as_the_reference():
    """`auto` probes the block's first op, a conv: its conv -> bn -> act
    window becomes a bn -> act window in both packages' fusion plans, and
    no other window changes."""
    from paddle_tpu.ops import fusion as jfusion
    from paddle_tpu_torch.ops import fusion
    got = []
    for fl, fu, insp in ((pt, fusion, inspector),
                         (jfluid, jfusion, jinspector)):
        main = fl.memory.build_smoke("resnet")["main"]
        before, after = _windows(fu, main), _windows(
            fu, insp.instrument(main, auto=True))
        got.append((before, after))
    assert got[0] == got[1]
    before, after = got[0]
    broken = before["conv_bn_act"] - after["conv_bn_act"]
    assert len(broken) == 1 and next(iter(broken))[0] == "conv2d_0.tmp_0"
    assert len(after["bn_act"]) == 1
    assert {k: v for k, v in before.items() if k != "conv_bn_act"} == \
        {k: v for k, v in after.items() if k not in ("conv_bn_act",
                                                     "bn_act")}
