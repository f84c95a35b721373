"""The port's training-dynamics observatory (paddle_tpu_torch/dynamics.py)
against the JAX package's, on the CPU (the card's graphs stood in for:
tests/torch_standin.py, since dynamics samples the graphed step only):

  * `plan` groups are equal, including the collapse to planner roles past
    MAX_PARAM_SERIES.
  * The sampled rows of 20 Momentum and 20 Adam steps (period 1) equal
    the JAX package's `sampled_stats` on the same old state, new state
    and gradients within rtol 1e-5 (the port sums squares through
    torch._foreach_norm, the JAX package through jnp.sum); on a sparse
    embedding gradient the rows reduce over the touched rows and equal the
    JAX package's `_group_row`, and the executor's sampled steps densify
    nothing.
  * Verdicts, EWMA baselines and `classify_grad` are exactly equal on the
    reference test's synthetic series.
  * The executor samples steps whose counter is a multiple of the period,
    in run() and in run_steps windows, from two graphs a signature (a
    sampled and a plain one), and sampling leaves the weights bitwise as
    with the observatory off."""

import torch_threads  # noqa: F401  (the cores shared among xdist workers)
import json

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import dynamics as jdyn
from paddle_tpu import executor as jexecutor
from paddle_tpu import telemetry as jtelemetry
from paddle_tpu.ops.common import SelectedRowsVal as JRows
import paddle_tpu_torch as pt
from paddle_tpu_torch import dynamics, telemetry
from paddle_tpu_torch import executor as E
from paddle_tpu_torch.ops.common import SelectedRowsVal

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


@pytest.fixture(autouse=True)
def _fresh():
    telemetry.reset()
    jtelemetry.reset()
    dynamics.reset()
    jdyn.reset()
    yield
    telemetry.reset()
    jtelemetry.reset()
    dynamics.reset()
    jdyn.reset()


def _mlp(fl, opt="momentum", depth=2, width=8):
    main, startup = fl.Program(), fl.Program()
    main.random_seed = startup.random_seed = 7
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        x = fl.layers.data(name="x", shape=[4], dtype="float32")
        y = fl.layers.data(name="y", shape=[1], dtype="float32")
        h = x
        for _ in range(depth):
            h = fl.layers.fc(input=h, size=width, act="relu")
        pred = fl.layers.fc(input=h, size=1)
        loss = fl.layers.mean(fl.layers.square_error_cost(pred, y))
        if opt == "momentum":
            fl.optimizer.Momentum(learning_rate=0.01,
                                  momentum=0.9).minimize(loss)
        else:
            fl.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return main, startup, loss


def _batches(n, batch=8, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        xb = rng.rand(batch, 4).astype(np.float32)
        out.append({"x": xb, "y": (xb.sum(1, keepdims=True) * 0.5).astype(
            np.float32)})
    return out


def _groups(p):
    return ([(g.name, g.role, [(e.name, e.grad, e.sparse_grad,
                                tuple(e.moments), e.role) for e in g.params])
             for g in p.groups], tuple(p.grab_names), p.period, p.n_params)


@pytest.mark.parametrize("depth", [2, 17])
@pytest.mark.parametrize("opt", ["momentum", "adam"])
def test_plan_groups_match(depth, opt):
    """17 hidden layers: 36 parameters, past MAX_PARAM_SERIES, collapse to
    their planner roles in both packages."""
    main, _, _ = _mlp(pt, opt, depth)
    jmain, _, _ = _mlp(jfluid, opt, depth)
    with dynamics.override(True, 16), jdyn.override(True, 16):
        p, jp = dynamics.plan(main), jdyn.plan(jmain)
        assert _groups(p) == _groups(jp)
        assert dynamics.cache_token(main) == jdyn.cache_token(jmain) == \
            (True, 16)
    if depth == 17:
        assert len(p.groups) < p.n_params == 2 * (depth + 1)
    with dynamics.override(False):
        assert dynamics.plan(main) is None


@pytest.mark.parametrize("opt", ["momentum", "adam"])
def test_sampled_rows_match_over_twenty_steps(opt, monkeypatch):
    torch_standin.graphed(monkeypatch)
    main, startup, loss = _mlp(pt, opt)
    jmain, _, _ = _mlp(jfluid, opt)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    params = [p.name for p in main.global_block().all_parameters()]
    grads = [n + "@GRAD" for n in params]
    written = exe._persistable_outputs(main)
    with dynamics.override(True, 1), jdyn.override(True, 1):
        jplan = jdyn.plan(jmain)
        want = []
        for feed in _batches(20):
            old = {n: np.array(v) for n, v in scope.vars.items()
                   if isinstance(v, torch.Tensor)}
            out = exe.run(main, feed=feed, fetch_list=[loss] + grads,
                          scope=scope)
            new = {n: np.array(scope.find_var(n)) for n in written}
            grabs = dict(zip(grads, out[1:]))
            want.append(np.asarray(jdyn.sampled_stats(jplan, old, new,
                                                      grabs, 0)))
        payload = dynamics.payload(recent=20)
    label = telemetry.program_label(main)
    assert payload["samples_recorded"] == 20
    assert E.COUNTERS.captures >= 1
    for gi, grp in enumerate(jplan.groups):
        recent = payload["programs"][label]["series"][grp.name]["recent"]
        assert len(recent) == 20
        for step, row in enumerate(recent):
            got = [(-1.0 if row[f] is None else row[f])
                   for f in dynamics.STAT_FIELDS]
            np.testing.assert_allclose(got, want[step][gi], rtol=1e-5,
                                       atol=1e-12, err_msg=grp.name)


def test_sparse_rows_reduce_over_the_touched_rows(monkeypatch):
    rng = np.random.default_rng(3)
    height, dim, k = 40, 4, 9
    w_old = rng.standard_normal((height, dim)).astype(np.float32)
    w_new = w_old.copy()
    rows = rng.integers(0, height, k).astype(np.int32)
    vals = rng.standard_normal((k, dim)).astype(np.float32)
    vals[0] = 0.0
    np.add.at(w_new, rows, -0.1 * vals)
    m1 = rng.random((height, dim)).astype(np.float32)
    ent = dynamics._ParamEntry("emb", "emb@GRAD", True, ("emb_m1",),
                               "embedding")
    jent = jdyn._ParamEntry("emb", "emb@GRAD", True, ("emb_m1",),
                            "embedding")
    plan = dynamics.DynamicsPlan(
        [dynamics._Group("emb", "embedding", [ent])], ("emb@GRAD",), 1, 1)
    jgrp = jdyn._Group("emb", "embedding", [jent])
    got = dynamics.group_rows(
        plan, {"emb": torch.from_numpy(w_old),
               "emb_m1": torch.from_numpy(m1)},
        {"emb": torch.from_numpy(w_new)},
        {"emb@GRAD": SelectedRowsVal(torch.from_numpy(rows),
                                     torch.from_numpy(vals), height)})
    want = np.asarray(jdyn._group_row(
        jgrp, {"emb": w_old, "emb_m1": m1}, {"emb": w_new},
        {"emb@GRAD": JRows(rows, vals, height)}))
    np.testing.assert_allclose(got.numpy()[0], want, rtol=1e-5)
    assert got.numpy()[0][5] == pytest.approx(1 / 9)    # one zero row of 9

    # through the executor: a sampled sparse step densifies nothing
    torch_standin.graphed(monkeypatch)
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        ids = pt.layers.data(name="ids", shape=[1], dtype="int64")
        y = pt.layers.data(name="y", shape=[1], dtype="float32")
        emb = pt.layers.embedding(ids, size=[height, dim], is_sparse=True)
        loss = pt.layers.mean(pt.layers.square_error_cost(
            pt.layers.fc(input=emb, size=1), y))
        pt.optimizer.Adam(learning_rate=0.01).minimize(loss)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    with dynamics.override(True, 1):
        for _ in range(3):
            exe.run(main, feed={"ids": rng.integers(0, height, (8, 1)),
                                "y": rng.random((8, 1)).astype(np.float32)},
                    fetch_list=[loss], scope=scope)
        payload = dynamics.payload()
    assert payload["samples_recorded"] == 3
    assert not telemetry.read_series("sparse_densify_fallback_total")


# --- the host half on synthetic series --------------------------------------

def _plans(name="fc_0.w_0", role="ffn_up"):
    out = []
    for mod in (dynamics, jdyn):
        ent = mod._ParamEntry(name, name + "@GRAD", False, [], role)
        out.append(mod.DynamicsPlan([mod._Group(name, role, [ent])],
                                    (ent.grad,), 1, 1))
    return out


def _row(weight_l2=1.0, weight_rms=0.1, weight_max_abs=0.5, grad_l2=1.0,
         grad_rms=0.1, grad_zero_frac=0.0, update_ratio=0.01,
         moment_rms=-1.0):
    vals = dict(weight_l2=weight_l2, weight_rms=weight_rms,
                weight_max_abs=weight_max_abs, grad_l2=grad_l2,
                grad_rms=grad_rms, grad_zero_frac=grad_zero_frac,
                update_ratio=update_ratio, moment_rms=moment_rms)
    return np.array([[vals[f] for f in dynamics.STAT_FIELDS]], np.float64)


WIN = int(dynamics.THRESHOLDS["verdict_window"])
SERIES = {
    "dead_layer": [_row(grad_l2=0.0, grad_rms=0.0, update_ratio=0.0)] * WIN,
    "frozen_param": [_row(grad_rms=0.1, update_ratio=0.0)] * WIN,
    "exploding_update": [_row(update_ratio=0.01)] * 8
    + [_row(update_ratio=0.5)],
    "nonfinite": [_row(grad_rms=0.0, update_ratio=0.0)] * WIN
    + [_row(weight_l2=float("nan"))],
    "absent": [_row(grad_l2=-1.0, grad_rms=-1.0, grad_zero_frac=-1.0,
                    update_ratio=-1.0, moment_rms=-1.0)],
    "steady": [_row()] * 12,
}


@pytest.mark.parametrize("series", sorted(SERIES))
def test_verdicts_match_on_synthetic_series(series):
    plan, jplan = _plans()
    for step, row in enumerate(SERIES[series]):
        dynamics._OBS.record("pX", step, plan, row)
        jdyn._OBS.record("pX", step, jplan, row)
    assert dynamics.verdicts() == jdyn.verdicts()
    got, want = dynamics.payload(), jdyn.payload()
    for k in ("samples_recorded", "verdicts", "thresholds", "health_codes",
              "fields"):
        assert got[k] == want[k], k
    s, js = (p["programs"]["pX"]["series"]["fc_0.w_0"] for p in (got, want))
    assert json.dumps(s, sort_keys=True) == json.dumps(js, sort_keys=True)
    assert dynamics.crash_section()["verdicts"] == \
        jdyn.crash_section()["verdicts"]
    for g in ("dynamics_dead_layers", "dynamics_frozen_params",
              "dynamics_unhealthy_series"):
        assert telemetry.read_gauge(g, program="pX") == \
            jtelemetry.read_gauge(g, program="pX")


@pytest.mark.parametrize("args", [
    (True, 1.0, 1.0, 1.0), (False, 0.0, 0.0, 0.0), (False, 1e-9, 1e-9, 1e-9),
    (False, 1e4, 1.0, 1e4), (False, 0.1, 0.05, 0.2)])
def test_classify_grad_matches(args):
    assert dynamics.classify_grad(*args) == jdyn.classify_grad(*args)
    assert dynamics.classify_grad(*args, vanishing_threshold=1e-2) == \
        jdyn.classify_grad(*args, vanishing_threshold=1e-2)


def test_tables_are_the_reference_ones():
    assert dynamics.THRESHOLDS == jdyn.THRESHOLDS
    assert dynamics.HEALTH_CATALOG == jdyn.HEALTH_CATALOG
    assert dynamics.STAT_FIELDS == jdyn.STAT_FIELDS
    assert (dynamics.MAX_PARAM_SERIES, dynamics.RING_CAPACITY,
            dynamics.EWMA_ALPHA, dynamics.DEFAULT_PERIOD) == (
        jdyn.MAX_PARAM_SERIES, jdyn.RING_CAPACITY, jdyn.EWMA_ALPHA,
        jdyn.DEFAULT_PERIOD)


def test_jsonl_export(tmp_path, monkeypatch):
    path = str(tmp_path / "dyn.jsonl")
    monkeypatch.setenv("PADDLE_TPU_DYNAMICS_LOG", path)
    plan, _ = _plans()
    for step in range(2):
        dynamics._OBS.record("pX", step, plan, _row())
    recs = [json.loads(ln) for ln in open(path)]
    assert [r["series"] for r in recs] == ["fc_0.w_0"] * 2
    assert recs[1]["update_ratio"] == pytest.approx(0.01)


# --- sampling in the executor -----------------------------------------------

def _train(steps, monkeypatch, enabled, period=1, window=False):
    captures = torch_standin.graphed(monkeypatch)
    main, startup, loss = _mlp(pt)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    E.COUNTERS.reset()
    with dynamics.override(enabled, period):
        if window:
            exe.run_steps(main, feed_window=_batches(steps),
                          fetch_list=[loss], scope=scope)
        else:
            for feed in _batches(steps):
                exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    return main, scope, captures


def test_period_two_samples_even_counters_from_two_graphs(monkeypatch):
    """The startup run leaves the counter at 1: six steps run counters
    1..6, and 2, 4, 6 sample. A sampled and a plain graph, one capture
    each, share the state buffers."""
    main, scope, captures = _train(6, monkeypatch, True, 2)
    assert dynamics.payload()["samples_recorded"] == 3
    steps = [r["step"] for r in next(iter(dynamics.payload()["programs"]
                                          .values()))["series"]
             ["fc_0.w_0"]["recent"]]
    assert steps == [2, 4, 6]
    assert len(captures) == 2 and E.COUNTERS.warmups == 2


def test_run_steps_window_samples_period_boundaries(monkeypatch):
    """Counters 1..8 with period 4 sample 4 and 8."""
    _train(8, monkeypatch, True, 4, window=True)
    assert dynamics.payload()["samples_recorded"] == 2


def test_sampling_leaves_the_weights_bitwise(monkeypatch):
    main, off, _ = _train(5, monkeypatch, False)
    dynamics.reset()
    main, on, _ = _train(5, monkeypatch, True, 1)
    assert dynamics.payload()["samples_recorded"] == 5
    for p in main.global_block().all_parameters():
        assert torch.equal(off.find_var(p.name), on.find_var(p.name)), p.name


def test_eager_runs_do_not_sample():
    main, startup, loss = _mlp(pt)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    with dynamics.override(True, 1):
        for feed in _batches(3):
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert dynamics.payload()["samples_recorded"] == 0
