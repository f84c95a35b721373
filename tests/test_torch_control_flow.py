"""Control flow through the port against the JAX package on the CPU: every
case of tests/test_control_flow.py (While and the tensor arrays,
ConditionalBlock, Switch, IfElse, StaticRNN, DynamicRNN training, the
grads of while and conditional_block, the silent-zero-grad check, the
step-record cap) built by the same script in both packages, run on the
same inputs from a seed with the JAX startup's weights carried across
(`interop.load_numpy_params`), and held to the JAX package's results: f32
within rtol 1e-5 / atol 1e-6, grads within rtol 1e-4, losses over steps
within rtol 1e-4, integers exact. Then the LoD array ops, `Print`, the
IR's sub-blocks through clone / prune / JSON, and the graph gate: a
program with a `while` runs eager under "control_flow", a step with an
`rnn` is graphed.
"""

import torch_threads  # noqa: F401  (the cores shared among xdist workers)
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import executor as jax_executor
import paddle_tpu_torch as pt
from paddle_tpu_torch import executor as pt_executor
from paddle_tpu_torch.ops import registry

F32 = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(autouse=True)
def _keep_jax_op_census():
    before = set(jax_executor._RECORDED_OPS)
    yield
    jax_executor._RECORDED_OPS.intersection_update(before)


def _ex(fluid):
    return pt_executor if fluid is pt else jax_executor


def make_lod(fluid, rows):
    flat = np.concatenate(rows, axis=0)
    offs = np.concatenate([[0], np.cumsum([len(r) for r in rows])]).tolist()
    return _ex(fluid).LoDTensor(flat, [offs])


def run_both(build, feeds, fetch=None, return_numpy=True):
    """`build(fluid)` -> the fetch list (Variables or names), in fresh
    programs of each package; `feeds(fluid)` -> a list of feed dicts, one
    a step. The port starts from the JAX startup's persistables. -> (the
    JAX package's fetches, the port's), a list a step each."""
    results, arrays = {}, None
    for fluid in (jfluid, pt):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            targets = build(fluid)
        scope = _ex(fluid).Scope()
        exe = fluid.Executor(fluid.CPUPlace())
        if fluid is jfluid:
            exe.run(startup, scope=scope)
            arrays = {n: np.asarray(scope.find_var(n))
                      for n, v in startup.global_block().desc.vars.items()
                      if v.persistable and scope.find_var(n) is not None}
        else:
            pt.interop.load_numpy_params(scope, arrays, "cpu")
        results[fluid] = [exe.run(main, feed=f, fetch_list=targets,
                                  scope=scope, return_numpy=return_numpy)
                          for f in feeds(fluid)]
    return results[jfluid], results[pt]


def assert_same(want, got, tol=F32):
    for w_step, g_step in zip(want, got):
        for w, g in zip(w_step, g_step):
            w, g = np.asarray(w), np.asarray(g)
            if np.issubdtype(w.dtype, np.floating):
                np.testing.assert_allclose(g, w, **tol)
            else:
                np.testing.assert_array_equal(g.astype(np.int64),
                                              w.astype(np.int64))


def one(feed=None):
    return lambda fluid: [dict(feed or {})]


# --- While and the tensor arrays -------------------------------------------------

def _counter_sum(fluid):
    L = fluid.layers
    i = L.fill_constant(shape=[1], dtype="int64", value=0)
    limit = L.fill_constant(shape=[1], dtype="int64", value=10)
    acc = L.fill_constant(shape=[1], dtype="float32", value=0.0)
    cond = L.less_than(x=i, y=limit)
    w = L.While(cond=cond)
    with w.block():
        casted = L.cast(i, "float32")
        L.assign(L.elementwise_add(acc, casted), acc)
        L.increment(i, value=1, in_place=True)
        L.less_than(x=i, y=limit, cond=cond)
    return [acc, i]


def test_while_counter_sum():
    want, got = run_both(_counter_sum, one())
    assert_same(want, got)
    assert float(got[0][0][0]) == sum(range(10)) and int(got[0][1][0]) == 10


def _array_accumulate(fluid):
    L = fluid.layers
    i = L.fill_constant(shape=[1], dtype="int64", value=0)
    limit = L.fill_constant(shape=[1], dtype="int64", value=5)
    seed = L.fill_constant(shape=[1], dtype="float32", value=0.0)
    arr = L.array_write(seed, i, capacity=8)
    cond = L.less_than(x=i, y=limit)
    w = L.While(cond=cond)
    with w.block():
        fi = L.cast(i, "float32")
        L.array_write(L.elementwise_mul(fi, fi), i, array=arr)
        L.increment(i, value=1, in_place=True)
        L.less_than(x=i, y=limit, cond=cond)
    third = L.array_read(arr, L.fill_constant(shape=[1], dtype="int64",
                                              value=3))
    return [third, L.array_length(arr)]


def test_while_array_accumulate():
    want, got = run_both(_array_accumulate, one())
    assert_same(want, got)
    assert float(got[0][0][0]) == 9.0 and int(got[0][1][0]) == 5


# --- ConditionalBlock, Switch, IfElse ---------------------------------------------

def _scalar_cond(fluid):
    L = fluid.layers
    x = L.data(name="x", shape=[4], dtype="float32")
    flag = L.data(name="flag", shape=[1], dtype="float32",
                  append_batch_size=False)
    zero = L.fill_constant(shape=[1], dtype="float32", value=0.0)
    out = L.fill_constant(shape=[1], dtype="float32", value=-1.0)
    cond = L.less_than(x=zero, y=flag)
    cb = L.ConditionalBlock([cond], is_scalar_condition=True)
    with cb.block():
        L.assign(L.reduce_sum(x), out)
    return [out]


@pytest.mark.parametrize("flag,expect", [(1.0, 8.0), (-1.0, -1.0)])
def test_conditional_block_scalar_cond(flag, expect):
    feed = {"x": np.ones((2, 4), np.float32),
            "flag": np.array([flag], np.float32)}
    want, got = run_both(_scalar_cond, one(feed))
    assert_same(want, got)
    assert float(got[0][0][0]) == expect


def _switch(fluid):
    L = fluid.layers
    step = L.data(name="step", shape=[1], dtype="float32",
                  append_batch_size=False)
    lr = L.fill_constant(shape=[1], dtype="float32", value=0.0)
    warmup = L.fill_constant(shape=[1], dtype="float32", value=100.0)
    with L.Switch() as switch:
        with switch.case(L.less_than(step, warmup)):
            L.assign(L.fill_constant(shape=[1], dtype="float32", value=0.01),
                     lr)
        with switch.default():
            L.assign(L.fill_constant(shape=[1], dtype="float32", value=0.1),
                     lr)
    return [lr]


@pytest.mark.parametrize("step,expect", [(10.0, 0.01), (200.0, 0.1)])
def test_switch_lr_warmup_style(step, expect):
    want, got = run_both(_switch, one({"step": np.array([step], np.float32)}))
    assert_same(want, got)
    assert abs(float(got[0][0][0]) - expect) < 1e-7


def _ifelse(fluid):
    L = fluid.layers
    x = L.data(name="x", shape=[1], dtype="float32")
    zero = L.fill_constant(shape=[1], dtype="float32", value=0.0)
    ie = L.IfElse(L.less_than(x=x, y=zero))
    with ie.true_block():
        ie.output(L.scale(ie.input(x), scale=-1.0))
    with ie.false_block():
        ie.output(ie.input(x))
    return [ie()]


def test_ifelse_row_select():
    xs = np.array([[-2.0], [3.0], [-5.0]], np.float32)
    want, got = run_both(_ifelse, one({"x": xs}))
    assert_same(want, got)
    np.testing.assert_allclose(got[0][0], np.abs(xs))


# --- StaticRNN and DynamicRNN ------------------------------------------------------

def _static_rnn(fluid):
    L = fluid.layers
    x = L.data(name="x", shape=[3], dtype="float32", lod_level=1)
    rnn = L.StaticRNN()
    with rnn.step():
        xt = rnn.step_input(x)
        h = rnn.memory(shape=[3], value=0.0)
        nh = L.elementwise_add(h, xt)
        rnn.update_memory(h, nh)
        rnn.step_output(nh)
    return [rnn()]


def test_static_rnn_cumsum_recurrence():
    rows = [np.ones((4, 3), np.float32), np.ones((2, 3), np.float32)]
    want, got = run_both(_static_rnn,
                         lambda fluid: [{"x": make_lod(fluid, rows)}])
    assert_same(want, got)
    np.testing.assert_allclose(got[0][0][:4, 0], [1, 2, 3, 4])
    np.testing.assert_allclose(got[0][0][4:, 0], [1, 2])


def _dyn_rnn(fluid, reverse=False):
    L = fluid.layers
    x = L.data(name="x", shape=[8], dtype="float32", lod_level=1)
    label = L.data(name="label", shape=[1], dtype="int64")
    rnn = L.DynamicRNN()
    rnn.is_reverse = reverse
    with rnn.block():
        xt = rnn.step_input(x)
        h = rnn.memory(shape=[16], value=0.0)
        nh = L.fc(input=L.concat([xt, h], axis=1), size=16, act="tanh")
        rnn.update_memory(h, nh)
        rnn.step_output(nh)
    last = L.sequence_last_step(rnn())
    logits = L.fc(input=last, size=2)
    loss = L.mean(L.softmax_with_cross_entropy(logits=logits, label=label))
    fluid.optimizer.Adam(learning_rate=5e-3).minimize(loss)
    return [loss]


def _dyn_rnn_feeds(steps):
    def feeds(fluid):
        rng = np.random.RandomState(0)
        out = []
        for _ in range(steps):
            rows, labs = [], []
            for _ in range(4):
                n = rng.randint(2, 7)
                bias = rng.choice([-0.5, 0.5])
                rows.append((rng.randn(n, 8) * 0.3 + bias).astype(np.float32))
                labs.append([int(rows[-1].mean() > 0)])
            out.append({"x": make_lod(fluid, rows),
                        "label": np.asarray(labs, np.int64)})
        return out
    return feeds


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "reverse"])
def test_dynamic_rnn_trains_as_the_jax_package(reverse):
    """Five Adam steps of the DynamicRNN cell on ragged batches: the losses
    within rtol 1e-4; the rnn grad is the generic one, one re-run a step."""
    registry.RERUNS.clear()
    want, got = run_both(lambda fluid: _dyn_rnn(fluid, reverse),
                         _dyn_rnn_feeds(5))
    assert_same(want, got, dict(rtol=1e-4, atol=1e-6))
    assert registry.RERUNS["rnn"] == 5
    assert got[-1][0][0] < got[0][0][0]


def test_dynamic_rnn_converges():
    """tests/test_control_flow.py's threshold at 60 steps of 16 sequences,
    through the port alone."""
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        loss, = _dyn_rnn(pt)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    losses = []
    for _ in range(60):
        rows, labs = [], []
        for _ in range(16):
            n = rng.randint(2, 7)
            bias = rng.choice([-0.5, 0.5])
            rows.append((rng.randn(n, 8) * 0.3 + bias).astype(np.float32))
            labs.append([int(rows[-1].mean() > 0)])
        lv, = exe.run(main, feed={"x": make_lod(pt, rows),
                                  "label": np.asarray(labs, np.int64)},
                      fetch_list=[loss], scope=scope)
        losses.append(float(lv.ravel()[0]))
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) * 0.6, losses


# --- grads through while and conditional_block ------------------------------------

def _while_grad(fluid):
    L = fluid.layers
    x = L.data(name="x", shape=[4], dtype="float32", append_batch_size=False,
               stop_gradient=False)
    w = L.data(name="w", shape=[4], dtype="float32", append_batch_size=False,
               stop_gradient=False)
    y = L.scale(x, scale=1.0)
    i = L.fill_constant(shape=[1], dtype="int64", value=0)
    limit = L.fill_constant(shape=[1], dtype="int64", value=3)
    cond = L.less_than(x=i, y=limit)
    wl = L.While(cond=cond)
    with wl.block():
        L.assign(L.elementwise_add(L.elementwise_mul(y, w), x), y)
        L.increment(i, value=1, in_place=True)
        L.less_than(x=i, y=limit, cond=cond)
    loss = L.reduce_sum(y)
    fluid.backward.append_backward(loss)
    return [loss, "x@GRAD", "w@GRAD"]


def _xw_feeds(seed, deltas=()):
    def feeds(fluid):
        rng = np.random.RandomState(seed)
        xv = rng.randn(4).astype(np.float32)
        wv = rng.rand(4).astype(np.float32) * 0.8 + 0.1
        out = [{"x": xv, "w": wv}]
        for k, d in deltas:
            xp = xv.copy()
            xp[k] += d
            out.append({"x": xp, "w": wv})
        return out
    return feeds


def test_while_grad_matches_closed_form():
    want, got = run_both(_while_grad, _xw_feeds(3))
    assert_same(want, got, GRAD)
    rng = np.random.RandomState(3)
    xv = rng.randn(4).astype(np.float32)
    wv = rng.rand(4).astype(np.float32) * 0.8 + 0.1
    lv, gx, gw = got[0]
    np.testing.assert_allclose(float(lv[0]),
                               float(np.sum(xv * (wv**3 + wv**2 + wv + 1))),
                               rtol=1e-5)
    np.testing.assert_allclose(gx, wv**3 + wv**2 + wv + 1, rtol=1e-5)
    np.testing.assert_allclose(gw, xv * (3 * wv**2 + 2 * wv + 1), rtol=1e-5)


def test_while_grad_numeric():
    """tests/test_control_flow.py's central differences (delta 1e-2) of
    the port's loss against its analytic x@GRAD."""
    delta = 1e-2
    deltas = [(k, s * delta) for k in range(4) for s in (1, -1)]
    want, got = run_both(_while_grad, _xw_feeds(7, deltas))
    assert_same(want, got, GRAD)
    gx = got[0][1]
    losses = [float(step[0][0]) for step in got[1:]]
    num = [(losses[2 * k] - losses[2 * k + 1]) / (2 * delta) for k in range(4)]
    np.testing.assert_allclose(gx, num, rtol=2e-3, atol=2e-3)


def _while_train(fluid):
    L = fluid.layers
    x = L.data(name="x", shape=[8], dtype="float32", append_batch_size=False)
    target = L.data(name="target", shape=[8], dtype="float32",
                    append_batch_size=False)
    w = L.create_parameter(shape=[8], dtype="float32", name="w_loop")
    y = L.scale(x, scale=1.0)
    i = L.fill_constant(shape=[1], dtype="int64", value=0)
    limit = L.fill_constant(shape=[1], dtype="int64", value=2)
    cond = L.less_than(x=i, y=limit)
    wl = L.While(cond=cond)
    with wl.block():
        L.assign(L.elementwise_add(y, w), y)
        L.increment(i, value=1, in_place=True)
        L.less_than(x=i, y=limit, cond=cond)
    loss = L.reduce_mean(L.square(L.elementwise_sub(y, target)))
    fluid.optimizer.SGD(learning_rate=0.2).minimize(loss)
    return [loss]


def test_while_training_converges():
    feeds = lambda fluid: [{"x": np.zeros(8, np.float32),  # noqa: E731
                            "target": np.full(8, 3.0, np.float32)}] * 30
    want, got = run_both(_while_train, feeds)
    assert_same(want[:5], got[:5], dict(rtol=1e-4, atol=1e-6))
    losses = [float(s[0][0]) for s in got]
    assert losses[-1] < losses[0] * 1e-2, losses


def _cond_grad(fluid):
    L = fluid.layers
    x = L.data(name="x", shape=[4], dtype="float32", append_batch_size=False,
               stop_gradient=False)
    p = L.data(name="p", shape=[1], dtype="float32", append_batch_size=False,
               stop_gradient=False)
    flag = L.data(name="flag", shape=[1], dtype="float32",
                  append_batch_size=False)
    zero = L.fill_constant(shape=[1], dtype="float32", value=0.0)
    out = L.scale(p, scale=1.0)
    cb = L.ConditionalBlock([L.less_than(x=zero, y=flag)],
                            is_scalar_condition=True)
    with cb.block():
        L.assign(L.reduce_sum(L.scale(x, scale=2.0)), out)
    fluid.backward.append_backward(L.reduce_sum(out))
    return ["x@GRAD", "p@GRAD"]


@pytest.mark.parametrize("flag,gx,gp", [(1.0, 2.0, 0.0), (-1.0, 0.0, 1.0)])
def test_conditional_block_grads_both_branches(flag, gx, gp):
    feed = {"x": np.arange(4, dtype=np.float32),
            "p": np.array([5.0], np.float32),
            "flag": np.array([flag], np.float32)}
    want, got = run_both(_cond_grad, one(feed))
    assert_same(want, got, GRAD)
    np.testing.assert_allclose(got[0][0], np.full(4, gx), atol=1e-7)
    np.testing.assert_allclose(got[0][1], [gp], atol=1e-7)


def test_no_grad_op_on_loss_path_raises():
    """write_to_array registers no grad: on the loss path append_backward
    raises in both packages."""
    for fluid in (jfluid, pt):
        with fluid.unique_name.guard(), fluid.program_guard(fluid.Program(),
                                                            fluid.Program()):
            L = fluid.layers
            x = L.data(name="x", shape=[4], dtype="float32",
                       append_batch_size=False)
            i = L.fill_constant(shape=[1], dtype="int64", value=0)
            y = L.array_read(L.array_write(x, i, capacity=4), i)
            with pytest.raises(RuntimeError, match="no gradient"):
                fluid.backward.append_backward(L.reduce_sum(y))


def _long_loop(fluid, max_iters=None):
    L = fluid.layers
    w = L.data(name="w", shape=[2], dtype="float32", append_batch_size=False,
               stop_gradient=False)
    y = L.scale(w, scale=0.0)
    i = L.fill_constant(shape=[1], dtype="int64", value=0)
    limit = L.fill_constant(shape=[1], dtype="int64", value=200)
    cond = L.less_than(x=i, y=limit)
    wl = L.While(cond=cond, max_iters=max_iters)
    with wl.block():
        L.assign(L.elementwise_add(y, w), y)
        L.increment(i, value=1, in_place=True)
        L.less_than(x=i, y=limit, cond=cond)
    loss = L.reduce_sum(y)
    fluid.backward.append_backward(loss)
    return ["w@GRAD", loss]


@pytest.mark.parametrize("max_iters", [None, 256], ids=["cap128", "cap256"])
def test_step_record_cap(max_iters):
    """200 iterations: past the default cap of 128 the grads are NaN and the
    forward exact; with max_iters 256 the true gradient."""
    feed = one({"w": np.ones(2, np.float32)})
    want, got = run_both(lambda fluid: _long_loop(fluid, max_iters), feed)
    gw, lv = got[0]
    assert float(lv[0]) == float(want[0][1][0]) == 400.0
    if max_iters is None:
        assert np.all(np.isnan(gw)) and np.all(np.isnan(want[0][0]))
    else:
        np.testing.assert_allclose(gw, [200.0, 200.0], rtol=1e-6)
        assert_same(want, got, GRAD)


def _increment_grad(fluid):
    L = fluid.layers
    x = L.data(name="x", shape=[2], dtype="float32", append_batch_size=False,
               stop_gradient=False)
    y = L.increment(L.scale(x, scale=3.0), value=1.0, in_place=False)
    fluid.backward.append_backward(L.reduce_sum(y))
    return ["x@GRAD"]


def test_float_increment_differentiable():
    want, got = run_both(_increment_grad, one({"x": np.ones(2, np.float32)}))
    assert_same(want, got, GRAD)
    np.testing.assert_allclose(got[0][0], [3.0, 3.0], rtol=1e-6)


# --- the LoD array ops and Print ------------------------------------------------------

def _lod_arrays(fluid):
    L = fluid.layers
    x = L.data(name="x", shape=[3], dtype="float32", lod_level=1)
    mask = L.data(name="mask", shape=[1], dtype="bool")
    table = L.lod_rank_table(x)
    arr = L.lod_tensor_to_array(x, table)
    back = L.array_to_lod_tensor(arr, table)
    longest = L.max_sequence_len(table)
    reordered = L.reorder_lod_tensor_by_rank(x, table)
    i = L.fill_constant(shape=[1], dtype="int64", value=1)
    step1 = L.array_read(arr, i)
    shrunk = L.shrink_memory(step1, i, table)
    last = L.sequence_last_step(x)
    t_in, f_in = L.split_lod_tensor(last, mask)
    merged = L.merge_lod_tensor(L.scale(t_in, scale=2.0), f_in, last, mask)
    return [back, longest, reordered, step1, shrunk, t_in, f_in, merged]


def test_lod_array_ops():
    rng = np.random.RandomState(4)
    rows = [rng.randn(n, 3).astype(np.float32) for n in (2, 5, 3)]
    mask = np.array([[True], [False], [True]])
    want, got = run_both(_lod_arrays, lambda fluid: [
        {"x": make_lod(fluid, rows), "mask": mask}])
    assert_same(want, got)
    back, longest, reordered = got[0][:3]
    np.testing.assert_array_equal(back, np.concatenate(rows))
    assert int(longest[0]) == 5
    np.testing.assert_array_equal(
        reordered, np.concatenate([rows[1], rows[2], rows[0]]))


def _printed(fluid):
    L = fluid.layers
    x = L.data(name="x", shape=[3], dtype="float32", stop_gradient=False)
    y = L.Print(L.scale(x, scale=2.0), message="twice ", summarize=2)
    fluid.backward.append_backward(L.reduce_sum(L.square(y)))
    return [y, "x@GRAD"]


def test_print_passes_through_and_prints(capsys):
    xs = np.arange(6, dtype=np.float32).reshape(2, 3)
    want, got = run_both(_printed, one({"x": xs}))
    assert_same(want, got, GRAD)
    assert "twice " in capsys.readouterr().out


# --- the IR's sub-blocks and the graph gate ---------------------------------------------

def test_sub_blocks_survive_clone_prune_and_json():
    """clone, prune and to_json/from_json keep every block, with each op's
    BlockRef naming its own block; prune keeps the ops that feed a
    sub-block."""
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        acc, i = _counter_sum(pt)
        extra = pt.layers.scale(acc, scale=3.0)
    for p in (main.clone(), pt.Program.from_json(main.to_json()),
              main.prune([], [acc.name])):
        assert p.num_blocks == main.num_blocks == 2
        w = next(o for o in p.global_block().ops if o.type == "while")
        assert w.attr("sub_block").idx == 1
        assert [o.type for o in p.block(1).ops] == \
            [o.type for o in main.block(1).ops]
    pruned = main.prune([], [acc.name])
    assert not any(o.output_arg_names == [extra.name]
                   for o in pruned.global_block().ops)
    # the limit is read only by ops inside the loop and before it
    kept = {n for o in pruned.global_block().ops for n in o.output_arg_names}
    assert i.name in kept
    res = pt.Executor(pt.CPUPlace()).run(pruned, fetch_list=[acc.name],
                                         scope=pt.Scope())
    assert float(res[0][0]) == 45.0


def _card_gate(exe):
    """The gate as it answers on a CUDA place."""
    exe.device = torch.device("cuda", 0)
    return exe


def test_gate_sends_control_flow_eager_and_graphs_rnn():
    exe = _card_gate(pt.Executor(pt.CPUPlace()))
    for build, want in ((_counter_sum, "control_flow"),
                        (_scalar_cond, "control_flow"),
                        (_printed, "control_flow"),
                        (_dyn_rnn, None)):
        main, startup = pt.Program(), pt.Program()
        with pt.unique_name.guard(), pt.program_guard(main, startup):
            build(pt)
        feed = {"x": None, "label": None}
        assert exe.graph_gate(main, feed) == want, build.__name__


def test_host_syncs_counted_and_state_seen_inside_loops():
    """One host read of the condition a while iteration (and one for the
    exit); a weight only the loop body reads is state the run resolves."""
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        L = pt.layers
        i = L.fill_constant(shape=[1], dtype="int64", value=0)
        limit = L.fill_constant(shape=[1], dtype="int64", value=4)
        acc = L.fill_constant(shape=[2], dtype="float32", value=0.0)
        w = L.create_parameter(shape=[2], dtype="float32", name="w_body")
        cond = L.less_than(x=i, y=limit)
        wl = L.While(cond=cond)
        with wl.block():
            L.assign(L.elementwise_add(acc, w), acc)
            L.increment(i, value=1, in_place=True)
            L.less_than(x=i, y=limit, cond=cond)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    assert "w_body" in exe._resolve_state(main, {}, scope)
    pt_executor.COUNTERS.reset()
    out, = exe.run(main, fetch_list=[acc], scope=scope)
    assert pt_executor.COUNTERS.host_syncs == {"while": 5}
    np.testing.assert_allclose(out, 4 * scope.find_var("w_body").numpy(),
                               rtol=1e-6)
