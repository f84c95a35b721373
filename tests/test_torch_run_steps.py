"""Executor.run_steps of the port (paddle_tpu_torch) on the CPU: K steps in
one call, bitwise K sequential run() calls in losses, scope and rng
counter (the port's counterpart of tests/test_run_steps.py; its dropout
and LoD cases are in tests/test_torch_lod.py), the window checks
and fetch modes, a failed window leaving the scope as it was, and the
port against the JAX package from the same weights.

Cross-package: the JAX startup's parameters go into the port's scope by
name (interop.load_numpy_params). On fit_a_line the port's run_steps is
held to the JAX package's run_steps; on the conv model to four JAX run()
calls, which tests/test_run_steps.py pins bitwise to the JAX run_steps
(XLA:CPU runs a conv step inside lax.scan some 60 times slower). Both
packages sum in f32 in their own order: losses within 1e-5 relative,
every parameter and accumulator within 1e-5 relative L2.
"""

import torch_threads  # noqa: F401  (the cores shared among xdist workers)
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import executor as jax_executor
import paddle_tpu_torch as pt
from paddle_tpu_torch import executor as port_executor

K = 4
RTOL = 1e-5


@pytest.fixture(autouse=True)
def _keep_jax_op_census():
    """The JAX executor's op census (executor._RECORDED_OPS) gets back the
    op types these runs added, as in tests/test_torch_ops.py: the
    op-coverage gate counts only its own worker's census (ROADMAP.md
    Queue 3), and parity runs must not push a worker over its line."""
    before = set(jax_executor._RECORDED_OPS)
    yield
    jax_executor._RECORDED_OPS.intersection_update(before)


def _fit_a_line(fluid):
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(prog, startup):
        x = fluid.layers.data(name="x", shape=[13], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        h = fluid.layers.fc(input=x, size=16, act="relu")
        y_predict = fluid.layers.fc(input=h, size=1, act=None)
        cost = fluid.layers.square_error_cost(input=y_predict, label=y)
        avg_cost = fluid.layers.mean(cost)
        fluid.optimizer.SGD(learning_rate=0.05).minimize(
            avg_cost, startup_program=startup)
    rng = np.random.default_rng(7)
    w = rng.standard_normal((13, 1)).astype(np.float32)
    feeds = []
    for _ in range(K):
        xs = rng.standard_normal((8, 13)).astype(np.float32)
        feeds.append({"x": xs, "y": (xs @ w).astype(np.float32)})
    return prog, startup, avg_cost, feeds


def _conv_model(fluid):
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(prog, startup):
        img = fluid.layers.data(name="img", shape=[1, 8, 8],
                                dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        conv = fluid.layers.conv2d(input=img, num_filters=4, filter_size=3,
                                   act="relu")
        pool = fluid.layers.pool2d(conv, pool_size=2, pool_type="max",
                                   pool_stride=2)
        pred = fluid.layers.fc(input=pool, size=10, act="softmax")
        cost = fluid.layers.cross_entropy(input=pred, label=label)
        avg_cost = fluid.layers.mean(cost)
        fluid.optimizer.Momentum(learning_rate=0.01, momentum=0.9).minimize(
            avg_cost, startup_program=startup)
    rng = np.random.default_rng(3)
    feeds = [{"img": rng.standard_normal((4, 1, 8, 8)).astype(np.float32),
              "label": rng.integers(0, 10, (4, 1)).astype(np.int64)}
             for _ in range(K)]
    return prog, startup, avg_cost, feeds


MODELS = {"fit_a_line": _fit_a_line, "conv_model": _conv_model}


def _clone_scope(src):
    dst = pt.Scope()
    for n, v in src.vars.items():
        dst.set_var(n, v.clone() if isinstance(v, torch.Tensor) else v)
    return dst


def _assert_scope_parity(sa, sb):
    assert set(sa.vars) == set(sb.vars), set(sa.vars) ^ set(sb.vars)
    for n, a in sa.vars.items():
        b = sb.vars[n]
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f"state '{n}' diverged"
        else:
            assert a == b, (n, a, b)


def _port_start(model):
    prog, startup, loss, feeds = model(pt)
    exe = pt.Executor(pt.CPUPlace())
    sa = pt.Scope()
    exe.run(startup, scope=sa)
    return exe, prog, startup, loss, feeds, sa


@pytest.mark.parametrize("model", sorted(MODELS))
def test_run_steps_bitwise_k_runs(model):
    """K run() calls and one run_steps window from the same scope: the
    same losses, scope and rng counter, bit for bit."""
    exe, prog, _, loss, feeds, sa = _port_start(MODELS[model])
    sb = _clone_scope(sa)
    c0 = sa.find_var("__rng_counter__") or 0
    seq = [exe.run(prog, feed=f, fetch_list=[loss], scope=sa)[0]
           for f in feeds]
    win, = exe.run_steps(prog, feed_window=feeds, fetch_list=[loss],
                         scope=sb, fetch_mode="stack")
    np.testing.assert_array_equal(np.stack(seq), win)
    assert sa.find_var("__rng_counter__") == \
        sb.find_var("__rng_counter__") == c0 + K
    _assert_scope_parity(sa, sb)


def test_rng_counter_per_step(monkeypatch):
    """Step i of a window runs with counter c + i, as the i-th of K
    sequential run() calls does: the counters handed to the lowerings'
    contexts, in order."""
    exe, prog, _, loss, feeds, sa = _port_start(_fit_a_line)
    sb = _clone_scope(sa)
    seen = []
    init = port_executor.LoweringContext.__init__

    def spy(self, executor, program, rng_counter):
        seen.append(rng_counter)
        init(self, executor, program, rng_counter)

    monkeypatch.setattr(port_executor.LoweringContext, "__init__", spy)
    for f in feeds:
        exe.run(prog, feed=f, fetch_list=[loss], scope=sa)
    seq, seen[:] = list(seen), []
    exe.run_steps(prog, feed_window=feeds, fetch_list=[loss], scope=sb)
    c0 = seq[0]
    assert seq == seen == list(range(c0, c0 + K))


def test_prestacked_dict_and_fetch_modes():
    exe, prog, _, loss, feeds, sa = _port_start(_fit_a_line)
    sb, sc = _clone_scope(sa), _clone_scope(sa)
    stacked = {n: np.stack([f[n] for f in feeds]) for n in feeds[0]}
    all_losses, = exe.run_steps(prog, feed_window=feeds, fetch_list=[loss],
                                scope=sa, fetch_mode="stack")
    last, = exe.run_steps(prog, feed_window=stacked, fetch_list=[loss],
                          scope=sb, fetch_mode="last")
    mean, = exe.run_steps(prog, feed_window=stacked, steps=K,
                          fetch_list=[loss], scope=sc, fetch_mode="mean")
    np.testing.assert_array_equal(all_losses[-1], last)
    np.testing.assert_allclose(np.asarray(all_losses).mean(axis=0), mean,
                               rtol=1e-6)
    _assert_scope_parity(sa, sb)
    _assert_scope_parity(sa, sc)


def test_tensor_window_and_return_tensors():
    """A window of torch tensors (what DoubleBufferedFeeder hands out)
    runs as its numpy twin; return_numpy=False keeps the fetches as
    tensors on the executor's device."""
    exe, prog, _, loss, feeds, sa = _port_start(_fit_a_line)
    sb = _clone_scope(sa)
    stacked = {n: np.stack([f[n] for f in feeds]) for n in feeds[0]}
    a, = exe.run_steps(prog, feed_window=stacked, fetch_list=[loss],
                       scope=sa, fetch_mode="stack")
    b, = exe.run_steps(prog, feed_window={n: torch.from_numpy(v) for n, v in
                                          stacked.items()},
                       fetch_list=[loss], scope=sb, fetch_mode="stack",
                       return_numpy=False)
    assert isinstance(b, torch.Tensor) and b.device.type == "cpu"
    np.testing.assert_array_equal(a, b.numpy())
    _assert_scope_parity(sa, sb)


def test_window_shape_validation():
    exe, prog, _, loss, feeds, s = _port_start(_fit_a_line)
    with pytest.raises(ValueError, match="steps=3"):
        exe.run_steps(prog, feed_window=feeds, steps=3,
                      fetch_list=[loss], scope=s)
    bad = {n: np.stack([f[n] for f in feeds]) for n in feeds[0]}
    bad["y"] = bad["y"][:2]
    with pytest.raises(ValueError, match="leading dims"):
        exe.run_steps(prog, feed_window=bad, fetch_list=[loss], scope=s)
    with pytest.raises(ValueError, match="feed_window"):
        exe.run_steps(prog, fetch_list=[loss], scope=s)
    with pytest.raises(ValueError, match="fetch_mode"):
        exe.run_steps(prog, feed_window=feeds, fetch_list=[loss], scope=s,
                      fetch_mode="first")
    with pytest.raises(ValueError, match="explicit steps"):
        exe.run_steps(prog, reader=object(), fetch_list=[loss], scope=s)
    with pytest.raises(ValueError, match="not both"):
        exe.run_steps(prog, feeds, reader=object(), steps=K,
                      fetch_list=[loss], scope=s)
    with pytest.raises(ValueError, match="same keys"):
        exe.run_steps(prog, feed_window=[feeds[0], {"x": feeds[1]["x"]}],
                      fetch_list=[loss], scope=s)


def test_lod_feed_raises():
    prog, startup = pt.Program(), pt.Program()
    with pt.program_guard(prog, startup):
        words = pt.layers.data(name="words", shape=[1], dtype="int64",
                               lod_level=1)
        out = pt.layers.scale(words, 2.0)
    exe = pt.Executor(pt.CPUPlace())
    # a pre-stacked window holding a LoDTensor raises, as the JAX
    # package's (executor.py:766); per-step dicts fall back per step
    window = {"words": pt.LoDTensor(np.zeros((K, 1), np.int64),
                                    [list(range(K + 1))])}
    with pytest.raises(ValueError, match="per-step"):
        exe.run_steps(prog, feed_window=window, fetch_list=[out],
                      scope=pt.Scope())


def test_steps_counted():
    exe, prog, _, loss, feeds, s = _port_start(_fit_a_line)
    before = port_executor.COUNTERS.steps
    exe.run_steps(prog, feed_window=feeds, fetch_list=[loss], scope=s)
    assert port_executor.COUNTERS.steps - before == K


def test_window_advances_counter_atomically_by_k():
    exe, prog, _, loss, feeds, s = _port_start(_fit_a_line)
    c0 = s.find_var("__rng_counter__") or 0
    exe.run_steps(prog, feed_window=feeds, fetch_list=[loss], scope=s)
    assert s.find_var("__rng_counter__") == c0 + K
    exe.run_steps(prog, feed_window=feeds, fetch_list=[loss], scope=s)
    assert s.find_var("__rng_counter__") == c0 + 2 * K


def test_failed_window_leaves_scope_and_counter():
    """A window whose last step fails (its x has the wrong width) writes
    nothing back: the scope's tensors and the counter are as before, and a
    good window then runs as from the start."""
    exe, prog, _, loss, feeds, s = _port_start(_fit_a_line)
    ref = _clone_scope(s)
    before = {n: v.clone() if isinstance(v, torch.Tensor) else v
              for n, v in s.vars.items()}
    bad = [dict(f) for f in feeds]
    bad[-1]["x"] = np.zeros((8, 5), np.float32)
    with pytest.raises(Exception):
        exe.run_steps(prog, feed_window=bad, fetch_list=[loss], scope=s)
    for n, v in before.items():
        got = s.vars[n]
        assert (torch.equal(got, v) if isinstance(v, torch.Tensor)
                else got == v), n
    a, = exe.run_steps(prog, feed_window=feeds, fetch_list=[loss], scope=s,
                       fetch_mode="stack")
    b, = exe.run_steps(prog, feed_window=feeds, fetch_list=[loss],
                       scope=ref, fetch_mode="stack")
    np.testing.assert_array_equal(a, b)


# --- against the JAX package -------------------------------------------------

def _rl2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _jax_persistables(scope, startup):
    return {n: np.array(scope.find_var(n))
            for n, v in startup.global_block().desc.vars.items()
            if v.persistable}


@pytest.mark.parametrize("model", sorted(MODELS))
def test_run_steps_matches_the_jax_package(model):
    """The port's run_steps from the JAX startup's weights against the
    JAX package: its run_steps on fit_a_line, four run() calls on the conv
    model."""
    jprog, jstartup, jloss, feeds = MODELS[model](jfluid)
    jscope = jax_executor.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    init = _jax_persistables(jscope, jstartup)
    if model == "fit_a_line":
        jl, = jexe.run_steps(jprog, feed_window=feeds, fetch_list=[jloss],
                             scope=jscope, fetch_mode="stack")
    else:
        jl = np.stack([jexe.run(jprog, feed=f, fetch_list=[jloss],
                                scope=jscope)[0] for f in feeds])
    after = _jax_persistables(jscope, jstartup)

    prog, _, loss, _ = MODELS[model](pt)
    scope = pt.Scope()
    pt.interop.load_numpy_params(scope, init, "cpu")
    exe = pt.Executor(pt.CPUPlace())
    pl, = exe.run_steps(prog, feed_window=feeds, fetch_list=[loss],
                        scope=scope, fetch_mode="stack")
    np.testing.assert_allclose(pl, np.asarray(jl), rtol=RTOL)
    assert set(after) == {n for n in scope.vars if n != "__rng_counter__"}
    for n, want in after.items():
        got = scope.find_var(n).numpy()
        assert got.shape == want.shape, n
        assert _rl2(got, want) <= RTOL, (n, _rl2(got, want))


# --- concat, the op the word2vec chapter adds --------------------------------

def _concat_net(fluid, axis, widths):
    """loss = sum(concat(inputs, axis) * w), inputs [-1, 3, 4] but for
    their `widths` along `axis`."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        ins = []
        for i, width in enumerate(widths):
            shape = [3, 4]
            shape[axis - 1] = width
            ins.append(fluid.layers.data(name=f"in{i}", shape=shape,
                                         dtype="float32",
                                         stop_gradient=False))
        out = fluid.layers.concat(ins, axis=axis)
        w = fluid.layers.data(name="w", shape=list(out.shape[1:]),
                              dtype="float32")
        loss = fluid.layers.reduce_sum(fluid.layers.elementwise_mul(out, w))
        fluid.backward.append_backward(loss)
    return main, out


@pytest.mark.parametrize("axis,widths", [(1, (3, 2)), (2, (4, 1, 5))],
                         ids=["axis1", "axis2_three_inputs"])
def test_concat_and_its_grad_match_the_jax_op(axis, widths):
    """concat's output and, through the generic grad, the grads of its
    inputs, against the JAX package's on the same feeds."""
    rng = np.random.default_rng(axis)
    feed = {}
    for i, width in enumerate(widths):
        shape = [2, 3, 4]
        shape[axis] = width
        feed[f"in{i}"] = rng.standard_normal(shape).astype(np.float32)
    want = np.concatenate([feed[f"in{i}"] for i in range(len(widths))],
                          axis=axis)
    feed["w"] = rng.standard_normal(want.shape).astype(np.float32)
    names = [f"in{i}@GRAD" for i in range(len(widths))]
    outs = []
    for fluid, scope in ((jfluid, jax_executor.Scope()), (pt, pt.Scope())):
        main, out = _concat_net(fluid, axis, widths)
        assert list(main.global_block().var(out.name).shape) == \
            [-1] + list(want.shape[1:])
        exe = fluid.Executor(fluid.CPUPlace())
        outs.append(exe.run(main, feed=feed, fetch_list=[out] + names,
                            scope=scope))
    for j, p in zip(*outs):
        np.testing.assert_allclose(p, np.asarray(j), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(outs[1][0], want)
    for i, name in enumerate(names):    # the grad of a linear op: w's slices
        np.testing.assert_array_equal(outs[1][1 + i], np.split(
            feed["w"], np.cumsum(widths)[:-1], axis=axis)[i])
