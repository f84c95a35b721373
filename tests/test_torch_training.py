"""The training slice as a whole on the CPU: the same small net trained by the
JAX package and by the port from the same weights, fit_a_line converging
in the port, the optimizer ops against the JAX lowerings, and the scope
across runs.

The net is built from models/resnet.py blocks in both packages: a 3x3 stem
conv_bn_layer 3->128 (whose conv fails the conv gate on Ci=3, so under AMP
O2 its batch_norm is K6's case), bottleneck(ch_in=128, ch_out=128,
stride=2) (whose input feeds two convs: an @RENAME@ + sum), global average
pooling, fc(10), softmax_with_cross_entropy, mean; input [2, 3, 16, 16],
Momentum(0.05, 0.9), three steps on three seeded batches. The JAX startup's
parameters (and zero velocities) are carried into the port's scope by name.

Tolerances. f32: rtol 1e-4 on the losses, and every parameter, velocity and
running statistic within 1e-4 of its largest magnitude (both sum in f32 in
their own order; measured spread 2e-6). AMP O2: the losses within 1e-2
relative; every tensor within twice the distance between the JAX package's
own O2 and f32 runs plus 2 % of its largest magnitude — the port's O2 must
be no further from the JAX O2 than bf16 noise moves the JAX package itself.
With BN statistics over 2x8x8 pixels the noise is large: the JAX O2 run
differs from its f32 run by up to 19 % of a velocity's largest magnitude
after three steps, the port's O2 from the JAX O2 by up to 23 %.
"""

import torch_threads  # noqa: F401  (the cores shared among xdist workers)
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jfluid
from paddle_tpu import executor as jax_executor
from paddle_tpu.models import resnet as jax_resnet
from paddle_tpu.ops import registry as jax_registry
import paddle_tpu_torch as pt
from paddle_tpu_torch.models import resnet as port_resnet
from paddle_tpu_torch.ops import bn_cuda, conv_cuda, registry

STEPS = 3


@pytest.fixture(autouse=True)
def _keep_jax_op_census():
    """The JAX executor records every op type it runs
    (executor._RECORDED_OPS). tests/test_zz_op_coverage.py holds its xdist
    worker's census to every registered op once it passes 150 types, which
    no one worker reaches (a fault of that gate, ROADMAP.md Queue 3); the
    parity runs here take back the op types they added, so they cannot
    push a worker over that line, and do not count toward the gate."""
    before = set(jax_executor._RECORDED_OPS)
    yield
    jax_executor._RECORDED_OPS.intersection_update(before)


def _build(fluid, amp):
    resnet = jax_resnet if fluid is jfluid else port_resnet
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[3, 16, 16],
                                dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        x = resnet.conv_bn_layer(img, 128, 3, 1, 1)
        x = resnet.bottleneck(x, 128, 128, 2)
        x = fluid.layers.pool2d(x, pool_size=8, pool_type="avg",
                                global_pooling=True)
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
            fluid.layers.fc(x, size=10), label))
        opt = fluid.optimizer.Momentum(learning_rate=0.05, momentum=0.9)
        if amp:
            opt = fluid.amp.decorate(opt, level="O2")
        opt.minimize(loss)
    return main, startup, loss


def _feeds():
    rng = np.random.default_rng(0)
    return [{"img": rng.standard_normal((2, 3, 16, 16)).astype(np.float32),
             "label": rng.integers(0, 10, (2, 1)).astype(np.int64)}
            for _ in range(STEPS)]


_JAX_RUNS = {}


def _jax_run(amp):
    """The JAX package's startup weights, per-step losses and state after
    the steps, computed once per precision (O2 runs the Pallas kernels in
    interpret mode)."""
    if amp not in _JAX_RUNS:
        main, startup, loss = _build(jfluid, amp)
        scope = jax_executor.Scope()
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup, scope=scope)
        init = {n: np.array(scope.find_var(n)).astype(np.float32)
                for n, v in startup.global_block().desc.vars.items()
                if v.persistable}
        losses = [float(np.ravel(exe.run(main, feed=f, fetch_list=[loss],
                                         scope=scope)[0])[0])
                  for f in _feeds()]
        after = {n: np.array(scope.find_var(n)).astype(np.float32)
                 for n in init}
        _JAX_RUNS[amp] = (init, losses, after)
    return _JAX_RUNS[amp]


def _port_run(amp, init):
    main, _, loss = _build(pt, amp)
    scope = pt.Scope()
    pt.interop.load_numpy_params(scope, init, "cpu")
    exe = pt.Executor(pt.CPUPlace())
    losses = [float(np.ravel(exe.run(main, feed=f, fetch_list=[loss],
                                     scope=scope)[0])[0])
              for f in _feeds()]
    return losses, {n: scope.find_var(n).float().numpy() for n in init}


def test_startup_creates_the_jax_variables():
    """The port's startup, run, fills exactly the scope variables the JAX
    startup fills — parameters, batch-norm statistics, velocities and the
    learning rate — with the same shapes, so weights and optimizer state
    carry across by name."""
    init, _, _ = _jax_run(False)
    _, startup, _ = _build(pt, False)
    scope = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(startup, scope=scope)
    got = {n: tuple(v.shape) for n, v in scope.vars.items()
           if not n.startswith("__")}
    assert got == {n: a.shape for n, a in init.items()}
    assert sum(n.endswith("_velocity_0") for n in got) == 17
    assert float(scope.find_var("learning_rate_0")) == pytest.approx(0.05)


def test_f32_training_matches_jax():
    init, want_losses, want = _jax_run(False)
    losses, got = _port_run(False, init)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4)
    for n in want:
        scale = np.abs(want[n]).max() + 1e-12
        assert np.abs(got[n] - want[n]).max() <= 1e-4 * scale, n
    assert any(np.abs(want[n] - init[n]).max() > 1e-3 for n in want)


def test_amp_o2_training_matches_jax():
    init, _, ref32 = _jax_run(False)
    _, want_losses, want = _jax_run(True)
    conv_cuda.COUNTERS.reset()
    bn_cuda.COUNTERS.reset()
    losses, got = _port_run(True, init)
    # the port took its kernel route at every window (plain versions here)
    assert conv_cuda.COUNTERS.hits == {"fused_conv_bn_act": 4 * STEPS,
                                       "conv2d_grad": 4 * STEPS}
    assert conv_cuda.COUNTERS.fallbacks == {("conv2d", "channels"): STEPS,
                                            ("conv2d_grad", "channels"): STEPS}
    assert bn_cuda.COUNTERS.hits == {"fused_conv_bn_act": 4 * STEPS,
                                     "fused_bn_act": STEPS}
    np.testing.assert_allclose(losses, want_losses, rtol=1e-2)
    for n in want:
        scale = np.abs(want[n]).max() + 1e-12
        noise = np.abs(want[n] - ref32[n]).max()
        assert np.abs(got[n] - want[n]).max() <= 2 * noise + 0.02 * scale, n


def test_fit_a_line_converges():
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[16], dtype="float32")
        y = pt.layers.data(name="y", shape=[1], dtype="float32")
        pred = pt.layers.fc(input=x, size=1)
        loss = pt.layers.mean(pt.layers.square_error_cost(pred, y))
        pt.optimizer.SGD(learning_rate=0.05).minimize(loss)
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    w = rng.randn(16, 1).astype(np.float32)
    for _ in range(100):
        xs = rng.randn(64, 16).astype(np.float32)
        out, = exe.run(main, feed={"x": xs, "y": xs @ w}, fetch_list=[loss],
                       scope=scope)
    assert float(out[0]) < 1e-4


def test_a_second_run_reads_the_updated_state():
    """Executor.run writes every persistable output back to the scope
    (parameters, velocities, running statistics) and the next run reads
    them: one SGD-with-momentum step computed by hand from the scope
    before the run matches the scope after it."""
    main, startup, loss = _build(pt, False)
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    feed = _feeds()[0]
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    p1 = scope.find_var("fc_0.w_0").clone()
    v1 = scope.find_var("fc_0.w_0_velocity_0").clone()
    mean1 = scope.find_var("batch_norm_0.w_1").clone()
    grad, = exe.run(main, feed=feed, fetch_list=["fc_0.w_0@GRAD"],
                    scope=scope)
    v2 = 0.9 * v1 + torch.from_numpy(grad)
    torch.testing.assert_close(scope.find_var("fc_0.w_0_velocity_0"), v2)
    torch.testing.assert_close(scope.find_var("fc_0.w_0"), p1 - 0.05 * v2)
    assert not torch.equal(scope.find_var("batch_norm_0.w_1"), mean1)


def test_a_profiled_run_is_split_by_the_executors_spans():
    """While a profiler records, the executor names each op, window and
    generic grad's forward re-run; with none recording it opens no range.
    batch_norm_grad is explicit (no re-run of batch_norm); the stem conv
    (Ci=3, outside the kernels' gate) keeps the generic grad; the 17
    momentum updates run as one bucket."""
    main, startup, loss = _build(pt, True)
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    assert registry.span("op:mul") is registry._NO_SPAN
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        exe.run(main, feed=_feeds()[0], fetch_list=[loss], scope=scope)
    names = {e.name for e in prof.events()}
    assert {"win:conv2d+batch_norm+relu", "win:conv2d+batch_norm",
            "op:conv2d_grad", "op:batch_norm_grad", "rerun:conv2d",
            "win:momentum*17", "op:fused_momentum"} <= names
    assert "rerun:batch_norm" not in names and "op:momentum" not in names
    assert sum(e.name == "op:fused_momentum" for e in prof.events()) == 1


# --- optimizer ops against the JAX lowerings ----------------------------------

def _opt_inputs(kind, grad_dtype, seed=0):
    rng = np.random.default_rng(seed)
    arr = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    ins = {"Param": arr(6, 5), "Grad": arr(6, 5),
           "LearningRate": np.array([0.1], np.float32)}
    if kind == "momentum":
        ins["Velocity"] = arr(6, 5)
    if kind == "adam":
        ins.update(Moment1=arr(6, 5), Moment2=np.abs(arr(6, 5)),
                   Beta1Pow=np.array([0.9 ** 3], np.float32),
                   Beta2Pow=np.array([0.999 ** 3], np.float32))
    jins = {k: [jnp.asarray(v)] for k, v in ins.items()}
    tins = {k: [torch.from_numpy(v)] for k, v in ins.items()}
    if grad_dtype == "bfloat16":
        jins["Grad"] = [jins["Grad"][0].astype(jnp.bfloat16)]
        tins["Grad"] = [tins["Grad"][0].to(torch.bfloat16)]
    return jins, tins


@pytest.mark.parametrize("kind,attrs", [
    ("sgd", {}),
    ("momentum", {"mu": 0.9, "use_nesterov": False}),
    ("momentum", {"mu": 0.9, "use_nesterov": True}),
    ("adam", {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
], ids=["sgd", "momentum", "nesterov", "adam"])
@pytest.mark.parametrize("grad_dtype", ["float32", "bfloat16"])
def test_optimizer_op_matches_jax(kind, attrs, grad_dtype):
    """f32 params, f32 or bf16 grads (AMP O2 master weights): the grad is
    upcast to the param's dtype first, so both are exact f32 arithmetic on
    the same values, to rtol 1e-6."""
    jins, tins = _opt_inputs(kind, grad_dtype)
    op = SimpleNamespace(attr=lambda k, d=None: attrs.get(k, d),
                         input=lambda slot: [slot.lower()])
    want = jax_registry.get(kind).lower(None, op, jins)
    got = registry.get(kind).lower(None, op, tins)
    assert sorted(got) == sorted(want)
    for slot in want:
        g = got[slot][0]
        assert g.dtype == torch.float32, slot
        np.testing.assert_allclose(g.numpy(), np.asarray(want[slot][0]),
                                   rtol=1e-6, atol=1e-7, err_msg=slot)
