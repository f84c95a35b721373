"""AMP O3 training in the port (paddle_tpu_torch), int8 and fp8, held
against the JAX package on the CPU, and the new `matmul` and
`depthwise_conv2d` lowerings against the JAX lowerings and jax.vjp.

The models are the reference's own O3 smoke models (tests/test_quant.py
`_train_fc`, `_train_conv`): an fc classifier (64 -> 64 relu -> 10
softmax, SGD 0.1, batch 16) and a 128-channel 3x3 conv (+ bias, relu) on
[2, 128, 8, 8], average-pooled into fc(4) (SGD 0.05), so that the conv
passes the reference's 128-lane quant gate: the port's K11 plain version
and the Pallas `conv2d_q8` in interpret mode both run. Both packages build
the same script under `unique_name.guard()`, the JAX startup's weights are
carried into the port's scope (`interop.load_numpy_params`), and the
batches come from numpy seeds.

Tolerances:
  * the first step's first quantized op: bitwise the reference's function
    on the same operands (both quantize the same bf16 values with the same
    f32 arithmetic and sum exactly), and within FIRST_OP_RL2 of its jitted
    step (see the test's note);
  * loss trajectories: rtol 1e-2, the bound of the port's O2 training
    parity test (tests/test_torch_training.py); O3 against O2 in the port
    within the reference's own bound (rtol 0.05, atol 0.02 / 0.03);
  * fp8: the first op within one bf16 ulp of the reference's function (the
    e4m3 products summed in f32 in each library's order), the losses
    within FP8_LOSS_RTOL (see its note);
  * matmul and depthwise_conv2d in f32: rtol 1e-5 (f32 sums in another
    order); under O3 the quantized 2-D matmul bitwise, its bf16 grads
    within one bf16 ulp.
"""

import torch_threads  # noqa: F401  (the cores shared among xdist workers)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import executor as jax_executor
from paddle_tpu import quant as jquant
from paddle_tpu import telemetry
import paddle_tpu_torch as pt
from paddle_tpu_torch import quant
from paddle_tpu_torch.ops import conv_cuda, registry

BF16_ULP = 2.0 ** -7          # relative spacing of bf16 values
LOSS_RTOL = 1e-2
FIRST_OP_RL2 = 1e-2
# fp8: e4m3 keeps 3 mantissa bits, so where the jitted reference's scale
# lies one ulp off the port's, a value on an e4m3 rounding boundary moves a
# whole 6 % step: measured on the CPU, the first fc's output 0.9 % apart
# (relative L2) and the losses after three steps 2.0 % apart
FP8_FIRST_OP_RL2 = 3e-2
FP8_LOSS_RTOL = 3e-2


@pytest.fixture(autouse=True)
def _keep_jax_op_census():
    """The JAX executor's op census (executor._RECORDED_OPS) gets back the
    op types these runs added, as in tests/test_torch_training.py."""
    before = set(jax_executor._RECORDED_OPS)
    yield
    jax_executor._RECORDED_OPS.intersection_update(before)


@pytest.fixture(autouse=True)
def _fresh_counters():
    quant.COUNTERS.reset()
    conv_cuda.COUNTERS.reset()
    registry.RERUNS.clear()
    yield
    quant.COUNTERS.reset()
    conv_cuda.COUNTERS.reset()


def _fc_model(fluid, level, width=64, hid=64):
    x = fluid.layers.data(name="x", shape=[width], dtype="float32")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    h = fluid.layers.fc(input=x, size=hid, act="relu")
    logits = fluid.layers.fc(input=h, size=10, act="softmax")
    avg = fluid.layers.mean(fluid.layers.cross_entropy(input=logits,
                                                       label=label))
    fluid.amp.decorate(fluid.optimizer.SGD(learning_rate=0.1),
                       level=level).minimize(avg)
    return avg


def _fc_feeds(steps, width=64, seed=3):
    rng = np.random.default_rng(seed)
    return [{"x": rng.standard_normal((16, width)).astype(np.float32),
             "label": rng.integers(0, 10, (16, 1)).astype(np.int64)}
            for _ in range(steps)]


def _conv_model(fluid, level):
    img = fluid.layers.data(name="img", shape=[128, 8, 8], dtype="float32")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    c = fluid.layers.conv2d(input=img, num_filters=128, filter_size=3,
                            padding=1, act="relu")
    p = fluid.layers.pool2d(c, pool_size=8, pool_type="avg")
    logits = fluid.layers.fc(input=p, size=4, act="softmax")
    avg = fluid.layers.mean(fluid.layers.cross_entropy(input=logits,
                                                       label=label))
    fluid.amp.decorate(fluid.optimizer.SGD(learning_rate=0.05),
                       level=level).minimize(avg)
    return avg


def _conv_feeds(steps, seed=5):
    rng = np.random.default_rng(seed)
    return [{"img": rng.standard_normal((2, 128, 8, 8)).astype(np.float32),
             "label": rng.integers(0, 4, (2, 1)).astype(np.int64)}
            for _ in range(steps)]


MODELS = {"fc": (_fc_model, _fc_feeds), "conv": (_conv_model, _conv_feeds)}


def _build(fluid, model, level, **kw):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        loss = MODELS[model][0](fluid, level, **kw)
    return main, startup, loss


def _fetch_names(main):
    """The first two `mul`/`conv2d` outputs (the first quantized op and one
    after it) and the loss's name is added by the caller."""
    return [o.output_arg_names[0] for o in main.global_block().ops
            if o.type in ("mul", "conv2d")][:2]


def _jax_run(model, level, steps, **kw):
    """Startup weights, per-step fetches (the loss last) and the quant
    series of the first step, of the JAX package."""
    main, startup, loss = _build(jfluid, model, level, **kw)
    scope = jax_executor.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(startup, scope=scope)
    init = {n: np.array(scope.find_var(n)).astype(np.float32)
            for n, v in startup.global_block().desc.vars.items()
            if v.persistable}
    names = _fetch_names(main) + [loss.name]
    outs, series = [], None
    feeds = MODELS[model][1](steps, **({"width": kw["width"]}
                                       if "width" in kw else {}))
    for i, f in enumerate(feeds):
        if i == 0:
            telemetry.reset()
        outs.append([np.asarray(v, np.float32) for v in
                     exe.run(main, feed=f, fetch_list=names, scope=scope)])
        if i == 0:
            series = (telemetry.read_series("quant_kernel_total"),
                      telemetry.read_series("quant_fallback_total"))
    return init, outs, series


def _port_run(model, level, init, steps, **kw):
    main, _, loss = _build(pt, model, level, **kw)
    scope = pt.Scope()
    pt.interop.load_numpy_params(scope, init, "cpu")
    exe = pt.Executor(pt.CPUPlace())
    names = _fetch_names(main) + [loss.name]
    outs, counts = [], None
    feeds = MODELS[model][1](steps, **({"width": kw["width"]}
                                       if "width" in kw else {}))
    for i, f in enumerate(feeds):
        quant.COUNTERS.reset()
        outs.append([np.asarray(v, np.float32) for v in
                     exe.run(main, feed=f, fetch_list=names, scope=scope)])
        if i == 0:
            counts = ({f"op={k}": v for k, v in quant.COUNTERS.hits.items()},
                      {f"op={o},reason={r}": v for (o, r), v in
                       quant.COUNTERS.fallbacks.items()})
    return outs, counts


def _rl2(a, b):
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) or 1.0))


def _losses(outs):
    return [float(np.ravel(o[-1])[0]) for o in outs]


def _within_ulp(got, want, ulps=1):
    """|got - want| <= ulps bf16 ulps at the larger of the two magnitudes
    (the spacing of bf16 values in that binade)."""
    m = np.maximum(np.maximum(np.abs(got), np.abs(want)), 1e-30)
    ulp = 2.0 ** (np.floor(np.log2(m)) - 7)
    return bool(np.all(np.abs(got - want) <= ulps * ulp))


_JAX = {}


def _jax_cached(model, level, steps=5):
    key = (model, level, steps)
    if key not in _JAX:
        _JAX[key] = _jax_run(model, level, steps)
    return _JAX[key]


def _per_trace(series, counts):
    """The JAX package's counts (one per trace of the step) divided by the
    number of times its first step traced, which must be a whole number
    that fits every key."""
    hits, fallbacks = series
    got_hits, got_fallbacks = counts
    first = next(iter(got_hits or got_fallbacks))
    k = (hits or fallbacks).get(first, 0) / (got_hits or got_fallbacks)[first]
    assert k >= 1 and k == int(k), (series, counts)
    return ({n: v / k for n, v in hits.items()},
            {n: v / k for n, v in fallbacks.items()})


def _first_op_eager(model, init, level_mode="int8"):
    """The reference's quantized function run eagerly on the first step's
    first quantized op: its bf16 input and weight, as both packages cast
    them."""
    main, _, _ = _build(pt, model, "O3")
    op = next(o for o in main.global_block().ops if o.type in ("mul",
                                                               "conv2d"))
    f = MODELS[model][1](1)[0]
    if op.type == "mul":
        x = jnp.asarray(f["x"], jnp.bfloat16)
        w = jnp.asarray(init[op.input("Y")[0]], jnp.bfloat16)
        return np.asarray(jquant.qmatmul(x, w, level_mode), np.float32)
    x = jnp.asarray(f["img"].transpose(0, 2, 3, 1), jnp.bfloat16)
    w = jnp.asarray(init[op.input("Filter")[0]], jnp.bfloat16)
    y = jquant.qconv2d(x, w, (1, 1), (1, 1), (1, 1))
    return np.asarray(y, np.float32).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("model", ["fc", "conv"])
def test_o3_training_matches_jax(model):
    init, want, series = _jax_cached(model, "O3")
    got, counts = _port_run(model, "O3", init, len(want))
    # the first step's first quantized op: bitwise the reference's
    # function on the same bf16 operands; within FIRST_OP_RL2 of its
    # jitted step, where XLA divides by 127 as a multiply by f32(1/127),
    # which moves a few int8 weights by one step (measured: 17 of 147,456
    # filter values, a relative L2 of the conv output of 2e-3)
    np.testing.assert_array_equal(got[0][0], _first_op_eager(model, init))
    assert _rl2(got[0][0], want[0][0]) < FIRST_OP_RL2
    np.testing.assert_allclose(_losses(got), _losses(want), rtol=LOSS_RTOL)
    # the same routing, counted the same, on one step
    hits, fallbacks = _per_trace(series, counts)
    assert counts == (hits, fallbacks)
    assert hits.get("op=mul", 0) > 0
    if model == "conv":
        assert hits.get("op=conv2d") == 1
    # straight-through grads: no grad re-ran a quantized forward
    assert not {k for k in registry.RERUNS if k in quant.QUANT_OPS}


@pytest.mark.parametrize("model,atol", [("fc", 0.02), ("conv", 0.03)])
def test_o3_tracks_o2(model, atol):
    init, _, _ = _jax_cached(model, "O3")
    o2, _ = _port_run(model, "O2", init, 5)
    o3, _ = _port_run(model, "O3", init, 5)
    np.testing.assert_allclose(_losses(o3), _losses(o2), rtol=0.05,
                               atol=atol)
    assert all(np.isfinite(_losses(o3)))


def test_two_o3_runs_are_bitwise_equal():
    init, _, _ = _jax_cached("conv", "O3")
    a, _ = _port_run("conv", "O3", init, 3)
    b, _ = _port_run("conv", "O3", init, 3)
    for x, y in zip(a, b):
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)


def _bn_model(fluid, level):
    """A conv -> batch_norm -> relu window of 128 channels, pooled into an
    fc: under O2 the window's kernels (K4 + K5), under O3 the ladder (K11,
    then K6)."""
    img = fluid.layers.data(name="img", shape=[128, 8, 8], dtype="float32")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    c = fluid.layers.conv2d(input=img, num_filters=128, filter_size=3,
                            padding=1, bias_attr=False)
    c = fluid.layers.batch_norm(c, act="relu")
    p = fluid.layers.pool2d(c, pool_size=8, pool_type="avg")
    logits = fluid.layers.fc(input=p, size=4, act="softmax")
    avg = fluid.layers.mean(fluid.layers.cross_entropy(input=logits,
                                                       label=label))
    fluid.amp.decorate(fluid.optimizer.SGD(learning_rate=0.05),
                       level=level).minimize(avg)
    return avg


MODELS["bn"] = (_bn_model, _conv_feeds)


@pytest.mark.parametrize("model", ["fc", "conv", "bn"])
def test_quant_off_makes_o3_bitwise_o2(model, monkeypatch):
    _, startup, _ = _build(pt, model, "O2")
    scope = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(startup, scope=scope)
    init = {n: v.numpy() for n, v in scope.vars.items()
            if isinstance(v, torch.Tensor)}
    monkeypatch.setattr(quant, "QUANT", False)
    o2, _ = _port_run(model, "O2", init, 3)
    o3, (hits, fallbacks) = _port_run(model, "O3", init, 3)
    for x, y in zip(o2, o3):
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)
    assert not hits and fallbacks and \
        all(k.endswith("reason=disabled") for k in fallbacks)


def test_fallback_counts_match_the_reference():
    """A K=24 fc fails the shape gate in both packages, counted alike."""
    init, want, series = _jax_run("fc", "O3", 1, width=24)
    got, counts = _port_run("fc", "O3", init, 1, width=24)
    assert counts == _per_trace(series, counts)
    assert counts[1].get("op=mul,reason=shape") == 1
    np.testing.assert_allclose(_losses(got), _losses(want), rtol=LOSS_RTOL)


@pytest.mark.parametrize("model", ["fc", "conv"])
def test_fp8_training_matches_jax(model, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_QUANT_MODE", "fp8")
    init, want, series = _jax_run(model, "O3", 3)
    got, counts = _port_run(model, "O3", init, 3)
    hits, fallbacks = _per_trace(series, counts)
    assert counts == (hits, fallbacks)
    assert hits.get("op=mul", 0) > 0
    if model == "conv":
        assert fallbacks == {"op=conv2d,reason=mode": 1}
    # the first quantized op within one bf16 ulp of the reference's
    # function run eagerly (the same e4m3 bytes, f32 sums in each library's
    # order, one bf16 rounding), and near its jitted step (its scale
    # amax * f32(1/448), note of test_o3_training_matches_jax)
    if model == "fc":
        assert _within_ulp(got[0][0], _first_op_eager(model, init, "fp8"))
    assert _rl2(got[0][0], want[0][0]) < FP8_FIRST_OP_RL2
    np.testing.assert_allclose(_losses(got), _losses(want),
                               rtol=FP8_LOSS_RTOL)
    o2, _ = _port_run(model, "O2", init, 3)
    np.testing.assert_allclose(_losses(got), _losses(o2), rtol=0.05,
                               atol=0.03)


# --- matmul and depthwise_conv2d ---------------------------------------------

MATMUL_CASES = [
    # x shape, y shape, transpose_x, transpose_y, alpha
    ((6, 64), (64, 40), False, False, 1.0),
    ((64, 6), (64, 40), True, False, 1.0),
    ((6, 64), (40, 64), False, True, 0.5),
    ((64, 6), (40, 64), True, True, 2.0),
    ((3, 6, 32), (32, 8), False, False, 1.0),     # batch against 2-D
    ((2, 1, 6, 32), (3, 32, 8), False, False, 1.0),   # batch broadcast
    ((32,), (32, 8), False, False, 1.0),            # 1-D x
    ((3, 6, 32), (32,), False, False, 1.5),         # 1-D y
]


def _matmul_run(fluid, xs, ys, tx, ty, alpha, level, x, y, g):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        xv = fluid.layers.data(name="x", shape=list(xs), dtype="float32",
                               append_batch_size=False, stop_gradient=False)
        yv = fluid.layers.data(name="y", shape=list(ys), dtype="float32",
                               append_batch_size=False, stop_gradient=False)
        out = fluid.layers.matmul(xv, yv, transpose_x=tx, transpose_y=ty)
        if alpha != 1.0:
            main.global_block().ops[-1].desc.attrs["alpha"] = alpha
        gv = fluid.layers.data(name="g", shape=list(g.shape),
                               dtype="float32", append_batch_size=False)
        loss = fluid.layers.reduce_sum(fluid.layers.elementwise_mul(out, gv))
        fluid.backward.append_backward(loss)
    if level:
        fluid.amp.enable(main, level=level)
    scope = pt.Scope() if fluid is pt else jax_executor.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    return [np.asarray(v, np.float32) for v in exe.run(
        main, feed={"x": x, "y": y, "g": g},
        fetch_list=[out.name, "x@GRAD", "y@GRAD"], scope=scope)]


@pytest.mark.parametrize("case", MATMUL_CASES, ids=str)
def test_matmul_and_grad_match_jax(case):
    xs, ys, tx, ty, alpha = case
    rng = np.random.default_rng(len(xs) * 10 + len(ys))
    x = rng.standard_normal(xs).astype(np.float32)
    y = rng.standard_normal(ys).astype(np.float32)
    out_shape = torch.matmul(
        torch.from_numpy(x).transpose(-1, -2) if tx else torch.from_numpy(x),
        torch.from_numpy(y).transpose(-1, -2) if ty else
        torch.from_numpy(y)).shape
    g = rng.standard_normal(tuple(out_shape)).astype(np.float32)
    want = _matmul_run(jfluid, xs, ys, tx, ty, alpha, None, x, y, g)
    got = _matmul_run(pt, xs, ys, tx, ty, alpha, None, x, y, g)
    for a, b, what in zip(got, want, ("out", "dx", "dy")):
        assert a.shape == b.shape, what
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=what)
    assert "matmul" not in registry.RERUNS


@pytest.mark.parametrize("case", [MATMUL_CASES[0], MATMUL_CASES[2],
                                  MATMUL_CASES[4]], ids=str)
def test_matmul_o3_matches_jax(case):
    """Under O3 a 2-D product quantizes (a transposed Y per call), a
    batched one falls back with "rank", in both packages."""
    xs, ys, tx, ty, alpha = case
    rng = np.random.default_rng(17)
    x = rng.standard_normal(xs).astype(np.float32)
    y = rng.standard_normal(ys).astype(np.float32)
    m = xs[-1] if tx else xs[-2]
    n = ys[-2] if ty else ys[-1]
    g = rng.standard_normal(xs[:-2] + (m, n)).astype(np.float32)
    telemetry.reset()
    want = _matmul_run(jfluid, xs, ys, tx, ty, alpha, "O3", x, y, g)
    series = (telemetry.read_series("quant_kernel_total"),
              telemetry.read_series("quant_fallback_total"))
    got = _matmul_run(pt, xs, ys, tx, ty, alpha, "O3", x, y, g)
    counts = ({f"op={k}": v for k, v in quant.COUNTERS.hits.items()},
              {f"op={o},reason={r}": v for (o, r), v in
               quant.COUNTERS.fallbacks.items()})
    assert counts == _per_trace(series, counts)
    assert counts[0 if len(xs) == 2 else 1]
    if len(xs) == 2:
        # bitwise the reference's function on the same bf16 operands (its
        # jitted step rounds the scales its own way: FIRST_OP_RL2)
        xb = jnp.asarray(x.T if tx else x, jnp.bfloat16)
        yb = jnp.asarray(y.T if ty else y, jnp.bfloat16)
        eager = jquant.qmatmul(xb, yb, "int8")
        if alpha != 1.0:
            eager = eager * alpha
        np.testing.assert_array_equal(got[0], np.asarray(eager, np.float32))
        assert _rl2(got[0], want[0]) < FIRST_OP_RL2
    else:
        assert _within_ulp(got[0], want[0])
    # the bf16 grads: f32 sums (and the batch reduction) in each library's
    # order, rounded to bf16
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a, b, rtol=2 * BF16_ULP,
                                   atol=2 * BF16_ULP * np.abs(b).max())
    assert "matmul" not in registry.RERUNS


def _depthwise_run(fluid, level, x, w, g):
    from importlib import import_module
    helper_mod = import_module(fluid.__name__ + ".layer_helper")
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        xv = fluid.layers.data(name="x", shape=list(x.shape), dtype="float32",
                               append_batch_size=False, stop_gradient=False)
        helper = helper_mod.LayerHelper("depthwise_conv2d")
        wv = helper.create_parameter(attr=helper.param_attr,
                                     shape=list(w.shape), dtype="float32")
        out = helper.create_tmp_variable("float32")
        helper.append_op(type="depthwise_conv2d",
                         inputs={"Input": [xv], "Filter": [wv]},
                         outputs={"Output": [out]},
                         attrs={"strides": [2, 2], "paddings": [1, 1],
                                "dilations": [1, 1], "groups": x.shape[1]})
        gv = fluid.layers.data(name="g", shape=list(g.shape),
                               dtype="float32", append_batch_size=False)
        loss = fluid.layers.reduce_sum(fluid.layers.elementwise_mul(out, gv))
        fluid.backward.append_backward(loss)
    if level:
        fluid.amp.enable(main, level=level)
    scope = pt.Scope() if fluid is pt else jax_executor.Scope()
    scope.set_var(wv.name, torch.from_numpy(w) if fluid is pt else w)
    exe = fluid.Executor(fluid.CPUPlace())
    return [np.asarray(v, np.float32) for v in exe.run(
        main, feed={"x": x, "g": g},
        fetch_list=[out.name, "x@GRAD", wv.name + "@GRAD"], scope=scope)]


@pytest.mark.parametrize("level", [None, "O3"])
def test_depthwise_conv2d_and_grad_match_jax(level):
    rng = np.random.default_rng(23)
    x = rng.standard_normal((2, 16, 9, 9)).astype(np.float32)
    w = (rng.standard_normal((16, 1, 3, 3)) * 0.3).astype(np.float32)
    g = rng.standard_normal((2, 16, 5, 5)).astype(np.float32)
    telemetry.reset()
    want = _depthwise_run(jfluid, level, x, w, g)
    series = ({}, telemetry.read_series("quant_fallback_total"))
    got = _depthwise_run(pt, level, x, w, g)
    if level is None:
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    else:
        # bf16 operands, f32 sums in another order, one bf16 rounding each
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=2 * BF16_ULP,
                                       atol=2 * BF16_ULP * np.abs(b).max())
        counts = ({}, {f"op={o},reason={r}": v for (o, r), v in
                       quant.COUNTERS.fallbacks.items()})
        assert counts == _per_trace(series, counts) == \
            ({}, {"op=depthwise_conv2d,reason=kernel": 1})
    assert conv_cuda.COUNTERS.fallbacks == {
        ("depthwise_conv2d", "groups"): 1,
        ("depthwise_conv2d_grad", "groups"): 1}


def test_quant_ops_and_switches_match_the_reference(monkeypatch):
    assert quant.QUANT_OPS == jquant.QUANT_OPS
    for t in ("matmul", "matmul_grad", "depthwise_conv2d",
              "depthwise_conv2d_grad"):
        assert registry.try_get(t) is not None and \
            registry.get(t).lower is not registry.generic_grad_lower, t
    assert (quant.QUANT, quant.QUANT_TOL) == (jquant.QUANT, jquant.QUANT_TOL)
    main = pt.Program()
    monkeypatch.setenv("PADDLE_TPU_QUANT_MODE", "fp8")
    pt.amp.enable(main, level="O3")
    assert main._quant_mode == "fp8"
    token = quant.cache_token(main)
    monkeypatch.setattr(quant, "QUANT_TOL", 0.01)
    assert quant.cache_token(main) != token
    monkeypatch.setattr(quant, "QUANT", False)
    assert quant.cache_token(main)[1:] == (False, 0.01)


def test_the_environment_switches_are_read_at_import():
    import os
    import subprocess
    import sys
    from pathlib import Path
    repo = str(Path(__file__).resolve().parent.parent)
    env = dict(os.environ, PADDLE_TPU_QUANT="0", PADDLE_TPU_QUANT_TOL="0.5",
               PYTHONPATH=os.pathsep.join(
                   [repo] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    out = subprocess.run(
        [sys.executable, "-c", "import paddle_tpu_torch.quant as q; "
         "print(q.QUANT, q.QUANT_TOL)"], env=env, capture_output=True,
        text=True, timeout=120)
    assert out.stdout.split() == ["False", "0.5"], out.stderr
