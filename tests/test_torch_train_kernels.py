"""The port's training kernels K2-K6 (ops/conv_cuda.py, ops/bn_cuda.py) held
against the JAX package's Pallas kernels on the CPU, and their gates.

On the CPU each port wrapper computes its plain version; each JAX kernel runs
under the Pallas interpreter, as tests/test_pallas_conv.py runs it, at that
file's CASES (channels 128, batch 2, stride 2 and dilation included).

Tolerances. f32 outputs: both sides sum the same bf16 products (or bf16
values) in f32, in another order, so they differ by f32 summation noise,
which grows with the sum of the terms' magnitudes, sum |a||b|, not with the
result: SUM_RTOL * sum |a||b| (a long reduction, as K3's over N*OH*OW, would
fail a plain rtol on its small outputs). bf16 outputs: within one bf16 ulp
(plus the f32 tolerance: a sum that differs in its last f32 bits may round
the other way). K4's y is bitwise the port's K1 plain output.
"""

import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops import fusion as jax_fusion
from paddle_tpu.ops import layout as jax_layout
from paddle_tpu.ops import pallas_conv
import paddle_tpu_torch as pt
from paddle_tpu_torch.ops import bn_cuda, conv_cuda

SUM_RTOL = 1e-5

# tests/test_pallas_conv.py CASES: (H, W, KH, KW, strides, paddings,
# dilations), channels fixed at one 128-lane tile
CASES = [
    (6, 6, 3, 3, (1, 1), (1, 1), (1, 1)),
    (9, 9, 3, 3, (2, 2), (1, 1), (1, 1)),
    (8, 8, 1, 1, (1, 1), (0, 0), (1, 1)),
    (10, 10, 3, 3, (1, 1), (2, 2), (2, 2)),
    (7, 9, 2, 3, (2, 1), (1, 2), (1, 1)),
]


def _bf16(a):
    """numpy float32 holding bf16-representable values."""
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _operands(h, w, kh, kw, s, p, d, n=2, c=128, seed=0):
    rng = np.random.default_rng(seed)
    x = _bf16(rng.standard_normal((n, h, w, c)))
    wt = _bf16(rng.standard_normal((c, c, kh, kw)) * 0.1)
    oh = (h + 2 * p[0] - ((kh - 1) * d[0] + 1)) // s[0] + 1
    ow = (w + 2 * p[1] - ((kw - 1) * d[1] + 1)) // s[1] + 1
    dout = _bf16(rng.standard_normal((n, oh, ow, c)))
    return x, wt, dout


def _t(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def _j(a):
    return jnp.asarray(a, jnp.bfloat16)


def _ulp(a):
    a = np.maximum(np.abs(np.asarray(a, np.float64)), 1e-30)
    return np.exp2(np.floor(np.log2(a)) - 7)


def _assert_sum_close(got, want, mags, slack=0.0):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert np.all(err <= SUM_RTOL * np.asarray(mags) + slack + 1e-6), \
        err.max()


def _assert_bf16_close(got, want, mags=0.0):
    """got and want are bf16 values: within one ulp of want plus the f32
    summation tolerance."""
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert np.all(err <= _ulp(want) + SUM_RTOL * np.asarray(mags) + 1e-6), \
        err.max()


@pytest.fixture(autouse=True)
def _fresh_counters():
    conv_cuda.COUNTERS.reset()
    bn_cuda.COUNTERS.reset()
    yield
    conv_cuda.COUNTERS.reset()
    bn_cuda.COUNTERS.reset()


# --- K2: grad input -----------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("out", ["f32", "bf16"])
def test_grad_input_matches_pallas(case, out):
    h, w, kh, kw, s, p, d = case
    x, wt, dout = _operands(*case, seed=1)
    jdt = jnp.float32 if out == "f32" else jnp.bfloat16
    tdt = torch.float32 if out == "f32" else torch.bfloat16
    want = np.asarray(pallas_conv.conv2d_grad_input(
        _j(dout), _j(wt), (h, w), s, p, d, out_dtype=jdt).astype(jnp.float32))
    got = conv_cuda.conv2d_grad_input(_t(dout), _t(wt), (h, w), s, p, d,
                                      out_dtype=tdt)
    assert got.dtype == tdt and tuple(got.shape) == x.shape
    mags = conv_cuda.conv2d_grad_input_reference(
        _t(np.abs(dout)), _t(np.abs(wt)), (h, w), s, p, d,
        out_dtype=torch.float32).numpy()
    if out == "f32":
        _assert_sum_close(got.numpy(), want, mags)
    else:
        _assert_bf16_close(got.float().numpy(), want, mags)


def test_grad_input_pads_hi_at_1x1_stride_2():
    """A 1x1/s2 conv on an even input: the dilated cotangent is one row and
    column short of H, so the transposed conv pads hi = lo + 1 — K2's
    explicit OH = H and zero-filled reads give it."""
    x, wt, dout = _operands(8, 8, 1, 1, (2, 2), (0, 0), (1, 1), seed=2)
    want = np.asarray(pallas_conv.conv2d_grad_input(
        _j(dout), _j(wt), (8, 8), (2, 2), (0, 0), (1, 1),
        out_dtype=jnp.float32))
    got = conv_cuda.conv2d_grad_input(_t(dout), _t(wt), (8, 8), (2, 2),
                                      (0, 0), (1, 1), out_dtype=torch.float32)
    assert tuple(got.shape) == (2, 8, 8, 128)
    assert not got[:, 1::2].any() and not got[:, :, 1::2].any()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# --- K3: grad filter ----------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("out", ["f32", "bf16"])
def test_grad_filter_matches_pallas(case, out):
    h, w, kh, kw, s, p, d = case
    x, wt, dout = _operands(*case, seed=3)
    jdt = jnp.float32 if out == "f32" else jnp.bfloat16
    tdt = torch.float32 if out == "f32" else torch.bfloat16
    want = np.asarray(pallas_conv.conv2d_grad_filter(
        _j(x), _j(dout), (kh, kw), s, p, d, out_dtype=jdt)
        .astype(jnp.float32))
    got = conv_cuda.conv2d_grad_filter(_t(x), _t(dout), (kh, kw), s, p, d,
                                       out_dtype=tdt)
    assert got.dtype == tdt and tuple(got.shape) == wt.shape
    mags = conv_cuda.conv2d_grad_filter_reference(
        _t(np.abs(x)), _t(np.abs(dout)), (kh, kw), s, p, d,
        out_dtype=torch.float32).numpy()
    if out == "f32":
        _assert_sum_close(got.numpy(), want, mags)
    else:
        _assert_bf16_close(got.float().numpy(), want, mags)


def test_wgrad_splits_cover_the_reduction():
    """K3's split of the N*OH*OW reduction (slices of 64 pixels): every
    split non-empty, the splits cover every slice, each split at least the
    measured least slices, and the blocks near the measured target for the
    tile shape (conv_cuda._WGRAD_BLOCKS)."""
    for xs, ws, s in [((32, 56, 56, 64), (256, 64, 1, 1), (1, 1)),
                      ((32, 7, 7, 512), (512, 512, 3, 3), (1, 1)),
                      ((2, 9, 9, 8), (24, 8, 3, 3), (2, 2)),
                      ((32, 56, 56, 256), (512, 256, 1, 1), (2, 2)),
                      ((32, 56, 56, 64), (64, 64, 3, 3), (1, 1))]:
        x = torch.empty(xs, device="meta")
        w = torch.empty(ws, device="meta")
        p = ((ws[2] - 1) // 2,) * 2
        splits, per = conv_cuda.wgrad_splits(x, w, s, p, (1, 1))
        oh = (xs[1] + 2 * p[0] - ws[2]) // s[0] + 1
        ow = (xs[2] + 2 * p[1] - ws[3]) // s[1] + 1
        plan = conv_cuda.wgrad_plan(xs, (xs[0], oh, ow, ws[0]), ws[2], ws[3],
                                    s, p)
        assert (plan.splits, plan.per) == (splits, per)
        steps = plan.steps
        assert steps >= -(-xs[0] * oh * ow // 64)
        assert (splits - 1) * per < steps <= splits * per
        target, least = conv_cuda._WGRAD_BLOCKS[(plan.nwg, plan.block_n)]
        assert splits == 1 or per >= least
        assert splits == 1 or plan.tiles * (splits - 1) < target
    # ResNet-50's 1x1 64->256 conv at batch 32: 2 output tiles of 128 x 64,
    # 1568 slices of 64 pixels: 32 splits of 49 slices, 64 blocks
    assert conv_cuda.wgrad_splits(torch.empty((32, 56, 56, 64), device="meta"),
                                  torch.empty((256, 64, 1, 1), device="meta"),
                                  (1, 1), (0, 0), (1, 1)) == (32, 49)


# --- K4: conv + statistics ------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_conv_stats_matches_pallas_and_k1(case):
    h, w, kh, kw, s, p, d = case
    x, wt, _ = _operands(*case, seed=4)
    jy, jsum, jsq = pallas_conv.conv2d_stats(_j(x), _j(wt), s, p, d)
    y, csum, csq = conv_cuda.conv2d_stats(_t(x), _t(wt), s, p, d)
    assert torch.equal(y, conv_cuda.conv2d(_t(x), _t(wt), s, p, d))
    assert y.dtype == torch.bfloat16 and csum.dtype == torch.float32
    jyf = np.asarray(jy.astype(jnp.float32)).reshape(-1, 128)
    yf = y.float().reshape(-1, 128).numpy()
    _assert_bf16_close(yf, jyf)
    # each package sums its own rounded y: the sums may differ by the ulps
    # where the two roundings of y differ, plus f32 noise
    _assert_sum_close(csum.numpy(), np.asarray(jsum), np.abs(yf).sum(0),
                      slack=np.abs(yf - jyf).sum(0))
    _assert_sum_close(csq.numpy(), np.asarray(jsq), (yf * yf).sum(0),
                      slack=np.abs(yf * yf - jyf * jyf).sum(0))


# --- K5: bn apply, K6: bn + act ---------------------------------------------------

def _bn_operands(m, c=128, seed=5):
    rng = np.random.default_rng(seed)
    x = _bf16(rng.standard_normal((m, c)) * 2 + 0.5)
    scale = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    mean = (0.1 * rng.standard_normal(c)).astype(np.float32)
    var = (1 + 0.2 * np.abs(rng.standard_normal(c))).astype(np.float32)
    return x, scale, bias, mean, var


_JAX_ACT = {None: None, "relu": jax.nn.relu}


@pytest.mark.parametrize("m", [16, 72, 512])
@pytest.mark.parametrize("act", [None, "relu"])
def test_bn_apply_matches_pallas(m, act):
    x, scale, bias, mean, var = _bn_operands(m)
    jbn, jact = pallas_conv.bn_apply(_j(x), *map(jnp.asarray, (scale, bias,
                                                               mean, var)),
                                     1e-5, _JAX_ACT[act])
    ybn, yact = bn_cuda.bn_apply(_t(x), *map(torch.from_numpy, (scale, bias,
                                                                mean, var)),
                                 1e-5, act)
    _assert_bf16_close(ybn.float().numpy(), np.asarray(jbn.astype(jnp.float32)))
    if act is None:
        assert yact is None and jact is None
    else:
        _assert_bf16_close(yact.float().numpy(),
                           np.asarray(jact.astype(jnp.float32)))
        assert torch.equal(yact, torch.relu(ybn))


@pytest.mark.parametrize("m", [16, 72, 512])
@pytest.mark.parametrize("act", [None, "relu"])
def test_bn_act_matches_pallas(m, act):
    x, scale, bias, _, _ = _bn_operands(m, seed=6)
    act_fn = None if act is None else functools.partial(
        jax_fusion._activations[act], a=None)
    jbn, jact, jmean, jvar = jax_fusion._pallas_bn_act(
        _j(x), jnp.asarray(scale), jnp.asarray(bias), 1e-5, act_fn)
    ybn, yact, mean, var = bn_cuda.bn_act(
        _t(x), torch.from_numpy(scale), torch.from_numpy(bias), 1e-5, act)
    _assert_sum_close(mean.numpy(), np.asarray(jmean), np.abs(x).mean(0))
    ex2 = (x * x).mean(0)
    _assert_sum_close(var.numpy(), np.asarray(jvar),
                      ex2 + 2 * np.abs(mean.numpy()) * np.abs(x).mean(0))
    _assert_bf16_close(ybn.float().numpy(), np.asarray(jbn.astype(jnp.float32)))
    if act is not None:
        _assert_bf16_close(yact.float().numpy(),
                           np.asarray(jact.astype(jnp.float32)))


# --- gates --------------------------------------------------------------------

def _jax_bn_gate(x_nhwc, dtype, is_test):
    """The JAX package's bn+act kernel gate (fusion.py:544) on a batch_norm
    whose input is an NHWC-tagged activation of that shape."""
    g = SimpleNamespace(bn=SimpleNamespace(
        attr=lambda k, dflt=None: is_test if k == "is_test" else dflt,
        desc=SimpleNamespace(input=lambda slot: ["x"])))
    ctx = SimpleNamespace(layouts={"x": jax_layout.NHWC})
    return jax_fusion._kernel_ineligible(
        ctx, g, {"x": jnp.zeros(x_nhwc, dtype)})


def test_bn_gate_admits_every_shape_the_jax_gate_admits():
    """bn_cuda.ineligible (K6) against fusion.py `_kernel_ineligible`, on
    ResNet-50's batch-norm inputs at batch 32 and odd shapes: every shape
    the JAX gate admits, the port admits; the port also admits C % 128 != 0
    (stage 1's C = 64, the stem) and M % 8 != 0."""
    shapes = [(32, 112, 112, 64), (32, 56, 56, 64), (32, 56, 56, 256),
              (32, 28, 28, 128), (32, 28, 28, 512), (32, 14, 14, 256),
              (32, 14, 14, 1024), (32, 7, 7, 512), (32, 7, 7, 2048),
              (1, 3, 3, 128), (2, 5, 7, 200), (3, 1, 1, 8)]
    admitted_by_port_only = 0
    for nhwc in shapes:
        for jdt, tdt in ((jnp.bfloat16, torch.bfloat16),
                         (jnp.float32, torch.float32)):
            for is_test in (False, True):
                jr = _jax_bn_gate(nhwc, jdt, is_test)
                x = torch.empty((nhwc[0], nhwc[3], nhwc[1], nhwc[2]),
                                dtype=tdt, device="meta")
                r = bn_cuda.ineligible(x, is_test, "relu")
                if jr is None:
                    assert r is None, (nhwc, jdt, is_test)
                elif r is None:
                    admitted_by_port_only += 1
                    assert jr == "kernel_shape"
                else:
                    assert r == jr, (nhwc, jdt, is_test, r, jr)
    assert admitted_by_port_only == 5


def test_conv_stats_gate_admits_every_shape_the_jax_gate_admits():
    """The K4 + K5 window's shape gate (K1's `conv_cuda.ineligible`)
    against the JAX package's (fusion.py:622-658: `pallas_conv.ineligible`
    and M % 8 == 0) on every ResNet-50 conv at batches 1, 2 and 32 and on
    the CASES: whatever the JAX gate admits, the port admits, and the port
    also admits the stage-1 convs (C = 64) the TPU tiling refused."""
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        img = pt.layers.data(name="img", shape=[3, 224, 224], dtype="float32")
        pt.models.resnet50(img)
    block = main.global_block()
    shapes = []
    for op in block.ops:
        if op.type == "conv2d":
            _, c, h, w = block.desc.var(op.input("Input")[0]).shape
            wshape = tuple(block.desc.var(op.input("Filter")[0]).shape)
            for n in (1, 2, 32):
                shapes.append(((n, h, w, c), wshape,
                               *(tuple(op.attr(a)) for a in
                                 ("strides", "paddings", "dilations"))))
    shapes += [((2, h, w, 128), (128, 128, kh, kw), s, p, d)
               for h, w, kh, kw, s, p, d in CASES]
    jax_admits = port_only = 0
    for xs, ws, s, p, d in shapes:
        jx = jax.ShapeDtypeStruct(xs, jnp.bfloat16)
        jw = jax.ShapeDtypeStruct(ws, jnp.bfloat16)
        oh = (xs[1] + 2 * p[0] - ((ws[2] - 1) * d[0] + 1)) // s[0] + 1
        ow = (xs[2] + 2 * p[1] - ((ws[3] - 1) * d[1] + 1)) // s[1] + 1
        m = xs[0] * oh * ow
        jax_ok = pallas_conv.ineligible(jx, jw, s, p, d) is None and \
            m >= 8 and m % 8 == 0
        port_ok = conv_cuda.ineligible(
            torch.empty(xs, dtype=torch.bfloat16, device="meta"),
            torch.empty(ws, dtype=torch.bfloat16, device="meta"),
            s, p, d) is None
        assert port_ok or not jax_ok, (xs, ws, s, p, d)
        jax_admits += jax_ok
        port_only += port_ok and not jax_ok
    assert jax_admits > 0 and port_only > 0


def test_fallback_reasons_are_pinned():
    assert bn_cuda.FALLBACK_REASONS == {
        "kernel_is_test", "kernel_layout", "kernel_dtype", "kernel_shape",
        "act"}
    x = torch.empty((2, 8, 4, 4), dtype=torch.bfloat16, device="meta")
    assert bn_cuda.ineligible(x, False, None) is None
    assert bn_cuda.ineligible(x, False, "relu") is None
    assert bn_cuda.ineligible(x, True, "relu") == "kernel_is_test"
    assert bn_cuda.ineligible(x[0], False, None) == "kernel_layout"
    assert bn_cuda.ineligible(x.float(), False, None) == "kernel_dtype"
    assert bn_cuda.ineligible(x[:0], False, None) == "kernel_shape"
    assert bn_cuda.ineligible(x, False, "tanh") == "act"


def _window(fluid, act, is_test=False, ci=128, amp=None):
    """conv(3x3, ci -> 128) -> batch_norm [-> act], a mean loss; returns the
    program and the loss name."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[ci, 6, 6], dtype="float32")
        c = fluid.layers.conv2d(img, 128, 3, padding=1, bias_attr=False)
        b = fluid.layers.batch_norm(c, act=act, is_test=is_test)
        loss = fluid.layers.mean(b)
    if amp:
        fluid.amp.enable(main, level=amp)
    return main, startup, loss


@pytest.mark.parametrize("amp,act,is_test,ci,conv_hits,conv_fb,bn_hits,bn_fb", [
    # O2, relu: the whole window through K4 + K5
    ("O2", "relu", False, 128, {"fused_conv_bn_act": 1}, {},
     {"fused_conv_bn_act": 1}, {}),
    # O2, no act: K4 + K5 with identity
    ("O2", None, False, 128, {"fused_conv_bn_act": 1}, {},
     {"fused_conv_bn_act": 1}, {}),
    # the conv fails the gate (Ci = 3): the ladder, conv to F.conv2d, bn
    # through K6
    ("O2", "relu", False, 3, {}, {("conv2d", "channels"): 1},
     {"fused_bn_act": 1}, {}),
    # O1 restores the conv output to f32: the ladder, K1 for the conv, the
    # plain bn
    ("O1", "relu", False, 128, {"conv2d": 1}, {}, {},
     {("fused_bn_act", "kernel_dtype"): 1}),
    # f32: no kernel at all
    (None, "relu", False, 128, {}, {("conv2d", "dtype"): 1}, {},
     {("fused_bn_act", "kernel_dtype"): 1}),
    # an activation the kernels do not implement
    ("O2", "tanh", False, 128, {"conv2d": 1}, {}, {},
     {("fused_bn_act", "act"): 1}),
    # is_test, fetched conv output (no fold): the plain lowerings
    ("O2", "relu", True, 128, {"conv2d": 1}, {}, {},
     {("fused_bn_act", "kernel_is_test"): 1}),
])
def test_window_routes(amp, act, is_test, ci, conv_hits, conv_fb, bn_hits,
                       bn_fb):
    main, startup, loss = _window(pt, act, is_test, ci, amp)
    conv_out = main.global_block().ops[0].output("Output")[0]
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    x = np.random.default_rng(0).standard_normal((2, ci, 6, 6)) \
        .astype(np.float32)
    conv_cuda.COUNTERS.reset()
    bn_cuda.COUNTERS.reset()
    fetch = [loss] + ([conv_out] if is_test else [])
    out = exe.run(main, feed={"img": x}, fetch_list=fetch, scope=scope)
    assert np.isfinite(out[0]).all()
    assert conv_cuda.COUNTERS.hits == conv_hits
    assert conv_cuda.COUNTERS.fallbacks == conv_fb
    assert bn_cuda.COUNTERS.hits == bn_hits
    assert bn_cuda.COUNTERS.fallbacks == bn_fb


def test_fused_window_matches_the_ladder():
    """The K4 + K5 window and the member ladder (K1, then the plain
    batch_norm lowering) give the same forward on the CPU: y bitwise, the
    normalized output within one bf16 ulp (one-pass statistics of the same
    rounded y, summed in another order), the statistics within f32 noise."""
    main, startup, loss = _window(pt, "relu", amp="O2")
    ops = main.global_block().ops
    names = [ops[0].output("Output")[0], ops[1].output("Y")[0],
             ops[1].output("SavedMean")[0], ops[1].output("SavedVariance")[0],
             ops[1].input("Mean")[0]]
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    x = np.random.default_rng(1).standard_normal((2, 128, 6, 6)) \
        .astype(np.float32)
    fused = exe.run(main, feed={"img": x}, fetch_list=names, scope=scope)
    ladder_scope = pt.Scope()
    exe.run(startup, scope=ladder_scope)
    from paddle_tpu_torch.ops import fusion
    ctx_main = main.clone()
    ladder = pt.Executor(pt.CPUPlace())
    ladder._plan = lambda program: None          # every op on its own
    plain = ladder.run(ctx_main, feed={"img": x}, fetch_list=names,
                       scope=ladder_scope)
    assert fusion.plan(main) is not None
    np.testing.assert_array_equal(fused[0], plain[0])
    _assert_bf16_close(fused[1], plain[1])
    for a, b in zip(fused[2:], plain[2:]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
