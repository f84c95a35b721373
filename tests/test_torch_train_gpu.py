"""K2-K6, the port's training kernels, against their plain versions on the
card, at shapes that reach the tiles' edges (pixels and channels that are
not multiples of the 128x128 conv tiles or the 64x64 batch-norm blocks,
strides, dilations, asymmetric padding) and at every ResNet-50 training
conv at batch 32, with bitwise repeatability (K4's y bitwise K1's, K3 in
f32 and bf16 out), and one AMP O2 training step of a small net on the card
against the CPU plain path.

The kernels have no CPU mode, so every test here needs a CUDA device and
skips without one. This file imports no JAX (the GPU machine has none): run
it there without the suite's conftest,

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_train_gpu.py

Tolerances. f32 outputs: both sides sum the same bf16 products in f32 in
another order, so they agree within SUM_RTOL of the sum of the terms'
magnitudes, sum |a||b| (a long reduction, as K3's, grows its error with that
sum, not with the result). bf16 outputs: within one bf16 ulp of the plain
version's plus that f32 tolerance (a rounding may flip). K4's y is K1's
bitwise.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch.models import resnet
from paddle_tpu_torch.ops import bn_cuda, conv_cuda

SUM_RTOL = 1e-5

# (N, H, W, Ci, Co, KH, KW, strides, paddings, dilations)
SHAPES = [
    (2, 6, 6, 128, 128, 3, 3, (1, 1), (1, 1), (1, 1)),
    (2, 9, 9, 8, 24, 3, 3, (2, 2), (1, 1), (1, 1)),
    (3, 7, 9, 16, 40, 2, 3, (2, 1), (1, 2), (1, 1)),
    (2, 10, 10, 48, 136, 3, 3, (1, 1), (2, 2), (2, 2)),
    (1, 5, 5, 264, 8, 1, 1, (1, 1), (0, 0), (1, 1)),
    (4, 13, 11, 64, 200, 3, 3, (2, 2), (0, 1), (1, 1)),
    (2, 8, 8, 16, 32, 1, 1, (2, 2), (0, 0), (1, 1)),    # 1x1/s2: hi = lo + 1
    (3, 30, 30, 64, 256, 1, 1, (1, 1), (0, 0), (1, 1)),  # long reduction
]

# every distinct ResNet-50 training conv at batch 32: (H, W, Ci, Co, K,
# stride, padding)
RESNET50 = [
    (56, 56, 64, 256, 1, 1, 0), (56, 56, 64, 64, 1, 1, 0),
    (56, 56, 64, 64, 3, 1, 1), (56, 56, 256, 64, 1, 1, 0),
    (56, 56, 256, 512, 1, 2, 0), (56, 56, 256, 128, 1, 2, 0),
    (28, 28, 128, 128, 3, 1, 1), (28, 28, 128, 512, 1, 1, 0),
    (28, 28, 512, 128, 1, 1, 0), (28, 28, 512, 1024, 1, 2, 0),
    (28, 28, 512, 256, 1, 2, 0), (14, 14, 256, 256, 3, 1, 1),
    (14, 14, 256, 1024, 1, 1, 0), (14, 14, 1024, 256, 1, 1, 0),
    (14, 14, 1024, 2048, 1, 2, 0), (14, 14, 1024, 512, 1, 2, 0),
    (7, 7, 512, 512, 3, 1, 1), (7, 7, 512, 2048, 1, 1, 0),
    (7, 7, 2048, 512, 1, 1, 0),
]
RESNET50_SHAPES = [(32, h, w, ci, co, k, k, (s, s), (p, p), (1, 1))
                   for h, w, ci, co, k, s, p in RESNET50]

# [M, C] of the batch-norm kernels
BN_SHAPES = [(1000, 200), (64, 64), (4099, 8), (32, 1024)]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("K2-K6 are CUDA/Triton kernels with no CPU mode: needs a "
                    "CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _operands(shape, device, seed=0):
    n, h, w, ci, co, kh, kw, s, p, d = shape
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n, h, w, ci), generator=g).to(torch.bfloat16).to(device)
    wt = (torch.randn((co, ci, kh, kw), generator=g) * 0.1) \
        .to(torch.bfloat16).to(device)
    oh = (h + 2 * p[0] - ((kh - 1) * d[0] + 1)) // s[0] + 1
    ow = (w + 2 * p[1] - ((kw - 1) * d[1] + 1)) // s[1] + 1
    dout = torch.randn((n, oh, ow, co), generator=g).to(torch.bfloat16) \
        .to(device)
    return x, wt, dout, s, p, d


def _ulp(t):
    a = t.float().abs().clamp_min(1e-30)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def _assert_sum_close(got, want, mags):
    err = (got.float() - want.float()).abs()
    bound = SUM_RTOL * mags.float() + 1e-6
    assert (err <= bound).all(), f"max err {err.max().item()}"


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES + RESNET50_SHAPES, ids=str)
def test_dgrad_matches_plain_version(device, shape):
    x, wt, dout, s, p, d = _operands(shape, device)
    hw = (x.shape[1], x.shape[2])
    before = conv_cuda.COUNTERS.dgrad_launches
    g32 = conv_cuda.conv2d_grad_input(dout, wt, hw, s, p, d,
                                      out_dtype=torch.float32)
    g16 = conv_cuda.conv2d_grad_input(dout, wt, hw, s, p, d)
    again = conv_cuda.conv2d_grad_input(dout, wt, hw, s, p, d)
    torch.cuda.synchronize()
    assert conv_cuda.COUNTERS.dgrad_launches == before + 3
    assert g32.shape == x.shape and g16.dtype == torch.bfloat16
    r32 = conv_cuda.conv2d_grad_input_reference(dout, wt, hw, s, p, d,
                                                out_dtype=torch.float32)
    mags = conv_cuda.conv2d_grad_input_reference(
        dout.abs(), wt.abs(), hw, s, p, d, out_dtype=torch.float32)
    _assert_sum_close(g32, r32, mags)
    assert torch.equal(g16, g32.to(torch.bfloat16))
    assert torch.equal(g16, again)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES + RESNET50_SHAPES, ids=str)
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16],
                         ids=str)
def test_wgrad_matches_plain_version(device, shape, out_dtype):
    x, wt, dout, s, p, d = _operands(shape, device, seed=1)
    khw = (wt.shape[2], wt.shape[3])
    before = conv_cuda.COUNTERS.wgrad_launches
    g = conv_cuda.conv2d_grad_filter(x, dout, khw, s, p, d,
                                     out_dtype=out_dtype)
    again = conv_cuda.conv2d_grad_filter(x, dout, khw, s, p, d,
                                         out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert conv_cuda.COUNTERS.wgrad_launches == before + 2
    assert g.shape == wt.shape and g.dtype == out_dtype
    assert torch.equal(g, again)
    r32 = conv_cuda.conv2d_grad_filter_reference(x, dout, khw, s, p, d,
                                                 out_dtype=torch.float32)
    mags = conv_cuda.conv2d_grad_filter_reference(
        x.abs(), dout.abs(), khw, s, p, d, out_dtype=torch.float32)
    if out_dtype == torch.float32:
        _assert_sum_close(g, r32, mags)
    else:
        err = (g.float() - r32.to(torch.bfloat16).float()).abs()
        assert (err <= _ulp(r32) + SUM_RTOL * mags + 1e-6).all()


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES + RESNET50_SHAPES, ids=str)
def test_conv_stats_is_k1_plus_sums(device, shape):
    x, wt, _, s, p, d = _operands(shape, device, seed=2)
    before = conv_cuda.COUNTERS.stats_launches
    y, csum, csq = conv_cuda.conv2d_stats(x, wt, s, p, d)
    y2, csum2, csq2 = conv_cuda.conv2d_stats(x, wt, s, p, d)
    k1 = conv_cuda.conv2d(x, wt, s, p, d)
    torch.cuda.synchronize()
    assert conv_cuda.COUNTERS.stats_launches == before + 2
    assert torch.equal(y, k1)
    assert torch.equal(y2, y) and torch.equal(csum2, csum) and \
        torch.equal(csq2, csq)
    yf = y.float().reshape(-1, y.shape[-1])
    _assert_sum_close(csum, yf.sum(0), yf.abs().sum(0))
    _assert_sum_close(csq, (yf * yf).sum(0), (yf * yf).sum(0))


def _bn_operands(m, c, device, seed=3):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn((m, c), generator=g) * 2 + 0.5).to(torch.bfloat16) \
        .to(device)
    scale = (1 + 0.1 * torch.randn(c, generator=g)).to(device)
    bias = (0.1 * torch.randn(c, generator=g)).to(device)
    mean = (0.1 * torch.randn(c, generator=g)).to(device)
    var = (1 + 0.2 * torch.randn(c, generator=g).abs()).to(device)
    return x, scale, bias, mean, var


@pytest.mark.gpu
@pytest.mark.parametrize("mc", BN_SHAPES, ids=str)
@pytest.mark.parametrize("act", [None, "relu"], ids=str)
def test_bn_apply_matches_plain_version(device, mc, act):
    x, scale, bias, mean, var = _bn_operands(*mc, device)
    before = bn_cuda.COUNTERS.apply_launches
    ybn, yact = bn_cuda.bn_apply(x, scale, bias, mean, var, 1e-5, act)
    ybn2, yact2 = bn_cuda.bn_apply(x, scale, bias, mean, var, 1e-5, act)
    torch.cuda.synchronize()
    assert bn_cuda.COUNTERS.apply_launches == before + 2
    rbn, ract = bn_cuda.bn_apply_reference(x, scale, bias, mean, var, 1e-5,
                                           act)
    assert ybn.dtype == torch.bfloat16 and torch.equal(ybn, ybn2)
    assert ((ybn.float() - rbn.float()).abs() <= _ulp(rbn)).all()
    if act is None:
        assert yact is None
    else:
        assert torch.equal(yact, torch.relu(ybn)) and torch.equal(yact, yact2)


@pytest.mark.gpu
@pytest.mark.parametrize("mc", BN_SHAPES, ids=str)
@pytest.mark.parametrize("act", [None, "relu"], ids=str)
def test_bn_act_matches_plain_version(device, mc, act):
    x, scale, bias, _, _ = _bn_operands(*mc, device, seed=4)
    before = bn_cuda.COUNTERS.act_launches
    out = bn_cuda.bn_act(x, scale, bias, 1e-5, act)
    out2 = bn_cuda.bn_act(x, scale, bias, 1e-5, act)
    torch.cuda.synchronize()
    assert bn_cuda.COUNTERS.act_launches == before + 2
    ybn, yact, mean, var = out
    for a, b in zip(out, out2):
        assert (a is None and b is None) or torch.equal(a, b)
    rbn, _, rmean, rvar = bn_cuda.bn_act_reference(x, scale, bias, 1e-5, act)
    xf = x.float()
    m = x.shape[0]
    _assert_sum_close(mean, rmean, xf.abs().sum(0) / m)
    ex2 = (xf * xf).sum(0) / m
    _assert_sum_close(var, rvar, ex2 + 2 * rmean.abs() * xf.abs().sum(0) / m)
    # the kernel normalizes with its own statistics: hold its bf16 output
    # to the plain normalize of those, within one ulp
    want, _ = bn_cuda.bn_apply_reference(x, scale, bias, mean, var, 1e-5)
    assert ((ybn.float() - want.float()).abs() <= _ulp(want)).all()
    if act == "relu":
        assert torch.equal(yact, torch.relu(ybn))


@pytest.mark.gpu
def test_ineligible_cuda_operands_raise(device):
    dout = torch.zeros((1, 8, 8, 16), dtype=torch.bfloat16, device=device)
    wt = torch.zeros((16, 3, 3, 3), dtype=torch.bfloat16, device=device)
    with pytest.raises(ValueError, match="channels"):
        conv_cuda.conv2d_grad_input(dout, wt, (8, 8), (1, 1), (1, 1), (1, 1))
    x = torch.zeros((8, 8), dtype=torch.float32, device=device)
    v = torch.zeros(8, device=device)
    with pytest.raises(ValueError, match="bf16"):
        bn_cuda.bn_act(x, v, v, 1e-5)
    with pytest.raises(ValueError, match="not 'tanh'"):
        bn_cuda.bn_act(x.bfloat16(), v, v, 1e-5, "tanh")


def _small_net():
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        img = pt.layers.data(name="img", shape=[3, 16, 16], dtype="float32")
        label = pt.layers.data(name="label", shape=[1], dtype="int64")
        x = resnet.conv_bn_layer(img, 128, 3, 1, 1)
        x = resnet.bottleneck(x, 128, 128, 2)
        x = pt.layers.pool2d(x, pool_size=8, pool_type="avg",
                             global_pooling=True)
        loss = pt.layers.mean(pt.layers.softmax_with_cross_entropy(
            pt.layers.fc(x, size=10), label))
        pt.amp.decorate(pt.optimizer.Momentum(0.05, 0.9),
                        level="O2").minimize(loss)
    main.random_seed = startup.random_seed = 7
    return main, startup, loss


@pytest.mark.gpu
def test_o2_training_step_on_the_card_matches_the_cpu(device):
    """One step of the small net on the card (every kernel) and on the CPU
    plain path from the same weights: the loss within 1e-2 and every grad
    (the first step's velocity) within a relative L2 difference of 0.1.
    Both are bf16 noise through about 15 rounding points: the first card
    run measured a max abs difference of 5.4 % of the largest grad of
    conv2d_4's filter, the worst parameter."""
    main, startup, loss = _small_net()
    gpu_scope = pt.Scope()
    pt.Executor().run(startup, scope=gpu_scope)
    cpu_scope = pt.Scope()
    for n, v in gpu_scope.vars.items():
        cpu_scope.set_var(n, v.cpu() if isinstance(v, torch.Tensor) else v)
    rng = np.random.default_rng(0)
    feed = {"img": rng.standard_normal((4, 3, 16, 16)).astype(np.float32),
            "label": rng.integers(0, 10, (4, 1)).astype(np.int64)}
    conv_cuda.COUNTERS.reset()
    bn_cuda.COUNTERS.reset()
    lg, = pt.Executor().run(main, feed=feed, fetch_list=[loss],
                            scope=gpu_scope)
    c = conv_cuda.COUNTERS
    assert (c.stats_launches, c.dgrad_launches, c.wgrad_launches) == (4, 4, 4)
    assert (bn_cuda.COUNTERS.apply_launches,
            bn_cuda.COUNTERS.act_launches) == (4, 1)
    lc, = pt.Executor(pt.CPUPlace()).run(main, feed=feed, fetch_list=[loss],
                                         scope=cpu_scope)
    assert np.isfinite(lg).all()
    np.testing.assert_allclose(lg, lc, rtol=1e-2)
    for n in gpu_scope.vars:
        if n.endswith("_velocity_0"):
            a = gpu_scope.find_var(n).float().cpu()
            b = cpu_scope.find_var(n).float()
            assert (a - b).norm() <= 0.1 * b.norm() + 1e-6, n
