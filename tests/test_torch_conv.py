"""The port's conv2d (paddle_tpu_torch/ops/conv_cuda.py, kernel K1) held
against the JAX package's Pallas conv2d on the CPU.

On the CPU the port's wrapper computes its plain version; the JAX kernel
runs under the Pallas interpreter. Both sum bf16 products in float32 and
differ only in the order of the sums, so f32 outputs agree to rtol/atol
1e-4 and bf16 outputs to one bf16 ulp. The CUDA kernel itself is checked
against the same plain version on the card by chip_smoke.py.
"""

import torch_threads  # noqa: F401  (the cores shared among xdist workers)
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops import pallas_conv
import paddle_tpu_torch as pt
from paddle_tpu_torch.models import resnet as port_resnet
from paddle_tpu_torch.ops import conv_cuda

# tests/test_pallas_conv.py CASES: (H, W, KH, KW, strides, paddings,
# dilations), channels fixed at one 128-lane tile
CASES = [
    (6, 6, 3, 3, (1, 1), (1, 1), (1, 1)),
    (9, 9, 3, 3, (2, 2), (1, 1), (1, 1)),
    (8, 8, 1, 1, (1, 1), (0, 0), (1, 1)),
    (10, 10, 3, 3, (1, 1), (2, 2), (2, 2)),
    (7, 9, 2, 3, (2, 1), (1, 2), (1, 1)),
]


def _operands(h, w, kh, kw, n=2, c=128, seed=0):
    """The operands of tests/test_pallas_conv.py, as numpy float32 arrays
    holding bf16-representable values."""
    rng = np.random.default_rng(seed)
    x = np.array(jnp.asarray(rng.standard_normal((n, h, w, c)), jnp.bfloat16)
                 .astype(jnp.float32))
    wt = np.array(jnp.asarray(rng.standard_normal((c, c, kh, kw)) * 0.1,
                              jnp.bfloat16).astype(jnp.float32))
    return x, wt


def _both(x, wt):
    jx, jw = jnp.asarray(x, jnp.bfloat16), jnp.asarray(wt, jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    tw = torch.from_numpy(wt).to(torch.bfloat16)
    return jx, jw, tx, tw


@pytest.fixture(autouse=True)
def _fresh_counters():
    conv_cuda.COUNTERS.reset()
    yield
    conv_cuda.COUNTERS.reset()


@pytest.mark.parametrize("case", CASES)
def test_reference_matches_pallas_f32(case):
    h, w, kh, kw, s, p, d = case
    jx, jw, tx, tw = _both(*_operands(h, w, kh, kw))
    want = np.asarray(pallas_conv.conv2d(jx, jw, s, p, d,
                                         out_dtype=jnp.float32))
    got = conv_cuda.conv2d(tx, tw, s, p, d, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", CASES)
def test_reference_matches_pallas_bf16_within_one_ulp(case):
    h, w, kh, kw, s, p, d = case
    jx, jw, tx, tw = _both(*_operands(h, w, kh, kw, seed=1))
    want = np.asarray(pallas_conv.conv2d(jx, jw, s, p, d).astype(jnp.float32))
    got = conv_cuda.conv2d(tx, tw, s, p, d)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    # one bf16 ulp at each value: 2^(exponent - 7)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= ulp + 1e-30)


def test_wrapper_on_cpu_launches_nothing():
    jx, jw, tx, tw = _both(*_operands(6, 6, 3, 3))
    conv_cuda.conv2d(tx, tw, (1, 1), (1, 1), (1, 1))
    assert conv_cuda.COUNTERS.launches == 0


def _jax_shape(shape, dtype):
    return jax.ShapeDtypeStruct(shape, dtype)


def _resnet50_conv_shapes(batch=16):
    """(x NHWC shape, w OIHW shape, strides, paddings, dilations, groups)
    of every conv2d in the port's ResNet-50 build at 224x224."""
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        img = pt.layers.data(name="img", shape=[3, 224, 224], dtype="float32")
        port_resnet.resnet50(img, class_dim=1000, is_test=True)
    block = main.global_block()
    out = []
    for op in block.ops:
        if op.type != "conv2d":
            continue
        n, c, h, w = block.desc.var(op.input("Input")[0]).shape
        wshape = tuple(block.desc.var(op.input("Filter")[0]).shape)
        out.append(((batch, h, w, c), wshape, tuple(op.attr("strides")),
                    tuple(op.attr("paddings")), tuple(op.attr("dilations")),
                    op.attr("groups")))
    return out


def test_gate_admits_every_shape_the_jax_gate_admits():
    shapes = [((2, h, w, 128), (128, 128, kh, kw), s, p, d, 1)
              for h, w, kh, kw, s, p, d in CASES]
    resnet = _resnet50_conv_shapes()
    assert len(resnet) == 53
    shapes += resnet
    jax_admits = port_admits = 0
    for xs, ws, s, p, d, g in shapes:
        jreason = pallas_conv.ineligible(
            _jax_shape(xs, jnp.bfloat16), _jax_shape(ws, jnp.bfloat16),
            s, p, d, g)
        treason = conv_cuda.ineligible(
            torch.empty(xs, dtype=torch.bfloat16, device="meta"),
            torch.empty(ws, dtype=torch.bfloat16, device="meta"), s, p, d, g)
        if jreason is None:
            jax_admits += 1
            assert treason is None, (xs, ws, s, p, d)
        port_admits += treason is None
    # ResNet-50: 42 convs pass the JAX gate; the port's Hopper envelope
    # also takes the ten 64-channel convs of stage 1, not the Ci=3 stem
    assert jax_admits == 5 + 42
    assert port_admits == 5 + 52


@pytest.mark.parametrize("change,reason", [
    (dict(dtype=torch.float32), "dtype"),
    (dict(groups=2), "groups"),
    (dict(ci=3), "channels"),
    (dict(co=12), "channels"),
    (dict(paddings=(1, 1, 1, 1)), "attrs"),
    (dict(paddings=(3, 3)), "geometry"),
    (dict(h=1, paddings=(0, 0)), "geometry"),
])
def test_gate_reasons(change, reason):
    a = dict(dtype=torch.bfloat16, groups=1, ci=16, co=16, h=8,
             paddings=(1, 1))
    a.update(change)
    x = torch.empty((2, a["h"], 8, a["ci"]), dtype=a["dtype"], device="meta")
    w = torch.empty((a["co"], a["ci"], 3, 3), dtype=a["dtype"], device="meta")
    got = conv_cuda.ineligible(x, w, (1, 1), a["paddings"], (1, 1), a["groups"])
    assert got == reason
    assert got in conv_cuda.FALLBACK_REASONS


def test_gate_rank():
    x = torch.empty((2, 8, 8, 16), dtype=torch.bfloat16, device="meta")
    w = torch.empty((16, 16, 3, 3), dtype=torch.bfloat16, device="meta")
    assert conv_cuda.ineligible(x[0], w, (1, 1), (1, 1), (1, 1)) == "rank"
    assert conv_cuda.ineligible(x, w[0], (1, 1), (1, 1), (1, 1)) == "rank"
    assert conv_cuda.ineligible(x, w, (1, 1), (1, 1), (1, 1)) is None


def test_bound_counts():
    x = torch.empty((16, 56, 56, 64), dtype=torch.bfloat16, device="meta")
    w = torch.empty((64, 64, 3, 3), dtype=torch.bfloat16, device="meta")
    s = p = d = (1, 1)
    assert conv_cuda.conv_flops(x, w, s, p, d) == 2 * 16 * 56 * 56 * 64 * 9 * 64
    assert conv_cuda.conv_bytes(x, w, s, p, d) == \
        2 * (16 * 56 * 56 * 64 + 64 * 64 * 9 + 16 * 56 * 56 * 64)


@pytest.mark.parametrize("dtype,k,s,p,read_hw", [
    (torch.int8, 1, 2, 0, 28 * 28),        # one pixel in four
    (torch.bfloat16, 1, 2, 0, 28 * 28),
    (torch.bfloat16, 3, 2, 1, 56 * 56),    # the 3x3 window covers the gaps
    (torch.bfloat16, 1, 3, 0, 19 * 19),
    (torch.bfloat16, 3, 1, 0, 56 * 56),
])
def test_bound_counts_only_the_pixels_read(dtype, k, s, p, read_hw):
    x = torch.empty((16, 56, 56, 256), dtype=dtype, device="meta")
    w = torch.empty((512, 256, k, k), dtype=dtype, device="meta")
    size = x.element_size()
    oh = (56 + 2 * p - k) // s + 1
    assert conv_cuda.input_bytes(x, w, (s, s), (p, p), (1, 1)) == \
        16 * read_hw * 256 * size
    assert conv_cuda.conv_bytes(x, w, (s, s), (p, p), (1, 1)) == \
        16 * read_hw * 256 * size + w.numel() * size + 16 * oh * oh * 512 * 2


# every distinct ResNet-50 conv that reaches K1 (H, W, Ci, Co, K, stride,
# padding), and the edge shapes of the card tests
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
PLAN_SHAPES = [(n, h, w, ci, co, k, k, (s, s), (p, p))
               for n in (1, 4, 16, 32) for h, w, ci, co, k, s, p in RESNET50] \
    + [(2, 9, 9, 8, 24, 3, 3, (2, 2), (1, 1)),
       (3, 7, 9, 16, 40, 2, 3, (2, 1), (1, 2)),
       (1, 5, 5, 264, 8, 1, 1, (1, 1), (0, 0)),
       (2, 6, 6, 24, 8, 3, 3, (1, 1), (1, 1))]


def _ohw(shape):
    n, h, w, ci, co, kh, kw, s, p = shape
    return (h + 2 * p[0] - kh) // s[0] + 1, (w + 2 * p[1] - kw) // s[1] + 1


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_conv_plan_covers_the_output_and_the_reduction(shape):
    """K1's plan: the tiles cover every output pixel (a FLAT tile is 128
    consecutive pixels, a box 2**7 of them within TMA's 256-element box
    limit), the splits cover the 64-deep reduction steps with none empty,
    and the ring can hold a step while the next one lands."""
    n, h, w, ci, co, kh, kw, s, p = shape
    oh, ow = _ohw(shape)
    plan = conv_cuda.conv_plan((n, h, w, ci), co, kh, kw, oh, ow, s, p)
    assert plan.lbn + plan.lbh + plan.lbw == 7
    if plan.flat:
        assert (kh, kw, s, p, (oh, ow)) == (1, 1, (1, 1), (0, 0), (h, w))
        assert plan.tiles * 128 >= n * oh * ow > (plan.tiles - 1) * 128
    else:
        assert (1 << plan.lbw) * s[1] <= 256 and (1 << plan.lbh) * s[0] <= 256
        assert plan.tiles == (-(-n >> plan.lbn)) * (-(-oh >> plan.lbh)) \
            * (-(-ow >> plan.lbw))
    assert plan.steps == kh * kw * -(-ci // 64)
    assert (plan.splits - 1) * plan.per < plan.steps <= plan.splits * plan.per
    assert plan.block_n == 64 or co > 64
    assert 1 <= plan.stages <= 4 and plan.stages <= plan.per
    assert plan.per == 1 or plan.stages >= 2
    m = n * oh * ow
    assert plan.stat_rows(m) == (-(-m // 128) if plan.splits > 1
                                 else plan.tiles)


def test_conv_plan_splits_only_small_grids():
    """Split-K where the grid leaves SMs idle: ResNet-50's stage-4 3x3 conv
    at batch 16 and the late stages of the small buckets; never where the
    tiles fill a quarter of the card."""
    def plan(n, h, ci, co, k, s=1, p=0):
        oh = (h + 2 * p - k) // s + 1
        return conv_cuda.conv_plan((n, h, h, ci), co, k, k, oh, oh, (s, s),
                                   (p, p))
    assert plan(16, 7, 512, 512, 3, p=1).splits == 4
    assert plan(1, 7, 512, 512, 3, p=1).splits > 1
    assert plan(4, 14, 256, 256, 3, p=1).splits > 1
    assert plan(16, 56, 64, 256, 1).splits == 1
    assert plan(32, 14, 256, 256, 3, p=1).splits == 1
    for shape in PLAN_SHAPES:
        n, h, w, ci, co, kh, kw, s, p = shape
        oh, ow = _ohw(shape)
        pl = conv_cuda.conv_plan((n, h, w, ci), co, kh, kw, oh, ow, s, p)
        if pl.tiles * -(-co // pl.block_n) > 132 // 4:
            assert pl.splits == 1
        # 64 output channels a tile where there are only 64
        if co <= 64:
            assert pl.block_n == 64


Q8_PLAN_SHAPES = [sh for sh in PLAN_SHAPES if sh[3] % 16 == 0 and
                  sh[4] % 16 == 0]


@pytest.mark.parametrize("shape", Q8_PLAN_SHAPES, ids=str)
def test_q8_plan_steps_by_element_size(shape):
    """K11's plan (conv_plan with elem=1): K1's pixel tiles, a reduction
    step of one tap and 128 int8 channels (one 128-byte row, as K1's 64
    bf16), every split non-empty, a ring that can hold a step while the
    next lands, and one plan object per shape (cached)."""
    n, h, w, ci, co, kh, kw, s, p = shape
    oh, ow = _ohw(shape)
    args = ((n, h, w, ci), co, kh, kw, oh, ow, s, p)
    bf16 = conv_cuda.conv_plan(*args)
    q8 = conv_cuda.conv_plan(*args, elem=1)
    assert bf16.steps == kh * kw * -(-ci // 64)
    assert q8.steps == kh * kw * -(-ci // 128)
    assert (q8.flat, q8.lbn, q8.lbh, q8.lbw, q8.tiles) == \
        (bf16.flat, bf16.lbn, bf16.lbh, bf16.lbw, bf16.tiles)
    assert (q8.splits - 1) * q8.per < q8.steps <= q8.splits * q8.per
    assert q8.block_n in (64, 128) and (q8.block_n == 64 or co > 64)
    assert 1 <= q8.stages <= 4 and q8.stages <= q8.per
    assert q8.per == 1 or q8.stages >= 2
    assert conv_cuda.conv_plan(*args, elem=1) is q8
    assert conv_cuda.conv_plan(*args, elem=1, sms=132) == q8


def _q8_split_sums(x, w, strides, paddings, plan):
    """K11's int32 sums as the kernel takes them under `plan`: each split z
    adds the steps z*per .. (one tap, 128 channels each, taps in (ky, kx)
    order) into its own int32 partial [N*OH*OW, Co]; returns the partials
    and their in-order int32 sum."""
    n, h, wd, ci = x.shape
    co, _, kh, kw = w.shape
    cols = torch.nn.functional.unfold(
        x.permute(0, 3, 1, 2).double(), (kh, kw), padding=tuple(paddings),
        stride=tuple(strides))                    # [N, Ci*KH*KW, L]
    cols = cols.reshape(n, ci, kh * kw, -1).permute(0, 3, 2, 1) \
        .reshape(-1, kh * kw, ci)                # [N*L, taps, Ci]
    wt = w.double().reshape(co, ci, kh * kw).permute(2, 1, 0)  # [taps, Ci, Co]
    chunks = -(-ci // 128)
    parts = []
    for z in range(plan.splits):
        part = torch.zeros((cols.shape[0], co), dtype=torch.float64)
        for step in range(z * plan.per, min(plan.steps, (z + 1) * plan.per)):
            tap, c0 = step // chunks, step % chunks * 128
            part += cols[:, tap, c0:c0 + 128] @ wt[tap, c0:c0 + 128]
        parts.append(part.to(torch.int32))        # exact: |sum| < 2**31
    total = torch.zeros_like(parts[0])
    for part in parts:                            # in order, as the kernel
        total += part
    return parts, total


@pytest.mark.parametrize("shape", [
    (1, 7, 7, 384, 128, 3, 3, (1, 1), (1, 1)),
    (2, 14, 14, 256, 256, 3, 3, (2, 2), (1, 1)),
    (1, 7, 7, 2048, 512, 1, 1, (1, 1), (0, 0)),
    (4, 9, 9, 176, 48, 3, 3, (1, 1), (1, 1)),
], ids=str)
def test_q8_split_k_is_the_plain_sum(shape):
    """K11's split-K: the plan splits these reductions, every split covers
    its steps once, and the int32 partials added in order are the unsplit
    int32 sum (integer sums are exact), so the dequantized output is
    bitwise conv2d_q8_reference's."""
    n, h, w, ci, co, kh, kw, s, p = shape
    oh, ow = _ohw(shape)
    plan = conv_cuda.conv_plan((n, h, w, ci), co, kh, kw, oh, ow, s, p,
                               elem=1)
    assert plan.splits > 1
    g = torch.Generator().manual_seed(sum(shape[:5]))
    x = torch.randint(-127, 128, (n, h, w, ci), generator=g, dtype=torch.int8)
    wt = torch.randint(-127, 128, (co, ci, kh, kw), generator=g,
                       dtype=torch.int8)
    dq = torch.rand(co, generator=g) * 1e-4 + 1e-6
    parts, total = _q8_split_sums(x, wt, s, p, plan)
    _, unsplit = _q8_split_sums(
        x, wt, s, p, dataclasses.replace(plan, splits=1, per=plan.steps))
    assert len(parts) == plan.splits
    assert all(part.abs().sum() > 0 for part in parts)
    assert torch.equal(total, unsplit)
    y = (total.float() * dq).reshape(n, oh, ow, co).to(torch.bfloat16)
    assert torch.equal(y, conv_cuda.conv2d_q8_reference(x, wt, s, p, (1, 1),
                                                        dq))


def test_ohwi_filter_is_read_in_place_else_copied_once():
    """The wrappers' filter: an OIHW view of OHWI memory is passed through
    without a copy; any other filter is copied once and counted."""
    w = torch.randn(16, 8, 3, 3).to(torch.bfloat16)
    view = w.contiguous(memory_format=torch.channels_last)
    got = conv_cuda._ohwi(view)
    assert got.data_ptr() == view.data_ptr() and got.is_contiguous()
    assert conv_cuda.COUNTERS.filter_copies == 0
    got = conv_cuda._ohwi(w)
    assert got.is_contiguous() and torch.equal(got, w.permute(0, 2, 3, 1))
    assert conv_cuda.COUNTERS.filter_copies == 1


def test_amp_casts_conv_filters_into_ohwi_memory():
    """Under AMP O2 the conv lowerings cast the f32 master filter straight
    into channels_last memory (one cast, as before, and no transpose after
    it); other operands keep their layout."""
    from paddle_tpu_torch.ops.common import CONV_FORMATS, mxu_cast

    class Ctx:
        amp_dtype, amp_level = "bfloat16", "O2"
    x = torch.randn(2, 8, 5, 5)
    w = torch.randn(16, 8, 3, 3)
    (xc, wc), restore = mxu_cast(Ctx, x, w, formats=CONV_FORMATS)
    assert restore is None and xc.dtype == wc.dtype == torch.bfloat16
    assert xc.is_contiguous() and wc.permute(0, 2, 3, 1).is_contiguous()
    assert torch.equal(wc, w.to(torch.bfloat16))
