"""The port's conv2d (paddle_tpu_torch/ops/conv_cuda.py, kernel K1) held
against the JAX package's Pallas conv2d on the CPU.

On the CPU the port's wrapper computes its plain version; the JAX kernel
runs under the Pallas interpreter. Both sum bf16 products in float32 and
differ only in the order of the sums, so f32 outputs agree to rtol/atol
1e-4 and bf16 outputs to one bf16 ulp. The CUDA kernel itself is checked
against the same plain version on the card by chip_smoke.py.
"""

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
