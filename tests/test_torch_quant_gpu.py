"""K11, the port's int8 conv kernel, and the quantized ops around it, on the
card: against the plain versions, bitwise.

K11 sums int8 products exactly in int32 and dequantizes with one f32
multiply rounded once, as its plain version does, so outputs agree bitwise:
at the JAX tests' CASES, at every distinct conv shape that ResNet-50's O3
route sends to K11 (batches 1 and 4), and at shapes that reach the tile
edges (output pixels and channels past a 128 tile, Ci not a multiple of
the 64-channel slice). The quantizers and the int8 GEMM of `mul` give on
the card what they give on the CPU.

K11 is K1's kernel body on int8 operands (csrc/conv2d_fwd.cu): its split-K
adds int32 partials in order, so a split call is bitwise the unsplit one;
its boxes are K1's, so the ragged output edges at 14x14 and 7x7 and a Ci
that is not a multiple of the 128-channel step (TMA's zero fill) are held
here too.

The kernel has no CPU mode, so every test here needs a CUDA device and
skips without one. This file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_quant_gpu.py
"""

import torch_threads  # noqa: F401  (the cores shared among xdist workers)
import dataclasses
import sys
from pathlib import Path

import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import quant
from paddle_tpu_torch.models import resnet
from paddle_tpu_torch.ops import conv_cuda

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

# (N, H, W, Ci, Co, KH, KW, strides, paddings, dilations)
EDGES = [
    (3, 7, 9, 48, 144, 3, 3, (2, 1), (1, 1), (1, 1)),
    (2, 10, 10, 80, 16, 3, 3, (1, 1), (2, 2), (2, 2)),
    (1, 5, 5, 16, 272, 1, 1, (1, 1), (0, 0), (1, 1)),
]


def _resnet50_shapes():
    main = chip_smoke._resnet50(pt, resnet)[0]
    return sorted({k for b in (1, 4)
                   for k in chip_smoke._eligible_convs(conv_cuda, main, b,
                                                       quant)})


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("K11 is a CUDA kernel with no CPU mode: needs a CUDA "
                    "device")
    return torch.device("cuda", 0)


def _operands(xs, ws, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(-127, 128, xs, generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, ws, generator=g, dtype=torch.int8)
    dq = torch.rand(ws[0], generator=g) * 1e-4 + 1e-6
    return x.to(device), w.to(device), dq.to(device)


def _holds(x, w, s, p, d, dq):
    before = conv_cuda.COUNTERS.q8_launches
    y = conv_cuda.conv2d_q8(x, w, s, p, d, dq)
    y32 = conv_cuda.conv2d_q8(x, w, s, p, d, dq, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert conv_cuda.COUNTERS.q8_launches == before + 2
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, conv_cuda.conv2d_q8_reference(x, w, s, p, d, dq))
    assert torch.equal(y32, conv_cuda.conv2d_q8_reference(
        x, w, s, p, d, dq, out_dtype=torch.float32))


@pytest.mark.gpu
@pytest.mark.parametrize("case", chip_smoke.CASES, ids=str)
def test_k11_at_the_jax_cases(device, case):
    h, w, kh, kw, s, p, d = case
    x, wt, dq = _operands((2, h, w, 128), (128, 128, kh, kw), device)
    _holds(x, wt, s, p, d, dq)


@pytest.mark.gpu
def test_k11_at_every_quantized_resnet50_shape(device):
    shapes = _resnet50_shapes()
    assert len(shapes) >= 20
    for i, (xs, ws, s, p, d) in enumerate(shapes):
        x, wt, dq = _operands(xs, ws, device, seed=i)
        _holds(x, wt, s, p, d, dq)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", EDGES, ids=str)
def test_k11_at_tile_edges(device, shape):
    n, h, w, ci, co, kh, kw, s, p, d = shape
    x, wt, dq = _operands((n, h, w, ci), (co, ci, kh, kw), device)
    _holds(x, wt, s, p, d, dq)
    # an OIHW view of OHWI memory (the engine's layout) gives the same
    view = wt.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)
    assert torch.equal(conv_cuda.conv2d_q8(x, view, s, p, d, dq),
                       conv_cuda.conv2d_q8(x, wt, s, p, d, dq))


@pytest.mark.gpu
def test_k11_refuses_what_its_gate_refuses(device):
    x = torch.zeros((1, 8, 8, 8), dtype=torch.int8, device=device)
    w = torch.zeros((16, 8, 3, 3), dtype=torch.int8, device=device)
    dq = torch.ones(16, device=device)
    with pytest.raises(ValueError, match="channels"):
        conv_cuda.conv2d_q8(x, w, (1, 1), (1, 1), (1, 1), dq)
    with pytest.raises(ValueError, match="dtype"):
        conv_cuda.conv2d_q8(x.float(), w, (1, 1), (1, 1), (1, 1), dq)
    with pytest.raises(ValueError, match="CUDA"):
        conv_cuda.conv2d_q8(x, w.cpu(), (1, 1), (1, 1), (1, 1), dq)


@pytest.mark.gpu
def test_quantized_ops_on_the_card_equal_the_cpu(device):
    g = torch.Generator().manual_seed(3)
    x = torch.randn((4, 9, 9, 256), generator=g).to(torch.bfloat16)
    w = (torch.randn((128, 256, 3, 3), generator=g) * 0.05).to(torch.bfloat16)
    want = quant.qconv2d(x, w, (2, 2), (1, 1), (1, 1))
    before = conv_cuda.COUNTERS.q8_launches
    got = quant.qconv2d(x.to(device), w.to(device), (2, 2), (1, 1), (1, 1))
    assert conv_cuda.COUNTERS.q8_launches == before + 1
    assert torch.equal(got.cpu(), want)
    for m, n in ((1, 1000), (16, 1000), (37, 24), (3, 10)):
        a = torch.randn((m, 2048), generator=g).to(torch.bfloat16)
        b = torch.randn((2048, n), generator=g)
        q, s, _ = quant.weight_qparams(b, -1)
        pre = (torch.from_numpy(q), torch.from_numpy(s))
        want = quant.qmatmul(a, b, pre=pre)
        got = quant.qmatmul(a.to(device), b.to(device),
                            pre=tuple(t.to(device) for t in pre))
        assert torch.equal(got.cpu(), want), (m, n)
        aq, _ = quant.quantize_channelwise(a, 0)
        assert torch.equal(quant.int_matmul(aq.to(device), pre[0].to(device))
                           .cpu(), quant.int_matmul(aq, pre[0]))


# (N, H, W, Ci, Co, KH, KW, strides, paddings): output boxes with ragged
# edges at ResNet-50's 14x14 and 7x7 maps (the box covers more rows than
# the output holds) and channel counts past a tile; Ci not a multiple of
# the 128-channel step (the rest of the step zero-filled)
RAGGED = [
    (3, 14, 14, 256, 272, 3, 3, (1, 1), (1, 1)),
    (5, 7, 7, 512, 80, 3, 3, (1, 1), (1, 1)),
    (1, 14, 14, 1024, 208, 1, 1, (2, 2), (0, 0)),
    (3, 7, 7, 2048, 528, 1, 1, (1, 1), (0, 0)),
]
PARTIAL_CI = [
    (2, 14, 14, 48, 128, 3, 3, (1, 1), (1, 1)),
    (4, 7, 7, 176, 256, 3, 3, (1, 1), (1, 1)),
    (1, 14, 14, 80, 64, 1, 1, (1, 1), (0, 0)),
    (2, 9, 9, 400, 144, 3, 3, (2, 2), (1, 1)),
]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", RAGGED + PARTIAL_CI, ids=str)
def test_k11_ragged_edges_and_partial_steps(device, shape):
    n, h, w, ci, co, kh, kw, s, p = shape
    x, wt, dq = _operands((n, h, w, ci), (co, ci, kh, kw), device, seed=ci)
    _holds(x, wt, s, p, (1, 1), dq)


def _with_plan(monkeypatch, change):
    """Route K11's calls through conv_plan's plan with `change` applied."""
    planner = conv_cuda.conv_plan

    def plan(*args, **kwargs):
        return change(planner(*args, **kwargs))
    monkeypatch.setattr(conv_cuda, "conv_plan", plan)


def _split(plan, k):
    per = -(-plan.steps // k)
    return dataclasses.replace(plan, splits=-(-plan.steps // per), per=per,
                               stages=min(plan.stages, max(per, 2)))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [
    (16, 7, 7, 512, 512, 3, 3, (1, 1), (1, 1)),
    (1, 14, 14, 256, 256, 3, 3, (1, 1), (1, 1)),
    (4, 7, 7, 2048, 512, 1, 1, (1, 1), (0, 0)),
    (16, 28, 28, 128, 128, 3, 3, (1, 1), (1, 1)),
    (3, 7, 7, 176, 80, 3, 3, (1, 1), (1, 1)),
], ids=str)
def test_k11_split_and_unsplit_are_bitwise_the_plain_version(
        device, shape, monkeypatch):
    """The same call unsplit, under its own plan and split 2, 3 and as far
    as the steps go: every output bitwise conv2d_q8_reference's (bf16 and
    f32), so bitwise each other's."""
    n, h, w, ci, co, kh, kw, s, p = shape
    x, wt, dq = _operands((n, h, w, ci), (co, ci, kh, kw), device, seed=co)
    oh, ow = conv_cuda._out_hw(x, wt, s, p, (1, 1))
    plan = conv_cuda.conv_plan((n, h, w, ci), co, kh, kw, oh, ow, s, p,
                               elem=1)
    ref = conv_cuda.conv2d_q8_reference(x, wt, s, p, (1, 1), dq)
    splits = sorted({1, plan.splits, 2, 3, plan.steps})
    for k in splits:
        with monkeypatch.context() as m:
            _with_plan(m, lambda pl, k=k: _split(pl, k))
            _holds(x, wt, s, p, (1, 1), dq)
            y = conv_cuda.conv2d_q8(x, wt, s, p, (1, 1), dq)
        torch.cuda.synchronize()
        assert torch.equal(y, ref), k


@pytest.mark.gpu
def test_k11_copies_only_a_filter_not_in_ohwi_memory(device):
    """K11 reads an OIHW view of OHWI memory in place (the int8 engine's
    prequantized filters) and copies any other filter once, counted."""
    x, wt, dq = _operands((2, 7, 7, 128), (128, 128, 3, 3), device)
    view = wt.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)
    conv_cuda.COUNTERS.filter_copies = 0
    conv_cuda.conv2d_q8(x, view, (1, 1), (1, 1), (1, 1), dq)
    assert conv_cuda.COUNTERS.filter_copies == 0
    conv_cuda.conv2d_q8(x, wt, (1, 1), (1, 1), (1, 1), dq)
    assert conv_cuda.COUNTERS.filter_copies == 1
