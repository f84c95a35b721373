"""K11, the port's int8 conv kernel, and the quantized ops around it, on the
card: against the plain versions, bitwise.

K11 sums int8 products exactly in int32 and dequantizes with one f32
multiply rounded once, as its plain version does, so outputs agree bitwise:
at the JAX tests' CASES, at every distinct conv shape that ResNet-50's O3
route sends to K11 (batches 1 and 4), and at shapes that reach the tile
edges (output pixels and channels past a 128 tile, Ci not a multiple of
the 64-channel slice). The quantizers and the int8 GEMM of `mul` give on
the card what they give on the CPU.

The kernel has no CPU mode, so every test here needs a CUDA device and
skips without one. This file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_quant_gpu.py
"""

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
