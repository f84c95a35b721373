"""K1, the port's CUDA conv2d forward kernel, against its plain version on
the card: at shapes that reach the kernel's tile edges (output pixels and
channels that are not multiples of the tiles, Ci and Co of 8 and 24, below
one 64-channel reduction slice, strides, dilations, padding, an operand
that is not 16-byte aligned), at every ResNet-50 conv shape of the served
buckets (batches 1, 4 and 16), on shapes whose plan splits the reduction
(bitwise repeatable), and with the filter as the path passes it, an OIHW
view of OHWI memory, which the wrapper reads without a copy.

The kernel has no CPU mode, so every test here needs a CUDA device and
skips without one. This file imports no JAX (the GPU machine has none):
run it there without the suite's conftest,

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_conv_gpu.py

Tolerance: both sides sum the same bf16 products in float32, in another
order, so f32 outputs agree to rtol/atol 1e-4; the kernel's bf16 output is
its own f32 sum rounded once.
"""

import pytest
import torch

from paddle_tpu_torch.ops import conv_cuda

# (N, H, W, Ci, Co, KH, KW, strides, paddings, dilations)
SHAPES = [
    (2, 6, 6, 128, 128, 3, 3, (1, 1), (1, 1), (1, 1)),
    (2, 9, 9, 8, 24, 3, 3, (2, 2), (1, 1), (1, 1)),
    (3, 7, 9, 16, 40, 2, 3, (2, 1), (1, 2), (1, 1)),
    (2, 10, 10, 48, 136, 3, 3, (1, 1), (2, 2), (2, 2)),
    (1, 5, 5, 264, 8, 1, 1, (1, 1), (0, 0), (1, 1)),
    (4, 13, 11, 64, 200, 3, 3, (2, 2), (0, 1), (1, 1)),
    (2, 6, 6, 24, 8, 3, 3, (1, 1), (1, 1), (1, 1)),      # Ci 24, Co 8
    (2, 8, 8, 16, 64, 1, 1, (2, 2), (0, 0), (1, 1)),     # stride-2 1x1, Co 64
]

# every distinct ResNet-50 conv that reaches K1: (H, W, Ci, Co, K, stride,
# padding)
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
RESNET50_SHAPES = [(n, h, w, ci, co, k, k, (s, s), (p, p), (1, 1))
                   for n in (1, 4, 16)
                   for h, w, ci, co, k, s, p in RESNET50]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("K1 is a CUDA kernel with no CPU mode: needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _operands(shape, device, seed=0):
    n, h, w, ci, co, kh, kw, s, p, d = shape
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n, h, w, ci), generator=g).to(torch.bfloat16).to(device)
    wt = (torch.randn((co, ci, kh, kw), generator=g) * 0.1) \
        .to(torch.bfloat16).to(device)
    return x, wt, s, p, d


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES + RESNET50_SHAPES, ids=str)
def test_kernel_matches_plain_version(device, shape):
    x, wt, s, p, d = _operands(shape, device)
    assert conv_cuda.ineligible(x, wt, s, p, d) is None
    before = conv_cuda.COUNTERS.launches
    y32 = conv_cuda.conv2d(x, wt, s, p, d, out_dtype=torch.float32)
    y16 = conv_cuda.conv2d(x, wt, s, p, d)
    torch.cuda.synchronize()
    assert conv_cuda.COUNTERS.launches == before + 2
    r32 = conv_cuda.conv2d_reference(x, wt, s, p, d, out_dtype=torch.float32)
    assert y32.shape == r32.shape and y16.dtype == torch.bfloat16
    torch.testing.assert_close(y32, r32, rtol=1e-4, atol=1e-4)
    assert torch.equal(y16, y32.to(torch.bfloat16))


@pytest.mark.gpu
def test_unaligned_operand_is_realigned(device):
    x, wt, s, p, d = _operands(SHAPES[1], device, seed=1)
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=device)
    shifted = flat[1:].view(x.shape)            # 2-byte offset: not 16-aligned
    shifted.copy_(x)
    assert shifted.data_ptr() % 16 != 0
    got = conv_cuda.conv2d(shifted, wt, s, p, d, out_dtype=torch.float32)
    want = conv_cuda.conv2d_reference(x, wt, s, p, d, out_dtype=torch.float32)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_ineligible_cuda_operand_raises(device):
    x = torch.zeros((1, 8, 8, 3), dtype=torch.bfloat16, device=device)
    wt = torch.zeros((16, 3, 3, 3), dtype=torch.bfloat16, device=device)
    with pytest.raises(ValueError, match="channels"):
        conv_cuda.conv2d(x, wt, (1, 1), (1, 1), (1, 1))


def _plan(shape):
    n, h, w, ci, co, kh, kw, s, p, d = shape
    oh = (h + 2 * p[0] - ((kh - 1) * d[0] + 1)) // s[0] + 1
    ow = (w + 2 * p[1] - ((kw - 1) * d[1] + 1)) // s[1] + 1
    return conv_cuda.conv_plan((n, h, w, ci), co, kh, kw, oh, ow, s, p)


# shapes whose plan splits the reduction (stage 4 at batch 1 and 16) or
# not, and a 64-channel one
REPEATED = [RESNET50_SHAPES[16], RESNET50_SHAPES[-3], RESNET50_SHAPES[-1],
            RESNET50_SHAPES[2], SHAPES[0]]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", REPEATED, ids=str)
def test_repeated_call_is_bitwise_equal(device, shape):
    x, wt, s, p, d = _operands(shape, device, seed=2)
    ys = [conv_cuda.conv2d(x, wt, s, p, d) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(ys[0], y) for y in ys[1:])


@pytest.mark.gpu
def test_split_reduction_shapes_split(device):
    """The served path's small grids do split (so the tests above reach the
    split-K reduction), and a split result is the f32 sum rounded once."""
    split = [sh for sh in RESNET50_SHAPES if _plan(sh).splits > 1]
    assert RESNET50_SHAPES[-3] in split and len(split) >= 6
    x, wt, s, p, d = _operands(split[0], device, seed=3)
    y32 = conv_cuda.conv2d(x, wt, s, p, d, out_dtype=torch.float32)
    y16 = conv_cuda.conv2d(x, wt, s, p, d)
    torch.cuda.synchronize()
    assert torch.equal(y16, y32.to(torch.bfloat16))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [SHAPES[0], RESNET50_SHAPES[6]], ids=str)
def test_ohwi_view_is_read_in_place(device, shape):
    """An OIHW view of OHWI memory (the fold's and the training casts'
    layout) is read without a copy and gives the contiguous filter's bits;
    a contiguous OIHW filter is copied once and counted."""
    x, wt, s, p, d = _operands(shape, device, seed=4)
    view = wt.contiguous(memory_format=torch.channels_last)
    assert view.permute(0, 2, 3, 1).is_contiguous()
    before = conv_cuda.COUNTERS.filter_copies
    a = conv_cuda.conv2d(x, view, s, p, d)
    assert conv_cuda.COUNTERS.filter_copies == before
    b = conv_cuda.conv2d(x, wt, s, p, d)
    assert conv_cuda.COUNTERS.filter_copies == before + 1
    y, _, _ = conv_cuda.conv2d_stats(x, view, s, p, d)
    assert conv_cuda.COUNTERS.filter_copies == before + 1
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(a, y)
