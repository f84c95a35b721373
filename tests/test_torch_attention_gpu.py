"""K7-K9, the port's flash-attention kernels, against their plain versions
on the card: the JAX tests' shapes (tests/test_pallas_attention.py), causal
and not, T = 72 (a row tile past T) at D = 64 and 128, offsets and Tq != Tk
for the block form, bitwise repeatability, and the autograd Function's
gradient against autograd through the einsum path.

The kernels have no CPU mode, so every test here needs a CUDA device and
skips without one. This file imports no JAX (the GPU machine has none): run
it there without the suite's conftest,

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_attention_gpu.py

Tolerances. Each bf16 output within `chip_smoke.attention_tolerance` of
the plain version: one bf16 ulp, 1e-5 of the sum of its terms' magnitudes
(f32 sums in another order) and four flipped bf16 roundings of P or dS
(2^-8 of the largest term each). LSE within 1e-5 of max(1, |lse|).
"""

import math
import sys
from pathlib import Path

import pytest
import torch

from paddle_tpu_torch.ops import attention_cuda as A

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from chip_smoke import attention_tolerance  # noqa: E402

SHAPES = [(2, 64, 2, 32), (1, 128, 4, 64), (2, 256, 2, 64),
          (1, 72, 2, 64), (2, 72, 1, 128), (1, 256, 2, 128)]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("K7-K9 are CUDA kernels with no CPU mode: needs a CUDA "
                    "device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _rand(shape, device, seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * scale).to(torch.bfloat16) \
        .to(device)


def _operands(shape, device, seed=0):
    q, k, v, do = (_rand(shape, device, seed + i) for i in range(4))
    return q, k, v, do


def _assert_within(got, want, bound, what):
    err = (got.float() - want.float()).abs()
    assert (err <= bound).all(), \
        f"{what}: max err {err.max().item():.4g}, worst excess " \
        f"{(err - bound).max().item():.4g}"


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_forward_matches_plain_version(device, shape, causal):
    q, k, v, _ = _operands(shape, device)
    o, lse = A.flash_forward(q, k, v, causal)
    o2, lse2 = A.flash_forward(q, k, v, causal)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    ro, rlse = A.flash_forward_reference(q, k, v, causal)
    bound, = attention_tolerance("fwd", q, k, v, causal)
    _assert_within(o, ro, bound, "o")
    assert ((lse - rlse).abs() <= 1e-5 * rlse.abs().clamp_min(1.0)).all()


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_backward_matches_plain_version(device, shape, causal):
    q, k, v, do = _operands(shape, device)
    o, lse = A.flash_forward(q, k, v, causal)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    scale = 1.0 / math.sqrt(shape[-1])
    args = (q, k, v, do, lse, delta, 0, 0, scale, causal)
    dq, dk, dv = A.flash_attention_bwd_block(*args)
    again = A.flash_attention_bwd_block(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again))
    rq = A.flash_dq_reference(*args)
    rk, rv = A.flash_dkv_reference(*args)
    bq, = attention_tolerance("dq", q, k, v, causal, do, lse, delta)
    bk, bv = attention_tolerance("dkv", q, k, v, causal, do, lse, delta)
    _assert_within(dq, rq, bq, "dq")
    _assert_within(dk, rk, bk, "dk")
    _assert_within(dv, rv, bv, "dv")


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
def test_block_form_with_offsets(device, causal):
    """The block form K10's ring merge will call: Tq != Tk and global
    offsets, kernels against plain versions."""
    q, do = _rand((1, 64, 2, 64), device, 1), _rand((1, 64, 2, 64), device, 2)
    k, v = _rand((1, 136, 2, 64), device, 3), _rand((1, 136, 2, 64), device, 4)
    scale = 0.125
    o, lse = A.flash_forward_block(q, k, v, 100, 8, scale, causal)
    ro, rlse = A.flash_forward_reference(q, k, v, causal, 100, 8, scale)
    torch.cuda.synchronize()
    assert (o.float() - ro.float()).abs().max().item() <= 2e-2
    assert ((lse - rlse).abs() <= 1e-5 * rlse.abs().clamp_min(1.0)).all()
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta, 100, 8, scale, causal)
    got = A.flash_attention_bwd_block(*args)
    want = (A.flash_dq_reference(*args),) + A.flash_dkv_reference(*args)
    for a, b in zip(got, want):
        err = (a.float() - b.float()).abs().max().item()
        assert err <= 2e-2 * b.float().abs().max().item() + 1e-3, err


@pytest.mark.gpu
def test_autograd_function_against_the_einsum_path(device):
    """flash_attention's gradient (K7, then K8 + K9) against autograd
    through the einsum path in f32 on the same bf16 values: the two
    algorithms round P and dS in different places, so within 2 % of the
    largest gradient."""
    q, k, v, do = _operands((2, 128, 2, 64), device, 5)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    A.COUNTERS.reset()
    out = A.flash_attention(*leaves, causal=True)
    out.backward(do)
    assert (A.COUNTERS.launches, A.COUNTERS.dq_launches,
            A.COUNTERS.dkv_launches) == (1, 1, 1)
    ref = [t.float().requires_grad_(True) for t in (q, k, v)]
    A.attention_reference(*ref, causal=True).backward(do.float())
    for a, b in zip(leaves, ref):
        err = (a.grad.float() - b.grad).abs().max().item()
        assert err <= 2e-2 * b.grad.abs().max().item(), err


@pytest.mark.gpu
def test_ineligible_cuda_operands_raise(device):
    q = torch.zeros((1, 64, 2, 64), device=device)            # f32
    with pytest.raises(ValueError, match="dtype"):
        A.flash_forward(q, q, q, True)
    q = torch.zeros((1, 64, 2, 40), dtype=torch.bfloat16, device=device)
    with pytest.raises(ValueError, match="head_dim"):
        A.flash_forward(q, q, q, True)
    assert A.ineligible(q, q, q) == "head_dim"


@pytest.mark.gpu
def test_unaligned_operand_is_realigned(device):
    base = _rand((1 * 64 * 2 * 64 + 8,), device, 6)
    q = base[8:].view(1, 64, 2, 64)          # 16-byte aligned
    k = base[1:1 + q.numel()].view(1, 64, 2, 64)   # 2-byte offset
    o, _ = A.flash_forward(q, k, q, False)
    ro, _ = A.flash_forward_reference(q, k, q, False)
    bound, = attention_tolerance("fwd", q, k, q, False)
    _assert_within(o, ro, bound, "o")
