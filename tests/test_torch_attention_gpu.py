"""K7-K10, the port's flash-attention kernels, against their plain versions
on the card: the JAX tests' shapes (tests/test_pallas_attention.py), causal
and not, T = 72 (a row tile past T) at D = 64 and 128, offsets and Tq != Tk
for the block form, K10 and K8/K9 at every (query shard, key shard) pair of
a four-shard ring (wholly masked pairs included), the four-shard ring merge
against K7 on the whole sequence, bitwise repeatability, and the autograd
Function's gradient against autograd through the einsum path.

The kernels have no CPU mode, so every test here needs a CUDA device and
skips without one. This file imports no JAX (the GPU machine has none): run
it there without the suite's conftest,

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_attention_gpu.py

Tolerances. Each bf16 output within `chip_smoke.attention_tolerance` of
the plain version: one bf16 ulp, 1e-5 of the sum of its terms' magnitudes
(f32 sums in another order) and four flipped bf16 roundings of P or dS
(2^-8 of the largest term each). LSE within 1e-5 of max(1, |lse|).
K10's (acc, l, m) within `chip_smoke.hold_block`: acc as above with an f32
ulp, m and m + log(l) by the LSE rule, the rows no key tile reaches
exactly (0, 0, -1e30). The ring merge against K7: P is rounded to bf16
against another running maximum on each side, so each term may differ by
2^-8 of itself: rel 2^-8 + 1e-5 of the sum of the terms' magnitudes.
"""

import math
import sys
from pathlib import Path

import pytest
import torch

from paddle_tpu_torch.ops import attention_cuda as A

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from chip_smoke import attention_tolerance, hold_block  # noqa: E402

SHAPES = [(2, 64, 2, 32), (1, 128, 4, 64), (2, 256, 2, 64),
          (1, 72, 2, 64), (2, 72, 1, 128), (1, 256, 2, 128)]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("K7-K10 are CUDA kernels with no CPU mode: needs a CUDA "
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


RING_SHARDS = [(1, 128, 2, 64), (1, 64, 2, 128)]


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shard", RING_SHARDS, ids=str)
def test_ring_block_pairs_match_plain_version(device, shard, causal):
    """K10, then K8 and K9, at the 16 (query shard, key shard) pairs of a
    four-shard ring: offsets past, on and before the diagonal; under the
    causal mask the 6 pairs wholly in the future give (0, 0, -1e30) and
    zero gradients."""
    b, t, h, d = shard
    full = (b, 4 * t, h, d)
    q, k, v, do = _operands(full, device, 7)
    scale = 1.0 / math.sqrt(d)
    o, lse = A.flash_forward(q, k, v, causal)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    masked = 0
    for i in range(4):
        qi, doi = q[:, i * t:(i + 1) * t], do[:, i * t:(i + 1) * t]
        for j in range(4):
            kj, vj = k[:, j * t:(j + 1) * t], v[:, j * t:(j + 1) * t]
            at = f"pair ({i}, {j})"
            got = A.flash_attention_block(qi, kj, vj, i * t, j * t, scale,
                                          causal)
            again = A.flash_attention_block(qi, kj, vj, i * t, j * t, scale,
                                            causal)
            torch.cuda.synchronize()
            assert all(torch.equal(x, y) for x, y in zip(got, again)), at
            want = A.flash_forward_block_reference(qi, kj, vj, i * t, j * t,
                                                   scale, causal)
            hold_block(got, want, qi, kj, vj, i * t, j * t, scale, causal, at)
            if causal and j > i:
                masked += 1
                assert (got[0] == 0).all() and (got[1] == 0).all()
                assert (got[2] == -1e30).all()
            args = (qi, kj, vj, doi, lse[..., i * t:(i + 1) * t].contiguous(),
                    delta[..., i * t:(i + 1) * t].contiguous(), i * t, j * t,
                    scale, causal)
            dq, dk, dv = A.flash_attention_bwd_block(*args)
            rq, rk, rv = A.flash_attention_bwd_block_reference(*args)
            bq, = attention_tolerance("dq", qi, kj, vj, causal, doi, args[4],
                                      args[5], q_off=i * t, k_off=j * t)
            bk, bv = attention_tolerance("dkv", qi, kj, vj, causal, doi,
                                         args[4], args[5], q_off=i * t,
                                         k_off=j * t)
            _assert_within(dq, rq, bq, f"dq {at}")
            _assert_within(dk, rk, bk, f"dk {at}")
            _assert_within(dv, rv, bv, f"dv {at}")
    assert masked == (6 if causal else 0)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
def test_block_mid_tile_offsets(device, causal):
    """K10 at Tq != Tk and offsets that cut a tile: rows of a visited tile
    whose every visited key is masked stay invalid (m = -1e30)."""
    q = _rand((1, 64, 2, 64), device, 11)
    k, v = (_rand((1, 136, 2, 64), device, seed) for seed in (12, 13))
    got = A.flash_attention_block(q, k, v, 100, 120, 0.125, causal)
    want = A.flash_forward_block_reference(q, k, v, 100, 120, 0.125, causal)
    torch.cuda.synchronize()
    hold_block(got, want, q, k, v, 100, 120, 0.125, causal, "mid-tile")
    if causal:
        assert (want[2][..., :20] == -1e30).all()   # rows 100..119


@pytest.mark.gpu
def test_block_gate_raises(device):
    q = torch.zeros((1, 64, 2, 64), device=device)            # f32
    with pytest.raises(ValueError, match="dtype"):
        A.flash_attention_block(q, q, q, 0, 0, 0.125, True)
    A.COUNTERS.reset()
    q = q.to(torch.bfloat16)
    A.flash_attention_block(q, q, q, 0, 0, 0.125, True)
    assert A.COUNTERS.block_launches == 1 and A.COUNTERS.launches == 0


@pytest.mark.gpu
def test_four_shard_ring_merge_matches_k7(device):
    """The ring's per-step function looped over four shards in one process
    (K10 each step, the f32 merge) against K7 on the whole sequence."""
    from chip_smoke import MERGE_REL
    from paddle_tpu_torch.parallel import ring_attention as R
    q, k, v, _ = _operands((1, 1024, 2, 64), device, 21)
    t, scale = 256, 0.125
    o, lse = A.flash_forward(q, k, v, True)
    A.COUNTERS.reset()
    outs, lses = [], []
    for i in range(4):
        qi = q[:, i * t:(i + 1) * t]
        state = R.ring_init(qi)
        for s in range(4):
            j = (i - s) % 4
            state = R.ring_step(state, qi, k[:, j * t:(j + 1) * t],
                                v[:, j * t:(j + 1) * t], i * t, j * t, scale,
                                True)
        o_i, lse_i = R.ring_finish(state, q.dtype)
        outs.append(o_i)
        lses.append(lse_i)
    torch.cuda.synchronize()
    assert A.COUNTERS.block_launches == 16 and A.COUNTERS.launches == 0
    bound, = attention_tolerance("fwd", q, k, v, True, rel=MERGE_REL)
    _assert_within(torch.cat(outs, 1), o, bound, "o")
    got_lse = torch.cat(lses, -1)
    assert ((got_lse - lse).abs() <= 1e-5 * lse.abs().clamp_min(1.0)).all()


@pytest.mark.gpu
def test_flash_ring_refuses_f32_on_the_card(device):
    """The flash ring on CUDA operands the Hopper gate refuses (f32, no AMP)
    raises before any block runs, forward and backward, where the plain
    versions would form the whole f32 scores per block; the einsum ring,
    asked for explicitly, still runs."""
    from paddle_tpu_torch.parallel import make_mesh
    from paddle_tpu_torch.parallel import ring_attention as R
    mesh = make_mesh((1,), ("sp",))
    q = torch.randn((1, 256, 2, 64), device=device)              # f32
    A.COUNTERS.reset()
    with pytest.raises(ValueError, match="bf16"):
        R.ring_attention_sharded(q, q, q, mesh, causal=True, use_flash=True)
    lse = torch.zeros((1, 2, 256), device=device)
    with pytest.raises(ValueError, match="bf16"):
        R.ring_attention_bwd_sharded(q, q, q, q, q, lse, mesh, causal=True)
    assert A.COUNTERS.block_launches == A.COUNTERS.dq_launches == 0
    assert not A.COUNTERS.fallbacks
    out = R.ring_attention_sharded(q, q, q, mesh, causal=True)
    assert out.shape == q.shape and torch.isfinite(out).all()
