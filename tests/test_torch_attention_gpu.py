"""K7-K10, the port's flash-attention kernels, against their plain versions
on the card, in bf16 (the Hopper kernels) and in f32 (their f32 forms): the
JAX tests' shapes (tests/test_pallas_attention.py), causal and not, T = 72
(a row tile past T) at D = 64 and 128, D 32, offsets and Tq != Tk for the
block form, mid-tile offsets, K10 and K8/K9 at every (query shard, key
shard) pair of a four-shard ring (wholly masked pairs included; T 72
shards, whose offsets cut tiles, at D 16, 48, 80 and 112 too), the
backward at those head dims, the f32 backward at T 8192, the
four-shard ring merge against K7 on the whole sequence, bitwise
repeatability, the autograd Function's gradient against autograd through
the einsum path, and the f32 flash ring through the f32 kernels. K7's f32
form (csrc/flash_attn_fwd_tf32.cu) also at every head dim 16-128, Tq !=
Tk with offsets, rows whose every visited key is masked, and T 8192.

The kernels have no CPU mode, so every test here needs a CUDA device and
skips without one. This file imports no JAX (the GPU machine has none): run
it there without the suite's conftest,

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_attention_gpu.py

Tolerances. Each output within `chip_smoke.attention_tolerance` of the
plain version: one ulp of the output's dtype, 1e-5 of the sum of its
terms' magnitudes (f32 sums in another order) and, for bf16 operands, four
flipped bf16 roundings of P or dS (2^-8 of the largest term each). LSE
within 1e-5 of max(1, |lse|). K10's (acc, l, m) within
`chip_smoke.hold_block`: acc as above with an f32 ulp, m and m + log(l) by
the LSE rule, the rows no key tile reaches exactly (0, 0, -1e30). The ring
merge against K7: P is rounded to bf16 against another running maximum on
each side, so each term may differ by 2^-8 of itself: rel 2^-8 + 1e-5 of
the sum of the terms' magnitudes.
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
# the backward also at the other head dims the tile plans pad (D 16 and 48
# to 64, 80 and 112 to 128), at a ragged T
BWD_SHAPES = SHAPES + [(1, 72, 2, d) for d in (16, 48, 80, 112)]
DTYPES = [torch.bfloat16, torch.float32]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("K7-K10 are CUDA kernels with no CPU mode: needs a CUDA "
                    "device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _rand(shape, device, seed, scale=1.0, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * scale).to(dtype).to(device)


def _operands(shape, device, seed=0, dtype=torch.bfloat16):
    return tuple(_rand(shape, device, seed + i, dtype=dtype)
                 for i in range(4))


def _assert_within(got, want, bound, what):
    err = (got.float() - want.float()).abs()
    assert (err <= bound).all(), \
        f"{what}: max err {err.max().item():.4g}, worst excess " \
        f"{(err - bound).max().item():.4g}"


def _counter(name, dtype):
    """The launch counter of kernel `name` for operands of `dtype`."""
    return name if dtype == torch.bfloat16 else "f32_" + name


def _dkv_kernels(d, dtype):
    """The kernels one K9 call launches: its f32 form at D > 64 runs two
    (dV, then dK)."""
    return 2 if dtype == torch.float32 and d > 64 else 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_forward_matches_plain_version(device, shape, causal, dtype):
    q, k, v, _ = _operands(shape, device, dtype=dtype)
    A.COUNTERS.reset()
    o, lse = A.flash_forward(q, k, v, causal)
    o2, lse2 = A.flash_forward(q, k, v, causal)
    torch.cuda.synchronize()
    assert getattr(A.COUNTERS, _counter("launches", dtype)) == 2
    assert o.dtype == dtype
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    ro, rlse = A.flash_forward_reference(q, k, v, causal)
    bound, = attention_tolerance("fwd", q, k, v, causal)
    _assert_within(o, ro, bound, "o")
    assert ((lse - rlse).abs() <= 1e-5 * rlse.abs().clamp_min(1.0)).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", BWD_SHAPES, ids=str)
def test_backward_matches_plain_version(device, shape, causal, dtype):
    q, k, v, do = _operands(shape, device, dtype=dtype)
    o, lse = A.flash_forward(q, k, v, causal)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    scale = 1.0 / math.sqrt(shape[-1])
    args = (q, k, v, do, lse, delta, 0, 0, scale, causal)
    A.COUNTERS.reset()
    dq, dk, dv = A.flash_attention_bwd_block(*args)
    again = A.flash_attention_bwd_block(*args)
    torch.cuda.synchronize()
    assert getattr(A.COUNTERS, _counter("dq_launches", dtype)) == 2
    assert getattr(A.COUNTERS, _counter("dkv_launches", dtype)) == \
        2 * _dkv_kernels(shape[-1], dtype)
    assert all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again))
    rq = A.flash_dq_reference(*args)
    rk, rv = A.flash_dkv_reference(*args)
    bq, = attention_tolerance("dq", q, k, v, causal, do, lse, delta)
    bk, bv = attention_tolerance("dkv", q, k, v, causal, do, lse, delta)
    _assert_within(dq, rq, bq, "dq")
    _assert_within(dk, rk, bk, "dk")
    _assert_within(dv, rv, bv, "dv")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("causal", [False, True])
def test_block_form_with_offsets(device, causal, dtype):
    """The block form K10's ring merge will call: Tq != Tk and global
    offsets, kernels against plain versions."""
    q = _rand((1, 64, 2, 64), device, 1, dtype=dtype)
    do = _rand((1, 64, 2, 64), device, 2, dtype=dtype)
    k = _rand((1, 136, 2, 64), device, 3, dtype=dtype)
    v = _rand((1, 136, 2, 64), device, 4, dtype=dtype)
    scale = 0.125
    o, lse = A.flash_forward_block(q, k, v, 100, 8, scale, causal)
    ro, rlse = A.flash_forward_reference(q, k, v, causal, 100, 8, scale)
    torch.cuda.synchronize()
    bound, = attention_tolerance("fwd", q, k, v, causal, q_off=100, k_off=8,
                                 scale=scale)
    _assert_within(o, ro, bound, "o")
    assert ((lse - rlse).abs() <= 1e-5 * rlse.abs().clamp_min(1.0)).all()
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta, 100, 8, scale, causal)
    dq, dk, dv = A.flash_attention_bwd_block(*args)
    bq, = attention_tolerance("dq", q, k, v, causal, do, lse, delta,
                              q_off=100, k_off=8, scale=scale)
    bk, bv = attention_tolerance("dkv", q, k, v, causal, do, lse, delta,
                                 q_off=100, k_off=8, scale=scale)
    _assert_within(dq, A.flash_dq_reference(*args), bq, "dq")
    rk, rv = A.flash_dkv_reference(*args)
    _assert_within(dk, rk, bk, "dk")
    _assert_within(dv, rv, bv, "dv")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_autograd_function_against_the_einsum_path(device, dtype):
    """flash_attention's gradient (K7, then K8 + K9) against autograd
    through the einsum path in f32 on the same values: in bf16 the two
    algorithms round P and dS in different places, so within 2 % of the
    largest gradient; in f32 neither rounds them, so within 1e-5."""
    q, k, v, do = _operands((2, 128, 2, 64), device, 5, dtype=dtype)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    A.COUNTERS.reset()
    out = A.flash_attention(*leaves, causal=True)
    out.backward(do)
    assert tuple(getattr(A.COUNTERS, _counter(n, dtype)) for n in (
        "launches", "dq_launches", "dkv_launches")) == (1, 1, 1)
    assert not A.COUNTERS.fallbacks
    ref = [t.float().requires_grad_(True) for t in (q, k, v)]
    A.attention_reference(*ref, causal=True).backward(do.float())
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    for a, b in zip(leaves, ref):
        err = (a.grad.float() - b.grad).abs().max().item()
        assert err <= tol * b.grad.abs().max().item(), err


@pytest.mark.gpu
def test_ineligible_cuda_operands_raise(device):
    q = torch.zeros((1, 64, 2, 64), dtype=torch.float16, device=device)
    with pytest.raises(ValueError, match="dtype"):
        A.flash_forward(q, q, q, True)
    with pytest.raises(ValueError, match="dtype"):
        A.flash_forward(q.float(), q.to(torch.bfloat16), q.float(), True)
    q = torch.zeros((1, 64, 2, 40), dtype=torch.bfloat16, device=device)
    with pytest.raises(ValueError, match="head_dim"):
        A.flash_forward(q, q, q, True)
    assert A.ineligible(q, q, q) == "head_dim"
    with pytest.raises(ValueError, match="head_dim"):
        A.flash_forward(q.float(), q.float(), q.float(), True)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_unaligned_operand_is_realigned(device, dtype):
    base = _rand((1 * 64 * 2 * 64 + 8,), device, 6, dtype=dtype)
    q = base[8:].view(1, 64, 2, 64)          # 16-byte aligned
    k = base[1:1 + q.numel()].view(1, 64, 2, 64)   # one element off
    o, _ = A.flash_forward(q, k, q, False)
    ro, _ = A.flash_forward_reference(q, k, q, False)
    bound, = attention_tolerance("fwd", q, k, q, False)
    _assert_within(o, ro, bound, "o")


# the last four: shards of T 72, so every ring offset cuts a 32- or 64-row
# tile, at the head dims the tile plans pad
RING_SHARDS = [(1, 128, 2, 64), (1, 64, 2, 128), (1, 64, 2, 32)] + \
    [(1, 72, 2, d) for d in (16, 48, 80, 112)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shard", RING_SHARDS, ids=str)
def test_ring_block_pairs_match_plain_version(device, shard, causal, dtype):
    """K10, then K8 and K9, at the 16 (query shard, key shard) pairs of a
    four-shard ring: offsets past, on and before the diagonal; under the
    causal mask the 6 pairs wholly in the future give (0, 0, -1e30) and
    zero gradients."""
    b, t, h, d = shard
    full = (b, 4 * t, h, d)
    q, k, v, do = _operands(full, device, 7, dtype=dtype)
    scale = 1.0 / math.sqrt(d)
    o, lse = A.flash_forward(q, k, v, causal)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    masked = 0
    A.COUNTERS.reset()
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
            again = A.flash_attention_bwd_block(*args)
            assert all(torch.equal(x, y)
                       for x, y in zip((dq, dk, dv), again)), at
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
    assert getattr(A.COUNTERS, _counter("block_launches", dtype)) == 32


@pytest.mark.gpu
def test_f32_backward_long_sequence(device):
    """K8's and K9's f32 forms at T 8192 causal, where dQ sums 8192 keys
    and dK, dV up to 8192 queries: the partials joined every 32-row tile
    keep the tensor cores' truncating accumulation inside the f32 rule (a
    single chain of that length drifts past it: tests/torch_tf32_probe.py);
    bitwise repeatable."""
    shape = (1, 8192, 2, 64)
    q, k, v, do = _operands(shape, device, 41, dtype=torch.float32)
    o, lse = A.flash_forward(q, k, v, True)
    delta = (do * o).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta, 0, 0, 0.125, True)
    dq, dk, dv = A.flash_attention_bwd_block(*args)
    again = A.flash_attention_bwd_block(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again))
    bq, = attention_tolerance("dq", q, k, v, True, do, lse, delta)
    _assert_within(dq, A.flash_dq_reference(*args), bq, "dq")
    del bq
    bk, bv = attention_tolerance("dkv", q, k, v, True, do, lse, delta)
    rk, rv = A.flash_dkv_reference(*args)
    _assert_within(dk, rk, bk, "dk")
    _assert_within(dv, rv, bv, "dv")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("causal", [False, True])
def test_block_mid_tile_offsets(device, causal, dtype):
    """K10 at Tq != Tk and offsets that cut a tile: rows of a visited tile
    whose every visited key is masked stay invalid (m = -1e30)."""
    q = _rand((1, 64, 2, 64), device, 11, dtype=dtype)
    k, v = (_rand((1, 136, 2, 64), device, seed, dtype=dtype)
            for seed in (12, 13))
    got = A.flash_attention_block(q, k, v, 100, 120, 0.125, causal)
    want = A.flash_forward_block_reference(q, k, v, 100, 120, 0.125, causal)
    torch.cuda.synchronize()
    hold_block(got, want, q, k, v, 100, 120, 0.125, causal, "mid-tile")
    if causal:
        assert (want[2][..., :20] == -1e30).all()   # rows 100..119


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_block_mid_tile_offsets_long(device, dtype):
    """K10 where a warpgroup's 64 rows reach a key tile partway and the
    CTA's two warpgroups walk different numbers of key tiles: Tq 200, Tk
    328, offsets 40 and 72, causal."""
    q = _rand((1, 200, 2, 64), device, 14, dtype=dtype)
    k, v = (_rand((1, 328, 2, 64), device, seed, dtype=dtype)
            for seed in (15, 16))
    got = A.flash_attention_block(q, k, v, 40, 72, 0.125, True)
    want = A.flash_forward_block_reference(q, k, v, 40, 72, 0.125, True)
    torch.cuda.synchronize()
    hold_block(got, want, q, k, v, 40, 72, 0.125, True, "mid-tile long")


@pytest.mark.gpu
def test_block_gate_raises(device):
    q = torch.zeros((1, 64, 2, 64), dtype=torch.float16, device=device)
    with pytest.raises(ValueError, match="dtype"):
        A.flash_attention_block(q, q, q, 0, 0, 0.125, True)
    A.COUNTERS.reset()
    A.flash_attention_block(q.to(torch.bfloat16), q.to(torch.bfloat16),
                            q.to(torch.bfloat16), 0, 0, 0.125, True)
    A.flash_attention_block(q.float(), q.float(), q.float(), 0, 0, 0.125,
                            True)
    assert A.COUNTERS.block_launches == 1 and A.COUNTERS.launches == 0
    assert A.COUNTERS.f32_block_launches == 1


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
def test_flash_ring_runs_f32_on_the_card(device):
    """The flash ring on f32 CUDA operands (no AMP) runs through the f32
    forms of K10, K8 and K9, forward and backward, as flash-ring hits with
    no fallback, and agrees with autograd through the einsum ring in f32;
    fp16 operands still raise before any block runs."""
    from paddle_tpu_torch.parallel import make_mesh
    from paddle_tpu_torch.parallel import ring_attention as R
    mesh = make_mesh((1,), ("sp",))
    q, k, v, do = _operands((1, 256, 2, 64), device, 31, dtype=torch.float32)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    A.COUNTERS.reset()
    out = R.ring_attention_sharded(*leaves, mesh, causal=True,
                                   use_flash=True)
    out.backward(do)
    torch.cuda.synchronize()
    assert (A.COUNTERS.f32_block_launches, A.COUNTERS.f32_dq_launches,
            A.COUNTERS.f32_dkv_launches) == (1, 1, 1)
    assert A.COUNTERS.block_launches == A.COUNTERS.dq_launches == 0
    assert A.COUNTERS.hits == {"ring_attention": 1}
    assert not A.COUNTERS.fallbacks
    ref = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = R.ring_attention_sharded(*ref, mesh, causal=True)
    want.backward(do)
    assert (out - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    for a, b in zip(leaves, ref):
        err = (a.grad - b.grad).abs().max().item()
        assert err <= 1e-5 * b.grad.abs().max().item(), err
    h = q.to(torch.float16)
    with pytest.raises(ValueError, match="float16"):
        R.ring_attention_sharded(h, h, h, mesh, causal=True, use_flash=True)


# K7 f32 (tf32 wgmma): (B, Tq, Tk, H, q_off, k_off): T a multiple of 8 but
# not of 64, Tq != Tk with offsets that cut tiles, rows 100-119 and 40-71
# whose every visited key is masked (p = 1 over the visited tile, the plain
# version's behaviour), a query tile that visits nothing (Tq 64 at q_off 0
# against keys from 64)
F32_FWD_CASES = [(2, 72, 72, 2, 0, 0), (1, 200, 328, 2, 40, 72),
                 (1, 64, 136, 2, 100, 120), (1, 136, 72, 3, 64, 0),
                 (1, 64, 128, 2, 0, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("d", [16, 32, 48, 64, 80, 96, 112, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("case", F32_FWD_CASES, ids=str)
def test_f32_forward_matches_plain_version(device, case, causal, d):
    b, tq, tk, h, q_off, k_off = case
    q = _rand((b, tq, h, d), device, d, dtype=torch.float32)
    k, v = (_rand((b, tk, h, d), device, d + i, dtype=torch.float32)
            for i in (1, 2))
    scale = 1.0 / math.sqrt(d)
    A.COUNTERS.reset()
    o, lse = A.flash_forward_block(q, k, v, q_off, k_off, scale, causal)
    o2, lse2 = A.flash_forward_block(q, k, v, q_off, k_off, scale, causal)
    torch.cuda.synchronize()
    assert A.COUNTERS.f32_launches == 2
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    ro, rlse = A.flash_forward_reference(q, k, v, causal, q_off, k_off,
                                         scale)
    bound, = attention_tolerance("fwd", q, k, v, causal, q_off=q_off,
                                 k_off=k_off, scale=scale)
    _assert_within(o, ro, bound, f"o {case} D {d}")
    assert ((lse - rlse).abs() <= 1e-5 * rlse.abs().clamp_min(1.0)).all()
    if causal and q_off < k_off:            # rows whose every key is masked
        rows = slice(0, min(tq, k_off - q_off))
        assert (lse[..., rows] == rlse[..., rows]).all()


@pytest.mark.gpu
def test_f32_forward_long_sequence(device):
    """K7 f32 at T 8192 causal: o joins a tile's P V partial at a time, so
    the tensor cores' truncating accumulation stays inside the f32 rule (a
    single chain of 8192 keys drifts past it: tests/torch_tf32_probe.py);
    bitwise repeatable."""
    shape = (1, 8192, 2, 64)
    q, k, v, _ = _operands(shape, device, 51, dtype=torch.float32)
    o, lse = A.flash_forward(q, k, v, True)
    o2, lse2 = A.flash_forward(q, k, v, True)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    ro, rlse = A.flash_forward_reference(q, k, v, True)
    bound, = attention_tolerance("fwd", q, k, v, True, rows=2048)
    _assert_within(o, ro, bound, "o")
    assert ((lse - rlse).abs() <= 1e-5 * rlse.abs().clamp_min(1.0)).all()
