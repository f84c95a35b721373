"""The port's attention on the CPU: the plain versions of K7-K9
(paddle_tpu_torch/ops/attention_cuda.py) against the JAX package's Pallas
flash kernels in interpret mode, the autograd Function against JAX's
custom_vjp, the einsum path against the reference's, the Hopper gate, a
guard that a CPU tensor never reaches the CUDA build, and the f32 kernels'
3xTF32 arithmetic (K7 f32 and K10 f32, one tf32-wgmma body, and K8, K9)
emulated on the CPU under the f32 rule.

Inputs come from a numpy seed and go through both packages.

Tolerances, relative to the largest magnitude of the JAX output:
  * f32: 2e-6. Both sides compute in f32 and differ in the order of their
    sums and in their key tiles (64 here, the whole T up to 512 there):
    measured at most 5.2e-7.
  * bf16 operands: 2^-7, two bf16 ulps of the largest output. Both round P
    and dS to bf16 before their products, but the forward rounds P against
    a running maximum that depends on the key tiling, and each output is
    rounded once more at the end: measured at most 3.6e-3.
  * LSE (f32 in both cases): 1e-6.
"""

import torch_threads  # noqa: F401  (the cores shared among xdist workers)
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops import pallas_attention
from paddle_tpu.parallel import ring_attention
from paddle_tpu_torch.ops import attention_cuda as A
from paddle_tpu_torch.ops import cuda_build

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from chip_smoke import attention_tolerance, hold_block  # noqa: E402

# tests/test_pallas_attention.py's shapes
SHAPES = [(2, 64, 2, 32), (1, 128, 4, 64), (2, 256, 2, 64)]
TOL = {"float32": 2e-6, "bfloat16": 2.0 ** -7}


def _inputs(shape, dtype, seed=0, n=4):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return ([jnp.asarray(a).astype(jd) for a in arrs],
            [torch.from_numpy(a).to(td) for a in arrs])


def _close(got, want, tol, what):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.float().numpy()
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), f"{what}: {err}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_versions_match_pallas(shape, causal, dtype):
    """K7's plain version against pallas_attention._forward, K8's and K9's
    against flash_attention_bwd_block, on the same operands, LSE and
    delta."""
    (q, k, v, do), (tq, tk, tv, tdo) = _inputs(shape, dtype)
    scale = 1.0 / np.sqrt(shape[-1])
    with jax.default_matmul_precision("highest"):
        o, lse = pallas_attention._forward(q, k, v, causal, return_lse=True)
        delta = jnp.sum(do.astype(jnp.float32) * o.astype(jnp.float32),
                        axis=-1).transpose(0, 2, 1)
        dq, dk, dv = pallas_attention.flash_attention_bwd_block(
            q, k, v, do, lse, delta, 0, 0, scale, causal)
    po, plse = A.flash_forward_reference(tq, tk, tv, causal)
    assert po.dtype == tq.dtype and plse.dtype == torch.float32
    _close(po, o, TOL[dtype], "o")
    _close(plse, lse, 1e-6, "lse")
    # the backward from the JAX forward's own LSE and delta
    tlse = torch.from_numpy(np.array(lse))
    tdelta = torch.from_numpy(np.array(delta))
    args = (tq, tk, tv, tdo, tlse, tdelta, 0, 0, scale, causal)
    pq = A.flash_dq_reference(*args)
    pk, pv = A.flash_dkv_reference(*args)
    for got, want, what in ((pq, dq, "dq"), (pk, dk, "dk"), (pv, dv, "dv")):
        assert got.dtype == tq.dtype, what
        _close(got, want, TOL[dtype], what)


@pytest.mark.parametrize("causal", [False, True])
def test_autograd_function_matches_custom_vjp(causal):
    """flash_attention (K7 forward, K8 + K9 backward through
    attention_backward) against pallas_attention.flash_attention's
    custom_vjp, f32: the gradients of sum(out^2)."""
    (q, k, v), (tq, tk, tv) = _inputs((1, 128, 2, 32), "float32", 3, 3)
    with jax.default_matmul_precision("highest"):
        want = jax.grad(lambda a, b, c: jnp.sum(
            pallas_attention.flash_attention(a, b, c, causal) ** 2),
            argnums=(0, 1, 2))(q, k, v)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    A.COUNTERS.reset()
    torch.sum(A.flash_attention(*leaves, causal=causal) ** 2).backward()
    # f32 operands pass the gate (the kernels' f32 forms on the card; here,
    # on CPU tensors, their plain versions): two hits, no fallback
    assert A.COUNTERS.hits == {"flash_attention": 2}
    assert not A.COUNTERS.fallbacks
    for leaf, w, what in zip(leaves, want, "qkv"):
        _close(leaf.grad, w, TOL["float32"] * 10, "d" + what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_einsum_path_matches_reference(causal, dtype):
    """attention_reference and attention_reference_lse against
    ring_attention's: the same einsum arithmetic in the operands' dtype
    (bf16: one ulp of the softmax apart, as jnp and torch round its sum
    differently)."""
    (q, k, v), (tq, tk, tv) = _inputs((2, 64, 2, 32), dtype, 5, 3)
    with jax.default_matmul_precision("highest"):
        want = ring_attention.attention_reference(q, k, v, causal=causal)
        want_lse = ring_attention.attention_reference_lse(q, k,
                                                          causal=causal)
    got = A.attention_reference(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype
    _close(got, want, {"float32": 1e-6, "bfloat16": 2.0 ** -6}[dtype], "out")
    _close(A.attention_reference_lse(tq, tk, causal=causal), want_lse,
           {"float32": 1e-6, "bfloat16": 2.0 ** -8}[dtype], "lse")


def test_supports_is_the_reference_rule():
    for shape in [(1, 104, 2, 32), (1, 256, 1, 64), (1, 64, 1, 64),
                  (1, 100, 2, 32), (1, 257, 1, 64), (1, 384, 1, 16)]:
        j, t = _inputs(shape, "float32", n=3)
        assert A.supports(*t) == pallas_attention.supports(*j), shape
    q3 = torch.zeros((2, 64, 32))
    assert not A.supports(q3, q3, q3)


def test_gate_reasons():
    """bf16 and f32 pass (the Hopper kernels and their f32 forms); other
    dtypes, fp16 among them, and mixed dtypes fail with "dtype"; D outside
    the multiples of 16 up to 128 with "head_dim", in either dtype."""
    bf = torch.zeros((1, 64, 2, 64), dtype=torch.bfloat16)
    assert A.ineligible(bf, bf, bf) is None
    assert A.ineligible(bf.float(), bf.float(), bf.float()) is None
    assert A.ineligible(bf, bf.float(), bf) == "dtype"
    assert A.ineligible(bf.float(), bf, bf) == "dtype"
    for dt in (torch.float16, torch.float64):
        x = bf.to(dt)
        assert A.ineligible(x, x, x) == "dtype", dt
    for dt in (torch.bfloat16, torch.float32):
        for d in (40, 144, 8):
            x = torch.zeros((1, 64, 2, d), dtype=dt)
            assert A.ineligible(x, x, x) == "head_dim", (dt, d)
        for d in (16, 32, 96, 128):
            x = torch.zeros((1, 64, 2, d), dtype=dt)
            assert A.ineligible(x, x, x) is None, (dt, d)
    assert A.FALLBACK_REASONS == {"dtype", "head_dim"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_ring_gate_admits_f32(dtype):
    """The flash ring's gate on the card's meta tensors: bf16 and f32 are
    hits (the f32 ring runs through the kernels' f32 forms on the card);
    fp16 raises on a CUDA-like device before anything runs, where the plain
    versions would form the whole scores, and counts a "dtype" fallback on
    CPU tensors."""
    from paddle_tpu_torch.parallel import ring_attention as R
    meta = torch.empty((1, 256, 2, 64), dtype=dtype, device="meta")
    A.COUNTERS.reset()
    if dtype == torch.float16:
        with pytest.raises(ValueError, match="float16"):
            R._gate(meta, meta, meta, "ring_attention")
        R._gate(torch.zeros((1, 8, 1, 16), dtype=dtype),
                torch.zeros((1, 8, 1, 16), dtype=dtype),
                torch.zeros((1, 8, 1, 16), dtype=dtype), "ring_attention")
        assert A.COUNTERS.fallbacks == {("ring_attention", "dtype"): 1}
        assert not A.COUNTERS.hits
    else:
        R._gate(meta, meta, meta, "ring_attention")
        assert A.COUNTERS.hits == {"ring_attention": 1}
        assert not A.COUNTERS.fallbacks


def test_cpu_tensors_never_touch_the_cuda_build(monkeypatch):
    """On CPU tensors every wrapper computes its plain version: no library
    is built or loaded and no launch is counted, whatever the gate says."""
    def refuse(*a, **k):
        raise AssertionError("a CPU tensor reached cuda_build")
    monkeypatch.setattr(cuda_build, "load", refuse)
    monkeypatch.setattr(cuda_build, "entry", refuse)
    monkeypatch.setattr(cuda_build, "build", refuse)
    _, (q, k, v, do) = _inputs((1, 64, 2, 32), "bfloat16")
    A.COUNTERS.reset()
    o, lse = A.flash_forward(q, k, v, True)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    A.flash_attention_bwd_block(q, k, v, do, lse, delta, 0, 0, 0.125, True)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    A.flash_attention(*leaves, causal=True).float().sum().backward()
    assert (A.COUNTERS.launches, A.COUNTERS.dq_launches,
            A.COUNTERS.dkv_launches) == (0, 0, 0)
    assert A.COUNTERS.hits == {"flash_attention": 2}


def test_non_finite_lse_rows_add_nothing():
    """flash_attention_bwd_block replaces a non-finite LSE by 1e30 (the
    reference's :419), so such a row's P is 0: it adds nothing to dK or
    dV and its dQ is 0."""
    _, (q, k, v, do) = _inputs((1, 64, 1, 32), "float32", 9)
    _, lse = A.flash_forward(q, k, v, False)
    delta = torch.zeros_like(lse)
    bad = lse.clone()
    bad[0, 0, 5] = float("-inf")
    dq, dk, dv = A.flash_attention_bwd_block(q, k, v, do, bad, delta, 0, 0,
                                             0.125, False)
    assert torch.isfinite(dq).all() and torch.isfinite(dk).all()
    assert torch.equal(dq[0, 5], torch.zeros_like(dq[0, 5]))
    do2 = do.clone()
    do2[0, 5] = 0                      # row 5 contributes nothing either way
    _, dk2, dv2 = A.flash_attention_bwd_block(q, k, v, do2, lse, delta, 0, 0,
                                              0.125, False)
    torch.testing.assert_close(dv, dv2)


def test_kernel_tolerance_is_not_vacuous():
    """The bound chip_smoke.py and the card tests hold the kernels to is
    tight enough to fail dK with its keys in the wrong rows (what a wrong
    tile index gives) or at 1.05 times its value."""
    _, (q, k, v, do) = _inputs((1, 64, 2, 64), "bfloat16", 11)
    o, lse = A.flash_forward(q, k, v, True)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta, 0, 0, 0.125, True)
    dk, _ = A.flash_dkv_reference(*args)
    bk, _ = attention_tolerance("dkv", q, k, v, True, do, lse, delta)
    for wrong in (dk.flip(1), dk * 1.05):
        assert not ((wrong.float() - dk.float()).abs() <= bk).all()


def test_f32_kernel_tolerance_is_not_vacuous():
    """The f32 forms' bound (no flipped roundings, an f32 ulp, dS counted
    with the magnitude of dP's terms) still fails dK with its keys in the
    wrong rows or at 1.001 times its value, and o at 1.001 times its
    value."""
    _, (q, k, v, do) = _inputs((1, 64, 2, 64), "float32", 11)
    o, lse = A.flash_forward(q, k, v, True)
    bo, = attention_tolerance("fwd", q, k, v, True)
    assert ((o - A.flash_forward_reference(q, k, v, True)[0]).abs()
            <= bo).all()
    assert not ((o * 1.001 - o).abs() <= bo).all()
    delta = (do * o).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta, 0, 0, 0.125, True)
    dk, _ = A.flash_dkv_reference(*args)
    bk, _ = attention_tolerance("dkv", q, k, v, True, do, lse, delta)
    for wrong in (dk.flip(1), dk * 1.001):
        assert not ((wrong - dk).abs() <= bk).all()


# --- the f32 backward kernels' arithmetic (csrc/flash_attn_bwd_tf32.cu) -------

def _tf32_hi(x):
    """x truncated to tf32: the top 19 bits, what the tensor cores read of a
    raw f32 (measured on the card: tests/torch_tf32_probe.py)."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _tf32_rna(x):
    """x rounded to the nearest tf32, ties away from zero (cvt.rna)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_product(a, b, passes, tile=None):
    """a [..., M, K] @ b [..., K, N] in f32 as the kernels take it: each
    operand x = hi + lo, hi = _tf32_hi(x), lo = _tf32_rna(x - hi); passes 3:
    lo_a hi_b + hi_a lo_b + hi_a hi_b, passes 1: hi_a hi_b alone (tf32
    products are exact, the tensor cores' sums within a chain of a few k8
    steps close to it: f64 here); the sum over K in partials of `tile`
    (the kernels' 32-row tiles; one partial when None), each rounded to f32
    and joined in order by f32 adds."""
    ah, bh = _tf32_hi(a), _tf32_hi(b)
    al, bl = _tf32_rna(a - ah), _tf32_rna(b - bh)
    tile = tile or a.shape[-1]
    acc = None
    for k0 in range(0, a.shape[-1], tile):
        ks = slice(k0, k0 + tile)
        part = ah[..., ks].double() @ bh[..., ks, :].double()
        if passes == 3:
            part += al[..., ks].double() @ bh[..., ks, :].double()
            part += ah[..., ks].double() @ bl[..., ks, :].double()
        part = part.float()
        acc = part if acc is None else acc + part
    return acc


def _f32_backward(q, k, v, do, lse, delta, scale, causal, passes):
    """K8's and K9's formulas with the kernels' rounding points: S and dP
    from tf32 products (one chain over D), S times scale rounded, masked
    -1e30, P = exp(S - LSE) and dS = P (dP - delta) in f32, then dQ =
    scale * dS K over 32-key partials, dV = P^T dO and dK = scale * dS^T Q
    over 32-query partials. passes 0: the same formulas in f64. Returns
    (dq, dk, dv) [B, T, H, D]."""
    dt = torch.float64 if passes == 0 else torch.float32
    qf, kf, vf, dof = (x.to(dt).permute(0, 2, 1, 3) for x in (q, k, v, do))

    def mm(a, b, tile=None):
        return a @ b if passes == 0 else _tf32_product(a, b, passes, tile)

    s = mm(qf, kf.transpose(-1, -2)) * scale
    if causal:
        keep = torch.ones(s.shape[-2:], dtype=torch.bool).tril()
        s = torch.where(keep, s, torch.full_like(s, -1e30))
    p = torch.exp(s - lse.to(dt)[..., None])
    ds = p * (mm(dof, vf.transpose(-1, -2)) - delta.to(dt)[..., None])
    dq = mm(ds, kf, 32) * scale
    dv = mm(p.transpose(-1, -2), dof, 32)
    dk = mm(ds.transpose(-1, -2), qf, 32) * scale
    return tuple(x.permute(0, 2, 1, 3) for x in (dq, dk, dv))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_f32_backward_arithmetic_holds_the_f32_rule(shape, causal):
    """The f32 kernels' 3xTF32 scheme (hi truncated, lo rounded to nearest,
    three passes, sequence-long sums joined every 32-row tile), emulated on
    the CPU through K8's and K9's formulas, stays within
    chip_smoke.attention_tolerance's f32 rule of the f64 result on the same
    f32 operands, LSE and delta; one tf32 pass (hi alone) does not, so the
    rule can tell them apart."""
    _, (q, k, v, do) = _inputs(shape, "float32", 13)
    scale = 1.0 / np.sqrt(shape[-1])
    o, lse = A.flash_forward_reference(q, k, v, causal)
    delta = (do * o).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta, scale, causal)
    want = _f32_backward(*args, passes=0)
    bq, = attention_tolerance("dq", q, k, v, causal, do, lse, delta)
    bk, bv = attention_tolerance("dkv", q, k, v, causal, do, lse, delta)

    def within(got):
        return [bool(((g.double() - w).abs() <= b.double()).all())
                for g, w, b in zip(got, want, (bq, bk, bv))]

    assert within(_f32_backward(*args, passes=3)) == [True] * 3
    assert not any(within(_f32_backward(*args, passes=1)))


# --- the f32 forward kernel's arithmetic (csrc/flash_attn_fwd_tf32.cu) ---------

def _f32_forward(q, k, v, causal, q_off, k_off, scale, bk, passes,
                 raw=False):
    """K7 f32 as the kernel runs it: per 64 query rows, the 64-key tiles the
    plain version visits walked in tiles of `bk` keys (keys past the last
    visited tile or Tk add exactly nothing); S from tf32 products (one
    chain over D), times scale rounded, causal-masked -1e30; the online
    softmax in f32; each tile's P V one tf32 partial joined by o = o *
    alpha + partial; O = o / max(l, 1e-30), LSE = m + log(max(l, 1e-30)).
    Returns (o [B, Tq, H, D], lse [B, H, Tq]); with `raw`, K10 f32 on the
    same body: the state as it stands, (acc [B, Tq, H, D], l, m [B, H,
    Tq]), a row that visits no key tile (0, 0, -1e30)."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    qf, kf, vf = (x.float().permute(0, 2, 1, 3) for x in (q, k, v))
    o = torch.zeros((b, h, tq, d))
    lse = torch.zeros((b, h, tq))
    ls = torch.zeros((b, h, tq))
    for q0 in range(0, tq, 64):
        rows = slice(q0, min(q0 + 64, tq))
        visit = -(-tk // 64)
        if causal:
            last_key = q_off + rows.stop - 1 - k_off
            visit = 0 if last_key < 0 else min(visit, last_key // 64 + 1)
        lim = min(tk, visit * 64)
        qpos = q_off + torch.arange(rows.start, rows.stop)
        m = torch.full((b, h, rows.stop - q0), -1e30)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, h, rows.stop - q0, d))
        for k0 in range(0, lim, bk):
            keys = torch.arange(k0, min(k0 + bk, lim))
            kb, vb = kf[:, :, keys], vf[:, :, keys]
            s = _tf32_product(qf[:, :, rows], kb.transpose(-1, -2), passes) \
                * scale
            if causal:
                keep = qpos[:, None] >= k_off + keys[None, :]
                s = torch.where(keep, s, torch.full_like(s, -1e30))
            mx = torch.maximum(m, s.amax(-1))
            corr = torch.exp(m - mx)
            pr = torch.exp(s - mx[..., None])
            l = l * corr + pr.sum(-1)
            m = mx
            acc = acc * corr[..., None] + _tf32_product(pr, vb, passes)
        if raw:
            o[:, :, rows], lse[:, :, rows], ls[:, :, rows] = acc, m, l
            continue
        denom = torch.clamp(l, min=1e-30)
        o[:, :, rows] = acc / denom[..., None]
        lse[:, :, rows] = m + torch.log(denom)
    if raw:
        return o.permute(0, 2, 1, 3), ls, lse
    return o.permute(0, 2, 1, 3), lse


# (B, Tq, Tk, H, D, q_off, k_off): the JAX tests' shapes; T 72 (a ragged
# tile); Tq != Tk with offsets that cut tiles; rows 100-119 whose every key
# is masked (p = 1 over the visited tile, the plain version's behaviour)
F32_FWD_CASES = [(2, 64, 64, 2, 32, 0, 0), (1, 128, 128, 4, 64, 0, 0),
                 (2, 256, 256, 2, 64, 0, 0), (1, 72, 72, 2, 128, 0, 0),
                 (1, 200, 328, 2, 48, 40, 72), (1, 64, 136, 2, 80, 100, 120)]


@pytest.mark.parametrize("bk", [32, 64])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("case", F32_FWD_CASES, ids=str)
def test_f32_forward_arithmetic_holds_the_f32_rule(case, causal, bk):
    """K7 f32's scheme (3xTF32 products, key tiles of 32 or 64 inside the
    plain version's 64-key visiting, per-tile P V partials joined by the
    online rescale), emulated on the CPU, stays within
    chip_smoke.attention_tolerance's f32 rule of the plain version (LSE
    within 1e-5 of max(1, |lse|)); one tf32 pass (hi alone) does not."""
    b, tq, tk, h, d, q_off, k_off = case
    rng = np.random.default_rng(sum(case) + bk)
    q = torch.from_numpy(rng.standard_normal((b, tq, h, d)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((b, tk, h, d))
                             .astype(np.float32)) for _ in range(2))
    scale = 1.0 / np.sqrt(d)
    ro, rlse = A.flash_forward_reference(q, k, v, causal, q_off, k_off, scale)
    bound, = attention_tolerance("fwd", q, k, v, causal, q_off=q_off,
                                 k_off=k_off, scale=scale)
    o, lse = _f32_forward(q, k, v, causal, q_off, k_off, scale, bk, 3)
    assert ((o - ro).abs() <= bound).all()
    assert ((lse - rlse).abs() <= 1e-5 * rlse.abs().clamp_min(1.0)).all()
    if causal and q_off < k_off:    # rows whose every key is masked
        masked = slice(0, k_off - q_off)
        assert (rlse[..., masked] == -1e30).all()
        assert (ro[:, masked].abs().sum(-1) > 0).all()      # p = 1, not 0
    o1, _ = _f32_forward(q, k, v, causal, q_off, k_off, scale, bk, 1)
    assert not ((o1 - ro).abs() <= bound).all()


def _f32_operands(b, tq, tk, h, d, seed):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((b, tq, h, d)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((b, tk, h, d))
                             .astype(np.float32)) for _ in range(2))
    return q, k, v


def _hold_f32_block(q, k, v, q_off, k_off, causal, bk):
    """K10 f32's scheme, emulated, held to the plain version by
    chip_smoke.hold_block (invalid rows exactly m = -1e30, rows no key
    tile reaches exactly (0, 0, -1e30), valid rows' acc within
    attention_tolerance's f32 rule); one tf32 pass must fail it. Returns
    the plain version's (acc, l, m)."""
    scale = 1.0 / np.sqrt(q.shape[-1])
    want = A.flash_forward_block_reference(q, k, v, q_off, k_off, scale,
                                           causal)
    got = _f32_forward(q, k, v, causal, q_off, k_off, scale, bk, 3, raw=True)
    args = (q, k, v, q_off, k_off, scale, causal)
    hold_block(got, want, *args, "K10 f32 emulated")
    if not (want[2] <= -5e29).all():
        one = _f32_forward(q, k, v, causal, q_off, k_off, scale, bk, 1,
                           raw=True)
        with pytest.raises(RuntimeError, match="acc|m"):
            hold_block(one, want, *args, "one tf32 pass")
    return got, want


@pytest.mark.parametrize("bk", [32, 64])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("case", F32_FWD_CASES, ids=str)
def test_f32_block_arithmetic_holds_the_f32_rule(case, causal, bk):
    """K10 f32 runs K7 f32's body with the normalization left out: its raw
    state (acc, l, m), emulated on the CPU with the kernel's scheme, stays
    within the f32 rule of flash_forward_block_reference at F32_FWD_CASES;
    one tf32 pass does not."""
    b, tq, tk, h, d, q_off, k_off = case
    q, k, v = _f32_operands(b, tq, tk, h, d, sum(case) + bk + 1)
    (acc, l, m), (racc, rl, rm) = _hold_f32_block(q, k, v, q_off, k_off,
                                                  causal, bk)
    assert acc.shape == q.shape and l.shape == m.shape == (b, h, tq)
    if causal and q_off < k_off:    # rows whose every visited key is masked
        masked = slice(0, k_off - q_off)
        assert (m[..., masked] == -1e30).all()
        assert (rl[..., masked] > 0).all()        # p = 1 over the tile, not 0


# (B, T/P, H, D) of a four-shard ring's pairs: T/P 64 and 72 (a ragged tile)
F32_RING_SHARDS = [(1, 64, 2, 32), (1, 72, 2, 64)]


@pytest.mark.parametrize("bk", [32, 64])
@pytest.mark.parametrize("q_shard", range(4))
@pytest.mark.parametrize("shard", F32_RING_SHARDS, ids=str)
def test_f32_block_at_the_four_shard_ring_pairs(shard, q_shard, bk):
    """K10 f32, emulated, at the four (q_shard, j) pairs of a causal
    four-shard ring, the offsets the ring gives it: held to the plain
    version by the f32 rule; a pair wholly in the causal future (j >
    q_shard, no key tile visited) is exactly (0, 0, -1e30), as the plain
    version is."""
    b, t, h, d = shard
    q, k, v = _f32_operands(b, 4 * t, 4 * t, h, d, 29 + q_shard + bk + d)
    i = q_shard
    for j in range(4):
        (acc, l, m), _ = _hold_f32_block(
            q[:, i * t:(i + 1) * t], k[:, j * t:(j + 1) * t],
            v[:, j * t:(j + 1) * t], i * t, j * t, True, bk)
        if j > i:
            assert (acc == 0).all() and (l == 0).all() and (m == -1e30).all()
        else:
            assert (m > -1e30).all() and (l >= 1).all()


def test_f32_block_runs_on_the_tf32_forward():
    """The f32 form of K10 is K7 f32's library entry (no tile walk is
    built), counted in f32_block_launches."""
    lib, entry, counter = A._KERNELS["block"][1]
    assert (lib, entry, counter) == ("flash_attn_fwd_tf32",
                                     "flash_tf32_fwd_block",
                                     "f32_block_launches")
    assert A._KERNELS["fwd"][1][0] == lib
    assert "flash_attn_walk" not in cuda_build.SOURCES
    assert not (cuda_build.CSRC / "flash_attn_walk.cu").exists()
    assert "flash_tf32_fwd_block" in \
        (cuda_build.CSRC / cuda_build.SOURCES[lib]).read_text()
