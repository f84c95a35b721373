"""The port's attention on the CPU: the plain versions of K7-K9
(paddle_tpu_torch/ops/attention_cuda.py) against the JAX package's Pallas
flash kernels in interpret mode, the autograd Function against JAX's
custom_vjp, the einsum path against the reference's, the Hopper gate, and a
guard that a CPU tensor never reaches the CUDA build.

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
from chip_smoke import attention_tolerance  # noqa: E402

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
