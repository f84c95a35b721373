"""The port's int8 compute (paddle_tpu_torch/quant.py and K11's plain
version) against the JAX package's (paddle_tpu/quant.py, the Pallas
`conv2d_q8` run in interpret mode on the CPU, as tests/test_quant.py runs
it), on numpy inputs from a seed.

Tolerance: none. Both sides quantize with the same f32 arithmetic (max|x|,
one division, round half to even), sum int8 products exactly, and
dequantize with the same f32 multiplies rounded once, so int8 operands,
scales and outputs are compared bitwise.
"""

import torch_threads  # noqa: F401  (the cores shared among xdist workers)
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from paddle_tpu import quant as jquant
from paddle_tpu.ops import pallas_conv
from paddle_tpu_torch import quant
from paddle_tpu_torch.ops import conv_cuda

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from chip_smoke import CASES  # noqa: E402


def _bf16_pair(a):
    """The same bf16 values for both packages."""
    t = torch.from_numpy(a).to(torch.bfloat16)
    return jnp.asarray(t.float().numpy(), jnp.bfloat16), t


def _np(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else
                      jnp.asarray(a, jnp.float32))


@pytest.fixture(autouse=True)
def _fresh_counters():
    quant.COUNTERS.reset()
    yield
    quant.COUNTERS.reset()


@pytest.mark.parametrize("shape,axis", [((64, 16), 0), ((64, 16), 1),
                                        ((128, 64, 3, 3), 0),
                                        ((5, 7, 3), -1)], ids=str)
def test_quantize_channelwise_and_weight_qparams_bitwise(shape, axis):
    rng = np.random.default_rng(3)
    w = rng.standard_normal(shape).astype(np.float32)
    w[(slice(None),) * (axis % len(shape)) + (1,)] *= 100.0   # a hot channel
    jq, js = jquant.quantize_channelwise(jnp.asarray(w), axis)
    tq, ts = quant.quantize_channelwise(torch.from_numpy(w), axis)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jq2, js2, jerr = jquant.weight_qparams(w, axis)
    tq2, ts2, terr = quant.weight_qparams(torch.from_numpy(w), axis)
    np.testing.assert_array_equal(tq2, jq2)
    np.testing.assert_array_equal(ts2, js2)
    assert terr == jerr and terr < quant.QUANT_TOL
    # the host-side and the tensor quantizer give the same int8 weights
    np.testing.assert_array_equal(tq2, tq.numpy())


@pytest.mark.parametrize("case", CASES, ids=str)
def test_k11_plain_version_equals_pallas_conv2d_q8(case):
    h, w, kh, kw, s, p, d = case
    rng = np.random.default_rng(h * 100 + w)
    x = rng.integers(-127, 128, (2, h, w, 128)).astype(np.int8)
    wt = rng.integers(-127, 128, (128, 128, kh, kw)).astype(np.int8)
    dq = (rng.random(128) * 1e-4 + 1e-6).astype(np.float32)
    want = pallas_conv.conv2d_q8(jnp.asarray(x), jnp.asarray(wt), s, p, d,
                                 jnp.asarray(dq))
    got = conv_cuda.conv2d_q8(torch.from_numpy(x), torch.from_numpy(wt),
                              s, p, d, torch.from_numpy(dq))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(_np(got), _np(want))
    assert conv_cuda.COUNTERS.q8_launches == 0     # CPU: the plain version
    # the f32 output is the exact sum times dq, before the bf16 rounding
    y32 = conv_cuda.conv2d_q8_reference(torch.from_numpy(x),
                                        torch.from_numpy(wt), s, p, d,
                                        torch.from_numpy(dq),
                                        out_dtype=torch.float32)
    assert torch.equal(y32.to(torch.bfloat16), got)


def test_k11_gate_and_plain_version_edges():
    x = torch.zeros((1, 5, 5, 128), dtype=torch.int8)
    w = torch.zeros((128, 128, 3, 3), dtype=torch.int8)
    s = p = d = (1, 1)
    assert conv_cuda.q8_ineligible(x, w, s, p, d) is None
    assert conv_cuda.q8_ineligible(x.float(), w, s, p, d) == "dtype"
    assert conv_cuda.q8_ineligible(x[..., :8], w[:, :8], s, p, d) == "channels"
    assert conv_cuda.q8_ineligible(x, w, s, (3, 3), d) == "geometry"
    assert conv_cuda.q8_ineligible(x[0], w, s, p, d) == "rank"
    # the largest int32 sums (127*127 per term) stay exact in the plain
    # version: 3*3*128 terms of 127*127 = 18,580,608 > 2^24 rounds in f32
    full = torch.full((1, 3, 3, 128), 127, dtype=torch.int8)
    wf = torch.full((128, 128, 3, 3), 127, dtype=torch.int8)
    y = conv_cuda.conv2d_q8_reference(full, wf, s, (0, 0), d,
                                      torch.ones(128), out_dtype=torch.float32)
    assert float(y[0, 0, 0, 0]) == float(np.float32(127 * 127 * 9 * 128))
    # the byte count takes each operand at its own element size
    assert conv_cuda.conv_bytes(x, w, s, p, d) == \
        x.numel() + w.numel() + 25 * 128 * 2


def test_qconv2d_and_qmatmul_bitwise_from_bf16():
    rng = np.random.default_rng(5)
    xj, xt = _bf16_pair(rng.standard_normal((2, 8, 8, 128)).astype(np.float32))
    wj, wt = _bf16_pair((rng.standard_normal((128, 128, 3, 3)) * 0.05)
                        .astype(np.float32))
    yj = jquant.qconv2d(xj, wj, (1, 1), (1, 1), (1, 1))
    yt = quant.qconv2d(xt, wt, (1, 1), (1, 1), (1, 1))
    assert yt.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(yt), _np(yj))
    # the int8 operands the two quantizers hand their kernels are equal
    sx_j = jnp.maximum(jnp.max(jnp.abs(xj.astype(jnp.float32))), 1e-12) / 127.0
    xq_j = jnp.clip(jnp.round(xj.astype(jnp.float32) / sx_j), -127, 127)
    xq_t, sx_t = quant.quantize_tensor(xt)
    np.testing.assert_array_equal(xq_t.numpy(), np.asarray(xq_j, np.int8))
    assert float(sx_t) == float(sx_j)
    for dtype in (np.float32, "bf16"):
        a = rng.standard_normal((32, 256)).astype(np.float32)
        b = rng.standard_normal((256, 64)).astype(np.float32)
        if dtype == "bf16":
            (aj, at), (bj, bt) = _bf16_pair(a), _bf16_pair(b)
        else:
            aj, at, bj, bt = a, torch.from_numpy(a), b, torch.from_numpy(b)
        got = quant.qmatmul(at, bt)
        np.testing.assert_array_equal(_np(got), _np(jquant.qmatmul(aj, bj)))
        assert got.dtype == at.dtype


def test_prequantized_matmul_uses_the_given_weights():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((20, 64)).astype(np.float32)
    y = rng.standard_normal((64, 24)).astype(np.float32)
    q, s, _ = quant.weight_qparams(y, -1)
    pre_t = (torch.from_numpy(q), torch.from_numpy(s))
    got = quant.qmatmul(torch.from_numpy(x), torch.zeros(64, 24), pre=pre_t)
    want = jquant.qmatmul(x, y, pre=(q, s))
    np.testing.assert_array_equal(_np(got), _np(want))
    xq, _ = quant.quantize_channelwise(torch.from_numpy(x), 0)
    exact = xq.numpy().astype(np.int64) @ q.astype(np.int64)
    np.testing.assert_array_equal(quant.int_matmul(xq, pre_t[0]).numpy(),
                                  exact)


def test_gate_reasons_are_declared():
    """test_quant.py's matmul cases give the same reasons; the conv gate
    is the reference's, so a 64-channel conv that K1 takes does not
    quantize ("kernel")."""
    f32, bf = torch.float32, torch.bfloat16

    def t(shape, dtype=f32):
        return torch.empty(shape, dtype=dtype, device="meta")

    cases = [
        quant.ineligible_matmul(t((4, 8, 64)), t((64, 64))),
        quant.ineligible_matmul(t((4, 64), torch.int32), t((64, 64))),
        quant.ineligible_matmul(t((4, 24)), t((24, 64))),
        quant.ineligible_matmul(t((4, 64)), t((64, 64)), mode="int4"),
    ]
    assert cases == ["rank", "dtype", "shape", "mode"]
    assert all(c in quant.FALLBACK_REASONS for c in cases)
    assert quant.ineligible_matmul(t((4, 64)), t((64, 64))) is None

    s = p = d = (1, 1)
    x64, w64 = t((2, 8, 8, 64), bf), t((64, 64, 3, 3), bf)
    assert conv_cuda.ineligible(x64, w64, s, p, d) is None
    assert quant.ineligible_conv(x64, w64, s, p, d) == "kernel"
    assert quant.ineligible_conv(t((2, 8, 8, 128), bf), t((128, 128, 3, 3), bf),
                                 s, p, d) is None
    assert quant.ineligible_conv(t((2, 8, 8, 128), bf), t((128, 128, 3, 3), bf),
                                 s, p, d, mode="fp8") == "mode"
    wide = t((1, 3, 2100, 128), bf)
    assert quant.ineligible_conv(wide, t((128, 128, 1, 1), bf), s, (0, 0),
                                 d) == "kernel"
    # the same verdicts as the reference's gate on the same shapes
    for xs, ws in (((2, 8, 8, 64), (64, 64, 3, 3)),
                   ((2, 8, 8, 128), (128, 128, 3, 3)),
                   ((2, 8, 8, 3), (128, 3, 3, 3))):
        want = jquant.ineligible_conv(
            jax.ShapeDtypeStruct(xs, jnp.bfloat16),
            jax.ShapeDtypeStruct(ws, jnp.bfloat16), s, p, d)
        assert quant.ineligible_conv(t(xs, bf), t(ws, bf), s, p, d) == want


def test_quant_disabled_and_error_bound(monkeypatch):
    x, y = torch.empty((4, 64), device="meta"), torch.empty((64, 64),
                                                             device="meta")
    monkeypatch.setattr(quant, "QUANT_TOL", 1e-4)
    assert quant.ineligible_matmul(x, y) == "error_bound"
    monkeypatch.setattr(quant, "QUANT", False)
    assert quant.ineligible_matmul(x, y) == "disabled"
    assert quant.error_estimate(64, "int8") == jquant.error_estimate(64, "int8")


def test_qmatmul_ste_backward_is_plain_bf16():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((8, 64))).to(torch.bfloat16)
    y = torch.from_numpy(rng.standard_normal((64, 32))).to(torch.bfloat16)
    xl, yl = x.clone().requires_grad_(True), y.clone().requires_grad_(True)
    quant.qmatmul(xl, yl).sum().backward()
    g = torch.ones((8, 32), dtype=torch.bfloat16)
    assert torch.equal(xl.grad, g @ y.T) and torch.equal(yl.grad, x.T @ g)
    # and within one bf16 ulp of the JAX package's (each rounds its own sum)
    gx, gy = jax.grad(lambda a, b: jnp.sum(jquant.qmatmul(a, b)), (0, 1))(
        jnp.asarray(x.float().numpy(), jnp.bfloat16),
        jnp.asarray(y.float().numpy(), jnp.bfloat16))
    for got, want in ((xl.grad, gx), (yl.grad, gy)):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(_np(got), want, rtol=2 ** -7, atol=0)


def test_qconv2d_ste_backward_is_plain_bf16():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((1, 6, 6, 128))).to(torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((128, 128, 3, 3)) * 0.05) \
        .to(torch.bfloat16)
    xl, wl = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    quant.qconv2d(xl, wl, (1, 1), (1, 1), (1, 1)).float().sum().backward()
    xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    F.conv2d(xr.permute(0, 3, 1, 2), wr, padding=1).float().sum().backward()
    assert torch.equal(xl.grad, xr.grad) and torch.equal(wl.grad, wr.grad)


def test_qmatmul_error_within_model_bound():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((32, 256)).astype(np.float32)
    y = rng.standard_normal((256, 64)).astype(np.float32)
    ref = x @ y
    out = quant.qmatmul(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    rel = np.linalg.norm(out - ref) / np.linalg.norm(ref)
    assert rel < 10 * quant.error_estimate(256, "int8"), rel


def _fp8_bits(q):
    """The e4m3 bytes of a torch float8 tensor or an ml_dtypes array."""
    if isinstance(q, torch.Tensor):
        return q.view(torch.uint8).numpy()
    return np.asarray(q).view(np.uint8)


@pytest.mark.parametrize("shape,axis", [((64, 16), 0), ((64, 16), 1),
                                        ((128, 64, 3, 3), 0),
                                        ((5, 7, 3), -1)], ids=str)
def test_fp8_quantize_channelwise_and_weight_qparams_bitwise(shape, axis):
    """e4m3 quantization: the same bytes and scales as jnp's
    astype(float8_e4m3fn), a hot channel and values that underflow to
    (signed) zero included, and the same admission error."""
    rng = np.random.default_rng(8)
    w = (rng.standard_normal(shape) * 50.0).astype(np.float32)
    w[(slice(None),) * (axis % len(shape)) + (1,)] *= 100.0
    w.flat[::7] *= 1e-6
    jq, js = jquant.quantize_channelwise(jnp.asarray(w), axis, "fp8")
    tq, ts = quant.quantize_channelwise(torch.from_numpy(w), axis, "fp8")
    assert tq.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(_fp8_bits(tq), _fp8_bits(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jq2, js2, jerr = jquant.weight_qparams(w, axis, "fp8")
    tq2, ts2, terr = quant.weight_qparams(torch.from_numpy(w), axis, "fp8")
    np.testing.assert_array_equal(_fp8_bits(tq2), _fp8_bits(jq2))
    np.testing.assert_array_equal(ts2, js2)
    assert terr == jerr and terr < quant.QUANT_TOL


def test_fp8_conversion_beyond_448_is_pinned():
    """Up to 448 (e4m3's largest finite value) and at the rounding ties the
    two conversions agree; beyond it torch saturates to +-448 where jnp
    gives NaN past 464 (the tie that rounds down to 448). The quantizer
    divides by max|x| / 448, so its
    quotients stay within +-448 (plus rounding) and never reach that
    range."""
    x = np.array([447.0, 448.0, 450.0, 464.0, 2.0 ** -10, 1.5 * 2.0 ** -9,
                  -1e-3, 0.0019], np.float32)
    want = np.asarray(jnp.asarray(x).astype(jnp.float8_e4m3fn)).view(np.uint8)
    got = torch.from_numpy(x).to(torch.float8_e4m3fn).view(torch.uint8)
    np.testing.assert_array_equal(got.numpy(), want)
    past = np.array([470.0, 500.0, 1e4, -1e4], np.float32)
    assert np.isnan(np.asarray(jnp.asarray(past).astype(jnp.float8_e4m3fn),
                               np.float32)).all()
    assert torch.from_numpy(past).to(torch.float8_e4m3fn).float().tolist() \
        == [448.0, 448.0, 448.0, -448.0]
    # the quantizer's largest quotient, at the amax itself
    w = np.array([[3.0e-3, -7.1, 7.1000004]], np.float32)
    q, s = quant.quantize_channelwise(torch.from_numpy(w), 0, "fp8")
    assert float(q.float().abs().max()) == 448.0


def test_qmatmul_fp8_within_model_bound_and_jax():
    """fp8 qmatmul on the CPU: within the reference's error model of the
    f32 product (3 x error_estimate, tests/test_quant.py:226-233), and
    within f32 summation order of paddle_tpu.quant.qmatmul(..., "fp8"):
    both sum the same e4m3 products in f32 (exact products, the sums
    rounded in each library's order), so they differ by at most K
    roundings of the largest partial sum, 1e-5 relative here; the scale
    product and the bf16/f32 rounding of the output are the same."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((32, 256)).astype(np.float32)
    y = rng.standard_normal((256, 64)).astype(np.float32)
    ref = x @ y
    got = quant.qmatmul(torch.from_numpy(x), torch.from_numpy(y), "fp8")
    rel = np.linalg.norm(got.numpy() - ref) / np.linalg.norm(ref)
    assert rel < 3 * quant.error_estimate(256, "fp8"), rel
    want = np.asarray(jquant.qmatmul(x, y, "fp8"))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the e4m3 operands are the same bytes, the exact sums the same
    xq, sx = quant.quantize_channelwise(torch.from_numpy(x), 0, "fp8")
    yq, sy = quant.quantize_channelwise(torch.from_numpy(y), 1, "fp8")
    acc = quant.fp8_matmul(xq, yq)
    exact = xq.double() @ yq.double()
    bound = 256 * 2.0 ** -24 * (xq.double().abs() @ yq.double().abs())
    assert ((acc.double() - exact).abs() <= bound).all()
    # bf16 operands, as O3 hands them over
    (aj, at), (bj, bt) = _bf16_pair(x), _bf16_pair(y)
    got = quant.qmatmul(at, bt, "fp8")
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(jquant.qmatmul(aj, bj, "fp8")),
                               rtol=2 ** -7, atol=1e-2)
    # the conv stays int8: the gate says "mode", qconv2d refuses fp8
    with pytest.raises(ValueError, match="int8"):
        quant.qconv2d(torch.zeros(1, 4, 4, 128, dtype=torch.bfloat16),
                      torch.zeros(128, 128, 1, 1, dtype=torch.bfloat16),
                      (1, 1), (0, 0), (1, 1), mode="fp8")


def test_fp8_gates_match_the_reference():
    f32, bf = torch.float32, torch.bfloat16

    def t(shape, dtype=f32):
        return torch.empty(shape, dtype=dtype, device="meta")

    for xs, ys in (((4, 64), (64, 64)), ((4, 24), (24, 64)),
                   ((4, 8, 64), (64, 64))):
        want = jquant.ineligible_matmul(jax.ShapeDtypeStruct(xs, np.float32),
                                        jax.ShapeDtypeStruct(ys, np.float32),
                                        mode="fp8")
        assert quant.ineligible_matmul(t(xs), t(ys), mode="fp8") == want
    assert quant.ineligible_matmul(t((4, 64)), t((64, 64)), "fp8") is None
    s = p = d = (1, 1)
    want = jquant.ineligible_conv(
        jax.ShapeDtypeStruct((2, 8, 8, 128), jnp.bfloat16),
        jax.ShapeDtypeStruct((128, 128, 3, 3), jnp.bfloat16), s, p, d,
        mode="fp8")
    assert want == "mode" and quant.ineligible_conv(
        t((2, 8, 8, 128), bf), t((128, 128, 3, 3), bf), s, p, d,
        mode="fp8") == want


def test_grad_rerun_counts_no_second_quant_hit():
    """A generic grad re-runs its forward lowering; under O3 the re-run
    counts no second quant hit, as the JAX package's vjp counts none
    (registry.py:213-217): one run books one `mul` hit."""
    import paddle_tpu_torch as pt
    x = np.random.default_rng(5).standard_normal((4, 64)).astype(np.float32)
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        xv = pt.layers.data(name="x", shape=[64], dtype="float32")
        loss = pt.layers.mean(pt.layers.fc(xv, size=32))
        pt.backward.append_backward(loss)
    pt.amp.enable(main, level="O3")
    assert any(op.type == "mul_grad" for op in main.global_block().ops)
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    exe.run(main, feed={"x": x}, fetch_list=[loss], scope=scope)
    assert quant.COUNTERS.hits == {"mul": 1}
    assert not quant.COUNTERS.fallbacks
