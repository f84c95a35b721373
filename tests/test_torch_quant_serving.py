"""Quantized serving (AMP O3, int8) on the CPU: a small ResNet served by the
JAX package's ServingEngine and by the port's with quantize="int8", on the
same weights.

The model, from models/resnet.py blocks in both packages: a 3->64 3x3 stem
(Ci=3: K1's gate sends it to F.conv2d, the quant gate says "kernel"), one
bottleneck at 64 channels (its four convs pass K1's gate but not the
reference's 128-channel rule: bf16 on K1, quant fallback "kernel"),
basicblock 256->128 stride 2 and basicblock 128->256 stride 2 (six convs,
all quantized: K11's plain version here), global average pooling, fc(10)
(quantized: an int8 GEMM) and softmax, on a 2x3x16x16 input, is_test=True.
Batch-norm scales are drawn from uniform(0.2, 4), the statistics away from
the identity, so the fold matters.

The JAX engine quantizes each conv filter once, unfolded, and its serving
trace hands those int8 values to every conv, folded or not
(quant.prequantized by filter name, nn_ops.py:308-310): the batch-norm
scale of each folded conv is lost. The right JAX path quantizes the folded
filter, which it does per call when `quant.prequantized` returns None for
conv filters; the port is held to that path, with the reference engine's
own answer shown far off (test_reference_fold_fault).

Tolerances: softmax within SOFTMAX_ATOL of the JAX path with equal
argmax, logits within a relative L2 of LOGIT_RL2. The int8 routes compute
bitwise alike (tests/test_torch_quant.py); the bf16 convs of the
64-channel block and the bf16 roundings between ops sum in another order,
and a bf16 flip upstream can move an activation across an int8 rounding
step. Measured on the CPU: softmax 0.00195 apart, logits 0.0063; the
bounds are 2.5x and 3x that.
"""

import torch_threads  # noqa: F401  (the cores shared among xdist workers)
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import executor as jax_executor
from paddle_tpu import quant as jquant
from paddle_tpu import telemetry
from paddle_tpu.models import resnet as jax_resnet
from paddle_tpu.serving import ServingEngine as JaxServingEngine
import paddle_tpu_torch as pt
from paddle_tpu_torch import quant
from paddle_tpu_torch.models import resnet as port_resnet
from paddle_tpu_torch.ops import conv_cuda, quant_cuda
from paddle_tpu_torch.serving import ServingEngine

BUCKETS = (1, 2, 4)
SOFTMAX_ATOL, LOGIT_RL2 = 5e-3, 0.02
# relative L2 distance of the logits from the f32 engine's
PORT_RL2, FAULT_RL2 = 0.03, 0.1


def _build(fluid, resnet):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[3, 16, 16], dtype="float32")
        x = resnet.conv_bn_layer(img, 64, 3, 1, 1, is_test=True)
        x = resnet.bottleneck(x, 64, 64, 1, is_test=True)
        x = resnet.basicblock(x, 256, 128, 2, is_test=True)
        x = resnet.basicblock(x, 128, 256, 2, is_test=True)
        x = fluid.layers.pool2d(x, pool_size=4, pool_type="avg",
                                global_pooling=True)
        logits = fluid.layers.fc(x, size=10)
        prob = fluid.layers.softmax(logits)
    return main, startup, [prob.name, logits.name]


def _weights():
    """The JAX startup's persistables with batch-norm parameters redrawn."""
    main, startup, _ = _build(jfluid, jax_resnet)
    scope = jax_executor.Scope()
    with jax_executor.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
    arrays = {n: np.array(scope.find_var(n))
              for n, v in startup.global_block().desc.vars.items()
              if v.persistable}
    rng = np.random.default_rng(7)
    for op in main.global_block().ops:
        if op.type == "batch_norm":
            c = arrays[op.input("Scale")[0]].shape
            arrays[op.input("Scale")[0]] = rng.uniform(0.2, 4.0, c)
            arrays[op.input("Bias")[0]] = 0.1 * rng.standard_normal(c)
            arrays[op.input("Mean")[0]] = 0.1 * rng.standard_normal(c)
            arrays[op.input("Variance")[0]] = rng.uniform(0.5, 2.0, c)
    # the scales grow the activations ~1000x over ten convs: shrink the fc
    # so that the softmax is not saturated and its check means something
    fc_w = next(op.input("Y")[0] for op in main.global_block().ops
                if op.type == "mul")
    arrays[fc_w] = arrays[fc_w] * 1e-3
    return {n: a.astype(np.float32) for n, a in arrays.items()}


def _input(n=2, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, 3, 16, 16)).astype(np.float32)


def _conv_filters(main):
    return {op.input("Filter")[0] for op in main.global_block().ops
            if op.type == "conv2d"}


_CACHE = {}


def _jax_serve(quantize, patched):
    """(outputs, quant_report, hit and fallback series) of the JAX engine,
    once per variant. `patched`: conv filters bypass the admission-time
    int8 values, so each conv quantizes the filter it is handed."""
    key = (quantize, patched)
    if key not in _CACHE:
        arrays = _weights()
        main, _, fetch = _build(jfluid, jax_resnet)
        scope = jax_executor.Scope()
        for n, a in arrays.items():
            scope.set_var(n, a)
        filters = _conv_filters(main)
        orig = jquant.prequantized
        if patched:
            jquant.prequantized = lambda ctx, name: (
                None if name in filters else orig(ctx, name))
        try:
            telemetry.reset()
            eng = JaxServingEngine(main, ["img"], fetch,
                                   place=jfluid.CPUPlace(), scope=scope,
                                   buckets=BUCKETS, quantize=quantize)
            out = [np.asarray(o, np.float32)
                   for o in eng.infer({"img": _input()})]
            series = (telemetry.read_series("quant_kernel_total"),
                      telemetry.read_series("quant_fallback_total"))
        finally:
            jquant.prequantized = orig
        _CACHE[key] = (out, eng.quant_report, series, arrays)
    return _CACHE[key]


def _port_engine(arrays, **kw):
    main, _, fetch = _build(pt, port_resnet)
    scope = pt.Scope()
    pt.interop.load_numpy_params(scope, arrays, "cpu")
    return ServingEngine(main, ["img"], fetch, place=pt.CPUPlace(),
                         scope=scope, buckets=BUCKETS, **kw)


def _rl2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(autouse=True)
def _fresh_counters():
    conv_cuda.COUNTERS.reset()
    quant.COUNTERS.reset()
    yield
    conv_cuda.COUNTERS.reset()
    quant.COUNTERS.reset()


def test_int8_parity_with_the_right_jax_path():
    (want, want_logits), report, (hits, fallbacks), arrays = \
        _jax_serve("int8", patched=True)
    eng = _port_engine(arrays, quantize="int8")
    got, got_logits = eng.infer({"img": _input()})
    assert got.shape == want.shape == (2, 10)
    top2 = np.sort(want, axis=1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() > 2 * SOFTMAX_ATOL
    assert np.abs(got - want).max() <= SOFTMAX_ATOL
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    assert _rl2(got_logits, want_logits) < LOGIT_RL2
    # the same admission report and the same routing, op by op
    assert eng.quant_report == report
    assert len(report["quantized"]) == 12 and not report["skipped"]
    assert {f"op={k}": v for k, v in quant.COUNTERS.hits.items()} == hits
    assert {f"op={o},reason={r}": v
            for (o, r), v in quant.COUNTERS.fallbacks.items()} == fallbacks
    assert quant.COUNTERS.hits == {"conv2d": 6, "mul": 1}
    assert quant.COUNTERS.fallbacks == {("conv2d", "kernel"): 5}
    assert conv_cuda.COUNTERS.hits == {"conv2d": 10}
    assert conv_cuda.COUNTERS.fallbacks == {("conv2d", "channels"): 1}


def test_reference_fold_fault():
    """The JAX int8 engine as it stands lies far from the f32 engine; the
    port, and the JAX path it is held to, lie close."""
    (_, f32_logits), _, _, arrays = _jax_serve(None, patched=False)
    (_, faulty), _, _, _ = _jax_serve("int8", patched=False)
    (_, right), _, _, _ = _jax_serve("int8", patched=True)
    port = _port_engine(arrays, quantize="int8").infer({"img": _input()})[1]
    assert _rl2(faulty, f32_logits) > FAULT_RL2
    assert _rl2(right, f32_logits) < PORT_RL2
    assert _rl2(port, f32_logits) < PORT_RL2
    # the port's f32 engine is the JAX package's, so the distance is to the
    # same reference
    port_f32 = _port_engine(arrays).infer({"img": _input()})[1]
    np.testing.assert_allclose(port_f32, f32_logits, rtol=1e-4, atol=1e-4)


def test_int8_filters_are_not_recomputed_per_request(monkeypatch):
    _, _, _, arrays = _jax_serve("int8", patched=True)
    eng = _port_engine(arrays, quantize="int8")
    folds = eng._prepared.folds
    # int8 values only for the six folds the quant gate admits; the five
    # below the reference's 128-channel rule keep their bf16 filter
    assert len(folds) == 11 and \
        sum(f[2] is not None for f in folds.values()) == 6
    # the raw conv filters are reported but only the fc's int8 values kept
    assert len(eng.quant_report["quantized"]) == 12
    assert sorted(eng.program._quant_weights) == ["fc_0.w_0"]
    seen, seen_pre = [], []
    orig, orig_q = quant_cuda.quantize_channelwise_reference, quant.qconv2d
    monkeypatch.setattr(quant_cuda, "quantize_channelwise_reference",
                        lambda x, axis, *a, **k: seen.append((x.dim(), axis))
                        or orig(x, axis, *a, **k))
    monkeypatch.setattr(quant, "qconv2d", lambda *a, pre=None, **k:
                        seen_pre.append(pre) or orig_q(*a, pre=pre, **k))
    first = eng.infer({"img": _input()})[0]
    second = eng.infer({"img": _input()})[0]
    np.testing.assert_array_equal(first, second)
    # only the fc's activation rows are quantized per request
    assert seen == [(2, 0), (2, 0)]
    assert len(seen_pre) == 12 and all(p is not None for p in seen_pre)


def test_padded_bucket_rows_keep_the_activation_scale():
    """Edge padding repeats the last row, so the per-tensor activation
    scale over the padded bucket is the scale over the request's rows."""
    x = torch.randn(3, 8, 4, 4).to(torch.bfloat16)
    padded = torch.cat([x, x[-1:]])
    assert torch.equal(quant.quantize_tensor(padded)[1],
                       quant.quantize_tensor(x)[1])
    _, _, _, arrays = _jax_serve("int8", patched=True)
    eng = _port_engine(arrays, quantize="int8")
    img = _input(3, seed=4)
    three = eng.infer({"img": img})[0]               # bucket 4, padded
    four = eng.infer({"img": np.concatenate([img, img[-1:]])})[0]
    assert eng.bucket_runs == {4: 2}
    np.testing.assert_array_equal(three, four[:3])


def test_o3_clone_runs_as_o2_in_both_packages():
    """Program.clone carries the AMP level but not the quant mode in both
    packages, so O3 reaches a served program only through quantize=."""
    for fluid, resnet in ((jfluid, jax_resnet), (pt, port_resnet)):
        main, _, _ = _build(fluid, resnet)
        fluid.amp.enable(main, level="O3")
        assert main._quant_mode == "int8"
        clone = main.clone(for_test=True)
        assert clone._amp_level == "O3"
        assert getattr(clone, "_quant_mode", None) is None


def test_executor_run_o3_quantizes_per_call():
    """An O3 program run through Executor.run (no engine) quantizes its
    folded filters per call, with the same answer as the engine's
    once-per-engine values. The fc weight is given the engine's
    admission-time values: quantized from the f32 weight, where a per-call
    quantization starts from its bf16 cast (as in the JAX package)."""
    _, _, _, arrays = _jax_serve("int8", patched=True)
    eng = _port_engine(arrays, quantize="int8")
    scope = pt.Scope()
    pt.interop.load_numpy_params(scope, arrays, "cpu")
    prog = eng.program.clone()
    pt.amp.enable(prog, level="O3")
    prog._quant_weights = {n: v for n, v in eng.program._quant_weights.items()
                           if n.startswith("fc")}
    direct = pt.Executor(pt.CPUPlace()).run(
        prog, feed={"img": _input()}, fetch_list=eng.fetch_names, scope=scope)
    served = eng.infer({"img": _input()})
    for a, b in zip(direct, served):
        np.testing.assert_array_equal(a, b)


def test_fp8_serving_matches_jax():
    """quantize="fp8": the fc's weight is admitted in e4m3 (the same bytes
    as the JAX engine's), the conv filters in int8 for the report only;
    the fc runs its fp8 product, every conv K1 (the fold keeps its bf16
    filter) with the quant gate's "mode" (or, below the reference's
    128-channel rule, "kernel") counted, as in the JAX engine. The answers:
    within the int8 test's bounds of the JAX engine's (the jitted engine
    scales the fc's activation rows by amax * f32(1/448), the port divides;
    measured: softmax 1e-4 apart, logits 4e-4)."""
    (want, want_logits), report, (hits, fallbacks), arrays = \
        _jax_serve("fp8", patched=False)
    eng = _port_engine(arrays, quantize="fp8")
    got, got_logits = eng.infer({"img": _input()})
    assert eng.quant_report == report
    assert len(report["quantized"]) == 12 and not report["skipped"]
    assert all(f[2] is None for f in eng._prepared.folds.values())
    assert {f"op={k}": v for k, v in quant.COUNTERS.hits.items()} == hits
    assert {f"op={o},reason={r}": v
            for (o, r), v in quant.COUNTERS.fallbacks.items()} == fallbacks
    assert quant.COUNTERS.hits == {"mul": 1}
    assert quant.COUNTERS.fallbacks == {("conv2d", "mode"): 6,
                                        ("conv2d", "kernel"): 5}
    assert eng.program._quant_weights["fc_0.w_0"][0].dtype == \
        torch.float8_e4m3fn
    assert np.abs(got - want).max() <= SOFTMAX_ATOL
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    assert _rl2(got_logits, want_logits) < LOGIT_RL2
    # near the f32 engine: fp8's own noise on one fc
    (_, f32_logits), _, _, _ = _jax_serve(None, patched=False)
    assert _rl2(got_logits, f32_logits) < PORT_RL2
