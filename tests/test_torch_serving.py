"""The serving slice as a whole on the CPU: a small ResNet served by the JAX
package's ServingEngine and by the port's, on the same weights.

The model is built from models/resnet.py blocks in both packages: a 3->128
3x3 conv_bn_layer (the stem, which the conv gate sends to the fallback),
basicblock 128->128 stride 1, basicblock 128->256 stride 2 (whose 1x1
shortcut is eligible), global average pooling, fc(10) and softmax, on a
2x3x16x16 input with is_test=True. The JAX startup's parameters, with
batch-norm statistics and scales made non-trivial so the fold matters,
are carried into the port's scope by name (interop.load_numpy_params).

Tolerances: f32 rtol 1e-4 / atol 1e-5 (both sum in f32, in another
order); AMP O2 atol 2e-2 on the bf16 softmax with equal argmax — six bf16
rounding points lie between input and output, and each package rounds
its own f32 sums.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import executor as jax_executor
from paddle_tpu.models import resnet as jax_resnet
from paddle_tpu.serving import ServingEngine as JaxServingEngine
import paddle_tpu_torch as pt
from paddle_tpu_torch.models import resnet as port_resnet
from paddle_tpu_torch.ops import conv_cuda, fusion, registry
from paddle_tpu_torch.serving import ServingEngine, bucket_ladder

BUCKETS = (1, 2, 4)


def _build(fluid, resnet, amp):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[3, 16, 16], dtype="float32")
        x = resnet.conv_bn_layer(img, 128, 3, 1, 1, is_test=True)
        x = resnet.basicblock(x, 128, 128, 1, is_test=True)
        x = resnet.basicblock(x, 128, 256, 2, is_test=True)
        x = fluid.layers.pool2d(x, pool_size=4, pool_type="avg",
                                global_pooling=True)
        prob = fluid.layers.softmax(fluid.layers.fc(x, size=10))
    if amp:
        fluid.amp.enable(main, level="O2")
    return main, startup, prob.name


def _jax_weights(main, startup):
    """Run the JAX startup; return its persistables as numpy arrays, with
    every batch_norm's scale/bias/mean/variance redrawn away from the
    identity (which also spreads the logits: the softmax is not flat)."""
    scope = jax_executor.Scope()
    with jax_executor.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
    arrays = {n: np.array(scope.find_var(n))
              for n, v in startup.global_block().desc.vars.items()
              if v.persistable}
    rng = np.random.default_rng(2)
    for op in main.global_block().ops:
        if op.type == "batch_norm":
            c = arrays[op.input("Scale")[0]].shape
            arrays[op.input("Scale")[0]] = 1 + 0.1 * rng.standard_normal(c)
            arrays[op.input("Bias")[0]] = 0.1 * rng.standard_normal(c)
            arrays[op.input("Mean")[0]] = 0.1 * rng.standard_normal(c)
            arrays[op.input("Variance")[0]] = \
                1 + 0.2 * np.abs(rng.standard_normal(c))
    arrays = {n: a.astype(np.float32) for n, a in arrays.items()}
    for n, a in arrays.items():
        scope.set_var(n, a)
    return scope, arrays


def _input(n=2, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, 3, 16, 16)).astype(np.float32)


_JAX_CACHE = {}


def _served_by_jax(amp):
    """The JAX package's answer and weights, computed once per precision
    (the O2 run goes through the Pallas interpreter)."""
    if amp not in _JAX_CACHE:
        main, startup, prob = _build(jfluid, jax_resnet, amp)
        scope, arrays = _jax_weights(main, startup)
        eng = JaxServingEngine(main, ["img"], [prob], place=jfluid.CPUPlace(),
                               scope=scope, buckets=BUCKETS)
        out = np.asarray(eng.infer({"img": _input()})[0]).astype(np.float32)
        _JAX_CACHE[amp] = (out, arrays)
    return _JAX_CACHE[amp]


def _port_engine(amp, arrays, **kw):
    main, _, prob = _build(pt, port_resnet, amp)
    scope = pt.Scope()
    pt.interop.load_numpy_params(scope, arrays, "cpu")
    return ServingEngine(main, ["img"], [prob], place=pt.CPUPlace(),
                         scope=scope, buckets=BUCKETS, **kw)


@pytest.fixture(autouse=True)
def _fresh_counters():
    conv_cuda.COUNTERS.reset()
    yield
    conv_cuda.COUNTERS.reset()


def test_names_match_so_weights_carry_across():
    jmain, jstartup, _ = _build(jfluid, jax_resnet, False)
    tmain, tstartup, _ = _build(pt, port_resnet, False)
    names = lambda p: sorted(n for n, v in p.global_block().desc.vars.items()
                             if v.persistable)
    assert names(tstartup) == names(jstartup)
    assert names(tmain) == names(jmain)


def test_f32_parity_with_jax_serving():
    want, arrays = _served_by_jax(False)
    got = _port_engine(False, arrays).infer({"img": _input()})[0]
    assert got.dtype == np.float32 and got.shape == (2, 10)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    # f32 convs fail the gate on dtype: all six go to F.conv2d
    assert conv_cuda.COUNTERS.fallbacks == {("conv2d", "dtype"): 6}


def test_amp_o2_parity_with_jax_serving():
    want, arrays = _served_by_jax(True)
    got = _port_engine(True, arrays).infer({"img": _input()})[0]
    # a softmax that is not flat, with top-1 margins well past the
    # tolerance, so that equal argmax is a real check
    top2 = np.sort(want, axis=1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() > 0.1
    assert np.abs(got - want).max() <= 2e-2
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    # the stem (Ci=3) falls back; the five 128/256-channel convs take K1,
    # which on CPU tensors is its plain version: no kernel launch
    assert conv_cuda.COUNTERS.fallbacks == {("conv2d", "channels"): 1}
    assert conv_cuda.COUNTERS.hits == {"conv2d": 5}
    assert conv_cuda.COUNTERS.launches == 0


def test_fold_runs_and_batch_norm_never_does(monkeypatch):
    _, arrays = _served_by_jax(True)
    eng = _port_engine(True, arrays)
    # the conv windows (the plan also holds fc_act and chain windows)
    groups = {a: g for a, g in eng._prepared.groups.items()
              if g.kind == "conv_bn_act"}
    assert len(groups) == 6 and all(g.fold for g in groups.values())
    calls = []
    bn = registry.get("batch_norm")
    monkeypatch.setattr(bn, "lower",
                        lambda *a: calls.append(1) or
                        pytest.fail("batch_norm ran unfolded"))
    eng.infer({"img": _input()})
    assert calls == []


def test_folded_filters_are_stored_ohwi():
    """The fold stores each bf16 filter as an OIHW view of OHWI memory,
    the layout K1 reads in place: a served request copies no filter."""
    _, arrays = _served_by_jax(True)
    eng = _port_engine(True, arrays)
    folds = eng._prepared.folds
    assert len(folds) == 6
    for wf, _, _ in folds.values():
        assert wf.dtype == torch.bfloat16
        assert wf.permute(0, 2, 3, 1).is_contiguous()


def test_fetched_conv_output_is_not_elided():
    _, arrays = _served_by_jax(False)
    main, startup, prob = _build(pt, port_resnet, False)
    conv_out = next(op for op in main.global_block().ops
                    if op.type == "conv2d").output("Output")[0]
    scope = pt.Scope()
    pt.interop.load_numpy_params(scope, arrays, "cpu")
    exe = pt.Executor(pt.CPUPlace())
    test_prog = main.clone(for_test=True)
    p, c = exe.run(test_prog, feed={"img": _input()},
                   fetch_list=[prob, conv_out], scope=scope)
    assert c.shape == (2, 128, 16, 16)
    (p_only,) = exe.run(test_prog, feed={"img": _input()}, fetch_list=[prob],
                        scope=scope)
    np.testing.assert_allclose(p, p_only, rtol=1e-5, atol=1e-6)


def test_padded_bucket_rows_match_unpadded_run():
    _, arrays = _served_by_jax(True)
    eng = _port_engine(True, arrays)
    x = _input(3, seed=1)
    padded = eng.infer({"img": x})[0]          # 3 rows padded into bucket 4
    assert eng.bucket_runs == {4: 1}
    alone = np.concatenate([eng.infer({"img": x[i:i + 1]})[0]
                            for i in range(3)])
    np.testing.assert_allclose(padded, alone, rtol=0, atol=1e-6)
    assert eng.bucket_runs == {4: 1, 1: 3}
    assert eng.cache_misses == 2 and eng.cache_hits == 2


def test_executor_run_matches_serving():
    _, arrays = _served_by_jax(False)
    eng = _port_engine(False, arrays)
    scope = pt.Scope()
    pt.interop.load_numpy_params(scope, arrays, "cpu")
    (direct,) = pt.Executor(pt.CPUPlace()).run(
        eng.program, feed={"img": _input()}, fetch_list=eng.fetch_names,
        scope=scope)
    np.testing.assert_array_equal(eng.infer({"img": _input()})[0], direct)


def test_infer_chunks_past_the_top_bucket():
    _, arrays = _served_by_jax(False)
    eng = _port_engine(False, arrays)
    x = _input(6, seed=2)
    out = eng.infer({"img": x})[0]
    assert out.shape == (6, 10)
    assert eng.bucket_runs == {4: 1, 2: 1}     # rows 0-3, then 4-5
    np.testing.assert_allclose(out[4:], eng.infer({"img": x[4:]})[0],
                               rtol=1e-5, atol=1e-6)


def test_startup_on_cpu_is_seeded_and_repeatable():
    outs = []
    for _ in range(2):
        main, startup, prob = _build(pt, port_resnet, False)
        scope = pt.Scope()
        pt.Executor(pt.CPUPlace()).run(startup, scope=scope)
        outs.append({n: scope.find_var(n).clone() for n in scope.vars
                     if not n.startswith("__")})
    assert outs[0].keys() == outs[1].keys()
    for n in outs[0]:
        assert torch.equal(outs[0][n], outs[1][n]), n
    w = outs[0]["conv2d_0.w_0"]
    assert w.shape == (128, 3, 3, 3) and 0.05 < float(w.std()) < 0.4


def test_engine_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main, _, prob = _build(pt, port_resnet, False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(main, ["img"], [prob], scope=pt.Scope())


def test_later_slices_raise():
    """fp8 serving (tests/test_torch_quant_serving.py) and the embedding
    cache (tests/test_torch_emb_cache.py) are ported; an unknown mode is
    refused, and a cache asked for a table the program does not look up
    caches nothing, as the reference's enable_serving."""
    main, startup, prob = _build(pt, port_resnet, False)
    with pytest.raises(ValueError, match="quantize"):
        ServingEngine(main, ["img"], [prob], place=pt.CPUPlace(),
                      quantize="int4")
    scope = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(startup, scope=scope)
    engine = ServingEngine(main, ["img"], [prob], place=pt.CPUPlace(),
                           scope=scope, emb_cache_tables={"t": 4})
    assert "emb_cache" not in engine.stats()


def test_admission_refuses_training_ops():
    main, _, prob = _build(pt, port_resnet, False)
    sm = next(op for op in main.global_block().ops if op.type == "softmax")
    sm.set_attr("op_role", "optimize")     # its output is then uncomputable
    with pytest.raises(ValueError, match="not computable"):
        ServingEngine(main, ["img"], [prob], place=pt.CPUPlace(),
                      scope=pt.Scope())
    assert bucket_ladder(6) == (1, 2, 4, 6)


def test_missing_weights_are_reported():
    main, _, prob = _build(pt, port_resnet, False)
    with pytest.raises(RuntimeError, match="run the startup program first"):
        ServingEngine(main, ["img"], [prob], place=pt.CPUPlace(),
                      scope=pt.Scope())


def test_fusion_plan_matches_every_conv_bn_window():
    main, _, _ = _build(pt, port_resnet, True)
    groups = fusion.plan(main.clone(for_test=True))
    acts = [g.act.type if g.act else "" for g in groups.values()
            if g.kind == "conv_bn_act"]
    # stem and each block's first conv end in relu; the second convs and
    # the shortcut conv feed an elementwise_add instead
    assert sorted(acts) == ["", "", "", "relu", "relu", "relu"]
