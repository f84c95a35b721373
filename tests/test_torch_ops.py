"""Lowerings of the port (paddle_tpu_torch/ops) held against the JAX
package's Executor on the CPU, in float32, on the same feeds and weights.

Two kinds of program: small op mixes built through each package's layers
DSL (reductions, elementwise with axis broadcast and `act`, scale,
activations, softmax), and the classification head of models/common.py
(softmax_with_cross_entropy, mean, top_k, accuracy) over resnet_cifar10
with batch_norm in training mode, whose running statistics both packages
write back to their scopes. Both sum in f32 in their own order: rtol 1e-4,
atol 1e-5.
"""

import torch_threads  # noqa: F401  (the cores shared among xdist workers)
import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import executor as jax_executor
from paddle_tpu.models import common as jax_common
from paddle_tpu.models import resnet as jax_resnet
import paddle_tpu_torch as pt
from paddle_tpu_torch.models import common as port_common
from paddle_tpu_torch.models import resnet as port_resnet

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _keep_jax_op_census():
    """The JAX executor's op census (executor._RECORDED_OPS) gets back the
    op types these runs added, as in tests/test_torch_backward.py: the
    op-coverage gate counts only its own worker's census (ROADMAP.md
    Queue 3), and parity runs must not push a worker over its line."""
    before = set(jax_executor._RECORDED_OPS)
    yield
    jax_executor._RECORDED_OPS.intersection_update(before)


def _reduces(fluid):
    x = fluid.layers.data(name="x", shape=[3, 4, 5], dtype="float32")
    L = fluid.layers
    return [L.reduce_sum(x, dim=1), L.reduce_mean(x, dim=[1, 2], keep_dim=True),
            L.reduce_max(x, dim=-1), L.reduce_min(x), L.reduce_prod(x, dim=2)]


def _elementwise(fluid):
    x = fluid.layers.data(name="x", shape=[3, 4, 5], dtype="float32")
    L = fluid.layers
    y = L.reduce_mean(x, dim=[0, 2, 3])        # [3]: broadcast at axis 1
    out = L.elementwise_add(x, y, axis=1, act="relu")
    out = L.elementwise_mul(out, L.scale(x, scale=0.5, bias=1.0))
    out = L.elementwise_sub(out, L.reduce_max(x, dim=-1, keep_dim=True))
    return [out, L.tanh(out), L.sigmoid(x), L.softmax(out)]


def _run_both(model, feed):
    """Build `model` in both packages, run each package's startup and main
    once on `feed`; return both fetch lists."""
    outs = []
    for fluid in (jfluid, pt):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            fetch = model(fluid)
        exe = fluid.Executor(fluid.CPUPlace())
        scope = fluid.Scope() if fluid is pt else jax_executor.Scope()
        exe.run(startup, scope=scope)
        outs.append(exe.run(main, feed=feed, fetch_list=fetch, scope=scope))
    return outs


@pytest.mark.parametrize("model", [_reduces, _elementwise],
                         ids=["reduce", "elementwise"])
def test_op_mix_matches_jax(model):
    x = np.random.default_rng(0).standard_normal((2, 3, 4, 5)) \
        .astype(np.float32)
    want, got = _run_both(model, {"x": x})
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=RTOL, atol=ATOL)


def _classifier(fluid, resnet, common):
    img = fluid.layers.data(name="img", shape=[3, 32, 32], dtype="float32")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    return common.build_image_classifier(resnet.resnet_cifar10, img, label,
                                         class_dim=10, depth=8)


def test_classifier_head_and_training_batch_norm_match_jax():
    rng = np.random.default_rng(1)
    feed = {"img": rng.standard_normal((4, 3, 32, 32)).astype(np.float32),
            "label": rng.integers(0, 10, (4, 1)).astype(np.int64)}

    jmain, jstartup = jfluid.Program(), jfluid.Program()
    with jfluid.unique_name.guard(), jfluid.program_guard(jmain, jstartup):
        jfetch = _classifier(jfluid, jax_resnet, jax_common)
    jscope = jax_executor.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    arrays = {n: np.asarray(jscope.find_var(n)).astype(np.float32)
              for n, v in jstartup.global_block().desc.vars.items()
              if v.persistable}

    tmain, tstartup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(tmain, tstartup):
        tfetch = _classifier(pt, port_resnet, port_common)
    tscope = pt.Scope()
    pt.interop.load_numpy_params(tscope, arrays, "cpu")

    want = jexe.run(jmain, feed=feed, fetch_list=list(jfetch), scope=jscope)
    got = pt.Executor(pt.CPUPlace()).run(tmain, feed=feed,
                                         fetch_list=list(tfetch), scope=tscope)
    (jcost, jpred, jacc), (tcost, tpred, tacc) = want, got
    np.testing.assert_allclose(tpred, np.asarray(jpred), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tcost, np.asarray(jcost), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(tacc, np.asarray(jacc))
    # training-mode batch_norm moved every running mean/variance the same way
    stats = [n for op in tmain.global_block().ops if op.type == "batch_norm"
             for n in op.input("Mean") + op.input("Variance")]
    assert len(stats) == 2 * 9              # stem, 2 + 3 + 3 in the blocks
    for n in stats:
        moved = tscope.find_var(n).numpy()
        assert not np.array_equal(moved, arrays[n]), n
        np.testing.assert_allclose(moved, np.asarray(jscope.find_var(n)),
                                   rtol=RTOL, atol=ATOL, err_msg=n)
