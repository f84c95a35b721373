"""The zoo's CNNs (AlexNet, GoogLeNet, SmallNet) and the eval and selective
layers the port lacked, through the port against the JAX package on the
CPU.

Each model is built in both packages by its `models` function at the
reference's own widths, on the smallest input its strides admit (AlexNet
63x63, GoogLeNet 64x64, SmallNet 32x32), and run from the same weights
(the JAX startup's persistables carried across by name): the logits, then
three SGD steps' losses. Dropout is in its inference form (is_test), since
the two packages' generators draw different masks. Tolerance rtol 1e-4 /
atol 1e-5 (the convs' sums run in another order than XLA's).
`layers.precision_recall`, `layers.positive_negative_pair` and
`layers.selective_fc` against the JAX package's layers on the same
inputs: f32 within rtol 1e-5 / atol 1e-6.
"""

import torch_threads  # noqa: F401  (the cores shared among xdist workers)
import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import executor as jax_executor
import paddle_tpu_torch as pt

from test_torch_front_end import assert_same, data, run_both

CONV = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _keep_jax_op_census():
    """The JAX executor's op census (executor._RECORDED_OPS) gets back the
    types it had before each test, as in test_torch_backward.py: these
    tests run the JAX package's ops only as an oracle, and
    tests/test_zz_op_coverage.py reads the census of its xdist worker."""
    before = set(jax_executor._RECORDED_OPS)
    yield
    jax_executor._RECORDED_OPS.intersection_update(before)

ZOO = {"alexnet": (63, 10, 0.01), "googlenet": (64, 10, 0.005),
       "smallnet_mnist_cifar": (32, 10, 0.01)}


def run_both_port_init(build, feed, steps):
    """run_both with both packages starting from the port's startup
    persistables, so the JAX package compiles only the training step (its
    startup program over a zoo net's initializers compiles as long as the
    step itself). -> (JAX fetches, port fetches), a list a step each."""
    progs = {}
    for fluid in (pt, jfluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            targets = build(fluid)
        progs[fluid] = (main, startup, targets)
    main, startup, _ = progs[pt]
    scope = pt.executor.Scope()
    pt.Executor(pt.CPUPlace()).run(startup, scope=scope)
    arrays = {n: np.asarray(scope.find_var(n))
              for n, v in startup.global_block().desc.vars.items()
              if v.persistable and scope.find_var(n) is not None}
    out = {}
    for fluid in (jfluid, pt):
        main, _, targets = progs[fluid]
        if fluid is jfluid:
            scope = jax_executor.Scope()
            for n, a in arrays.items():
                scope.set_var(n, a)
        else:
            scope = pt.executor.Scope()
            pt.interop.load_numpy_params(scope, arrays, "cpu")
        exe = fluid.Executor(fluid.CPUPlace())
        out[fluid] = [[np.asarray(v) for v in exe.run(
            main, feed=feed, fetch_list=targets, scope=scope)]
            for _ in range(steps)]
    return out[jfluid], out[pt]


@pytest.mark.parametrize("model", sorted(ZOO))
def test_cnn_logits_and_losses(model):
    size, classes, lr = ZOO[model]
    rng = np.random.RandomState(3)
    feed = {"img": rng.randn(2, 3, size, size).astype(np.float32),
            "label": rng.randint(0, classes, (2, 1)).astype(np.int64)}

    def build(fluid):
        img = fluid.layers.data(name="img", shape=[3, size, size],
                                dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        logits = getattr(fluid.models, model)(img, class_dim=classes,
                                              is_test=True)
        cost = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
            logits=logits, label=label))
        fluid.optimizer.SGD(learning_rate=lr).minimize(cost)
        return [cost, logits]
    want, got = run_both_port_init(build, feed, steps=3)
    assert_same(want, got, CONV)
    losses = [float(s[0].reshape(-1)[0]) for s in got]
    assert np.isfinite(losses).all()


def test_zoo_exports():
    for name in ("alexnet", "googlenet", "smallnet_mnist_cifar"):
        assert hasattr(pt.models, name) and name in pt.models.__all__
    assert set(jfluid.models.__all__) == set(pt.models.__all__)


def test_precision_recall_layer():
    rng = np.random.RandomState(1)
    idx = rng.randint(0, 4, (12, 1)).astype(np.int32)
    lab = rng.randint(0, 4, (12, 1)).astype(np.int32)
    wts = rng.rand(12, 1).astype(np.float32)
    states = rng.randint(0, 5, (4, 4)).astype(np.float32)

    def build(fluid):
        L = fluid.layers
        i, l = data(fluid, "i", idx), data(fluid, "l", lab)
        w = data(fluid, "w", wts, grad=False)
        s = data(fluid, "s", states, grad=False)
        return list(L.precision_recall(i, l, 4)) + \
            list(L.precision_recall(i, l, 4, weights=w, states_info=s))
    want, got = run_both(build, {"i": idx, "l": lab, "w": wts, "s": states})
    assert_same(want, got)


def test_positive_negative_pair_layer():
    rng = np.random.RandomState(2)
    score = np.round(rng.rand(10, 2) * 4).astype(np.float32) / 4
    label = rng.randint(0, 3, (10, 1)).astype(np.float32)
    query = np.array([[0], [0], [0], [1], [1], [2], [2], [2], [2], [3]],
                     np.int64)
    weight = rng.rand(10, 1).astype(np.float32)

    def build(fluid):
        L = fluid.layers
        s, l = data(fluid, "s", score, grad=False), \
            data(fluid, "l", label, grad=False)
        q, w = data(fluid, "q", query), data(fluid, "w", weight, grad=False)
        return list(L.positive_negative_pair(s, l, q)) + \
            list(L.positive_negative_pair(s, l, q, weight=w, column=0))
    want, got = run_both(build, {"s": score, "l": label, "q": query,
                                 "w": weight})
    assert_same(want, got)


def test_selective_fc_layer():
    rng = np.random.RandomState(4)
    x = rng.randn(5, 6).astype(np.float32)
    sel = (rng.rand(5, 3) > 0.5).astype(np.float32)

    def build(fluid):
        xv = data(fluid, "x", x)
        sv = data(fluid, "sel", sel, grad=False)
        out = fluid.layers.selective_fc(xv, sv, size=3, act="tanh")
        loss = fluid.layers.reduce_sum(fluid.layers.square(out))
        fluid.backward.append_backward(loss)
        return [out, "x@GRAD"]
    want, got = run_both(build, {"x": x, "sel": sel})
    assert_same(want, got)
    assert (got[0][0][sel == 0] == 0).all()
