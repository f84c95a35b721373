"""The sequence ops of the port (paddle_tpu_torch/ops/sequence_ops.py), the
masked `mean` and `softmax_with_cross_entropy`, `cos_sim` and `dropout`,
held against the JAX package on the CPU: one small program per op, built
through each package's layers DSL, fed the same numpy LoDTensors from a
seed, the JAX startup's weights carried into the port
(interop.load_numpy_params); the forward outputs (packed back by the
fetch, as the reference's LoDTensor) and the gradients of the inputs and
parameters (append_backward on the mean of the squared output) compared.

Tolerances: f32 rtol 1e-5, atol 1e-6 for pools, masks, reshapes and the
other ops without a recurrence; rtol 1e-4, atol 1e-5 for the RNNs at T <=
16 (tanh and sigmoid differ in the last ulp between the libraries, and the
recurrence carries it) and for the ops whose gradient sums a GEMM
(sequence_conv, lstm_unit, gru_unit, cos_sim: XLA and torch add the
products in another order).
"""

import torch_threads  # noqa: F401  (the cores shared among xdist workers)
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import executor as jax_executor
import paddle_tpu_torch as pt
from paddle_tpu_torch import executor as port_executor
from paddle_tpu_torch.ops import registry

TIGHT = dict(rtol=1e-5, atol=1e-6)
RNN = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _keep_jax_op_census():
    """The JAX executor's op census gets back the op types these runs added
    (as in tests/test_torch_ops.py): the op-coverage gate counts only its
    own worker's census."""
    before = set(jax_executor._RECORDED_OPS)
    yield
    jax_executor._RECORDED_OPS.intersection_update(before)


def _lod(fluid, rows, lod):
    cls = pt.LoDTensor if fluid is pt else jax_executor.LoDTensor
    return cls(rows, lod)


def _seq(rng, lens, d, dtype=np.float32):
    rows = rng.standard_normal((int(sum(lens)), d)).astype(dtype)
    return rows, [np.concatenate([[0], np.cumsum(lens)]).astype(int).tolist()]


def run_both(build, feed, grads=True):
    """`build(fluid)` -> (fetch vars, loss var or None, names whose grads to
    fetch). Runs the JAX startup, carries its persistables into the port,
    runs both mains once on `feed(fluid)`; returns (jax fetches, port
    fetches), the grads after the outputs."""
    outs = []
    arrays = None
    for fluid in (jfluid, pt):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            fetch, loss, wrt = build(fluid)
            names = [v.name for v in fetch]
            if loss is not None and grads:
                fluid.append_backward(loss)
                names += [n + "@GRAD" for n in wrt]
        exe = fluid.Executor(fluid.CPUPlace())
        if fluid is jfluid:
            scope = jax_executor.Scope()
            exe.run(startup, scope=scope)
            arrays = {n: np.asarray(scope.find_var(n))
                      for n, v in startup.global_block().desc.vars.items()
                      if v.persistable}
        else:
            scope = pt.Scope()
            pt.interop.load_numpy_params(scope, arrays, "cpu")
        outs.append(exe.run(main, feed=feed(fluid), fetch_list=names,
                            scope=scope))
    return outs


def _close(want, got, tol):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert g.shape == w.shape, (g.shape, w.shape)
        np.testing.assert_allclose(g, w, **tol)


def _sq_loss(fluid, out):
    return fluid.layers.mean(fluid.layers.square(out))


def _params(fluid, kind):
    return [p.name for p in fluid.default_main_program().global_block()
            .all_parameters()] if kind else []


# --- the RNNs -----------------------------------------------------------------

LENS = [5, 3, 7, 1]          # padded to T 8


@pytest.mark.parametrize("peep,rev", [(True, False), (False, True),
                                      (True, True)])
def test_lstm(peep, rev):
    rng = np.random.default_rng(0)
    rows, lod = _seq(rng, LENS, 16)

    def build(fluid):
        x = fluid.layers.data(name="x", shape=[16], dtype="float32",
                              lod_level=1, stop_gradient=False)
        h, c = fluid.layers.dynamic_lstm(x, size=16, use_peepholes=peep,
                                         is_reverse=rev)
        loss = fluid.layers.elementwise_add(
            _sq_loss(fluid, h), fluid.layers.mean(c))
        return [h, c], loss, ["x"] + _params(fluid, True)

    want, got = run_both(build, lambda f: {"x": _lod(f, rows, lod)})
    _close(want, got, RNN)


def test_lstm_explicit_grad_matches_autograd_of_the_port():
    """lstm_grad (BPTT from the saved Hidden and Cell) against
    torch.autograd through the port's own lstm forward (the generic grad),
    with lengths, peepholes and H0/C0."""
    rng = np.random.default_rng(1)
    b, t, h = 4, 9, 8
    ins = {"Input": [torch.tensor(rng.standard_normal((b, t, 4 * h)),
                                  dtype=torch.float32)],
           "Weight": [torch.tensor(rng.standard_normal((h, 4 * h)) * 0.3,
                                   dtype=torch.float32)],
           "Bias": [torch.tensor(rng.standard_normal((1, 7 * h)) * 0.3,
                                 dtype=torch.float32)],
           "H0": [torch.tensor(rng.standard_normal((b, h)),
                               dtype=torch.float32)],
           "C0": [torch.tensor(rng.standard_normal((b, h)),
                               dtype=torch.float32)]}
    lengths = torch.tensor([9, 4, 1, 6], dtype=torch.int32)
    for rev in (False, True):
        main = pt.Program()
        block = main.global_block()
        names = {s: s.lower() for s in ins}
        for s, n in names.items():
            block.create_var(name=n, shape=list(ins[s][0].shape),
                             dtype="float32")
        for n in ("hid", "cel"):
            block.create_var(name=n, shape=[b, t, h], dtype="float32")
        op = block.append_op(type="lstm",
                             inputs={s: [n] for s, n in names.items()},
                             outputs={"Hidden": ["hid"], "Cell": ["cel"]},
                             attrs={"use_peepholes": True, "is_reverse": rev})
        ctx = port_executor.LoweringContext(pt.Executor(pt.CPUPlace()), main,
                                            0)
        ctx.env = {"input@SEQLEN": lengths}
        fwd = registry.get("lstm").lower(ctx, op, ins)
        gdesc, = registry.make_grad_op_descs(op.desc, set())
        gop = block.append_op(type=gdesc.type, inputs=gdesc.inputs,
                              outputs=gdesc.outputs, attrs=gdesc.attrs)
        gins = {s: list(v) for s, v in ins.items()}
        gins["Hidden"], gins["Cell"] = fwd["Hidden"], fwd["Cell"]
        gins["Hidden@GRAD"] = [torch.tensor(rng.standard_normal((b, t, h)),
                                            dtype=torch.float32)]
        gins["Cell@GRAD"] = [torch.tensor(rng.standard_normal((b, t, h)),
                                          dtype=torch.float32)]
        explicit = registry.get("lstm_grad").lower(ctx, gop, gins)
        generic = registry.generic_grad_lower(ctx, gop, gins)
        for slot in ("Input@GRAD", "Weight@GRAD", "Bias@GRAD", "H0@GRAD",
                     "C0@GRAD"):
            np.testing.assert_allclose(explicit[slot][0].numpy(),
                                       generic[slot][0].numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=slot)


def test_lstmp():
    rng = np.random.default_rng(2)
    rows, lod = _seq(rng, LENS, 16)

    def build(fluid):
        x = fluid.layers.data(name="x", shape=[16], dtype="float32",
                              lod_level=1, stop_gradient=False)
        r, c = fluid.layers.dynamic_lstmp(x, size=16, proj_size=3)
        return [r, c], _sq_loss(fluid, r), ["x"] + _params(fluid, True)

    want, got = run_both(build, lambda f: {"x": _lod(f, rows, lod)})
    _close(want, got, RNN)


@pytest.mark.parametrize("rev", [False, True])
def test_gru(rev):
    rng = np.random.default_rng(3)
    rows, lod = _seq(rng, LENS, 12)

    def build(fluid):
        x = fluid.layers.data(name="x", shape=[12], dtype="float32",
                              lod_level=1, stop_gradient=False)
        h = fluid.layers.dynamic_gru(x, size=4, is_reverse=rev)
        return [h], _sq_loss(fluid, h), ["x"] + _params(fluid, True)

    want, got = run_both(build, lambda f: {"x": _lod(f, rows, lod)})
    _close(want, got, RNN)


def test_lstm_unit_and_gru_unit():
    rng = np.random.default_rng(4)
    feed = {n: rng.standard_normal((3, d)).astype(np.float32)
            for n, d in (("x", 5), ("h", 4), ("c", 4), ("g", 12))}

    def build(fluid):
        L = fluid.layers
        x, hp, cp, g = (L.data(name=n, shape=[d], dtype="float32",
                               stop_gradient=False)
                        for n, d in (("x", 5), ("h", 4), ("c", 4), ("g", 12)))
        h, c = L.lstm_unit(x, hp, cp, forget_bias=0.5)
        gh, reset, gate = L.gru_unit(g, hp, size=12)
        loss = L.elementwise_add(
            L.elementwise_add(_sq_loss(fluid, h), L.mean(c)),
            L.elementwise_add(_sq_loss(fluid, gh), L.mean(reset)))
        return [h, c, gh, reset, gate], loss, ["x", "h", "c", "g"] + \
            _params(fluid, True)

    want, got = run_both(build, lambda f: dict(feed))
    _close(want, got, RNN)


# --- pools, transforms, masks -------------------------------------------------

@pytest.mark.parametrize("pool", ["sum", "average", "sqrt", "max", "last",
                                  "first"])
def test_sequence_pool(pool):
    rng = np.random.default_rng(5)
    rows, lod = _seq(rng, [4, 1, 6, 3], 5)

    def build(fluid):
        x = fluid.layers.data(name="x", shape=[5], dtype="float32",
                              lod_level=1, stop_gradient=False)
        out = fluid.layers.sequence_pool(x, pool)
        return [out], _sq_loss(fluid, out), ["x"]

    want, got = run_both(build, lambda f: {"x": _lod(f, rows, lod)})
    _close(want, got, TIGHT)


def test_sequence_softmax_and_mask():
    rng = np.random.default_rng(6)
    rows, lod = _seq(rng, [4, 1, 6], 1)

    def build(fluid):
        x = fluid.layers.data(name="x", shape=[1], dtype="float32",
                              lod_level=1, stop_gradient=False)
        out = fluid.layers.sequence_softmax(x)
        mask = fluid.layers.sequence_mask(x)
        return [out, mask], _sq_loss(fluid, out), ["x"]

    want, got = run_both(build, lambda f: {"x": _lod(f, rows, lod)})
    _close(want, got, TIGHT)


def test_sequence_expand():
    rng = np.random.default_rng(7)
    rows, lod = _seq(rng, [3, 5, 2], 2)
    xs = rng.standard_normal((3, 4)).astype(np.float32)

    def build(fluid):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32",
                              stop_gradient=False)
        y = fluid.layers.data(name="y", shape=[2], dtype="float32",
                              lod_level=1)
        out = fluid.layers.sequence_expand(x, y)
        return [out], _sq_loss(fluid, out), ["x"]

    want, got = run_both(build, lambda f: {"x": xs, "y": _lod(f, rows, lod)})
    _close(want, got, TIGHT)


def test_sequence_conv_and_context_project():
    rng = np.random.default_rng(8)
    rows, lod = _seq(rng, [5, 2, 7], 6)

    def build(fluid):
        x = fluid.layers.data(name="x", shape=[6], dtype="float32",
                              lod_level=1, stop_gradient=False)
        conv = fluid.layers.sequence_conv(x, num_filters=4, filter_size=3,
                                          act="tanh")
        ctxp = fluid.layers.context_project(x, context_length=3)
        loss = fluid.layers.elementwise_add(_sq_loss(fluid, conv),
                                            _sq_loss(fluid, ctxp))
        return [conv, ctxp], loss, ["x"] + _params(fluid, True)

    want, got = run_both(build, lambda f: {"x": _lod(f, rows, lod)})
    _close(want, got, RNN)


def test_sequence_concat_and_reshape():
    rng = np.random.default_rng(9)
    a, alod = _seq(rng, [2, 4, 1], 4)
    b, blod = _seq(rng, [3, 1, 5], 4)

    def build(fluid):
        L = fluid.layers
        x = L.data(name="a", shape=[4], dtype="float32", lod_level=1,
                   stop_gradient=False)
        y = L.data(name="b", shape=[4], dtype="float32", lod_level=1,
                   stop_gradient=False)
        cat = L.sequence_concat([x, y])
        rs = L.sequence_reshape(x, new_dim=2)
        loss = L.elementwise_add(_sq_loss(fluid, cat), _sq_loss(fluid, rs))
        return [cat, rs], loss, ["a", "b"]

    want, got = run_both(build, lambda f: {"a": _lod(f, a, alod),
                                           "b": _lod(f, b, blod)})
    _close(want, got, TIGHT)


def test_sequence_slice_and_erase():
    rng = np.random.default_rng(10)
    rows, lod = _seq(rng, [5, 3, 7], 3)
    ids = rng.integers(0, 6, (15, 1)).astype(np.int64)
    off = np.array([[1], [0], [2]], np.int64)
    ln = np.array([[3], [2], [4]], np.int64)

    def build(fluid):
        L = fluid.layers
        x = L.data(name="x", shape=[3], dtype="float32", lod_level=1,
                   stop_gradient=False)
        w = L.data(name="w", shape=[1], dtype="int64", lod_level=1)
        o = L.data(name="off", shape=[1], dtype="int64")
        n = L.data(name="len", shape=[1], dtype="int64")
        sl = L.sequence_slice(x, o, n)
        er = L.sequence_erase(w, tokens=[2, 4])
        return [sl, er], _sq_loss(fluid, sl), ["x"]

    want, got = run_both(build, lambda f: {
        "x": _lod(f, rows, lod), "w": _lod(f, ids, lod), "off": off,
        "len": ln})
    _close(want, got, TIGHT)


def test_lod_reset():
    rng = np.random.default_rng(11)
    rows, lod = _seq(rng, [3, 4, 2], 2)
    offs = np.array([0, 2, 5, 9], np.int32)

    def build(fluid):
        L = fluid.layers
        x = L.data(name="x", shape=[2], dtype="float32", lod_level=1,
                   stop_gradient=False)
        y = L.data(name="y", shape=[4], dtype="int32",
                   append_batch_size=False)
        by_attr = L.lod_reset(x, target_lod=[0, 2, 5, 9])
        by_y = L.lod_reset(x, y=y)
        pooled = L.sequence_pool(by_attr, "sum")
        loss = L.elementwise_add(_sq_loss(fluid, pooled),
                                 L.mean(L.sequence_pool(by_y, "max")))
        return [by_attr, pooled], loss, ["x"]

    want, got = run_both(build, lambda f: {"x": _lod(f, rows, lod),
                                           "y": offs})
    _close(want, got, TIGHT)


def _nested(rng, docs, d):
    rows, outer, inner = [], [0], [0]
    for doc in docs:
        outer.append(outer[-1] + len(doc))
        for n in doc:
            rows.append(rng.standard_normal((n, d)).astype(np.float32))
            inner.append(inner[-1] + n)
    return np.concatenate(rows), [outer, inner]


def test_sequence_unfold_fold_nested():
    """Level-2 LoD (tests/test_nested_lod.py's structure): words pooled in
    each sentence, sentences in each document, through unfold and fold;
    the nested feed fetched back as a two-level LoDTensor."""
    rows, lod = _nested(np.random.default_rng(12), [[2, 3], [1], [4, 2, 1]],
                        3)

    def build(fluid):
        L = fluid.layers
        x = L.data(name="x", shape=[3], dtype="float32", lod_level=2,
                   stop_gradient=False)
        flat = L.sequence_unfold(x)
        sent = L.sequence_pool(flat, "sum")
        docs = L.sequence_fold(sent, x)
        doc = L.sequence_pool(docs, "average")
        twice = L.scale(x, scale=2.0)
        return [doc, twice], _sq_loss(fluid, doc), ["x"]

    want, got = run_both(build, lambda f: {"x": _lod(f, rows, lod)})
    _close(want, got, TIGHT)
    np.testing.assert_allclose(got[1], 2 * rows, rtol=1e-6)


# --- masked reductions and losses, cos_sim, dropout ---------------------------

def test_masked_mean_and_softmax_with_cross_entropy():
    """Over padded sequence logits [B, T, V]: the mean over the valid
    positions and the cross entropy zero at the padded ones, forward and
    explicit grads against JAX's vjp of its masked forward."""
    rng = np.random.default_rng(13)
    rows, lod = _seq(rng, [3, 6, 2], 5)
    labels = rng.integers(0, 5, (11, 1)).astype(np.int64)

    def build(fluid):
        L = fluid.layers
        x = L.data(name="x", shape=[5], dtype="float32", lod_level=1,
                   stop_gradient=False)
        lab = L.data(name="lab", shape=[1], dtype="int64", lod_level=1)
        ce = L.softmax_with_cross_entropy(x, lab)
        loss = L.mean(ce)
        return [ce, loss], loss, ["x"]

    want, got = run_both(build, lambda f: {"x": _lod(f, rows, lod),
                                           "lab": _lod(f, labels, lod)})
    _close(want, got, TIGHT)


def test_cos_sim():
    rng = np.random.default_rng(14)
    feed = {"x": rng.standard_normal((4, 6)).astype(np.float32),
            "y": rng.standard_normal((4, 6)).astype(np.float32)}

    def build(fluid):
        L = fluid.layers
        x = L.data(name="x", shape=[6], dtype="float32", stop_gradient=False)
        y = L.data(name="y", shape=[6], dtype="float32", stop_gradient=False)
        out = L.cos_sim(x, y)
        return [out], _sq_loss(fluid, out), ["x", "y"]

    want, got = run_both(build, lambda f: dict(feed))
    _close(want, got, RNN)


def test_dropout_with_one_shared_mask(monkeypatch):
    """Training dropout and its grad with the JAX lowering's bernoulli draw
    and the port's mask draw both returning one numpy mask (patched here
    only); is_test scales by 1 - p."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu_torch.ops import nn_ops
    rng = np.random.default_rng(15)
    x = rng.standard_normal((4, 10)).astype(np.float32)
    mask = (rng.random((4, 10)) < 0.7).astype(np.float32)
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.asarray(mask, bool))
    monkeypatch.setattr(nn_ops, "dropout_mask",
                        lambda ctx, op_, shape, keep, dtype, device:
                        torch.tensor(mask, dtype=dtype, device=device))

    def build(fluid, is_test=False):
        L = fluid.layers
        xv = L.data(name="x", shape=[10], dtype="float32",
                    stop_gradient=False)
        out = L.dropout(xv, dropout_prob=0.3, is_test=is_test)
        return [out], _sq_loss(fluid, out), ["x"]

    want, got = run_both(build, lambda f: {"x": x})
    _close(want, got, TIGHT)
    np.testing.assert_array_equal(got[0], x * mask)
    want, got = run_both(lambda f: build(f, True), lambda f: {"x": x},
                         grads=False)
    _close(want, got, TIGHT)
    np.testing.assert_allclose(got[0], x * (1 - 0.3), rtol=1e-6)


def test_dropout_masks_change_per_run_and_repeat_per_seed():
    """The port's own draws (no patch): step i and i+1 different masks, the
    same seed and run counter the same mask, keep share near 1 - p."""
    def masks(seed, n=3):
        main, startup = pt.Program(), pt.Program()
        with pt.unique_name.guard(), pt.program_guard(main, startup):
            x = pt.layers.data(name="x", shape=[64], dtype="float32")
            pt.layers.dropout(x, dropout_prob=0.25)
        main.random_seed = seed
        m = next(o for o in main.global_block().ops
                 if o.type == "dropout").output("Mask")[0]
        exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
        feed = {"x": np.ones((32, 64), np.float32)}
        return [exe.run(main, feed=feed, fetch_list=[m], scope=scope)[0]
                for _ in range(n)]
    a, b = masks(3), masks(3)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a[0], a[1]) and not np.array_equal(a[1], a[2])
    assert abs(np.mean(a) - 0.75) < 0.05
    assert not np.array_equal(masks(4)[0], a[0])


def test_registered_types():
    """The 18 sequence op types of the JAX package's sequence_ops.py, cos_sim,
    dropout and dropout_grad are registered in the port."""
    from paddle_tpu.ops import sequence_ops as jax_seq  # noqa: F401
    from paddle_tpu.ops import registry as jax_registry
    seq = {"lstm", "lstmp", "gru", "lstm_unit", "gru_unit", "sequence_pool",
           "sequence_softmax", "sequence_expand", "sequence_conv",
           "sequence_concat", "sequence_reshape", "sequence_slice",
           "sequence_erase", "lod_reset", "sequence_unfold", "sequence_fold",
           "context_project", "sequence_mask"}
    assert seq <= set(jax_registry.registered_ops())
    for t in seq | {"cos_sim", "dropout", "dropout_grad", "lstm_grad"}:
        assert t in registry._REGISTRY, t
