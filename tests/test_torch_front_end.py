"""The training front end through the port against the JAX package on the
CPU: every op type of the tensor, math, loss and misc families (forward,
and the input grads of a sum-of-squares loss where the op has a grad),
the Variable operators, the six learning-rate schedules over steps 1..N,
the step counter, the three gradient clips and ErrorClipByValue, L1
decay and the order clip -> regularization -> optimizer, calc_gradient,
the global-norm gauge, the save/load ops across packages (and their gate
reason on a CUDA place), the mq2007 surrogate and WeightedAverage, and the
op census.

Each case builds the same script in both packages, runs it on the same
numpy inputs from a seed, and holds the port to the JAX package's
results: f32 within rtol 1e-5 / atol 1e-6, integers and booleans exact.
The random ops draw from different generators in the two packages, so
their draws are held to their distribution and shape, not to the JAX
package's numbers.
"""

import torch_threads  # noqa: F401  (the cores shared among xdist workers)
import os
import pickle

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import executor as jax_executor
from paddle_tpu import telemetry as jax_telemetry
from paddle_tpu.ops import registry as jax_registry
import paddle_tpu_torch as pt
from paddle_tpu_torch import executor as pt_executor
from paddle_tpu_torch import telemetry as pt_telemetry
from paddle_tpu_torch.ops import nn_ops as pt_nn_ops
from paddle_tpu_torch.ops import registry as pt_registry

F32 = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _keep_jax_op_census():
    before = set(jax_executor._RECORDED_OPS)
    yield
    jax_executor._RECORDED_OPS.intersection_update(before)


def _ex(fluid):
    return pt_executor if fluid is pt else jax_executor


def data(fluid, name, arr, grad=True):
    """A feed variable of `arr`'s shape and dtype; a float one takes
    gradients when `grad`."""
    arr = np.asarray(arr)
    is_float = arr.dtype.kind == "f"
    return fluid.layers.data(name=name, shape=list(arr.shape),
                             dtype=str(arr.dtype), append_batch_size=False,
                             stop_gradient=not (grad and is_float))


def raw(fluid, type, inputs, outs, attrs=None, dtypes=None):
    """Append op `type` with fresh output variables, one a slot -> {slot:
    var} (for the ops no layer builds)."""
    block = fluid.default_main_program().current_block()
    made = {s: block.create_var(
        name=fluid.unique_name.generate(f"{type}.{s.lower()}"),
        dtype=(dtypes or {}).get(s, "float32")) for s in outs}
    block.append_op(type=type,
                    inputs={k: v if isinstance(v, list) else [v]
                            for k, v in inputs.items()},
                    outputs={s: [v] for s, v in made.items()},
                    attrs=attrs or {})
    return made


def run_both(build, feeds, steps=1, startup_arrays=None):
    """`build(fluid)` -> fetch list, in fresh programs of each package, run
    `steps` times on `feeds` (one dict, or a list a step); the port
    starts from the JAX startup's persistables. -> (JAX fetches, port
    fetches), a list a step each."""
    out, arrays = {}, None
    feeds = feeds if isinstance(feeds, list) else [feeds] * steps
    for fluid in (jfluid, pt):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            targets = build(fluid)
        scope = _ex(fluid).Scope()
        exe = fluid.Executor(fluid.CPUPlace())
        if fluid is jfluid:
            exe.run(startup, scope=scope)
            arrays = {n: np.asarray(scope.find_var(n))
                      for n, v in startup.global_block().desc.vars.items()
                      if v.persistable and scope.find_var(n) is not None}
        else:
            pt.interop.load_numpy_params(scope, arrays, "cpu")
        out[fluid] = [[np.asarray(v) for v in exe.run(
            main, feed=f, fetch_list=targets, scope=scope)] for f in feeds]
    return out[jfluid], out[pt]


def assert_same(want, got, tol=F32):
    assert len(want) == len(got)
    for w_step, g_step in zip(want, got):
        assert len(w_step) == len(g_step)
        for w, g in zip(w_step, g_step):
            w, g = np.asarray(w), np.asarray(g)
            assert w.shape == g.shape, (w.shape, g.shape)
            if np.issubdtype(w.dtype, np.floating):
                np.testing.assert_allclose(g, w, **tol)
            else:
                np.testing.assert_array_equal(g.astype(np.int64),
                                              w.astype(np.int64))


def with_grads(fluid, outs, wrt):
    """outs + the grads of sum_i sum(outs_i^2) with respect to `wrt`."""
    L = fluid.layers
    parts = [L.reduce_sum(L.square(o)) for o in outs]
    loss = parts[0] if len(parts) == 1 else L.sums(parts)
    fluid.backward.append_backward(loss)
    return list(outs) + [v.name + "@GRAD" for v in wrt]


RNG = np.random.RandomState(7)


def f32(*shape, lo=None, hi=None):
    if lo is not None:
        return RNG.uniform(lo, hi, shape).astype(np.float32)
    return RNG.randn(*shape).astype(np.float32)


# --- the op families: (name, build(fluid, feed) -> fetch list, feed) -------
# Each case declares its feeds through `data`, so the grads of the float
# inputs it lists come back after its outputs.

def _unary(layer, feed, grad=True, **kw):
    def build(fluid):
        x = data(fluid, "x", feed["x"])
        out = getattr(fluid.layers, layer)(x, **kw)
        return with_grads(fluid, [out], [x]) if grad else [out]
    return build


def _case_clip(fluid):
    x = data(fluid, "x", FEEDS["clip"]["x"])
    return with_grads(fluid, [fluid.layers.clip(x, -0.3, 0.4)], [x])


def _case_clip_by_norm(fluid):
    x = data(fluid, "x", FEEDS["clip_by_norm"]["x"])
    y = data(fluid, "y", FEEDS["clip_by_norm"]["y"])
    L = fluid.layers
    return with_grads(fluid, [L.clip_by_norm(x, 1.0),
                              L.clip_by_norm(y, 100.0)], [x, y])


def _case_split(fluid):
    x = data(fluid, "x", FEEDS["split"]["x"])
    a = fluid.layers.split(x, 3, dim=1)
    b = fluid.layers.split(x, [1, 3], dim=0)
    return with_grads(fluid, a + b, [x])


def _case_gather(fluid):
    f = FEEDS["gather"]
    x, i = data(fluid, "x", f["x"]), data(fluid, "i", f["i"])
    return with_grads(fluid, [fluid.layers.gather(x, i)], [x])


def _case_scatter(fluid):
    f = FEEDS["scatter"]
    x, i, u = (data(fluid, "x", f["x"]), data(fluid, "i", f["i"]),
               data(fluid, "u", f["u"]))
    return with_grads(fluid, [fluid.layers.scatter(x, i, u)], [x, u])


def _case_one_hot(fluid):
    i = data(fluid, "i", FEEDS["one_hot"]["i"])
    return [fluid.layers.one_hot(i, depth=6)]


def _case_multiplex(fluid):
    f = FEEDS["multiplex"]
    xs = [data(fluid, f"x{k}", f[f"x{k}"]) for k in range(3)]
    ids = data(fluid, "ids", f["ids"])
    return with_grads(fluid, [fluid.layers.multiplex(xs, ids)], xs)


def _case_mul(fluid):
    f = FEEDS["mul"]
    x, y = data(fluid, "x", f["x"]), data(fluid, "y", f["y"])
    return with_grads(fluid, [fluid.layers.mul(x, y, x_num_col_dims=2)],
                      [x, y])


def _case_fill(fluid):
    return [raw(fluid, "fill", {}, ["Out"],
                {"shape": [2, 3], "dtype": "float32",
                 "value": [0.5, -1.0, 2.0, 3.25, 0.0, 7.0]})["Out"]]


def _case_minus(fluid):
    f = FEEDS["minus"]
    x, y = data(fluid, "x", f["x"]), data(fluid, "y", f["y"])
    return with_grads(fluid, [raw(fluid, "minus", {"X": x, "Y": y},
                                  ["Out"])["Out"]], [x, y])


def _case_modified_huber(fluid):
    f = FEEDS["modified_huber_loss"]
    x, y = data(fluid, "x", f["x"]), data(fluid, "y", f["y"], grad=False)
    o = raw(fluid, "modified_huber_loss", {"X": x, "Y": y},
            ["IntermediateVal", "Out"])
    return with_grads(fluid, [o["Out"]], [x]) + [o["IntermediateVal"]]


def _case_l1_norm(fluid):
    x = data(fluid, "x", FEEDS["l1_norm"]["x"])
    return with_grads(fluid, [fluid.layers.l1_norm(x)], [x])


def _case_bilinear(fluid):
    f = FEEDS["bilinear_tensor_product"]
    x, y, w, b = (data(fluid, n, f[n]) for n in ("x", "y", "w", "b"))
    out = raw(fluid, "bilinear_tensor_product",
              {"X": x, "Y": y, "Weight": w, "Bias": b}, ["Out"])["Out"]
    return with_grads(fluid, [out], [x, y, w, b])


def _case_cumsum(fluid):
    x = data(fluid, "x", FEEDS["cumsum"]["x"])
    L = fluid.layers
    outs = [L.cumsum(x, axis=1, exclusive=e, reverse=r)
            for e in (False, True) for r in (False, True)]
    outs.append(L.cumsum(x, axis=0))
    return with_grads(fluid, outs, [x])


def _case_norm(fluid):
    x = data(fluid, "x", FEEDS["norm"]["x"])
    return with_grads(fluid, [fluid.layers.l2_normalize(x, axis=1)], [x])


def _case_sigmoid_ce(fluid):
    f = FEEDS["sigmoid_cross_entropy_with_logits"]
    x, z = data(fluid, "x", f["x"]), data(fluid, "z", f["z"], grad=False)
    return with_grads(
        fluid, [fluid.layers.sigmoid_cross_entropy_with_logits(x, z)], [x])


def _case_smooth_l1(fluid):
    f = FEEDS["smooth_l1_loss"]
    x, y = data(fluid, "x", f["x"]), data(fluid, "y", f["y"], grad=False)
    iw = data(fluid, "iw", f["iw"], grad=False)
    ow = data(fluid, "ow", f["ow"], grad=False)
    L = fluid.layers
    return with_grads(fluid, [L.smooth_l1(x, y, iw, ow, sigma=2.0),
                              L.smooth_l1(x, y)], [x])


def _case_log_loss(fluid):
    f = FEEDS["log_loss"]
    p, y = data(fluid, "p", f["p"]), data(fluid, "y", f["y"], grad=False)
    return with_grads(fluid, [fluid.layers.log_loss(p, y)], [p])


def _loss_op(type, ins, outs, attrs=None, grad_of=()):
    def build(fluid):
        f = FEEDS[type]
        vs = {slot: data(fluid, name, f[name], grad=name in grad_of)
              for slot, name in ins.items()}
        o = raw(fluid, type, vs, outs, attrs)
        return with_grads(fluid, [o[outs[0]]],
                          [vs[s] for s, n in ins.items() if n in grad_of]) \
            + [o[s] for s in outs[1:]]
    return build


def _case_label_smooth(fluid):
    f = FEEDS["label_smooth"]
    x = data(fluid, "x", f["x"])
    prior = data(fluid, "prior", f["prior"], grad=False)
    L = fluid.layers
    return with_grads(fluid, [L.label_smooth(x, epsilon=0.1),
                              L.label_smooth(x, prior, epsilon=0.2)], [x])


def _case_auc(fluid):
    f = FEEDS["auc"]
    p, y = data(fluid, "p", f["p"], grad=False), data(fluid, "y", f["y"])
    L = fluid.layers
    return [L.auc(p, y, num_thresholds=11), L.auc(p, y, num_thresholds=200),
            L.auc(p, y, num_thresholds=7)]


# scores that lie exactly on thresholds of 11 and 7 buckets, and on the
# f32 quotients i / 6 one ulp away from some of them, and others between
_AUC_SCORES = np.concatenate([
    pt_nn_ops.auc_thresholds(11), pt_nn_ops.auc_thresholds(7),
    np.arange(7, dtype=np.float32) / np.float32(6),
    RNG.uniform(0, 1, 14).astype(np.float32)])

FEEDS = {
    "sign": {"x": np.array([[-2.0, 0.0, 3.0], [1e-8, -0.0, -5.0]],
                           np.float32)},
    "clip": {"x": f32(4, 5)},
    "clip_by_norm": {"x": f32(4, 5), "y": f32(3, 2)},
    "reverse": {"x": f32(3, 4, 2)},
    "split": {"x": f32(4, 6)},
    "expand": {"x": f32(2, 3)},
    "squeeze": {"x": f32(3, 1, 4)},
    "unsqueeze": {"x": f32(3, 4)},
    "gather": {"x": f32(5, 3), "i": np.array([4, 0, 2, 0], np.int32)},
    "scatter": {"x": f32(5, 3), "i": np.array([1, 3], np.int64),
                "u": f32(2, 3)},
    "one_hot": {"i": np.array([[3], [0], [5], [-1], [6]], np.int64)},
    "multiplex": {"x0": f32(4, 5), "x1": f32(4, 5), "x2": f32(4, 5),
                  "ids": np.array([[2], [0], [1], [2]], np.int32)},
    "mul": {"x": f32(2, 3, 4), "y": f32(4, 5)},
    "fill": {},
    "minus": {"x": f32(3, 4), "y": f32(3, 4)},
    "modified_huber_loss": {
        "x": np.array([[-2.5], [-0.4], [0.3], [1.7], [0.8], [-1.6]],
                      np.float32),
        "y": np.array([[1], [0], [1], [0], [0], [1]], np.float32)},
    "l1_norm": {"x": f32(3, 4)},
    "bilinear_tensor_product": {"x": f32(3, 4), "y": f32(3, 5),
                                "w": f32(2, 4, 5), "b": f32(1, 2)},
    "cumsum": {"x": f32(3, 5)},
    "norm": {"x": f32(3, 5)},
    "sigmoid_cross_entropy_with_logits": {"x": f32(4, 3),
                                          "z": f32(4, 3, lo=0, hi=1)},
    "smooth_l1_loss": {"x": f32(4, 3), "y": f32(4, 3),
                       "iw": f32(4, 3, lo=0.5, hi=1.5),
                       "ow": f32(4, 3, lo=0.5, hi=1.5)},
    "log_loss": {"p": f32(6, 1, lo=0.05, hi=0.95),
                 "y": np.array([[0], [1], [1], [0], [1], [0]], np.float32)},
    "hinge_loss": {"logits": np.array([[0.4], [-2.0], [1.5], [0.2]],
                                      np.float32),
                   "labels": np.array([[1], [0], [0], [1]], np.float32)},
    "huber_loss": {"x": f32(5, 1), "y": f32(5, 1) * 3},
    "rank_loss": {"label": np.array([[1], [0], [1]], np.float32),
                  "left": f32(3, 1), "right": f32(3, 1)},
    "margin_rank_loss": {"label": np.array([[1], [-1], [1], [-1]],
                                           np.float32),
                         "x1": f32(4, 1), "x2": f32(4, 1)},
    "squared_l2_norm": {"x": f32(3, 4)},
    "squared_l2_distance": {"x": f32(4, 3), "y": f32(4, 3)},
    "label_smooth": {"x": np.eye(5, dtype=np.float32)[[1, 3, 0, 4]],
                     "prior": f32(1, 5, lo=0, hi=0.4)},
    "auc": {"p": np.stack([1 - _AUC_SCORES, _AUC_SCORES], axis=1),
            "y": (np.arange(len(_AUC_SCORES)) % 3 != 0).astype(
                np.int64).reshape(-1, 1)},
}

CASES = {
    "sign": _unary("sign", FEEDS["sign"], grad=False),
    "clip": _case_clip,
    "clip_by_norm": _case_clip_by_norm,
    "reverse": _unary("reverse", FEEDS["reverse"], axis=[0, 2]),
    "split": _case_split,
    "expand": _unary("expand", FEEDS["expand"], expand_times=[2, 3]),
    "squeeze": _unary("squeeze", FEEDS["squeeze"], axes=[1]),
    "unsqueeze": _unary("unsqueeze", FEEDS["unsqueeze"], axes=[0, 2]),
    "gather": _case_gather,
    "scatter": _case_scatter,
    "one_hot": _case_one_hot,
    "multiplex": _case_multiplex,
    "mul": _case_mul,
    "fill": _case_fill,
    "minus": _case_minus,
    "modified_huber_loss": _case_modified_huber,
    "l1_norm": _case_l1_norm,
    "bilinear_tensor_product": _case_bilinear,
    "cumsum": _case_cumsum,
    "norm": _case_norm,
    "sigmoid_cross_entropy_with_logits": _case_sigmoid_ce,
    "smooth_l1_loss": _case_smooth_l1,
    "log_loss": _case_log_loss,
    "hinge_loss": _loss_op("hinge_loss", {"Logits": "logits",
                                          "Labels": "labels"}, ["Loss"],
                           grad_of=("logits",)),
    "huber_loss": _loss_op("huber_loss", {"X": "x", "Y": "y"},
                           ["Out", "Residual"], {"delta": 1.0},
                           grad_of=("x",)),
    "rank_loss": _loss_op("rank_loss", {"Label": "label", "Left": "left",
                                        "Right": "right"}, ["Out"],
                          grad_of=("left", "right")),
    "margin_rank_loss": _loss_op("margin_rank_loss",
                                 {"Label": "label", "X1": "x1", "X2": "x2"},
                                 ["Out", "Activated"], {"margin": 0.1},
                                 grad_of=("x1", "x2")),
    "squared_l2_norm": _loss_op("squared_l2_norm", {"X": "x"}, ["Out"],
                                grad_of=("x",)),
    "squared_l2_distance": _loss_op("squared_l2_distance",
                                    {"X": "x", "Y": "y"},
                                    ["Out", "sub_result"],
                                    grad_of=("x", "y")),
    "label_smooth": _case_label_smooth,
    "auc": _case_auc,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_forward_and_grad(name):
    want, got = run_both(CASES[name], FEEDS[name])
    assert_same(want, got)


def test_auc_thresholds_are_jnp_linspace_bitwise():
    import jax.numpy as jnp
    for n in list(range(2, 300)) + [4097]:
        want = np.asarray(jnp.linspace(0.0, 1.0, n))
        got = pt_nn_ops.auc_thresholds(n)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


@pytest.mark.parametrize("op_type", ["uniform_random_batch_size_like",
                                     "gaussian_random_batch_size_like"])
def test_batch_size_like_randoms(op_type):
    """The shape takes the input's batch at run time; the draws follow the
    op's distribution, repeat for the same run counter and differ for
    the next."""
    feed = {"x": f32(64, 3)}

    def build(fluid):
        x = data(fluid, "x", feed["x"], grad=False)
        kw = dict(min=-2.0, max=3.0) if op_type.startswith("uniform") \
            else dict(mean=1.0, std=2.0)
        return [getattr(fluid.layers, op_type)(x, shape=[-1, 300], **kw)]

    want, got = run_both(build, feed)
    assert want[0][0].shape == got[0][0].shape == (64, 300)
    for v in (want[0][0], got[0][0]):
        if op_type.startswith("uniform"):
            assert v.min() >= -2.0 and v.max() < 3.0
            assert abs(v.mean() - 0.5) < 0.05
        else:
            assert abs(v.mean() - 1.0) < 0.05 and abs(v.std() - 2.0) < 0.05
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        out, = build(pt)
    exe = pt.Executor(pt.CPUPlace())
    s1, s2 = pt.Scope(), pt.Scope()
    a, = exe.run(main, feed=feed, fetch_list=[out], scope=s1)
    b, = exe.run(main, feed=feed, fetch_list=[out], scope=s2)
    c, = exe.run(main, feed=feed, fetch_list=[out], scope=s1)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert op_type in pt_executor.RANDOM_OPS


# --- Variable operators (layers/math_op_patch.py) ------------------------------

def test_variable_operators():
    feed = {"a": f32(3, 4, lo=0.5, hi=2.0), "b": f32(3, 4, lo=0.5, hi=2.0)}

    def build(fluid):
        a, b = data(fluid, "a", feed["a"]), data(fluid, "b", feed["b"])
        outs = [a + b, a - b, a * b, a / b, a ** b, a + 2.0, 2.0 + a,
                a - 1.5, 1.5 - a, a * 3.0, 3.0 * a, a / 4.0, 4.0 / a,
                a ** 0.5, 2.0 ** a, -a]
        cmps = [a < b, a <= b, a > b, a >= b]
        return with_grads(fluid, outs, [a, b]) + cmps

    want, got = run_both(build, feed)
    assert_same(want, got)


# --- the step counter and the LR schedules ------------------------------------

STEPS = 12


def _schedules(L):
    return [
        L.exponential_decay(0.1, 3, 0.5),
        L.exponential_decay(0.1, 3, 0.5, staircase=True),
        L.natural_exp_decay(0.1, 4, 0.3),
        L.natural_exp_decay(0.1, 4, 0.3, staircase=True),
        L.inverse_time_decay(0.1, 2, 0.7),
        L.inverse_time_decay(0.1, 2, 0.7, staircase=True),
        L.polynomial_decay(0.1, 5, end_learning_rate=0.01, power=2.0),
        L.polynomial_decay(0.1, 5, end_learning_rate=0.01, power=1.0,
                           cycle=True),
        L.piecewise_decay([3, 7], [0.1, 0.05, 0.01]),
        L.noam_decay(d_model=64, warmup_steps=5),
    ]


def _closed_forms(step):
    import math
    s = float(step)
    poly_cycle = 5 * max(1.0, math.ceil(s / 5))
    return [0.1 * 0.5 ** (s / 3), 0.1 * 0.5 ** math.floor(s / 3),
            0.1 * math.exp(-0.3 * s / 4),
            0.1 * math.exp(-0.3 * math.floor(s / 4)),
            0.1 / (1 + 0.7 * s / 2), 0.1 / (1 + 0.7 * math.floor(s / 2)),
            (0.1 - 0.01) * (1 - min(s / 5, 1.0)) ** 2 + 0.01,
            (0.1 - 0.01) * (1 - s / poly_cycle) + 0.01,
            0.1 if s < 3 else (0.05 if s < 7 else 0.01),
            64 ** -0.5 * min(s ** -0.5, 5 ** -1.5 * s)]


def test_lr_schedules_over_steps():
    """Steps 1..12: staircase and smooth, the polynomial's cycle through
    two periods, piecewise across both boundaries, noam on both sides of
    its warm-up (5); each against the JAX package and the closed form."""
    def build(fluid):
        return _schedules(fluid.layers) + [
            fluid.default_main_program().global_block().var("@STEP_COUNTER@")]

    want, got = run_both(build, {}, steps=STEPS)
    assert_same(want, got)
    for step, vals in enumerate(got, start=1):
        assert int(vals[-1][0]) == step
        np.testing.assert_allclose([float(v[0]) for v in vals[:-1]],
                                   _closed_forms(step), rtol=2e-6)


def test_step_counter_is_one_prepended_increment():
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        c = pt.layers.autoincreased_step_counter(begin=5, step=2)
        assert pt.layers.autoincreased_step_counter() is c
        pt.layers.noam_decay(16, 4)
    ops = main.global_block().ops
    assert ops[0].type == "increment" and \
        ops[0].input("X") == ops[0].output("Out") == ["@STEP_COUNTER@"]
    assert sum(o.type == "increment" for o in ops) == 1
    assert c.persistable and c.dtype == "int64"
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    # begin - 1 after the startup, then one `step` before each step's ops
    assert int(scope.find_var("@STEP_COUNTER@")[0]) == 4
    for want in (6, 8, 10):
        exe.run(main, scope=scope)
        assert int(scope.find_var("@STEP_COUNTER@")[0]) == want


# --- clipping, regularization, and their order --------------------------------

def _fc_model(fluid, opt, clip=None, regularization=None, size=3):
    L = fluid.layers
    x = L.data(name="x", shape=[4], dtype="float32")
    y = L.data(name="y", shape=[size], dtype="float32")
    h = L.fc(input=x, size=6, act="tanh")
    pred = L.fc(input=h, size=size)
    loss = L.mean(L.square_error_cost(input=pred, label=y))
    if clip is not None:
        fluid.clip.set_gradient_clip(clip)
    if regularization is not None:
        opt.regularization = regularization
    _, params_grads = opt.minimize(loss)
    return loss, params_grads


FC_FEED = {"x": f32(8, 4) * 3, "y": f32(8, 3) * 3}


def _clip_run(make_clip, regularization=None, lr=0.5):
    def build(fluid):
        reg = None if regularization is None else \
            getattr(fluid.regularizer, regularization[0])(regularization[1])
        loss, pg = _fc_model(fluid, fluid.optimizer.SGD(learning_rate=lr),
                             make_clip(fluid), reg)
        return [loss] + [p.name for p, _ in pg] + [g.name for _, g in pg]
    return run_both(build, FC_FEED, steps=3)


@pytest.mark.parametrize("clip", ["value", "norm", "global_norm"])
def test_gradient_clips(clip):
    make = {"value": lambda f: f.clip.GradientClipByValue(0.05, -0.02),
            "norm": lambda f: f.clip.GradientClipByNorm(clip_norm=0.1),
            "global_norm": lambda f: f.clip.GradientClipByGlobalNorm(
                clip_norm=0.2)}[clip]
    want, got = _clip_run(make)
    assert_same(want, got)


def test_global_norm_is_computed_once_a_group():
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        _fc_model(pt, pt.optimizer.SGD(learning_rate=0.1),
                  pt.clip.GradientClipByGlobalNorm(clip_norm=1.0))
    ops = main.global_block().ops
    types = [o.type for o in ops]
    assert types.count("sqrt") == 1 and types.count("elementwise_max") == 1
    # four parameters: a square of each grad, one sum of their norms
    assert sum(o.type == "square" and o.input("X")[0].endswith("@GRAD")
               for o in ops) == 4
    assert sum(o.type == "sum" and len(o.input("X")) == 4 for o in ops) == 1
    norm = main._telemetry_fetch_extra["optimizer_global_norm"]
    assert list(main.global_block().var(norm).shape) == [1]


def test_error_clip_by_value():
    def build(fluid):
        loss, pg = _fc_model(fluid, fluid.optimizer.SGD(learning_rate=0.1))
        block = fluid.default_main_program().global_block()
        g = pg[0][1].name
        fluid.clip.ErrorClipByValue(max=0.01).append_clip_op(block, g)
        return [loss, g]
    want, got = run_both(build, FC_FEED)
    assert_same(want, got)
    assert np.abs(got[0][1]).max() <= 0.01


@pytest.mark.parametrize("reg", [("L1Decay", 0.05), ("L2Decay", 0.05)])
def test_weight_decay(reg):
    want, got = _clip_run(lambda f: None, regularization=reg)
    assert_same(want, got)


def test_clip_runs_before_regularization_before_the_optimizer():
    """minimize: clip, then decay, then the update (optimizer.py:126-127):
    the op order of both packages, and one SGD step equal to
    p - lr * (clip(g) + coeff * sign(p)) on the host."""
    progs = {}
    for fluid in (jfluid, pt):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            _fc_model(fluid, fluid.optimizer.SGD(learning_rate=0.5),
                      fluid.clip.GradientClipByValue(0.01),
                      fluid.regularizer.L1Decay(0.2))
        progs[fluid] = (main, startup)
    types = {f: [o.type for o in progs[f][0].global_block().ops]
             for f in progs}
    assert types[jfluid] == types[pt]
    t = types[pt]
    last_clip = max(i for i, o in enumerate(t) if o == "clip")
    first_sign = min(i for i, o in enumerate(t) if o == "sign")
    first_sgd = min(i for i, o in enumerate(t) if o == "sgd")
    assert last_clip < first_sign < first_sgd
    main, startup = progs[pt]
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    params = [p.name for p in main.global_block().all_parameters()]
    before = {n: scope.find_var(n).clone() for n in params}
    grads = exe.run(main, feed=FC_FEED, scope=scope,
                    fetch_list=[n + "@GRAD" for n in params])
    for n, g in zip(params, grads):
        p0 = before[n].numpy()
        want = p0 - 0.5 * (np.clip(g, -0.01, 0.01) + 0.2 * np.sign(p0))
        np.testing.assert_allclose(scope.find_var(n).numpy(), want, **F32)


# --- calc_gradient (tests/test_weak_fixes.py:29, :48) ---------------------------

def _x(fluid):
    return fluid.layers.data(name="x", shape=[3], dtype="float32",
                             append_batch_size=False, stop_gradient=False)


def _calc_single(fluid):
    L = fluid.layers
    x = _x(fluid)
    return fluid.calc_gradient(L.reduce_sum(L.elementwise_mul(x, x)), x)


def _calc_multi(fluid):
    """The grad of <tg1, t1> + <tg2, t2>: 2 * 3 + 0.5 * 2x."""
    L = fluid.layers
    x = _x(fluid)
    t1, t2 = L.scale(x, scale=3.0), L.elementwise_mul(x, x)
    tg1 = L.fill_constant([3], "float32", 2.0)
    tg2 = L.fill_constant([3], "float32", 0.5)
    return fluid.calc_gradient([t1, t2], x, target_gradients=[tg1, tg2])


@pytest.mark.parametrize("build,closed", [
    (_calc_single, lambda x: 2 * x), (_calc_multi, lambda x: 6.0 + x)])
def test_calc_gradient(build, closed):
    xv = np.array([1.0, -4.0, 2.5], np.float32)
    want, got = run_both(build, {"x": xv})
    assert_same(want, got)
    np.testing.assert_allclose(got[0][0], closed(xv), **F32)


def test_calc_gradient_unreached_input_is_none():
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        L = pt.layers
        x = L.data(name="x", shape=[2], dtype="float32",
                   append_batch_size=False, stop_gradient=False)
        z = L.data(name="z", shape=[2], dtype="float32",
                   append_batch_size=False, stop_gradient=False)
        gx, gz = pt.calc_gradient(L.scale(x, scale=2.0), [x, z])
    assert gx is not None and gz is None
    with pytest.raises(ValueError):
        pt.calc_gradient([x, z], x, target_gradients=[x])


# --- the global-norm gauge (tests/test_telemetry.py:208) ------------------------

def test_global_norm_gauge_with_clipping(monkeypatch):
    jax_telemetry.reset()
    pt_telemetry.reset()
    built = {}

    def build(fluid):
        loss, pg = _fc_model(fluid, fluid.optimizer.SGD(learning_rate=0.01),
                             fluid.clip.GradientClipByGlobalNorm(1.0))
        built[fluid] = fluid.default_main_program()
        return [loss] + [p.name + "@GRAD" for p, _ in pg]

    want, got = run_both(build, FC_FEED)
    assert_same(want, got)
    assert len(got[0]) == 5   # the side-fetch does not reach the caller
    (jnorm,) = jax_telemetry.snapshot()["gauges"][
        "optimizer_global_norm"].values()
    (pnorm,) = pt_telemetry.read_series("optimizer_global_norm").values()
    host = np.sqrt(sum(float(np.sum(np.square(g))) for g in got[0][1:]))
    np.testing.assert_allclose(pnorm, jnorm, **F32)
    np.testing.assert_allclose(pnorm, host, rtol=1e-5)
    assert pt_telemetry.read_series("optimizer_minimize_total") == {
        "optimizer=sgd": 1.0}
    # PADDLE_TPU_TELEMETRY_FETCH=0: no side fetch, the gauge stays
    main = built[pt]
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(pt.default_startup_program(), scope=scope)
    monkeypatch.setenv("PADDLE_TPU_TELEMETRY_FETCH", "0")
    assert pt_executor.Executor._telemetry_extra(main, []) == []
    monkeypatch.setenv("PADDLE_TPU_TELEMETRY_FETCH", "1")
    assert pt_executor.Executor._telemetry_extra(main, []) == [
        ("optimizer_global_norm", main._telemetry_fetch_extra[
            "optimizer_global_norm"])]


# --- save / load ops across the packages ---------------------------------------

def _save_prog(fluid, path, combined):
    L = fluid.layers
    a = L.data(name="a", shape=[2, 3], dtype="float32",
               append_batch_size=False)
    b = L.data(name="b", shape=[4], dtype="int32", append_batch_size=False)
    block = fluid.default_main_program().global_block()
    if combined:
        block.append_op(type="save_combine", inputs={"X": [a, b]},
                        attrs={"file_path": path})
    else:
        block.append_op(type="save", inputs={"X": [a]},
                        attrs={"file_path": path})


def _load_prog(fluid, path, combined):
    block = fluid.default_main_program().global_block()
    a = block.create_var(name="a", shape=[2, 3], dtype="float32",
                         persistable=True)
    if combined:
        b = block.create_var(name="b", shape=[4], dtype="int32",
                             persistable=True)
        block.append_op(type="load_combine", outputs={"Out": [a, b]},
                        attrs={"file_path": path})
        return [a, b]
    block.append_op(type="load", outputs={"Out": [a]},
                    attrs={"file_path": path})
    return [a]


@pytest.mark.parametrize("combined", [False, True])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_save_load_ops_across_packages(tmp_path, writer, combined):
    # int32: the JAX package's load ops cannot declare 64-bit results
    feed = {"a": f32(2, 3), "b": np.array([3, -1, 7, 0], np.int32)}
    path = str(tmp_path / ("combined" if combined else "a"))
    w, r = (jfluid, pt) if writer == "jax" else (pt, jfluid)
    for fluid, build in ((w, _save_prog), (r, _load_prog)):
        main = fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main,
                                                            fluid.Program()):
            fetch = build(fluid, path, combined)
        exe = fluid.Executor(fluid.CPUPlace())
        scope = _ex(fluid).Scope()
        if fetch is None:
            exe.run(main, feed=feed, scope=scope)
        else:
            got = exe.run(main, fetch_list=fetch, scope=scope)
    np.testing.assert_array_equal(got[0], feed["a"])
    if combined:
        np.testing.assert_array_equal(got[1], feed["b"])
    with open(path, "rb") as f:
        blob = pickle.load(f)
    if combined:
        assert sorted(blob) == ["a", "b"] and blob["a"][1] is None
    else:
        assert blob["lod"] is None and blob["version"] == 0


def test_host_io_ops_run_eager_on_the_card(tmp_path):
    """A block holding a save or load runs eager under "host_io" (a replay
    would skip the write); the gate asked as on a CUDA place."""
    exe = pt.Executor(pt.CPUPlace())
    exe.device = torch.device("cuda", 0)
    for combined in (False, True):
        for build in (_save_prog, _load_prog):
            main = pt.Program()
            with pt.unique_name.guard(), pt.program_guard(main, pt.Program()):
                build(pt, str(tmp_path / "x"), combined)
            assert exe.graph_gate(main, {"a": None, "b": None}) == "host_io"
    assert {"save", "save_combine", "load", "load_combine"} == \
        pt_executor.HOST_IO_OPS


def test_a_save_runs_every_step(tmp_path):
    path = str(tmp_path / "a")
    main = pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, pt.Program()):
        _save_prog(pt, path, False)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    for k in range(3):
        a = np.full((2, 3), k, np.float32)
        exe.run(main, feed={"a": a, "b": np.zeros(4, np.int32)},
                scope=scope)
        with open(path, "rb") as f:
            np.testing.assert_array_equal(pickle.load(f)["tensor"], a)


# --- mq2007 and WeightedAverage --------------------------------------------------

@pytest.mark.parametrize("fmt", ["pointwise", "pairwise", "listwise"])
def test_mq2007_surrogate_is_the_jax_packages(fmt):
    from paddle_tpu.dataset import mq2007 as jmq
    for split in ("train", "test"):
        want = list(getattr(jmq, split)(format=fmt)())
        got = list(getattr(pt.dataset.mq2007, split)(format=fmt)())
        assert len(want) == len(got) > 0
        for w, g in zip(want, got):
            for a, b in zip(w, g):
                np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def test_mq2007_parses_letor_text(tmp_path, monkeypatch):
    from paddle_tpu.dataset import mq2007 as jmq
    text = ("2 qid:10 1:0.5 2:0.25 46:1.0 # doc a\n"
            "0 qid:10 1:0.1 3:0.7\n"
            "1 qid:11 2:0.9 # doc c\n\n")
    path = tmp_path / "train.txt"
    path.write_text(text)
    want, got = jmq._parse_letor(str(path)), \
        pt.dataset.mq2007._parse_letor(str(path))
    assert sorted(want) == sorted(got) == ["10", "11"]
    for q in want:
        for (rw, fw), (rg, fg) in zip(want[q], got[q]):
            assert rw == rg
            np.testing.assert_array_equal(fg, fw)
    monkeypatch.setattr(pt.dataset.common, "DATA_HOME", str(tmp_path.parent))
    (tmp_path.parent / "mq2007").mkdir(exist_ok=True)
    (tmp_path.parent / "mq2007" / "train.txt").write_text(text)
    pairs = list(pt.dataset.mq2007.train()())
    assert len(pairs) == 1 and pairs[0][0] == 1.0


def test_weighted_average():
    from paddle_tpu.average import WeightedAverage as J
    for cls in (J, pt.average.WeightedAverage):
        avg = cls()
        avg.add(np.array([2.0, 4.0]), 1)
        avg.add(np.array([5.0, 1.0]), 3)
        np.testing.assert_allclose(avg.eval(), [4.25, 1.75])
        with pytest.raises(ValueError):
            avg.add("x", 1)
        avg.reset()
        with pytest.raises(ValueError):
            avg.eval()


# --- the census ------------------------------------------------------------------

# the types the port does not register: the four fusion window types,
# which the port's executor runs as windows of member ops (ops/fusion.py)
# without making an op of them
LEFT_FOR_LATER = frozenset({
    "fused_bn_act", "fused_chain", "fused_conv_bn_act", "fused_fc_act"})


def _registered(names, registry):
    """The types registered at import: `registered_ops()` less the generic
    `<type>_grad` entries either registry adds lazily once a program
    differentiates `<type>` (which earlier tests in a process do)."""
    return {n for n in names
            if registry._REGISTRY[n].lower is not registry.generic_grad_lower}


def test_op_census():
    """The port registers the reference's types but exactly the 4 left."""
    ref = _registered(jax_registry.registered_ops(), jax_registry)
    port = _registered(pt_registry._REGISTRY, pt_registry)
    assert len(ref) == 229 and len(LEFT_FOR_LATER) == 4
    assert ref - port == LEFT_FOR_LATER
    assert len(ref & port) == 225


def test_top_level_exports():
    for name in ("SGD", "SGDOptimizer", "Momentum", "MomentumOptimizer",
                 "Adagrad", "AdagradOptimizer", "Adam", "AdamOptimizer",
                 "Adamax", "AdamaxOptimizer", "DecayedAdagrad",
                 "DecayedAdagradOptimizer", "Adadelta", "AdadeltaOptimizer",
                 "RMSProp", "RMSPropOptimizer", "Ftrl", "FtrlOptimizer",
                 "calc_gradient", "average", "DataFeeder", "batch",
                 "metrics"):
        assert hasattr(pt, name) and hasattr(jfluid, name), name
    for name in jfluid.layers.learning_rate_scheduler.__all__ + [
            "EOFException", "open_recordio_file", "read_file", "shuffle",
            "batch", "multi_pass", "double_buffer", "create_tensor", "sums",
            "ones", "zeros", "sign", "cumsum", "uniform_random",
            "gaussian_random", "uniform_random_batch_size_like",
            "gaussian_random_batch_size_like", "autoincreased_step_counter"]:
        assert hasattr(pt.layers, name), name
    assert set(jfluid.clip.__all__) == set(pt.clip.__all__)
    assert set(jfluid.regularizer.__all__) == set(pt.regularizer.__all__)
    assert set(jfluid.optimizer.__all__) == set(pt.optimizer.__all__)


def test_port_imports_without_jax():
    """`import paddle_tpu_torch` in a fresh interpreter where jax and
    paddle_tpu cannot be imported."""
    import subprocess
    import sys
    code = ("import sys\n"
            "class Block:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name.split('.')[0] in ('jax', 'jaxlib', 'paddle_tpu'):\n"
            "            raise ImportError('blocked: ' + name)\n"
            "sys.meta_path.insert(0, Block())\n"
            "import paddle_tpu_torch as pt\n"
            "pt.layers.noam_decay; pt.optimizer.ModelAverage; "
            "pt.dataset.mq2007; pt.clip.GradientClipByGlobalNorm\n"
            "print('ok')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
