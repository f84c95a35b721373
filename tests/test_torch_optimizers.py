"""The optimizer family and ModelAverage through the port against the JAX
package on the CPU: the trajectories of the five new optimizers (and SGD,
Momentum, Adagrad, Adam beside them) as tests/test_op_sweep.py's
`_opt_run` runs them, held to the JAX package and to the numpy oracles
there; the two proximal ops, which have no class and are built with
append_op; each optimizer on an MLP for several steps with a schedule's
learning rate; a SelectedRows grad densified and counted; ModelAverage as
tests/test_model_average.py runs it, and average_accumulates across its
window's roll. f32 within rtol 1e-5 / atol 1e-6 of the JAX package;
against the numpy oracles rtol 1e-4 where the oracle runs in f64 (the
test_op_sweep.py tolerance).
"""

import torch_threads  # noqa: F401  (the cores shared among xdist workers)
import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import executor as jax_executor
from paddle_tpu import telemetry as jax_telemetry
import paddle_tpu_torch as pt
from paddle_tpu_torch import executor as pt_executor
from paddle_tpu_torch import telemetry as pt_telemetry

F32 = dict(rtol=1e-5, atol=1e-6)
ORACLE = dict(rtol=1e-4, atol=1e-6)
LR = 0.1


@pytest.fixture(autouse=True)
def _keep_jax_op_census():
    before = set(jax_executor._RECORDED_OPS)
    yield
    jax_executor._RECORDED_OPS.intersection_update(before)


def _ex(fluid):
    return pt_executor if fluid is pt else jax_executor


def _opt_run(fluid, make_opt, steps=3):
    """tests/test_op_sweep.py:759: `steps` updates of one 4-weight fc under
    the optimizer; -> the weight trajectory and the (constant) grad."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        pred = fluid.layers.fc(input=x, size=1, bias_attr=False,
                               param_attr=fluid.ParamAttr(name="ow"))
        loss = fluid.layers.mean(pred)
        make_opt(fluid).minimize(loss)
    exe = fluid.Executor(fluid.CPUPlace())
    xs = np.ones((2, 4), "float32") * np.array([1., 2., 3., 4.], "float32")
    w0 = np.array([[0.5], [-0.3], [0.2], [0.1]], "float32")
    grad = xs.mean(axis=0, keepdims=True).T
    scope = _ex(fluid).Scope()
    traj = [w0.copy()]
    with _ex(fluid).scope_guard(scope):
        exe.run(startup)
        scope.set_var("ow", w0.copy())
        for _ in range(steps):
            exe.run(main, feed={"x": xs}, fetch_list=[loss])
            traj.append(np.asarray(scope.find_var("ow")).copy())
    return np.array(traj), grad


def _oracle(name, g, w, steps=3):
    """The numpy oracles of tests/test_op_sweep.py:807-858, in f64."""
    g, w = g.astype(np.float64), w.astype(np.float64)
    out, s = [w], {}
    for t in range(1, steps + 1):
        if name == "momentum":
            s["v"] = 0.9 * s.get("v", 0) + g
            w = w - LR * s["v"]
        elif name == "adagrad":
            s["m"] = s.get("m", 0) + g * g
            w = w - LR * g / (np.sqrt(s["m"]) + 1e-6)
        elif name == "decayed_adagrad":
            s["m"] = 0.95 * s.get("m", 0) + 0.05 * g * g
            w = w - LR * g / (np.sqrt(s["m"]) + 1e-6)
        elif name == "adadelta":
            s["ag"] = 0.95 * s.get("ag", 0) + 0.05 * g * g
            upd = -np.sqrt((s.get("au", 0) + 1e-6) / (s["ag"] + 1e-6)) * g
            s["au"] = 0.95 * s.get("au", 0) + 0.05 * upd * upd
            w = w + upd
        elif name == "adamax":
            s["m"] = 0.9 * s.get("m", 0) + 0.1 * g
            s["u"] = np.maximum(0.999 * s.get("u", 0), np.abs(g))
            w = w - LR / (1 - 0.9 ** t) * s["m"] / (s["u"] + 1e-8)
        elif name == "rmsprop":
            s["ms"] = 0.9 * s.get("ms", 0) + 0.1 * g * g
            w = w - LR * g / np.sqrt(s["ms"] + 1e-6)
        elif name == "ftrl":
            # ftrl_op.cc, lr_power -0.5, l1 = l2 = 0
            sq0 = s.get("sq", 0)
            s["sq"] = sq0 + g * g
            sigma = (np.sqrt(s["sq"]) - np.sqrt(sq0)) / LR
            s["lin"] = s.get("lin", 0) + g - sigma * w
            w = -s["lin"] / (np.sqrt(s["sq"]) / LR)
        out.append(w)
    return np.array(out)


OPTIMIZERS = {
    "sgd": lambda f: f.optimizer.SGD(LR),
    "momentum": lambda f: f.optimizer.Momentum(LR, momentum=0.9),
    "adagrad": lambda f: f.optimizer.Adagrad(LR),
    "adam": lambda f: f.optimizer.Adam(LR),
    "adamax": lambda f: f.optimizer.Adamax(LR, beta1=0.9, beta2=0.999,
                                           epsilon=1e-8),
    "decayed_adagrad": lambda f: f.optimizer.DecayedAdagrad(LR, decay=0.95),
    "adadelta": lambda f: f.optimizer.Adadelta(LR, epsilon=1e-6, rho=0.95),
    "rmsprop": lambda f: f.optimizer.RMSProp(LR, rho=0.9, epsilon=1e-6,
                                             momentum=0.0),
    "ftrl": lambda f: f.optimizer.Ftrl(LR),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_trajectory(name):
    want, g = _opt_run(jfluid, OPTIMIZERS[name])
    got, _ = _opt_run(pt, OPTIMIZERS[name])
    np.testing.assert_allclose(got, want, **F32)
    if name not in ("sgd", "adam"):
        np.testing.assert_allclose(got, _oracle(name, g, got[0]), **ORACLE)
    assert not np.allclose(got[0], got[-1])


@pytest.mark.parametrize("op_type", ["proximal_gd", "proximal_adagrad"])
def test_proximal_ops(op_type):
    """No class has them (as in the reference): the op appended beside a
    plain backward, with l1 and l2 set so the shrink acts."""
    trajs = {}
    for fluid in (jfluid, pt):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            x = fluid.layers.data(name="x", shape=[4], dtype="float32")
            pred = fluid.layers.fc(input=x, size=1, bias_attr=False,
                                   param_attr=fluid.ParamAttr(name="pw"))
            loss = fluid.layers.mean(pred)
            (p, g), = fluid.backward.append_backward(loss)
            block = main.global_block()
            lr = fluid.layers.fill_constant([1], "float32", LR)
            ins = {"Param": [p], "Grad": [g], "LearningRate": [lr]}
            outs = {"ParamOut": [p]}
            if op_type == "proximal_adagrad":
                m = block.create_var(name="pw_moment", shape=[4, 1],
                                     dtype="float32", persistable=True)
                ins["Moment"], outs["MomentOut"] = [m], [m]
            block.append_op(type=op_type, inputs=ins, outputs=outs,
                            attrs={"l1": 0.05, "l2": 0.1})
        exe = fluid.Executor(fluid.CPUPlace())
        scope = _ex(fluid).Scope()
        # the last weight's grad is 0: the l1 shrink takes it to 0
        xs = np.ones((2, 4), np.float32) * np.array([1., -2., 3., 0.],
                                                    np.float32)
        traj = []
        with _ex(fluid).scope_guard(scope):
            exe.run(startup)
            scope.set_var("pw", np.array([[0.5], [-0.3], [0.02], [0.004]],
                                         np.float32))
            if op_type == "proximal_adagrad":
                scope.set_var("pw_moment", np.zeros((4, 1), np.float32))
            for _ in range(4):
                exe.run(main, feed={"x": xs}, fetch_list=[loss])
                traj.append(np.asarray(scope.find_var("pw")).copy())
        trajs[fluid] = np.array(traj)
    np.testing.assert_allclose(trajs[pt], trajs[jfluid], **F32)
    assert (trajs[pt] == 0).any()     # the l1 shrink reached zero


def _mlp_losses(fluid, name, make_lr, steps=6):
    """An MLP trained `steps` steps by optimizer `name` with the learning
    rate `make_lr(fluid)` builds (a schedule), from the JAX startup's
    weights; -> losses, the final persistables."""
    rng = np.random.RandomState(3)
    xs, ys = rng.randn(16, 5).astype(np.float32), \
        rng.randn(16, 2).astype(np.float32)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[5], dtype="float32")
        y = fluid.layers.data(name="y", shape=[2], dtype="float32")
        h = fluid.layers.fc(input=x, size=8, act="relu")
        pred = fluid.layers.fc(input=h, size=2)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        opt = OPTIMIZERS[name](fluid)
        opt._learning_rate = make_lr(fluid)
        opt.minimize(loss)
    return main, startup, loss, {"x": xs, "y": ys}


@pytest.mark.parametrize("name", ["adamax", "decayed_adagrad", "adadelta",
                                  "rmsprop", "ftrl", "adam"])
def test_optimizers_with_schedules_on_an_mlp(name):
    make_lr = {
        "adamax": lambda f: f.layers.piecewise_decay([2, 4],
                                                     [0.05, 0.02, 0.01]),
        "decayed_adagrad": lambda f: f.layers.exponential_decay(
            0.05, 2, 0.5, staircase=True),
        "adadelta": lambda f: f.layers.inverse_time_decay(1.0, 2, 0.5),
        "rmsprop": lambda f: f.layers.natural_exp_decay(0.01, 3, 0.2),
        "ftrl": lambda f: f.layers.polynomial_decay(
            0.1, 4, end_learning_rate=0.05, cycle=True),
        "adam": lambda f: f.layers.noam_decay(8, 3),
    }[name]
    res = {}
    for fluid in (jfluid, pt):
        main, startup, loss, feed = _mlp_losses(fluid, name, make_lr)
        exe, scope = fluid.Executor(fluid.CPUPlace()), _ex(fluid).Scope()
        if fluid is jfluid:
            exe.run(startup, scope=scope)
            arrays = {n: np.asarray(scope.find_var(n))
                      for n, v in startup.global_block().desc.vars.items()
                      if v.persistable and scope.find_var(n) is not None}
        else:
            pt.interop.load_numpy_params(scope, arrays, "cpu")
        losses = [float(np.asarray(exe.run(main, feed=feed, fetch_list=[loss],
                                           scope=scope)[0]).ravel()[0])
                  for _ in range(6)]
        res[fluid] = losses, {n: np.asarray(scope.find_var(n))
                              for n in sorted(arrays)}
    np.testing.assert_allclose(res[pt][0], res[jfluid][0], **F32)
    for n, v in res[jfluid][1].items():
        got = res[pt][1][n]
        if np.issubdtype(v.dtype, np.floating):
            np.testing.assert_allclose(got, v, err_msg=n, **F32)
        else:
            np.testing.assert_array_equal(got, v.astype(got.dtype))
    assert int(res[pt][1]["@STEP_COUNTER@"][0]) == 6


@pytest.mark.parametrize("name", ["adamax", "decayed_adagrad", "adadelta",
                                  "rmsprop", "ftrl"])
def test_sparse_grad_densifies_counted(name):
    """An is_sparse embedding's SelectedRows grad reaches an optimizer with
    no sparse apply: densified at the op's boundary and counted as the JAX
    package counts it (sparse_unaware_op, JAX executor.py:1624), with the
    same update."""
    ids = np.array([[1], [3], [1], [0]], np.int64)
    res = {}
    for fluid in (jfluid, pt):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            i = fluid.layers.data(name="i", shape=[1], dtype="int64")
            e = fluid.layers.embedding(i, size=[5, 3], is_sparse=True,
                                       param_attr=fluid.ParamAttr(name="emb"))
            loss = fluid.layers.mean(fluid.layers.square(e))
            OPTIMIZERS[name](fluid).minimize(loss)
        exe, scope = fluid.Executor(fluid.CPUPlace()), _ex(fluid).Scope()
        if fluid is jfluid:
            exe.run(startup, scope=scope)
            arrays = {n: np.asarray(scope.find_var(n))
                      for n, v in startup.global_block().desc.vars.items()
                      if v.persistable and scope.find_var(n) is not None}
            jax_telemetry.reset()
        else:
            pt_telemetry.reset()
            pt.interop.load_numpy_params(scope, arrays, "cpu")
        for _ in range(2):
            exe.run(main, feed={"i": ids}, fetch_list=[loss], scope=scope)
        res[fluid] = np.asarray(scope.find_var("emb"))
    if name == "ftrl":
        # the table's rows 2 and 4 no id looks up: the JAX package's NaN,
        # the reference's 0 (test_ftrl_untouched_entries_follow_the_reference)
        assert np.isnan(res[jfluid][[2, 4]]).all()
        assert (res[pt][[2, 4]] == 0).all()
        res[jfluid] = np.nan_to_num(res[jfluid], nan=0.0)
    np.testing.assert_allclose(res[pt], res[jfluid], **F32)
    want = jax_telemetry.snapshot()["counters"]["sparse_densify_fallback_total"]
    assert pt_telemetry.read_series("sparse_densify_fallback_total") == \
        want == {f"op={name},reason=sparse_unaware_op": 2.0}


# --- ModelAverage (tests/test_model_average.py) ----------------------------------

def _model_average(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[2], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        pred = fluid.layers.fc(input=x, size=1,
                               param_attr=fluid.ParamAttr(name="w"),
                               bias_attr=False)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        fluid.optimizer.SGDOptimizer(learning_rate=0.2).minimize(loss)
        avg = fluid.optimizer.ModelAverage(
            average_window_rate=1.0, min_average_window=1,
            max_average_window=1000)
    return main, startup, loss, pred, avg


def test_model_average_apply_and_restore():
    rng = np.random.RandomState(0)
    xs = rng.randn(16, 2).astype(np.float32)
    ys = xs @ np.array([[1.5], [-2.0]], np.float32)
    out = {}
    for fluid in (jfluid, pt):
        main, startup, loss, pred, avg = _model_average(fluid)
        exe = fluid.Executor(fluid.CPUPlace())
        scope = _ex(fluid).Scope()
        with _ex(fluid).scope_guard(scope):
            exe.run(startup)
            scope.set_var("w", np.array([[0.3], [0.1]], np.float32))
            traj = []
            for _ in range(6):
                exe.run(main, feed={"x": xs, "y": ys}, fetch_list=[loss])
                traj.append(np.asarray(scope.find_var("w")).copy())
            with avg.apply(exe):
                inside = np.asarray(scope.find_var("w")).copy()
                infer = main.prune(["x"], [pred.name])
                p_in, = exe.run(infer, feed={"x": xs, "y": ys},
                                fetch_list=[pred])
            restored = np.asarray(scope.find_var("w")).copy()
        out[fluid] = traj, inside, restored, np.asarray(p_in)
    traj, inside, restored, p_in = out[pt]
    np.testing.assert_allclose(inside, np.mean(traj, axis=0), rtol=1e-5)
    np.testing.assert_array_equal(restored, traj[-1])
    np.testing.assert_allclose(p_in, xs @ inside, rtol=1e-5, atol=1e-6)
    for a, b in zip(out[pt], out[jfluid]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **F32)


def test_average_accumulates_window_roll():
    """The numpy simulation of the reference kernel (test_model_average.py)
    across window rolls, in both packages."""
    res = {}
    for fluid in (jfluid, pt):
        main = fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main,
                                                            fluid.Program()):
            p = fluid.layers.data(name="p", shape=[3], dtype="float32",
                                  append_batch_size=False)
            blk = main.global_block()
            v = {nm: blk.create_var(name=nm, shape=shape, dtype=dt,
                                    persistable=True)
                 for nm, shape, dt in [("s1", [3], "float32"),
                                       ("s2", [3], "float32"),
                                       ("s3", [3], "float32"),
                                       ("na", [1], "int32"),
                                       ("on", [1], "int32"),
                                       ("nu", [1], "int32")]}
            blk.append_op(
                type="average_accumulates",
                inputs={"param": [p], "in_sum_1": [v["s1"]],
                        "in_sum_2": [v["s2"]], "in_sum_3": [v["s3"]],
                        "in_num_accumulates": [v["na"]],
                        "in_old_num_accumulates": [v["on"]],
                        "in_num_updates": [v["nu"]]},
                outputs={"out_sum_1": [v["s1"]], "out_sum_2": [v["s2"]],
                         "out_sum_3": [v["s3"]],
                         "out_num_accumulates": [v["na"]],
                         "out_old_num_accumulates": [v["on"]],
                         "out_num_updates": [v["nu"]]},
                attrs={"average_window": 0.5, "min_average_window": 2,
                       "max_average_window": 3})
        exe, scope = fluid.Executor(fluid.CPUPlace()), _ex(fluid).Scope()
        for nm in ("s1", "s2", "s3"):
            scope.set_var(nm, np.zeros(3, np.float32))
        for nm in ("na", "on", "nu"):
            scope.set_var(nm, np.zeros(1, np.int32))
        rng = np.random.RandomState(2)
        steps = []
        for _ in range(9):
            exe.run(main, feed={"p": rng.rand(3).astype(np.float32)},
                    fetch_list=[v["s1"]], scope=scope)
            steps.append({nm: np.asarray(scope.find_var(nm)).copy()
                          for nm in v})
        res[fluid] = steps
    s1, s2, s3 = np.zeros(3), np.zeros(3), np.zeros(3)
    na = on = nu = 0
    rng = np.random.RandomState(2)
    for step, (got, want) in enumerate(zip(res[pt], res[jfluid])):
        pv = rng.rand(3).astype(np.float32)
        nu += 1
        na += 1
        s1 = s1 + pv
        if na >= 2 and na >= min(3, int(nu * 0.5)):
            s3, s1, s2 = s1 + s2, np.zeros(3), np.zeros(3)
            on, na = na, 0
        for nm, val in (("s1", s1), ("s2", s2), ("s3", s3)):
            np.testing.assert_allclose(got[nm], val, rtol=1e-6,
                                       err_msg=f"{nm} step {step}")
            np.testing.assert_allclose(got[nm], want[nm], **F32)
        assert (int(got["na"][0]), int(got["on"][0]), int(got["nu"][0])) \
            == (na, on, nu)
        for nm in ("na", "on", "nu"):
            np.testing.assert_array_equal(got[nm], want[nm])


def test_average_accumulates_saturates_the_window_limit():
    """With the default max_average_window (2^31 - 1) the f32 limit is
    2^31, which the int32 conversion saturates (as XLA's convert does),
    where a plain torch cast would wrap to -2^31 and roll every step."""
    from paddle_tpu_torch.ops.misc_ops import _saturate_i32
    import torch
    got = _saturate_i32(torch.tensor([2.0 ** 31, -3e9, 7.9, -7.9]))
    assert got.tolist() == [2 ** 31 - 1, -2 ** 31, 7, -7]


def test_ftrl_untouched_entries_follow_the_reference():
    """An entry no grad has reached (sq accumulator 0, l2 0): ftrl_op.h's
    select makes the parameter 0 where the JAX package's division makes
    0/0 = NaN; the port follows the reference, and agrees with the JAX
    package everywhere else."""
    import torch
    from paddle_tpu_torch.ops import registry as pt_registry
    from paddle_tpu.ops import registry as jax_registry

    class _Op:
        type = "ftrl"

        def __init__(self, attrs):
            self._a = attrs

        def attr(self, k, d=None):
            return self._a.get(k, d)

    p = np.array([0.5, -0.2, 0.3, 0.0], np.float32)
    g = np.array([0.1, -0.4, 0.0, 0.0], np.float32)
    zeros = np.zeros(4, np.float32)
    ins = {"Param": [p], "Grad": [g], "SquaredAccumulator": [zeros],
           "LinearAccumulator": [zeros], "LearningRate": [np.float32([0.1])]}
    for l1 in (0.0, 0.05):
        op_ = _Op({"l1": l1, "l2": 0.0, "lr_power": -0.5})
        got = pt_registry.get("ftrl").lower(
            None, op_, {k: [torch.from_numpy(np.asarray(v[0]))]
                        for k, v in ins.items()})["ParamOut"][0].numpy()
        want = np.asarray(jax_registry.get("ftrl").lower(
            None, op_, ins)["ParamOut"][0])
        assert np.isnan(want[2:]).all() and (got[2:] == 0).all()
        np.testing.assert_allclose(got[:2], want[:2], **F32)
