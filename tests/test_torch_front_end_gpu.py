"""The training front end on the card (Executor.run on a CUDA place).

  * The new ops (tensor, math, loss, misc families) on the card against
    the port's own CPU path on the same inputs, forward and input grads.
  * Each optimizer of the family, the proximal ops among them, on an MLP:
    the graphed steps (warm-up, capture, replays) bitwise their eager
    twins, and the trajectory within tolerance of the CPU's.
  * A step holding a learning-rate schedule stays graphed: each replay
    advances @STEP_COUNTER@ in place and the LR it computes on the card
    is the host's closed form of the step; the global-norm gauge is the
    host's norm of the grads.
  * ModelAverage's swap programs on the card; save/load run eager under
    "host_io" and write every step; the reader layers pull batches staged
    on the card through the double buffer.

Every test skips without a CUDA device. This file imports no JAX: run it
on the card without the suite's conftest,

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_front_end_gpu.py

Tolerances: graphed against eager bitwise; the card against the CPU rtol
1e-5 / atol 1e-6 for the ops (cuBLAS and the CPU reduce in other orders)
and rtol 1e-4 / atol 1e-6 for trajectories of several steps; the LR within
1e-6 relative of the host's f64 closed form.
"""

import torch_threads  # noqa: F401  (the cores shared among xdist workers)
import pickle
import random

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import executor as E
from paddle_tpu_torch import telemetry

pytestmark = pytest.mark.gpu

OPS = dict(rtol=1e-5, atol=1e-6)
TRAJ = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _scope(state, device):
    s = pt.Scope()
    for k, v in state.items():
        s.set_var(k, v.clone().to(device))
    return s


def _startup_state(startup):
    scope = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(startup, scope=scope)
    return {k: v for k, v in scope.vars.items() if isinstance(v, torch.Tensor)}


RNG = np.random.RandomState(5)
FEED = {"x": RNG.randn(6, 5).astype(np.float32),
        "y": RNG.randn(6, 5).astype(np.float32),
        "w": RNG.randn(3, 5, 5).astype(np.float32),
        "p": RNG.uniform(0.05, 0.95, (6, 5)).astype(np.float32),
        "z": RNG.uniform(0, 1, (6, 5)).astype(np.float32),
        "ids": np.array([[4], [0], [2]], np.int64),
        "sel": np.array([[1], [0], [0], [1], [1], [0]], np.int32),
        "lab": np.array([[1], [0], [3], [4], [2], [0]], np.int64)}


def _op_net():
    L = pt.layers
    d = {n: L.data(name=n, shape=list(a.shape), dtype=str(a.dtype),
                   append_batch_size=False,
                   stop_gradient=a.dtype.kind != "f")
         for n, a in FEED.items()}
    x, y = d["x"], d["y"]
    block = pt.default_main_program().current_block()

    def raw(type, ins, outs, attrs=None):
        made = {s: block.create_var(name=pt.unique_name.generate(type),
                                    dtype="float32") for s in outs}
        block.append_op(type=type, inputs={k: [v] for k, v in ins.items()},
                        outputs={s: [v] for s, v in made.items()},
                        attrs=attrs or {})
        return made[outs[0]]

    outs = [
        L.clip(x, -0.3, 0.4), L.clip_by_norm(x, 1.0), L.reverse(x, [0, 1]),
        L.expand(x, [2, 1]), L.unsqueeze(L.squeeze(L.unsqueeze(x, [1]), [1]),
                                         [0]),
        L.gather(x, d["ids"]), L.scatter(x, d["ids"], L.gather(y, d["ids"])),
        L.multiplex([x, y], d["sel"]),
        L.cumsum(x, axis=1, exclusive=True, reverse=True), L.cumsum(x, axis=0),
        L.l2_normalize(x, axis=1), L.sigmoid_cross_entropy_with_logits(x, d["z"]),
        L.smooth_l1(x, y, sigma=2.0), L.log_loss(d["p"], d["z"]),
        L.label_smooth(L.one_hot(d["lab"], 5), epsilon=0.1), L.l1_norm(x),
        raw("minus", {"X": x, "Y": y}, ["Out"]),
        raw("bilinear_tensor_product", {"X": x, "Y": y, "Weight": d["w"]},
            ["Out"]),
        raw("huber_loss", {"X": x, "Y": y}, ["Out", "Residual"]),
        raw("squared_l2_distance", {"X": x, "Y": y}, ["Out", "sub_result"]),
        raw("squared_l2_norm", {"X": x}, ["Out"]),
        raw("modified_huber_loss",
            {"X": L.reduce_sum(x, dim=1, keep_dim=True),
             "Y": L.cast(d["sel"], "float32")}, ["Out", "IntermediateVal"]),
        L.sign(x),
    ] + L.split(x, [2, 3], dim=1)
    parts = [L.reduce_sum(L.square(o)) for o in outs]
    pt.backward.append_backward(L.sums(parts))
    return outs + ["x@GRAD", "y@GRAD", "w@GRAD", "p@GRAD"]


def test_new_ops_on_the_card_match_the_cpu(device):
    main = pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, pt.Program()):
        fetch = _op_net()
    got = {}
    for place in (pt.CPUPlace(), pt.CUDAPlace(0)):
        got[type(place)] = pt.Executor(place).run(
            main, feed=FEED, fetch_list=fetch, scope=pt.Scope(),
            use_jit=False)
    for a, b in zip(got[pt.CUDAPlace], got[pt.CPUPlace]):
        np.testing.assert_allclose(a, b, **OPS)


def test_auc_on_the_card_is_the_cpus(device):
    from paddle_tpu_torch.ops.nn_ops import auc_thresholds
    scores = np.concatenate([auc_thresholds(11), auc_thresholds(200),
                             RNG.uniform(0, 1, 40).astype(np.float32)])
    feed = {"p": np.stack([1 - scores, scores], 1),
            "y": (np.arange(len(scores)) % 3 != 0).astype(
                np.int64).reshape(-1, 1)}
    main = pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, pt.Program()):
        L = pt.layers
        p = L.data(name="p", shape=[len(scores), 2], dtype="float32",
                   append_batch_size=False)
        y = L.data(name="y", shape=[len(scores), 1], dtype="int64",
                   append_batch_size=False)
        fetch = [L.auc(p, y, num_thresholds=n) for n in (11, 200)]
    cpu = pt.Executor(pt.CPUPlace()).run(main, feed=feed, fetch_list=fetch)
    card = pt.Executor().run(main, feed=feed, fetch_list=fetch)
    # the trapezoid's sum runs in another order on the card: a few ulps;
    # a score moved to another bucket would move the AUC by ~1/(P·N),
    # 1.4e-3 here
    for a, b in zip(card, cpu):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)


def _mlp(make_opt, lr=None, clip=None):
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        L = pt.layers
        x = L.data(name="x", shape=[5], dtype="float32")
        y = L.data(name="y", shape=[2], dtype="float32")
        h = L.fc(input=x, size=16, act="relu")
        pred = L.fc(input=h, size=2)
        loss = L.mean(L.square_error_cost(pred, y))
        if clip is not None:
            pt.clip.set_gradient_clip(clip)
        rate = lr(pt) if lr is not None else 0.05
        opt = make_opt(rate)
        if opt is None:     # the proximal ops: appended by hand
            params_grads = pt.backward.append_backward(loss)
            block = main.global_block()
            for p, g in params_grads:
                ins = {"Param": [p], "Grad": [g], "LearningRate": [rate]}
                outs = {"ParamOut": [p]}
                block.append_op(type="proximal_gd", inputs=ins, outputs=outs,
                                attrs={"l1": 1e-3, "l2": 1e-3})
        else:
            opt.minimize(loss)
    main.random_seed = startup.random_seed = 1
    return main, startup, loss


def _proximal(rate):
    return None


OPTIMIZERS = {
    "adamax": lambda lr: pt.optimizer.Adamax(lr),
    "decayed_adagrad": lambda lr: pt.optimizer.DecayedAdagrad(lr),
    "adadelta": lambda lr: pt.optimizer.Adadelta(lr),
    "rmsprop": lambda lr: pt.optimizer.RMSProp(lr, momentum=0.5),
    "ftrl": lambda lr: pt.optimizer.Ftrl(lr, l1=1e-3, l2=1e-3),
    "proximal_gd": _proximal,
}
BATCH = {"x": RNG.randn(32, 5).astype(np.float32),
         "y": RNG.randn(32, 2).astype(np.float32)}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_graphed_bitwise_eager(device, name):
    def lr(p):
        return p.layers.fill_constant([1], "float32", 0.05)
    main, startup, loss = _mlp(OPTIMIZERS[name],
                               lr if name == "proximal_gd" else None)
    init = _startup_state(startup)
    sg, se, sc = (_scope(init, device), _scope(init, device),
                  _scope(init, "cpu"))
    exe, cpu = pt.Executor(), pt.Executor(pt.CPUPlace())
    E.COUNTERS.reset()
    for _ in range(5):
        lg, = exe.run(main, feed=BATCH, fetch_list=[loss], scope=sg)
        le, = exe.run(main, feed=BATCH, fetch_list=[loss], scope=se,
                      use_jit=False)
        lc, = cpu.run(main, feed=BATCH, fetch_list=[loss], scope=sc)
        np.testing.assert_array_equal(lg, le)
        np.testing.assert_allclose(lg, lc, **TRAJ)
    assert (E.COUNTERS.warmups, E.COUNTERS.captures,
            E.COUNTERS.replays) == (1, 1, 4)
    for n, v in sg.vars.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, se.vars[n]), n
            np.testing.assert_allclose(v.cpu().numpy(),
                                       sc.vars[n].numpy(), err_msg=n, **TRAJ)


def test_schedule_graphed_counter_and_lr_advance(device):
    """noam_decay on Adam and the global-norm clip: every replay advances
    @STEP_COUNTER@ and recomputes the LR on the card, bitwise the eager
    steps, and the gauge reads a norm each step."""
    main, startup, loss = _mlp(lambda lr: pt.optimizer.Adam(lr),
                               lambda p: p.layers.noam_decay(16, 5),
                               pt.clip.GradientClipByGlobalNorm(0.5))
    label = telemetry.program_label(main)
    lr = next(o for o in main.global_block().ops
              if o.type == "adam").input("LearningRate")[0]
    init = _startup_state(startup)
    sg, se = _scope(init, device), _scope(init, device)
    exe = pt.Executor()
    E.COUNTERS.reset()
    for step in range(1, 9):
        lg, rg = exe.run(main, feed=BATCH, fetch_list=[loss, lr], scope=sg)
        le, re = exe.run(main, feed=BATCH, fetch_list=[loss, lr], scope=se,
                         use_jit=False)
        assert np.array_equal(lg, le) and np.array_equal(rg, re)
        want = 16 ** -0.5 * min(step ** -0.5, 5 ** -1.5 * step)
        assert abs(float(rg[0]) - want) <= 1e-6 * want
        assert int(sg.find_var("@STEP_COUNTER@").item()) == step
        assert np.isfinite(telemetry.read_gauge("optimizer_global_norm",
                                                program=label))
    assert E.COUNTERS.replays == 7


def test_global_norm_gauge_on_the_card(device):
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        L = pt.layers
        x = L.data(name="x", shape=[5], dtype="float32")
        y = L.data(name="y", shape=[2], dtype="float32")
        pred = L.fc(input=L.fc(input=x, size=16, act="relu"), size=2)
        loss = L.mean(L.square_error_cost(pred, y))
        pt.clip.set_gradient_clip(pt.clip.GradientClipByGlobalNorm(0.1))
        _, pg = pt.optimizer.SGD(0.1).minimize(loss)
    init = _startup_state(startup)
    exe = pt.Executor()
    grads = exe.run(main, feed=BATCH, scope=_scope(init, device),
                    fetch_list=[p.name + "@GRAD" for p, _ in pg])
    gauge = telemetry.read_gauge("optimizer_global_norm",
                                 program=telemetry.program_label(main))
    host = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2))
                       for g in grads))
    assert abs(gauge - host) <= 1e-5 * host


def test_model_average_on_the_card(device):
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        L = pt.layers
        x = L.data(name="x", shape=[5], dtype="float32")
        y = L.data(name="y", shape=[2], dtype="float32")
        pred = L.fc(input=x, size=2, param_attr=pt.ParamAttr(name="w"))
        loss = L.mean(L.square_error_cost(pred, y))
        pt.optimizer.SGD(0.1).minimize(loss)
        avg = pt.optimizer.ModelAverage(1.0, min_average_window=1,
                                        max_average_window=100)
    scope = _scope(_startup_state(startup), device)
    exe = pt.Executor()
    traj = []
    for _ in range(5):
        exe.run(main, feed=BATCH, fetch_list=[loss], scope=scope)
        traj.append(scope.find_var("w").clone())
    with pt.scope_guard(scope), avg.apply(exe):
        inside = scope.find_var("w").clone()
    torch.testing.assert_close(inside, torch.stack(traj).mean(0),
                               rtol=1e-6, atol=1e-7)
    assert torch.equal(scope.find_var("w"), traj[-1])


def test_save_runs_eager_on_the_card_every_step(device, tmp_path):
    path = str(tmp_path / "a")
    main = pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, pt.Program()):
        a = pt.layers.data(name="a", shape=[3], dtype="float32",
                           append_batch_size=False)
        main.global_block().append_op(type="save", inputs={"X": [a]},
                                      attrs={"file_path": path})
    exe = pt.Executor()
    E.COUNTERS.reset()
    for k in range(3):
        exe.run(main, feed={"a": np.full(3, k, np.float32)})
        with open(path, "rb") as f:
            assert pickle.load(f)["tensor"].tolist() == [k] * 3
    assert E.COUNTERS.eager == {"host_io": 3} and not E.COUNTERS.captures


def test_reader_layers_on_the_card(device, tmp_path):
    path = str(tmp_path / "r.recordio")
    rng = np.random.RandomState(0)
    pt.recordio.write_samples(path, [
        (rng.rand(5).astype(np.float32), rng.randn(2).astype(np.float32))
        for _ in range(40)])
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        L = pt.layers
        r = L.open_recordio_file(path, shapes=[[-1, 5], [-1, 2]],
                                 lod_levels=[0, 0],
                                 dtypes=["float32", "float32"])
        r = L.double_buffer(L.batch(L.shuffle(r, 16), 8))
        x, y = L.read_file(r)
        loss = L.mean(L.square_error_cost(L.fc(input=x, size=2), y))
        pt.optimizer.SGD(0.05).minimize(loss)
    scope = _scope(_startup_state(startup), device)
    exe = pt.Executor()
    E.COUNTERS.reset()
    for p in range(2):
        random.seed(p)
        n = 0
        while True:
            try:
                v, = exe.run(main, fetch_list=[loss], scope=scope)
            except pt.layers.EOFException:
                r.reset()
                break
            assert np.isfinite(v).all()
            n += 1
        assert n == 5
    # ten steps: the warm-up, the capture (which replays once), 8 replays
    assert E.COUNTERS.replays == 9 and not E.COUNTERS.eager
    bx, _ = r.next_batch(device)
    assert bx.device.type == "cuda" and bx.shape == (8, 5)
    r.reset()
