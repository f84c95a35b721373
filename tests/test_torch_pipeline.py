"""The port's pipelines against the JAX package's.

`parallel.pipeline.gpipe` on a gloo group of 4 CPU processes (a 'pp' axis
of 4; tests/torch_group.py, workers tests/torch_parallel_worker.py, which
import no jax) against the JAX `gpipe` on a 4-device 'pp' mesh of the host
platform: the forward at M 6, the gradients of sum(out^2) by the stacked
parameters and the microbatches at M 3, and M 2 < P, at
tests/test_pipeline.py's tolerances. Each rank's parameter gradient is
its stage's rows alone; their sum is the JAX one.

`parallel.program_pipeline.PipelineTranspiler` in one process: the pp-4
MLP of tests/test_program_pipeline.py against the JAX PipelineTrainer and
the one-device port, from the JAX startup's weights (losses and
parameters within rtol 1e-5); the stages disjoint and placed on
CUDAPlace(i mod the cards) by default; the skip connection's ValueError;
L2 regularization; LoD feeds refused; and a small transformer LM cut after
each layer's FFN residual add (chip_smoke.lm_stage_cuts, the smoke's
train_pipeline_lm at a small width)."""

import torch_threads  # noqa: F401  (the cores shared among xdist workers)
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jfluid
import paddle_tpu_torch as pt
from paddle_tpu import executor as jax_executor
from paddle_tpu.parallel import mesh as jax_mesh
from paddle_tpu.parallel.pipeline import gpipe as jax_gpipe
from paddle_tpu.parallel.program_pipeline import \
    PipelineTranspiler as JaxPipelineTranspiler

import chip_smoke
import torch_group

WORKER = Path(__file__).resolve().parent / "torch_parallel_worker.py"
P = 4
FWD_TOL = dict(rtol=2e-5, atol=2e-6)       # tests/test_pipeline.py's
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
TOL = dict(rtol=1e-5, atol=1e-6)
GPIPE = {"fwd": 6, "grad": 3, "few": 2}    # case -> microbatches


@pytest.fixture(autouse=True)
def _keep_jax_op_census():
    before = set(jax_executor._RECORDED_OPS)
    yield
    jax_executor._RECORDED_OPS.intersection_update(before)


def _gpipe_case(m, seed):
    rng = np.random.RandomState(seed)
    return {"ws": (rng.randn(P, 8, 8) * 0.5).astype(np.float32),
            "bs": (rng.randn(P, 8) * 0.1).astype(np.float32),
            "xs": rng.randn(m, 4, 8).astype(np.float32)}


def _jax_stage(params, h):
    w, b = params
    return jnp.tanh(h @ w + b)


_RANKS = {}


def _ranks(tmp_path_factory):
    if not _RANKS:
        cases = [dict(_gpipe_case(m, 23 + m), name=n, kind="gpipe")
                 for n, m in GPIPE.items()]
        ranks, _ = torch_group.launch(WORKER, P, cases,
                                      tmp_path_factory.mktemp("pp"),
                                      timeout=150)
        _RANKS["cases"] = {c["name"]: c for c in cases}
        _RANKS["ranks"] = ranks
    return _RANKS["cases"], _RANKS["ranks"]


@pytest.mark.parametrize("name", sorted(GPIPE))
def test_gpipe_matches_jax(name, tmp_path_factory):
    cases, ranks = _ranks(tmp_path_factory)
    c = cases[name]
    mesh = jax_mesh.make_mesh((P,), ("pp",))
    params = (jnp.asarray(c["ws"]), jnp.asarray(c["bs"]))
    xs = jnp.asarray(c["xs"])
    want = np.asarray(jax_gpipe(_jax_stage, params, xs, mesh))
    (gw, gb), gx = jax.grad(
        lambda p, x: jnp.sum(jax_gpipe(_jax_stage, p, x, mesh) ** 2),
        argnums=(0, 1))(params, xs)
    for r, res in enumerate(ranks):
        got = res[name]
        np.testing.assert_allclose(got["out"], want, **FWD_TOL,
                                   err_msg=f"rank {r}")
        # the microbatches are replicated in: every rank's gradient
        np.testing.assert_allclose(got["gx"], np.asarray(gx), **GRAD_TOL)
        # a rank's parameter gradient is its stage's rows alone
        others = [i for i in range(P) if i != r]
        assert not got["gw"][others].any() and not got["gb"][others].any()
    np.testing.assert_allclose(sum(res[name]["gw"] for res in ranks),
                               np.asarray(gw), **GRAD_TOL)
    np.testing.assert_allclose(sum(res[name]["gb"] for res in ranks),
                               np.asarray(gb), **GRAD_TOL)
    # M hops a link each way; the first stage sends, the last receives
    m = GPIPE[name]
    assert ranks[0][name]["calls"]["pipe_send"] == m
    assert "pipe_send" not in ranks[P - 1][name]["calls"]
    assert ranks[P - 1][name]["calls"]["pipe_send_bwd"] == m


# --- PipelineTranspiler -----------------------------------------------------

def _build_mlp(fluid):
    """tests/test_program_pipeline.py's 4-layer MLP: three cut points."""
    x = fluid.layers.data(name="x", shape=[16], dtype="float32")
    y = fluid.layers.data(name="y", shape=[1], dtype="float32")
    hs, h = [], x
    for i, size in enumerate((32, 32, 16)):
        h = fluid.layers.fc(input=h, size=size, act="tanh",
                            param_attr=fluid.ParamAttr(name=f"w{i + 1}"),
                            bias_attr=fluid.ParamAttr(name=f"b{i + 1}"))
        hs.append(h)
    pred = fluid.layers.fc(input=h, size=1,
                           param_attr=fluid.ParamAttr(name="w4"),
                           bias_attr=fluid.ParamAttr(name="b4"))
    loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
    return loss, hs


def _batches(steps, bsz=32):
    rng = np.random.RandomState(0)
    w = rng.randn(16, 1).astype(np.float32)
    out = []
    for _ in range(steps):
        xs = rng.randn(bsz, 16).astype(np.float32)
        out.append({"x": xs, "y": (np.tanh(xs) @ w).astype(np.float32)})
    return out


def _jax_pipeline(build, opt, cuts_of, feeds, m):
    """The JAX PipelineTrainer's losses, its startup's state and the state
    after the steps."""
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.unique_name.guard(), jfluid.program_guard(main, startup):
        loss, cuts = build(jfluid)
    cuts = cuts_of(main, cuts)
    trainer = JaxPipelineTranspiler().transpile(
        loss, cut_vars=cuts, optimizer=lambda: opt(jfluid),
        num_microbatches=m)
    scope = jax_executor.Scope()
    with jax_executor.scope_guard(scope):
        trainer.startup(startup)
        init = {n: np.asarray(scope.find_var(n)) for n in scope.vars}
        losses = [trainer.train_step(f) for f in feeds]
        state = {n: np.asarray(scope.find_var(n)) for n in init}
    return losses, init, state


def _port_pipeline(build, opt, cuts_of, feeds, m, init):
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        loss, cuts = build(pt)
    trainer = pt.parallel.PipelineTranspiler().transpile(
        loss, cut_vars=cuts_of(main, cuts), optimizer=lambda: opt(pt),
        num_microbatches=m, places=[pt.CPUPlace()])
    scope = pt.Scope()
    trainer.startup(startup, scope=scope)
    pt.interop.load_numpy_params(scope, init, torch.device("cpu"))
    losses = [trainer.train_step(f, scope=scope) for f in feeds]
    return losses, {n: np.asarray(scope.find_var(n)) for n in init
                    if scope.find_var(n) is not None}, trainer


def _port_one_device(build, opt, feeds, init):
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        loss, _ = build(pt)
        opt(pt).minimize(loss)
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    pt.interop.load_numpy_params(scope, init, exe.device)
    losses = [float(np.ravel(exe.run(main, feed=f, fetch_list=[loss],
                                     scope=scope)[0])[0]) for f in feeds]
    return losses, {n: np.asarray(scope.find_var(n)) for n in init
                    if scope.find_var(n) is not None}


def _sgd(reg=None):
    return lambda fluid: fluid.optimizer.SGD(
        learning_rate=0.1, regularization=None if reg is None else
        fluid.regularizer.L2Decay(reg))


def _given(main, cuts):
    return cuts


def _params(names, *states):
    return [n for n in names if all(n in s for s in states)]


@pytest.mark.parametrize("reg", [None, 1e-3], ids=["sgd", "l2_decay"])
def test_pp4_mlp_matches_jax_and_one_device(reg):
    feeds = _batches(4)
    want, init, want_state = _jax_pipeline(_build_mlp, _sgd(reg), _given,
                                           feeds, 4)
    got, got_state, trainer = _port_pipeline(_build_mlp, _sgd(reg), _given,
                                             feeds, 4, init)
    one, one_state = _port_one_device(_build_mlp, _sgd(reg), feeds, init)
    assert len(trainer.stages) == 4
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, one, **TOL)
    names = [f"{k}{i}" for i in range(1, 5) for k in "wb"]
    for n in _params(names, got_state, want_state, one_state):
        np.testing.assert_allclose(got_state[n], want_state[n], **TOL,
                                   err_msg=n)
        np.testing.assert_allclose(got_state[n], one_state[n], **TOL,
                                   err_msg=n)


def test_stage_partition_is_disjoint_and_placed(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        loss, cuts = _build_mlp(pt)
    trainer = pt.parallel.PipelineTranspiler().transpile(
        loss, cut_vars=cuts, optimizer=lambda: _sgd()(pt),
        num_microbatches=2)
    own = [set(s.param_names) for s in trainer.stages]
    for i in range(len(own)):
        for j in range(i + 1, len(own)):
            assert not (own[i] & own[j]), (own[i], own[j])
    assert set().union(*own) == {f"{k}{i}" for i in range(1, 5)
                                 for k in "wb"}
    # stage i on card i mod the cards: two cards, two stages each
    assert [s.place for s in trainer.stages] == \
        [pt.CUDAPlace(i % 2) for i in range(4)]
    assert [e.device for e in trainer.executors] == \
        [torch.device("cuda", i % 2) for i in range(4)]


def test_skip_connection_across_cut_rejected():
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[8], dtype="float32")
        y = pt.layers.data(name="y", shape=[1], dtype="float32")
        h1 = pt.layers.fc(input=x, size=8, act="tanh",
                          param_attr=pt.ParamAttr(name="sw1"))
        h2 = pt.layers.fc(input=h1, size=8, act="tanh",
                          param_attr=pt.ParamAttr(name="sw2"))
        h3 = pt.layers.elementwise_add(
            pt.layers.fc(input=h2, size=8,
                         param_attr=pt.ParamAttr(name="sw3")), h1)
        pred = pt.layers.fc(input=h3, size=1,
                            param_attr=pt.ParamAttr(name="sw4"))
        loss = pt.layers.mean(pt.layers.square_error_cost(pred, y))
    with pytest.raises(ValueError, match="separate the graph"):
        pt.parallel.PipelineTranspiler().transpile(
            loss, cut_vars=[h2], optimizer=lambda: _sgd()(pt),
            num_microbatches=2, places=[pt.CPUPlace()])


def test_lod_feed_refused():
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        loss, cuts = _build_mlp(pt)
    trainer = pt.parallel.PipelineTranspiler().transpile(
        loss, cut_vars=cuts, optimizer=lambda: _sgd()(pt),
        num_microbatches=2, places=[pt.CPUPlace()])
    feed = _batches(1)[0]
    feed["x"] = pt.LoDTensor(feed["x"], [[0, 16, 32]])
    with pytest.raises(ValueError, match="LoDTensor"):
        trainer.train_step(feed)


LM = {"seqlen": 16, "n_layer": 2, "d_model": 32, "n_head": 2, "vocab": 64,
      "batch": 8, "lr": 1e-3}


def _build_lm(fluid):
    t = LM["seqlen"]
    tok = fluid.layers.data(name="tok", shape=[-1, t], dtype="int64",
                            append_batch_size=False)
    lab = fluid.layers.data(name="lab", shape=[-1, t], dtype="int64",
                            append_batch_size=False)
    loss = fluid.models.transformer_lm(
        tok, lab, vocab_size=LM["vocab"], d_model=LM["d_model"],
        n_head=LM["n_head"], n_layer=LM["n_layer"])
    return loss, None


def _lm_cuts(main, _cuts):
    return chip_smoke.lm_stage_cuts(main, LM["n_layer"])


def test_lm_cut_per_layer_matches_jax_and_one_device():
    rng = np.random.RandomState(4)
    feeds = []
    for _ in range(3):
        tok = rng.randint(0, LM["vocab"], (LM["batch"], LM["seqlen"] + 1))
        feeds.append({"tok": tok[:, :-1].astype(np.int64),
                      "lab": tok[:, 1:].astype(np.int64)})
    adam = lambda fluid: fluid.optimizer.Adam(learning_rate=LM["lr"])  # noqa: E731
    want, init, want_state = _jax_pipeline(_build_lm, adam, _lm_cuts, feeds,
                                           2)
    got, got_state, trainer = _port_pipeline(_build_lm, adam, _lm_cuts,
                                             feeds, 2, init)
    one, one_state = _port_one_device(_build_lm, adam, feeds, init)
    assert len(trainer.stages) == LM["n_layer"]
    assert any("pos_emb" in s for s in trainer.stages[0].param_names)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, one, **TOL)
    params = [n for s in trainer.stages for n in s.param_names]
    for n in params:
        np.testing.assert_allclose(got_state[n], one_state[n], rtol=1e-4,
                                   atol=1e-6, err_msg=n)
