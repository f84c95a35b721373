"""Checkpoints and inference models across packages (paddle_tpu_torch/io.py
against paddle_tpu/io.py): a directory either package writes loads in the
other, and the port serves it.

The model is the small ResNet of tests/test_torch_serving.py; its weights
come from the JAX startup with batch-norm statistics drawn away from the
identity. Tolerance: f32 answers within rtol 1e-4 / atol 1e-5 (both sum in
f32, in another order); tensors read back are bitwise what was written.
"""

import torch_threads  # noqa: F401  (the cores shared among xdist workers)
import os
import pickle

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import executor as jax_executor
from paddle_tpu import io as jio
from paddle_tpu.models import resnet as jax_resnet
from paddle_tpu.serving import ServingEngine as JaxServingEngine
import paddle_tpu_torch as pt
from paddle_tpu_torch.models import resnet as port_resnet
from paddle_tpu_torch.serving import ServingEngine

BUCKETS = (1, 2, 4)


@pytest.fixture(autouse=True)
def _keep_jax_op_census():
    """The JAX executor's op census (executor._RECORDED_OPS) gets back the
    op types these runs added, as in tests/test_torch_backward.py: the
    op-coverage gate counts only its own worker's census (ROADMAP.md
    Queue 3), and parity runs must not push a worker over its line."""
    before = set(jax_executor._RECORDED_OPS)
    yield
    jax_executor._RECORDED_OPS.intersection_update(before)


def _build(fluid, resnet, train=False):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[3, 16, 16], dtype="float32")
        x = resnet.conv_bn_layer(img, 128, 3, 1, 1, is_test=not train)
        x = resnet.basicblock(x, 128, 256, 2, is_test=not train)
        x = fluid.layers.pool2d(x, pool_size=4, pool_type="avg",
                                global_pooling=True)
        logits = fluid.layers.fc(x, size=10)
        prob = fluid.layers.softmax(logits)
        if train:
            label = fluid.layers.data(name="label", shape=[1], dtype="int64")
            loss = fluid.layers.mean(
                fluid.layers.softmax_with_cross_entropy(logits, label))
            fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
            return main, startup, prob, loss
    return main, startup, prob, logits


def _arrays():
    main, startup, _, _ = _build(jfluid, jax_resnet)
    scope = jax_executor.Scope()
    with jax_executor.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
    arrays = {n: np.array(scope.find_var(n))
              for n, v in startup.global_block().desc.vars.items()
              if v.persistable}
    rng = np.random.default_rng(3)
    for op in main.global_block().ops:
        if op.type == "batch_norm":
            c = arrays[op.input("Scale")[0]].shape
            arrays[op.input("Scale")[0]] = rng.uniform(0.5, 2.0, c)
            arrays[op.input("Mean")[0]] = 0.1 * rng.standard_normal(c)
            arrays[op.input("Variance")[0]] = rng.uniform(0.5, 2.0, c)
    return {n: a.astype(np.float32) for n, a in arrays.items()}


def _input(n=2, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, 3, 16, 16)).astype(np.float32)


def _jax_scope(arrays):
    scope = jax_executor.Scope()
    for n, a in arrays.items():
        scope.set_var(n, a)
    return scope


def _port_scope(arrays):
    scope = pt.Scope()
    pt.interop.load_numpy_params(scope, arrays, "cpu")
    return scope


def _save_port(dirname, arrays, **kw):
    main, _, prob, logits = _build(pt, port_resnet)
    with pt.scope_guard(_port_scope(arrays)):
        pt.io.save_inference_model(dirname, ["img"], [prob, logits],
                                   pt.Executor(pt.CPUPlace()),
                                   main_program=main, **kw)


def _save_jax(dirname, arrays, **kw):
    main, _, prob, logits = _build(jfluid, jax_resnet)
    with jax_executor.scope_guard(_jax_scope(arrays)):
        jio.save_inference_model(dirname, ["img"], [prob, logits],
                                 jfluid.Executor(jfluid.CPUPlace()),
                                 main_program=main, **kw)


@pytest.mark.parametrize("combined", [False, True], ids=["files", "combined"])
def test_persistables_round_trip(tmp_path, combined):
    arrays = _arrays()
    main, _, _, _ = _build(pt, port_resnet)
    exe = pt.Executor(pt.CPUPlace())
    fname = "params" if combined else None
    with pt.scope_guard(_port_scope(arrays)):
        pt.io.save_persistables(exe, str(tmp_path), main, filename=fname)
    back = pt.Scope()
    with pt.scope_guard(back):
        pt.io.load_persistables(exe, str(tmp_path), main, filename=fname)
    assert set(back.vars) == set(arrays)
    for n, a in arrays.items():
        t = back.find_var(n)
        assert isinstance(t, torch.Tensor) and t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), a)
    # the JAX package reads the same directory
    jscope = jax_executor.Scope()
    jmain, _, _, _ = _build(jfluid, jax_resnet)
    with jax_executor.scope_guard(jscope):
        jio.load_persistables(jfluid.Executor(jfluid.CPUPlace()),
                              str(tmp_path), jmain, filename=fname)
    for n, a in arrays.items():
        np.testing.assert_array_equal(np.asarray(jscope.find_var(n)), a)


def test_files_hold_plain_numpy(tmp_path):
    """A variable's file unpickles with numpy alone: f32 weights stay f32,
    and a bf16 tensor is written as its exact f32 widening."""
    main, _, _, _ = _build(pt, port_resnet)
    name = next(v.name for v in main.list_vars() if v.persistable)
    scope = pt.Scope()
    value = torch.randn(4, 3).to(torch.bfloat16)
    scope.set_var(name, value)
    with pt.scope_guard(scope):
        pt.io.save_vars(None, str(tmp_path), main,
                        vars=[main.global_block().var(name)])
    with open(os.path.join(tmp_path, name), "rb") as f:
        d = pickle.load(f)
    assert d["version"] == 0 and d["lod"] is None
    assert type(d["tensor"]) is np.ndarray and d["tensor"].dtype == np.float32
    np.testing.assert_array_equal(d["tensor"], value.float().numpy())


def test_lod_round_trips_beside_the_values(tmp_path):
    """A variable saved with a LoD loads as an executor.LoDTensor of its
    rows and LoD, as the JAX package's io restores it (io.py:151-155), and
    saves back with its LoD."""
    main, _, _, _ = _build(pt, port_resnet)
    var = next(v for v in main.list_vars() if v.persistable)
    arr = np.arange(12, dtype=np.float32).reshape(6, 2)
    with open(os.path.join(tmp_path, var.name), "wb") as f:
        pickle.dump({"tensor": arr, "lod": [[0, 2, 6]], "version": 0}, f)
    scope = pt.Scope()
    with pt.scope_guard(scope):
        pt.io.load_vars(None, str(tmp_path), main, vars=[var])
        val = scope.find_var(var.name)
        assert isinstance(val, pt.LoDTensor) and val.lod == [[0, 2, 6]]
        np.testing.assert_array_equal(val.array(), arr)
        assert scope.find_var(var.name + "@LOD") is None
        pt.io.save_vars(None, str(tmp_path / "again"), main, vars=[var])
    with open(os.path.join(tmp_path, "again", var.name), "rb") as f:
        d = pickle.load(f)
    assert d["lod"] == [[0, 2, 6]]
    np.testing.assert_array_equal(d["tensor"], arr)


def _lod_state_program(fluid):
    """A persistable sequence (lod_level 1) summed per sequence and scaled:
    sequence state that only its LoD makes right."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        mem = main.global_block().create_var(
            name="seq_state", shape=[-1, -1, 3], dtype="float32",
            lod_level=1, persistable=True)
        out = fluid.layers.scale(fluid.layers.sequence_pool(mem, "sum"),
                                 scale=2.0)
    return main, mem, out


def test_lod_checkpoint_of_the_jax_package_runs_in_the_port(tmp_path):
    """A checkpoint the JAX package wrote with a LoD variable, loaded by the
    port and run, fetches what the JAX package fetches."""
    rows = np.random.RandomState(2).randn(7, 3).astype(np.float32)
    lod = [[0, 2, 3, 7]]
    jmain, jmem, jout = _lod_state_program(jfluid)
    with jax_executor.scope_guard(jax_executor.Scope()):
        jax_executor.global_scope().set_var(
            "seq_state", jax_executor.LoDTensor(rows, lod))
        jio.save_vars(None, str(tmp_path), jmain, vars=[jmem])
    jscope = jax_executor.Scope()
    with jax_executor.scope_guard(jscope):
        jio.load_vars(None, str(tmp_path), jmain, vars=[jmem])
        want, = jfluid.Executor(jfluid.CPUPlace()).run(
            jmain, fetch_list=[jout], scope=jscope)
    main, mem, out = _lod_state_program(pt)
    scope = pt.Scope()
    with pt.scope_guard(scope):
        pt.io.load_vars(None, str(tmp_path), main, vars=[mem])
    assert isinstance(scope.find_var("seq_state"), pt.LoDTensor)
    got, = pt.Executor(pt.CPUPlace()).run(main, fetch_list=[out],
                                          scope=scope)
    assert got.shape == (3, 3)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        got, 2 * np.stack([rows[0:2].sum(0), rows[2:3].sum(0),
                           rows[3:7].sum(0)]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_saved_model_serves_in_the_other_package(tmp_path, writer):
    arrays = _arrays()
    d = str(tmp_path)
    (_save_port if writer == "port" else _save_jax)(d, arrays)
    jeng = JaxServingEngine(d, place=jfluid.CPUPlace(), buckets=BUCKETS)
    want = [np.asarray(o, np.float32) for o in jeng.infer({"img": _input()})]
    eng = ServingEngine(d, place=pt.CPUPlace(), buckets=BUCKETS)
    assert eng.feed_names == ["img"] and len(eng.fetch_names) == 2
    got = eng.infer({"img": _input()})
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
    # load_inference_model gives the same program and weights
    scope = pt.Scope()
    with pt.scope_guard(scope):
        prog, feeds, fetches = pt.io.load_inference_model(
            d, pt.Executor(pt.CPUPlace()))
    direct = pt.Executor(pt.CPUPlace()).run(
        prog, feed={"img": _input()}, fetch_list=fetches, scope=scope)
    for g, w in zip(direct, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
    assert feeds == ["img"] and [v.name for v in fetches] == eng.fetch_names


def test_saved_model_serves_int8_like_the_in_memory_engine(tmp_path):
    arrays = _arrays()
    _save_port(str(tmp_path), arrays)
    from_dir = ServingEngine(str(tmp_path), place=pt.CPUPlace(),
                             buckets=BUCKETS, quantize="int8")
    main, _, prob, logits = _build(pt, port_resnet)
    in_memory = ServingEngine(main, ["img"], [prob, logits],
                              place=pt.CPUPlace(), scope=_port_scope(arrays),
                              buckets=BUCKETS, quantize="int8")
    assert from_dir.quant_report == in_memory.quant_report
    assert from_dir.program._quant_mode == "int8"
    for a, b in zip(from_dir.infer({"img": _input()}),
                    in_memory.infer({"img": _input()})):
        np.testing.assert_array_equal(a, b)


def test_save_inference_model_refuses_a_grad_target(tmp_path):
    main, startup, prob, loss = _build(pt, port_resnet, train=True)
    grad = main.global_block().var(loss.name + "@GRAD")
    exe = pt.Executor(pt.CPUPlace())
    with pytest.raises(ValueError, match="gradient"):
        pt.io.save_inference_model(str(tmp_path), ["img"], [grad], exe,
                                   main_program=main)
    # the inference slice of a training program drops the label feed
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    with pt.scope_guard(scope):
        prog = pt.io.save_inference_model(str(tmp_path), ["img", "label"],
                                          [prob], exe, main_program=main)
    with open(os.path.join(tmp_path, "__model__"), "rb") as f:
        meta = pickle.load(f)
    assert meta["feed_names"] == ["img"]
    types = [op.type for op in prog.global_block().ops]
    assert "sgd" not in types and not any(t.endswith("_grad") for t in types)
    infer_prog = pt.io.get_inference_program([prob], main)
    assert [op.type for op in infer_prog.global_block().ops] == types
