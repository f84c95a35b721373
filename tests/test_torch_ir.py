"""The port's IR and package rules (paddle_tpu_torch).

After a reset of each package's unique_name counters, the same model script
built through either package's layers DSL gives the same ProgramDesc JSON,
main and startup — the property that carries the JAX package's weights
across by name (interop.py). Nothing runs here: these are builds only.
"""

import ast
import os
import subprocess
import sys

import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.models import resnet as jax_resnet
import paddle_tpu_torch as pt
from paddle_tpu_torch.models import resnet as port_resnet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(REPO, "paddle_tpu_torch")


def _small(fluid, resnet):
    """The test model of tests/test_torch_serving.py."""
    img = fluid.layers.data(name="img", shape=[3, 16, 16], dtype="float32")
    x = resnet.conv_bn_layer(img, 128, 3, 1, 1, is_test=True)
    x = resnet.basicblock(x, 128, 128, 1, is_test=True)
    x = resnet.basicblock(x, 128, 256, 2, is_test=True)
    x = fluid.layers.pool2d(x, pool_size=4, pool_type="avg",
                            global_pooling=True)
    return fluid.layers.softmax(fluid.layers.fc(x, size=10))


def _resnet50(fluid, resnet):
    img = fluid.layers.data(name="img", shape=[3, 224, 224], dtype="float32")
    return fluid.layers.softmax(resnet.resnet50(img, class_dim=1000,
                                                is_test=True))


def _classifier(fluid, resnet):
    from importlib import import_module
    common = import_module(resnet.__name__.rsplit(".", 1)[0] + ".common")
    img = fluid.layers.data(name="img", shape=[3, 32, 32], dtype="float32")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    avg_cost, predict, acc = common.build_image_classifier(
        resnet.resnet_cifar10, img, label, class_dim=10, depth=8)
    return predict


def _mnist_conv(fluid, resnet):
    """recognize_digits[conv]: nets.simple_img_conv_pool twice."""
    from importlib import import_module
    models = import_module(resnet.__name__.rsplit(".", 1)[0])
    img = fluid.layers.data(name="img", shape=[1, 28, 28], dtype="float32")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    avg_cost, predict, _ = models.build_image_classifier(
        models.mnist_conv, img, label, class_dim=10)
    fluid.optimizer.Adam(learning_rate=1e-3).minimize(avg_cost)
    return predict


def _word2vec(fluid, resnet):
    """word2vec: a shared embedding, concat, cross_entropy over softmax."""
    words = [fluid.layers.data(name=f"w{i}", shape=[1], dtype="int64")
             for i in range(5)]
    embs = [fluid.layers.embedding(input=w, size=[50, 8],
                                   param_attr=fluid.ParamAttr(name="shared_w"))
            for w in words[:4]]
    hidden = fluid.layers.fc(input=fluid.layers.concat(embs, axis=1), size=16,
                             act="sigmoid")
    pred = fluid.layers.fc(input=hidden, size=50, act="softmax")
    avg_cost = fluid.layers.mean(fluid.layers.cross_entropy(pred, words[4]))
    fluid.optimizer.SGD(learning_rate=0.1).minimize(avg_cost)
    return pred


def _build(fluid, resnet, model):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        model(fluid, resnet)
    return main, startup


@pytest.mark.parametrize("model", [_small, _resnet50, _classifier,
                                   _mnist_conv, _word2vec],
                         ids=["small", "resnet50", "cifar_classifier",
                              "mnist_conv", "word2vec"])
def test_program_desc_json_equal(model):
    jmain, jstartup = _build(jfluid, jax_resnet, model)
    tmain, tstartup = _build(pt, port_resnet, model)
    assert tmain.to_json() == jmain.to_json()
    assert tstartup.to_json() == jstartup.to_json()


def test_json_round_trip_from_the_jax_package():
    jmain, _ = _build(jfluid, jax_resnet, _small)
    s = jmain.to_json()
    assert pt.Program.from_json(s).to_json() == s


def test_clone_for_test_carries_amp_and_sets_is_test():
    main, _ = _build(pt, port_resnet, _small)
    for op in main.global_block().ops:
        if "is_test" in op.desc.attrs:
            op.set_attr("is_test", False)
    pt.amp.enable(main, level="O2")
    test_prog = main.clone(for_test=True)
    assert test_prog._amp_dtype == "bfloat16" and test_prog._amp_level == "O2"
    flags = [op.attr("is_test") for op in test_prog.global_block().ops
             if "is_test" in op.desc.attrs]
    assert flags and all(flags)


def test_prune_keeps_only_the_fetch_path():
    main, _ = _build(pt, port_resnet, _classifier)
    predict = [op for op in main.global_block().ops
               if op.type == "softmax"][-1].output("Out")[0]
    pruned = main.prune(["img"], [predict])
    types = [op.type for op in pruned.global_block().ops]
    assert "accuracy" not in types and "mean" not in types
    assert types[-1] == "softmax"


def test_amp_o3_is_a_later_slice(monkeypatch):
    """O3 marks the program for quantized compute, in the mode
    PADDLE_TPU_QUANT_MODE names (int8 by default); O3 training, once a
    later slice, builds: decorate(level="O3").minimize marks the program
    and appends its backward and optimizer ops."""
    monkeypatch.delenv("PADDLE_TPU_QUANT_MODE", raising=False)
    prog = pt.amp.enable(pt.Program(), level="O3")
    assert prog._quant_mode == "int8" and prog._amp_level == "O3"
    assert pt.amp.disable(prog)._quant_mode is None
    main, _ = _build(pt, port_resnet, _classifier)
    loss = next(op for op in main.global_block().ops
                if op.type == "mean").output("Out")[0]
    opt = pt.amp.decorate(pt.optimizer.SGD(learning_rate=0.1), level="O3")
    with pt.program_guard(main, pt.Program()):
        opt.minimize(main.global_block().var(loss))
    assert main._quant_mode == "int8" and main._amp_level == "O3"
    types = [op.type for op in main.global_block().ops]
    assert "conv2d_grad" in types and "sgd" in types


def test_import_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "import paddle_tpu_torch, paddle_tpu_torch.serving, "
            "paddle_tpu_torch.errors, paddle_tpu_torch.telemetry, "
            "paddle_tpu_torch.tracing, paddle_tpu_torch.serving.batcher, "
            "paddle_tpu_torch.serving.harness, paddle_tpu_torch.serving.slo, "
            "paddle_tpu_torch.reader, paddle_tpu_torch.reader.pipeline, "
            "paddle_tpu_torch.reader.creator, paddle_tpu_torch.dataset, "
            "paddle_tpu_torch.recordio, paddle_tpu_torch.data_feeder, "
            "paddle_tpu_torch.minibatch, paddle_tpu_torch.nets, "
            "paddle_tpu_torch.models.mnist; "
            "paddle_tpu_torch.recordio._load(); "
            "assert not any(m == 'paddle_tpu' or m.startswith('paddle_tpu.') "
            "for m in sys.modules); print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("module", [
    "errors", "telemetry", "tracing", "serving.batcher", "serving.harness",
    "serving.slo", "ops.sparse_ops", "ops.sparse_cuda", "parallel.embedding",
    "parallel.emb_cache"])
def test_serving_modules_import_alone_without_jax(module):
    """Each module of the serving and sparse-embedding slices, imported
    first and alone with jax blocked, brings in neither jax nor anything of
    the JAX package."""
    code = ("import sys; sys.modules['jax'] = None; "
            f"import paddle_tpu_torch.{module}; "
            "assert not any(m == 'paddle_tpu' or m.startswith('paddle_tpu.') "
            "or m.startswith('jax') for m in sys.modules if sys.modules[m]); "
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_parallel_imports_without_jax():
    """The ring's modules (paddle_tpu_torch.parallel) import neither jax nor
    anything of the JAX package, with jax blocked."""
    code = ("import sys; sys.modules['jax'] = None; "
            "import paddle_tpu_torch.parallel.ring_attention, "
            "paddle_tpu_torch.parallel._collectives; "
            "assert not any(m == 'paddle_tpu' or m.startswith('paddle_tpu.') "
            "or m.startswith('jax') for m in sys.modules if sys.modules[m]); "
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _port_sources():
    for root, _dirs, files in os.walk(PORT_DIR):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_no_port_source_imports_jax_or_paddle_tpu():
    bad = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "paddle_tpu"):
                    bad.append(f"{os.path.relpath(path, REPO)}: {name}")
    assert not bad, bad


def test_executor_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.Executor()
    assert pt.Executor(pt.CPUPlace()).device == torch.device("cpu")


def test_tpu_place_raises():
    with pytest.raises(ValueError, match="TPUPlace"):
        pt.TPUPlace(0)
