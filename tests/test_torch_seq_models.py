"""Sequence models through the port against the JAX package on the CPU:
bench.py's lstm (`chip_smoke._lstm_model`: embedding, two fc(4H) +
dynamic_lstm with peepholes, sequence_last_step, fc(2, softmax),
cross_entropy, Adam) cut to hidden 32, T 12, batch 4, vocab 50, trained 3
steps from the JAX startup's weights on dense [B, T] ids (as bench.py
feeds it) and on LoDTensor ids: the losses and every parameter and Adam
moment within rtol 1e-4, atol 1e-5 (f32; tanh and sigmoid differ in the
last ulp between the libraries, and the recurrence and Adam carry it).
And the transformer LM with dropout in training builds and trains.
"""

import torch_threads  # noqa: F401  (the cores shared among xdist workers)
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402
import paddle_tpu as jfluid  # noqa: E402
from paddle_tpu import executor as jax_executor  # noqa: E402
import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch.ops import registry  # noqa: E402

CFG = {"vocab": 50, "emb": 8, "hidden": 32, "batch": 4, "seqlen": 12,
       "lr": 2e-3}
TOL = dict(rtol=1e-4, atol=1e-5)
STEPS = 3


@pytest.fixture(autouse=True)
def _keep_jax_op_census():
    before = set(jax_executor._RECORDED_OPS)
    yield
    jax_executor._RECORDED_OPS.intersection_update(before)


def _feeds(fluid, lod):
    rng = np.random.default_rng(7)
    out = []
    for _ in range(STEPS):
        if lod:
            lens = rng.integers(2, CFG["seqlen"] + 1, CFG["batch"])
            ids = rng.integers(0, CFG["vocab"], (int(lens.sum()), 1))
            cls = pt.LoDTensor if fluid is pt else jax_executor.LoDTensor
            words = cls(ids.astype(np.int64),
                        [np.concatenate([[0], np.cumsum(lens)]).tolist()])
        else:
            words = rng.integers(0, CFG["vocab"],
                                 (CFG["batch"], CFG["seqlen"])).astype(np.int32)
        out.append({"words": words,
                    "label": rng.integers(0, 2, (CFG["batch"], 1))
                    .astype(np.int64)})
    return out


@pytest.mark.parametrize("lod", [False, True], ids=["dense", "lod"])
def test_bench_lstm_trains_as_the_jax_package(lod):
    jmain, jstartup, jloss = chip_smoke._lstm_model(jfluid, CFG)
    jscope = jax_executor.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    arrays = {n: np.asarray(jscope.find_var(n))
              for n, v in jstartup.global_block().desc.vars.items()
              if v.persistable}
    want = [float(np.ravel(jexe.run(jmain, feed=f, fetch_list=[jloss],
                                    scope=jscope)[0])[0])
            for f in _feeds(jfluid, lod)]

    main, _, loss = chip_smoke._lstm_model(pt, CFG)
    scope = pt.Scope()
    pt.interop.load_numpy_params(scope, arrays, "cpu")
    exe = pt.Executor(pt.CPUPlace())
    registry.RERUNS.clear()
    got = [float(exe.run(main, feed=f, fetch_list=[loss],
                         scope=scope)[0].ravel()[0])
           for f in _feeds(pt, lod)]
    assert registry.RERUNS["lstm"] == 0
    np.testing.assert_allclose(got, want, **TOL)
    for n in arrays:
        np.testing.assert_allclose(scope.find_var(n).numpy(),
                                   np.asarray(jscope.find_var(n)),
                                   err_msg=n, **TOL)


def test_transformer_lm_with_dropout_trains():
    """dropout_prob > 0 in training: the program holds the dropout, steps
    run, the loss stays finite and falls on a repeated batch, and two
    steps draw different masks."""
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        tok = pt.layers.data(name="tok", shape=[-1, 16], dtype="int64",
                             append_batch_size=False)
        lab = pt.layers.data(name="lab", shape=[-1, 16], dtype="int64",
                             append_batch_size=False)
        loss = pt.models.transformer_lm(tok, lab, vocab_size=32, d_model=32,
                                        n_head=2, n_layer=2,
                                        dropout_prob=0.1)
        pt.optimizer.Adam(learning_rate=3e-3).minimize(loss)
    mask = next(o for o in main.global_block().ops
                if o.type == "dropout").output("Mask")[0]
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.default_rng(8)
    feed = {"tok": rng.integers(0, 32, (2, 16)), "lab": rng.integers(0, 32, (2, 16))}
    losses, masks = [], []
    for _ in range(12):
        lv, mv = exe.run(main, feed=feed, fetch_list=[loss, mask], scope=scope)
        losses.append(float(lv.ravel()[0]))
        masks.append(mv)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert not np.array_equal(masks[0], masks[1])
    assert torch.isfinite(scope.find_var("pos_emb")).all()
