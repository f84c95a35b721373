"""The graphed training step on the card (Executor.run on a CUDA place: one
CUDA graph per step signature) against the eager step (use_jit=False).

  * A small ResNet (a 3x3 stem conv_bn_layer, one bottleneck of 128
    channels, pool, fc) and a small LM (2 layers, d_model 128, 2 heads of
    64, T 256, use_flash=True) under AMP O2: four graphed steps (a warm-up,
    the capture, two replays) bitwise four eager steps from the same state
    and batches, losses and every scope tensor. A replay calls no kernel
    wrapper (their launch counters stay), and the profiler's trace of a
    replay holds the hand-written kernels of an eager step's trace, each
    as many times.
  * Two scopes graphed on one Executor, on different batches: each
    bitwise its eager twin, no tensor shared between them.
  * A scope variable replaced between runs is copied into its buffer
    before the replay, and the step stays bitwise the eager one.
  * A new feed shape warms up and captures a graph of its own.
  * A program with a random op runs graphed: each replay draws what the
    eager step of the same run counter draws, and each step draws anew.

The card has no CPU mode for the graphs, so every test here skips without a
CUDA device. This file imports no JAX: run it on the card without the
suite's conftest,

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_graph_gpu.py

Tolerances: none; every comparison is bitwise.
"""

import torch_threads  # noqa: F401  (the cores shared among xdist workers)
import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import executor as E
from paddle_tpu_torch.models import resnet
from paddle_tpu_torch.ops import attention_cuda, bn_cuda, conv_cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("CUDA graphs need a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _resnet():
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        img = pt.layers.data(name="img", shape=[3, 16, 16], dtype="float32")
        label = pt.layers.data(name="label", shape=[1], dtype="int64")
        x = resnet.conv_bn_layer(img, 128, 3, 1, 1)
        x = resnet.bottleneck(x, 128, 128, 2)
        x = pt.layers.pool2d(x, pool_size=8, pool_type="avg",
                             global_pooling=True)
        loss = pt.layers.mean(pt.layers.softmax_with_cross_entropy(
            pt.layers.fc(x, size=10), label))
        opt = pt.optimizer.Momentum(learning_rate=0.05, momentum=0.9)
        pt.amp.decorate(opt, level="O2").minimize(loss)
    return main, startup, loss


def _resnet_feeds(n, batch=4, seed=0):
    rng = np.random.default_rng(seed)
    return [{"img": rng.standard_normal((batch, 3, 16, 16)).astype(np.float32),
             "label": rng.integers(0, 10, (batch, 1)).astype(np.int64)}
            for _ in range(n)]


def _lm():
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        tok = pt.layers.data(name="tok", shape=[-1, 256], dtype="int64",
                             append_batch_size=False)
        lab = pt.layers.data(name="lab", shape=[-1, 256], dtype="int64",
                             append_batch_size=False)
        loss = pt.models.transformer_lm(tok, lab, vocab_size=512,
                                        d_model=128, n_head=2, n_layer=2,
                                        use_flash=True)
        opt = pt.optimizer.Adam(learning_rate=1e-3)
        pt.amp.decorate(opt, level="O2").minimize(loss,
                                                  startup_program=startup)
    return main, startup, loss


def _lm_feeds(n, batch=2, seed=0):
    rng = np.random.default_rng(seed)
    return [{"tok": rng.integers(0, 512, (batch, 256)).astype(np.int64),
             "lab": rng.integers(0, 512, (batch, 256)).astype(np.int64)}
            for _ in range(n)]


MODELS = {"resnet": (_resnet, _resnet_feeds), "lm": (_lm, _lm_feeds)}


def _two_scopes(build, n=2):
    main, startup, loss = build()
    scope = pt.Scope()
    pt.Executor().run(startup, scope=scope)
    scopes = []
    for _ in range(n):
        s = pt.Scope()
        for n, v in scope.vars.items():
            s.set_var(n, v.clone() if isinstance(v, torch.Tensor) else v)
        scopes.append(s)
    return main, loss, scopes


def _same_scopes(a, b):
    bad = [n for n, v in a.vars.items() if isinstance(v, torch.Tensor)
           and not torch.equal(v, b.vars[n])]
    assert not bad, bad[:8]


# the hand-written kernels' names in the profiler's events
KERNELS = ("conv2d_fwd_kernel", "conv2d_wgrad_kernel", "_bn_apply_body",
           "bn_act_kernel", "flash_fwd_kernel", "flash_dq_kernel",
           "flash_dkv_kernel", "splitk_reduce_kernel", "stats_rows_kernel",
           "stats_reduce_kernel", "wgrad_reduce_kernel")


def _traced_kernels(step):
    """The hand-written kernels in the profiler's trace of `step()`, by
    full name, with their counts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    counts = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and \
                any(k in e.name for k in KERNELS):
            counts[e.name] = counts.get(e.name, 0) + 1
    return counts


def _launches():
    c, b, a = conv_cuda.COUNTERS, bn_cuda.COUNTERS, attention_cuda.COUNTERS
    return (c.dgrad_launches, c.wgrad_launches, c.stats_launches, c.launches,
            b.apply_launches, b.act_launches, a.launches, a.dq_launches,
            a.dkv_launches)


@pytest.mark.gpu
@pytest.mark.parametrize("model", sorted(MODELS))
def test_graphed_steps_bitwise_eager(device, model):
    build, feeds_of = MODELS[model]
    main, loss, (sg, se) = _two_scopes(build)
    exe = pt.Executor()
    E.COUNTERS.reset()
    got, want, per_step = [], [], []
    for feed in feeds_of(4):
        before = _launches()
        got.append(exe.run(main, feed=feed, fetch_list=[loss], scope=sg)[0])
        mid = _launches()
        want.append(exe.run(main, feed=feed, fetch_list=[loss], scope=se,
                            use_jit=False)[0])
        after = _launches()
        per_step.append((tuple(m - b for m, b in zip(mid, before)),
                         tuple(a - m for a, m in zip(after, mid))))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    _same_scopes(sg, se)
    assert (E.COUNTERS.warmups, E.COUNTERS.captures, E.COUNTERS.replays) \
        == (1, 1, 3)
    assert E.COUNTERS.eager == {"use_jit": 4}
    # the warm-up and the capture call the wrappers, a replay none
    for i, (graphed, eager) in enumerate(per_step):
        assert any(eager), eager
        assert graphed == (eager if i < 2 else (0,) * len(eager)), i
    feed = feeds_of(5)[4]
    replayed = _traced_kernels(lambda: exe.run(main, feed=feed,
                                               fetch_list=[loss], scope=sg))
    eager = _traced_kernels(lambda: exe.run(main, feed=feed,
                                            fetch_list=[loss], scope=se,
                                            use_jit=False))
    assert eager and replayed == eager, (replayed, eager)
    _same_scopes(sg, se)


@pytest.mark.gpu
@pytest.mark.parametrize("model", sorted(MODELS))
def test_two_scopes_graphed_on_one_executor(device, model):
    build, feeds_of = MODELS[model]
    main, loss, (sa, sb, ea, eb) = _two_scopes(build, 4)
    exe = pt.Executor()
    for x, y in zip(feeds_of(4, seed=2), feeds_of(4, seed=3)):
        for scope, eager, feed in ((sa, ea, x), (sb, eb, y)):
            got = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0]
            want = exe.run(main, feed=feed, fetch_list=[loss], scope=eager,
                           use_jit=False)[0]
            np.testing.assert_array_equal(got, want)
    _same_scopes(sa, ea)
    _same_scopes(sb, eb)
    shared = [n for n, v in sa.vars.items() if isinstance(v, torch.Tensor)
              and v.data_ptr() == sb.vars[n].data_ptr()]
    assert not shared, shared[:8]


@pytest.mark.gpu
def test_replaced_scope_variable_is_copied_in(device):
    main, loss, (sg, se) = _two_scopes(_resnet)
    exe = pt.Executor()
    feeds = _resnet_feeds(4, seed=1)
    for feed in feeds[:3]:
        exe.run(main, feed=feed, fetch_list=[loss], scope=sg)
        exe.run(main, feed=feed, fetch_list=[loss], scope=se, use_jit=False)
    name = next(n for n in sg.vars if n.startswith("fc_") and
                n.endswith(".w_0"))
    new = torch.full_like(sg.find_var(name), 0.01)
    sg.set_var(name, new.clone())
    se.set_var(name, new.clone())
    before = E.COUNTERS.copied_in
    a = exe.run(main, feed=feeds[3], fetch_list=[loss], scope=sg)[0]
    b = exe.run(main, feed=feeds[3], fetch_list=[loss], scope=se,
                use_jit=False)[0]
    np.testing.assert_array_equal(a, b)
    assert E.COUNTERS.copied_in == before + 1
    _same_scopes(sg, se)


@pytest.mark.gpu
def test_new_feed_shape_captures_anew(device):
    main, loss, (sg, se) = _two_scopes(_resnet)
    exe = pt.Executor()
    E.COUNTERS.reset()
    feeds = _resnet_feeds(2) + _resnet_feeds(3, batch=6) + _resnet_feeds(1)
    for feed in feeds:
        a = exe.run(main, feed=feed, fetch_list=[loss], scope=sg)[0]
        b = exe.run(main, feed=feed, fetch_list=[loss], scope=se,
                    use_jit=False)[0]
        np.testing.assert_array_equal(a, b)
    assert (E.COUNTERS.warmups, E.COUNTERS.captures, E.COUNTERS.replays) \
        == (2, 2, 4)
    _same_scopes(sg, se)


@pytest.mark.gpu
def test_random_op_runs_eager(device):
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[8], dtype="float32")
        noise = main.global_block().create_var(name="noise", shape=[4, 8],
                                               dtype="float32")
        main.global_block().append_op(
            type="uniform_random", outputs={"Out": [noise]},
            attrs={"shape": [4, 8], "dtype": "float32", "min": -1.0,
                   "max": 1.0, "seed": 0})
        out = pt.layers.mean(pt.layers.elementwise_add(x, noise))
    exe = pt.Executor()
    E.COUNTERS.reset()
    feed = {"x": np.ones((4, 8), np.float32)}
    sg, se = pt.Scope(), pt.Scope()
    draws = [float(exe.run(main, feed=feed, fetch_list=[out],
                           scope=sg)[0][0]) for _ in range(3)]
    eager = [float(exe.run(main, feed=feed, fetch_list=[out], scope=se,
                           use_jit=False)[0][0]) for _ in range(3)]
    assert len(set(draws)) == 3 and draws == eager
    assert E.COUNTERS.eager == {"use_jit": 3}
    assert (E.COUNTERS.captures, E.COUNTERS.replays) == (1, 2)
