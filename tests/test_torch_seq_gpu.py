"""Sequence models and dropout as CUDA graphs on the card (Executor.run on a
CUDA place) against the eager step (use_jit=False).

  * A small LSTM model (embedding, fc(4H) + dynamic_lstm with peepholes,
    sequence_last_step, fc, Adam) fed LoDTensors: every padded-length
    bucket is its own signature, and each bucket's warm-up, capture and
    replays are bitwise the eager steps (losses and every scope tensor).
  * More buckets than GRAPH_CACHE_SIZE: the least recently run graphs are
    evicted, and a bucket run again after its eviction warms up and
    captures anew, still bitwise.
  * No host sync while a sequence program runs: the block's lowerings run
    under `torch.cuda.set_sync_debug_mode("error")` (a length read on the
    host, `.item()`, `.tolist()` or a mask-sized index, would raise).
  * Dropout graphed: a replay's mask is the eager step's of the same run
    counter, consecutive steps draw different masks, and two runs from one
    seed draw the same masks.

The card has no CPU mode for the graphs, so every test here skips without a
CUDA device. This file imports no JAX: run it on the card without the
suite's conftest,

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_seq_gpu.py

Tolerances: none; every comparison is bitwise.
"""

import torch_threads  # noqa: F401  (the cores shared among xdist workers)
import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import executor as E


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _lstm_model(vocab=64, hidden=32):
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        words = pt.layers.data(name="words", shape=[1], dtype="int64",
                               lod_level=1)
        label = pt.layers.data(name="label", shape=[1], dtype="int64")
        emb = pt.layers.embedding(words, size=[vocab, 16])
        proj = pt.layers.fc(emb, size=4 * hidden, num_flatten_dims=2)
        h, _ = pt.layers.dynamic_lstm(proj, size=4 * hidden,
                                      use_peepholes=True)
        conv = pt.nets.sequence_conv_pool(emb, 8, 3, act="tanh",
                                          pool_type="max")
        last = pt.layers.sequence_last_step(h)
        logits = pt.layers.fc([last, conv], size=2)
        loss = pt.layers.mean(pt.layers.softmax_with_cross_entropy(
            logits, label))
        pt.optimizer.Adam(1e-2).minimize(loss)
    return main, startup, loss


def _lod_batch(rng, top, batch=4, vocab=64):
    lens = rng.integers(1, top + 1, batch)
    lens[0] = top
    ids = rng.integers(0, vocab, (int(lens.sum()), 1)).astype(np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)]).tolist()
    return {"words": pt.LoDTensor(ids, [offs]),
            "label": rng.integers(0, 2, (batch, 1)).astype(np.int64)}


def _two_scopes(startup):
    scope = pt.Scope()
    pt.Executor().run(startup, scope=scope)
    init = {n: v for n, v in scope.vars.items() if isinstance(v, torch.Tensor)}
    out = []
    for _ in range(2):
        s = pt.Scope()
        for n, v in init.items():
            s.set_var(n, v.clone())
        out.append(s)
    return out


def _same_scopes(a, b):
    for n, v in a.vars.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, b.vars[n]), n


@pytest.mark.gpu
def test_lod_buckets_graphed_bitwise_eager(device):
    main, startup, loss = _lstm_model()
    sg, se = _two_scopes(startup)
    exe = pt.Executor()
    rng = np.random.default_rng(0)
    E.COUNTERS.reset()
    tops = (5, 12, 20, 40)               # buckets 8, 16, 32, 64
    for top in tops:
        feed = _lod_batch(rng, top)
        for _ in range(3):
            a = exe.run(main, feed=feed, fetch_list=[loss], scope=sg)[0]
            b = exe.run(main, feed=feed, fetch_list=[loss], scope=se,
                        use_jit=False)[0]
            np.testing.assert_array_equal(a, b)
    n = len(tops)
    assert (E.COUNTERS.warmups, E.COUNTERS.captures, E.COUNTERS.replays) \
        == (n, n, 2 * n)
    assert E.COUNTERS.eager == {"use_jit": 3 * n}
    _same_scopes(sg, se)


@pytest.mark.gpu
def test_lod_fetch_repacks_from_a_replay(device):
    main, startup, loss = _lstm_model()
    h = next(op for op in main.global_block().ops
             if op.type == "lstm").output("Hidden")[0]
    sg, se = _two_scopes(startup)
    exe = pt.Executor()
    feed = _lod_batch(np.random.default_rng(1), 11)
    for _ in range(3):
        got = exe.run(main, feed=feed, fetch_list=[h], scope=sg,
                      return_numpy=False)[0]
        want = exe.run(main, feed=feed, fetch_list=[h], scope=se,
                       use_jit=False, return_numpy=False)[0]
        assert got.lod == want.lod == feed["words"].lod
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.gpu
def test_lru_eviction_past_the_cache(device):
    main, startup, loss = _lstm_model()
    sg, se = _two_scopes(startup)
    exe = pt.Executor()
    rng = np.random.default_rng(2)
    tops = (3, 9, 17, 33, 65, 129, 193, 257, 321, 385)  # ten buckets
    feeds = [_lod_batch(rng, t) for t in tops]
    E.COUNTERS.reset()
    for f in feeds + feeds[:2]:
        for _ in range(2):
            a = exe.run(main, feed=f, fetch_list=[loss], scope=sg)[0]
            b = exe.run(main, feed=f, fetch_list=[loss], scope=se,
                        use_jit=False)[0]
            np.testing.assert_array_equal(a, b)
    n = len(feeds) + 2
    assert E.COUNTERS.captures == n and E.COUNTERS.replays == n
    assert E.COUNTERS.evicted == n - E.GRAPH_CACHE_SIZE
    assert len(exe._graphs) == E.GRAPH_CACHE_SIZE
    _same_scopes(sg, se)


@pytest.mark.gpu
def test_no_host_sync_in_a_sequence_step(device):
    main, startup, loss = _lstm_model()
    scope = pt.Scope()
    exe = pt.Executor()
    exe.run(startup, scope=scope)
    feed = _lod_batch(np.random.default_rng(3), 13)
    raw = {}
    for n, v in feed.items():
        E._unpack_lod(n, v, raw)
    env = {n: E._to_device(v, exe.device) for n, v in raw.items()}
    state = exe._resolve_state(main, env, scope)
    env.update({n: scope.find_var(n) for n in state})
    torch.cuda.synchronize()
    ctx = E.LoweringContext(exe, main, 0)
    groups, drops, _ = exe._block_plan(main)
    torch.cuda.set_sync_debug_mode("error")
    try:
        exe._run_block(ctx, main, env, groups, {loss.name}, drops,
                       {loss.name} | set(state))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(env[loss.name]).all()


def _dropout_model(seed=7):
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[32], dtype="float32")
        h = pt.layers.fc(x, size=64, act="relu")
        d = pt.layers.dropout(h, dropout_prob=0.3)
        loss = pt.layers.mean(pt.layers.fc(d, size=1))
        pt.optimizer.SGD(0.1).minimize(loss)
    main.random_seed = startup.random_seed = seed
    mask = next(op for op in main.global_block().ops
                if op.type == "dropout").output("Mask")[0]
    return main, startup, loss, mask


@pytest.mark.gpu
def test_dropout_graphed_bitwise_eager_and_new_each_step(device):
    runs = []
    for _ in range(2):                   # two runs from the same seed
        main, startup, loss, mask = _dropout_model()
        sg, se = _two_scopes(startup)
        exe = pt.Executor()
        E.COUNTERS.reset()
        feed = {"x": np.random.default_rng(4).standard_normal(
            (16, 32)).astype(np.float32)}
        masks = []
        for _ in range(4):
            lg, mg = exe.run(main, feed=feed, fetch_list=[loss, mask],
                             scope=sg)
            le, me = exe.run(main, feed=feed, fetch_list=[loss, mask],
                             scope=se, use_jit=False)
            np.testing.assert_array_equal(lg, le)
            np.testing.assert_array_equal(mg, me)
            masks.append(mg)
        assert (E.COUNTERS.captures, E.COUNTERS.replays) == (1, 3)
        assert E.COUNTERS.eager == {"use_jit": 4}
        for a, b in zip(masks, masks[1:]):
            assert not np.array_equal(a, b)
        assert 0.5 < np.mean(masks) < 0.9
        _same_scopes(sg, se)
        runs.append(masks)
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)
