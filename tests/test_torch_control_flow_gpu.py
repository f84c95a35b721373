"""Control flow on the card (Executor.run on a CUDA place).

  * An `rnn` step is graphed: the machine-translation chapter's seq2seq
    (chip_smoke.mt_train_net at the book's widths, a DynamicRNN decoder
    with attention) fed LoDTensors, its warm-up, capture and replays
    bitwise the eager steps (losses and every scope tensor), the rnn grad
    re-running its loop once an eager step (and once in the warm-up and
    the capture), never in a replay.
  * A `while` runs eager under the gate's reason "control_flow", its
    condition read on the host once an iteration (and once at the exit),
    counted in COUNTERS.host_syncs; the beam decode's ids and scores are
    those of the same program on the CPU from the same weights.
  * The tensor arrays, beam_search, beam_search_decode and an rnn step
    read nothing on the host: their lowerings run under
    `torch.cuda.set_sync_debug_mode("error")`.

The card has no CPU mode for the graphs, so every test here skips without
a CUDA device. This file imports no JAX: run it on the card without the
suite's conftest,

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_control_flow_gpu.py

Tolerances: the graphed steps bitwise; the card's decode against the CPU's
ids exact, scores within rtol 1e-4 / atol 1e-4 (cuBLAS and the CPU sum in
another order).
"""

import torch_threads  # noqa: F401  (the cores shared among xdist workers)
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402
import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch import executor as E  # noqa: E402
from paddle_tpu_torch.ops import registry  # noqa: E402


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _build(net):
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        out = net()
    return main, startup, out


def _scopes(startup, n=2):
    scope = pt.Scope()
    pt.Executor().run(startup, scope=scope)
    init = {k: v for k, v in scope.vars.items() if isinstance(v, torch.Tensor)}
    out = []
    for _ in range(n):
        s = pt.Scope()
        for k, v in init.items():
            s.set_var(k, v.clone())
        out.append(s)
    return out, init


def _mt_feed(rng, n=8):
    pairs = chip_smoke.mt_toy_pairs(n, rng, chip_smoke.MT_BOOK["dict"])
    feed = {}
    for col, name in enumerate(("src_word_id", "target_language_word",
                                "target_language_next_word")):
        rows = [np.asarray(p[col], np.int64).reshape(-1, 1) for p in pairs]
        offs = np.concatenate([[0], np.cumsum([len(r) for r in rows])])
        feed[name] = pt.LoDTensor(np.concatenate(rows), [offs.tolist()])
    return feed


@pytest.mark.gpu
def test_rnn_step_graphed_bitwise_eager(device):
    main, startup, (_, loss, _) = _build(
        lambda: chip_smoke.mt_train_net(pt, chip_smoke.MT_BOOK, 5e-3))
    (sg, se), _ = _scopes(startup)
    exe = pt.Executor()
    assert exe.graph_gate(main, {}) is None
    feed = _mt_feed(np.random.RandomState(0))
    E.COUNTERS.reset()
    registry.RERUNS.clear()
    for _ in range(4):
        a = exe.run(main, feed=feed, fetch_list=[loss], scope=sg)[0]
        b = exe.run(main, feed=feed, fetch_list=[loss], scope=se,
                    use_jit=False)[0]
        np.testing.assert_array_equal(a, b)
    assert (E.COUNTERS.warmups, E.COUNTERS.captures, E.COUNTERS.replays) \
        == (1, 1, 3)
    assert E.COUNTERS.eager == {"use_jit": 4}
    # the warm-up, the capture and the eager steps re-run the rnn loop; a
    # replay runs no Python
    assert registry.RERUNS["rnn"] == 6
    for n, v in sg.vars.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, se.vars[n]), n


@pytest.mark.gpu
def test_while_eager_with_host_syncs_counted(device):
    cfg = chip_smoke.BEAM_BOOK
    main, startup, (_, sent, sc) = _build(
        lambda: chip_smoke.beam_decode_net(pt))
    (scope,), init = _scopes(startup, 1)
    exe = pt.Executor()
    feed = chip_smoke.beam_src_feed(pt)
    E.COUNTERS.reset()
    ids, scores = exe.run(main, feed=feed, fetch_list=[sent, sc], scope=scope)
    assert E.COUNTERS.eager == {"control_flow": 1}
    assert E.COUNTERS.host_syncs == {"while": cfg["max_len"] + 1}
    assert E.COUNTERS.captures == 0
    cpu_scope = pt.Scope()
    for k, v in init.items():
        cpu_scope.set_var(k, v.cpu())
    want = pt.Executor(pt.CPUPlace()).run(main, feed=feed,
                                          fetch_list=[sent, sc],
                                          scope=cpu_scope)
    np.testing.assert_array_equal(ids, want[0])
    np.testing.assert_allclose(scores, want[1], rtol=1e-4, atol=1e-4)


def _no_sync(exe, main, feed, scope, fetch):
    """Run the block's lowerings with any host sync raising, after one run
    that copies the static attrs' constants to the card
    (`Executor.constant`, as a graph's warm-up does)."""
    raw = {}
    for n, v in feed.items():
        E._unpack_lod(n, v, raw)
    env = {n: E._to_device(v, exe.device) for n, v in raw.items()}
    state = exe._resolve_state(main, env, scope)
    env.update({n: scope.find_var(n) for n in state})
    torch.cuda.synchronize()
    groups, drops, _ = exe._block_plan(main)
    exe._run_block(E.LoweringContext(exe, main, 0), main, dict(env), groups,
                   set(fetch), drops, set(fetch) | set(state))
    torch.cuda.synchronize()
    ctx = E.LoweringContext(exe, main, 0)
    torch.cuda.set_sync_debug_mode("error")
    try:
        exe._run_block(ctx, main, env, groups, set(fetch), drops,
                       set(fetch) | set(state))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return [env[n] for n in fetch]


@pytest.mark.gpu
def test_arrays_and_beam_ops_read_nothing_on_the_host(device):
    b, k, v, steps = 3, 4, 11, 5

    def net():
        L = pt.layers
        scores = L.data(name="scores", shape=[b, steps, k, v],
                        dtype="float32", append_batch_size=False)
        pre_ids = L.fill_constant(shape=[b, k], dtype="int64", value=0)
        pre_sc = L.fill_constant(shape=[b, k], dtype="float32", value=0.0)
        i = L.fill_constant(shape=[1], dtype="int64", value=0)
        arrs = [L.array_write(pre_ids, i, capacity=steps + 3),
                L.array_write(L.cast(pre_ids, "int32"), i,
                              capacity=steps + 3),
                L.array_write(pre_sc, i, capacity=steps + 3)]
        step_scores = L.lod_tensor_to_array(scores, L.lod_rank_table(scores))
        for s in range(steps):
            logp = L.array_read(step_scores, i)
            pre_ids, pre_sc, par = L.beam_search(pre_ids, pre_sc, logp,
                                                 beam_size=k, end_id=1)
            L.increment(i, value=1, in_place=True)
            for a, x in zip(arrs, (pre_ids, par, pre_sc)):
                L.array_write(x, i, array=a)
        sent, fin = L.beam_search_decode(arrs[0], arrs[1], scores=arrs[2],
                                         end_id=1)
        return [sent.name, fin.name, L.array_length(arrs[0]).name]
    main, startup, fetch = _build(net)
    exe = pt.Executor()
    scores = np.log(np.random.default_rng(5).dirichlet(
        np.ones(v), (b, steps, k))).astype(np.float32)
    feed = {"scores": scores}
    sent, fin, n = _no_sync(exe, main, feed, pt.Scope(), fetch)
    want = pt.Executor(pt.CPUPlace()).run(main, feed=feed, fetch_list=fetch,
                                          scope=pt.Scope())
    np.testing.assert_array_equal(sent.cpu().numpy(), want[0])
    np.testing.assert_allclose(fin.cpu().numpy(), want[1], rtol=1e-6)
    assert int(n.cpu()[0]) == steps + 1


@pytest.mark.gpu
def test_rnn_step_reads_nothing_on_the_host(device):
    main, startup, (_, loss, _) = _build(
        lambda: chip_smoke.mt_train_net(pt, chip_smoke.MT_BOOK, 5e-3))
    (scope,), _ = _scopes(startup, 1)
    out, = _no_sync(pt.Executor(), main, _mt_feed(np.random.RandomState(1)),
                    scope, [loss.name])
    assert torch.isfinite(out).all()
