"""The CRF, CTC, eval and beam-search ops through the port against the
JAX package on the CPU, at ragged lengths: linear_chain_crf's negative
log-likelihood and its grads (emission and transition), crf_decoding's
Viterbi paths and its correctness indicator, ties included; every case of
tests/test_ctc_eval_ops.py (warpctc against a brute-force path
enumeration and training down, ctc_align, edit_distance against a
Levenshtein oracle, chunk_eval, precision_recall, positive_negative_pair,
the ChunkEvaluator and EditDistance metrics), warpctc's grads with and
without norm_by_times, ctc_greedy_decoder; beam_search with frozen lanes
and ties,
beam_search_decode with an array capacity past the steps written. The
same programs are built in both packages and fed the same numpy inputs
from a seed: f32 outputs within rtol 1e-5 / atol 1e-6, grads within rtol
1e-4, ids, parents, paths and counts exact.
"""

import torch_threads  # noqa: F401  (the cores shared among xdist workers)
import itertools

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import executor as jax_executor
import paddle_tpu_torch as pt
from paddle_tpu_torch import executor as pt_executor

F32 = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
RNG = np.random.RandomState(3)


@pytest.fixture(autouse=True)
def _keep_jax_op_census():
    before = set(jax_executor._RECORDED_OPS)
    yield
    jax_executor._RECORDED_OPS.intersection_update(before)


def _ex(fluid):
    return pt_executor if fluid is pt else jax_executor


def make_lod(fluid, rows):
    offs = np.concatenate([[0], np.cumsum([len(r) for r in rows])]).tolist()
    return _ex(fluid).LoDTensor(np.concatenate(rows, axis=0), [offs])


def run_both(build, feed, return_numpy=True):
    """`build(fluid)` -> fetch list; `feed(fluid)` -> one feed dict. Runs
    the JAX startup, carries it to the port, runs both -> (want, got)."""
    out, arrays = {}, None
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
        out[fluid] = exe.run(main, feed=feed(fluid), fetch_list=targets,
                             scope=scope, return_numpy=return_numpy)
    return out[jfluid], out[pt]


def assert_same(want, got, tol=F32):
    for w, g in zip(want, got):
        if isinstance(w, jax_executor.LoDTensor):
            assert isinstance(g, pt_executor.LoDTensor) and g.lod == w.lod
            w, g = w.array(), g.array()
        w, g = np.asarray(w), np.asarray(g)
        assert g.shape == w.shape
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, **tol)
        else:
            np.testing.assert_array_equal(g.astype(np.int64),
                                          w.astype(np.int64))


# --- linear-chain CRF ------------------------------------------------------------

D = 5
LENS = (4, 1, 7, 3)


def _crf(fluid, with_label_decode=False):
    L = fluid.layers
    em = L.data(name="em", shape=[D], dtype="float32", lod_level=1,
                stop_gradient=False)
    lab = L.data(name="lab", shape=[1], dtype="int64", lod_level=1)
    proj = L.fc(input=em, size=D, num_flatten_dims=2)
    nll = L.linear_chain_crf(input=proj, label=lab,
                             param_attr=fluid.ParamAttr(name="crfw"))
    fluid.backward.append_backward(L.mean(nll))
    path = L.crf_decoding(input=proj, param_attr=fluid.ParamAttr(name="crfw"),
                          label=lab if with_label_decode else None)
    return [nll, path, "crfw@GRAD", "em@GRAD"]


def _crf_feed(seed, ties=False):
    rng = np.random.RandomState(seed)

    def feed(fluid):
        if ties:
            ems = [np.zeros((n, D), np.float32) for n in LENS]
        else:
            ems = [rng.randn(n, D).astype(np.float32) for n in LENS]
        labs = [rng.randint(0, D, (n, 1)).astype(np.int64) for n in LENS]
        rng.seed(seed)
        return {"em": make_lod(fluid, ems), "lab": make_lod(fluid, labs)}
    return feed


@pytest.mark.parametrize("label_decode", [False, True],
                         ids=["path", "indicator"])
def test_crf_nll_grads_and_viterbi(label_decode):
    want, got = run_both(lambda f: _crf(f, label_decode), _crf_feed(11))
    assert_same(want[:2], got[:2])
    assert_same(want[2:], got[2:], GRAD)
    path = got[1]
    assert path.shape == (sum(LENS), 1)
    if label_decode:
        assert set(np.unique(path)) <= {0, 1}
    else:
        assert (path >= 0).all() and (path < D).all()


def test_crf_viterbi_ties_take_the_first_tag():
    """Zero emissions and a zero transition: every tag ties, and the
    Viterbi path is tag 0 throughout, as jnp.argmax takes the first."""
    def build(fluid):
        L = fluid.layers
        em = L.data(name="em", shape=[D], dtype="float32", lod_level=1)
        lab = L.data(name="lab", shape=[1], dtype="int64", lod_level=1)
        L.linear_chain_crf(input=em, label=lab,
                           param_attr=fluid.ParamAttr(
                               name="crfw", initializer=fluid.initializer
                               .Constant(0.0)))
        return [L.crf_decoding(input=em,
                               param_attr=fluid.ParamAttr(name="crfw"))]
    want, got = run_both(build, _crf_feed(2, ties=True))
    assert_same(want, got)
    assert (got[0] == 0).all()


# --- CTC ------------------------------------------------------------------------

def ctc_loss_brute(probs, label, blank):
    t, c = probs.shape
    total = 0.0
    for path in itertools.product(range(c), repeat=t):
        collapsed, prev = [], -1
        for p in path:
            if p != blank and p != prev:
                collapsed.append(p)
            prev = p
        if collapsed == list(label):
            total += np.prod([probs[i, p] for i, p in enumerate(path)])
    return -np.log(max(total, 1e-300))


def test_warpctc_vs_bruteforce():
    t, c = 4, 3
    logits = RNG.randn(2, t, c).astype(np.float32)
    rows_logits = [logits[0], logits[1, :3]]
    labels = [np.array([[1], [2]], np.int64), np.array([[2]], np.int64)]

    def build(fluid):
        x = fluid.layers.data(name="logits", shape=[c], dtype="float32",
                              lod_level=1)
        lbl = fluid.layers.data(name="label", shape=[1], dtype="int64",
                                lod_level=1)
        return [fluid.layers.warpctc(input=x, label=lbl, blank=0)]
    want, got = run_both(build, lambda f: {"logits": make_lod(f, rows_logits),
                                           "label": make_lod(f, labels)})
    assert_same(want, got)

    def softmax(z):
        e = np.exp(z - z.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True)
    np.testing.assert_allclose(
        np.asarray(got[0]).reshape(-1),
        [ctc_loss_brute(softmax(rows_logits[0]), [1, 2], 0),
         ctc_loss_brute(softmax(rows_logits[1]), [2], 0)], rtol=1e-4)


@pytest.mark.parametrize("norm_by_times", [False, True])
def test_warpctc_grads(norm_by_times):
    t, c, h = 6, 5, 4
    rng = np.random.RandomState(9)
    xs = [rng.randn(n, h).astype(np.float32) for n in (6, 4, 5)]
    labs = [np.array([[1], [2], [2]], np.int64), np.array([[3]], np.int64),
            np.array([[4], [1]], np.int64)]

    def build(fluid):
        L = fluid.layers
        x = L.data(name="x", shape=[h], dtype="float32", lod_level=1)
        lbl = L.data(name="label", shape=[1], dtype="int64", lod_level=1)
        proj = L.fc(input=x, size=c, num_flatten_dims=2,
                    param_attr=fluid.ParamAttr(name="ctc_w"))
        loss = L.warpctc(input=proj, label=lbl, blank=0,
                         norm_by_times=norm_by_times)
        fluid.backward.append_backward(L.mean(loss))
        return [loss, "ctc_w@GRAD"]
    want, got = run_both(build, lambda f: {"x": make_lod(f, xs),
                                           "label": make_lod(f, labs)})
    assert_same(want[:1], got[:1])
    assert_same(want[1:], got[1:], GRAD)


def test_warpctc_grad_descends():
    """tests/test_ctc_eval_ops.py's training check: 12 SGD 0.5 steps on one
    sequence take the loss below 0.8 of the first."""
    t, c, h = 5, 4, 6
    x0 = np.random.RandomState(3).randn(t, h).astype(np.float32)
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[h], dtype="float32", lod_level=1)
        lbl = pt.layers.data(name="label", shape=[1], dtype="int64",
                             lod_level=1)
        proj = pt.layers.fc(input=x, size=c, num_flatten_dims=2)
        avg = pt.layers.mean(pt.layers.warpctc(input=proj, label=lbl, blank=0))
        pt.optimizer.SGD(learning_rate=0.5).minimize(avg)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    feed = {"x": make_lod(pt, [x0]),
            "label": make_lod(pt, [np.array([[1], [2]], np.int64)])}
    vals = [float(exe.run(main, feed=feed, fetch_list=[avg],
                          scope=scope)[0].ravel()[0]) for _ in range(12)]
    assert vals[-1] < vals[0] * 0.8, vals


def test_ctc_align_merge_and_blank():
    rows = [np.array([[0], [1], [1], [0], [2], [2]], np.int32),
            np.array([[3], [0], [3]], np.int32)]

    def build(fluid):
        x = fluid.layers.data(name="x", shape=[1], dtype="int32", lod_level=1)
        return [fluid.layers.ctc_align(x, blank=0)]
    want, got = run_both(build, lambda f: {"x": make_lod(f, rows)},
                         return_numpy=False)
    assert_same(want, got)
    lod, arr = got[0].lod[0], got[0].array()
    assert [arr[lod[i]:lod[i + 1]].reshape(-1).tolist()
            for i in range(len(lod) - 1)] == [[1, 2], [3, 3]]


def test_ctc_greedy_decoder():
    rng = np.random.RandomState(5)
    probs = [rng.rand(n, 4).astype(np.float32) for n in (6, 3, 5)]

    def build(fluid):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32",
                              lod_level=1)
        return [fluid.layers.ctc_greedy_decoder(x, blank=0)]
    want, got = run_both(build, lambda f: {"x": make_lod(f, probs)},
                         return_numpy=False)
    assert_same(want, got)


@pytest.mark.parametrize("normalized", [False, True])
def test_edit_distance_vs_oracle(normalized):
    hyps = [np.array([[1], [2], [3]], np.int64), np.array([[5], [5]], np.int64)]
    refs = [np.array([[1], [3]], np.int64),
            np.array([[5], [6], [7]], np.int64)]

    def lev(a, b):
        d = np.zeros((len(a) + 1, len(b) + 1))
        d[:, 0], d[0, :] = np.arange(len(a) + 1), np.arange(len(b) + 1)
        for i in range(1, len(a) + 1):
            for j in range(1, len(b) + 1):
                d[i, j] = min(d[i - 1, j] + 1, d[i, j - 1] + 1,
                              d[i - 1, j - 1] + (a[i - 1] != b[j - 1]))
        return d[-1, -1]

    def build(fluid):
        h = fluid.layers.data(name="h", shape=[1], dtype="int64", lod_level=1)
        r = fluid.layers.data(name="r", shape=[1], dtype="int64", lod_level=1)
        return list(fluid.layers.edit_distance(h, r, normalized=normalized))
    want, got = run_both(build, lambda f: {"h": make_lod(f, hyps),
                                           "r": make_lod(f, refs)})
    assert_same(want, got)
    expect = np.array([lev(h.ravel(), r.ravel()) for h, r in zip(hyps, refs)])
    if normalized:
        expect = expect / np.array([2.0, 3.0])
    np.testing.assert_allclose(np.asarray(got[0]).reshape(-1), expect,
                               rtol=1e-5)
    assert int(np.asarray(got[1]).reshape(-1)[0]) == 2


# --- beam search -------------------------------------------------------------------

B, K, V, END = 3, 4, 7, 1


def _beam_step(fluid):
    L = fluid.layers
    pre_ids = L.data(name="pre_ids", shape=[B, K], dtype="int64",
                     append_batch_size=False)
    pre_scores = L.data(name="pre_scores", shape=[B, K], dtype="float32",
                        append_batch_size=False)
    scores = L.data(name="scores", shape=[B, K, V], dtype="float32",
                    append_batch_size=False)
    return list(L.beam_search(pre_ids=pre_ids, pre_scores=pre_scores,
                              scores=scores, beam_size=K, end_id=END))


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_beam_search_frozen_lanes_and_ties(ties):
    """Lanes whose last id is END only extend by END at +0; with scores on
    a coarse grid (and equal frozen lanes) candidates tie, and the lower
    flat index wins, as lax.top_k takes it."""
    rng = np.random.RandomState(6)
    pre_ids = rng.randint(2, V, (B, K)).astype(np.int64)
    pre_ids[0, 1] = pre_ids[1, 0] = pre_ids[1, 2] = pre_ids[2, 3] = END
    pre_scores = -rng.rand(B, K).astype(np.float32)
    scores = np.log(rng.dirichlet(np.ones(V), (B, K))).astype(np.float32)
    if ties:
        pre_scores = np.round(pre_scores * 2) / 2
        pre_scores[1, 0] = pre_scores[1, 2]
        scores = np.round(scores * 2).astype(np.float32) / 2
    feed = {"pre_ids": pre_ids, "pre_scores": pre_scores, "scores": scores}
    want, got = run_both(_beam_step, lambda f: dict(feed))
    assert_same(want, got)
    ids, sc, parent = got
    assert (np.diff(sc, axis=1) <= 0).all()
    # a frozen parent's child is END at the parent's score
    frozen = pre_ids[np.arange(B)[:, None], parent] == END
    assert (ids[frozen] == END).all()
    np.testing.assert_array_equal(
        sc[frozen], pre_scores[np.arange(B)[:, None], parent][frozen])


def _decode_arrays(fluid, steps, capacity):
    """`steps` [B, K] steps of ids, parents and scores, fed one var a step
    and written to arrays of `capacity` at device indices, backtracked."""
    L = fluid.layers
    arrays = [None, None, None]
    for s in range(steps):
        i = L.fill_constant(shape=[1], dtype="int64", value=s)
        for a, (name, dtype) in enumerate((("ids", "int64"),
                                           ("par", "int32"),
                                           ("sc", "float32"))):
            row = L.data(name=f"{name}{s}", shape=[B, K], dtype=dtype,
                         append_batch_size=False)
            arrays[a] = L.array_write(row, i, array=arrays[a],
                                      capacity=capacity)
    return list(L.beam_search_decode(arrays[0], arrays[1], scores=arrays[2],
                                     end_id=END))


@pytest.mark.parametrize("capacity", [5, 9], ids=["full", "slack"])
def test_beam_search_decode_backtracks(capacity):
    """Five steps of random parents backtracked: each lane's tokens from
    step 0, END past the steps written; the scores the last step's."""
    steps = 5
    rng = np.random.RandomState(8)
    feed = {}
    for s in range(steps):
        feed[f"ids{s}"] = rng.randint(2, V, (B, K)).astype(np.int64)
        feed[f"par{s}"] = rng.randint(0, K, (B, K)).astype(np.int32)
        feed[f"sc{s}"] = -rng.rand(B, K).astype(np.float32)
    want, got = run_both(lambda f: _decode_arrays(f, steps, capacity),
                         lambda f: dict(feed))
    assert_same(want, got)
    sent, final = got
    assert sent.shape == (B, K, capacity)
    assert (sent[:, :, steps:] == END).all()
    np.testing.assert_array_equal(final, feed[f"sc{steps - 1}"])
    # lane 0 of row 0, backtracked by hand
    lane, toks = 0, []
    for s in range(steps - 1, -1, -1):
        toks.append(feed[f"ids{s}"][0, lane])
        lane = feed[f"par{s}"][0, lane]
    np.testing.assert_array_equal(sent[0, 0, :steps], toks[::-1])


# --- the eval ops and evaluators -----------------------------------------------------

def _chunk(fluid, **attrs):
    inf = fluid.layers.data(name="inf", shape=[1], dtype="int64", lod_level=1)
    lab = fluid.layers.data(name="lab", shape=[1], dtype="int64", lod_level=1)
    return list(fluid.layers.chunk_eval(input=inf, label=lab, **attrs))


@pytest.mark.parametrize("case", ["iob", "plain_multiseq", "excluded"])
def test_chunk_eval(case):
    """tests/test_ctc_eval_ops.py's three chunk_eval cases: IOB, the plain
    scheme over two sequences, an excluded type; (precision, recall, F1,
    chunk counts) as the JAX package's and the case's expectation."""
    if case == "iob":
        lab = [np.array([[0], [1], [4], [2]], np.int64)]
        inf = [np.array([[0], [1], [4], [0]], np.int64)]
        attrs, counts = dict(chunk_scheme="IOB", num_chunk_types=2), (2, 2, 1)
    elif case == "plain_multiseq":
        lab = [np.array([[1], [1], [3], [0]], np.int64),
               np.array([[2], [3]], np.int64)]
        inf = [np.array([[1], [1], [3], [3]], np.int64),
               np.array([[2], [2]], np.int64)]
        attrs, counts = dict(chunk_scheme="plain", num_chunk_types=3), \
            (2, 3, 1)
    else:
        lab = [np.array([[0], [2]], np.int64)]
        inf = [np.array([[0], [2]], np.int64)]
        attrs = dict(chunk_scheme="plain", num_chunk_types=4,
                     excluded_chunk_types=[0])
        counts = (2, 2, 1)
    want, got = run_both(lambda f: _chunk(f, **attrs),
                         lambda f: {"inf": make_lod(f, inf),
                                    "lab": make_lod(f, lab)})
    assert_same(want, got)
    assert tuple(int(np.ravel(v)[0]) for v in got[3:]) == counts
    if case == "iob":
        np.testing.assert_allclose([float(np.ravel(v)[0]) for v in got[:3]],
                                   [0.5, 0.5, 0.5])


def test_precision_recall_vs_oracle():
    n, c = 12, 4
    rng = np.random.RandomState(12)
    idx = rng.randint(0, c, (n, 1)).astype(np.int32)
    lab = rng.randint(0, c, (n, 1)).astype(np.int32)
    states = np.zeros((c, 4), np.float32)
    for p, t in zip(idx.ravel(), lab.ravel()):
        states[:, 2] += 1
        states[p, 2] -= 1
        if p == t:
            states[p, 0] += 1
        else:
            states[t, 3] += 1
            states[p, 1] += 1
            states[t, 2] -= 1

    def build(fluid):
        L = fluid.layers
        i = L.data(name="pr_idx", shape=[n, 1], dtype="int32",
                   append_batch_size=False)
        lb = L.data(name="pr_lab", shape=[n, 1], dtype="int32",
                    append_batch_size=False)
        block = fluid.default_main_program().global_block()
        outs = [block.create_var(name=f"pr_{k}", dtype="float32")
                for k in ("batch", "accum", "states")]
        block.append_op(type="precision_recall",
                        inputs={"Indices": [i], "Labels": [lb]},
                        outputs={"BatchMetrics": [outs[0]],
                                 "AccumMetrics": [outs[1]],
                                 "AccumStatesInfo": [outs[2]]},
                        attrs={"class_number": c})
        return outs
    want, got = run_both(build, lambda f: {"pr_idx": idx, "pr_lab": lab})
    assert_same(want, got)

    def ratio(a, b):
        return a / (a + b) if a + b > 0 else 1.0

    def f1(p, r):
        return 2 * p * r / (p + r) if p + r > 0 else 0.0
    mp = np.mean([ratio(states[k, 0], states[k, 1]) for k in range(c)])
    mr = np.mean([ratio(states[k, 0], states[k, 3]) for k in range(c)])
    up = ratio(states[:, 0].sum(), states[:, 1].sum())
    ur = ratio(states[:, 0].sum(), states[:, 3].sum())
    np.testing.assert_allclose(got[0], [mp, mr, f1(mp, mr), up, ur,
                                        f1(up, ur)], rtol=1e-5)
    np.testing.assert_allclose(got[2], states, rtol=1e-5)


def test_positive_negative_pair_vs_oracle():
    score = np.array([[0.8], [0.2], [0.5], [0.4], [0.9]], np.float32)
    label = np.array([[1], [0], [1], [0], [1]], np.float32)
    query = np.array([[7], [7], [7], [8], [8]], np.int64)
    pos = neg = neu = 0.0
    for i in range(5):
        for j in range(i + 1, 5):
            if query[i] != query[j] or label[i] == label[j]:
                continue
            ds, dl = score[i, 0] - score[j, 0], label[i, 0] - label[j, 0]
            neu += ds == 0
            if ds * dl > 0:
                pos += 1
            else:
                neg += 1

    def build(fluid):
        L = fluid.layers
        ins = {slot: L.data(name=n, shape=list(a.shape), dtype=a.dtype.name,
                            append_batch_size=False)
               for slot, n, a in (("Score", "pnp_s", score),
                                  ("Label", "pnp_l", label),
                                  ("QueryID", "pnp_q", query))}
        block = fluid.default_main_program().global_block()
        outs = [block.create_var(name=f"pnp_{k}", dtype="float32")
                for k in ("pos", "neg", "neu")]
        block.append_op(type="positive_negative_pair",
                        inputs={k: [v] for k, v in ins.items()},
                        outputs={"PositivePair": [outs[0]],
                                 "NegativePair": [outs[1]],
                                 "NeutralPair": [outs[2]]})
        return outs
    want, got = run_both(build, lambda f: {"pnp_s": score, "pnp_l": label,
                                           "pnp_q": query})
    assert_same(want, got)
    assert [float(np.ravel(v)[0]) for v in got] == [pos, neg, neu]


def test_chunk_evaluator_accumulates():
    """metrics.ChunkEvaluator fed by chunk_eval over two batches, as
    tests/test_ctc_eval_ops.py's, in both packages."""
    from paddle_tpu import metrics as jmetrics
    feeds = lambda f: [{"inf": make_lod(  # noqa: E731
        f, [np.array([[0], [1], [4], [0]], np.int64)]),
        "lab": make_lod(f, [np.array([[0], [1], [4], [2]], np.int64)])}] * 2
    results = {}
    for fluid, mod in ((jfluid, jmetrics), (pt, pt.metrics)):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            outs = _chunk(fluid, chunk_scheme="IOB", num_chunk_types=2)[3:]
        ev = mod.ChunkEvaluator()
        exe = fluid.Executor(fluid.CPUPlace())
        for f in feeds(fluid):
            ev.update(*exe.run(main, feed=f, fetch_list=outs,
                               scope=_ex(fluid).Scope()))
        results[fluid] = ev.eval()
    assert results[pt] == results[jfluid] == (0.5, 0.5, 0.5)


def test_edit_distance_metric():
    from paddle_tpu import metrics as jmetrics
    results = {}
    for fluid, mod in ((jfluid, jmetrics), (pt, pt.metrics)):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            h = fluid.layers.data(name="h", shape=[1], dtype="int64",
                                  lod_level=1)
            r = fluid.layers.data(name="r", shape=[1], dtype="int64",
                                  lod_level=1)
            outs = list(fluid.layers.edit_distance(h, r, normalized=False))
        ev = mod.EditDistance()
        ev.update(*fluid.Executor(fluid.CPUPlace()).run(
            main, feed={"h": make_lod(fluid, [np.array([[1], [2]], np.int64),
                                              np.array([[5]], np.int64)]),
                        "r": make_lod(fluid, [np.array([[1], [3]], np.int64),
                                              np.array([[5]], np.int64)])},
            fetch_list=outs, scope=_ex(fluid).Scope()))
        results[fluid] = ev.eval()
    assert results[pt] == results[jfluid]
    assert abs(results[pt][0] - 0.5) < 1e-6
