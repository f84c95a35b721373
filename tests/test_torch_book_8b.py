"""The control-flow chapters through the port against the JAX package on
the CPU, op by op for a few steps: the same scripts (chip_smoke's
`mt_train_net`, `mt_decode_net`, `srl_net`, `beam_decode_net`, at the
reference tests' widths) built in both packages, the port started from the
JAX startup's weights (`interop.load_numpy_params`), fed the same batches.
Losses over 5 steps within rtol 1e-4, the weights after them within rtol
1e-4 / atol 1e-5 (f32: tanh, sigmoid and log-sum-exp differ in the last
ulp between the libraries and the steps carry it), decoded ids, parents
and Viterbi paths exact, scores within rtol 1e-5 / atol 1e-5. And the
datasets conll05, wmt14 and wmt16: the port's readers yield the JAX
package's samples bit for bit.
"""

import torch_threads  # noqa: F401  (the cores shared among xdist workers)
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402
import paddle_tpu as jfluid  # noqa: E402
from paddle_tpu import executor as jax_executor  # noqa: E402
import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch import executor as pt_executor  # noqa: E402
from paddle_tpu_torch.ops import registry  # noqa: E402

LOSS = dict(rtol=1e-4, atol=1e-6)
WEIGHTS = dict(rtol=1e-4, atol=1e-5)
STEPS = 5


@pytest.fixture(autouse=True)
def _keep_jax_op_census():
    before = set(jax_executor._RECORDED_OPS)
    yield
    jax_executor._RECORDED_OPS.intersection_update(before)


def _lod(fluid):
    return (pt_executor if fluid is pt else jax_executor).LoDTensor


def _build(fluid, net):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        out = net(fluid)
    return main, startup, out


def _jax_start(startup):
    scope = jax_executor.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(startup, scope=scope)
    arrays = {n: np.asarray(scope.find_var(n))
              for n, v in startup.global_block().desc.vars.items()
              if v.persistable and scope.find_var(n) is not None}
    return exe, scope, arrays


def _port_scope(arrays):
    scope = pt.Scope()
    pt.interop.load_numpy_params(scope, arrays, "cpu")
    return pt.Executor(pt.CPUPlace()), scope


MT_NAMES = ("src_word_id", "target_language_word",
            "target_language_next_word")


def _train_both(net, feeds_of, fetch_of, persist_check=True):
    """Build `net` in each package, run the JAX startup, carry it over and
    run STEPS steps of `feeds_of(fluid)` in each -> (JAX fetches, port
    fetches) per step, after checking the weights agree."""
    jmain, jstartup, jout = _build(jfluid, net)
    jexe, jscope, arrays = _jax_start(jstartup)
    want = [jexe.run(jmain, feed=f, fetch_list=fetch_of(jout), scope=jscope)
            for f in feeds_of(jfluid)]
    main, _, out = _build(pt, net)
    exe, scope = _port_scope(arrays)
    got = [exe.run(main, feed=f, fetch_list=fetch_of(out), scope=scope)
           for f in feeds_of(pt)]
    if persist_check:
        for n in arrays:
            np.testing.assert_allclose(scope.find_var(n).numpy(),
                                       np.asarray(jscope.find_var(n)),
                                       err_msg=n, **WEIGHTS)
    return want, got


def test_machine_translation_trains_as_the_jax_package():
    """The chapter's teacher-forced seq2seq (DynamicRNN decoder with
    attention), Adam 4e-3, 5 batches of 16 from the wmt14 reader: losses
    and weights; the rnn grad re-runs its loop once a step."""
    samples = list(pt.dataset.wmt14.train(chip_smoke.MT_BOOK["dict"])())

    def feeds(fluid):
        return [chip_smoke._seq_feeds(fluid, samples[16 * i:16 * (i + 1)],
                                       MT_NAMES)
                for i in range(STEPS)]
    registry.RERUNS.clear()
    want, got = _train_both(
        lambda f: chip_smoke.mt_train_net(f, chip_smoke.MT_BOOK, 4e-3),
        feeds, lambda out: [out[1]])
    assert registry.RERUNS["rnn"] == STEPS
    np.testing.assert_allclose([float(g[0].ravel()[0]) for g in got],
                               [float(np.ravel(w[0])[0]) for w in want],
                               **LOSS)


@pytest.mark.parametrize("beam", [chip_smoke.MT_BEAM, 1],
                         ids=["beam", "greedy"])
def test_machine_translation_decodes_as_the_jax_package(beam):
    """The generation program (While over [B, K] lanes, beam_search or the
    argmax, the arrays backtracked) on the JAX startup's weights: the ids
    exact, the scores within tolerance."""
    def net(fluid):
        return chip_smoke.mt_decode_net(fluid, chip_smoke.MT_BOOK, beam,
                                        beam > 1, chip_smoke.MT_BOOK_MAX_LEN)

    rows = [[3, 7, 9], [12, 4], [5, 8, 11, 2, 6]]

    def feed(fluid):
        flat = np.concatenate(rows).reshape(-1, 1).astype(np.int64)
        offs = np.concatenate([[0], np.cumsum([len(r) for r in rows])])
        return {"src_word_id": _lod(fluid)(flat, [offs.tolist()])}
    jmain, jstartup, (_, jsent, jsc) = _build(jfluid, net)
    jexe, jscope, arrays = _jax_start(jstartup)
    want = jexe.run(jmain, feed=feed(jfluid), fetch_list=[jsent, jsc],
                    scope=jscope)
    main, _, (_, sent, sc) = _build(pt, net)
    exe, scope = _port_scope(arrays)
    pt_executor.COUNTERS.reset()
    got = exe.run(main, feed=feed(pt), fetch_list=[sent, sc], scope=scope)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_allclose(got[1], np.asarray(want[1]), rtol=1e-5,
                               atol=1e-5)
    assert got[0].shape == (3, beam, chip_smoke.MT_BOOK_MAX_LEN + 1)
    # the condition is read once an iteration and once at the exit
    assert pt_executor.COUNTERS.host_syncs == {
        "while": chip_smoke.MT_BOOK_MAX_LEN + 1}


def test_label_semantic_roles_trains_as_the_jax_package():
    """db_lstm + linear_chain_crf, Adam 5e-3, 6 batches of 16 samples: the
    losses, and the Viterbi paths of each batch exact. The weights are not
    held: where a grad entry is near zero, Adam's m / sqrt(v) turns a
    last-ulp difference into a step of lr's size (one weight of 16384
    moved 2.5e-5 apart after 6 steps)."""
    rng = np.random.RandomState(0)
    label_n = pt.dataset.conll05.LABEL_N
    batches = [[chip_smoke.srl_book_sample(rng, label_n) for _ in range(16)]
               for _ in range(STEPS + 1)]
    names = chip_smoke.SRL_NAMES + ("target",)

    def feeds(fluid):
        return [chip_smoke._seq_feeds(fluid, b, names) for b in batches]
    registry.RERUNS.clear()
    want, got = _train_both(
        lambda f: chip_smoke.srl_net(f, chip_smoke.SRL_BOOK, 5e-3),
        feeds, lambda out: [out[2], out[3]], persist_check=False)
    assert registry.RERUNS["linear_chain_crf"] == STEPS + 1
    np.testing.assert_allclose([float(g[0].ravel()[0]) for g in got],
                               [float(np.ravel(w[0])[0]) for w in want],
                               **LOSS)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g[1], np.asarray(w[1]))


@pytest.mark.parametrize("slack", [0, 5], ids=["exact", "slack"])
def test_beam_search_decode_as_the_jax_package(slack):
    cfg = chip_smoke.BEAM_BOOK
    jmain, jstartup, (_, jsent, jsc) = _build(
        jfluid, lambda f: chip_smoke.beam_decode_net(
            f, cfg["max_len"] + 1 + slack))
    jexe, jscope, arrays = _jax_start(jstartup)
    want = jexe.run(jmain, feed=chip_smoke.beam_src_feed(jax_executor),
                    fetch_list=[jsent, jsc], scope=jscope)
    main, _, (_, sent, sc) = _build(
        pt, lambda f: chip_smoke.beam_decode_net(
            f, cfg["max_len"] + 1 + slack))
    exe, scope = _port_scope(arrays)
    got = exe.run(main, feed=chip_smoke.beam_src_feed(pt),
                  fetch_list=[sent, sc], scope=scope)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_allclose(got[1], np.asarray(want[1]), rtol=1e-5,
                               atol=1e-5)
    assert (got[0][:, :, cfg["max_len"] + 1:] == chip_smoke.MT_END).all()


# --- the datasets ------------------------------------------------------------------

def _readers(pkg):
    d = pkg.dataset
    return {
        "conll05.train": d.conll05.train(),
        "conll05.test": d.conll05.test(),
        "wmt14.train": d.wmt14.train(300),
        "wmt14.test": d.wmt14.test(30000),
        "wmt16.train": d.wmt16.train(300, 400),
        "wmt16.test": d.wmt16.test(1000, 30000, src_lang="de"),
        "wmt16.validation": d.wmt16.validation(50, 60),
    }


@pytest.mark.parametrize("reader", sorted(_readers(pt)))
def test_dataset_surrogates_bit_for_bit(reader):
    want = list(_readers(jfluid)[reader]())
    got = list(_readers(pt)[reader]())
    assert len(got) == len(want) > 0
    for w, g in zip(want, got):
        assert len(w) == len(g)
        for a, b in zip(w, g):
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def test_dataset_dicts_and_constants():
    for mod in ("conll05", "wmt14", "wmt16"):
        jm, pm = getattr(jfluid.dataset, mod), getattr(pt.dataset, mod)
        names = [n for n in dir(jm) if n.isupper()]
        assert names and all(getattr(pm, n) == getattr(jm, n) for n in names)
    assert pt.dataset.wmt14.get_dict(100) == jfluid.dataset.wmt14.get_dict(100)
    assert pt.dataset.wmt16.get_dict("de", 70, reverse=True) == \
        jfluid.dataset.wmt16.get_dict("de", 70, reverse=True)
    assert (pt.dataset.conll05.LABEL_N, pt.dataset.conll05.PRED_VOCAB,
            pt.dataset.conll05.WORD_VOCAB) == (59, 3162, 44068)


def test_beam_decode_saved_and_served():
    """The beam decode program through save_inference_model (its While
    sub-block kept by the prune), load_inference_model into a fresh scope,
    and ServingEngine.infer, which takes the LoD request to the executor
    (serving_fallback_total{reason="lod"}): the ids of exe.run each time."""
    import tempfile
    from paddle_tpu_torch import telemetry
    from paddle_tpu_torch.serving import ServingEngine
    main, startup, (src, sent, sc) = _build(pt, chip_smoke.beam_decode_net)
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    feed = chip_smoke.beam_src_feed(pt)
    want = exe.run(main, feed=feed, fetch_list=[sent, sc], scope=scope)
    with tempfile.TemporaryDirectory() as d:
        with pt.scope_guard(scope):
            pt.io.save_inference_model(d, ["src"], [sent, sc], exe,
                                       main_program=main)
        fresh = pt.Scope()
        with pt.scope_guard(fresh):
            prog, names, fetch = pt.io.load_inference_model(d, exe)
        assert prog.num_blocks == main.num_blocks == 2
        got = exe.run(prog, feed=feed, fetch_list=fetch, scope=fresh)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        engine = ServingEngine(d, place=pt.CPUPlace())
        before = telemetry.read_series("serving_fallback_total")
        served = engine.infer(feed)
        after = telemetry.read_series("serving_fallback_total")
    np.testing.assert_array_equal(served[0], want[0])
    np.testing.assert_array_equal(served[1], want[1])
    lod = {k: v for k, v in after.items() if "lod" in str(k)}
    assert sum(lod.values()) - sum(v for k, v in before.items()
                                   if "lod" in str(k)) == 1
