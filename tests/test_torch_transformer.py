"""The transformer slice on the CPU: its ops against the JAX lowerings, and
`transformer_lm` (2 layers, d_model 64, 2 heads, T 128, vocab 256,
use_flash=True) built, trained one Adam step and served by both packages
from the JAX startup's weights.

The flash path runs the Pallas kernels in interpret mode in the JAX package
and the kernels' plain versions in the port (ops/attention_cuda.py).

Tolerances.
  * Ops: f32 within 1e-6 of the largest output (the same arithmetic); the
    bf16 layer_norm within 2^-7 of it (jnp and torch round the bf16 mean
    and variance at their own points).
  * One training step, f32: the loss within 1e-5 relative; each grad
    within a relative L2 of 1e-5 of its own (both sum in f32 in their own
    order; measured at most 7.2e-7). The K projections' biases have a zero
    gradient in exact arithmetic, so both runs give rounding noise for
    them (JAX: under 1e-6 of the largest grad norm): the port's is held
    under 1e-6 of that norm in f32 and 1e-5 under O2 (JAX's O2 noise
    measured 3.2e-6);
    Adam's moments after the step within 1e-4 of the largest moment of
    their kind (first or second), the parameters within 1e-5 of theirs
    plus 1e-5 (1 % of the learning rate: Adam divides each grad by its own
    magnitude, so the f32 noise of a tiny grad becomes a share of its
    parameter's step; measured 1.5e-6).
  * The attention grad op under O2, f32 or bf16 cotangent: within 2^-7 of
    the largest grad (the plain versions against Pallas, as in
    tests/test_torch_attention.py). The adam op: rtol 1e-6.
  * AMP O2: the loss within 1e-3 relative; each grad, on its own scale,
    no further from the JAX O2 grad (relative L2) than twice the JAX
    package's own O2-vs-f32 relative L2 for that parameter, and its norm
    within 1 % of the JAX O2 grad's: the port's O2 is held to the bf16
    noise of the reference, parameter by parameter (measured: at most 1.21
    times that distance, 0.16 % to 1.27 %; norm ratios 0.9976-1.0023; loss
    3.9e-6 relative).
  * Serving logits, O2: within 2 % of the largest |logit| (bf16 noise of
    two layers; measured 0.53 %).
"""

import torch_threads  # noqa: F401  (the cores shared among xdist workers)
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jfluid
from paddle_tpu import executor as jax_executor
from paddle_tpu import models as jax_models
from paddle_tpu.ops import registry as jax_registry
from paddle_tpu.serving import ServingEngine as JaxServingEngine
import paddle_tpu_torch as pt
from paddle_tpu_torch.ops import attention_cuda, registry
from paddle_tpu_torch.serving import ServingEngine

T, VOCAB, BATCH = 128, 256, 2


@pytest.fixture(autouse=True)
def _keep_jax_op_census():
    """Take back the op types the JAX executor recorded in this test (see
    tests/test_torch_training.py: the op-coverage gate, ROADMAP Queue 3)."""
    before = set(jax_executor._RECORDED_OPS)
    yield
    jax_executor._RECORDED_OPS.intersection_update(before)


# --- the ops ----------------------------------------------------------------------

def _op(attrs, outputs=(), type_="op"):
    return SimpleNamespace(
        type=type_, attr=lambda k, d=None: attrs.get(k, d),
        input=lambda slot: [slot.lower()],
        desc=SimpleNamespace(outputs={s: [s.lower()] for s in outputs}))


def _both(op_type, attrs, ins, outputs=(), amp=None):
    """One op's lowering in each package on the same numpy inputs."""
    jctx = SimpleNamespace(program=None, amp_dtype=amp, amp_level="O2")
    tctx = SimpleNamespace(program=None, amp_dtype=amp, amp_level="O2")
    op = _op(attrs, outputs)
    want = jax_registry.get(op_type).lower(
        jctx, op, {k: [jnp.asarray(v)] for k, v in ins.items()})
    got = registry.get(op_type).lower(
        tctx, op, {k: [torch.from_numpy(np.ascontiguousarray(v))]
                   for k, v in ins.items()})
    return want, got


def _close(got, want, tol, what=""):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape, what
    assert np.abs(got - want).max() <= tol * (np.abs(want).max() + 1e-12), what


@pytest.mark.parametrize("ids_shape", [(2, 5), (2, 5, 1)], ids=str)
@pytest.mark.parametrize("padding_idx", [-1, 3])
def test_lookup_table_and_grad_match_jax(ids_shape, padding_idx):
    """The gather with padding rows zeroed and a trailing 1 in Ids squeezed,
    and the dense grad: repeated ids add up, the padding row gets none."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((7, 4)).astype(np.float32)
    ids = rng.integers(0, 7, ids_shape).astype(np.int64)
    ids.flat[0] = ids.flat[1] = 3                # a repeat and the pad id
    attrs = {"padding_idx": padding_idx, "is_sparse": False}
    want, got = _both("lookup_table", attrs, {"W": w, "Ids": ids})
    _close(got["Out"][0], want["Out"][0], 1e-6)
    g = rng.standard_normal(got["Out"][0].shape).astype(np.float32)
    want, got = _both("lookup_table_grad", attrs,
                      {"W": w, "Ids": ids, "Out@GRAD": g}, ("W@GRAD",))
    _close(got["W@GRAD"][0], want["W@GRAD"][0], 1e-6)
    assert (got["W@GRAD"][0][3] == 0).all() == (padding_idx == 3)


def test_sparse_lookup_grad_is_a_later_slice():
    """The sparse embedding slice is ported: is_sparse=True gives a
    SelectedRows gradient, the flat ids and the cotangent rows unmerged,
    whose dense form is the dense gradient (tests/test_torch_sparse.py
    holds it to the JAX package's)."""
    from paddle_tpu_torch.ops.common import SelectedRowsVal
    ins = {"W": [torch.zeros(3, 2)], "Ids": [torch.tensor([[2], [2]])],
           "Out@GRAD": [torch.ones(2, 2)]}
    sr = registry.get("lookup_table_grad").lower(
        None, _op({"is_sparse": True}), ins)["W@GRAD"][0]
    assert isinstance(sr, SelectedRowsVal) and sr.height == 3
    assert sr.rows.tolist() == [2, 2]
    dense = registry.get("lookup_table_grad").lower(
        None, _op({"is_sparse": False}), ins)["W@GRAD"][0]
    assert torch.equal(sr.to_dense(), dense)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    """Y, Mean and Variance; a bf16 X times the f32 Scale comes out f32 in
    both packages (the AMP O2 dtype)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 8)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal(8).astype(np.float32)
    bias = rng.standard_normal(8).astype(np.float32)
    ins = {"X": x, "Scale": scale, "Bias": bias}
    attrs = {"begin_norm_axis": 2, "epsilon": 1e-5}
    if dtype == "bfloat16":
        jctx = SimpleNamespace(program=None)
        op = _op(attrs)
        want = jax_registry.get("layer_norm").lower(jctx, op, {
            "X": [jnp.asarray(x).astype(jnp.bfloat16)],
            "Scale": [jnp.asarray(scale)], "Bias": [jnp.asarray(bias)]})
        got = registry.get("layer_norm").lower(None, op, {
            "X": [torch.from_numpy(x).to(torch.bfloat16)],
            "Scale": [torch.from_numpy(scale)],
            "Bias": [torch.from_numpy(bias)]})
        assert want["Y"][0].dtype == jnp.float32
        assert got["Y"][0].dtype == torch.float32
        assert got["Mean"][0].dtype == torch.bfloat16
        tol = 2.0 ** -7
    else:
        want, got = _both("layer_norm", attrs, ins)
        tol = 1e-6
    for slot in ("Y", "Mean", "Variance"):
        _close(got[slot][0], want[slot][0], tol, slot)
    assert tuple(got["Mean"][0].shape) == (6,)


@pytest.mark.parametrize("dout_dtype", ["float32", "bfloat16"])
def test_attention_grad_casts_dout_like_jax(dout_dtype):
    """Under AMP O2 the cotangent reaches scaled_dot_product_attention_grad
    in f32 or bf16, as the consumer's grad gives it; mxu_cast takes it to
    bf16 with Q, K and V in both packages, and dQ, dK, dV come out bf16 and
    agree (the flash path: Pallas in interpret mode, the plain versions)."""
    rng = np.random.default_rng(2)
    q, k, v, do = (rng.standard_normal((1, 64, 2, 32)).astype(np.float32)
                   for _ in range(4))
    attrs = {"causal": True, "use_flash": True, "sequence_parallel": False}
    jctx = SimpleNamespace(program=None, amp_dtype="bfloat16", amp_level="O2")
    op = _op(attrs, ("Q@GRAD", "K@GRAD", "V@GRAD"),
             "scaled_dot_product_attention_grad")
    jf = jax_registry.get("scaled_dot_product_attention").lower(
        jctx, op, {s: [jnp.asarray(a)] for s, a in zip("QKV", (q, k, v))})
    ins = {"Q": q, "K": k, "V": v, "Out": np.asarray(jf["Out"][0], np.float32),
           "LSE": np.asarray(jf["LSE"][0])}
    jdo = jnp.asarray(do).astype(getattr(jnp, dout_dtype))
    want = jax_registry.get("scaled_dot_product_attention_grad").lower(
        jctx, op, {**{s: [jnp.asarray(a)] for s, a in ins.items()},
                   "Out@GRAD": [jdo]})
    tctx = SimpleNamespace(program=None, amp_dtype="bfloat16", amp_level="O2")
    tdo = torch.from_numpy(do).to(getattr(torch, dout_dtype))
    attention_cuda.COUNTERS.reset()
    got = registry.get("scaled_dot_product_attention_grad").lower(
        tctx, op, {**{s: [torch.from_numpy(a)] for s, a in ins.items()},
                   "Out@GRAD": [tdo]})
    assert attention_cuda.COUNTERS.hits == {
        "scaled_dot_product_attention_grad": 1}
    for slot in ("Q@GRAD", "K@GRAD", "V@GRAD"):
        assert got[slot][0].dtype == torch.bfloat16, slot
        _close(got[slot][0], want[slot][0], 2.0 ** -7, slot)


@pytest.mark.parametrize("shape", [(64, 256), (4, 8, 16)], ids=str)
def test_adam_op_matches_jax_at_o2(shape):
    """The adam op on an f32 master parameter with a bf16 grad (AMP O2),
    2-D as the projections and 3-D, from moments and beta powers carried
    across: exact f32 arithmetic on the same values in both packages."""
    rng = np.random.default_rng(3)
    ins = {"Param": rng.standard_normal(shape).astype(np.float32),
           "Grad": rng.standard_normal(shape).astype(np.float32),
           "Moment1": rng.standard_normal(shape).astype(np.float32),
           "Moment2": np.abs(rng.standard_normal(shape)).astype(np.float32),
           "LearningRate": np.array([1e-4], np.float32),
           "Beta1Pow": np.array([0.9 ** 2], np.float32),
           "Beta2Pow": np.array([0.999 ** 2], np.float32)}
    attrs = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}
    op = _op(attrs)
    want = jax_registry.get("adam").lower(None, op, {
        **{s: [jnp.asarray(a)] for s, a in ins.items()},
        "Grad": [jnp.asarray(ins["Grad"]).astype(jnp.bfloat16)]})
    got = registry.get("adam").lower(None, op, {
        **{s: [torch.from_numpy(a)] for s, a in ins.items()},
        "Grad": [torch.from_numpy(ins["Grad"]).to(torch.bfloat16)]})
    for slot in ("ParamOut", "Moment1Out", "Moment2Out"):
        assert got[slot][0].dtype == torch.float32
        np.testing.assert_allclose(got[slot][0].numpy(),
                                   np.asarray(want[slot][0]), rtol=1e-6,
                                   atol=1e-7, err_msg=slot)


def test_reshape_matches_jax():
    x = np.arange(2 * 6 * 4, dtype=np.float32).reshape(2, 6, 4)
    for shape in ([0, 6, 2, 2], [-1, 24], [2, -1, 4, 2]):
        want, got = _both("reshape", {"shape": shape}, {"X": x})
        np.testing.assert_array_equal(got["Out"][0].numpy(),
                                      np.asarray(want["Out"][0]))


# --- the model --------------------------------------------------------------------

def _build(fluid, amp, is_test=False, optimizer=True):
    models = jax_models if fluid is jfluid else pt.models
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        tok = fluid.layers.data(name="tok", shape=[-1, T], dtype="int64",
                                append_batch_size=False)
        lab = fluid.layers.data(name="lab", shape=[-1, T], dtype="int64",
                                append_batch_size=False)
        loss, logits = models.transformer_lm(
            tok, lab, vocab_size=VOCAB, d_model=64, n_head=2, n_layer=2,
            use_flash=True, is_test=is_test, return_logits=True)
        if optimizer:
            opt = fluid.optimizer.Adam(learning_rate=1e-3)
            if amp:
                opt = fluid.amp.decorate(opt, level="O2")
            opt.minimize(loss, startup_program=startup)
        elif amp:
            fluid.amp.enable(main, level="O2")
    return main, startup, loss, logits


def _feed(seed=0, n=BATCH):
    rng = np.random.default_rng(seed)
    return {"tok": rng.integers(0, VOCAB, (n, T)).astype(np.int64),
            "lab": rng.integers(0, VOCAB, (n, T)).astype(np.int64)}


def _params(main):
    return sorted(p.name for p in main.global_block().all_parameters())


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "O2"])
def test_program_desc_matches_jax(amp):
    """After Adam.minimize (and amp.decorate O2) the main and startup
    ProgramDescs are JSON-identical in both packages, attrs included
    (use_flash True, the LSE output, the grad op's inputs)."""
    jmain, jstartup, _, _ = _build(jfluid, amp)
    pmain, pstartup, _, _ = _build(pt, amp)
    assert json.loads(pmain.desc.to_json()) == json.loads(jmain.desc.to_json())
    assert json.loads(pstartup.desc.to_json()) == \
        json.loads(jstartup.desc.to_json())
    types = [op.type for op in pmain.global_block().ops]
    assert types.count("scaled_dot_product_attention_grad") == 2
    assert "scaled_dot_product_attention_grad_grad" not in types
    assert "pos_emb" in _params(pmain)


_JAX_RUNS = {}


def _jax_step(amp):
    """The JAX package's startup state, and the loss, grads and state after
    one step, computed once per precision."""
    if amp not in _JAX_RUNS:
        main, startup, loss, _ = _build(jfluid, amp)
        scope = jax_executor.Scope()
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup, scope=scope)
        init = {n: np.array(scope.find_var(n)).astype(np.float32)
                for n, v in startup.global_block().desc.vars.items()
                if v.persistable}
        out = exe.run(main, feed=_feed(), scope=scope, fetch_list=[loss] + [
            p + "@GRAD" for p in _params(main)])
        after = {n: np.array(scope.find_var(n)).astype(np.float32)
                 for n in init}
        _JAX_RUNS[amp] = (init, float(np.ravel(out[0])[0]),
                          [np.asarray(g, np.float32) for g in out[1:]], after)
    return _JAX_RUNS[amp]


def _port_step(amp, init):
    main, _, loss, _ = _build(pt, amp)
    scope = pt.Scope()
    pt.interop.load_numpy_params(scope, init, "cpu")
    out = pt.Executor(pt.CPUPlace()).run(
        main, feed=_feed(), scope=scope,
        fetch_list=[loss] + [p + "@GRAD" for p in _params(main)])
    after = {n: scope.find_var(n).float().numpy() for n in init}
    return float(out[0][0]), out[1:], after


def test_startup_creates_the_jax_variables():
    """Parameters (pos_emb included), Adam's moments and beta powers and
    the learning rate: the same names and shapes in both startups."""
    init, _, _, _ = _jax_step(False)
    _, startup, _, _ = _build(pt, False)
    scope = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(startup, scope=scope)
    got = {n: tuple(v.shape) for n, v in scope.vars.items()
           if not n.startswith("__")}
    assert got == {n: a.shape for n, a in init.items()}
    assert {"pos_emb_moment1_0", "pos_emb_moment2_0", "beta1_pow_acc_0",
            "beta2_pow_acc_0", "learning_rate_0"} <= set(got)


def _rl2(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _zero_grads(want32):
    """The indices of the grads that are zero in exact arithmetic, the K
    projections' biases (a bias on K adds one constant to each query's
    scores, which softmax ignores): one per layer, each JAX f32 grad norm
    under 1e-6 of the largest. Also the largest norm."""
    norms = [np.linalg.norm(w) for w in want32]
    zero = {i for i, n in enumerate(norms) if n < 1e-6 * max(norms)}
    assert len(zero) == 2
    return zero, max(norms)


def test_adam_step_matches_jax_f32():
    init, want_loss, want_grads, want_after = _jax_step(False)
    attention_cuda.COUNTERS.reset()
    loss, grads, after = _port_step(False, init)
    # the flash path on f32 operands passes the gate (the kernels' f32
    # forms on the card; on CPU tensors their plain versions): hits only
    assert attention_cuda.COUNTERS.hits == {
        "scaled_dot_product_attention": 2,
        "scaled_dot_product_attention_grad": 2}
    assert not attention_cuda.COUNTERS.fallbacks
    assert loss == pytest.approx(want_loss, rel=1e-5)
    zero, top = _zero_grads(want_grads)
    for i, (name, g, w) in enumerate(zip(_params(_build(pt, False)[0]), grads,
                                         want_grads)):
        if i in zero:
            assert np.linalg.norm(g) <= 1e-6 * top, name
        else:
            assert _rl2(g, w) <= 1e-5, name
    kind_top = {k: max(np.abs(w).max() for n, w in want_after.items()
                       if n.endswith(k)) for k in ("_moment1_0", "_moment2_0")}
    for n, w in want_after.items():
        # moments: the grads' tolerance; parameters: see the module doc
        kind = n[n.rfind("_moment"):]
        tol = 1e-4 * kind_top[kind] if kind in kind_top else \
            1e-5 * np.abs(w).max() + 1e-5
        assert np.abs(after[n] - w).max() <= tol, n
    assert np.abs(after["pos_emb"] - init["pos_emb"]).max() > 1e-4


def test_adam_step_matches_jax_o2():
    _, _, ref32, _ = _jax_step(False)
    init, want_loss, want_grads, _ = _jax_step(True)
    attention_cuda.COUNTERS.reset()
    loss, grads, _ = _port_step(True, init)
    assert attention_cuda.COUNTERS.hits == {
        "scaled_dot_product_attention": 2,
        "scaled_dot_product_attention_grad": 2}
    assert not attention_cuda.COUNTERS.fallbacks
    assert loss == pytest.approx(want_loss, rel=1e-3)
    zero, top = _zero_grads(ref32)
    for i, (name, g, w, r) in enumerate(zip(_params(_build(pt, True)[0]), grads,
                                            want_grads, ref32)):
        if i in zero:
            assert np.linalg.norm(g) <= 1e-5 * top, name
            continue
        assert _rl2(g, w) <= 2 * _rl2(w, r), name
        assert abs(np.linalg.norm(g) / np.linalg.norm(w) - 1) <= 0.01, name


def test_serving_logits_match_jax():
    """ServingEngine over transformer_lm(is_test=True, return_logits=True)
    in AMP O2, fetching `logits`: pruning drops the loss tail, int64 token
    feeds of static T pad to the bucket, and the logits equal the JAX
    engine's on the same weights."""
    jmain, jstartup, _, jlogits = _build(jfluid, True, is_test=True,
                                         optimizer=False)
    scope = jax_executor.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(jstartup, scope=scope)
    arrays = {n: np.array(scope.find_var(n)).astype(np.float32)
              for n, v in jstartup.global_block().desc.vars.items()
              if v.persistable}
    tok = _feed(4, n=3)["tok"]
    jeng = JaxServingEngine(jmain, ["tok"], [jlogits.name], place=jfluid.CPUPlace(),
                            scope=scope, buckets=(4,))
    want = np.asarray(jeng.infer({"tok": tok})[0], np.float32)

    pmain, _, _, plogits = _build(pt, True, is_test=True, optimizer=False)
    pscope = pt.Scope()
    pt.interop.load_numpy_params(pscope, arrays, "cpu")
    eng = ServingEngine(pmain, ["tok"], [plogits], place=pt.CPUPlace(),
                        scope=pscope, buckets=(2, 4))
    served = {op.type for op in eng.program.global_block().ops}
    assert "softmax_with_cross_entropy" not in served and "mean" not in served
    attention_cuda.COUNTERS.reset()
    got = eng.infer({"tok": tok})[0]
    assert attention_cuda.COUNTERS.hits == {"scaled_dot_product_attention": 2}
    assert got.shape == want.shape == (3, T, VOCAB)
    assert np.abs(got - want).max() <= 0.02 * np.abs(want).max()
    one = eng.infer({"tok": tok[:1]})[0]       # bucket 2, one padded row
    assert np.abs(one - got[:1]).max() <= 0.02 * np.abs(want).max()
    assert eng.bucket_runs == {4: 1, 2: 1}


def test_model_options_that_are_later_slices_raise():
    """Dropout in training, a later slice before, now builds: one dropout
    op on the embedding sum, where the JAX package's model has it
    (models/transformer.py:44); is_test keeps it out of the program."""
    for is_test, want in ((False, 1), (True, 0)):
        main, startup = pt.Program(), pt.Program()
        with pt.unique_name.guard(), pt.program_guard(main, startup):
            tok = pt.layers.data(name="tok", shape=[-1, 16], dtype="int64",
                                 append_batch_size=False)
            pt.models.transformer_lm(tok, tok, vocab_size=32, d_model=32,
                                     n_head=2, n_layer=1, dropout_prob=0.1,
                                     is_test=is_test)
        ops = main.global_block().ops
        drops = [i for i, o in enumerate(ops) if o.type == "dropout"]
        assert len(drops) == want
        if drops:
            assert ops[drops[0] - 1].type == "elementwise_add"


def test_auto_takes_the_einsum_path_below_2048():
    """use_flash="auto" at T = 128 < 2048 runs the einsum path: no flash
    call, counted or not, and a training step's grads are finite."""
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        tok = pt.layers.data(name="tok", shape=[-1, T], dtype="int64",
                             append_batch_size=False)
        lab = pt.layers.data(name="lab", shape=[-1, T], dtype="int64",
                             append_batch_size=False)
        loss = pt.models.transformer_lm(tok, lab, vocab_size=VOCAB,
                                        d_model=32, n_head=2, n_layer=1)
        pt.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    attention_cuda.COUNTERS.reset()
    out = exe.run(main, feed=_feed(), scope=scope,
                  fetch_list=[loss, "pos_emb@GRAD"])
    assert not attention_cuda.COUNTERS.hits
    assert not attention_cuda.COUNTERS.fallbacks
    assert np.isfinite(out[1]).all() and np.abs(out[1]).max() > 0
