"""The training host path on the CPU: the CPU generator's seed, the explicit
grads, the optimizer buckets, the fc_act and chain windows, the fusion plan
against the JAX package's, liveness, and the graphed step's bookkeeping.

  * Random ops on CPUPlace draw from the program seed and the run counter.
  * Each explicit grad lowering (batch_norm, layer_norm, relu, gelu,
    elementwise_add, mul, reshape, softmax_with_cross_entropy, mean,
    average pool2d) against the port's generic grad (the
    forward re-run under autograd) on the same grad OpDesc and inputs, and
    against the JAX package's generic grad (jax.vjp of its lowering).
  * fused_sgd / fused_momentum / fused_adam bitwise the per-param ops, and
    against the JAX package's fused lowerings (its flat concat).
  * A program run with fc_act and chain windows bitwise the same program
    with no plan; `fusion.plan` over the ResNet-50 and LM training programs
    the same (anchor, end, kind) triples as the JAX package's.
  * Liveness: the same values as a run that keeps every temporary, and an
    env left holding only fetches, persistable outputs and state.
  * The graph gate's reasons, and the graphed step's buffers and copies
    with the capture stood in for by a re-run of its body (a CUDA graph
    needs the card: tests/test_torch_graph_gpu.py): two scopes on one
    Executor stay apart, the scope is handed copies and never a buffer,
    read-only state is not written back, a failed window leaves the
    scope, signatures share their state buffers, and the graph cache
    drops the signature run least recently.

Tolerances.
  * Explicit grad against the port's generic grad: f32 within 1e-6 of the
    largest magnitude of the generic grad; bf16 each element within one
    bf16 ulp of the generic grad's element plus that.
  * Against the JAX package's grad, the training parity tests' tolerances
    (tests/test_torch_training.py): f32 within 1e-4 of the largest
    magnitude; bf16 within 2 % of it (the additive term of its O2 rule).
  * Buckets against the JAX fused lowerings: f32 rounding, rtol 1e-6 and
    atol 1e-7 (tests/test_torch_training.py's optimizer-op rule).
  * Everything else bitwise.
"""

import torch_threads  # noqa: F401  (the cores shared among xdist workers)
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jfluid
from paddle_tpu import executor as jax_executor
from paddle_tpu.framework.desc import OpDesc as JOpDesc
from paddle_tpu.framework.framework import Operator as JOperator
from paddle_tpu.models import resnet as jax_resnet
from paddle_tpu.models import transformer as jax_transformer
from paddle_tpu.ops import fusion as jax_fusion
from paddle_tpu.ops import registry as jax_registry
import paddle_tpu_torch as pt
from paddle_tpu_torch import executor as port_executor
from paddle_tpu_torch.framework.desc import OpDesc
from paddle_tpu_torch.framework.framework import Operator
from paddle_tpu_torch.models import resnet as port_resnet
from paddle_tpu_torch.models import transformer as port_transformer
from paddle_tpu_torch.ops import fusion, registry


@pytest.fixture(autouse=True)
def _keep_jax_op_census():
    """The JAX executor's op census (executor._RECORDED_OPS) gets back the
    op types these runs added, as in tests/test_torch_training.py."""
    before = set(jax_executor._RECORDED_OPS)
    yield
    jax_executor._RECORDED_OPS.intersection_update(before)


# --- the CPU generator ------------------------------------------------------------

def _uniform_program(seed):
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        out = main.global_block().create_var(name="u", shape=[2, 3],
                                             dtype="float32")
        main.global_block().append_op(
            type="uniform_random", outputs={"Out": [out]},
            attrs={"shape": [2, 3], "dtype": "float32", "min": -1.0,
                   "max": 1.0, "seed": 0})
    main.random_seed = seed
    return main


def _draws(seed, runs, counter=0):
    main, scope = _uniform_program(seed), pt.Scope()
    scope.set_var("__rng_counter__", counter)
    exe = pt.Executor(pt.CPUPlace())
    return [exe.run(main, fetch_list=["u"], scope=scope)[0]
            for _ in range(runs)]


def test_cpu_draws_follow_the_counter_and_the_seed():
    four = _draws(7, 4)
    assert len({a.tobytes() for a in four}) == 4
    assert not np.array_equal(_draws(8, 1)[0], four[0])
    again = _draws(7, 1, counter=2)[0]
    np.testing.assert_array_equal(again, four[2])
    np.testing.assert_array_equal(_draws(7, 4)[3], four[3])


def test_fold_seed_keeps_every_bit():
    keys = [1 << b for b in range(63)]
    folded = {port_executor.fold_seed(k) for k in keys}
    assert len(folded) == len(keys)
    assert all(0 <= f < 2 ** 32 for f in folded)


# --- explicit grads ---------------------------------------------------------------

_BF16 = torch.bfloat16


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _op(cls, desc):
    op = cls.__new__(cls)
    op.block = None
    op.creation_site = None
    op.desc = desc
    return op


def _pctx(amp):
    return SimpleNamespace(amp_dtype="bfloat16" if amp else None,
                           amp_level=amp or "O1", quant_mode=None,
                           device=torch.device("cpu"), mesh=None)


def _jctx(amp):
    return SimpleNamespace(amp_dtype="bfloat16" if amp else None,
                           amp_level=amp or "O1", quant_mode=None,
                           layout_of=lambda name: None,
                           set_layout=lambda *a: None,
                           seq_len=lambda *a, **k: None, mesh=None)


def _to_jnp(t):
    if t.dtype == _BF16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _ulp_bf16(a):
    """One bf16 ulp at each |a| (the spacing above it; 2^-133 at zero)."""
    e = np.floor(np.log2(np.maximum(np.abs(a), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _grad_case(fwd_type, ins, attrs, main_out, amp=None, seed=0,
               more_outs=()):
    """Forward `fwd_type` on `ins` ({slot: tensor}) through the port's
    lowering, its grad OpDesc from the default maker, a cotangent for
    `main_out` and each of `more_outs` (the others missing): (explicit
    grads, generic grads, the
    JAX package's grads), each {slot: value}, and whether the op computed
    in bf16 (a bf16 input or AMP)."""
    names = {s: [s.lower()] for s in ins}
    fwd = registry.get(fwd_type)
    fview = _op(Operator, OpDesc(fwd_type, inputs=names, outputs={},
                                 attrs=dict(attrs)))
    outs = fwd.lower(_pctx(amp), fview, {s: [v] for s, v in ins.items()})
    out_names = {s: [s.lower() + "_out"] for s in outs}
    fdesc = OpDesc(fwd_type, inputs=names, outputs=out_names,
                   attrs=dict(attrs))
    gdesc, = registry.make_grad_op_descs(fdesc, set())
    rng = np.random.default_rng(seed)
    y = outs[main_out][0]
    ct = _t(rng.standard_normal(tuple(y.shape)).astype(np.float32), y.dtype)
    gins = {s: [v] for s, v in ins.items()}
    gins.update({s: list(v) for s, v in outs.items()})
    gins[main_out + "@GRAD"] = [ct]
    for slot in more_outs:
        v = outs[slot][0]
        gins[slot + "@GRAD"] = [_t(rng.standard_normal(tuple(v.shape))
                                   .astype(np.float32), v.dtype)]
    gop = _op(Operator, gdesc)
    explicit = registry.get(gdesc.type).lower(_pctx(amp), gop, gins)
    assert registry.get(gdesc.type).lower is not registry.generic_grad_lower
    generic = registry.generic_grad_lower(_pctx(amp), gop, gins)
    jdesc = JOpDesc(gdesc.type, inputs=gdesc.inputs, outputs=gdesc.outputs,
                    attrs=dict(gdesc.attrs))
    jins = {s: [None if v is None else _to_jnp(v) for v in vs]
            for s, vs in gins.items()}
    jax_grads = jax_registry.generic_grad_lower(_jctx(amp), _op(JOperator,
                                                                jdesc), jins)
    lowp = bool(amp) or any(v.dtype == _BF16 for v in ins.values())
    return ({s: v[0] for s, v in explicit.items()},
            {s: v[0] for s, v in generic.items()},
            {s: v[0] for s, v in jax_grads.items()}, lowp)


def _hold(explicit, generic, jax_grads, lowp=False):
    """`lowp`: the op computed in bf16 (a bf16 input or AMP), so the JAX
    comparison takes the bf16 rule whatever the grad's dtype."""
    assert sorted(explicit) == sorted(generic)
    for slot, want in generic.items():
        got = explicit[slot]
        assert got.dtype == want.dtype and got.shape == want.shape, slot
        g, w = _np32(got), _np32(want)
        big = np.abs(w).max()
        err = np.abs(g - w)
        if want.dtype == _BF16:
            assert (err <= _ulp_bf16(w) + 1e-6 * big).all(), \
                (slot, err.max())
        else:
            assert err.max() <= 1e-6 * big, (slot, err.max() / big)
        j = _np32(jax_grads[slot])
        tol = (2e-2 if lowp or want.dtype == _BF16 else 1e-4) * \
            max(big, 1e-30)
        assert np.abs(g - j).max() <= tol, (slot, "jax")


def _arr(rng, *shape, scale=1.0, shift=0.0):
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


@pytest.mark.parametrize("is_test", [False, True, "stats"],
                         ids=["train", "test", "train_stats"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_norm_grad(dtype, is_test):
    """"stats": training mode with cotangents on the four statistics
    outputs as well as Y."""
    rng = np.random.default_rng(1)
    dt = _BF16 if dtype == "bfloat16" else torch.float32
    x = _t(_arr(rng, 4, 3, 5, 5, scale=2.0, shift=0.5), dt)
    if dtype == "bfloat16":
        x = x.contiguous(memory_format=torch.channels_last)
    ins = {"X": x, "Scale": _t(_arr(rng, 3, shift=1.0)),
           "Bias": _t(_arr(rng, 3)), "Mean": _t(_arr(rng, 3, scale=0.1)),
           "Variance": _t(np.abs(_arr(rng, 3)) + 0.5)}
    stats = ("SavedMean", "SavedVariance", "MeanOut", "VarianceOut") \
        if is_test == "stats" else ()
    _hold(*_grad_case("batch_norm", ins, {"epsilon": 1e-5, "momentum": 0.9,
                                          "is_test": is_test is True}, "Y",
                      more_outs=stats))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_grad(dtype):
    """bf16 X takes the generic grad by design (nn_ops._layer_norm_grad),
    so that case holds bitwise; f32 is the explicit form."""
    rng = np.random.default_rng(2)
    dt = _BF16 if dtype == "bfloat16" else torch.float32
    ins = {"X": _t(_arr(rng, 2, 3, 16, shift=0.3), dt),
           "Scale": _t(_arr(rng, 16, shift=1.0)), "Bias": _t(_arr(rng, 16))}
    _hold(*_grad_case("layer_norm", ins, {"begin_norm_axis": 2,
                                          "epsilon": 1e-5}, "Y"))


@pytest.mark.parametrize("act", ["relu", "gelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_activation_grad(act, dtype):
    rng = np.random.default_rng(3)
    x = _arr(rng, 4, 33)
    x[0, :5] = 0.0
    dt = _BF16 if dtype == "bfloat16" else torch.float32
    _hold(*_grad_case(act, {"X": _t(x, dt)}, {}, "Out"))


@pytest.mark.parametrize("case", ["bias", "full", "o2_bias"])
def test_elementwise_add_grad(case):
    rng = np.random.default_rng(4)
    amp = "O2" if case == "o2_bias" else None
    x = _t(_arr(rng, 4, 6, 3), _BF16 if amp else torch.float32)
    y = _t(_arr(rng, 6)) if case != "full" else _t(_arr(rng, 4, 6, 3))
    _hold(*_grad_case("elementwise_add", {"X": x, "Y": y},
                      {"axis": 1 if case != "full" else -1}, "Out", amp=amp))


@pytest.mark.parametrize("case", ["f32", "o1", "o2", "col_dims"])
def test_mul_grad(case):
    rng = np.random.default_rng(5)
    amp = {"o1": "O1", "o2": "O2"}.get(case)
    xn = 2 if case == "col_dims" else 1
    x = _arr(rng, 2, 3, 5) if case == "col_dims" else _arr(rng, 4, 3, 5)
    y = _arr(rng, 5, 4) if case == "col_dims" else _arr(rng, 15, 6)
    xt = _t(x, _BF16 if case == "o2" else torch.float32)
    _hold(*_grad_case("mul", {"X": xt, "Y": _t(y)},
                      {"x_num_col_dims": xn, "y_num_col_dims": 1}, "Out",
                      amp=amp))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reshape_grad(dtype):
    rng = np.random.default_rng(6)
    dt = _BF16 if dtype == "bfloat16" else torch.float32
    _hold(*_grad_case("reshape", {"X": _t(_arr(rng, 2, 6, 2), dt)},
                      {"shape": [0, 3, -1]}, "Out"))


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_softmax_with_cross_entropy_grad(soft):
    rng = np.random.default_rng(7)
    logits = _t(_arr(rng, 6, 10, scale=2.0))
    if soft:
        p = np.abs(_arr(rng, 6, 10))
        label = _t(p / p.sum(-1, keepdims=True))
    else:
        label = torch.from_numpy(rng.integers(0, 10, (6, 1)))
    _hold(*_grad_case("softmax_with_cross_entropy",
                      {"Logits": logits, "Label": label},
                      {"soft_label": soft}, "Loss"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mean_grad(dtype):
    rng = np.random.default_rng(8)
    dt = _BF16 if dtype == "bfloat16" else torch.float32
    _hold(*_grad_case("mean", {"X": _t(_arr(rng, 3, 5, 2), dt)}, {}, "Out"))


@pytest.mark.parametrize("case", ["avg", "avg_pad", "global", "max"])
def test_pool2d_grad(case):
    """Average pooling is explicit; max pooling takes the generic grad by
    design (nn_ops._pool2d_grad), so that case holds bitwise."""
    rng = np.random.default_rng(9)
    attrs = {"pooling_type": "max" if case == "max" else "avg",
             "ksize": [3, 3], "strides": [2, 2],
             "paddings": [1, 1] if case in ("avg_pad", "max") else [0, 0],
             "global_pooling": case == "global", "exclusive": True}
    x = _t(_arr(rng, 2, 3, 7, 7)).contiguous(memory_format=torch.channels_last)
    _hold(*_grad_case("pool2d", {"X": x}, attrs, "Out"))


def test_explicit_grads_run_no_forward():
    """An LM training step: the generic grad re-ran no forward (every op
    of the LM's backward has an explicit grad)."""
    main, startup, loss = _small_lm(pt)
    registry.RERUNS.clear()
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    exe.run(main, feed=_lm_feed(), fetch_list=[loss], scope=scope)
    assert not registry.RERUNS


# --- optimizer buckets ------------------------------------------------------------

_OPT_ATTRS = {"sgd": {}, "momentum": {"mu": 0.9, "use_nesterov": False},
              "nesterov": {"mu": 0.9, "use_nesterov": True},
              "adam": {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}}


def _bucket_inputs(kind, pdtype, seed=0):
    rng = np.random.default_rng(seed)
    shapes = [(6, 5), (7,), (3, 4, 2)]
    t = kind if kind != "nesterov" else "momentum"
    per = {"Param": [], "Grad": []}
    if t == "momentum":
        per["Velocity"] = []
    if t == "adam":
        per["Moment1"], per["Moment2"] = [], []
    for s in shapes:
        for slot in per:
            a = _arr(rng, *s)
            if slot == "Moment2":
                a = np.abs(a)
            per[slot].append(_t(a, _BF16 if slot == "Grad" else pdtype))
    shared = {"LearningRate": [_t(np.array([0.1], np.float32))]}
    if t == "adam":
        shared["Beta1Pow"] = [_t(np.array([0.9 ** 3], np.float32))]
        shared["Beta2Pow"] = [_t(np.array([0.999 ** 3], np.float32))]
    return t, per, shared


@pytest.mark.parametrize("kind", ["sgd", "momentum", "nesterov", "adam"])
@pytest.mark.parametrize("pdtype", ["float32", "bfloat16"])
def test_fused_bucket_is_the_per_param_ops(kind, pdtype):
    """bf16 grads into f32 (or bf16) params: bitwise the per-param op on
    each member; f32 params also within f32 rounding of the JAX package's
    flat-concat fused lowering."""
    pdt = _BF16 if pdtype == "bfloat16" else torch.float32
    t, per, shared = _bucket_inputs(kind, pdt)
    attrs = _OPT_ATTRS[kind]
    op = SimpleNamespace(attr=lambda k, d=None: attrs.get(k, d))
    got = registry.get("fused_" + t).lower(None, op, {**per, **shared})
    n = len(per["Param"])
    for i in range(n):
        one = registry.get(t).lower(None, op, {
            **{s: [v[i]] for s, v in per.items()}, **shared})
        for slot, vals in one.items():
            assert torch.equal(got[slot][i], vals[0]), (slot, i)
            assert got[slot][i].dtype == vals[0].dtype
    if pdt != torch.float32:
        return
    jins = {s: [_to_jnp(v) for v in vs] for s, vs in {**per,
                                                      **shared}.items()}
    want = jax_registry.get("fused_" + t).lower(None, op, jins)
    for slot in want:
        for g, w in zip(got[slot], want[slot]):
            np.testing.assert_allclose(_np32(g), _np32(w), rtol=1e-6,
                                       atol=1e-7, err_msg=slot)


def test_bucket_sub_buckets_by_dtype_and_counts_exclusions():
    """A momentum run over params of two dtypes runs one fused op per dtype
    sub-bucket; a param the program shards stays per-param, counted."""
    main, startup, loss = _small_mlp(pt)
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    feed = _mlp_feed()
    groups = fusion.plan(main)
    bucket = next(g for g in groups.values() if g.kind == "opt_bucket")
    params = [fusion._first(m.desc.input("Param")) for m in bucket.members]
    assert len(params) == 4
    main._param_shardings = {params[0]: "x"}
    fusion.COUNTERS.reset()
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope, use_jit=False)
    assert fusion.COUNTERS.fallbacks == {"sharded_param": 1}
    assert fusion.COUNTERS.buckets == {"fused_momentum": 1}
    del main._param_shardings
    for p in params[2:]:
        v = p + "_velocity_0"
        scope.set_var(v, scope.find_var(v).to(torch.float64))
    fusion.COUNTERS.reset()
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert fusion.COUNTERS.buckets == {"fused_momentum": 2}
    assert not fusion.COUNTERS.fallbacks


# --- fc_act and chain windows, and the plan ---------------------------------------

def _small_mlp(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[12], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        h = fluid.layers.fc(x, size=16, act="relu")
        h = fluid.layers.elementwise_add(h, fluid.layers.scale(h, scale=0.5))
        h = fluid.layers.relu(h)
        pred = fluid.layers.fc(h, size=1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        fluid.optimizer.Momentum(learning_rate=0.05,
                                 momentum=0.9).minimize(loss)
    return main, startup, loss


def _mlp_feed():
    rng = np.random.default_rng(9)
    return {"x": _arr(rng, 8, 12), "y": _arr(rng, 8, 1)}


def _grads_fetch(main, loss):
    return [loss.name] + sorted(n for n in main.grad_info_map
                                if n != loss.name + "@GRAD")


def test_fc_act_and_chain_windows_are_their_members(monkeypatch):
    main, startup, loss = _small_mlp(pt)
    kinds = sorted({g.kind for g in fusion.plan(main).values()})
    assert kinds == ["chain", "fc_act", "opt_bucket"]
    fetch = _grads_fetch(main, loss)
    runs = []
    for plan in (fusion.plan, lambda program: None):
        monkeypatch.setattr(fusion, "plan", plan)
        scope = pt.Scope()
        exe = pt.Executor(pt.CPUPlace())
        exe.run(startup, scope=scope)
        if runs:
            for n, v in runs[0][1].items():
                scope.set_var(n, v.clone())
        init = {n: v.clone() for n, v in scope.vars.items()
                if isinstance(v, torch.Tensor)}
        outs = [exe.run(main, feed=_mlp_feed(), fetch_list=fetch,
                        scope=scope) for _ in range(2)]
        runs.append((outs, init, scope))
    (a, _, sa), (b, _, sb) = runs
    for x, y in zip(sum(a, []), sum(b, [])):
        np.testing.assert_array_equal(x, y)
    for n, v in sa.vars.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, sb.vars[n]), n


def _resnet50(fluid):
    resnet = jax_resnet if fluid is jfluid else port_resnet
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[3, 224, 224],
                                dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        avg_cost, _, _ = fluid.models.build_image_classifier(
            resnet.resnet50, img, label, class_dim=1000)
        opt = fluid.optimizer.Momentum(learning_rate=0.0125, momentum=0.9)
        opt = fluid.amp.decorate(opt, level="O2")
        opt.minimize(avg_cost)
    return main


def _lm(fluid, t=2048, vocab=8192, d_model=512, n_head=8, n_layer=4):
    tm = jax_transformer if fluid is jfluid else port_transformer
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        tok = fluid.layers.data(name="tok", shape=[-1, t], dtype="int64",
                                append_batch_size=False)
        lab = fluid.layers.data(name="lab", shape=[-1, t], dtype="int64",
                                append_batch_size=False)
        loss = tm.transformer_lm(tok, lab, vocab_size=vocab, d_model=d_model,
                                 n_head=n_head, n_layer=n_layer)
        opt = fluid.optimizer.Adam(learning_rate=1e-4)
        opt = fluid.amp.decorate(opt, level="O2")
        opt.minimize(loss, startup_program=startup)
    return main, startup, loss


def _small_lm(fluid):
    return _lm(fluid, t=16, vocab=64, d_model=32, n_head=2, n_layer=2)


def _lm_feed():
    rng = np.random.default_rng(0)
    return {"tok": rng.integers(0, 64, (2, 16)).astype(np.int64),
            "lab": rng.integers(0, 64, (2, 16)).astype(np.int64)}


def _triples(groups):
    return sorted((a, g.end, g.kind) for a, g in (groups or {}).items())


@pytest.mark.parametrize("model", ["resnet50", "lm"])
def test_plan_is_the_reference_plan(model):
    """bench.py's ResNet-50 O2 (Momentum) and LM O2 (Adam) training
    programs, built in both packages: the same windows."""
    build = _resnet50 if model == "resnet50" else (lambda f: _lm(f)[0])
    want = _triples(jax_fusion.plan(build(jfluid)))
    got = _triples(fusion.plan(build(pt)))
    assert got == want
    kinds = {k for _, _, k in got}
    assert kinds == ({"opt_bucket", "conv_bn_act", "fc_act", "chain"}
                     if model == "resnet50" else
                     {"opt_bucket", "fc_act", "chain"})


def test_fused_ops_are_registered():
    for t in ("fused_sgd", "fused_momentum", "fused_adam"):
        assert registry.get(t).lower is not None, t


def test_compose_windows_run_their_members(monkeypatch):
    """fc_act and chain windows run the program's own ops, no fused op
    (the optimizer bucket is the one fused op)."""
    main, startup, loss = _small_mlp(pt)
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    ran = []
    exec_op = pt.Executor._exec_op

    def record(self, ctx, op, env):
        ran.append(op.type)
        return exec_op(self, ctx, op, env)
    monkeypatch.setattr(pt.Executor, "_exec_op", record)
    exe.run(main, feed=_mlp_feed(), fetch_list=[loss], scope=scope)
    program_types = {op.type for op in main.global_block().ops}
    compose = [m.type for g in fusion.plan(main).values()
               if g.kind in ("fc_act", "chain") for m in g.members]
    assert compose
    assert set(ran) - program_types == {"fused_momentum"}
    assert ran.count("mul") == [op.type for op in
                                main.global_block().ops].count("mul")


# --- liveness ----------------------------------------------------------------------

def test_liveness_keeps_values_and_frees_temporaries(monkeypatch):
    """Bitwise the same as a run that drops nothing (no liveness plan)."""
    main, startup, loss = _small_lm(pt)
    fetch = _grads_fetch(main, loss)
    runs = []
    for plan in (port_executor.liveness, lambda ops, groups: {}):
        monkeypatch.setattr(port_executor, "liveness", plan)
        scope = pt.Scope()
        exe = pt.Executor(pt.CPUPlace())
        exe.run(startup, scope=scope)
        if runs:
            for n, v in runs[0][1].items():
                scope.set_var(n, v.clone())
        init = {n: v.clone() for n, v in scope.vars.items()
                if isinstance(v, torch.Tensor)}
        outs = [exe.run(main, feed=_lm_feed(), fetch_list=fetch,
                        scope=scope) for _ in range(2)]
        runs.append((outs, init, scope))
    (a, _, sa), (b, _, sb) = runs
    for x, y in zip(sum(a, []), sum(b, [])):
        np.testing.assert_array_equal(x, y)
    for n, v in sa.vars.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, sb.vars[n]), n


def test_liveness_leaves_fetches_outputs_and_state():
    main, startup, loss = _small_lm(pt)
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    feed = {n: torch.from_numpy(v) for n, v in _lm_feed().items()}
    state_names = exe._resolve_state(main, feed, scope)
    persist = exe._persistable_outputs(main)
    env = {n: scope.find_var(n) for n in state_names}
    env.update(feed)
    ctx = port_executor.LoweringContext(exe, main, 0)
    groups, drops, _ = exe._block_plan(main)
    protected = {loss.name} | set(persist)
    exe._run_block(ctx, main, env, groups, protected, drops,
                   protected | set(state_names))
    assert set(env) <= protected | set(state_names)
    assert loss.name in env and set(persist) <= set(env)
    n_ops = len(main.global_block().ops)
    assert n_ops > 100 and len(env) < len(state_names) + len(persist) + 2


def test_liveness_counts_a_window_at_its_end():
    main, _, _ = _small_mlp(pt)
    ops = main.global_block().ops
    groups = fusion.plan(main)
    drops = port_executor.liveness(ops, groups)
    fc = next(g for g in groups.values() if g.kind == "fc_act")
    inner = fc.members[0].output_arg_names[0]      # mul's Out, read by add
    where = [p for p, names in drops.items() if inner in names]
    assert where and where[0] >= fc.end - 1


# --- the graph gate and the graphed step's bookkeeping -----------------------------

def test_graph_gate_reasons():
    main, startup, loss = _small_mlp(pt)
    exe = pt.Executor(pt.CPUPlace())
    feed = _mlp_feed()
    assert exe.graph_gate(main, feed) == "cpu"
    exe.device = torch.device("cuda", 0)      # the gate reads the type only
    assert exe.graph_gate(main, feed) is None
    assert exe.graph_gate(main, feed, use_jit=False) == "use_jit"
    assert exe.graph_gate(main, feed, use_program_cache=False) == \
        "no_program_cache"
    # an initialiser runs eager; a random op is graphed
    assert exe.graph_gate(startup, {}) == "startup"
    assert any(o.type == "uniform_random"
               for o in startup.global_block().ops)
    # a LoD feed is graphed: its lengths are feeds of the graph
    main.global_block().var("x").desc.lod_level = 1
    assert exe.graph_gate(main, feed) is None


def test_use_jit_false_gives_the_same_results():
    main, startup, loss = _small_lm(pt)
    fetch = _grads_fetch(main, loss)
    outs, init = [], None
    for use_jit in (None, False):
        scope = pt.Scope()
        exe = pt.Executor(pt.CPUPlace())
        exe.run(startup, scope=scope)
        if init is None:
            init = {n: v.clone() for n, v in scope.vars.items()
                    if isinstance(v, torch.Tensor)}
        for n, v in init.items():
            scope.set_var(n, v.clone())
        port_executor.COUNTERS.reset()
        outs.append(exe.run(main, feed=_lm_feed(), fetch_list=fetch,
                            scope=scope, use_jit=use_jit))
        assert port_executor.COUNTERS.eager == {
            "cpu" if use_jit is None else "use_jit": 1}
    for x, y in zip(*outs):
        np.testing.assert_array_equal(x, y)


def _counter_tables():
    from paddle_tpu_torch import quant
    from paddle_tpu_torch.ops import attention_cuda, bn_cuda, conv_cuda
    return (conv_cuda.COUNTERS, bn_cuda.COUNTERS, attention_cuda.COUNTERS,
            quant.COUNTERS, fusion.COUNTERS)


class _Rerun:
    """Stands in for a captured CUDA graph on the CPU: a replay runs the
    captured body again on the same buffers, with the kernel counters put
    back after it (a real replay runs no Python, so counts nothing)."""

    def __init__(self, body, pool=None):
        self.body = body
        body()

    def pool(self):
        return None

    def replay(self):
        tables = _counter_tables()
        saved = [{f: (dict(v) if isinstance(v, dict) else v)
                  for f, v in vars(t).items()} for t in tables]
        reruns = dict(registry.RERUNS)
        self.body()
        for t, s in zip(tables, saved):
            for f, v in s.items():
                setattr(t, f, v)
        registry.RERUNS.clear()
        registry.RERUNS.update(reruns)


@pytest.fixture
def graphed(monkeypatch):
    """The graph path on the CPU: the gate asked as for a CUDA place, the
    capture stood in for by `_Rerun`."""
    gate = pt.Executor.graph_gate

    def cuda_gate(self, program, feed, use_jit=None, use_program_cache=True):
        device, self.device = self.device, torch.device("cuda", 0)
        try:
            return gate(self, program, feed, use_jit, use_program_cache)
        finally:
            self.device = device
    monkeypatch.setattr(port_executor, "capture_graph", _Rerun)
    monkeypatch.setattr(pt.Executor, "graph_gate", cuda_gate)
    port_executor.COUNTERS.reset()
    return port_executor.COUNTERS


def _lm_scopes(n):
    main, startup, loss = _small_lm(pt)
    scope = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(startup, scope=scope)
    init = {n_: v.clone() for n_, v in scope.vars.items()
            if isinstance(v, torch.Tensor)}
    scopes = []
    for _ in range(n):
        s = pt.Scope()
        for k, v in init.items():
            s.set_var(k, v.clone())
        scopes.append(s)
    return main, loss, scopes


def _feeds(n, batch=2):
    rng = np.random.default_rng(11)
    return [{"tok": rng.integers(0, 64, (batch, 16)).astype(np.int64),
             "lab": rng.integers(0, 64, (batch, 16)).astype(np.int64)}
            for _ in range(n)]


def _same_scopes(a, b):
    for n, v in a.vars.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, b.vars[n]), n


def test_graphed_steps_match_eager_steps(graphed):
    main, loss, (sg, se) = _lm_scopes(2)
    exe = pt.Executor(pt.CPUPlace())
    got, want = [], []
    for feed in _feeds(4):
        got.append(exe.run(main, feed=feed, fetch_list=[loss], scope=sg)[0])
        want.append(exe.run(main, feed=feed, fetch_list=[loss], scope=se,
                            use_jit=False)[0])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    _same_scopes(sg, se)
    assert (graphed.warmups, graphed.captures, graphed.replays) == (1, 1, 3)
    # the startup program, an initialiser, runs eager
    assert graphed.eager == {"use_jit": 4, "startup": 1}


def test_replay_counts_nothing(graphed):
    """A replay runs no Python: the fused-bucket and re-run counters move
    on the warm-up and the capture only."""
    main, loss, (sg,) = _lm_scopes(1)
    exe = pt.Executor(pt.CPUPlace())
    feeds = _feeds(4)
    for feed in feeds[:2]:
        exe.run(main, feed=feed, fetch_list=[loss], scope=sg)
    fusion.COUNTERS.reset()
    registry.RERUNS.clear()
    for feed in feeds[2:]:
        exe.run(main, feed=feed, fetch_list=[loss], scope=sg)
    assert graphed.replays == 3
    assert not fusion.COUNTERS.buckets and not registry.RERUNS


def _shared(a, b):
    """Names whose tensors in scopes `a` and `b` share storage."""
    return [n for n, v in a.vars.items() if isinstance(v, torch.Tensor)
            and v.untyped_storage().data_ptr()
            == b.vars[n].untyped_storage().data_ptr()]


def test_two_scopes_on_one_executor_stay_apart(graphed):
    """Two scopes graphed on one Executor, from one state on different
    batches: each bitwise its eager twin, and no tensor shared."""
    main, loss, (sa, sb, ea, eb) = _lm_scopes(4)
    exe = pt.Executor(pt.CPUPlace())
    fa, fb = _feeds(4), _feeds(8)[4:]
    for x, y in zip(fa, fb):
        for scope, eager, feed in ((sa, ea, x), (sb, eb, y)):
            got = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0]
            want = exe.run(main, feed=feed, fetch_list=[loss], scope=eager,
                           use_jit=False)[0]
            np.testing.assert_array_equal(got, want)
    _same_scopes(sa, ea)
    _same_scopes(sb, eb)
    assert not _shared(sa, sb)
    assert (graphed.captures, graphed.replays) == (1, 7)


def test_scope_is_handed_copies_not_buffers(graphed):
    """A tensor taken from the scope keeps its value through later steps,
    and the scope never holds a graph's static buffer."""
    main, loss, (sg,) = _lm_scopes(1)
    exe = pt.Executor(pt.CPUPlace())
    feeds = _feeds(5)
    for feed in feeds[:3]:
        exe.run(main, feed=feed, fetch_list=[loss], scope=sg)
    name = next(n for n in sg.vars if n.endswith(".w_0"))
    taken = sg.find_var(name)
    value = taken.clone()
    for feed in feeds[3:]:
        exe.run(main, feed=feed, fetch_list=[loss], scope=sg)
    assert torch.equal(taken, value)
    assert not torch.equal(sg.find_var(name), value)
    buffers = {b.t.untyped_storage().data_ptr()
               for b in exe._buffers.values()}
    assert not any(v.untyped_storage().data_ptr() in buffers
                   for v in sg.vars.values() if isinstance(v, torch.Tensor))


def test_read_only_state_is_not_written_back(graphed):
    """State the step reads and does not write (the learning rate) stays
    the scope's own tensor; the written state is handed back as copies."""
    main, loss, (sg,) = _lm_scopes(1)
    exe = pt.Executor(pt.CPUPlace())
    persist = set(exe._persistable_outputs(main))
    before = {n: v for n, v in sg.vars.items() if isinstance(v, torch.Tensor)}
    read_only = [n for n in exe._resolve_state(main, _feeds(1)[0], sg)
                 if n not in persist]
    assert read_only
    for feed in _feeds(3):
        exe.run(main, feed=feed, fetch_list=[loss], scope=sg)
    for n in read_only:
        assert sg.find_var(n) is before[n], n
    assert graphed.copied_in == 0


def test_failed_window_leaves_the_scope(graphed, monkeypatch):
    """A graphed run_steps window that fails after stepping the state
    buffers leaves the scope as it was, and the next graphed step starts
    from the scope, bitwise its eager twin."""
    main, loss, (sg, se) = _lm_scopes(2)
    exe = pt.Executor(pt.CPUPlace())
    feeds = _feeds(8)
    for feed in feeds[:2]:
        exe.run(main, feed=feed, fetch_list=[loss], scope=sg)
        exe.run(main, feed=feed, fetch_list=[loss], scope=se, use_jit=False)
    kept = {n: v.clone() for n, v in sg.vars.items()
            if isinstance(v, torch.Tensor)}
    graphed_step = pt.Executor._graphed
    calls = []

    def third_fails(self, *args, **kwargs):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("the third step failed")
        return graphed_step(self, *args, **kwargs)
    monkeypatch.setattr(pt.Executor, "_graphed", third_fails)
    with pytest.raises(RuntimeError, match="third step"):
        exe.run_steps(main, feeds[2:6], fetch_list=[loss], scope=sg)
    for n, v in kept.items():
        assert torch.equal(sg.find_var(n), v), n
    monkeypatch.setattr(pt.Executor, "_graphed", graphed_step)
    a = exe.run(main, feed=feeds[6], fetch_list=[loss], scope=sg)[0]
    b = exe.run(main, feed=feeds[6], fetch_list=[loss], scope=se,
                use_jit=False)[0]
    np.testing.assert_array_equal(a, b)
    _same_scopes(sg, se)


def test_signatures_share_state_buffers(graphed):
    """Two feed shapes of one program: two graphs reading one set of state
    buffers, each step bitwise its eager twin."""
    main, loss, (sg, se) = _lm_scopes(2)
    exe = pt.Executor(pt.CPUPlace())
    for feed in _feeds(2) + _feeds(2, batch=3) + _feeds(2):
        a = exe.run(main, feed=feed, fetch_list=[loss], scope=sg)[0]
        b = exe.run(main, feed=feed, fetch_list=[loss], scope=se,
                    use_jit=False)[0]
        np.testing.assert_array_equal(a, b)
    _same_scopes(sg, se)
    first, second = exe._graphs.values()
    assert first.state.keys() == second.state.keys()
    assert all(first.state[n] is second.state[n] for n in first.state)
    assert len(exe._buffers) == len(first.state)


def test_graph_cache_drops_the_least_recent(graphed, monkeypatch):
    monkeypatch.setattr(port_executor, "GRAPH_CACHE_SIZE", 2)
    main, loss, (sg, se) = _lm_scopes(2)
    exe = pt.Executor(pt.CPUPlace())
    for batch in (2, 3, 2, 4):
        for feed in _feeds(2, batch=batch):
            a = exe.run(main, feed=feed, fetch_list=[loss], scope=sg)[0]
            b = exe.run(main, feed=feed, fetch_list=[loss], scope=se,
                        use_jit=False)[0]
            np.testing.assert_array_equal(a, b)
    _same_scopes(sg, se)
    assert [k[2][0][1][0] for k in exe._graphs] == [2, 4]
    assert graphed.evicted == 1 and graphed.warmups == 3


def test_replaced_scope_variable_is_copied_in(graphed):
    main, loss, (sg, se) = _lm_scopes(2)
    exe = pt.Executor(pt.CPUPlace())
    feeds = _feeds(4)
    for feed in feeds[:3]:
        exe.run(main, feed=feed, fetch_list=[loss], scope=sg)
        exe.run(main, feed=feed, fetch_list=[loss], scope=se, use_jit=False)
    name = next(n for n in sg.vars if n.endswith(".w_0"))
    new = torch.full_like(sg.find_var(name), 0.01)
    sg.set_var(name, new.clone())
    se.set_var(name, new.clone())
    before = graphed.copied_in
    a = exe.run(main, feed=feeds[3], fetch_list=[loss], scope=sg)[0]
    b = exe.run(main, feed=feeds[3], fetch_list=[loss], scope=se,
                use_jit=False)[0]
    np.testing.assert_array_equal(a, b)
    assert graphed.copied_in == before + 1
    _same_scopes(sg, se)


def test_new_feed_shape_captures_anew(graphed):
    main, loss, (sg,) = _lm_scopes(1)
    exe = pt.Executor(pt.CPUPlace())
    for feed in _feeds(2) + _feeds(2, batch=3) + _feeds(1):
        exe.run(main, feed=feed, fetch_list=[loss], scope=sg)
    assert (graphed.warmups, graphed.captures, graphed.replays) == (2, 2, 3)


def test_fetches_come_back_as_copies(graphed):
    main, loss, (sg,) = _lm_scopes(1)
    exe = pt.Executor(pt.CPUPlace())
    feeds = _feeds(4)
    outs = [exe.run(main, feed=f, fetch_list=[loss], scope=sg,
                    return_numpy=False)[0] for f in feeds]
    assert len({o.data_ptr() for o in outs[1:]}) == 3
    assert len({float(o) for o in outs}) == 4


def test_run_steps_replays_each_step(graphed):
    main, loss, (sg, se) = _lm_scopes(2)
    exe = pt.Executor(pt.CPUPlace())
    feeds = _feeds(6)
    exe.run(main, feed=feeds[0], fetch_list=[loss], scope=sg)
    exe.run(main, feed=feeds[0], fetch_list=[loss], scope=se, use_jit=False)
    got = exe.run_steps(main, feeds[1:5], fetch_list=[loss], scope=sg,
                        fetch_mode="stack")[0]
    want = [exe.run(main, feed=f, fetch_list=[loss], scope=se,
                    use_jit=False)[0] for f in feeds[1:5]]
    np.testing.assert_array_equal(got, np.stack(want))
    _same_scopes(sg, se)
    assert (graphed.captures, graphed.replays) == (1, 4)


def test_failed_capture_raises(graphed, monkeypatch):
    """An admitted step whose capture fails raises; nothing runs eager in
    its place."""
    def broken(body, pool=None):
        raise RuntimeError("operation not permitted when stream is capturing")
    monkeypatch.setattr(port_executor, "capture_graph", broken)
    main, loss, (sg,) = _lm_scopes(1)
    exe = pt.Executor(pt.CPUPlace())
    feeds = _feeds(2)
    exe.run(main, feed=feeds[0], fetch_list=[loss], scope=sg)
    with pytest.raises(RuntimeError, match="CUDA graph capture"):
        exe.run(main, feed=feeds[1], fetch_list=[loss], scope=sg)
    assert graphed.eager == {"startup": 1}
