"""The port's static analyzer (paddle_tpu_torch.analysis) against the JAX
package's (paddle_tpu/analysis), on the CPU.

  * Each case of tests/test_analysis.py (and the shipped examples, a small
    ResNet in O2 and the LM), built alike in both packages, gives the same
    diagnostics: equal (severity, code, op_index, var) lists, except the
    JAX package's `layout-barrier` infos (the port has no layout pass) and
    the conv-gate warnings, which each package derives from its own gate.
    Those are held apart: per conv2d op, each package's warning says its
    own gate's reason, and where the two gates answer differently the pair
    of reasons is one of CONV_GATE_DIFFERENCES, listed per case.
  * infer's shapes and dtypes equal the reference's on every var of
    ResNet-50 O2's training program and the LM's.
  * The PADDLE_TPU_VERIFY hook: a clean program runs, a broken one raises
    ProgramVerifyError before its first op.
  * The serving engine refuses a broken program at admission, before any
    bucket runs.
"""

import torch_threads  # noqa: F401  (the cores shared among xdist workers)
import collections
import os
import re
import sys
from types import SimpleNamespace

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as pt
from paddle_tpu.analysis import analyze_program as janalyze
from paddle_tpu_torch import errors
from paddle_tpu_torch import executor as executor_mod
from paddle_tpu_torch.analysis import analyze_program, infer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --- the cases, each built by a function of the fluid module -----------------

def _fit_a_line(fl):
    main, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        x = fl.layers.data(name="x", shape=[13])
        y = fl.layers.data(name="y", shape=[1])
        pred = fl.layers.fc(input=x, size=1)
        loss = fl.layers.mean(fl.layers.square_error_cost(input=pred, label=y))
        fl.optimizer.SGD(learning_rate=0.01).minimize(
            loss, startup_program=startup)
    return main, startup, loss


def case_clean(fl):
    main, _, loss = _fit_a_line(fl)
    return main, ["x", "y"], [loss.name]


def case_rank_mismatch(fl):
    main, _, loss = _fit_a_line(fl)
    main.global_block().desc.var("x").shape = [-1]
    return main, ["x", "y"], [loss.name]


def case_unregistered_op(fl):
    desc = sys.modules[fl.__name__ + ".framework.desc"]
    main = fl.Program()
    with fl.program_guard(main, fl.Program()):
        fl.layers.data(name="x", shape=[4])
        b = main.global_block()
        b.create_var(name="o", shape=[-1, 4], dtype="float32")
        b.desc.ops.append(desc.OpDesc(
            type="definitely_not_an_op",
            inputs={"X": ["x"]}, outputs={"Out": ["o"]}))
        b._sync_ops()
    return main, ["x"], ["o"]


def case_use_before_def(fl):
    main = fl.Program()
    with fl.program_guard(main, fl.Program()):
        fl.layers.data(name="x", shape=[4])
        b = main.global_block()
        b.create_var(name="t", shape=[-1, 4], dtype="float32")
        b.create_var(name="o", shape=[-1, 4], dtype="float32")
        b.append_op(type="scale", inputs={"X": ["t"]},
                    outputs={"Out": ["o"]}, attrs={"scale": 2.0})
        b.append_op(type="scale", inputs={"X": ["x"]},
                    outputs={"Out": ["t"]}, attrs={"scale": 1.0})
    return main, ["x"], ["o"]


def case_dead_op(fl):
    main = fl.Program()
    with fl.unique_name.guard(), fl.program_guard(main, fl.Program()):
        x = fl.layers.data(name="x", shape=[4])
        kept = fl.layers.scale(x, scale=2.0)
        fl.layers.scale(x, scale=3.0)
    return main, ["x"], [kept.name]


def case_donated_fetch(fl):
    main, _, loss = _fit_a_line(fl)
    params = sorted(n for n, v in main.global_block().desc.vars.items()
                    if v.persistable and n.endswith(".w_0"))
    return main, ["x", "y"], [loss.name, params[0]]


def case_param_grad_pairing(fl):
    main, _, loss = _fit_a_line(fl)
    dense = [g for _, g in main._grad_param_pairs if g.endswith(".w_0@GRAD")]
    main.global_block().desc.var(dense[0]).shape = [3, 3, 3]
    return main, ["x", "y"], [loss.name]


def case_sharding_indivisible(fl):
    main = fl.Program()
    main.global_block().create_var(name="w", shape=[10, 6], dtype="float32",
                                   persistable=True)
    main._param_shardings = {"w": (None, "mp")}
    main._mesh = SimpleNamespace(shape={"mp": 4}, axis_names=("mp",))
    return main, [], []


def case_sharding_unknown_axis(fl):
    main = fl.Program()
    main.global_block().create_var(name="w", shape=[8, 8], dtype="float32",
                                   persistable=True)
    main._param_shardings = {"w": ("tp", None)}
    main._mesh = SimpleNamespace(shape={"mp": 4}, axis_names=("mp",))
    return main, [], []


def case_conv_channel_miss(fl):
    main = fl.Program()
    with fl.unique_name.guard(), fl.program_guard(main, fl.Program()):
        img = fl.layers.data(name="img", shape=[64, 16, 16])
        out = fl.layers.conv2d(input=img, num_filters=128, filter_size=3,
                               padding=1)
    main._amp_dtype = "bfloat16"
    return main, ["img"], [out.name]


def case_conv_channels_both(fl):
    """Ci = 12: a miss of both gates, for the same reason."""
    main = fl.Program()
    with fl.unique_name.guard(), fl.program_guard(main, fl.Program()):
        img = fl.layers.data(name="img", shape=[12, 16, 16])
        out = fl.layers.conv2d(input=img, num_filters=128, filter_size=3,
                               padding=1)
    main._amp_dtype = "bfloat16"
    return main, ["img"], [out.name]


def case_conv_f32(fl):
    """f32 operands: "dtype, then channels" in the reference, "dtype" in
    the port (Ci 64 is a multiple of 8)."""
    main = fl.Program()
    with fl.unique_name.guard(), fl.program_guard(main, fl.Program()):
        img = fl.layers.data(name="img", shape=[64, 16, 16])
        out = fl.layers.conv2d(input=img, num_filters=64, filter_size=3,
                               padding=1)
    return main, ["img"], [out.name]


def _shallow_fc(fl, o3):
    main = fl.Program()
    with fl.unique_name.guard(), fl.program_guard(main, fl.Program()):
        x = fl.layers.data(name="x", shape=[24], dtype="float32")
        h = fl.layers.fc(input=x, size=64, act="relu")
        out = fl.layers.fc(input=h, size=64)
    main._amp_dtype = "bfloat16"
    if o3:
        main._amp_level = "O3"
        main._quant_mode = "int8"
    return main, ["x"], [out.name]


def case_quant_shallow_matmul(fl):
    return _shallow_fc(fl, True)


def case_quant_silent_below_o3(fl):
    return _shallow_fc(fl, False)


def _emb_cache(fl, cache_rows):
    main = fl.Program()
    with fl.program_guard(main, fl.Program()), fl.unique_name.guard():
        ids = fl.layers.data(name="ids", shape=[26], dtype="int64")
        fl.layers.embedding(ids, size=[1000, 8], is_sparse=True,
                            param_attr=fl.ParamAttr(name="emb_w"),
                            cache_rows=cache_rows)
    return main, ["ids"], []


def case_emb_cache_thrash(fl):
    return _emb_cache(fl, 64)


def case_emb_cache_covered(fl):
    return _emb_cache(fl, 256)


def _resnet(fl, depth=8, amp=True):
    main, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        img = fl.layers.data(name="img", shape=[3, 32, 32], dtype="float32")
        label = fl.layers.data(name="label", shape=[1], dtype="int64")
        loss, _, _ = fl.models.build_image_classifier(
            fl.models.resnet_cifar10, img, label, class_dim=10, depth=depth)
        opt = fl.optimizer.Momentum(learning_rate=0.01, momentum=0.9)
        if amp:
            opt = fl.amp.decorate(opt, level="O2")
        opt.minimize(loss)
    return main, ["img", "label"], [loss.name]


def case_resnet_o2(fl):
    return _resnet(fl)


def _lm(fl, n_layer=1, seqlen=16, vocab=64, d_model=32, n_head=2):
    main, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        tok = fl.layers.data(name="tok", shape=[-1, seqlen], dtype="int64",
                             append_batch_size=False)
        lab = fl.layers.data(name="lab", shape=[-1, seqlen], dtype="int64",
                             append_batch_size=False)
        loss = fl.models.transformer_lm(tok, lab, vocab_size=vocab,
                                        d_model=d_model, n_head=n_head,
                                        n_layer=n_layer)
        opt = fl.amp.decorate(fl.optimizer.Adam(learning_rate=1e-3),
                              level="O2")
        opt.minimize(loss)
    return main, ["tok", "lab"], [loss.name]


def case_lm_o2(fl):
    return _lm(fl)


def _example(fl, name):
    """examples/fluid/train_<name>.py's build_programs(), the source read
    with this fluid module's package in place of paddle_tpu."""
    path = os.path.join(REPO, "examples", "fluid", f"train_{name}.py")
    src = open(path).read()
    src = re.sub(r"\bpaddle_tpu\b", fl.__name__, src)
    mod = type(sys)(f"_ex_{fl.__name__}_{name}")
    mod.__file__ = path
    exec(compile(src, path, "exec"), mod.__dict__)
    with fl.unique_name.guard():
        built = mod.build_programs()
    return built["main"], built["feeds"], built["fetches"]


def case_example_fit_a_line(fl):
    return _example(fl, "fit_a_line")


def case_example_criteo_dlrm(fl):
    return _example(fl, "criteo_dlrm")


def case_example_transformer_long_context(fl):
    return _example(fl, "transformer_long_context")


CASES = {n[len("case_"):]: f for n, f in sorted(globals().items())
         if n.startswith("case_")}

# the codes each reference-test case is about (tests/test_analysis.py)
EXPECT = {
    "rank_mismatch": "rank-mismatch", "unregistered_op": "unregistered-op",
    "use_before_def": "use-before-def", "dead_op": "dead-op",
    "donated_fetch": "donated-fetch",
    "param_grad_pairing": "param-grad-shape",
    "sharding_indivisible": "sharding-indivisible",
    "sharding_unknown_axis": "sharding-unknown-axis",
    "quant_shallow_matmul": "quant-fallback",
    "emb_cache_thrash": "emb-cache-thrash",
}

# where the JAX package's Pallas gate (128-lane channel tiles, a 2048
# padded-width budget) and the port's K1 gate (channels in multiples of 8)
# answer differently: case -> Counter of (reference reason, port reason)
# over its conv2d ops
CONV_GATE_DIFFERENCES = {
    "conv_channel_miss": {("channels", None): 1},
    "conv_f32": {("dtype, then channels", "dtype"): 1},
    "resnet_o2": {("channels", None): 8},
}


def _key(d):
    return (d.severity, d.code, d.op_index, d.var)


def _conv_reasons(report, program):
    """op index -> the reason in this report's conv-gate warning (None:
    no warning) for every conv2d op of the program."""
    got = {i: None for i, op in enumerate(program.global_block().ops)
           if op.type == "conv2d"}
    for d in report.diagnostics:
        if d.code == "pallas-conv-fallback" and d.op_index is not None:
            got[d.op_index] = re.search(r"reason: ([^)]*)", d.message).group(1)
    return got


def _gate_reasons(program, gate, dtype_of):
    """op index -> the gate's answer for every conv2d of the program, asked
    as the preflight asks it (NHWC input at batch 8, bf16 under AMP)."""
    out = {}
    block = program.global_block()
    for i, op in enumerate(block.ops):
        if op.type != "conv2d":
            continue
        n, c, h, w = (8 if d == -1 else d
                      for d in block.desc.var(op.input("Input")[0]).shape)
        wshape = block.desc.var(op.input("Filter")[0]).shape
        dt = dtype_of(getattr(program, "_amp_dtype", None) is not None)
        args = (list(op.attr("strides")), list(op.attr("paddings")),
                list(op.attr("dilations")), int(op.attr("groups") or 1))
        r = gate((n, h, w, c), wshape, dt, args)
        if r == "dtype":
            deeper = gate((n, h, w, c), wshape, dtype_of(True), args)
            r = r if deeper is None else f"dtype, then {deeper}"
        out[i] = r
    return out


def _port_gate(xs, ws, dt, args):
    import torch
    from paddle_tpu_torch.ops import conv_cuda
    return conv_cuda.ineligible(torch.empty(xs, dtype=dt, device="meta"),
                                torch.empty(ws, dtype=dt, device="meta"),
                                *args)


def _jax_gate(xs, ws, dt, args):
    import jax
    from paddle_tpu.ops import pallas_conv
    return pallas_conv.ineligible(jax.ShapeDtypeStruct(xs, dt),
                                  jax.ShapeDtypeStruct(tuple(ws), dt), *args)


def _port_dtype(bf16):
    import torch
    return torch.bfloat16 if bf16 else torch.float32


def _jax_dtype(bf16):
    import jax.numpy as jnp
    return jnp.bfloat16 if bf16 else jnp.float32


@pytest.mark.parametrize("name", sorted(CASES))
def test_diagnostics_match_the_reference(name):
    build = CASES[name]
    main, feeds, fetches = build(pt)
    jmain, jfeeds, jfetches = build(jfluid)
    mine = analyze_program(main, feeds=feeds, fetches=fetches)
    ref = janalyze(jmain, feeds=jfeeds, fetches=jfetches)
    skip = ("pallas-conv-fallback", "layout-barrier")
    assert [_key(d) for d in mine.diagnostics if d.code not in skip] == \
        [_key(d) for d in ref.diagnostics if d.code not in skip], \
        mine.format() + "\n--- reference:\n" + ref.format()
    assert not any(d.code == "analyzer-internal" for d in mine.diagnostics)
    if name in EXPECT:
        assert any(d.code == EXPECT[name] for d in mine.diagnostics)
    # the conv-gate warnings: each package's says its own gate's reason
    # (rolled-up tails aside), and the gates differ only as listed
    port_gate = _gate_reasons(main, _port_gate, _port_dtype)
    jax_gate = _gate_reasons(jmain, _jax_gate, _jax_dtype)
    for report, gate in ((mine, port_gate), (ref, jax_gate)):
        said = _conv_reasons(report, main)
        rolled = sum(int(re.match(r"(\d+)", d.message).group(1))
                     for d in report.diagnostics
                     if d.code == "pallas-conv-fallback"
                     and d.op_index is None)
        mism = [i for i in gate if said[i] != gate[i]]
        assert len(mism) == rolled and all(said[i] is None for i in mism)
    diffs = collections.Counter((jax_gate[i], port_gate[i])
                                for i in port_gate
                                if jax_gate[i] != port_gate[i])
    assert dict(diffs) == CONV_GATE_DIFFERENCES.get(name, {})


def test_quant_preflight_names_the_shallow_matmul():
    main, feeds, fetches = case_quant_shallow_matmul(pt)
    report = analyze_program(main, feeds=feeds, fetches=fetches)
    warns = [d for d in report.diagnostics if d.code == "quant-fallback"]
    assert len(warns) == 1 and "reason: shape" in warns[0].message
    assert "K=24" in warns[0].hint and not report.errors


def test_quant_preflight_agrees_with_the_lowerings():
    """Under O3 the preflight names each conv, mul and matmul that the
    lowerings then count as a quant fallback, with the same reason, and
    no other: convs of 3, 128 and 40 channels, shallow and deep fc
    layers, and matmuls whose transposes make K deep or shallow."""
    from paddle_tpu_torch import quant
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        img = pt.layers.data(name="img", shape=[3, 8, 8])
        h = pt.layers.conv2d(input=img, num_filters=128, filter_size=3,
                             padding=1)
        h = pt.layers.conv2d(input=h, num_filters=128, filter_size=3,
                             padding=1)
        h = pt.layers.conv2d(input=h, num_filters=40, filter_size=1)
        f = pt.layers.fc(input=h, size=24)
        f = pt.layers.fc(input=f, size=64)
        w = pt.layers.create_parameter([48, 64], "float32")
        g = pt.layers.matmul(f, w, transpose_y=True)
        a = pt.layers.create_parameter([16, 64], "float32")
        b = pt.layers.create_parameter([16, 8], "float32")
        g2 = pt.layers.matmul(a, b, transpose_x=True)
    pt.amp.enable(main, level="O3")
    report = analyze_program(main, feeds=["img"], fetches=[g.name, g2.name])
    said = collections.Counter(
        (main.global_block().ops[d.op_index].type,
         d.message.split("reason: ")[1].split(")")[0])
        for d in report.diagnostics if d.code == "quant-fallback")
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    quant.COUNTERS.reset()
    exe.run(main, feed={"img": np.ones((2, 3, 8, 8), np.float32)},
            fetch_list=[g, g2], scope=scope)
    assert said == collections.Counter(quant.COUNTERS.fallbacks)
    assert set(said) == {("conv2d", "kernel"), ("mul", "shape"),
                         ("matmul", "shape")}
    assert set(quant.COUNTERS.hits) == {"conv2d", "mul", "matmul"}


def test_rank_mismatch_cites_the_creation_site():
    main, feeds, fetches = case_rank_mismatch(pt)
    d = analyze_program(main, feeds=feeds, fetches=fetches).errors[0]
    assert d.op_type == "mul" and "test_torch_analysis.py" in d.site


def _captured_clone(program):
    """The reference's shapes pass works on `program.clone()`: keep it."""
    got = []
    orig = program.clone

    def clone(*a, **k):
        c = orig(*a, **k)
        got.append(c)
        return c
    program.clone = clone
    return got


@pytest.mark.parametrize("build", [
    lambda fl: _resnet_full(fl),
    # bench.py's LM: T 2048, 4 layers, d_model 512, 8 heads, vocab 8192
    lambda fl: _lm(fl, n_layer=4, seqlen=2048, vocab=8192, d_model=512,
                   n_head=8)],
    ids=["resnet50_o2", "lm_o2"])
def test_infer_shapes_match_the_reference(build):
    main, feeds, fetches = build(pt)
    jmain, _, _ = build(jfluid)
    got = _captured_clone(jmain)
    janalyze(jmain, feeds=feeds, fetches=fetches)
    ref = got[0].global_block().desc.vars
    mine = infer.infer_block(main).global_block().desc.vars
    assert set(mine) == set(ref)
    assert len(mine) > 100
    diff = {n: ((list(v.shape) if v.shape is not None else None, v.dtype),
                (list(ref[n].shape) if ref[n].shape is not None else None,
                 ref[n].dtype))
            for n, v in mine.items()
            if (v.shape, v.dtype) != (ref[n].shape, ref[n].dtype)}
    assert not diff, list(diff.items())[:5]


def _resnet_full(fl):
    """ResNet-50 O2's training program at ImageNet shapes (the smoke's)."""
    main, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        img = fl.layers.data(name="img", shape=[3, 224, 224], dtype="float32")
        label = fl.layers.data(name="label", shape=[1], dtype="int64")
        loss, _, _ = fl.models.build_image_classifier(
            fl.models.resnet50, img, label, class_dim=1000)
        opt = fl.amp.decorate(
            fl.optimizer.Momentum(learning_rate=0.0125, momentum=0.9),
            level="O2")
        opt.minimize(loss)
    return main, ["img", "label"], [loss.name]


def test_infer_meta_evaluates_a_long_tail_op():
    """An EVAL_SHAPE_OPS op (no closed-form rule) gets its output shape from
    its own lowering on meta tensors, the batch kept symbolic."""
    main = pt.Program()
    with pt.program_guard(main, pt.Program()):
        x = pt.layers.data(name="x", shape=[6])
        y = pt.layers.data(name="y", shape=[6])
        b = main.global_block()
        b.create_var(name="d", dtype="float32")
        b.create_var(name="sub", dtype="float32")
        b.desc.var("d").shape = None
        b.append_op(type="squared_l2_distance", inputs={"X": [x.name],
                                                         "Y": [y.name]},
                    outputs={"Out": ["d"], "sub_result": ["sub"]})
    assert infer.rule_kind("squared_l2_distance") == "eval"
    clone = infer.infer_block(main)
    assert clone.global_block().desc.var("d").shape == [-1, 1]
    assert clone.global_block().desc.var("sub").shape == [-1, 6]


def test_verify_hook_runs_a_clean_program(monkeypatch):
    monkeypatch.setattr(executor_mod, "_VERIFY", True)
    main, startup, loss = _fit_a_line(pt)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    out, = exe.run(main, feed={"x": np.ones((4, 13), np.float32),
                               "y": np.ones((4, 1), np.float32)},
                   fetch_list=[loss], scope=scope)
    assert np.isfinite(float(np.ravel(out)[0]))
    assert exe._verified_programs


def test_verify_hook_refuses_a_broken_program_before_its_first_op(
        monkeypatch):
    monkeypatch.setattr(executor_mod, "_VERIFY", True)
    main, startup, loss = _fit_a_line(pt)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    main.global_block().desc.var("x").shape = [-1]
    main._version += 1
    ran = []
    orig = exe._exec_op
    monkeypatch.setattr(exe, "_exec_op",
                        lambda ctx, op, env: ran.append(op.type) or
                        orig(ctx, op, env))
    with pytest.raises(errors.ProgramVerifyError) as ei:
        exe.run(main, feed={"x": np.ones((4,), np.float32),
                            "y": np.ones((4, 1), np.float32)},
                fetch_list=[loss], scope=scope)
    assert not ran and "rank-mismatch" in str(ei.value)
    assert ei.value.diagnostics[0].op_type == "mul"


def test_verify_is_off_by_default():
    assert executor_mod._VERIFY is False


def test_engine_refuses_a_broken_program_at_admission(monkeypatch):
    from paddle_tpu_torch import telemetry
    from paddle_tpu_torch.serving import ServingEngine
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[13])
        pred = pt.layers.fc(input=x, size=2)
    scope = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(startup, scope=scope)
    ok = ServingEngine(main, ["x"], [pred], place=pt.CPUPlace(), scope=scope,
                       buckets=(2,))
    assert ok.admission["error"] == 0 and ok.admission["seconds"] >= 0
    main.global_block().desc.var("x").shape = [-1]     # rank 1: mul refuses
    ran = []
    monkeypatch.setattr(executor_mod.Executor, "_exec_op",
                        lambda self, ctx, op, env: ran.append(op.type))
    runs = dict(telemetry.read_series("serving_bucket_runs_total"))
    with pytest.raises(errors.ProgramVerifyError) as ei:
        ServingEngine(main, ["x"], [pred], place=pt.CPUPlace(), scope=scope,
                      buckets=(2,))
    assert "serving admission" in str(ei.value)
    assert [d.code for d in ei.value.diagnostics] == ["rank-mismatch"]
    assert not ran
    assert dict(telemetry.read_series("serving_bucket_runs_total")) == runs
