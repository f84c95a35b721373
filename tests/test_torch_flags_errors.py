"""The port's flags, typed errors and checkpoint converters against the JAX
package's (paddle_tpu/flags.py, errors.py, compat.py), on the CPU.

  * flags: the catalogue's names, defaults and types are the reference's,
    less `test_platform` and `xla_cache` (the JAX test suite's platform and
    XLA compilation cache, which mean nothing in the port); get / set /
    snapshot / dump behave the same over the same environment.
  * errors: every class keeps the reference's bases, fields and to_dict();
    the executor raises errors.EnforceNotMet itself.
  * compat: the LSTM/GRU converters bitwise equal to the reference's,
    round trips included.
"""

import torch_threads  # noqa: F401  (the cores shared among xdist workers)
import os

import numpy as np
import pytest

from paddle_tpu import compat as jcompat
from paddle_tpu import errors as jerrors
from paddle_tpu import flags as jflags
from paddle_tpu import memory as jmemory  # noqa: F401  (defines memory's flags)
from paddle_tpu_torch import compat, errors, flags
from paddle_tpu_torch import memory  # noqa: F401  (defines memory's flags)

JAX_ONLY_FLAGS = {"test_platform", "xla_cache"}


@pytest.fixture
def clean_env(monkeypatch):
    """Every PADDLE_TPU_<flag> unset, and after the test each back as it
    was before it, whatever the test wrote (setenv first, so that the undo
    also removes a variable that was unset)."""
    for name in set(jflags._REGISTRY) | set(flags._REGISTRY):
        env = f"PADDLE_TPU_{name.upper()}"
        monkeypatch.setenv(env, "")
        monkeypatch.delenv(env)
    yield monkeypatch


def test_catalogue_is_the_references_less_the_jax_test_settings():
    assert set(flags._REGISTRY) == set(jflags._REGISTRY) - JAX_ONLY_FLAGS
    for name, (default, t, _help) in flags._REGISTRY.items():
        jdefault, jt, _ = jflags._REGISTRY[name]
        assert (default, t) == (jdefault, jt), name


def test_dump_keys(clean_env):
    assert set(flags.dump()) == set(jflags.dump()) - JAX_ONLY_FLAGS
    for name, (value, _help) in flags.dump().items():
        assert value == jflags.dump()[name][0], name


@pytest.mark.parametrize("name,raw", [
    ("check_nan_inf", "1"), ("check_nan_inf", "true"), ("check_nan_inf", "0"),
    ("vlog", "3"), ("vlog", ""), ("max_loop_iters", "7"),
    ("record_ops", "/x/ops.txt"), ("hbm_budget_bytes", "1024"),
    ("memory_tracker", "0"), ("telemetry_fetch", "1")])
def test_get_parses_the_environment_as_the_reference(clean_env, name, raw):
    clean_env.setenv(f"PADDLE_TPU_{name.upper()}", raw)
    assert flags.get(name) == jflags.get(name)


@pytest.mark.parametrize("name,value", [
    ("check_nan_inf", True), ("check_nan_inf", False), ("check_nan_inf", 0),
    ("vlog", 2), ("max_loop_iters", "9"), ("step_log", "/tmp/s.jsonl"),
    ("hbm_budget_bytes", 4096)])
def test_set_writes_the_environment_as_the_reference(clean_env, name, value):
    env = f"PADDLE_TPU_{name.upper()}"
    got = flags.set(name, value)
    raw = os.environ[env]
    clean_env.delenv(env)
    want = jflags.set(name, value)
    assert (got, raw) == (want, os.environ[env])
    assert flags.set(name, None) == jflags.set(name, None)
    assert env not in os.environ


def test_snapshot_and_dump_annotate_a_change(clean_env):
    for mod in (flags, jflags):
        before = mod.snapshot("vlog")
        mod.set("vlog", 5)
        value, help_str = mod.dump()["vlog"]
        assert value == 5 and mod.snapshot("vlog") == before
        assert "env changed after import" in help_str
        mod.set("vlog", None)


class _Diag:
    """A stand-in analysis.Diagnostic: format() and to_dict()."""

    def __init__(self, code):
        self.code = code

    def format(self):
        return f"error: {self.code}"

    def to_dict(self):
        return {"severity": "error", "code": self.code}


def _pairs():
    """(port error, reference error) built alike, one per class."""
    d = [_Diag("rank-mismatch"), _Diag("use-before-def")]
    args = [
        ("EnforceNotMet", ("op failed",), {"op_type": "mul",
                                           "creation_site": "a.py:3"}),
        ("NonFiniteError", ("nan in x",), {"var_name": "x", "dtype": "float32",
                                           "op_type": "mul", "op_index": 3,
                                           "feed_signature": [("x", (2, 3))]}),
        ("OOMError", ("out of memory",), {
            "program": "p1", "breakdown": {"params": 10, "feeds": 2},
            "top_buffers": [{"nbytes": 8, "name": "w"}],
            "analysis": {"total_bytes": 12}, "suggestions": ["smaller"],
            "device": "cuda:0"}),
        ("ProgramVerifyError", (d,), {"program_name": "serving admission"}),
        ("ServingOverloadError", ("full",), {"reason": "queue_full",
                                             "queue_depth": 3}),
    ]
    for cls, a, kw in args:
        yield cls, getattr(errors, cls)(*a, **kw), getattr(jerrors, cls)(
            *a, **kw)


@pytest.mark.parametrize("cls,mine,ref", list(_pairs()),
                         ids=[p[0] for p in _pairs()])
def test_error_fields_and_to_dict(cls, mine, ref):
    assert [b.__name__ for b in type(mine).__mro__] == \
        [b.__name__ for b in type(ref).__mro__]
    fields = {k: v for k, v in vars(ref).items()}
    assert set(vars(mine)) == set(fields)
    if hasattr(ref, "to_dict"):
        a, b = mine.to_dict(), ref.to_dict()
        if cls == "ProgramVerifyError":
            # the hint at the end names each package's own entry point
            a.pop("message"), b.pop("message")
            assert str(mine).split("\n(")[0] == str(ref).split("\n(")[0]
        assert a == b


def test_not_found_and_eof():
    assert issubclass(errors.NotFoundError, KeyError)
    from paddle_tpu_torch.layers.io import EOFException
    assert errors.EOFException is EOFException
    with pytest.raises(AttributeError):
        errors.NoSuchError  # noqa: B018


def test_executor_raises_the_errors_enforce_not_met(monkeypatch):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import executor
    from paddle_tpu_torch.ops import registry
    assert executor.EnforceNotMet is errors.EnforceNotMet

    def broken(ctx, op_, ins):
        raise ValueError("planted")

    monkeypatch.setattr(registry.get("scale"), "lower", broken)
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[4])
        out = pt.layers.scale(x, scale=2.0)
    with pytest.raises(errors.EnforceNotMet) as ei:
        pt.Executor(pt.CPUPlace()).run(
            main, feed={"x": np.ones((2, 4), np.float32)}, fetch_list=[out],
            scope=pt.Scope())
    assert ei.value.op_type == "scale" and ei.value.creation_site
    assert "planted" in str(ei.value)


def _zero_grad_net(pt):
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[4], dtype="float32")
        y = pt.layers.data(name="y", shape=[1], dtype="float32")
        loss = pt.layers.mean(pt.layers.square_error_cost(
            pt.layers.fc(input=x, size=1), y))
    return loss


def test_allow_zero_grad_lets_append_backward_pass(clean_env):
    """A NO_GRAD op on the loss path raises in append_backward unless the
    allow_zero_grad flag is on, read when append_backward runs."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import registry
    clean_env.setattr(registry.get("square"), "grad", registry.NO_GRAD)
    with pytest.raises(RuntimeError, match="PADDLE_TPU_ALLOW_ZERO_GRAD=1"):
        pt.append_backward(_zero_grad_net(pt))
    try:
        flags.set("allow_zero_grad", True)
        assert pt.append_backward(_zero_grad_net(pt))
    finally:
        flags.set("allow_zero_grad", None)


def test_eager_flag_and_vlog_are_read(clean_env, capsys):
    """The eager flag as the process started (flags.snapshot) sends a run
    whose caller leaves use_jit unset down the eager path; vlog prints
    at or below the vlog flag's level, read at each call."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import executor
    assert executor._EAGER is flags.snapshot("eager")
    exe = pt.Executor(pt.CPUPlace())
    main = pt.Program()
    clean_env.setattr(executor, "_EAGER", True)
    assert exe.graph_gate(main, {}) == "use_jit"
    assert exe.graph_gate(main, {}, use_jit=True) == "cpu"
    clean_env.setattr(executor, "_EAGER", False)
    assert exe.graph_gate(main, {}) == "cpu"
    executor.vlog(1, "quiet")
    try:
        flags.set("vlog", 2)
        executor.vlog(2, "loud")
        executor.vlog(3, "too deep")
    finally:
        flags.set("vlog", None)
    err = capsys.readouterr().err
    assert "loud" in err and "paddle_tpu_torch]" in err
    assert "quiet" not in err and "too deep" not in err


def test_unread_flags_say_so():
    """No flag is left unread since the numeric-health plane came: none
    says in its help that nothing reads it, and the import-time ones say
    they are read at import."""
    for name in flags._REGISTRY:
        assert "not read yet" not in flags._REGISTRY[name][2], name
    for name in ("trap_fp", "benchmark", "record_ops", "step_log"):
        assert "read at import" in flags._REGISTRY[name][2], name


RNG = np.random.RandomState(3)


@pytest.mark.parametrize("shape,axis", [((16,), -1), ((5, 24), -1),
                                        ((24, 7), 0), ((3, 8, 12), 2)])
def test_lstm_converters_bitwise(shape, axis):
    w = RNG.randn(*shape).astype(np.float32)
    for f in ("convert_lstm_weight_from_reference",
              "convert_lstm_weight_to_reference"):
        got, want = getattr(compat, f)(w, axis), getattr(jcompat, f)(w, axis)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    back = compat.convert_lstm_weight_to_reference(
        compat.convert_lstm_weight_from_reference(w, axis), axis)
    assert np.array_equal(back, w)


@pytest.mark.parametrize("shape,axis", [((9,), -1), ((4, 12), -1),
                                        ((6, 5), 0)])
def test_gru_converter_bitwise_and_an_involution(shape, axis):
    w = RNG.randn(*shape).astype(np.float32)
    got = compat.convert_gru_weight_from_reference(w, axis)
    want = jcompat.convert_gru_weight_from_reference(w, axis)
    assert np.array_equal(got, want)
    assert np.array_equal(compat.convert_gru_weight_from_reference(got, axis),
                          w)
