"""The numeric-health plane on the card:

  * T1 (ops/stats_cuda.py, Triton) against its plain version over shapes
    (one element to 2^24 + 5, ragged against the block) and dtypes (f32,
    bf16, fp16), with NaN, +-Inf, all non-finite and values whose squares
    overflow f32: min, max and the counts exact; mean, abs-mean and l2
    within rtol 1e-5 (T1's f32 partial sums against the plain version's
    f64), mean's error bounded by 1e-5 x abs-mean; inside a captured CUDA
    graph too, bitwise its eager call; refused dtypes raise.
  * The graphed step's finiteness flag: finite_flag is False for one NaN
    or one Inf among many tensors of three dtypes and True for finite
    values whose squares overflow; a graphed MLP under check_nan_inf with
    a poisoned weight raises NonFiniteError with the first reader
    attributed, the scope (its sparse table updated in place included)
    bitwise as before, the rng counter kept.
  * Dynamics on a graphed MLP at period 2: a sampled and a plain graph
    for the signature, the rows equal group_rows on the step's copies.

This file imports no JAX: run it on the card without the suite's
conftest,

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_observe_gpu.py
"""

import torch_threads  # noqa: F401  (the cores shared among xdist workers)
import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import dynamics, errors, flags, inspector, telemetry
from paddle_tpu_torch import executor as E
from paddle_tpu_torch.ops import stats_cuda

pytestmark = pytest.mark.gpu

RTOL = 1e-5


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    telemetry.reset()
    dynamics.reset()
    yield torch.device("cuda", 0)
    flags.set("check_nan_inf", None)
    dynamics.reset()


def _hold(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    exact = [0, 1, 5, 6, 7]
    assert torch.equal(got[exact], want[exact]), (got, want)
    tol = RTOL * torch.stack([want[3], want[3], want[4]]).abs() + 1e-30
    close = (got[2:5] == want[2:5]) | ((got[2:5] - want[2:5]).abs() <= tol)
    assert bool(close.all()), (got, want)


def _tensor(n, dtype, case, device):
    g = torch.Generator(device="cpu").manual_seed(n)
    x = torch.randn(n, generator=g) * 3 + 0.25
    if case == "nonfinite" and n > 3:
        x[1] = float("nan")
        x[n // 2] = float("inf")
        x[-1] = float("-inf")
    elif case == "all_nan":
        x[:] = float("nan")
    elif case == "huge":
        x = x * (6e4 if dtype == torch.float16 else 1e30)
    return x.to(dtype).to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("n", [1, 3, 1023, 1025, 262_147, 16_777_221])
@pytest.mark.parametrize("case", ["finite", "nonfinite", "all_nan", "huge"])
def test_t1_matches_its_plain_version(device, dtype, n, case):
    x = _tensor(n, dtype, case, device)
    before = stats_cuda.COUNTERS.launches
    got = stats_cuda.tensor_stats(x)
    assert stats_cuda.COUNTERS.launches == before + 1
    _hold(got, stats_cuda.tensor_stats_reference(x))
    assert torch.equal(got, stats_cuda.tensor_stats(x))     # no atomics


def test_t1_on_a_strided_view_and_in_a_graph(device):
    x = torch.randn(64, 300, device=device)[:, ::3]
    _hold(stats_cuda.tensor_stats(x), stats_cuda.tensor_stats_reference(x))
    y = torch.randn(4096, 33, device=device, dtype=torch.bfloat16)
    eager = stats_cuda.tensor_stats(y)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        stats_cuda.tensor_stats(y)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = stats_cuda.tensor_stats(y)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


def test_t1_refuses_what_its_gate_refuses(device):
    for bad in (torch.zeros(5, device=device, dtype=torch.float64),
                torch.zeros(5, device=device, dtype=torch.int32),
                torch.zeros(0, device=device)):
        with pytest.raises(ValueError):
            stats_cuda.tensor_stats(bad)
    # the op's lowering routes them: f64 to the plain version, counted
    stats_cuda.COUNTERS.reset()
    out = inspector._tensor_stats_lower(
        None, None, {"X": [torch.ones(4, device=device,
                                      dtype=torch.float64)]})["Out"][0]
    assert out[7] == 4 and stats_cuda.COUNTERS.fallbacks == {"float64": 1}
    out = inspector._tensor_stats_lower(
        None, None, {"X": [torch.arange(5, device=device)]})["Out"][0]
    assert out[1] == 4 and stats_cuda.COUNTERS.launches == 1


def test_finite_flag(device):
    ts = [torch.randn(1000, device=device),
          torch.randn(33, 7, device=device).bfloat16(),
          torch.randn(5, device=device).half(),
          torch.arange(4, device=device)]
    assert bool(E.finite_flag(ts))
    big = [torch.full((100,), 3e38, device=device)]     # squares overflow
    assert bool(E.finite_flag(big))
    for i, bad in ((0, float("nan")), (1, float("inf")), (2, float("-inf"))):
        t = [x.clone() for x in ts]
        t[i].view(-1)[3] = bad
        assert not bool(E.finite_flag(t)), (i, bad)


def _mlp(sparse=False):
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        y = pt.layers.data(name="y", shape=[1], dtype="float32")
        if sparse:
            ids = pt.layers.data(name="ids", shape=[1], dtype="int64")
            h = pt.layers.embedding(ids, size=[1000, 16], is_sparse=True)
        else:
            h = pt.layers.data(name="x", shape=[16], dtype="float32")
        h = pt.layers.fc(input=h, size=64, act="relu")
        pred = pt.layers.fc(input=h, size=1)
        loss = pt.layers.mean(pt.layers.square_error_cost(pred, y))
        pt.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main, startup, loss


def _feed(sparse, rng):
    f = {"y": rng.standard_normal((32, 1)).astype(np.float32)}
    if sparse:
        f["ids"] = rng.integers(0, 1000, (32, 1))
    else:
        f["x"] = rng.standard_normal((32, 16)).astype(np.float32)
    return f


@pytest.mark.parametrize("sparse", [False, True])
def test_graphed_check_nan_inf_restores_the_scope(device, sparse):
    main, startup, loss = _mlp(sparse)
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.default_rng(0)
    feed = _feed(sparse, rng)
    flags.set("check_nan_inf", True)
    for _ in range(3):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert E.COUNTERS.replays >= 2
    w = scope.find_var("fc_1.w_0").clone()
    w.view(-1)[0] = float("inf")
    scope.set_var("fc_1.w_0", w)
    before = {n: (v.clone() if isinstance(v, torch.Tensor) else v)
              for n, v in scope.vars.items()}
    tables = {n: v for n, v in scope.vars.items()
              if isinstance(v, torch.Tensor) and v.shape[:1] == (1000,)}
    with pytest.raises(errors.NonFiniteError) as ei:
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    att = ei.value.attribution
    first = next(i for i, op in enumerate(main.global_block().ops)
                 if "fc_1.w_0" in op.input_arg_names)
    assert att is not None and att.op_index == first
    for n, v in before.items():
        got = scope.vars[n]
        assert (torch.equal(v, got) if isinstance(v, torch.Tensor)
                else v == got), n
    for n, t in tables.items():
        assert scope.vars[n] is t       # restored in place
    # the signature's next graphed step starts from the restored state
    scope.set_var("fc_1.w_0", before["fc_1.w_0"].nan_to_num(posinf=0.0))
    out = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert np.isfinite(out[0]).all()


def test_dynamics_graphs_and_rows(device):
    main, startup, loss = _mlp()
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.default_rng(1)
    feed = _feed(False, rng)
    E.COUNTERS.reset()
    with dynamics.override(True, 2):
        plan = dynamics.plan(main)
        rows = []
        for _ in range(8):
            c = scope.find_var("__rng_counter__")
            old = {n: v.clone() for n, v in scope.vars.items()
                   if isinstance(v, torch.Tensor)}
            grads = [p.name + "@GRAD"
                     for p in main.global_block().all_parameters()]
            out = exe.run(main, feed=feed, fetch_list=[loss] + grads,
                          scope=scope, return_numpy=False)
            if c % 2 == 0:
                new = {n: scope.find_var(n)
                       for n in exe._persistable_outputs(main)}
                rows.append((c, dynamics.group_rows(
                    plan, old, new, dict(zip(grads, out[1:])))))
        payload = dynamics.payload(recent=8)
    keys = [k for k in exe._graphs if k[0] == id(main)]
    assert sorted(k[-2][2] for k in keys) == [False, True]
    assert E.COUNTERS.captures == 2
    series = payload["programs"][telemetry.program_label(main)]["series"]
    for c, want in rows:
        for gi, grp in enumerate(plan.groups):
            row = next(r for r in series[grp.name]["recent"]
                       if r["step"] == c)
            got = [-1.0 if row[f] is None else row[f]
                   for f in dynamics.STAT_FIELDS]
            np.testing.assert_allclose(got, want[gi].cpu().numpy(),
                                       rtol=1e-5, atol=1e-12)
