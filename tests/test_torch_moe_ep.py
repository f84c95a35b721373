"""Expert parallelism in the port: moe_ffn under a mesh whose 'ep' axis
splits its expert weights W1 [E, D, F] and W2 [E, F, D] on dim 0
(`shard_parameter(main, w, ("ep", None, None))`), against the JAX
package's SPMD run of the same program (tests/test_moe.py's net,
tests/torch_parallel_nets.py `moe`) on as many host devices, three SGD
steps from the JAX startup's state, losses and whole state within rtol
2e-4 (tests/test_moe.py's):

  * form (a): tokens replicated over 'ep' (an 'ep'-only mesh, the JAX
    test's), on 2 and 4 ranks;
  * form (b): the batch split over 'ep' itself (shard_feed(x, ("ep",
    None))), on 2 and 4 ranks;
  * form (c): a (dp 2, ep 2) mesh, the batch over 'dp', the experts over
    'ep'.

Each rank holds E / |ep| experts' bytes and never all-gathers W1 or W2
(spmd.COUNTERS.gathers); the replicated state is bitwise equal across
ranks. The one-device op against tests/test_moe.py's numpy oracle, where
overflowed tokens pass through."""

import torch_threads  # noqa: F401  (the cores shared among xdist workers)
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as pt
from paddle_tpu import executor as jax_executor
from paddle_tpu.parallel import mesh as jax_mesh

import torch_group
import torch_parallel_nets as nets
from test_moe import moe_oracle

WORKER = Path(__file__).resolve().parent / "torch_parallel_worker.py"
TOL = dict(rtol=2e-4, atol=1e-6)
STEPS = 3
CASES = {
    2: {"a_ep2": dict(mesh=((2,), ("ep",))),
        "b_ep2": dict(mesh=((2,), ("ep",)), ep_batch=True)},
    4: {"a_ep4": dict(mesh=((4,), ("ep",))),
        "b_ep4": dict(mesh=((4,), ("ep",)), ep_batch=True),
        "c_dp2_ep2": dict(mesh=((2, 2), ("dp", "ep")))},
}
ALL = [(w, n) for w in sorted(CASES) for n in CASES[w]]


@pytest.fixture(autouse=True)
def _keep_jax_op_census():
    before = set(jax_executor._RECORDED_OPS)
    yield
    jax_executor._RECORDED_OPS.intersection_update(before)


def _jax_run(case):
    main, startup, loss = nets.moe(jfluid, case)
    main._mesh = jax_mesh.make_mesh(*case["mesh"])
    nets.shard(jfluid, main, case)
    scope = jax_executor.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(startup, scope=scope)
    init = {n: np.asarray(scope.find_var(n))
            for n, v in startup.global_block().desc.vars.items()
            if v.persistable and scope.find_var(n) is not None}
    losses = [float(np.ravel(exe.run(main, feed=f, fetch_list=[loss],
                                     scope=scope)[0])[0])
              for f in case["feeds"]]
    return init, losses, {n: np.asarray(scope.find_var(n)) for n in init}


_GROUPS = {}


def _group(world, tmp_path_factory):
    if world not in _GROUPS:
        jax_res, cases = {}, []
        for name, spec in CASES[world].items():
            case = dict(spec, name=name, net="moe", shard="ep",
                        feeds=nets.feeds("moe", STEPS, seed=len(name)))
            init, losses, state = _jax_run(case)
            case["init"] = init
            jax_res[name] = (losses, state)
            cases.append(case)
        ranks, _ = torch_group.launch(WORKER, world, cases,
                                      tmp_path_factory.mktemp(f"ep{world}"),
                                      timeout=150)
        _GROUPS[world] = (jax_res, ranks)
    return _GROUPS[world]


@pytest.mark.parametrize("world,name", ALL, ids=[f"P{w}-{n}" for w, n in ALL])
def test_expert_parallel_matches_jax_spmd(world, name, tmp_path_factory):
    jax_res, ranks = _group(world, tmp_path_factory)
    want_losses, want_state = jax_res[name]
    for r, res in enumerate(ranks):
        got = res[name]
        np.testing.assert_allclose(got["losses"], want_losses, **TOL,
                                   err_msg=f"rank {r} losses")
        for n, w in want_state.items():
            np.testing.assert_allclose(got["state"][n], w, **TOL,
                                       err_msg=f"rank {r} {name}: {n}")


@pytest.mark.parametrize("world,name", ALL, ids=[f"P{w}-{n}" for w, n in ALL])
def test_each_rank_holds_its_experts_only(world, name, tmp_path_factory):
    """E / |ep| experts' bytes of W1 and W2 on each rank, no all-gather of
    them (nor of anything else), the rest bitwise equal across ranks."""
    _, ranks = _group(world, tmp_path_factory)
    mesh_shape, axes = CASES[world][name]["mesh"]
    ep = mesh_shape[axes.index("ep")]
    c = nets.MOE
    full = c["experts"] * c["dim"] * c["hidden"] * 4
    for res in ranks:
        got = res[name]
        assert got["gathers"] == 0, got
        experts = {n: b for n, b in got["nbytes"].items()
                   if got["state"][n].ndim == 3}
        assert len(experts) == 2 and all(b == full // ep
                                         for b in experts.values()), experts
    first = ranks[0][name]
    for res in ranks[1:]:
        for n, d in first["digest"].items():
            if first["state"][n].ndim != 3:
                assert res[name]["digest"][n] == d, n


def test_one_device_matches_numpy_oracle():
    """tests/test_moe.py's oracle: 16 tokens, 4 experts (capacity 5),
    overflow passing through."""
    rng = np.random.RandomState(5)
    n, d, e, f = 16, 8, 4, 12
    x = rng.randn(n, d).astype("float32")
    gw = rng.randn(d, e).astype("float32")
    w1 = (rng.randn(e, d, f) * 0.3).astype("float32")
    w2 = (rng.randn(e, f, d) * 0.3).astype("float32")
    want = moe_oracle(x, gw, w1, w2, 1.25)
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        xv = pt.layers.data(name="x", shape=[n, d], dtype="float32",
                            append_batch_size=False)
        blk = main.global_block()
        for nm, arr in (("gw", gw), ("w1", w1), ("w2", w2)):
            blk.create_var(name=nm, shape=list(arr.shape), dtype="float32",
                           persistable=True)
        out = blk.create_var(name="moe_out", dtype="float32")
        blk.append_op(type="moe_ffn", inputs={"X": [xv], "GateW": ["gw"],
                                              "W1": ["w1"], "W2": ["w2"]},
                      outputs={"Out": [out]},
                      attrs={"capacity_factor": 1.25})
    scope = pt.Scope()
    for nm, arr in (("gw", gw), ("w1", w1), ("w2", w2)):
        scope.set_var(nm, torch.from_numpy(arr))
    got, = pt.Executor(pt.CPUPlace()).run(main, feed={"x": x},
                                          fetch_list=[out], scope=scope)
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-4, atol=1e-5)
