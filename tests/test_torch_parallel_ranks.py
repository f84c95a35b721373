"""The port's sharded runs on gloo groups of 2 and 4 CPU processes against
the JAX package's SPMD runs of the same programs on as many host devices
(tests/conftest.py's 8-device CPU platform).

One group per world size for the whole file (tests/torch_group.py: fresh
interpreters running tests/torch_parallel_worker.py, which imports torch
and the port, never jax; a hard timeout for the group, every process
killed after). The programs are tests/torch_parallel_nets.py's, built by
each package from the same script; the port's ranks start from the JAX
startup's state and take three Momentum steps on the same global batches:

  * the MLP and the conv net (synchronized batch-norm statistics,
    accuracy) transpiled over 'dp';
  * shard_all_params_zero over 'dp';
  * column- and row-parallel `mul` over a (dp 2, mp 2) mesh;
  * a small transformer LM planned over (fsdp 2, tp 2) and (dp 2, tp 2);
  * a table row-sharded over 'dp', its SelectedRows gradient applied per
    rank, and densified (PADDLE_TPU_SPARSE_APPLY=0);
  * the MLP checkpointed on 2 ranks after two steps and resumed;
  * a global batch that does not divide over the ranks, and an op that
    reduces the batch with no rule for it, each raising by name.

Each case's losses and whole state (shards gathered) within f32 tolerance
(rtol 1e-5, atol 1e-6) of the JAX run, the replicated state bitwise equal
across ranks, and each rank holding its shards' bytes."""

import torch_threads  # noqa: F401  (the cores shared among xdist workers)
from pathlib import Path

import numpy as np
import pytest

import jax

import paddle_tpu as jfluid
from paddle_tpu import executor as jax_executor
from paddle_tpu.parallel import mesh as jax_mesh

import torch_group
import torch_parallel_nets as nets

WORKER = Path(__file__).resolve().parent / "torch_parallel_worker.py"
TOL = dict(rtol=1e-5, atol=1e-6)
STEPS = 3
GROUP_TIMEOUT = 150

CASES = {
    2: {"dp_mlp": dict(net="mlp", mesh=((2,), ("dp",))),
        "dp_conv": dict(net="conv", mesh=((2,), ("dp",))),
        "zero": dict(net="mlp", mesh=((2,), ("dp",)), shard="zero"),
        "table_sparse": dict(net="table", mesh=((2,), ("dp",)),
                             shard="table"),
        "table_dense": dict(net="table", mesh=((2,), ("dp",)),
                            shard="table",
                            env={"PADDLE_TPU_SPARSE_APPLY": "0"}),
        "checkpoint": dict(net="mlp", mesh=((2,), ("dp",)), ckpt=2)},
    4: {"tp_col": dict(net="mlp", mesh=((2, 2), ("dp", "mp")), shard="fc"),
        "tp_row": dict(net="mlp", mesh=((2, 2), ("dp", "mp")),
                       shard="row"),
        "lm_fsdp_tp": dict(net="lm", mesh=((2, 2), ("fsdp", "tp")),
                           shard="plan"),
        "lm_dp_tp": dict(net="lm", mesh=((2, 2), ("dp", "tp")),
                         shard="plan")},
}
# cases each rank runs expecting an error: (net, feed rows) -> the
# error's type and a phrase of its message
ERRORS = {"not_divisible": ("mlp", 7, "ValueError", "does not split"),
          "unruled": ("unruled", 8, "NotImplementedError", "'l1_norm'")}
ALL = [(w, n) for w in sorted(CASES) for n in CASES[w]]


@pytest.fixture(autouse=True)
def _keep_jax_op_census():
    """The JAX executor's op census gets back the types it had (as
    tests/test_torch_backward.py): the JAX runs here are an oracle."""
    before = set(jax_executor._RECORDED_OPS)
    yield
    jax_executor._RECORDED_OPS.intersection_update(before)


def _jax_run(case):
    """The JAX package's SPMD run of the case: (initial state, losses,
    final state, the plan's dict or None)."""
    import os
    saved = {k: os.environ.get(k) for k in case.get("env", {})}
    os.environ.update(case.get("env", {}))
    try:
        main, startup, loss = nets.BUILDERS[case["net"]](jfluid, case)
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
        state = {n: np.asarray(scope.find_var(n)) for n in init}
        plan = getattr(main, "_sharding_plan", None)
        return init, losses, state, None if plan is None else plan.to_dict()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


_GROUPS = {}


def _group(world, tmp_path_factory):
    """(JAX results by case, every rank's results) of world's cases, run
    once per world size."""
    if world not in _GROUPS:
        jax_res, cases = {}, []
        ckpt = tmp_path_factory.mktemp(f"ckpt{world}")
        for name, spec in CASES[world].items():
            case = dict(spec, name=name,
                        feeds=nets.feeds(spec["net"], STEPS, seed=len(name)))
            if "ckpt" in case:
                case["ckpt_dir"] = str(ckpt)
            init, losses, state, plan = _jax_run(case)
            case["init"] = init
            jax_res[name] = (losses, state, plan)
            cases.append(case)
        if world == 2:
            for name, (net, rows, _, _) in ERRORS.items():
                f = nets.feeds(net, 1)[0]
                cases.append(dict(
                    name=name, net=net, mesh=((2,), ("dp",)),
                    expect_error=True, init={},
                    feeds=[{k: v[:rows] for k, v in f.items()}]))
        ranks, _ = torch_group.launch(WORKER, world, cases,
                                      tmp_path_factory.mktemp(f"W{world}"),
                                      timeout=GROUP_TIMEOUT)
        _GROUPS[world] = (jax_res, ranks)
    return _GROUPS[world]


@pytest.mark.parametrize("world,name", ALL,
                         ids=[f"P{w}-{n}" for w, n in ALL])
def test_sharded_run_matches_jax_spmd(world, name, tmp_path_factory):
    assert len(jax.devices()) >= world
    (jax_res, ranks) = _group(world, tmp_path_factory)
    want_losses, want_state, want_plan = jax_res[name]
    for r, res in enumerate(ranks):
        got = res[name]
        np.testing.assert_allclose(got["losses"], want_losses, **TOL,
                                   err_msg=f"rank {r} losses")
        assert set(got["state"]) == set(want_state)
        for n, w in want_state.items():
            np.testing.assert_allclose(got["state"][n], w, **TOL,
                                       err_msg=f"rank {r} {name}: {n}")
    if want_plan is not None:
        got_plan = ranks[0][name]["plan"]
        assert got_plan["roles"] == want_plan["roles"]
        assert {n: [list(e) if isinstance(e, (list, tuple)) else e
                    for e in s] for n, s in got_plan["specs"].items()} == \
            {n: [list(e) if isinstance(e, (list, tuple)) else e
                 for e in s] for n, s in want_plan["specs"].items()}
        assert ranks[0][name]["validate"]


@pytest.mark.parametrize("world,name", ALL,
                         ids=[f"P{w}-{n}" for w, n in ALL])
def test_replicated_state_bitwise_and_shards_held(world, name,
                                                  tmp_path_factory):
    """Every tensor a rank holds whole is bitwise the same on every rank;
    a sharded one is the shard's bytes (its whole bytes over the factor),
    as per_shard_param_bytes counts it."""
    _, ranks = _group(world, tmp_path_factory)
    first = ranks[0][name]
    for res in ranks[1:]:
        got = res[name]
        for n, d in first["digest"].items():
            if first["nbytes"][n] == got["nbytes"][n] and \
                    first["state"][n].nbytes == first["nbytes"][n]:
                assert got["digest"][n] == d, f"{name}: {n} differs"
    for res in ranks:
        got = res[name]
        for n, b in got["per_shard"].items():
            assert got["nbytes"][n] == b, (name, n)


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_sharded_run_raises_by_name(name, tmp_path_factory):
    """A batch of 7 rows over 2 ranks, and l1_norm of a split batch (no
    all-reduce rule), fail on every rank with the reason, never running
    on rank-local values."""
    _, ranks = _group(2, tmp_path_factory)
    _, _, kind, phrase = ERRORS[name]
    for res in ranks:
        err = res[name]["error"]
        assert err is not None and err.startswith(kind) and phrase in err, \
            err
