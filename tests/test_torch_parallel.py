"""The port's parallel/ modules in one process against the JAX package's:
planner.plan's roles, specs, fallbacks and per-shard bytes on bench.py's
LM, ResNet-50 and DLRM over (fsdp 2, tp 2) and (dp 2, fsdp 2, tp 2)
meshes; overlap.plan's buckets (names, order, members) on the ResNet and
the LM transpiled over 'dp'; tensor_parallel.expected_collectives and
per_shard_param_bytes; the transpiler's facade; multihost's
shard_reader, CheckpointableReader and checkpoint helpers; a mesh's axis
indices and sub-group ranks. (The sharded runs themselves are
tests/test_torch_parallel_ranks.py's, on gloo groups.)"""

import torch_threads  # noqa: F401  (the cores shared among xdist workers)
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import executor as jax_executor
from paddle_tpu.parallel import mesh as jax_mesh
from paddle_tpu.parallel import overlap as jax_overlap
import paddle_tpu_torch as pt
from paddle_tpu_torch import telemetry as ptelemetry
from paddle_tpu_torch.parallel import mesh as pmesh
from paddle_tpu_torch.parallel import overlap as poverlap

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402
import torch_parallel_nets as nets  # noqa: E402

MESHES = {"fsdp_tp": ((2, 2), ("fsdp", "tp")),
          "dp_fsdp_tp": ((2, 2, 2), ("dp", "fsdp", "tp")),
          "dp": ((2,), ("dp",))}


def _port_mesh(shape, axes):
    """A mesh of the given shape with no process group: what the planners
    read of it (axis names and sizes)."""
    return pmesh.Mesh(tuple(axes), tuple(shape), None, 0,
                      torch.device("cpu"))


def _lm_net(fluid):
    c = chip_smoke.LM
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        tok = fluid.layers.data(name="tok", shape=[-1, c["seqlen"]],
                                dtype="int64", append_batch_size=False)
        lab = fluid.layers.data(name="lab", shape=[-1, c["seqlen"]],
                                dtype="int64", append_batch_size=False)
        loss = fluid.models.transformer_lm(
            tok, lab, vocab_size=c["vocab"], d_model=c["d_model"],
            n_head=c["n_head"], n_layer=c["n_layer"])
        fluid.amp.decorate(fluid.optimizer.Adam(learning_rate=c["lr"]),
                           level="O2").minimize(loss)
    return main


def _resnet(fluid):
    return chip_smoke._resnet50_train(fluid, fluid.models.resnet)[0]


def _dlrm(fluid):
    return chip_smoke._dlrm_train(fluid, chip_smoke.DLRM["rows"],
                                  sharded=False)[0]


NETS = {"lm": _lm_net, "resnet50": _resnet, "dlrm": _dlrm}


@pytest.mark.parametrize("mesh", ["fsdp_tp", "dp_fsdp_tp"])
@pytest.mark.parametrize("net", sorted(NETS))
def test_plan_equals_the_jax_planners(net, mesh):
    """Roles, specs, feed specs, per-shard bytes and the degradation notes
    of planner.plan on the same program, the same mesh shape."""
    shape, axes = MESHES[mesh]
    jmain, pmain = NETS[net](jfluid), NETS[net](pt)
    jp = jfluid.parallel.planner.plan(jmain, jax_mesh.make_mesh(shape, axes))
    pp = pt.parallel.planner.plan(pmain, _port_mesh(shape, axes))
    assert pp.to_dict() == jp.to_dict()
    assert pp.feed_specs == jp.feed_specs
    assert {n: p.notes for n, p in pp.params.items()} == \
        {n: p.notes for n, p in jp.params.items()}
    assert pmain._param_shardings == jmain._param_shardings
    assert getattr(pmain, "_sharded_tables", {}) == \
        getattr(jmain, "_sharded_tables", {})
    assert pt.parallel.tensor_parallel.expected_collectives(pmain) == \
        jfluid.parallel.tensor_parallel.expected_collectives(jmain)


@pytest.mark.parametrize("net", ["resnet50", "lm"])
@pytest.mark.parametrize("cap_mb", ["4", "0.25"])
def test_overlap_buckets_equal_the_jax_plans(net, cap_mb, monkeypatch):
    """Buckets of the program transpiled over 'dp' (and, for the LM,
    planned over (dp, fsdp, tp)): sites, anchors, dtypes, bytes, members
    in order."""
    monkeypatch.setenv("PADDLE_TPU_OVERLAP_BUCKET_MB", cap_mb)
    jmain, pmain = NETS[net](jfluid), NETS[net](pt)
    jmain._mesh = jax_mesh.make_mesh((2,), ("dp",))
    pmain._mesh = _port_mesh((2,), ("dp",))
    if net == "lm":
        shape, axes = MESHES["dp_fsdp_tp"]
        jfluid.parallel.planner.plan(jmain, jax_mesh.make_mesh(shape, axes))
        pt.parallel.planner.plan(pmain, _port_mesh(shape, axes))
    jb, pb = jax_overlap.plan(jmain), poverlap.plan(pmain)
    assert jb is not None and pb is not None
    key = lambda b: (b.site, b.params, b.grads, b.dtype, b.bytes,  # noqa
                     b.anchor, b.spec)
    assert [key(b) for b in pb.buckets] == [key(b) for b in jb.buckets]
    assert len(pb.buckets) >= 2


def test_per_shard_param_bytes_match_the_jax_packages():
    """On the planned LM with whole tensors in each scope: the same
    per-parameter accounting, and validate_plan_bytes passing."""
    shape, axes = MESHES["fsdp_tp"]
    small = dict(nets.LM)

    def build(fluid):
        return nets.lm(fluid, small)
    (jmain, jstart, _), (pmain, pstart, _) = build(jfluid), build(pt)
    jfluid.parallel.planner.plan(jmain, jax_mesh.make_mesh(shape, axes))
    pt.parallel.planner.plan(pmain, _port_mesh(shape, axes))
    js, ps = jax_executor.Scope(), pt.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(jstart, scope=js)
    pt.Executor(pt.CPUPlace()).run(pstart, scope=ps)
    want = jfluid.parallel.per_shard_param_bytes(jmain, js)
    got = pt.parallel.per_shard_param_bytes(pmain, ps)
    assert got == want
    assert pt.parallel.validate_plan_bytes(pmain, ps)


def test_planner_mesh_from_env_and_fallbacks(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_MESH", "")
    m = pt.parallel.mesh_from_env()
    assert m.axis_names == ("dp",) and m.shape == (1,)
    monkeypatch.setenv("PADDLE_TPU_MESH", "dp=2,tp=1")
    with pytest.raises(ValueError, match="needs 2 ranks"):
        pt.parallel.mesh_from_env()
    monkeypatch.setenv("PADDLE_TPU_MESH", "dp=x")
    with pytest.raises(ValueError, match="axis=<int>"):
        pt.parallel.mesh_from_env()
    # a dim a mesh axis does not divide degrades, counted
    main = _resnet(pt)
    p = pt.parallel.planner.plan(main, _port_mesh((3,), ("fsdp",)))
    notes = [n for pp in p.params.values() for n in pp.notes]
    assert notes and "dropped axis 'fsdp'" in notes[0]
    series = ptelemetry.read_series("planner_fallback_total")
    assert any("indivisible" in str(k) for k in series)


def test_mesh_axis_indices_and_subgroups():
    """Row-major coordinates, and the ranks of each axis tuple's sub-group
    in the order the collectives count them."""
    m = pmesh.Mesh(("dp", "fsdp", "tp"), (2, 2, 2), None, 5,
                   torch.device("cpu"))
    assert [m.axis_index(a) for a in ("dp", "fsdp", "tp")] == [1, 0, 1]
    assert m.axis_index(("dp", "fsdp")) == 2
    assert m.axis_size(("fsdp", "tp")) == 4
    assert pmesh._ranks_over(m, ("tp",)) == (4, 5)
    assert pmesh._ranks_over(m, ("dp", "fsdp")) == (1, 3, 5, 7)
    assert pmesh._ranks_over(m, ("fsdp", "dp")) == (1, 5, 3, 7)
    one = pt.parallel.make_mesh((1,), ("dp",))
    assert one.group is None and one.group_of("dp") == (None, (0,))
    assert pt.parallel.batch_sharding(one, 3).spec == ("dp", None, None)
    assert pt.parallel.data_parallel_mesh().shape == (1,)


def test_transpiler_facade():
    main, startup, loss = nets.mlp(pt, {})
    t = pt.DistributeTranspiler()
    t.transpile(trainer_id=0, program=main, trainers=1)
    assert main._mesh.axis_names == ("dp",) and t.get_trainer_program() \
        is main
    with pytest.raises(RuntimeError):
        t.get_pserver_program("127.0.0.1:6174")
    with pytest.raises(RuntimeError):
        t.get_startup_program("127.0.0.1:6174")
    assert pt.memory_optimize(main) is main and \
        pt.release_memory(main) is main
    # a one-rank mesh runs the one-device path, as before the transpile
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    f = nets.feeds("mlp", 1)[0]
    lv, = exe.run(main, feed=f, fetch_list=[loss], scope=scope)
    assert np.isfinite(lv).all()


def test_overlap_compiler_options_and_steps_per_call():
    main, _, _ = nets.mlp(pt, {})
    assert poverlap.compiler_options(main) is None
    main._mesh = _port_mesh((2,), ("dp",))
    assert poverlap.compiler_options(main) is None
    assert poverlap.choose_steps_per_call(2.0, 10.0) == 10
    assert poverlap.choose_steps_per_call() == 64
    assert poverlap.choose_steps_per_call(2.0, 10.0) == \
        jax_overlap.choose_steps_per_call(2.0, 10.0)
    # the memory bound (memory.HeadroomModel over the feed window)
    kw = dict(feed_bytes_per_step=1, budget_bytes=2)
    assert poverlap.choose_steps_per_call(**kw) == \
        jax_overlap.choose_steps_per_call(**kw) == 2


def test_shard_reader_and_checkpointable_reader():
    def reader():
        return iter(range(10))
    assert list(pt.parallel.multihost.shard_reader(reader, 3, 1)()) == \
        [1, 4, 7]
    assert list(pt.parallel.multihost.shard_reader(reader)()) == \
        list(range(10))
    r = pt.parallel.multihost.CheckpointableReader(reader)
    it = r()
    assert [next(it) for _ in range(4)] == [0, 1, 2, 3]
    st = r.state(in_flight=1)
    assert st == {"reader_pass": 0, "reader_offset": 3}
    r2 = pt.parallel.multihost.CheckpointableReader(reader)
    r2.restore(st)
    assert list(r2()) == list(range(3, 10)) and r2.pass_id == 1
    jr = jfluid.parallel.multihost.CheckpointableReader(reader)
    jit = jr()
    [next(jit) for _ in range(4)]
    assert jr.state(in_flight=1) == st


def test_checkpoint_helpers_round_trip(tmp_path):
    """save_checkpoint writes the persistables and the metadata
    atomically (the leader, rank 0 here); latest_checkpoint and
    load_checkpoint restore them and the reader's position."""
    mh = pt.parallel.multihost
    main, startup, loss = nets.mlp(pt, {})
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    f = nets.feeds("mlp", 1)[0]
    exe.run(main, feed=f, fetch_list=[loss], scope=scope)
    r = mh.CheckpointableReader(lambda: iter(range(5)))
    it = r()
    next(it), next(it)
    assert mh.latest_checkpoint(str(tmp_path)) is None
    with pt.scope_guard(scope):
        assert mh.save_checkpoint(exe, str(tmp_path), 7, main_program=main,
                                  extra_meta={"lr": 0.1}, reader=r)
    assert mh.is_save_leader()
    meta = mh.latest_checkpoint(str(tmp_path))
    assert meta["step"] == 7 and meta["lr"] == 0.1
    fresh = pt.Scope()
    r2 = mh.CheckpointableReader(lambda: iter(range(5)))
    with pt.scope_guard(fresh):
        meta = mh.load_checkpoint(exe, str(tmp_path), main_program=main,
                                  reader=r2)
    assert meta["step"] == 7 and r2.offset == 2
    for n in ("tp_w1", "tp_w2"):
        np.testing.assert_array_equal(np.asarray(fresh.find_var(n)),
                                      np.asarray(scope.find_var(n)))
    assert mh.allgather_bytes(b"x") == [b"x"]
    assert mh.initialize() is False


def test_host_collectives_alone():
    from paddle_tpu_torch.parallel import _collectives as C
    np.testing.assert_array_equal(C.host_allreduce_sum([1.0, 2.0]),
                                  [1.0, 2.0])
    assert C.process_allgather_bytes(b"ab") == [b"ab"]
    x = torch.arange(4.0)
    one = pt.parallel.make_mesh((1,), ("dp",))
    for y in (C.all_reduce(x, one, "dp"), C.all_gather(x, one, "dp"),
              C.reduce_scatter(x, one, "dp"), C.broadcast(x, one, "dp")):
        assert y is x
