"""Sparse embeddings in the port (paddle_tpu_torch) on the CPU, held to the
JAX package (the port's counterpart of tests/test_sparse_grad.py): the
SelectedRows gradient, merge_selected_rows, the sparse applies of sgd,
momentum and adam (S1's plain version here: CPU tensors), their lazy
semantics, the fused_sparse_* buckets and fusion's counters, the densify
counters, sparse `sum`, the one-rank row-sharded table, a small DLRM, and
the table keeping its storage across steps.

Inputs come from numpy with fixed seeds; the JAX startup's weights (and
accumulators) go into the port's scope by name (interop.load_numpy_params).
Tolerances: merged values within f32 rounding (rtol 1e-6, atol 1e-7): the
two packages sum duplicate ids in their own order; updated tables and
losses within rtol 1e-5, atol 1e-6: XLA:CPU may fuse or reorder the update
arithmetic that the port runs one rounded op at a time. Rows no gradient
names are held bitwise.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import executor as jax_executor
from paddle_tpu import telemetry as jtelemetry
from paddle_tpu.ops import common as jcommon
from paddle_tpu.ops import sparse_ops as jsparse
import paddle_tpu_torch as pt
from paddle_tpu_torch import telemetry as ptelemetry
from paddle_tpu_torch.ops import common as pcommon
from paddle_tpu_torch.ops import fusion as pfusion
from paddle_tpu_torch.ops import sparse_cuda, sparse_ops

RTOL, ATOL = 1e-5, 1e-6
IDS = np.array([[1, 7, 7, 3], [0, 2, 2, 2]], np.int64)
LBL = np.array([[5], [9]], np.int64)
TOUCHED = {0, 1, 2, 3, 7}


@pytest.fixture(autouse=True)
def _keep_jax_op_census():
    """The JAX executor's op census gets back the op types these runs added
    (tests/test_torch_ops.py): the op-coverage gate counts only its own
    worker's census."""
    before = set(jax_executor._RECORDED_OPS)
    yield
    jax_executor._RECORDED_OPS.intersection_update(before)


OPTS = {
    "sgd": lambda f: f.optimizer.SGD(learning_rate=0.5),
    "momentum": lambda f: f.optimizer.Momentum(learning_rate=0.3,
                                               momentum=0.9),
    "nesterov": lambda f: f.optimizer.Momentum(learning_rate=0.3,
                                               momentum=0.9,
                                               use_nesterov=True),
    "adam": lambda f: f.optimizer.Adam(learning_rate=0.1),
    "adagrad": lambda f: f.optimizer.Adagrad(learning_rate=0.1),
}


def _net(fluid, opt, is_sparse, rows=50, mesh=None):
    """tests/test_sparse_grad.py's net: one [rows, 8] table looked up by 4
    ids an example, an fc to 50 classes."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        ids = fluid.layers.data(name="ids", shape=[4], dtype="int64")
        lbl = fluid.layers.data(name="lbl", shape=[1], dtype="int64")
        emb = fluid.layers.embedding(ids, size=[rows, 8], is_sparse=is_sparse,
                                     param_attr=fluid.ParamAttr(name="emb_w"))
        flat = fluid.layers.reshape(emb, shape=[-1, 32])
        logits = fluid.layers.fc(input=flat, size=50,
                                 param_attr=fluid.ParamAttr(name="fc_w"))
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, lbl))
        OPTS[opt](fluid).minimize(loss)
    if mesh:
        _shard_one_rank(fluid, main, "emb_w")
    return main, startup, loss


def _shard_one_rank(fluid, main, table):
    """Row-shard `table` over an fsdp mesh of one rank (one device)."""
    if fluid is jfluid:
        from paddle_tpu.parallel import embedding as emb_mod
        from paddle_tpu.parallel.mesh import make_mesh
    else:
        from paddle_tpu_torch.parallel import embedding as emb_mod
        from paddle_tpu_torch.parallel.mesh import make_mesh
    main._mesh = make_mesh((1,), ("fsdp",))
    emb_mod.shard_table(main, table, "fsdp")


def _init(rows=50):
    return {"emb_w": np.linspace(-1, 1, rows * 8).astype(np.float32)
            .reshape(rows, 8),
            "fc_w": np.linspace(-0.5, 0.5, 32 * 50).astype(np.float32)
            .reshape(32, 50)}


def _jax_train(opt, is_sparse, feeds, rows=50, mesh=False):
    main, startup, loss = _net(jfluid, opt, is_sparse, rows, mesh)
    scope = jax_executor.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(startup, scope=scope)
    for n, a in _init(rows).items():
        scope.set_var(n, a)
    state = {n: np.array(scope.find_var(n))
             for n, v in startup.global_block().desc.vars.items()
             if v.persistable}
    losses, snaps = [], []
    for f in feeds:
        out, = exe.run(main, feed=f, fetch_list=[loss], scope=scope)
        losses.append(float(np.ravel(out)[0]))
        snaps.append(np.array(scope.find_var("emb_w")))
    return state, losses, snaps


def _port_train(opt, is_sparse, feeds, state, rows=50, mesh=False):
    main, _, loss = _net(pt, opt, is_sparse, rows, mesh)
    scope = pt.Scope()
    pt.interop.load_numpy_params(scope, state, "cpu")
    exe = pt.Executor(pt.CPUPlace())
    losses, snaps = [], []
    for f in feeds:
        out, = exe.run(main, feed=f, fetch_list=[loss], scope=scope)
        losses.append(float(np.ravel(out)[0]))
        snaps.append(scope.find_var("emb_w").numpy().copy())
    return losses, snaps, scope


def _feeds(n, seed=None):
    if seed is None:
        return [{"ids": IDS, "lbl": LBL}] * n
    rng = np.random.default_rng(seed)
    return [{"ids": rng.integers(0, 50, (2, 4)).astype(np.int64),
             "lbl": rng.integers(0, 50, (2, 1)).astype(np.int64)}
            for _ in range(n)]


# --- the SelectedRows value -------------------------------------------------

MERGE_CASES = {
    "duplicates": np.array([7, 2, 7, 5, 2, 7]),
    "one_id": np.array([4]),
    "one_run": np.full(9, 3),
    "sorted_unique": np.arange(6),
}


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_merge_selected_rows(case):
    """Rows equal to the reference's (freed slots at height), the merged
    values within f32 rounding, and the dense sums of both equal."""
    rows = MERGE_CASES[case]
    vals = np.random.default_rng(9).random((rows.size, 4)).astype(np.float32)
    jr, jv = jcommon.merge_selected_rows(
        jcommon.SelectedRowsVal(rows.astype(np.int32), vals, 50))
    pr, pv = pcommon.merge_selected_rows(pcommon.SelectedRowsVal(
        torch.from_numpy(rows), torch.from_numpy(vals), 50))
    np.testing.assert_array_equal(pr.numpy(), np.asarray(jr))
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=1e-6,
                               atol=1e-7)
    dense = pcommon.SelectedRowsVal(torch.from_numpy(rows),
                                    torch.from_numpy(vals), 50).to_dense()
    ref = np.zeros((50, 4), np.float64)
    np.add.at(ref, rows, vals.astype(np.float64))
    np.testing.assert_allclose(dense.numpy(), ref, rtol=1e-6, atol=1e-7)


APPLY_CASES = ["sgd", "momentum", "nesterov", "adam"]


def _apply_inputs(k, seed):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 20, k)
    vals = rng.standard_normal((k, 6)).astype(np.float32)
    p = rng.standard_normal((20, 6)).astype(np.float32)
    a1 = rng.standard_normal((20, 6)).astype(np.float32)
    a2 = rng.random((20, 6)).astype(np.float32)
    return rows, vals, p, a1, a2


def _jax_apply(kind, rows, vals, p, a1, a2):
    import jax.numpy as jnp
    sr = jcommon.SelectedRowsVal(rows.astype(np.int32), vals, 20)
    p, a1, a2 = jnp.asarray(p), jnp.asarray(a1), jnp.asarray(a2)
    lr = np.float32(0.1)
    if kind == "sgd":
        return (jsparse.sgd_apply(p, lr, sr),)
    if kind in ("momentum", "nesterov"):
        return jsparse.momentum_apply(p, a1, lr, 0.9, kind == "nesterov", sr)
    return jsparse.adam_apply(p, a1, a2, lr, 0.9, 0.999, 1e-8,
                              np.float32(0.9 ** 3), np.float32(0.999 ** 3),
                              sr)


def _port_apply(kind, rows, vals, p, a1, a2):
    sr = pcommon.SelectedRowsVal(torch.from_numpy(rows),
                                 torch.from_numpy(vals), 20)
    p, a1, a2 = (torch.from_numpy(x.copy()) for x in (p, a1, a2))
    lr = torch.tensor(0.1)
    if kind == "sgd":
        return (sparse_ops.sgd_apply(p, lr, sr),)
    if kind in ("momentum", "nesterov"):
        return sparse_ops.momentum_apply(p, a1, lr, 0.9, kind == "nesterov",
                                         sr)
    return sparse_ops.adam_apply(p, a1, a2, lr, 0.9, 0.999, 1e-8,
                                 torch.tensor(0.9 ** 3),
                                 torch.tensor(0.999 ** 3), sr)


@pytest.mark.parametrize("k", [1, 12, 40])
@pytest.mark.parametrize("kind", APPLY_CASES)
def test_sparse_apply_matches_reference(kind, k):
    """One SelectedRows gradient through each apply (S1's plain version):
    the table and its accumulators within tolerance of the JAX package's,
    updated in place, the rows the gradient does not name bitwise
    unchanged, moments included (lazy)."""
    rows, vals, p, a1, a2 = _apply_inputs(k, seed=k)
    ref = _jax_apply(kind, rows, vals, p, a1, a2)
    got = _port_apply(kind, rows, vals, p, a1, a2)
    before = (p, a1, a2)
    untouched = sorted(set(range(20)) - set(rows.tolist()))
    for r, g, b in zip(ref, got, before):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_array_equal(g.numpy()[untouched], b[untouched])


def test_apply_updates_in_place():
    rows, vals, p, a1, a2 = _apply_inputs(8, seed=1)
    tp, t1, t2 = (torch.from_numpy(x.copy()) for x in (p, a1, a2))
    ptrs = [t.data_ptr() for t in (tp, t1, t2)]
    out = sparse_ops.adam_apply(
        tp, t1, t2, torch.tensor(0.1), 0.9, 0.999, 1e-8, torch.tensor(0.9),
        torch.tensor(0.999), pcommon.SelectedRowsVal(
            torch.from_numpy(rows), torch.from_numpy(vals), 20))
    assert [t.data_ptr() for t in out] == ptrs
    assert out[0] is tp and not np.array_equal(tp.numpy(), p)


def test_apply_skips_freed_and_out_of_range_rows():
    """Rows equal to the height (a merged gradient's freed slots) and ids
    outside the table change nothing."""
    p = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    sr = pcommon.SelectedRowsVal(torch.tensor([4, 1, -1, 9]),
                                 torch.ones(4, 3), 4)
    sparse_cuda.sgd(p, sr, torch.tensor(1.0))
    want = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    want[1] -= 1
    assert torch.equal(p, want)


def test_cuda_tensor_reaches_s1_or_raises(monkeypatch):
    """The wrapper's gate is checked before any build: a table S1 does not
    take raises. A CPU tensor never touches the CUDA build."""
    from paddle_tpu_torch.ops import cuda_build

    def refuse(*a, **k):
        raise AssertionError("a CPU tensor reached cuda_build")
    monkeypatch.setattr(cuda_build, "entry", refuse)
    sr = pcommon.SelectedRowsVal(torch.tensor([1]), torch.ones(1, 3), 4)
    sparse_cuda.sgd(torch.zeros(4, 3), sr, torch.tensor(0.1))
    assert sparse_cuda.ineligible(
        "sgd", sr, torch.zeros(4, 3, dtype=torch.float64), (),
        [torch.tensor(0.1)]) == "dtype"
    assert sparse_cuda.ineligible("adam", sr, torch.zeros(4, 3),
                                  (torch.zeros(4, 3), torch.zeros(5, 3)),
                                  []) == "shape"
    assert sparse_cuda.bound_bytes("adam", 6656, 64, 6000) == \
        6656 * 64 * 4 + 6000 * 64 * 4 * 2 * 3


def test_lookup_grad_is_selected_rows_with_padding_zeroed():
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        ids = pt.layers.data(name="ids", shape=[4], dtype="int64")
        emb = pt.layers.embedding(ids, size=[10, 3], is_sparse=True,
                                  padding_idx=2,
                                  param_attr=pt.ParamAttr(name="emb_w"))
        loss = pt.layers.mean(emb)
        pt.backward.append_backward(loss)
    assert main._sparse_grad_names == {"emb_w@GRAD"}
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    g, = exe.run(main, feed={"ids": IDS}, fetch_list=["emb_w@GRAD"],
                 scope=scope, return_numpy=False)
    # a fetch densifies the SelectedRows value, counted
    assert tuple(g.shape) == (10, 3)
    assert not g[2].any() and g[7].gt(0).all()
    np.testing.assert_allclose(g[7].numpy(), np.full(3, 2 / 24), rtol=1e-6)


def test_sum_of_selected_rows():
    from paddle_tpu_torch.ops import registry
    a = pcommon.SelectedRowsVal(torch.tensor([1, 2]), torch.ones(2, 3), 5)
    b = pcommon.SelectedRowsVal(torch.tensor([2]), torch.full((1, 3), 2.0), 5)
    lower = registry.get("sum").lower
    out = lower(None, None, {"X": [a, b]})["Out"][0]
    assert isinstance(out, pcommon.SelectedRowsVal)
    assert out.rows.tolist() == [1, 2, 2] and out.height == 5
    mixed = lower(None, None, {"X": [a, torch.ones(5, 3)]})["Out"][0]
    want = torch.ones(5, 3)
    want[1:3] += 1
    assert torch.equal(mixed, want)


# --- training through the sparse path -----------------------------------------

@pytest.mark.parametrize("opt", ["sgd", "momentum", "adam"])
def test_first_step_matches_dense(opt):
    """TestSparseAdam / TestSparseMomentum: the first sparse step equals the
    dense one (zero moments hide the laziness), in the port and against
    the JAX package's sparse step."""
    state, jl, js = _jax_train(opt, True, _feeds(1))
    ls, ss, _ = _port_train(opt, True, _feeds(1), state)
    ld, sd, _ = _port_train(opt, False, _feeds(1), state)
    np.testing.assert_allclose(ls, ld, rtol=RTOL)
    np.testing.assert_allclose(ss[-1], sd[-1], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ls, jl, rtol=RTOL)
    np.testing.assert_allclose(ss[-1], js[-1], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mesh", [False, True], ids=["plain", "sharded1"])
@pytest.mark.parametrize("opt", ["sgd", "momentum", "adam"])
def test_untouched_rows_frozen_and_trains(opt, mesh):
    """Six steps: losses and the table within tolerance of the JAX
    package's, untouched rows bitwise their start, the loss falling; on a
    one-rank fsdp mesh the row-sharded table takes the same path."""
    state, jl, js = _jax_train(opt, True, _feeds(6), mesh=mesh)
    losses, snaps, _ = _port_train(opt, True, _feeds(6), state, mesh=mesh)
    np.testing.assert_allclose(losses, jl, rtol=RTOL)
    np.testing.assert_allclose(snaps[-1], js[-1], rtol=RTOL, atol=ATOL)
    untouched = [i for i in range(50) if i not in TOUCHED]
    np.testing.assert_array_equal(snaps[-1][untouched],
                                  _init()["emb_w"][untouched])
    assert losses[-1] < losses[0]


def test_lazy_adam_row_absent_from_step_two_is_frozen():
    """TestLazyAdamSemantics: a row with no gradient in step 2 keeps its
    value bitwise, where dense adam's decayed moment still moves it."""
    feeds = [{"ids": np.array([[1, 7, 12, 3], [0, 2, 9, 5]]), "lbl": LBL},
             {"ids": np.array([[1, 7, 12, 3], [0, 2, 9, 3]]), "lbl": LBL}]
    state, _, js = _jax_train("adam", True, feeds)
    _, sparse, _ = _port_train("adam", True, feeds, state)
    _, dense, _ = _port_train("adam", False, feeds, state)
    np.testing.assert_array_equal(sparse[1][5], sparse[0][5])
    assert np.any(dense[1][5] != dense[0][5])
    np.testing.assert_allclose(sparse[1], js[1], rtol=RTOL, atol=ATOL)


def test_table_keeps_its_storage_across_eager_steps():
    """The sparse apply advances the table and its moments in the scope's
    own tensors: the same storage after three run() calls and a
    run_steps window."""
    state, _, _ = _jax_train("adam", True, [])
    main, _, loss = _net(pt, "adam", True)
    scope = pt.Scope()
    pt.interop.load_numpy_params(scope, state, "cpu")
    names = ["emb_w", "emb_w_moment1_0", "emb_w_moment2_0"]
    ptrs = {n: scope.find_var(n).data_ptr() for n in names}
    exe = pt.Executor(pt.CPUPlace())
    for f in _feeds(3, seed=4):
        exe.run(main, feed=f, fetch_list=[loss], scope=scope)
    exe.run_steps(main, feed_window=_feeds(2, seed=5), fetch_list=[loss],
                  scope=scope)
    assert {n: scope.find_var(n).data_ptr() for n in names} == ptrs
    assert not np.array_equal(scope.find_var("emb_w").numpy(),
                              state["emb_w"])


def test_sharded_table_over_more_than_one_rank_raises():
    from paddle_tpu_torch.parallel import embedding, mesh
    main, _, _ = _net(pt, "sgd", True)
    main._mesh = mesh.Mesh(("fsdp",), (2,), None, 0, torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="9b"):
        embedding.shard_table(main, "emb_w", "fsdp")
    one, _, _ = _net(pt, "sgd", True, mesh=True)
    per = embedding.per_shard_table_bytes(one, scope=pt.Scope())
    assert per["tables"]["emb_w"]["factor"] == 1
    assert per["tables"]["emb_w"]["bytes"] == 50 * 8 * 4


def _two_tables(fluid, opt):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        ids_a = fluid.layers.data(name="ids_a", shape=[4], dtype="int64")
        ids_b = fluid.layers.data(name="ids_b", shape=[4], dtype="int64")
        lbl = fluid.layers.data(name="lbl", shape=[1], dtype="int64")
        emb_a = fluid.layers.embedding(
            ids_a, size=[40, 8], is_sparse=True,
            param_attr=fluid.ParamAttr(name="two_emb_a"))
        emb_b = fluid.layers.embedding(
            ids_b, size=[30, 8], is_sparse=True,
            param_attr=fluid.ParamAttr(name="two_emb_b"))
        both = fluid.layers.concat([emb_a, emb_b], axis=1)
        flat = fluid.layers.reshape(both, shape=[-1, 64])
        logits = fluid.layers.fc(input=flat, size=20,
                                 param_attr=fluid.ParamAttr(name="two_fc"))
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, lbl))
        OPTS[opt](fluid).minimize(loss)
    return main, startup, loss


TWO_FEED = {"ids_a": np.array([[1, 7, 12, 3], [0, 2, 9, 5]], np.int64),
            "ids_b": np.array([[4, 8, 11, 6], [13, 10, 14, 15]], np.int64),
            "lbl": LBL}


@pytest.mark.parametrize("opt", ["sgd", "momentum", "adam"])
def test_fused_sparse_bucket(opt):
    """TestFusedSparseBuckets: two sparse tables run as one
    fused_sparse_<opt> bucket; the tables within tolerance of the JAX
    package's after two steps, and fusion's fallback reasons counted as
    the reference counts them."""
    main, startup, loss = _two_tables(jfluid, opt)
    scope = jax_executor.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(startup, scope=scope)
    state = {n: np.array(scope.find_var(n))
             for n, v in startup.global_block().desc.vars.items()
             if v.persistable}
    before = jtelemetry.read_series("fusion_fallback_total")
    for _ in range(2):
        exe.run(main, feed=TWO_FEED, fetch_list=[loss], scope=scope)
    after = jtelemetry.read_series("fusion_fallback_total")
    ref = {k.split("reason=")[1]: v - before.get(k, 0.0)
           for k, v in after.items() if v != before.get(k, 0.0)}
    pmain, _, ploss = _two_tables(pt, opt)
    pscope = pt.Scope()
    pt.interop.load_numpy_params(pscope, state, "cpu")
    pfusion.COUNTERS.reset()
    pexe = pt.Executor(pt.CPUPlace())
    for _ in range(2):
        pexe.run(pmain, feed=TWO_FEED, fetch_list=[ploss], scope=pscope)
    assert pfusion.COUNTERS.buckets.get("fused_sparse_" + opt) == 2
    assert {k: float(v) for k, v in pfusion.COUNTERS.fallbacks.items()} \
        == ref
    for n in ("two_emb_a", "two_emb_b", "two_fc"):
        np.testing.assert_allclose(pscope.find_var(n).numpy(),
                                   np.array(scope.find_var(n)), rtol=RTOL,
                                   atol=ATOL)


def _delta(tel, name, before):
    after = tel.read_series(name)
    return {k: v - before.get(k, 0.0) for k, v in after.items()
            if v != before.get(k, 0.0)}


@pytest.mark.parametrize("case", ["hot_path", "gated_off", "adagrad"])
def test_densify_counters(case, monkeypatch):
    """TestDensifyCounters: the hot path densifies nothing; with the gate
    off sgd densifies (`gated_off`) and trains as the dense path; adagrad,
    with no sparse apply, densifies at the executor's boundary
    (`sparse_unaware_op`); each delta equal to the JAX package's on the
    same run."""
    opt = "adagrad" if case == "adagrad" else "sgd"
    if case == "gated_off":
        monkeypatch.setenv("PADDLE_TPU_SPARSE_APPLY", "0")
    name = "sparse_densify_fallback_total"
    jb = jtelemetry.read_series(name)
    state, _, js = _jax_train(opt, True, _feeds(2))
    ref = _delta(jtelemetry, name, jb)
    pb = ptelemetry.read_series(name)
    _, snaps, _ = _port_train(opt, True, _feeds(2), state)
    got = _delta(ptelemetry, name, pb)
    assert got == ref
    want = {"hot_path": {}, "gated_off": {"op=sgd,reason=gated_off": 2.0},
            "adagrad": {"op=adagrad,reason=sparse_unaware_op": 2.0}}[case]
    assert got == want
    np.testing.assert_allclose(snaps[-1], js[-1], rtol=RTOL, atol=ATOL)
    if case == "gated_off":
        _, dense, _ = _port_train(opt, False, _feeds(2), state)
        np.testing.assert_allclose(snaps[-1], dense[-1], rtol=RTOL,
                                   atol=1e-7)


def test_apply_rows_counter_and_graph_key_token(monkeypatch):
    before = ptelemetry.read_series("sparse_apply_rows_total")
    state, _, _ = _jax_train("sgd", True, [])
    _port_train("sgd", True, _feeds(1), state)
    after = ptelemetry.read_series("sparse_apply_rows_total")
    assert after.get("op=sgd", 0) - before.get("op=sgd", 0) == IDS.size
    main, _, _ = _net(pt, "sgd", True)
    on = sparse_ops.cache_token(main)
    monkeypatch.setenv("PADDLE_TPU_SPARSE_APPLY", "0")
    assert sparse_ops.cache_token(main) != on


# --- a small DLRM ---------------------------------------------------------------

DLRM = {"rows": 2000, "dim": 16, "slots": 4, "batch": 16}


def _dlrm(fluid, sharded):
    """bench.py's `embedding` family cut to size: one shared table looked
    up by every slot, an MLP of relu fc layers, Adam, no AMP."""
    c = DLRM
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        ids = fluid.layers.data(name="ids", shape=[c["slots"]],
                                dtype="int64")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        emb = fluid.layers.embedding(
            ids, size=[c["rows"], c["dim"]], is_sparse=True,
            param_attr=fluid.ParamAttr(name="emb_table"))
        flat = fluid.layers.reshape(emb, shape=[-1, c["slots"] * c["dim"]])
        h = fluid.layers.fc(input=flat, size=32, act="relu")
        h = fluid.layers.fc(input=h, size=16, act="relu")
        logits = fluid.layers.fc(input=h, size=2)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, label))
        fluid.optimizer.Adam(learning_rate=1e-2).minimize(loss)
    if sharded:
        _shard_one_rank(fluid, main, "emb_table")
    return main, startup, loss


@pytest.mark.parametrize("sharded", [False, True])
def test_dlrm_three_steps(sharded):
    """Three steps of the small DLRM from the JAX startup: losses, the
    touched rows within tolerance, the untouched rows bitwise their start;
    fusion counts the table as the reference does."""
    c = DLRM
    rng = np.random.default_rng(15)
    feeds = [{"ids": rng.integers(0, c["rows"],
                                  (c["batch"], c["slots"])).astype(np.int64),
              "label": rng.integers(0, 2, (c["batch"], 1)).astype(np.int64)}
             for _ in range(3)]
    main, startup, loss = _dlrm(jfluid, sharded)
    scope = jax_executor.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(startup, scope=scope)
    state = {n: np.array(scope.find_var(n))
             for n, v in startup.global_block().desc.vars.items()
             if v.persistable}
    jl = [float(np.ravel(exe.run(main, feed=f, fetch_list=[loss],
                                 scope=scope)[0])[0]) for f in feeds]
    pmain, _, ploss = _dlrm(pt, sharded)
    pscope = pt.Scope()
    pt.interop.load_numpy_params(pscope, state, "cpu")
    pfusion.COUNTERS.reset()
    pexe = pt.Executor(pt.CPUPlace())
    pl = [float(np.ravel(pexe.run(pmain, feed=f, fetch_list=[ploss],
                                  scope=pscope)[0])[0]) for f in feeds]
    np.testing.assert_allclose(pl, jl, rtol=RTOL)
    got = pscope.find_var("emb_table").numpy()
    np.testing.assert_allclose(got, np.array(scope.find_var("emb_table")),
                               rtol=RTOL, atol=ATOL)
    touched = np.unique(np.concatenate([f["ids"].ravel() for f in feeds]))
    untouched = np.setdiff1d(np.arange(c["rows"]), touched)
    np.testing.assert_array_equal(got[untouched],
                                  state["emb_table"][untouched])
    assert not np.array_equal(got[touched], state["emb_table"][touched])
    reason = "sharded_table_sparse_path" if sharded else "sparse_grad_handled"
    assert pfusion.COUNTERS.fallbacks == {reason: 3}


class _Deferred:
    """Stands in for a CUDA graph capture on the CPU: a capture launches
    nothing (it only records), so the body runs at each replay, never at
    the capture; a replay runs no Python, so the kernel counters are put
    back after it."""

    def __init__(self, body, pool=None):
        self.body = body

    def pool(self):
        return None

    def replay(self):
        launches = dict(sparse_cuda.COUNTERS.launches)
        self.body()
        sparse_cuda.COUNTERS.launches.clear()
        sparse_cuda.COUNTERS.launches.update(launches)


def test_graphed_sparse_steps_update_the_scope_tables_in_place(monkeypatch):
    """The graphed step (the capture stood in for on the CPU) keeps the
    table and its moments in the scope's own tensors: its buffers are
    them, no step copies them in or hands out copies, and the losses and
    every tensor equal the eager steps' bitwise; PADDLE_TPU_SPARSE_APPLY
    is part of the graph's key."""
    from paddle_tpu_torch import executor as port_executor
    gate = pt.Executor.graph_gate

    def cuda_gate(self, program, feed, use_jit=None, use_program_cache=True):
        device, self.device = self.device, torch.device("cuda", 0)
        try:
            return gate(self, program, feed, use_jit, use_program_cache)
        finally:
            self.device = device
    monkeypatch.setattr(port_executor, "capture_graph", _Deferred)
    monkeypatch.setattr(pt.Executor, "graph_gate", cuda_gate)
    state, _, _ = _jax_train("adam", True, [])
    main, _, loss = _net(pt, "adam", True)
    sg, se = pt.Scope(), pt.Scope()
    for s in (sg, se):
        pt.interop.load_numpy_params(s, state, "cpu")
    names = ["emb_w", "emb_w_moment1_0", "emb_w_moment2_0"]
    tables = {n: sg.find_var(n) for n in names}
    exe = pt.Executor(pt.CPUPlace())
    port_executor.COUNTERS.reset()
    for f in _feeds(4, seed=6):
        a, = exe.run(main, feed=f, fetch_list=[loss], scope=sg)
        b, = exe.run(main, feed=f, fetch_list=[loss], scope=se,
                     use_jit=False)
        np.testing.assert_array_equal(a, b)
    c = port_executor.COUNTERS
    assert (c.warmups, c.captures, c.replays, c.copied_in) == (1, 1, 3, 0)
    for n, v in se.vars.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(sg.find_var(n), v), n
    assert all(sg.find_var(n) is t for n, t in tables.items())
    entry, = exe._graphs.values()
    assert entry.inplace == set(names)
    assert all(entry.state[n].t is tables[n] for n in names)
    monkeypatch.setenv("PADDLE_TPU_SPARSE_APPLY", "0")
    exe.run(main, feed=_feeds(1, seed=7)[0], fetch_list=[loss], scope=sg)
    assert c.warmups == 2 and len(exe._graphs) == 2


def test_two_graphed_scopes_keep_their_own_tables(monkeypatch):
    """Two scopes graphed in turns on one Executor stay apart: each in-place
    table is bound to the graph captured on its scope (its identity is in
    the key), so neither scope's steps write the other's table or moments,
    and each scope equals its own eager twin bitwise."""
    from paddle_tpu_torch import executor as port_executor
    gate = pt.Executor.graph_gate

    def cuda_gate(self, program, feed, use_jit=None, use_program_cache=True):
        device, self.device = self.device, torch.device("cuda", 0)
        try:
            return gate(self, program, feed, use_jit, use_program_cache)
        finally:
            self.device = device
    monkeypatch.setattr(port_executor, "capture_graph", _Deferred)
    monkeypatch.setattr(pt.Executor, "graph_gate", cuda_gate)
    state, _, _ = _jax_train("adam", True, [])
    main, _, loss = _net(pt, "adam", True)
    scopes = [pt.Scope() for _ in range(4)]   # graphed a, b; eager a, b
    for s in scopes:
        pt.interop.load_numpy_params(s, state, "cpu")
    names = ["emb_w", "emb_w_moment1_0", "emb_w_moment2_0"]
    tables = [{n: s.find_var(n) for n in names} for s in scopes[:2]]
    exe = pt.Executor(pt.CPUPlace())
    port_executor.COUNTERS.reset()
    feeds = [_feeds(4, seed=8), _feeds(4, seed=9)]
    for i in range(4):
        for g, e, f in ((0, 2, feeds[0][i]), (1, 3, feeds[1][i])):
            a, = exe.run(main, feed=f, fetch_list=[loss], scope=scopes[g])
            b, = exe.run(main, feed=f, fetch_list=[loss], scope=scopes[e],
                         use_jit=False)
            np.testing.assert_array_equal(a, b)
    c = port_executor.COUNTERS
    assert (c.warmups, c.captures, c.replays) == (2, 2, 6)
    for g, e in ((0, 2), (1, 3)):
        for n, v in scopes[e].vars.items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(scopes[g].find_var(n), v), n
    for s, t in zip(scopes[:2], tables):
        assert all(s.find_var(n) is t[n] for n in names)
    assert not torch.equal(tables[0]["emb_w"], tables[1]["emb_w"])
    bound = [{n: e.state[n].t for n in names} for e in exe._graphs.values()]
    assert sorted(id(b["emb_w"]) for b in bound) == sorted(
        id(t["emb_w"]) for t in tables)
