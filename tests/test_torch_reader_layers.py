"""The in-program reader layers through the port against the JAX package
on the CPU, as tests/test_input_pipeline.py:233-300 drives them:
open_recordio_file -> shuffle -> batch -> double_buffer -> read_file, with
`exe.run()` taking no feed and pulling batches until EOFException, then
`reader.reset()` and the next pass; the losses of both packages from the
same weights and the same seeded shuffle (f32 within rtol 1e-5 / atol
1e-6); a LoD slot batched into a LoDTensor; multi_pass; the pull's
all-or-nothing rule; the staged batches bit for bit the file's samples in
the shuffle's order.
"""

import torch_threads  # noqa: F401  (the cores shared among xdist workers)
import random

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import executor as jax_executor
import paddle_tpu_torch as pt
from paddle_tpu_torch import executor as pt_executor

F32 = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _keep_jax_op_census():
    before = set(jax_executor._RECORDED_OPS)
    yield
    jax_executor._RECORDED_OPS.intersection_update(before)


def _ex(fluid):
    return pt_executor if fluid is pt else jax_executor


def _samples(n=36, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        x = rng.rand(4).astype(np.float32)
        out.append((x, np.array([int(x.sum() > 2.0)], np.int64)))
    return out


def _write(path, samples):
    pt.recordio.write_samples(path, samples)


def _reader_net(fluid, path, shuffle=16, batch=8, buffered=True):
    L = fluid.layers
    r = L.open_recordio_file(path, shapes=[[-1, 4], [-1, 1]],
                             lod_levels=[0, 0], dtypes=["float32", "int64"])
    if shuffle:
        r = L.shuffle(r, buffer_size=shuffle)
    r = L.batch(r, batch_size=batch)
    if buffered:
        r = L.double_buffer(r)
    x, y = L.read_file(r)
    pred = L.fc(input=x, size=2)
    loss = L.mean(L.softmax_with_cross_entropy(pred, y))
    fluid.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
    return r, x, y, loss


def _drain(exe, main, fetch, scope, reader, passes=2, seed=5):
    """Every pass of `reader` until EOFException, reset between passes;
    Python's random seeded before each pass (shuffle draws from it)."""
    out = []
    for p in range(passes):
        random.seed(seed + p)
        while True:
            try:
                out.append([np.asarray(v) for v in exe.run(
                    main, fetch_list=fetch, scope=scope)])
            except fluid_eof(exe):
                reader.reset()
                break
    return out


def fluid_eof(exe):
    return (pt.layers.EOFException if isinstance(exe, pt.Executor)
            else jfluid.layers.EOFException)


@pytest.mark.parametrize("buffered", [True, False])
def test_reader_driven_training_both_packages(tmp_path, buffered):
    """36 samples, batches of 8 with a last one of 4, two passes: the same
    batches and losses in both packages, from the JAX startup's weights."""
    path = str(tmp_path / "train.recordio")
    _write(path, _samples())
    res, arrays = {}, None
    for fluid in (jfluid, pt):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            r, x, y, loss = _reader_net(fluid, path, buffered=buffered)
        exe, scope = fluid.Executor(fluid.CPUPlace()), _ex(fluid).Scope()
        if fluid is jfluid:
            exe.run(startup, scope=scope)
            arrays = {n: np.asarray(scope.find_var(n))
                      for n, v in startup.global_block().desc.vars.items()
                      if v.persistable and scope.find_var(n) is not None}
        else:
            pt.interop.load_numpy_params(scope, arrays, "cpu")
        res[fluid] = _drain(exe, main, [loss, x, y], scope, r)
    assert len(res[pt]) == len(res[jfluid]) == 2 * 5
    assert [len(s[1]) for s in res[pt]] == [8, 8, 8, 8, 4] * 2
    for w, g in zip(res[jfluid], res[pt]):
        np.testing.assert_allclose(g[0], w[0], **F32)
        np.testing.assert_array_equal(g[1], w[1])
        np.testing.assert_array_equal(g[2], w[2])


def test_staged_batches_are_the_shuffled_samples(tmp_path):
    """The batches the executor pulls are the file's samples in the order
    the reference's shuffle gives (each full buffer shuffled, handed out
    from its end), stacked, bit for bit."""
    path = str(tmp_path / "s.recordio")
    samples = _samples(20, seed=3)
    _write(path, samples)
    main = pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, pt.Program()):
        r = pt.layers.open_recordio_file(
            path, shapes=[[-1, 4], [-1, 1]], lod_levels=[0, 0],
            dtypes=["float32", "int64"])
        r = pt.layers.double_buffer(pt.layers.batch(
            pt.layers.shuffle(r, buffer_size=8), batch_size=4))
        x, y = pt.layers.read_file(r)
    random.seed(11)
    order = []
    buf = []
    for s in samples:
        buf.append(s)
        if len(buf) >= 8:
            random.shuffle(buf)
            order += buf[::-1]
            buf = []
    random.shuffle(buf)
    order += buf[::-1]
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    random.seed(11)
    for b in range(5):
        gx, gy = exe.run(main, fetch_list=[x, y], scope=scope)
        want = order[4 * b: 4 * b + 4]
        np.testing.assert_array_equal(gx, np.stack([s[0] for s in want]))
        np.testing.assert_array_equal(gy, np.stack([s[1] for s in want]))
    with pytest.raises(pt.layers.EOFException):
        exe.run(main, fetch_list=[x], scope=scope)


def test_lod_slot_batching(tmp_path):
    """A variable-length slot comes out of batch() as a LoDTensor and feeds
    the padded-LoD path (tests/test_input_pipeline.py:270)."""
    path = str(tmp_path / "seq.recordio")
    rng = np.random.RandomState(1)
    rows = [rng.rand(n, 3).astype(np.float32) for n in (2, 4, 1, 3)]
    _write(path, [(r,) for r in rows])
    got = {}
    for fluid in (jfluid, pt):
        main = fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main,
                                                            fluid.Program()):
            r = fluid.layers.open_recordio_file(
                path, shapes=[[-1, 3]], lod_levels=[1], dtypes=["float32"])
            r = fluid.layers.double_buffer(fluid.layers.batch(r, 4))
            seq = fluid.layers.read_file(r)
            pooled = fluid.layers.sequence_pool(seq, "sum")
        exe = fluid.Executor(fluid.CPUPlace())
        got[fluid], = exe.run(main, fetch_list=[pooled],
                              scope=_ex(fluid).Scope())
    want = np.stack([r.sum(0) for r in rows])
    np.testing.assert_allclose(np.asarray(got[pt]), want, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(got[pt]), np.asarray(got[jfluid]),
                               **F32)


def test_multi_pass_repeats_the_stream(tmp_path):
    path = str(tmp_path / "mp.recordio")
    _write(path, [(np.full((2,), i, np.float32),) for i in range(3)])
    r = pt.layers.open_recordio_file(path, shapes=[[2]], lod_levels=[0],
                                     dtypes=["float32"])
    r = pt.layers.batch(pt.layers.multi_pass(r, pass_num=2), batch_size=1)
    vals = []
    try:
        while True:
            vals.append(float(r.next_batch()[0][0, 0]))
    except pt.layers.EOFException:
        pass
    assert vals == [0.0, 1.0, 2.0, 0.0, 1.0, 2.0]


def test_feeding_part_of_a_reader_raises(tmp_path):
    path = str(tmp_path / "p.recordio")
    _write(path, _samples(8))
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        r, x, y, loss = _reader_net(pt, path, shuffle=0)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    xs = np.zeros((8, 4), np.float32)
    with pytest.raises(ValueError, match="all-or-nothing"):
        exe.run(main, feed={x.name: xs}, fetch_list=[loss], scope=scope)
    # a whole feed bypasses the reader, which stays at its start
    exe.run(main, feed={x.name: xs, y.name: np.zeros((8, 1), np.int64)},
            fetch_list=[loss], scope=scope)
    first, = exe.run(main, fetch_list=[x], scope=scope)
    np.testing.assert_array_equal(first, np.stack([s[0]
                                                   for s in _samples(8)]))


def test_read_file_needs_a_batch(tmp_path):
    r = pt.layers.open_recordio_file(str(tmp_path / "none"), shapes=[[2]],
                                     lod_levels=[0], dtypes=["float32"])
    with pytest.raises(ValueError):
        pt.layers.read_file(r)


def test_double_buffer_stages_through_the_feeder(tmp_path, monkeypatch):
    """double_buffer hands the pull DoubleBufferedFeeder's staged tensors
    (the copy stream's on the card; CPU tensors here), and reset() stops
    its producer."""
    from paddle_tpu_torch.reader import pipeline
    made = []
    real = pipeline.DoubleBufferedFeeder

    class Recording(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(pipeline, "DoubleBufferedFeeder", Recording)
    path = str(tmp_path / "d.recordio")
    _write(path, _samples(16))
    r = pt.layers.open_recordio_file(path, shapes=[[-1, 4], [-1, 1]],
                                     lod_levels=[0, 0],
                                     dtypes=["float32", "int64"])
    r = pt.layers.double_buffer(pt.layers.batch(r, 8))
    bx, by = r.next_batch(torch.device("cpu"))
    assert isinstance(bx, torch.Tensor) and bx.shape == (8, 4)
    assert by.dtype == torch.int64
    assert len(made) == 1 and made[0].device.type == "cpu"
    r.reset()
    assert r._feeder is None and made[0]._thread is None
