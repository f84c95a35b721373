"""The port's input pipeline on the CPU (paddle_tpu_torch: dataset/,
reader/, minibatch.batch, DataFeeder, reader/pipeline.py
DoubleBufferedFeeder): the JAX package's tests/test_input_pipeline.py run
against the port (without TestSparseSlots, the hot-row cache's hook, and
the in-program reader layers open_recordio_file/double_buffer/multi_pass,
which the port has not), and the two packages held to each other on the
same seeds: each dataset's first 64 samples bitwise, and batch, shuffle
(Python's global `random` seeded before each package's reader),
DataFeeder.feed and feed_window to equal arrays.

The feeder runs here on `torch.device("cpu")`, where it hands out CPU
tensors; its copy stream, events and pinned buffers run on the card
(tests/test_torch_input_gpu.py).
"""

import torch_threads  # noqa: F401  (the cores shared among xdist workers)
import random
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import executor as jax_executor
from paddle_tpu.reader import pipeline as jax_pipeline
import paddle_tpu_torch as pt
from paddle_tpu_torch import data_feeder, recordio
from paddle_tpu_torch.reader import pipeline
from paddle_tpu_torch.reader.pipeline import DoubleBufferedFeeder

CPU = torch.device("cpu")
N_SAMPLES = 64


@pytest.fixture(autouse=True)
def _keep_jax_op_census():
    """The JAX executor's op census (executor._RECORDED_OPS) gets back the
    op types these runs added, as in tests/test_torch_ops.py (ROADMAP.md
    Queue 3)."""
    before = set(jax_executor._RECORDED_OPS)
    yield
    jax_executor._RECORDED_OPS.intersection_update(before)


# --- datasets: the same samples as the JAX package's -------------------------

DATASETS = {
    "uci_housing.train": lambda d: d.uci_housing.train(),
    "uci_housing.test": lambda d: d.uci_housing.test(),
    "mnist.train": lambda d: d.mnist.train(),
    "mnist.test": lambda d: d.mnist.test(),
    "cifar.train10": lambda d: d.cifar.train10(),
    "cifar.test100": lambda d: d.cifar.test100(),
    "imikolov.train": lambda d: d.imikolov.train(d.imikolov.build_dict(), 5),
    "imikolov.test_seq": lambda d: d.imikolov.test(
        d.imikolov.build_dict(), 5, d.imikolov.DataType.SEQ),
    "flowers.train": lambda d: d.flowers.train(),
    "flowers.valid": lambda d: d.flowers.valid(),
}


def _first(reader, n=N_SAMPLES):
    out = []
    for s in reader():
        out.append(s)
        if len(out) == n:
            break
    return out


def _assert_samples_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g if isinstance(g, tuple) else (g,)
        w = w if isinstance(w, tuple) else (w,)
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert type(a) is type(b)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype and a.shape == b.shape
                assert a.tobytes() == b.tobytes()
            else:
                assert a == b


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_dataset_streams_the_reference_samples(name):
    """The first 64 samples of each reader, bit for bit the JAX
    package's (the synthetic surrogates: no real data is cached)."""
    _assert_samples_equal(_first(DATASETS[name](pt.dataset)),
                          _first(DATASETS[name](jfluid.dataset)))


def test_dataset_schemas():
    x, y = _first(pt.dataset.flowers.train(), 1)[0]
    assert x.shape == (3 * 224 * 224,) and x.dtype == np.float32
    assert 0 <= y < pt.dataset.flowers.CLASS_NUM == 102
    img, label = _first(pt.dataset.mnist.train(), 1)[0]
    assert img.shape == (784,) and isinstance(label, int)
    assert len(pt.dataset.imikolov.build_dict()) == 2074
    assert not pt.dataset.common.have_real_data("flowers", "102flowers.tgz")
    with pytest.raises(RuntimeError, match="no network egress"):
        pt.dataset.common.download("http://example.invalid/x.tgz", "nowhere")


# --- decorators, batch and DataFeeder across packages ------------------------

def _chain(fluid, seed):
    random.seed(seed)
    return fluid.batch(fluid.reader.shuffle(fluid.dataset.mnist.train(),
                                            buf_size=100), batch_size=16)


def test_shuffle_and_batch_match_the_jax_package():
    port = _first(_chain(pt, 5), 12)
    jax = _first(_chain(jfluid, 5), 12)
    assert [len(b) for b in port] == [16] * 12
    for pb, jb in zip(port, jax):
        _assert_samples_equal(pb, jb)


def _feeder(fluid, conv):
    prog = fluid.Program()
    with fluid.program_guard(prog, fluid.Program()):
        img = fluid.layers.data(name="img", shape=[1, 28, 28] if conv
                                else [784], dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        return fluid.DataFeeder(place=fluid.CPUPlace(), feed_list=[img, label],
                                program=prog)


@pytest.mark.parametrize("conv", [False, True], ids=["flat", "reshaped"])
def test_data_feeder_feed_and_window_match_the_jax_package(conv):
    """DataFeeder.feed (a flat 784-pixel sample reshaped to [1, 28, 28]
    where the slot asks for it) and feed_window, through both packages."""
    batches = _first(_chain(pt, 9), 4)
    port, jax = _feeder(pt, conv), _feeder(jfluid, conv)
    for b in batches:
        p, j = port.feed(b), jax.feed(b)
        assert set(p) == set(j) == {"img", "label"}
        for n in p:
            assert p[n].dtype == j[n].dtype and p[n].shape == j[n].shape
            np.testing.assert_array_equal(p[n], j[n])
    assert port.feed(batches[0])["img"].shape == \
        ((16, 1, 28, 28) if conv else (16, 784))
    pw, jw = port.feed_window(batches), jax.feed_window(batches)
    for n in pw:
        assert pw[n].shape[0] == 4
        np.testing.assert_array_equal(pw[n], jw[n])


def test_data_feeder_counts_and_checks():
    f = _feeder(pt, False)
    before = data_feeder.COUNTERS.batches
    batch = _first(pt.batch(pt.dataset.mnist.train(), 8), 1)[0]
    f.feed(batch)
    assert data_feeder.COUNTERS.batches == before + 1
    with pytest.raises(ValueError, match="fields"):
        f.feed([(batch[0][0],)])
    with pytest.raises(ValueError, match="at least one"):
        f.feed_window([])
    with pytest.raises(TypeError):
        pt.DataFeeder(feed_list=[3], place=pt.CPUPlace())


def test_data_feeder_rejects_lod_slots():
    """A sequence slot converts to a LoDTensor in `feed`, and `feed_window`
    rejects it: each batch pads to its own length (the JAX package's
    data_feeder.py:110)."""
    prog = pt.Program()
    with pt.program_guard(prog, pt.Program()):
        pt.layers.data(name="seq", shape=[1], dtype="int64", lod_level=1)
        f = pt.DataFeeder(["seq"], pt.CPUPlace(), program=prog)
    got = f.feed([([1, 2, 3],), ([4],)])["seq"]
    assert isinstance(got, pt.LoDTensor) and got.lod == [[0, 3, 4]]
    with pytest.raises(ValueError, match="carries LoD"):
        f.feed_window([[([1, 2],)], [([3],)]])


def test_feed_window_shapes():
    prog = pt.Program()
    with pt.program_guard(prog, pt.Program()):
        pt.layers.data(name="x", shape=[3], dtype="float32")
        pt.layers.data(name="y", shape=[1], dtype="int64")
        feeder = pt.DataFeeder(["x", "y"], pt.CPUPlace(), program=prog)
    mbs = [[(np.full(3, i, np.float32), [i]) for i in (0, 1)],
           [(np.full(3, i, np.float32), [i]) for i in (2, 3)]]
    w = feeder.feed_window(mbs)
    assert w["x"].shape == (2, 2, 3) and w["y"].shape == (2, 2, 1)
    np.testing.assert_array_equal(w["y"][:, :, 0], [[0, 1], [2, 3]])


def test_decorators():
    r = pt.reader
    nums = lambda: iter(range(10))        # noqa: E731
    assert list(r.map_readers(lambda a, b: a * b, nums, nums)()) == \
        [i * i for i in range(10)]
    assert list(r.chain(nums, r.firstn(nums, 3))()) == list(range(10)) + \
        [0, 1, 2]
    assert list(r.compose(nums, nums)())[3] == (3, 3)
    with pytest.raises(r.ComposeNotAligned):
        list(r.compose(nums, r.firstn(nums, 4))())
    assert len(list(r.compose(nums, r.firstn(nums, 4),
                              check_alignment=False)())) == 4
    assert list(r.buffered(nums, 2)()) == list(range(10))
    assert list(pt.batch(nums, 4)()) == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9]]
    assert list(pt.batch(nums, 4, drop_last=True)()) == \
        [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert list(r.creator.np_array(np.arange(6).reshape(3, 2))())[1].tolist() \
        == [2, 3]


def test_decorators_match_the_jax_package(tmp_path):
    path = tmp_path / "lines.txt"
    path.write_text("a b\nc\n\nd e f\n")
    for fluid in (pt, jfluid):
        assert list(fluid.reader.creator.text_file(str(path))()) == \
            ["a b", "c", "", "d e f"]
    outs = []
    for fluid in (pt, jfluid):
        random.seed(3)
        outs.append(list(fluid.reader.shuffle(
            fluid.reader.chain(lambda: iter(range(7)),
                               lambda: iter(range(100, 105))), 4)()))
    assert outs[0] == outs[1]


def test_buffered_surfaces_errors():
    def bad():
        yield 1
        raise ValueError("boom")
    it = pt.reader.buffered(bad, 2)()
    assert next(it) == 1
    with pytest.raises(ValueError, match="boom"):
        next(it)


@pytest.mark.parametrize("order", [True, False])
def test_xmap_readers(order):
    out = list(pt.reader.xmap_readers(lambda x: x * 2,
                                      lambda: iter(range(50)), 4, 8,
                                      order=order)())
    if order:
        assert out == [2 * i for i in range(50)]
    else:
        assert sorted(out) == [2 * i for i in range(50)]


def test_xmap_errors_and_teardown():
    def mapper(x):
        if x == 7:
            raise KeyError("bad sample")
        return x
    before = threading.active_count()
    with pytest.raises(KeyError, match="bad sample"):
        list(pt.reader.xmap_readers(mapper, lambda: iter(range(100)), 3, 4,
                                    order=True)())

    def dying():
        yield 1
        raise OSError("source died")
    with pytest.raises(OSError, match="source died"):
        list(pt.reader.xmap_readers(lambda x: x, dying, 2, 4)())
    it = pt.reader.xmap_readers(lambda x: x, lambda: iter(range(1000)), 3,
                                2)()
    next(it)
    it.close()                           # abandoned: every thread ends
    deadline = threading.Event()
    for _ in range(50):
        if threading.active_count() <= before:
            break
        deadline.wait(0.1)
    assert threading.active_count() <= before


# --- DoubleBufferedFeeder ----------------------------------------------------

def _batches(n):
    return [{"x": np.full((2, 3), i, np.float32),
             "y": np.full((2, 1), -i, np.int64)} for i in range(n)]


def _dbf(n, depth=1, **kw):
    b = _batches(n)
    return DoubleBufferedFeeder(lambda: iter(b), device=CPU,
                                window_prefetch=depth, **kw)


def test_yields_all_batches_in_order():
    dbf = _dbf(7)
    got = [float(b["x"][0, 0]) for b in dbf]
    assert got == list(range(7))
    assert [float(b["x"][0, 0]) for b in dbf] == list(range(7))  # a new pass
    b = next(iter(dbf))
    assert isinstance(b["x"], torch.Tensor) and b["x"].device == CPU
    assert b["y"].dtype == torch.int64
    dbf.stop()


def test_propagates_reader_errors():
    def bad_reader():
        yield {"x": np.zeros(1)}
        raise ValueError("boom")

    it = iter(DoubleBufferedFeeder(bad_reader, device=CPU))
    next(it)
    with pytest.raises(ValueError, match="boom"):
        next(it)


@pytest.mark.parametrize("depth", [1, 2])
def test_stacks_k_batches_in_order(depth):
    dbf = _dbf(7, depth)
    w = dbf.next_window(3)
    assert set(w) == {"x", "y"}
    assert tuple(w["x"].shape) == (3, 2, 3) and tuple(w["y"].shape) == \
        (3, 2, 1)
    np.testing.assert_array_equal(w["x"][:, 0, 0], [0, 1, 2])
    w2 = dbf.next_window(3)           # the same pass goes on
    np.testing.assert_array_equal(w2["x"][:, 0, 0], [3, 4, 5])
    np.testing.assert_array_equal(w2["y"][:, 0, 0], [-3, -4, -5])
    dbf.stop()


@pytest.mark.parametrize("depth", [1, 2])
def test_short_remainder_dropped_at_end_of_pass(depth):
    dbf = _dbf(7, depth)
    dbf.next_window(3)
    dbf.next_window(3)
    before = pipeline.COUNTERS.dropped
    with pytest.raises(StopIteration):
        dbf.next_window(3)            # only batch 6 left: dropped, counted
    assert pipeline.COUNTERS.dropped - before == 1
    w = dbf.next_window(3)            # a new pass starts from batch 0
    np.testing.assert_array_equal(w["x"][:, 0, 0], [0, 1, 2])
    dbf.stop()


def test_same_stream_as_synchronous():
    sync, pre = _dbf(9, 1), _dbf(9, 3)
    for _ in range(3):
        a, b = sync.next_window(3), pre.next_window(3)
        for n in a:
            assert torch.equal(a[n], b[n])
    sync.stop()
    pre.stop()


def test_same_windows_as_the_jax_package():
    """The port's windows and the JAX package's feeder's (host side: no
    device) over one reader, equal."""
    b = _batches(8)
    port = DoubleBufferedFeeder(lambda: iter(b), device=CPU)
    jax = jax_pipeline.DoubleBufferedFeeder(lambda: iter(b))
    for _ in range(2):
        p, j = port.next_window(4), jax.next_window(4)
        for n in j:
            np.testing.assert_array_equal(p[n].numpy(), np.asarray(j[n]))
    port.stop()
    jax.stop()


def test_mismatched_feed_names_rejected():
    b = [{"x": np.zeros((2, 3), np.float32)},
         {"y": np.zeros((2, 3), np.float32)}]
    dbf = DoubleBufferedFeeder(lambda: iter(b), device=CPU)
    with pytest.raises(ValueError, match="same feed names"):
        dbf.next_window(2)


def test_window_reader_error_surfaces_in_consumer():
    def bad_reader():
        yield {"x": np.zeros((1,), np.float32)}
        raise ValueError("boom")

    for depth in (1, 2):
        dbf = DoubleBufferedFeeder(bad_reader, device=CPU,
                                   window_prefetch=depth)
        with pytest.raises(ValueError, match="boom"):
            dbf.next_window(2)
        dbf.stop()


def test_stop_terminates_builder_thread():
    dbf = _dbf(50, 2)
    dbf.next_window(2)
    t = dbf._wthread
    assert t is not None and t.is_alive()
    dbf.stop()
    assert dbf._wthread is None
    t.join(timeout=5)
    assert not t.is_alive()


def test_reset_restarts_the_pass():
    dbf = _dbf(5)
    it = iter(dbf)
    assert float(next(it)["x"][0, 0]) == 0
    assert float(next(it)["x"][0, 0]) == 1
    assert [float(b["x"][0, 0]) for b in dbf] == list(range(5))
    dbf.stop()
    assert dbf._thread is None


def test_cuda_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        DoubleBufferedFeeder(lambda: iter([]))
    with pytest.raises(RuntimeError, match="CUDA"):
        DoubleBufferedFeeder(lambda: iter([]), device="cuda")


# --- the reader-driven training loop -----------------------------------------

def _recordio_dataset(path, n=32):
    rng = np.random.RandomState(17)
    samples = []
    for _ in range(n):
        x = rng.rand(4).astype(np.float32)
        samples.append((x, np.array([int(x.sum() > 2.0)], np.int64)))
    recordio.write_samples(path, samples)


def _classifier():
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[4], dtype="float32")
        y = pt.layers.data(name="y", shape=[1], dtype="int64")
        pred = pt.layers.fc(input=x, size=2)
        loss = pt.layers.mean(pt.layers.softmax_with_cross_entropy(pred, y))
        pt.optimizer.SGD(learning_rate=0.1).minimize(loss)
    feeder = pt.DataFeeder([x, y], pt.CPUPlace(), program=main)
    return main, startup, loss, feeder


def test_reader_driven_training(tmp_path):
    """recordio file -> creator.recordio -> shuffle -> batch -> DataFeeder
    -> DoubleBufferedFeeder -> Executor.run, two passes (the reference's
    book-test reader idiom, with the chain on the host)."""
    path = str(tmp_path / "train.recordio")
    _recordio_dataset(path)
    main, startup, loss, feeder = _classifier()
    chain = pt.batch(pt.reader.shuffle(
        pt.reader.creator.recordio(path, decode=True), buf_size=16), 8)
    dbf = DoubleBufferedFeeder(chain, to_feed=feeder.feed, device=CPU)
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    seen = 0
    for _ in range(2):
        for feed in dbf:
            v, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
            seen += 1
            assert np.isfinite(v).all()
    assert seen == 2 * (32 // 8)


def test_run_steps_from_the_feeder_matches_run(tmp_path):
    """run_steps(reader=feeder) over one pass against run() on the same
    batches from the same scope: bitwise, and the pass ends in
    StopIteration with no batch dropped."""
    path = str(tmp_path / "train.recordio")
    _recordio_dataset(path)
    main, startup, loss, feeder = _classifier()
    chain = pt.batch(pt.reader.creator.recordio(path, decode=True), 8)
    exe = pt.Executor(pt.CPUPlace())
    sa = pt.Scope()
    exe.run(startup, scope=sa)
    sb = pt.Scope()
    sb.vars = {n: v.clone() if isinstance(v, torch.Tensor) else v
               for n, v in sa.vars.items()}
    seq = [exe.run(main, feed=feeder.feed(b), fetch_list=[loss],
                   scope=sa)[0] for b in chain()]
    dbf = DoubleBufferedFeeder(chain, to_feed=feeder.feed, device=CPU,
                               window_prefetch=2)
    before = pipeline.COUNTERS.dropped
    win = [exe.run_steps(main, reader=dbf, steps=2, fetch_list=[loss],
                         scope=sb, fetch_mode="stack")[0] for _ in range(2)]
    with pytest.raises(StopIteration):
        exe.run_steps(main, reader=dbf, steps=2, fetch_list=[loss], scope=sb)
    assert pipeline.COUNTERS.dropped == before
    np.testing.assert_array_equal(np.concatenate(win), np.stack(seq))
    for n, v in sa.vars.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, sb.vars[n]), n
    dbf.stop()
