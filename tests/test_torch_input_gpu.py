"""The input pipeline on the card: DoubleBufferedFeeder's copy stream,
events and reused pinned buffers hand out batches and windows bit for bit
the host's, at capacities 1 and 2 and window_prefetch 1 and 2, while the
consumer's stream computes on them; Executor.run_steps on the card equals
K run() calls bit for bit on tests/test_torch_run_steps.py's conv model;
a feeder asked for a CUDA device the process does not have raises.

Skipped without a CUDA device; on the card:
    python -m pytest --noconftest tests/test_torch_input_gpu.py
"""

import torch_threads  # noqa: F401  (the cores shared among xdist workers)
import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch.reader.pipeline import DoubleBufferedFeeder

N_BATCHES = 12


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("the feeder's copy stream and pinned buffers need a CUDA "
                    "device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _host_batches(seed=0, n=N_BATCHES):
    rng = np.random.default_rng(seed)
    return [{"img": rng.standard_normal((16, 3, 64, 64)).astype(np.float32),
             "label": rng.integers(0, 100, (16, 1)).astype(np.int64)}
            for _ in range(n)]


def _busy(x):
    """Work on the consumer's stream that reads all of `x`: a missing wait
    for the copy, or memory handed to a later copy while this still reads
    it, would show in the comparison after."""
    return torch.tanh(x.float() * 2).sum()


@pytest.mark.gpu
@pytest.mark.parametrize("capacity", [1, 2])
def test_batches_bitwise_the_hosts(device, capacity):
    host = _host_batches()
    dbf = DoubleBufferedFeeder(lambda: iter(host), device=device,
                               capacity=capacity)
    got = []
    for b in dbf:
        assert b["img"].device == device and b["label"].dtype == torch.int64
        _busy(b["img"])
        got.append(b)                  # kept: compared after the pass
    assert len(got) == N_BATCHES
    torch.cuda.synchronize()
    for g, h in zip(got, host):
        for n in h:
            assert torch.equal(g[n].cpu(), torch.from_numpy(h[n])), n


@pytest.mark.gpu
@pytest.mark.parametrize("capacity", [1, 2])
@pytest.mark.parametrize("prefetch", [1, 2])
def test_windows_bitwise_the_hosts(device, capacity, prefetch):
    """Every window of two passes, each kept and compared after both: the
    pinned staging buffer is reused from window to window, so a copy that
    had not ended before the next stack would show here."""
    host = _host_batches(seed=capacity * 10 + prefetch)
    k = 3
    dbf = DoubleBufferedFeeder(lambda: iter(host), device=device,
                               capacity=capacity, window_prefetch=prefetch)
    got = []
    for _ in range(2):
        for _ in range(N_BATCHES // k):
            w = dbf.next_window(k)
            assert tuple(w["img"].shape) == (k, 16, 3, 64, 64)
            _busy(w["img"])
            got.append(w)
        with pytest.raises(StopIteration):
            dbf.next_window(k)
    dbf.stop()
    torch.cuda.synchronize()
    for i, w in enumerate(got):
        j = (i % (N_BATCHES // k)) * k
        for n in w:
            want = np.stack([host[j + t][n] for t in range(k)])
            assert torch.equal(w[n].cpu(), torch.from_numpy(want)), (i, n)


@pytest.mark.gpu
def test_window_to_a_cpu_device_from_a_cuda_feeder(device):
    host = _host_batches(n=4)
    dbf = DoubleBufferedFeeder(lambda: iter(host), device=device)
    w = dbf.next_window(2, device=torch.device("cpu"))
    assert w["img"].device.type == "cpu"
    assert torch.equal(w["img"], torch.from_numpy(
        np.stack([host[0]["img"], host[1]["img"]])))
    dbf.stop()


@pytest.mark.gpu
def test_missing_cuda_device_raises(device):
    with pytest.raises(RuntimeError, match="CUDA devices"):
        DoubleBufferedFeeder(lambda: iter([]), device=torch.device(
            "cuda", torch.cuda.device_count()))


def _conv_model():
    prog, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(prog, startup):
        img = pt.layers.data(name="img", shape=[1, 8, 8], dtype="float32")
        label = pt.layers.data(name="label", shape=[1], dtype="int64")
        conv = pt.layers.conv2d(input=img, num_filters=4, filter_size=3,
                                act="relu")
        pool = pt.layers.pool2d(conv, pool_size=2, pool_type="max",
                                pool_stride=2)
        pred = pt.layers.fc(input=pool, size=10, act="softmax")
        avg_cost = pt.layers.mean(pt.layers.cross_entropy(input=pred,
                                                          label=label))
        pt.optimizer.Momentum(learning_rate=0.01, momentum=0.9).minimize(
            avg_cost, startup_program=startup)
    rng = np.random.default_rng(3)
    feeds = [{"img": rng.standard_normal((4, 1, 8, 8)).astype(np.float32),
              "label": rng.integers(0, 10, (4, 1)).astype(np.int64)}
             for _ in range(4)]
    return prog, startup, avg_cost, feeds


@pytest.mark.gpu
@pytest.mark.parametrize("through_feeder", [False, True])
def test_run_steps_bitwise_k_runs_on_the_card(device, through_feeder):
    prog, startup, loss, feeds = _conv_model()
    exe = pt.Executor(pt.CUDAPlace(0))
    sa = pt.Scope()
    exe.run(startup, scope=sa)
    sb = pt.Scope()
    sb.vars = {n: v.clone() if isinstance(v, torch.Tensor) else v
               for n, v in sa.vars.items()}
    seq = np.stack([exe.run(prog, feed=f, fetch_list=[loss], scope=sa)[0]
                    for f in feeds])
    if through_feeder:
        dbf = DoubleBufferedFeeder(lambda: iter(feeds), device=device,
                                   window_prefetch=2)
        win, = exe.run_steps(prog, reader=dbf, steps=len(feeds),
                             fetch_list=[loss], scope=sb, fetch_mode="stack")
        dbf.stop()
    else:
        win, = exe.run_steps(prog, feed_window=feeds, fetch_list=[loss],
                             scope=sb, fetch_mode="stack")
    np.testing.assert_array_equal(seq, win)
    assert sa.find_var("__rng_counter__") == sb.find_var("__rng_counter__")
    for n, v in sa.vars.items():
        if isinstance(v, torch.Tensor):
            assert v.device.type == "cuda"
            assert torch.equal(v, sb.vars[n]), n
