"""Sparse embeddings on the card: S1 (csrc/sparse_apply.cu) against its plain
version (ops/sparse_cuda.py apply_reference) in every form, twice and
bitwise repeatable, bitwise the plain version where no run of equal ids
is longer than eight (the kernel then sums in the plain version's order).
A longer run S1 sums as eight warps' partial sums added in a fixed order,
the plain version in sorted order: each row's sum (read back through sgd
at lr 1 on a zero table) within 2 n 2^-24 sum|v| of the plain sum (two f32
sums of the same n values), and the updated tensors within rtol 1e-4,
atol 1e-5 (that difference passed through the update); a CUDA tensor S1
does not take raises; a small
DLRM's graphed steps bitwise its eager steps, with the table and its
moments kept in the scope's own storage and never copied in; the hot-row
cache on the card (copy-stream staging, prefetch, flush) bitwise the
uncached run; the read-only serving cache bitwise the uncached engine.

Skipped without a CUDA device; on the card:
    python -m pytest --noconftest tests/test_torch_sparse_gpu.py
"""

import torch_threads  # noqa: F401  (the cores shared among xdist workers)
import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import executor as port_executor
from paddle_tpu_torch.ops import sparse_cuda
from paddle_tpu_torch.ops.common import SelectedRowsVal
from paddle_tpu_torch.parallel import emb_cache
from paddle_tpu_torch.reader.pipeline import DoubleBufferedFeeder

RTOL, ATOL = 1e-4, 1e-5
U = 2.0 ** -24


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("S1 and the card's cache paths need a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _rows(case, k, height, rng):
    if case == "uniform":
        return rng.integers(0, height, k)
    if case == "one_run":
        return np.full(k, 5)
    if case == "zipf":
        return np.minimum(rng.zipf(1.3, k) - 1, height - 1)
    # freed slots (== height) and ids outside the table among real ones
    r = rng.integers(0, height, k)
    r[::3] = height
    r[1::7] = -1
    r[2::11] = height + 4
    return r


def _call(kind, sr, p, accs, lr, b1p, b2p, plain):
    kw = dict(mu=0.9, nesterov=kind == "nesterov", b1=0.9, b2=0.999,
              eps=1e-8)
    form = "momentum" if kind == "nesterov" else kind
    if plain:
        return sparse_cuda.apply_reference(form, sr, p, accs, lr, b1p, b2p,
                                           **kw)
    if form == "sgd":
        return sparse_cuda.sgd(p, sr, lr)
    if form == "momentum":
        return sparse_cuda.momentum(p, accs[0], sr, lr, 0.9, kw["nesterov"])
    return sparse_cuda.adam(p, accs[0], accs[1], sr, lr, 0.9, 0.999, 1e-8,
                            b1p, b2p)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["uniform", "one_run", "zipf", "freed"])
@pytest.mark.parametrize("k", [1, 300, 6656])
@pytest.mark.parametrize("kind", ["sgd", "momentum", "nesterov", "adam"])
def test_s1_against_plain(device, kind, k, case):
    rng = np.random.default_rng(k)
    height, d = 1000, 64
    rows = torch.from_numpy(_rows(case, k, height, rng)).to(device)
    vals = torch.from_numpy(rng.standard_normal((k, d)).astype(np.float32)
                            ).to(device)
    sr = SelectedRowsVal(rows, vals, height)
    base = [torch.from_numpy(rng.standard_normal((height, d)).astype(
        np.float32)).to(device) for _ in range(3)]
    base[2] = base[2].abs()
    n_acc = {"sgd": 0, "momentum": 1, "nesterov": 1, "adam": 2}[kind]
    lr = torch.tensor(0.01, device=device)
    b1p = torch.tensor(0.9 ** 3, device=device)
    b2p = torch.tensor(0.999 ** 3, device=device)

    def run(plain):
        ts = [t.clone() for t in base[:1 + n_acc]]
        before = sparse_cuda.COUNTERS.total
        out = _call(kind, sr, ts[0], ts[1:], lr, b1p, b2p, plain)
        assert sparse_cuda.COUNTERS.total == before + (0 if plain else 1)
        assert all(o is t for o, t in zip(out, ts))
        torch.cuda.synchronize()
        return ts

    a, b, want = run(False), run(False), run(True)
    r = rows.cpu().numpy()
    valid = r[(r >= 0) & (r < height)]
    longest = np.bincount(valid).max() if valid.size else 0
    for x, y, w in zip(a, b, want):
        assert torch.equal(x, y)
        if longest <= 8:
            assert torch.equal(x, w)
        else:
            torch.testing.assert_close(x, w, rtol=RTOL, atol=ATOL)
    if longest > 8:
        _hold_sums(sr, height, d, device)
    untouched = torch.ones(height, dtype=torch.bool)
    untouched[torch.from_numpy(valid)] = False
    for x, t in zip(a, base):
        assert torch.equal(x[untouched.to(device)], t[untouched.to(device)])


def _hold_sums(sr, height, d, device):
    """S1's row sums (sgd at lr 1 on a zero table writes -sum exactly)
    within 2 n 2^-24 sum|v| of the plain merge's."""
    from paddle_tpu_torch.ops.common import merge_selected_rows
    p = torch.zeros(height, d, device=device)
    sparse_cuda.sgd(p, sr, torch.tensor(1.0, device=device))
    rows, g = merge_selected_rows(sr)
    keep = (rows >= 0) & (rows < height)
    rows, g = rows[keep], g[keep]
    _, mags = merge_selected_rows(SelectedRowsVal(sr.rows, sr.values.abs(),
                                                  height))
    n = torch.bincount(sr.rows[(sr.rows >= 0) & (sr.rows < height)],
                       minlength=height)[rows]
    bound = 2 * n[:, None] * U * mags[keep]
    assert bool(((-p[rows] - g).abs() <= bound).all())


@pytest.mark.gpu
def test_s1_raises_on_what_it_does_not_take(device):
    sr = SelectedRowsVal(torch.tensor([1], device=device),
                         torch.ones(1, 4, device=device), 8)
    with pytest.raises(ValueError, match="dtype"):
        sparse_cuda.sgd(torch.zeros(8, 4, dtype=torch.float64, device=device),
                        sr, torch.tensor(0.1, device=device))
    with pytest.raises(ValueError, match="device"):
        sparse_cuda.sgd(torch.zeros(8, 4, device=device), sr,
                        torch.tensor(0.1))


def _dlrm(rows=5000, dim=16, slots=4, opt="adam"):
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        ids = pt.layers.data(name="ids", shape=[slots], dtype="int64")
        label = pt.layers.data(name="label", shape=[1], dtype="int64")
        emb = pt.layers.embedding(ids, size=[rows, dim], is_sparse=True,
                                  param_attr=pt.ParamAttr(name="emb_table"))
        flat = pt.layers.reshape(emb, shape=[-1, slots * dim])
        h = pt.layers.fc(input=flat, size=32, act="relu")
        logits = pt.layers.fc(input=h, size=2)
        loss = pt.layers.mean(
            pt.layers.softmax_with_cross_entropy(logits, label))
        (pt.optimizer.Adam(learning_rate=1e-2) if opt == "adam"
         else pt.optimizer.SGD(learning_rate=0.1)).minimize(loss)
    main._logits = logits.name
    return main, startup, loss


def _feeds(n, rows=5000, slots=4, batch=32, seed=0, zipf=None):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = (np.minimum(rng.zipf(zipf, (batch, slots)) - 1, rows - 1)
               if zipf else rng.integers(0, rows, (batch, slots)))
        out.append({"ids": ids.astype(np.int64),
                    "label": rng.integers(0, 2, (batch, 1)).astype(np.int64)})
    return out


def _scopes(startup, n, device):
    exe = pt.Executor(pt.CUDAPlace(0))
    first = pt.Scope()
    exe.run(startup, scope=first)
    state = {k: v.cpu().numpy() for k, v in first.vars.items()
             if isinstance(v, torch.Tensor)}
    scopes = []
    for _ in range(n):
        s = pt.Scope()
        pt.interop.load_numpy_params(s, state, device)
        scopes.append(s)
    return scopes


@pytest.mark.gpu
def test_graphed_dlrm_step_bitwise_eager_and_in_place(device):
    main, startup, loss = _dlrm()
    eager, graphed = _scopes(startup, 2, device)
    exe = pt.Executor(pt.CUDAPlace(0))
    names = ["emb_table", "emb_table_moment1_0", "emb_table_moment2_0"]
    ptrs = {n: graphed.find_var(n).data_ptr() for n in names}
    port_executor.COUNTERS.reset()
    for f in _feeds(5):
        le, = exe.run(main, feed=f, fetch_list=[loss], scope=eager,
                      use_jit=False)
        lg, = exe.run(main, feed=f, fetch_list=[loss], scope=graphed)
        assert np.array_equal(le, lg)
    c = port_executor.COUNTERS
    assert (c.warmups, c.captures, c.replays) == (1, 1, 4)
    assert c.copied_in == 0
    for n in names:
        assert graphed.find_var(n).data_ptr() == ptrs[n]
        assert torch.equal(graphed.find_var(n), eager.find_var(n))


@pytest.mark.gpu
@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_cache_on_card_matches_uncached(device, opt):
    """The cached table (a 200-row slab over 5000 rows, zipf ids: about 140
    distinct ids a window, 336 in all, so windows evict) trained
    through run_steps windows from the feeder, the next window prefetched
    behind the current one, equals the uncached run bitwise after the
    flush: the remap is elementwise, so S1 sums the same values in the
    same order."""
    main, startup, loss = _dlrm(opt=opt)
    plain, cached = _scopes(startup, 2, device)
    feeds = _feeds(16, zipf=1.3, seed=3)
    exe = pt.Executor(pt.CUDAPlace(0))
    for i in range(0, 16, 4):
        exe.run_steps(main, feed_window=feeds[i:i + 4], fetch_list=[loss],
                      scope=plain)
    cmain, _, closs = _dlrm(opt=opt)
    cache = emb_cache.enable(cmain, tables={"emb_table": 200}, scope=cached)
    feeder = DoubleBufferedFeeder(lambda: iter(feeds), window_prefetch=2)
    names = cache.feed_id_names()
    win, _ = feeder.next_window(4, sparse_slots=names)
    try:
        while win is not None:
            exe.run_steps(cmain, feed_window=win, fetch_list=[closs],
                          scope=cached, return_numpy=False)
            try:
                nxt, uniq = feeder.next_window(4, sparse_slots=names)
            except StopIteration:
                nxt = None
            if nxt is not None:
                cache.prefetch(uniq).wait()
            win = nxt
    finally:
        feeder.stop()
    cache.flush()
    for n in cache.tables()["emb_table"].state_names:
        assert np.array_equal(cache.host_value(n),
                              plain.find_var(n).cpu().numpy()), n
    assert cache.stats()["evictions"] > 0


@pytest.mark.gpu
def test_serving_cache_on_card(device):
    from paddle_tpu_torch.serving import ServingEngine
    main, startup, _ = _dlrm()
    scope, = _scopes(startup, 1, device)
    fetch = [main._logits]
    eng0 = ServingEngine(main, ["ids"], fetch, scope=scope, max_batch=8)
    eng1 = ServingEngine(main, ["ids"], fetch, scope=scope, max_batch=8,
                         emb_cache_tables={"emb_table": 64})
    for f in _feeds(6, batch=8, seed=5):
        a, = eng0.run_batch({"ids": f["ids"]})
        b, = eng1.run_batch({"ids": f["ids"]})
        assert np.array_equal(a, b)
    st = eng1.stats()["emb_cache"]
    assert st["evictions"] > 0 and st["flush_bytes"] == 0
