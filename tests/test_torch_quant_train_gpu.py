"""AMP O3 training on the card: Q1 (the fused quantize pass,
csrc/quantize.cu), K11 at ResNet-50's batch-32 training shapes, the fp8
GEMM, and a graphed O3 step.

  * Q1 in its three forms (per tensor, per row, per column or output
    channel) bitwise its plain version (quant.quantize_tensor,
    quant.quantize_channelwise run on the same CUDA tensor): the q bytes
    and the scales; and its dequantize epilogue bitwise
    `(acc.float() * (sx * sy)).to(dtype)`; at every shape of the slice's paths (ResNet-50's
    quantized conv activations and filters at batch 32 and its served
    batches, its fc; the LM's `mul` activations and weights at batch 8 x T
    2048) and at edges: one element, all zeros (scale 1e-12 / 127),
    ragged rows and channels, a misaligned base pointer, a transposed
    view, f32 input.
  * K11 at every batch-32 training shape bitwise its plain version, its
    filter from Q1 in OHWI memory: conv_cuda.COUNTERS.filter_copies does
    not move.
  * The fp8 GEMM (`quant.fp8_matmul`: torch._scaled_mm, unit scales, f32
    out, K, M and N padded to 16) within FP8_ACC_REL of the CPU's f32 sum
    of the same e4m3 products (Hopper's fp8 tensor cores add with fewer
    bits than f32 between the promotions to the f32 accumulator), and the
    whole fp8 qmatmul within the reference's error model of the f32
    product (3 x error_estimate, tests/test_quant.py:226-233).
  * A small O3 ResNet (128 channels: K11, K6, the int8 fc) and the same in
    fp8 trained graphed and eager from one state: bitwise, losses and every
    scope tensor. PADDLE_TPU_QUANT flipped off between graphed runs
    captures a new signature and gives the O2 program's numbers bitwise.

This file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_quant_train_gpu.py
"""

import torch_threads  # noqa: F401  (the cores shared among xdist workers)
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import executor as E
from paddle_tpu_torch import quant
from paddle_tpu_torch.models import resnet
from paddle_tpu_torch.ops import bn_cuda, conv_cuda, quant_cuda, registry

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

# |card - cpu| of an fp8 product's f32 sum, relative to sum |x_k y_k|
FP8_ACC_REL = 2.0 ** -12


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("Q1, K11 and the graphs are CUDA code with no CPU mode: "
                    "needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _bits(q):
    return q.view(torch.uint8) if q.dtype != torch.int8 else q


def _same(got, want):
    (gq, gs), (wq, ws) = got, want
    assert gq.dtype == wq.dtype and gq.shape == wq.shape
    assert torch.equal(_bits(gq), _bits(wq)), \
        int((_bits(gq) != _bits(wq)).sum())
    assert gs.shape == ws.shape and torch.equal(gs, ws)


def _paths():
    """(conv activation shapes, conv filter shapes, mul activation shapes,
    mul weight shapes) of the slice's paths."""
    acts, filters = set(), set()
    train = chip_smoke._resnet50_train(pt, resnet, level="O3")[0]
    serve = chip_smoke._resnet50(pt, resnet)[0]
    for prog, batches in ((train, (chip_smoke.TRAIN_BATCH,)),
                          (serve, chip_smoke.BUCKETS)):
        for b in batches:
            for xs, ws, *_ in chip_smoke._eligible_convs(conv_cuda, prog, b,
                                                         quant):
                acts.add(xs)
                filters.add(ws)
    rows, cols = {(chip_smoke.TRAIN_BATCH, 2048)}, {(2048, 1000)}
    rows |= {(b, 2048) for b in chip_smoke.BUCKETS}
    lm = chip_smoke._transformer(pt, level="O3")[0]
    block = lm.global_block()
    m = chip_smoke.LM["batch"] * chip_smoke.LM["seqlen"]
    for op in block.ops:
        if op.type == "mul":
            k, n = block.desc.var(op.input("Y")[0]).shape
            rows.add((m, k))
            rows.add((chip_smoke.LM["seqlen"], k))    # the batch-1 step
            cols.add((k, n))
    return sorted(acts), sorted(filters), sorted(rows), sorted(cols)


PATHS = None


def _shapes(i):
    global PATHS
    if PATHS is None:
        PATHS = _paths()
    return PATHS[i]


def _randn(shape, device, seed, dtype=torch.bfloat16, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * scale).to(dtype).to(device)


@pytest.mark.gpu
def test_q1_per_tensor_at_every_path_shape_and_edges(device):
    before = quant_cuda.COUNTERS.launches.get("tensor", 0)
    cases = [_randn(s, device, i) for i, s in enumerate(_shapes(0))]
    assert len(cases) >= 20
    flat = _randn((4099,), device, 1)
    cases += [_randn((1,), device, 2), torch.zeros((3, 5, 7, 16),
                                                    dtype=torch.bfloat16,
                                                    device=device),
              flat[1:],                  # a 2-byte offset: misaligned
              _randn((2, 3, 5, 13), device, 3),     # n % 8 != 0
              _randn((64, 1000), device, 4, torch.float32),
              _randn((1 << 20,), device, 5, scale=1e-30)]
    for x in cases:
        got = quant_cuda.quantize_tensor(x)
        want = quant.quantize_tensor(x)
        _same(got, want)
        assert got[0].is_contiguous()
    assert quant_cuda.COUNTERS.launches["tensor"] - before == len(cases)
    zeros = quant_cuda.quantize_tensor(cases[-5])
    assert float(zeros[1]) == float(np.float32(1e-12) / np.float32(127))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_q1_per_row_at_every_path_shape_and_edges(device, mode):
    cases = [_randn(s, device, i, scale=3.0) for i, s in
             enumerate(_shapes(2))]
    wide = _randn((5, 41), device, 7)
    cases += [_randn((1, 1), device, 1), torch.zeros((4, 64),
                                                     dtype=torch.bfloat16,
                                                     device=device),
              _randn((37, 61), device, 2),        # ragged rows and K
              wide[:, 1:],                         # misaligned, strided
              _randn((9, 300), device, 3).t(),     # a transposed view
              _randn((33, 2048), device, 4, torch.float32, 40.0)]
    for x in cases:
        _same(quant_cuda.quantize_rows(x, mode),
              quant.quantize_channelwise(x, 0, mode))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_q1_per_column_at_every_path_shape_and_edges(device, mode):
    cases = [_randn(s, device, i, torch.float32, 0.05) for i, s in
             enumerate(_shapes(3))]
    cases += [c.to(torch.bfloat16) for c in cases[:3]]
    cases += [_randn((1, 1), device, 1), torch.zeros((64, 40),
                                                     dtype=torch.bfloat16,
                                                     device=device),
              _randn((97, 37), device, 2),          # ragged K and N
              _randn((64, 45), device, 3)[:, 1:],   # misaligned columns
              _randn((40, 64), device, 4).t()]      # transpose_Y's view
    for y in cases:
        got = quant_cuda.quantize_cols(y, mode)
        _same((got[0].contiguous(), got[1]),
              quant.quantize_channelwise(y, 1, mode))
        assert got[0].t().is_contiguous()   # the GEMMs' column-major B


@pytest.mark.gpu
def test_q1_per_output_channel_filters(device):
    cases = []
    for i, ws in enumerate(_shapes(1)):
        w = _randn(ws, device, i, scale=0.05)
        cases += [w.contiguous(memory_format=torch.channels_last), w]
    cases += [_randn((16, 8, 3, 3), device, 1, torch.float32),
              torch.zeros((32, 16, 1, 1), dtype=torch.bfloat16,
                          device=device),
              _randn((24, 40, 3, 3), device, 2)[:, 1:]]   # misaligned Ci
    for w in cases:
        q, s = quant_cuda.quantize_filter(w)
        assert q.permute(0, 2, 3, 1).is_contiguous()     # OHWI memory
        _same((q.contiguous(), s), quant.quantize_channelwise(w, 0))


@pytest.mark.gpu
@pytest.mark.parametrize("acc_dtype", [torch.int32, torch.float32])
def test_q1_dequantize_at_every_path_shape_and_edges(device, acc_dtype):
    """The dequantize epilogue bitwise (acc.float() * (sx * sy)).to(dtype),
    at every `mul` product of the paths, on a slice of a padded result
    (the GEMM's), at ragged N and misaligned columns."""
    g = torch.Generator().manual_seed(9)
    shapes = [(m, n) for (m, _), (_, n) in zip(_shapes(2), _shapes(3))]
    shapes += [(32, 1000), (1, 1), (37, 61), (16384, 8192)]
    for m, n in shapes:
        acc = (torch.randint(-2 ** 30, 2 ** 30, (m + 3, n + 8), generator=g)
               .to(acc_dtype).to(device))
        sx = (torch.rand((m, 1), generator=g) * 1e-3).to(device)
        sy = (torch.rand((1, n), generator=g) * 1e-3).to(device)
        for a in (acc[:m, :n], acc[:m, 1:n + 1]):
            for dtype in (torch.bfloat16, torch.float32):
                got = quant_cuda.dequantize(a, sx, sy, dtype)
                assert got.is_contiguous()
                assert torch.equal(got, (a.float() * (sx * sy)).to(dtype))


@pytest.mark.gpu
def test_q1_refuses_what_it_does_not_take(device):
    with pytest.raises(ValueError, match="bf16 or f32"):
        quant_cuda.quantize_rows(torch.zeros((2, 8), dtype=torch.float16,
                                             device=device))
    with pytest.raises(ValueError, match="contiguous"):
        quant_cuda.quantize_tensor(torch.zeros((8, 8), dtype=torch.bfloat16,
                                               device=device).t())
    with pytest.raises(ValueError, match="mode"):
        quant_cuda.quantize_rows(torch.zeros((2, 8), dtype=torch.bfloat16,
                                             device=device), "int4")


@pytest.mark.gpu
def test_k11_at_every_training_shape_with_q1_filters(device):
    main = chip_smoke._resnet50_train(pt, resnet, level="O3")[0]
    shapes = sorted(set(chip_smoke._eligible_convs(
        conv_cuda, main, chip_smoke.TRAIN_BATCH, quant)))
    assert len(shapes) >= 10
    for i, (xs, ws, s, p, d) in enumerate(shapes):
        x = _randn(xs, device, i)
        w = _randn(ws, device, i + 100, scale=0.05).contiguous(
            memory_format=torch.channels_last)
        copies = conv_cuda.COUNTERS.filter_copies
        got = quant._qconv_forward(x, w, s, p, d, None)
        assert conv_cuda.COUNTERS.filter_copies == copies
        xq, sx = quant.quantize_tensor(x)
        wq, sw = quant.quantize_channelwise(w, 0)
        want = conv_cuda.conv2d_q8_reference(xq, wq, s, p, d,
                                             (sx * sw.reshape(-1)).float())
        assert torch.equal(got, want), (xs, ws)


@pytest.mark.gpu
@pytest.mark.parametrize("mkn", [(16384, 512, 1536), (16384, 2048, 512),
                                 (1, 2048, 1000), (3, 40, 24), (37, 64, 9)],
                         ids=str)
def test_fp8_gemm_within_its_bound(device, mkn):
    m, k, n = mkn
    x = _randn((m, k), device, 1)
    y = _randn((k, n), device, 2, torch.float32, 0.05)
    xq, sx = quant_cuda.quantize_rows(x, "fp8")
    yq, sy = quant_cuda.quantize_cols(y, "fp8")
    acc = quant.fp8_matmul(xq, yq)
    assert acc.shape == (m, n) and acc.dtype == torch.float32
    cpu = quant.fp8_matmul(xq.cpu(), yq.cpu())
    mag = xq.cpu().float().abs() @ yq.cpu().float().abs()
    err = float(((acc.cpu() - cpu).abs() / mag.clamp(min=1e-30)).max())
    print(f"fp8 GEMM {mkn}: max |card - cpu| / sum|x y| = {err:.3g}")
    assert err <= FP8_ACC_REL
    out = quant.qmatmul(x.float(), y, "fp8")
    ref = x.float() @ y
    rel = float(torch.linalg.norm(out - ref) / torch.linalg.norm(ref))
    assert rel < 3 * quant.error_estimate(k, "fp8"), rel


def _small_resnet(level, mode="int8"):
    main, startup = pt.Program(), pt.Program()
    with chip_smoke._quant_mode(mode), pt.unique_name.guard(), \
            pt.program_guard(main, startup):
        img = pt.layers.data(name="img", shape=[3, 16, 16], dtype="float32")
        label = pt.layers.data(name="label", shape=[1], dtype="int64")
        x = resnet.conv_bn_layer(img, 128, 3, 1, 1)
        x = resnet.bottleneck(x, 128, 128, 2)
        x = pt.layers.pool2d(x, pool_size=8, pool_type="avg",
                             global_pooling=True)
        loss = pt.layers.mean(pt.layers.softmax_with_cross_entropy(
            pt.layers.fc(x, size=10), label))
        opt = pt.optimizer.Momentum(learning_rate=0.05, momentum=0.9)
        pt.amp.decorate(opt, level=level).minimize(loss)
    return main, startup, loss


def _feeds(n, batch=4, seed=0):
    rng = np.random.default_rng(seed)
    return [{"img": rng.standard_normal((batch, 3, 16, 16)).astype(np.float32),
             "label": rng.integers(0, 10, (batch, 1)).astype(np.int64)}
            for _ in range(n)]


def _scopes(startup, n):
    scope = pt.Scope()
    pt.Executor().run(startup, scope=scope)
    out = []
    for _ in range(n):
        s = pt.Scope()
        for k, v in scope.vars.items():
            s.set_var(k, v.clone() if isinstance(v, torch.Tensor) else v)
        out.append(s)
    return out


def _same_scopes(a, b):
    bad = [n for n, v in a.vars.items() if isinstance(v, torch.Tensor)
           and not torch.equal(v, b.vars[n])]
    assert not bad, bad[:8]


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_graphed_o3_step_is_bitwise_its_eager_step(device, mode):
    main, startup, loss = _small_resnet("O3", mode)
    assert main._quant_mode == mode
    sg, se = _scopes(startup, 2)
    exe = pt.Executor()
    quant.COUNTERS.reset()
    conv_cuda.COUNTERS.reset()
    bn_cuda.COUNTERS.reset()
    quant_cuda.COUNTERS.reset()
    E.COUNTERS.reset()
    registry.RERUNS.clear()
    for f in _feeds(4):
        a = exe.run(main, feed=f, fetch_list=[loss], scope=sg)[0]
        b = exe.run(main, feed=f, fetch_list=[loss], scope=se,
                    use_jit=False)[0]
        assert np.array_equal(a, b) and np.isfinite(a).all()
    _same_scopes(sg, se)
    # the second run captures and replays, the later two replay
    assert (E.COUNTERS.warmups, E.COUNTERS.captures, E.COUNTERS.replays) \
        == (1, 1, 3)
    # six eager step bodies ran the wrappers: the warm-up, the capture and
    # four eager steps
    if mode == "int8":
        # the bottleneck's four convs quantize (K11), the stem (Ci=3) not
        assert quant.COUNTERS.hits == {"conv2d": 24, "mul": 6}
        assert conv_cuda.COUNTERS.q8_launches == 24
        assert conv_cuda.COUNTERS.stats_launches == 0
        assert bn_cuda.COUNTERS.act_launches == 30
        assert quant_cuda.COUNTERS.launches == {"tensor": 24, "filter": 24,
                                                "rows": 6, "cols": 6,
                                                "dequant": 6}
    else:
        assert quant.COUNTERS.hits == {"mul": 6}
        assert quant.COUNTERS.fallbacks[("conv2d", "mode")] == 24
    # the only re-run forward is the stem's (Ci = 3: no kernel, no
    # quantization), once a step; no grad re-runs a quantized forward
    assert dict(registry.RERUNS) == {"conv2d": 6}


@pytest.mark.gpu
def test_quant_switch_between_graphed_runs_captures_o2(device, monkeypatch):
    main3, startup, loss = _small_resnet("O3")
    main2, _, loss2 = _small_resnet("O2")
    s3, s2 = _scopes(startup, 2)
    exe = pt.Executor()
    feed = _feeds(1)[0]
    for _ in range(3):
        exe.run(main3, feed=feed, fetch_list=[loss], scope=s3)
    E.COUNTERS.reset()
    monkeypatch.setattr(quant, "QUANT", False)
    s3, s2 = _scopes(startup, 2)
    for _ in range(3):
        a = exe.run(main3, feed=feed, fetch_list=[loss], scope=s3)[0]
        b = exe.run(main2, feed=feed, fetch_list=[loss2], scope=s2)[0]
        assert np.array_equal(a, b)
    _same_scopes(s3, s2)
    # the O3 program under the switch is a signature of its own
    assert E.COUNTERS.warmups == 2 and E.COUNTERS.captures == 2
