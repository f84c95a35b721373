"""The vision and detection slice on the card (Executor.run on a CUDA
place).

  * The new op types on the card against the port's own CPU path on the
    same inputs: forward outputs (integer ones exact: pooling masks, ROI
    argmaxes, match indices, mined negatives, NMS labels and counts) and
    the input grads of a sum-of-squares loss.
  * The detection arithmetic reads nothing on the host: bipartite_match's
    rounds, multiclass_nms' keep loop and the pairwise IoU run on CUDA
    tensors under torch.cuda.set_sync_debug_mode("error").
  * A narrow MobileNet-SSD's training step (matching and mining inside)
    graphed: warm-up, capture and replays bitwise their eager twins, no
    eager fallback, no host read; detection_output graphed bitwise eager.
  * detection_map runs eager under the gate's reason "host_metric", one
    host read a run, counted in COUNTERS.host_syncs.

Every test skips without a CUDA device. This file imports no JAX: run it
on the card without the suite's conftest,

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_vision_gpu.py

Tolerances: graphed against eager bitwise; the card against the CPU rtol
1e-5 / atol 1e-6 for elementwise and pooling work, rtol 1e-4 / atol 1e-5
for the convs, moe_ffn and hsigmoid (cuDNN, cuBLAS and the CPU sum in
other orders; TF32 off).
"""

import torch_threads  # noqa: F401  (the cores shared among xdist workers)
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import executor as E
from paddle_tpu_torch.ops import detection_ops

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

pytestmark = pytest.mark.gpu

F32 = dict(rtol=1e-5, atol=1e-6)
CONV = dict(rtol=1e-4, atol=1e-5)
RNG = np.random.RandomState(19)


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _x(*shape):
    return RNG.rand(*shape).astype(np.float32)


def _sep(*shape):
    n = int(np.prod(shape))
    return (RNG.permutation(n).astype(np.float32) / n).reshape(shape)


def _boxes(n):
    lo = RNG.rand(n, 2).astype(np.float32) * 0.6
    return np.concatenate([lo, lo + 0.1 + RNG.rand(n, 2) * 0.3],
                          1).astype(np.float32)


def _op_case(type, ins, outs, attrs, grad_of=(), dtypes=None, tol=F32):
    def build():
        block = pt.default_main_program().current_block()
        vs = {s: pt.layers.data(name=f"in_{s.lower()}", shape=list(a.shape),
                                dtype=str(a.dtype), append_batch_size=False,
                                stop_gradient=s not in grad_of)
              for s, a in ins.items()}
        made = {s: block.create_var(name=f"{type}.{s.lower()}",
                                    dtype=(dtypes or {}).get(s, "float32"))
                for s in outs}
        block.append_op(type=type, inputs={s: [v] for s, v in vs.items()},
                        outputs={s: [v] for s, v in made.items()},
                        attrs=attrs)
        fetch = [made[s] for s in outs]
        if grad_of:
            loss = pt.layers.reduce_sum(pt.layers.square(fetch[0]))
            pt.backward.append_backward(loss)
            fetch += [vs[s].name + "@GRAD" for s in grad_of]
        return fetch
    return build, {f"in_{s.lower()}": a for s, a in ins.items()}, tol


CASES = {
    "pool3d": _op_case("pool3d", {"X": _sep(2, 3, 5, 6, 5)}, ["Out"],
                       {"pooling_type": "max", "ksize": [2, 3, 2],
                        "strides": [1, 2, 2], "paddings": [0, 1, 0]},
                       grad_of=("X",)),
    "max_pool2d_with_index": _op_case(
        "max_pool2d_with_index", {"X": _sep(2, 3, 6, 6)}, ["Out", "Mask"],
        {"ksize": [3, 3], "strides": [2, 2], "paddings": [1, 1]},
        grad_of=("X",), dtypes={"Mask": "int32"}),
    "roi_pool": _op_case("roi_pool", {
        "X": _sep(2, 3, 8, 8),
        "ROIs": np.array([[1, 1, 6, 6], [0, 2, 7, 7], [2, 0, 3, 3]],
                         np.float32),
        "RoiBatchId": np.array([0, 1, 1], np.int32)}, ["Out", "Argmax"],
        {"spatial_scale": 1.0, "pooled_height": 3, "pooled_width": 3},
        grad_of=("X",), dtypes={"Argmax": "int32"}),
    "crop": _op_case("crop", {"X": _x(4, 6),
                              "Offsets": np.array([1, 2], np.int32)},
                     ["Out"], {"shape": [2, 3]}, grad_of=("X",)),
    "spp": _op_case("spp", {"X": _sep(2, 3, 7, 9)}, ["Out"],
                    {"pyramid_height": 3, "pooling_type": "max"},
                    grad_of=("X",)),
    "unpool": _op_case("unpool", {"X": _x(1, 2, 2, 2),
                                  "Indices": np.array([[[[0, 3], [9, 14]],
                                                        [[1, 6], [8, 15]]]],
                                                      np.int32)},
                       ["Out"], {"unpooled_size": [4, 4]}, grad_of=("X",)),
    "bilinear_interp": _op_case("bilinear_interp", {"X": _x(2, 3, 4, 5)},
                                ["Out"], {"out_h": 7, "out_w": 9},
                                grad_of=("X",)),
    "conv_shift": _op_case("conv_shift", {"X": _x(2, 7), "Y": _x(2, 3)},
                           ["Out"], {}, grad_of=("X", "Y")),
    "im2sequence": _op_case("im2sequence", {"X": _x(2, 3, 5, 4)}, ["Out"],
                            {"kernels": [3, 2], "strides": [2, 1],
                             "paddings": [1, 0, 2, 1]}),
    "row_conv": _op_case("row_conv", {"X": _x(2, 6, 4), "Filter": _x(2, 4)},
                         ["Out"], {}, grad_of=("X", "Filter"), tol=CONV),
    "lrn": _op_case("lrn", {"X": _x(2, 6, 3, 3)}, ["Out", "MidOut"],
                    {"n": 5, "k": 2.0, "alpha": 1e-4, "beta": 0.75},
                    grad_of=("X",), tol=CONV),
    "conv3d": _op_case("conv3d", {"Input": _x(2, 4, 5, 4, 5),
                                  "Filter": _x(6, 2, 3, 2, 3)}, ["Output"],
                       {"strides": [2, 1, 2], "paddings": [1, 0, 1],
                        "dilations": [1, 2, 1], "groups": 2},
                       grad_of=("Input", "Filter"), tol=CONV),
    "conv2d_transpose": _op_case("conv2d_transpose",
                                 {"Input": _x(2, 3, 4, 5),
                                  "Filter": _x(3, 2, 3, 3)}, ["Output"],
                                 {"strides": [2, 2], "paddings": [1, 1]},
                                 grad_of=("Input", "Filter"), tol=CONV),
    "conv3d_transpose": _op_case("conv3d_transpose",
                                 {"Input": _x(1, 2, 3, 3, 3),
                                  "Filter": _x(2, 3, 2, 2, 2)}, ["Output"],
                                 {"strides": [2, 2, 2], "paddings": [1, 1, 1]},
                                 grad_of=("Input", "Filter"), tol=CONV),
    "moe_ffn": _op_case("moe_ffn", {
        "X": RNG.randn(16, 8).astype(np.float32),
        "GateW": RNG.randn(8, 4).astype(np.float32),
        "W1": (RNG.randn(4, 8, 12) * 0.3).astype(np.float32),
        "W2": (RNG.randn(4, 12, 8) * 0.3).astype(np.float32)}, ["Out"],
        {"capacity_factor": 1.25}, grad_of=("X", "W1", "W2"), tol=CONV),
    "iou_similarity": _op_case("iou_similarity", {"X": _boxes(5),
                                                  "Y": _boxes(7)},
                               ["Out"], {}),
    "box_coder": _op_case("box_coder", {"PriorBox": _boxes(3),
                                        "TargetBox": _boxes(4)},
                          ["OutputBox"], {}),
    "bipartite_match": _op_case(
        "bipartite_match",
        {"DistMat": (np.round(RNG.rand(2, 4, 9) * 4) / 4)
         .astype(np.float32)},
        ["ColToRowMatchIndices", "ColToRowMatchDist"],
        {"match_type": "per_prediction", "dist_threshold": 0.5},
        dtypes={"ColToRowMatchIndices": "int32"}),
    "multiclass_nms": _op_case(
        "multiclass_nms",
        {"BBoxes": np.stack([_boxes(30), _boxes(30)]),
         "Scores": (np.round(RNG.rand(2, 4, 30) * 8) / 8).astype(np.float32)},
        ["Out"], {"background_label": 0, "score_threshold": 0.1,
                  "nms_threshold": 0.3, "nms_top_k": 12, "keep_top_k": 10}),
}


def _run(build, feed, place):
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        fetch = build()
    exe = pt.Executor(place)
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    return [np.asarray(v) for v in exe.run(main, feed=feed, fetch_list=fetch,
                                           scope=scope, use_jit=False)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_ops_on_the_card_match_the_cpu(device, name):
    build, feed, tol = CASES[name]
    want = _run(build, feed, pt.CPUPlace())
    got = _run(build, feed, pt.CUDAPlace(0))
    for w, g in zip(want, got):
        assert w.shape == g.shape
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, **tol)
        else:
            np.testing.assert_array_equal(g, w)


def test_detection_lowerings_read_nothing_on_the_host(device):
    """The matching and NMS arithmetic on CUDA tensors with synchronizing
    calls made errors."""
    dist = torch.rand(4, 8, 300, device=device)
    lens = torch.tensor([8, 3, 1, 5], dtype=torch.int32, device=device)
    boxes = torch.rand(4, 300, 2, device=device)
    boxes = torch.cat([boxes, boxes + 0.2], dim=-1)
    scores = torch.rand(4, 6, 300, device=device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        idx, d = detection_ops.bipartite_match(dist, lens, "per_prediction",
                                               0.5)
        keep = detection_ops.nms_keep(boxes, scores, 0.05, 0.45, 100)
        iou = detection_ops.pairwise_iou(boxes, boxes[0])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert idx.shape == (4, 300) and keep.shape == (4, 6, 300)
    assert iou.shape == (4, 300, 300)
    # NMS keeps at most top_k a class, never a box over the threshold
    assert int(keep.sum(-1).max()) <= 100


SMALL_SSD = dict(chip_smoke.SSD, img=96, batch=4, scale=0.25, classes=5)


def test_ssd_step_graphed_bitwise_eager(device):
    main, startup, loss, _, det, out = chip_smoke.ssd_programs(pt, SMALL_SSD)
    feed, _, _ = chip_smoke.ssd_batch(np.random.default_rng(1), pt.LoDTensor,
                                      SMALL_SSD["batch"], SMALL_SSD)
    exe = pt.Executor()
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    state = {n: v for n, v in scope.vars.items()
             if isinstance(v, torch.Tensor)}
    sg = pt.Scope()
    se = pt.Scope()
    for n, v in state.items():
        sg.set_var(n, v.clone())
        se.set_var(n, v.clone())
    assert exe.graph_gate(main, feed) is None
    E.COUNTERS.reset()
    for i in range(5):
        a, = exe.run(main, feed=feed, fetch_list=[loss], scope=sg)
        b, = exe.run(main, feed=feed, fetch_list=[loss], scope=se,
                     use_jit=False)
        assert np.array_equal(a, b), i
    # the capture's step replays its graph too
    assert (E.COUNTERS.warmups, E.COUNTERS.captures, E.COUNTERS.replays) == \
        (1, 1, 4)
    assert E.COUNTERS.eager == {"use_jit": 5} and not E.COUNTERS.host_syncs
    for n, v in sg.vars.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, se.vars[n]), n

    # detection_output with the trained weights, graphed against eager
    img = {"image": feed["image"]}
    runs = [exe.run(det, feed=img, fetch_list=[out], scope=sg,
                    return_numpy=False)[0] for _ in range(3)]
    eager = exe.run(det, feed=img, fetch_list=[out], scope=sg, use_jit=False,
                    return_numpy=False)[0]
    for r in runs:
        assert np.array_equal(np.asarray(r), np.asarray(eager))
        assert r.lod == eager.lod
    assert not E.COUNTERS.host_syncs


def test_detection_map_runs_eager_with_its_host_read_counted(device):
    gt = np.array([[[1, 0, 0.1, 0.1, 0.4, 0.4],
                    [2, 0, 0.5, 0.5, 0.9, 0.9]]], np.float32)
    det = np.array([[[1, 0.9, 0.1, 0.1, 0.4, 0.4],
                     [2, 0.8, 0.0, 0.0, 0.05, 0.05]]], np.float32)
    main = pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, pt.Program()):
        d = pt.layers.data(name="d", shape=[1, 2, 6], dtype="float32",
                           append_batch_size=False)
        g = pt.layers.data(name="g", shape=[1, 2, 6], dtype="float32",
                           append_batch_size=False)
        m = pt.layers.detection.detection_map(d, g, overlap_threshold=0.5)
    exe = pt.Executor()
    E.COUNTERS.reset()
    for _ in range(3):
        v, = exe.run(main, feed={"d": det, "g": gt}, fetch_list=[m])
        np.testing.assert_allclose(v, [0.5], atol=1e-6)
    assert E.COUNTERS.eager == {"host_metric": 3}
    assert E.COUNTERS.host_syncs == {"detection_map": 3}
    assert not E.COUNTERS.captures
