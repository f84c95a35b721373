"""The vision, extra and new nn op types through the port against the JAX
package on the CPU: pool3d, max_pool2d/3d_with_index, unpool, spp,
roi_pool, crop, conv3d_transpose, prelu, conv_shift, bilinear_interp,
pad, maxout, row_conv, im2sequence, nce, conv3d, conv2d_transpose, lrn,
moe_ffn and hierarchical_sigmoid, with the layers that build them.

Each case mirrors a case of tests/test_vision_ops.py or of the JAX
package's op sweeps (test_op_sweep.py, test_nn_ops.py, test_moe.py): the
same script built in both packages, run on the same numpy inputs from a
seed, the forward outputs and the input grads of a sum-of-squares loss
(where the op has a grad) held to the JAX package's. Tolerances: rtol
1e-5 / atol 1e-6 for elementwise and pooling work; rtol 1e-4 / atol 1e-5
for the convs, row_conv, hierarchical_sigmoid and moe_ffn, whose sums run
in another order than XLA's; integer outputs (the pooling masks, ROI
argmaxes) exact. nce draws its negatives from each package's own
generator: its cost is held to the JAX formula recomputed from the port's
own SampleLabels.
"""

import torch_threads  # noqa: F401  (the cores shared among xdist workers)
import numpy as np
import pytest

from paddle_tpu import executor as jax_executor
import paddle_tpu_torch as pt
from paddle_tpu_torch import executor as pt_executor

from test_torch_front_end import (F32, assert_same, data, raw, run_both,
                                  with_grads)

CONV = dict(rtol=1e-4, atol=1e-5)
RNG = np.random.RandomState(42)


@pytest.fixture(autouse=True)
def _keep_jax_op_census():
    """The JAX executor's op census (executor._RECORDED_OPS) gets back the
    types it had before each test, as in test_torch_backward.py: these
    tests run the JAX package's ops only as an oracle, and
    tests/test_zz_op_coverage.py reads the census of its xdist worker."""
    before = set(jax_executor._RECORDED_OPS)
    yield
    jax_executor._RECORDED_OPS.intersection_update(before)


def f32(*shape):
    return RNG.rand(*shape).astype(np.float32)


def well_separated(*shape):
    """Distinct values, so no max ties between the packages' argmaxes."""
    n = int(np.prod(shape))
    return (RNG.permutation(n).astype(np.float32) / n).reshape(shape)


def _op(type, ins, outs, attrs, grad_of=(), dtypes=None, tol=F32):
    """A case of one raw op: `ins` slot -> array (floats take grads when
    their slot is in `grad_of`), the outputs `outs` fetched, then the
    grads of `grad_of`'s inputs."""
    feeds = {f"in_{s.lower()}": a for s, a in ins.items()}

    def build(fluid):
        vs = {s: data(fluid, f"in_{s.lower()}", a, grad=s in grad_of)
              for s, a in ins.items()}
        made = raw(fluid, type, vs, outs, attrs, dtypes)
        fetched = [made[s] for s in outs]
        if not grad_of:
            return fetched
        return with_grads(fluid, fetched[:1], [vs[s] for s in grad_of]) + \
            fetched[1:]
    return build, feeds, tol


def _x(*shape):
    return f32(*shape)


CASES = {
    # tests/test_vision_ops.py
    "pool3d_max": _op("pool3d", {"X": _x(2, 3, 5, 6, 5)}, ["Out"],
                      {"pooling_type": "max", "ksize": [2, 3, 2],
                       "strides": [1, 2, 2], "paddings": [0, 1, 0]}),
    "pool3d_max_grad": _op("pool3d", {"X": well_separated(1, 1, 3, 4, 3)},
                           ["Out"], {"pooling_type": "max", "ksize": [2, 3, 2],
                                     "strides": [1, 2, 2],
                                     "paddings": [0, 1, 0]}, grad_of=("X",)),
    "pool3d_avg": _op("pool3d", {"X": _x(2, 2, 4, 5, 4)}, ["Out"],
                      {"pooling_type": "avg", "ksize": [2, 2, 2],
                       "strides": [2, 2, 2], "paddings": [0, 0, 0],
                       "exclusive": False}, grad_of=("X",)),
    "pool3d_avg_exclusive_padded": _op(
        "pool3d", {"X": _x(1, 2, 4, 5, 4)}, ["Out"],
        {"pooling_type": "avg", "ksize": [3, 3, 3], "strides": [2, 2, 2],
         "paddings": [1, 1, 1]}, grad_of=("X",)),
    "max_pool2d_with_index": _op(
        "max_pool2d_with_index", {"X": _x(2, 3, 6, 6)}, ["Out", "Mask"],
        {"ksize": [3, 3], "strides": [2, 2], "paddings": [1, 1]},
        dtypes={"Mask": "int32"}),
    "max_pool2d_with_index_grad": _op(
        "max_pool2d_with_index", {"X": well_separated(1, 2, 4, 4)},
        ["Out", "Mask"], {"ksize": [3, 3], "strides": [2, 2],
                          "paddings": [1, 1]}, grad_of=("X",),
        dtypes={"Mask": "int32"}),
    "max_pool3d_with_index": _op(
        "max_pool3d_with_index", {"X": _x(1, 2, 4, 5, 4)}, ["Out", "Mask"],
        {"ksize": [2, 2, 2], "strides": [2, 2, 2], "paddings": [0, 0, 0]},
        grad_of=("X",), dtypes={"Mask": "int32"}),
    "unpool": _op("unpool", {"X": _x(1, 2, 2, 2),
                             "Indices": np.array([[[[0, 3], [9, 14]],
                                                   [[1, 6], [8, 15]]]],
                                                 np.int32)},
                  ["Out"], {"unpooled_size": [4, 4]}, grad_of=("X",)),
    "spp_max": _op("spp", {"X": _x(2, 3, 7, 9)}, ["Out"],
                   {"pyramid_height": 2, "pooling_type": "max"},
                   grad_of=("X",)),
    "spp_avg": _op("spp", {"X": _x(2, 3, 7, 9)}, ["Out"],
                   {"pyramid_height": 3, "pooling_type": "avg"},
                   grad_of=("X",)),
    "roi_pool": _op("roi_pool", {
        "X": _x(2, 3, 8, 8),
        "ROIs": np.array([[1, 1, 6, 6], [0, 2, 7, 7], [2, 0, 3, 3]],
                         np.float32),
        "RoiBatchId": np.array([0, 1, 1], np.int32)}, ["Out", "Argmax"],
        {"spatial_scale": 1.0, "pooled_height": 3, "pooled_width": 3},
        dtypes={"Argmax": "int32"}),
    "roi_pool_grad": _op("roi_pool", {
        "X": well_separated(1, 1, 4, 4),
        "ROIs": np.array([[0, 0, 3, 3]], np.float32),
        "RoiBatchId": np.array([0], np.int32)}, ["Out", "Argmax"],
        {"spatial_scale": 1.0, "pooled_height": 2, "pooled_width": 2},
        grad_of=("X",), dtypes={"Argmax": "int32"}),
    "roi_pool_scaled_empty_bins": _op("roi_pool", {
        "X": well_separated(1, 2, 6, 6),
        "ROIs": np.array([[2.5, 3.5, 40.0, 44.0], [9.0, 9.0, 9.0, 9.0]],
                         np.float32)}, ["Out", "Argmax"],
        {"spatial_scale": 0.125, "pooled_height": 3, "pooled_width": 2},
        grad_of=("X",), dtypes={"Argmax": "int32"}),
    "crop": _op("crop", {"X": _x(4, 6)}, ["Out"],
                {"shape": [2, 3], "offsets": [1, 2]}, grad_of=("X",)),
    "crop_offsets_input": _op("crop", {"X": _x(4, 6),
                                       "Offsets": np.array([1, 2], np.int32)},
                              ["Out"], {"shape": [2, 3]}, grad_of=("X",)),
    "crop_offsets_clipped": _op("crop", {"X": _x(4, 6),
                                         "Offsets": np.array([3, 5],
                                                             np.int32)},
                                ["Out"], {"shape": [2, 3]}),
    "conv3d_transpose": _op("conv3d_transpose",
                            {"Input": _x(1, 2, 3, 3, 3),
                             "Filter": _x(2, 3, 2, 2, 2)}, ["Output"],
                            {"strides": [2, 2, 2], "paddings": [1, 1, 1]},
                            grad_of=("Input", "Filter"), tol=CONV),
    "conv3d_transpose_unit": _op("conv3d_transpose",
                                 {"Input": _x(1, 1, 2, 2, 2),
                                  "Filter": _x(1, 1, 2, 2, 2)}, ["Output"],
                                 {"strides": [1, 1, 1], "paddings": [0, 0, 0]},
                                 grad_of=("Input", "Filter"), tol=CONV),
    "conv_shift": _op("conv_shift", {"X": _x(2, 7), "Y": _x(2, 3)}, ["Out"],
                      {}, grad_of=("X", "Y")),
    "bilinear_interp_up": _op("bilinear_interp", {"X": _x(2, 3, 4, 5)},
                              ["Out"], {"out_h": 7, "out_w": 9},
                              grad_of=("X",)),
    "bilinear_interp_down": _op("bilinear_interp", {"X": _x(1, 2, 6, 6)},
                                ["Out"], {"out_h": 3, "out_w": 1},
                                grad_of=("X",)),
    # the JAX package's op sweep (test_op_sweep.py)
    "pad": _op("pad", {"X": _x(2, 3)}, ["Out"],
               {"paddings": [1, 0, 0, 2], "pad_value": 0.5}, grad_of=("X",)),
    "pad_4d": _op("pad", {"X": _x(1, 2, 3, 3)}, ["Out"],
                  {"paddings": [0, 1, 2, 0, 1, 1, 0, 3]}, grad_of=("X",)),
    "maxout": _op("maxout", {"X": well_separated(2, 6, 3, 3)}, ["Out"],
                  {"groups": 2}, grad_of=("X",)),
    "row_conv": _op("row_conv", {"X": _x(5, 3), "Filter": _x(3, 3)},
                    ["Out"], {}, grad_of=("X", "Filter"), tol=CONV),
    "row_conv_batched": _op("row_conv", {"X": _x(2, 6, 4),
                                         "Filter": _x(2, 4)},
                            ["Out"], {}, grad_of=("X", "Filter"), tol=CONV),
    "im2sequence": _op("im2sequence", {"X": _x(1, 2, 4, 4)}, ["Out"],
                       {"kernels": [2, 2], "strides": [1, 1]}),
    "im2sequence_padded": _op("im2sequence", {"X": _x(2, 3, 5, 4)}, ["Out"],
                              {"kernels": [3, 2], "strides": [2, 1],
                               "paddings": [1, 0, 2, 1]}),
    "lrn": _op("lrn", {"X": _x(2, 6, 3, 3)}, ["Out", "MidOut"],
               {"n": 5, "k": 2.0, "alpha": 1e-4, "beta": 0.75},
               grad_of=("X",), tol=CONV),
    "conv3d": _op("conv3d", {"Input": _x(1, 2, 4, 4, 4),
                             "Filter": _x(3, 2, 2, 2, 2)}, ["Output"],
                  {"strides": [1, 1, 1], "paddings": [0, 0, 0]},
                  grad_of=("Input", "Filter"), tol=CONV),
    "conv3d_strided_grouped": _op("conv3d", {"Input": _x(2, 4, 5, 4, 5),
                                             "Filter": _x(6, 2, 3, 2, 3)},
                                  ["Output"],
                                  {"strides": [2, 1, 2], "paddings": [1, 0, 1],
                                   "dilations": [1, 2, 1], "groups": 2},
                                  grad_of=("Input", "Filter"), tol=CONV),
    "conv2d_transpose": _op("conv2d_transpose", {"Input": _x(2, 3, 4, 5),
                                                 "Filter": _x(3, 2, 3, 3)},
                            ["Output"], {"strides": [2, 2],
                                         "paddings": [1, 1]},
                            grad_of=("Input", "Filter"), tol=CONV),
    "conv2d_transpose_dilated": _op(
        "conv2d_transpose", {"Input": _x(1, 2, 3, 3),
                             "Filter": _x(2, 4, 2, 3)}, ["Output"],
        {"strides": [1, 2], "paddings": [0, 1], "dilations": [2, 1]},
        grad_of=("Input", "Filter"), tol=CONV),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_forward_and_grad(name):
    build, feeds, tol = CASES[name]
    want, got = run_both(build, feeds)
    assert_same(want, got, tol)


def _prelu_case(mode, alpha_shape):
    x = (RNG.rand(3, 4) - 0.5).astype(np.float32)
    x[np.abs(x) < 0.05] = 0.1
    a = RNG.rand(*alpha_shape).astype(np.float32)
    return _op("prelu", {"X": x, "Alpha": a}, ["Out"], {"mode": mode},
               grad_of=("X", "Alpha"))


@pytest.mark.parametrize("mode,alpha_shape", [("all", (1,)),
                                              ("channel", (4,)),
                                              ("element", (1, 4))])
def test_prelu(mode, alpha_shape):
    build, feeds, tol = _prelu_case(mode, alpha_shape)
    want, got = run_both(build, feeds)
    assert_same(want, got, tol)


def test_moe_ffn_matches_the_jax_package():
    """test_moe.py::test_matches_numpy's case: 16 tokens, 4 experts, some
    past an expert's capacity of 5."""
    rng = np.random.RandomState(5)
    n, d, e, f = 16, 8, 4, 12
    arrays = {"x": rng.randn(n, d).astype(np.float32),
              "gw": rng.randn(d, e).astype(np.float32),
              "w1": (rng.randn(e, d, f) * 0.3).astype(np.float32),
              "w2": (rng.randn(e, f, d) * 0.3).astype(np.float32)}
    build, feeds, _ = _op("moe_ffn", {"X": arrays["x"], "GateW": arrays["gw"],
                                      "W1": arrays["w1"], "W2": arrays["w2"]},
                          ["Out"], {"capacity_factor": 1.25},
                          grad_of=("X", "GateW", "W1", "W2"))
    want, got = run_both(build, feeds)
    assert_same(want, got, CONV)


def test_hierarchical_sigmoid():
    """hsigmoid over 6 classes (code length 3), with and without bias."""
    x = RNG.randn(5, 4).astype(np.float32)
    label = np.array([[0], [5], [2], [3], [1]], np.int64)

    def build(fluid, bias):
        xv = data(fluid, "x", x)
        lv = data(fluid, "label", label)
        cost = fluid.layers.hsigmoid(
            xv, lv, 6, bias_attr=None if bias else False)
        return with_grads(fluid, [cost], [xv])
    for bias in (True, False):
        want, got = run_both(lambda fl: build(fl, bias),
                             {"x": x, "label": label})
        assert_same(want, got, CONV)


def test_nce_cost_from_its_own_samples():
    """The port's nce: SampleLabels of the right shape and range, column 0
    the labels; Cost and SampleLogits the JAX formula recomputed on the
    host from those samples and the JAX package's weights; the weight
    grads through the explicit grad; a second run draws other
    negatives, and the same run counter the same ones."""
    b, d, c, k = 6, 5, 20, 4
    x = RNG.randn(b, d).astype(np.float32)
    y = RNG.randint(0, c, (b, 1)).astype(np.int64)
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        xv = pt.layers.data(name="x", shape=[d], dtype="float32",
                            stop_gradient=False)
        yv = pt.layers.data(name="y", shape=[1], dtype="int64")
        cost = pt.layers.nce(input=xv, label=yv, num_total_classes=c,
                             num_neg_samples=k)
        loss = pt.layers.mean(cost)
        pt.backward.append_backward(loss)
    nce_op, = [o for o in main.global_block().ops if o.type == "nce"]
    labels_name = nce_op.output("SampleLabels")[0]
    logits_name = nce_op.output("SampleLogits")[0]
    w_name, b_name = nce_op.input("Weight")[0], nce_op.input("Bias")[0]
    exe = pt.Executor(pt.CPUPlace())
    scope = pt_executor.Scope()
    exe.run(startup, scope=scope)
    fetch = [cost, labels_name, logits_name, w_name + "@GRAD",
             "x@GRAD", w_name, b_name]
    got = exe.run(main, feed={"x": x, "y": y}, fetch_list=fetch, scope=scope)
    cst, lab, lgt, dw, dx, w, bias = got
    assert lab.shape == (b, 1 + k) and lab.dtype == np.int64
    assert (lab[:, 0] == y[:, 0]).all() and (lab >= 0).all() and \
        (lab < c).all()
    want_logits = np.einsum("nd,nkd->nk", x, w[lab]) + bias.reshape(-1)[lab]
    np.testing.assert_allclose(lgt, want_logits, **CONV)
    want_cost = np.log1p(np.exp(-want_logits[:, :1])).sum(1, keepdims=True) \
        + np.log1p(np.exp(want_logits[:, 1:])).sum(1, keepdims=True)
    np.testing.assert_allclose(cst, want_cost, **CONV)
    # the grads of mean(cost) from the same samples, in closed form
    sig = 1.0 / (1.0 + np.exp(-want_logits))
    g = np.concatenate([sig[:, :1] - 1.0, sig[:, 1:]], axis=1) / b
    want_dx = np.einsum("nk,nkd->nd", g, w[lab])
    want_dw = np.zeros_like(w)
    np.add.at(want_dw, lab.reshape(-1), (g[..., None] * x[:, None, :])
              .reshape(-1, d))
    np.testing.assert_allclose(dx, want_dx, **CONV)
    np.testing.assert_allclose(dw, want_dw, **CONV)
    again = exe.run(main, feed={"x": x, "y": y}, fetch_list=[labels_name],
                    scope=scope)[0]
    assert not np.array_equal(again, lab)
    assert "nce" in pt_executor.RANDOM_OPS


@pytest.mark.parametrize("layer", ["conv2d_transpose", "conv3d",
                                   "conv3d_transpose", "prelu", "row_conv",
                                   "lrn", "maxout", "pool3d", "spp",
                                   "bilinear_interp", "im2sequence", "pad",
                                   "max_pool2d_with_index_unpool",
                                   "conv_shift", "crop", "roi_pool",
                                   "sparse_moe"])
def test_layers_build_the_same_programs(layer):
    """Each new layer function with the reference's signature: the same
    ops and parameter shapes in both packages, and the same results from
    the same weights."""
    feeds = {"img": f32(2, 4, 6, 6), "vol": f32(2, 2, 3, 4, 4),
             "seq": f32(2, 5, 3), "vec": f32(2, 7), "ker": f32(2, 3),
             "rois": np.array([[0, 0, 3, 3], [1, 2, 5, 5]], np.float32),
             "tok": f32(8, 4)}

    def build(fluid):
        L = fluid.layers
        # im2sequence has no grad, as in the reference
        img = data(fluid, "img", feeds["img"], grad=layer != "im2sequence")
        vol = data(fluid, "vol", feeds["vol"])
        seq = data(fluid, "seq", feeds["seq"])
        vec = data(fluid, "vec", feeds["vec"])
        ker = data(fluid, "ker", feeds["ker"])
        rois = data(fluid, "rois", feeds["rois"], grad=False)
        tok = data(fluid, "tok", feeds["tok"])
        out = {
            "conv2d_transpose": lambda: [L.conv2d_transpose(
                img, num_filters=3, filter_size=3, stride=2, padding=1,
                act="relu")],
            "conv3d": lambda: [L.conv3d(vol, num_filters=3, filter_size=2,
                                        padding=1, act="relu")],
            "conv3d_transpose": lambda: [L.conv3d_transpose(
                vol, num_filters=2, output_size=[4, 6, 6], stride=1)],
            "prelu": lambda: [L.prelu(img, mode="channel"),
                              L.prelu(img, mode="element")],
            "row_conv": lambda: [L.row_conv(seq, future_context_size=2)],
            "lrn": lambda: [L.lrn(img, n=3, k=1.0, alpha=0.1, beta=0.75)],
            "maxout": lambda: [L.maxout(img, groups=2)],
            "pool3d": lambda: [L.pool3d(vol, pool_size=2, pool_type="avg",
                                        pool_stride=1)],
            "spp": lambda: [L.spp(img, pyramid_height=2)],
            "bilinear_interp": lambda: [L.bilinear_interp(img, 9, 5)],
            "im2sequence": lambda: [L.im2sequence(img, filter_size=2,
                                                  stride=2)],
            "pad": lambda: [L.pad(vec, paddings=[0, 1, 2, 0],
                                  pad_value=-1.0)],
            "max_pool2d_with_index_unpool": lambda: (lambda o, m: [
                o, m, L.unpool(o, m, [6, 6])])(
                    *L.max_pool2d_with_index(img, 2, 2)),
            "conv_shift": lambda: [L.conv_shift(vec, ker)],
            "crop": lambda: [L.crop(img, shape=[2, 2, 3, 3],
                                    offsets=[0, 1, 2, 3])],
            "roi_pool": lambda: [L.roi_pool(img, rois, 2, 2, 1.0)],
            "sparse_moe": lambda: [L.sparse_moe(tok, num_experts=2,
                                                hidden_size=6)],
        }[layer]()
        wrt = {"conv3d": [vol], "conv3d_transpose": [vol], "pool3d": [vol],
               "row_conv": [seq], "pad": [vec], "conv_shift": [vec, ker],
               "sparse_moe": [tok], "im2sequence": []}.get(layer, [img])
        if not wrt:
            return out
        floats = [o for o in out if o.dtype == "float32"]
        return with_grads(fluid, floats, wrt) + \
            [o for o in out if o.dtype != "float32"]
    want, got = run_both(build, feeds)
    tol = CONV if layer.startswith(("conv", "row", "lrn", "sparse")) else F32
    assert_same(want, got, tol)


# --- the JAX package's own cases of the new nn op types (test_nn_ops.py,
# test_op_sweep.py), through both packages ---------------------------------

def test_hsigmoid_named_parameters_and_grads():
    """test_nn_ops.py TestHsigmoid's case: 10 classes, named weights set
    by hand, the cost and x's grad; then the tree's probabilities over
    all 8 labels of one x sum to 1 (bias off)."""
    rng = np.random.RandomState(0)
    w = (rng.randn(9, 8) * 0.3).astype(np.float32)
    b = (rng.randn(1, 9) * 0.1).astype(np.float32)
    feed = {"x": rng.randn(4, 8).astype(np.float32),
            "hl": np.array([[3], [0], [9], [5]], np.int64),
            "hs_w": w, "hs_b": b}

    def build(fluid):
        x = data(fluid, "x", feed["x"])
        lab = data(fluid, "hl", feed["hl"])
        wv = data(fluid, "hs_w", w, grad=False)
        bv = data(fluid, "hs_b", b, grad=False)
        cost = raw(fluid, "hierarchical_sigmoid",
                   {"X": x, "W": wv, "Label": lab, "Bias": bv}, ["Cost"],
                   {"num_classes": 10})["Cost"]
        return with_grads(fluid, [cost], [x])
    want, got = run_both(build, feed)
    assert_same(want, got, CONV)

    x8 = np.repeat(rng.randn(1, 4).astype(np.float32), 8, axis=0)
    labels = np.arange(8, dtype=np.int64)[:, None]

    def build8(fluid):
        return [fluid.layers.hsigmoid(data(fluid, "x", x8),
                                      data(fluid, "hl", labels), 8,
                                      bias_attr=False)]
    want, got = run_both(build8, {"x": x8, "hl": labels})
    assert_same(want, got, CONV)
    np.testing.assert_allclose(np.exp(-got[0][0].ravel()).sum(), 1.0,
                               rtol=1e-4)


def test_bilinear_interp_corners_and_grad_conservation():
    """test_nn_ops.py TestBilinearInterp: 2x2 -> 3x3 corners aligned, and
    the grad of a sum over a 4x4 upsample conserving 16."""
    xv = np.array([[[[0.0, 1.0], [2.0, 3.0]]]], np.float32)

    def build(fluid):
        x = data(fluid, "x", xv)
        up3 = fluid.layers.bilinear_interp(x, out_h=3, out_w=3)
        up4 = fluid.layers.bilinear_interp(x, out_h=4, out_w=4)
        fluid.backward.append_backward(fluid.layers.reduce_sum(up4))
        return [up3, "x@GRAD"]
    want, got = run_both(build, {"x": xv})
    assert_same(want, got)
    np.testing.assert_allclose(got[0][0][0, 0], [[0.0, 0.5, 1.0],
                                                 [1.0, 1.5, 2.0],
                                                 [2.0, 2.5, 3.0]], rtol=1e-6)
    np.testing.assert_allclose(got[0][1].sum(), 16.0, rtol=1e-5)


def test_conv_variants_of_the_op_sweep():
    """test_op_sweep.py TestConvVariants: conv2d_transpose of ones with a
    constant 0.5 filter (every output 1.0), and conv3d's 2x2x2 oracle."""
    x = np.ones((1, 2, 4, 4), np.float32)
    x3 = RNG.rand(1, 1, 3, 3, 3).astype(np.float32)
    w3 = RNG.rand(1, 1, 2, 2, 2).astype(np.float32)

    def build(fluid):
        xv = data(fluid, "x", x)
        ct = fluid.layers.conv2d_transpose(
            xv, num_filters=3, filter_size=2, stride=2, bias_attr=False,
            param_attr=fluid.ParamAttr(
                name="ct_w", initializer=fluid.initializer.Constant(0.5)))
        c3 = raw(fluid, "conv3d", {"Input": data(fluid, "x3", x3),
                                   "Filter": data(fluid, "w3", w3)},
                 ["Output"], {"strides": [1, 1, 1],
                              "paddings": [0, 0, 0]})["Output"]
        return with_grads(fluid, [ct, c3], [xv])
    want, got = run_both(build, {"x": x, "x3": x3, "w3": w3})
    assert_same(want, got, CONV)
    assert got[0][0].shape == (1, 3, 8, 8)
    np.testing.assert_allclose(got[0][0], 1.0, rtol=1e-5)
