"""The detection family through the port against the JAX package on the
CPU: the eight op types (prior_box, iou_similarity, box_coder,
bipartite_match, mine_hard_examples, target_assign, multiclass_nms,
detection_map) through layers.detection, ssd_loss and multi_box_head, a
tiny SSD's training losses, a narrow MobileNet-SSD's losses and
detection_output, metrics.DetectionMAP, the detection_map gate reason,
and the voc2012 surrogate.

Each case mirrors a case of tests/test_detection_ops.py (and adds
deliberate ties, where the packages must pick the same winners: stable
descending sorts, first maxima in row-major order). The same numpy inputs
go through both packages; the port starts from the JAX package's weights.
Tolerances: rtol 1e-5 / atol 1e-6 for float outputs of the ops; rtol 1e-4
/ atol 1e-5 for the losses of the conv nets (sums in another order than
XLA's); exact for every integer output (match indices, negative indices,
NMS labels, counts) and for the prior boxes.
"""

import torch_threads  # noqa: F401  (the cores shared among xdist workers)
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import executor as jax_executor
import paddle_tpu_torch as pt
from paddle_tpu_torch import executor as pt_executor

import chip_smoke

F32 = dict(rtol=1e-5, atol=1e-6)
CONV = dict(rtol=1e-4, atol=1e-5)
RNG = np.random.RandomState(5)


@pytest.fixture(autouse=True)
def _keep_jax_op_census():
    """The JAX executor's op census (executor._RECORDED_OPS) gets back the
    types it had before each test, as in test_torch_backward.py: these
    tests run the JAX package's ops only as an oracle, and
    tests/test_zz_op_coverage.py reads the census of its xdist worker."""
    before = set(jax_executor._RECORDED_OPS)
    yield
    jax_executor._RECORDED_OPS.intersection_update(before)


def _ex(fluid):
    return pt_executor if fluid is pt else jax_executor


def make_lod(fluid, rows):
    offs = [0]
    for r in rows:
        offs.append(offs[-1] + len(r))
    return _ex(fluid).LoDTensor(np.concatenate(rows, axis=0), [offs])


def _host(v):
    """A fetch as (array, lod) where it came back a LoDTensor."""
    if isinstance(v, (jax_executor.LoDTensor, pt_executor.LoDTensor)):
        return np.asarray(v.array()), [list(l) for l in v.lod]
    return np.asarray(v), None


def run_both(build, feeds, steps=1):
    """`build(fluid)` -> fetch list, in fresh programs of each package;
    `feeds(fluid)` -> the feed dict; the port starts from the JAX
    startup's persistables; `steps` runs. -> (JAX, port) lists of
    (array, lod) per fetch, per step."""
    out, arrays = {}, None
    for fluid in (jfluid, pt):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            targets = build(fluid)
        scope = _ex(fluid).Scope()
        exe = fluid.Executor(fluid.CPUPlace())
        if fluid is jfluid:
            exe.run(startup, scope=scope)
            arrays = {n: np.asarray(scope.find_var(n))
                      for n, v in startup.global_block().desc.vars.items()
                      if v.persistable and scope.find_var(n) is not None}
        else:
            pt.interop.load_numpy_params(scope, arrays, "cpu")
        feed = feeds(fluid)
        out[fluid] = [[_host(v) for v in exe.run(
            main, feed=feed, fetch_list=targets, scope=scope,
            return_numpy=False)] for _ in range(steps)]
    return out[jfluid], out[pt]


def lockstep(build, feeds, steps):
    """`steps` training steps of `build(fluid)` -> [loss] in each package,
    the port starting each step from the JAX package's state before it
    (its persistables copied over by name), so every step is compared
    from the same weights. -> (JAX losses, port losses)."""
    progs, scopes, exes = {}, {}, {}
    for fluid in (jfluid, pt):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            targets = build(fluid)
        progs[fluid] = (main, targets)
        scopes[fluid] = _ex(fluid).Scope()
        exes[fluid] = fluid.Executor(fluid.CPUPlace())
    # both start from the port's startup persistables: the JAX package's
    # startup program compiles about as long as its training step
    exes[pt].run(startup, scope=scopes[pt])
    for n, v in startup.global_block().desc.vars.items():
        if v.persistable and scopes[pt].find_var(n) is not None:
            scopes[jfluid].set_var(n, np.asarray(scopes[pt].find_var(n)))
    persist = [n for n, v in progs[jfluid][0].global_block().desc.vars.items()
               if v.persistable]
    out = {jfluid: [], pt: []}
    for _ in range(steps):
        js = scopes[jfluid]
        pt.interop.load_numpy_params(
            scopes[pt], {n: np.asarray(js.find_var(n)) for n in persist
                         if js.find_var(n) is not None}, "cpu")
        for fluid in (jfluid, pt):
            main, targets = progs[fluid]
            v, = exes[fluid].run(main, feed=feeds(fluid), fetch_list=targets,
                                 scope=scopes[fluid])
            out[fluid].append(float(np.asarray(v).reshape(-1)[0]))
    return out[jfluid], out[pt]


def assert_same(want, got, tol=F32):
    for w_step, g_step in zip(want, got):
        assert len(w_step) == len(g_step)
        for (w, wl), (g, gl) in zip(w_step, g_step):
            assert w.shape == g.shape, (w.shape, g.shape)
            assert wl == gl
            if np.issubdtype(w.dtype, np.floating):
                np.testing.assert_allclose(g, w, **tol)
            else:
                np.testing.assert_array_equal(g.astype(np.int64),
                                              w.astype(np.int64))


def dense(fluid, name, arr):
    return fluid.layers.data(name=name, shape=list(arr.shape),
                             dtype=str(arr.dtype), append_batch_size=False)


def boxes_like(n, rng=RNG):
    lo = rng.rand(n, 2).astype(np.float32) * 0.6
    return np.concatenate([lo, lo + 0.1 + rng.rand(n, 2) * 0.3],
                          1).astype(np.float32)


# --- the ops ---------------------------------------------------------------------

@pytest.mark.parametrize("flip,clip,steps", [(True, False, None),
                                             (False, True, [8.0, 12.0])])
def test_prior_box(flip, clip, steps):
    feat = np.zeros((1, 8, 3, 2), np.float32)
    img = np.zeros((1, 3, 32, 24), np.float32)

    def build(fluid):
        f = fluid.layers.data(name="f", shape=[8, 3, 2], dtype="float32")
        im = fluid.layers.data(name="im", shape=[3, 32, 24], dtype="float32")
        return list(fluid.layers.detection.prior_box(
            f, im, [4.0, 10.0], [9.0, 20.0], [2.0, 3.0],
            [0.1, 0.1, 0.2, 0.2], flip=flip, clip=clip, steps=steps))
    want, got = run_both(build, lambda fl: {"f": feat, "im": img})
    assert want[0][0][0].shape == (3, 2, 12 if flip else 8, 4)
    for (w, _), (g, _) in zip(want[0], got[0]):
        np.testing.assert_array_equal(g, w)


def test_iou_similarity_dense_and_padded_lod():
    x, y = boxes_like(4), boxes_like(3)
    rows = [boxes_like(3), boxes_like(1)]

    def build(fluid):
        xv, yv = dense(fluid, "x", x), dense(fluid, "y", y)
        g = fluid.layers.data(name="g", shape=[4], dtype="float32",
                              lod_level=1)
        return [fluid.layers.detection.iou_similarity(xv, yv),
                fluid.layers.detection.iou_similarity(g, yv)]
    want, got = run_both(build, lambda fl: {"x": x, "y": y,
                                            "g": make_lod(fl, rows)})
    assert_same(want, got)


def test_box_coder_encode_decode():
    p = np.array([[0.1, 0.1, 0.5, 0.5], [0.2, 0.3, 0.7, 0.8]], np.float32)
    pv = np.tile(np.array([0.1, 0.1, 0.2, 0.2], np.float32), (2, 1))
    t = np.array([[0.15, 0.2, 0.4, 0.6], [0.3, 0.1, 0.9, 0.5]], np.float32)
    codes = RNG.randn(3, 2, 4).astype(np.float32) * 0.5

    def build(fluid):
        D = fluid.layers.detection
        pb, pbv, tb = dense(fluid, "p", p), dense(fluid, "pv", pv), \
            dense(fluid, "t", t)
        cv = dense(fluid, "c", codes)
        enc = D.box_coder(pb, pbv, tb, "encode_center_size")
        return [enc, D.box_coder(pb, pbv, enc, "decode_center_size"),
                D.box_coder(pb, pbv, cv, "decode_center_size")]
    want, got = run_both(build, lambda fl: {"p": p, "pv": pv, "t": t,
                                            "c": codes})
    assert_same(want, got)


def test_bipartite_match_lod():
    rows = [RNG.rand(3, 5).astype(np.float32),
            RNG.rand(2, 5).astype(np.float32)]

    def build(fluid):
        d = fluid.layers.data(name="d", shape=[5], dtype="float32",
                              lod_level=1)
        return list(fluid.layers.detection.bipartite_match(d))
    want, got = run_both(build, lambda fl: {"d": make_lod(fl, rows)})
    assert_same(want, got)


@pytest.mark.parametrize("match_type", ["bipartite", "per_prediction"])
def test_bipartite_match_ties(match_type):
    """Equal entries everywhere: each round must take the first maximum
    in row-major order, and per_prediction the first best row."""
    dist = np.array([[0.5, 0.5, 0.2, 0.7, 0.7],
                     [0.5, 0.7, 0.5, 0.7, 0.1],
                     [0.7, 0.5, 0.5, 0.2, 0.6]], np.float32)

    def build(fluid):
        d = dense(fluid, "d", dist)
        return list(fluid.layers.detection.bipartite_match(
            d, match_type=match_type, dist_threshold=0.5))
    want, got = run_both(build, lambda fl: {"d": dist})
    assert_same(want, got)


def test_per_prediction_oracle():
    dist = np.array([[0.8, 0.2, 0.6], [0.3, 0.7, 0.65]], np.float32)

    def build(fluid):
        return list(fluid.layers.detection.bipartite_match(
            dense(fluid, "d", dist), match_type="per_prediction",
            dist_threshold=0.5))
    want, got = run_both(build, lambda fl: {"d": dist})
    assert_same(want, got)
    np.testing.assert_array_equal(got[0][0][0][0], [0, 1, 1])


@pytest.mark.parametrize("rank", [3, 4])
def test_target_assign(rank):
    x = RNG.rand(2, 3, 4).astype(np.float32) if rank == 3 else \
        RNG.rand(2, 3, 4, 2).astype(np.float32)
    match = np.array([[0, -1, 2, 1], [-1, 1, -1, 0]], np.int32)

    def build(fluid):
        return list(fluid.layers.detection.target_assign(
            dense(fluid, "x", x), dense(fluid, "m", match),
            mismatch_value=0))
    want, got = run_both(build, lambda fl: {"x": x, "m": match})
    assert_same(want, got)


@pytest.mark.parametrize("mining_type", ["max_negative", "hard_example"])
def test_mine_hard_examples_with_ties_then_assign(mining_type):
    """Equal losses among the eligible priors: the stable rank must keep
    the lower prior index first, as jnp.argsort(-x, stable=True); the
    negatives then weight target_assign through their @SEQLEN."""
    b, p = 3, 10
    loss = np.round(RNG.rand(b, p, 1) * 3).astype(np.float32) / 3
    match = np.full((b, p), -1, np.int32)
    match[0, [1, 4]] = [0, 1]
    match[1, 7] = 0
    match[2, [0, 2, 5]] = [0, 1, 2]
    mdist = RNG.rand(b, p).astype(np.float32)
    mdist[match == -1] = np.round(mdist[match == -1] * 2) / 4
    labels = RNG.randint(1, 5, (b, 3, 1)).astype(np.int32)

    def build(fluid):
        D = fluid.layers.detection
        lv, mv, dv = dense(fluid, "l", loss), dense(fluid, "m", match), \
            dense(fluid, "d", mdist)
        neg, upd = D.mine_hard_examples(
            lv, mv, dv, neg_pos_ratio=2.0, neg_dist_threshold=0.4,
            mining_type=mining_type, sample_size=4)
        tgt, wt = D.target_assign(dense(fluid, "g", labels), upd,
                                  negative_indices=neg, mismatch_value=0)
        return [neg, upd, tgt, wt]
    want, got = run_both(build, lambda fl: {"l": loss, "m": match,
                                            "d": mdist, "g": labels})
    assert_same(want, got)


def _nms_inputs(b, c, p, ties=False, rng=RNG):
    boxes = np.stack([boxes_like(p, rng) for _ in range(b)])
    scores = rng.rand(b, c, p).astype(np.float32)
    if ties:
        scores = np.round(scores * 4) / 4
    return boxes, scores


@pytest.mark.parametrize("case", [
    dict(b=1, c=3, p=6, kw=dict(score_threshold=0.1, nms_threshold=0.4,
                                keep_top_k=4)),
    dict(b=2, c=4, p=12, ties=True,
         kw=dict(score_threshold=0.2, nms_threshold=0.3, nms_top_k=5,
                 keep_top_k=6)),
    dict(b=2, c=3, p=9, ties=True,
         kw=dict(score_threshold=0.0, nms_threshold=0.5, nms_top_k=-1,
                 keep_top_k=-1, background_label=-1)),
    dict(b=1, c=2, p=5, kw=dict(score_threshold=0.01, nms_top_k=0,
                                keep_top_k=3))])
def test_multiclass_nms(case):
    """Rows and LoD counts (labels and counts exact): the reference
    test's case, then tied scores with nms_top_k cutting the sorted list,
    no background class, and nms_top_k 0 (no candidate)."""
    boxes, scores = _nms_inputs(case["b"], case["c"], case["p"],
                                case.get("ties", False))

    def build(fluid):
        return [fluid.layers.detection.multiclass_nms(
            dense(fluid, "b", boxes), dense(fluid, "s", scores),
            **case["kw"])]
    want, got = run_both(build, lambda fl: {"b": boxes, "s": scores})
    assert_same(want, got)


def test_multiclass_nms_matches_the_oracle():
    """The reference test's oracle: per-class greedy NMS (class 0 left
    out), the best keep_top_k by score."""
    from test_detection_ops import nms_oracle
    p, c = 6, 3
    boxes, scores = _nms_inputs(1, c, p)

    def build(fluid):
        return [fluid.layers.detection.multiclass_nms(
            dense(fluid, "b", boxes), dense(fluid, "s", scores),
            background_label=0, score_threshold=0.1, nms_threshold=0.4,
            keep_top_k=4)]
    _, got = run_both(build, lambda fl: {"b": boxes, "s": scores})
    rows, lod = got[0][0]
    cand = sorted([(cls, scores[0, cls, i], i) for cls in range(1, c)
                   for i in nms_oracle(boxes[0], scores[0, cls], 0.1, 0.4,
                                       -1)], key=lambda t: -t[1])[:4]
    assert lod[0][1] - lod[0][0] == len(cand)
    for row, (cls, sc, i) in zip(rows.reshape(-1, 6), cand):
        assert int(row[0]) == cls
        np.testing.assert_allclose(row[1], sc, rtol=1e-6)
        np.testing.assert_allclose(row[2:], boxes[0, i], rtol=1e-6)


def _map_case():
    gt = np.array([[[1, 0, 0.1, 0.1, 0.4, 0.4],
                    [2, 0, 0.5, 0.5, 0.9, 0.9]]], np.float32)
    perfect = np.array([[[1, 0.9, 0.1, 0.1, 0.4, 0.4],
                         [2, 0.8, 0.5, 0.5, 0.9, 0.9]]], np.float32)
    half = np.array([[[1, 0.9, 0.1, 0.1, 0.4, 0.4],
                      [2, 0.8, 0.0, 0.0, 0.05, 0.05]]], np.float32)
    return gt, perfect, half


@pytest.mark.parametrize("ap_version", ["integral", "11point"])
def test_detection_map(ap_version):
    gt, perfect, half = _map_case()

    def build(fluid):
        g = dense(fluid, "g", gt)
        return [fluid.layers.detection.detection_map(
            dense(fluid, n, a), g, overlap_threshold=0.5,
            ap_version=ap_version) for n, a in (("d1", perfect),
                                                 ("d2", half))]
    pt_executor.COUNTERS.reset()
    want, got = run_both(build, lambda fl: {"g": gt, "d1": perfect,
                                            "d2": half})
    assert_same(want, got)
    np.testing.assert_allclose(got[0][0][0], [1.0], atol=1e-6)
    assert pt_executor.COUNTERS.host_syncs == {"detection_map": 2}


def test_detection_map_runs_eager_on_the_card():
    """A block holding detection_map runs eager under "host_metric" (a
    replay would return the value computed at capture); the gate asked as
    on a CUDA place."""
    gt, perfect, _ = _map_case()
    exe = pt.Executor(pt.CPUPlace())
    exe.device = torch.device("cuda", 0)
    main = pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, pt.Program()):
        pt.layers.detection.detection_map(dense(pt, "d", perfect),
                                          dense(pt, "g", gt))
    assert exe.graph_gate(main, {"d": None, "g": None}) == "host_metric"
    assert pt_executor.HOST_METRIC_OPS == {"detection_map"}


# --- the nets --------------------------------------------------------------------

def test_tiny_ssd_trains_as_the_jax_package():
    """tests/test_detection_ops.py's tiny SSD (multi_box_head over two
    maps, ssd_loss, SGD 0.1): eight steps' losses in both packages from
    the same weights, the loss falling."""
    b, c = 2, 4
    img = RNG.rand(b, 3, 32, 32).astype(np.float32)
    gt_boxes = [np.array([[0.1, 0.1, 0.45, 0.45]], np.float32),
                np.array([[0.5, 0.5, 0.9, 0.9], [0.2, 0.6, 0.5, 0.95]],
                         np.float32)]
    gt_labels = [np.array([[1]], np.int64), np.array([[2], [3]], np.int64)]

    def build(fluid):
        L = fluid.layers
        im = L.data(name="img", shape=[3, 32, 32], dtype="float32")
        gb = L.data(name="gt_box", shape=[4], dtype="float32", lod_level=1)
        gl = L.data(name="gt_label", shape=[1], dtype="int64", lod_level=1)
        c1 = L.conv2d(im, num_filters=8, filter_size=3, stride=2, padding=1,
                      act="relu")
        c2 = L.conv2d(c1, num_filters=8, filter_size=3, stride=2, padding=1,
                      act="relu")
        loc, conf, boxes, variances = L.detection.multi_box_head(
            inputs=[c1, c2], image=im, base_size=32, num_classes=c,
            aspect_ratios=[[2.0], [2.0]], min_sizes=[4.0, 8.0],
            max_sizes=[8.0, 16.0], flip=True, clip=True)
        avg = L.reduce_mean(L.detection.ssd_loss(loc, conf, gb, gl, boxes,
                                                 variances))
        fluid.optimizer.SGDOptimizer(learning_rate=0.1).minimize(avg)
        return [avg]
    want, got = run_both(build, lambda fl: {
        "img": img, "gt_box": make_lod(fl, gt_boxes),
        "gt_label": make_lod(fl, gt_labels)}, steps=8)
    assert_same(want, got, CONV)
    losses = [s[0][0].item() for s in got]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


SMALL_SSD = dict(chip_smoke.SSD, img=64, batch=8, scale=0.125, classes=5)
# The MobileNet-SSD's 35 batch norms, the last ones over 1x1 maps, compound
# the two packages' rounding layer by layer (the difference grows about
# 1.4x a layer, from 2e-7 relative after the first to ~2e-4 at the heads):
# its head outputs are held at rtol 1e-3 / atol 1e-3. Its losses, each step
# from the same weights, stay within the conv tolerance.
DEEP = dict(rtol=1e-3, atol=1e-3)


def _ssd_feed(fluid, seed):
    feed, _, _ = chip_smoke.ssd_batch(np.random.default_rng(seed),
                                      _ex(fluid).LoDTensor,
                                      SMALL_SSD["batch"], SMALL_SSD)
    return feed


def test_mobilenet_ssd_losses_match():
    """chip_smoke's MobileNet-SSD net at width 1/8 and 64x64 (six maps of
    4x4 down to 1x1), f32, Momentum at the configuration's lr: three
    steps in lockstep (the port from the JAX package's weights before
    each step, since hard-negative mining over a random net's
    near-uniform scores turns rounding into other selections once the
    weights drift apart), each loss within the conv tolerance, the
    losses finite and falling."""
    def build(fluid):
        _, loss, _ = chip_smoke.ssd_train_net(fluid, SMALL_SSD, amp=False)
        return [loss]
    want, got = lockstep(build, lambda fl: _ssd_feed(fl, 3), 3)
    np.testing.assert_allclose(got, want, **CONV)
    assert np.isfinite(got).all() and got[-1] < got[0]


def test_mobilenet_ssd_detection_output_and_map():
    """chip_smoke's detect net at the same narrow width, in two parts: the
    head's loc, conf, priors and variances from the same weights within
    the deep-net tolerance; then detection_output on those same head outputs
    (the JAX package's) in both packages: rows and counts, labels and
    counts exact, scores and boxes within the op tolerance (a random net's
    scores lie close together, so the backbone's own rounding would
    reorder near ties between the packages). Then metrics.DetectionMAP
    over three batches against the JAX package's."""
    cfg = dict(SMALL_SSD, nms_threshold=0.45)
    feed, boxes, labels = chip_smoke.ssd_batch(
        np.random.default_rng(11), jax_executor.LoDTensor, cfg["batch"], cfg)

    def head(fluid):
        img = fluid.layers.data(name="image", shape=[3, cfg["img"],
                                                     cfg["img"]],
                                dtype="float32")
        return list(chip_smoke.mobilenet_ssd(fluid, img, cfg["classes"],
                                             cfg["scale"]))
    want, got = run_both(head, lambda fl: {"image": feed["image"]})
    assert_same(want, got, DEEP)
    outs = {n: w for n, (w, _) in zip(("loc", "conf", "pb", "pbv"), want[0])}

    def detect(fluid):
        v = {n: dense(fluid, n, a) for n, a in outs.items()}
        return [fluid.layers.detection.detection_output(
            v["loc"], v["conf"], v["pb"], v["pbv"],
            nms_threshold=cfg["nms_threshold"])]
    want, got = run_both(detect, lambda fl: outs)
    (wrows, wlod), = want[0]
    (grows, glod), = got[0]
    assert glod == wlod and glod[0][-1] > 0
    np.testing.assert_array_equal(grows[:, 0], wrows[:, 0])
    np.testing.assert_allclose(grows[:, 1:], wrows[:, 1:], **F32)

    from paddle_tpu import metrics as jmetrics
    jm, pm = jmetrics.DetectionMAP(), pt.metrics.DetectionMAP()
    rng = np.random.default_rng(4)
    b = cfg["batch"]
    g = np.zeros((b, cfg["max_boxes"], 6), np.float32)
    gc = np.array([len(bx) for bx in boxes])
    for i, (bx, lb) in enumerate(zip(boxes, labels)):
        g[i, :len(bx), 0] = lb[:, 0]
        g[i, :len(bx), 2:] = bx
    counts = np.diff(glod[0])
    for k in range(3):
        dets = np.zeros((b, int(counts.max()), 6), np.float32)
        for i in range(b):
            dets[i, :counts[i]] = grows[glod[0][i]:glod[0][i + 1]]
        # a few of the detections made hits: moved onto a ground truth
        for i in range(b):
            dets[i, 0, 0] = g[i, 0, 0]
            dets[i, 0, 2:] = np.clip(g[i, 0, 2:] + rng.normal(
                0, 0.02 * k, 4), 0, 1)
        for m in (jm, pm):
            m.update(dets, counts, g, gc)
    assert pm.eval() == jm.eval() and pm.eval() > 0


def test_metrics_accuracy_and_composite():
    from paddle_tpu import metrics as jmetrics
    batches = [(0.5, 4), (0.75, 8), (1.0, 2)]
    for mod in (jmetrics, pt.metrics):
        acc = mod.Accuracy()
        comp = mod.CompositeMetric()
        comp.add_metric(mod.Accuracy())
        comp.add_metric(mod.EditDistance())
        for v, w in batches:
            acc.update(np.array([v], np.float32), w)
            comp.update((np.array([v]), w), (np.array([0.0, 2.0, 1.0]), 3))
        if mod is jmetrics:
            want = (acc.eval(), comp.eval())
        else:
            assert (acc.eval(), comp.eval()) == want
    with pytest.raises(ValueError):
        pt.metrics.Accuracy().eval()
    assert set(jmetrics.__all__) == set(pt.metrics.__all__)


@pytest.mark.parametrize("split", ["train", "test", "val"])
def test_voc2012_surrogate_is_the_jax_packages(split):
    from paddle_tpu.dataset import voc2012 as jvoc
    mine = list(getattr(pt.dataset.voc2012, split)()())
    theirs = list(getattr(jvoc, split)()())
    assert len(mine) == len(theirs) > 0
    for (a, b), (c, d) in zip(mine, theirs):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
        assert a.dtype == np.float32 and b.dtype == np.int32


def test_iou_and_box_coder_grads():
    """The two detection ops with a grad in the reference (the generic
    one): iou_similarity's X grad and box_coder's TargetBox grad, encode
    and decode, of a sum-of-squares loss."""
    x, y = boxes_like(4), boxes_like(3)
    p = boxes_like(3)
    codes = RNG.randn(2, 3, 4).astype(np.float32) * 0.3
    pvars = np.tile(np.array([0.1, 0.1, 0.2, 0.2], np.float32), (3, 1))

    def build(fluid):
        D, L = fluid.layers.detection, fluid.layers
        xv = fluid.layers.data(name="x", shape=[4, 4], dtype="float32",
                               append_batch_size=False, stop_gradient=False)
        cv = fluid.layers.data(name="c", shape=[2, 3, 4], dtype="float32",
                               append_batch_size=False, stop_gradient=False)
        yv, pv = dense(fluid, "y", y), dense(fluid, "p", p)
        pvar = dense(fluid, "pvar", pvars)
        outs = [D.iou_similarity(xv, yv),
                D.box_coder(pv, pvar, xv, "encode_center_size"),
                D.box_coder(pv, pvar, cv, "decode_center_size")]
        loss = L.sums([L.reduce_sum(L.square(o)) for o in outs])
        fluid.backward.append_backward(loss)
        return outs + ["x@GRAD", "c@GRAD"]
    want, got = run_both(build, lambda fl: {"x": x, "y": y, "p": p,
                                            "c": codes, "pvar": pvars})
    assert_same(want, got, CONV)
