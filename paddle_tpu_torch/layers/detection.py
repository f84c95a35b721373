"""SSD detection layers DSL, the port's copy of
paddle_tpu/layers/detection.py (reference: python/paddle/fluid/layers/
detection.py — detection_output :46, detection_map :157, bipartite_match
:208, target_assign :278, ssd_loss :350, multi_box_head :568, prior_box
via multi_box_head).

The same five-step SSD loss as the reference (match -> mine -> assign ->
loc/conf losses -> weighted sum), composed over the padded-batch detection
ops instead of LoD row routing: gt boxes and labels arrive padded
[B, G, ...] with @SEQLEN counts, and every per-prior target is a dense
gather, so a training step holding the loss reads nothing on the host and
is captured as one CUDA graph. Each layer emits the same ops, attrs and
names as the JAX package's."""

from __future__ import annotations

import numpy as np

import math

from ..layer_helper import LayerHelper
from . import control_flow as cf_layers
from . import nn
from . import ops as ops_layers
from . import tensor as tensor_layers

__all__ = [
    "prior_box", "iou_similarity", "box_coder", "bipartite_match",
    "target_assign", "mine_hard_examples", "ssd_loss", "detection_output",
    "multiclass_nms", "detection_map", "multi_box_head",
]


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=None,
              variance=None, flip=False, clip=False, steps=None,
              offset=0.5, name=None):
    """SSD prior boxes for one feature map (reference detection.py
    multi_box_head internals, prior_box_op.h). Returns (boxes [H, W, np, 4],
    variances same shape)."""
    helper = LayerHelper("prior_box")
    boxes = helper.create_tmp_variable("float32")
    variances = helper.create_tmp_variable("float32")
    # priors are coordinate constants derived from the feature-map SHAPE
    # (reference prior_box_op registers no grad); stating that here keeps
    # the silent-zero-grad check quiet about the feature-map input
    boxes.stop_gradient = True
    variances.stop_gradient = True
    steps = steps or [0.0, 0.0]
    helper.append_op(
        type="prior_box", inputs={"Input": [input], "Image": [image]},
        outputs={"Boxes": [boxes], "Variances": [variances]},
        attrs={"min_sizes": list(min_sizes),
               "max_sizes": list(max_sizes or []),
               "aspect_ratios": list(aspect_ratios or [1.0]),
               "variances": list(variance or [0.1, 0.1, 0.2, 0.2]),
               "flip": flip, "clip": clip,
               "step_w": steps[0], "step_h": steps[1], "offset": offset})
    return boxes, variances


def iou_similarity(x, y):
    helper = LayerHelper("iou_similarity")
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(type="iou_similarity", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]}, attrs={})
    return out


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", name=None):
    helper = LayerHelper("box_coder")
    out = helper.create_tmp_variable(target_box.dtype)
    helper.append_op(type="box_coder",
                     inputs={"PriorBox": [prior_box],
                             "PriorBoxVar": [prior_box_var],
                             "TargetBox": [target_box]},
                     outputs={"OutputBox": [out]},
                     attrs={"code_type": code_type})
    return out


def bipartite_match(dist_matrix, match_type="bipartite",
                    dist_threshold=0.5, name=None):
    """Greedy bipartite matching on a distance matrix (reference
    detection.py:208). Returns (match_indices [B, P], match_distance)."""
    helper = LayerHelper("bipartite_match")
    match_indices = helper.create_tmp_variable("int32")
    match_distance = helper.create_tmp_variable(dist_matrix.dtype)
    helper.append_op(type="bipartite_match",
                     inputs={"DistMat": [dist_matrix]},
                     outputs={"ColToRowMatchIndices": [match_indices],
                              "ColToRowMatchDist": [match_distance]},
                     attrs={"match_type": match_type,
                            "dist_threshold": dist_threshold})
    return match_indices, match_distance


def target_assign(input, matched_indices, negative_indices=None,
                  mismatch_value=0, name=None):
    """Assign per-prior targets by match index (reference detection.py:278).
    Returns (out, out_weight)."""
    helper = LayerHelper("target_assign")
    out = helper.create_tmp_variable(input.dtype)
    out_weight = helper.create_tmp_variable("float32")
    # assigned targets are training CONSTANTS (the reference registers no
    # grad for target_assign; loc/conf loss grads flow only through the
    # predictions) — marking them stop_gradient states that intent so the
    # silent-zero-grad check in append_backward doesn't flag them
    out.stop_gradient = True
    out_weight.stop_gradient = True
    inputs = {"X": [input], "MatchIndices": [matched_indices]}
    if negative_indices is not None:
        inputs["NegIndices"] = [negative_indices]
    helper.append_op(type="target_assign", inputs=inputs,
                     outputs={"Out": [out], "OutWeight": [out_weight]},
                     attrs={"mismatch_value": mismatch_value})
    return out, out_weight


def mine_hard_examples(cls_loss, match_indices, match_dist, loc_loss=None,
                       neg_pos_ratio=1.0, neg_dist_threshold=0.5,
                       mining_type="max_negative", sample_size=0):
    helper = LayerHelper("mine_hard_examples")
    neg_indices = helper.create_tmp_variable("int32")
    updated = helper.create_tmp_variable("int32")
    inputs = {"ClsLoss": [cls_loss], "MatchIndices": [match_indices],
              "MatchDist": [match_dist]}
    if loc_loss is not None:
        inputs["LocLoss"] = [loc_loss]
    helper.append_op(type="mine_hard_examples", inputs=inputs,
                     outputs={"NegIndices": [neg_indices],
                              "UpdatedMatchIndices": [updated]},
                     attrs={"neg_pos_ratio": neg_pos_ratio,
                            "neg_dist_threshold": neg_dist_threshold,
                            "mining_type": mining_type,
                            "sample_size": sample_size})
    return neg_indices, updated


def multiclass_nms(bboxes, scores, background_label=0, score_threshold=0.01,
                   nms_top_k=-1, nms_threshold=0.3, keep_top_k=-1,
                   nms_eta=1.0, name=None):
    helper = LayerHelper("multiclass_nms")
    out = helper.create_tmp_variable(bboxes.dtype)
    helper.append_op(type="multiclass_nms",
                     inputs={"BBoxes": [bboxes], "Scores": [scores]},
                     outputs={"Out": [out]},
                     attrs={"background_label": background_label,
                            "score_threshold": score_threshold,
                            "nms_top_k": nms_top_k,
                            "nms_threshold": nms_threshold,
                            "keep_top_k": keep_top_k, "nms_eta": nms_eta})
    return out


def detection_output(loc, scores, prior_box, prior_box_var,
                     background_label=0, nms_threshold=0.3, nms_top_k=400,
                     keep_top_k=200, score_threshold=0.01, nms_eta=1.0):
    """Decode predictions and run multi-class NMS (reference
    detection.py:46): loc [B, P, 4] codes, scores [B, P, C] (softmaxed
    here), priors [P, 4]. Returns padded [B, keep_top_k, 6] detections."""
    decoded = box_coder(prior_box=prior_box, prior_box_var=prior_box_var,
                        target_box=loc, code_type="decode_center_size")
    scores = ops_layers.softmax(scores)
    scores = nn.transpose(scores, perm=[0, 2, 1])
    return multiclass_nms(bboxes=decoded, scores=scores,
                          background_label=background_label,
                          score_threshold=score_threshold,
                          nms_top_k=nms_top_k, nms_threshold=nms_threshold,
                          keep_top_k=keep_top_k, nms_eta=nms_eta)


def detection_map(detect_res, label, overlap_threshold=0.3,
                  evaluate_difficult=True, ap_version="integral",
                  background_label=0, class_num=None):
    """Batch mAP metric (reference detection.py:157, detection_map_op.h).
    detect_res padded [B, D, 6] (label, score, box); label padded [B, G, 6]
    (label, difficult, box)."""
    helper = LayerHelper("detection_map")
    map_out = helper.create_tmp_variable("float32")
    helper.append_op(type="detection_map",
                     inputs={"DetectRes": [detect_res], "Label": [label]},
                     outputs={"MAP": [map_out]},
                     attrs={"overlap_threshold": overlap_threshold,
                            "evaluate_difficult": evaluate_difficult,
                            "ap_type": ap_version,
                            "background_label": background_label})
    return map_out


def ssd_loss(location, confidence, gt_box, gt_label, prior_box,
             prior_box_var=None, background_label=0, overlap_threshold=0.5,
             neg_pos_ratio=3.0, neg_overlap=0.5, loc_loss_weight=1.0,
             conf_loss_weight=1.0, match_type="per_prediction",
             mining_type="max_negative", normalize=True, sample_size=None):
    """SSD multibox loss (reference detection.py:350) — the five reference
    steps over padded batches:
      1. IoU(gt, priors) -> bipartite/per-prediction matching
      2. confidence loss on matched labels for mining
      3. hard-negative mining -> negative indices
      4. assign loc (encoded) + conf targets
      5. weighted smooth-L1 + softmax-CE, normalized by match count
    location [B, P, 4], confidence [B, P, C], gt_box padded LoD [B, G, 4],
    gt_label padded LoD [B, G, 1], prior_box [P, 4]. Returns [B, P, 1]
    per-prior weighted loss."""
    helper = LayerHelper("ssd_loss")
    if prior_box_var is None:
        pv_np = np.tile(np.array([0.1, 0.1, 0.2, 0.2], np.float32),
                        (prior_box.shape[0], 1))
        prior_box_var = tensor_layers.assign(pv_np)

    # 1. match
    iou = iou_similarity(x=gt_box, y=prior_box)
    matched_indices, matched_dist = bipartite_match(
        iou, match_type, overlap_threshold)

    # 2. conf loss on provisional targets, for mining
    gt_label_t, _ = target_assign(gt_label, matched_indices,
                                  mismatch_value=background_label)
    conf_loss_mine = nn.softmax_with_cross_entropy(confidence, gt_label_t)

    # 3. hard negative mining
    neg_indices, updated_indices = mine_hard_examples(
        cls_loss=conf_loss_mine, match_indices=matched_indices,
        match_dist=matched_dist, neg_pos_ratio=neg_pos_ratio,
        neg_dist_threshold=neg_overlap, mining_type=mining_type,
        sample_size=sample_size or 0)

    # 4. targets: encoded gt boxes per (gt, prior) pair, then per-prior picks
    encoded = box_coder(prior_box=prior_box, prior_box_var=prior_box_var,
                        target_box=gt_box, code_type="encode_center_size")
    loc_target, loc_weight = target_assign(encoded, updated_indices,
                                           mismatch_value=0)
    conf_target, conf_weight = target_assign(
        gt_label, updated_indices, negative_indices=neg_indices,
        mismatch_value=background_label)

    # 5. losses
    conf_loss = nn.softmax_with_cross_entropy(confidence, conf_target)
    conf_loss = nn.elementwise_mul(conf_loss, conf_weight)

    diff = nn.elementwise_sub(location, loc_target)
    abs_diff = ops_layers.abs(diff)
    one = tensor_layers.fill_constant(shape=[1], dtype="float32", value=1.0)
    sq = nn.scale(nn.elementwise_mul(diff, diff), scale=0.5)
    lin = nn.scale(abs_diff, scale=1.0, bias=-0.5)
    is_small = tensor_layers.cast(cf_layers.less_than(abs_diff, one),
                                 "float32")
    is_big = nn.scale(is_small, scale=-1.0, bias=1.0)
    l1 = nn.elementwise_add(nn.elementwise_mul(sq, is_small),
                            nn.elementwise_mul(lin, is_big))
    loc_loss = nn.reduce_sum(l1, dim=-1, keep_dim=True)
    loc_loss = nn.elementwise_mul(loc_loss, loc_weight)

    loss = nn.elementwise_add(
        nn.scale(loc_loss, scale=loc_loss_weight),
        nn.scale(conf_loss, scale=conf_loss_weight))
    if normalize:
        denom = nn.reduce_sum(loc_weight)
        denom = nn.elementwise_max(
            denom, tensor_layers.fill_constant(shape=[1], dtype="float32",
                                               value=1.0))
        loss = nn.elementwise_div(loss, denom, axis=0)
    return loss


def multi_box_head(inputs, image, base_size, num_classes, aspect_ratios,
                   min_ratio=None, max_ratio=None, min_sizes=None,
                   max_sizes=None, steps=None, step_w=None, step_h=None,
                   offset=0.5, variance=None, flip=False, clip=False,
                   kernel_size=1, pad=0, stride=1, name=None):
    """SSD detection head over multiple feature maps (reference
    detection.py:568): per-map loc/conf convs + prior boxes, concatenated.
    Returns (mbox_loc [B, total, 4], mbox_conf [B, total, C],
    boxes [total, 4], variances [total, 4])."""
    if min_sizes is None:
        # evenly spaced scales between min_ratio and max_ratio percent
        num_layer = len(inputs)
        min_sizes, max_sizes = [], []
        if num_layer > 2:
            step = int(math.floor((max_ratio - min_ratio) / (num_layer - 2)))
            for ratio in range(min_ratio, max_ratio + 1, step):
                min_sizes.append(base_size * ratio / 100.0)
                max_sizes.append(base_size * (ratio + step) / 100.0)
            min_sizes = [base_size * 0.1] + min_sizes
            max_sizes = [base_size * 0.2] + max_sizes
        else:
            min_sizes = [base_size * 0.2, base_size * 0.4]
            max_sizes = [base_size * 0.5, base_size * 0.8]

    locs, confs, prior_list, var_list = [], [], [], []
    for i, inp in enumerate(inputs):
        ms = min_sizes[i]
        mx = max_sizes[i] if max_sizes else None
        ar = aspect_ratios[i] if isinstance(aspect_ratios[i],
                                            (list, tuple)) else \
            [aspect_ratios[i]]
        st = steps[i] if steps else [step_w[i] if step_w else 0.0,
                                     step_h[i] if step_h else 0.0]
        if not isinstance(st, (list, tuple)):
            st = [st, st]
        boxes, variances = prior_box(
            inp, image, [ms] if not isinstance(ms, (list, tuple)) else ms,
            [mx] if mx and not isinstance(mx, (list, tuple)) else mx,
            ar, variance, flip, clip, st, offset)
        num_priors = boxes.shape[2]

        total = boxes.shape[0] * boxes.shape[1] * num_priors

        loc = nn.conv2d(inp, num_filters=num_priors * 4,
                        filter_size=kernel_size, padding=pad, stride=stride)
        # [B, np*4, H, W] -> [B, H, W, np*4] -> [B, H*W*np, 4]
        loc = nn.transpose(loc, perm=[0, 2, 3, 1])
        loc = nn.reshape(loc, shape=[-1, total, 4])
        locs.append(loc)

        conf = nn.conv2d(inp, num_filters=num_priors * num_classes,
                         filter_size=kernel_size, padding=pad, stride=stride)
        conf = nn.transpose(conf, perm=[0, 2, 3, 1])
        conf = nn.reshape(conf, shape=[-1, total, num_classes])
        confs.append(conf)

        prior_list.append(nn.reshape(boxes, shape=[-1, 4]))
        var_list.append(nn.reshape(variances, shape=[-1, 4]))

    mbox_loc = tensor_layers.concat(locs, axis=1)
    mbox_conf = tensor_layers.concat(confs, axis=1)
    boxes = tensor_layers.concat(prior_list, axis=0)
    variances = tensor_layers.concat(var_list, axis=0)
    return mbox_loc, mbox_conf, boxes, variances
