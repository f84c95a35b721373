"""SSD detection op family: prior_box, iou_similarity, box_coder,
bipartite_match, mine_hard_examples, target_assign, multiclass_nms,
detection_map (the port's counterpart of paddle_tpu/ops/detection_ops.py;
reference prior_box_op.h, iou_similarity_op.h, box_coder_op.h,
bipartite_match_op.cc, mine_hard_examples_op.cc, target_assign_op.h,
multiclass_nms_op.cc, detection_map_op.h).

Shapes are fixed as in the JAX package: ground truths arrive padded
[B, G, ...] with `@SEQLEN` counts (a LoD feed), the matching and NMS are
loops of a fixed trip count over the sorted candidates, batched over the
images (and the classes), and selections are compacted by stable sorts of
keep masks, so a training step or a served request holding them reads no
device value on the host and can be captured as a CUDA graph. Ties break
as the JAX package's: stable descending sorts keep the original order
among equal scores, and argmax takes the first maximum in row-major
order. detection_map is a host op (the JAX package's pure_callback): it
reads its inputs to the host, counted in `executor.COUNTERS.host_syncs`,
and a block holding it runs eager (`executor.HOST_METRIC_OPS`).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .common import in_var, seq_lengths, set_out
from .registry import NO_GRAD, op

_EPS = 1e-6


# --- prior_box ----------------------------------------------------------------

def _expand_aspect_ratios(ars, flip):
    out = [1.0]
    for ar in ars:
        if any(abs(ar - o) < 1e-6 for o in out):
            continue
        out.append(ar)
        if flip:
            out.append(1.0 / ar)
    return out


def _prior_box_infer(op_, block):
    iv = in_var(op_, block, "Input")
    if iv is None or iv.shape is None:
        return
    ars = _expand_aspect_ratios(op_.attr("aspect_ratios", [1.0]),
                                op_.attr("flip", False))
    num = len(ars) * len(op_.attr("min_sizes")) + \
        len(op_.attr("max_sizes", []) or [])
    h, w = iv.shape[2], iv.shape[3]
    set_out(op_, block, "Boxes", [h, w, num, 4], "float32")
    set_out(op_, block, "Variances", [h, w, num, 4], "float32")


@functools.lru_cache(maxsize=64)
def prior_boxes(fh, fw, ih, iw, min_sizes, max_sizes, ars, variances,
                step_w, step_h, offset, clip):
    """(boxes, variances) [fh, fw, num_priors, 4] f32 numpy, computed on
    the host once per shape and attrs (the JAX package makes them at trace
    time): per cell, each min size's square box, then the square box of
    sqrt(min * max), then one box per aspect ratio other than 1."""
    step_w = step_w or iw / fw
    step_h = step_h or ih / fh
    num = len(ars) * len(min_sizes) + len(max_sizes)
    boxes = np.zeros((fh, fw, num, 4), np.float32)
    for h in range(fh):
        for w in range(fw):
            cx = (w + offset) * step_w
            cy = (h + offset) * step_h
            idx = 0
            for s, ms in enumerate(min_sizes):
                bw = bh = ms / 2.0
                boxes[h, w, idx] = [(cx - bw) / iw, (cy - bh) / ih,
                                    (cx + bw) / iw, (cy + bh) / ih]
                idx += 1
                if max_sizes:
                    bw = bh = math.sqrt(ms * max_sizes[s]) / 2.0
                    boxes[h, w, idx] = [(cx - bw) / iw, (cy - bh) / ih,
                                        (cx + bw) / iw, (cy + bh) / ih]
                    idx += 1
                for ar in ars:
                    if abs(ar - 1.0) < 1e-6:
                        continue
                    bw = ms * math.sqrt(ar) / 2.0
                    bh = ms / math.sqrt(ar) / 2.0
                    boxes[h, w, idx] = [(cx - bw) / iw, (cy - bh) / ih,
                                        (cx + bw) / iw, (cy + bh) / ih]
                    idx += 1
    if clip:
        boxes = np.clip(boxes, 0.0, 1.0)
    vars_ = np.broadcast_to(np.asarray(variances, np.float32),
                            boxes.shape).copy()
    return boxes, vars_


@op("prior_box", infer_shape=_prior_box_infer, grad=NO_GRAD,
    non_diff_inputs=("Input", "Image"))
def _prior_box(ctx, op_, ins):
    """SSD prior (anchor) boxes of one feature map: a function of the
    feature map's and the image's shapes and the attrs alone, put on the
    device once (Executor.constant)."""
    feat, img = ins["Input"][0], ins["Image"][0]
    boxes, vars_ = prior_boxes(
        feat.shape[2], feat.shape[3], img.shape[2], img.shape[3],
        tuple(float(v) for v in op_.attr("min_sizes")),
        tuple(float(v) for v in (op_.attr("max_sizes", []) or [])),
        tuple(_expand_aspect_ratios(
            [float(a) for a in op_.attr("aspect_ratios", [1.0])],
            op_.attr("flip", False))),
        tuple(float(v) for v in op_.attr("variances", [0.1, 0.1, 0.2, 0.2])),
        float(op_.attr("step_w", 0.0)), float(op_.attr("step_h", 0.0)),
        float(op_.attr("offset", 0.5)), bool(op_.attr("clip", False)))
    const = ctx.executor.constant
    return {"Boxes": [const(boxes, torch.float32)],
            "Variances": [const(vars_, torch.float32)]}


# --- iou_similarity -----------------------------------------------------------

def _iou_infer(op_, block):
    xv = in_var(op_, block, "X")
    yv = in_var(op_, block, "Y")
    if xv is not None and xv.shape is not None and yv is not None \
            and yv.shape is not None:
        set_out(op_, block, "Out", [xv.shape[0], yv.shape[0]], xv.dtype)


def pairwise_iou(x, y):
    """IoU of every row of x [..., N, 4] with every row of y [..., M, 4]
    -> [..., N, M]."""
    x = x[..., :, None, :]
    y = y[..., None, :, :]
    iw = torch.clamp(torch.minimum(x[..., 2], y[..., 2])
                     - torch.maximum(x[..., 0], y[..., 0]), min=0.0)
    ih = torch.clamp(torch.minimum(x[..., 3], y[..., 3])
                     - torch.maximum(x[..., 1], y[..., 1]), min=0.0)
    inter = iw * ih
    a1 = (x[..., 2] - x[..., 0]) * (x[..., 3] - x[..., 1])
    a2 = (y[..., 2] - y[..., 0]) * (y[..., 3] - y[..., 1])
    return inter / torch.clamp(a1 + a2 - inter, min=_EPS)


@op("iou_similarity", infer_shape=_iou_infer, non_diff_inputs=("Y",))
def _iou_similarity(ctx, op_, ins):
    """Pairwise Jaccard overlap of X [N, 4] or a padded LoD batch
    [B, G, 4] (rows past an image's count are garbage the consumers mask
    through @SEQLEN) with Y [M, 4]."""
    return {"Out": [pairwise_iou(ins["X"][0], ins["Y"][0])]}


# --- box_coder ----------------------------------------------------------------

def _box_coder_infer(op_, block):
    tv = in_var(op_, block, "TargetBox")
    pv = in_var(op_, block, "PriorBox")
    if tv is None or tv.shape is None or pv is None or pv.shape is None:
        return
    if op_.attr("code_type", "encode_center_size") == "encode_center_size":
        set_out(op_, block, "OutputBox",
                [tv.shape[0], pv.shape[0], 4], tv.dtype)
    else:
        set_out(op_, block, "OutputBox", list(tv.shape), tv.dtype)


@op("box_coder", infer_shape=_box_coder_infer,
    non_diff_inputs=("PriorBox", "PriorBoxVar"))
def _box_coder(ctx, op_, ins):
    """Boxes encoded against or decoded from the priors in center-size
    form: encode targets [..., G, 4] x priors [P, 4] -> [..., G, P, 4];
    decode codes [..., P, 4] aligned with the priors -> boxes."""
    t = ins["TargetBox"][0]
    p = ins["PriorBox"][0]
    pv = ins["PriorBoxVar"][0] if ins.get("PriorBoxVar") and \
        ins["PriorBoxVar"][0] is not None else torch.ones_like(p)
    pv = pv.reshape(-1, pv.shape[-1])
    p = p.reshape(-1, p.shape[-1])
    pw = p[:, 2] - p[:, 0]
    ph = p[:, 3] - p[:, 1]
    pcx = (p[:, 2] + p[:, 0]) / 2
    pcy = (p[:, 3] + p[:, 1]) / 2
    if op_.attr("code_type", "encode_center_size") == "encode_center_size":
        tcx = ((t[..., 2] + t[..., 0]) / 2)[..., None]
        tcy = ((t[..., 3] + t[..., 1]) / 2)[..., None]
        tw = (t[..., 2] - t[..., 0])[..., None]
        th = (t[..., 3] - t[..., 1])[..., None]
        out = torch.stack([
            (tcx - pcx) / pw / pv[:, 0],
            (tcy - pcy) / ph / pv[:, 1],
            torch.log(torch.abs(tw / pw)) / pv[:, 2],
            torch.log(torch.abs(th / ph)) / pv[:, 3]], dim=-1)
    else:
        tcx = pv[..., 0] * t[..., 0] * pw + pcx
        tcy = pv[..., 1] * t[..., 1] * ph + pcy
        tw = torch.exp(pv[..., 2] * t[..., 2]) * pw
        th = torch.exp(pv[..., 3] * t[..., 3]) * ph
        out = torch.stack([tcx - tw / 2, tcy - th / 2,
                           tcx + tw / 2, tcy + th / 2], dim=-1)
    return {"OutputBox": [out]}


# --- bipartite_match ----------------------------------------------------------

def _bipartite_infer(op_, block):
    dv = in_var(op_, block, "DistMat")
    if dv is not None and dv.shape is not None:
        if len(dv.shape) == 3:
            shape = [dv.shape[0], dv.shape[2]]
        else:
            shape = [1, dv.shape[1]]
        set_out(op_, block, "ColToRowMatchIndices", shape, "int32")
        set_out(op_, block, "ColToRowMatchDist", shape, "float32")


def _set_at(t, idx, val, ok):
    """t [B, L] with t[b, idx[b]] = val[b] where ok[b]."""
    idx = idx[:, None]
    cur = t.gather(1, idx)[:, 0]
    return t.scatter(1, idx, torch.where(ok, val, cur)[:, None])


def bipartite_match(dist, lens, match_type, overlap_threshold):
    """Greedy global-argmax matching (reference BipartiteMatch) of each
    image's rows (ground truths, the first `lens` valid) to its columns
    (priors), batched over the images: G rounds, each taking the largest
    entry left of every image (the first in row-major order, as
    jnp.argmax) whose row and column are both free and retiring them, while
    it is > 0. "per_prediction" then also matches each unmatched column
    to its best row where that clears `overlap_threshold`."""
    b, g, p = dist.shape
    dev = dist.device
    neg1 = torch.full((), -1.0, dtype=dist.dtype, device=dev)
    row_valid = torch.arange(g, device=dev)[None, :] < lens[:, None]
    dist = torch.where(row_valid[..., None], dist, neg1)
    match_idx = torch.full((b, p), -1, dtype=torch.int32, device=dev)
    match_dist = torch.zeros((b, p), dtype=dist.dtype, device=dev)
    row_used = torch.zeros((b, g), dtype=torch.bool, device=dev)
    flat_dist = dist.reshape(b, g * p)
    small = dist < _EPS
    for _ in range(g):
        masked = torch.where(row_used[:, :, None] | (match_idx[:, None, :] >= 0)
                             | small, neg1, dist).reshape(b, g * p)
        flat = torch.argmax(masked, dim=1)
        r = torch.div(flat, p, rounding_mode="floor")
        c = flat - r * p
        ok = masked.gather(1, flat[:, None])[:, 0] > 0.0
        match_idx = _set_at(match_idx, c, r.to(torch.int32), ok)
        match_dist = _set_at(match_dist, c,
                             flat_dist.gather(1, flat[:, None])[:, 0], ok)
        row_used = _set_at(row_used, r, torch.ones_like(ok), ok)
    if match_type == "per_prediction":
        best = torch.argmax(dist, dim=1).to(torch.int32)
        bestd = torch.amax(dist, dim=1)
        extra = (match_idx == -1) & (bestd >= overlap_threshold)
        match_idx = torch.where(extra, best, match_idx)
        match_dist = torch.where(extra, bestd, match_dist)
    return match_idx, match_dist


@op("bipartite_match", infer_shape=_bipartite_infer, grad=NO_GRAD)
def _bipartite_match(ctx, op_, ins):
    dist = ins["DistMat"][0]
    if dist.dim() == 2:
        dist = dist[None]
    lens = seq_lengths(ctx, op_, "DistMat", dist.shape[0], dist.shape[1])
    idx, d = bipartite_match(dist, lens, op_.attr("match_type", "bipartite"),
                             op_.attr("dist_threshold", 0.5))
    for slot in ("ColToRowMatchIndices", "ColToRowMatchDist"):
        for n in op_.desc.outputs.get(slot, []):
            ctx.set_seq_len(n, None)
    return {"ColToRowMatchIndices": [idx], "ColToRowMatchDist": [d]}


# --- mine_hard_examples -------------------------------------------------------

def _sort_desc(x, dim):
    """Indices of a descending sort that keeps the original order among
    equal values (jnp.argsort(-x, stable=True))."""
    return torch.sort(-x, dim=dim, stable=True).indices


@op("mine_hard_examples", grad=NO_GRAD)
def _mine_hard_examples(ctx, op_, ins):
    """Hard-negative mining (reference mine_hard_examples_op.cc): the
    eligible priors (for max_negative: unmatched, overlap under
    neg_dist_threshold) ranked by loss, the top num_pos * neg_pos_ratio
    (max_negative) or sample_size (hard_example) kept. NegIndices [B, P, 1]
    holds each image's kept prior indices ascending, its @SEQLEN their
    count."""
    cls_loss = ins["ClsLoss"][0]
    match_idx = ins["MatchIndices"][0].to(torch.int32)
    match_dist = ins["MatchDist"][0]
    if cls_loss.dim() == 3:
        cls_loss = cls_loss[..., 0]
    b, p = match_idx.shape
    dev = match_idx.device
    mining_type = op_.attr("mining_type", "max_negative")
    neg_pos_ratio = op_.attr("neg_pos_ratio", 1.0)
    loss = cls_loss
    if mining_type == "hard_example" and ins.get("LocLoss") and \
            ins["LocLoss"][0] is not None:
        ll = ins["LocLoss"][0]
        loss = loss + (ll[..., 0] if ll.dim() == 3 else ll)
    if mining_type == "max_negative":
        eligible = (match_idx == -1) & \
            (match_dist < op_.attr("neg_dist_threshold", 0.5))
        num_pos = torch.sum(match_idx != -1, dim=1)
        neg_sel = torch.minimum(
            (num_pos.to(torch.float32) * neg_pos_ratio).to(torch.int32),
            eligible.sum(dim=1).to(torch.int32))
    else:
        eligible = torch.ones_like(match_idx, dtype=torch.bool)
        neg_sel = torch.clamp(eligible.sum(dim=1).to(torch.int32),
                              max=op_.attr("sample_size", 0))
    masked = torch.where(eligible, loss,
                         torch.full((), float("-inf"), dtype=loss.dtype,
                                    device=dev))
    order = _sort_desc(masked, 1)
    ar = torch.arange(p, device=dev)
    rank = torch.empty_like(order).scatter_(1, order, ar.expand(b, p))
    selected = eligible & (rank < neg_sel[:, None])
    key = torch.where(selected, ar[None, :], torch.full_like(rank, p + 1))
    sorted_idx = torch.sort(key, dim=1).values
    neg_count = selected.sum(dim=1).to(torch.int32)
    neg_indices = torch.where(ar[None, :] < neg_count[:, None], sorted_idx,
                              torch.zeros_like(sorted_idx)).to(torch.int32)
    updated = match_idx
    if mining_type == "hard_example":
        updated = torch.where((match_idx > -1) & ~selected,
                              torch.full_like(match_idx, -1), match_idx)
    ctx.set_seq_len(op_.desc.outputs["NegIndices"][0], neg_count)
    for n in op_.desc.outputs.get("UpdatedMatchIndices", []):
        ctx.set_seq_len(n, None)
    return {"NegIndices": [neg_indices[..., None]],
            "UpdatedMatchIndices": [updated]}


# --- target_assign ------------------------------------------------------------

@op("target_assign", grad=NO_GRAD,
    non_diff_inputs=("X", "MatchIndices", "NegIndices"))
def _target_assign(ctx, op_, ins):
    """Per-prior targets gathered from each image's ground-truth rows by
    match index (reference target_assign_op.h): out[b, m] = X[b,
    match[b, m]] (X [B, G, K]) or X[b, match[b, m], m] (X [B, G, P, K],
    per-prior targets) where matched, weight 1; else mismatch_value,
    weight 0; the priors NegIndices lists (its first @SEQLEN entries)
    take weight 1 at mismatch_value."""
    x = ins["X"][0]
    match = ins["MatchIndices"][0].to(torch.int64)      # [B, M]
    mismatch = op_.attr("mismatch_value", 0)
    b, m = match.shape
    dev = match.device
    safe = match.clamp(0, x.shape[1] - 1)
    if x.dim() == 4:
        gathered = x[torch.arange(b, device=dev)[:, None], safe,
                     torch.arange(m, device=dev)[None, :], :]
    else:
        gathered = torch.take_along_dim(x, safe[..., None], dim=1)
    matched = (match > -1)[..., None]
    out = torch.where(matched, gathered,
                      torch.full_like(gathered, float(mismatch)))
    wt = matched.to(torch.float32)
    if ins.get("NegIndices") and ins["NegIndices"][0] is not None:
        neg = ins["NegIndices"][0].to(torch.int64)
        if neg.dim() == 3:
            neg = neg[..., 0]
        names = op_.desc.inputs.get("NegIndices", [])
        ncount = ctx.seq_len(names[0]) if names else None
        if ncount is None:
            ncount = torch.full((b,), neg.shape[1], dtype=torch.int32,
                                device=dev)
        valid = torch.arange(neg.shape[1], device=dev)[None, :] < \
            ncount[:, None]
        hit = torch.zeros((b, m + 1), dtype=torch.float32, device=dev)
        hit.scatter_(1, torch.where(valid, neg, torch.full_like(neg, m)), 1.0)
        wt = torch.where(hit[:, :m, None] > 0, torch.ones_like(wt), wt)
    for slot in ("Out", "OutWeight"):
        for n in op_.desc.outputs.get(slot, []):
            ctx.set_seq_len(n, None)
    return {"Out": [out], "OutWeight": [wt]}


# --- multiclass_nms -----------------------------------------------------------

def nms_keep(boxes, scores, score_threshold, nms_threshold, top_k):
    """Greedy NMS of every (image, class) at once (reference NMSFast):
    boxes [B, P, 4], scores [B, C, P] -> keep [B, C, P] bool in the
    original index space. Each class's candidates are sorted by score
    (stable); only the first `top_k` (all with -1) can be kept, so the
    loop walks those K = min(P, top_k) alone: step i keeps candidate i
    when its score clears `score_threshold` and no kept candidate before
    it overlaps it by more than `nms_threshold` (the candidates after i
    are not kept yet). K steps of a few launches each, whatever B and C."""
    b, c, p = scores.shape
    k = p if top_k <= -1 else min(p, top_k)
    keep_full = torch.zeros((b, c, p), dtype=torch.bool, device=scores.device)
    if k == 0:
        return keep_full
    order = _sort_desc(scores, -1)[..., :k]                      # [B, C, K]
    sscores = scores.gather(-1, order)
    sboxes = torch.take_along_dim(boxes[:, None], order[..., None], dim=2)
    valid = sscores > score_threshold
    over = pairwise_iou(sboxes, sboxes) > nms_threshold          # [B,C,K,K]
    keep = torch.zeros((b, c, k), dtype=torch.bool, device=scores.device)
    for i in range(k):
        suppressed = (over[..., i] & keep).any(dim=-1)
        keep[..., i] = valid[..., i] & ~suppressed
    return keep_full.scatter_(-1, order, keep)


def _nms_infer(op_, block):
    bv = in_var(op_, block, "BBoxes")
    sv = in_var(op_, block, "Scores")
    if bv is None or bv.shape is None or sv is None or sv.shape is None:
        return
    keep_top_k = op_.attr("keep_top_k", -1)
    cap = keep_top_k if keep_top_k > 0 else bv.shape[-2]
    batch = sv.shape[0] if len(sv.shape) == 3 else 1
    set_out(op_, block, "Out", [batch, cap, 6], bv.dtype)


@op("multiclass_nms", infer_shape=_nms_infer, grad=NO_GRAD)
def _multiclass_nms(ctx, op_, ins):
    """Multi-class NMS (reference multiclass_nms_op.cc): Scores [B, C, P],
    BBoxes [B, P, 4] shared by the classes (or [P, 4]). Out is padded
    [B, cap, 6] rows (label, score, x1, y1, x2, y2), the kept detections of
    every class but the background's by descending score (stable), zeros
    past each image's count; @SEQLEN the counts, at most cap = keep_top_k
    (P when -1)."""
    scores = ins["Scores"][0]
    boxes = ins["BBoxes"][0]
    if scores.dim() == 2:
        scores = scores[None]
    if boxes.dim() == 2:
        boxes = boxes[None]
    b, c, p = scores.shape
    bg = op_.attr("background_label", 0)
    keep_top_k = op_.attr("keep_top_k", -1)
    cap = keep_top_k if keep_top_k > 0 else p
    keeps = nms_keep(boxes, scores, op_.attr("score_threshold", 0.0),
                     op_.attr("nms_threshold", 0.3), op_.attr("nms_top_k", -1))
    if 0 <= bg < c:
        keeps[:, bg] = False
    flat_scores = torch.where(
        keeps, scores, torch.full((), float("-inf"), dtype=scores.dtype,
                                  device=scores.device)).reshape(b, c * p)
    counts = torch.clamp(keeps.reshape(b, -1).sum(dim=1), max=cap)
    order = _sort_desc(flat_scores, 1)[:, :cap]
    sel_class = torch.div(order, p, rounding_mode="floor")
    sel_idx = order - sel_class * p
    sel_score = flat_scores.gather(1, order)
    sel_box = torch.take_along_dim(boxes, sel_idx[..., None], dim=1)
    rows = torch.cat([sel_class.to(boxes.dtype)[..., None],
                      sel_score.to(boxes.dtype)[..., None], sel_box], dim=-1)
    rank_ok = torch.arange(order.shape[1], device=rows.device)[None, :] < \
        counts[:, None]
    rows = torch.where(rank_ok[..., None], rows, torch.zeros_like(rows))
    ctx.set_seq_len(op_.desc.outputs["Out"][0], counts.to(torch.int32))
    return {"Out": [rows]}


# --- detection_map ------------------------------------------------------------
# The host arithmetic is the port's own copy of the JAX package's numpy
# helpers (detection_ops.py:478-587), which follow the reference
# detection_map_op.h.

def _np_iou(a, b):
    ixmin = max(a[0], b[0]); iymin = max(a[1], b[1])
    ixmax = min(a[2], b[2]); iymax = min(a[3], b[3])
    if b[0] > a[2] or b[2] < a[0] or b[1] > a[3] or b[3] < a[1]:
        return 0.0
    inter = (ixmax - ixmin) * (iymax - iymin)
    a1 = (a[2] - a[0]) * (a[3] - a[1])
    a2 = (b[2] - b[0]) * (b[3] - b[1])
    return inter / max(a1 + a2 - inter, _EPS)


def detection_tp_fp(dets, det_counts, gts, gt_counts, overlap_threshold,
                    evaluate_difficult):
    """Per-class positive counts and (score, tp) / (score, fp) pairs of a
    batch (reference CalcTrueAndFalsePositive). dets [B, D, 6] rows
    (label, score, box), gts [B, G, 6] rows (label, difficult, box), each
    image's first counts valid. Images are independent, so the pairs of
    several batches merge (metrics.DetectionMAP)."""
    label_pos, tp, fp = {}, {}, {}
    for n in range(dets.shape[0]):
        for row in gts[n][:int(gt_counts[n])]:
            lab = int(row[0])
            if evaluate_difficult or not bool(abs(row[1]) > 1e-6):
                label_pos[lab] = label_pos.get(lab, 0) + 1
    for n in range(dets.shape[0]):
        gt_by_label, det_by_label = {}, {}
        for row in gts[n][:int(gt_counts[n])]:
            gt_by_label.setdefault(int(row[0]), []).append(row)
        for row in dets[n][:int(det_counts[n])]:
            det_by_label.setdefault(int(row[0]), []).append(row)
        for lab, rows in det_by_label.items():
            if lab not in gt_by_label:
                for row in rows:
                    tp.setdefault(lab, []).append((float(row[1]), 0))
                    fp.setdefault(lab, []).append((float(row[1]), 1))
                continue
            matched = gt_by_label[lab]
            visited = [False] * len(matched)
            for row in sorted(rows, key=lambda r: -r[1]):
                box = np.clip(row[2:6], 0.0, 1.0)
                score = float(row[1])
                overlaps = [_np_iou(box, m[2:6]) for m in matched]
                j = int(np.argmax(overlaps)) if overlaps else 0
                hit = 0
                if overlaps and overlaps[j] > overlap_threshold:
                    if not (evaluate_difficult or
                            not bool(abs(matched[j][1]) > 1e-6)):
                        continue
                    if not visited[j]:
                        hit = 1
                        visited[j] = True
                tp.setdefault(lab, []).append((score, hit))
                fp.setdefault(lab, []).append((score, 1 - hit))
    return label_pos, tp, fp


def map_from_tp_fp(label_pos, tp, fp, ap_type, background_label):
    """mAP of accumulated per-class pairs (reference CalcMAP): "11point"
    or "integral" AP per class with positives, averaged."""
    m_ap, count = 0.0, 0
    for lab, num_pos in label_pos.items():
        if lab == background_label or lab not in tp or num_pos == 0:
            continue
        tps = np.cumsum([x[1] for x in sorted(tp[lab], key=lambda x: -x[0])])
        fps = np.cumsum([x[1] for x in sorted(fp[lab], key=lambda x: -x[0])])
        prec = tps / np.maximum(tps + fps, 1)
        rec = tps / num_pos
        if ap_type == "11point":
            maxp = np.zeros(11)
            for j in range(11):
                mask = rec >= j / 10.0
                maxp[j] = prec[mask].max() if mask.any() else 0.0
            ap = maxp.sum() / 11.0
        else:
            ap, prev = 0.0, 0.0
            for pr, rc in zip(prec, rec):
                if abs(rc - prev) > 1e-6:
                    ap += pr * abs(rc - prev)
                prev = rc
        m_ap += ap
        count += 1
    return np.float32(m_ap / count if count else 0.0)


def detection_map_np(dets, det_counts, gts, gt_counts, overlap_threshold,
                     evaluate_difficult, ap_type, background_label):
    """The mAP of one batch on the host."""
    label_pos, tp, fp = detection_tp_fp(dets, det_counts, gts, gt_counts,
                                        overlap_threshold, evaluate_difficult)
    return map_from_tp_fp(label_pos, tp, fp, ap_type, background_label)


def _dmap_infer(op_, block):
    set_out(op_, block, "MAP", [1], "float32")


@op("detection_map", infer_shape=_dmap_infer, grad=NO_GRAD)
def _detection_map(ctx, op_, ins):
    """The batch's mAP, computed on the host as the reference's CPU-only
    kernel: DetectRes [B, D, 6] and Label [B, G, 6] with their @SEQLEN
    counts are read to the host (one sync, counted), MAP [1] goes back to
    the device."""
    det, gt = ins["DetectRes"][0], ins["Label"][0]
    if det.dim() == 2:
        det = det[None]
    if gt.dim() == 2:
        gt = gt[None]
    dcount = seq_lengths(ctx, op_, "DetectRes", det.shape[0], det.shape[1])
    gcount = seq_lengths(ctx, op_, "Label", gt.shape[0], gt.shape[1])
    ctx.host_sync(op_.type)
    host = [t.detach().float().cpu().numpy() if t.is_floating_point()
            else t.detach().cpu().numpy() for t in (det, dcount, gt, gcount)]
    m = detection_map_np(*host, op_.attr("overlap_threshold", 0.3),
                         op_.attr("evaluate_difficult", True),
                         op_.attr("ap_type", "integral"),
                         op_.attr("background_label", 0))
    for n in op_.desc.outputs.get("MAP", []):
        ctx.set_seq_len(n, None)
    return {"MAP": [torch.tensor([m], dtype=torch.float32, device=det.device)]}
