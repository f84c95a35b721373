"""Evaluation metric ops: chunk_eval, precision_recall, positive_negative_pair
(the port's counterpart of paddle_tpu/ops/eval_ops.py; reference
chunk_eval_op.h, precision_recall_op.h, positive_negative_pair_op.h).

Dense forms of the reference's per-sample loops, as in the JAX package:
boundary flags and a row-wise running max for the chunks, one-hot sums for
the confusion states, a masked pairwise grid for the ranking pairs; all
on the device, no value read on the host.
"""

from __future__ import annotations

import torch

from .common import set_out
from .registry import NO_GRAD, op

# per-scheme tag ids, -1 = tag absent (reference chunk_eval_op.h:108-139)
_SCHEMES = {
    "IOB": dict(num_tags=2, begin=0, inside=1, end=-1, single=-1),
    "IOE": dict(num_tags=2, begin=-1, inside=0, end=1, single=-1),
    "IOBES": dict(num_tags=4, begin=0, inside=1, end=2, single=3),
    "plain": dict(num_tags=1, begin=-1, inside=-1, end=-1, single=-1),
}


def _shift(x, fill, right):
    """x shifted one step along the time axis, `fill` entering."""
    pad = torch.full_like(x[:, :1], fill)
    return torch.cat([pad, x[:, :-1]], 1) if right else \
        torch.cat([x[:, 1:], pad], 1)


def _chunk_flags(labels, valid, num_chunk_types, sc):
    """Per-position chunk begin and end flags and the chunk type of padded
    [B, T] label rows (JAX eval_ops.py:31, the reference's GetSegments
    state machine as adjacent-pair predicates)."""
    other = num_chunk_types
    tag = labels % sc["num_tags"]
    typ = torch.where(valid, labels // sc["num_tags"],
                      torch.full_like(labels, other))
    prev_tag, prev_typ = _shift(tag, -1, True), _shift(typ, other, True)
    next_tag, next_typ = _shift(tag, -1, False), _shift(typ, other, False)
    nonother = typ != other
    b, i, e, s = sc["begin"], sc["inside"], sc["end"], sc["single"]

    def same_type_begin(ptag, ctag):
        return ((ctag == b) & (b >= 0)) | ((ctag == s) & (s >= 0)) | \
            (((ctag == i) | (ctag == e)) & ((ptag == e) | (ptag == s))
             & (e >= 0))

    def same_type_end(ptag, ctag):
        return (((ptag == b) | (ptag == i)) &
                (((ctag == b) & (b >= 0)) | ((ctag == s) & (s >= 0)))) | \
            (((ptag == e) | (ptag == s)) & (e >= 0))

    begin = nonother & ((prev_typ == other) | (prev_typ != typ)
                        | same_type_begin(prev_tag, tag))
    end = nonother & ((next_typ == other) | (next_typ != typ)
                      | same_type_end(tag, next_tag))
    return begin, end, typ


def _chunk_start_idx(begin):
    """The start of the chunk covering each position: the running max of
    the positions where a chunk begins."""
    pos = torch.arange(begin.shape[1], device=begin.device)[None, :]
    marked = torch.where(begin, pos, torch.full_like(pos, -1))
    return torch.cummax(marked, dim=1).values


def _chunk_eval_infer(op_, block):
    for slot in ("Precision", "Recall", "F1-Score"):
        set_out(op_, block, slot, [1], "float32")
    for slot in ("NumInferChunks", "NumLabelChunks", "NumCorrectChunks"):
        set_out(op_, block, slot, [1], "int32")


@op("chunk_eval", infer_shape=_chunk_eval_infer, grad=NO_GRAD)
def _chunk_eval(ctx, op_, ins):
    """Chunking precision, recall and F1 (JAX eval_ops.py:95): Inference
    and Label padded [B, T] ints with their lengths; a correct chunk is an
    exactly matching (begin, end, type) span in both; excluded types leave
    the correct count only, as in the reference."""
    inf, lab = ins["Inference"][0], ins["Label"][0]
    if inf.dim() == 3:
        inf = inf[..., 0]
    if lab.dim() == 3:
        lab = lab[..., 0]
    b, t = inf.shape
    names = op_.desc.inputs.get("Label", [])
    lens = ctx.seq_len(names[0]) if names else None
    if lens is None:
        valid = torch.ones((b, t), dtype=torch.bool, device=inf.device)
    else:
        valid = torch.arange(t, device=inf.device)[None, :] < lens[:, None]
    nct = op_.attr("num_chunk_types")
    sc = _SCHEMES[op_.attr("chunk_scheme", "IOB")]
    ib, ie, ityp = _chunk_flags(inf.to(torch.int64), valid, nct, sc)
    lb, le, ltyp = _chunk_flags(lab.to(torch.int64), valid, nct, sc)
    correct = ie & le & (_chunk_start_idx(ib) == _chunk_start_idx(lb)) & \
        (ityp == ltyp)
    for ex in op_.attr("excluded_chunk_types", []) or []:
        correct = correct & (ityp != ex)
    n_inf = ib.sum().to(torch.int32)
    n_lab = lb.sum().to(torch.int32)
    n_cor = correct.sum().to(torch.int32)
    zero = torch.zeros((), dtype=torch.float32, device=inf.device)
    prec = torch.where(n_inf > 0, n_cor / n_inf.clamp(min=1), zero)
    rec = torch.where(n_lab > 0, n_cor / n_lab.clamp(min=1), zero)
    f1 = torch.where(n_cor > 0, 2 * prec * rec / (prec + rec).clamp(
        min=1e-12), zero)
    for names in op_.desc.outputs.values():
        for name in names:
            ctx.set_seq_len(name, None)
    return {"Precision": [prec.float()[None]], "Recall": [rec.float()[None]],
            "F1-Score": [f1.float()[None]], "NumInferChunks": [n_inf[None]],
            "NumLabelChunks": [n_lab[None]],
            "NumCorrectChunks": [n_cor[None]]}


def _pr_infer(op_, block):
    set_out(op_, block, "BatchMetrics", [6], "float32")
    set_out(op_, block, "AccumMetrics", [6], "float32")
    set_out(op_, block, "AccumStatesInfo", [op_.attr("class_number"), 4],
            "float32")


def _pr_metrics(states):
    """[C, 4] per-class TP/FP/TN/FN -> the macro and micro precision,
    recall and F1 (reference precision_recall_op.h ComputeMetrics)."""
    tp, fp, fn = states[:, 0], states[:, 1], states[:, 3]
    one = torch.ones((), dtype=states.dtype, device=states.device)

    def ratio(a, b):
        return torch.where(a + b > 0, a / (a + b).clamp(min=1e-12), one)

    def f1(p, r):
        return torch.where(p + r > 0, 2 * p * r / (p + r).clamp(min=1e-12),
                           torch.zeros_like(one))

    macro_p, macro_r = ratio(tp, fp).mean(), ratio(tp, fn).mean()
    micro_p, micro_r = ratio(tp.sum(), fp.sum()), ratio(tp.sum(), fn.sum())
    return torch.stack([macro_p, macro_r, f1(macro_p, macro_r),
                        micro_p, micro_r, f1(micro_p, micro_r)])


@op("precision_recall", infer_shape=_pr_infer, grad=NO_GRAD)
def _precision_recall(ctx, op_, ins):
    """Multi-class precision, recall and F1, accumulated across batches
    through StatesInfo (JAX eval_ops.py:178): Indices and Labels [N, 1],
    optional Weights [N, 1]."""
    idx = ins["Indices"][0].reshape(-1).to(torch.int64)
    lab = ins["Labels"][0].reshape(-1).to(torch.int64)
    cls_num = op_.attr("class_number")
    if ins.get("Weights") and ins["Weights"][0] is not None:
        w = ins["Weights"][0].reshape(-1).float()
    else:
        w = torch.ones(idx.shape[0], dtype=torch.float32, device=idx.device)
    oh_idx = torch.nn.functional.one_hot(idx, cls_num).float()
    oh_lab = torch.nn.functional.one_hot(lab, cls_num).float()
    hit = (idx == lab).float()
    tp = (oh_idx * (hit * w)[:, None]).sum(0)
    fp = (oh_idx * ((1 - hit) * w)[:, None]).sum(0)
    fn = (oh_lab * ((1 - hit) * w)[:, None]).sum(0)
    tn = w.sum() - tp - fp - fn
    batch = torch.stack([tp, fp, tn, fn], dim=1)
    accum = batch
    if ins.get("StatesInfo") and ins["StatesInfo"][0] is not None:
        accum = accum + ins["StatesInfo"][0].float()
    return {"BatchMetrics": [_pr_metrics(batch)],
            "AccumMetrics": [_pr_metrics(accum)],
            "AccumStatesInfo": [accum]}


def _pnp_infer(op_, block):
    for slot in ("PositivePair", "NegativePair", "NeutralPair"):
        set_out(op_, block, slot, [1], "float32")


@op("positive_negative_pair", infer_shape=_pnp_infer, grad=NO_GRAD)
def _positive_negative_pair(ctx, op_, ins):
    """Ranking pairs per query (JAX eval_ops.py:214): each same-query pair
    of different labels is positive when the scores order it as the labels
    do, else negative; a score tie is neutral and also negative, as the
    reference counts it; each pair weighs the mean of its two weights."""
    score = ins["Score"][0]
    label = ins["Label"][0].reshape(-1)
    query = ins["QueryID"][0].reshape(-1)
    s = score.reshape(score.shape[0], -1)[:, op_.attr("column", -1)]
    n = s.shape[0]
    if ins.get("Weight") and ins["Weight"][0] is not None:
        w = ins["Weight"][0].reshape(-1).float()
    else:
        w = torch.ones(n, dtype=torch.float32, device=s.device)
    upper = torch.ones((n, n), dtype=torch.bool, device=s.device).triu(1)
    pair = upper & (query[:, None] == query[None, :]) & \
        (label[:, None] != label[None, :])
    pw = (w[:, None] + w[None, :]) * 0.5
    ds = s[:, None] - s[None, :]
    dl = (label[:, None] - label[None, :]).to(s.dtype)
    tie = ds == 0
    pos = ((pair & (ds * dl > 0)).float() * pw).sum()
    tied = ((pair & tie).float() * pw).sum()
    neg = ((pair & ~tie & (ds * dl <= 0)).float() * pw).sum() + tied
    neu = tied
    if ins.get("AccumulatePositivePair") and \
            ins["AccumulatePositivePair"][0] is not None:
        pos = pos + ins["AccumulatePositivePair"][0].reshape(())
        neg = neg + ins["AccumulateNegativePair"][0].reshape(())
        neu = neu + ins["AccumulateNeutralPair"][0].reshape(())
    return {"PositivePair": [pos[None]], "NegativePair": [neg[None]],
            "NeutralPair": [neu[None]]}
