"""Extra NN ops: pad, maxout, row_conv, im2sequence, nce (the port's
counterpart of paddle_tpu/ops/extra_ops.py; reference pad_op.cc,
maxout_op.cc, row_conv_op.cc, im2sequence_op.cc, nce_op.cc)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import in_var, set_out
from .registry import NO_GRAD, cotangent, grad_op, op, zero_grads


def _pad_infer(op_, block):
    iv = in_var(op_, block, "X")
    p = op_.attr("paddings")
    if iv is not None and iv.shape is not None:
        shape = [None if d is None else d + p[2 * i] + p[2 * i + 1]
                 for i, d in enumerate(iv.shape)]
        set_out(op_, block, "Out", shape, iv.dtype)


@op("pad", infer_shape=_pad_infer)
def _pad(ctx, op_, ins):
    """Constant padding: `paddings` holds (before, after) per dim, first
    dim first; F.pad takes them last dim first."""
    x = ins["X"][0]
    p = op_.attr("paddings")
    flat = []
    for i in reversed(range(x.dim())):
        flat += [p[2 * i], p[2 * i + 1]]
    return {"Out": [F.pad(x, flat, value=op_.attr("pad_value", 0.0))]}


def _maxout_infer(op_, block):
    iv = in_var(op_, block, "X")
    g = op_.attr("groups")
    if iv is not None and iv.shape is not None:
        n, c, h, w = iv.shape
        set_out(op_, block, "Out", [n, None if c is None else c // g, h, w],
                iv.dtype)


@op("maxout", infer_shape=_maxout_infer)
def _maxout(ctx, op_, ins):
    """The max over each group of `groups` channels. amax's grad splits the
    cotangent evenly among tied maxima, as jnp.max's does."""
    x = ins["X"][0]
    g = op_.attr("groups")
    n, c, h, w = x.shape
    return {"Out": [torch.amax(x.reshape(n, c // g, g, h, w), dim=2)]}


@op("row_conv")
def _row_conv(ctx, op_, ins):
    """Lookahead row convolution: out[t] = sum_i x[t+i] * filter[i], the
    steps past the end zero. X is (T, D) or (N, T, D)."""
    x = ins["X"][0]
    w = ins["Filter"][0]                 # (k+1, D)
    squeeze = x.dim() == 2
    if squeeze:
        x = x[None]
    k = w.shape[0]
    t = x.shape[1]
    xp = F.pad(x, (0, 0, 0, k - 1))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + xp[:, i:i + t, :] * w[i]
    return {"Out": [out[0] if squeeze else out]}


@op("im2sequence", grad=NO_GRAD)
def _im2sequence(ctx, op_, ins):
    """Image patches as sequence rows, (N*OH*OW, C*kh*kw), channels the
    slowest within a row (lax.conv_general_dilated_patches' order, and
    F.unfold's). `paddings` is (top, left, bottom, right)."""
    x = ins["X"][0]
    kh, kw = op_.attr("kernels")
    sh, sw = op_.attr("strides", [1, 1])
    p = op_.attr("paddings", [0, 0, 0, 0])
    n = x.shape[0]
    xp = F.pad(x, (p[1], p[3], p[0], p[2]))
    cols = F.unfold(xp, (kh, kw), stride=(sh, sw))    # (N, C*kh*kw, L)
    return {"Out": [cols.transpose(1, 2).reshape(n * cols.shape[2],
                                                 cols.shape[1])]}


def _nce_infer(op_, block):
    xv = in_var(op_, block, "Input")
    if xv is not None and xv.shape is not None:
        set_out(op_, block, "Cost", [xv.shape[0], 1], xv.dtype)


def _nce_terms(x, w, b, labels):
    """(cost [N, 1], logits [N, 1+K]) of the true class, column 0 of
    `labels`, against the drawn negatives, the other columns."""
    logits = torch.einsum("nd,nkd->nk", x, w[labels])
    if b is not None:
        logits = logits + b[labels]
    pos, neg = logits[:, :1], logits[:, 1:]
    cost = torch.log1p(torch.exp(-pos)).sum(dim=1, keepdim=True) + \
        torch.log1p(torch.exp(neg)).sum(dim=1, keepdim=True)
    return cost, logits


def _nce_bias(ins):
    b = ins.get("Bias")
    return b[0].reshape(-1) if b and b[0] is not None else None


@op("nce", infer_shape=_nce_infer, non_diff_inputs=("Label", "SampleWeight"))
def _nce(ctx, op_, ins):
    """Noise-contrastive estimation: binary logistic loss of the true class
    against `num_neg_samples` classes drawn uniformly per row from the op's
    generator (ctx.generator, as dropout's mask: seeded per run, and drawn
    anew by a CUDA graph's replay; on a batch split over ranks, the global
    batch's negatives and this rank's rows). SampleWeight is taken and
    unused, as in the JAX package."""
    x = ins["Input"][0]
    label = ins["Label"][0].reshape(-1).to(torch.int64)
    w = ins["Weight"][0]
    num_classes = op_.attr("num_total_classes")
    num_neg = op_.attr("num_neg_samples", 10)
    def draw(rows):
        return torch.randint(0, num_classes, (rows, num_neg),
                             generator=ctx.generator(op_), device=x.device)
    spmd = getattr(ctx, "spmd", None)
    if spmd is not None and spmd.slot_split(op_, "Input"):
        # a batch split over ranks (parallel/spmd.py): the global batch's
        # negatives drawn, this rank's rows kept, as dropout's mask
        neg = spmd.global_rows(x.shape[0], draw)
    else:
        neg = draw(x.shape[0])
    labels = torch.cat([label[:, None], neg], dim=1)
    cost, logits = _nce_terms(x, w, _nce_bias(ins), labels)
    return {"Cost": [cost], "SampleLogits": [logits],
            "SampleLabels": [labels]}


@grad_op("nce")
def _nce_grad(ctx, op_, ins):
    """The grads from the forward's own SampleLabels: the cost recomputed
    from them under autograd, with no second draw (a re-run of the
    forward would draw other negatives inside a CUDA graph's capture)."""
    dcost = cotangent(ins, "Cost", ins["Cost"][0])
    if dcost is None:
        return zero_grads(op_, ins)
    wants = {s: s + "@GRAD" in op_.desc.outputs
             for s in ("Input", "Weight", "Bias")}
    with torch.enable_grad():
        leaves = {s: ins[s][0].detach().requires_grad_(True)
                  for s, on in wants.items() if on and ins.get(s)
                  and ins[s][0] is not None}
        x = leaves.get("Input", ins["Input"][0])
        w = leaves.get("Weight", ins["Weight"][0])
        b = leaves["Bias"].reshape(-1) if "Bias" in leaves \
            else _nce_bias(ins)
        cost, _ = _nce_terms(x, w, b, ins["SampleLabels"][0].to(torch.int64))
        grads = torch.autograd.grad([cost], list(leaves.values()), [dcost],
                                    allow_unused=True)
    outs = {}
    for (s, leaf), g in zip(leaves.items(), grads):
        outs[s + "@GRAD"] = [torch.zeros_like(leaf) if g is None else g]
    return outs
