"""NN ops: softmax, conv2d and its explicit grad, pool2d, batch_norm, the
classifier heads (cross_entropy, softmax_with_cross_entropy, accuracy), the
embedding lookup, layer_norm, and scaled dot-product attention with its
explicit grad (the port's counterpart of paddle_tpu/ops/nn_ops.py;
reference softmax_op.cc, conv_op.cc, pool_op.cc, batch_norm_op.cc,
cross_entropy_op.cc, softmax_with_cross_entropy_op.cc, accuracy_op.cc,
lookup_table_op.cc, layer_norm_op.cc).

Layout: tensors are logical NCHW, as users see them. conv2d returns its
output in `torch.channels_last` memory, so the NHWC view the kernel reads
is a free permute and the conv/bn/pool stack stays NHWC in memory — the
role the JAX package gives its trace-time NHWC tags (ops/layout.py).
Elementwise ops, batch_norm and pooling preserve that memory format.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import quant
from ..framework.desc import OpDesc
from ..framework.framework import grad_var_name
from . import attention_cuda, conv_cuda
from .common import (CONV_FORMATS, SelectedRowsVal, in_var, mxu_cast,
                     same_as_input, set_out)
from .registry import (NO_GRAD, cotangent, generic_grad_lower, grad_op,
                       infer_grad_shapes, op, zero_grads)


# --- softmax and the classifier head ----------------------------------------

@op("softmax", infer_shape=same_as_input())
def _softmax(ctx, op_, ins):
    return {"Out": [torch.softmax(ins["X"][0], dim=-1)]}


def _ce_infer(op_, block):
    xv = in_var(op_, block, "X")
    if xv is not None and xv.shape is not None:
        set_out(op_, block, "Y", list(xv.shape[:-1]) + [1], xv.dtype)


@op("cross_entropy", infer_shape=_ce_infer, non_diff_inputs=("Label",))
def _cross_entropy(ctx, op_, ins):
    """-log of the probability of the label (nn_ops.py:40), the
    probabilities clipped at 1e-12; soft labels sum over the classes."""
    x, label = ins["X"][0], ins["Label"][0]
    if op_.attr("soft_label", False):
        loss = -torch.sum(label * torch.log(torch.clamp(x, min=1e-12)),
                          dim=-1, keepdim=True)
    else:
        idx = label.reshape(label.shape[0], -1)[:, :1].to(torch.int64)
        picked = torch.gather(x, -1, idx)
        loss = -torch.log(torch.clamp(picked, min=1e-12))
    return {"Y": [loss]}


def _swce_infer(op_, block):
    xv = in_var(op_, block, "Logits")
    if xv is not None and xv.shape is not None:
        set_out(op_, block, "Softmax", xv.shape, xv.dtype)
        set_out(op_, block, "Loss", list(xv.shape[:-1]) + [1], xv.dtype)


@op("softmax_with_cross_entropy", infer_shape=_swce_infer,
    non_diff_inputs=("Label",))
def _softmax_with_cross_entropy(ctx, op_, ins):
    # log-softmax in f32, as the JAX package does for bf16 logits
    logits = ins["Logits"][0].float()
    label = ins["Label"][0]
    logp = torch.log_softmax(logits, dim=-1)
    if op_.attr("soft_label", False):
        loss = -torch.sum(label * logp, dim=-1, keepdim=True)
    else:
        idx = label.to(torch.int64)
        if idx.dim() < logits.dim():
            idx = idx.unsqueeze(-1)
        elif idx.shape[-1] != 1:
            idx = idx[..., :1]
        loss = -torch.gather(logp, -1, idx)
    return {"Softmax": [torch.exp(logp)], "Loss": [loss]}


@grad_op("softmax_with_cross_entropy")
def _softmax_with_cross_entropy_grad(ctx, op_, ins):
    """dLogits from the forward's saved Softmax, in f32 as the forward's
    log-softmax: with g = dLogp (-dLoss at the label, or -label · dLoss
    for soft labels), dLogits = g - Softmax · Σ g, then Logits' dtype;
    the log-softmax is not computed again. A cotangent on Softmax takes
    the generic grad."""
    if ins.get("Softmax@GRAD") and ins["Softmax@GRAD"][0] is not None:
        return generic_grad_lower(ctx, op_, ins)
    logits, label = ins["Logits"][0], ins["Label"][0]
    dloss = cotangent(ins, "Loss", ins["Loss"][0])
    if dloss is None:
        return zero_grads(op_, ins)
    softmax = ins["Softmax"][0].float()
    dloss = dloss.float()
    if op_.attr("soft_label", False):
        g = -label.float() * dloss
    else:
        idx = label.to(torch.int64)
        if idx.dim() < logits.dim():
            idx = idx.unsqueeze(-1)
        elif idx.shape[-1] != 1:
            idx = idx[..., :1]
        g = torch.zeros_like(softmax).scatter_(-1, idx, -dloss)
    dx = g - softmax * g.sum(dim=-1, keepdim=True)
    return {"Logits@GRAD": [dx.to(logits.dtype)]}


def _accuracy_infer(op_, block):
    set_out(op_, block, "Accuracy", [1], "float32")
    set_out(op_, block, "Correct", [1], "int32")
    set_out(op_, block, "Total", [1], "int32")


@op("accuracy", infer_shape=_accuracy_infer, grad=NO_GRAD)
def _accuracy(ctx, op_, ins):
    idx = ins["Indices"][0]
    label = ins["Label"][0].reshape(-1, 1)
    hit = torch.any(idx == label, dim=1)
    correct = torch.sum(hit.to(torch.int32)).reshape(1).to(torch.int32)
    # a fill, not a host copy: a CUDA graph can capture it
    total = torch.full((1,), idx.shape[0], dtype=torch.int32,
                       device=idx.device)
    acc = correct.float() / idx.shape[0]
    return {"Accuracy": [acc], "Correct": [correct], "Total": [total]}


# --- conv / pool --------------------------------------------------------------

def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return list(v)
    return [v] * n


def _conv_out_dim(i, k, p, s, d=1):
    if i is None or i < 0:
        return None
    ke = d * (k - 1) + 1
    return (i + 2 * p - ke) // s + 1


def _conv2d_infer(op_, block):
    xv, fv = in_var(op_, block, "Input"), in_var(op_, block, "Filter")
    if xv is None or fv is None or xv.shape is None or fv.shape is None:
        return
    s, p, d = (_pair(op_.attr("strides", [1, 1])),
               _pair(op_.attr("paddings", [0, 0])),
               _pair(op_.attr("dilations", [1, 1])))
    n, _, h, w = xv.shape
    co, _, kh, kw = fv.shape
    set_out(op_, block, "Output",
            [n, co, _conv_out_dim(h, kh, p[0], s[0], d[0]),
             _conv_out_dim(w, kw, p[1], s[1], d[1])], xv.dtype)


@op("conv2d", infer_shape=_conv2d_infer)
def _conv2d(ctx, op_, ins):
    """Eligible shapes (conv_cuda.ineligible, the one gate) run the port's
    CUDA kernel K1, or under AMP O3 the int8 kernel K11 where the quant gate
    also passes; the rest go to F.conv2d with a reason-labelled fallback
    count, as the JAX package routes between its Pallas kernels and
    lax.conv (nn_ops.py:275-320). The filter's admission-time int8 values,
    where the serving engine made them, come by its name."""
    pre = quant.prequantized(ctx, op_.desc.inputs["Filter"][0]) \
        if getattr(ctx, "quant_mode", None) else None
    return {"Output": [conv2d_forward(ctx, op_, ins["Input"][0],
                                      ins["Filter"][0], pre)]}


def conv2d_forward(ctx, op_, x, w, pre=None):
    """The conv2d lowering on explicit operands: NCHW x, OIHW w -> NCHW y in
    channels_last memory. `pre` is the (int8 values, scales) of `w` for the
    quantized route, or None to quantize `w` per call; the fold passes its
    folded filter and that filter's own int8 values."""
    s = _pair(op_.attr("strides", [1, 1]))
    p = _pair(op_.attr("paddings", [0, 0]))
    d = _pair(op_.attr("dilations", [1, 1]))
    groups = op_.attr("groups", 1) or 1
    qmode = getattr(ctx, "quant_mode", None)
    (x, w), restore = mxu_cast(ctx, x, w, formats=CONV_FORMATS)
    x = x.contiguous(memory_format=torch.channels_last)
    x_nhwc = x.permute(0, 2, 3, 1)
    reason = conv_cuda.ineligible(x_nhwc, w, s, p, d, groups)
    if reason is None:
        conv_cuda.count_hit(op_.type)
        qreason = quant.ineligible_conv(x_nhwc, w, s, p, d, groups,
                                        qmode) if qmode else "disabled"
        if qreason is None:
            quant.count_hit(op_.type)
            y = quant.qconv2d(x_nhwc, w, s, p, d, qmode, pre=pre)
        else:
            if qmode:
                quant.count_fallback(op_.type, qreason)
            y = conv_cuda.conv2d(x_nhwc, w, s, p, d)
        out = y.permute(0, 3, 1, 2)
    else:
        conv_cuda.count_fallback(op_.type, reason)
        if qmode:
            # the quantized conv needs the kernel route (quant.py:181-184)
            quant.count_fallback(op_.type, "kernel")
        out = F.conv2d(x, w, stride=s, padding=p, dilation=d, groups=groups)
    if restore is not None:
        out = out.to(restore)
    return out


@op("conv2d_grad", infer_shape=infer_grad_shapes, grad=NO_GRAD)
def _conv2d_grad(ctx, op_, ins):
    """Explicit conv backward (nn_ops.py:340-409): eligible shapes take K2
    (grad input) and K3 (grad filter) under K1's one gate; the rest take
    the generic grad, autograd over the forward lowering's F.conv2d,
    counted as ("conv2d_grad", reason). The generic grad cannot
    differentiate K1, which runs through ctypes: hence this op.

    A missing cotangent (the output unused by the loss) gives zeros
    without a re-run. dx comes out in Input's dtype (bf16 under O2), dW in
    the un-cast filter's dtype (f32 master weights), NCHW in channels_last
    memory and OIHW."""
    douts = ins.get("Output@GRAD")
    if not douts or douts[0] is None:
        return zero_grads(op_, ins)
    x, w = ins["Input"][0], ins["Filter"][0]
    s = _pair(op_.attr("strides", [1, 1]))
    p = _pair(op_.attr("paddings", [0, 0]))
    d = _pair(op_.attr("dilations", [1, 1]))
    groups = op_.attr("groups", 1) or 1
    (xc, wc), _ = mxu_cast(ctx, x, w, formats=CONV_FORMATS)
    x_nhwc = xc.contiguous(memory_format=torch.channels_last) \
        .permute(0, 2, 3, 1)
    reason = conv_cuda.ineligible(x_nhwc, wc, s, p, d, groups)
    if reason is not None:
        conv_cuda.count_fallback(op_.type, reason)
        # the forward lowering counted itself on the forward pass
        with conv_cuda.suppress_counters():
            return generic_grad_lower(ctx, op_, ins)
    conv_cuda.count_hit(op_.type)
    dout = douts[0]
    if not dout.is_contiguous(memory_format=torch.channels_last):
        conv_cuda.COUNTERS.layout_copies += 1
        dout = dout.contiguous(memory_format=torch.channels_last)
    dout = dout.permute(0, 2, 3, 1).to(torch.bfloat16)
    outs = {}
    if "Input@GRAD" in op_.desc.outputs:
        dx = conv_cuda.conv2d_grad_input(
            dout, wc, (x_nhwc.shape[1], x_nhwc.shape[2]), s, p, d,
            out_dtype=x.dtype)
        outs["Input@GRAD"] = [dx.permute(0, 3, 1, 2)]
    if "Filter@GRAD" in op_.desc.outputs:
        outs["Filter@GRAD"] = [conv_cuda.conv2d_grad_filter(
            x_nhwc, dout, (wc.shape[2], wc.shape[3]), s, p, d,
            out_dtype=w.dtype)]
    return outs


@op("depthwise_conv2d", infer_shape=_conv2d_infer)
def _depthwise_conv2d(ctx, op_, ins):
    """conv2d's lowering (nn_ops.py:335-337): K1's gate refuses groups != 1
    ("groups"), so the route is F.conv2d, counted; under O3 the quant gate
    counts ("depthwise_conv2d", "kernel"), as the reference's does."""
    return _conv2d(ctx, op_, ins)


@op("depthwise_conv2d_grad", infer_shape=infer_grad_shapes, grad=NO_GRAD)
def _depthwise_conv2d_grad(ctx, op_, ins):
    """conv2d_grad's lowering: the generic grad over F.conv2d, counted as
    ("depthwise_conv2d_grad", "groups")."""
    return _conv2d_grad(ctx, op_, ins)


def _pool2d_infer(op_, block):
    xv = in_var(op_, block, "X")
    if xv is None or xv.shape is None:
        return
    if op_.attr("global_pooling", False):
        set_out(op_, block, "Out", [xv.shape[0], xv.shape[1], 1, 1], xv.dtype)
        return
    k = _pair(op_.attr("ksize"))
    s = _pair(op_.attr("strides", [1, 1]))
    p = _pair(op_.attr("paddings", [0, 0]))
    n, c, h, w = xv.shape

    def odim(i, kk, pp, ss):
        if i is None or i < 0:
            return None
        if op_.attr("ceil_mode", False):
            return (i - kk + 2 * pp + ss - 1) // ss + 1
        return (i - kk + 2 * pp) // ss + 1
    set_out(op_, block, "Out",
            [n, c, odim(h, k[0], p[0], s[0]), odim(w, k[1], p[1], s[1])], xv.dtype)


@op("pool2d", infer_shape=_pool2d_infer)
def _pool2d(ctx, op_, ins):
    """Max pooling pads with -inf; average pooling is `exclusive` by default
    (counts only the valid cells, `count_include_pad=False`), as in the JAX
    lowering (nn_ops.py:554-566). Like that lowering, the window walk is
    floor-mode whatever `ceil_mode` says."""
    x = ins["X"][0]
    if op_.attr("global_pooling", False):
        k = [x.shape[2], x.shape[3]]
        s, p = k, [0, 0]
    else:
        k = _pair(op_.attr("ksize"))
        s = _pair(op_.attr("strides", [1, 1]))
        p = _pair(op_.attr("paddings", [0, 0]))
    if op_.attr("pooling_type", "max") == "max":
        out = F.max_pool2d(x, k, s, p)
    else:
        out = F.avg_pool2d(x, k, s, p,
                           count_include_pad=not op_.attr("exclusive", True))
    return {"Out": [out]}


@grad_op("pool2d")
def _pool2d_grad(ctx, op_, ins):
    """Average pooling's dX from the window geometry alone (autograd's own
    avg_pool2d_backward, global pooling included). Max pooling needs the
    argmax of each window, which only the forward computes: it takes the
    generic grad."""
    x = ins["X"][0]
    if op_.attr("pooling_type", "max") == "max":
        return generic_grad_lower(ctx, op_, ins)
    dout = cotangent(ins, "Out", ins["Out"][0])
    if dout is None:
        return zero_grads(op_, ins)
    if op_.attr("global_pooling", False):
        k = [x.shape[2], x.shape[3]]
        s, p = k, [0, 0]
    else:
        k = _pair(op_.attr("ksize"))
        s = _pair(op_.attr("strides", [1, 1]))
        p = _pair(op_.attr("paddings", [0, 0]))
    return {"X@GRAD": [torch.ops.aten.avg_pool2d_backward(
        dout, x, k, s, p, False, not op_.attr("exclusive", True), None)]}


# --- normalization ------------------------------------------------------------

def _bn_infer(op_, block):
    xv = in_var(op_, block, "X")
    if xv is None or xv.shape is None:
        return
    set_out(op_, block, "Y", xv.shape, xv.dtype)
    c = xv.shape[1] if len(xv.shape) > 1 else xv.shape[0]
    for slot in ("MeanOut", "VarianceOut", "SavedMean", "SavedVariance"):
        set_out(op_, block, slot, [c], "float32")


@op("batch_norm", infer_shape=_bn_infer,
    non_diff_inputs=("Mean", "Variance"))
def _batch_norm(ctx, op_, ins):
    """Statistics and normalization in f32; the output returns to x's dtype
    (bf16 under AMP O2). is_test uses the running statistics; training mode
    takes batch statistics (one-pass E[x^2]-E[x]^2 for bf16 inputs, the
    centered two-pass form for f32, as nn_ops.py:606-633)."""
    x = ins["X"][0]
    scale, bias = ins["Scale"][0], ins["Bias"][0]
    mean, var = ins["Mean"][0], ins["Variance"][0]
    eps = op_.attr("epsilon", 1e-5)
    momentum = op_.attr("momentum", 0.9)
    axes = tuple(i for i in range(x.dim()) if i != 1)
    shape = [1] * x.dim()
    shape[1] = x.shape[1]
    xf = x.float()
    if op_.attr("is_test", False):
        use_mean, use_var = mean, var
        mean_out, var_out = mean, var
    else:
        use_mean = torch.mean(xf, dim=axes)
        if x.dtype == torch.bfloat16:
            use_var = torch.clamp(torch.mean(torch.square(xf), dim=axes)
                                  - torch.square(use_mean), min=0.0)
        else:
            use_var = torch.mean(torch.square(xf - use_mean.reshape(shape)),
                                 dim=axes)
        mean_out = mean * momentum + use_mean * (1.0 - momentum)
        var_out = var * momentum + use_var * (1.0 - momentum)
    inv = torch.rsqrt(use_var + eps)
    y = (xf - use_mean.reshape(shape)) * (inv * scale).reshape(shape) \
        + bias.reshape(shape)
    return {"Y": [y.to(x.dtype)], "MeanOut": [mean_out],
            "VarianceOut": [var_out], "SavedMean": [use_mean],
            "SavedVariance": [use_var]}


@grad_op("batch_norm")
def _batch_norm_grad(ctx, op_, ins):
    """dX, dScale, dBias from the forward's own statistics, in f32 (the
    forward's arithmetic): SavedMean and SavedVariance in training mode
    (what `_batch_norm` and the training windows wrote, so the batch
    statistics are not computed again), the running Mean and Variance
    under is_test. With x̂ = (x - mean) · rsqrt(var + eps) over the N
    values of a channel: dBias = Σ dy, dScale = Σ dy · x̂, and in training
    mode dX = scale · rsqrt(var + eps) · (dy - dBias / N - x̂ · dScale / N),
    under is_test dX = scale · rsqrt(var + eps) · dy; dX in X's dtype,
    dScale and dBias in theirs. In training mode cotangents on the
    statistics outputs (none in a program append_backward builds) add
    dMean / N + dVar · 2 (x - mean) / N to dX, with dMean = dSavedMean +
    (1 - momentum) dMeanOut and dVar likewise."""
    x = ins["X"][0]
    dy = cotangent(ins, "Y", x)
    if dy is None:
        if not any(ins.get(s + "@GRAD") and ins[s + "@GRAD"][0] is not None
                   for s in ("SavedMean", "SavedVariance", "MeanOut",
                             "VarianceOut")):
            return zero_grads(op_, ins)
        dy = torch.zeros_like(x)
    scale = ins["Scale"][0]
    is_test = op_.attr("is_test", False)
    mean = ins["Mean" if is_test else "SavedMean"][0]
    var = ins["Variance" if is_test else "SavedVariance"][0]
    axes = tuple(i for i in range(x.dim()) if i != 1)
    shape = [1] * x.dim()
    shape[1] = x.shape[1]
    inv = torch.rsqrt(var.float() + op_.attr("epsilon", 1e-5))
    dyf = dy.float()
    xhat = (x.float() - mean.float().reshape(shape)) * inv.reshape(shape)
    dbias = torch.sum(dyf, dim=axes)
    dscale = torch.sum(dyf * xhat, dim=axes)
    k = (scale.float() * inv).reshape(shape)
    if is_test:
        dx = dyf * k
    else:
        n = x.numel() // x.shape[1]
        dx = (dyf - (dbias / n).reshape(shape)
              - xhat * (dscale / n).reshape(shape)) * k
        keep = 1.0 - op_.attr("momentum", 0.9)
        dmean = dvar = None
        for slot, w, kind in (("SavedMean", 1.0, 0), ("MeanOut", keep, 0),
                              ("SavedVariance", 1.0, 1),
                              ("VarianceOut", keep, 1)):
            g = cotangent(ins, slot, ins[slot][0]) if ins.get(slot) else None
            if g is None:
                continue
            g = g.float() * w
            if kind == 0:
                dmean = g if dmean is None else dmean + g
            else:
                dvar = g if dvar is None else dvar + g
        if dmean is not None:
            dx = dx + (dmean / n).reshape(shape)
        if dvar is not None:
            dx = dx + (dvar * 2.0 / n).reshape(shape) * \
                (x.float() - mean.float().reshape(shape))
    outs = {"X@GRAD": [dx.to(x.dtype)],
            "Scale@GRAD": [dscale.to(scale.dtype)],
            "Bias@GRAD": [dbias.to(ins["Bias"][0].dtype)]}
    return {s: outs[s] for s in op_.desc.outputs}


# --- embedding ----------------------------------------------------------------

def _lookup_infer(op_, block):
    wv, iv = in_var(op_, block, "W"), in_var(op_, block, "Ids")
    if wv is None or iv is None or wv.shape is None or iv.shape is None:
        return
    shape = list(iv.shape)
    if shape and shape[-1] == 1:
        shape = shape[:-1]
    set_out(op_, block, "Out", shape + [wv.shape[1]], wv.dtype)


def _squeezed_ids(ids):
    """Ids with a trailing 1 squeezed ([N, 1] -> [N]), as the reference's
    lookup takes them."""
    if ids.dim() > 1 and ids.shape[-1] == 1:
        ids = ids.reshape(ids.shape[:-1])
    return ids


@op("lookup_table", infer_shape=_lookup_infer, non_diff_inputs=("Ids",))
def _lookup_table(ctx, op_, ins):
    """Rows of W gathered by Ids; rows of `padding_idx` read as zeros
    (nn_ops.py:189). A row-sharded table gathers through
    sparse_ops.sharded_lookup."""
    from . import sparse_ops
    w = ins["W"][0]
    ids = _squeezed_ids(ins["Ids"][0])
    wname = (op_.input("W") or [None])[0]
    program = getattr(ctx, "program", None)
    if wname and sparse_ops.table_axes(program, wname) is not None:
        out = sparse_ops.sharded_lookup(program, wname, w, ids.long())
    else:
        out = w[ids.long()]
    pad = op_.attr("padding_idx", -1)
    if pad is not None and pad >= 0:
        out = out.masked_fill((ids == pad)[..., None], 0.0)
    return {"Out": [out]}


@op("lookup_table_grad", grad=NO_GRAD)
def _lookup_table_grad(ctx, op_, ins):
    """The embedding gradient (nn_ops.py:211): the cotangent rows, in W's
    dtype and zero at `padding_idx`. Under is_sparse=True, and for a
    row-sharded table, a SelectedRowsVal of the flat ids and those rows,
    duplicates unmerged as the reference's; else the rows summed into a
    zero table in a fixed order."""
    from . import sparse_ops
    w = ins["W"][0]
    douts = ins.get("Out@GRAD")
    if not douts or douts[0] is None:
        return zero_grads(op_, ins)
    ids = _squeezed_ids(ins["Ids"][0]).reshape(-1).long()
    g = douts[0]
    g = g.reshape(-1, g.shape[-1]).to(w.dtype)
    pad = op_.attr("padding_idx", -1)
    if pad is not None and pad >= 0:
        g = g.masked_fill((ids == pad)[:, None], 0.0)
    wname = (op_.input("W") or [None])[0]
    sharded = (wname is not None and sparse_ops.table_axes(
        getattr(ctx, "program", None), wname) is not None)
    if op_.attr("is_sparse", False) or sharded:
        if sharded and not op_.attr("is_sparse", False):
            sparse_ops.note_once(
                f"forced_sparse:{wname}",
                f"lookup_table_grad for row-sharded table '{wname}' "
                f"emits a SelectedRows gradient (is_sparse forced on): "
                f"a dense gradient would materialize the full table.")
        return {"W@GRAD": [SelectedRowsVal(ids, g, w.shape[0])]}
    # accumulate through index_put_: on a CUDA tensor it sorts the ids and
    # sums each id's rows in order, where index_add_'s atomics add them in
    # whatever order they land (two runs, or a graph and the eager step,
    # would differ in the last bits)
    return {"W@GRAD": [torch.zeros_like(w).index_put_((ids,), g,
                                                      accumulate=True)]}


# --- layer_norm -------------------------------------------------------------------

def _ln_infer(op_, block):
    xv = in_var(op_, block, "X")
    if xv is None or xv.shape is None:
        return
    set_out(op_, block, "Y", xv.shape, xv.dtype)
    ax = op_.attr("begin_norm_axis", 1)
    left = int(np.prod([d for d in xv.shape[:ax]])) if all(
        d is not None and d > 0 for d in xv.shape[:ax]) else None
    set_out(op_, block, "Mean", [left] if left else None, "float32")
    set_out(op_, block, "Variance", [left] if left else None, "float32")


@op("layer_norm", infer_shape=_ln_infer)
def _layer_norm(ctx, op_, ins):
    """Normalize over the axes from begin_norm_axis on, in x's own dtype
    (no local upcast, as nn_ops.py:656), then Scale and Bias multiplied in:
    under AMP O2 a bf16 x times the f32 Scale promotes to f32, in torch as
    in jnp. Mean and Variance come out flattened."""
    x = ins["X"][0]
    ax = op_.attr("begin_norm_axis", 1)
    eps = op_.attr("epsilon", 1e-5)
    axes = tuple(range(ax, x.dim()))
    mean = torch.mean(x, dim=axes, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=axes, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    feat_shape = (1,) * ax + tuple(x.shape[ax:])
    if ins.get("Scale") and ins["Scale"][0] is not None:
        y = y * ins["Scale"][0].reshape(feat_shape)
    if ins.get("Bias") and ins["Bias"][0] is not None:
        y = y + ins["Bias"][0].reshape(feat_shape)
    return {"Y": [y], "Mean": [mean.reshape(-1)],
            "Variance": [var.reshape(-1)]}


@grad_op("layer_norm")
def _layer_norm_grad(ctx, op_, ins):
    """dX, dScale, dBias from the forward's saved Mean and Variance, in
    the forward's dtype chain: x̂ = (x - mean) · rsqrt(var + eps) in X's
    dtype, dBias = Σ dy and dScale = Σ dy · x̂ over the leading axes (in
    Y's dtype, then the parameter's), g = dy · scale in X's dtype, and
    dX = rsqrt(var + eps) · (g - mean(g) - x̂ · mean(g · x̂)) over the
    normalized axes. A bf16 X takes the generic grad: the forward runs in
    bf16 throughout (as the reference's), and a closed form lands up to 11
    bf16 ulps from autograd's grad of that chain of roundings; no path
    feeds layer_norm bf16 (the LM's residual stream is f32)."""
    x = ins["X"][0]
    if x.dtype == torch.bfloat16:
        return generic_grad_lower(ctx, op_, ins)
    y = ins["Y"][0]
    dy = cotangent(ins, "Y", y)
    if dy is None:
        return zero_grads(op_, ins)
    ax = op_.attr("begin_norm_axis", 1)
    axes = tuple(range(ax, x.dim()))
    keep = tuple(x.shape[:ax]) + (1,) * (x.dim() - ax)
    feat_shape = (1,) * ax + tuple(x.shape[ax:])
    lead = tuple(range(ax))
    rstd = torch.rsqrt(ins["Variance"][0].reshape(keep)
                       + op_.attr("epsilon", 1e-5))
    xhat = (x - ins["Mean"][0].reshape(keep)) * rstd
    outs = {}
    scale = ins["Scale"][0] if ins.get("Scale") else None
    bias = ins["Bias"][0] if ins.get("Bias") else None
    if bias is not None:
        outs["Bias@GRAD"] = [torch.sum(dy, dim=lead).to(bias.dtype)
                             .reshape(bias.shape)]
    if scale is not None:
        outs["Scale@GRAD"] = [torch.sum(dy * xhat, dim=lead).to(scale.dtype)
                              .reshape(scale.shape)]
        g = (dy * scale.reshape(feat_shape)).to(x.dtype)
    else:
        g = dy.to(x.dtype)
    dx = rstd * (g - torch.mean(g, dim=axes, keepdim=True)
                 - xhat * torch.mean(g * xhat, dim=axes, keepdim=True))
    outs["X@GRAD"] = [dx.to(x.dtype)]
    return {s: outs[s] for s in op_.desc.outputs}


# --- attention ----------------------------------------------------------------------

def _sdpa_infer(op_, block):
    qv = in_var(op_, block, "Q")
    if qv is not None:
        set_out(op_, block, "Out", qv.shape, qv.dtype)
        if "LSE" in op_.desc.outputs:
            b, t, h = qv.shape[0], qv.shape[1], qv.shape[2]
            set_out(op_, block, "LSE", [b, h, t], "float32")


def _sdpa_grad(fwd, no_grad_set):
    """The explicit grad op, fed the forward's saved Out and LSE
    (nn_ops.py:793): the flash path's backward runs K8 + K9 straight from
    them, so no forward is re-run."""
    wanted = [s for s in ("Q", "K", "V")
              if fwd.input(s)[0] not in no_grad_set]
    if not wanted:
        return []
    return [OpDesc(
        type="scaled_dot_product_attention_grad",
        inputs={"Q": fwd.input("Q"), "K": fwd.input("K"),
                "V": fwd.input("V"), "Out": fwd.output("Out"),
                "LSE": fwd.output("LSE"),
                "Out@GRAD": [grad_var_name(fwd.output("Out")[0])]},
        outputs={s + "@GRAD": [grad_var_name(fwd.input(s)[0])]
                 for s in wanted},
        attrs=dict(fwd.attrs))]


# Sequence length from which use_flash="auto" takes the flash path: the
# reference's rule and default (nn_ops.py:814), kept as the reference's. On
# an H100 the flash kernels beat the einsum path at every T measured, from
# 512 up (`chip_smoke.py`'s crossover, PERF.md §6).
FLASH_AUTO_T = 2048


def _ring_uses_flash(op_, q, mesh):
    """Whether the ring runs flash blocks per shard (nn_ops.py:826): an
    explicit use_flash=False takes the einsum ring; True or "auto" take
    the flash ring wherever the shard shape tiles. Static, so the grad op
    reaches the same answer without re-running the forward."""
    from ..parallel.ring_attention import flash_ring_eligible
    if op_.attr("use_flash", "auto") is False:
        return False
    return flash_ring_eligible(q, mesh, "sp")


def _sdpa_paths(ctx, op_, q, k, v):
    """(mode, mesh) (nn_ops.py:838): 'ring' under sequence_parallel=True
    with an 'sp' axis on the program's mesh; else 'flash' when use_flash is
    True, or "auto" at T >= the threshold, and the shape passes `supports`;
    else 'einsum'. sequence_parallel=True without such a mesh falls
    through to flash or einsum, as in the reference."""
    mesh = getattr(ctx, "mesh", None)
    if op_.attr("sequence_parallel", False) and mesh is not None and \
            "sp" in mesh.axis_names:
        return "ring", mesh
    uf = op_.attr("use_flash", "auto")
    if uf == "auto":
        uf = q.shape[1] >= FLASH_AUTO_T
    if uf and attention_cuda.supports(q, k, v):
        return "flash", None
    return "einsum", None


@op("scaled_dot_product_attention", infer_shape=_sdpa_infer,
    grad=_sdpa_grad)
def _scaled_dot_product_attention(ctx, op_, ins):
    """Softmax attention over Q/K/V [B, T, H, D] (nn_ops.py:856), with LSE
    [B, H, T] f32, the per-row logsumexp of the scaled scores that the
    explicit backward starts from. The ring path runs ring attention over
    the mesh's 'sp' axis (parallel/ring_attention.py: K10 per shard pair,
    in bf16 under AMP O2 or in its f32 form, or the einsum ring where the
    shards do not tile) and emits its merged
    LSE; the flash path runs K7 (ops/attention_cuda.py, under its gate);
    the einsum path runs attention_reference, as the reference does below
    its threshold."""
    q, k, v = ins["Q"][0], ins["K"][0], ins["V"][0]
    causal = op_.attr("causal", False)
    (q, k, v), restore = mxu_cast(ctx, q, k, v)
    mode, mesh = _sdpa_paths(ctx, op_, q, k, v)
    if mode == "ring":
        from ..parallel.ring_attention import ring_attention_sharded
        out, lse = ring_attention_sharded(
            q, k, v, mesh, "sp", causal,
            use_flash=op_.attr("use_flash", "auto") is not False,
            return_lse=True, op=op_.type)
    elif mode == "flash":
        out, lse = attention_cuda.attention_forward(q, k, v, causal,
                                                    op=op_.type)
    else:
        out = attention_cuda.attention_reference(q, k, v, causal=causal)
        lse = attention_cuda.attention_reference_lse(q, k, causal=causal)
    if restore is not None:
        out = out.to(restore)
    return {"Out": [out], "LSE": [lse]}


@op("scaled_dot_product_attention_grad", grad=NO_GRAD,
    non_diff_inputs=("LSE",))
def _sdpa_grad_kernel(ctx, op_, ins):
    """dQ/dK/dV from the saved (Out, LSE) (nn_ops.py:899): the flash path
    runs K8 + K9 (ops/attention_cuda.py) and the flash ring the direct ring
    backward (K8 + K9 per shard pair), both with no forward re-run; the
    einsum ring and the einsum path differentiate their forward with
    torch.autograd. dO is cast by mxu_cast like Q, K and V."""
    douts = ins.get("Out@GRAD")
    if not douts or douts[0] is None:
        return zero_grads(op_, ins)
    q, k, v = ins["Q"][0], ins["K"][0], ins["V"][0]
    causal = op_.attr("causal", False)
    (q, k, v, do), restore = mxu_cast(ctx, q, k, v, douts[0])
    mode, mesh = _sdpa_paths(ctx, op_, q, k, v)
    if mode == "ring" and _ring_uses_flash(op_, q, mesh):
        from ..parallel.ring_attention import ring_attention_bwd_sharded
        dq, dk, dv = ring_attention_bwd_sharded(
            q, k, v, do.to(q.dtype), ins["Out"][0].to(q.dtype),
            ins["LSE"][0], mesh, "sp", causal, op=op_.type)
    elif mode == "ring":
        from ..parallel.ring_attention import ring_attention_sharded
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = ring_attention_sharded(
                *leaves, mesh, "sp", causal,
                use_flash=op_.attr("use_flash", "auto") is not False,
                op=op_.type)
            dq, dk, dv = torch.autograd.grad(out, leaves, do.to(out.dtype))
    elif mode == "flash":
        dq, dk, dv = attention_cuda.attention_backward(
            q, k, v, ins["Out"][0], do, ins["LSE"][0], causal, op=op_.type)
    else:
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = attention_cuda.attention_reference(*leaves, causal=causal)
            dq, dk, dv = torch.autograd.grad(out, leaves, do.to(out.dtype))
    if restore is not None:
        dq, dk, dv = dq.to(restore), dk.to(restore), dv.to(restore)
    return {name: [g] for name, g in (("Q@GRAD", dq), ("K@GRAD", dk),
                                      ("V@GRAD", dv))
            if name in op_.desc.outputs}
