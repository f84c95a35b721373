"""Math ops: mul, matmul, elementwise with axis broadcast, activations,
reductions, sum, cumsum, norm, the bilinear tensor product
(the port's counterpart of paddle_tpu/ops/math_ops.py; reference mul_op.cc,
matmul_op.cc, elementwise_*_op.cc, activation_op.cc, reduce_op.cc, mean_op.cc,
cumsum_op.cc, norm_op.cc, bilinear_tensor_product_op.cc)."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .. import quant
from .common import (SelectedRowsVal, broadcast_y_to_x, elementwise_infer,
                     in_var, maybe_dense, mxu_cast, same_as_input, seq_len_of,
                     set_out, time_mask)
from .registry import cotangent, grad_op, op, register, zero_grads


# --- GEMM ---------------------------------------------------------------------

def _flat2(x, num_col_dims):
    """Flatten to 2-D the way mul_op does: leading num_col_dims dims become
    rows, the rest columns."""
    shape = tuple(x.shape)
    rows = int(np.prod(shape[:num_col_dims])) if num_col_dims else 1
    cols = int(np.prod(shape[num_col_dims:])) if num_col_dims < len(shape) else 1
    return x.reshape(rows, cols)


def _mul_infer(op_, block):
    xv, yv = in_var(op_, block, "X"), in_var(op_, block, "Y")
    if xv is None or yv is None or xv.shape is None or yv.shape is None:
        return
    xn = op_.attr("x_num_col_dims", 1)
    yn = op_.attr("y_num_col_dims", 1)
    set_out(op_, block, "Out",
            list(xv.shape[:xn]) + list(yv.shape[yn:]), xv.dtype)


@op("mul", infer_shape=_mul_infer)
def _mul(ctx, op_, ins):
    """A plain matrix product, left to torch.matmul as the JAX package
    leaves it to XLA (no Pallas kernel backs `mul`); under AMP O3, where
    the quant gate passes, the int8 product of quant.qmatmul
    (math_ops.py:52-62), with Y's admission-time int8 values when the
    serving engine made them."""
    x, y = ins["X"][0], ins["Y"][0]
    xn = op_.attr("x_num_col_dims", 1)
    yn = op_.attr("y_num_col_dims", 1)
    tp = _tp_weight(ctx, op_)
    if tp is not None:
        return _tp_mul(ctx, op_, x, y, xn, yn, tp)
    (xf, yf), restore = mxu_cast(ctx, _flat2(x, xn), _flat2(y, yn))
    qmode = getattr(ctx, "quant_mode", None)
    reason = quant.ineligible_matmul(xf, yf, qmode) if qmode else "disabled"
    if reason is None:
        quant.count_hit(op_.type)
        out2d = quant.qmatmul(xf, yf, qmode, pre=quant.prequantized(
            ctx, op_.desc.inputs["Y"][0]))
    else:
        if qmode:
            quant.count_fallback(op_.type, reason)
        out2d = torch.matmul(xf, yf)
    if restore is not None:
        out2d = out2d.to(restore)
    return {"Out": [out2d.reshape(tuple(x.shape[:xn]) + tuple(y.shape[yn:]))]}


def _tp_weight(ctx, op_):
    """(kind, axes, index, size) when `mul`'s weight is split on a model
    axis in a sharded run (parallel/spmd.py `tp_weight`), else None."""
    spmd = getattr(ctx, "spmd", None)
    if spmd is None:
        return None
    return spmd.tp_weight((op_.desc.inputs.get("Y") or [None])[0])


def _tp_mul(ctx, op_, x, y, xn, yn, tp):
    """Megatron's forward on this rank's part of the weight (its columns,
    or its rows, over the whole of the other dim): column-parallel, the
    local product and an all-gather of the output's columns; row-parallel,
    this rank's columns of X times its rows of W, then an all-reduce."""
    from ..parallel import _collectives as C
    kind, axes, idx, size = tp
    x2 = _flat2(x, xn)
    if kind == "row":
        k = x2.shape[1] // size
        x2 = x2.narrow(1, idx * k, k)
    (xf, yf), restore = mxu_cast(ctx, x2, _flat2(y, yn))
    out2d = torch.matmul(xf, yf)
    if restore is not None:
        out2d = out2d.to(restore)
    if kind == "col":
        out2d = C.all_gather(out2d, ctx.spmd.mesh, axes, dim=1,
                             site="tp_col_all_gather")
    else:
        out2d = C.all_reduce(out2d, ctx.spmd.mesh, axes,
                             site="tp_row_all_reduce")
    cols = out2d.shape[1]
    return {"Out": [out2d.reshape(tuple(x.shape[:xn]) + (cols,))]}


def _tp_mul_grad(ctx, op_, x, y, xn, dout, tp):
    """Megatron's backward: column-parallel dW = Xᵀ dOut[:, cols] and dX =
    dOut[:, cols] Wᵀ all-reduced over the model axis; row-parallel dW =
    X[:, rows]ᵀ dOut and dX = dOut Wᵀ all-gathered along its columns. dW is
    this rank's part, a partial sum over its rows of the batch."""
    from ..parallel import _collectives as C
    kind, axes, idx, size = tp
    x2 = _flat2(x, xn)
    if kind == "row":
        k = x2.shape[1] // size
        x2 = x2.narrow(1, idx * k, k)
    (xf, yf), restore = mxu_cast(ctx, x2, y)
    d2 = dout.to(restore or xf.dtype).reshape(x2.shape[0], -1).to(xf.dtype)
    if kind == "col":
        n = d2.shape[1] // size
        d2 = d2.narrow(1, idx * n, n)
    outs = {}
    if "X@GRAD" in op_.desc.outputs:
        dx = torch.matmul(d2, yf.t())
        if kind == "col":
            dx = C.all_reduce(dx, ctx.spmd.mesh, axes,
                              site="tp_col_dx_all_reduce")
        else:
            dx = C.all_gather(dx, ctx.spmd.mesh, axes, dim=1,
                              site="tp_row_dx_all_gather")
        outs["X@GRAD"] = [dx.to(x.dtype).reshape(x.shape)]
    if "Y@GRAD" in op_.desc.outputs:
        outs["Y@GRAD"] = [torch.matmul(xf.t(), d2).to(y.dtype)
                          .reshape(y.shape)]
    return outs


@grad_op("mul")
def _mul_grad(ctx, op_, ins):
    """dX = dOut · Yᵀ, dY = Xᵀ · dOut on the 2-D views the forward
    multiplied, in its compute dtype (the operands as mxu_cast gave them;
    under O1 the cotangent rounded to it first), each grad then back in
    its input's dtype and shape. Under O3 the same plain products: the
    quantized forward's straight-through backward (quant._QMatmul). The
    products stay torch.matmul, as the reference's outside any kernel."""
    x, y = ins["X"][0], ins["Y"][0]
    xn = op_.attr("x_num_col_dims", 1)
    yn = op_.attr("y_num_col_dims", 1)
    out_shape = tuple(x.shape[:xn]) + tuple(y.shape[yn:])
    g = ins.get("Out@GRAD")
    if not g or g[0] is None:
        return zero_grads(op_, ins)
    tp = _tp_weight(ctx, op_)
    if tp is not None:
        return _tp_mul_grad(ctx, op_, x, y, xn, g[0], tp)
    (xf, yf), restore = mxu_cast(ctx, _flat2(x, xn), _flat2(y, yn))
    dout = g[0].to(restore or xf.dtype).reshape(out_shape)
    dout = dout.reshape(xf.shape[0], yf.shape[1]).to(xf.dtype)
    outs = {}
    if "X@GRAD" in op_.desc.outputs:
        outs["X@GRAD"] = [torch.matmul(dout, yf.t()).to(x.dtype)
                          .reshape(x.shape)]
    if "Y@GRAD" in op_.desc.outputs:
        outs["Y@GRAD"] = [torch.matmul(xf.t(), dout).to(y.dtype)
                          .reshape(y.shape)]
    return outs


def _matmul_shape(xs, ys, tx, ty):
    """The matmul output shape of the JAX package's infer (common.py:202):
    a 1-D X is [1, K], a 1-D Y [K, 1], batch dims from X else Y."""
    if xs is None or ys is None:
        return None
    xs, ys = list(xs), list(ys)
    if len(xs) == 1:
        xs = [1, xs[0]]
    if len(ys) == 1:
        ys = [ys[0], 1]
    if tx:
        xs[-2], xs[-1] = xs[-1], xs[-2]
    if ty:
        ys[-2], ys[-1] = ys[-1], ys[-2]
    return (xs[:-2] or ys[:-2]) + [xs[-2], ys[-1]]


def _matmul_infer(op_, block):
    xv, yv = in_var(op_, block, "X"), in_var(op_, block, "Y")
    if xv is None or yv is None:
        return
    set_out(op_, block, "Out",
            _matmul_shape(xv.shape, yv.shape, op_.attr("transpose_X", False),
                          op_.attr("transpose_Y", False)), xv.dtype)


def _matmul_operands(op_, x, y):
    """X and Y as multiplied: the last two dims swapped where transpose_X /
    transpose_Y ask (a 1-D operand is left as it is)."""
    if op_.attr("transpose_X", False) and x.dim() > 1:
        x = x.transpose(-1, -2)
    if op_.attr("transpose_Y", False) and y.dim() > 1:
        y = y.transpose(-1, -2)
    return x, y


@op("matmul", infer_shape=_matmul_infer)
def _matmul(ctx, op_, ins):
    """alpha * (X' @ Y') with X', Y' the operands after their transposes,
    torch.matmul's batch broadcasting and 1-D rules (jnp.matmul's), in the
    AMP compute dtype (math_ops.py:82-111). Under O3 a 2-D product whose
    gate passes is quant.qmatmul's, with Y's admission-time values unless
    Y is transposed (the admission cache holds [K, N], so a transposed Y
    quantizes per call)."""
    x, y = _matmul_operands(op_, ins["X"][0], ins["Y"][0])
    (x, y), restore = mxu_cast(ctx, x, y)
    qmode = getattr(ctx, "quant_mode", None)
    reason = quant.ineligible_matmul(x, y, qmode) if qmode else "disabled"
    if reason is None:
        quant.count_hit(op_.type)
        pre = None if op_.attr("transpose_Y", False) else \
            quant.prequantized(ctx, op_.desc.inputs["Y"][0])
        out = quant.qmatmul(x, y, qmode, pre=pre)
    else:
        if qmode:
            quant.count_fallback(op_.type, reason)
        out = torch.matmul(x, y)
    if restore is not None:
        out = out.to(restore)
    alpha = op_.attr("alpha", 1.0)
    if alpha != 1.0:
        out = out * alpha
    return {"Out": [out]}


@grad_op("matmul")
def _matmul_grad(ctx, op_, ins):
    """dX' = dP @ Y'^T, dY' = X'^T @ dP with dP = alpha * dOut in the
    compute dtype, each summed over the batch dims its operand was
    broadcast along, then transposed back and cast to its input's dtype.
    A 1-D operand is multiplied as a [1, K] row or a [K, 1] column and
    squeezed back. Under O3 the same plain products: the straight-through
    backward of quant._QMatmul. No forward is re-run."""
    x, y = ins["X"][0], ins["Y"][0]
    g = ins.get("Out@GRAD")
    if not g or g[0] is None:
        return zero_grads(op_, ins)
    xt, yt = _matmul_operands(op_, x, y)
    (xc, yc), restore = mxu_cast(ctx, xt, yt)
    x2 = xc if xc.dim() > 1 else xc.unsqueeze(0)
    y2 = yc if yc.dim() > 1 else yc.unsqueeze(-1)
    batch = torch.broadcast_shapes(x2.shape[:-2], y2.shape[:-2])
    dout = g[0].to(restore or xc.dtype)
    alpha = op_.attr("alpha", 1.0)
    if alpha != 1.0:
        dout = dout * alpha
    dout = dout.to(xc.dtype).reshape(tuple(batch) + (x2.shape[-2],
                                                     y2.shape[-1]))
    outs = {}
    if "X@GRAD" in op_.desc.outputs:
        dx = torch.matmul(dout, y2.transpose(-1, -2)).sum_to_size(x2.shape)
        dx = dx.reshape(xt.shape)
        if op_.attr("transpose_X", False) and x.dim() > 1:
            dx = dx.transpose(-1, -2)
        outs["X@GRAD"] = [dx.to(x.dtype)]
    if "Y@GRAD" in op_.desc.outputs:
        dy = torch.matmul(x2.transpose(-1, -2), dout).sum_to_size(y2.shape)
        dy = dy.reshape(yt.shape)
        if op_.attr("transpose_Y", False) and y.dim() > 1:
            dy = dy.transpose(-1, -2)
        outs["Y@GRAD"] = [dy.to(y.dtype)]
    return outs


# --- elementwise with axis broadcast ------------------------------------------

_elementwise_fns = {
    "elementwise_add": torch.add,
    "elementwise_sub": torch.sub,
    "elementwise_mul": torch.mul,
    "elementwise_div": torch.div,
    "elementwise_max": torch.maximum,
    "elementwise_min": torch.minimum,
    "elementwise_pow": torch.pow,
}


def _make_ew(fn):
    def lower(ctx, op_, ins):
        x = ins["X"][0]
        y = broadcast_y_to_x(x, ins["Y"][0], op_.attr("axis", -1))
        # AMP O2 and O3: an f32 operand (a master-weight bias) must not
        # promote a bf16 activation back to f32
        if getattr(ctx, "amp_level", "O1") in ("O2", "O3") and \
                x.dtype == torch.bfloat16 and y.dtype == torch.float32:
            y = y.to(x.dtype)
        return {"Out": [fn(x, y)]}
    return lower


for _name, _fn in _elementwise_fns.items():
    register(_name, lower=_make_ew(_fn), infer_shape=elementwise_infer)


@grad_op("elementwise_add")
def _elementwise_add_grad(ctx, op_, ins):
    """dX = dOut, dY = dOut summed over the axes `axis` broadcast Y along,
    each summed in dOut's dtype and then cast to its input's (under AMP
    O2 the bf16 sum of a bias's grad, then f32, as autograd of the
    forward's cast gives it)."""
    x, y, out = ins["X"][0], ins["Y"][0], ins["Out"][0]
    dout = cotangent(ins, "Out", out)
    if dout is None:
        return zero_grads(op_, ins)
    outs = {}
    if "X@GRAD" in op_.desc.outputs:
        outs["X@GRAD"] = [dout.sum_to_size(x.shape).to(x.dtype)]
    if "Y@GRAD" in op_.desc.outputs:
        yb = broadcast_y_to_x(x, y, op_.attr("axis", -1))
        dy = dout.sum_to_size(yb.shape)
        if getattr(ctx, "amp_level", "O1") in ("O2", "O3") and \
                x.dtype == torch.bfloat16 and y.dtype == torch.float32:
            dy = dy.to(x.dtype)
        outs["Y@GRAD"] = [dy.to(y.dtype).reshape(y.shape)]
    return outs


# --- activations (reference activation_op.cc) ---------------------------------

def _softshrink(x, lam):
    return torch.where(x > lam, x - lam,
                       torch.where(x < -lam, x + lam, torch.zeros_like(x)))


def _where0(cond, x):
    return torch.where(cond, x, torch.zeros_like(x))


def _clip(x, lo, hi):
    """jnp.clip's gradient: a value on a bound splits the tie 0.5/0.5
    between x and the bound (torch.clamp would give x all of it)."""
    return torch.minimum(torch.maximum(x, torch.full_like(x, lo)),
                         torch.full_like(x, hi))


def _fma(a, x, b):
    """a * x + b rounded once to x's dtype, as XLA contracts it under jit
    (0.2 * -2.5 + 0.5 is -7.45e-9 there, 0 with two roundings: the
    difference between no gradient and a tie on hard_sigmoid's bound).
    The scalars are taken in x's dtype first, as JAX's weak types are."""
    a = torch.tensor(a, dtype=x.dtype).double()
    b = torch.tensor(b, dtype=x.dtype).double()
    return (a * x.double() + b).to(x.dtype)


class _Abs(torch.autograd.Function):
    """torch.abs with jnp.abs's gradient: sign(x), but 1 at +-0 where
    torch.abs gives 0."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x < 0, -g, g)


def _abs(x):
    return _Abs.apply(x)


ACTIVATIONS = {
    "sigmoid": lambda x, a: torch.sigmoid(x),
    "logsigmoid": lambda x, a: F.logsigmoid(x),
    "exp": lambda x, a: torch.exp(x),
    "relu": lambda x, a: torch.relu(x),
    "tanh": lambda x, a: torch.tanh(x),
    "tanh_shrink": lambda x, a: x - torch.tanh(x),
    "softshrink": lambda x, a: _softshrink(x, a.attr("lambda", 0.5)),
    "hard_shrink": lambda x, a: _where0(
        torch.abs(x) > a.attr("threshold", 0.5), x),
    "sqrt": lambda x, a: torch.sqrt(x),
    "abs": lambda x, a: _abs(x),
    "ceil": lambda x, a: torch.ceil(x),
    "floor": lambda x, a: torch.floor(x),
    "round": lambda x, a: torch.round(x),
    "reciprocal": lambda x, a: 1.0 / x,
    "log": lambda x, a: torch.log(x),
    "square": lambda x, a: torch.square(x),
    "softplus": lambda x, a: F.softplus(x),
    "softsign": lambda x, a: x / (1.0 + torch.abs(x)),
    "brelu": lambda x, a: _clip(x, a.attr("t_min", 0.0),
                                a.attr("t_max", 24.0)),
    "leaky_relu": lambda x, a: torch.where(x >= 0, x,
                                           a.attr("alpha", 0.02) * x),
    "soft_relu": lambda x, a: torch.log1p(torch.exp(_clip(
        x, -a.attr("threshold", 40.0), a.attr("threshold", 40.0)))),
    "elu": lambda x, a: torch.where(x >= 0, x, a.attr("alpha", 1.0)
                                    * (torch.exp(x) - 1.0)),
    "relu6": lambda x, a: _clip(x, 0.0, a.attr("threshold", 6.0)),
    "pow": lambda x, a: torch.pow(x, a.attr("factor", 1.0)),
    "stanh": lambda x, a: a.attr("scale_b", 1.7159) * torch.tanh(
        a.attr("scale_a", 2.0 / 3.0) * x),
    "hard_sigmoid": lambda x, a: _clip(
        _fma(a.attr("slope", 0.2), x, a.attr("offset", 0.5)), 0.0, 1.0),
    "swish": lambda x, a: x * torch.sigmoid(a.attr("beta", 1.0) * x),
    "thresholded_relu": lambda x, a: _where0(
        x > a.attr("threshold", 1.0), x),
    "gelu": lambda x, a: F.gelu(x),
    "silu": lambda x, a: F.silu(x),
}


def _make_act(fn):
    def lower(ctx, op_, ins):
        return {"Out": [fn(ins["X"][0], op_)]}
    return lower


for _name, _fn in ACTIVATIONS.items():
    register(_name, lower=_make_act(_fn), infer_shape=same_as_input())


@grad_op("relu")
def _relu_grad(ctx, op_, ins):
    """dX = dOut · (Out > 0): autograd's own threshold_backward, zero at
    x = 0 as jax.nn.relu's derivative."""
    out = ins["Out"][0]
    dout = cotangent(ins, "Out", out)
    if dout is None:
        return zero_grads(op_, ins)
    return {"X@GRAD": [torch.ops.aten.threshold_backward(dout, out, 0)]}


@grad_op("gelu")
def _gelu_grad(ctx, op_, ins):
    """dX = dOut · (Φ(x) + x · φ(x)), the exact erf form (the reference's
    approximate=False): autograd's own gelu_backward."""
    x = ins["X"][0]
    dout = cotangent(ins, "Out", ins["Out"][0])
    if dout is None:
        return zero_grads(op_, ins)
    return {"X@GRAD": [torch.ops.aten.gelu_backward(dout, x,
                                                    approximate="none")]}


# --- reductions ---------------------------------------------------------------

def _reduce_dims(op_, ndim):
    if op_.attr("reduce_all", False):
        return tuple(range(ndim))
    dim = op_.attr("dim", [0])
    if isinstance(dim, int):
        dim = [dim]
    return tuple(d % ndim for d in dim)


def _reduce_infer(op_, block):
    iv = in_var(op_, block, "X")
    if iv is None or iv.shape is None:
        return
    nd = len(iv.shape)
    dims = _reduce_dims(op_, nd)
    keep = op_.attr("keep_dim", False)
    if op_.attr("reduce_all", False):
        shape = [1] * nd if keep else [1]
    else:
        shape = [1 if i in dims else d for i, d in enumerate(iv.shape)] if keep \
            else [d for i, d in enumerate(iv.shape) if i not in dims]
        shape = shape or [1]
    set_out(op_, block, "Out", shape, iv.dtype)


def _prod(x, dim, keepdim):
    for d in sorted(dim, reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


_reduce_fns = {
    "reduce_sum": torch.sum, "reduce_mean": torch.mean, "reduce_max": torch.amax,
    "reduce_min": torch.amin, "reduce_prod": _prod,
}


def _make_reduce(fn, name):
    def lower(ctx, op_, ins):
        x = ins["X"][0]
        dims = _reduce_dims(op_, x.dim())
        keep = op_.attr("keep_dim", False)
        spmd = getattr(ctx, "spmd", None)
        if spmd is not None and 0 in dims and spmd.slot_split(op_, "X"):
            out = _split_reduce(spmd, name, fn, x, dims, keep)
        else:
            out = fn(x, dim=dims, keepdim=keep)
        if out.dim() == 0:
            out = out.reshape(1)
        return {"Out": [out]}
    return lower


def _split_reduce(spmd, name, fn, x, dims, keep):
    """A reduction over the batch dim of a batch split over ranks: the
    local reduction, then its all-reduce (sum; the mean as the sum over
    the global count; max and min where every rank but the holder's
    contributes the identity, so the gradient reaches the holder alone)."""
    if name == "reduce_sum":
        return spmd.batch_sum(fn(x, dim=dims, keepdim=keep))
    if name == "reduce_mean":
        return spmd.batch_sum(torch.sum(x, dim=dims, keepdim=keep)) / (
            math.prod(x.shape[d] for d in dims) * spmd.nb)
    if name in ("reduce_max", "reduce_min"):
        local = fn(x, dim=dims, keepdim=keep)
        glob = spmd.batch_reduce(local.detach(),
                                 op="max" if name == "reduce_max" else "min")
        held = (local == glob).to(local.dtype)
        return spmd.batch_sum(local * held) / spmd.batch_sum(held)
    raise NotImplementedError(
        f"{name} over a batch split across {spmd.nb} ranks has no rule")


for _name, _fn in _reduce_fns.items():
    register(_name, lower=_make_reduce(_fn, _name), infer_shape=_reduce_infer)


def _cos_sim_infer(op_, block):
    xv = in_var(op_, block, "X")
    if xv is not None and xv.shape is not None:
        set_out(op_, block, "Out", [xv.shape[0], 1], xv.dtype)
        set_out(op_, block, "XNorm", [xv.shape[0], 1], xv.dtype)
    yv = in_var(op_, block, "Y")
    if yv is not None and yv.shape is not None:
        set_out(op_, block, "YNorm", [yv.shape[0], 1], yv.dtype)


@op("cos_sim", infer_shape=_cos_sim_infer)
def _cos_sim(ctx, op_, ins):
    """Row-wise cosine similarity of X and Y [N, D] (reference
    cos_sim_op.cc; JAX math_ops.py:369), with the norms it divides by."""
    x, y = ins["X"][0], ins["Y"][0]
    xn = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
    yn = torch.sqrt(torch.sum(y * y, dim=1, keepdim=True))
    out = torch.sum(x * y, dim=1, keepdim=True) / (xn * yn)
    return {"Out": [out], "XNorm": [xn], "YNorm": [yn]}


def _sum_infer(op_, block):
    iv = in_var(op_, block, "X", 0)
    if iv is not None:
        set_out(op_, block, "Out", iv.shape, iv.dtype)


@op("sum", infer_shape=_sum_infer)
def _sum(ctx, op_, ins):
    """Elementwise sum of the X list (reference sum_op.cc); backward's
    @RENAME@ accumulation emits it pairwise. SelectedRows inputs only
    concatenate their rows and values (the rows may repeat, as the
    reference's unmerged SelectedRows); a mix densifies (math_ops.py:320)."""
    raw = [x for x in ins["X"] if x is not None]
    if raw and all(isinstance(x, SelectedRowsVal) for x in raw):
        if len(raw) == 1:
            return {"Out": [raw[0]]}
        return {"Out": [SelectedRowsVal(torch.cat([x.rows for x in raw]),
                                        torch.cat([x.values for x in raw]),
                                        raw[0].height)]}
    xs = [maybe_dense(x) for x in raw]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {"Out": [out]}


def _mean_infer(op_, block):
    iv = in_var(op_, block, "X")
    set_out(op_, block, "Out", [1], iv.dtype if iv else "float32")


def _mean_mask(ctx, op_, x):
    """(mask shaped to broadcast over x, valid element count) when X is a
    padded sequence (X@SEQLEN), else None."""
    lengths = seq_len_of(ctx, op_.desc.inputs["X"][0])
    if lengths is None or x.dim() < 2:
        return None
    mask = time_mask(lengths, x.shape[1], x.dtype)
    feat = 1
    for d in x.shape[2:]:
        feat *= d
    denom = torch.clamp(mask.sum() * feat, min=1.0)
    return mask.reshape(mask.shape + (1,) * (x.dim() - 2)), denom


@op("mean", infer_shape=_mean_infer)
def _mean(ctx, op_, ins):
    """Mean over every element; over a padded sequence, over the valid
    positions only, as the reference's mean over the packed rows (JAX
    math_ops.py:294)."""
    x = ins["X"][0]
    masked = _mean_mask(ctx, op_, x)
    spmd = getattr(ctx, "spmd", None)
    if spmd is not None and spmd.slot_split(op_, "X"):
        # a batch split over ranks: the global sum over the global count
        if masked is None:
            return {"Out": [(spmd.batch_sum(torch.sum(x).reshape(1),
                                            site="mean")
                             / (x.numel() * spmd.nb))]}
        m, denom = masked
        return {"Out": [spmd.batch_sum(torch.sum(x * m).reshape(1),
                                       site="mean")
                        / spmd.batch_reduce(denom.reshape(1).detach(),
                                            site="mean_count")]}
    if masked is None:
        return {"Out": [torch.mean(x).reshape(1)]}
    m, denom = masked
    return {"Out": [(torch.sum(x * m) / denom).reshape(1)]}


@grad_op("mean")
def _mean_grad(ctx, op_, ins):
    """dX = dOut / numel(X) at every element (autograd's mean backward);
    over a padded sequence dOut / (valid count) at the valid positions and
    0 at the padded ones, the vjp of the masked forward."""
    x = ins["X"][0]
    dout = cotangent(ins, "Out", ins["Out"][0])
    if dout is None:
        return zero_grads(op_, ins)
    masked = _mean_mask(ctx, op_, x)
    spmd = getattr(ctx, "spmd", None)
    split = spmd is not None and spmd.slot_split(op_, "X")
    if masked is None:
        n = x.numel() * (spmd.nb if split else 1)
        return {"X@GRAD": [dout.reshape(()).expand(x.shape) / n]}
    m, denom = masked
    if split:
        denom = spmd.batch_reduce(denom.reshape(1), site="mean_count") \
            .reshape(denom.shape)
    return {"X@GRAD": [(dout.reshape(()) / denom * m).expand(x.shape)
                       .contiguous()]}


# --- bilinear product, cumsum, norm (reference bilinear_tensor_product_op.cc,
# cumsum_op.cc, norm_op.cc; JAX math_ops.py:123, :338, :379) -------------------

def _bilinear_infer(op_, block):
    xv = in_var(op_, block, "X")
    wv = in_var(op_, block, "Weight")
    if xv is not None and xv.shape is not None and wv is not None \
            and wv.shape is not None:
        set_out(op_, block, "Out", [xv.shape[0], wv.shape[0]], xv.dtype)


@op("bilinear_tensor_product", infer_shape=_bilinear_infer)
def _bilinear_tensor_product(ctx, op_, ins):
    """out[b, o] = x[b] W[o] y[b] (+ bias), X [B, M], Y [B, N], W [O, M, N]."""
    (x, y, w), restore = mxu_cast(ctx, ins["X"][0], ins["Y"][0],
                                  ins["Weight"][0])
    out = torch.einsum("bm,omn,bn->bo", x, w, y)
    if restore is not None:
        out = out.to(restore)
    bias = ins.get("Bias")
    if bias and bias[0] is not None:
        out = out + bias[0].to(out.dtype)
    return {"Out": [out]}


@op("cumsum", infer_shape=same_as_input())
def _cumsum(ctx, op_, ins):
    """Running sum along `axis`; `reverse` sums from the end, `exclusive`
    leaves each element out of its own sum."""
    x = ins["X"][0]
    axis = op_.attr("axis", -1) % max(x.dim(), 1)
    reverse = op_.attr("reverse", False)
    if reverse:
        x = torch.flip(x, (axis,))
    out = torch.cumsum(x, dim=axis)
    if op_.attr("exclusive", False):
        zero = torch.zeros_like(out.narrow(axis, 0, 1))
        out = torch.cat([zero, out.narrow(axis, 0, x.shape[axis] - 1)],
                        dim=axis)
    if reverse:
        out = torch.flip(out, (axis,))
    return {"Out": [out]}


@op("norm", infer_shape=same_as_input())
def _norm(ctx, op_, ins):
    """x / sqrt(sum(x^2, axis) + epsilon) along `axis` (l2_normalize), and
    the norm it divides by."""
    x = ins["X"][0]
    n = torch.sqrt(torch.sum(x * x, dim=op_.attr("axis", -1), keepdim=True)
                   + op_.attr("epsilon", 1e-10))
    return {"Out": [x / n], "Norm": [n]}
