"""Optimizer update ops (the port's counterpart of
paddle_tpu/ops/optimizer_ops.py; reference sgd_op.cc, momentum_op.cc,
adam_op.cc, adagrad_op.cc, adamax_op.cc, decayed_adagrad_op.cc,
adadelta_op.cc, rmsprop_op.cc, ftrl_op.cc, proximal_gd_op.cc,
proximal_adagrad_op.cc).

Like the reference, optimizer updates are ops in the program: outputs alias
the parameter/accumulator input names, and the executor writes them back to
the scope. The grad is upcast to the parameter's dtype before any arithmetic
(`_param_grad`, optimizer_ops.py:33): f32 master weights under AMP O2 may
receive bf16 grads.

A SelectedRows grad (is_sparse lookup_table_grad) reaches sgd, momentum
and adam's sparse branch while PADDLE_TPU_SPARSE_APPLY is on: the apply
of ops/sparse_ops.py (S1 on the card), which updates the table and its
accumulators in place and hands back the same tensors. Any other
optimizer, or these with the gate off, densifies it, counted as
`no_sparse_kernel` or `gated_off` (optimizer_ops.py:36-150).
"""

from __future__ import annotations

import torch

from . import sparse_ops
from .common import SelectedRowsVal, in_var, maybe_dense, set_out
from .registry import NO_GRAD, op


def _param_out_infer(*pairs):
    def infer(op_, block):
        for in_slot, out_slot in pairs:
            iv = in_var(op_, block, in_slot)
            if iv is not None:
                set_out(op_, block, out_slot, iv.shape, iv.dtype)
    return infer


def _lr(ins):
    return ins["LearningRate"][0].reshape(())


def _param_grad(ins, op_type=None):
    """(param, grad) with the grad cast to the param's dtype; a SelectedRows
    grad densifies here, counted under `op_type`'s reason."""
    p = ins["Param"][0]
    g = ins["Grad"][0]
    if isinstance(g, SelectedRowsVal) and op_type is not None:
        sparse_ops.count_densify(
            op_type, "gated_off" if op_type in sparse_ops.SPARSE_APPLY_OPS
            else "no_sparse_kernel")
    return p, maybe_dense(g).to(p.dtype)


def _sparse_ready(ins) -> bool:
    return (isinstance(ins["Grad"][0], SelectedRowsVal)
            and sparse_ops.sparse_apply_enabled())


def _sparse_grad(ins):
    """The SelectedRows grad with its values cast to the param's dtype."""
    g, p = ins["Grad"][0], ins["Param"][0]
    return SelectedRowsVal(g.rows, g.values.to(p.dtype), g.height)


def _pname(op_):
    names = op_.input("Param")
    return names[0] if names else None


# Dense update math (optimizer_ops.py:69-87): elementwise over the tensors
# with scalar hyperparameters.

def sgd_dense(p, g, lr):
    return p - lr * g


def momentum_dense(p, g, v, lr, mu, use_nesterov):
    v_out = mu * v + g
    if use_nesterov:
        p_out = p - lr * (g + mu * v_out)
    else:
        p_out = p - lr * v_out
    return p_out, v_out


def adam_dense(p, g, m1, m2, lr, b1, b2, eps, b1p, b2p):
    m1o = b1 * m1 + (1 - b1) * g
    m2o = b2 * m2 + (1 - b2) * g * g
    lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    po = p - lr_t * m1o / (torch.sqrt(m2o) + eps)
    return po, m1o, m2o


# List forms over lists of tensors, for the fused optimizer buckets
# (ops/fusion.py opt_bucket). The reference concatenates a bucket into one
# flat buffer and applies the dense update once (fusion.py:843-895); here
# torch._foreach ops take the lists as they are, one op of the dense
# expression at a time and in its order, so each element sees the same
# operations and roundings as the per-param update. `lr` (and adam's beta
# powers) are 0-dim tensors shared by the bucket.

def _times(xs, t):
    """t * xs[i] for a 0-dim f32 tensor t. In f32 torch._foreach_mul is
    one exact product rounded once, as the per-param `t * x`; in bf16 its
    products are not bitwise `t * x` (nor is `x * t` on the CPU), so lists
    of another dtype multiply one by one, in the per-param order."""
    if all(x.dtype == torch.float32 for x in xs):
        return torch._foreach_mul(xs, t)
    return [t * x for x in xs]


def sgd_list(ps, gs, lr):
    return torch._foreach_sub(ps, _times(gs, lr))


def momentum_list(ps, gs, vs, lr, mu, use_nesterov):
    v_out = torch._foreach_add(torch._foreach_mul(vs, mu), gs)
    if use_nesterov:
        step = torch._foreach_add(gs, torch._foreach_mul(v_out, mu))
    else:
        step = v_out
    return torch._foreach_sub(ps, _times(step, lr)), v_out


def adam_list(ps, gs, m1s, m2s, lr, b1, b2, eps, b1p, b2p):
    m1o = torch._foreach_add(torch._foreach_mul(m1s, b1),
                             torch._foreach_mul(gs, 1 - b1))
    gg = torch._foreach_mul(torch._foreach_mul(gs, 1 - b2), gs)
    m2o = torch._foreach_add(torch._foreach_mul(m2s, b2), gg)
    lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    den = torch._foreach_add(torch._foreach_sqrt(m2o), eps)
    upd = torch._foreach_div(_times(m1o, lr_t), den)
    return torch._foreach_sub(ps, upd), m1o, m2o


@op("sgd", grad=NO_GRAD, infer_shape=_param_out_infer(("Param", "ParamOut")))
def _sgd(ctx, op_, ins):
    if _sparse_ready(ins):
        po = sparse_ops.sgd_apply(ins["Param"][0], _lr(ins), _sparse_grad(ins))
        po = sparse_ops.pin_table(ctx.program, _pname(op_), po)
        return {"ParamOut": [po]}
    p, g = _param_grad(ins, "sgd")
    return {"ParamOut": [sgd_dense(p, g, _lr(ins))]}


@op("momentum", grad=NO_GRAD,
    infer_shape=_param_out_infer(("Param", "ParamOut"),
                                 ("Velocity", "VelocityOut")))
def _momentum(ctx, op_, ins):
    if _sparse_ready(ins):
        po, vo = sparse_ops.momentum_apply(
            ins["Param"][0], ins["Velocity"][0], _lr(ins), op_.attr("mu"),
            op_.attr("use_nesterov", False), _sparse_grad(ins))
        po, vo = sparse_ops.pin_table(ctx.program, _pname(op_), po, vo)
        return {"ParamOut": [po], "VelocityOut": [vo]}
    p, g = _param_grad(ins, "momentum")
    p_out, v_out = momentum_dense(p, g, ins["Velocity"][0], _lr(ins),
                                  op_.attr("mu"),
                                  op_.attr("use_nesterov", False))
    return {"ParamOut": [p_out], "VelocityOut": [v_out]}


@op("adam", grad=NO_GRAD,
    infer_shape=_param_out_infer(("Param", "ParamOut"),
                                 ("Moment1", "Moment1Out"),
                                 ("Moment2", "Moment2Out")))
def _adam(ctx, op_, ins):
    hyper = (_lr(ins), op_.attr("beta1", 0.9), op_.attr("beta2", 0.999),
             op_.attr("epsilon", 1e-8), ins["Beta1Pow"][0].reshape(()),
             ins["Beta2Pow"][0].reshape(()))
    if _sparse_ready(ins):
        po, m1o, m2o = sparse_ops.adam_apply(
            ins["Param"][0], ins["Moment1"][0], ins["Moment2"][0], *hyper,
            _sparse_grad(ins))
        po, m1o, m2o = sparse_ops.pin_table(ctx.program, _pname(op_), po,
                                            m1o, m2o)
        return {"ParamOut": [po], "Moment1Out": [m1o], "Moment2Out": [m2o]}
    p, g = _param_grad(ins, "adam")
    po, m1o, m2o = adam_dense(p, g, ins["Moment1"][0], ins["Moment2"][0],
                              *hyper)
    return {"ParamOut": [po], "Moment1Out": [m1o], "Moment2Out": [m2o]}


@op("adagrad", grad=NO_GRAD,
    infer_shape=_param_out_infer(("Param", "ParamOut"), ("Moment", "MomentOut")))
def _adagrad(ctx, op_, ins):
    """reference adagrad_op.cc; dense grads only (optimizer_ops.py:175)."""
    p, g = _param_grad(ins, op_.type)
    mo = ins["Moment"][0] + g * g
    po = p - _lr(ins) * g / (torch.sqrt(mo) + op_.attr("epsilon", 1e-6))
    return {"ParamOut": [po], "MomentOut": [mo]}


# --- the rest of the optimizer family (reference adamax_op.cc,
# decayed_adagrad_op.cc, adadelta_op.cc, rmsprop_op.cc, ftrl_op.cc,
# proximal_gd_op.cc, proximal_adagrad_op.cc; JAX optimizer_ops.py:158-283).
# Dense updates only: a SelectedRows grad densifies at the op's boundary in
# the executor, counted as `sparse_unaware_op`, as in the JAX package. -------

@op("adamax", grad=NO_GRAD,
    infer_shape=_param_out_infer(("Param", "ParamOut"), ("Moment", "MomentOut"),
                                 ("InfNorm", "InfNormOut")))
def _adamax(ctx, op_, ins):
    p, g = _param_grad(ins, op_.type)
    b1, b2 = op_.attr("beta1", 0.9), op_.attr("beta2", 0.999)
    b1p = ins["Beta1Pow"][0].reshape(())
    mo = b1 * ins["Moment"][0] + (1 - b1) * g
    uo = torch.maximum(b2 * ins["InfNorm"][0], torch.abs(g))
    po = p - (_lr(ins) / (1 - b1p)) * mo / (uo + op_.attr("epsilon", 1e-8))
    return {"ParamOut": [po], "MomentOut": [mo], "InfNormOut": [uo]}


@op("decayed_adagrad", grad=NO_GRAD,
    infer_shape=_param_out_infer(("Param", "ParamOut"), ("Moment", "MomentOut")))
def _decayed_adagrad(ctx, op_, ins):
    p, g = _param_grad(ins, op_.type)
    decay = op_.attr("decay", 0.95)
    mo = decay * ins["Moment"][0] + (1 - decay) * g * g
    po = p - _lr(ins) * g / (torch.sqrt(mo) + op_.attr("epsilon", 1e-6))
    return {"ParamOut": [po], "MomentOut": [mo]}


@op("adadelta", grad=NO_GRAD,
    infer_shape=_param_out_infer(("Param", "ParamOut"),
                                 ("AvgSquaredGrad", "AvgSquaredGradOut"),
                                 ("AvgSquaredUpdate", "AvgSquaredUpdateOut")))
def _adadelta(ctx, op_, ins):
    """The raw update, no learning rate (adadelta_op.cc)."""
    p, g = _param_grad(ins, op_.type)
    rho, eps = op_.attr("rho", 0.95), op_.attr("epsilon", 1e-6)
    au = ins["AvgSquaredUpdate"][0]
    ago = rho * ins["AvgSquaredGrad"][0] + (1 - rho) * g * g
    upd = -torch.sqrt((au + eps) / (ago + eps)) * g
    auo = rho * au + (1 - rho) * upd * upd
    return {"ParamOut": [p + upd], "AvgSquaredGradOut": [ago],
            "AvgSquaredUpdateOut": [auo]}


@op("rmsprop", grad=NO_GRAD,
    infer_shape=_param_out_infer(("Param", "ParamOut"), ("Moment", "MomentOut"),
                                 ("MeanSquare", "MeanSquareOut")))
def _rmsprop(ctx, op_, ins):
    p, g = _param_grad(ins, op_.type)
    rho, eps = op_.attr("decay", 0.9), op_.attr("epsilon", 1e-10)
    mso = rho * ins["MeanSquare"][0] + (1 - rho) * g * g
    momo = op_.attr("momentum", 0.0) * ins["Moment"][0] \
        + _lr(ins) * g / torch.sqrt(mso + eps)
    return {"ParamOut": [p - momo], "MomentOut": [momo],
            "MeanSquareOut": [mso]}


@op("ftrl", grad=NO_GRAD,
    infer_shape=_param_out_infer(("Param", "ParamOut"),
                                 ("SquaredAccumulator", "SquaredAccumOut"),
                                 ("LinearAccumulator", "LinearAccumOut")))
def _ftrl(ctx, op_, ins):
    """FTRL-proximal as ftrl_op.h computes it: the parameter is
    (l1 sign(lin) - lin) / y where |lin| > l1, else 0. The JAX package
    divides clip(lin, -l1, l1) - lin by y everywhere, the same numbers
    except where y is 0 (no grad ever reached the entry, l2 = 0: an
    embedding row no batch has looked up), where it makes 0/0 = NaN and
    the reference's select makes 0; the port follows the reference."""
    p, g = _param_grad(ins, op_.type)
    sq, lin = ins["SquaredAccumulator"][0], ins["LinearAccumulator"][0]
    l1, l2 = op_.attr("l1", 0.0), op_.attr("l2", 0.0)
    power = op_.attr("lr_power", -0.5)
    lr = _lr(ins)
    new_sq = sq + g * g
    if power == -0.5:
        root_new, root_old = torch.sqrt(new_sq), torch.sqrt(sq)
    else:
        root_new, root_old = torch.pow(new_sq, -power), torch.pow(sq, -power)
    new_lin = lin + g - (root_new - root_old) / lr * p
    denom = root_new / lr + 2 * l2
    shrunk = (l1 * torch.sign(new_lin) - new_lin) / denom
    po = torch.where(torch.abs(new_lin) > l1, shrunk,
                     torch.zeros_like(shrunk))
    return {"ParamOut": [po], "SquaredAccumOut": [new_sq],
            "LinearAccumOut": [new_lin]}


def _proximal(p, g, lr, l1, l2):
    prox = p - lr * g
    return torch.sign(prox) * torch.clamp(torch.abs(prox) - lr * l1,
                                          min=0.0) / (1.0 + lr * l2)


@op("proximal_gd", grad=NO_GRAD,
    infer_shape=_param_out_infer(("Param", "ParamOut")))
def _proximal_gd(ctx, op_, ins):
    p, g = _param_grad(ins, op_.type)
    return {"ParamOut": [_proximal(p, g, _lr(ins), op_.attr("l1", 0.0),
                                   op_.attr("l2", 0.0))]}


@op("proximal_adagrad", grad=NO_GRAD,
    infer_shape=_param_out_infer(("Param", "ParamOut"), ("Moment", "MomentOut")))
def _proximal_adagrad(ctx, op_, ins):
    p, g = _param_grad(ins, op_.type)
    mo = ins["Moment"][0] + g * g
    lr = _lr(ins) / torch.sqrt(mo + 1e-12)
    return {"ParamOut": [_proximal(p, g, lr, op_.attr("l1", 0.0),
                                   op_.attr("l2", 0.0))], "MomentOut": [mo]}
