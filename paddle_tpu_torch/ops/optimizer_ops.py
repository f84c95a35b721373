"""Optimizer update ops, dense grads (the port's counterpart of
paddle_tpu/ops/optimizer_ops.py; reference sgd_op.cc, momentum_op.cc,
adam_op.cc).

Like the reference, optimizer updates are ops in the program: outputs alias
the parameter/accumulator input names, and the executor writes them back to
the scope. The grad is upcast to the parameter's dtype before any arithmetic
(`_param_grad`, optimizer_ops.py:33): f32 master weights under AMP O2 may
receive bf16 grads. SelectedRows grads wait for the sparse slice.
"""

from __future__ import annotations

import torch

from .common import in_var, set_out
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


def _param_grad(ins):
    p = ins["Param"][0]
    return p, ins["Grad"][0].to(p.dtype)


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


@op("sgd", grad=NO_GRAD, infer_shape=_param_out_infer(("Param", "ParamOut")))
def _sgd(ctx, op_, ins):
    p, g = _param_grad(ins)
    return {"ParamOut": [sgd_dense(p, g, _lr(ins))]}


@op("momentum", grad=NO_GRAD,
    infer_shape=_param_out_infer(("Param", "ParamOut"),
                                 ("Velocity", "VelocityOut")))
def _momentum(ctx, op_, ins):
    p, g = _param_grad(ins)
    p_out, v_out = momentum_dense(p, g, ins["Velocity"][0], _lr(ins),
                                  op_.attr("mu"),
                                  op_.attr("use_nesterov", False))
    return {"ParamOut": [p_out], "VelocityOut": [v_out]}


@op("adam", grad=NO_GRAD,
    infer_shape=_param_out_infer(("Param", "ParamOut"),
                                 ("Moment1", "Moment1Out"),
                                 ("Moment2", "Moment2Out")))
def _adam(ctx, op_, ins):
    p, g = _param_grad(ins)
    po, m1o, m2o = adam_dense(
        p, g, ins["Moment1"][0], ins["Moment2"][0], _lr(ins),
        op_.attr("beta1", 0.9), op_.attr("beta2", 0.999),
        op_.attr("epsilon", 1e-8), ins["Beta1Pow"][0].reshape(()),
        ins["Beta2Pow"][0].reshape(()))
    return {"ParamOut": [po], "Moment1Out": [m1o], "Moment2Out": [m2o]}
