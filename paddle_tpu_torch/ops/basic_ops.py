"""Basic ops: fills, randoms, scale, top_k, reshape, concat (the port's
counterpart of paddle_tpu/ops/basic_ops.py; reference fill_constant_op.cc,
uniform_random_op.cc, gaussian_random_op.cc, scale_op.cc, top_k_op.cc,
reshape_op.cc, concat_op.cc).

The random ops draw from a torch.Generator that the executor seeds per op
(executor.LoweringContext.generator). Its numbers differ from JAX's
threefry stream for the same seed, so tests carry the JAX package's
initialized parameters across (interop.py) instead of comparing draws.
"""

from __future__ import annotations

import numpy as np
import torch

from .common import in_var, same_as_input, set_out, to_torch_dtype
from .registry import NO_GRAD, cotangent, grad_op, op, register, zero_grads

# --- feed / fetch: no lowering, the executor handles them (reference
# feed_op.cc/fetch_op.cc) ------------------------------------------------------
register("feed", grad=NO_GRAD)
register("fetch", grad=NO_GRAD)


def _fill_constant_infer(op_, block):
    set_out(op_, block, "Out", op_.attr("shape"), op_.attr("dtype", "float32"))


@op("fill_constant", infer_shape=_fill_constant_infer, grad=NO_GRAD)
def _fill_constant(ctx, op_, ins):
    dtype = to_torch_dtype(op_.attr("dtype", "float32"))
    return {"Out": [torch.full(tuple(op_.attr("shape")),
                               op_.attr("value", 0.0), dtype=dtype,
                               device=ctx.device)]}


@op("uniform_random", infer_shape=_fill_constant_infer, grad=NO_GRAD)
def _uniform_random(ctx, op_, ins):
    dtype = to_torch_dtype(op_.attr("dtype", "float32"))
    lo, hi = op_.attr("min", -1.0), op_.attr("max", 1.0)
    u = torch.rand(tuple(op_.attr("shape")), generator=ctx.generator(op_),
                   dtype=torch.float32, device=ctx.device)
    return {"Out": [(u * (hi - lo) + lo).to(dtype)]}


@op("gaussian_random", infer_shape=_fill_constant_infer, grad=NO_GRAD)
def _gaussian_random(ctx, op_, ins):
    dtype = to_torch_dtype(op_.attr("dtype", "float32"))
    z = torch.randn(tuple(op_.attr("shape")), generator=ctx.generator(op_),
                    dtype=torch.float32, device=ctx.device)
    out = op_.attr("mean", 0.0) + op_.attr("std", 1.0) * z
    return {"Out": [out.to(dtype)]}


@op("scale", infer_shape=same_as_input())
def _scale(ctx, op_, ins):
    x = ins["X"][0]
    s = op_.attr("scale", 1.0)
    b = op_.attr("bias", 0.0)
    if op_.attr("bias_after_scale", True):
        return {"Out": [x * s + b]}
    return {"Out": [(x + b) * s]}


def _top_k_infer(op_, block):
    iv = in_var(op_, block, "X")
    k = op_.attr("k", 1)
    if iv is not None and iv.shape is not None:
        shape = list(iv.shape[:-1]) + [k]
        set_out(op_, block, "Out", shape, iv.dtype)
        set_out(op_, block, "Indices", shape, "int64")


@op("top_k", infer_shape=_top_k_infer, grad=NO_GRAD)
def _top_k(ctx, op_, ins):
    vals, idxs = torch.topk(ins["X"][0], op_.attr("k", 1), dim=-1)
    return {"Out": [vals], "Indices": [idxs.to(torch.int64)]}


# --- shape manipulation -------------------------------------------------------

def _reshape_infer(op_, block):
    """A 0 copies the input's dim; a -1 is inferred when every input dim is
    known (basic_ops.py:217)."""
    iv = in_var(op_, block, "X")
    shape = list(op_.attr("shape"))
    if iv is not None and iv.shape is not None and all(
            s is not None for s in iv.shape):
        src = list(iv.shape)
        shape = [src[i] if s == 0 else s for i, s in enumerate(shape)]
        if -1 in shape and all(s > 0 for s in src):
            total = int(np.prod(src))
            known = int(np.prod([s for s in shape if s != -1]))
            shape[shape.index(-1)] = total // known
    set_out(op_, block, "Out", shape, iv.dtype if iv else None)


@op("reshape", infer_shape=_reshape_infer)
def _reshape(ctx, op_, ins):
    x = ins["X"][0]
    shape = [x.shape[i] if s == 0 else s
             for i, s in enumerate(op_.attr("shape"))]
    return {"Out": [x.reshape(shape)]}


@grad_op("reshape")
def _reshape_grad(ctx, op_, ins):
    """dX = dOut in X's shape."""
    x = ins["X"][0]
    dout = cotangent(ins, "Out", ins["Out"][0])
    if dout is None:
        return zero_grads(op_, ins)
    return {"X@GRAD": [dout.reshape(x.shape)]}


def _concat_infer(op_, block):
    """The sum of the inputs' extents along `axis`, -1 where one is
    unknown; nothing where an input's rank is unknown (basic_ops.py:268)."""
    axis = op_.attr("axis", 0)
    shapes = []
    for i in range(len(op_.desc.inputs.get("X", []))):
        v = in_var(op_, block, "X", i)
        if v is None or v.shape is None:
            return
        shapes.append(list(v.shape))
    if any(len(s) <= axis for s in shapes):
        return
    out = list(shapes[0])
    if any(s[axis] is None or s[axis] < 0 for s in shapes):
        out[axis] = -1
    else:
        out[axis] = sum(s[axis] for s in shapes)
    set_out(op_, block, "Out", out, in_var(op_, block, "X").dtype)


@op("concat", infer_shape=_concat_infer)
def _concat(ctx, op_, ins):
    """Linear: the generic grad's autograd of torch.cat splits the
    cotangent back to the inputs."""
    return {"Out": [torch.cat(list(ins["X"]), dim=op_.attr("axis", 0))]}
