"""Basic ops: fills, randoms, casts, scale, shape manipulation, indexing,
sign and clipping (the port's counterpart of paddle_tpu/ops/basic_ops.py;
reference fill_constant_op.cc, uniform_random_op.cc, gaussian_random_op.cc,
scale_op.cc, top_k_op.cc, reshape_op.cc, concat_op.cc, split_op.cc,
expand_op.cc, gather_op.cc, scatter_op.cc, one_hot_op.cc, multiplex_op.cc,
sign_op.cc, clip_op.cc, clip_by_norm_op.cc).

The random ops draw from a torch.Generator that the executor seeds per op
(executor.LoweringContext.generator). Its numbers differ from JAX's
threefry stream for the same seed, so tests carry the JAX package's
initialized parameters across (interop.py) instead of comparing draws.
"""

from __future__ import annotations

import numpy as np
import torch

from .common import in_var, out_var, same_as_input, set_out, to_torch_dtype
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


# --- fills like another tensor (reference fill_zeros_like_op.cc,
# fill_constant_batch_size_like_op.cc; JAX basic_ops.py:46-88) ----------------

def _fill_like_infer(op_, block):
    iv = in_var(op_, block, "X")
    if iv is not None:
        set_out(op_, block, "Out", iv.shape, op_.attr("dtype") or iv.dtype)


@op("fill_zeros_like", infer_shape=_fill_like_infer, grad=NO_GRAD)
def _fill_zeros_like(ctx, op_, ins):
    return {"Out": [torch.zeros_like(ins["X"][0])]}


def _fill_bsl_infer(op_, block):
    shape = list(op_.attr("shape"))
    iv = in_var(op_, block, "Input")
    if iv is not None and iv.shape is not None:
        shape[op_.attr("output_dim_idx", 0)] = \
            iv.shape[op_.attr("input_dim_idx", 0)]
    set_out(op_, block, "Out", shape, op_.attr("dtype", "float32"))


@op("fill_constant_batch_size_like", infer_shape=_fill_bsl_infer,
    grad=NO_GRAD)
def _fill_constant_bsl(ctx, op_, ins):
    x = ins["Input"][0]
    shape = list(op_.attr("shape"))
    shape[op_.attr("output_dim_idx", 0)] = x.shape[op_.attr("input_dim_idx", 0)]
    return {"Out": [torch.full(tuple(shape), op_.attr("value", 0.0),
                               dtype=to_torch_dtype(op_.attr("dtype",
                                                             "float32")),
                               device=x.device)]}


def _fill_tensor_infer(op_, block):
    set_out(op_, block, "Out", op_.attr("shape"), op_.attr("dtype", "float32"))


def _attr_constant(ctx, values, dtype_name, shape):
    """A static attr's values as a device tensor: the Executor's copy made
    once (`Executor.constant`), so a CUDA graph's capture finds it."""
    arr = np.asarray(values, dtype=np.dtype(dtype_name)).reshape(shape)
    return ctx.executor.constant(arr, to_torch_dtype(dtype_name))


@op("fill_constant_tensor", infer_shape=_fill_tensor_infer, grad=NO_GRAD)
def _fill_constant_tensor(ctx, op_, ins):
    """A literal ndarray (layers.assign of numpy data)."""
    return {"Out": [_attr_constant(ctx, op_.attr("values"),
                                   op_.attr("dtype", "float32"),
                                   tuple(op_.attr("shape")))]}


def _assign_value_infer(op_, block):
    set_out(op_, block, "Out", list(op_.attr("shape")),
            op_.attr("dtype", "float32"))


@op("assign_value", infer_shape=_assign_value_infer, grad=NO_GRAD)
def _assign_value(ctx, op_, ins):
    """A compile-time constant (reference assign_value_op.cc; JAX
    misc_ops.py:37)."""
    vals = op_.attr("fp32_values", None) or op_.attr("int32_values", None)
    return {"Out": [_attr_constant(ctx, vals, op_.attr("dtype", "float32"),
                                   tuple(op_.attr("shape")))]}


# --- arg max / min (reference arg_max_op.cc; JAX basic_ops.py:82-99) -------

def _arg_infer(op_, block):
    iv = in_var(op_, block, "X")
    axis = op_.attr("axis", 0)
    if iv is not None and iv.shape is not None:
        shape = [d for i, d in enumerate(iv.shape)
                 if i != axis % len(iv.shape)]
        set_out(op_, block, "Out", shape or [1], "int64")


@op("arg_max", infer_shape=_arg_infer, grad=NO_GRAD)
def _arg_max(ctx, op_, ins):
    """The first index of the largest value, as jnp.argmax takes it."""
    return {"Out": [torch.argmax(ins["X"][0], dim=op_.attr("axis", 0))]}


@op("arg_min", infer_shape=_arg_infer, grad=NO_GRAD)
def _arg_min(ctx, op_, ins):
    return {"Out": [torch.argmin(ins["X"][0], dim=op_.attr("axis", 0))]}


# --- assign / cast / increment (JAX basic_ops.py:150-193) -----------------

@op("assign", infer_shape=same_as_input("X", "Out"))
def _assign(ctx, op_, ins):
    return {"Out": [ins["X"][0]]}


def _cast_infer(op_, block):
    iv = in_var(op_, block, "X")
    set_out(op_, block, "Out", iv.shape if iv else None,
            op_.attr("out_dtype", "float32"))


def _cast_grad(fwd, no_grad_set):
    """The grad of a cast is the cast back (JAX basic_ops.py:161)."""
    from ..framework.desc import OpDesc
    from ..framework.framework import grad_var_name
    xname = fwd.input("X")[0]
    if xname in no_grad_set:
        return []
    return [OpDesc(type="cast",
                   inputs={"X": [grad_var_name(fwd.output("Out")[0])]},
                   outputs={"Out": [grad_var_name(xname)]},
                   attrs={"in_dtype": fwd.attr("out_dtype", "float32"),
                          "out_dtype": fwd.attr("in_dtype", "float32")})]


@op("cast", infer_shape=_cast_infer, grad=_cast_grad)
def _cast(ctx, op_, ins):
    return {"Out": [ins["X"][0].to(
        to_torch_dtype(op_.attr("out_dtype", "float32")))]}


@op("increment", infer_shape=same_as_input())
def _increment(ctx, op_, ins):
    """x + step in x's dtype; d(x + c)/dx = 1 through the generic grad."""
    x = ins["X"][0]
    step = op_.attr("step", 1.0)
    return {"Out": [x + (step if x.is_floating_point() else int(step))]}


# --- transpose (reference transpose_op.cc) ----------------------------------

def _transpose_infer(op_, block):
    iv = in_var(op_, block, "X")
    axis = op_.attr("axis")
    if iv is not None and iv.shape is not None:
        set_out(op_, block, "Out", [iv.shape[a] for a in axis], iv.dtype)


@op("transpose", infer_shape=_transpose_infer)
def _transpose(ctx, op_, ins):
    return {"Out": [ins["X"][0].permute(*op_.attr("axis"))]}


# --- compare / logical (reference compare_op.cc, logical_op.cc; JAX
# basic_ops.py:455-497) --------------------------------------------------------

def _cmp_infer(op_, block):
    xv = in_var(op_, block, "X")
    if xv is not None:
        set_out(op_, block, "Out", xv.shape, "bool")


_BINARY_BOOL = {
    "less_than": torch.lt, "less_equal": torch.le, "greater_than": torch.gt,
    "greater_equal": torch.ge, "equal": torch.eq, "not_equal": torch.ne,
    "logical_and": torch.logical_and, "logical_or": torch.logical_or,
    "logical_xor": torch.logical_xor,
}


def _make_binary(fn):
    def lower(ctx, op_, ins):
        return {"Out": [fn(ins["X"][0], ins["Y"][0])]}
    return lower


for _n, _f in _BINARY_BOOL.items():
    register(_n, lower=_make_binary(_f), infer_shape=_cmp_infer, grad=NO_GRAD)


@op("logical_not", infer_shape=_cmp_infer, grad=NO_GRAD)
def _logical_not(ctx, op_, ins):
    return {"Out": [torch.logical_not(ins["X"][0])]}


@op("is_empty", grad=NO_GRAD)
def _is_empty(ctx, op_, ins):
    x = ins["X"][0]
    return {"Out": [torch.full((), x.numel() == 0, dtype=torch.bool,
                               device=x.device)]}


@op("shape", grad=NO_GRAD)
def _shape(ctx, op_, ins):
    x = ins["Input"][0] if "Input" in op_.desc.inputs else ins["X"][0]
    return {"Out": [_attr_constant(ctx, list(x.shape), "int64",
                                   (x.dim(),))]}


# --- batch-size-like randoms (JAX basic_ops.py:124-146) ------------------------

def _bsl_shape(op_, x):
    shape = list(op_.attr("shape"))
    shape[op_.attr("output_dim_idx", 0)] = x.shape[op_.attr("input_dim_idx", 0)]
    return tuple(shape)


def _bsl_draw(ctx, op_, x, draw):
    """A batch-size-like random op's value: `draw(shape)` at its shape. In
    a sharded run whose batch splits the Input's dim 0 over ranks
    (parallel/spmd.py) dropout's rule applies: the global batch's values
    drawn, this rank's rows kept, so the ranks together hold what one
    device draws."""
    shape = _bsl_shape(op_, x)
    spmd = getattr(ctx, "spmd", None)
    if spmd is None or op_.attr("input_dim_idx", 0) != 0 or \
            not spmd.slot_split(op_, "Input"):
        return draw(shape)
    out_dim = op_.attr("output_dim_idx", 0)

    def whole(rows):
        s = list(shape)
        s[out_dim] = rows
        return draw(tuple(s))
    return spmd.global_rows(x.shape[0], whole, dim=out_dim)


@op("uniform_random_batch_size_like", infer_shape=_fill_bsl_infer,
    grad=NO_GRAD)
def _uniform_random_bsl(ctx, op_, ins):
    """uniform_random at the shape attr with one dim taken from Input."""
    dtype = to_torch_dtype(op_.attr("dtype", "float32"))
    lo, hi = op_.attr("min", -1.0), op_.attr("max", 1.0)
    u = _bsl_draw(ctx, op_, ins["Input"][0], lambda shape: torch.rand(
        shape, generator=ctx.generator(op_), dtype=torch.float32,
        device=ctx.device))
    return {"Out": [(u * (hi - lo) + lo).to(dtype)]}


@op("gaussian_random_batch_size_like", infer_shape=_fill_bsl_infer,
    grad=NO_GRAD)
def _gaussian_random_bsl(ctx, op_, ins):
    dtype = to_torch_dtype(op_.attr("dtype", "float32"))
    z = _bsl_draw(ctx, op_, ins["Input"][0], lambda shape: torch.randn(
        shape, generator=ctx.generator(op_), dtype=torch.float32,
        device=ctx.device))
    out = op_.attr("mean", 0.0) + op_.attr("std", 1.0) * z
    return {"Out": [out.to(dtype)]}


# --- sign / clip (reference sign_op.cc, clip_op.cc, clip_by_norm_op.cc;
# JAX basic_ops.py:196-213) -----------------------------------------------------

@op("sign", infer_shape=same_as_input(), grad=NO_GRAD)
def _sign(ctx, op_, ins):
    return {"Out": [torch.sign(ins["X"][0])]}


@op("clip", infer_shape=same_as_input())
def _clip(ctx, op_, ins):
    """jnp.clip: min(max(x, lo), hi), whose gradient splits a tie on a
    bound between x and the bound (math_ops._clip)."""
    from .math_ops import _clip as clip_fn
    return {"Out": [clip_fn(ins["X"][0], op_.attr("min"), op_.attr("max"))]}


@op("clip_by_norm", infer_shape=same_as_input())
def _clip_by_norm(ctx, op_, ins):
    """x scaled to L2 norm `max_norm` when its norm exceeds it; the scale
    is computed in the norm's dtype and applied in x's."""
    x = ins["X"][0]
    max_norm = op_.attr("max_norm")
    norm = torch.sqrt(torch.sum(x * x))
    scale = torch.where(norm > max_norm,
                        max_norm / torch.clamp(norm, min=1e-12),
                        torch.ones_like(norm))
    return {"Out": [x * scale.to(x.dtype)]}


# --- shape manipulation (JAX basic_ops.py:259-390) ------------------------------

def _same_shape_infer(op_, block):
    iv = in_var(op_, block, "X")
    if iv is not None and iv.shape is not None:
        set_out(op_, block, "Out", list(iv.shape), iv.dtype)


@op("reverse", infer_shape=_same_shape_infer)
def _reverse(ctx, op_, ins):
    """x flipped along the `axis` list; linear, so the generic grad flips
    the cotangent back."""
    return {"Out": [torch.flip(ins["X"][0], tuple(op_.attr("axis")))]}


def _set_out_i(op_, block, slot, i, shape, dtype):
    v = out_var(op_, block, slot, i)
    if v is not None:
        v.shape = list(shape) if shape is not None else None
        v.dtype = dtype


def _split_infer(op_, block):
    iv = in_var(op_, block, "X")
    axis = op_.attr("axis", 0)
    n = len(op_.desc.outputs.get("Out", []))
    sections = op_.attr("sections") or None
    if iv is None or iv.shape is None:
        return
    for i in range(n):
        s = list(iv.shape)
        if sections:
            s[axis] = sections[i]
        elif s[axis] is not None and s[axis] > 0:
            s[axis] = s[axis] // n
        _set_out_i(op_, block, "Out", i, s, iv.dtype)


@op("split", infer_shape=_split_infer)
def _split(ctx, op_, ins):
    """`sections` sizes along `axis`, or `num` equal parts."""
    x = ins["X"][0]
    axis = op_.attr("axis", 0)
    sections = op_.attr("sections") or None
    if sections:
        return {"Out": list(torch.split(x, list(sections), dim=axis))}
    n = op_.attr("num", 0) or len(op_.desc.outputs["Out"])
    return {"Out": list(torch.split(x, x.shape[axis] // n, dim=axis))}


def _expand_infer(op_, block):
    iv = in_var(op_, block, "X")
    times = op_.attr("expand_times")
    if iv is not None and iv.shape is not None:
        set_out(op_, block, "Out",
                [None if d is None else d * t
                 for d, t in zip(iv.shape, times)], iv.dtype)


@op("expand", infer_shape=_expand_infer)
def _expand(ctx, op_, ins):
    """jnp.tile: each dim repeated `expand_times` times."""
    return {"Out": [ins["X"][0].repeat(*op_.attr("expand_times"))]}


def _squeeze_axes(shape, axes):
    if axes:
        axes = [a % len(shape) for a in axes]
        return [d for i, d in enumerate(shape) if i not in axes]
    return [d for d in shape if d != 1]


def _squeeze_infer(op_, block):
    iv = in_var(op_, block, "X")
    if iv is not None and iv.shape is not None:
        set_out(op_, block, "Out",
                _squeeze_axes(list(iv.shape), op_.attr("axes") or []),
                iv.dtype)


@op("squeeze", infer_shape=_squeeze_infer)
def _squeeze(ctx, op_, ins):
    x = ins["X"][0]
    return {"Out": [x.reshape(_squeeze_axes(list(x.shape),
                                            op_.attr("axes") or []))]}


def _unsqueeze_infer(op_, block):
    iv = in_var(op_, block, "X")
    if iv is not None and iv.shape is not None:
        shape = list(iv.shape)
        for a in sorted(op_.attr("axes")):
            shape.insert(a, 1)
        set_out(op_, block, "Out", shape, iv.dtype)


@op("unsqueeze", infer_shape=_unsqueeze_infer)
def _unsqueeze(ctx, op_, ins):
    x = ins["X"][0]
    for a in sorted(op_.attr("axes")):
        x = x.unsqueeze(a)
    return {"Out": [x]}


# --- indexing (reference gather_op.cc, scatter_op.cc, one_hot_op.cc,
# multiplex_op.cc; JAX basic_ops.py:394-450) -----------------------------------

def _gather_infer(op_, block):
    xv, iv = in_var(op_, block, "X"), in_var(op_, block, "Index")
    if xv is not None and xv.shape is not None and iv is not None \
            and iv.shape is not None:
        set_out(op_, block, "Out", list(iv.shape[:1]) + list(xv.shape[1:]),
                xv.dtype)


@op("gather", infer_shape=_gather_infer, non_diff_inputs=("Index",))
def _gather(ctx, op_, ins):
    """Rows of X by Index; the generic grad adds the cotangent's rows back
    into place (a repeated index sums)."""
    idx = ins["Index"][0].reshape(-1).long()
    return {"Out": [ins["X"][0].index_select(0, idx)]}


@op("scatter", infer_shape=same_as_input("X", "Out"), non_diff_inputs=("Ids",))
def _scatter(ctx, op_, ins):
    """X with rows Ids overwritten by Updates (x.at[ids].set(upd)). Which
    of a repeated id's rows wins is left open in both packages, and is not
    deterministic on the card."""
    ids = ins["Ids"][0].reshape(-1).long()
    return {"Out": [ins["X"][0].index_put((ids,), ins["Updates"][0])]}


def _one_hot_infer(op_, block):
    iv = in_var(op_, block, "X")
    if iv is not None and iv.shape is not None:
        shape = list(iv.shape)
        if shape and shape[-1] == 1:
            shape = shape[:-1]
        set_out(op_, block, "Out", shape + [op_.attr("depth")], "float32")


@op("one_hot", infer_shape=_one_hot_infer, grad=NO_GRAD)
def _one_hot(ctx, op_, ins):
    """f32 one-hot rows of depth `depth`, as jax.nn.one_hot builds them:
    a comparison with 0..depth-1, so an id out of range gives a row of
    zeros, and nothing is read back to the host."""
    x = ins["X"][0]
    if x.dim() and x.shape[-1] == 1:
        x = x.reshape(x.shape[:-1])
    depth = torch.arange(op_.attr("depth"), device=x.device)
    return {"Out": [(x.unsqueeze(-1) == depth).to(torch.float32)]}


@op("multiplex", non_diff_inputs=("Ids",))
def _multiplex(ctx, op_, ins):
    """Row i of the output is row i of X[Ids[i]]."""
    ids = ins["Ids"][0].reshape(-1).long()
    stack = torch.stack(list(ins["X"]), dim=0)
    rows = torch.arange(stack.shape[1], device=stack.device)
    return {"Out": [stack[ids, rows]]}
