"""Shared helpers for op lowerings and shape inference (the port's
counterpart of paddle_tpu/ops/common.py)."""

from __future__ import annotations

import torch

_TORCH_DTYPES = {
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "float32": torch.float32, "float64": torch.float64,
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool,
}


def to_torch_dtype(name: str) -> torch.dtype:
    return _TORCH_DTYPES[name]


def mxu_cast(ctx, *xs):
    """Mixed-precision policy hook for matmul/conv (JAX ops/common.py:77).

    Under AMP (program._amp_dtype, see amp.py) float32 operands are cast to
    the compute dtype (bfloat16). Level O1 returns float32 as the restore
    dtype, so the call site rounds the op result to bf16 once and casts it
    back; level O2 returns None: activations stay bf16 end to end. O3 is O2
    on this axis (JAX common.py:113): the quantized routing happens
    downstream of this cast, in the mul and conv2d lowerings.

    Returns (cast_operands_tuple, restore_dtype_or_None); call sites do
    `out = out.to(restore) if restore is not None else out`.
    """
    amp = getattr(ctx, "amp_dtype", None)
    if not amp:
        return xs, None
    cd = to_torch_dtype(amp)
    casted = tuple(x.to(cd) if x.dtype == torch.float32 else x for x in xs)
    if getattr(ctx, "amp_level", "O1") in ("O2", "O3"):
        return casted, None
    any_cast = any(c is not x for c, x in zip(casted, xs))
    return casted, (torch.float32 if any_cast else None)


def broadcast_y_to_x(x, y, axis: int):
    """Paddle elementwise broadcast: align y's dims to x starting at `axis`
    (reference operators/elementwise_op_function.h); axis == -1 aligns to
    the trailing dims."""
    if y.dim() == 0 or tuple(x.shape) == tuple(y.shape):
        return y
    if axis == -1:
        axis = x.dim() - y.dim()
        while axis < 0 and y.shape[-1] == 1:
            y = y.reshape(y.shape[:-1])
            axis += 1
    else:
        while axis + y.dim() > x.dim() and y.shape[-1] == 1:
            y = y.reshape(y.shape[:-1])
    if axis < 0 or axis + y.dim() > x.dim():
        raise ValueError(f"cannot broadcast y{tuple(y.shape)} to "
                         f"x{tuple(x.shape)} at axis {axis}")
    new_shape = (1,) * axis + tuple(y.shape) + (1,) * (x.dim() - axis - y.dim())
    return y.reshape(new_shape)


# --- shape inference helpers (copied from the JAX package) -----------------

def out_var(op, block, slot="Out", idx=0):
    names = op.desc.outputs.get(slot, [])
    if idx >= len(names):
        return None
    name = names[idx]
    return block.desc.vars.get(name) or _find_up(block, name)


def in_var(op, block, slot="X", idx=0):
    names = op.desc.inputs.get(slot, [])
    if idx >= len(names):
        return None
    return _find_up(block, names[idx])


def _find_up(block, name):
    b = block
    while b is not None:
        if b.desc.has_var(name):
            return b.desc.var(name)
        b = b.parent_block
    return None


def set_out(op, block, slot, shape, dtype):
    v = out_var(op, block, slot)
    if v is not None:
        v.shape = list(shape) if shape is not None else None
        if dtype is not None:
            v.dtype = dtype


def same_as_input(in_slot="X", out_slot="Out"):
    def infer(op, block):
        iv = in_var(op, block, in_slot)
        if iv is not None:
            set_out(op, block, out_slot, iv.shape, iv.dtype)
    return infer


def elementwise_infer(op, block):
    xv = in_var(op, block, "X")
    if xv is not None:
        set_out(op, block, "Out", xv.shape, xv.dtype)

