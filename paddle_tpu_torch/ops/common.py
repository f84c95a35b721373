"""Shared helpers for op lowerings and shape inference (the port's
counterpart of paddle_tpu/ops/common.py)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

_TORCH_DTYPES = {
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "float32": torch.float32, "float64": torch.float64,
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool,
}


def to_torch_dtype(name: str) -> torch.dtype:
    return _TORCH_DTYPES[name]


@dataclass
class SelectedRowsVal:
    """A sparse-rows gradient (reference framework/selected_rows.h:19; JAX
    ops/common.py:13): `rows` int [K] may repeat, as the reference's
    unmerged SelectedRows does, `values` [K, D] are the rows' cotangents,
    `height` the dense row count of the whole table. K is the number of
    lookups, never the number of distinct ids, so every shape is static
    and a step holding one can be captured as a CUDA graph. Consumers
    scatter-apply it (ops/sparse_ops.py) or densify it (`to_dense`)."""
    rows: torch.Tensor
    values: torch.Tensor
    height: int

    def to_dense(self) -> torch.Tensor:
        """The [height, D] table of row sums. index_put_ with accumulate
        sums each row's entries in index order on the card too, where
        index_add_'s atomics would add them in whatever order they land."""
        dense = torch.zeros((self.height,) + tuple(self.values.shape[1:]),
                            dtype=self.values.dtype, device=self.values.device)
        return dense.index_put_((self.rows.long(),), self.values,
                                accumulate=True)


def maybe_dense(v, count_as: Optional[str] = None):
    """Densify a SelectedRowsVal (identity otherwise). `count_as`, a site
    label like "fetch", records the densification in
    sparse_densify_fallback_total."""
    if isinstance(v, SelectedRowsVal):
        if count_as is not None:
            from . import sparse_ops
            sparse_ops.count_densify(count_as, "densified_at_" + count_as)
        return v.to_dense()
    return v


def merge_selected_rows(sr: SelectedRowsVal):
    """Duplicate rows summed (reference selected_rows_functor.cc MergeAdd;
    JAX common.py:49) with static shapes: (rows [K], values [K, D]), each
    distinct row's sum in the first slot of its run, freed slots carrying
    row = height. The ids are sorted stably and each run is summed in
    sorted order, in the values' dtype; no torch.unique, whose output size
    depends on the data and would sync with the host."""
    rows = sr.rows.reshape(-1)
    vals = sr.values
    k = rows.shape[0]
    r_s, order = torch.sort(rows, stable=True)
    v_s = vals[order]
    is_new = torch.ones(k, dtype=torch.bool, device=rows.device)
    is_new[1:] = r_s[1:] != r_s[:-1]
    seg = torch.cumsum(is_new, 0) - 1
    merged_vals = torch.zeros_like(v_s).index_put_((seg,), v_s,
                                                   accumulate=True)
    merged_rows = torch.full((k,), sr.height, dtype=rows.dtype,
                             device=rows.device).scatter_(0, seg, r_s)
    return merged_rows, merged_vals


def mxu_cast(ctx, *xs, formats=None):
    """Mixed-precision policy hook for matmul/conv (JAX ops/common.py:77).

    Under AMP (program._amp_dtype, see amp.py) float32 operands are cast to
    the compute dtype (bfloat16). Level O1 returns float32 as the restore
    dtype, so the call site rounds the op result to bf16 once and casts it
    back; level O2 returns None: activations stay bf16 end to end. O3 is O2
    on this axis (JAX common.py:113): the quantized routing happens
    downstream of this cast, in the mul and conv2d lowerings.

    `formats` gives each operand's memory format after a cast (default:
    preserved); the conv lowerings cast their filter into channels_last,
    the OIHW view of OHWI memory that the conv kernels read without a copy.

    Returns (cast_operands_tuple, restore_dtype_or_None); call sites do
    `out = out.to(restore) if restore is not None else out`.
    """
    amp = getattr(ctx, "amp_dtype", None)
    if not amp:
        return xs, None
    cd = to_torch_dtype(amp)
    formats = formats or (torch.preserve_format,) * len(xs)
    casted = tuple(x.to(cd, memory_format=f) if x.dtype == torch.float32
                   else x for x, f in zip(xs, formats))
    if getattr(ctx, "amp_level", "O1") in ("O2", "O3"):
        return casted, None
    any_cast = any(c is not x for c, x in zip(casted, xs))
    return casted, (torch.float32 if any_cast else None)


# a conv's (input, filter) formats under mxu_cast
CONV_FORMATS = (torch.preserve_format, torch.channels_last)


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

