"""Misc and LoD-array ops: the LoD-array ops, `print`, fill, minus,
modified_huber_loss, l1_norm, average_accumulates and the host I/O ops
save, save_combine, load, load_combine (the port's counterpart of
paddle_tpu/ops/misc_ops.py; reference lod_tensor_to_array_op.cc,
array_to_lod_tensor_op.cc, split_lod_tensor_op.cc, merge_lod_tensor_op.cc,
reorder_lod_tensor_by_rank_op.cc, print_op.cc, fill_op.cc, minus_op.cc,
modified_huber_loss_op.h, l1_norm_op.cc, average_accumulates_op.h,
save_op.cc, load_op.cc, save_combine_op.cc, load_combine_op.cc).

The reference's row-routing LoD ops become dense masked selects: rows keep
their positions and no shape depends on the data.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from ..framework.desc import OpDesc
from ..framework.framework import grad_var_name
from .common import in_var, same_as_input, set_out, to_torch_dtype
from .control_flow_ops import TensorArrayVal
from .registry import NO_GRAD, op


def _table_lengths(ctx, op_, ins, slot="RankTable"):
    """The lengths of a rank table (the lengths vector lod_rank_table
    outputs, or the @SEQLEN of the var named), int32, or None."""
    names = op_.desc.inputs.get(slot, [])
    lens = ctx.seq_len(names[0]) if names else None
    if lens is None and names and ins.get(slot) and ins[slot][0] is not None:
        v = ins[slot][0]
        if isinstance(v, torch.Tensor) and v.dim() == 1:
            lens = v
    return None if lens is None else lens.to(torch.int32)


@op("lod_tensor_to_array", non_diff_inputs=("RankTable",))
def _lod_tensor_to_array(ctx, op_, ins):
    """A padded sequence batch as a time-major tensor array, array[t] =
    X[:, t] (JAX misc_ops.py:304): the full batch each step, the masks
    downstream supplying the reference's shrinking batches."""
    x = ins["X"][0]
    ctx.set_seq_len(op_.desc.outputs["Out"][0], _table_lengths(ctx, op_, ins))
    return {"Out": [TensorArrayVal(
        x.transpose(0, 1), torch.full((), x.shape[1], dtype=torch.int32,
                                      device=x.device))]}


@op("array_to_lod_tensor", non_diff_inputs=("RankTable",))
def _array_to_lod_tensor(ctx, op_, ins):
    """The inverse of lod_tensor_to_array (JAX misc_ops.py:320): the array
    stacked back into [batch, T, ...] with the lengths restored."""
    arr = ins["X"][0]
    if not isinstance(arr, TensorArrayVal):
        raise TypeError("array_to_lod_tensor needs a tensor array")
    lens = _table_lengths(ctx, op_, ins)
    if lens is None:
        lens = ctx.seq_len(op_.desc.inputs["X"][0])
    ctx.set_seq_len(op_.desc.outputs["Out"][0], lens)
    return {"Out": [arr.buffer.transpose(0, 1)]}


def _row_mask(mask, x):
    m = mask.reshape(-1).bool()
    return m.reshape((m.shape[0],) + (1,) * (x.dim() - 1))


@op("split_lod_tensor", non_diff_inputs=("Mask",))
def _split_lod_tensor(ctx, op_, ins):
    """Rows routed by a boolean mask (JAX misc_ops.py:334): each output
    keeps the row positions, the other side's rows zero."""
    x = ins["X"][0]
    m = _row_mask(ins["Mask"][0], x)
    zero = torch.zeros_like(x)
    return {"OutTrue": [torch.where(m, x, zero)],
            "OutFalse": [torch.where(m, zero, x)]}


@op("merge_lod_tensor", non_diff_inputs=("Mask",))
def _merge_lod_tensor(ctx, op_, ins):
    x_true = ins["InTrue"][0]
    m = _row_mask(ins["Mask"][0], x_true)
    return {"Out": [torch.where(m, x_true, ins["InFalse"][0])]}


@op("reorder_lod_tensor_by_rank", non_diff_inputs=("RankTable",))
def _reorder_lod_tensor_by_rank(ctx, op_, ins):
    """The sequences in rank-table order, descending length, ties in
    their order (JAX misc_ops.py:358)."""
    x = ins["X"][0]
    lens = _table_lengths(ctx, op_, ins)
    if lens is None:
        lens = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                          device=x.device)
    order = torch.sort(-lens, stable=True).indices
    ctx.set_seq_len(op_.desc.outputs["Out"][0], lens[order])
    return {"Out": [x.index_select(0, order)]}


def _print_grad_maker(fwd, no_grad_set):
    """print only observes: In@GRAD is Out@GRAD, through an assign (JAX
    misc_ops.py:98)."""
    in_name = fwd.inputs["In"][0]
    if in_name in no_grad_set:
        return []
    return [OpDesc(type="assign",
                   inputs={"X": [grad_var_name(fwd.outputs["Out"][0])]},
                   outputs={"Out": [grad_var_name(in_name)]})]


@op("print", grad=_print_grad_maker)
def _print(ctx, op_, ins):
    """Print the message, the var's name, shape and dtype and its values
    (the first `summarize` when it is positive) each time the op runs
    (reference print_op.cc; JAX misc_ops.py:115), and pass the input on.
    A block holding one runs eager (the executor's graph gate), so every
    run prints."""
    x = ins["In"][0]
    summarize = op_.attr("summarize", -1)
    shown = x.reshape(-1)[:summarize] if summarize and summarize > 0 else x
    print(f"{op_.attr('message', '') or ''}{op_.desc.inputs['In'][0]} "
          f"shape={tuple(x.shape)} dtype={x.dtype} {shown.detach().cpu()}",
          flush=True)
    return {"Out": [x]}


# --- small tensor ops (reference fill_op.cc, minus_op.cc,
# modified_huber_loss_op.h, l1_norm_op.cc; JAX misc_ops.py:46-95) --------------

def _fill_infer(op_, block):
    set_out(op_, block, "Out", list(op_.attr("shape")),
            op_.attr("dtype", "float32"))


@op("fill", infer_shape=_fill_infer, grad=NO_GRAD)
def _fill(ctx, op_, ins):
    """Out holds the literal `value` list at `shape`, copied to the device
    once (Executor.constant)."""
    dtype = op_.attr("dtype", "float32")
    arr = np.asarray(op_.attr("value"), dtype=np.dtype(dtype)).reshape(
        list(op_.attr("shape")))
    return {"Out": [ctx.executor.constant(arr, to_torch_dtype(dtype))]}


@op("minus", infer_shape=same_as_input())
def _minus(ctx, op_, ins):
    return {"Out": [ins["X"][0] - ins["Y"][0]]}


def _mhl_infer(op_, block):
    xv = in_var(op_, block, "X")
    if xv is not None and xv.shape is not None:
        set_out(op_, block, "IntermediateVal", xv.shape, xv.dtype)
        set_out(op_, block, "Out", [xv.shape[0], 1], xv.dtype)


@op("modified_huber_loss", infer_shape=_mhl_infer, non_diff_inputs=("Y",))
def _modified_huber_loss(ctx, op_, ins):
    """Labels in {0, 1}, a = x (2y - 1): -4a below -1, (1 - a)^2 below 1,
    0 above."""
    x, y = ins["X"][0], ins["Y"][0]
    a = x * (2.0 * y - 1.0)
    zero = torch.zeros_like(a)
    loss = torch.where(a < -1.0, -4.0 * a,
                       torch.where(a < 1.0, (1.0 - a) ** 2, zero))
    return {"IntermediateVal": [a], "Out": [loss.reshape(x.shape[0], 1)]}


def _l1_infer(op_, block):
    xv = in_var(op_, block, "X")
    if xv is not None:
        set_out(op_, block, "Out", [1], xv.dtype)


@op("l1_norm", infer_shape=_l1_infer)
def _l1_norm(ctx, op_, ins):
    from .math_ops import _abs
    return {"Out": [torch.sum(_abs(ins["X"][0])).reshape(1)]}


# --- ModelAverage's accumulators (reference average_accumulates_op.h; JAX
# misc_ops.py:129-184) ---------------------------------------------------------

K_MAX_ACC = 16384   # reference average_accumulates_op.h kMaxNumAccumulates


def _saturate_i32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> int32 truncating toward zero and saturating at the int32
    range, as XLA's convert does (torch's cast of 2^31 wraps)."""
    return torch.clamp(x.double(), -2.0 ** 31, 2.0 ** 31 - 1).to(torch.int32)


@op("average_accumulates", grad=NO_GRAD,
    non_diff_inputs=("param", "in_sum_1", "in_sum_2", "in_sum_3",
                     "in_num_accumulates", "in_old_num_accumulates",
                     "in_num_updates"))
def _average_accumulates(ctx, op_, ins):
    """One step of ModelAverage's sums: sum_1 gathers the parameter, spills
    into sum_2 every K_MAX_ACC updates, and once the window holds
    min_average_window updates and min(max_average_window, num_updates *
    average_window) of them the window's sums move to sum_3 and the count
    to old_num_accumulates. The C++ branches are selects on the device,
    so a CUDA graph captures the step and no count is read on the host."""
    param = ins["param"][0]
    s1, s2, s3 = ins["in_sum_1"][0], ins["in_sum_2"][0], ins["in_sum_3"][0]

    def count(slot):
        return ins[slot][0].reshape(()).to(torch.int32)

    num_acc = count("in_num_accumulates") + 1
    old_num_acc = count("in_old_num_accumulates")
    num_upd = count("in_num_updates") + 1
    avg_win = op_.attr("average_window", 0.0)
    max_win = op_.attr("max_average_window", 2 ** 31 - 1)
    min_win = min(op_.attr("min_average_window", 10000), max_win)

    s1 = s1 + param
    spill = (num_upd % K_MAX_ACC) == 0
    zeros = torch.zeros_like(s1)
    s2 = torch.where(spill, s2 + s1, s2)
    s1 = torch.where(spill, zeros, s1)
    dev = num_upd.device
    limit = torch.minimum(
        torch.full((), float(max_win), dtype=torch.float32, device=dev),
        num_upd.to(torch.float32)
        * torch.full((), avg_win, dtype=torch.float32, device=dev))
    full = (num_acc >= min_win) & (num_acc >= _saturate_i32(limit))
    s3 = torch.where(full, s1 + s2, s3)
    s1 = torch.where(full, zeros, s1)
    s2 = torch.where(full, zeros, s2)
    old_num_acc = torch.where(full, num_acc, old_num_acc)
    num_acc = torch.where(full, torch.zeros_like(num_acc), num_acc)
    return {"out_sum_1": [s1], "out_sum_2": [s2], "out_sum_3": [s3],
            "out_num_accumulates": [num_acc.reshape(1)],
            "out_old_num_accumulates": [old_num_acc.reshape(1)],
            "out_num_updates": [num_upd.reshape(1)]}


# --- save / load as ops (reference save_op.cc, save_combine_op.cc,
# load_op.cc, load_combine_op.cc; JAX misc_ops.py:196-290) ----------------------
# They read or write a file on the host, in io._save_one's format: one pickled
# {"tensor", "lod", "version"} a variable, or {name: (array, lod)} for the
# combined file, so either package reads what the other wrote. A block that
# holds one runs eager (executor.HOST_IO_OPS): a CUDA graph's replay would
# skip the write or return the file's value at capture.

def _host_array(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _save_payload(path, overwrite, payload):
    if not overwrite and os.path.exists(path):
        raise IOError(f"save op: '{path}' exists and overwrite is False")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(payload, f)


@op("save", grad=NO_GRAD)
def _save(ctx, op_, ins):
    _save_payload(op_.attr("file_path"), op_.attr("overwrite", True),
                  {"tensor": _host_array(ins["X"][0]), "lod": None,
                   "version": 0})
    return {}


@op("save_combine", grad=NO_GRAD)
def _save_combine(ctx, op_, ins):
    names = op_.desc.inputs["X"]
    _save_payload(op_.attr("file_path"), op_.attr("overwrite", True),
                  {n: (_host_array(v), None) for n, v in zip(names, ins["X"])})
    return {}


def _declared(op_, slot, idx=0):
    """(static shape or None, dtype name or None) of output `slot`[idx] as
    its variable declares them."""
    name = op_.desc.outputs[slot][idx]
    b = getattr(op_, "block", None)
    while b is not None:
        if b.desc.has_var(name):
            v = b.desc.var(name)
            shape = tuple(v.shape) if v.shape is not None and all(
                s is not None and s >= 0 for s in v.shape) else None
            return shape, v.dtype
        b = b.parent_block
    return None, None


def _loaded(ctx, op_, arr, idx=0):
    """A file's array on the device in its output's declared dtype and
    static shape (the file's own where the variable declares none)."""
    shape, dtype = _declared(op_, "Out", idx)
    arr = np.asarray(arr)
    if dtype is not None:
        arr = arr.astype(np.float32 if dtype == "bfloat16" else dtype)
    if shape is not None:
        arr = arr.reshape(shape)
    t = torch.as_tensor(np.ascontiguousarray(arr), device=ctx.device)
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


@op("load", grad=NO_GRAD)
def _load(ctx, op_, ins):
    with open(op_.attr("file_path"), "rb") as f:
        d = pickle.load(f)
    return {"Out": [_loaded(ctx, op_, d["tensor"])]}


@op("load_combine", grad=NO_GRAD)
def _load_combine(ctx, op_, ins):
    with open(op_.attr("file_path"), "rb") as f:
        d = pickle.load(f)
    return {"Out": [_loaded(ctx, op_, d[n][0], i)
                    for i, n in enumerate(op_.desc.outputs["Out"])]}
