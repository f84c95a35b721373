"""The LoD-array ops and `print` (the port's counterpart of the part of
paddle_tpu/ops/misc_ops.py that control flow uses; reference
lod_tensor_to_array_op.cc, array_to_lod_tensor_op.cc,
split_lod_tensor_op.cc, merge_lod_tensor_op.cc,
reorder_lod_tensor_by_rank_op.cc, print_op.cc).

The reference's row-routing LoD ops become dense masked selects: rows keep
their positions and no shape depends on the data.
"""

from __future__ import annotations

import torch

from ..framework.desc import OpDesc
from ..framework.framework import grad_var_name
from .control_flow_ops import TensorArrayVal
from .registry import op


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
