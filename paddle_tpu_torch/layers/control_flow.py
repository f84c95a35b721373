"""Control-flow DSL, the port's copy of paddle_tpu/layers/control_flow.py
(reference: python/paddle/fluid/layers/control_flow.py:
While :607, StaticRNN :382, DynamicRNN :1349, IfElse :1247, Switch :1158,
ConditionalBlock :1101, array ops :888-1058, increment, less_than).

Sub-blocks are real IR blocks; the executor runs them through the
`while`, `conditional_block` and `rnn` lowerings (ops/control_flow_ops.py):
a Python loop or branch on a condition read on the host, and a loop over
the padded time axis."""

from __future__ import annotations

import contextlib
from typing import List, Optional

from ..framework.desc import BlockRef, VarType
from ..framework.framework import (Variable, default_main_program)
from ..layer_helper import LayerHelper
from . import tensor as tensor_layers

__all__ = [
    "While", "StaticRNN", "DynamicRNN", "IfElse", "Switch",
    "ConditionalBlock", "array_read", "array_write", "array_length",
    "create_array", "increment", "less_than", "equal", "zeros_like",
    "lod_rank_table", "max_sequence_len", "lod_tensor_to_array",
    "array_to_lod_tensor", "split_lod_tensor", "merge_lod_tensor",
    "reorder_lod_tensor_by_rank", "shrink_memory", "Print",
]


def Print(input, first_n=-1, message=None, summarize=-1,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=True,
          print_phase="both"):
    """Execution-time tensor logging (reference control_flow.py:149 Print
    over print_op.cc): returns a pass-through of `input` that prints the
    message + value every time the step runs. The
    formatting flags are accepted for parity; name/shape/dtype are always
    shown, `summarize` truncates the printed values. In the port the block
    runs eager (the executor's graph gate), so every run prints."""
    helper = LayerHelper("print")
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="print", inputs={"In": [input]},
                     outputs={"Out": [out]},
                     attrs={"message": message or "",
                            "summarize": summarize,
                            "first_n": first_n,
                            "print_phase": print_phase})
    return out


def increment(x, value=1.0, in_place=True):
    """x += value (reference control_flow.py increment)."""
    helper = LayerHelper("increment")
    out = x if in_place else helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(type="increment", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"step": float(value)})
    return out


def less_than(x, y, cond=None):
    helper = LayerHelper("less_than")
    if cond is None:
        cond = helper.create_tmp_variable(dtype="bool")
    helper.append_op(type="less_than", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [cond]})
    return cond


def equal(x, y, cond=None):
    helper = LayerHelper("equal")
    if cond is None:
        cond = helper.create_tmp_variable(dtype="bool")
    helper.append_op(type="equal", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [cond]})
    return cond


def zeros_like(x, out=None):
    helper = LayerHelper("zeros_like")
    if out is None:
        out = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(type="fill_zeros_like", inputs={"X": [x]},
                     outputs={"Out": [out]})
    return out


# --- tensor arrays ----------------------------------------------------------

def create_array(dtype):
    """Create a LOD_TENSOR_ARRAY var (reference control_flow.py:888)."""
    helper = LayerHelper("array")
    return helper.main_program.current_block().create_var(
        name=None, dtype=dtype, type=VarType.LOD_TENSOR_ARRAY)


def array_write(x, i, array=None, capacity=None):
    """array[i] = x (reference control_flow.py array_write)."""
    helper = LayerHelper("array_write")
    if array is None:
        array = create_array(x.dtype)
    attrs = {}
    if capacity is not None:
        attrs["capacity"] = int(capacity)
    helper.append_op(type="write_to_array",
                     inputs={"X": [x], "I": [i], "Out": [array]},
                     outputs={"Out": [array]}, attrs=attrs)
    return array


def array_read(array, i):
    helper = LayerHelper("array_read")
    out = helper.create_tmp_variable(dtype=array.dtype)
    helper.append_op(type="read_from_array",
                     inputs={"X": [array], "I": [i]},
                     outputs={"Out": [out]})
    return out


def array_length(array):
    helper = LayerHelper("array_length")
    out = helper.create_tmp_variable(dtype="int64")
    helper.append_op(type="lod_array_length", inputs={"X": [array]},
                     outputs={"Out": [out]})
    return out


# --- While ------------------------------------------------------------------

class While:
    """while (cond) { ... } (reference control_flow.py:607).

    cond must be a bool Variable; every loop-state var (anything assigned in
    the body that must survive iterations, including cond) must hold a value
    before the loop starts.

    max_iters bounds the step-scope recording used by while_grad (default
    128); a training loop that exceeds it gets NaN-poisoned gradients, so
    raise it to the true iteration bound for long loops.
    """

    def __init__(self, cond, name=None, max_iters=None):
        self.helper = LayerHelper("while", name=name)
        self.cond_var = cond
        self.max_iters = max_iters

    @contextlib.contextmanager
    def block(self):
        program = self.helper.main_program
        parent_block = program.current_block()
        sub_block = program.create_block()
        try:
            yield
        finally:
            program.rollback()

        # reads: consumed names not produced inside; writes: produced names
        # that already exist in the parent chain (loop state)
        produced, reads, writes = set(), [], []
        for op_ in sub_block.ops:
            for n in op_.input_arg_names:
                if n not in produced and n not in reads:
                    reads.append(n)
            for n in op_.output_arg_names:
                produced.add(n)
                if parent_block.has_var_recursive(n) and n not in writes:
                    writes.append(n)
        x_names = [n for n in reads
                   if parent_block.has_var_recursive(n)]
        attrs = {"sub_block": BlockRef(sub_block.idx)}
        if self.max_iters is not None:
            attrs["max_loop_iters"] = int(self.max_iters)
        parent_block.append_op(
            type="while",
            inputs={"Condition": [self.cond_var.name], "X": x_names},
            outputs={"Out": writes},
            attrs=attrs)


# --- ConditionalBlock / IfElse / Switch -------------------------------------

class ConditionalBlock:
    """Guarded block (reference control_flow.py:1101)."""

    def __init__(self, inputs, is_scalar_condition=False, name=None):
        for each_input in inputs:
            assert isinstance(each_input, Variable)
        self.inputs = inputs
        self.is_scalar_condition = is_scalar_condition
        self.helper = LayerHelper("conditional_block", name=name)

    @contextlib.contextmanager
    def block(self):
        program = self.helper.main_program
        parent_block = program.current_block()
        sub_block = program.create_block()
        try:
            yield
        finally:
            program.rollback()
        out_names, produced, reads = [], set(), []
        for op_ in sub_block.ops:
            for n in op_.input_arg_names:
                if n not in produced and n not in reads:
                    reads.append(n)
            for n in op_.output_arg_names:
                produced.add(n)
                if n not in out_names:
                    out_names.append(n)
        # explicit reads (weights, pre-existing outputs) so grads flow to
        # them through conditional_block_grad instead of being closure
        # constants under vjp
        x_names = [n for n in reads if parent_block.has_var_recursive(n)]
        for n in out_names:
            if parent_block.has_var_recursive(n) and n not in x_names:
                x_names.append(n)
        parent_block.append_op(
            type="conditional_block",
            inputs={"Cond": [v.name for v in self.inputs], "X": x_names},
            outputs={"Out": out_names},
            attrs={"sub_block": BlockRef(sub_block.idx),
                   "is_scalar_condition": self.is_scalar_condition})


class IfElse:
    """if/else over a batch-wise bool condition (reference
    control_flow.py:1247). The reference scatters true/false rows into
    sub-blocks; the dense lowering evaluates both branches on the full batch
    and selects rows by the condition mask."""

    OUT_IF_ELSE_BLOCKS = 2

    def __init__(self, cond, name=None):
        self.helper = LayerHelper("ifelse", name=name)
        self.cond = cond
        self.in_else = False
        self.true_outs: List[Variable] = []
        self.false_outs: List[Variable] = []

    def input(self, x):
        # dense lowering: both branches see the full input
        return x

    @contextlib.contextmanager
    def true_block(self):
        self.in_else = False
        yield

    @contextlib.contextmanager
    def false_block(self):
        self.in_else = True
        yield

    def output(self, *outs):
        target = self.false_outs if self.in_else else self.true_outs
        target.extend(outs)

    def __call__(self):
        assert len(self.true_outs) == len(self.false_outs), (
            "IfElse needs output() in both branches")
        from . import nn as nn_layers
        results = []
        for t, f in zip(self.true_outs, self.false_outs):
            helper = LayerHelper("ifelse_select")
            out = helper.create_tmp_variable(dtype=t.dtype)
            helper.append_op(type="select_rows_by_cond",
                             inputs={"Cond": [self.cond], "X": [t],
                                     "Y": [f]},
                             outputs={"Out": [out]})
            results.append(out)
        return results if len(results) > 1 else results[0]


class Switch:
    """switch/case on scalar conditions (reference control_flow.py:1158);
    used for LR warmup schedules. Each case assigns to pre-created vars."""

    def __init__(self, name=None):
        self.helper = LayerHelper("switch", name=name)
        self.pre_not_conditions: List[Variable] = []

    @contextlib.contextmanager
    def case(self, condition):
        from . import ops as ops_layers
        if not self.pre_not_conditions:
            cond = condition
        else:
            pre = self.pre_not_conditions[-1]
            cond = _logical_and(pre, condition)
        not_cond = _logical_not(condition) if not self.pre_not_conditions \
            else _logical_and(self.pre_not_conditions[-1],
                              _logical_not(condition))
        self.pre_not_conditions.append(not_cond)
        cb = ConditionalBlock([cond], is_scalar_condition=True)
        with cb.block():
            yield

    @contextlib.contextmanager
    def default(self):
        assert self.pre_not_conditions, "default must follow a case"
        cb = ConditionalBlock([self.pre_not_conditions[-1]],
                              is_scalar_condition=True)
        with cb.block():
            yield

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def _logical_and(x, y):
    helper = LayerHelper("logical_and")
    out = helper.create_tmp_variable(dtype="bool")
    helper.append_op(type="logical_and", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]})
    return out


def _logical_not(x):
    helper = LayerHelper("logical_not")
    out = helper.create_tmp_variable(dtype="bool")
    helper.append_op(type="logical_not", inputs={"X": [x]},
                     outputs={"Out": [out]})
    return out


# --- RNNs -------------------------------------------------------------------

class _RNNBase:
    """Shared machinery for StaticRNN/DynamicRNN: build a step sub-block,
    then emit one `rnn` op, a loop over the padded time axis."""

    def __init__(self, kind: str, is_reverse=False, name=None):
        self.helper = LayerHelper(kind, name=name)
        self.is_reverse = is_reverse
        self.seq_inputs: List[Variable] = []       # outer [B,T,...] vars
        self.step_input_vars: List[Variable] = []  # block-local [B,...] vars
        self.init_states: List[Variable] = []
        self.state_vars: List[Variable] = []
        self.state_out_vars: List[Optional[Variable]] = []
        self.step_output_vars: List[Variable] = []
        self.outputs: List[Variable] = []
        self.sub_block = None
        self.parent_block = None
        self._status = "outside"

    @contextlib.contextmanager
    def block(self):
        program = self.helper.main_program
        self.parent_block = program.current_block()
        self.sub_block = program.create_block()
        self._status = "in"
        try:
            yield
        finally:
            self._status = "done"
            program.rollback()

        assert self.step_input_vars, "RNN needs step_input()"
        assert all(v is not None for v in self.state_out_vars), (
            "every memory needs update_memory()")
        outs = []
        for sv in self.step_output_vars:
            o = self.parent_block.create_var(
                name=None, dtype=sv.dtype,
                shape=[sv.shape[0], None] + list(sv.shape[1:])
                if sv.shape else None)
            outs.append(o)
        finals = []
        for st in self.state_out_vars:
            f = self.parent_block.create_var(name=None, dtype=st.dtype,
                                             shape=st.shape)
            finals.append(f)
        # Outer vars the step block reads (weights, encoder states, …) become
        # explicit op inputs so gradients flow to them: a read of the outer
        # env would be a constant to the generic grad and never train.
        inner = {v.name for v in self.step_input_vars} | \
                {v.name for v in self.state_vars}
        produced = set()
        extra = []
        for op_ in self.sub_block.ops:
            for n in op_.input_arg_names:
                if n in inner or n in produced or n in extra:
                    continue
                if self.parent_block.has_var_recursive(n):
                    extra.append(n)
            for n in op_.output_arg_names:
                produced.add(n)
        self.parent_block.append_op(
            type="rnn",
            inputs={"Inputs": [v.name for v in self.seq_inputs],
                    "InitStates": [v.name for v in self.init_states],
                    "ExtraIn": extra},
            outputs={"Outputs": [v.name for v in outs],
                     "FinalStates": [v.name for v in finals]},
            attrs={"sub_block": BlockRef(self.sub_block.idx),
                   "step_input_vars": [v.name for v in self.step_input_vars],
                   "state_vars": [v.name for v in self.state_vars],
                   "state_out_vars": [v.name for v in self.state_out_vars],
                   "step_output_vars": [v.name for v in self.step_output_vars],
                   "extra_in_vars": extra,
                   "is_reverse": self.is_reverse})
        self.outputs = outs
        self.final_states = finals

    def step_input(self, x):
        """Register x [B,T,...] as a sequence input; returns the per-step
        view [B,...] usable inside the block."""
        assert self._status == "in"
        self.seq_inputs.append(x)
        step = self.sub_block.create_var(
            name=None, dtype=x.dtype,
            shape=[x.shape[0]] + list(x.shape[2:]) if x.shape else None)
        self.step_input_vars.append(step)
        return step

    def memory(self, init=None, shape=None, value=0.0, dtype="float32",
               batch_ref=None):
        """Loop-carried state. init: Variable holding the initial value; or
        shape+value to fill a constant (batch size taken from batch_ref or
        the first step input's batch dim)."""
        assert self._status == "in"
        if init is None:
            assert shape is not None
            ref = batch_ref if batch_ref is not None else self.seq_inputs[0]
            # build the init in the PARENT block (it runs before the loop)
            from ..framework.framework import in_block
            with in_block(self.helper.main_program, self.parent_block.idx):
                init = tensor_layers.fill_constant_batch_size_like(
                    input=ref, shape=[-1] + list(shape), dtype=dtype,
                    value=value)
        mem = self.sub_block.create_var(name=None, dtype=init.dtype,
                                        shape=init.shape)
        self.init_states.append(init)
        self.state_vars.append(mem)
        self.state_out_vars.append(None)
        return mem

    def update_memory(self, mem, new_val):
        assert self._status == "in"
        idx = self.state_vars.index(mem)
        self.state_out_vars[idx] = new_val

    def step_output(self, o):
        assert self._status == "in"
        self.step_output_vars.append(o)

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    def __call__(self):
        outs = self.outputs
        return outs if len(outs) > 1 else outs[0]


class StaticRNN(_RNNBase):
    """Fixed-length RNN (reference control_flow.py:382). On the padded
    convention it is the same scan as DynamicRNN; masking simply sees
    full-length sequences."""

    def __init__(self, name=None):
        super().__init__("static_rnn", name=name)

    @contextlib.contextmanager
    def step(self):
        with self.block():
            yield


class DynamicRNN(_RNNBase):
    """Variable-length RNN (reference control_flow.py:1349). The reference
    sorts sequences by length (lod_rank_table) and shrinks the batch each
    step; the padded lowering keeps the batch dense and masks by length —
    identical math, dense shapes."""

    def __init__(self, name=None):
        super().__init__("dynamic_rnn", name=name)


# --- LoD-array plumbing (reference control_flow.py:665,888-1058) --------------

def lod_rank_table(x, level=0):
    """Sorted (index, length) table over a sequence batch (reference
    control_flow.py:665, lod_rank_table.cc); in the padded lowering this is
    the lengths vector riding the @SEQLEN channel."""
    helper = LayerHelper("lod_rank_table")
    table = helper.create_tmp_variable("int32")
    helper.append_op(type="lod_rank_table", inputs={"X": [x]},
                     outputs={"Out": [table]}, attrs={"level": level})
    return table


def max_sequence_len(rank_table):
    """Max sequence length from a rank table (reference control_flow.py:704)."""
    helper = LayerHelper("max_sequence_len")
    out = helper.create_tmp_variable("int64")
    helper.append_op(type="max_sequence_len",
                     inputs={"RankTable": [rank_table]},
                     outputs={"Out": [out]}, attrs={})
    return out


def lod_tensor_to_array(x, table):
    """Split a sequence batch into a time-major TensorArray (reference
    control_flow.py:888)."""
    helper = LayerHelper("lod_tensor_to_array")
    array = helper.create_tmp_variable(x.dtype)
    helper.append_op(type="lod_tensor_to_array",
                     inputs={"X": [x], "RankTable": [table]},
                     outputs={"Out": [array]}, attrs={})
    return array


def array_to_lod_tensor(x, table):
    """Stack a TensorArray back into a padded sequence batch (reference
    control_flow.py:919)."""
    helper = LayerHelper("array_to_lod_tensor")
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(type="array_to_lod_tensor",
                     inputs={"X": [x], "RankTable": [table]},
                     outputs={"Out": [out]}, attrs={})
    return out


def split_lod_tensor(input, mask, level=0):
    """Row-route a batch by boolean mask (reference control_flow.py:943).
    Returns (in_true, in_false); dense lowering keeps row positions."""
    helper = LayerHelper("split_lod_tensor")
    out_true = helper.create_tmp_variable(input.dtype)
    out_false = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="split_lod_tensor",
                     inputs={"X": [input], "Mask": [mask]},
                     outputs={"OutTrue": [out_true], "OutFalse": [out_false]},
                     attrs={"level": level})
    return out_true, out_false


def merge_lod_tensor(in_true, in_false, x, mask, level=0):
    """Inverse of split_lod_tensor (reference control_flow.py:997)."""
    helper = LayerHelper("merge_lod_tensor")
    out = helper.create_tmp_variable(in_true.dtype)
    helper.append_op(type="merge_lod_tensor",
                     inputs={"InTrue": [in_true], "InFalse": [in_false],
                             "Mask": [mask], "X": [x]},
                     outputs={"Out": [out]}, attrs={"level": level})
    return out


def reorder_lod_tensor_by_rank(x, rank_table):
    """Reorder sequences into rank-table (descending length) order
    (reference control_flow.py:1058)."""
    helper = LayerHelper("reorder_lod_tensor_by_rank")
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(type="reorder_lod_tensor_by_rank",
                     inputs={"X": [x], "RankTable": [rank_table]},
                     outputs={"Out": [out]}, attrs={})
    return out


def shrink_memory(x, i, table):
    """Batch-shrink an RNN state to live sequences (reference
    control_flow.py:732, shrink_rnn_memory_op.cc); dense lowering is a
    pass-through — masking in the scan supplies the semantics."""
    helper = LayerHelper("shrink_memory")
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(type="shrink_rnn_memory",
                     inputs={"X": [x], "I": [i], "RankTable": [table]},
                     outputs={"Out": [out]}, attrs={})
    return out
