"""Control-flow ops: while / conditional_block / rnn and the tensor arrays
(the port's counterpart of paddle_tpu/ops/control_flow_ops.py; reference
paddle/fluid/operators/while_op.cc:35,96, conditional_block_op.cc,
recurrent_op.cc:222, tensor_array_read_write_op.cc, lod_rank_table.cc,
shrink_rnn_memory_op.cc).

Each sub-block runs through `ctx.run_block` on a copy of the outer env plus
the carry, as the JAX package's lax bodies do. `while` and
`conditional_block` read their condition on the host (counted by
`ctx.host_sync`) and loop or branch in Python, so a block holding one runs
eager (the executor's graph gate, reason "control_flow"). `rnn` loops over
the padded time axis, a static trip count per signature, with its masks
made on the device from the lengths: a step holding one is captured as a
CUDA graph like any other, and its grad is the generic one (it re-runs the
loop under autograd, counted in `registry.RERUNS["rnn"]`).

A tensor array is a fixed-capacity buffer [capacity, ...] and a length
tensor, both on the device; a write at a device index is an `index_copy`
with the index clamped into the buffer, as `dynamic_update_index_in_dim`
clamps it: no lowering here reads an index or a length on the host.
"""

from __future__ import annotations

import os
from typing import Dict, List

import torch

from ..framework.desc import BlockRef, OpDesc
from ..framework.framework import grad_var_name
from . import registry
from .registry import NO_GRAD, _is_diff as _is_float, op


class TensorArrayVal:
    """Fixed-capacity tensor array: buffer [cap, ...] + int32 length scalar,
    both on the device (JAX control_flow_ops.py:32)."""

    def __init__(self, buffer: torch.Tensor, length: torch.Tensor):
        self.buffer = buffer
        self.length = length

    def __repr__(self):
        return f"TensorArrayVal(cap={self.buffer.shape[0]})"


DEFAULT_ARRAY_CAPACITY = 128


def _index(i, cap: int) -> torch.Tensor:
    """A device index [1] (int64), clamped into [0, cap - 1]."""
    return i.reshape(-1)[:1].to(torch.int64).clamp(0, cap - 1)


@op("write_to_array", grad=NO_GRAD)
def _write_to_array(ctx, op_, ins):
    """array[i] = x (reference tensor_array_read_write_op.cc WriteToArray).
    Out aliases the input array var; the first write makes a buffer of the
    `capacity` attr."""
    x = ins["X"][0]
    i = ins["I"][0]
    arr = ins.get("Out", [None])[0]
    if not isinstance(arr, TensorArrayVal):
        cap = int(op_.attr("capacity", DEFAULT_ARRAY_CAPACITY))
        arr = TensorArrayVal(
            torch.zeros((cap,) + tuple(x.shape), dtype=x.dtype,
                        device=x.device),
            torch.zeros((), dtype=torch.int32, device=x.device))
    cap = arr.buffer.shape[0]
    idx = _index(i, cap)
    buf = arr.buffer.index_copy(0, idx, x.to(arr.buffer.dtype).unsqueeze(0))
    length = torch.maximum(arr.length, (idx[0] + 1).to(torch.int32))
    return {"Out": [TensorArrayVal(buf, length)]}


@op("read_from_array", grad=NO_GRAD)
def _read_from_array(ctx, op_, ins):
    arr = ins["X"][0]
    if not isinstance(arr, TensorArrayVal):
        raise TypeError("read_from_array needs a tensor array")
    idx = _index(ins["I"][0], arr.buffer.shape[0])
    return {"Out": [arr.buffer.index_select(0, idx)[0]]}


@op("lod_array_length", grad=NO_GRAD)
def _lod_array_length(ctx, op_, ins):
    arr = ins["X"][0]
    if not isinstance(arr, TensorArrayVal):
        raise TypeError("lod_array_length needs a tensor array")
    return {"Out": [arr.length.reshape(1).to(torch.int64)]}


class StepScopesVal:
    """The pre-iteration carries a recorded `while` kept for while_grad (JAX
    control_flow_ops.py:95): at most `cap` of them (a loop past the cap
    overwrites the last, as the JAX package's buffer does), and the
    iterations run."""

    def __init__(self, names, records: List[Dict], count: int):
        self.names = tuple(names)
        self.records = records
        self.count = count

    def __repr__(self):
        return f"StepScopesVal(names={self.names}, count={self.count})"


class ScopeRecordVal:
    """The pre-op values of the vars a conditional_block writes (JAX
    control_flow_ops.py:121): its grad needs the else branch's
    pass-through values, which the forward op has overwritten."""

    def __init__(self, names, values):
        self.names = tuple(names)
        self.values = values

    def __repr__(self):
        return f"ScopeRecordVal(names={self.names})"


# the default step-record capacity of a while loop that trains; per loop
# While(max_iters=...), for all PADDLE_TPU_MAX_LOOP_ITERS
DEFAULT_MAX_LOOP_ITERS = int(os.environ.get("PADDLE_TPU_MAX_LOOP_ITERS")
                             or 128)


def _block_writes(program, block_idx) -> List[str]:
    """Every name a block writes, through its sub-blocks, in order."""
    writes: List[str] = []
    seen = set()
    for o in program.block(block_idx).ops:
        names = list(o.output_arg_names)
        for a in o.desc.attrs.values():
            if isinstance(a, BlockRef):
                names += _block_writes(program, a.idx)
        for name in names:
            if name not in seen:
                seen.add(name)
                writes.append(name)
    return writes


def _truth(ctx, op_type, cond, scalar=True) -> bool:
    """A condition tensor read on the host, counted."""
    ctx.host_sync(op_type)
    c = cond.reshape(-1)
    return bool(c[0]) if scalar else bool(c.bool().all())


@op("while", grad=NO_GRAD)      # the maker is set below
def _while(ctx, op_, ins):
    """while (Condition) { sub_block } (reference while_op.cc:35; JAX
    control_flow_ops.py:170). The carry is every var the sub-block writes
    that already has a value, plus the condition; the rest of what the
    sub-block reads is the outer env's. The condition is read on the host
    before each iteration. With `record_step_scopes` (set by the grad
    maker) the pre-iteration carries are kept for while_grad, at most
    `max_loop_iters` of them."""
    sub = op_.attr("sub_block")
    cond_name = op_.desc.inputs["Condition"][0]
    carry_names = [n for n in _block_writes(ctx.program, sub.idx)
                   if n in ctx.env]
    if cond_name not in carry_names:
        carry_names.append(cond_name)
    base_env = dict(ctx.env)
    carry = {n: ctx.env[n] for n in carry_names}
    record = bool(op_.attr("record_step_scopes", False)) and \
        bool(op_.desc.outputs.get("StepScopes"))
    cap = int(op_.attr("max_loop_iters", 0) or DEFAULT_MAX_LOOP_ITERS)
    records: List[Dict] = []
    count = 0
    while _truth(ctx, "while", carry[cond_name]):
        if record:
            if len(records) < cap:
                records.append(carry)
            else:
                records[cap - 1] = carry
        env2 = dict(base_env)
        env2.update(carry)
        ctx.run_block(sub.idx, env2)
        carry = {n: env2[n] for n in carry_names}
        count += 1
    out = {"Out": [carry.get(n) for n in op_.desc.outputs.get("Out", [])]}
    if record:
        out["StepScopes"] = [StepScopesVal(carry_names, records, count)]
    return out


def _while_grad_maker(fwd, no_grad_set):
    """while_grad, and the forward op marked to record its step scopes
    (reference while_op.cc:96; JAX control_flow_ops.py:273)."""
    out_names = list(fwd.outputs.get("Out", []))
    x_names = list(fwd.inputs.get("X", []))
    gx = [n for n in x_names if n not in no_grad_set]
    if not gx:
        return []
    ss_name = (out_names[0] if out_names else x_names[0]) + "@STEP_SCOPES"
    fwd.outputs["StepScopes"] = [ss_name]
    fwd.attrs["record_step_scopes"] = True
    return [OpDesc(
        type="while_grad",
        inputs={"Condition": list(fwd.inputs["Condition"]),
                "X": x_names, "Out": out_names,
                "Out@GRAD": [grad_var_name(n) for n in out_names],
                "StepScopes": [ss_name]},
        outputs={"X@GRAD": [grad_var_name(n) for n in gx]},
        attrs=dict(fwd.attrs))]


registry.get("while").grad = _while_grad_maker


def _vjp_block(ctx, sub_idx, base_env, carry, xd, out_names, cts,
               then=True):
    """One run of sub-block `sub_idx` at (carry, xd) under autograd and its
    vjp against `cts` (name -> cotangent of the output, or None): (d carry,
    d xd), each float leaf's grad or zeros. With `then` False the block
    is not run and the outputs are the carry (a conditional_block's else
    branch)."""
    with torch.enable_grad(), registry.suppress_counters():
        c_leaves = {n: v.detach().requires_grad_(True)
                    for n, v in carry.items() if _is_float(v)}
        x_leaves = {n: v.detach().requires_grad_(True) for n, v in xd.items()}
        env2 = dict(base_env)
        env2.update(x_leaves)
        env2.update(carry)
        env2.update(c_leaves)
        if then:
            ctx.run_block(sub_idx, env2)
        outs, gs = [], []
        for n in out_names:
            o, g = env2.get(n), cts.get(n)
            if isinstance(o, torch.Tensor) and o.requires_grad and \
                    o.is_floating_point() and g is not None:
                outs.append(o)
                gs.append(g.to(o.dtype).reshape(o.shape))
        leaves = list(c_leaves.values()) + list(x_leaves.values())
        grads = [None] * len(leaves)
        if outs and leaves:
            grads = torch.autograd.grad(outs, leaves, gs, allow_unused=True)
    grads = [torch.zeros_like(l) if g is None else g.detach()
             for l, g in zip(leaves, grads)]
    dc = dict(zip(c_leaves, grads[:len(c_leaves)]))
    dx = dict(zip(x_leaves, grads[len(c_leaves):]))
    return dc, dx


def _grad_base(gname: str) -> str:
    base = gname.split("@RENAME@")[0]
    return base[: -len("@GRAD")] if base.endswith("@GRAD") else base


@op("while_grad", grad=NO_GRAD)
def _while_grad(ctx, op_, ins):
    """The reverse sweep of a recorded while loop (JAX
    control_flow_ops.py:298): for j = n-1 .. 0, the vjp of the body at the
    recorded carry j. Past the recording cap the replay is truncated and
    every gradient undefined: each float grad is NaN then, so training
    fails loudly (raise the cap with While(cond, max_iters=N))."""
    sub = op_.attr("sub_block")
    ss = ins["StepScopes"][0]
    if not isinstance(ss, StepScopesVal):
        raise TypeError("while_grad needs the recorded step scopes")
    carry_names = list(ss.names)
    cap = int(op_.attr("max_loop_iters", 0) or DEFAULT_MAX_LOOP_ITERS)
    x_names = op_.desc.inputs.get("X", [])
    x_vals = dict(zip(x_names, ins.get("X", [])))
    out_cts = dict(zip(op_.desc.inputs.get("Out", []),
                       ins.get("Out@GRAD", [])))
    base_env = dict(ctx.env)
    base_env.update({n: v for n, v in x_vals.items() if v is not None})
    x_diff = {n: v for n, v in x_vals.items()
              if n not in carry_names and _is_float(v)}
    tmpl = ss.records[0] if ss.records else {}
    g = {}
    for n in carry_names:
        p = tmpl.get(n)
        if not _is_float(p):
            continue
        ct = out_cts.get(n)
        g[n] = ct.to(p.dtype).reshape(p.shape) if isinstance(
            ct, torch.Tensor) else torch.zeros_like(p)
    xbar = {n: torch.zeros_like(v) for n, v in x_diff.items()}
    for j in reversed(range(min(ss.count, cap))):
        dc, dx = _vjp_block(ctx, sub.idx, base_env, ss.records[j], x_diff,
                            carry_names, g)
        g = {n: dc.get(n, torch.zeros_like(v)) for n, v in g.items()}
        xbar = {n: xbar[n] + dx[n] for n in xbar}
    grads = []
    for gn in op_.desc.outputs.get("X@GRAD", []):
        base = _grad_base(gn)
        grads.append(g.get(base) if base in carry_names else xbar.get(base))
    if ss.count > cap:
        grads = [None if v is None else torch.full_like(v, float("nan"))
                 for v in grads]
    return {"X@GRAD": grads}


def _zeros_like_then(ctx, sub_idx, base_env, carry, names):
    """Zeros shaped like the then branch's `names` (the JAX package's
    eval_shape of the branch): the branch is run on a copy of the env."""
    env2 = dict(base_env)
    env2.update(carry)
    with torch.no_grad():
        ctx.run_block(sub_idx, env2)
    return {n: torch.zeros_like(env2[n]) for n in names}


@op("conditional_block", grad=NO_GRAD)   # the maker is set below
def _conditional_block(ctx, op_, ins):
    """if (Cond) { sub_block } (reference conditional_block_op.cc; JAX
    control_flow_ops.py:421). An output that had a value keeps it when the
    predicate is false; one that did not is zeros shaped like the then
    branch's. With `record_scope` (set by the grad maker) the pre-op
    values go out through Scope for conditional_block_grad."""
    sub = op_.attr("sub_block")
    pred = _truth(ctx, "conditional_block", ins["Cond"][0],
                  bool(op_.attr("is_scalar_condition", True)))
    out_names = op_.desc.outputs.get("Out", [])
    base_env = dict(ctx.env)
    carry = {n: ctx.env[n] for n in out_names if n in ctx.env}
    missing = [n for n in out_names if n not in carry]
    if pred:
        env2 = dict(base_env)
        env2.update(carry)
        ctx.run_block(sub.idx, env2)
        outs = [env2[n] for n in out_names]
    else:
        if missing:
            carry.update(_zeros_like_then(ctx, sub.idx, base_env, carry,
                                          missing))
        outs = [carry[n] for n in out_names]
    result = {"Out": outs}
    if bool(op_.attr("record_scope", False)) and \
            op_.desc.outputs.get("Scope"):
        if pred and missing:
            carry.update({n: torch.zeros_like(env2[n]) for n in missing})
        result["Scope"] = [ScopeRecordVal(
            out_names, {n: carry[n] for n in out_names})]
    return result


def _conditional_block_grad_maker(fwd, no_grad_set):
    """conditional_block_grad, and the forward op marked to record its
    pre-op values (JAX control_flow_ops.py:462)."""
    out_names = list(fwd.outputs.get("Out", []))
    x_names = list(fwd.inputs.get("X", []))
    gx = [n for n in x_names if n not in no_grad_set]
    if not out_names or not gx:
        return []
    scope_name = out_names[0] + "@COND_SCOPE"
    fwd.outputs["Scope"] = [scope_name]
    fwd.attrs["record_scope"] = True
    return [OpDesc(
        type="conditional_block_grad",
        inputs={"Cond": list(fwd.inputs["Cond"]), "X": x_names,
                "Out": out_names,
                "Out@GRAD": [grad_var_name(n) for n in out_names],
                "Scope": [scope_name]},
        outputs={"X@GRAD": [grad_var_name(n) for n in gx]},
        attrs=dict(fwd.attrs))]


@op("conditional_block_grad", grad=NO_GRAD)
def _conditional_block_grad(ctx, op_, ins):
    """The vjp of conditional_block at the recorded pre-op values (JAX
    control_flow_ops.py:490): through the then branch when the predicate
    holds, else through the pass-through of the outputs that had values;
    grads reach the explicit reads X and those outputs' pre-op values."""
    sub = op_.attr("sub_block")
    pred = _truth(ctx, "conditional_block_grad", ins["Cond"][0],
                  bool(op_.attr("is_scalar_condition", True)))
    sr = ins["Scope"][0]
    if not isinstance(sr, ScopeRecordVal):
        raise TypeError("conditional_block_grad needs the recorded scope")
    out_names = list(sr.names)
    carry = dict(sr.values)
    out_cts = dict(zip(op_.desc.inputs.get("Out", []),
                       ins.get("Out@GRAD", [])))
    x_names = op_.desc.inputs.get("X", [])
    x_vals = dict(zip(x_names, ins.get("X", [])))
    base_env = dict(ctx.env)
    base_env.update({n: v for n, v in x_vals.items() if v is not None})
    x_diff = {n: v for n, v in x_vals.items()
              if n not in carry and _is_float(v)}
    cts = {n: out_cts[n] for n in out_names
           if isinstance(out_cts.get(n), torch.Tensor)}
    dc, dx = _vjp_block(ctx, sub.idx, base_env, carry, x_diff, out_names,
                        cts, then=pred)
    grads = []
    for gn in op_.desc.outputs.get("X@GRAD", []):
        base = _grad_base(gn)
        g = dx.get(base)
        if base in dc:
            g = dc[base] if g is None else g + dc[base]
        grads.append(g)
    return {"X@GRAD": grads}


registry.get("conditional_block").grad = _conditional_block_grad_maker


@op("rnn")
def _rnn(ctx, op_, ins):
    """A step-scoped RNN over padded sequences (reference
    recurrent_op.cc:222; JAX control_flow_ops.py:559, a lax.scan): the
    sub-block run once per step of the padded time axis, in reverse with
    `is_reverse`. A step past a sequence's length keeps its carry and
    emits zeros (masks from the lengths, on the device). Inputs: the
    sequences [B, T, ...] sliced per step, InitStates, and ExtraIn, the
    outer values the block reads (explicit, so their grads flow). Outputs:
    the step outputs stacked [B, T, ...] with the inputs' lengths, and
    FinalStates."""
    sub = op_.attr("sub_block")
    step_in_names = list(op_.attr("step_input_vars", []))
    state_names = list(op_.attr("state_vars", []))
    state_out_names = list(op_.attr("state_out_vars", []))
    out_names = list(op_.attr("step_output_vars", []))
    seqs = list(ins.get("Inputs", []))
    states = list(ins.get("InitStates", []))
    if not seqs:
        raise ValueError("the rnn op needs at least one sequence input")
    bsz, t = seqs[0].shape[0], seqs[0].shape[1]
    lengths = None
    for n in op_.desc.inputs.get("Inputs", []):
        lengths = ctx.seq_len(n)
        if lengths is not None:
            break
    if lengths is not None:
        mask = torch.arange(t, device=seqs[0].device)[None, :] < \
            lengths.to(seqs[0].device)[:, None]
    else:
        mask = torch.ones((bsz, t), dtype=torch.bool, device=seqs[0].device)
    base_env = dict(ctx.env)
    base_env.update({n: v for n, v in zip(op_.attr("extra_in_vars", []),
                                          ins.get("ExtraIn", []))
                     if v is not None})
    steps = range(t - 1, -1, -1) if op_.attr("is_reverse", False) \
        else range(t)
    stacked: List[List[torch.Tensor]] = [[] for _ in out_names]
    for s in steps:
        env2 = dict(base_env)
        env2.update({n: x[:, s] for n, x in zip(step_in_names, seqs)})
        env2.update(zip(state_names, states))
        ctx.run_block(sub.idx, env2)
        m = mask[:, s]
        states = [torch.where(m.reshape((bsz,) + (1,) * (new.dim() - 1)),
                              new, old)
                  for new, old in zip((env2[n] for n in state_out_names),
                                      states)]
        for lst, n in zip(stacked, out_names):
            o = env2[n]
            lst.append(torch.where(m.reshape((bsz,) + (1,) * (o.dim() - 1)),
                                   o, torch.zeros((), dtype=o.dtype,
                                                  device=o.device)))
    if op_.attr("is_reverse", False):
        stacked = [lst[::-1] for lst in stacked]
    outputs = [torch.stack(lst, dim=1) for lst in stacked]
    for name in op_.desc.outputs.get("Outputs", []):
        ctx.set_seq_len(name, lengths)
    for name in op_.desc.outputs.get("FinalStates", []):
        ctx.set_seq_len(name, None)
    return {"Outputs": outputs, "FinalStates": states}


@op("select_rows_by_cond", non_diff_inputs=("Cond",))
def _select_rows_by_cond(ctx, op_, ins):
    """out[i] = cond[i] ? x[i] : y[i]: the dense IfElse (both branches on the
    whole batch, rows selected; JAX control_flow_ops.py:637)."""
    cond = ins["Cond"][0].reshape(-1).bool()
    x, y = ins["X"][0], ins["Y"][0]
    return {"Out": [torch.where(cond.reshape((cond.shape[0],)
                                             + (1,) * (x.dim() - 1)), x, y)]}


@op("max_sequence_len", grad=NO_GRAD)
def _max_sequence_len(ctx, op_, ins):
    """The longest length of a sequence batch, from its lengths (JAX
    control_flow_ops.py:650), on the device."""
    lengths = ctx.seq_len(op_.desc.inputs["RankTable"][0])
    if lengths is None:
        x = ins["RankTable"][0]
        return {"Out": [torch.full((1,), x.shape[1], dtype=torch.int64,
                                   device=x.device)]}
    return {"Out": [lengths.max().to(torch.int64).reshape(1)]}


@op("lod_rank_table", grad=NO_GRAD)
def _lod_rank_table(ctx, op_, ins):
    """The reference's (index, length) table sorted by length
    (lod_rank_table.cc) drives batch-shrinking RNNs; the dense and masked
    lowering keeps the batch whole, so the table is the lengths vector,
    which also rides the @SEQLEN channel (JAX control_flow_ops.py:662)."""
    x = ins["X"][0]
    lengths = ctx.seq_len(op_.desc.inputs["X"][0])
    if lengths is None:
        lengths = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                             device=x.device)
    out = lengths.to(torch.int32)
    for n in op_.desc.outputs.get("Out", []):
        ctx.set_seq_len(n, out)
    return {"Out": [out]}


@op("shrink_rnn_memory")
def _shrink_rnn_memory(ctx, op_, ins):
    """The reference shrinks an RNN state to the sequences alive at step I
    (shrink_rnn_memory_op.cc); the dense batch keeps its size and the
    masks supply the semantics, so the state passes through (JAX
    control_flow_ops.py:679)."""
    return {"Out": [ins["X"][0]]}
