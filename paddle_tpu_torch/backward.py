"""IR-level autodiff: append gradient ops to a Program (the port's
counterpart of paddle_tpu/backward.py; reference
python/paddle/fluid/backward.py:425 append_backward, :117
_addup_repetitive_outputs_, :167 no-grad pruning).

Gradients are ops in the IR, not an autograd tape: the program stays the
product, and the executor runs grad ops like any other. Each forward op's
grad ops come from the registry's grad makers (ops/registry.py; the generic
one re-runs the forward lowering under torch.autograd).

Fan-in accumulation: when several consumers contribute to one variable's
gradient, later contributions are renamed and summed eagerly (pairwise `sum`
ops), the reference's @RENAME@ + sum_op insertion. `calc_gradient` takes
the gradients of several targets, weighted by given cotangents, with
respect to any variables.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

from . import flags
from .framework.framework import (Block, Operator, Parameter, Variable,
                                  grad_var_name)
from .ops import registry

__all__ = ["append_backward", "calc_gradient"]


def _collect_no_grad(block: Block, extra: Optional[Set[str]]) -> Set[str]:
    no_grad = set(extra or ())
    for name, v in block.vars.items():
        if getattr(v, "stop_gradient", False) or v.desc.stop_gradient:
            no_grad.add(name)
    return no_grad


def _relevant_op_indices(block: Block, loss_name: str) -> List[int]:
    """Backward slice: ops that (transitively) produce the loss."""
    target = {loss_name}
    idxs = []
    for i in range(len(block.ops) - 1, -1, -1):
        op = block.ops[i]
        if target & set(op.output_arg_names):
            idxs.append(i)
            target |= set(op.input_arg_names)
    idxs.reverse()
    return idxs


def _ensure_grad_var(block: Block, gname: str):
    """Declare a grad var mirroring its forward var's shape/dtype."""
    if block.has_var(gname):
        return
    base = gname.split("@RENAME@")[0]
    if base.endswith("@GRAD"):
        base = base[: -len("@GRAD")]
    if block.has_var_recursive(base):
        fv = block.var_recursive(base)
        block.create_var(name=gname, shape=fv.desc.shape, dtype=fv.dtype,
                         lod_level=fv.lod_level)
    else:
        block.create_var(name=gname)


# NO_GRAD ops that are legitimately gradient-transparent even when their
# outputs' grads are demanded: constants, shape probes, RNG sources,
# comparisons (the JAX package's list)
_ZERO_GRAD_SAFE = frozenset({
    "fill_constant", "fill_constant_batch_size_like", "fill_constant_tensor",
    "fill", "fill_zeros_like", "assign_value", "shape", "lod_rank_table",
    "max_sequence_len", "lod_array_length", "less_than", "less_equal",
    "greater_than", "greater_equal", "equal", "not_equal", "logical_and",
    "logical_or", "logical_not", "logical_xor", "is_empty",
    "one_hot", "uniform_random", "gaussian_random",
    "uniform_random_batch_size_like", "gaussian_random_batch_size_like",
    "sign", "arg_max", "arg_min", "crf_decoding", "ctc_align",
    "sequence_mask", "prior_box", "tensor_stats",
})

_INT_DTYPES = ("bool", "int8", "uint8", "int16", "int32", "int64")


def _check_silent_zero_grad(block: Block, fwd_op, no_grad: Set[str],
                            produced_count: Dict[str, int]):
    """Raise when a NO_GRAD op sits on the loss path with differentiable
    inputs: silently emitting no grad op would train quietly wrong. The
    allow_zero_grad flag (PADDLE_TPU_ALLOW_ZERO_GRAD=1) accepts the zero
    gradients instead."""
    if flags.get("allow_zero_grad"):
        return
    if fwd_op.type in _ZERO_GRAD_SAFE:
        return
    opdef = registry.try_get(fwd_op.type)
    if opdef is None or opdef.grad is not registry.NO_GRAD:
        return
    needed = [o for o in fwd_op.output_arg_names
              if grad_var_name(o) in produced_count]
    if not needed:
        return
    diff_ins = []
    for n in fwd_op.input_arg_names:
        if n in no_grad or not block.has_var_recursive(n):
            continue
        dt = block.var_recursive(n).dtype
        if dt is None or str(dt) not in _INT_DTYPES:
            diff_ins.append(n)
    if diff_ins:
        raise RuntimeError(
            f"Operator '{fwd_op.type}' lies on the loss path (outputs "
            f"{needed} need gradients) but registers no gradient; its "
            f"differentiable inputs {diff_ins} would silently receive zero "
            f"gradient. Register a grad maker for '{fwd_op.type}', mark "
            f"the inputs stop_gradient, or set PADDLE_TPU_ALLOW_ZERO_GRAD=1 "
            f"to accept zero gradients.")


def append_backward(loss: Variable, parameter_list: Optional[Sequence] = None,
                    no_grad_set: Optional[Set[str]] = None,
                    callbacks=None) -> List[Tuple[Parameter, Variable]]:
    """Append grad ops for `loss` and return [(param, grad_var)]. Root-block
    autodiff only."""
    program = loss.block.program
    block = program.global_block()
    if loss.block.idx != 0:
        raise ValueError("loss must live in the root block")
    no_grad = _collect_no_grad(block, no_grad_set)
    # the loss, for the analyzer's default fetch set (analysis/__init__.py
    # PassContext; JAX backward.py:135-142)
    losses = getattr(program, "_loss_names", None)
    if losses is None:
        losses = program._loss_names = []
    if loss.name not in losses:
        losses.append(loss.name)
    rel = _relevant_op_indices(block, loss.name)

    # seed: d loss / d loss = 1
    loss_g = grad_var_name(loss.name)
    _ensure_grad_var(block, loss_g)
    block.append_op(
        type="fill_constant",
        outputs={"Out": [loss_g]},
        attrs={"shape": list(loss.shape or [1]), "value": 1.0,
               "dtype": loss.dtype, "op_role": "backward"})

    produced_count: Dict[str, int] = {loss_g: 1}
    grad_to_var: Dict[str, str] = {loss_g: loss.name}

    for i in reversed(rel):
        fwd_op = block.ops[i]
        gdescs = registry.make_grad_op_descs(fwd_op.desc, no_grad)
        if not gdescs:
            _check_silent_zero_grad(block, fwd_op, no_grad, produced_count)
        for g in gdescs:
            # Rename duplicate grad writes, then accumulate with sum ops.
            # A grad op that consumes n@GRAD and produces n@GRAD mirrors an
            # in-place forward op: its output replaces the cotangent.
            g_grad_ins = {n for names in g.inputs.values() for n in names
                          if n.endswith("@GRAD")}
            renames: List[Tuple[str, str]] = []
            for slot, names in list(g.outputs.items()):
                new_names = []
                for n in names:
                    c = produced_count.get(n, 0)
                    if c == 0 or n in g_grad_ins:
                        produced_count[n] = max(c, 1)
                        new_names.append(n)
                    else:
                        rn = f"{n}@RENAME@{c}"
                        produced_count[n] = c + 1
                        new_names.append(rn)
                        renames.append((n, rn))
                g.outputs[slot] = new_names

            for names in g.outputs.values():
                for n in names:
                    _ensure_grad_var(block, n)
                    base = n.split("@RENAME@")[0]
                    if base.endswith("@GRAD"):
                        grad_to_var[base] = base[: -len("@GRAD")]
            # role tag (reference OpRole::kBackward): inference slicing
            # strips these before pruning
            g.attrs.setdefault("op_role", "backward")
            block.desc.ops.append(g)
            op_obj = Operator(block, g)
            block.ops.append(op_obj)
            program._version += 1
            block._infer_shape(op_obj)

            for orig, rn in renames:
                block.append_op(type="sum", inputs={"X": [orig, rn]},
                                outputs={"Out": [orig]},
                                attrs={"op_role": "backward"})

    program.grad_info_map.update(grad_to_var)

    if parameter_list is not None:
        params = [block.var(p) if isinstance(p, str) else p
                  for p in parameter_list]
    else:
        params = block.all_parameters()
    result = []
    for p in params:
        if not getattr(p, "trainable", True):
            continue
        gname = grad_var_name(p.name)
        if produced_count.get(gname):
            result.append((p, block.var(gname)))
    # the (param, grad) pairing for the overlap pass (parallel/overlap.py;
    # JAX backward.py:224-234): only append_backward knows which params
    # received a gradient in this program
    pairs = getattr(program, "_grad_param_pairs", None)
    if pairs is None:
        pairs = program._grad_param_pairs = []
    for p, g in result:
        if (p.name, g.name) not in pairs:
            pairs.append((p.name, g.name))
    # the grads that are SelectedRows by construction (an is_sparse
    # lookup_table_grad), named for the planners that must not treat them
    # as dense (backward.py:235-247); a row-sharded table's grad turns
    # sparse at run time too, which its planners learn from _sharded_tables
    sparse_names = getattr(program, "_sparse_grad_names", None)
    if sparse_names is None:
        sparse_names = program._sparse_grad_names = set()
    for op_ in block.ops:
        if op_.type == "lookup_table_grad" and op_.attr("is_sparse", False):
            sparse_names.update(op_.output_arg_names)
    return result


def calc_gradient(targets, inputs, target_gradients=None,
                  no_grad_set: Optional[Set[str]] = None):
    """Gradients of `targets` with respect to `inputs` (reference
    backward.py:555; JAX backward.py:251), None for an input the targets do
    not reach. Several targets and their cotangents `target_gradients`
    (ones where absent) are differentiated as sum_i reduce_sum(t_i * tg_i),
    which by the linearity of the vjp is the reference's accumulation over
    targets. The grad ops go into the targets' program."""
    targets = list(targets) if isinstance(targets, (list, tuple)) \
        else [targets]
    inputs = list(inputs) if isinstance(inputs, (list, tuple)) else [inputs]
    if target_gradients is None:
        target_gradients = [None] * len(targets)
    elif not isinstance(target_gradients, (list, tuple)):
        target_gradients = [target_gradients]
    if len(target_gradients) != len(targets):
        raise ValueError(f"{len(targets)} targets but "
                         f"{len(target_gradients)} target gradients")
    program = targets[0].block.program
    from .framework.framework import program_guard
    from . import layers
    with program_guard(program):
        parts = [layers.reduce_sum(t if tg is None
                                   else layers.elementwise_mul(t, tg))
                 for t, tg in zip(targets, target_gradients)]
        loss = parts[0]
        for p in parts[1:]:
            loss = layers.elementwise_add(loss, p)
    append_backward(loss, no_grad_set=no_grad_set)
    block = program.global_block()
    outs = []
    for v in inputs:
        gname = grad_var_name(v.name)
        outs.append(block.var(gname) if block.has_var(gname) else None)
    return outs
