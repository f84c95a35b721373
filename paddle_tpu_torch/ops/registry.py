"""Operator registry: op type -> (torch lowering, shape inference, grad maker).

The port's counterpart of paddle_tpu/ops/registry.py (reference:
paddle/fluid/framework/op_registry.h:62-195). Every op carries a *lowering*,
a plain function from torch tensors to torch tensors, and the port's
executor calls the lowerings of a block one after another on the device.

Gradient ops: the default grad maker emits a `<type>_grad` OpDesc whose
lowering is generic: it re-runs the forward lowering on detached leaf copies
of the inputs under `torch.enable_grad()` and takes `torch.autograd.grad`
against the output cotangents. Eager torch has no CSE, so that re-run is
real work (the JAX package's whole-block jit merges it with the original
forward); `RERUNS` counts the re-runs by forward op type. The ops on the
training paths register explicit grad lowerings (`grad_op`) for the same
OpDesc instead, which compute from the forward's inputs and outputs as the
grad op declares them and re-run nothing: `batch_norm`, `layer_norm`,
`softmax_with_cross_entropy`, average `pool2d` (ops/nn_ops.py), `relu`,
`gelu`, `elementwise_add`, `mul`, `mean` (ops/math_ops.py), `reshape`
(ops/basic_ops.py); max pooling and a bf16 layer_norm still take the
generic grad. Two of the explicit ones exist also
because a kernel called through ctypes is opaque to autograd, so the
generic grad cannot differentiate it: `conv2d_grad` runs K2 + K3, and
`scaled_dot_product_attention_grad` takes the forward's saved Out and LSE
and runs K8 + K9, where a generic grad would launch the flash forward K7 a
second time (and could not differentiate it either). A random op's grad
cannot re-run its forward either, which would draw again (inside a CUDA
graph's capture, other numbers): `dropout_grad` reads the saved Mask and
`nce_grad` the saved SampleLabels (ops/extra_ops.py).
"""

from __future__ import annotations

import collections
import contextlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from ..framework.desc import OpDesc
from ..framework.framework import grad_var_name

# sentinel: op has no gradient (metrics, int ops, assignment of constants…)
NO_GRAD = "no_grad"

_NO_SPAN = contextlib.nullcontext()


def span(label: str):
    """A torch.profiler range named `label` while a profiler records, and
    nothing otherwise. The executor names each op ("op:<type>"), window
    ("win:<member types>") and generic grad's forward re-run
    ("rerun:<type>"), so a profile of a run splits its time by them; the
    ranges nest (a window holds its ladder's ops, a grad op its re-run)."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(label)
    return _NO_SPAN


_QUIET = [False]


@contextlib.contextmanager
def suppress_counters():
    """Silence the route counters that read `counting()` (quant's hits and
    fallbacks) while a grad lowering re-runs a forward lowering that already
    counted itself on the forward pass (JAX registry.py:213-217)."""
    prev = _QUIET[0]
    _QUIET[0] = True
    try:
        yield
    finally:
        _QUIET[0] = prev


def counting() -> bool:
    """False inside `suppress_counters`."""
    return not _QUIET[0]


@dataclass
class OpDef:
    type: str
    lower: Optional[Callable] = None          # (ctx, op, ins) -> {slot: [values]}
    infer_shape: Optional[Callable] = None    # (op, block) -> None
    grad: Any = None                          # None=generic; NO_GRAD; or maker fn
    # forward input slots the generic grad should NOT differentiate
    non_diff_inputs: Sequence[str] = field(default_factory=tuple)


_REGISTRY: Dict[str, OpDef] = {}


def register(type: str, *, lower=None, infer_shape=None, grad=None,
             non_diff_inputs=()) -> OpDef:
    if type in _REGISTRY:
        raise ValueError(f"op '{type}' registered twice")
    d = OpDef(type=type, lower=lower, infer_shape=infer_shape, grad=grad,
              non_diff_inputs=tuple(non_diff_inputs))
    _REGISTRY[type] = d
    return d


def op(type: str, *, infer_shape=None, grad=None, non_diff_inputs=()):
    """Decorator form: @op("relu") def _(ctx, op, ins): ..."""
    def deco(fn):
        register(type, lower=fn, infer_shape=infer_shape, grad=grad,
                 non_diff_inputs=non_diff_inputs)
        return fn
    return deco


def grad_op(fwd_type: str):
    """Decorator: the explicit lowering of `<fwd_type>_grad`, the OpDesc
    the default grad maker emits (forward inputs and outputs, the output
    cotangents in; the input grads out), in place of `generic_grad_lower`."""
    def deco(fn):
        register(fwd_type + "_grad", lower=fn, infer_shape=infer_grad_shapes,
                 grad=NO_GRAD)
        return fn
    return deco


def cotangent(ins, slot, like):
    """The cotangent of forward output `slot` as the generic grad takes it:
    in the output's dtype and shape, or None when the loss does not use
    the output."""
    g = ins.get(slot + "@GRAD")
    if not g or g[0] is None:
        return None
    return g[0].to(like.dtype).reshape(like.shape)


def zero_grads(op_, ins):
    """Zeros for every input grad an explicit grad op owes when its output
    cotangent is missing (the output unused by the loss): no re-run."""
    outs = {}
    for slot, names in op_.desc.outputs.items():
        srcs = ins.get(slot[: -len("@GRAD")], [])
        outs[slot] = [torch.zeros_like(srcs[i])
                      if i < len(srcs) and srcs[i] is not None else None
                      for i in range(len(names))]
    return outs


def get(type: str) -> OpDef:
    d = try_get(type)
    if d is None:
        raise KeyError(f"op '{type}' is not registered in the port")
    return d


def try_get(type: str) -> Optional[OpDef]:
    d = _REGISTRY.get(type)
    if d is None and type.endswith("_grad") and type[: -len("_grad")] in _REGISTRY:
        # auto-generated grad op backed by the generic lowering; registered
        # lazily so every differentiable forward op gets a grad op for free
        d = OpDef(type=type, lower=generic_grad_lower,
                  infer_shape=infer_grad_shapes, grad=NO_GRAD)
        _REGISTRY[type] = d
    return d


def static_infer(type: str):
    """The shape rule the static analyzer uses for `type` (analysis/infer.py,
    the JAX package's registry.static_infer): the registered infer_shape,
    the generic grad mirror for any `<base>_grad` of a registered base, or
    None. Unlike try_get it never adds a lazy grad entry."""
    d = _REGISTRY.get(type)
    if d is not None and d.infer_shape is not None:
        return d.infer_shape
    if type.endswith("_grad") and type[: -len("_grad")] in _REGISTRY:
        return infer_grad_shapes
    return None


# ---------------------------------------------------------------------------
# Generic gradient machinery
# ---------------------------------------------------------------------------

def make_grad_op_descs(fwd: OpDesc, no_grad_set: set) -> List[OpDesc]:
    """Grad op desc(s) for a forward op (reference GradOpDescMakerBase,
    framework/grad_op_desc_maker.h). Custom makers take precedence; the
    default emits one `<type>_grad` op wired by the @GRAD naming
    convention."""
    opdef = get(fwd.type)
    if opdef.grad is NO_GRAD:
        return []
    if callable(opdef.grad):
        return opdef.grad(fwd, no_grad_set)
    if opdef.lower is None:
        raise ValueError(f"op '{fwd.type}' has no lowering and no custom "
                         f"grad maker")
    inputs: Dict[str, List[str]] = {}
    for slot, names in fwd.inputs.items():
        inputs[slot] = list(names)
    for slot, names in fwd.outputs.items():
        inputs[slot] = list(names)
        inputs[slot + "@GRAD"] = [grad_var_name(n) for n in names]
    outputs = {
        slot + "@GRAD": [grad_var_name(n) for n in names]
        for slot, names in fwd.inputs.items()
        if slot not in opdef.non_diff_inputs
        and any(n not in no_grad_set for n in names)
    }
    if not outputs:
        return []
    g = OpDesc(type=fwd.type + "_grad", inputs=inputs, outputs=outputs,
               attrs=dict(fwd.attrs))
    g.attrs["__fwd_type__"] = fwd.type
    return [g]


def _is_diff(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def forward_view(op):
    """The forward op a grad op mirrors: its forward input slots, and its
    forward output slots (those with a matching `@GRAD` input slot)."""
    fwd_type = op.attr("__fwd_type__") or op.type[: -len("_grad")]
    fwd_in_slots = [s for s in op.desc.inputs
                    if not s.endswith("@GRAD")
                    and s + "@GRAD" not in op.desc.inputs]
    fwd_out_slots = [s for s in op.desc.inputs
                     if not s.endswith("@GRAD") and s + "@GRAD" in op.desc.inputs]
    fwd_attrs = {k: v for k, v in op.desc.attrs.items() if k != "__fwd_type__"}
    fwd_desc = OpDesc(type=fwd_type,
                      inputs={s: op.desc.inputs[s] for s in fwd_in_slots},
                      outputs={s: list(op.desc.inputs[s]) for s in fwd_out_slots},
                      attrs=fwd_attrs)
    from ..framework.framework import Operator
    view = Operator.__new__(Operator)
    view.block = getattr(op, "block", None)
    view.desc = fwd_desc
    view.creation_site = getattr(op, "creation_site", None)
    return view, fwd_in_slots, fwd_out_slots


# forward op type -> re-runs of its lowering by generic_grad_lower
RERUNS: collections.Counter = collections.Counter()


def generic_grad_lower(ctx, op, ins):
    """Lowering of auto-generated `<type>_grad` ops: the forward lowering
    re-run on detached leaf copies of the differentiable inputs, then
    `torch.autograd.grad` against the output cotangents.

    Grad-op inputs hold the forward inputs (original slot names), the
    forward outputs, and `<slot>@GRAD` cotangents; outputs are `<slot>@GRAD`
    input grads. Integer outputs take no cotangent; a missing cotangent is
    zeros (an output the loss does not use), which contributes nothing and
    is left out of the autograd call. Each grad comes out in its input's
    dtype."""
    view, fwd_in_slots, fwd_out_slots = forward_view(op)
    fwd_def = get(view.type)
    RERUNS[view.type] += 1
    fwd_ins = {s: list(ins[s]) for s in fwd_in_slots if s in ins}

    # differentiable leaves: float tensors in slots this grad op wants
    diff_paths = []  # (slot, idx)
    for slot in sorted(fwd_in_slots):
        if slot + "@GRAD" not in op.desc.outputs or \
                slot in fwd_def.non_diff_inputs:
            continue
        for i, v in enumerate(fwd_ins.get(slot, [])):
            if _is_diff(v):
                diff_paths.append((slot, i))

    leaves = []
    with torch.enable_grad():
        for slot, i in diff_paths:
            leaf = fwd_ins[slot][i].detach().requires_grad_(True)
            fwd_ins[slot][i] = leaf
            leaves.append(leaf)
        with span("rerun:" + view.type), suppress_counters():
            outs = fwd_def.lower(ctx, view, fwd_ins)
        tensors, cts = [], []
        for s in sorted(fwd_out_slots):
            gvals = ins.get(s + "@GRAD", [])
            for j, v in enumerate(outs.get(s, [])):
                if not isinstance(v, torch.Tensor) or not v.requires_grad \
                        or not v.is_floating_point():
                    continue
                if j < len(gvals) and gvals[j] is not None:
                    tensors.append(v)
                    cts.append(gvals[j].to(v.dtype).reshape(v.shape))
        grads = [None] * len(leaves)
        if tensors and leaves:
            grads = torch.autograd.grad(tensors, leaves, cts,
                                        allow_unused=True)

    by_slot: Dict[str, Dict[int, Any]] = {}
    for (slot, i), leaf, g in zip(diff_paths, leaves, grads):
        by_slot.setdefault(slot, {})[i] = \
            torch.zeros_like(leaf) if g is None else g.detach()
    result: Dict[str, List[Any]] = {}
    for slot, names in op.desc.outputs.items():
        base = slot[: -len("@GRAD")]
        vals = []
        for i in range(len(names)):
            g = by_slot.get(base, {}).get(i)
            if g is None:
                # non-float input that still demanded a grad slot: zeros
                srcs = ins.get(base, [])
                src = srcs[i] if i < len(srcs) else None
                g = torch.zeros_like(src) if isinstance(src, torch.Tensor) \
                    else None
            vals.append(g)
        result[slot] = vals
    return result


def infer_grad_shapes(op, block):
    """Shape inference for generic grad ops: each input grad mirrors its
    forward var's shape and dtype."""
    for slot, gnames in op.desc.outputs.items():
        base = slot[: -len("@GRAD")]
        fnames = op.desc.inputs.get(base, [])
        for gname, fname in zip(gnames, fnames):
            if block.desc.has_var(gname) and block.desc.has_var(fname):
                f = block.desc.var(fname)
                g = block.desc.var(gname)
                g.shape = list(f.shape) if f.shape is not None else None
                g.dtype = f.dtype
