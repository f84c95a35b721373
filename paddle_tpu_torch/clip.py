"""Error clip and gradient clipping (the port's counterpart of
paddle_tpu/clip.py; reference python/paddle/fluid/clip.py:32-215).

`minimize` runs `append_gradient_clip_ops` on the (param, grad) pairs
before the regularizers and the optimizer ops, as in the JAX package. A
parameter's `gradient_clip_attr` (set_gradient_clip) picks its clip:
GradientClipByValue (a `clip` op), GradientClipByNorm (`clip_by_norm`) or
GradientClipByGlobalNorm, which scales every grad of its group by
clip_norm / max(clip_norm, global norm), the norm computed once a group.
The global norm is marked on the program (`_telemetry_fetch_extra`) for
the executor to publish as the `optimizer_global_norm` gauge.
"""

from __future__ import annotations

__all__ = ["ErrorClipByValue", "GradientClipByValue", "GradientClipByNorm",
           "GradientClipByGlobalNorm", "set_gradient_clip",
           "append_gradient_clip_ops", "error_clip_callback"]


class BaseErrorClipAttr:
    def append_clip_op(self, block, grad_name):
        raise NotImplementedError


class ErrorClipByValue(BaseErrorClipAttr):
    """Clip a variable's gradient to [min, max] in place (min = -max by
    default)."""

    def __init__(self, max, min=None):
        max = float(max)
        self.max = max
        self.min = float(min) if min is not None else -max

    def append_clip_op(self, block, grad_name):
        block.append_op(type="clip", inputs={"X": [grad_name]},
                        outputs={"Out": [grad_name]},
                        attrs={"min": self.min, "max": self.max})


def error_clip_callback(block, op):
    """The per-op error clipping hook minimize passes to append_backward
    (reference clip.py:66). It appends nothing, as in the JAX package: an
    ErrorClipByValue acts where its append_clip_op is called on a grad."""


class BaseGradientClipAttr:
    def process_context(self, context, param, grad):
        pass

    def create_operators(self, param, grad):
        raise NotImplementedError


class NullGradientClipAttr(BaseGradientClipAttr):
    def create_operators(self, param, grad):
        return param, grad


class GradientClipByValue(BaseGradientClipAttr):
    def __init__(self, max, min=None):
        max = float(max)
        self.max = max
        self.min = float(min) if min is not None else -max

    def create_operators(self, param, grad):
        from .layers.nn import clip as clip_layer
        return param, clip_layer(grad, self.min, self.max)


class GradientClipByNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def create_operators(self, param, grad):
        from .layers.nn import clip_by_norm
        return param, clip_by_norm(grad, self.clip_norm)


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = clip_norm
        self.group_name = group_name

    def process_context(self, context, param, grad):
        if self.group_name not in context:
            context[self.group_name] = []
            context[self.group_name + "_clip_value"] = self.clip_norm
        from .layers.nn import reduce_sum
        from .layers.ops import square
        context[self.group_name].append(reduce_sum(square(grad)))

    def create_operators(self, param, grad):
        from .layers import nn, ops, tensor
        context = getattr(self, "_context")
        # the norm and the scale once a group, shared by its parameters;
        # every shape is [1], as in the JAX package, so the scale promotes
        # as it does there
        scale_key = self.group_name + "_scale_var"
        if scale_key not in context:
            group = context[self.group_name]
            total = group[0] if len(group) == 1 else tensor.sums(group)
            global_norm = ops.sqrt(total)
            clip_value = tensor.fill_constant([1], "float32", self.clip_norm)
            context[scale_key] = nn.elementwise_div(
                clip_value, nn.elementwise_max(clip_value, global_norm))
            prog = global_norm.block.program
            marks = getattr(prog, "_telemetry_fetch_extra", None)
            if marks is None:
                marks = prog._telemetry_fetch_extra = {}
            marks["optimizer_global_norm"] = global_norm.name
        return param, nn.elementwise_mul(grad, context[scale_key])


def set_gradient_clip(clip, param_list=None, program=None):
    """Give `clip` to the parameters of `param_list` (names or Variables),
    every parameter of `program` (the default main program) by default."""
    from .framework.framework import default_main_program
    program = program or default_main_program()
    if param_list is None:
        param_list = program.global_block().all_parameters()
    param_list = [program.global_block().var(p) if isinstance(p, str) else p
                  for p in param_list]
    for param in param_list:
        param.gradient_clip_attr = clip


def append_gradient_clip_ops(param_grad):
    """The (param, grad) pairs with each parameter's clip applied: every
    clip's context first (a global norm sees the whole group), then the
    clip ops. A parameter whose clip is no BaseGradientClipAttr raises
    rather than train unclipped."""
    context = {}
    for p, g in param_grad:
        clip_attr = getattr(p, "gradient_clip_attr", None) \
            or NullGradientClipAttr()
        if not isinstance(clip_attr, BaseGradientClipAttr):
            raise TypeError(f"parameter {p.name} asks for gradient clip "
                            f"{clip_attr!r}, which is no gradient clip "
                            f"attr (clip.GradientClipByValue, ByNorm, "
                            f"ByGlobalNorm)")
        clip_attr.process_context(context=context, param=p, grad=g)
    res = []
    for p, g in param_grad:
        clip_attr = getattr(p, "gradient_clip_attr", None) \
            or NullGradientClipAttr()
        clip_attr._context = context
        res.append(clip_attr.create_operators(param=p, grad=g))
    return res
