"""Operators on Variable (the port's counterpart of
paddle_tpu/layers/math_op_patch.py; reference
python/paddle/fluid/layers/math_op_patch.py): `a + b`, `a * 2.0`, `2.0 / a`,
`a ** 0.5`, `a < b`, `-a` build elementwise, scale, pow and compare ops.
A Python scalar becomes a `scale` op (or `pow` for `x ** s`) where one
suffices, else a `fill_constant` operand. The learning-rate schedules are
written with them. Patched in when `layers` is imported."""

from __future__ import annotations

from ..framework.framework import Variable
from ..layer_helper import LayerHelper


def _scalar_op(var, scale, bias):
    helper = LayerHelper("scale")
    out = helper.create_tmp_variable(dtype=var.dtype)
    helper.append_op(type="scale", inputs={"X": [var]}, outputs={"Out": [out]},
                     attrs={"scale": float(scale), "bias": float(bias)})
    return out


def _const_like(var, value):
    """A constant broadcastable against `var`, a -1 batch dim taken from
    it at run time."""
    shape = list(var.shape or [1])
    if any(d is None or d < 0 for d in shape):
        from .tensor import fill_constant_batch_size_like
        shape = [1 if (d is None or d < 0) else d for d in shape]
        return fill_constant_batch_size_like(var, shape, var.dtype, value)
    from .tensor import fill_constant
    return fill_constant(shape, var.dtype, value)


def _binary(op_type, reverse=False):
    def impl(self, other):
        if isinstance(other, (int, float)):
            if op_type == "elementwise_add":
                return _scalar_op(self, 1.0, other)
            if op_type == "elementwise_sub":
                if reverse:
                    return _scalar_op(self, -1.0, other)
                return _scalar_op(self, 1.0, -other)
            if op_type == "elementwise_mul":
                return _scalar_op(self, other, 0.0)
            if op_type == "elementwise_div" and not reverse:
                return _scalar_op(self, 1.0 / other, 0.0)
            if op_type == "elementwise_pow" and not reverse:
                helper = LayerHelper("pow")
                out = helper.create_tmp_variable(dtype=self.dtype)
                helper.append_op(type="pow", inputs={"X": [self]},
                                 outputs={"Out": [out]},
                                 attrs={"factor": float(other)})
                return out
            other = _const_like(self, other)
        helper = LayerHelper(op_type)
        out = helper.create_tmp_variable(dtype=self.dtype)
        x, y = (other, self) if reverse else (self, other)
        helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                         outputs={"Out": [out]})
        return out
    return impl


def _compare(op_type):
    def impl(self, other):
        helper = LayerHelper(op_type)
        out = helper.create_tmp_variable(dtype="bool")
        helper.append_op(type=op_type, inputs={"X": [self], "Y": [other]},
                         outputs={"Out": [out]})
        return out
    return impl


def monkey_patch_variable():
    Variable.__add__ = _binary("elementwise_add")
    Variable.__radd__ = _binary("elementwise_add", reverse=True)
    Variable.__sub__ = _binary("elementwise_sub")
    Variable.__rsub__ = _binary("elementwise_sub", reverse=True)
    Variable.__mul__ = _binary("elementwise_mul")
    Variable.__rmul__ = _binary("elementwise_mul", reverse=True)
    Variable.__truediv__ = _binary("elementwise_div")
    Variable.__rtruediv__ = _binary("elementwise_div", reverse=True)
    Variable.__pow__ = _binary("elementwise_pow")
    Variable.__rpow__ = _binary("elementwise_pow", reverse=True)
    Variable.__lt__ = _compare("less_than")
    Variable.__le__ = _compare("less_equal")
    Variable.__gt__ = _compare("greater_than")
    Variable.__ge__ = _compare("greater_equal")
    Variable.__neg__ = lambda self: _scalar_op(self, -1.0, 0.0)


monkey_patch_variable()
