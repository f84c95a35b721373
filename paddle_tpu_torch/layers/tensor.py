"""Tensor-creation layers, the part the training slices use (the port's
counterpart of paddle_tpu/layers/tensor.py; reference
python/paddle/fluid/layers/tensor.py)."""

from __future__ import annotations

from ..framework.framework import convert_dtype
from ..initializer import ConstantInitializer
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr

__all__ = ["create_parameter", "create_global_var", "fill_constant", "concat"]


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """A parameter outside any layer (tensor.py:24), initialized by the
    startup program; the transformer keeps its position embedding in one."""
    helper = LayerHelper("create_parameter", name=name)
    attr = ParamAttr.to_attr(attr) if attr else ParamAttr(name=name)
    return helper.create_parameter(attr, shape, dtype, is_bias,
                                   default_initializer)


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    """A global-block variable filled with `value` by the startup program
    (tensor.py:33); the optimizers keep their learning rate in one."""
    helper = LayerHelper("global_var", name=name)
    var = helper.create_global_variable(
        name=helper.name if name is None else name, dtype=dtype, shape=shape,
        persistable=persistable)
    helper.set_variable_initializer(var, ConstantInitializer(value))
    return var


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    """A constant tensor (tensor.py:88); no gradient flows through it."""
    helper = LayerHelper("fill_constant")
    dtype = convert_dtype(dtype)
    if out is None:
        out = helper.create_tmp_variable(dtype=dtype)
    helper.append_op(type="fill_constant", outputs={"Out": [out]},
                     attrs={"shape": list(shape), "dtype": dtype,
                            "value": float(value)})
    out.stop_gradient = True
    out.desc.stop_gradient = True
    return out


def concat(input, axis=0, name=None):
    """The inputs joined along `axis` (tensor.py:53)."""
    helper = LayerHelper("concat", input=input, name=name)
    out = helper.create_tmp_variable(dtype=helper.input_dtype())
    helper.append_op(type="concat", inputs={"X": input},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out
