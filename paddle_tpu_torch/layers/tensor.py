"""Tensor-creation layers (the port's counterpart of
paddle_tpu/layers/tensor.py; reference python/paddle/fluid/layers/tensor.py)."""

from __future__ import annotations

import numpy as np

from ..framework.framework import Variable, convert_dtype
from ..initializer import ConstantInitializer
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr

__all__ = ["create_tensor", "create_parameter", "create_global_var", "cast",
           "concat", "sums", "assign", "fill_constant",
           "fill_constant_batch_size_like", "ones", "zeros", "argmin",
           "argmax"]


def create_tensor(dtype, name=None, persistable=False):
    """A variable of the current block with no producer yet (tensor.py:18),
    for an op's `out=` or an assign to fill."""
    helper = LayerHelper("create_tensor", name=name)
    return helper.create_variable(name=helper.name, dtype=dtype,
                                  persistable=persistable)


def sums(input, out=None):
    """The elementwise sum of the `input` list (tensor.py:61)."""
    helper = LayerHelper("sum", input=input)
    if out is None:
        out = helper.create_tmp_variable(dtype=helper.input_dtype())
    helper.append_op(type="sum", inputs={"X": input}, outputs={"Out": [out]})
    return out


def ones(shape, dtype, force_cpu=False):
    return fill_constant(shape=shape, dtype=dtype, value=1.0)


def zeros(shape, dtype, force_cpu=False):
    return fill_constant(shape=shape, dtype=dtype, value=0.0)


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


def cast(x, dtype):
    """x in `dtype` (tensor.py:44); the grad casts back."""
    helper = LayerHelper("cast")
    dtype = convert_dtype(dtype)
    out = helper.create_tmp_variable(dtype=dtype)
    helper.append_op(type="cast", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"in_dtype": x.dtype, "out_dtype": dtype})
    return out


def assign(input, output=None):
    """Copy a Variable into `output` (a new one by default), or make a
    numpy array a constant (tensor.py:69)."""
    helper = LayerHelper("assign")
    if isinstance(input, Variable):
        if output is None:
            output = helper.create_tmp_variable(dtype=input.dtype)
        helper.append_op(type="assign", inputs={"X": [input]},
                         outputs={"Out": [output]})
    elif isinstance(input, np.ndarray):
        if output is None:
            output = helper.create_tmp_variable(dtype=input.dtype.name)
        helper.append_op(
            type="fill_constant_tensor", outputs={"Out": [output]},
            attrs={"shape": list(input.shape), "dtype": input.dtype.name,
                   "values": input.ravel().tolist()})
    else:
        raise TypeError("assign expects Variable or ndarray")
    return output


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0):
    """A constant whose dim `output_dim_idx` is `input`'s dim
    `input_dim_idx` (tensor.py:101)."""
    helper = LayerHelper("fill_constant_batch_size_like")
    dtype = convert_dtype(dtype)
    out = helper.create_tmp_variable(dtype=dtype)
    helper.append_op(type="fill_constant_batch_size_like",
                     inputs={"Input": [input]}, outputs={"Out": [out]},
                     attrs={"shape": list(shape), "dtype": dtype,
                            "value": float(value),
                            "input_dim_idx": input_dim_idx,
                            "output_dim_idx": output_dim_idx})
    out.stop_gradient = True
    out.desc.stop_gradient = True
    return out


def _arg_min_max(x, op_type, axis):
    helper = LayerHelper(op_type)
    out = helper.create_tmp_variable(dtype="int64")
    helper.append_op(type=op_type, inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"axis": axis})
    return out


def argmin(x, axis=0):
    return _arg_min_max(x, "arg_min", axis)


def argmax(x, axis=0):
    return _arg_min_max(x, "arg_max", axis)
