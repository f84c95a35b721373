"""Unary-op and random layer wrappers (reference: python/paddle/fluid/layers/
ops.py + layer_function_generator.py): the port's counterpart of
paddle_tpu/layers/ops.py."""

from __future__ import annotations

from ..layer_helper import LayerHelper
from ..ops.math_ops import ACTIVATIONS

_UNARY_OPS = sorted(ACTIVATIONS) + ["softmax", "sign", "cumsum"]

__all__ = list(_UNARY_OPS) + ["uniform_random", "gaussian_random",
                              "uniform_random_batch_size_like",
                              "gaussian_random_batch_size_like"]


def _make_unary(op_type):
    def f(x, name=None, **attrs):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_tmp_variable(dtype=x.dtype)
        helper.append_op(type=op_type, inputs={"X": [x]},
                         outputs={"Out": [out]}, attrs=attrs)
        return out
    f.__name__ = op_type
    f.__doc__ = f"Elementwise {op_type} (reference activation_op.cc)."
    return f


for _name in _UNARY_OPS:
    globals()[_name] = _make_unary(_name)


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0):
    helper = LayerHelper("uniform_random")
    out = helper.create_tmp_variable(dtype=dtype)
    helper.append_op(type="uniform_random", outputs={"Out": [out]},
                     attrs={"shape": list(shape), "dtype": dtype,
                            "min": min, "max": max, "seed": seed})
    return out


def gaussian_random(shape, dtype="float32", mean=0.0, std=1.0, seed=0):
    helper = LayerHelper("gaussian_random")
    out = helper.create_tmp_variable(dtype=dtype)
    helper.append_op(type="gaussian_random", outputs={"Out": [out]},
                     attrs={"shape": list(shape), "dtype": dtype,
                            "mean": mean, "std": std, "seed": seed})
    return out


def _batch_size_like(op_type, input, shape, dtype, seed, input_dim_idx,
                     output_dim_idx, **dist):
    helper = LayerHelper(op_type)
    out = helper.create_tmp_variable(dtype=dtype)
    helper.append_op(type=op_type, inputs={"Input": [input]},
                     outputs={"Out": [out]},
                     attrs={"shape": list(shape), "dtype": dtype, **dist,
                            "seed": seed, "input_dim_idx": input_dim_idx,
                            "output_dim_idx": output_dim_idx})
    return out


def uniform_random_batch_size_like(input, shape, dtype="float32", min=-1.0,
                                   max=1.0, seed=0, input_dim_idx=0,
                                   output_dim_idx=0):
    return _batch_size_like("uniform_random_batch_size_like", input, shape,
                            dtype, seed, input_dim_idx, output_dim_idx,
                            min=min, max=max)


def gaussian_random_batch_size_like(input, shape, dtype="float32", mean=0.0,
                                    std=1.0, seed=0, input_dim_idx=0,
                                    output_dim_idx=0):
    return _batch_size_like("gaussian_random_batch_size_like", input, shape,
                            dtype, seed, input_dim_idx, output_dim_idx,
                            mean=mean, std=std)
