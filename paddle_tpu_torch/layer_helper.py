"""LayerHelper: parameter-creation glue shared by all layers
(reference: python/paddle/fluid/layer_helper.py); the port's copy of
paddle_tpu/layer_helper.py, so both packages emit the same ops and names."""

from __future__ import annotations

from .framework import unique_name
from .framework.framework import (Parameter, Variable, default_main_program,
                                  default_startup_program)
from .param_attr import ParamAttr


class LayerHelper:
    def __init__(self, layer_type: str, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = kwargs.get("name")
        self.name = name if name is not None else unique_name.generate(layer_type)

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    @property
    def block(self):
        return self.main_program.current_block()

    @property
    def param_attr(self):
        return ParamAttr.to_attr(self.kwargs.get("param_attr"))

    @property
    def bias_attr(self):
        return ParamAttr.to_attr(self.kwargs.get("bias_attr"))

    def multiple_param_attr(self, length):
        attr = self.param_attr
        if isinstance(attr, ParamAttr):
            attr = [attr]
        if len(attr) != 1 and len(attr) != length:
            raise ValueError("parameter number mismatch")
        if len(attr) == 1 and length != 1:
            def clone(a):
                import copy
                c = copy.copy(a)
                c.name = None  # each replica gets its own generated name
                return c
            attr = [attr[0]] + [clone(attr[0]) for _ in range(length - 1)]
        return attr

    def iter_inputs_and_params(self, input_param_name="input"):
        inputs = self.multiple_input(input_param_name)
        attrs = self.multiple_param_attr(len(inputs))
        yield from zip(inputs, attrs)

    def multiple_input(self, input_param_name="input"):
        ipt = self.kwargs[input_param_name]
        return list(ipt) if isinstance(ipt, (list, tuple)) else [ipt]

    def input_dtype(self, input_param_name="input"):
        inputs = self.multiple_input(input_param_name)
        dtype = None
        for each in inputs:
            if dtype is None:
                dtype = each.dtype
            elif dtype != each.dtype:
                raise ValueError("all inputs must have the same dtype")
        return dtype

    def create_parameter(self, attr, shape, dtype, is_bias=False,
                         default_initializer=None) -> Parameter:
        attr = ParamAttr.to_attr(attr)
        if default_initializer is None:
            if is_bias:
                attr.set_default_bias_initializer()
            else:
                attr.set_default_param_initializer()
        else:
            attr.set_default_initializer(default_initializer)
        if attr.name is None:
            attr.name = unique_name.generate(".".join([self.name, "w"]))
        init = attr.initializer
        # parameter in the main program …
        param = self.main_program.global_block().create_parameter(
            shape=shape, dtype=dtype, **attr.to_kwargs())
        # … and its twin + init op in the startup program
        startup_param = self.startup_program.global_block().create_parameter(
            shape=shape, dtype=dtype,
            **{k: v for k, v in attr.to_kwargs().items()})
        init(startup_param, self.startup_program.global_block())
        return param

    def create_tmp_variable(self, dtype, stop_gradient=False) -> Variable:
        return self.block.create_var(
            name=unique_name.generate(".".join([self.name, "tmp"])),
            dtype=dtype, stop_gradient=stop_gradient)

    def create_variable(self, **kwargs) -> Variable:
        return self.block.create_var(**kwargs)

    def create_global_variable(self, persistable=False, **kwargs) -> Variable:
        return self.main_program.global_block().create_var(
            persistable=persistable, **kwargs)

    def set_variable_initializer(self, var, initializer):
        """Mirror `var` into the startup program and initialize it there."""
        sv = self.startup_program.global_block().create_var(
            name=var.name, shape=var.shape, dtype=var.dtype, persistable=True)
        initializer(sv, self.startup_program.global_block())
        var.persistable = True
        return var

    def append_op(self, **kwargs):
        return self.block.append_op(**kwargs)

    def append_bias_op(self, input_var, dim_start=1, dim_end=None):
        """Add a bias over dims [dim_start, dim_end) of input
        (reference layer_helper.py append_bias_op)."""
        size = list(input_var.shape[dim_start:dim_end])
        bias_attr = self.bias_attr
        if not bias_attr:
            return input_var
        if bias_attr.name is None:
            bias_attr.name = unique_name.generate(".".join([self.name, "b"]))
        b = self.create_parameter(attr=bias_attr, shape=size,
                                  dtype=input_var.dtype, is_bias=True)
        tmp = self.create_tmp_variable(dtype=input_var.dtype)
        self.append_op(type="elementwise_add",
                       inputs={"X": [input_var], "Y": [b]},
                       outputs={"Out": [tmp]},
                       attrs={"axis": dim_start})
        return tmp

    def append_activation(self, input_var):
        act = self.kwargs.get("act")
        if act is None:
            return input_var
        if isinstance(act, str):
            act = {"type": act}
        act = dict(act)
        act_type = act.pop("type")
        tmp = self.create_tmp_variable(dtype=input_var.dtype)
        self.append_op(type=act_type, inputs={"X": [input_var]},
                       outputs={"Out": [tmp]}, attrs=act)
        return tmp

    def get_parameter(self, name):
        """An existing parameter by name (the CRF's transition, shared by
        linear_chain_crf and crf_decoding)."""
        param = self.main_program.global_block().var(name)
        if not isinstance(param, Parameter):
            raise ValueError(f"no parameter named {name}")
        return param
