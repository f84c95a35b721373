"""Sequence layers DSL (the port's counterpart of
paddle_tpu/layers/sequence.py; reference python/paddle/fluid/layers/nn.py
dynamic_lstm :247, dynamic_lstmp :393, dynamic_gru :579, gru_unit :686,
lstm_unit :1935, sequence_conv, sequence_pool/first_step/last_step,
sequence_softmax, sequence_expand, sequence_reshape, lod_reset). Each layer
emits the same ops, attrs and names as the JAX package's.

All sequence inputs and outputs use the padded-dense convention
(executor.pack_to_padded): [batch, T, D] with a lengths tensor beside it."""

from __future__ import annotations

from ..layer_helper import LayerHelper
from ..initializer import ConstantInitializer

__all__ = [
    "sequence_unfold", "sequence_mask", "sequence_fold", "context_project",
    "dynamic_lstm", "dynamic_lstmp", "dynamic_gru", "gru_unit", "lstm_unit",
    "sequence_conv", "sequence_pool", "sequence_first_step",
    "sequence_last_step", "sequence_softmax", "sequence_expand",
    "sequence_reshape", "sequence_slice", "sequence_concat", "sequence_erase",
    "lod_reset",
]


def dynamic_lstm(input, size, h_0=None, c_0=None, param_attr=None,
                 bias_attr=None, use_peepholes=True, is_reverse=False,
                 gate_activation="sigmoid", cell_activation="tanh",
                 candidate_activation="tanh", dtype="float32", name=None):
    """LSTM over a padded sequence (reference nn.py:247 dynamic_lstm,
    lstm_op.cc). `input` is the pre-computed x-projection [B, T, 4H]
    (size = 4H); returns (hidden [B,T,H], cell [B,T,H])."""
    helper = LayerHelper("lstm", param_attr=param_attr, bias_attr=bias_attr,
                         name=name)
    size = size // 4
    weight = helper.create_parameter(attr=helper.param_attr,
                                     shape=[size, 4 * size], dtype=dtype)
    bias_size = [1, 7 * size if use_peepholes else 4 * size]
    bias = helper.create_parameter(attr=helper.bias_attr, shape=bias_size,
                                   dtype=dtype, is_bias=True)
    hidden = helper.create_tmp_variable(dtype)
    cell = helper.create_tmp_variable(dtype)
    inputs = {"Input": [input], "Weight": [weight], "Bias": [bias]}
    if h_0 is not None:
        inputs["H0"] = [h_0]
    if c_0 is not None:
        inputs["C0"] = [c_0]
    helper.append_op(type="lstm", inputs=inputs,
                     outputs={"Hidden": [hidden], "Cell": [cell]},
                     attrs={"use_peepholes": use_peepholes,
                            "is_reverse": is_reverse,
                            "gate_activation": gate_activation,
                            "cell_activation": cell_activation,
                            "candidate_activation": candidate_activation})
    return hidden, cell


def dynamic_lstmp(input, size, proj_size, param_attr=None, bias_attr=None,
                  use_peepholes=True, is_reverse=False,
                  gate_activation="sigmoid", cell_activation="tanh",
                  candidate_activation="tanh", proj_activation="tanh",
                  dtype="float32", name=None):
    """LSTM with a recurrent projection layer (reference nn.py:393,
    lstmp_op.cc): hidden is projected to proj_size before recurrence.
    Emits a single fused `lstmp` op; returns
    (projection [B,T,P], cell [B,T,H])."""
    helper = LayerHelper("lstmp", param_attr=param_attr, bias_attr=bias_attr,
                         name=name)
    size = size // 4
    # recurrent weight operates on the projected state: [P, 4H]
    weight = helper.create_parameter(attr=helper.param_attr,
                                     shape=[proj_size, 4 * size], dtype=dtype)
    proj_weight = helper.create_parameter(attr=helper.param_attr,
                                          shape=[size, proj_size], dtype=dtype)
    bias_size = [1, 7 * size if use_peepholes else 4 * size]
    bias = helper.create_parameter(attr=helper.bias_attr, shape=bias_size,
                                   dtype=dtype, is_bias=True)
    projection = helper.create_tmp_variable(dtype)
    cell = helper.create_tmp_variable(dtype)
    helper.append_op(type="lstmp",
                     inputs={"Input": [input], "Weight": [weight],
                             "ProjWeight": [proj_weight], "Bias": [bias]},
                     outputs={"Projection": [projection], "Cell": [cell]},
                     attrs={"use_peepholes": use_peepholes,
                            "is_reverse": is_reverse,
                            "gate_activation": gate_activation,
                            "cell_activation": cell_activation,
                            "candidate_activation": candidate_activation,
                            "proj_activation": proj_activation})
    return projection, cell


def dynamic_gru(input, size, param_attr=None, bias_attr=None,
                is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", h_0=None, dtype="float32"):
    """GRU over a padded sequence (reference nn.py:579, gru_op.cc).
    `input` is the x-projection [B, T, 3H] (size = H)."""
    helper = LayerHelper("gru", param_attr=param_attr, bias_attr=bias_attr)
    weight = helper.create_parameter(attr=helper.param_attr,
                                     shape=[size, 3 * size], dtype=dtype)
    bias = helper.create_parameter(attr=helper.bias_attr,
                                   shape=[1, 3 * size], dtype=dtype,
                                   is_bias=True)
    hidden = helper.create_tmp_variable(dtype)
    inputs = {"Input": [input], "Weight": [weight], "Bias": [bias]}
    if h_0 is not None:
        inputs["H0"] = [h_0]
    helper.append_op(type="gru", inputs=inputs,
                     outputs={"Hidden": [hidden]},
                     attrs={"is_reverse": is_reverse,
                            "gate_activation": gate_activation,
                            "activation": candidate_activation})
    return hidden


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation="tanh", gate_activation="sigmoid"):
    """Single GRU step (reference nn.py:686, gru_unit_op.cc). `input` is the
    x-projection [B, 3H] (size = 3H); `hidden` [B, H]. Returns
    (new_hidden, reset_hidden_prev, gate)."""
    helper = LayerHelper("gru_unit", param_attr=param_attr,
                         bias_attr=bias_attr)
    dtype = input.dtype
    size = size // 3
    weight = helper.create_parameter(attr=helper.param_attr,
                                     shape=[size, 3 * size], dtype=dtype)
    bias = helper.create_parameter(attr=helper.bias_attr,
                                   shape=[1, 3 * size], dtype=dtype,
                                   is_bias=True,
                                   default_initializer=ConstantInitializer(0.0))
    gate = helper.create_tmp_variable(dtype)
    reset_hidden_prev = helper.create_tmp_variable(dtype)
    updated_hidden = helper.create_tmp_variable(dtype)
    helper.append_op(type="gru_unit",
                     inputs={"Input": [input], "HiddenPrev": [hidden],
                             "Weight": [weight], "Bias": [bias]},
                     outputs={"Hidden": [updated_hidden],
                              "ResetHiddenPrev": [reset_hidden_prev],
                              "Gate": [gate]},
                     attrs={"activation": activation,
                            "gate_activation": gate_activation})
    return updated_hidden, reset_hidden_prev, gate


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, name=None):
    """Single LSTM step (reference nn.py:1935): projects [x_t, h_prev] to 4H
    gates with an fc, then applies the lstm_unit op. Returns (h, c)."""
    from . import nn as nn_layers
    from . import tensor as tensor_layers
    helper = LayerHelper("lstm_unit", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    size = cell_t_prev.shape[-1]
    concat_out = tensor_layers.concat(input=[x_t, hidden_t_prev], axis=-1)
    fc_out = nn_layers.fc(input=concat_out, size=4 * size,
                          param_attr=param_attr, bias_attr=bias_attr)
    c = helper.create_tmp_variable(x_t.dtype)
    h = helper.create_tmp_variable(x_t.dtype)
    helper.append_op(type="lstm_unit",
                     inputs={"X": [fc_out], "C_prev": [cell_t_prev]},
                     outputs={"C": [c], "H": [h]},
                     attrs={"forget_bias": forget_bias})
    return h, c


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=None, bias_attr=None, param_attr=None, act=None):
    """Context-window convolution over time (reference nn.py sequence_conv,
    sequence_conv_op.cc)."""
    helper = LayerHelper("sequence_conv", param_attr=param_attr,
                         bias_attr=bias_attr, act=act)
    dtype = input.dtype
    filter_shape = [filter_size * input.shape[-1], num_filters]
    filter_param = helper.create_parameter(attr=helper.param_attr,
                                           shape=filter_shape, dtype=dtype)
    pre_bias = helper.create_tmp_variable(dtype)
    helper.append_op(type="sequence_conv",
                     inputs={"X": [input], "Filter": [filter_param]},
                     outputs={"Out": [pre_bias]},
                     attrs={"contextStride": filter_stride,
                            "contextStart": -int(filter_size // 2),
                            "contextLength": filter_size})
    # output is [B, T, M]: bias over the feature dim only
    pre_act = helper.append_bias_op(pre_bias, dim_start=2)
    return helper.append_activation(pre_act)


def sequence_pool(input, pool_type):
    """Pool a sequence to one row per instance (reference nn.py
    sequence_pool; pool_type in sum/average/sqrt/max/last/first)."""
    helper = LayerHelper("sequence_pool", input=input)
    out = helper.create_tmp_variable(input.dtype)
    max_index = helper.create_tmp_variable("int32")
    helper.append_op(type="sequence_pool", inputs={"X": [input]},
                     outputs={"Out": [out], "MaxIndex": [max_index]},
                     attrs={"pooltype": pool_type.upper()})
    return out


def sequence_first_step(input):
    return sequence_pool(input, "first")


def sequence_last_step(input):
    return sequence_pool(input, "last")


def sequence_softmax(input, name=None):
    helper = LayerHelper("sequence_softmax", name=name)
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="sequence_softmax", inputs={"X": [input]},
                     outputs={"Out": [out]})
    return out


def sequence_expand(x, y, name=None):
    """Expand x to match y's sequence lengths (reference nn.py
    sequence_expand)."""
    helper = LayerHelper("sequence_expand", input=x, name=name)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(type="sequence_expand",
                     inputs={"X": [x], "Y": [y]}, outputs={"Out": [out]})
    return out


def sequence_reshape(input, new_dim):
    helper = LayerHelper("sequence_reshape", input=input)
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="sequence_reshape", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"new_dim": new_dim})
    return out


def sequence_slice(input, offset, length, name=None):
    helper = LayerHelper("sequence_slice", input=input, name=name)
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="sequence_slice",
                     inputs={"X": [input], "Offset": [offset],
                             "Length": [length]},
                     outputs={"Out": [out]})
    return out


def sequence_concat(input, name=None):
    helper = LayerHelper("sequence_concat", input=input, name=name)
    out = helper.create_tmp_variable(helper.input_dtype())
    helper.append_op(type="sequence_concat", inputs={"X": input},
                     outputs={"Out": [out]})
    return out


def sequence_erase(input, tokens, name=None):
    helper = LayerHelper("sequence_erase", input=input, name=name)
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="sequence_erase", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"tokens": list(tokens)})
    return out


def lod_reset(x, y=None, target_lod=None):
    """Reset sequence lengths (reference nn.py:3322 lod_reset)."""
    helper = LayerHelper("lod_reset", input=x)
    out = helper.create_tmp_variable(x.dtype)
    if y is not None:
        helper.append_op(type="lod_reset", inputs={"X": [x], "Y": [y]},
                         outputs={"Out": [out]})
    elif target_lod is not None:
        helper.append_op(type="lod_reset", inputs={"X": [x]},
                         outputs={"Out": [out]},
                         attrs={"target_lod": list(target_lod)})
    else:
        raise ValueError("lod_reset needs y or target_lod")
    return out


def sequence_unfold(x):
    """Flatten a nested (lod_level=2) sequence batch [B, S, T, ...] into its
    sub-sequences [B*S, T, ...] so inner-level sequence ops apply (TPU-native
    nested-LoD idiom; reference nested offsets lod_tensor.h:55)."""
    helper = LayerHelper("sequence_unfold")
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(type="sequence_unfold", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={})
    return out


def sequence_fold(x, outer_like):
    """Regroup flattened sub-sequences back to [B, S, ...] using the outer
    structure of `outer_like` (the var sequence_unfold was applied to)."""
    helper = LayerHelper("sequence_fold")
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(type="sequence_fold",
                     inputs={"X": [x], "OuterLike": [outer_like]},
                     outputs={"Out": [out]}, attrs={})
    return out


def sequence_mask(x, name=None):
    """[B, T] float mask of valid positions for a padded sequence var
    (1 inside each sequence, 0 in padding). Reads the lengths channel the
    feed path attaches to LoD feeds; full-length for dense feeds."""
    helper = LayerHelper("sequence_mask", name=name)
    out = helper.create_tmp_variable("float32")
    helper.append_op(type="sequence_mask", inputs={"X": [x]},
                     outputs={"Y": [out]})
    return out


def context_project(x, context_length, context_start=None, name=None):
    """Concatenate a window of neighboring timesteps onto the feature
    axis, zero-padded at sequence boundaries (reference gserver
    ContextProjection; the centered default matches
    trainer_config_helpers context_projection: start = -(L-1)//2)."""
    if context_start is None:
        context_start = -(context_length - 1) // 2
    helper = LayerHelper("context_project", name=name)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(type="context_project", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"context_length": context_length,
                            "context_start": context_start})
    return out
