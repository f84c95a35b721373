"""Neural-network layers DSL, the part the ported slices use (the port's
counterpart of paddle_tpu/layers/nn.py; reference
python/paddle/fluid/layers/nn.py — fc :81, embedding :188, square_error_cost
:965, conv2d :1120, pool2d :1425, batch_norm :1478, layer_norm, reduces
:2055-2239, reshape), and fused_attention (no reference counterpart). Each
layer emits the same ops, attrs and names as the JAX package's."""

from __future__ import annotations

import math

import numpy as np

from ..initializer import ConstantInitializer, NormalInitializer
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr

__all__ = [
    "fc", "embedding", "conv2d", "pool2d", "batch_norm", "layer_norm",
    "cross_entropy", "softmax_with_cross_entropy", "square_error_cost",
    "reshape",
    "fused_attention",
    "accuracy", "mean", "elementwise_add", "elementwise_sub",
    "elementwise_mul", "elementwise_div", "elementwise_max",
    "elementwise_min", "elementwise_pow", "reduce_sum", "reduce_mean",
    "reduce_max", "reduce_min", "reduce_prod", "scale", "matmul",
]


def _simple(op_type, x, attrs=None, name=None, outs=("Out",), in_slot="X"):
    helper = LayerHelper(op_type, name=name)
    outvars = [helper.create_tmp_variable(dtype=x.dtype) for _ in outs]
    helper.append_op(type=op_type, inputs={in_slot: [x]},
                     outputs={s: [v] for s, v in zip(outs, outvars)},
                     attrs=attrs or {})
    return outvars[0] if len(outvars) == 1 else tuple(outvars)


def _pair(v):
    return list(v) if isinstance(v, (list, tuple)) else [v, v]


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    """X' @ Y' with the last two dims of each swapped where asked (reference
    nn.py matmul; the op's `alpha` attribute scales the product)."""
    helper = LayerHelper("matmul", name=name)
    out = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(type="matmul", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]},
                     attrs={"transpose_X": transpose_x,
                            "transpose_Y": transpose_y})
    return out


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       use_mkldnn=False, act=None, is_test=False, name=None):
    """Fully connected layer (reference nn.py:81): out = act(sum_i X_i W_i + b),
    lowered to `mul` + a broadcast `elementwise_add`."""
    helper = LayerHelper("fc", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = helper.input_dtype()
    mul_results = []
    for input_var, p_attr in helper.iter_inputs_and_params():
        input_shape = input_var.shape
        param_shape = [int(np.prod(input_shape[num_flatten_dims:]))] + [size]
        w = helper.create_parameter(attr=p_attr, shape=param_shape,
                                    dtype=dtype, is_bias=False)
        tmp = helper.create_tmp_variable(dtype)
        helper.append_op(type="mul",
                         inputs={"X": [input_var], "Y": [w]},
                         outputs={"Out": [tmp]},
                         attrs={"x_num_col_dims": num_flatten_dims,
                                "y_num_col_dims": 1})
        mul_results.append(tmp)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_tmp_variable(dtype)
        helper.append_op(type="sum", inputs={"X": mul_results},
                         outputs={"Out": [pre_bias]})
    pre_act = helper.append_bias_op(pre_bias, dim_start=num_flatten_dims)
    return helper.append_activation(pre_act)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32",
              shard_axis=None, cache_rows=None):
    """Embedding lookup (reference nn.py:188): a `lookup_table` op over a
    [vocab, dim] parameter. A negative padding_idx counts from the end.

    is_sparse=True keeps the gradient a SelectedRows value end to end: the
    sgd/momentum/adam sparse applies (ops/sparse_ops.py) update only the
    looked-up rows, in place. is_distributed or shard_axis row-shards the
    table over the program's mesh (parallel/embedding.py shard_table; one
    rank only: more raise, ROADMAP Queue 1 item 9b). cache_rows=N records
    a request for the hot-row cache (parallel/emb_cache.py), which
    `emb_cache.enable(program)` activates once the startup program ran."""
    helper = LayerHelper("embedding", param_attr=param_attr)
    w = helper.create_parameter(attr=helper.param_attr, shape=size,
                                dtype=dtype, is_bias=False)
    tmp = helper.create_tmp_variable(dtype)
    padding_idx = -1 if padding_idx is None else (
        padding_idx if padding_idx >= 0 else size[0] + padding_idx)
    helper.append_op(type="lookup_table",
                     inputs={"W": [w], "Ids": [input]},
                     outputs={"Out": [tmp]},
                     attrs={"is_sparse": is_sparse, "padding_idx": padding_idx})
    if shard_axis is not None or is_distributed:
        from ..parallel import embedding as embedding_mod
        embedding_mod.shard_table(helper.main_program, w.name, shard_axis)
    if cache_rows is not None:
        from ..parallel import emb_cache as emb_cache_mod
        emb_cache_mod.request_cache(helper.main_program, w.name, cache_rows)
    return tmp


def cross_entropy(input, label, soft_label=False):
    """-log of `input`'s probability of `label` (reference nn.py:135)."""
    helper = LayerHelper("cross_entropy")
    out = helper.create_tmp_variable(dtype=input.dtype)
    helper.append_op(type="cross_entropy",
                     inputs={"X": [input], "Label": [label]},
                     outputs={"Y": [out]}, attrs={"soft_label": soft_label})
    return out


def square_error_cost(input, label):
    """(input - label)^2, built from elementwise ops (reference nn.py:965)."""
    helper = LayerHelper("square_error_cost", input=input)
    minus_out = helper.create_tmp_variable(dtype=input.dtype)
    helper.append_op(type="elementwise_sub",
                     inputs={"X": [input], "Y": [label]},
                     outputs={"Out": [minus_out]})
    square_out = helper.create_tmp_variable(dtype=input.dtype)
    helper.append_op(type="square", inputs={"X": [minus_out]},
                     outputs={"Out": [square_out]})
    return square_out


def softmax_with_cross_entropy(logits, label, soft_label=False):
    helper = LayerHelper("softmax_with_cross_entropy")
    softmax = helper.create_tmp_variable(dtype=logits.dtype)
    loss = helper.create_tmp_variable(dtype=logits.dtype)
    helper.append_op(type="softmax_with_cross_entropy",
                     inputs={"Logits": [logits], "Label": [label]},
                     outputs={"Softmax": [softmax], "Loss": [loss]},
                     attrs={"soft_label": soft_label})
    return loss


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=None, param_attr=None, bias_attr=None, use_cudnn=True,
           use_mkldnn=False, act=None, name=None):
    """2-D convolution, NCHW (reference nn.py:1120). use_cudnn is accepted
    and ignored: eligible shapes run the port's own CUDA kernel."""
    helper = LayerHelper("conv2d", param_attr=param_attr, bias_attr=bias_attr,
                         act=act, name=name)
    dtype = input.dtype
    groups = groups or 1
    num_channels = input.shape[1]
    filter_size = _pair(filter_size)
    filter_shape = [num_filters, num_channels // groups] + filter_size
    fan_in = (num_channels // groups) * filter_size[0] * filter_size[1]
    std = math.sqrt(2.0 / fan_in)
    w = helper.create_parameter(
        attr=helper.param_attr, shape=filter_shape, dtype=dtype,
        default_initializer=NormalInitializer(0.0, std))
    pre_bias = helper.create_tmp_variable(dtype)
    helper.append_op(type="conv2d",
                     inputs={"Input": [input], "Filter": [w]},
                     outputs={"Output": [pre_bias]},
                     attrs={"strides": _pair(stride), "paddings": _pair(padding),
                            "dilations": _pair(dilation), "groups": groups})
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, use_mkldnn=False, name=None):
    helper = LayerHelper("pool2d", name=name)
    out = helper.create_tmp_variable(dtype=input.dtype)
    helper.append_op(type="pool2d", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"pooling_type": pool_type,
                            "ksize": _pair(pool_size),
                            "global_pooling": global_pooling,
                            "strides": _pair(pool_stride),
                            "paddings": _pair(pool_padding),
                            "ceil_mode": ceil_mode})
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               in_place=False, use_mkldnn=False, name=None,
               moving_mean_name=None, moving_variance_name=None,
               do_model_average_for_mean_and_var=False):
    """Batch normalization (reference nn.py:1478, batch_norm_op.cc)."""
    helper = LayerHelper("batch_norm", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    input_shape = input.shape
    channel_num = input_shape[1] if data_layout == "NCHW" else input_shape[-1]
    param_shape = [channel_num]
    scale = helper.create_parameter(
        attr=helper.param_attr, shape=param_shape, dtype=dtype,
        default_initializer=ConstantInitializer(1.0))
    bias = helper.create_parameter(attr=helper.bias_attr, shape=param_shape,
                                   dtype=dtype, is_bias=True)
    mean = helper.create_parameter(
        attr=ParamAttr(name=moving_mean_name, trainable=False),
        shape=param_shape, dtype=dtype,
        default_initializer=ConstantInitializer(0.0))
    variance = helper.create_parameter(
        attr=ParamAttr(name=moving_variance_name, trainable=False),
        shape=param_shape, dtype=dtype,
        default_initializer=ConstantInitializer(1.0))
    saved_mean = helper.create_tmp_variable(dtype=dtype, stop_gradient=True)
    saved_variance = helper.create_tmp_variable(dtype=dtype, stop_gradient=True)
    out = input if in_place else helper.create_tmp_variable(dtype)
    helper.append_op(
        type="batch_norm",
        inputs={"X": [input], "Scale": [scale], "Bias": [bias],
                "Mean": [mean], "Variance": [variance]},
        outputs={"Y": [out], "MeanOut": [mean], "VarianceOut": [variance],
                 "SavedMean": [saved_mean], "SavedVariance": [saved_variance]},
        attrs={"momentum": momentum, "epsilon": epsilon, "is_test": is_test})
    return helper.append_activation(out)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    """Layer normalization over the dims from begin_norm_axis on (reference
    layer_norm_op.cc), with a [prod(dims)] Scale (ones) and Bias."""
    helper = LayerHelper("layer_norm", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    param_shape = [int(np.prod(input.shape[begin_norm_axis:]))]
    inputs = {"X": [input]}
    if scale:
        s = helper.create_parameter(
            attr=helper.param_attr, shape=param_shape, dtype=dtype,
            default_initializer=ConstantInitializer(1.0))
        inputs["Scale"] = [s]
    if shift:
        b = helper.create_parameter(attr=helper.bias_attr, shape=param_shape,
                                    dtype=dtype, is_bias=True)
        inputs["Bias"] = [b]
    mean_out = helper.create_tmp_variable(dtype=dtype, stop_gradient=True)
    variance_out = helper.create_tmp_variable(dtype=dtype, stop_gradient=True)
    out = helper.create_tmp_variable(dtype)
    helper.append_op(type="layer_norm", inputs=inputs,
                     outputs={"Y": [out], "Mean": [mean_out],
                              "Variance": [variance_out]},
                     attrs={"epsilon": epsilon,
                            "begin_norm_axis": begin_norm_axis})
    return helper.append_activation(out)


def reshape(x, shape, actual_shape=None, act=None, inplace=True, name=None):
    """Reshape to `shape`: a 0 copies the input's dim, one -1 is inferred."""
    helper = LayerHelper("reshape", act=act, name=name)
    out = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(type="reshape", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"shape": list(shape)})
    return helper.append_activation(out)


def fused_attention(q, k, v, causal=False,
                    sequence_parallel=False, use_flash="auto", name=None):
    """Softmax attention over [B, T, H, D] tensors, one
    `scaled_dot_product_attention` op (nn.py:1083). use_flash=True takes
    the flash kernels (K7 forward, K8 + K9 backward, ops/attention_cuda.py);
    False the einsum path; "auto" picks flash from T = 2048
    (ops/nn_ops.FLASH_AUTO_T). sequence_parallel=True runs ring attention
    over the 'sp' axis of the program's mesh (`program._mesh`,
    parallel/ring_attention.py: K10 forward, K8 + K9 backward per shard
    pair), and the flash or einsum path when the program has no such mesh.
    The op also writes LSE, the f32 per-row logsumexp the explicit
    backward starts from, a stop_gradient output."""
    helper = LayerHelper("fused_attention")
    out = helper.create_tmp_variable(q.dtype)
    lse = helper.create_tmp_variable("float32", stop_gradient=True)
    helper.append_op(type="scaled_dot_product_attention",
                     inputs={"Q": [q], "K": [k], "V": [v]},
                     outputs={"Out": [out], "LSE": [lse]},
                     attrs={"causal": causal,
                            "sequence_parallel": sequence_parallel,
                            "use_flash": use_flash})
    return out


def accuracy(input, label, k=1, correct=None, total=None):
    helper = LayerHelper("accuracy")
    topk_out = helper.create_tmp_variable(dtype=input.dtype)
    topk_indices = helper.create_tmp_variable(dtype="int64")
    helper.append_op(type="top_k", inputs={"X": [input]},
                     outputs={"Out": [topk_out], "Indices": [topk_indices]},
                     attrs={"k": k})
    acc_out = helper.create_tmp_variable(dtype="float32")
    correct = correct or helper.create_tmp_variable(dtype="int32")
    total = total or helper.create_tmp_variable(dtype="int32")
    helper.append_op(type="accuracy",
                     inputs={"Out": [topk_out], "Indices": [topk_indices],
                             "Label": [label]},
                     outputs={"Accuracy": [acc_out], "Correct": [correct],
                              "Total": [total]})
    return acc_out


def mean(x, name=None):
    return _simple("mean", x, name=name)


def _ew(op_type):
    def f(x, y, axis=-1, act=None, name=None):
        helper = LayerHelper(op_type, act=act, name=name)
        out = helper.create_tmp_variable(dtype=x.dtype)
        helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                         outputs={"Out": [out]}, attrs={"axis": axis})
        return helper.append_activation(out)
    f.__name__ = op_type
    return f


elementwise_add = _ew("elementwise_add")
elementwise_sub = _ew("elementwise_sub")
elementwise_mul = _ew("elementwise_mul")
elementwise_div = _ew("elementwise_div")
elementwise_max = _ew("elementwise_max")
elementwise_min = _ew("elementwise_min")
elementwise_pow = _ew("elementwise_pow")


def _reduce(op_type):
    def f(input, dim=None, keep_dim=False, name=None):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_tmp_variable(dtype=input.dtype)
        if dim is not None and not isinstance(dim, (list, tuple)):
            dim = [dim]
        helper.append_op(type=op_type, inputs={"X": [input]},
                         outputs={"Out": [out]},
                         attrs={"dim": dim if dim is not None else [0],
                                "keep_dim": keep_dim,
                                "reduce_all": dim is None})
        return out
    f.__name__ = op_type
    return f


reduce_sum = _reduce("reduce_sum")
reduce_mean = _reduce("reduce_mean")
reduce_max = _reduce("reduce_max")
reduce_min = _reduce("reduce_min")
reduce_prod = _reduce("reduce_prod")


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    helper = LayerHelper("scale", act=act, name=name)
    out = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(type="scale", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"scale": float(scale), "bias": float(bias),
                            "bias_after_scale": bias_after_scale})
    return helper.append_activation(out)
