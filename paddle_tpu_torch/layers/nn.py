"""Neural-network layers DSL, the part the ported slices use (the port's
counterpart of paddle_tpu/layers/nn.py; reference
python/paddle/fluid/layers/nn.py — fc :81, embedding :188, square_error_cost
:965, conv2d :1120, pool2d :1425, batch_norm :1478, layer_norm, reduces
:2055-2239, reshape), and fused_attention (no reference counterpart). Each
layer emits the same ops, attrs and names as the JAX package's."""

from __future__ import annotations

import math

import numpy as np

from ..framework.framework import Variable
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
    "dropout", "cos_sim", "transpose", "topk", "linear_chain_crf",
    "crf_decoding", "beam_search", "beam_search_decode", "warpctc",
    "ctc_greedy_decoder", "ctc_align", "edit_distance", "chunk_eval",
    "mul", "reverse", "split", "one_hot", "clip", "clip_by_norm", "expand",
    "squeeze", "unsqueeze", "gather", "scatter", "multiplex",
    "sigmoid_cross_entropy_with_logits", "smooth_l1", "log_loss",
    "label_smooth", "auc", "l1_norm", "l2_normalize",
    "autoincreased_step_counter",
    "precision_recall", "positive_negative_pair", "selective_fc",
    "lrn", "conv3d", "conv2d_transpose", "conv3d_transpose", "pool3d",
    "max_pool2d_with_index", "unpool", "spp", "roi_pool", "crop", "prelu",
    "conv_shift", "bilinear_interp", "maxout", "pad", "row_conv",
    "im2sequence", "nce", "hsigmoid", "sparse_moe",
]


def _simple(op_type, x, attrs=None, extra_inputs=None, out_dtype=None,
            name=None, outs=("Out",), in_slot="X"):
    helper = LayerHelper(op_type, name=name)
    inputs = {in_slot: [x]}
    if extra_inputs:
        inputs.update({k: v if isinstance(v, list) else [v]
                       for k, v in extra_inputs.items() if v is not None})
    outvars = [helper.create_tmp_variable(dtype=out_dtype or x.dtype)
               for _ in outs]
    helper.append_op(type=op_type, inputs=inputs,
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


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               seq_mask=False):
    """Padded-sequence logits are masked through their lengths (@SEQLEN);
    seq_mask=True also checks at build time that the logits are a
    sequence ([B, T, V])."""
    if seq_mask and (logits.shape is None or len(logits.shape) < 3):
        raise ValueError(
            "seq_mask=True but logits are not sequence-shaped [B,T,V]; "
            "feed the sequence through LoD data vars so lengths ride along")
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


def dropout(x, dropout_prob, is_test=False, seed=None, name=None):
    """Dropout in its downgrade-in-infer form (reference nn.py dropout; JAX
    layers/nn.py:451): training keeps each element with probability
    1 - dropout_prob, inference scales by it."""
    helper = LayerHelper("dropout", name=name)
    out = helper.create_tmp_variable(dtype=x.dtype)
    mask = helper.create_tmp_variable(dtype=x.dtype, stop_gradient=True)
    helper.append_op(type="dropout", inputs={"X": [x]},
                     outputs={"Out": [out], "Mask": [mask]},
                     attrs={"dropout_prob": dropout_prob, "is_test": is_test,
                            "seed": seed if seed is not None else 0})
    return out


def cos_sim(X, Y):
    """Row-wise cosine similarity [N, 1] (reference nn.py cos_sim; JAX
    layers/nn.py:664)."""
    helper = LayerHelper("cos_sim")
    out = helper.create_tmp_variable(dtype=X.dtype)
    xnorm = helper.create_tmp_variable(dtype=X.dtype, stop_gradient=True)
    ynorm = helper.create_tmp_variable(dtype=X.dtype, stop_gradient=True)
    helper.append_op(type="cos_sim", inputs={"X": [X], "Y": [Y]},
                     outputs={"Out": [out], "XNorm": [xnorm],
                              "YNorm": [ynorm]})
    return out


def transpose(x, perm, name=None):
    return _simple("transpose", x, attrs={"axis": list(perm)}, name=name)


def topk(input, k):
    helper = LayerHelper("top_k")
    values = helper.create_tmp_variable(dtype=input.dtype)
    indices = helper.create_tmp_variable(dtype="int64")
    helper.append_op(type="top_k", inputs={"X": [input]},
                     outputs={"Out": [values], "Indices": [indices]},
                     attrs={"k": k})
    return values, indices


# --- CRF (JAX nn.py:720-752) ---------------------------------------------------

def linear_chain_crf(input, label, param_attr=None):
    """The linear-chain CRF cost (reference nn.py:787): padded emissions
    [B, T, D], labels [B, T, 1] -> the negative log-likelihood [B, 1]; the
    transition parameter is [D+2, D] (start row, stop row, pairs)."""
    helper = LayerHelper("linear_chain_crf", param_attr=param_attr)
    size = input.shape[-1]
    transition = helper.create_parameter(
        attr=helper.param_attr, shape=[size + 2, size], dtype=input.dtype)
    log_likelihood = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="linear_chain_crf",
                     inputs={"Emission": [input], "Transition": [transition],
                             "Label": [label]},
                     outputs={"LogLikelihood": [log_likelihood]})
    return log_likelihood


def crf_decoding(input, param_attr, label=None):
    """Viterbi over the transition parameter `param_attr` names; with a
    label, a per-token correctness indicator."""
    helper = LayerHelper("crf_decoding", param_attr=param_attr)
    transition = helper.get_parameter(helper.param_attr.name)
    viterbi_path = helper.create_tmp_variable("int64")
    inputs = {"Emission": [input], "Transition": [transition]}
    if label is not None:
        inputs["Label"] = [label]
    helper.append_op(type="crf_decoding", inputs=inputs,
                     outputs={"ViterbiPath": [viterbi_path]})
    return viterbi_path


# --- beam search (JAX nn.py:754-792) ------------------------------------------

def beam_search(pre_ids, pre_scores, scores, beam_size, end_id, level=0):
    """One beam-search step over dense [B, K] lanes (reference nn.py:1903)
    -> (selected_ids, selected_scores, parent_idx), each [B, K]."""
    helper = LayerHelper("beam_search")
    selected_ids = helper.create_tmp_variable("int64")
    selected_scores = helper.create_tmp_variable(scores.dtype)
    parent_idx = helper.create_tmp_variable("int32")
    helper.append_op(type="beam_search",
                     inputs={"pre_ids": [pre_ids],
                             "pre_scores": [pre_scores], "scores": [scores]},
                     outputs={"selected_ids": [selected_ids],
                              "selected_scores": [selected_scores],
                              "parent_idx": [parent_idx]},
                     attrs={"beam_size": beam_size, "end_id": end_id,
                            "level": level})
    return selected_ids, selected_scores, parent_idx


def beam_search_decode(ids, parent_idx, scores=None, beam_size=None,
                       end_id=1):
    """The beam arrays backtracked into (sentence_ids [B, K, T],
    sentence_scores [B, K])."""
    helper = LayerHelper("beam_search_decode")
    sentence_ids = helper.create_tmp_variable("int64")
    sentence_scores = helper.create_tmp_variable("float32")
    inputs = {"Ids": [ids], "ParentIdx": [parent_idx]}
    if scores is not None:
        inputs["Scores"] = [scores]
    helper.append_op(type="beam_search_decode", inputs=inputs,
                     outputs={"SentenceIds": [sentence_ids],
                              "SentenceScores": [sentence_scores]},
                     attrs={"end_id": end_id})
    return sentence_ids, sentence_scores


# --- CTC and edit distance (JAX nn.py:795-852) ------------------------------------

def warpctc(input, label, blank=0, norm_by_times=False):
    """The CTC loss over padded LoD logits (reference nn.py:2696; the
    softmax taken inside) -> [num_sequences, 1]."""
    helper = LayerHelper("warpctc")
    loss = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="warpctc",
                     inputs={"Logits": [input], "Label": [label]},
                     outputs={"Loss": [loss]},
                     attrs={"blank": blank, "norm_by_times": norm_by_times})
    return loss


def ctc_greedy_decoder(input, blank, name=None):
    """Greedy CTC decode: each step's best class, then repeats merged and
    blanks dropped (reference nn.py:2616: top_k -> ctc_align)."""
    helper = LayerHelper("ctc_greedy_decoder")
    _, idx = topk(input, k=1)
    out = helper.create_tmp_variable(idx.dtype)
    helper.append_op(type="ctc_align", inputs={"Input": [idx]},
                     outputs={"Output": [out]},
                     attrs={"blank": blank, "merge_repeated": True})
    return out


def ctc_align(input, blank=0, merge_repeated=True):
    helper = LayerHelper("ctc_align")
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="ctc_align", inputs={"Input": [input]},
                     outputs={"Output": [out]},
                     attrs={"blank": blank, "merge_repeated": merge_repeated})
    return out


def edit_distance(input, label, normalized=True, ignored_tokens=None,
                  name=None):
    """Levenshtein distance per sequence pair (reference nn.py:2534) ->
    (distance [B, 1], sequence_num [1]); `ignored_tokens` are erased from
    both sides first."""
    helper = LayerHelper("edit_distance")
    if ignored_tokens:
        erased_input = helper.create_tmp_variable(input.dtype)
        erased_label = helper.create_tmp_variable(label.dtype)
        helper.append_op(type="sequence_erase", inputs={"X": [input]},
                         outputs={"Out": [erased_input]},
                         attrs={"tokens": list(ignored_tokens)})
        helper.append_op(type="sequence_erase", inputs={"X": [label]},
                         outputs={"Out": [erased_label]},
                         attrs={"tokens": list(ignored_tokens)})
        input, label = erased_input, erased_label
    out = helper.create_tmp_variable("float32")
    seq_num = helper.create_tmp_variable("int32")
    helper.append_op(type="edit_distance",
                     inputs={"Hyps": [input], "Refs": [label]},
                     outputs={"Out": [out], "SequenceNum": [seq_num]},
                     attrs={"normalized": normalized})
    return out, seq_num


def chunk_eval(input, label, chunk_scheme, num_chunk_types,
               excluded_chunk_types=None):
    """Chunking precision, recall and F1 (reference nn.py:1015) ->
    (precision, recall, f1, num_infer_chunks, num_label_chunks,
    num_correct_chunks)."""
    helper = LayerHelper("chunk_eval")
    outs = [helper.create_tmp_variable(d) for d in ("float32",) * 3
            + ("int32",) * 3]
    helper.append_op(
        type="chunk_eval",
        inputs={"Inference": [input], "Label": [label]},
        outputs=dict(zip(("Precision", "Recall", "F1-Score",
                          "NumInferChunks", "NumLabelChunks",
                          "NumCorrectChunks"), ([o] for o in outs))),
        attrs={"num_chunk_types": num_chunk_types,
               "chunk_scheme": chunk_scheme,
               "excluded_chunk_types": excluded_chunk_types or []})
    return tuple(outs)


# --- tensor and loss layers (JAX layers/nn.py:173-210, :439, :482-660,
# :698-715, :1074) ----------------------------------------------------------------

def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    """x @ y with each flattened to 2-D at its num_col_dims (nn.py:498)."""
    return _simple("mul", x, attrs={"x_num_col_dims": x_num_col_dims,
                                    "y_num_col_dims": y_num_col_dims},
                   extra_inputs={"Y": y}, name=name)


def reverse(x, axis, name=None):
    """x flipped along `axis` (an int or a list)."""
    axis = [axis] if isinstance(axis, int) else list(axis)
    return _simple("reverse", x, attrs={"axis": axis}, name=name)


def split(input, num_or_sections, dim=-1, name=None):
    """`num_or_sections` equal parts, or parts of those sizes, along dim."""
    helper = LayerHelper("split", name=name)
    dim = dim if dim >= 0 else dim + len(input.shape)
    if isinstance(num_or_sections, int):
        num, sections = num_or_sections, []
    else:
        num, sections = len(num_or_sections), list(num_or_sections)
    outs = [helper.create_tmp_variable(dtype=input.dtype) for _ in range(num)]
    helper.append_op(type="split", inputs={"X": [input]},
                     outputs={"Out": outs},
                     attrs={"axis": dim, "sections": sections,
                            "num": 0 if sections else num})
    return outs


def one_hot(input, depth):
    return _simple("one_hot", input, attrs={"depth": depth},
                   out_dtype="float32")


def clip(x, min, max, name=None):
    return _simple("clip", x, attrs={"min": float(min), "max": float(max)},
                   name=name)


def clip_by_norm(x, max_norm, name=None):
    return _simple("clip_by_norm", x, attrs={"max_norm": float(max_norm)},
                   name=name)


def expand(x, expand_times, name=None):
    return _simple("expand", x, attrs={"expand_times": list(expand_times)},
                   name=name)


def squeeze(input, axes, name=None):
    return _simple("squeeze", input, attrs={"axes": list(axes)}, name=name)


def unsqueeze(input, axes, name=None):
    return _simple("unsqueeze", input, attrs={"axes": list(axes)}, name=name)


def gather(input, index):
    return _simple("gather", input, extra_inputs={"Index": index})


def scatter(input, index, updates, name=None):
    return _simple("scatter", input,
                   extra_inputs={"Ids": index, "Updates": updates}, name=name)


def multiplex(inputs, index):
    helper = LayerHelper("multiplex")
    out = helper.create_tmp_variable(dtype=inputs[0].dtype)
    helper.append_op(type="multiplex", inputs={"X": inputs, "Ids": [index]},
                     outputs={"Out": [out]})
    return out


def sigmoid_cross_entropy_with_logits(x, label):
    return _simple("sigmoid_cross_entropy_with_logits", x,
                   extra_inputs={"Label": label})


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=None):
    helper = LayerHelper("smooth_l1_loss")
    diff = helper.create_tmp_variable(dtype=x.dtype)
    loss = helper.create_tmp_variable(dtype=x.dtype)
    inputs = {"X": [x], "Y": [y]}
    if inside_weight is not None:
        inputs["InsideWeight"] = [inside_weight]
    if outside_weight is not None:
        inputs["OutsideWeight"] = [outside_weight]
    helper.append_op(type="smooth_l1_loss", inputs=inputs,
                     outputs={"Diff": [diff], "Out": [loss]},
                     attrs={"sigma": sigma or 1.0})
    return loss


def log_loss(input, label, epsilon=1e-4, name=None):
    helper = LayerHelper("log_loss", name=name)
    loss = helper.create_tmp_variable(dtype=input.dtype)
    helper.append_op(type="log_loss",
                     inputs={"Predicted": [input], "Labels": [label]},
                     outputs={"Loss": [loss]}, attrs={"epsilon": epsilon})
    return loss


def label_smooth(label, prior_dist=None, epsilon=0.1, dtype="float32",
                 name=None):
    """(1 - epsilon) label + epsilon prior (uniform when prior_dist is
    None): the transformer's label smoothing over one_hot labels."""
    helper = LayerHelper("label_smooth", name=name)
    out = helper.create_tmp_variable(dtype)
    inputs = {"X": [label]}
    if prior_dist is not None:
        inputs["PriorDist"] = [prior_dist]
    helper.append_op(type="label_smooth", inputs=inputs,
                     outputs={"Out": [out]}, attrs={"epsilon": float(epsilon)})
    return out


def auc(input, label, curve="ROC", num_thresholds=200, topk=1):
    helper = LayerHelper("auc")
    auc_out = helper.create_tmp_variable(dtype="float32")
    helper.append_op(type="auc", inputs={"Out": [input], "Label": [label]},
                     outputs={"AUC": [auc_out]},
                     attrs={"curve": curve, "num_thresholds": num_thresholds})
    return auc_out


def l1_norm(x, name=None):
    """Sum of absolute values (reference l1_norm_op.cc)."""
    helper = LayerHelper("l1_norm")
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(type="l1_norm", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={})
    return out


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    helper = LayerHelper("l2_normalize", name=name)
    out = helper.create_tmp_variable(dtype=x.dtype)
    norm = helper.create_tmp_variable(dtype=x.dtype, stop_gradient=True)
    helper.append_op(type="norm", inputs={"X": [x]},
                     outputs={"Out": [out], "Norm": [norm]},
                     attrs={"axis": axis, "epsilon": epsilon})
    return out


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """The global step counter (reference nn.py:3291): persistable int64
    `@STEP_COUNTER@` [1], begin - 1 after the startup, advanced in place by
    an `increment` at index 0 of the global block, so the step's first op
    makes it begin, begin + step, ... The LR schedules read it."""
    helper = LayerHelper("global_step_counter")
    counter_name = counter_name or "@STEP_COUNTER@"
    gblock = helper.main_program.global_block()
    if gblock.has_var(counter_name):
        return gblock.var(counter_name)
    counter = gblock.create_var(name=counter_name, dtype="int64", shape=[1],
                                persistable=True)
    helper.set_variable_initializer(
        counter, ConstantInitializer(float(begin - 1)))
    gblock.prepend_op(type="increment", inputs={"X": [counter]},
                      outputs={"Out": [counter]}, attrs={"step": float(step)})
    counter.stop_gradient = True
    counter.desc.stop_gradient = True
    return counter


# --- vision, the extra layers, the eval layers (8c-2) ---------------------------

def nce(input, label, num_total_classes, sample_weight=None, param_attr=None,
        bias_attr=None, num_neg_samples=None):
    """Noise-contrastive estimation loss (reference nce_op.cc, nn.py:2806)."""
    helper = LayerHelper("nce", param_attr=param_attr, bias_attr=bias_attr)
    dim = input.shape[1]
    num_neg_samples = 10 if num_neg_samples is None else num_neg_samples
    w = helper.create_parameter(attr=helper.param_attr,
                                shape=[num_total_classes, dim],
                                dtype=input.dtype, is_bias=False)
    b = helper.create_parameter(attr=helper.bias_attr,
                                shape=[num_total_classes, 1],
                                dtype=input.dtype, is_bias=True)
    cost = helper.create_tmp_variable(dtype=input.dtype)
    sample_logits = helper.create_tmp_variable(dtype=input.dtype)
    sample_labels = helper.create_tmp_variable(dtype="int64")
    inputs = {"Input": [input], "Label": [label], "Weight": [w], "Bias": [b]}
    if sample_weight is not None:
        inputs["SampleWeight"] = [sample_weight]
    helper.append_op(type="nce", inputs=inputs,
                     outputs={"Cost": [cost], "SampleLogits": [sample_logits],
                              "SampleLabels": [sample_labels]},
                     attrs={"num_total_classes": num_total_classes,
                            "num_neg_samples": num_neg_samples})
    return cost


def conv3d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=None, param_attr=None, bias_attr=None, act=None, name=None):
    helper = LayerHelper("conv3d", param_attr=param_attr, bias_attr=bias_attr,
                         act=act, name=name)
    def _triple(v):
        return list(v) if isinstance(v, (list, tuple)) else [v] * 3
    dtype = input.dtype
    groups = groups or 1
    num_channels = input.shape[1]
    fs = _triple(filter_size)
    filter_shape = [num_filters, num_channels // groups] + fs
    fan_in = (num_channels // groups) * fs[0] * fs[1] * fs[2]
    w = helper.create_parameter(
        attr=helper.param_attr, shape=filter_shape, dtype=dtype,
        default_initializer=NormalInitializer(0.0, math.sqrt(2.0 / fan_in)))
    pre_bias = helper.create_tmp_variable(dtype)
    helper.append_op(type="conv3d",
                     inputs={"Input": [input], "Filter": [w]},
                     outputs={"Output": [pre_bias]},
                     attrs={"strides": _triple(stride),
                            "paddings": _triple(padding),
                            "dilations": _triple(dilation), "groups": groups})
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def conv2d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, param_attr=None,
                     bias_attr=None, use_cudnn=True, act=None, name=None):
    helper = LayerHelper("conv2d_transpose", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    num_channels = input.shape[1]
    padding_, stride_, dilation_ = _pair(padding), _pair(stride), _pair(dilation)
    if filter_size is None:
        assert output_size is not None
        output_size = _pair(output_size)
        h, w_ = input.shape[2], input.shape[3]
        filter_size = [
            (output_size[0] - (h - 1) * stride_[0] + 2 * padding_[0] - 1)
            // dilation_[0] + 1,
            (output_size[1] - (w_ - 1) * stride_[1] + 2 * padding_[1] - 1)
            // dilation_[1] + 1]
    else:
        filter_size = _pair(filter_size)
    filter_shape = [num_channels, num_filters] + filter_size
    w = helper.create_parameter(attr=helper.param_attr, shape=filter_shape,
                                dtype=dtype, is_bias=False)
    pre_bias = helper.create_tmp_variable(dtype)
    helper.append_op(type="conv2d_transpose",
                     inputs={"Input": [input], "Filter": [w]},
                     outputs={"Output": [pre_bias]},
                     attrs={"strides": stride_, "paddings": padding_,
                            "dilations": dilation_})
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def maxout(x, groups, name=None):
    helper = LayerHelper("maxout", name=name)
    out = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(type="maxout", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"groups": groups})
    return out


def lrn(input, n=5, k=1.0, alpha=1e-4, beta=0.75, name=None):
    helper = LayerHelper("lrn", name=name)
    out = helper.create_tmp_variable(dtype=input.dtype)
    mid = helper.create_tmp_variable(dtype=input.dtype, stop_gradient=True)
    helper.append_op(type="lrn", inputs={"X": [input]},
                     outputs={"Out": [out], "MidOut": [mid]},
                     attrs={"n": n, "k": k, "alpha": alpha, "beta": beta})
    return out


def pad(x, paddings, pad_value=0.0, name=None):
    return _simple("pad", x, attrs={"paddings": list(paddings),
                                    "pad_value": float(pad_value)}, name=name)


def row_conv(input, future_context_size, param_attr=None, act=None):
    helper = LayerHelper("row_conv", param_attr=param_attr, act=act)
    filter_shape = [future_context_size + 1, input.shape[-1]]
    w = helper.create_parameter(attr=helper.param_attr, shape=filter_shape,
                                dtype=input.dtype, is_bias=False)
    out = helper.create_tmp_variable(dtype=input.dtype)
    helper.append_op(type="row_conv",
                     inputs={"X": [input], "Filter": [w]},
                     outputs={"Out": [out]})
    return helper.append_activation(out)


def im2sequence(input, filter_size=1, stride=1, padding=0, name=None):
    helper = LayerHelper("im2sequence", name=name)
    out = helper.create_tmp_variable(dtype=input.dtype)
    helper.append_op(type="im2sequence", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"kernels": _pair(filter_size),
                            "strides": _pair(stride),
                            "paddings": _pair(padding) + _pair(padding)})
    return out


def precision_recall(indices, labels, class_number, weights=None,
                     states_info=None):
    """Multi-class precision/recall metrics op wrapper (reference
    precision_recall_op.h). Returns (batch_metrics [6], accum_metrics [6],
    accum_states_info [C,4])."""
    helper = LayerHelper("precision_recall")
    batch_metrics = helper.create_tmp_variable("float32")
    accum_metrics = helper.create_tmp_variable("float32")
    accum_states = helper.create_tmp_variable("float32")
    inputs = {"Indices": [indices], "Labels": [labels]}
    if weights is not None:
        inputs["Weights"] = [weights]
    if states_info is not None:
        inputs["StatesInfo"] = [states_info]
    helper.append_op(type="precision_recall", inputs=inputs,
                     outputs={"BatchMetrics": [batch_metrics],
                              "AccumMetrics": [accum_metrics],
                              "AccumStatesInfo": [accum_states]},
                     attrs={"class_number": class_number})
    return batch_metrics, accum_metrics, accum_states


def positive_negative_pair(score, label, query_id, weight=None, column=-1):
    """Ranking pair counts per query (reference positive_negative_pair_op.h).
    Returns (positive_pair, negative_pair, neutral_pair)."""
    helper = LayerHelper("positive_negative_pair")
    pos, neg, neu = (helper.create_tmp_variable("float32") for _ in range(3))
    inputs = {"Score": [score], "Label": [label], "QueryID": [query_id]}
    if weight is not None:
        inputs["Weight"] = [weight]
    helper.append_op(type="positive_negative_pair", inputs=inputs,
                     outputs={"PositivePair": [pos], "NegativePair": [neg],
                              "NeutralPair": [neu]},
                     attrs={"column": column})
    return pos, neg, neu


def pool3d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, ceil_mode=False, name=None):
    """NCDHW pooling (reference pool_op.cc pool3d)."""
    def _t(v):
        return list(v) if isinstance(v, (list, tuple)) else [v, v, v]
    helper = LayerHelper("pool3d")
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="pool3d", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"pooling_type": pool_type,
                            "ksize": _t(pool_size),
                            "strides": _t(pool_stride),
                            "paddings": _t(pool_padding),
                            "global_pooling": global_pooling,
                            "ceil_mode": ceil_mode})
    return out


def max_pool2d_with_index(input, pool_size, pool_stride=1, pool_padding=0):
    """Max pool returning (out, argmax-mask) (reference
    pool_with_index_op.cc)."""
    helper = LayerHelper("max_pool2d_with_index")
    out = helper.create_tmp_variable(input.dtype)
    mask = helper.create_tmp_variable("int32")
    helper.append_op(type="max_pool2d_with_index", inputs={"X": [input]},
                     outputs={"Out": [out], "Mask": [mask]},
                     attrs={"ksize": _pair(pool_size),
                            "strides": _pair(pool_stride),
                            "paddings": _pair(pool_padding)})
    return out, mask


def unpool(input, indices, unpooled_size):
    """Max unpooling from argmax indices (reference unpool_op.cc)."""
    helper = LayerHelper("unpool")
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="unpool",
                     inputs={"X": [input], "Indices": [indices]},
                     outputs={"Out": [out]},
                     attrs={"unpooled_size": list(unpooled_size)})
    return out


def spp(input, pyramid_height, pool_type="max"):
    """Spatial pyramid pooling (reference spp_op.cc)."""
    helper = LayerHelper("spp")
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="spp", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"pyramid_height": pyramid_height,
                            "pooling_type": pool_type})
    return out


def roi_pool(input, rois, pooled_height, pooled_width, spatial_scale=1.0,
             rois_batch_id=None):
    """ROI max pooling (reference roi_pool_op.cc)."""
    helper = LayerHelper("roi_pool")
    out = helper.create_tmp_variable(input.dtype)
    argmax = helper.create_tmp_variable("int32")
    inputs = {"X": [input], "ROIs": [rois]}
    if rois_batch_id is not None:
        inputs["RoiBatchId"] = [rois_batch_id]
    helper.append_op(type="roi_pool", inputs=inputs,
                     outputs={"Out": [out], "Argmax": [argmax]},
                     attrs={"pooled_height": pooled_height,
                            "pooled_width": pooled_width,
                            "spatial_scale": spatial_scale})
    return out


def crop(x, shape=None, offsets=None, name=None):
    """Crop x to shape at offsets (reference crop_op.cc); shape/offsets may
    be lists or Variables."""
    helper = LayerHelper("crop")
    out = helper.create_tmp_variable(x.dtype)
    inputs = {"X": [x]}
    attrs = {}
    if isinstance(shape, Variable):
        inputs["Y"] = [shape]
    else:
        attrs["shape"] = list(shape)
    if isinstance(offsets, Variable):
        inputs["Offsets"] = [offsets]
    elif offsets is not None:
        attrs["offsets"] = list(offsets)
    helper.append_op(type="crop", inputs=inputs, outputs={"Out": [out]},
                     attrs=attrs)
    return out


def prelu(x, mode="all", param_attr=None, name=None):
    """Parametric ReLU with learned alpha (reference prelu_op.cc)."""
    helper = LayerHelper("prelu", param_attr=param_attr)
    if mode == "all":
        alpha_shape = [1]
    elif mode == "channel":
        alpha_shape = [x.shape[1]]
    else:
        # element mode: one alpha per feature element, broadcast over the
        # batch dim (which is -1 for data vars and must not size a param)
        alpha_shape = [1] + list(x.shape[1:])
    alpha = helper.create_parameter(attr=helper.param_attr,
                                    shape=alpha_shape, dtype=x.dtype,
                                    default_initializer=ConstantInitializer(0.25))
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(type="prelu",
                     inputs={"X": [x], "Alpha": [alpha]},
                     outputs={"Out": [out]}, attrs={"mode": mode})
    return out


def conv3d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, param_attr=None,
                     bias_attr=None, act=None, name=None):
    """Transposed 3D convolution (reference conv_transpose_op.cc)."""
    def _t(v):
        return list(v) if isinstance(v, (list, tuple)) else [v, v, v]
    helper = LayerHelper("conv3d_transpose", param_attr=param_attr,
                         bias_attr=bias_attr, act=act)
    cin = input.shape[1]
    stride_, padding_, dilation_ = _t(stride), _t(padding), _t(dilation)
    if filter_size is None:
        assert output_size is not None, \
            "conv3d_transpose needs filter_size or output_size"
        output_size = _t(output_size)
        filter_size = [
            (output_size[i] - (input.shape[2 + i] - 1) * stride_[i]
             + 2 * padding_[i] - 1) // dilation_[i] + 1
            for i in range(3)]
    else:
        filter_size = _t(filter_size)
    f = helper.create_parameter(
        attr=helper.param_attr,
        shape=[cin, num_filters] + filter_size, dtype=input.dtype)
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="conv3d_transpose",
                     inputs={"Input": [input], "Filter": [f]},
                     outputs={"Output": [out]},
                     attrs={"strides": stride_, "paddings": padding_,
                            "dilations": dilation_})
    out = helper.append_bias_op(out, dim_start=1, dim_end=2)
    return helper.append_activation(out)


def conv_shift(x, y, name=None):
    """Circular convolution (reference conv_shift_op.cc)."""
    helper = LayerHelper("conv_shift")
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(type="conv_shift", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]}, attrs={})
    return out


def sparse_moe(x, num_experts, hidden_size, capacity_factor=1.25,
               param_attr=None, name=None):
    """Top-1 gated mixture-of-experts FFN over [N, D] tokens (GShard-style
    dispatch; see ops/nn_ops.py moe_ffn). Expert parallelism: split W1 and
    W2 (the 3-D parameters) on dim 0 over a mesh axis with
    parallel.shard_parameter(main, name, ("ep", None, None)), and each rank
    runs only its experts."""
    helper = LayerHelper("sparse_moe", param_attr=param_attr)
    d = x.shape[-1]
    # one ParamAttr instance per parameter: create_parameter binds the
    # attr's name, so sharing one attr across gate/W1/W2 would collide
    import copy as _copy

    def _attr(suffix):
        a = helper.param_attr
        a = _copy.deepcopy(a)
        if getattr(a, "name", None):
            a.name = f"{a.name}.{suffix}"
        return a

    gate_w = helper.create_parameter(attr=_attr("gate"),
                                     shape=[d, num_experts], dtype=x.dtype)
    w1 = helper.create_parameter(attr=_attr("w1"),
                                 shape=[num_experts, d, hidden_size],
                                 dtype=x.dtype)
    w2 = helper.create_parameter(attr=_attr("w2"),
                                 shape=[num_experts, hidden_size, d],
                                 dtype=x.dtype)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(type="moe_ffn",
                     inputs={"X": [x], "GateW": [gate_w],
                             "W1": [w1], "W2": [w2]},
                     outputs={"Out": [out]},
                     attrs={"capacity_factor": capacity_factor})
    return out


def hsigmoid(input, label, num_classes, param_attr=None, bias_attr=None,
             name=None):
    """Hierarchical sigmoid classification cost over a complete binary tree
    (reference gserver HierarchicalSigmoidLayer.cpp; fluid hsigmoid). Cost
    is -log P(label) under the tree factorization; O(log C) tree nodes per
    sample instead of a C-way softmax. Returns [B, 1]."""
    helper = LayerHelper("hierarchical_sigmoid", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    dim = input.shape[-1]
    w = helper.create_parameter(attr=helper.param_attr,
                                shape=[num_classes - 1, dim],
                                dtype=input.dtype)
    inputs = {"X": [input], "W": [w], "Label": [label]}
    if bias_attr is not False:
        b = helper.create_parameter(attr=helper.bias_attr,
                                    shape=[1, num_classes - 1],
                                    dtype=input.dtype, is_bias=True)
        inputs["Bias"] = [b]
    cost = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="hierarchical_sigmoid", inputs=inputs,
                     outputs={"Cost": [cost]},
                     attrs={"num_classes": int(num_classes)})
    return cost


def bilinear_interp(input, out_h, out_w, name=None):
    """Bilinear upsampling of NCHW feature maps (reference gserver
    BilinearInterpLayer.cpp; corners-aligned ratio (in-1)/(out-1))."""
    helper = LayerHelper("bilinear_interp", name=name)
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="bilinear_interp", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"out_h": int(out_h), "out_w": int(out_w)})
    return out


def selective_fc(input, select, size, act=None, param_attr=None,
                 bias_attr=None, name=None):
    """Fully-connected layer computing only selected output columns per
    sample (reference gserver SelectiveFullyConnectedLayer.cpp: with a
    selection the layer evaluates just those columns; here the full
    product is computed and masked — identical outputs, zeros at the
    unselected columns). `select` is a [B, size] 0/1 mask."""
    out = fc(input=input, size=size, act=act, param_attr=param_attr,
             bias_attr=bias_attr, name=name)
    helper = LayerHelper("selective_fc", name=name)
    masked = helper.create_tmp_variable(out.dtype)
    helper.append_op(type="elementwise_mul",
                     inputs={"X": [out], "Y": [select]},
                     outputs={"Out": [masked]}, attrs={"axis": -1})
    return masked
