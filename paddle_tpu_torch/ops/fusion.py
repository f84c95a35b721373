"""Fusion pass over the ProgramDesc: the conv -> batch_norm [-> act] and
batch_norm -> act windows (the port's counterpart of
paddle_tpu/ops/fusion.py, those two window kinds).

`plan()` pattern-matches contiguous conv2d -> batch_norm [-> activation]
and batch_norm -> activation windows in the global block
(`_match_conv_bn_act`, fusion.py:162). Each lowers as one unit at its
anchor (`execute_group`):

  * inference (is_test) conv windows whose conv output feeds nothing but
    the batch_norm (`_foldable`): BN folds into the conv filter and a
    channel bias, and the conv's own output is never materialized
    (`_fold_lower`, fusion.py:779);
  * training conv windows (`_conv_stats`, fusion.py:608): K4 computes the
    conv and its per-channel sums, K5 normalizes and activates; gated to
    training-mode bn, no AMP restore (O1 goes to the ladder), a kernel
    activation, and K1's gate;
  * otherwise the member ladder (fusion.py:516): the conv member runs
    through its lowering, then a training bn [+ act] on a bf16 activation
    runs K6 (`_bn_act`, fusion.py:565) when `bn_cuda.ineligible` passes,
    and the plain batch_norm (+ act) lowerings when it does not (counted
    by reason).

Running statistics stay outside the kernels, on the [C] vectors
(fusion.py:596-601, :684-689). Gradients stay consistent: the windows cover
forward ops only, whose grad ops re-run the unfused forward lowerings
(ops/registry.py) or are explicit (conv2d_grad). The fc_act, chain and
opt_bucket windows of the JAX pass wait for a later slice; their members
run one by one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from .. import quant
from . import bn_cuda, conv_cuda
from .common import mxu_cast
from .math_ops import ACTIVATIONS
from .nn_ops import _pair, conv2d_forward

CONV_OPS = frozenset({"conv2d"})

# activations that can close a window (the JAX package's ACT_OPS)
ACT_OPS = frozenset({
    "relu", "relu6", "leaky_relu", "sigmoid", "tanh", "elu", "swish",
    "brelu", "hard_sigmoid", "soft_relu",
})


@dataclass
class Group:
    """One matched window: ops[start:end] of the global block, executed as
    a unit at the anchor index (start); `conv` is None in a bn_act
    window."""
    start: int
    end: int                     # exclusive
    members: Tuple[Any, ...]     # Operators in block order
    conv: Any = None
    bn: Any = None
    act: Any = None
    fold: bool = False           # inference-mode BN fold into conv weights
    elide: Tuple[str, ...] = ()  # names the fold never materializes


def plan(program) -> Optional[Dict[int, Group]]:
    """anchor index -> Group for the program's global block, or None when
    nothing matches."""
    ops = program.global_block().ops
    groups: Dict[int, Group] = {}
    i, n = 0, len(ops)
    while i < n:
        g = _match_conv_bn_act(ops, i)
        if g is not None:
            groups[i] = g
            i = g.end
        else:
            i += 1
    return groups or None


def _first(names: List[str]) -> Optional[str]:
    return names[0] if names else None


def _match_conv_bn_act(ops, i) -> Optional[Group]:
    n = len(ops)
    conv = None
    j = i
    if ops[j].type in CONV_OPS:
        conv = ops[j]
        j += 1
        if j >= n or ops[j].type != "batch_norm":
            return None
    elif ops[j].type != "batch_norm":
        return None
    bn = ops[j]
    if conv is not None and \
            _first(bn.desc.input("X")) != _first(conv.desc.output("Output")):
        return None
    j += 1
    act = None
    if j < n and ops[j].type in ACT_OPS and \
            _first(ops[j].desc.input("X")) == _first(bn.desc.output("Y")):
        act = ops[j]
        j += 1
    if conv is None and act is None:
        return None   # a bare batch_norm is not a window
    members = tuple(m for m in (conv, bn, act) if m is not None)
    fold, elide = False, ()
    if conv is not None and bn.attr("is_test", False):
        out_name = _first(conv.desc.output("Output"))
        fold = _foldable(ops, conv, bn, out_name)
        if fold:
            elide = (out_name,)
    return Group(start=i, end=j, members=members, conv=conv, bn=bn, act=act,
                 fold=fold, elide=elide)


def _foldable(ops, conv, bn, out_name) -> bool:
    """The conv output can be elided iff bn is its only consumer, no later
    op rewrites the name, and it isn't persistable state."""
    if out_name is None:
        return False
    for o in ops:
        if o is bn or o is conv:
            continue
        if out_name in o.desc.input_arg_names():
            return False
        if out_name in o.desc.output_arg_names():
            return False
    block = getattr(conv, "block", None)
    if block is not None and block.desc.has_var(out_name) and \
            block.desc.var(out_name).persistable:
        return False
    return True


def execute_group(executor, ctx, group: Group, env, protected=()):
    """Lower one planned window at its anchor. `protected` (fetch names and
    persistable outputs) blocks the fold's elision: the plan is
    fetch-agnostic."""
    if group.fold and not (set(group.elide) & set(protected)):
        _fold_lower(ctx, group, env)
        return
    if group.conv is not None and _conv_stats(ctx, group, env):
        return
    if group.conv is not None:
        executor._exec_op(ctx, group.conv, env)
    x = env.get(_first(group.bn.desc.input("X")))
    reason = bn_cuda.ineligible(x, group.bn.attr("is_test", False),
                                _act_name(group))
    if reason is None:
        _bn_act(group, env)
        return
    bn_cuda.count_fallback("fused_bn_act", reason)
    executor._exec_op(ctx, group.bn, env)
    if group.act is not None:
        executor._exec_op(ctx, group.act, env)


def _act_name(g: Group):
    """The window's activation as the kernels name it: None, "relu", or
    the op type of one they do not implement."""
    return None if g.act is None else g.act.type


def _nhwc(t):
    """The [M, C] view of a logical NCHW activation; free when it lies in
    channels_last memory (the conv lowering's output format)."""
    c = t.shape[1]
    return t.contiguous(memory_format=torch.channels_last) \
        .permute(0, 2, 3, 1).reshape(-1, c)


def _nchw(t2, like):
    """[M, C] back to the logical NCHW shape of `like`, channels_last."""
    n, c, h, w = like.shape
    return t2.reshape(n, h, w, c).permute(0, 3, 1, 2)


def _write_bn(g: Group, env, y, yact, saved_mean, saved_var):
    """A training window's bn outputs, with the running statistics updated
    outside the kernels on the [C] vectors (fusion.py:596-601)."""
    bn = g.bn
    mean = env[_first(bn.desc.input("Mean"))]
    var = env[_first(bn.desc.input("Variance"))]
    momentum = bn.attr("momentum", 0.9)
    env[_first(bn.desc.output("Y"))] = y
    env[_first(bn.desc.output("MeanOut"))] = \
        mean * momentum + saved_mean * (1.0 - momentum)
    env[_first(bn.desc.output("VarianceOut"))] = \
        var * momentum + saved_var * (1.0 - momentum)
    env[_first(bn.desc.output("SavedMean"))] = saved_mean
    env[_first(bn.desc.output("SavedVariance"))] = saved_var
    if g.act is not None:
        env[_first(g.act.desc.output("Out"))] = yact


def _bn_vectors(bn, env):
    return (env[_first(bn.desc.input("Scale"))].float(),
            env[_first(bn.desc.input("Bias"))].float(),
            float(bn.attr("epsilon", 1e-5)))


def _bn_act(g: Group, env):
    """Training bn [+ act] as K6 over the [M, C] view of the activation:
    statistics, then normalize and activate (fusion.py `_bn_act_pallas`)."""
    x = env[_first(g.bn.desc.input("X"))]
    scale, bias, eps = _bn_vectors(g.bn, env)
    bn_cuda.count_hit("fused_bn_act")
    ybn2, yact2, saved_mean, saved_var = bn_cuda.bn_act(
        _nhwc(x), scale, bias, eps, _act_name(g))
    _write_bn(g, env, _nchw(ybn2, x),
              None if yact2 is None else _nchw(yact2, x),
              saved_mean, saved_var)


def _conv_stats(ctx, g: Group, env) -> bool:
    """Whole-window kernel path (fusion.py `_conv_stats_pallas`): K4 emits
    the conv output and its per-channel sum and sum of squares, K5
    normalizes (+ act) with the clamped one-pass variance — the window
    never re-reads the conv output to compute batch statistics. Returns
    False with no side effects when a gate fails; the member ladder then
    runs, and the conv member still reaches K1 through its lowering."""
    conv, bn = g.conv, g.bn
    if bn.attr("is_test", False) or _act_name(g) not in bn_cuda.ACTS:
        return False
    if getattr(ctx, "quant_mode", None):
        # O3: the ladder runs, so the conv member reaches its quantized
        # route (fusion.py:629)
        return False
    x = env.get(_first(conv.desc.input("Input")))
    w = env.get(_first(conv.desc.input("Filter")))
    if x is None or w is None:
        return False
    s, p, d = _conv_attrs(conv)
    (xc, wc), restore = mxu_cast(ctx, x, w)
    if restore is not None:
        return False
    x_nhwc = xc.contiguous(memory_format=torch.channels_last) \
        .permute(0, 2, 3, 1)
    if conv_cuda.ineligible(x_nhwc, wc, s, p, d,
                            conv.attr("groups", 1) or 1) is not None:
        return False
    conv_cuda.count_hit("fused_conv_bn_act")
    y, csum, csq = conv_cuda.conv2d_stats(x_nhwc, wc, s, p, d)
    m = y.shape[0] * y.shape[1] * y.shape[2]
    co = y.shape[3]
    env[_first(conv.desc.output("Output"))] = y.permute(0, 3, 1, 2)
    # one-pass variance, clamped like the unfused bf16 batch_norm
    saved_mean = csum / float(m)
    saved_var = torch.clamp(csq / float(m) - saved_mean * saved_mean,
                            min=0.0)
    scale, bias, eps = _bn_vectors(bn, env)
    bn_cuda.count_hit("fused_conv_bn_act")
    ybn2, yact2 = bn_cuda.bn_apply(y.reshape(-1, co), scale, bias,
                                   saved_mean, saved_var, eps, _act_name(g))
    yv = y.permute(0, 3, 1, 2)
    _write_bn(g, env, _nchw(ybn2, yv),
              None if yact2 is None else _nchw(yact2, yv),
              saved_mean, saved_var)
    return True


def _conv_attrs(conv):
    return (_pair(conv.attr("strides", [1, 1])),
            _pair(conv.attr("paddings", [0, 0])),
            _pair(conv.attr("dilations", [1, 1])))


def _fold_weights(g: Group, env):
    """(w * s, bias - mean * s) with s = scale * rsqrt(var + eps), the fold
    in f32, the filter rounded back to its own dtype (fusion.py:799-804)."""
    conv, bn = g.conv, g.bn
    w = env[_first(conv.desc.input("Filter"))]
    scale = env[_first(bn.desc.input("Scale"))].float()
    bias = env[_first(bn.desc.input("Bias"))].float()
    mean = env[_first(bn.desc.input("Mean"))].float()
    var = env[_first(bn.desc.input("Variance"))].float()
    s = scale * torch.rsqrt(var + bn.attr("epsilon", 1e-5))
    wf = (w.float() * s.reshape((-1,) + (1,) * (w.dim() - 1))).to(w.dtype)
    return wf, bias - mean * s


def fold_constants(ctx, groups, env) -> Dict[int, tuple]:
    """anchor -> (filter, channel bias, int8 filter or None) of every fold
    window, computed once from resident weights (the serving engine's
    PreparedProgram): what `_fold_lower` would compute per call. Under AMP
    O2/O3 the filter is stored already cast to bf16 (the conv lowering's
    mxu_cast then leaves it alone). Under O3 the int8 values and per-Co
    scales are those of the *folded* bf16 filter, as the reference's
    quantized conv computes them per call from the filter it is handed
    (quant.py:377-378). Its serving engine instead looks up the unfolded
    filter's values by name and so drops the batch-norm scale from every
    folded conv; the port does not copy that. The int8 filter is kept as an
    OIHW view of OHWI memory, the layout K11 reads, so no call copies it."""
    out = {}
    for anchor, g in (groups or {}).items():
        if not g.fold:
            continue
        wf, bf = _fold_weights(g, env)
        if getattr(ctx, "amp_level", "O1") in ("O2", "O3"):
            (wf,), _ = mxu_cast(ctx, wf)
        pre = None
        if getattr(ctx, "quant_mode", None):
            q, scale = quant.quantize_channelwise(wf, axis=0,
                                                  mode=ctx.quant_mode)
            pre = (q.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2),
                   scale)
        out[anchor] = (wf, bf, pre)
    return out


def _fold_lower(ctx, g: Group, env):
    """y = conv(x, w * s) + (bias - mean * s), s = scale * rsqrt(var + eps).

    As in the JAX package (fusion.py:799-816): the fold is computed in f32
    and rounded to the filter's dtype, and only then does the conv lowering
    cast it (bf16 under AMP); the channel bias is added in the conv output's
    dtype (bf16 under O2). A serving engine's constants (`fold_constants`)
    stand in for the fold when it has them. Under O3 the quantized route
    gets the folded filter's int8 values, never the unfolded filter's."""
    conv, bn, act = g.conv, g.bn, g.act
    folded = ctx.folds.get(g.start) if getattr(ctx, "folds", None) else None
    if folded is not None:
        wf, bf, pre = folded
    else:
        (wf, bf), pre = _fold_weights(g, env), None
    y = conv2d_forward(ctx, conv, env[_first(conv.desc.input("Input"))], wf,
                       pre)
    y = y + bf.to(y.dtype).reshape((1, -1) + (1,) * (y.dim() - 2))
    env[_first(bn.desc.output("Y"))] = y
    # is_test batch_norm passes the running statistics through
    for slot, src in (("MeanOut", "Mean"), ("VarianceOut", "Variance"),
                      ("SavedMean", "Mean"), ("SavedVariance", "Variance")):
        env[_first(bn.desc.output(slot))] = env[_first(bn.desc.input(src))]
    if act is not None:
        env[_first(act.desc.output("Out"))] = ACTIVATIONS[act.type](y, act)
