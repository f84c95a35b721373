"""Fusion pass over the ProgramDesc (the port's counterpart of
paddle_tpu/ops/fusion.py): `plan()` pattern-matches contiguous windows of
the global block, in the reference's order (`_build`, fusion.py:143):

    runs of same-type sgd/momentum/adam updates sharing one LR (opt_bucket)
    conv2d -> batch_norm [-> activation] and batch_norm -> activation
    mul -> elementwise_add(1-D bias) [-> activation]            (fc_act)
    elementwise/activation runs, their _grad variants included  (chain)

and the executor lowers each as one unit at its anchor (`execute_group`).
Because a window is contiguous, running it at its anchor keeps the block's
op order.

  * opt_bucket (fusion.py:278, :404): the dense members split into
    sub-buckets by the dtypes of their per-param tensors (the grad aside:
    it is cast to its param's dtype per tensor), and each sub-bucket of
    two or more runs as one `fused_sgd`/`fused_momentum`/`fused_adam` op
    over lists of tensors (ops/optimizer_ops.py `*_list`: torch._foreach
    ops, no concat), bitwise the per-param updates. SelectedRows grads
    form `fused_sparse_<t>` buckets by param dtype (each member's sparse
    apply, in order) while the op has a sparse apply and the gate is on,
    and stay per-param otherwise; a param the program shards stays
    per-param. Each is counted by reason (COUNTERS.fallbacks).
  * fc_act and chain (fusion.py:220, :254) run as the reference's
    `_compose_lower` (:500) does: the members in order through the
    executor's own `_exec_op`, under one `win:` span, bitwise the unfused
    values. The reference's `fused_fc_act`/`fused_chain` ops only carry
    that composition; the port registers its `fused_fc_act` with the
    epilogue-fused bias/act GEMM, later speed work (ROADMAP).
  * conv -> bn [-> act]:
    - inference (is_test) conv windows whose conv output feeds nothing
      but the batch_norm (`_foldable`): BN folds into the conv filter and
      a channel bias, and the conv's own output is never materialized
      (`_fold_lower`, fusion.py:779);
    - training conv windows (`_conv_stats`, fusion.py:608): K4 computes
      the conv and its per-channel sums, K5 normalizes and activates;
      gated to training-mode bn, no AMP restore (O1 goes to the ladder), a
      kernel activation, K1's gate, and no quantization (under O3 the
      ladder runs, unless PADDLE_TPU_QUANT is off);
    - otherwise the member ladder (fusion.py:516): the conv member runs
      through its lowering, then a training bn [+ act] on a bf16
      activation runs K6 (`_bn_act`, fusion.py:565) when
      `bn_cuda.ineligible` passes, and the plain batch_norm (+ act)
      lowerings when it does not (counted by reason).

Running statistics stay outside the kernels, on the [C] vectors
(fusion.py:596-601, :684-689). Gradients stay consistent: the conv
windows cover forward ops only, whose grad ops are explicit
(batch_norm_grad reads the window's SavedMean/SavedVariance; conv2d_grad).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch

from .. import quant
from ..framework.desc import OpDesc
from . import bn_cuda, conv_cuda, optimizer_ops, quant_cuda, sparse_ops
from .common import CONV_FORMATS, SelectedRowsVal, mxu_cast
from .math_ops import ACTIVATIONS
from .nn_ops import _pair, conv2d_forward
from .registry import NO_GRAD, register
from .registry import get as registry_get

CONV_OPS = frozenset({"conv2d"})

# activations that can close a window (the JAX package's ACT_OPS)
ACT_OPS = frozenset({
    "relu", "relu6", "leaky_relu", "sigmoid", "tanh", "elu", "swish",
    "brelu", "hard_sigmoid", "soft_relu",
})

# chain members, matched by base type so their _grad variants ride along:
# the reference's layout-agnostic pass-through ops
# (paddle_tpu/ops/layout.py:43 AGNOSTIC_OPS) less the _grad names
CHAIN_OPS = frozenset({
    "relu", "relu6", "leaky_relu", "elu", "sigmoid", "tanh", "abs",
    "square", "sqrt", "exp", "log", "clip", "scale", "cast", "dropout",
    "pow", "softsign", "softplus", "round", "floor", "ceil",
    "hard_sigmoid", "brelu", "soft_relu", "swish",
    "sum", "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min",
})

OPTIMIZER_BUCKET_OPS = frozenset({"sgd", "momentum", "adam"})

# per-param input slots / shared input slots / per-param output slots
_OPT_SLOTS = {
    "sgd": (("Param", "Grad"), ("LearningRate",), ("ParamOut",)),
    "momentum": (("Param", "Grad", "Velocity"), ("LearningRate",),
                 ("ParamOut", "VelocityOut")),
    "adam": (("Param", "Grad", "Moment1", "Moment2"),
             ("LearningRate", "Beta1Pow", "Beta2Pow"),
             ("ParamOut", "Moment1Out", "Moment2Out")),
}


@dataclass
class Counters:
    """`fallbacks`: optimizer ops a bucket left per-param, by reason (the
    reference's fusion_fallback_total); `buckets`: fused optimizer ops
    run, by type."""
    fallbacks: Dict[str, int] = field(default_factory=dict)
    buckets: Dict[str, int] = field(default_factory=dict)

    def reset(self):
        self.fallbacks.clear()
        self.buckets.clear()


COUNTERS = Counters()


def _count(table, key):
    table[key] = table.get(key, 0) + 1


@dataclass
class Group:
    """One matched window: ops[start:end] of the global block, executed as
    a unit at the anchor index (start). `kind` is conv_bn_act, bn_act,
    fc_act, chain or opt_bucket; `conv` is None in a bn_act window."""
    kind: str
    start: int
    end: int                     # exclusive
    members: Tuple[Any, ...]     # Operators in block order
    conv: Any = None
    bn: Any = None
    act: Any = None
    fold: bool = False           # inference-mode BN fold into conv weights
    elide: Tuple[str, ...] = ()  # names the fold never materializes
    cache: Dict[Any, Any] = field(default_factory=dict)


def plan(program) -> Optional[Dict[int, Group]]:
    """anchor index -> Group for the program's global block, or None when
    nothing matches."""
    ops = program.global_block().ops
    groups: Dict[int, Group] = {}
    i, n = 0, len(ops)
    while i < n:
        g = (_match_opt_bucket(ops, i) or _match_conv_bn_act(ops, i)
             or _match_fc_act(ops, i) or _match_chain(ops, i))
        if g is not None:
            groups[i] = g
            i = g.end
        else:
            i += 1
    return groups or None


def span_name(g: Group) -> str:
    """The executor's profiler range for a window: "win:" and its member
    types, or for an optimizer bucket "win:<type>*<members>"."""
    if g.kind == "opt_bucket":
        return f"win:{g.members[0].type}*{len(g.members)}"
    return "win:" + "+".join(m.type for m in g.members)


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
    return Group(kind="conv_bn_act" if conv is not None else "bn_act",
                 start=i, end=j, members=members, conv=conv, bn=bn, act=act,
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


def _match_fc_act(ops, i) -> Optional[Group]:
    n = len(ops)
    if ops[i].type != "mul" or i + 1 >= n or \
            ops[i + 1].type != "elementwise_add":
        return None
    mul, add = ops[i], ops[i + 1]
    if _first(add.desc.input("X")) != _first(mul.desc.output("Out")):
        return None
    # channel-bias form only: a 1-D Y (plan-time shape from the block)
    yname = _first(add.desc.input("Y"))
    block = getattr(mul, "block", None)
    if yname is None or block is None or not block.desc.has_var(yname):
        return None
    yshape = block.desc.var(yname).shape
    if yshape is None or len(yshape) != 1:
        return None
    j = i + 2
    act = None
    if j < n and ops[j].type in ACT_OPS and \
            _first(ops[j].desc.input("X")) == _first(add.desc.output("Out")):
        act = ops[j]
        j += 1
    members = tuple(m for m in (mul, add, act) if m is not None)
    return Group(kind="fc_act", start=i, end=j, members=members)


def _chain_ok(op) -> bool:
    t = op.type
    base = t[: -len("_grad")] if t.endswith("_grad") else t
    return base in CHAIN_OPS


def _match_chain(ops, i) -> Optional[Group]:
    n = len(ops)
    j = i
    while j < n and _chain_ok(ops[j]):
        j += 1
    if j - i < 2:
        return None
    return Group(kind="chain", start=i, end=j, members=tuple(ops[i:j]))


def _opt_key(op):
    lr = tuple(op.desc.input("LearningRate"))
    if op.type == "sgd":
        return (lr,)
    if op.type == "momentum":
        return (lr, op.attr("mu"), bool(op.attr("use_nesterov", False)))
    return (lr, op.attr("beta1", 0.9), op.attr("beta2", 0.999),
            op.attr("epsilon", 1e-8), tuple(op.desc.input("Beta1Pow")),
            tuple(op.desc.input("Beta2Pow")))


def _match_opt_bucket(ops, i) -> Optional[Group]:
    t = ops[i].type
    if t not in OPTIMIZER_BUCKET_OPS:
        return None
    key0 = _opt_key(ops[i])
    n = len(ops)
    j = i + 1
    while j < n and ops[j].type == t and _opt_key(ops[j]) == key0:
        j += 1
    if j - i < 2:
        return None
    return Group(kind="opt_bucket", start=i, end=j, members=tuple(ops[i:j]))


# --- fused Operators -------------------------------------------------------------

def _synth_operator(block, desc, site):
    from ..framework.framework import Operator
    o = Operator.__new__(Operator)   # the view pattern of registry.forward_view
    o.block = block
    o.desc = desc
    o.creation_site = site
    return o


def _bucket_synth(group, members, t, prefix="fused_"):
    """The fused optimizer op over a same-dtype sub-bucket (fusion.py:327):
    per-param slots keep their names with one entry per member, the
    shared slots (LR, beta pows) one entry. prefix "fused_sparse_" builds
    the sparse-apply bucket, whose lowering runs each member's apply; the
    prefix is part of the cache key, since a member set can turn from
    sparse to dense when PADDLE_TPU_SPARSE_APPLY changes."""
    key = (prefix,) + tuple(id(m) for m in members)
    hit = group.cache.get(key)
    if hit is not None:
        return hit
    per_param, shared, outs = _OPT_SLOTS[t]
    inputs = {s: [_first(m.desc.input(s)) for m in members]
              for s in per_param}
    for s in shared:
        inputs[s] = list(members[0].desc.input(s))
    outputs = {s: [_first(m.desc.output(s)) for m in members] for s in outs}
    attrs = dict(members[0].desc.attrs)
    if prefix == "fused_sparse_":
        attrs["__sparse_members__"] = tuple(members)
    desc = OpDesc(type=prefix + t, inputs=inputs, outputs=outputs,
                  attrs=attrs)
    op = _synth_operator(getattr(members[0], "block", None), desc,
                         getattr(members[0], "creation_site", None))
    group.cache[key] = op
    return op


# --- execution -----------------------------------------------------------------

def execute_group(executor, ctx, group: Group, env, protected=()):
    """Lower one planned window at its anchor. `protected` (fetch names and
    persistable outputs) blocks the fold's elision: the plan is
    fetch-agnostic."""
    if group.kind == "opt_bucket":
        _execute_opt_bucket(executor, ctx, group, env)
        return
    if group.kind in ("fc_act", "chain"):
        # the reference's _compose_lower (fusion.py:500): the members in
        # order, bitwise the unfused values
        for m in group.members:
            executor._exec_op(ctx, m, env)
        return
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


def _execute_opt_bucket(executor, ctx, group: Group, env):
    """fusion.py:404: the dense members, sub-bucketed by the dtypes of
    their per-param tensors (the grad aside), run as one fused op per
    sub-bucket of two or more; the rest per-param. A SelectedRows grad
    never joins a dense bucket: with a sparse apply for the op and the gate
    on, its member joins a `fused_sparse_<t>` bucket by param dtype
    (counted `sparse_grad_handled`, or `sharded_table_sparse_path` for a
    row-sharded table), else it runs per-param (`sparse_grad_unsupported`),
    densified there."""
    t = group.members[0].type
    specs = getattr(ctx.program, "_param_shardings", None) or {}
    tables = getattr(ctx.program, "_sharded_tables", None) or {}
    dense, sparse = [], []
    for m in group.members:
        g = env.get(_first(m.desc.input("Grad")))
        pname = _first(m.desc.input("Param"))
        if isinstance(g, SelectedRowsVal):
            if sparse_ops.sparse_apply_enabled() \
                    and t in sparse_ops.SPARSE_APPLY_OPS:
                _count(COUNTERS.fallbacks, "sharded_table_sparse_path"
                       if pname in tables else "sparse_grad_handled")
                sparse.append(m)
            else:
                _count(COUNTERS.fallbacks, "sparse_grad_unsupported")
                executor._exec_op(ctx, m, env)
        elif pname in specs:
            # an explicitly sharded param stays per-param
            _count(COUNTERS.fallbacks, "sharded_param")
            executor._exec_op(ctx, m, env)
        else:
            dense.append(m)
    buckets: Dict[Tuple[str, ...], List[Any]] = {}
    for m in dense:
        sig = tuple(str(getattr(env.get(_first(m.desc.input(s))), "dtype",
                                None))
                    for s in _OPT_SLOTS[t][0] if s != "Grad")
        buckets.setdefault(sig, []).append(m)
    sbuckets: Dict[Tuple[str, ...], List[Any]] = {}
    for m in sparse:
        p = env.get(_first(m.desc.input("Param")))
        sbuckets.setdefault((str(getattr(p, "dtype", None)),), []).append(m)
    for prefix, table in (("fused_", buckets), ("fused_sparse_", sbuckets)):
        for sig in sorted(table):
            ms = table[sig]
            if len(ms) < 2:
                for m in ms:
                    executor._exec_op(ctx, m, env)
                continue
            _count(COUNTERS.buckets, prefix + t)
            executor._exec_op(ctx, _bucket_synth(group, ms, t, prefix), env)


def _params_grads(ins):
    """The params, and each grad cast to its param's dtype per tensor
    (optimizer_ops._param_grad per member)."""
    ps = list(ins["Param"])
    return ps, [g.to(p.dtype) for p, g in zip(ps, ins["Grad"])]


def _lower_fused_sgd(ctx, op_, ins):
    ps, gs = _params_grads(ins)
    return {"ParamOut": optimizer_ops.sgd_list(ps, gs,
                                               optimizer_ops._lr(ins))}


def _lower_fused_momentum(ctx, op_, ins):
    ps, gs = _params_grads(ins)
    po, vo = optimizer_ops.momentum_list(
        ps, gs, list(ins["Velocity"]), optimizer_ops._lr(ins),
        op_.attr("mu"), op_.attr("use_nesterov", False))
    return {"ParamOut": po, "VelocityOut": vo}


def _lower_fused_adam(ctx, op_, ins):
    ps, gs = _params_grads(ins)
    po, m1o, m2o = optimizer_ops.adam_list(
        ps, gs, list(ins["Moment1"]), list(ins["Moment2"]),
        optimizer_ops._lr(ins), op_.attr("beta1", 0.9),
        op_.attr("beta2", 0.999), op_.attr("epsilon", 1e-8),
        ins["Beta1Pow"][0].reshape(()), ins["Beta2Pow"][0].reshape(()))
    return {"ParamOut": po, "Moment1Out": m1o, "Moment2Out": m2o}


def _sparse_bucket_lower(ctx, op_, ins):
    """A fused sparse-apply bucket (fusion.py:897): each member's own
    lowering (the sparse apply, one table at a time: tables differ in
    height) on its entries of the bucket's slots, in member order, so the
    values are bitwise the per-param sparse path's."""
    members = op_.attr("__sparse_members__")
    per_param, shared, outs = _OPT_SLOTS[members[0].type]
    lower = registry_get(members[0].type).lower
    result = {s: [] for s in outs}
    for i, m in enumerate(members):
        mins = {s: [ins[s][i]] for s in per_param}
        mins.update({s: ins[s] for s in shared})
        out = lower(ctx, m, mins)
        for s in outs:
            result[s].append(out[s][0])
    return result


register("fused_sgd", lower=_lower_fused_sgd, grad=NO_GRAD)
register("fused_momentum", lower=_lower_fused_momentum, grad=NO_GRAD)
register("fused_adam", lower=_lower_fused_adam, grad=NO_GRAD)
for _t in OPTIMIZER_BUCKET_OPS:
    register("fused_sparse_" + _t, lower=_sparse_bucket_lower, grad=NO_GRAD)


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
    if getattr(ctx, "quant_mode", None) and quant.QUANT:
        # O3: the ladder runs, so the conv member reaches its quantized
        # route (fusion.py:629). With PADDLE_TPU_QUANT off nothing
        # quantizes, and the window runs as under O2, so that O3 is then
        # bitwise O2 (the reference turns its window off either way)
        return False
    x = env.get(_first(conv.desc.input("Input")))
    w = env.get(_first(conv.desc.input("Filter")))
    if x is None or w is None:
        return False
    s, p, d = _conv_attrs(conv)
    (xc, wc), restore = mxu_cast(ctx, x, w, formats=CONV_FORMATS)
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
    (quant.py:377-378), and only where `quant.ineligible_conv` admits the
    conv in the program's mode (probed at the smallest input the conv
    takes; the conv's own gate decides per call): under fp8 the fold keeps
    its bf16 filter, and the conv takes K1 with a ("conv2d", "mode")
    fallback, as in the reference. Its serving engine instead looks up the
    unfolded filter's values by name and so drops the batch-norm scale from
    every folded conv; the port does not copy that. The filter, bf16 and
    int8 alike, is kept as an OIHW view of OHWI memory, the layout K1 and
    K11 read, so no call copies it."""
    out = {}
    for anchor, g in (groups or {}).items():
        if not g.fold:
            continue
        wf, bf = _fold_weights(g, env)
        if getattr(ctx, "amp_level", "O1") in ("O2", "O3"):
            (wf,), _ = mxu_cast(ctx, wf, formats=CONV_FORMATS[1:])
        wf = wf.contiguous(memory_format=torch.channels_last)
        pre = None
        mode = getattr(ctx, "quant_mode", None)
        if mode and _fold_quantizes(g.conv, wf, mode):
            pre = quant_cuda.quantize_filter(wf)
        out[anchor] = (wf, bf, pre)
    return out


def _fold_quantizes(conv, wf, mode) -> bool:
    """Whether quant.ineligible_conv admits the conv with filter `wf` in
    `mode`, on a meta input of the smallest size the conv takes."""
    s, p, d = _conv_attrs(conv)
    co, ci, kh, kw = wf.shape
    x = torch.empty((1, (kh - 1) * d[0] + 1, (kw - 1) * d[1] + 1, ci),
                    dtype=wf.dtype, device="meta")
    return quant.ineligible_conv(x, wf, s, p, d, conv.attr("groups", 1) or 1,
                                 mode) is None


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
