"""IR-level shape/dtype inference pass (the `shapes` pass; the port's
counterpart of paddle_tpu/analysis/infer.py).

Strategy: clone the program (ProgramDesc JSON round-trip — cheap, and
keeps the user's desc untouched), then walk the root block re-deriving
every op's output shapes from the feed/parameter leaves. Four rule
sources, in precedence order per op type:

  CHECKERS            hand-written validating rules in this module: they
                      check input ranks/dtypes/broadcast compatibility
                      (which the build-time registry rules never do) and
                      may compute outputs themselves.
  registry rule       ops/registry.py's build-time infer_shape (via
                      registry.static_infer), re-run on the clone; an
                      exception here is itself a diagnostic. `<t>_grad`
                      ops use the generic grad mirror the same way.
  EVAL_SHAPE_OPS      long-tail ops whose lowering is run on tensors of
                      torch's `meta` device (shapes and dtypes, no data,
                      no FLOPs) — the lowering is the ground truth for ops
                      with no closed-form rule. Where the JAX package
                      traces the lowering with jax.eval_shape, the port
                      runs its own lowering on meta tensors; one that
                      needs a value on the host (`.item()`, a length read
                      on the host) fails there and its outputs come back
                      unknown.
  DYNAMIC_SHAPE_OPS   the explicit allowlist of ops whose output shapes
                      are genuinely value/LoD-dependent (control flow,
                      tensor arrays, beam search, save/load); their
                      outputs are marked unknown and downstream checks
                      go lenient.

An op none of these covers (the port registers a few sequence ops without
a build-time rule) has its outputs marked unknown, as a rule-less op of
the JAX package would.

Symbolic -1 batch dims flow through every rule: two dims are compatible
when equal or either is -1. Once an op errors, its outputs are marked
unknown so one planted defect doesn't cascade into a diagnostic per
downstream op. After the walk, any var whose re-derived shape disagrees
with the declared desc shape gets a `shape-drift` warning — the
signature of a desc edited behind the registry's back.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

from ..framework.desc import VarType

# --- coverage tables (the JAX package's, op for op) -------------------------

# Output shapes depend on runtime values / LoD structure / sub-block
# control flow: static inference is not attempted, outputs are unknown.
DYNAMIC_SHAPE_OPS = frozenset({
    "array_to_lod_tensor", "beam_search", "beam_search_decode",
    "conditional_block", "conditional_block_grad", "feed", "fetch",
    "is_empty", "load", "load_combine", "lod_array_length",
    "lod_rank_table", "lod_tensor_to_array", "max_sequence_len",
    "merge_lod_tensor", "print", "read_from_array",
    "reorder_lod_tensor_by_rank", "rnn", "save", "save_combine",
    "select_rows_by_cond", "sequence_concat", "sequence_erase",
    "sequence_reshape", "sequence_slice", "shrink_rnn_memory",
    "split_lod_tensor", "while", "while_grad", "write_to_array",
})

# No closed-form rule, but the lowering itself evaluates on meta tensors
# (_meta_eval_op).
EVAL_SHAPE_OPS = frozenset({
    "auc", "average_accumulates", "fused_adam", "fused_bn_act",
    "fused_chain", "fused_conv_bn_act", "fused_fc_act", "fused_momentum",
    "fused_sgd", "fused_sparse_adam", "fused_sparse_momentum",
    "fused_sparse_sgd", "hinge_loss", "huber_loss", "im2sequence",
    "log_loss", "margin_rank_loss", "mine_hard_examples", "multiplex",
    "rank_loss", "sequence_mask", "smooth_l1_loss",
    "squared_l2_distance", "target_assign",
})

# -1 → this probe value when the meta evaluation needs a concrete batch;
# output dims equal to it are mapped back to -1. Prime and
# larger than any static dim these programs use, so collisions with a
# real dim are implausible.
_PROBE_BATCH = 8191


# --- small shape algebra ---------------------------------------------------

def dim_ok(a: int, b: int) -> bool:
    return a == b or a == -1 or b == -1


def shapes_agree(x, y) -> bool:
    return len(x) == len(y) and all(dim_ok(a, b) for a, b in zip(x, y))


def _prod(dims) -> Optional[int]:
    """Product of dims, None when any is symbolic."""
    if any(d == -1 for d in dims):
        return None
    return math.prod(dims) if dims else 1


def _is_int(dtype: Optional[str]) -> bool:
    return bool(dtype) and ("int" in dtype or "bool" in dtype)


def _fmt(shape) -> str:
    return "[" + ", ".join(str(d) for d in shape) + "]"


# --- per-op checker context ------------------------------------------------

class OpCtx:
    """What a CHECKERS rule sees: slot-indexed input/output shapes read
    from the re-inference clone, emit helpers bound to this op's index,
    and set_out to publish re-derived output shapes."""

    def __init__(self, pctx, index, op, cblock, unknown):
        self._pctx = pctx
        self.index = index
        self.op = op
        self._cblock = cblock
        self._unknown = unknown
        self.errored = False
        self.outputs_set = False

    # -- reads --
    def _var(self, name):
        b = self._cblock
        while b is not None:
            if b.desc.has_var(name):
                return b.desc.var(name)
            b = b.parent_block
        return None

    def name(self, slot: str, idx: int = 0) -> Optional[str]:
        names = self.op.desc.inputs.get(slot, [])
        return names[idx] if idx < len(names) else None

    def shape(self, slot: str, idx: int = 0) -> Optional[Tuple[int, ...]]:
        n = self.name(slot, idx)
        if n is None or n in self._unknown:
            return None
        v = self._var(n)
        return tuple(v.shape) if v is not None and v.shape is not None \
            else None

    def dtype(self, slot: str, idx: int = 0) -> Optional[str]:
        n = self.name(slot, idx)
        v = self._var(n) if n else None
        return v.dtype if v is not None else None

    def var_type(self, slot: str, idx: int = 0) -> Optional[VarType]:
        n = self.name(slot, idx)
        v = self._var(n) if n else None
        return v.type if v is not None else None

    def n_inputs(self, slot: str) -> int:
        return len(self.op.desc.inputs.get(slot, ()))

    def attr(self, name, default=None):
        return self.op.attr(name, default)

    # -- writes --
    def set_out(self, slot: str, shape, dtype: Optional[str] = None,
                idx: int = 0):
        names = self.op.desc.outputs.get(slot, [])
        if idx >= len(names):
            return
        v = self._var(names[idx])
        if v is None:
            return
        v.shape = list(shape) if shape is not None else None
        if dtype is not None:
            v.dtype = dtype
        self.outputs_set = True

    # -- diagnostics --
    def error(self, code, msg, *, var=None, hint=None):
        self.errored = True
        self._pctx.emit("error", code, msg, op_index=self.index, var=var,
                        hint=hint)

    def warning(self, code, msg, *, var=None, hint=None):
        self._pctx.emit("warning", code, msg, op_index=self.index, var=var,
                        hint=hint)


# --- hand-written rules ----------------------------------------------------

def _no_int_float_mix(c: OpCtx, slots):
    """Arithmetic between an integer and a float operand is a class
    error in this IR (lowerings don't insert implicit casts); float-vs-
    float width mixes are fine — AMP legitimately mixes f32/bf16."""
    dts = [(s, c.dtype(s)) for s in slots if c.dtype(s)]
    ints = [s for s, d in dts if _is_int(d)]
    floats = [s for s, d in dts if not _is_int(d)]
    if ints and floats:
        c.error("dtype-mismatch",
                f"mixes integer input '{ints[0]}' "
                f"({c.dtype(ints[0])}) with float input '{floats[0]}' "
                f"({c.dtype(floats[0])})",
                var=c.name(ints[0]),
                hint="insert an explicit cast op; lowerings do not "
                     "implicitly promote int<->float")


def _chk_mul(c: OpCtx):
    x, y = c.shape("X"), c.shape("Y")
    if x is None or y is None:
        return
    xn = int(c.attr("x_num_col_dims", 1))
    yn = int(c.attr("y_num_col_dims", 1))
    if len(x) < xn + 1 or len(y) < yn + 1:
        c.error("rank-mismatch",
                f"X{_fmt(x)} / Y{_fmt(y)} too low-rank for "
                f"x_num_col_dims={xn}, y_num_col_dims={yn}",
                var=c.name("X"))
        return
    kx, ky = _prod(x[xn:]), _prod(y[:yn])
    if kx is not None and ky is not None and kx != ky:
        c.error("shape-mismatch",
                f"contraction dims disagree: X{_fmt(x)} flattens to "
                f"[*, {kx}] but Y{_fmt(y)} flattens to [{ky}, *]",
                var=c.name("X"),
                hint=f"X's trailing dims (from axis {xn}) must multiply "
                     f"out to Y's leading dims (through axis {yn})")
    _no_int_float_mix(c, ("X", "Y"))


def _chk_matmul(c: OpCtx):
    x, y = c.shape("X"), c.shape("Y")
    if x is None or y is None or len(x) < 2 or len(y) < 2:
        return
    kx = x[-2] if c.attr("transpose_X", False) else x[-1]
    ky = y[-1] if c.attr("transpose_Y", False) else y[-2]
    if not dim_ok(kx, ky):
        c.error("shape-mismatch",
                f"contraction dims disagree: X{_fmt(x)} x Y{_fmt(y)} "
                f"(transpose_X={bool(c.attr('transpose_X', False))}, "
                f"transpose_Y={bool(c.attr('transpose_Y', False))}) "
                f"contracts {kx} against {ky}", var=c.name("X"))
    _no_int_float_mix(c, ("X", "Y"))


def _chk_elementwise(c: OpCtx):
    x, y = c.shape("X"), c.shape("Y")
    if x is None or y is None:
        return
    axis = int(c.attr("axis", -1))
    if len(y) > len(x):
        c.error("broadcast-mismatch",
                f"Y{_fmt(y)} has higher rank than X{_fmt(x)} — Y "
                f"broadcasts into X, not the reverse", var=c.name("Y"))
        return
    off = len(x) - len(y) if axis == -1 else axis
    if off < 0 or off + len(y) > len(x):
        c.error("broadcast-mismatch",
                f"axis={axis} places Y{_fmt(y)} outside X{_fmt(x)}",
                var=c.name("Y"))
        return
    for j, yd in enumerate(y):
        xd = x[off + j]
        if yd != 1 and not dim_ok(xd, yd):
            c.error("broadcast-mismatch",
                    f"X{_fmt(x)} and Y{_fmt(y)} (axis={axis}) disagree "
                    f"at X dim {off + j}: {xd} vs {yd}", var=c.name("Y"),
                    hint="elementwise ops broadcast Y into X: each Y dim "
                         "must equal the aligned X dim or be 1")
            return
    _no_int_float_mix(c, ("X", "Y"))


def _conv_out(i, k, s, p, d):
    if i == -1:
        return -1
    ke = (k - 1) * d + 1
    return (i + 2 * p - ke) // s + 1


def _chk_conv2d(c: OpCtx):
    x, w = c.shape("Input"), c.shape("Filter")
    if x is None or w is None:
        return
    if len(x) != 4 or len(w) != 4:
        c.error("rank-mismatch",
                f"conv2d needs NCHW Input and OIHW Filter, got "
                f"Input{_fmt(x)} Filter{_fmt(w)}", var=c.name("Input"))
        return
    groups = int(c.attr("groups", 1) or 1)
    if x[1] != -1 and w[1] != -1 and w[1] * groups != x[1]:
        c.error("channel-mismatch",
                f"Input has {x[1]} channels but Filter{_fmt(w)} with "
                f"groups={groups} consumes {w[1] * groups}",
                var=c.name("Filter"))
        return
    strides = list(c.attr("strides", [1, 1]))
    paddings = list(c.attr("paddings", [0, 0]))
    dilations = list(c.attr("dilations", [1, 1]))
    for i, s, p, d, k in zip(x[2:], strides, paddings, dilations, w[2:]):
        o = _conv_out(i, k, s, p, d)
        if o != -1 and o < 1:
            c.error("conv-geometry",
                    f"spatial output collapses to {o}: input dim {i}, "
                    f"kernel {k}, stride {s}, padding {p}, dilation {d}",
                    var=c.name("Input"),
                    hint="pad the input or shrink the kernel/stride so "
                         "(i + 2p - ((k-1)d + 1)) // s + 1 >= 1")
            return


def _chk_pool2d(c: OpCtx):
    x = c.shape("X")
    if x is not None and len(x) != 4:
        c.error("rank-mismatch", f"pool2d needs NCHW input, got {_fmt(x)}",
                var=c.name("X"))


def _chk_batch_norm(c: OpCtx):
    x = c.shape("X")
    if x is None or len(x) < 2:
        return
    ch = x[-1] if c.attr("data_layout", "NCHW") == "NHWC" else x[1]
    for slot in ("Scale", "Bias", "Mean", "Variance"):
        s = c.shape(slot)
        if s is not None and ch != -1 and (len(s) != 1
                                           or not dim_ok(s[0], ch)):
            c.error("shape-mismatch",
                    f"{slot}{_fmt(s)} does not match X{_fmt(x)}'s "
                    f"channel dim {ch}", var=c.name(slot))
            return


def _chk_xent(c: OpCtx):
    logits = c.shape("Logits") or c.shape("X")
    lslot = "Logits" if c.shape("Logits") is not None else "X"
    label = c.shape("Label")
    if logits is None or label is None:
        return
    soft = bool(c.attr("soft_label", False))
    ldt = c.dtype("Label")
    if not soft and ldt and not _is_int(ldt):
        c.error("dtype-mismatch",
                f"hard-label cross entropy needs integer class ids, "
                f"Label is {ldt}", var=c.name("Label"),
                hint="feed int64 class indices, or set soft_label=True "
                     "for float distributions")
        return
    if len(label) != len(logits):
        c.error("rank-mismatch",
                f"Label{_fmt(label)} rank must match "
                f"{lslot}{_fmt(logits)}", var=c.name("Label"))
        return
    want_last = logits[-1] if soft else 1
    if not dim_ok(label[-1], want_last) or not all(
            dim_ok(a, b) for a, b in zip(label[:-1], logits[:-1])):
        c.error("shape-mismatch",
                f"Label{_fmt(label)} does not match {lslot}"
                f"{_fmt(logits)} (expected trailing dim {want_last})",
                var=c.name("Label"))


def _chk_lookup_table(c: OpCtx):
    ids, w = c.shape("Ids"), c.shape("W")
    dt = c.dtype("Ids")
    if dt and not _is_int(dt):
        c.error("dtype-mismatch", f"Ids must be integer, got {dt}",
                var=c.name("Ids"))
    if w is not None and len(w) != 2:
        c.error("rank-mismatch",
                f"embedding table W must be [rows, dim], got {_fmt(w)}",
                var=c.name("W"))
    del ids


def _chk_concat(c: OpCtx):
    shapes = [c.shape("X", i) for i in range(c.n_inputs("X"))]
    shapes = [s for s in shapes if s is not None]
    if len(shapes) < 2:
        return
    axis = int(c.attr("axis", 0))
    r = len(shapes[0])
    for s in shapes[1:]:
        if len(s) != r:
            c.error("rank-mismatch",
                    f"concat inputs mix ranks: {_fmt(shapes[0])} vs "
                    f"{_fmt(s)}", var=c.name("X"))
            return
        for d in range(r):
            if d != axis % r and not dim_ok(s[d], shapes[0][d]):
                c.error("shape-mismatch",
                        f"concat(axis={axis}) inputs disagree on dim "
                        f"{d}: {_fmt(shapes[0])} vs {_fmt(s)}",
                        var=c.name("X"))
                return


def _chk_reshape(c: OpCtx):
    x = c.shape("X")
    target = c.attr("shape")
    if x is None or not target:
        return
    target = list(target)
    if sum(1 for d in target if d == -1) > 1:
        c.error("shape-mismatch",
                f"reshape target {target} has more than one -1",
                var=c.name("X"))
        return
    # 0 copies the input dim (reference reshape semantics)
    resolved = [x[i] if d == 0 and i < len(x) else d
                for i, d in enumerate(target)]
    px, pt = _prod(x), _prod(resolved)
    if px is not None and pt is not None and px != pt:
        c.error("shape-mismatch",
                f"cannot reshape X{_fmt(x)} ({px} elements) to "
                f"{resolved} ({pt} elements)", var=c.name("X"))


def _chk_sum(c: OpCtx):
    shapes = [c.shape("X", i) for i in range(c.n_inputs("X"))]
    shapes = [s for s in shapes if s is not None]
    for s in shapes[1:]:
        if not shapes_agree(shapes[0], s):
            c.error("shape-mismatch",
                    f"sum inputs disagree: {_fmt(shapes[0])} vs "
                    f"{_fmt(s)}", var=c.name("X"))
            return


def _chk_optimizer(c: OpCtx):
    p, g = c.shape("Param"), c.shape("Grad")
    if c.var_type("Grad") == VarType.SELECTED_ROWS:
        return  # sparse rows: grad is [rows_touched, dim], checked at apply
    if p is not None and g is not None and not shapes_agree(p, g):
        c.error("optimizer-shape",
                f"Param{_fmt(p)} and Grad{_fmt(g)} disagree",
                var=c.name("Param"),
                hint="the param<->grad pairing is positional — a desc "
                     "edit between backward and the optimizer broke it")
        return
    for slot in ("Moment", "Moment1", "Moment2", "Velocity"):
        m = c.shape(slot)
        if p is not None and m is not None and not shapes_agree(p, m):
            c.error("optimizer-shape",
                    f"{slot}{_fmt(m)} does not match Param{_fmt(p)}",
                    var=c.name(slot))
            return


def _mirror(in_slot="X", out_slot="Out"):
    def chk(c: OpCtx):
        s = c.shape(in_slot)
        if s is not None:
            c.set_out(out_slot, s, c.dtype(in_slot))
    return chk


def _chk_squared_l2_norm(c: OpCtx):
    c.set_out("Out", [1], c.dtype("X"))


def _chk_shape_op(c: OpCtx):
    s = c.shape("Input") or c.shape("X")
    if s is not None:
        c.set_out("Out", [len(s)], "int32")


CHECKERS = {
    "mul": _chk_mul,
    "matmul": _chk_matmul,
    "elementwise_add": _chk_elementwise,
    "elementwise_sub": _chk_elementwise,
    "elementwise_mul": _chk_elementwise,
    "elementwise_div": _chk_elementwise,
    "elementwise_max": _chk_elementwise,
    "elementwise_min": _chk_elementwise,
    "elementwise_pow": _chk_elementwise,
    "conv2d": _chk_conv2d,
    "depthwise_conv2d": _chk_conv2d,
    "pool2d": _chk_pool2d,
    "batch_norm": _chk_batch_norm,
    "softmax_with_cross_entropy": _chk_xent,
    "cross_entropy": _chk_xent,
    "lookup_table": _chk_lookup_table,
    "concat": _chk_concat,
    "reshape": _chk_reshape,
    "sum": _chk_sum,
    "sgd": _chk_optimizer,
    "momentum": _chk_optimizer,
    "adam": _chk_optimizer,
    # no-registry-rule ops with a closed form
    "label_smooth": _mirror(),
    "sequence_softmax": _mirror(),
    "lod_reset": _mirror(),
    "row_conv": _mirror(),
    "squared_l2_norm": _chk_squared_l2_norm,
    "shape": _chk_shape_op,
}


def rule_kind(op_type: str) -> Optional[str]:
    """Which rule source covers `op_type`: 'checker' | 'dynamic' | 'eval'
    | 'registry' | 'grad' | None (outputs unknown)."""
    from ..ops import registry
    if op_type in CHECKERS:
        return "checker"
    if op_type in DYNAMIC_SHAPE_OPS:
        return "dynamic"
    if op_type in EVAL_SHAPE_OPS:
        return "eval"
    rule = registry.static_infer(op_type)
    if rule is registry.infer_grad_shapes:
        return "grad"
    if rule is not None:
        return "registry"
    return None


# --- meta-device fallback ----------------------------------------------------

def torch_dtype(name: Optional[str]):
    """The torch dtype of a desc dtype string, or None."""
    import torch
    dt = getattr(torch, str(name), None) if name else None
    return dt if isinstance(dt, torch.dtype) else None


def dtype_name(dt) -> str:
    """A torch dtype as the desc writes it ('float32', 'bfloat16', ...)."""
    return str(dt).replace("torch.", "")


class _MetaExecutor:
    """What a lowering may ask of ctx.executor on the meta device: the
    constants of static attrs (Executor.constant), without data."""

    def constant(self, values, dtype):
        import numpy as np
        import torch
        return torch.empty(np.shape(values), dtype=dtype, device="meta")


class _MetaCtx:
    """Lowering context stub for the meta evaluation: enough surface for
    data-path lowerings (the AMP policy, the quant mode, no sequence
    lengths, no mesh, no fold constants). Control-flow lowerings need
    run_block and are DYNAMIC_SHAPE_OPS instead; anything else missing
    raises and the op degrades to unknown outputs."""

    def __init__(self, program):
        import torch
        self.program = program
        self.executor = _MetaExecutor()
        self.device = torch.device("meta")
        self.amp_dtype = getattr(program, "_amp_dtype", None)
        self.amp_level = getattr(program, "_amp_level", "O1")
        self.quant_mode = getattr(program, "_quant_mode", None)
        self.mesh = None
        self.spmd = None
        self.folds = None
        self.capturing = False
        self.env: Dict = {}
        self.seq_overrides: Dict = {}

    def seq_len(self, name):
        return None

    def seq_len2(self, name):
        return None

    def set_seq_len(self, name, lengths):
        self.seq_overrides[name] = lengths

    def set_seq_len2(self, name, lengths):
        pass

    def host_sync(self, op_type):
        raise RuntimeError(f"{op_type} reads a value on the host")

    def generator(self, op):
        import torch
        return torch.Generator()


def _meta_eval_op(pctx, c: OpCtx, clone, cop, unknown) -> bool:
    """Run the op's lowering on meta tensors of its inputs' desc shapes and
    dtypes; write the output shapes into the clone desc. True when outputs
    were derived. A ValueError/TypeError with fully known inputs is a real
    shape error; any other failure (a host read, a stub limitation)
    degrades to unknown outputs."""
    import torch

    from ..ops import registry
    opdef = registry.try_get(cop.type)
    if opdef is None or opdef.lower is None:
        return False
    ins, known = {}, True
    for slot, names in cop.desc.inputs.items():
        vals = []
        for n in names:
            v = c._var(n)
            dt = torch_dtype(v.dtype) if v is not None else None
            if v is None or v.shape is None or n in unknown or dt is None:
                vals.append(None)
                known = False
                continue
            shape = tuple(_PROBE_BATCH if d == -1 else d for d in v.shape)
            vals.append(torch.empty(shape, dtype=dt, device="meta"))
        ins[slot] = vals
    if not known:
        return False
    mctx = _MetaCtx(clone)
    try:
        with registry.suppress_counters():
            out = opdef.lower(mctx, cop, ins)
    except (ValueError, TypeError) as e:
        c.error("infer-failed",
                f"lowering rejects the input shapes: {e}",
                var=(cop.desc.input_arg_names() or [None])[0])
        return False
    except Exception:  # noqa: BLE001 - stub-context limitation, not a bug
        return False
    for slot, vals in (out or {}).items():
        names = cop.desc.outputs.get(slot, [])
        for n, t in zip(names, vals):
            v = c._var(n)
            if v is None or not hasattr(t, "shape"):
                continue
            v.shape = [-1 if d == _PROBE_BATCH else int(d) for d in t.shape]
            if hasattr(t, "dtype"):
                v.dtype = dtype_name(t.dtype)
    return True


# --- the pass --------------------------------------------------------------

def _walk(pctx, clone, unknown: set):
    """Re-derive the clone's shapes op by op (the pass's body), emitting
    diagnostics into `pctx` and marking unknown outputs in `unknown`."""
    from ..ops import registry
    cblock = clone.global_block()
    for i, cop in enumerate(cblock.ops):
        t = cop.type
        opdef = registry.try_get(t)
        if opdef is None:
            pctx.emit("error", "unregistered-op",
                      f"op type '{t}' is not registered in "
                      f"ops/registry.py", op_index=i)
            unknown.update(cop.output_arg_names)
            continue
        kind = rule_kind(t)
        c = OpCtx(pctx, i, cop, cblock, unknown)
        if kind == "dynamic":
            unknown.update(cop.output_arg_names)
            continue
        inputs_unknown = any(n in unknown for n in cop.input_arg_names)
        if kind == "checker" and not inputs_unknown:
            CHECKERS[t](c)
        if c.errored:
            unknown.update(cop.output_arg_names)
            continue
        if not c.outputs_set:
            rule = registry.static_infer(t)
            if inputs_unknown:
                unknown.update(cop.output_arg_names)
            elif rule is not None:
                try:
                    rule(cop, cblock)
                except Exception as e:  # noqa: BLE001 - rule = validator
                    pctx.emit("error", "infer-failed",
                              f"shape inference rule for '{t}' raised: "
                              f"{e!r}", op_index=i)
                    unknown.update(cop.output_arg_names)
            elif kind == "eval":
                if not _meta_eval_op(pctx, c, clone, cop, unknown):
                    unknown.update(cop.output_arg_names)
            else:
                unknown.update(cop.output_arg_names)


def infer_block(program, feed_shapes=None):
    """A clone of `program` whose root block's var shapes are re-derived by
    the rules of this pass, with each feed of `feed_shapes` ({name: shape})
    declared at that shape first (so a concrete batch flows through every
    rule). The static memory walk (memory.program_peak_liveness) reads
    shapes from it; diagnostics are dropped."""
    from . import PassContext
    clone = program.clone()
    cblock = clone.global_block()
    for n, shape in (feed_shapes or {}).items():
        if cblock.desc.has_var(n):
            cblock.desc.var(n).shape = [int(d) for d in shape]
    _walk(PassContext(program, None, []), clone, set())
    return clone


def run(pctx):
    program = pctx.program
    clone = program.clone()
    cblock = clone.global_block()
    orig_block = pctx.block
    if len(cblock.ops) != len(orig_block.ops):
        pctx.emit("warning", "analyzer-internal",
                  "clone op count differs from source; skipping shapes")
        return
    declared = {n: (list(v.shape) if v.shape is not None else None)
                for n, v in orig_block.desc.vars.items()}
    unknown: set = set()
    _walk(pctx, clone, unknown)

    # declared-vs-rederived drift: a desc whose recorded shapes can't be
    # reproduced from its own leaves was edited behind the registry's
    # back (or deserialized from a corrupt JSON)
    for name, v in cblock.desc.vars.items():
        if name in unknown or v.shape is None:
            continue
        decl = declared.get(name)
        if decl is not None and not shapes_agree(decl, v.shape):
            pctx.emit("warning", "shape-drift",
                      f"declared shape {decl} disagrees with the shape "
                      f"re-derived from the program's own leaves "
                      f"{list(v.shape)}", var=name)
