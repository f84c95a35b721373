"""Fast-path preflight advisors (the `preflight` pass; the port's
counterpart of paddle_tpu/analysis/preflight.py).

The runtime counts every missed fast path after the fact (the kernels'
fallback counters by reason, fusion's, overlap's,
sparse_densify_fallback_total). This pass answers the question those
counters can't: *before the first step*, which ops will miss, and what
one-line change fixes it. It dry-runs the port's own gates, never
parallel re-implementations:

  conv     — conv_cuda.ineligible (K1-K4's one gate) over meta NHWC/OIHW
             tensors built from the desc shapes (bf16 when the program is
             amp.decorate'd, since mxu_cast runs before the gate); when
             the first answer is "dtype" it asks again in bf16 so an AMP
             suggestion doesn't mask a channels problem behind it. The
             diagnostic keeps the JAX package's code,
             `pallas-conv-fallback`; the gate, and so the reasons, are
             Hopper's (channels in multiples of 8, no width budget).
  quant    — quant.ineligible_conv / ineligible_matmul on meta operands
             shaped by the lowerings' own helpers (conv2d_forward's NHWC
             permute, math_ops._flat2 and _matmul_operands, nn_ops._pair)
             from the quantizable ops' desc shapes, only when the program
             is decorated O3 (_quant_mode set).
  sharding — `_param_shardings` specs against the mesh axis sizes: every
             annotated dim divisible by the product of its axes, and no
             axis name the mesh lacks. These two are the only *errors*
             this pass emits, with the planner's below.
  plans    — fusion.plan / overlap.plan summaries, as advisory info.
  emb cache, planner — the hot-row cache's sizing and the planner's specs.

The JAX package's `layout` check (NHWC tag propagation over
ops/layout.py, `layout-barrier` infos) has no counterpart: the port has
no layout pass (its convs keep torch.channels_last memory,
ops/nn_ops.py), so nothing transposes back at an op boundary.

Missed fast paths are warnings (the program runs, slower); plan
summaries are info.
"""

from __future__ import annotations

_PROBE_BATCH = 8  # stand-in for symbolic -1 dims; gates never read it


def _conv_hint(reason, ci, co):
    return {
        "rank": "the conv kernels only tile 4-D NCHW convs",
        "groups": "grouped/depthwise convs take F.conv2d; use groups=1 "
                  "for the conv kernels",
        "dtype": "run the program under amp.decorate (bf16 operands) — "
                 "f32 convs never take the conv kernels",
        "channels": f"pad channels to a multiple of 8 (Ci={ci}, Co={co}): "
                    f"the kernels load 16 bytes of bf16 at a time, so e.g. "
                    f"Ci={-(-max(ci, 1) // 8) * 8} keeps the kernel "
                    f"eligible",
        "attrs": "use symmetric 2-element strides/paddings/dilations "
                 "(the [top, bottom, left, right] padding form is not "
                 "tiled)",
        "geometry": "output must stay >= 1x1 and padding < effective "
                    "kernel",
    }.get(reason, reason)


def _meta(shape, dtype):
    import torch
    return torch.empty(tuple(int(d) for d in shape), dtype=dtype,
                       device="meta")


def _check_pallas_convs(pctx):
    import torch

    from ..ops import conv_cuda

    amp = getattr(pctx.program, "_amp_dtype", None)
    block = pctx.block
    per_reason = {}  # reason -> detailed diagnostics emitted so far
    rollup = {}      # reason -> suppressed count
    for i, op in enumerate(pctx.ops):
        if op.type != "conv2d":
            continue
        xn = (op.desc.input("Input") or [None])[0]
        wn = (op.desc.input("Filter") or [None])[0]
        if not (xn and wn and block.desc.has_var(xn)
                and block.desc.has_var(wn)):
            continue
        xv, wv = block.desc.var(xn), block.desc.var(wn)
        if (xv.shape is None or wv.shape is None
                or len(xv.shape) != 4 or len(wv.shape) != 4):
            continue  # the shapes pass already diagnosed rank problems
        n, c, h, w = (_PROBE_BATCH if d == -1 else d for d in xv.shape)
        # mxu_cast has run by the time the gate sees the operands
        dt = torch.bfloat16 if amp is not None else torch.float32
        args = (list(op.attr("strides", [1, 1])),
                list(op.attr("paddings", [0, 0])),
                list(op.attr("dilations", [1, 1])),
                int(op.attr("groups", 1) or 1))
        reason = conv_cuda.ineligible(_meta((n, h, w, c), dt),
                                      _meta(wv.shape, dt), *args)
        if reason is None:
            continue
        ci, co = wv.shape[1], wv.shape[0]
        hint = _conv_hint(reason, ci, co)
        if reason == "dtype":
            # would bf16 alone fix it, or is a deeper miss hiding behind
            # the AMP suggestion?
            deeper = conv_cuda.ineligible(
                _meta((n, h, w, c), torch.bfloat16),
                _meta(wv.shape, torch.bfloat16), *args)
            if deeper is not None:
                reason = f"dtype, then {deeper}"
                hint = (f"{_conv_hint('dtype', ci, co)}; even then: "
                        f"{_conv_hint(deeper, ci, co)}")
        seen = per_reason.get(reason, 0)
        if seen >= 4:
            # a resnet emits one identical miss per conv — summarize the
            # tail so the first few carry the detail
            rollup[reason] = rollup.get(reason, 0) + 1
            continue
        per_reason[reason] = seen + 1
        pctx.emit(
            "warning", "pallas-conv-fallback",
            f"will take the F.conv2d fallback (reason: {reason}) instead "
            f"of the conv kernels K1-K4 — forward and both grad convs all "
            f"miss, since they share the gate",
            op_index=i, var=xn, hint=hint)
    for reason, n in sorted(rollup.items()):
        pctx.emit("warning", "pallas-conv-fallback",
                  f"{n} more conv2d op(s) fall back for the same reason "
                  f"({reason}) — details suppressed after the first "
                  f"{per_reason[reason]}")


def _quant_hint(reason, op_type, k):
    return {
        "disabled": "PADDLE_TPU_QUANT=0 is set — unset it (or =1) to "
                    "re-enable the quantized path",
        "mode": "this mode/op pair has no quantized kernel (the quant "
                "conv is int8-only); use PADDLE_TPU_QUANT_MODE=int8",
        "rank": "the quantized matmul tiles 2-D operands only",
        "dtype": "operands must reach the gate as bf16/f32 — integer or "
                 "f64 matmuls never quantize",
        "shape": f"contraction depth K={k} must be >= 32 and a multiple "
                 f"of 8 to amortize the scale sweeps of the int8 "
                 f"product; pad the feature dim",
        "kernel": "the quantized conv K11 keeps the reference kernel's "
                  "envelope (channels in multiples of 128, padded width "
                  "<= 2048) on top of K1's gate",
        "error_bound": "the trace-time error estimate exceeds "
                       "PADDLE_TPU_QUANT_TOL; raise the tolerance to "
                       "accept the quantization noise",
    }.get(reason, reason)


def _quant_gate(op, x, y, qmode):
    """The quant gate's answer for `op` on meta operands `x`, `y` (desc
    shapes), handed over as its lowering hands them: a conv's input as
    the NHWC view conv2d_forward takes (ops/nn_ops.py), mul's operands
    flattened by math_ops._flat2, matmul's through
    math_ops._matmul_operands."""
    from .. import quant
    from ..ops import math_ops, nn_ops

    if op.type in ("conv2d", "depthwise_conv2d"):
        if x.dim() == 4:
            x = x.permute(0, 2, 3, 1)
        return quant.ineligible_conv(
            x, y, nn_ops._pair(op.attr("strides", [1, 1])),
            nn_ops._pair(op.attr("paddings", [0, 0])),
            nn_ops._pair(op.attr("dilations", [1, 1])),
            op.attr("groups", 1) or 1, qmode)
    if op.type == "mul":
        x = math_ops._flat2(x, op.attr("x_num_col_dims", 1))
        y = math_ops._flat2(y, op.attr("y_num_col_dims", 1))
    else:
        x, y = math_ops._matmul_operands(op, x, y)
    return quant.ineligible_matmul(x, y, qmode)


def _check_quant(pctx):
    """Dry-run the port's own quant gates (_quant_gate) over every
    quantizable op's desc shapes, so an O3 program learns before its
    first step which ops will count a quant fallback and why. Only runs
    when the program is actually decorated O3 (program._quant_mode set):
    an O1/O2 program falling back everywhere is the configured behavior,
    not a diagnosis."""
    import torch

    from .. import quant

    qmode = getattr(pctx.program, "_quant_mode", None)
    if not qmode:
        return
    block = pctx.block
    slots = {"conv2d": ("Input", "Filter"),
             "depthwise_conv2d": ("Input", "Filter")}
    per_reason = {}
    rollup = {}
    for i, op in enumerate(pctx.ops):
        if op.type not in quant.QUANT_OPS:
            continue
        xslot, yslot = slots.get(op.type, ("X", "Y"))
        xn = (op.desc.input(xslot) or [None])[0]
        yn = (op.desc.input(yslot) or [None])[0]
        if not (xn and yn and block.desc.has_var(xn)
                and block.desc.has_var(yn)):
            continue
        xv, yv = block.desc.var(xn), block.desc.var(yn)
        if xv.shape is None or yv.shape is None:
            continue
        # mxu_cast runs before the gate: O3 operands arrive bf16
        x = _meta([_PROBE_BATCH if d == -1 else d for d in xv.shape],
                  torch.bfloat16)
        y = _meta(yv.shape, torch.bfloat16)
        try:
            reason = _quant_gate(op, x, y, qmode)
        except Exception:  # noqa: BLE001 - odd desc shapes: shapes pass
            continue       # already diagnosed those
        if reason is None:
            continue
        k = x.shape[-1] if op.type in ("mul", "matmul") else None
        seen = per_reason.get(reason, 0)
        if seen >= 4:
            rollup[reason] = rollup.get(reason, 0) + 1
            continue
        per_reason[reason] = seen + 1
        pctx.emit(
            "warning", "quant-fallback",
            f"{op.type} will keep the bf16 path under O3 (reason: "
            f"{reason}) and count a quant fallback",
            op_index=i, var=xn, hint=_quant_hint(reason, op.type, k))
    for reason, n in sorted(rollup.items()):
        pctx.emit("warning", "quant-fallback",
                  f"{n} more quantizable op(s) fall back for the same "
                  f"reason ({reason}) — details suppressed after the "
                  f"first {per_reason[reason]}")


def _axis_sizes(mesh) -> dict:
    """{axis: size} of a mesh: the port's Mesh.axis_sizes, or a mapping
    `shape` (a stand-in mesh)."""
    sizes = getattr(mesh, "axis_sizes", None)
    if sizes is not None:
        return dict(sizes)
    return dict(getattr(mesh, "shape", None) or {})


def _axis_factor(entry, axis_sizes):
    """(divisor, missing axis names) for one PartitionSpec entry."""
    if entry is None:
        return 1, []
    axes = entry if isinstance(entry, (tuple, list)) else (entry,)
    factor, missing = 1, []
    for a in axes:
        if a in axis_sizes:
            factor *= int(axis_sizes[a])
        else:
            missing.append(a)
    return factor, missing


def _check_shardings(pctx):
    specs = getattr(pctx.program, "_param_shardings", None) or {}
    if not specs:
        return
    mesh = getattr(pctx.program, "_mesh", None)
    if mesh is None:
        pctx.emit("warning", "sharding-no-mesh",
                  f"{len(specs)} parameter(s) carry sharding specs but "
                  f"the program has no mesh — the annotations are dead",
                  hint="tag the program with parallel.make_mesh before "
                       "sharding parameters")
        return
    axis_sizes = _axis_sizes(mesh)
    block = pctx.block
    for pname in sorted(specs):
        spec = specs[pname]
        v = block.desc.vars.get(pname)
        if v is None or v.shape is None:
            pctx.emit("error", "sharding-unknown-param",
                      f"sharding spec {spec} names '{pname}', which is "
                      f"not a var of the global block", var=pname)
            continue
        shape = list(v.shape)
        if len(spec) > len(shape):
            pctx.emit("error", "sharding-rank",
                      f"spec {spec} has {len(spec)} entries but "
                      f"'{pname}' is rank {len(shape)} ({shape})",
                      var=pname)
            continue
        for d, entry in enumerate(spec):
            factor, missing = _axis_factor(entry, axis_sizes)
            if missing:
                pctx.emit(
                    "error", "sharding-unknown-axis",
                    f"spec {spec} for '{pname}' names mesh axis "
                    f"'{missing[0]}' but the mesh only has "
                    f"{sorted(axis_sizes) or 'no axes'}", var=pname,
                    hint="an unknown axis is treated as replicated — "
                         "fix the axis name or rebuild the mesh with it")
                continue
            if factor > 1 and shape[d] != -1 and shape[d] % factor:
                pctx.emit(
                    "error", "sharding-indivisible",
                    f"'{pname}' dim {d} has size {shape[d]}, not "
                    f"divisible by the {factor}-way split of spec entry "
                    f"{entry!r}", var=pname,
                    hint=f"pad the dim to "
                         f"{-(-shape[d] // factor) * factor} or shard a "
                         f"different dim")


def _check_plans(pctx):
    from ..ops import fusion
    from ..parallel import overlap

    # the port's fusion has no kill switch: its windows always plan
    program = pctx.program
    groups = fusion.plan(program)
    if groups:
        kinds = {}
        for g in groups.values():
            kinds[g.kind] = kinds.get(g.kind, 0) + 1
        desc = ", ".join(f"{k} x{n}" for k, n in sorted(kinds.items()))
        pctx.emit("info", "fusion-plan",
                  f"{len(groups)} fused window(s): {desc}")

    mesh = getattr(program, "_mesh", None)
    if mesh is None or "dp" not in getattr(mesh, "axis_names", ()):
        return  # overlap only applies to dp-tagged programs
    plan = overlap.plan(program)
    if plan is None:
        pctx.emit("info", "overlap-plan",
                  "dp mesh but no overlap buckets (overlap disabled or "
                  "no dense replicated parameter gradients)")
    else:
        pctx.emit("info", "overlap-plan",
                  f"{len(plan.buckets)} eager all-reduce bucket(s) over "
                  f"{sum(len(b.grads) for b in plan.buckets)} gradient(s)")


def _check_emb_cache(pctx):
    """Hot-row cache sizing (tables larger than the card): the per-step
    touched-row bound for a cached table is the total id count its lookups
    can feed in one step (every id distinct in the worst case). When that
    bound exceeds cache_rows, steady-state steps evict rows they staged
    moments ago — and a run_steps window, whose whole-id union must be
    resident at once, can fail outright. Static shapes only; -1 dims probe
    as _PROBE_BATCH, so the bound scales with the real batch at runtime."""
    program = pctx.program
    from ..parallel import emb_cache as emb_cache_mod

    sized = {}  # table -> cache_rows (active cache wins over requests)
    cache = emb_cache_mod.active_cache(program)
    if cache is not None:
        for t in cache.tables().values():
            sized[t.name] = t.cache_rows
    for name, rows in emb_cache_mod.requested_rows(program).items():
        sized.setdefault(name, int(rows))
    if not sized:
        return

    block = pctx.block
    bound = {}     # table -> summed worst-case ids per step
    first_op = {}  # table -> op index of its first lookup
    for i, op in enumerate(pctx.ops):
        if op.type != "lookup_table":
            continue
        wname = (op.input("W") or [None])[0]
        ids = (op.input("Ids") or [None])[0]
        if wname not in sized or not ids or not block.has_var(ids):
            continue
        shape = tuple(block.var(ids).shape or ())
        n = 1
        for d in shape:
            n *= _PROBE_BATCH if int(d) == -1 else int(d)
        bound[wname] = bound.get(wname, 0) + n
        first_op.setdefault(wname, i)
    for wname, n in sorted(bound.items()):
        if n <= sized[wname]:
            continue
        pctx.emit(
            "warning", "emb-cache-thrash",
            f"cached table '{wname}' can touch up to {n} unique rows "
            f"per step (batch probed as {_PROBE_BATCH} for -1 dims) but "
            f"cache_rows={sized[wname]}: steady-state steps will evict "
            f"rows staged the same step, and a fused window's id union "
            f"may not fit the slab at all",
            op_index=first_op[wname], var=wname,
            hint="raise cache_rows (or the enable() budget) above the "
                 "per-step touched-row bound, or lower the batch size")


def _check_planner(pctx):
    """Planner-output diagnostics, on top of the per-spec checks in
    _check_shardings:

      * sharding-batch-indivisible — a feed's dim-0 batch does not
        divide by its data-axis split, so the ranks' rows cannot be equal;
      * sharding-overcommit — one tensor dim sharded by an axis product
        larger than the dim itself (shards would be empty/padded);
      * norm-sharded — a role the planner keeps replicated on purpose
        (norm scale/bias, layer bias) carries a spec anyway: legal, but
        almost always a hand-annotation mistake since the bytes saved
        are trivial and every use pays a gather.
    """
    program = pctx.program
    mesh = getattr(program, "_mesh", None)
    if mesh is None:
        return
    axis_sizes = _axis_sizes(mesh)
    block = pctx.block

    # feeds: explicit _feed_shardings dim-0 entries vs static batch dims
    for name, spec in sorted(
            (getattr(program, "_feed_shardings", None) or {}).items()):
        if not spec or not block.has_var(name):
            continue
        shape = tuple(block.var(name).shape or ())
        if not shape or int(shape[0]) == -1:
            continue  # symbolic batch: runtime-sized, nothing to check
        factor, _missing = _axis_factor(spec[0], axis_sizes)
        if factor > 1 and int(shape[0]) % factor:
            pctx.emit(
                "error", "sharding-batch-indivisible",
                f"feed '{name}' has batch dim {shape[0]}, not divisible "
                f"by the {factor}-way data split of spec entry "
                f"{spec[0]!r}", var=name,
                hint=f"feed a global batch that is a multiple of "
                     f"{factor}, or re-plan on a smaller data axis")

    specs = getattr(program, "_param_shardings", None) or {}
    if not specs:
        return

    # axis overcommit: one dim split by more ways than it has elements
    for pname in sorted(specs):
        v = block.desc.vars.get(pname)
        if v is None or v.shape is None:
            continue  # _check_shardings already errors unknown params
        shape = list(v.shape)
        for d, entry in enumerate(specs[pname]):
            if d >= len(shape):
                break
            factor, _missing = _axis_factor(entry, axis_sizes)
            if factor > 1 and 0 < int(shape[d]) < factor:
                pctx.emit(
                    "error", "sharding-overcommit",
                    f"'{pname}' dim {d} has size {shape[d]} but spec "
                    f"entry {entry!r} splits it {factor} ways — "
                    f"{factor - int(shape[d])} shard(s) would be empty",
                    var=pname,
                    hint="drop one axis from the entry or shard a "
                         "larger dim")

    # norm/bias roles carrying a spec: replicated-by-design params
    from ..parallel import planner as planner_mod
    try:
        roles = planner_mod.classify_params(program)
    except Exception:
        return
    for pname in sorted(specs):
        if roles.get(pname) not in ("norm", "bias"):
            continue
        if not any(e for e in specs[pname]):
            continue
        pctx.emit(
            "warning", "norm-sharded",
            f"'{pname}' is a {roles[pname]} parameter (planner keeps "
            f"these replicated) but carries spec {specs[pname]} — the "
            f"bytes saved are trivial and every use pays a gather",
            var=pname,
            hint="let planner.plan assign this spec, or drop the "
                 "hand annotation")


def run(pctx):
    _check_pallas_convs(pctx)
    _check_quant(pctx)
    _check_shardings(pctx)
    _check_plans(pctx)
    _check_emb_cache(pctx)
    _check_planner(pctx)
