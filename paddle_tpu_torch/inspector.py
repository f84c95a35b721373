"""Program inspector: tensor-stat probes on the card, NaN/Inf origin
attribution, the gradient-flow audit and the crash flight recorder (the
port's counterpart of paddle_tpu/inspector.py, with its names, fields,
health codes and crash-report format).

The reference framework's numeric-health story is all-or-nothing:
FLAGS_check_nan_inf scans every op output on the host after each kernel
(reference executor.cc:325-333 CheckTensorNANOrInf). This module keeps the
graphed step while still localizing *which op and which step* went
non-finite:

1. Probe pass — `instrument(program, ...)` clones the program and inserts
   `tensor_stats` ops after selected ops. Each probe reduces one tensor to
   an 8-float vector (min/max/mean/abs-mean/l2/nan-count/inf-count/size)
   inside the step: on the card the op is T1 (ops/stats_cuda.py, Triton),
   captured into the step's CUDA graph; the executor fetches the vectors
   beside the user's fetch list, so a probed step costs one read of the
   device, not an op-by-op fallback. Selection is by output name, op type,
   regex, explicit indices, `every=True`, or `auto=True` (role boundaries
   + loss/grad vars).

2. Origin attribution — `attribute_nonfinite(...)` replays a failing step
   against a scratch copy of the scope, eager (no replay captures a
   graph), bisecting over program position: each round probes one
   checkpoint op and halves the window, then a dense pass over the final
   window names the first offending op; one more run collects its inputs'
   stats. O(log n) replays, reported as a structured
   `errors.NonFiniteError` + `nonfinite_detections_total` counter.

3. Gradient-flow audit — `GradientAudit(program)` walks backward.py's
   grad-var mapping and probes every trainable parameter's final gradient;
   `report()` classifies each as zero / vanishing / exploding / nonfinite /
   ok (dynamics.classify_grad) and feeds the telemetry gauges `grad_l2` /
   `grad_abs_mean`. Given an instrumented program, the audit keeps its
   probes beside the gradient probes (the reference's audit starts from
   the uninstrumented parent), so one program carries both.

4. Flight recorder — `enable_flight_recorder(path)` (or the
   PADDLE_TPU_FLIGHT_RECORDER flag) keeps a bounded ring of recent step
   records and dumps a JSON crash report (steps, probe stats, telemetry
   events, flags/env, pprint_program text) on executor exception or fatal
   signal. `read_crash_report` / `format_crash_report` read it back. The
   report's `env` section holds the PADDLE_TPU_*, PADDLE_TRAINER*, TORCH_*
   and CUDA_* variables (the reference's JAX_* and XLA_* are this
   backend's TORCH_* and CUDA_*). Signal handlers are installed only from
   the main thread, and only when asked (`signals=True`, or the flag).

The executor's side (executor.py): the probe vectors ride the fetch list
and `record_probes` runs before the state is written back; check_nan_inf
is a per-op scan in eager runs and one finiteness flag computed inside the
graph in graphed runs; every raising run calls `notify_crash`.
"""

from __future__ import annotations

import collections
import json
import os
import re
import signal as signal_mod
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

import threading

import numpy as np
import torch

from . import flags, telemetry
from .errors import NonFiniteError
from .framework.desc import VarType
from .framework.framework import Program, grad_var_name
from .ops import registry, stats_cuda
from .ops.common import SelectedRowsVal

__all__ = [
    "STAT_FIELDS", "TensorStats", "ProbeSite", "Attribution", "GradientAudit",
    "instrument", "select_ops", "probe_compatible", "attribute_nonfinite",
    "enable_flight_recorder", "disable_flight_recorder", "flight_enabled",
    "dump_crash_report", "read_crash_report", "format_crash_report",
    "probe_report", "feed_signature",
]

STAT_FIELDS = ("min", "max", "mean", "abs_mean", "l2",
               "nan_count", "inf_count", "size")

_FLOAT_DTYPES = ("float16", "bfloat16", "float32", "float64")

# op types whose outputs are not plain tensors a stats reduction can consume:
# step scopes, rank tables, tensor arrays, or nothing at all (side-effect
# ops). tensor_stats itself is excluded so `every=True` never probes probes.
_NON_TENSOR_OUTPUT_OPS = frozenset({
    "feed", "fetch", "while", "while_grad", "conditional_block",
    "conditional_block_grad", "rnn", "write_to_array", "lod_rank_table",
    "lod_tensor_to_array", "save", "save_combine", "tensor_stats",
})


# ---------------------------------------------------------------------------
# The tensor_stats op
# ---------------------------------------------------------------------------

def _tensor_stats_infer(op, block):
    for name in op.desc.outputs.get("Out", []):
        if block.desc.has_var(name):
            v = block.desc.var(name)
            v.shape = [len(STAT_FIELDS)]
            v.dtype = "float32"


def _tensor_stats_lower(ctx, op_, ins):
    """[min, max, mean, abs_mean, l2, nan_count, inf_count, size] of X as a
    float32 vector. min/max/mean/l2 are computed over the *finite* elements
    (masked), so the summary stays informative even while NaNs are present;
    the counts carry the contamination. A 1-D [8] output stays below the
    executor's ndim>=2 SEQLEN-inheritance rule, so probing a sequence tensor
    never tags the stats vector as a sequence. On a CUDA tensor this is T1
    (ops/stats_cuda.py); an empty X is zeros, an integer X is cast to f32
    for it, and a float64 X takes the plain version (its masks must see the
    f64 values), counted as a `float64` fallback. On the CPU, the plain
    version."""
    k = len(STAT_FIELDS)
    x = ins["X"][0] if ins.get("X") else None
    if isinstance(x, SelectedRowsVal):
        x = x.to_dense()
    if x is None or x.numel() == 0:
        dev = x.device if x is not None else ctx.device
        return {"Out": [torch.zeros((k,), dtype=torch.float32, device=dev)]}
    if x.device.type == "cuda":
        if x.dtype == torch.float64:
            stats_cuda.count_fallback("float64")
            return {"Out": [stats_cuda.tensor_stats_reference(x)]}
        if not x.is_floating_point():
            x = x.float()
    return {"Out": [stats_cuda.tensor_stats(x)]}


if "tensor_stats" not in registry._REGISTRY:
    registry.register("tensor_stats", lower=_tensor_stats_lower,
                      infer_shape=_tensor_stats_infer, grad=registry.NO_GRAD,
                      non_diff_inputs=("X",))


class TensorStats:
    """Wrapper over one fetched stats vector."""

    __slots__ = ("vec",)

    def __init__(self, vec):
        self.vec = np.asarray(vec, np.float64).ravel()

    # the fields by their positions in STAT_FIELDS (a probed step reads
    # several of each of hundreds)
    min = property(lambda s: float(s.vec[0]))
    max = property(lambda s: float(s.vec[1]))
    mean = property(lambda s: float(s.vec[2]))
    abs_mean = property(lambda s: float(s.vec[3]))
    l2 = property(lambda s: float(s.vec[4]))
    nan_count = property(lambda s: float(s.vec[5]))
    inf_count = property(lambda s: float(s.vec[6]))
    size = property(lambda s: float(s.vec[7]))

    @property
    def nonfinite(self) -> bool:
        return (self.nan_count + self.inf_count) > 0

    def to_dict(self) -> Dict[str, float]:
        return {f: float(self.vec[i]) for i, f in enumerate(STAT_FIELDS)}

    def __repr__(self):
        return (f"TensorStats(min={self.min:.4g}, max={self.max:.4g}, "
                f"mean={self.mean:.4g}, l2={self.l2:.4g}, "
                f"nan={self.nan_count:.0f}, inf={self.inf_count:.0f}, "
                f"size={self.size:.0f})")


class ProbeSite:
    """One inserted probe: which op (pristine-program index) and which var it
    watches, and the stat var carrying its vector. kind: 'probe' (output
    probe), 'input' (attribution input probe), 'grad' (GradientAudit)."""

    __slots__ = ("op_index", "op_type", "var", "stat_var", "kind", "param")

    def __init__(self, op_index, op_type, var, stat_var, kind="probe",
                 param=None):
        self.op_index = op_index
        self.op_type = op_type
        self.var = var
        self.stat_var = stat_var
        self.kind = kind
        self.param = param

    def to_dict(self):
        return {"op_index": self.op_index, "op_type": self.op_type,
                "var": self.var, "kind": self.kind, "param": self.param}

    def __repr__(self):
        return (f"ProbeSite(op {self.op_index} '{self.op_type}' "
                f"-> '{self.var}', kind={self.kind})")


class _Plan:
    __slots__ = ("insert_at", "var", "site")

    def __init__(self, insert_at, var, site):
        self.insert_at = insert_at
        self.var = var
        self.site = site


# ---------------------------------------------------------------------------
# Probe pass
# ---------------------------------------------------------------------------

def probe_compatible(op_type: str) -> bool:
    """Type-level predicate: can tensor_stats consume this op's output?
    True when the op has a lowering and pure-tensor outputs."""
    if op_type in _NON_TENSOR_OUTPUT_OPS:
        return False
    opdef = registry.try_get(op_type)
    return opdef is not None and opdef.lower is not None


def _probeable_var(block, name: str) -> bool:
    if not name or not block.desc.has_var(name):
        return False
    v = block.desc.var(name)
    if v.type not in (VarType.LOD_TENSOR, VarType.SELECTED_ROWS):
        return False
    return (v.dtype or "float32") in _FLOAT_DTYPES


def _probe_target(block, op) -> Optional[str]:
    """First float-tensor output of `op`, or None when the op is not
    probe-able (structural op, int outputs, no declared tensor output)."""
    if not probe_compatible(op.type):
        return None
    for name in op.output_arg_names:
        if _probeable_var(block, name):
            return name
    return None


def _auto_indices(program: Program) -> List[int]:
    """`auto` selection: block boundaries (first/last op + the last op of
    each op_role segment: forward->backward->optimize transitions) plus the
    ops producing the loss (backward.py records program._loss_names) and
    every parameter gradient."""
    block = program.global_block()
    n = len(block.ops)
    if not n:
        return []
    sel = {0, n - 1}
    roles = [op.desc.attrs.get("op_role") for op in block.ops]
    for i in range(n - 1):
        if roles[i] != roles[i + 1]:
            sel.add(i)
    interesting = set(getattr(program, "_loss_names", ()))
    interesting.update(grad_var_name(p.name)
                       for p in block.all_parameters())
    for i, op in enumerate(block.ops):
        if interesting & set(op.output_arg_names):
            sel.add(i)
    return sorted(sel)


def select_ops(program: Program, *, names=None, types=None, regex=None,
               indices=None, auto: bool = False,
               every: bool = False) -> List[int]:
    """Root-block op indices matched by any of the selectors: output var
    `names`, op `types`, a `regex` over op type and output names, explicit
    `indices`, `auto` boundaries, or `every` op."""
    block = program.global_block()
    sel = set(int(i) for i in (indices or ()))
    name_set = set(names or ())
    type_set = set(types or ())
    pat = re.compile(regex) if regex else None
    for i, op in enumerate(block.ops):
        if op.type in type_set:
            sel.add(i)
        if name_set and name_set & set(op.output_arg_names):
            sel.add(i)
        if pat is not None and (pat.search(op.type) or
                                any(pat.search(n)
                                    for n in op.output_arg_names)):
            sel.add(i)
    if every:
        sel.update(range(len(block.ops)))
    if auto:
        sel.update(_auto_indices(program))
    return sorted(i for i in sel if 0 <= i < len(block.ops))


def _apply_plans(base: Program, plans: List[_Plan]) -> Program:
    """Clone `base` and insert one tensor_stats op per plan. Insertions run
    highest-position-first so earlier insert positions stay valid; sites keep
    their *pristine* op indices for attribution windows."""
    inst = base.clone()
    block = inst.global_block()
    for plan in sorted(plans, key=lambda p: p.insert_at, reverse=True):
        block.create_var(name=plan.site.stat_var,
                         shape=[len(STAT_FIELDS)], dtype="float32")
        block.insert_op(plan.insert_at, type="tensor_stats",
                        inputs={"X": [plan.var]},
                        outputs={"Out": [plan.site.stat_var]},
                        attrs={"op_role": "probe"})
    inst._probe_sites = sorted((p.site for p in plans),
                               key=lambda s: (s.op_index, s.kind, s.var))
    inst._probe_parent = base
    return inst


def instrument(program: Program, *, names=None, types=None, regex=None,
               indices=None, auto: bool = False,
               every: bool = False) -> Program:
    """Probe pass: return a clone of `program` with tensor_stats probes on
    the first float output of every selected op. The executor fetches the
    probe vectors with the user fetch list (one round-trip), records them on
    the program as `_last_probe_stats` (see probe_report), and raises a
    structured NonFiniteError — with bisection attribution — when any probe
    reports NaN/Inf."""
    base = getattr(program, "_probe_parent", None) or program
    selected = select_ops(base, names=names, types=types, regex=regex,
                          indices=indices, auto=auto, every=every)
    block = base.global_block()
    plans = []
    for i in selected:
        var = _probe_target(block, block.ops[i])
        if var is None:
            continue
        plans.append(_Plan(i + 1, var, ProbeSite(
            i, block.ops[i].type, var, f"{var}@STATS@{i}", kind="probe")))
    if not plans:
        raise ValueError(
            "no probe-compatible ops matched the selection (see "
            "inspector.probe_compatible)")
    return _apply_plans(base, plans)


def probe_report(program: Program) -> List[Dict[str, Any]]:
    """Last run's probe stats of an instrumented program, as dicts sorted by
    op position (empty before the first run)."""
    stats = getattr(program, "_last_probe_stats", None) or {}
    return [dict(site.to_dict(), stats=st.to_dict())
            for site, st in sorted(stats.items(),
                                   key=lambda it: it[0].op_index)]


def feed_signature(feed) -> Optional[Tuple]:
    """telemetry.signature_of over a user feed dict (tolerates LoDTensor and
    plain-list values)."""
    try:
        from .executor import LoDTensor
        vals = {}
        for k, v in (feed or {}).items():
            if isinstance(v, LoDTensor):
                v = v.array()
            vals[k] = v if isinstance(v, torch.Tensor) else np.asarray(v)
        return telemetry.signature_of(vals)
    except Exception:
        return None


# ---------------------------------------------------------------------------
# NaN/Inf origin attribution
# ---------------------------------------------------------------------------

class Attribution:
    """Result of a bisection replay: the first op whose output went
    non-finite, with its stats, its inputs' stats, and the replay cost."""

    def __init__(self, op_index, op_type, var, stats, input_stats, inputs,
                 outputs, creation_site, runs, feed_signature):
        self.op_index = op_index
        self.op_type = op_type
        self.var = var
        self.stats = stats
        self.input_stats = input_stats      # {input var: TensorStats}
        self.inputs = inputs
        self.outputs = outputs
        self.creation_site = creation_site
        self.runs = runs                    # replay executor runs used
        self.feed_signature = feed_signature
        self.seconds = None                 # wall seconds of the replays

    def summary(self) -> str:
        parts = [f"origin: op {self.op_index} '{self.op_type}' -> "
                 f"'{self.var}' ({self.stats.nan_count:.0f} NaN, "
                 f"{self.stats.inf_count:.0f} Inf) "
                 f"[{self.runs} replay run(s)]"]
        if self.creation_site:
            parts.append(f"built at {self.creation_site}")
        for n, st in self.input_stats.items():
            parts.append(f"input '{n}': {st!r}")
        return "; ".join(parts)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "op_index": self.op_index, "op_type": self.op_type,
            "var": self.var, "stats": self.stats.to_dict(),
            "input_stats": {n: st.to_dict()
                            for n, st in self.input_stats.items()},
            "inputs": list(self.inputs), "outputs": list(self.outputs),
            "creation_site": self.creation_site, "runs": self.runs,
            "feed_signature": ([list(s) for s in self.feed_signature]
                               if self.feed_signature else None),
        }

    def __repr__(self):
        return f"Attribution({self.summary()})"


def _copy_value(v, fallback):
    """A copy of one scope value for the attribution scratch scope, on its
    device: a replay's run writes the scratch scope's state back, never the
    caller's. The port donates no buffers, so the scope's value is always
    there; `fallback` (the step's new state, the reference's stand-in for a
    donated buffer) is taken only when a value cannot be copied."""
    from .executor import LoDTensor
    if v is None:
        return None
    if isinstance(v, LoDTensor):
        arr = v.array()
        arr = arr.clone() if isinstance(arr, torch.Tensor) else np.array(arr)
        return LoDTensor(arr, [list(l) for l in (v.lod or [])])
    if isinstance(v, torch.Tensor):
        return v.detach().clone()
    try:
        return np.array(v)
    except Exception:
        return fallback if fallback is not None else v


def _scratch_scope(scope, state):
    from .executor import Scope
    s = Scope()
    seen = set()
    sc = scope
    while sc is not None:
        for n, v in sc.vars.items():
            if n in seen or n == "__rng_counter__":
                continue
            seen.add(n)
            s.set_var(n, _copy_value(v, (state or {}).get(n)))
        sc = sc.parent
    return s


def attribute_nonfinite(exe, program: Program, feed, *, scope=None,
                        state=None, rng_counter=0, use_jit=None,
                        window: Optional[Tuple[int, int]] = None,
                        max_dense: int = 8,
                        max_runs: int = 40) -> Optional[Attribution]:
    """Name the first op whose output goes non-finite when `program` is
    re-run with `feed`. Each replay runs against a fresh scratch copy of
    `scope` (`state`, the step's new values, stands in only for a value
    that cannot be copied), with the same rng_counter so dropout masks
    etc. reproduce. Every replay is eager (`use_program_cache=False`; `use_jit`
    None reads as False): no round captures a graph.

    Bisection over program position: each round instruments ONE checkpoint
    op (midpoint of the window) and runs once; a finite checkpoint moves the
    window past it, a non-finite one pulls the window in. Once the window is
    <= max_dense candidate ops, one dense pass probes all of them, and a
    final run collects the offender's input stats. Cost: ceil(log2(n /
    max_dense)) + 2 replay runs — the acceptance bound is O(log n). Should
    the non-finite value *not* propagate to a probed checkpoint (masked
    downstream), a full dense fallback pass recovers correctness at the
    price of one more run.

    Returns None when attribution is inconclusive (nothing non-finite on
    replay — e.g. nondeterministic corruption — or no probe-able ops)."""
    if scope is None:
        from .executor import global_scope
        scope = global_scope()
    base = getattr(program, "_probe_parent", None)
    if base is None:
        base = None if getattr(program, "_probe_sites", None) else program
    if base is None:
        return None
    block = base.global_block()
    cands = [i for i in range(len(block.ops))
             if _probe_target(block, block.ops[i]) is not None]
    if window is not None:
        lo_op, hi_op = window
        in_window = [i for i in cands if lo_op <= i <= hi_op]
        cands = in_window or cands
    if not cands:
        return None

    t0 = time.perf_counter()
    runs = 0
    use_jit = False if use_jit is None else use_jit

    def probe_run(plans):
        nonlocal runs
        inst = _apply_plans(base, plans)
        inst._inspector_internal = True
        # a fresh copy each round: a replay of a training step writes its
        # (diverged) state back into its scope, and the next round must
        # start from the failed step's state again (the reference replays
        # every round on one scratch scope, so from its second round on a
        # training program's replays start from the diverged state and
        # name its first op)
        scratch = _scratch_scope(scope, state)
        scratch.set_var("__rng_counter__", int(rng_counter))
        vals = exe.run(inst, feed=dict(feed or {}),
                       fetch_list=[s.stat_var for s in inst._probe_sites],
                       scope=scratch, use_program_cache=False,
                       use_jit=use_jit)
        runs += 1
        return [(site, TensorStats(v))
                for site, v in zip(inst._probe_sites, vals)]

    def out_plan(i):
        var = _probe_target(block, block.ops[i])
        return _Plan(i + 1, var, ProbeSite(
            i, block.ops[i].type, var, f"{var}@STATS@{i}", kind="probe"))

    try:
        lo, hi = 0, len(cands) - 1
        while (hi - lo + 1) > max_dense and runs < max_runs:
            mid = (lo + hi) // 2
            res = probe_run([out_plan(cands[mid])])
            if any(st.nonfinite for _, st in res):
                hi = mid
            else:
                lo = mid + 1
        offender = offender_stats = None
        res = probe_run([out_plan(cands[j]) for j in range(lo, hi + 1)])
        for site, st in res:
            if st.nonfinite:
                offender, offender_stats = site, st
                break
        if offender is None and (lo > 0 or hi < len(cands) - 1) \
                and runs < max_runs:
            # the monotonic-propagation assumption failed: dense fallback
            res = probe_run([out_plan(j) for j in cands])
            for site, st in res:
                if st.nonfinite:
                    offender, offender_stats = site, st
                    break
        if offender is None:
            return None

        op = block.ops[offender.op_index]
        input_stats: Dict[str, TensorStats] = {}
        in_plans = [
            _Plan(offender.op_index, n, ProbeSite(
                offender.op_index, op.type, n,
                f"{n}@STATS@in{offender.op_index}", kind="input"))
            for n in dict.fromkeys(op.input_arg_names)
            if _probeable_var(block, n)]
        if in_plans and runs < max_runs:
            try:
                for site, st in probe_run(in_plans):
                    input_stats[site.var] = st
            except Exception:
                input_stats = {}
    except Exception:
        return None

    att = Attribution(
        op_index=offender.op_index, op_type=op.type, var=offender.var,
        stats=offender_stats, input_stats=input_stats,
        inputs=list(op.input_arg_names), outputs=list(op.output_arg_names),
        creation_site=getattr(op, "creation_site", None), runs=runs,
        feed_signature=feed_signature(feed))
    att.seconds = time.perf_counter() - t0
    return att


# ---------------------------------------------------------------------------
# Executor hooks (probe recording + NonFiniteError raising)
# ---------------------------------------------------------------------------

def record_probes(exe, program, scope, sites, stat_vals, *, feed, new_state,
                  rng_counter, prog_label):
    """Called by the executor after a probed run, before state writeback:
    stores stats on the program, feeds the gradient-audit gauges, and — when
    any output probe reports NaN/Inf — counts the detection, runs bisection
    attribution inside the window the probes already narrowed, and raises a
    structured NonFiniteError (so the diverged state is never committed)."""
    stats: Dict[ProbeSite, TensorStats] = {}
    for site, val in zip(sites, stat_vals):
        try:
            stats[site] = TensorStats(val)
        except Exception:
            continue
    program._last_probe_stats = stats
    audit = getattr(program, "_grad_audit", None)
    if audit is not None:
        audit._observe(stats, prog_label)
    try:
        # activation probes feed the observatory's `saturating` verdicts
        from . import dynamics as dynamics_mod
        dynamics_mod.observe_probes(prog_label, stats)
    except Exception:
        pass
    bad = sorted(((s, st) for s, st in stats.items()
                  if s.kind == "probe" and st.nonfinite),
                 key=lambda it: it[0].op_index)
    if not bad:
        return
    telemetry.counter(
        "nonfinite_detections_total",
        "NaN/Inf values caught by check_nan_inf or inspector probes",
        labels=("program", "source")).labels(
            program=prog_label, source="probe").inc()
    site, st = bad[0]
    # the probes already bracket the origin: start the bisection window at
    # the last finite probed op before the first bad one
    window_lo = 0
    for s2, st2 in stats.items():
        if s2.kind == "probe" and s2.op_index < site.op_index \
                and not st2.nonfinite:
            window_lo = max(window_lo, s2.op_index + 1)
    attribution = None
    if flags.get("nonfinite_attribution"):
        try:
            attribution = attribute_nonfinite(
                exe, program, feed, scope=scope, state=new_state,
                rng_counter=rng_counter, window=(window_lo, site.op_index))
        except Exception:
            attribution = None
    msg = (f"NaN/Inf detected by probe: op {site.op_index} "
           f"'{site.op_type}' output '{site.var}' has "
           f"{st.nan_count:.0f} NaN / {st.inf_count:.0f} Inf values")
    if attribution is not None:
        msg += "\n  " + attribution.summary()
    raise NonFiniteError(msg, var_name=site.var, op_type=site.op_type,
                         op_index=site.op_index, stats=st,
                         attribution=attribution,
                         feed_signature=feed_signature(feed))


# ---------------------------------------------------------------------------
# Gradient-flow audit
# ---------------------------------------------------------------------------

class GradientAudit:
    """Per-step gradient health for every trainable parameter.

    Walks the program for the last op writing each parameter's grad var
    (backward.py's grad_var_name mapping, after fan-in accumulation) and
    probes it; `self.program` is the instrumented clone to run instead of
    the original. A parameter with NO grad-producing op (detached from the
    loss) is reported as status 'zero' without needing a probe. Each run
    feeds telemetry: gauges grad_l2{program,param} / grad_abs_mean and
    counter grad_audit_flags_total{program,param,status} for every non-ok
    status. Non-finite gradients are *reported*, not raised — combine with
    instrument()/check_nan_inf when divergence should abort the step."""

    def __init__(self, program: Program, parameters=None,
                 vanishing_threshold: Optional[float] = None,
                 exploding_threshold: Optional[float] = None):
        # thresholds default from the dynamics constants table so the
        # audit and the observatory can never disagree on "vanishing"
        from . import dynamics as dynamics_mod
        if vanishing_threshold is None:
            vanishing_threshold = \
                dynamics_mod.THRESHOLDS["grad_vanishing_abs_mean"]
        if exploding_threshold is None:
            exploding_threshold = \
                dynamics_mod.THRESHOLDS["grad_exploding_max_abs"]
        base = getattr(program, "_probe_parent", None) or program
        kept = [s for s in (getattr(program, "_probe_sites", None) or ())
                if s.kind == "probe"]
        block = base.global_block()
        if parameters is None:
            params = [p.name for p in block.all_parameters()
                      if getattr(p, "trainable", True)]
        else:
            params = [p if isinstance(p, str) else p.name
                      for p in parameters]
        self.params = params
        self.vanishing_threshold = float(vanishing_threshold)
        self.exploding_threshold = float(exploding_threshold)
        self.missing: List[str] = []
        plans = []
        for pname in params:
            g = grad_var_name(pname)
            last = None
            for i, op in enumerate(block.ops):
                if g in op.output_arg_names:
                    last = i
            if last is None or not _probeable_var(block, g):
                self.missing.append(pname)
                continue
            plans.append(_Plan(last + 1, g, ProbeSite(
                last, block.ops[last].type, g, f"{g}@STATS@{last}",
                kind="grad", param=pname)))
        # an instrumented program's probes stay, before the gradient probes
        # at the same op; a probe of the very grad var gets its own name
        taken = {p.site.stat_var for p in plans}
        for s in kept:
            if s.stat_var in taken:
                s = ProbeSite(s.op_index, s.op_type, s.var,
                              f"{s.stat_var}@probe", kind="probe")
            plans.append(_Plan(s.op_index + 1, s.var, s))
        self.program = _apply_plans(base, plans) if plans else base.clone()
        self.program._grad_audit = self
        self._last: Dict[str, Dict[str, Any]] = {}
        self._series: Dict[Tuple[str, str], Tuple] = {}

    def classify(self, st: TensorStats) -> str:
        from . import dynamics as dynamics_mod
        return dynamics_mod.classify_grad(
            st.nonfinite, st.l2, st.abs_mean,
            max(abs(st.min), abs(st.max)),
            vanishing_threshold=self.vanishing_threshold,
            exploding_threshold=self.exploding_threshold)

    def _gauges(self, prog_label: str, param: str):
        """The grad_l2 and grad_abs_mean series of one parameter, resolved
        once (a probed step sets two a parameter)."""
        gen = telemetry.registry().generation()
        hit = self._series.get((prog_label, param))
        if hit is None or hit[0] != gen:
            hit = self._series[(prog_label, param)] = (gen, telemetry.gauge(
                "grad_l2", "per-parameter gradient L2 norm (GradientAudit)",
                labels=("program", "param")).labels(
                    program=prog_label, param=param), telemetry.gauge(
                "grad_abs_mean",
                "per-parameter gradient mean |g| (GradientAudit)",
                labels=("program", "param")).labels(
                    program=prog_label, param=param))
        return hit[1], hit[2]

    def _observe(self, stats: Dict[ProbeSite, TensorStats], prog_label: str):
        for site, st in stats.items():
            if site.kind != "grad" or site.param is None:
                continue
            status = self.classify(st)
            self._last[site.param] = dict(st.to_dict(), status=status,
                                          grad_var=site.var)
            l2, abs_mean = self._gauges(prog_label, site.param)
            l2.set(st.l2)
            abs_mean.set(st.abs_mean)
            if status != "ok":
                telemetry.counter(
                    "grad_audit_flags_total",
                    "gradient health flags (zero/vanishing/exploding/"
                    "nonfinite) per parameter",
                    labels=("program", "param", "status")).labels(
                        program=prog_label, param=site.param,
                        status=status).inc()

    def report(self) -> Dict[str, Dict[str, Any]]:
        out = {}
        for p in self.params:
            if p in self._last:
                out[p] = dict(self._last[p])
            elif p in self.missing:
                out[p] = {"status": "zero",
                          "reason": "no op writes this parameter's grad "
                                    "var (detached from the loss)"}
            else:
                out[p] = {"status": "unknown",
                          "reason": "audit program not run yet"}
        return out


# ---------------------------------------------------------------------------
# Flight recorder
# ---------------------------------------------------------------------------

class FlightRecorder:
    def __init__(self, capacity: int = 256, path: Optional[str] = None):
        self.capacity = capacity
        self.path = path
        self.enabled = False
        self.explicitly_disabled = False
        self.records: collections.deque = collections.deque(maxlen=capacity)
        self._signals_installed: List[Tuple[int, Any]] = []


_RECORDER = FlightRecorder()
_IN_CRASH = False


def enable_flight_recorder(path: Optional[str] = None, capacity: int = 256,
                           signals: bool = False) -> FlightRecorder:
    """Start recording step records into a bounded ring buffer; a JSON crash
    report lands at `path` on executor exception (and, with signals=True, on
    SIGTERM/SIGABRT — plus a non-fatal diagnostic dump on SIGUSR1). Also
    reachable without code changes via PADDLE_TPU_FLIGHT_RECORDER=<path>."""
    _RECORDER.capacity = int(capacity)
    _RECORDER.records = collections.deque(maxlen=_RECORDER.capacity)
    _RECORDER.path = path or _RECORDER.path or "paddle_tpu_crash.json"
    _RECORDER.enabled = True
    _RECORDER.explicitly_disabled = False
    if signals:
        _install_signal_handlers()
    return _RECORDER


def disable_flight_recorder():
    _RECORDER.enabled = False
    _RECORDER.explicitly_disabled = True
    _remove_signal_handlers()


def flight_enabled() -> bool:
    """Live check consulted by the executor each run; lazily honors the
    PADDLE_TPU_FLIGHT_RECORDER flag (so flags.set enables it at runtime)."""
    if not _RECORDER.enabled and not _RECORDER.explicitly_disabled:
        p = flags.get("flight_recorder")
        if p:
            enable_flight_recorder(p, signals=True)
    return _RECORDER.enabled


def record_step(program, prog_label: str, info: Dict[str, Any]):
    """Append one step record to the ring (executor hook)."""
    if not _RECORDER.enabled:
        return
    rec = {"ts": time.time(), "program": prog_label}
    rec.update(info)
    stats = getattr(program, "_last_probe_stats", None)
    if stats:
        rec["probes"] = len(stats)
        nonfinite = [dict(s.to_dict(), nan=st.nan_count, inf=st.inf_count)
                     for s, st in stats.items() if st.nonfinite]
        if nonfinite:
            rec["nonfinite_probes"] = nonfinite
    _RECORDER.records.append(rec)


def notify_crash(exe, program, exc) -> Optional[str]:
    """Executor crash hook: write the crash report (when the recorder is
    enabled) and return its path. EOFException is the reader drain-loop's
    normal end-of-pass signal, not a crash."""
    global _IN_CRASH
    if _IN_CRASH:
        return None
    if getattr(program, "_inspector_internal", False):
        return None
    try:
        from .layers.io import EOFException
        if isinstance(exc, EOFException):
            return None
    except Exception:
        pass
    try:
        # step-event record regardless of the flight recorder so
        # /healthz (obs_server) can report a last-error verdict even in
        # processes that never enabled crash dumps
        telemetry.log_event(
            "crash", error=f"{type(exc).__name__}: {exc}",
            program=telemetry.program_label(program))
    except Exception:
        pass
    if not flight_enabled():
        return None
    _IN_CRASH = True
    try:
        telemetry.counter(
            "inspector_crash_reports_total",
            "crash reports written by the flight recorder").inc()
        path = dump_crash_report(_RECORDER.path, error=exc, program=program,
                                 kind="exception")
        print(f"paddle_tpu_torch inspector: crash report written to {path} "
              f"(inspector.read_crash_report / format_crash_report)",
              file=sys.stderr)
        return path
    except Exception:
        return None
    finally:
        _IN_CRASH = False


def dump_crash_report(path: Optional[str] = None, *, error=None,
                      program=None, kind: str = "crash",
                      extra: Optional[Dict[str, Any]] = None) -> str:
    """Write the flight-recorder JSON crash report. Format (version 1, the
    reference's): {format, version, kind, ts, host, error{type,message,...},
    env (the PADDLE_TPU_*/PADDLE_TRAINER*/TORCH_*/CUDA_* vars), flags (full
    registry dump), steps (the ring), events (telemetry ring incl. retrace
    causes), metrics (local snapshot), program (pprint_program text),
    probe_stats, grad_audit, memory, dynamics, analysis}.
    `extra` merges caller sections into the report before it is written —
    the sentinel's hang reports add {threads, spans, hang} this way."""
    report: Dict[str, Any] = {
        "format": "paddle_tpu-crash-report", "version": 1, "kind": kind,
        "ts": time.time(),
        "host": int(os.environ.get("PADDLE_TRAINER_ID", "0") or 0),
        "error": None,
        "env": {k: v for k, v in sorted(os.environ.items())
                if k.startswith(("PADDLE_TPU_", "PADDLE_TRAINER", "TORCH_",
                                 "CUDA_"))},
        "flags": {n: v for n, (v, _h) in flags.dump().items()},
        "steps": list(_RECORDER.records),
        "events": telemetry.recent_events(200),
        "metrics": telemetry.snapshot(),
        "program": None, "probe_stats": None, "grad_audit": None,
        "memory": None, "dynamics": None,
    }
    try:
        from . import memory as memory_mod
        report["memory"] = memory_mod.crash_section()
    except Exception:
        pass
    try:
        # last training-dynamics snapshot: per-series verdicts + final
        # sample, so a crash report names the layer that died first
        from . import dynamics as dynamics_mod
        report["dynamics"] = dynamics_mod.crash_section()
    except Exception:
        pass
    if error is not None:
        if hasattr(error, "to_dict"):
            # structured errors (NonFiniteError, OOMError) serialize their
            # own forensic fields
            report["error"] = error.to_dict()
        else:
            report["error"] = {"type": type(error).__name__,
                               "message": str(error)}
    if program is not None:
        from . import debugger
        lines: List[str] = []
        try:
            debugger.pprint_program(program, print_fn=lines.append)
        except Exception:
            lines.append("<program dump failed>")
        report["program"] = "\n".join(lines)
        report["program_label"] = telemetry.program_label(program)
        stats = getattr(program, "_last_probe_stats", None)
        if stats:
            report["probe_stats"] = [
                dict(s.to_dict(), stats=st.to_dict())
                for s, st in sorted(stats.items(),
                                    key=lambda it: it[0].op_index)]
        audit = getattr(program, "_grad_audit", None)
        if audit is not None:
            report["grad_audit"] = audit.report()
        try:
            # static analyzer findings: when a trace/run crashed, the
            # verifier's view of the same program is often the fastest
            # pointer to the root cause (and it never executes anything)
            from .analysis import analyze_program
            areport = analyze_program(program)
            report["analysis"] = {
                "counts": areport.counts(),
                "diagnostics": [d.to_dict()
                                for d in areport.diagnostics[:50]],
            }
        except Exception:
            pass
    if extra:
        report.update(extra)
    path = path or _RECORDER.path or "paddle_tpu_crash.json"
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(report, f, indent=2, default=str)
    return path


def read_crash_report(path: str) -> Dict[str, Any]:
    with open(path) as f:
        report = json.load(f)
    if report.get("format") != "paddle_tpu-crash-report":
        raise ValueError(f"{path} is not a paddle_tpu crash report")
    return report


def _signal_handler(signum, frame):
    try:
        name = signal_mod.Signals(signum).name
    except ValueError:
        name = str(signum)
    try:
        dump_crash_report(kind=f"signal:{name}")
    except Exception:
        pass
    if signum == getattr(signal_mod, "SIGUSR1", None):
        return  # diagnostic dump only; keep running
    _remove_signal_handlers()
    signal_mod.signal(signum, signal_mod.SIG_DFL)
    os.kill(os.getpid(), signum)


def _install_signal_handlers():
    # only the main thread may set handlers; a worker thread that enables
    # the recorder gets the exception hook alone
    if _RECORDER._signals_installed or \
            threading.current_thread() is not threading.main_thread():
        return
    for signum in (signal_mod.SIGTERM, signal_mod.SIGABRT,
                   getattr(signal_mod, "SIGUSR1", None)):
        if signum is None:
            continue
        try:
            prev = signal_mod.signal(signum, _signal_handler)
        except (ValueError, OSError):
            continue  # not the main thread / unsupported platform
        _RECORDER._signals_installed.append((signum, prev))


def _remove_signal_handlers():
    for signum, prev in _RECORDER._signals_installed:
        try:
            signal_mod.signal(signum, prev)
        except (ValueError, OSError):
            pass
    _RECORDER._signals_installed = []


# ---------------------------------------------------------------------------
# Crash-report pretty printer
# ---------------------------------------------------------------------------

def _fmt_hbm(n) -> str:
    from . import memory as memory_mod
    return memory_mod._fmt_bytes(n)


def _fmt_stats_dict(d: Dict[str, Any]) -> str:
    try:
        return (f"min={d['min']:.4g} max={d['max']:.4g} "
                f"mean={d['mean']:.4g} l2={d['l2']:.4g} "
                f"nan={d['nan_count']:.0f} inf={d['inf_count']:.0f}")
    except Exception:
        return str(d)


def format_crash_report(report: Dict[str, Any], *,
                        show_program: bool = False) -> str:
    lines: List[str] = []
    ts = report.get("ts")
    when = (time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(ts))
            if ts else "?")
    lines.append(f"paddle_tpu crash report  kind={report.get('kind')}  "
                 f"host={report.get('host')}  {when}")
    if report.get("program_label"):
        lines.append(f"program: {report['program_label']}")
    err = report.get("error")
    if err:
        lines.append(f"error: {err.get('type')}: {err.get('message')}")
        if err.get("var_name"):
            lines.append(f"  variable: '{err['var_name']}'"
                         + (f" (dtype {err['dtype']})"
                            if err.get("dtype") else ""))
        attr = err.get("attribution")
        if attr:
            lines.append(
                f"  origin: op {attr.get('op_index')} "
                f"'{attr.get('op_type')}' -> '{attr.get('var')}' "
                f"[{attr.get('runs')} replay run(s)]"
                + (f", built at {attr['creation_site']}"
                   if attr.get("creation_site") else ""))
            for n, st in (attr.get("input_stats") or {}).items():
                lines.append(f"    input '{n}': {_fmt_stats_dict(st)}")
        if err.get("breakdown"):
            lines.append("  memory breakdown: " + ", ".join(
                f"{k}={_fmt_hbm(v)}"
                for k, v in sorted(err["breakdown"].items())))
        for b in (err.get("top_buffers") or [])[:5]:
            nm = f" '{b['name']}'" if b.get("name") else ""
            lines.append(f"  live buffer{nm}: {_fmt_hbm(b.get('nbytes'))} "
                         f"{b.get('dtype')}{b.get('shape')}")
    hang = report.get("hang") or {}
    if hang:
        lines.append(
            f"hang: program={hang.get('program')} "
            f"budget={hang.get('budget_s', 0.0):.3g}s "
            f"waited={hang.get('waited_s', 0.0):.3g}s "
            f"thread={hang.get('thread')}")
    threads = report.get("threads") or []
    if threads:
        stalled = sum(1 for t in threads if t.get("stalled"))
        lines.append(f"threads: {len(threads)} captured"
                     + (f", {stalled} stalled" if stalled else ""))
        for t in threads:
            mark = "  ** STALLED **" if t.get("stalled") else ""
            lines.append(f"  thread '{t.get('name')}' "
                         f"ident={t.get('ident')}"
                         f"{' daemon' if t.get('daemon') else ''}{mark}")
            # stacks are multi-line strings from traceback.format_stack
            tail = t.get("stack") or []
            for frame in (tail if t.get("stalled") else tail[-2:]):
                for ln in frame.splitlines():
                    lines.append("    " + ln)
    mem = report.get("memory") or {}
    if mem.get("tracker") or mem.get("programs"):
        tr = mem.get("tracker") or {}
        if tr:
            lines.append(f"memory: in_use={_fmt_hbm(tr.get('bytes_in_use'))} "
                         f"peak={_fmt_hbm(mem.get('peak_bytes'))} "
                         f"source={tr.get('source')}")
        for p in (mem.get("programs") or [])[-3:]:
            lines.append(
                f"  {p.get('program')}: "
                f"total={_fmt_hbm(p.get('total_bytes'))} "
                f"(args={_fmt_hbm(p.get('argument_bytes'))} "
                f"temp={_fmt_hbm(p.get('temp_bytes'))} "
                f"out={_fmt_hbm(p.get('output_bytes'))})")
    steps = report.get("steps") or []
    lines.append(f"steps recorded: {len(steps)}"
                 + (" (most recent last)" if steps else ""))
    for rec in steps[-10:]:
        extra = ""
        if rec.get("global_norm") is not None:
            extra += f" |g|={rec['global_norm']:.4g}"
        if rec.get("nonfinite_probes"):
            extra += f" NONFINITE x{len(rec['nonfinite_probes'])}"
        lines.append(
            f"  {rec.get('program')} mode={rec.get('mode')} "
            f"cache={rec.get('cache')} "
            f"t={rec.get('seconds', 0.0):.4f}s{extra}")
    probes = report.get("probe_stats") or []
    if probes:
        lines.append(f"probe stats (last step, {len(probes)} sites):")
        for p in probes:
            lines.append(f"  op {p.get('op_index')} '{p.get('op_type')}' "
                         f"{p.get('var')}: "
                         f"{_fmt_stats_dict(p.get('stats') or {})}")
    audit = report.get("grad_audit") or {}
    if audit:
        lines.append("gradient audit:")
        for param, info in sorted(audit.items()):
            detail = (f" l2={info['l2']:.4g}" if "l2" in info else
                      f" ({info.get('reason', '')})")
            lines.append(f"  {param}: {info.get('status')}{detail}")
    dyn = report.get("dynamics") or {}
    if dyn:
        verd = dyn.get("verdicts") or []
        lines.append(f"training dynamics: "
                     f"{dyn.get('samples_recorded', 0)} samples, "
                     f"{len(verd)} non-ok verdict(s)")
        for v in verd[:10]:
            since = (f" since step {v['since_step']}"
                     if v.get("since_step") is not None else "")
            lines.append(f"  {v.get('program')}/{v.get('series')} "
                         f"[{v.get('role')}]: {v.get('code')}{since}")
    analysis = report.get("analysis") or {}
    if analysis:
        c = analysis.get("counts") or {}
        lines.append(f"static analysis: {c.get('error', 0)} error(s), "
                     f"{c.get('warning', 0)} warning(s), "
                     f"{c.get('info', 0)} info")
        for d in (analysis.get("diagnostics") or []):
            if d.get("severity") == "info":
                continue
            where = (f" [op {d['op_index']} '{d.get('op_type')}']"
                     if d.get("op_index") is not None else
                     f" [var '{d['var']}']" if d.get("var") else "")
            site = f" ({d['site']})" if d.get("site") else ""
            lines.append(f"  {d.get('severity')}: {d.get('code')}"
                         f"{where}{site}: {d.get('message')}")
    events = report.get("events") or []
    if events:
        counts: Dict[str, int] = {}
        for e in events:
            counts[e.get("kind", "?")] = counts.get(e.get("kind", "?"), 0) + 1
        lines.append("telemetry events: "
                     + ", ".join(f"{k}={v}"
                                 for k, v in sorted(counts.items())))
    fl = report.get("flags") or {}
    interesting = {k: v for k, v in fl.items()
                   if k in ("eager", "check_nan_inf", "trap_fp", "vlog",
                            "nonfinite_attribution", "flight_recorder")
                   and v not in ("", 0, False)}
    if interesting:
        lines.append("flags: " + ", ".join(f"{k}={v}"
                                           for k, v in sorted(
                                               interesting.items())))
    if show_program and report.get("program"):
        lines.append("")
        lines.append(report["program"])
    return "\n".join(lines)
