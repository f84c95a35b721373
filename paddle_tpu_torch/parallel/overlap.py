"""Bucketed gradient sync for data-parallel training (the port's
counterpart of paddle_tpu/parallel/overlap.py, whose plan it copies).

The reference's ParallelExecutor launched each gradient's all-reduce as
soon as backward produced it. `plan()` groups a dp-mesh program's
parameter gradients into size-capped buckets per (dtype, spec group) in
readiness order (ascending last-producer op index), exactly as the JAX
package's plan does; the port's executor (parallel/spmd.py `flush`) posts
each bucket's all-reduce asynchronously right after the op at its anchor
and waits on it before the first op that reads a member. A bucket of a
dp/fsdp-sharded group is cut to each rank's shard after the reduction (a
reduce-scatter on NCCL; an all-reduce and a narrow on gloo).

`compiler_options` has no counterpart outside XLA: it returns None, with
the `platform` reason counted, as the JAX package does off the TPU.
`choose_steps_per_call`'s memory bound needs memory.HeadroomModel (ROADMAP
item 10); its amortization rule is here.

Env knobs: `PADDLE_TPU_OVERLAP=1` (default on; read at import) gates the
plan; `PADDLE_TPU_OVERLAP_BUCKET_MB` caps a bucket (default 4 MiB, read at
plan time). `overlap_fallback_total{program,reason}` counts what stays
out of the buckets (tp_sharded, sharded_param, sharded_table_sparse_path,
sparse_grad_handled, unknown_var, dynamic_shape, platform) and
`overlap_buckets_total{program}` the buckets flushed.
"""

from __future__ import annotations

import bisect
import math
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "OVERLAP_OPT", "Bucket", "OverlapPlan", "plan", "count_fallback",
    "count_bucket", "compiler_options", "choose_steps_per_call",
]

OVERLAP_OPT = os.environ.get("PADDLE_TPU_OVERLAP", "1") == "1"


def _bucket_cap_bytes() -> int:
    """Per-bucket payload cap, read at plan time."""
    try:
        mb = float(os.environ.get("PADDLE_TPU_OVERLAP_BUCKET_MB", "4"))
    except ValueError:
        mb = 4.0
    return max(int(mb * 1024 * 1024), 1)


def count_fallback(program, reason: str, amount: int = 1):
    """overlap_fallback_total{program,reason}."""
    from .. import telemetry
    telemetry.counter(
        "overlap_fallback_total",
        "gradients or compile paths that kept the unscheduled sync by "
        "reason (communication/compute overlap pass)",
        labels=("program", "reason")).labels(
        program=telemetry.program_label(program), reason=reason).inc(amount)


def count_bucket(program):
    """overlap_buckets_total{program}: one bucket posted."""
    from .. import telemetry
    telemetry.counter(
        "overlap_buckets_total",
        "gradient buckets flushed eagerly by the overlap pass",
        labels=("program",)).labels(
        program=telemetry.program_label(program)).inc()


@dataclass(frozen=True)
class Bucket:
    """One flush unit: `grads[i]` is the gradient of `params[i]`, all of
    one declared dtype and one spec group, at most the cap in bytes.
    `anchor` is the global-block index of the last op producing a member;
    `spec` the group's spec tuple (empty: replicated parameters)."""
    index: int
    params: Tuple[str, ...]
    grads: Tuple[str, ...]
    dtype: str
    bytes: int
    anchor: int
    spec: Tuple = ()

    @property
    def site(self) -> str:
        prefix = "_".join(_spec_axes(self.spec)) or "dp"
        return f"{prefix}_grad_bucket{self.index}"


def _spec_axes(spec) -> Tuple[str, ...]:
    axes = set()
    for ent in (spec or ()):
        for a in (ent if isinstance(ent, (tuple, list))
                  else (ent,) if ent else ()):
            axes.add(str(a))
    return tuple(sorted(axes))


def _norm_spec(spec) -> Tuple:
    out = [tuple(ent) if isinstance(ent, list) else ent
           for ent in (spec or ())]
    while out and not out[-1]:
        out.pop()
    return tuple(out)


class OverlapPlan:
    """Buckets for one program version, indexed by anchor."""

    def __init__(self, buckets: List[Bucket]):
        self.buckets = buckets
        self.by_anchor: Dict[int, List[Bucket]] = {}
        for b in buckets:
            self.by_anchor.setdefault(b.anchor, []).append(b)
        self.anchors = sorted(self.by_anchor)

    @property
    def sites(self) -> List[str]:
        return [b.site for b in self.buckets]

    def flush_range(self, ctx, env, lo: int, hi: int):
        """Post every bucket anchored in [lo, hi): the op indices the run
        just executed (a window advances several at once)."""
        i = bisect.bisect_left(self.anchors, lo)
        while i < len(self.anchors) and self.anchors[i] < hi:
            for b in self.by_anchor[self.anchors[i]]:
                _flush(ctx, b, env)
            i += 1


_PLANS: Dict[Tuple[int, int], Tuple[Any, Optional[OverlapPlan]]] = {}


def plan(program) -> Optional[OverlapPlan]:
    """The program's bucket plan, or None when overlap is off, the program
    has no mesh with a 'dp' axis, or it has no dense gradient to bucket.
    Cached per (id, version)."""
    if not OVERLAP_OPT:
        return None
    mesh = getattr(program, "_mesh", None)
    if mesh is None or "dp" not in getattr(mesh, "axis_names", ()):
        return None
    key = (id(program), getattr(program, "_version", 0))
    hit = _PLANS.get(key)
    if hit is not None and hit[0] is program:
        return hit[1]
    if len(_PLANS) > 64:
        _PLANS.clear()
    p = _build(program)
    _PLANS[key] = (program, p)
    return p


def _dtype_nbytes(dtype: str) -> int:
    import numpy as np
    try:
        return int(np.dtype(dtype).itemsize)
    except TypeError:
        # numpy spells bfloat16 only once ml_dtypes registered it (the JAX
        # package always has): 2 bytes, as the JAX plan counts it
        return 2 if "bfloat16" in str(dtype) else 4


def _grad_pairs(program) -> List[Tuple[str, str]]:
    """(param, grad) name pairs: append_backward's record, else the
    grad_var_name convention against declared block vars."""
    pairs = getattr(program, "_grad_param_pairs", None)
    if pairs:
        return list(pairs)
    from ..framework.framework import grad_var_name
    block = program.global_block()
    out = []
    for p in block.all_parameters():
        if not getattr(p, "trainable", True):
            continue
        g = grad_var_name(p.name)
        if block.desc.has_var(g):
            out.append((p.name, g))
    return out


def _build(program) -> Optional[OverlapPlan]:
    import numpy as np

    from . import planner as planner_mod

    block = program.global_block()
    pairs = _grad_pairs(program)
    if not pairs:
        return None
    last: Dict[str, int] = {}
    for i, op in enumerate(block.ops):
        for name in op.desc.output_arg_names():
            last[name] = i
    specs = getattr(program, "_param_shardings", {})
    mesh = getattr(program, "_mesh", None)
    mesh_axes = set(getattr(mesh, "axis_names", ()) or ())
    splan = getattr(program, "_sharding_plan", None)
    model_axes = planner_mod.model_axes(
        splan.layout if splan is not None else None)
    items = []
    for pname, gname in pairs:
        anchor = last.get(gname)
        if anchor is None:
            continue
        if pname in (getattr(program, "_sharded_tables", None) or {}):
            count_fallback(program, "sharded_table_sparse_path")
            continue
        if gname in (getattr(program, "_sparse_grad_names", None) or ()):
            count_fallback(program, "sparse_grad_handled")
            continue
        spec = _norm_spec(specs.get(pname))
        if spec:
            axes = set(_spec_axes(spec))
            if axes & model_axes:
                count_fallback(program, "tp_sharded")
                continue
            if axes - mesh_axes:
                count_fallback(program, "sharded_param")
                continue
        try:
            var = block.var(gname) if block.desc.has_var(gname) \
                else block.var(pname)
            shape = tuple(var.shape or ())
            dtype = str(var.dtype)
        except Exception:
            count_fallback(program, "unknown_var")
            continue
        if any(d is None or d < 0 for d in shape):
            count_fallback(program, "dynamic_shape")
            continue
        nbytes = int(np.prod(shape, dtype=np.int64)) * _dtype_nbytes(dtype) \
            if shape else _dtype_nbytes(dtype)
        items.append((anchor, pname, gname, dtype, nbytes, spec))
    if not items:
        return None
    items.sort(key=lambda it: (it[0], it[2]))
    cap = _bucket_cap_bytes()
    buckets: List[Bucket] = []
    open_by_group: Dict[Tuple[str, Tuple], List[Any]] = {}

    def _close(group):
        acc = open_by_group.pop(group, None)
        if acc:
            dtype, spec = group
            buckets.append(Bucket(
                index=len(buckets), params=tuple(acc[0]),
                grads=tuple(acc[1]), dtype=dtype, bytes=acc[2],
                anchor=acc[3], spec=spec))

    for anchor, pname, gname, dtype, nbytes, spec in items:
        group = (dtype, spec)
        acc = open_by_group.get(group)
        if acc is not None and acc[2] + nbytes > cap:
            _close(group)
            acc = None
        if acc is None:
            acc = open_by_group[group] = [[], [], 0, anchor]
        acc[0].append(pname)
        acc[1].append(gname)
        acc[2] += nbytes
        acc[3] = max(acc[3], anchor)
    for group in sorted(open_by_group, key=repr):
        _close(group)
    buckets.sort(key=lambda b: (b.anchor, b.index))
    buckets = [Bucket(index=i, params=b.params, grads=b.grads,
                      dtype=b.dtype, bytes=b.bytes, anchor=b.anchor,
                      spec=b.spec)
               for i, b in enumerate(buckets)]
    return OverlapPlan(buckets)


def _flush(ctx, bucket: Bucket, env: Dict[str, Any]):
    """Post the bucket's all-reduce (parallel/spmd.py `Spmd.flush`) under
    its pd.coll scope; a member that is no partial sum (replicated already,
    or a SelectedRows gradient, which the sparse path gathers) stays out,
    and a bucket with no member left posts nothing."""
    spmd = getattr(ctx, "spmd", None)
    if spmd is None:
        return
    if spmd.flush(bucket, env):
        count_bucket(ctx.program)


def compiler_options(program=None) -> Optional[Dict[str, str]]:
    """None: the latency-hiding scheduler options are XLA's. Counted as the
    `platform` fallback when there is a mesh, as the JAX package does off
    the TPU."""
    if not OVERLAP_OPT:
        return None
    if program is not None and getattr(program, "_mesh", None) is None:
        return None
    count_fallback(program, "platform")
    return None


def choose_steps_per_call(python_overhead_ms: Optional[float] = None,
                          step_time_ms: Optional[float] = None,
                          feed_bytes_per_step: Optional[int] = None,
                          peak_bytes: Optional[int] = None,
                          budget_bytes: Optional[int] = None,
                          target_overhead_frac: float = 0.02,
                          lo: int = 1, hi: int = 64) -> int:
    """The run_steps window K (overlap.py:505).

    Amortization: with K steps a call the per-step host cost is
    overhead/K, so K = ceil(overhead / (frac * step_time)) caps host
    dispatch at `target_overhead_frac` of the step. Memory: the stacked
    [K, B, ...] feed window grows linearly in K on top of the K=1
    footprint, the linear shape memory.HeadroomModel fits for batch sizes
    — max_batch(budget) over (fixed = peak - one window, per_item = one
    window) bounds K to the device's headroom. No timing signal means 'as
    large as memory allows', no memory signal the amortization value
    alone, neither `hi`. Clamped to [lo, hi]."""
    lo = max(1, int(lo))
    hi = max(lo, int(hi))
    k = hi
    if python_overhead_ms and step_time_ms and step_time_ms > 0 \
            and target_overhead_frac > 0:
        need = python_overhead_ms / (target_overhead_frac * step_time_ms)
        k = min(k, max(lo, int(math.ceil(need))))
    if feed_bytes_per_step and budget_bytes:
        from ..memory import HeadroomModel
        model = HeadroomModel(
            fixed_bytes=max(0.0, float(peak_bytes or 0)
                            - float(feed_bytes_per_step)),
            per_item_bytes=float(feed_bytes_per_step))
        k_mem = model.max_batch(int(budget_bytes))
        if k_mem is not None:
            k = min(k, max(lo, k_mem))
    return max(lo, min(k, hi))
