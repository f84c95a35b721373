"""Named-axis sharding planner: one data x fsdp x tp vocabulary (the port's
counterpart of paddle_tpu/parallel/planner.py, whose IR walk and spec
algebra it copies).

1. **Role classification** (`classify_params`): walk the ProgramDesc and
   name each parameter's job from the forward ops that consume it (an
   embedding, attention qkv/out projections, ffn up/down, the lm head,
   conv filters, norms, biases, generic dense weights), seeing through
   shape and elementwise plumbing (TRANSPARENT_OPS).
2. **Role -> spec** (`SpecLayout.role_spec`, parallel/embedding.py): the
   Megatron + ZeRO algebra over named axes; axes the mesh lacks drop out
   and axes that do not divide a dim degrade with a counted
   `planner_fallback_total{program,reason}`.
3. **`plan(program, mesh)`** writes through the existing channels:
   embedding roles through `embedding.shard_table`, the rest through
   `tensor_parallel.shard_parameter`, feeds batch-split over (dp, fsdp)
   through `_feed_shardings`. The returned `Plan` carries per-parameter
   per-shard bytes that `validate_plan_bytes` holds to
   `parallel.per_shard_param_bytes`.

In the JAX package GSPMD runs the plan; in the port the executor runs it
with explicit collectives (parallel/spmd.py): the scope holds each rank's
shard, gathered on use; gradients are reduced over the batch axes and cut
to the shard; a tp-split `mul` runs Megatron's algebra.

Env knobs: `PADDLE_TPU_MESH="dp=2,fsdp=2,tp=2"` sizes the mesh for
`mesh_from_env()` over the process group's ranks.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "SpecLayout", "ParamPlan", "Plan", "classify_params", "plan",
    "mesh_from_env", "model_axes", "validate_plan_bytes",
    "OP_INPUT_ROLES", "TRANSPARENT_OPS", "ATTENTION_OPS", "HEAD_OPS",
    "ROLES", "WALK_ROLES", "SPEC_ROLES", "MATMUL_OPS", "count_fallback",
]


# --------------------------------------------------------------------------
# Role tables (the JAX package's check_registry lint pins every op
# name here against ops/registry.py — a typo never raises, the rule just
# silently stops matching)
# --------------------------------------------------------------------------

# (op_type, input slot) -> role, for parameters whose consuming op alone
# decides the role. Biases are handled structurally (rank-1 'Y' of an
# elementwise_add), not by table.
OP_INPUT_ROLES: Dict[Tuple[str, str], str] = {
    ("lookup_table", "W"): "embedding",
    ("conv2d", "Filter"): "conv_filter",
    ("depthwise_conv2d", "Filter"): "conv_filter",
    ("conv3d", "Filter"): "conv_filter",
    ("conv2d_transpose", "Filter"): "conv_filter",
    ("layer_norm", "Scale"): "norm",
    ("layer_norm", "Bias"): "norm",
    ("batch_norm", "Scale"): "norm",
    ("batch_norm", "Bias"): "norm",
}

# ops the matmul-weight walk sees through: pure shape/elementwise
# plumbing between a projection and the op that gives it meaning
TRANSPARENT_OPS = frozenset({
    "reshape", "transpose", "elementwise_add", "dropout", "scale",
    "cast", "concat", "split", "squeeze", "unsqueeze", "sum",
})

# attention sink/source: a weight projecting INTO one of these is qkv,
# a weight consuming its output is the output projection
ATTENTION_OPS = frozenset({"scaled_dot_product_attention"})

# loss-head sinks: a weight projecting into the softmax tail is the
# model head (lm_head for the transformer, the classifier head for DLRM)
HEAD_OPS = frozenset({"softmax_with_cross_entropy", "softmax",
                      "cross_entropy"})

# weight-bearing matmul ops whose "Y" operand triggers the graph walk
MATMUL_OPS = frozenset({"mul", "matmul"})

# roles the graph walk (as opposed to the direct table) can produce
WALK_ROLES = frozenset({"attn_qkv", "attn_out", "ffn_up", "ffn_down",
                        "lm_head", "bias", "dense"})

# the full role vocabulary the classifier can produce
ROLES = frozenset(OP_INPUT_ROLES.values()) | WALK_ROLES

# roles SpecLayout.role_spec distinguishes — check_registry's
# check_planner_roles pins this == ROLES in both directions (a spec-table
# role no classifier rule produces is dead; a classifier role the spec
# table doesn't know falls into the replicated default silently)
SPEC_ROLES = frozenset({
    "embedding", "attn_qkv", "ffn_up", "lm_head", "attn_out", "ffn_down",
    "conv_filter", "dense", "norm", "bias",
})


def count_fallback(program, reason: str, amount: int = 1):
    """planner_fallback_total{program,reason}: every spec the planner had
    to degrade (indivisible dim, unknown role kept replicated) is
    counted, never silent."""
    from .. import telemetry
    telemetry.counter(
        "planner_fallback_total",
        "parameters whose planned sharding was degraded or skipped by "
        "reason (named-axis sharding planner)",
        labels=("program", "reason")).labels(
        program=telemetry.program_label(program), reason=reason).inc(amount)


# --------------------------------------------------------------------------
# SpecLayout: role -> PartitionSpec entries over named axes
# --------------------------------------------------------------------------

from .embedding import SpecLayout  # noqa: E402


def model_axes(layout: Optional[SpecLayout] = None) -> frozenset:
    """Axes that make a gradient genuinely model-parallel (different
    VALUES per shard, not a sharded copy of the same sum): overlap.py
    skips those with the counted `tp_sharded` reason instead of
    bucketing them."""
    if layout is None:
        # "mp" is tensor_parallel.py's historical axis name
        return frozenset({"tp", "mp"})
    return frozenset({layout.tensor_axis, "mp"})


# --------------------------------------------------------------------------
# Role classification: walk the ProgramDesc
# --------------------------------------------------------------------------

def _is_optimizer_op(op) -> bool:
    ins = op.desc.inputs
    return "Param" in ins and "Grad" in ins


def _forward_ops(program):
    """(index, op) for forward ops only: the classifier reads the model
    structure, and grad/optimizer ops would double-count every consumer
    (lookup_table_grad also takes W, sgd takes Param, ...)."""
    for i, op in enumerate(program.global_block().ops):
        t = op.type
        if t.endswith("_grad") or t.startswith("fused_sparse_"):
            continue
        if _is_optimizer_op(op):
            continue
        yield i, op


def _walk_forward(start: str, consumers, depth: int = 12):
    """Op types reachable from var `start` through TRANSPARENT_OPS —
    the sinks that give a projection output its meaning. Bounded depth:
    residual chains in an N-layer net would otherwise drag every later
    block's sinks into every earlier projection."""
    sinks: List[str] = []
    seen = set()
    frontier = [start]
    for _ in range(depth):
        nxt: List[str] = []
        for name in frontier:
            for (t, _slot, outs) in consumers.get(name, ()):
                if t in TRANSPARENT_OPS:
                    for o in outs:
                        if o not in seen:
                            seen.add(o)
                            nxt.append(o)
                else:
                    sinks.append(t)
        if not nxt:
            break
        frontier = nxt
    return sinks


def _walk_backward(start: str, producers, depth: int = 12):
    """Op types that (transitively through TRANSPARENT_OPS) produced var
    `start` — what a projection's INPUT came from."""
    sources: List[str] = []
    seen = set()
    frontier = [start]
    for _ in range(depth):
        nxt: List[str] = []
        for name in frontier:
            prod = producers.get(name)
            if prod is None:
                continue
            t, ins = prod
            if t in TRANSPARENT_OPS:
                for i_ in ins:
                    if i_ not in seen:
                        seen.add(i_)
                        nxt.append(i_)
            else:
                sources.append(t)
        if not nxt:
            break
        frontier = nxt
    return sources


def classify_params(program) -> Dict[str, str]:
    """{param name -> role} for every parameter of the global block, by
    walking the forward ops that consume it. Precedence per param:

      1. a direct OP_INPUT_ROLES hit (lookup_table W, conv Filter,
         norm Scale/Bias) wins outright;
      2. a rank-1 'Y' operand of elementwise_add is a bias;
      3. a MATMUL_OPS 'Y' weight walks the graph: output reaching
         ATTENTION_OPS -> attn_qkv; input produced by ATTENTION_OPS ->
         attn_out; output reaching HEAD_OPS -> lm_head; input produced
         by an activation -> ffn_down; output feeding an activation ->
         ffn_up;
      4. everything else is generic `dense` (ZeRO dim-0 sharding).
    """
    from ..ops import fusion

    block = program.global_block()
    params = {p.name: p for p in block.all_parameters()}
    if not params:
        return {}
    act_ops = set(fusion.ACT_OPS) | {"gelu", "relu", "tanh", "sigmoid",
                                     "swish"}

    # single pass: who consumes / produces each var, forward ops only
    consumers: Dict[str, List] = {}
    producers: Dict[str, Tuple] = {}
    uses: Dict[str, List] = {n: [] for n in params}
    for _i, op in _forward_ops(program):
        outs = list(op.desc.output_arg_names())
        all_ins = list(op.desc.input_arg_names())
        for slot, names in op.desc.inputs.items():
            for n in names:
                if n in params:
                    uses[n].append((op.type, slot, op))
                consumers.setdefault(n, []).append((op.type, slot, outs))
        for o in outs:
            producers[o] = (op.type, all_ins)

    roles: Dict[str, str] = {}
    for pname, p in params.items():
        ndim = len(p.shape or ())
        role = None
        for (t, slot, op) in uses[pname]:
            role = OP_INPUT_ROLES.get((t, slot))
            if role:
                break
        if role is None and ndim == 1:
            # rank-1 'Y' of a broadcast add = a layer bias
            if any(t == "elementwise_add" and slot == "Y"
                   for (t, slot, _op) in uses[pname]):
                role = "bias"
        if role is None:
            for (t, slot, op) in uses[pname]:
                if t not in MATMUL_OPS or slot != "Y":
                    continue
                outs = list(op.desc.output_arg_names())
                ins = [n for n in op.desc.input_arg_names()
                       if n != pname]
                sinks = []
                for o in outs:
                    sinks.extend(_walk_forward(o, consumers))
                sources = []
                for i_ in ins:
                    sources.extend(_walk_backward(i_, producers))
                if any(s in ATTENTION_OPS for s in sinks):
                    role = "attn_qkv"
                elif any(s in ATTENTION_OPS for s in sources):
                    role = "attn_out"
                elif any(s in HEAD_OPS for s in sinks):
                    role = "lm_head"
                elif any(s in act_ops for s in sources):
                    role = "ffn_down"
                elif any(s in act_ops for s in sinks):
                    role = "ffn_up"
                if role:
                    break
        roles[pname] = role or "dense"
    return roles


# --------------------------------------------------------------------------
# The plan
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class ParamPlan:
    """One parameter's resolved sharding: `spec` is the final (filtered,
    divisibility-degraded) entry tuple written to `_param_shardings`;
    `factor` the device count splitting it; `per_shard_bytes` the ceil
    division of its padded shards."""
    name: str
    role: str
    spec: Tuple
    shape: Tuple[int, ...]
    bytes: int
    per_shard_bytes: int
    factor: int
    notes: Tuple[str, ...] = ()


@dataclass
class Plan:
    """plan()'s result: per-param decisions + the mesh/layout they were
    made against. `predicted` per-shard byte totals are the numbers
    validate_plan_bytes pins against parallel.per_shard_param_bytes."""
    params: Dict[str, ParamPlan]
    mesh_axes: Tuple[str, ...]
    layout: SpecLayout
    feed_specs: Dict[str, Tuple] = field(default_factory=dict)

    @property
    def model_axes(self) -> frozenset:
        return model_axes(self.layout)

    def by_role(self) -> Dict[str, List[str]]:
        out: Dict[str, List[str]] = {}
        for pp in self.params.values():
            out.setdefault(pp.role, []).append(pp.name)
        return {r: sorted(ns) for r, ns in out.items()}

    @property
    def total_bytes(self) -> int:
        return sum(pp.bytes for pp in self.params.values())

    @property
    def per_shard_bytes(self) -> int:
        return sum(pp.per_shard_bytes for pp in self.params.values())

    def to_dict(self) -> Dict:
        return {
            "mesh_axes": list(self.mesh_axes),
            "roles": {n: pp.role for n, pp in sorted(self.params.items())},
            "specs": {n: list(pp.spec)
                      for n, pp in sorted(self.params.items())},
            "total_bytes": self.total_bytes,
            "per_shard_bytes": self.per_shard_bytes,
        }


def _dtype_itemsize(var) -> int:
    try:
        return np.dtype(str(var.dtype)).itemsize
    except TypeError:
        return 4


def _degrade(spec: Tuple, shape, axis_sizes, notes: List[str],
             pname: str) -> Tuple:
    """Drop axes that do not divide their dim (tp first inside tuple
    entries, since dropping fsdp loses more memory savings). GSPMD would
    otherwise pad — legal but byte-accounting poison — and an
    indivisible NAMED axis is always a planning bug worth a counter."""
    out = []
    for d, ent in enumerate(spec):
        axes = list(ent if isinstance(ent, (tuple, list))
                    else (ent,) if ent else ())
        dim = shape[d] if d < len(shape) else -1
        while axes:
            factor = 1
            for a in axes:
                factor *= int(axis_sizes.get(a, 1))
            if dim == -1 or factor <= 1 or dim % factor == 0:
                break
            dropped = axes.pop()   # tp sits last in tuple entries
            notes.append(f"{pname}: dim {d} ({dim}) not divisible by "
                         f"{factor} — dropped axis '{dropped}'")
        out.append(axes[0] if len(axes) == 1 else (tuple(axes) or None))
    return tuple(out)


def _feed_vars(program) -> List[str]:
    """Graph inputs: non-persistable vars consumed but never produced by
    any op — the feed surface plan() batch-shards."""
    block = program.global_block()
    produced = set()
    consumed = set()
    for op in block.ops:
        produced.update(op.desc.output_arg_names())
        consumed.update(op.desc.input_arg_names())
    out = []
    for n in sorted(consumed - produced):
        if not block.has_var(n):
            continue
        v = block.var(n)
        if getattr(v, "persistable", False):
            continue
        if not (v.shape or ()):
            continue
        out.append(n)
    return out


def plan(program, mesh=None, layout: Optional[SpecLayout] = None,
         feeds: Optional[Sequence[str]] = None,
         shard_feeds: bool = True) -> Plan:
    """Classify every parameter, resolve each role's spec against the
    mesh, and write the result through the existing channels:
    `embedding.shard_table` for embedding roles (sparse path +
    `_sharded_tables` bookkeeping), `tensor_parallel.shard_parameter`
    for everything else, `_feed_shardings` batch specs over
    (data, fsdp) for the feed surface. Tags the program with the mesh
    when given one, stores the Plan at `program._sharding_plan`, and
    bumps `_version` once so compiled-step and pass caches invalidate.

    Idempotent per (program, mesh): re-planning overwrites the same
    channels with the same values.
    """
    from . import embedding as embedding_mod
    from . import tensor_parallel as tp_mod

    if mesh is not None:
        program._mesh = mesh
    else:
        mesh = getattr(program, "_mesh", None)
    if mesh is None:
        raise ValueError("planner.plan needs a mesh: pass one or tag the "
                         "program (program._mesh = make_mesh(...))")
    layout = layout or SpecLayout()
    axis_sizes = dict(getattr(mesh, "axis_sizes", None) or {})
    block = program.global_block()
    roles = classify_params(program)

    params: Dict[str, ParamPlan] = {}
    for p in block.all_parameters():
        pname = p.name
        role = roles.get(pname, "dense")
        shape = tuple(int(d) for d in (p.shape or ()))
        ndim = len(shape)
        notes: List[str] = []
        spec = layout.filter_axes(layout.role_spec(role, ndim), mesh)
        spec = _degrade(spec, shape, axis_sizes, notes, pname)
        for _ in notes:
            count_fallback(program, "indivisible")
        factor = 1
        for ent in spec:
            for a in (ent if isinstance(ent, (tuple, list))
                      else (ent,) if ent else ()):
                factor *= int(axis_sizes.get(a, 1))
        nbytes = int(np.prod(shape, dtype=np.int64)) * _dtype_itemsize(p) \
            if shape else 0
        per_shard = -(-nbytes // factor) if factor > 1 else nbytes
        if any(ent for ent in spec):
            if role == "embedding":
                # the sparse lookup/scatter path + _sharded_tables
                # bookkeeping hang off shard_table, not the raw spec
                ent = spec[0]
                axes = tuple(ent) if isinstance(ent, (tuple, list)) \
                    else (ent,)
                embedding_mod.shard_table(program, pname, axes)
            else:
                tp_mod.shard_parameter(program, pname, spec)
        else:
            # replicated by plan: drop any stale annotation so a re-plan
            # onto a smaller mesh does not leave dead axis names behind
            specs = getattr(program, "_param_shardings", None)
            if specs and pname in specs:
                del specs[pname]
            if role not in ("norm", "bias"):
                count_fallback(program, "replicated")
        params[pname] = ParamPlan(
            name=pname, role=role, spec=spec, shape=shape, bytes=nbytes,
            per_shard_bytes=per_shard, factor=factor, notes=tuple(notes))

    feed_specs: Dict[str, Tuple] = {}
    if shard_feeds:
        batch = layout.batch_spec(mesh)
        if batch and batch[0]:
            from . import shard_feed
            names = list(feeds) if feeds is not None \
                else _feed_vars(program)
            for n in names:
                v = block.var(n) if block.has_var(n) else None
                ndim = len(v.shape or ()) if v is not None else 1
                spec = batch + (None,) * (ndim - 1)
                shard_feed(program, n, spec)
                feed_specs[n] = spec

    p = Plan(params=params, mesh_axes=tuple(mesh.axis_names),
             layout=layout, feed_specs=feed_specs)
    program._sharding_plan = p
    program._version = getattr(program, "_version", 0) + 1
    return p


# --------------------------------------------------------------------------
# Validation + env plumbing
# --------------------------------------------------------------------------

def validate_plan_bytes(program, scope=None, tol: float = 0.01
                        ) -> Dict[str, Dict]:
    """Cross-check the plan's predicted per-shard bytes against
    parallel.per_shard_param_bytes (the accounting the bench columns and
    memory.classify ride). Returns {param: {predicted, accounted}} for
    every parameter BOTH sides measured; raises AssertionError on any
    relative mismatch > tol — a hard failure, because divergence means
    the planner and the executor disagree about per-rank memory."""
    from . import per_shard_param_bytes

    p: Optional[Plan] = getattr(program, "_sharding_plan", None)
    if p is None:
        raise ValueError("program has no _sharding_plan — call "
                         "planner.plan first")
    acct = per_shard_param_bytes(program, scope)["params"]
    out: Dict[str, Dict] = {}
    for name, pp in p.params.items():
        a = acct.get(name)
        if a is None or not a.get("bytes"):
            continue  # not materialized in this scope
        out[name] = {"predicted": pp.per_shard_bytes,
                     "accounted": a["per_device"]}
        err = abs(pp.per_shard_bytes - a["per_device"]) / max(
            a["per_device"], 1)
        assert err <= tol, (
            f"planner byte accounting diverged for '{name}': predicted "
            f"{pp.per_shard_bytes} per-shard bytes, "
            f"per_shard_param_bytes says {a['per_device']} "
            f"(rel err {err:.3f} > {tol})")
    return out


def mesh_from_env(default: str = "", devices=None, device=None):
    """Mesh from `PADDLE_TPU_MESH="dp=2,fsdp=2,tp=2"` (or `default` when
    the env var is unset; an empty default puts every rank of the process
    group on 'dp'). The axis order in the string is the mesh's; the sizes
    must multiply to the group's size. `devices` (the JAX signature's) may
    only be None; `device` as make_mesh's."""
    if devices is not None:
        raise ValueError("the port's meshes span the process group's "
                         "ranks; pass no devices")
    import torch.distributed as dist

    from .mesh import make_mesh

    raw = os.environ.get("PADDLE_TPU_MESH", default)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if not raw.strip():
        return make_mesh((world,), ("dp",), device=device)
    shape: List[int] = []
    names: List[str] = []
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        k, _, v = part.partition("=")
        try:
            size = int(v)
        except ValueError:
            raise ValueError(f"PADDLE_TPU_MESH entry '{part}' is not "
                             f"axis=<int>")
        if size < 1:
            raise ValueError(f"PADDLE_TPU_MESH axis '{k}' has size "
                             f"{size} < 1")
        names.append(k.strip())
        shape.append(size)
    n = 1
    for s in shape:
        n *= s
    if n != world:
        raise ValueError(f"PADDLE_TPU_MESH '{raw}' needs {n} ranks; the "
                         f"process group has {world}")
    return make_mesh(tuple(shape), tuple(names), device=device)
