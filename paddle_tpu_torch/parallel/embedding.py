"""Row-sharded embedding tables (the port's counterpart of
paddle_tpu/parallel/embedding.py).

The reference serves recommender-scale tables from parameter servers,
split by rows; the JAX package annotates the table's row dim with mesh
axes (`SpecLayout.embeddings()`: sharded over fsdp x tp, the feature dim
replicated) and lets GSPMD partition the gather. This module keeps that
annotation side:

  * `SpecLayout`: the role map from parameter roles to spec tuples over
    named axes (the JAX package's parallel/planner.py SpecLayout, copied).
  * `shard_table` / `shard_embeddings`: row-shard one table / every
    `lookup_table` W of a program; the spec goes to
    `program._param_shardings` (the write of the JAX package's
    tensor_parallel.shard_parameter, with its `_version` bump) and the
    table to `program._sharded_tables`, so fusion counts a sharded table's
    update as `sharded_table_sparse_path` and lookup_table_grad emits a
    SelectedRows gradient for it.
  * `table_accumulators` / `resolve_state_spec`: an optimizer accumulator
    (`<param>_<acc>_<n>`, the optimizer's naming) of a sharded table
    takes the table's sharding.
  * `state_shard_factor` / `per_shard_table_bytes`: per-device bytes of
    the sharded tables and their optimizer state.

On the port's mesh of one rank (parallel/mesh.py with no process group: the
one card) a sharded table holds every row and runs the sparse path, its
counters included. A shard axis of more than one rank raises
NotImplementedError: a routed multi-rank lookup needs the local-view
executor of ROADMAP Queue 1 item 9b.

`PADDLE_TPU_EMB_SHARD_AXIS` (default "fsdp", comma-separated for several)
names the axis when a caller passes none.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch.distributed as dist

__all__ = [
    "SpecLayout", "default_shard_axes", "shard_table", "shard_embeddings",
    "sharded_tables", "table_accumulators", "resolve_state_spec",
    "state_shard_factor", "per_shard_table_bytes",
]

Axes = Union[str, Sequence[str]]


@dataclass(frozen=True)
class SpecLayout:
    """Role map from parameter roles to dim-0-first spec tuples over named
    mesh axes (the JAX package's planner.py:153): embeddings shard their row
    dim over fsdp x tp and replicate the feature dim; projections follow the
    Megatron column/row algebra with fsdp on the other dim; norm and bias
    replicate. Axes the mesh lacks are dropped (`filter_axes`)."""

    data_axis: str = "dp"
    fsdp_axis: str = "fsdp"
    tensor_axis: str = "tp"

    def embeddings(self) -> Tuple:
        return ((self.fsdp_axis, self.tensor_axis), None)

    def ffn_column(self) -> Tuple:
        return (self.fsdp_axis, self.tensor_axis)

    def ffn_row(self) -> Tuple:
        return (self.tensor_axis, self.fsdp_axis)

    def role_spec(self, role: str, ndim: int) -> Tuple:
        """The spec tuple of `role` at rank `ndim`; unknown roles
        replicate."""
        if role == "embedding":
            spec = self.embeddings()
        elif role in ("attn_qkv", "ffn_up", "lm_head"):
            spec = self.ffn_column()
        elif role in ("attn_out", "ffn_down"):
            spec = self.ffn_row()
        elif role in ("conv_filter", "dense"):
            spec = (self.fsdp_axis,)
        else:
            spec = ()
        spec = tuple(spec)[:ndim]
        return spec + (None,) * (ndim - len(spec))

    def filter_axes(self, spec: Tuple, mesh) -> Tuple:
        """Drop the axes the mesh lacks; an emptied entry becomes None."""
        have = set(getattr(mesh, "axis_names", ()) or ())
        out = []
        for ent in spec:
            axes = (tuple(ent) if isinstance(ent, (tuple, list))
                    else (ent,) if ent else ())
            axes = tuple(a for a in axes if a in have)
            out.append(axes[0] if len(axes) == 1 else (axes or None))
        return tuple(out)

    def batch_spec(self, mesh) -> Tuple:
        """Dim-0 entry of a fed batch: split over data x fsdp."""
        return self.filter_axes(((self.data_axis, self.fsdp_axis),), mesh)


def default_shard_axes() -> Tuple[str, ...]:
    """PADDLE_TPU_EMB_SHARD_AXIS (comma-separated), default ("fsdp",)."""
    raw = os.environ.get("PADDLE_TPU_EMB_SHARD_AXIS", "fsdp")
    return tuple(a.strip() for a in raw.split(",") if a.strip())


def _ranks(program, axes: Tuple[str, ...]) -> int:
    """How many ranks `axes` span: on the program's mesh (or the current
    one) the product of their sizes; with no mesh, the process group's
    size (a mesh made later spans it)."""
    from .mesh import get_mesh
    mesh = getattr(program, "_mesh", None) or get_mesh()
    if mesh is None:
        return dist.get_world_size() if dist.is_initialized() else 1
    n = 1
    for a in axes:
        if a in mesh.axis_names:
            n *= mesh.axis_size(a)
    return n


def _shard_parameter(program, param_name: str, spec):
    """The spec write of the JAX package's tensor_parallel.shard_parameter:
    `program._param_shardings[param_name] = spec`, bumping `_version` when
    it changes."""
    specs = getattr(program, "_param_shardings", None)
    if specs is None:
        specs = program._param_shardings = {}
    spec = tuple(spec)
    if specs.get(param_name) != spec:
        specs[param_name] = spec
        program._version = getattr(program, "_version", 0) + 1


def shard_table(program, param_name: str, axis: Optional[Axes] = None):
    """Row-shard one embedding table over mesh axis/axes (default
    PADDLE_TPU_EMB_SHARD_AXIS): the spec in `_param_shardings`, the table in
    `_sharded_tables`. Raises NotImplementedError when the axes span more
    than one rank (ROADMAP Queue 1 item 9b)."""
    axes = (tuple(axis) if isinstance(axis, (tuple, list))
            else (axis,) if axis else default_shard_axes())
    if _ranks(program, axes) > 1:
        from ..ops.sparse_ops import ITEM_9B
        raise NotImplementedError(f"shard_table('{param_name}', {axes}): "
                                  f"{ITEM_9B}")
    ndim = None
    blk = program.global_block()
    if blk.has_var(param_name):
        shp = blk.var(param_name).shape
        ndim = len(shp) if shp is not None else None
    first = axes[0] if len(axes) == 1 else tuple(axes)
    _shard_parameter(program, param_name,
                     (first,) + (None,) * ((ndim or 2) - 1))
    tables = getattr(program, "_sharded_tables", None)
    if tables is None:
        tables = program._sharded_tables = {}
    tables[param_name] = axes
    return program


def sharded_tables(program) -> Dict[str, Tuple[str, ...]]:
    """{table name: row-shard axes} recorded by shard_table."""
    return dict(getattr(program, "_sharded_tables", None) or {})


def shard_embeddings(program, axis: Optional[Axes] = None, mesh=None,
                     layout: Optional[SpecLayout] = None) -> List[str]:
    """Row-shard every `lookup_table` W of the program. With a `layout`
    the axes come from `layout.embeddings()` filtered to the mesh's;
    otherwise `axis` or PADDLE_TPU_EMB_SHARD_AXIS. Returns the tables."""
    mesh = mesh if mesh is not None else getattr(program, "_mesh", None)
    if layout is not None and mesh is not None:
        ent = layout.filter_axes(layout.embeddings(), mesh)[0]
        axes = (tuple(ent) if isinstance(ent, (tuple, list))
                else (ent,) if ent else ())
        axis = axes or axis
    blk = program.global_block()
    done: List[str] = []
    for op_ in blk.ops:
        if op_.type != "lookup_table":
            continue
        wnames = op_.input("W")
        if not wnames or wnames[0] in done or not blk.has_var(wnames[0]):
            continue
        shard_table(program, wnames[0], axis)
        done.append(wnames[0])
    return done


def table_accumulators(program, pname: str) -> List[str]:
    """The optimizer accumulators of table `pname`: vars named
    `<pname>_...` of the table's shape (the optimizer's naming; the shape
    check keeps the [1] beta powers out)."""
    blk = program.global_block()
    if not blk.has_var(pname):
        return []
    pshape = tuple(blk.var(pname).shape or ())
    if not pshape:
        return []
    return sorted(n for n in blk.vars
                  if n != pname and n.startswith(pname + "_")
                  and tuple(blk.var(n).shape or ()) == pshape)


def _accum_of(program, name: str) -> Optional[str]:
    """The sharded parameter whose accumulator `name` is, or None."""
    sharded = set(getattr(program, "_sharded_tables", None) or ())
    sharded.update(getattr(program, "_param_shardings", None) or ())
    for pname in sorted(sharded):
        if name in table_accumulators(program, pname):
            return pname
    return None


def resolve_state_spec(program, name: str):
    """A persistable's spec: its own `_param_shardings` entry, or, for an
    accumulator of a sharded table, the table's."""
    specs = getattr(program, "_param_shardings", None) or {}
    if name in specs:
        return specs[name]
    pname = _accum_of(program, name)
    return specs.get(pname) if pname else None


def state_shard_factor(program, name: str) -> int:
    """How many ranks split state var `name` (1: replicated)."""
    spec = resolve_state_spec(program, name)
    mesh = getattr(program, "_mesh", None)
    if not spec or mesh is None:
        return 1
    f = 1
    for ent in spec:
        axes = (tuple(ent) if isinstance(ent, (tuple, list))
                else (ent,) if ent else ())
        for a in axes:
            if a in mesh.axis_names:
                f *= mesh.axis_size(a)
    return f


def _nbytes(scope, blk, name: str) -> int:
    v = scope.find_var(name)
    if v is not None and hasattr(v, "element_size"):
        return int(v.numel() * v.element_size())
    if v is not None and hasattr(v, "nbytes"):
        return int(v.nbytes)
    if blk.has_var(name):
        var = blk.var(name)
        shp = tuple(var.shape or ())
        if shp and all(int(s) > 0 for s in shp):
            from ..ops.common import to_torch_dtype
            n = 1
            for s in shp:
                n *= int(s)
            itemsize = to_torch_dtype(var.dtype).itemsize if var.dtype else 4
            return n * itemsize
    return 0


def per_shard_table_bytes(program, scope=None) -> Dict:
    """Per-rank bytes of each sharded table and its optimizer state:
    {tables: {name: {rows, dim, bytes, per_shard_bytes, opt_state_bytes,
    opt_state_per_shard_bytes, factor}}, total_bytes,
    total_per_shard_bytes}. Bytes come from the scope's values when
    present, else from the block's shapes."""
    from ..executor import global_scope
    scope = scope if scope is not None else global_scope()
    blk = program.global_block()
    out: Dict[str, Dict] = {}
    total = total_ps = 0
    for pname in sharded_tables(program):
        if not blk.has_var(pname):
            continue
        shp = tuple(blk.var(pname).shape or ())
        factor = state_shard_factor(program, pname)
        b = _nbytes(scope, blk, pname)
        opt_b = opt_ps = 0
        for vname in table_accumulators(program, pname):
            ab = _nbytes(scope, blk, vname)
            opt_b += ab
            opt_ps += -(-ab // state_shard_factor(program, vname))
        per_shard = -(-b // factor) if factor > 1 else b
        out[pname] = {
            "rows": int(shp[0]) if shp else 0,
            "dim": int(shp[1]) if len(shp) > 1 else 0,
            "bytes": int(b), "per_shard_bytes": int(per_shard),
            "opt_state_bytes": int(opt_b),
            "opt_state_per_shard_bytes": int(opt_ps),
            "factor": int(factor),
        }
        total += b + opt_b
        total_ps += per_shard + opt_ps
    return {"tables": out, "total_bytes": int(total),
            "total_per_shard_bytes": int(total_ps)}
