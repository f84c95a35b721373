"""The sharded run of a program over a process group (the port's counterpart
of the JAX executor's SPMD path: executor.py:1898-1960 `_shardings`,
:1823-1896 the state pins, :1744-1770 the overlap flush).

Under a mesh the JAX executor jits the program SPMD and GSPMD inserts the
collectives. The port interprets the program on every rank with explicit
collectives, and returns on every rank what the same program returns on
one device, up to the order of sums:

  * Feeds. Every rank is fed the global batch and keeps its rows along
    the feed's spec: an explicit `shard_feed` spec on dim 0 wins, else the
    feed splits over 'dp' when the mesh has that axis (the planner writes
    its (dp, fsdp) specs through `shard_feed`). `@SEQLEN` sidecars follow
    their base feed. A batch that does not divide raises.
  * Values. Each value is split along the batch (its declared dim 0 is the
    batch), replicated, or a partial sum. An op that reads a split value
    writes split outputs where their dim 0 is the batch; an op whose
    lowering reduces over the batch has a rule (an all-reduce inside it:
    RULED_OPS) and writes replicated values; a grad op writes partial sums
    (the gradient of a replicated input summed over this rank's rows); any
    other op that drops the batch raises, naming itself.
  * Partial sums are all-reduced over the batch axes: in the overlap
    plan's buckets, posted asynchronously after the op at the bucket's
    anchor and waited on before the first reader (parallel/overlap.py),
    else when an op other than an accumulating `sum` or a grad op's
    cotangent reads them. So the clip's norm, AMP's check and the
    optimizer read reduced gradients.
  * Sharded state (`_param_shardings`, and the optimizer state that
    inherits a parameter's spec through `embedding.resolve_state_spec`).
    The scope holds the rank's shard (a whole tensor in the scope, from a
    startup or a checkpoint, is cut at the step's start). An op reads it
    all-gathered (COUNTERS.gathers), a `mul` whose weight is split on a
    model axis gathers only its other dims and runs Megatron's algebra
    (ops/math_ops.py), a row-sharded table is read by a masked local
    gather and one all-reduce (ops/sparse_ops.py), and moe_ffn reads its
    expert weights split on dim 0 (EXPERT_OPS) as this rank's experts and
    runs them alone (ops/nn_ops.py), its W1/W2 gradient whole on the owner
    where the weights are split over every batch axis. A gradient is
    reduced and cut to the shard; the optimizer op runs on the shards.
  * Random ops. dropout, the batch-size-like random ops and nce draw the
    global batch's values and keep this rank's rows (`global_rows`), so
    the ranks together hold what one device draws.
  * Fetches. A split fetch is gathered along dim 0, a partial one
    reduced, a shard gathered: a script runs unchanged on 1 or N ranks.

`for_program(program)` is None (the one-device path, untouched) unless the
program's mesh has a process group and the program has a batch axis or a
sharded parameter. A ring program on an 'sp' mesh stays global-view: its
op shards the sequence inside itself (parallel/ring_attention.py).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from . import _collectives as C
from .mesh import axes_tuple

__all__ = ["Spmd", "for_program", "batch_axes", "RULED_OPS", "COUNTERS",
           "gather_state", "MODEL_AXES", "EXPERT_OPS"]

# ops whose lowering all-reduces what it sums over the batch, so that
# their non-batch outputs are the global (replicated) values
RULED_OPS = frozenset({
    "mean", "reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
    "accuracy", "batch_norm", "batch_norm_grad", "lookup_table",
})
# ops that read their expert weights (W1, W2 split on dim 0 alone) as
# this rank's shard and run only its experts (ops/nn_ops.py moe_ffn)
EXPERT_OPS = frozenset({"moe_ffn", "moe_ffn_grad"})
EXPERT_SLOTS = frozenset({"W1", "W2"})
# the axes a weight is split on for Megatron's algebra (planner.model_axes)
MODEL_AXES = frozenset({"tp", "mp"})


class Counters:
    """gathers: sharded values all-gathered on use, by name; reduces:
    partial sums all-reduced outside a bucket, by reason ('read',
    'fetch', 'end'); buckets: buckets posted; cuts: gradients cut to a
    shard."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.gathers: Dict[str, int] = {}
        self.reduces: Dict[str, int] = {}
        self.buckets = 0
        self.cuts = 0


COUNTERS = Counters()


def _bump(table, key):
    table[key] = table.get(key, 0) + 1


def batch_axes(program, mesh) -> Tuple[str, ...]:
    """The axes the program's batch is split over: the dim-0 entries of
    its `_feed_shardings` (which must agree), else ('dp',) when the mesh
    has that axis, else ()."""
    specs = getattr(program, "_feed_shardings", None) or {}
    found = {axes_tuple(s[0]) for s in specs.values() if s and s[0]}
    if len(found) > 1:
        raise ValueError(f"feeds split over different axes {sorted(found)}:"
                         f" one batch axis tuple per program")
    if found:
        axes = found.pop()
        missing = [a for a in axes if a not in mesh.axis_names]
        if missing:
            raise ValueError(f"feed spec names axes {missing} the mesh "
                             f"{mesh.axis_names} lacks")
        return axes
    return ("dp",) if "dp" in mesh.axis_names else ()


class Shard:
    """One sharded value's layout: per dim, the axes splitting it."""

    def __init__(self, mesh, spec, full_shape):
        self.full = tuple(int(d) for d in full_shape)
        ents = list(spec)[:len(self.full)]
        ents += [None] * (len(self.full) - len(ents))
        self.dims = [tuple(a for a in axes_tuple(e)
                           if a in mesh.axis_names) for e in ents]
        self.mesh = mesh
        for d, axes in enumerate(self.dims):
            if axes and self.full[d] % mesh.axis_size(axes):
                raise ValueError(
                    f"dim {d} ({self.full[d]}) of a value of shape "
                    f"{self.full} does not split over the "
                    f"{mesh.axis_size(axes)} ranks of {axes}")
        self.factor = math.prod(mesh.axis_size(a) for a in self.dims if a)

    def shape(self) -> Tuple[int, ...]:
        """This rank's shard's shape."""
        return tuple(f // self.mesh.axis_size(a) if a else f
                     for f, a in zip(self.full, self.dims))

    @property
    def model_dim(self) -> Optional[int]:
        for d, axes in enumerate(self.dims):
            if set(axes) & MODEL_AXES:
                return d
        return None

    def cut(self, t, skip=frozenset()):
        """This rank's part of `t` along every split dim not over `skip`
        axes, where `t` is whole along it."""
        for d, axes in enumerate(self.dims):
            if not axes or set(axes) & skip or t.shape[d] != self.full[d]:
                continue
            n = self.full[d] // self.mesh.axis_size(axes)
            t = t.narrow(d, self.mesh.axis_index(axes) * n, n)
        return t.contiguous()

    def gather(self, t, skip=frozenset(), site="param_all_gather"):
        """`t` all-gathered along every split dim not over `skip` axes."""
        for d, axes in enumerate(self.dims):
            if not axes or set(axes) & skip or t.shape[d] == self.full[d]:
                continue
            t = C.all_gather(t, self.mesh, axes, dim=d, site=site)
        return t


_STATIC: Dict[Tuple[int, int], Tuple[Any, Any]] = {}


def for_program(program) -> Optional["Static"]:
    """The program's sharded-run plan, or None for the one-device path."""
    mesh = getattr(program, "_mesh", None)
    if mesh is None or getattr(mesh, "group", None) is None:
        return None
    key = (id(program), getattr(program, "_version", 0))
    hit = _STATIC.get(key)
    if hit is not None and hit[0] is program:
        return hit[1]
    st = Static(program, mesh)
    if not st.batch and not st.specs:
        st = None
    if len(_STATIC) > 64:
        _STATIC.clear()
    _STATIC[key] = (program, st)
    return st


class Static:
    """What a program's sharded run knows before it runs: the mesh, the
    batch axes, each sharded state name's spec, the declared batch dims."""

    def __init__(self, program, mesh):
        from . import embedding
        self.program, self.mesh = program, mesh
        self.batch = batch_axes(program, mesh)
        self.nb = mesh.axis_size(self.batch) if self.batch else 1
        self.bi = mesh.axis_index(self.batch) if self.batch else 0
        block = program.global_block()
        self.feed_specs = getattr(program, "_feed_shardings", None) or {}
        specs = getattr(program, "_param_shardings", None) or {}
        self.specs: Dict[str, Shard] = {}
        names = set(specs)
        for p in set(specs) | set(getattr(program, "_sharded_tables",
                                          None) or ()):
            names.update(embedding.table_accumulators(program, p))
        for n in sorted(names):
            spec = embedding.resolve_state_spec(program, n)
            if not spec or not block.has_var(n):
                continue
            shape = block.var(n).shape
            if not shape or any(d is None or d < 0 for d in shape):
                continue
            sh = Shard(mesh, spec, shape)
            if sh.factor > 1 or any(sh.dims):
                self.specs[n] = sh
        self.grads = {}
        from ..framework.framework import grad_var_name
        for n in list(self.specs):
            self.grads[grad_var_name(n)] = n
        self.shapes = {n: v.shape for b in program.blocks
                       for n, v in b.desc.vars.items()}
        self.persistable = {n for b in program.blocks
                            for n, v in b.desc.vars.items() if v.persistable}

    def batch_dim(self, name, rows_seen) -> Optional[bool]:
        """Whether `name`'s declared dim 0 is the batch: -1, or a global
        batch size a split feed had; None when undeclared."""
        if name.split("@GRAD")[0] in self.persistable:
            return False        # state and its gradients carry no batch
        shape = self.shapes.get(name)
        if shape is None:
            return None
        if not shape:
            return False
        return shape[0] is None or shape[0] < 0 or shape[0] in rows_seen

    def split_feeds(self, feed: Dict[str, torch.Tensor]):
        """(each feed's rows of this rank, the marks a step's Spmd starts
        from: the split names, the global batch sizes a feed declared
        whole, this rank's row counts)."""
        split, rows_seen, local_rows = set(), set(), set()
        if not self.batch:
            return feed, (split, rows_seen, local_rows)
        out = {}
        for n, v in feed.items():
            base = n.split("@SEQLEN")[0]
            spec = self.feed_specs.get(base)
            axes = axes_tuple(spec[0]) if spec else self.batch
            if (spec is not None and not axes) or axes != self.batch \
                    or v.dim() == 0:
                out[n] = v
                continue
            rows = v.shape[0]
            if rows % self.nb:
                raise ValueError(
                    f"feed '{n}': a batch of {rows} rows does not split "
                    f"over the {self.nb} ranks of {self.batch}")
            k = rows // self.nb
            declared = self.shapes.get(n)
            if declared and declared[0] is not None and declared[0] > 0:
                # a batch declared whole (append_batch_size=False): its
                # size marks the batch dim of the values it flows into
                rows_seen.add(rows)
            if "@SEQLEN" not in n:
                local_rows.add(k)
            out[n] = v.narrow(0, self.bi * k, k)
            split.add(n)
        return out, (split, rows_seen, local_rows)

    def localize(self, state: Dict[str, torch.Tensor]):
        """Cut each whole sharded state tensor to this rank's shard, in
        place in `state`; a shard passes. -> the sharded names present."""
        names = []
        for n, sh in self.specs.items():
            v = state.get(n)
            if v is None:
                continue
            if tuple(v.shape) == sh.full and sh.factor > 1:
                state[n] = sh.cut(v)
            elif tuple(v.shape) != sh.shape():
                raise ValueError(
                    f"'{n}' holds {tuple(v.shape)}: neither its whole shape "
                    f"{sh.full} nor this rank's shard {sh.shape()}")
            names.append(n)
        return names

    def host_staged(self, device) -> bool:
        return device.type == "cuda" and self.mesh.backend != "nccl"


def _first_name(names):
    return names[0] if names else None


def _is_opt(op) -> bool:
    ins = op.desc.inputs
    return "Param" in ins and "Grad" in ins


class Spmd:
    """One step's sharded-run state (LoweringContext.spmd)."""

    def __init__(self, static: Static, sharded_names, marks):
        self.st = static
        self.mesh = static.mesh
        self.batch, self.nb, self.bi = static.batch, static.nb, static.bi
        split, rows_seen, local_rows = marks
        self.split: set = set(split)
        self.partial: set = set()
        self.rows_seen: set = set(rows_seen)
        self.local_rows: set = set(local_rows)
        self.sharded = set(sharded_names)     # state names holding shards
        self.shards: Dict[str, torch.Tensor] = {}
        self.full: Dict[str, torch.Tensor] = {}
        self.pending: Dict[str, Any] = {}     # grad name -> its Pending
        self.grad_cut: Dict[str, str] = {}    # grad name -> its param
        from . import overlap
        self.plan = overlap.plan(static.program)

    # --- helpers for lowerings ---------------------------------------------------
    def is_split(self, name: Optional[str]) -> bool:
        """Whether `name` is this rank's rows of a batch split over more
        than one rank: the lowerings' rules then reduce across ranks (over
        one rank they keep the one-device arithmetic, bitwise, while the
        gradient buckets and fetches still post their collectives)."""
        return self.nb > 1 and name is not None and name in self.split

    def slot_split(self, op_, slot: str) -> bool:
        names = op_.desc.inputs.get(slot) or []
        return bool(names) and self.is_split(names[0])

    def batch_sum(self, t, site="batch_sum"):
        """The global sum of a per-rank sum over the batch (differentiable,
        identity backward)."""
        return C.replicated_sum(t, self.mesh, self.batch, site=site)

    def batch_reduce(self, t, op="sum", site="batch_reduce"):
        return C.all_reduce(t, self.mesh, self.batch, op=op, site=site)

    def global_rows(self, local_rows: int, draw, dim: int = 0):
        """A random value of `local_rows` rows (along `dim`) as the
        one-device run draws it: `draw(global_rows)` then this rank's
        rows."""
        g = draw(local_rows * self.nb)
        return g.narrow(dim, self.bi * local_rows, local_rows)

    def expert_split(self, name: Optional[str]):
        """(axes, index, size) of an expert weight split on dim 0 alone
        (this rank holds experts [index * E / size, (index + 1) * E /
        size)); None otherwise."""
        sh = self.st.specs.get(name) if name else None
        if sh is None or not sh.dims or not sh.dims[0] or any(sh.dims[1:]):
            return None
        axes = sh.dims[0]
        return axes, self.mesh.axis_index(axes), self.mesh.axis_size(axes)

    def _complete_expert_grad(self, op, slot) -> bool:
        """Whether an expert op's W1/W2 gradient output is whole on its
        owner: its weight is split over every batch axis, so the tokens of
        every rank reached it (moe_ffn's dispatch) and no reduce over the
        batch is due."""
        base = slot[:-len("@GRAD")] if slot.endswith("@GRAD") else None
        if op.type not in EXPERT_OPS or base not in EXPERT_SLOTS:
            return False
        es = self.expert_split(_first_name(op.desc.inputs.get(base)))
        return es is not None and set(self.batch) <= set(es[0])

    def tp_weight(self, name: Optional[str]):
        """(kind, axes, index, size) of a weight split on a model axis:
        kind 'col' (dim 1) or 'row' (dim 0); None otherwise."""
        sh = self.st.specs.get(name) if name else None
        if sh is None or len(sh.full) != 2:
            return None
        d = sh.model_dim
        if d is None:
            return None
        axes = sh.dims[d]
        return ("col" if d == 1 else "row", axes,
                self.mesh.axis_index(axes), self.mesh.axis_size(axes))

    # --- around each op -----------------------------------------------------------
    def _reduced(self, name, v, why):
        """A partial value's all-reduce over the batch axes (a sparse
        gradient's rows and values gathered instead)."""
        from ..ops.common import SelectedRowsVal
        self.partial.discard(name)
        _bump(COUNTERS.reduces, why)
        if isinstance(v, SelectedRowsVal):
            rows = C.all_gather(v.rows, self.mesh, self.batch,
                                site="sparse_grad_all_gather")
            vals = C.all_gather(v.values, self.mesh, self.batch,
                                site="sparse_grad_all_gather")
            return SelectedRowsVal(rows, vals, v.height)
        return C.all_reduce(v, self.mesh, self.batch,
                            site="grad_all_reduce")

    def _wait(self, name, env):
        pend = self.pending[name]
        for g, v in zip(pend.names, pend.wait()):
            env[g] = v
            self.pending.pop(g, None)
        return env[name]

    def resolve(self, name, env, why="read", gather=True):
        """`name` as a reader sees it: a posted bucket waited on, a partial
        sum reduced, and (`gather`) a gradient cut to its shard gathered."""
        v = env.get(name)
        if name in self.pending:
            v = self._wait(name, env)
        if name in self.partial:
            v = env[name] = self._reduced(name, v, why)
        if gather and name in self.grad_cut and isinstance(v, torch.Tensor):
            sh = self.st.specs[self.grad_cut[name]]
            if tuple(v.shape) != sh.full:
                _bump(COUNTERS.gathers, name)
                v = sh.gather(v, site="grad_all_gather")
        return v

    def begin(self, env):
        """The step's sharded state, as the scope gave it (shards)."""
        for n in self.sharded:
            self.shards[n] = env[n]

    def _state_for(self, name, skip=frozenset()):
        """A sharded state value gathered whole (or whole but along the
        `skip` axes) for a reader; cached until the value is written."""
        key = (name, tuple(sorted(skip)))
        hit = self.full.get(key)
        if hit is not None:
            return hit
        _bump(COUNTERS.gathers, name)
        v = self.full[key] = self.st.specs[name].gather(self.shards[name],
                                                        skip)
        return v

    def prepare(self, op, ins, env):
        """The op's inputs as its lowering must see them."""
        t = op.type
        opt = _is_opt(op)
        is_grad = t.endswith("_grad")
        keep = t == "sum" and all(n in self.partial
                                  for n in op.desc.inputs.get("X", ()))
        out = {}
        for slot, names in op.desc.inputs.items():
            vals = list(ins.get(slot, []))
            cot = is_grad and slot.endswith("@GRAD")
            for i, n in enumerate(names):
                if n in self.pending or n in self.grad_cut or (
                        n in self.partial and not keep and not cot):
                    vals[i] = self.resolve(n, env, gather=not opt)
                if n in self.sharded:
                    if opt or (t in ("lookup_table", "lookup_table_grad")
                               and slot == "W") or (
                            t in EXPERT_OPS and slot in EXPERT_SLOTS
                            and self.expert_split(n) is not None):
                        vals[i] = self.shards[n]
                    elif t in ("mul", "mul_grad") and slot == "Y" and \
                            self.tp_weight(n) is not None:
                        vals[i] = self._state_for(n, MODEL_AXES)
                    else:
                        vals[i] = self._state_for(n)
            out[slot] = vals
        if opt:
            out = self._opt_inputs(op, out, env)
        for slot in ins:
            out.setdefault(slot, ins[slot])
        return out

    def _opt_inputs(self, op, ins, env):
        """An optimizer op on a sharded parameter: its gradient cut to the
        shard (a sparse one's rows kept where this rank owns them, rebased
        to its rows)."""
        from ..ops.common import SelectedRowsVal
        pnames = op.desc.inputs.get("Param", [])
        gnames = op.desc.inputs.get("Grad", [])
        grads = list(ins.get("Grad", []))
        for i, (p, g) in enumerate(zip(pnames, gnames)):
            sh = self.st.specs.get(p)
            v = grads[i]
            if sh is None or v is None:
                continue
            if isinstance(v, SelectedRowsVal):
                if sh.dims[0]:
                    n = sh.full[0] // self.mesh.axis_size(sh.dims[0])
                    lo = self.mesh.axis_index(sh.dims[0]) * n
                    own = (v.rows >= lo) & (v.rows < lo + n)
                    grads[i] = SelectedRowsVal(v.rows[own] - lo,
                                               v.values[own], n)
                continue
            if tuple(v.shape) != sh.shape():
                COUNTERS.cuts += 1
                grads[i] = sh.cut(v)
        ins["Grad"] = grads
        return ins

    def after(self, op, outs):
        """Classify the op's outputs: split, replicated or partial."""
        t = op.type
        in_names = [n for ns in op.desc.inputs.values() for n in ns]
        split_in = [n for n in in_names if n in self.split]
        partial_in = any(n in self.partial for n in in_names)
        opt = _is_opt(op)
        for slot, names in op.desc.outputs.items():
            for n, v in zip(names, outs.get(slot, [])):
                if v is None:
                    continue
                self.split.discard(n)
                self.partial.discard(n)
                self.grad_cut.pop(n, None)
                if n in self.sharded:
                    self.shards[n] = v
                    self.full = {k: f for k, f in self.full.items()
                                 if k[0] != n}
                if opt or not (split_in or partial_in) or \
                        self._complete_expert_grad(op, slot):
                    continue
                if split_in:
                    bd = self.st.batch_dim(n, self.rows_seen)
                    if bd is None:
                        # undeclared: rows of the batch when dim 0 counts
                        # whole multiples of this rank's rows (a per-row
                        # value of a [B * T, ...] view)
                        bd = isinstance(v, torch.Tensor) and v.dim() > 0 \
                            and any(v.shape[0] % k == 0 and v.shape[0] >= k
                                    for k in self.local_rows)
                    if bd:
                        self.split.add(n)
                    elif t.endswith("_grad") or "@GRAD" in n:
                        self.partial.add(n)
                    elif t not in RULED_OPS:
                        raise NotImplementedError(
                            f"op '{t}' reduces the batch-split input(s) "
                            f"{split_in} into '{n}' over the {self.nb} "
                            f"ranks of {self.batch}, and has no rule that "
                            f"all-reduces it (parallel/spmd.py RULED_OPS)")
                elif t.endswith("_grad") or t == "sum":
                    self.partial.add(n)

    def window(self, members, env):
        """Before a window that reads env itself: its members' sharded,
        partial and posted inputs resolved into env."""
        for m in members:
            opt = _is_opt(m)
            for names in m.desc.inputs.values():
                for n in names:
                    if n in self.pending or n in self.partial or \
                            n in self.grad_cut:
                        env[n] = self.resolve(n, env, gather=not opt)
                    if n in self.sharded and not opt:
                        env[n] = self._state_for(n)

    def after_window(self, members, env):
        for m in members:
            self.after(m, {slot: [env.get(n) for n in names]
                           for slot, names in m.desc.outputs.items()})

    # --- buckets --------------------------------------------------------------------
    def flush(self, bucket, env) -> bool:
        """Post a bucket's partial members' all-reduce over the batch axes;
        a sharded group's members are cut to the shard when waited on."""
        from ..ops.common import SelectedRowsVal
        names = [g for g in bucket.grads if g in self.partial
                 and isinstance(env.get(g), torch.Tensor)
                 and not isinstance(env.get(g), SelectedRowsVal)]
        if not names:
            return False
        tensors = [env[g] for g in names]
        dtypes = {t.dtype for t in tensors}
        if len(dtypes) > 1:
            tensors = [t.float() for t in tensors]
        pmap = dict(zip(bucket.grads, bucket.params))

        def post(i, t):
            p = pmap[names[i]]
            sh = self.st.specs.get(p)
            t = t.to(env_dtypes[i])
            if sh is not None:
                COUNTERS.cuts += 1
                self.grad_cut[names[i]] = p
                return sh.cut(t)
            return t
        env_dtypes = [env[g].dtype for g in names]
        pend = C.all_reduce_async(tensors, self.mesh, self.batch,
                                  site=bucket.site, post=post)
        pend.names = names
        for g in names:
            self.partial.discard(g)
            self.pending[g] = pend
        COUNTERS.buckets += 1
        return True

    def flush_range(self, ctx, env, lo, hi):
        if self.plan is not None and self.batch:
            self.plan.flush_range(ctx, env, lo, hi)

    # --- the step's end -------------------------------------------------------------
    def fetch(self, name, env):
        """A fetch as the one-device run returns it."""
        v = self.resolve(name, env, "fetch")
        if name in self.split and isinstance(v, torch.Tensor):
            return C.all_gather(v, self.mesh, self.batch, dim=0,
                                site="fetch_all_gather")
        sh = self.st.specs.get(self.st.grads.get(name, name))
        if sh is not None and isinstance(v, torch.Tensor) and \
                tuple(v.shape) != sh.full:
            return sh.gather(v, site="fetch_all_gather")
        return v

    def lengths(self, lens: Dict[str, torch.Tensor]):
        """Fetched sequences' lengths gathered as their rows."""
        if not self.batch:
            return lens
        return {n: (C.all_gather(v, self.mesh, self.batch, dim=0,
                                 site="fetch_all_gather")
                    if n.split("@SEQLEN")[0] in self.split or n in self.split
                    else v) for n, v in lens.items()}

    def finish(self, env):
        """Wait on every posted bucket, so no collective outlives the step."""
        while self.pending:
            self._wait(next(iter(self.pending)), env)

    def persist(self, name, env):
        """A persistable output as the scope keeps it: shards stay shards;
        a pending or partial value resolved."""
        if name in self.pending or name in self.partial:
            return self.resolve(name, env, "end")
        return env[name]


def gather_state(program, scope=None) -> Dict[str, torch.Tensor]:
    """{name: whole tensor} of each sharded state tensor of `program` the
    scope holds as a shard (every rank of the group must call it, in one
    order): what a checkpoint writes."""
    from ..executor import global_scope
    st = for_program(program)
    if st is None:
        return {}
    scope = scope if scope is not None else global_scope()
    out = {}
    for n, sh in st.specs.items():
        v = scope.find_var(n)
        if isinstance(v, torch.Tensor) and tuple(v.shape) == sh.shape() \
                and sh.factor > 1:
            out[n] = sh.gather(v)
    return out
