"""Collectives over a mesh's sub-groups (the port's counterpart of
paddle_tpu/parallel/_collectives.py).

Two families:

  * The ring's: a ring shift and the split and gather of a sequence axis,
    each a torch.autograd.Function whose backward is its transpose
    (`ppermute`, `shard_seq`, `all_gather_seq`).
  * The pipeline's and the experts': `pipe_exchange`, the open one-hop
    shift of lax.ppermute with perm [(i, i + 1) for i < P - 1] (the first
    rank receives nothing, the last sends nothing; parallel/pipeline.py
    posts it and its transpose itself), and the differentiable
    `scatter_sum` / `gather_cat` (a reduce-scatter and an all-gather along
    a dim, each the other's transpose) and `grad_sum` (the identity whose
    backward sums over the ranks) with which moe_ffn dispatches tokens to
    the experts' owners (ops/nn_ops.py).
  * The sharded run's (parallel/spmd.py): `all_reduce`, `all_gather`,
    `reduce_scatter` and `broadcast` over an axis or a tuple of axes of a
    mesh, each under the JAX package's `pd.coll.<site>` profiler range;
    `all_reduce_async` posts a bucket of tensors and hands back a
    `Pending` to wait on; `replicated_sum` is the all-reduce of a value a
    rank computed from its rows of the batch, whose backward is the
    identity (each rank's rows take the replicated cotangent as it is).

Every rank of the sub-group posts the same collectives in the same order,
with tensors of one shape. With no process group (the mesh of one process)
each is the identity. On a gloo group a CUDA tensor is staged through
pinned host memory explicitly, counted in `COUNTERS.host_staged` by
collective (gloo moves host memory only); a bf16 tensor is summed in f32
there and gathered as its 16-bit pattern.

The cross-process helpers `host_allreduce_sum` and
`process_allgather_bytes` (JAX `:47`, `:73`) ride torch.distributed's
object collectives on the default group.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["coll_scope", "ppermute", "shard_seq", "all_gather_seq",
           "all_reduce", "all_reduce_async", "all_gather", "reduce_scatter",
           "broadcast", "replicated_sum", "Pending", "COUNTERS",
           "pipe_exchange", "scatter_sum", "gather_cat", "grad_sum",
           "host_allreduce_sum", "process_allgather_bytes"]


class Counters:
    """calls: collectives posted, by site; host_staged: tensors staged
    through pinned host memory for a gloo group, by collective;
    staged_bytes: their bytes, each way; seconds: the host's wall time
    inside the collectives (staging, posting and waiting), by
    collective."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.calls: Dict[str, int] = {}
        self.host_staged: Dict[str, int] = {}
        self.staged_bytes = 0
        self.seconds: Dict[str, float] = {}


COUNTERS = Counters()


def coll_scope(site: str):
    """A profiler range tagging a collective call site as
    'pd.coll.<site>', the JAX package's scope name."""
    return torch.profiler.record_function(f"pd.coll.{site}")


def _count(site: str):
    COUNTERS.calls[site] = COUNTERS.calls.get(site, 0) + 1


class _timed:
    """Adds the wall time of its body to COUNTERS.seconds[what]."""

    def __init__(self, what):
        self.what = what

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        COUNTERS.seconds[self.what] = COUNTERS.seconds.get(self.what, 0.0) \
            + time.perf_counter() - self.t0


def _axis(mesh, axis) -> Tuple[int, int]:
    """(size, index) of this rank on `axis` (a name or a tuple)."""
    return mesh.axis_size(axis), mesh.axis_index(axis)


def _staged(mesh, t: torch.Tensor) -> bool:
    return t.is_cuda and mesh.backend != "nccl"


class _Stage:
    """A tensor as its collective sees it: on a gloo group a CUDA tensor
    goes to pinned host memory (bf16 widened to f32 for a sum, or viewed as
    int16 for a move), and `back` returns the result on the tensor's own
    device and in its own dtype."""

    def __init__(self, mesh, t: torch.Tensor, what: str, reduce: bool):
        self.device, self.dtype = t.device, t.dtype
        self.reduce = reduce
        x = t.contiguous()
        if x.dtype == torch.bfloat16 and mesh.backend != "nccl" \
                and mesh.group is not None:
            # gloo has no bf16: a sum in f32, a move as the same 16 bits
            # under a dtype it knows
            x = x.float() if reduce else x.view(torch.float16)
        if _staged(mesh, x):
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            host.copy_(x)
            COUNTERS.host_staged[what] = COUNTERS.host_staged.get(what, 0) + 1
            COUNTERS.staged_bytes += host.numel() * host.element_size()
            x = host
        self.t = x

    def back(self, r: torch.Tensor) -> torch.Tensor:
        if r.device != self.device:
            r = r.to(self.device, non_blocking=False)
        if r.dtype != self.dtype:
            r = r.view(self.dtype) if r.dtype == torch.float16 \
                and self.dtype == torch.bfloat16 else r.to(self.dtype)
        return r


_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN}


def all_reduce(x: torch.Tensor, mesh, axes, op: str = "sum",
               site: str = "all_reduce") -> torch.Tensor:
    """The elementwise reduction of `x` over the ranks of `axes`, as a new
    tensor on every one of them."""
    grp, _ = mesh.group_of(axes)
    if grp is None:
        return x
    _count(site)
    with coll_scope(site), _timed("all_reduce"):
        st = _Stage(mesh, x, "all_reduce", True)
        buf = st.t if st.t is not x else x.clone()
        dist.all_reduce(buf, op=_REDUCE_OPS[op], group=grp)
        return st.back(buf)


class Pending:
    """A posted bucket: `wait()` -> the reduced tensors, each in its
    member's shape, dtype and device."""

    def __init__(self, work, stage, flat, members, post=None):
        self.work, self.stage, self.flat = work, stage, flat
        self.members, self.post = members, post
        self._out = None

    def wait(self) -> List[torch.Tensor]:
        if self._out is None:
            with _timed("bucket_wait"):
                if self.work is not None:
                    self.work.wait()
                flat = self.stage.back(self.flat) if self.stage \
                    else self.flat
            out, off = [], 0
            for shape, dtype in self.members:
                n = math.prod(shape)
                out.append(flat[off:off + n].reshape(shape).to(dtype))
                off += n
            self._out = [self.post(i, t) for i, t in enumerate(out)] \
                if self.post else out
        return self._out


def all_reduce_async(tensors: Sequence[torch.Tensor], mesh, axes,
                     site: str, post=None) -> Pending:
    """Post one all-reduce (sum) of `tensors` flattened into one buffer of
    their common dtype, asynchronously; `Pending.wait()` unflattens them.
    `post(i, t)` maps member i's reduced tensor on wait."""
    grp, _ = mesh.group_of(axes)
    members = [(tuple(t.shape), t.dtype) for t in tensors]
    flat = torch.cat([t.reshape(-1) for t in tensors])
    if grp is None:
        return Pending(None, None, flat, members, post)
    _count(site)
    with coll_scope(site), _timed("bucket_post"):
        st = _Stage(mesh, flat, "all_reduce", True)
        buf = st.t if st.t is not flat else flat
        # under CUDA graph capture the collective is a node of the graph,
        # ordered on the capturing stream
        capturing = buf.is_cuda and torch.cuda.is_current_stream_capturing()
        work = dist.all_reduce(buf, group=grp, async_op=not capturing)
    return Pending(work, st, buf, members, post)


def all_gather(x: torch.Tensor, mesh, axes, dim: int = 0,
               site: str = "all_gather") -> torch.Tensor:
    """The ranks' tensors of `axes` concatenated along `dim` in the order
    of their coordinates."""
    grp, ranks = mesh.group_of(axes)
    if grp is None:
        return x
    _count(site)
    with coll_scope(site), _timed("all_gather"):
        st = _Stage(mesh, x, "all_gather", False)
        parts = [torch.empty_like(st.t) for _ in ranks]
        dist.all_gather(parts, st.t, group=grp)
        group_order = sorted(ranks)
        parts = [parts[group_order.index(r)] for r in ranks]
        return st.back(torch.cat(parts, dim=dim))


def _narrow(x, mesh, axis, dim):
    n, i = _axis(mesh, axis)
    size = x.shape[dim] // n
    return x.narrow(dim, i * size, size)


def reduce_scatter(x: torch.Tensor, mesh, axes, dim: int = 0,
                   site: str = "reduce_scatter") -> torch.Tensor:
    """The sum of `x` over the ranks of `axes`, cut along `dim` to this
    rank's part: NCCL's reduce-scatter where the cut is along dim 0, else
    (and on gloo, which has none) an all-reduce and a narrow."""
    grp, ranks = mesh.group_of(axes)
    if grp is None:
        return x
    n, i = _axis(mesh, axes)
    if mesh.backend == "nccl" and dim == 0 and \
            list(ranks) == sorted(ranks):
        _count(site)
        with coll_scope(site), _timed("reduce_scatter"):
            out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                              dtype=x.dtype, device=x.device)
            dist.reduce_scatter_tensor(out, x.contiguous(), group=grp)
            return out
    return _narrow(all_reduce(x, mesh, axes, site=site), mesh, axes,
                   dim).contiguous()


def broadcast(x: torch.Tensor, mesh, axes, src_index: int = 0,
              site: str = "broadcast") -> torch.Tensor:
    """Rank `src_index` of `axes`' tensor on every rank of them."""
    grp, ranks = mesh.group_of(axes)
    if grp is None:
        return x
    _count(site)
    with coll_scope(site), _timed("broadcast"):
        st = _Stage(mesh, x, "broadcast", False)
        buf = st.t if st.t is not x else x.clone()
        dist.broadcast(buf, src=ranks[src_index], group=grp)
        return st.back(buf)


class _ReplicatedSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, site):
        return all_reduce(x, mesh, axes, site=site)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


def replicated_sum(x: torch.Tensor, mesh, axes,
                   site: str = "batch_sum") -> torch.Tensor:
    """The sum over the ranks of `axes` of a value each computed from its
    own rows of the batch: the global value, on every rank. Its backward
    is the identity: the cotangent of the global value is replicated, and
    each rank's contribution takes it whole."""
    return _ReplicatedSum.apply(x, mesh, axes, site)


# --- the pipeline's and the experts' collectives -----------------------------

def pipe_exchange(send, recv_like, mesh, axis, forward=True,
                  site="pipe_send"):
    """One tick of the open shift along `axis` (lax.ppermute with perm
    [(i, i + 1) for i < P - 1], or its transpose with `forward` False):
    post `send` (a tensor, or None when this rank sends nothing this tick)
    to the next rank (the previous one when not `forward`) and receive a
    tensor shaped and typed as `recv_like` (None: receive nothing) from
    the other side, in one batch of P2P ops. -> the received tensor, or
    None. The caller decides who is active; the two ranks of a hop agree.
    On a gloo group a CUDA tensor is staged through pinned host memory,
    counted in COUNTERS.host_staged['pipe'], and each tensor sent is
    counted in COUNTERS.calls[site]."""
    n, i = _axis(mesh, axis)
    grp, ranks = mesh.group_of(axis)
    step = 1 if forward else -1
    ops, box = [], None
    with coll_scope(site), _timed("pipe"):
        if send is not None:
            if not 0 <= i + step < n:
                raise ValueError(f"rank {i} of {axis!r} has no rank "
                                 f"{i + step} to send to")
            st = _Stage(mesh, send, "pipe", False)
            ops.append(dist.P2POp(dist.isend, st.t, ranks[i + step], grp))
            _count(site)
        if recv_like is not None:
            if not 0 <= i - step < n:
                raise ValueError(f"rank {i} of {axis!r} has no rank "
                                 f"{i - step} to receive from")
            box = _RecvBox(mesh, recv_like)
            ops.append(dist.P2POp(dist.irecv, box.t, ranks[i - step], grp))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return None if box is None else box.back()


class _RecvBox:
    """The buffer a P2P receive lands in: pinned host memory for a CUDA
    tensor on a gloo group (bf16 as its 16 bits), else the device's."""

    def __init__(self, mesh, like):
        self.device, self.dtype = like.device, like.dtype
        gloo = mesh.backend != "nccl"
        dtype = torch.float16 if like.dtype == torch.bfloat16 and gloo \
            else like.dtype
        if _staged(mesh, like):
            self.t = torch.empty(like.shape, dtype=dtype, pin_memory=True)
            COUNTERS.host_staged["pipe"] = \
                COUNTERS.host_staged.get("pipe", 0) + 1
            COUNTERS.staged_bytes += self.t.numel() * self.t.element_size()
        else:
            self.t = torch.empty(like.shape, dtype=dtype, device=like.device)

    def back(self):
        r = self.t.to(self.device) if self.t.device != self.device \
            else self.t
        return r.view(self.dtype) if r.dtype != self.dtype else r


class _ScatterSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim, site):
        ctx.mesh, ctx.axes, ctx.dim, ctx.site = mesh, axes, dim, site
        return reduce_scatter(x, mesh, axes, dim=dim, site=site)

    @staticmethod
    def backward(ctx, g):
        return (all_gather(g.contiguous(), ctx.mesh, ctx.axes, dim=ctx.dim,
                           site=ctx.site + "_bwd"), None, None, None, None)


class _GatherCat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim, site):
        ctx.mesh, ctx.axes, ctx.dim, ctx.site = mesh, axes, dim, site
        return all_gather(x.contiguous(), mesh, axes, dim=dim, site=site)

    @staticmethod
    def backward(ctx, g):
        return (reduce_scatter(g.contiguous(), ctx.mesh, ctx.axes,
                               dim=ctx.dim, site=ctx.site + "_bwd"),
                None, None, None, None)


class _GradSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, site):
        ctx.mesh, ctx.axes, ctx.site = mesh, axes, site
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (all_reduce(g.contiguous(), ctx.mesh, ctx.axes,
                           site=ctx.site), None, None, None)


def scatter_sum(x, mesh, axes, dim=0, site="expert_scatter"):
    """The sum of `x` over the ranks of `axes`, cut along `dim` to this
    rank's part (reduce_scatter), differentiable: the backward gathers
    the parts' cotangents along `dim`."""
    if mesh.group_of(axes)[0] is None:
        return x
    return _ScatterSum.apply(x, mesh, axes, dim, site)


def gather_cat(x, mesh, axes, dim=0, site="expert_gather"):
    """The ranks' parts of `axes` concatenated along `dim` (all_gather),
    differentiable: the backward sums the cotangents over the ranks and
    keeps this rank's part (the transpose of a gather of distinct
    parts)."""
    if mesh.group_of(axes)[0] is None:
        return x
    return _GatherCat.apply(x, mesh, axes, dim, site)


def grad_sum(x, mesh, axes, site="expert_grad_sum"):
    """`x` as it is, whose cotangent is summed over the ranks of `axes`:
    the input side of a computation each rank does part of (Megatron's
    f), the transpose of `replicated_sum`."""
    if mesh.group_of(axes)[0] is None:
        return x
    return _GradSum.apply(x, mesh, axes, site)


# --- the ring's collectives ----------------------------------------------------

def _shift(xs, mesh, axis, shift):
    """Send each tensor of `xs` to the rank `shift` ahead on the ring and
    receive the one from `shift` behind, in one batch of P2P ops."""
    n, i = _axis(mesh, axis)
    grp, ranks = mesh.group_of(axis)
    dst, src = ranks[(i + shift) % n], ranks[(i - shift) % n]
    outs, ops = [], []
    for x in xs:
        x = x.contiguous()
        buf = torch.empty_like(x)
        ops += [dist.P2POp(dist.isend, x, dst, grp),
                dist.P2POp(dist.irecv, buf, src, grp)]
        outs.append(buf)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, shift, *xs):
        ctx.mesh, ctx.axis, ctx.shift = mesh, axis, shift
        return tuple(_shift(xs, mesh, axis, shift))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, None,
                *_shift(gs, ctx.mesh, ctx.axis, -ctx.shift))


def ppermute(xs, mesh, axis: str, shift: int = 1):
    """The ring shift of lax.ppermute with perm [(i, i + shift)]: every rank
    sends each tensor of `xs` (a tensor or a tuple) `shift` ranks ahead
    along `axis` and receives the one `shift` behind. Differentiable: the
    backward shifts the cotangents back."""
    single = isinstance(xs, torch.Tensor)
    xs = (xs,) if single else tuple(xs)
    if mesh.axis_size(axis) == 1:
        out = xs
    else:
        out = _PPermute.apply(mesh, axis, shift, *xs)
    return out[0] if single else tuple(out)


def _gather(x, mesh, axis, dim):
    grp, ranks = mesh.group_of(axis)
    parts = [torch.empty_like(x) for _ in ranks]
    dist.all_gather(parts, x.contiguous(), group=grp)
    order = sorted(ranks)
    return torch.cat([parts[order.index(r)] for r in ranks], dim=dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (_narrow(g, ctx.mesh, ctx.axis, ctx.dim).contiguous(), None,
                None, None)


class _Shard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _narrow(x, mesh, axis, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


def all_gather_seq(x, mesh, axis: str = "sp", dim: int = 1):
    """The global tensor from every rank's shard along `dim` (rank order).
    Its backward takes this rank's slice of the cotangent, which every rank
    holds whole: the program is global-view."""
    if mesh.axis_size(axis) == 1:
        return x
    with coll_scope("seq_all_gather"):
        return _AllGather.apply(x, mesh, axis, dim)


def shard_seq(x, mesh, axis: str = "sp", dim: int = 1):
    """This rank's shard of a global tensor along `dim` (size / P rows at
    index * size / P). Its backward gathers the shards' cotangents into the
    global one, so every rank ends with the whole gradient."""
    if mesh.axis_size(axis) == 1:
        return x
    if x.shape[dim] % mesh.axis_size(axis):
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over "
                         f"the {mesh.axis_size(axis)} ranks of {axis!r}")
    return _Shard.apply(x, mesh, axis, dim)


# --- cross-process helpers (JAX _collectives.py:47, :73) -----------------------

def host_allreduce_sum(values) -> np.ndarray:
    """Elementwise sum of a same-shaped array across every process of the
    default group (float64); this process's values alone without one."""
    local = np.asarray(values, dtype=np.float64)
    if not dist.is_initialized() or dist.get_world_size() <= 1:
        return local
    parts = [None] * dist.get_world_size()
    with coll_scope("host_allreduce"):
        dist.all_gather_object(parts, local)
    return np.sum(np.stack([np.asarray(p) for p in parts]), axis=0)


def process_allgather_bytes(payload: bytes) -> list:
    """One bytes payload per process, in rank order, over the default
    group's object collective (the JAX package's coordination-service
    key-value path)."""
    if not dist.is_initialized() or dist.get_world_size() <= 1:
        return [payload]
    parts = [None] * dist.get_world_size()
    with coll_scope("host_allgather"):
        dist.all_gather_object(parts, bytes(payload))
    return list(parts)
