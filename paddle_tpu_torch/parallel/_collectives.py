"""The collectives of the ring (the port's counterpart of
paddle_tpu/parallel/_collectives.py): a ring shift and the split and
gather of a sequence axis, each a torch.autograd.Function whose backward
is its transpose, over torch.distributed.

Every rank must post the same collectives in the same order; each function
here is called by every rank of the mesh axis with tensors of one shape.
On a mesh axis of size 1 each is the identity and touches no process
group. An axis must span the whole group (a 1-D mesh, or one whose other
axes have size 1): sub-groups for N-D meshes come with the rest of
`parallel/` (ROADMAP Queue 1, slice 9). The JAX module's cross-host
reduces and key-value helpers are not on the ring's path and are not
ported.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

__all__ = ["coll_scope", "ppermute", "shard_seq", "all_gather_seq"]


def coll_scope(site: str):
    """A profiler range tagging a collective call site as
    'pd.coll.<site>', the JAX package's scope name."""
    return torch.profiler.record_function(f"pd.coll.{site}")


def _axis(mesh, axis: str) -> Tuple[int, int]:
    """(size, index) of this rank on `axis`, checking the axis spans the
    group."""
    n = mesh.axis_size(axis)
    if n != mesh.size:
        raise NotImplementedError(
            f"collectives over axis {axis!r} of a mesh of shape {mesh.shape}: "
            f"only an axis that spans every rank is supported")
    return n, mesh.axis_index(axis)


def _shift(xs, mesh, axis, shift):
    """Send each tensor of `xs` to the rank `shift` ahead on the ring and
    receive the one from `shift` behind, in one batch of P2P ops."""
    n, i = _axis(mesh, axis)
    dst, src = (i + shift) % n, (i - shift) % n
    outs, ops = [], []
    for x in xs:
        x = x.contiguous()
        buf = torch.empty_like(x)
        ops += [dist.P2POp(dist.isend, x, dst, mesh.group),
                dist.P2POp(dist.irecv, buf, src, mesh.group)]
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
    n, _ = _axis(mesh, axis)
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group)
    return torch.cat(parts, dim=dim)


def _narrow(x, mesh, axis, dim):
    n, i = _axis(mesh, axis)
    size = x.shape[dim] // n
    return x.narrow(dim, i * size, size)


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
