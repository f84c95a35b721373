"""Pipeline parallelism: a GPipe schedule over a 'pp' mesh axis (the port's
counterpart of paddle_tpu/parallel/pipeline.py).

Every rank of the axis runs the same stage function with ITS stage's
parameters; activations hop one rank per tick while microbatches stream in
(GPipe: M microbatches over P stages, M + P - 1 ticks, bubble fraction
(P - 1) / (M + P - 1)). Stage 0 injects microbatch t at tick t, stage P - 1
commits microbatch t - (P - 1), and the outputs are replicated at the end.

The JAX package runs every stage on every tick under one scan, the bubble
ticks on garbage, and ships each tick's activation with lax.ppermute over
the open perm [(i, i + 1) for i < P - 1]. Here a rank computes only on the
ticks where it holds a microbatch, and a hop is posted only where both of
its ranks do (`_collectives.pipe_exchange`): each link carries M tensors
each way. `gpipe` is one torch.autograd.Function: the forward keeps each
tick's graph, and the backward runs the schedule reversed, the cotangents
hopping right to left, each stage's parameter gradients summed over its
microbatches. The outputs' replication has the identity backward (each
rank's cotangent of the replicated outputs is the global one, and only
stage P - 1 computed them), so no gradient comes out P times too large.
Stages must share one structure (a homogeneous layer stack), the standard
GPipe setting.
"""

from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from . import _collectives as C

__all__ = ["gpipe", "gpipe_reference", "bubble_fraction"]


def bubble_fraction(p: int, m: int) -> float:
    """The GPipe schedule's idle share of a stage: (P - 1) / (M + P - 1)."""
    return (p - 1) / (m + p - 1)


def _stage_params(stacked_params, i):
    return pytree.tree_map(lambda a: a[i], stacked_params)


def gpipe_reference(stage_fn, stacked_params, x_microbatches):
    """Sequential oracle: apply stages 0..P-1 to every microbatch."""
    p = pytree.tree_leaves(stacked_params)[0].shape[0]
    outs = []
    for x in x_microbatches:
        h = x
        for i in range(p):
            h = stage_fn(_stage_params(stacked_params, i), h)
        outs.append(h)
    return torch.stack(outs)


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage_fn, spec, mesh, axis, xs, *leaves):
        p, idx = mesh.axis_size(axis), mesh.axis_index(axis)
        m = xs.shape[0]
        want_x = ctx.needs_input_grad[4]
        ctx.meta = (stage_fn, mesh, axis, p, idx, m, xs.shape, xs.dtype,
                    want_x)
        params = [t.detach().requires_grad_(t.is_floating_point())
                  for t in leaves]
        tree = pytree.tree_unflatten(params, spec)
        graphs = {}                  # microbatch -> (its input leaf, output)
        outs = torch.zeros_like(xs)
        recv = None
        like = xs[0]
        for t in range(m + p - 1):
            j = t - idx
            if 0 <= j < m:
                src = xs[j] if idx == 0 else recv
                with torch.enable_grad():
                    inp = src.detach().requires_grad_(idx > 0 or want_x)
                    h = stage_fn(tree, inp)
                graphs[j] = (inp, h)
                if idx == p - 1:
                    outs[j] = h.detach()
            # the hop to the next stage: microbatch j leaves this rank, and
            # microbatch t - (idx - 1) arrives from the previous one
            send = graphs[j][1].detach() if 0 <= j < m and idx < p - 1 \
                else None
            k = t - (idx - 1)
            want = like if idx > 0 and 0 <= k < m and t < m + p - 2 \
                else None
            recv = C.pipe_exchange(send, want, mesh, axis, True,
                                   site="pipe_send")
        ctx.graphs, ctx.params = graphs, params
        # only the last stage holds the outputs: its sum over the axis
        # replicates them (the identity backward is this Function's own)
        return C.all_reduce(outs if idx == p - 1 else torch.zeros_like(outs),
                            mesh, axis, site="pipe_replicate")

    @staticmethod
    def backward(ctx, g_outs):
        stage_fn, mesh, axis, p, idx, m, shape, dtype, want_x = ctx.meta
        graphs, params = ctx.graphs, ctx.params
        acc = [None] * len(params)
        g_xs = torch.zeros(shape, dtype=dtype, device=g_outs.device) \
            if want_x else None
        recv = None
        like = g_outs[0]
        for t in range(m + p - 1):
            # reversed: stage P - 1 takes microbatch M - 1 first
            j = m - 1 - (t - (p - 1 - idx))
            g_in = None
            if 0 <= j < m:
                g_h = g_outs[j] if idx == p - 1 else recv
                inp, h = graphs.pop(j)
                ins = [inp] if inp.requires_grad else []
                leaves = ins + [q for q in params if q.requires_grad]
                grads = torch.autograd.grad(h, leaves, g_h.to(h.dtype),
                                            allow_unused=True)
                g_in = grads[0] if ins else None
                gi = iter(grads[len(ins):])
                for n, q in enumerate(params):
                    if not q.requires_grad:
                        continue
                    g = next(gi)
                    if g is not None:
                        acc[n] = g if acc[n] is None else acc[n] + g
                if idx == 0 and want_x:
                    g_xs[j] = g_in
            send = g_in if 0 <= j < m and idx > 0 else None
            k = m - 1 - (t - (p - 1 - (idx + 1)))
            want = like if idx < p - 1 and 0 <= k < m and t < m + p - 2 \
                else None
            recv = C.pipe_exchange(send, want, mesh, axis, False,
                                   site="pipe_send_bwd")
        if want_x:
            # the microbatches are replicated in: every rank's cotangent
            # of them is stage 0's
            g_xs = C.all_reduce(g_xs, mesh, axis, site="pipe_replicate_bwd")
        grads = [torch.zeros_like(q) if a is None and q.requires_grad
                 else a for q, a in zip(params, acc)]
        return (None, None, None, None, g_xs, *grads)


def gpipe(stage_fn, stacked_params, x_microbatches, mesh, axis: str = "pp"):
    """Run `stage_fn(params_i, h) -> h` as a P-stage pipeline over the
    ranks of `axis`.

    stacked_params: a pytree whose leaves stack the per-stage parameters on
    a leading axis of size P (this rank takes its stage's slice, so its
    gradient lands in that slice alone), or of size 1 (this rank's stage
    alone). x_microbatches: [M, B, ...] microbatches, replicated in (only
    stage 0 reads them). Returns [M, B, ...] final-stage outputs,
    replicated out. Differentiable with torch autograd. With no process
    group (one rank) the axis has size 1 and the one stage runs."""
    p, idx = mesh.axis_size(axis), mesh.axis_index(axis)
    leaves, spec = pytree.tree_flatten(stacked_params)
    local = []
    for a in leaves:
        if a.shape[0] == p:
            local.append(a[idx])
        elif a.shape[0] == 1:
            local.append(a[0])
        else:
            raise ValueError(f"a stacked parameter of shape {tuple(a.shape)} "
                             f"has neither {p} stages nor 1 on its axis 0")
    if p == 1:
        return torch.stack([stage_fn(pytree.tree_unflatten(local, spec), x)
                            for x in x_microbatches])
    return _GPipe.apply(stage_fn, spec, mesh, axis, x_microbatches, *local)
