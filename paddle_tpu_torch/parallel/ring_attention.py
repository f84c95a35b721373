"""Ring attention: sequence parallelism over the 'sp' axis of a mesh (the
port's counterpart of paddle_tpu/parallel/ring_attention.py).

The sequence axis is split over the ranks of the axis: each rank keeps its
query shard resident and the key/value shards rotate around the ring
(`_collectives.ppermute`), each visiting shard attended and merged into
the running online-softmax state (acc, l, m). Scores of the whole sequence
never exist. Per shard, the flash ring runs K10 (the unnormalized flash
block, ops/attention_cuda.flash_attention_block) forward and K8 + K9
(flash_attention_bwd_block) backward; the einsum ring (`_block_attn`) is
the reference's own fallback for shard shapes that do not tile.

Global view. The JAX package's ops see global tensors and shard_map splits
T over 'sp' inside the op; the port keeps that contract across ranks: each
rank holds the same global q, k, v, takes its T/P shard (`shard_seq`),
runs the ring, and gathers Out and LSE (`all_gather_seq`); the backward
gathers dQ, dK, dV the same way. On a mesh of one rank (the one-card path)
the ring has one step and no collective runs.

Precision. The merge carries (acc, l, m) in f32 whatever q's dtype; O is
rounded to q's dtype once, after acc / max(l, 1e-30), and LSE stays f32.
The reference carries them in q's dtype and rounds each block's f32
statistics to it, which under AMP O2 (bf16) puts its LSE up to ~0.06 off
(ROADMAP Queue 3); in f32 the two are the same computation.
"""

from __future__ import annotations

import math

import torch

from ..ops import attention_cuda as A
from ..ops.attention_cuda import (_scaled_masked_logits, attention_reference,
                                  attention_reference_lse)
from ._collectives import all_gather_seq, coll_scope, ppermute, shard_seq

__all__ = ["attention_reference", "attention_reference_lse", "ring_attention",
           "ring_step", "ring_finish", "ring_init", "ring_attention_sharded",
           "ring_attention_bwd_sharded", "flash_ring_eligible"]

_NEG = -1e30       # the flash block's "no key seen" row max
# the fallback reason of a flash ring whose shards do not tile, counted in
# attention_cuda.COUNTERS beside the Hopper gate's reasons
SHARD_SHAPE = "shard_shape"


def _block_attn(q, k, v, scale, mask):
    """Unnormalized blockwise attention in the operands' dtype (the einsum
    ring's block): (acc [B, Tq, H, D], row_sum, row_max, valid [B, H, Tq]).
    A row the mask wholly hides has row_max 0 and valid False."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, float("-inf"))
    m = logits.amax(-1)
    valid = torch.isfinite(m)
    # an all-masked row's max is -inf; exp(-inf - -inf) would be NaN
    m_safe = torch.where(valid, m, torch.zeros_like(m))
    p = torch.exp(logits - m_safe[..., None])
    acc = torch.einsum("bhqk,bkhd->bqhd", p, v)
    return acc, p.sum(-1), m_safe, valid


def ring_init(q):
    """The merge's starting state for resident q [B, T, H, D]: (acc, l, m)
    f32, m = -1e30 (no key seen; finite, so the first merge's rescale is
    exp(-1e30 - m) = 0 and never NaN)."""
    b, t, h, d = q.shape
    return (torch.zeros((b, t, h, d), dtype=torch.float32, device=q.device),
            torch.zeros((b, h, t), dtype=torch.float32, device=q.device),
            torch.full((b, h, t), _NEG, dtype=torch.float32, device=q.device))


def ring_step(state, q, k, v, q_off, k_off, scale, causal, flash=True):
    """One step of the ring: attend resident q to the visiting (k, v) shard
    at global offsets (q_off, k_off) and merge into `state` (acc, l, m) in
    f32. flash: K10's wrapper (its plain version on CPU tensors); else the
    einsum block. A row the visiting block leaves invalid does not move the
    state: its rescale of the old state is 1 and its own weight exp(-inf)
    = 0."""
    acc, l_acc, m_acc = state
    if flash:
        acc_b, l_b, m_b = A.flash_attention_block(q, k, v, q_off, k_off,
                                                  scale, causal)
        valid = m_b > -5e29
        m_b = torch.where(valid, m_b, torch.zeros_like(m_b))
    else:
        mask = None
        if causal:
            qpos = q_off + torch.arange(q.shape[1], device=q.device)
            kpos = k_off + torch.arange(k.shape[1], device=q.device)
            mask = qpos[:, None] >= kpos[None, :]
        acc_b, l_b, m_b, valid = _block_attn(q, k, v, scale, mask)
    acc_b, l_b, m_b = acc_b.float(), l_b.float(), m_b.float()
    m_new = torch.where(valid, torch.maximum(m_acc, m_b), m_acc)
    alpha = torch.exp(m_acc - m_new)
    # mask the exponent, not the value: where(valid, exp(big), 0) would
    # still form an inf whose gradient is 0 * inf = NaN
    beta = torch.exp(torch.where(valid, m_b - m_new,
                                 torch.full_like(m_new, float("-inf"))))
    acc = acc * alpha.transpose(1, 2)[..., None] + \
        acc_b * beta.transpose(1, 2)[..., None]
    return acc, l_acc * alpha + l_b * beta, m_new


def ring_finish(state, dtype):
    """(O in `dtype`, LSE [B, H, T] f32) from the merged state: O = acc /
    max(l, 1e-30) rounded once, LSE = m + log(max(l, 1e-30))."""
    acc, l, m = state
    denom = torch.clamp(l, min=1e-30)
    return (acc / denom.transpose(1, 2)[..., None]).to(dtype), \
        m + torch.log(denom)


def ring_attention(q, k, v, mesh, axis="sp", causal=False, scale=None,
                   use_flash=False, return_lse=False):
    """Attention over a sequence split on `axis`: q, k, v are this rank's
    shards [B, T/P, H, D]; returns its output shard (and, with return_lse,
    the f32 logsumexp [B, H, T/P]). P steps: attend, merge, rotate K/V one
    rank ahead. The global key offset of step s is that of shard (index -
    s) mod P, computed rather than sent."""
    n, idx = mesh.axis_size(axis), mesh.axis_index(axis)
    t = q.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    state = ring_init(q)
    for s in range(n):
        state = ring_step(state, q, k, v, idx * t, ((idx - s) % n) * t, scale,
                          causal, use_flash)
        if s + 1 < n:
            with coll_scope("ring_kv_rotate"):
                k, v = ppermute((k, v), mesh, axis)
    out, lse = ring_finish(state, q.dtype)
    return (out, lse) if return_lse else out


def _ring_bwd_local(q, k, v, do, o, lse, mesh, axis, causal, scale):
    """The flash ring backward on this rank's shards: the forward's ring
    schedule, each step the (dQ, dK, dV) blocks of resident Q against the
    visiting K/V shard (K8 + K9; their plain versions on CPU tensors). dQ
    accumulates in f32 at home; the dK and dV accumulators (f32) rotate
    with their K/V shard and are home after P hops."""
    n, idx = mesh.axis_size(axis), mesh.axis_index(axis)
    t = q.shape[1]
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for s in range(n):
        dq_b, dk_b, dv_b = A.flash_attention_bwd_block(
            q, k, v, do, lse, delta, idx * t, ((idx - s) % n) * t, scale,
            causal)
        dq += dq_b.float()
        dk += dk_b.float()
        dv += dv_b.float()
        with coll_scope("ring_bwd_rotate"):
            if s + 1 < n:
                k, v, dk, dv = ppermute((k, v, dk, dv), mesh, axis)
            else:
                dk, dv = ppermute((dk, dv), mesh, axis)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_ring_eligible(q, mesh, axis="sp") -> bool:
    """Static check from shapes alone: does the flash ring run for global
    q [B, T, H, D] on this mesh? T splits evenly over the axis and the
    shard passes the reference's block rule. The forward op and its grad
    op both ask, so the backward never re-runs the forward to find out."""
    n = mesh.axis_size(axis)
    if q.shape[1] % n:
        return False
    shard = torch.empty((q.shape[0], q.shape[1] // n) + tuple(q.shape[2:]),
                        device="meta")
    return A.block_supports(shard, shard)


def _gate(q, k, v, op):
    """The Hopper gate on the flash ring's operands, counted under `op` as
    a hit or, on CPU tensors, a fallback by reason (the wrappers compute
    the plain versions there). CUDA operands the gate refuses raise before
    anything runs: the plain versions form [B, H, T/P, T] f32 scores per
    block, the memory the ring exists to avoid (34 GB a layer at T 32768),
    and the kernels have no f32 form yet. Run the ring on the card under
    AMP O2, or on CPUPlace."""
    reason = A.ineligible(q, k, v)
    if reason is None:
        A.count_hit(op)
        return
    if q.device.type != "cpu":
        raise ValueError(
            f"{op}: the flash ring on a CUDA device needs bf16 q, k, v with "
            f"a head_dim that is a multiple of 16 up to 128 (AMP O2); "
            f"refused for {reason}: {tuple(q.shape)} {q.dtype}. The kernels "
            f"have no f32 form, and the plain versions would form the whole "
            f"[B, H, T/P, T] f32 scores the ring exists to avoid")
    A.count_fallback(op, reason)


def _flash_ring_fwd(q, k, v, mesh, axis, causal):
    ql, kl, vl = (shard_seq(x, mesh, axis) for x in (q, k, v))
    out, lse = ring_attention(ql, kl, vl, mesh, axis, causal,
                              use_flash=True, return_lse=True)
    return (all_gather_seq(out, mesh, axis, 1),
            all_gather_seq(lse.contiguous(), mesh, axis, 2))


class _FlashRing(torch.autograd.Function):
    """ring_attention_sharded's custom_vjp (ring_attention.py:308-323): the
    forward saves (q, k, v, O, LSE); the backward is the direct flash ring
    backward from them, with no forward re-run."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, axis, causal):
        with torch.no_grad():
            out, lse = _flash_ring_fwd(q, k, v, mesh, axis, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (mesh, axis, causal)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        mesh, axis, causal = ctx.args
        dq, dk, dv = _bwd_sharded(q, k, v, g.to(q.dtype), out, lse, mesh,
                                  axis, causal, None)
        return dq, dk, dv, None, None, None


def ring_attention_sharded(q, k, v, mesh, axis="sp", causal=False,
                           use_flash=False, return_lse=False,
                           op="ring_attention"):
    """Global q, k, v [B, T, H, D] through the ring over `axis` (T must
    split evenly). use_flash=True runs the flash ring where the shard
    shapes tile (`flash_ring_eligible`): K10 per block forward and, through
    this call's autograd, the direct flash ring backward (K8 + K9); CPU
    tensors take their plain versions, and CUDA tensors the Hopper gate
    refuses raise (`_gate`; calls counted under `op`). A shard shape that does not tile takes the einsum ring (counted
    as `op`'s "shard_shape" fallback), whose backward is autograd through
    the ring. return_lse=True also returns the global f32 logsumexp [B, H,
    T], the residual `ring_attention_bwd_sharded` starts from; the caller
    then owns the backward (the flash ring's outputs carry no graph)."""
    flash = use_flash and flash_ring_eligible(q, mesh, axis)
    if use_flash and not flash:
        A.count_fallback(op, SHARD_SHAPE)
    if not flash:
        ql, kl, vl = (shard_seq(x, mesh, axis) for x in (q, k, v))
        out, lse = ring_attention(ql, kl, vl, mesh, axis, causal,
                                  return_lse=True)
        out = all_gather_seq(out, mesh, axis, 1)
        if not return_lse:
            return out
        return out, all_gather_seq(lse.contiguous(), mesh, axis, 2)
    _gate(q, k, v, op)
    if return_lse:
        with torch.no_grad():
            return _flash_ring_fwd(q, k, v, mesh, axis, causal)
    return _FlashRing.apply(q, k, v, mesh, axis, causal)


def _bwd_sharded(q, k, v, do, o, lse, mesh, axis, causal, scale):
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    shards = [shard_seq(x, mesh, axis) for x in (q, k, v, do, o)]
    lse_l = shard_seq(lse, mesh, axis, dim=2).contiguous()
    grads = _ring_bwd_local(*shards, lse_l, mesh, axis, causal, scale)
    return tuple(all_gather_seq(g, mesh, axis, 1) for g in grads)


def ring_attention_bwd_sharded(q, k, v, do, o, lse, mesh, axis="sp",
                               causal=False, scale=None,
                               op="ring_attention_grad"):
    """The direct flash ring backward from the forward's saved (O, LSE):
    global dQ, dK, dV through K8 + K9 on the ring schedule (their plain
    versions on CPU tensors; CUDA tensors the Hopper gate refuses raise,
    `_gate`). Requires `flash_ring_eligible`."""
    _gate(q, k, v, op)
    with torch.no_grad():
        return _bwd_sharded(q, k, v, do, o, lse, mesh, axis, causal, scale)
