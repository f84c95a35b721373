"""The flash-attention kernels for Hopper — K7 (forward), K8 (dQ), K9
(dK/dV) — with their gate, their plain versions and their counters (the
port's counterpart of paddle_tpu/ops/pallas_attention.py), and the einsum
attention path (the counterpart of paddle_tpu/parallel/ring_attention.py
`attention_reference` and `attention_reference_lse`).

Replaces: pallas_attention.py `_fwd_kernel` (:143, normalize=True, through
`_forward` :266 -> `_fwd_call` :225), `_dq_kernel` (:295) and `_dkv_kernel`
(:342) (both through `flash_attention_bwd_block` :395), the Pallas TPU
kernels that `scaled_dot_product_attention` reaches on its flash path.

Kernels: `csrc/flash_attn_fwd.cu` (K7) and `csrc/flash_attn_bwd.cu` (K8,
K9), CUDA C++ for sm_90a, built by nvcc at first use (ops/cuda_build.py) and
called through ctypes. Operands stay [B, T, H, D] (the JAX layout) and are
read in place with a row stride of H*D; heads go into the grid; the
sequential grid axis of each TPU kernel (K tiles in K7/K8, Q tiles in K9)
is a loop inside a CTA; causal tiles wholly past the diagonal are not
visited. The TPU tile knobs (PADDLE_TPU_FLASH_BLOCK_Q/K, `_block`,
`_block_k`) are VMEM tiling and are not ported: the kernels take 64 resident
rows and stream 64 rows (32 for K8/K9 at D > 64).

Bound on an H100: operations. Causal at the bench shape [8, 2048, 8, 64],
K7 does 34.4 GFLOP, K8 51.5 and K9 68.7 (0.035, 0.052 and 0.069 ms at
989 TF/s bf16), their bytes a fifth of that time or less.
`chip_smoke.py` times each kernel beside that bound, its plain version and
`torch.nn.functional.scaled_dot_product_attention` (a yardstick only, never
called here), and PERF.md keeps the numbers.

Routing follows the JAX package: `supports` is its shape rule, deciding
between the flash and the einsum path (ops/nn_ops.py); `ineligible` is the
Hopper gate after it (bf16, D a multiple of 16 up to 128), and a flash-path
call that fails it runs the plain version, counted by op and reason. On a
CPU tensor a wrapper computes its plain version; on a CUDA tensor it
launches its kernel or raises — there is no fallback that hides a kernel.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass, field
from typing import Dict, Tuple

import torch

from . import cuda_build

__all__ = ["FALLBACK_REASONS", "COUNTERS", "supports", "ineligible",
           "flash_attention", "flash_forward", "flash_forward_block",
           "flash_forward_reference", "flash_dq", "flash_dq_reference",
           "flash_dkv", "flash_dkv_reference", "flash_attention_bwd_block",
           "attention_forward", "attention_backward", "attention_reference",
           "attention_reference_lse"]

FALLBACK_REASONS = frozenset({"dtype", "head_dim"})

_NEG = -1e30          # the reference's causal mask value
ROWS = 64             # resident rows of a CTA (queries in K7/K8, keys in K9)
FWD_BLOCK_K = 64      # K7's streamed key tile, which its plain version walks


@dataclass
class Counters:
    """Kernel launches, one field per wrapper and added to only where that
    wrapper launches its kernel: `launches` K7 (`flash_forward_block`),
    `dq_launches` K8 (`flash_dq`), `dkv_launches` K9 (`flash_dkv`).
    `hits`/`fallbacks`: flash-path calls routed to the kernels or to the
    plain versions, by op and by (op, reason)."""
    launches: int = 0
    dq_launches: int = 0
    dkv_launches: int = 0
    hits: Dict[str, int] = field(default_factory=dict)
    fallbacks: Dict[Tuple[str, str], int] = field(default_factory=dict)

    def reset(self):
        self.launches = self.dq_launches = self.dkv_launches = 0
        self.hits.clear()
        self.fallbacks.clear()


COUNTERS = Counters()


def count_hit(op: str):
    COUNTERS.hits[op] = COUNTERS.hits.get(op, 0) + 1


def count_fallback(op: str, reason: str):
    key = (op, reason)
    COUNTERS.fallbacks[key] = COUNTERS.fallbacks.get(key, 0) + 1


def supports(q, k, v) -> bool:
    """The JAX package's static shape rule (pallas_attention.py:49): [B, T,
    H, D] with equal shapes, T >= 8, T % 8 == 0, and T <= 128 or T % 128 ==
    0. It decides between the flash and the einsum path."""
    if q.ndim != 4 or tuple(q.shape) != tuple(k.shape) or \
            tuple(q.shape) != tuple(v.shape):
        return False
    t = q.shape[1]
    return t >= 8 and t % 8 == 0 and (t <= 128 or t % 128 == 0)


def ineligible(q, k, v):
    """None when the Hopper kernels take a flash-path call that passed
    `supports`, else the fallback reason: "dtype" unless q, k and v are
    bf16 (an f32 run without AMP takes the plain versions), "head_dim"
    unless D is a multiple of 16 (one mma.sync k-step) and at most 128 (the
    accumulators' register budget)."""
    if any(getattr(t, "dtype", None) != torch.bfloat16 for t in (q, k, v)):
        return "dtype"
    d = q.shape[-1]
    if d % 16 or d > 128:
        return "head_dim"
    return None


# --- plain versions ----------------------------------------------------------

def _heads(x):
    """[B, T, H, D] -> [B, H, T, D] in f32."""
    return x.float().permute(0, 2, 1, 3)


def _causal_keep(tq, tk, q_off, k_off, device):
    qpos = q_off + torch.arange(tq, device=device)
    kpos = k_off + torch.arange(tk, device=device)
    return qpos[:, None] >= kpos[None, :]


def flash_forward_reference(q, k, v, causal, q_off=0, k_off=0, scale=None):
    """The plain version of K7, its arithmetic step by step in f32: the
    online softmax over key tiles of FWD_BLOCK_K, each query tile of ROWS
    rows skipping the causal key tiles wholly past its last row, P rounded
    to the input dtype before P V, O = acc / max(l, 1e-30) rounded once,
    LSE = m + log(max(l, 1e-30)). Returns (o [B, Tq, H, D], lse [B, H, Tq]
    f32)."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    qf, kf, vf = _heads(q), _heads(k), _heads(v)
    dev = q.device
    m = torch.full((b, h, tq), _NEG, device=dev)
    l = torch.zeros((b, h, tq), device=dev)
    acc = torch.zeros((b, h, tq, d), device=dev)
    rows = torch.arange(tq, device=dev)
    tile_last = q_off + torch.clamp((rows // ROWS + 1) * ROWS, max=tq) - 1
    for k0 in range(0, tk, FWD_BLOCK_K):
        kb, vb = kf[:, :, k0:k0 + FWD_BLOCK_K], vf[:, :, k0:k0 + FWD_BLOCK_K]
        s = torch.matmul(qf, kb.transpose(-1, -2)) * scale
        if causal:
            keep = _causal_keep(tq, kb.shape[2], q_off, k_off + k0, dev)
            s = torch.where(keep, s, torch.full_like(s, _NEG))
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l_new = l * corr + p.sum(-1)
        acc_new = acc * corr[..., None] + torch.matmul(
            p.to(q.dtype).float(), vb)
        if causal:
            live = tile_last >= k_off + k0                  # [Tq]
            m = torch.where(live, m_new, m)
            l = torch.where(live, l_new, l)
            acc = torch.where(live[:, None], acc_new, acc)
        else:
            m, l, acc = m_new, l_new, acc_new
    denom = torch.clamp(l, min=1e-30)
    o = (acc / denom[..., None]).to(q.dtype).permute(0, 2, 1, 3).contiguous()
    return o, m + torch.log(denom)


def _bwd_terms(q, k, v, dout, lse, delta, q_off, k_off, scale, causal):
    """P and dS [B, H, Tq, Tk] in f32 (dS not yet rounded), and the f32
    operands [B, H, T, D]."""
    qf, kf, vf, dof = _heads(q), _heads(k), _heads(v), _heads(dout)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if causal:
        keep = _causal_keep(q.shape[1], k.shape[1], q_off, k_off, q.device)
        s = torch.where(keep, s, torch.full_like(s, _NEG))
    p = torch.exp(s - lse.float()[..., None])
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = p * (dp - delta.float()[..., None])
    return qf, kf, dof, p, ds


def flash_dq_reference(q, k, v, dout, lse, delta, q_off, k_off, scale,
                       causal):
    """The plain version of K8: dQ = scale * bf16(dS) K in f32, rounded once
    to q's dtype. `lse` must already be finite (flash_attention_bwd_block
    substitutes)."""
    _, kf, _, _, ds = _bwd_terms(q, k, v, dout, lse, delta, q_off, k_off,
                                 scale, causal)
    dq = torch.matmul(ds.to(q.dtype).float(), kf) * scale
    return dq.to(q.dtype).permute(0, 2, 1, 3).contiguous()


def flash_dkv_reference(q, k, v, dout, lse, delta, q_off, k_off, scale,
                        causal):
    """The plain version of K9: dV = bf16(P)^T dO and dK = scale *
    bf16(dS)^T Q in f32, rounded once to k's and v's dtypes."""
    qf, _, dof, p, ds = _bwd_terms(q, k, v, dout, lse, delta, q_off, k_off,
                                   scale, causal)
    dv = torch.matmul(p.to(k.dtype).float().transpose(-1, -2), dof)
    dk = torch.matmul(ds.to(k.dtype).float().transpose(-1, -2), qf) * scale
    return (dk.to(k.dtype).permute(0, 2, 1, 3).contiguous(),
            dv.to(v.dtype).permute(0, 2, 1, 3).contiguous())


# --- the kernels' wrappers ---------------------------------------------------

# flash_attn_fwd(q, k, v, o, lse, b, h, tq, tk, d, q_off, k_off, scale,
# causal, stream)
_FWD_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_float]
                 + [ctypes.c_int, ctypes.c_void_p])
# flash_attn_bwd_dq(q, k, v, dout, lse, delta, dq, 7 ints, scale, causal,
# stream); flash_attn_bwd_dkv takes dk and dv in place of dq
_DQ_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_float]
                + [ctypes.c_int, ctypes.c_void_p])
_DKV_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                 + [ctypes.c_float] + [ctypes.c_int, ctypes.c_void_p])


def _check_cuda(name, q, k, v, dout=None, stats=()):
    """Raise unless q (and dout) [B, Tq, H, D] and k, v [B, Tk, H, D] lie on
    one CUDA device with the f32 `stats` [B, H, Tq], pass the gate, dout is
    bf16 too, and Tq and Tk are multiples of 8."""
    extra = () if dout is None else (dout,)
    devices = {t.device for t in (q, k, v) + extra + tuple(stats)}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{name} kernel needs its operands on one CUDA "
                         f"device, got {sorted(map(str, devices))}")
    reason = ineligible(q, k, v) if q.dim() == 4 else "rank"
    if reason is None and dout is not None and (
            dout.dtype != torch.bfloat16 or dout.shape != q.shape):
        reason = "dout"
    if reason is None and (
            k.dim() != 4 or k.shape != v.shape or k.shape[0] != q.shape[0]
            or k.shape[2:] != q.shape[2:] or q.shape[1] % 8 or k.shape[1] % 8):
        reason = "shape"
    b, tq, h, _ = q.shape
    if reason is None and any(s.dtype != torch.float32 or
                              tuple(s.shape) != (b, h, tq) for s in stats):
        reason = "stats"
    if reason is not None:
        raise ValueError(f"{name} kernel called on an ineligible call "
                         f"({reason}): " + ", ".join(
                             f"{tuple(t.shape)} {t.dtype}"
                             for t in (q, k, v) + extra + tuple(stats)))


def _raise_on(rc, name, q):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc} "
                           f"(q {tuple(q.shape)})")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_forward_block(q, k, v, q_off, k_off, scale, causal):
    """K7. (o [B, Tq, H, D] in q's dtype, lse [B, H, Tq] f32) from q [B, Tq,
    H, D] and k, v [B, Tk, H, D], with global position offsets for the
    causal mask. CPU tensors take the plain version; CUDA tensors launch the
    kernel, or raise."""
    if q.device.type == "cpu":
        return flash_forward_reference(q, k, v, causal, q_off, k_off, scale)
    _check_cuda("flash_attn_fwd", q, k, v)
    b, tq, h, d = q.shape
    qc, kc, vc = (cuda_build.aligned(t) for t in (q, k, v))
    o = torch.empty_like(qc)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    fn = cuda_build.entry("flash_attn_fwd", "flash_attn_fwd", _FWD_ARGTYPES)
    rc = fn(qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, h, tq, k.shape[1], d, int(q_off), int(k_off),
            float(scale), int(bool(causal)), _stream(q))
    COUNTERS.launches += 1
    _raise_on(rc, "flash_attn_fwd", q)
    return o, lse


def flash_forward(q, k, v, causal):
    """K7 on one device's whole sequence: (o, lse [B, H, T]) with scale
    1/sqrt(D) and offsets 0 (pallas_attention.py `_forward`)."""
    return flash_forward_block(q, k, v, 0, 0, 1.0 / math.sqrt(q.shape[-1]),
                               causal)


def _bwd_operands(q, k, v, dout, lse, delta):
    return tuple(cuda_build.aligned(t) for t in (q, k, v, dout, lse, delta))


def flash_dq(q, k, v, dout, lse, delta, q_off, k_off, scale, causal):
    """K8. dq [B, Tq, H, D] in q's dtype. `lse` must be finite. CPU tensors
    take the plain version; CUDA tensors launch the kernel, or raise."""
    if q.device.type == "cpu":
        return flash_dq_reference(q, k, v, dout, lse, delta, q_off, k_off,
                                  scale, causal)
    _check_cuda("flash_attn_bwd_dq", q, k, v, dout, (lse, delta))
    b, tq, h, d = q.shape
    ops = _bwd_operands(q, k, v, dout, lse, delta)
    dq = torch.empty_like(ops[0])
    fn = cuda_build.entry("flash_attn_bwd", "flash_attn_bwd_dq", _DQ_ARGTYPES)
    rc = fn(*(t.data_ptr() for t in ops), dq.data_ptr(), b, h, tq, k.shape[1],
            d, int(q_off), int(k_off), float(scale), int(bool(causal)),
            _stream(q))
    COUNTERS.dq_launches += 1
    _raise_on(rc, "flash_attn_bwd_dq", q)
    return dq


def flash_dkv(q, k, v, dout, lse, delta, q_off, k_off, scale, causal):
    """K9. (dk, dv) [B, Tk, H, D] in k's and v's dtypes. `lse` must be
    finite. CPU tensors take the plain version; CUDA tensors launch the
    kernel, or raise."""
    if q.device.type == "cpu":
        return flash_dkv_reference(q, k, v, dout, lse, delta, q_off, k_off,
                                   scale, causal)
    _check_cuda("flash_attn_bwd_dkv", q, k, v, dout, (lse, delta))
    b, tq, h, d = q.shape
    ops = _bwd_operands(q, k, v, dout, lse, delta)
    dk, dv = torch.empty_like(ops[1]), torch.empty_like(ops[2])
    fn = cuda_build.entry("flash_attn_bwd", "flash_attn_bwd_dkv",
                          _DKV_ARGTYPES)
    rc = fn(*(t.data_ptr() for t in ops), dk.data_ptr(), dv.data_ptr(), b, h,
            tq, k.shape[1], d, int(q_off), int(k_off), float(scale),
            int(bool(causal)), _stream(q))
    COUNTERS.dkv_launches += 1
    _raise_on(rc, "flash_attn_bwd_dkv", q)
    return dk, dv


def _finite(lse):
    """LSE in f32 with a non-finite entry replaced by 1e30
    (pallas_attention.py:419): P = exp(S - 1e30) = 0, so the row adds
    nothing to any gradient."""
    lse = lse.float()
    return torch.where(torch.isfinite(lse), lse, torch.full_like(lse, 1e30))


def flash_attention_bwd_block(q, k, v, dout, lse, delta, q_off, k_off, scale,
                              causal):
    """The flash backward for one (Q, K/V) pair with global offsets
    (pallas_attention.py:395): q/dout [B, Tq, H, D], k/v [B, Tk, H, D],
    lse/delta [B, H, Tq] f32. Returns (dq, dk, dv): K8, then K9."""
    lse = _finite(lse)
    delta = delta.float().contiguous()
    dq = flash_dq(q, k, v, dout, lse, delta, q_off, k_off, scale, causal)
    dk, dv = flash_dkv(q, k, v, dout, lse, delta, q_off, k_off, scale, causal)
    return dq, dk, dv


# --- routing: the gate, then a kernel or a counted plain version -------------

def attention_forward(q, k, v, causal, op="flash_attention"):
    """A flash-path forward, (o, lse [B, H, T]): K7 where the gate admits
    the call, else the plain version, counted under `op` either way."""
    reason = ineligible(q, k, v)
    if reason is None:
        count_hit(op)
        return flash_forward(q, k, v, causal)
    count_fallback(op, reason)
    return flash_forward_reference(q, k, v, causal)


def attention_backward(q, k, v, o, dout, lse, causal, op="flash_attention"):
    """A flash-path backward from the forward's saved (o, lse): delta =
    rowsum(dO * O) in f32 [B, H, T] (pallas_attention.py:483-490), then K8
    and K9 where the gate admits the call, else their plain versions,
    counted under `op` either way. dout is taken in q's dtype."""
    dout = dout.to(q.dtype)
    delta = (dout.float() * o.to(q.dtype).float()).sum(-1) \
        .transpose(1, 2).contiguous()
    scale = 1.0 / math.sqrt(q.shape[-1])
    reason = ineligible(q, k, v)
    if reason is None:
        count_hit(op)
        return flash_attention_bwd_block(q, k, v, dout, lse, delta, 0, 0,
                                         scale, causal)
    count_fallback(op, reason)
    args = (q, k, v, dout, _finite(lse), delta, 0, 0, scale, causal)
    return (flash_dq_reference(*args), *flash_dkv_reference(*args))


class _FlashAttention(torch.autograd.Function):
    """pallas_attention.flash_attention's custom_vjp: the forward saves
    (q, k, v, o, lse); the backward runs K8 and K9 from them, with no
    forward re-run."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = attention_forward(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = attention_backward(q, k, v, o, g, lse, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, causal=False):
    """softmax(Q K^T / sqrt(D) [+ causal mask]) V over [B, T, H, D],
    differentiable: K7 forward, K8 + K9 backward."""
    return _FlashAttention.apply(q, k, v, causal)


# --- the einsum path ----------------------------------------------------------

def _scaled_masked_logits(q, k, causal, scale):
    """The one definition of the einsum path's scores [B, H, Tq, Tk]
    (ring_attention.py:29): attention_reference and attention_reference_lse
    both build their logits here, so the LSE matches the probabilities."""
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / torch.sqrt(torch.tensor(float(d))).to(q.dtype)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        tq, tk = logits.shape[-2], logits.shape[-1]
        keep = torch.tril(torch.ones((tq, tk), dtype=torch.bool,
                                     device=q.device), diagonal=tk - tq)
        logits = logits.masked_fill(~keep, float("-inf"))
    return logits


def attention_reference(q, k, v, causal=False, scale=None):
    """Plain softmax attention, q/k/v [B, T, H, D] -> [B, T, H, D], in the
    operands' dtype (ring_attention.py:46)."""
    probs = torch.softmax(_scaled_masked_logits(q, k, causal, scale), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def attention_reference_lse(q, k, causal=False, scale=None):
    """Per-row logsumexp of the scaled, masked scores [B, H, T] in f32
    (ring_attention.py:53)."""
    return torch.logsumexp(
        _scaled_masked_logits(q, k, causal, scale).float(), dim=-1)
