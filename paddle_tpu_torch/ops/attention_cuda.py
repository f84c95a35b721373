"""The flash-attention kernels for Hopper — K7 (forward), K8 (dQ), K9
(dK/dV), K10 (the unnormalized forward block of ring attention) — with
their gate, their plain versions and their counters (the port's
counterpart of paddle_tpu/ops/pallas_attention.py), and the einsum
attention path (the counterpart of paddle_tpu/parallel/ring_attention.py
`attention_reference` and `attention_reference_lse`).

Replaces: pallas_attention.py `_fwd_kernel` (:143, normalize=True, through
`_forward` :266 -> `_fwd_call` :225; and normalize=False, through
`flash_attention_block` :276 -> `_fwd_call`), `_dq_kernel` (:295) and
`_dkv_kernel` (:342) (both through `flash_attention_bwd_block` :395), the
Pallas TPU kernels that `scaled_dot_product_attention` reaches on its flash
and ring paths.

Kernels, CUDA C++ for sm_90a, built by nvcc at first use (ops/cuda_build.py)
and called through ctypes:
- bf16: `csrc/flash_attn_fwd.cu` (K7, K10) and `csrc/flash_attn_bwd.cu`
  (K8, K9) on wgmma with TMA loads through an mbarrier ring, a producer
  warp and consumer warpgroups of 64 resident rows; each entry point picks
  its tile plan from the head dim.
- f32: `csrc/flash_attn_fwd_tf32.cu` (K7, K10: one template with a
  NORMALIZE flag) and `csrc/flash_attn_bwd_tf32.cu` (K8, K9) on tf32
  wgmma with TMA loads through an mbarrier ring, split warps that turn
  each landed tile into the tf32 hi/lo and transposed forms the products
  read (`csrc/flash_attn_tf32.cuh`). They run every product as three TF32
  passes (3xTF32) and leave P and dS in f32 as the reference leaves them
  for f32 operands.
Operands stay [B, T, H, D] (the JAX layout) and are read in place with a
row stride of H*D; heads go into the grid; the sequential grid axis of
each TPU kernel (K tiles in K7/K8, Q tiles in K9) is a loop inside a CTA;
causal tiles wholly past the diagonal are not visited. The TPU tile knobs
(PADDLE_TPU_FLASH_BLOCK_Q/K, `_block`, `_block_k`) are VMEM tiling and are
not ported.

Bound on an H100: operations. Causal at the bench shape [8, 2048, 8, 64],
K7 does 34.4 GFLOP, K8 51.5 and K9 68.7 (0.035, 0.052 and 0.069 ms at
989 TF/s bf16), their bytes a fifth of that time or less. The f32 forms'
three TF32 passes run at 495 / 3 = 165 TF/s. K10 at the ring configuration's
one-card shape [1, 32768, 8, 64] causal does 1.10 TFLOP (1.11 ms) against
0.17 GB (0.05 ms). `chip_smoke.py` times each kernel beside that bound, its
plain version and `torch.nn.functional.scaled_dot_product_attention` (a
yardstick only, never called here), and PERF.md keeps the numbers.

Routing follows the JAX package: `supports` is its shape rule, deciding
between the flash and the einsum path (ops/nn_ops.py); `ineligible` is the
Hopper gate after it (q, k, v all bf16 or all f32, D a multiple of 16 up
to 128), and a flash-path call that fails it runs the plain version,
counted by op and reason. On a CPU tensor a wrapper computes its plain
version; on a CUDA tensor it launches its kernel or raises — there is no
fallback that hides a kernel.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass, field
from typing import Dict, Tuple

import torch

from . import cuda_build

__all__ = ["FALLBACK_REASONS", "COUNTERS", "supports", "block_supports",
           "ineligible", "flash_attention", "flash_forward",
           "flash_forward_block", "flash_forward_reference",
           "flash_attention_block", "flash_forward_block_reference",
           "flash_dq", "flash_dq_reference", "flash_dkv",
           "flash_dkv_reference", "flash_attention_bwd_block",
           "flash_attention_bwd_block_reference", "attention_forward",
           "attention_backward", "attention_reference",
           "attention_reference_lse"]

FALLBACK_REASONS = frozenset({"dtype", "head_dim"})

_NEG = -1e30          # the reference's causal mask value
# The forward's walk: query tiles of ROWS rows visit the key tiles of
# FWD_BLOCK_K up to the one holding their last row's position. The plain
# version walks it, and the kernels, bf16 and f32, visit by it whatever
# their own tiles (csrc/flash_attn_fwd.cu "Visiting").
ROWS = 64
FWD_BLOCK_K = 64
_KERNEL_DTYPES = (torch.bfloat16, torch.float32)


@dataclass
class Counters:
    """Kernel launches, one field per kernel and added to only where its
    wrapper launches it: the bf16 Hopper kernels `launches` K7
    (`flash_forward_block`), `dq_launches` K8 (`flash_dq`), `dkv_launches`
    K9 (`flash_dkv`), `block_launches` K10 (`flash_attention_block`); their
    f32 forms `f32_launches`, `f32_dq_launches`, `f32_dkv_launches`,
    `f32_block_launches` (the same wrappers on f32 operands; K9's f32 form
    at D > 64 is two kernels, dV then dK, and counts two). `hits`/
    `fallbacks`: flash-path and flash-ring calls routed to the kernels or
    to the plain versions, by op and by (op, reason); a flash ring whose
    shards do not tile counts a fallback "shard_shape"
    (parallel/ring_attention.py)."""
    launches: int = 0
    dq_launches: int = 0
    dkv_launches: int = 0
    block_launches: int = 0
    f32_launches: int = 0
    f32_dq_launches: int = 0
    f32_dkv_launches: int = 0
    f32_block_launches: int = 0
    hits: Dict[str, int] = field(default_factory=dict)
    fallbacks: Dict[Tuple[str, str], int] = field(default_factory=dict)

    def reset(self):
        self.launches = self.dq_launches = self.dkv_launches = 0
        self.block_launches = 0
        self.f32_launches = self.f32_dq_launches = self.f32_dkv_launches = 0
        self.f32_block_launches = 0
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


def block_supports(q, k) -> bool:
    """The reference's shape rule for the ring's per-shard flash block
    (pallas_attention.py:288) at its default resident block: 128 rows when
    min(Tq, Tk) is a multiple of 128, else min(Tq, Tk) itself; both Tq and
    Tk multiples of it and of 8, and at least 8."""
    tq, tk = q.shape[1], k.shape[1]
    t = min(tq, tk)
    blk = 128 if t % 128 == 0 else t
    return (q.dim() == 4 and tq % blk == 0 and tk % blk == 0 and t >= 8
            and tq % 8 == 0 and tk % 8 == 0)


def ineligible(q, k, v):
    """None when the kernels take a flash-path call that passed `supports`,
    else the fallback reason: "dtype" unless q, k and v are all bf16 (the
    Hopper kernels, AMP O2) or all f32 (their f32 forms, a run without AMP);
    fp16 and mixed dtypes take the plain versions. "head_dim" unless D is a
    multiple of 16 (one bf16 k-step) and at most 128 (the accumulators'
    register budget)."""
    dt = getattr(q, "dtype", None)
    if dt not in _KERNEL_DTYPES or \
            any(getattr(t, "dtype", None) != dt for t in (k, v)):
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


def _online_softmax(q, k, v, causal, q_off, k_off, scale):
    """The walk K7 and K10 share, in f32: the online softmax over key tiles
    of FWD_BLOCK_K, each query tile of ROWS rows skipping the causal key
    tiles wholly past its last row, masked scores -1e30, P rounded to the
    input dtype before P V. Returns (acc [B, H, Tq, D], l, m [B, H, Tq]);
    a row no visited tile reaches keeps (0, 0, -1e30)."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    qf, kf, vf = _heads(q), _heads(k), _heads(v)
    dev = q.device
    m = torch.full((b, h, tq), _NEG, device=dev)
    l = torch.zeros((b, h, tq), device=dev)
    acc = torch.zeros((b, h, tq, d), device=dev)
    rows = torch.arange(tq, device=dev)
    tile_last = q_off + torch.clamp((rows // ROWS + 1) * ROWS, max=tq) - 1
    for k0 in range(0, tk, FWD_BLOCK_K):
        if causal and q_off + tq - 1 < k_off + k0:
            break                        # no query tile reaches this key tile
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
    return acc, l, m


def flash_forward_reference(q, k, v, causal, q_off=0, k_off=0, scale=None):
    """The plain version of K7, its arithmetic step by step in f32: the
    online softmax of `_online_softmax`, then O = acc / max(l, 1e-30)
    rounded once, LSE = m + log(max(l, 1e-30)). Returns (o [B, Tq, H, D],
    lse [B, H, Tq] f32)."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    acc, l, m = _online_softmax(q, k, v, causal, q_off, k_off, scale)
    denom = torch.clamp(l, min=1e-30)
    o = (acc / denom[..., None]).to(q.dtype).permute(0, 2, 1, 3).contiguous()
    return o, m + torch.log(denom)


def flash_forward_block_reference(q, k, v, q_off, k_off, scale, causal):
    """The plain version of K10: K7's walk with the normalization left out.
    Returns (acc [B, Tq, H, D], l [B, H, Tq], m [B, H, Tq]), all f32; rows
    that no visited key tile reaches (a key shard wholly in their causal
    future) come out (0, 0, -1e30), as the Pallas kernel leaves them."""
    acc, l, m = _online_softmax(q, k, v, causal, q_off, k_off, scale)
    return acc.permute(0, 2, 1, 3).contiguous(), l, m


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

# The C entry points: flash_attn_fwd(q, k, v, o, lse, b, h, tq, tk, d,
# q_off, k_off, scale, causal, stream); flash_attn_fwd_block takes acc, m,
# l in place of o, lse; flash_attn_bwd_dq q, k, v, dout, lse, delta, dq, and
# flash_attn_bwd_dkv dk, dv in place of dq. The f32 forms (flash_tf32_fwd,
# flash_tf32_fwd_block, flash_tf32_bwd_dq, flash_tf32_bwd_dkv) take the same
# arguments.
def _argtypes(pointers):
    return ([ctypes.c_void_p] * pointers + [ctypes.c_int] * 7
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


# kernel name -> ((library, entry, launch counter) for bf16, the same for
# f32, pointer count)
_KERNELS = {
    "fwd": (("flash_attn_fwd", "flash_attn_fwd", "launches"),
            ("flash_attn_fwd_tf32", "flash_tf32_fwd", "f32_launches"), 5),
    "block": (("flash_attn_fwd", "flash_attn_fwd_block", "block_launches"),
              ("flash_attn_fwd_tf32", "flash_tf32_fwd_block",
               "f32_block_launches"), 6),
    "dq": (("flash_attn_bwd", "flash_attn_bwd_dq", "dq_launches"),
           ("flash_attn_bwd_tf32", "flash_tf32_bwd_dq", "f32_dq_launches"), 7),
    "dkv": (("flash_attn_bwd", "flash_attn_bwd_dkv", "dkv_launches"),
            ("flash_attn_bwd_tf32", "flash_tf32_bwd_dkv", "f32_dkv_launches"),
            8),
}


def _check_cuda(name, q, k, v, dout=None, stats=()):
    """Raise unless q (and dout) [B, Tq, H, D] and k, v [B, Tk, H, D] lie on
    one CUDA device with the f32 `stats` [B, H, Tq], pass the gate, dout has
    q's dtype, and Tq and Tk are multiples of 8."""
    extra = () if dout is None else (dout,)
    devices = {t.device for t in (q, k, v) + extra + tuple(stats)}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{name} kernel needs its operands on one CUDA "
                         f"device, got {sorted(map(str, devices))}")
    reason = ineligible(q, k, v) if q.dim() == 4 else "rank"
    if reason is None and dout is not None and (
            dout.dtype != q.dtype or dout.shape != q.shape):
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


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch(kernel, q, k, pointers, q_off, k_off, scale, causal):
    """Launch one of K7 ("fwd"), K10 ("block"), K8 ("dq"), K9 ("dkv") on
    checked CUDA operands: the Hopper kernel for bf16, its f32 form for
    f32. Counts the kernels launched, then raises if the launch was
    refused."""
    bf16_form, f32_form, n_ptr = _KERNELS[kernel]
    b, tq, h, d = q.shape
    f32 = q.dtype == torch.float32
    lib, name, counter = f32_form if f32 else bf16_form
    fn = cuda_build.entry(lib, name, _argtypes(n_ptr))
    rc = fn(*pointers, b, h, tq, k.shape[1], d, int(q_off), int(k_off),
            float(scale), int(bool(causal)), _stream(q))
    # K9's f32 form at D > 64 runs as two kernels (dV, then dK)
    n = 2 if f32 and kernel == "dkv" and d > 64 else 1
    setattr(COUNTERS, counter, getattr(COUNTERS, counter) + n)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error "
                           f"{rc} (q {tuple(q.shape)} {q.dtype})")


def _forward_block(q, k, v, q_off, k_off, scale, causal):
    _check_cuda("flash_attn_fwd", q, k, v)
    b, tq, h, d = q.shape
    qc, kc, vc = (cuda_build.aligned(t) for t in (q, k, v))
    o = torch.empty_like(qc)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    _launch("fwd", qc, kc, (qc.data_ptr(), kc.data_ptr(), vc.data_ptr(),
                            o.data_ptr(), lse.data_ptr()),
            q_off, k_off, scale, causal)
    return o, lse


def flash_forward_block(q, k, v, q_off, k_off, scale, causal):
    """K7. (o [B, Tq, H, D] in q's dtype, lse [B, H, Tq] f32) from q [B, Tq,
    H, D] and k, v [B, Tk, H, D], with global position offsets for the
    causal mask. CPU tensors take the plain version; CUDA tensors launch the
    kernel (bf16: the Hopper kernel; f32: its f32 form), or raise."""
    if q.device.type == "cpu":
        return flash_forward_reference(q, k, v, causal, q_off, k_off, scale)
    return _forward_block(q, k, v, q_off, k_off, scale, causal)


def flash_forward(q, k, v, causal):
    """K7 on one device's whole sequence: (o, lse [B, H, T]) with scale
    1/sqrt(D) and offsets 0 (pallas_attention.py `_forward`)."""
    return flash_forward_block(q, k, v, 0, 0, 1.0 / math.sqrt(q.shape[-1]),
                               causal)


def _attention_block(q, k, v, q_off, k_off, scale, causal):
    _check_cuda("flash_attn_fwd_block", q, k, v)
    b, tq, h, d = q.shape
    qc, kc, vc = (cuda_build.aligned(t) for t in (q, k, v))
    acc = torch.empty(qc.shape, dtype=torch.float32, device=q.device)
    m = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    _launch("block", qc, kc, (qc.data_ptr(), kc.data_ptr(), vc.data_ptr(),
                              acc.data_ptr(), m.data_ptr(), l.data_ptr()),
            q_off, k_off, scale, causal)
    return acc, l, m


def flash_attention_block(q, k, v, q_off, k_off, scale, causal):
    """K10, the ring's per-shard flash block (pallas_attention.py:276):
    q [B, Tq, H, D] resident, k, v [B, Tk, H, D] visiting, global position
    offsets for the causal mask. Returns the unnormalized online-softmax
    state (acc [B, Tq, H, D], l [B, H, Tq], m [B, H, Tq]), all f32. CPU
    tensors take the plain version; CUDA tensors launch the kernel (bf16 or
    its f32 form), or raise."""
    if q.device.type == "cpu":
        return flash_forward_block_reference(q, k, v, q_off, k_off, scale,
                                             causal)
    return _attention_block(q, k, v, q_off, k_off, scale, causal)


def _bwd_operands(q, k, v, dout, lse, delta):
    return tuple(cuda_build.aligned(t) for t in (q, k, v, dout, lse, delta))


def _dq(q, k, v, dout, lse, delta, q_off, k_off, scale, causal):
    _check_cuda("flash_attn_bwd_dq", q, k, v, dout, (lse, delta))
    ops = _bwd_operands(q, k, v, dout, lse, delta)
    dq = torch.empty_like(ops[0])
    _launch("dq", ops[0], ops[1], [t.data_ptr() for t in ops] +
            [dq.data_ptr()], q_off, k_off, scale, causal)
    return dq


def flash_dq(q, k, v, dout, lse, delta, q_off, k_off, scale, causal):
    """K8. dq [B, Tq, H, D] in q's dtype. `lse` must be finite. CPU tensors
    take the plain version; CUDA tensors launch the kernel (bf16 or its f32
    form), or raise."""
    if q.device.type == "cpu":
        return flash_dq_reference(q, k, v, dout, lse, delta, q_off, k_off,
                                  scale, causal)
    return _dq(q, k, v, dout, lse, delta, q_off, k_off, scale, causal)


def _dkv(q, k, v, dout, lse, delta, q_off, k_off, scale, causal):
    _check_cuda("flash_attn_bwd_dkv", q, k, v, dout, (lse, delta))
    ops = _bwd_operands(q, k, v, dout, lse, delta)
    dk, dv = torch.empty_like(ops[1]), torch.empty_like(ops[2])
    _launch("dkv", ops[0], ops[1], [t.data_ptr() for t in ops] +
            [dk.data_ptr(), dv.data_ptr()], q_off, k_off, scale, causal)
    return dk, dv


def flash_dkv(q, k, v, dout, lse, delta, q_off, k_off, scale, causal):
    """K9. (dk, dv) [B, Tk, H, D] in k's and v's dtypes. `lse` must be
    finite. CPU tensors take the plain version; CUDA tensors launch the
    kernel (bf16 or its f32 form), or raise."""
    if q.device.type == "cpu":
        return flash_dkv_reference(q, k, v, dout, lse, delta, q_off, k_off,
                                   scale, causal)
    return _dkv(q, k, v, dout, lse, delta, q_off, k_off, scale, causal)


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


def flash_attention_bwd_block_reference(q, k, v, dout, lse, delta, q_off,
                                        k_off, scale, causal):
    """The plain versions of K8 and K9 behind `flash_attention_bwd_block`:
    (dq, dk, dv) from the same operands, the non-finite LSE rows replaced
    the same way."""
    args = (q, k, v, dout, _finite(lse), delta.float(), q_off, k_off, scale,
            causal)
    return (flash_dq_reference(*args), *flash_dkv_reference(*args))


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
    return flash_attention_bwd_block_reference(q, k, v, dout, lse, delta, 0,
                                               0, scale, causal)


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
