"""The batch-norm kernels for Hopper — K5 (`bn_apply`) and K6 (`bn_act`) —
in Triton, with their gate, their plain versions and their counters.

K5 replaces paddle_tpu/ops/pallas_conv.py `bn_apply` (:507) ->
`_bn_apply_kernel` (:303): given per-channel statistics,
ybn = (x - mean) * (rsqrt(var + eps) * scale) + bias rounded to bf16, and
yact = act(ybn), over the [M, C] view of an NHWC activation (M = N*H*W).
It is the epilogue of the conv -> bn [-> act] training window, whose
statistics come from K4 (ops/conv_cuda.py `conv2d_stats`).

K6 replaces paddle_tpu/ops/fusion.py `_pallas_bn_act` (:738) ->
`_bn_act_kernel` (:697): training batch norm [+ act] with its own
statistics, in the two phases of the TPU kernel. Phase one sums x and x^2
per channel (f32) over row ranges into a [splits, C] workspace; a small
kernel adds the splits in order and takes mean = sum / M and the clamped
one-pass variance max(E[x^2] - mean^2, 0) (fusion.py:720-722); phase two is
K5's normalize. No atomics: a repeated call is bitwise equal.

Both are bandwidth-bound elementwise passes and per-channel reductions with
no tensor-core work: K5 reads x once and writes one or two bf16 outputs, K6
reads x twice. Their bound on an H100 is those bytes against 3.35 TB/s.
The activations implemented are identity and relu, the only ones on the
ResNet path; any other is a counted fallback with reason `act`.

Triton is imported, and the kernels compiled, only inside the launching
functions: the CPU has no triton, and the CPU tests import every module.
On a CPU tensor a wrapper computes its plain version; on a CUDA tensor it
launches its kernels or raises.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch

__all__ = ["ACTS", "COUNTERS", "bn_apply", "bn_apply_reference", "bn_act",
           "bn_act_reference", "bn_act_splits", "ineligible", "count_hit",
           "count_fallback"]

# activation name -> the kernels' ACT code
ACTS = {None: 0, "relu": 1}

# the JAX package's fusion_fallback_total reasons for this kernel, plus
# "act" for an activation the port's kernels do not implement
FALLBACK_REASONS = frozenset(
    {"kernel_is_test", "kernel_layout", "kernel_dtype", "kernel_shape", "act"})

_BLOCK_M = 64
_BLOCK_C = 64


@dataclass
class Counters:
    """`apply_launches`: K5 launches made by `bn_apply`; `act_launches`: K6
    launches made by `bn_act` (one per call, its three kernels together);
    each added to only where its wrapper launches. `hits`/`fallbacks`:
    windows routed to the kernels or to the plain batch_norm lowering, by
    op and by (op, reason)."""
    apply_launches: int = 0
    act_launches: int = 0
    hits: Dict[str, int] = field(default_factory=dict)
    fallbacks: Dict[Tuple[str, str], int] = field(default_factory=dict)

    def reset(self):
        self.apply_launches = self.act_launches = 0
        self.hits.clear()
        self.fallbacks.clear()


COUNTERS = Counters()


def count_hit(op: str):
    COUNTERS.hits[op] = COUNTERS.hits.get(op, 0) + 1


def count_fallback(op: str, reason: str):
    key = (op, reason)
    COUNTERS.fallbacks[key] = COUNTERS.fallbacks.get(key, 0) + 1


def ineligible(x, is_test: bool, act: Optional[str]) -> Optional[str]:
    """None when K6 applies to a training batch_norm [+ act] on `x` (logical
    NCHW), else the fallback reason (fusion.py `_kernel_ineligible` :544).
    The envelope is Hopper's: any bf16 4-D activation, where the TPU
    kernel needed C % 128 and M % 8. f32 inputs keep the two-pass centered
    variance of the plain lowering, as in the JAX package."""
    if is_test:
        return "kernel_is_test"
    if getattr(x, "ndim", 0) != 4:
        return "kernel_layout"
    if getattr(x, "dtype", None) != torch.bfloat16:
        return "kernel_dtype"
    if x.numel() == 0:
        return "kernel_shape"
    if act not in ACTS:
        return "act"
    return None


# --- plain versions -----------------------------------------------------------

def bn_apply_reference(x2, scale, bias, mean, var, eps, act=None):
    """The plain version of K5: x2 [M, C] bf16; scale, bias, mean, var f32
    [C]. Returns (ybn, yact) with yact None when act is."""
    inv = torch.rsqrt(var + eps)
    y = ((x2.float() - mean) * (inv * scale) + bias).to(x2.dtype)
    return y, (torch.relu(y) if act == "relu" else None)


def bn_act_reference(x2, scale, bias, eps, act=None):
    """The plain version of K6: (ybn, yact, mean, var), the statistics in
    f32 with the clamped one-pass variance."""
    xf = x2.float()
    mean = xf.mean(0)
    var = torch.clamp((xf * xf).mean(0) - mean * mean, min=0.0)
    ybn, yact = bn_apply_reference(x2, scale, bias, mean, var, eps, act)
    return ybn, yact, mean, var


# --- Triton kernels (bodies; compiled by _jit on first use on the card) -------

tl = None  # triton.language, bound by _jit


def _bn_apply_body(x_ptr, scale_ptr, bias_ptr, mean_ptr, var_ptr, ybn_ptr,
                   yact_ptr, M, C, eps, ACT: tl.constexpr,
                   BLOCK_M: tl.constexpr, BLOCK_C: tl.constexpr):
    rows = tl.program_id(0) * BLOCK_M + tl.arange(0, BLOCK_M)
    cols = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
    cmask = cols < C
    mask = (rows[:, None] < M) & cmask[None, :]
    offs = rows[:, None].to(tl.int64) * C + cols[None, :]
    x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    scale = tl.load(scale_ptr + cols, mask=cmask, other=0.0)
    bias = tl.load(bias_ptr + cols, mask=cmask, other=0.0)
    mean = tl.load(mean_ptr + cols, mask=cmask, other=0.0)
    var = tl.load(var_ptr + cols, mask=cmask, other=1.0)
    a = (1.0 / tl.sqrt(var + eps)) * scale
    y = ((x - mean[None, :]) * a[None, :] + bias[None, :]).to(tl.bfloat16)
    tl.store(ybn_ptr + offs, y, mask=mask)
    if ACT == 1:
        tl.store(yact_ptr + offs, tl.maximum(y, 0.0).to(tl.bfloat16),
                 mask=mask)


def _bn_partial_body(x_ptr, psum_ptr, psq_ptr, M, C, rows_per_split,
                     BLOCK_M: tl.constexpr, BLOCK_C: tl.constexpr):
    split = tl.program_id(0)
    cols = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
    cmask = cols < C
    acc = tl.zeros((BLOCK_C,), dtype=tl.float32)
    acc2 = tl.zeros((BLOCK_C,), dtype=tl.float32)
    start = split * rows_per_split
    for r0 in range(0, rows_per_split, BLOCK_M):
        rows = start + r0 + tl.arange(0, BLOCK_M)
        mask = (rows[:, None] < M) & cmask[None, :]
        offs = rows[:, None].to(tl.int64) * C + cols[None, :]
        x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        acc += tl.sum(x, axis=0)
        acc2 += tl.sum(x * x, axis=0)
    tl.store(psum_ptr + split * C + cols, acc, mask=cmask)
    tl.store(psq_ptr + split * C + cols, acc2, mask=cmask)


def _bn_finish_body(psum_ptr, psq_ptr, mean_ptr, var_ptr, M, C, splits,
                    BLOCK_C: tl.constexpr):
    cols = tl.program_id(0) * BLOCK_C + tl.arange(0, BLOCK_C)
    cmask = cols < C
    s = tl.zeros((BLOCK_C,), dtype=tl.float32)
    q = tl.zeros((BLOCK_C,), dtype=tl.float32)
    for k in range(0, splits):
        s += tl.load(psum_ptr + k * C + cols, mask=cmask, other=0.0)
        q += tl.load(psq_ptr + k * C + cols, mask=cmask, other=0.0)
    mean = s / M
    var = tl.maximum(q / M - mean * mean, 0.0)
    tl.store(mean_ptr + cols, mean, mask=cmask)
    tl.store(var_ptr + cols, var, mask=cmask)


_JIT: Dict[str, object] = {}


def _jit():
    """The three kernels, compiled by Triton at their first launch."""
    if not _JIT:
        import triton
        import triton.language
        globals()["tl"] = triton.language
        _JIT.update(apply=triton.jit(_bn_apply_body),
                    partial=triton.jit(_bn_partial_body),
                    finish=triton.jit(_bn_finish_body))
    return _JIT


def _cdiv(a, b):
    return -(-a // b)


def _check(name, x2, vecs, act):
    if x2.device.type != "cuda" or any(v.device != x2.device for v in vecs):
        raise ValueError(f"{name} kernel needs every operand on one CUDA "
                         f"device, got x on {x2.device}")
    if x2.dtype != torch.bfloat16 or x2.dim() != 2:
        raise ValueError(f"{name} kernel takes [M, C] bf16, got "
                         f"{tuple(x2.shape)} {x2.dtype}")
    if act not in ACTS:
        raise ValueError(f"{name} kernel implements {sorted(ACTS, key=str)}, "
                         f"not {act!r}")
    for v in vecs:
        if v.dtype != torch.float32 or v.shape != (x2.shape[1],):
            raise ValueError(f"{name} kernel takes f32 [C] vectors, got "
                             f"{tuple(v.shape)} {v.dtype}")


def _launch_apply(x2, scale, bias, mean, var, eps, act):
    m, c = x2.shape
    ybn = torch.empty_like(x2)
    yact = torch.empty_like(x2) if act is not None else ybn
    grid = (_cdiv(m, _BLOCK_M), _cdiv(c, _BLOCK_C))
    _jit()["apply"][grid](x2, scale, bias, mean, var, ybn, yact, m, c,
                          float(eps), ACT=ACTS[act], BLOCK_M=_BLOCK_M,
                          BLOCK_C=_BLOCK_C)
    return ybn, (yact if act is not None else None)


def bn_apply(x2, scale, bias, mean, var, eps, act=None):
    """K5. x2 [M, C] bf16; scale, bias, mean, var f32 [C] -> (ybn, yact) bf16
    [M, C], yact None when act is. CPU tensors take the plain version; CUDA
    tensors launch the kernel, or raise."""
    if x2.device.type == "cpu":
        return bn_apply_reference(x2, scale, bias, mean, var, eps, act)
    _check("bn_apply", x2, (scale, bias, mean, var), act)
    x2 = x2.contiguous()
    out = _launch_apply(x2, scale.contiguous(), bias.contiguous(),
                        mean.contiguous(), var.contiguous(), eps, act)
    COUNTERS.apply_launches += 1
    return out


def bn_act_splits(m, c, sms=132):
    """(splits, rows_per_split) of K6's statistics pass: about two programs
    per SM across the channel blocks, each split a whole number of
    64-row blocks, every split non-empty."""
    c_blocks = _cdiv(c, _BLOCK_C)
    blocks = _cdiv(m, _BLOCK_M)
    splits = max(1, min(blocks, _cdiv(2 * sms, c_blocks)))
    rows = _cdiv(blocks, splits) * _BLOCK_M
    return _cdiv(m, rows), rows


def bn_act(x2, scale, bias, eps, act=None):
    """K6. x2 [M, C] bf16; scale, bias f32 [C] -> (ybn, yact, mean, var):
    batch statistics of x2 (f32, clamped one-pass variance) and the
    normalized bf16 outputs. CPU tensors take the plain version; CUDA
    tensors launch the kernels, or raise."""
    if x2.device.type == "cpu":
        return bn_act_reference(x2, scale, bias, eps, act)
    _check("bn_act", x2, (scale, bias), act)
    x2 = x2.contiguous()
    m, c = x2.shape
    splits, rows = bn_act_splits(m, c)
    part = torch.empty((2, splits, c), dtype=torch.float32, device=x2.device)
    stats = torch.empty((2, c), dtype=torch.float32, device=x2.device)
    k = _jit()
    k["partial"][(splits, _cdiv(c, _BLOCK_C))](
        x2, part[0], part[1], m, c, rows, BLOCK_M=_BLOCK_M, BLOCK_C=_BLOCK_C)
    k["finish"][(_cdiv(c, _BLOCK_C),)](
        part[0], part[1], stats[0], stats[1], m, c, splits, BLOCK_C=_BLOCK_C)
    ybn, yact = _launch_apply(x2, scale.contiguous(), bias.contiguous(),
                              stats[0], stats[1], eps, act)
    COUNTERS.act_launches += 1
    return ybn, yact, stats[0], stats[1]
