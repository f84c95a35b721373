"""Quantized compute: the third AMP level, O3 (the port's counterpart of
paddle_tpu/quant.py, int8).

`ServingEngine(..., quantize="int8")` marks its program O3, and the `mul`
and `conv2d` lowerings route eligible compute through this module:

  * weights are quantized symmetrically per output channel (scale =
    max|w| / 127 per column of a `mul` Y, per Co of a conv filter),
    activations per row (`mul`) or per tensor (conv), at each call;
  * the integer product accumulates exactly in int32 and dequantizes by
    the product of the two scales, rounded once to the activation's dtype
    (bf16 under O3), as the reference does (quant.py:330-337, :369-383);
  * the conv runs K11, `ops/conv_cuda.conv2d_q8` (the port of the Pallas
    int8 conv); the `mul` product is an int8 GEMM, `torch._int_mm` on the
    card (the reference leaves it to XLA's int8 dot, outside Pallas);
  * `qmatmul` and `qconv2d` are autograd Functions whose backward is the
    plain bf16 product's (straight-through), as the reference's
    custom_vjp; O3 training is a later slice;
  * eligibility is a gate per op (`ineligible_matmul`, `ineligible_conv`)
    with counted fallbacks by reason (`COUNTERS`, the counterparts of the
    reference's quant_kernel_total and quant_fallback_total);
  * serving quantizes the weights once, at admission (`prequantize`; the
    folded conv filters in `ops/fusion.fold_constants`).

The conv gate is the reference's: its int8 conv rides the Pallas kernel
suite, whose channel rule is Ci, Co % 128 and whose width budget is 2048
(`pallas_conv.ineligible`). K1's gate here is wider (Ci, Co % 8), so a conv
that K1 takes may still fall back from quantization with reason "kernel",
as in the reference: quantizing more convs than it does would change the
answers, not only the speed.

fp8 (`mode="fp8"`) waits for a later slice: the gates return "mode".
`QUANT` and `QUANT_TOL` are module constants with the reference's defaults
(its PADDLE_TPU_QUANT and PADDLE_TPU_QUANT_TOL); the environment switches
come with the port's flags module.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .ops import conv_cuda, registry

__all__ = ["FALLBACK_REASONS", "QUANT", "QUANT_TOL", "QUANT_OPS", "COUNTERS",
           "count_hit", "count_fallback", "suppress_counters",
           "error_estimate", "ineligible_matmul", "ineligible_conv",
           "quantize_channelwise", "quantize_tensor", "weight_qparams",
           "int_matmul", "qmatmul", "qconv2d", "prequantize", "prequantized"]

QUANT = True
QUANT_TOL = 0.06

# every reason the gates can return (the reference's vocabulary)
FALLBACK_REASONS = frozenset(
    {"disabled", "mode", "rank", "dtype", "shape", "kernel", "error_bound"})

# RMS relative quantization noise per operand element (the reference's
# error model, quant.py:38-45)
_EPS_RMS = {"int8": 1.0 / (127.0 * math.sqrt(12.0)),
            "fp8": 2.0 ** -3 / math.sqrt(12.0)}

# int8 full scale / fp8 e4m3 max normal
_QMAX = {"int8": 127.0, "fp8": 448.0}

_FLOAT_IN = (torch.bfloat16, torch.float32)

# the registered op types that route through this module; `matmul` and
# `depthwise_conv2d` join when the port registers them
QUANT_OPS = {"mul": "qmatmul", "conv2d": "qconv2d"}

# the reference's conv kernel envelope (pallas_conv.py:26, :36): 128-lane
# channel tiles and a padded width of at most 2048
_LANE = 128
_MAX_W = 2048

# the profiler range around each activation-quantize pass
ACT_SPAN = "quant:act"


@dataclass
class Counters:
    """Lowerings routed to the quantized path, by op (`hits`), and those
    that fell back to the bf16 path, by (op, reason) (`fallbacks`)."""
    hits: Dict[str, int] = field(default_factory=dict)
    fallbacks: Dict[Tuple[str, str], int] = field(default_factory=dict)

    def reset(self):
        self.hits.clear()
        self.fallbacks.clear()


COUNTERS = Counters()

# silences count_hit/count_fallback while a grad lowering re-runs a forward
# lowering that already counted itself (the generic grads do)
suppress_counters = registry.suppress_counters


def count_hit(op: str):
    if registry.counting():
        COUNTERS.hits[op] = COUNTERS.hits.get(op, 0) + 1


def count_fallback(op: str, reason: str):
    if registry.counting():
        key = (op, reason)
        COUNTERS.fallbacks[key] = COUNTERS.fallbacks.get(key, 0) + 1


def error_estimate(k: int, mode: str) -> float:
    """Relative RMS error of a quantized K-deep contraction: both operands
    carry one quantization step of zero-mean noise, so the estimate does
    not depend on K."""
    del k
    return math.sqrt(2.0) * _EPS_RMS.get(mode, 1.0)


# --- gates ---------------------------------------------------------------

def ineligible_matmul(x, y, mode="int8"):
    """None when the quantized product applies to x [M, K] @ y [K, N] (both
    after the AMP cast), else the fallback reason (quant.py:142)."""
    if not QUANT:
        return "disabled"
    if mode != "int8":
        return "mode"
    if getattr(x, "ndim", 0) != 2 or getattr(y, "ndim", 0) != 2:
        return "rank"
    if getattr(x, "dtype", None) not in _FLOAT_IN or \
            getattr(y, "dtype", None) not in _FLOAT_IN:
        return "dtype"
    k = x.shape[1]
    if k < 32 or k % 8:
        return "shape"
    if error_estimate(k, mode) > QUANT_TOL:
        return "error_bound"
    return None


def _reference_kernel_gate(x, w, strides, paddings, dilations, groups):
    """The reference's pallas_conv.ineligible: K1's gate here plus the
    128-channel tiles and the 2048 width budget of the TPU kernel."""
    reason = conv_cuda.ineligible(x, w, strides, paddings, dilations, groups)
    if reason is not None:
        return reason
    co, ci, kh, kw = w.shape
    if ci % _LANE or co % _LANE:
        return "channels"
    kew = (kw - 1) * dilations[1] + 1
    ow = (x.shape[2] + 2 * paddings[1] - kew) // strides[1] + 1
    if max(x.shape[2] + 2 * paddings[1], x.shape[2] + kew - 1, ow) > _MAX_W:
        return "geometry"
    return None


def ineligible_conv(x, w, strides, paddings, dilations, groups=1,
                    mode="int8"):
    """None when the quantized conv applies (NHWC x, OIHW w, both after the
    AMP cast), else the reason (quant.py:168). The reference's kernel gate
    is a prerequisite: "kernel" where it fails."""
    if not QUANT:
        return "disabled"
    if mode != "int8":
        return "mode"
    if _reference_kernel_gate(x, w, strides, paddings, dilations,
                              groups) is not None:
        return "kernel"
    co, ci, kh, kw = w.shape
    if error_estimate(ci * kh * kw, mode) > QUANT_TOL:
        return "error_bound"
    return None


# --- quantizers ----------------------------------------------------------

def _int8_mode(mode):
    if mode != "int8":
        raise NotImplementedError(f"{mode} quantization is a later slice of "
                                  f"the port; int8 is ported")


def _scale(amax, mode):
    """max(amax, 1e-12) / qmax, a true f32 division on every device. (On
    CUDA, dividing by a Python number multiplies by its f32 reciprocal,
    which can land one ulp off the reference's quotient.)"""
    qmax = torch.full((), _QMAX[mode], dtype=torch.float32, device=amax.device)
    return torch.clamp(amax, min=1e-12) / qmax


def quantize_channelwise(x, axis: int, mode: str = "int8"):
    """Symmetric per-channel quantization (quant.py:286): max|x| over every
    dim but `axis`, scaled to 127, rounded half to even. Returns (q int8,
    scale f32 shaped like x reduced to 1 everywhere but `axis`)."""
    _int8_mode(mode)
    x32 = x.float()
    red = tuple(d for d in range(x32.dim()) if d != axis % x32.dim())
    scale = _scale(torch.amax(torch.abs(x32), dim=red, keepdim=True), mode)
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_tensor(x):
    """Per-tensor int8 quantization of a conv activation (quant.py:374-376):
    one scale from max|x| over the whole tensor, the padded bucket rows
    included. Returns (q int8, scale f32 scalar)."""
    x32 = x.float()
    scale = _scale(torch.amax(torch.abs(x32)), "int8")
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def weight_qparams(w, axis: int, mode: str = "int8"):
    """Host-side quantize_channelwise for serving admission (quant.py:303):
    numpy (or a tensor, read back as f32 numpy) in, (q int8, scale f32,
    relative RMS error of the dequantized weight) out, in numpy."""
    _int8_mode(mode)
    if isinstance(w, torch.Tensor):
        w = w.detach().float().cpu().numpy()
    w32 = np.asarray(w, np.float32)
    red = tuple(d for d in range(w32.ndim) if d != axis % w32.ndim)
    amax = np.max(np.abs(w32), axis=red, keepdims=True)
    scale = np.maximum(amax, 1e-12) / _QMAX[mode]
    q = np.clip(np.rint(w32 / scale), -127, 127).astype(np.int8)
    deq = q.astype(np.float32) * scale
    denom = float(np.sqrt(np.mean(w32 * w32))) or 1.0
    err = float(np.sqrt(np.mean((deq - w32) ** 2))) / denom
    return q, scale.astype(np.float32), err


# --- quantized compute ---------------------------------------------------

def int_matmul(xq, yq):
    """The exact int32 product of int8 xq [M, K] and yq [K, N]. CPU: an f64
    product of the int8 values (every partial sum is an integer below
    2^53, so exact). CUDA: cuBLAS's int8 GEMM (`torch._int_mm`), with M
    padded to at least 32 rows and N to a multiple of 8, as it asks."""
    if xq.device.type == "cpu":
        return torch.matmul(xq.double(), yq.double()).to(torch.int32)
    m, k = xq.shape
    n = yq.shape[1]
    mp, np_ = max(32, -(-m // 8) * 8), -(-n // 8) * 8
    if mp != m:
        xq = F.pad(xq, (0, 0, 0, mp - m))
    if np_ != n:
        yq = F.pad(yq, (0, np_ - n))
    return torch._int_mm(xq.contiguous(), yq.contiguous())[:m, :n]


def _qmm_forward(x, y, pre):
    with registry.span(ACT_SPAN):
        xq, sx = quantize_channelwise(x, axis=0)           # [M, 1] rows
    yq, sy = pre if pre is not None else quantize_channelwise(y, axis=1)
    acc = int_matmul(xq, yq).float()
    return (acc * (sx * sy)).to(x.dtype)


class _QMatmul(torch.autograd.Function):
    """Quantized forward, plain-product backward (quant.py:340-357)."""

    @staticmethod
    def forward(ctx, x, y, pre):
        ctx.save_for_backward(x, y)
        return _qmm_forward(x, y, pre)

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        gx = torch.matmul(g, y.transpose(-1, -2)).to(x.dtype)
        gy = torch.matmul(x.transpose(-1, -2), g).to(y.dtype)
        return gx, gy, None


def qmatmul(x, y, mode: str = "int8", pre=None):
    """Quantized x [M, K] @ y [K, N] -> [M, N] in x.dtype: per-row
    activation scales, per-column weight scales, exact int32 accumulation,
    `acc * (sx * sy)` rounded once. `pre` gives admission-time (q, scale)
    for y; y still flows in for the backward."""
    _int8_mode(mode)
    return _QMatmul.apply(x, y, pre)


def _qconv_forward(x, w, strides, paddings, dilations, pre):
    with registry.span(ACT_SPAN):
        xq, sx = quantize_tensor(x)
    wq, sw = pre if pre is not None else quantize_channelwise(w, axis=0)
    dq = (sx * sw.reshape(-1)).float()                     # [Co]
    return conv_cuda.conv2d_q8(xq, wq, strides, paddings, dilations, dq,
                               out_dtype=x.dtype)


class _QConv(torch.autograd.Function):
    """Quantized NHWC conv forward (K11), plain bf16 conv backward
    (quant.py:386-414)."""

    @staticmethod
    def forward(ctx, x, w, strides, paddings, dilations, pre):
        ctx.save_for_backward(x, w)
        ctx.geom = (strides, paddings, dilations)
        return _qconv_forward(x, w, strides, paddings, dilations, pre)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        s, p, d = ctx.geom
        with torch.enable_grad():
            xv = x.detach().requires_grad_(True)
            wv = w.detach().requires_grad_(True)
            y = F.conv2d(xv.permute(0, 3, 1, 2), wv, stride=tuple(s),
                         padding=tuple(p), dilation=tuple(d))
            gx, gw = torch.autograd.grad(
                y, (xv, wv), g.permute(0, 3, 1, 2).to(y.dtype))
        return gx.to(x.dtype), gw.to(w.dtype), None, None, None, None


def qconv2d(x, w, strides, paddings, dilations, mode: str = "int8",
            pre=None):
    """Quantized conv of x [N, H, W, Ci] with w [Co, Ci, KH, KW] -> [N, OH,
    OW, Co] in x.dtype, through K11: a per-tensor activation scale, per-Co
    weight scales, exact int32 sums, `acc * (sx * sw[co])` rounded once.
    The caller must have passed `ineligible_conv`."""
    _int8_mode(mode)
    return _QConv.apply(x, w, tuple(strides), tuple(paddings),
                        tuple(dilations), pre)


# --- serving admission ---------------------------------------------------

# the persistable operand each quantizable op's weight sits in
_WEIGHT_SLOTS = {"mul": "Y", "conv2d": "Filter"}


def prequantized(ctx, name: str):
    """The admission-time (q, scale) of weight `name`, or None."""
    cache = getattr(ctx.program, "_quant_weights", None)
    return cache.get(name) if cache else None


def prequantize(program, scope, mode: str = "int8", device="cpu",
                folded=()) -> dict:
    """Quantize every persistable weight of `program`'s quantizable ops
    once, from its scope value (quant.py:443): (q, scale) pairs on
    `device`, kept on the program for the lowerings. A weight whose
    dequantization error exceeds QUANT_TOL stays unquantized ("error_bound",
    counted). Returns {"quantized": [names], "skipped": {name: reason}}.
    The filters named in `folded` (those of fold windows) are checked and
    reported but not kept: a folded conv never reads its raw filter's
    values, the fold quantizes the folded filter (ops/fusion.fold_constants)."""
    cache, quantized, skipped = {}, [], {}
    block = program.global_block()
    for op_ in block.ops:
        slot = _WEIGHT_SLOTS.get(op_.type)
        names = op_.desc.inputs.get(slot, []) if slot else []
        if not names or names[0] in quantized or names[0] in skipped:
            continue
        name = names[0]
        var = block.desc.vars.get(name)
        if var is None or not var.persistable:
            continue
        w = scope.find_var(name)
        if w is None:
            skipped[name] = "shape"
            continue
        if isinstance(w, torch.Tensor):
            ok = w.dtype in _FLOAT_IN
        else:
            w = np.asarray(w)
            ok = w.dtype == np.float32
        if not ok:
            skipped[name] = "dtype"
            count_fallback(op_.type, "dtype")
            continue
        q, scale, err = weight_qparams(w, 0 if slot == "Filter" else -1, mode)
        if err > QUANT_TOL:
            skipped[name] = "error_bound"
            count_fallback(op_.type, "error_bound")
            continue
        quantized.append(name)
        if name in folded:
            continue
        q = torch.from_numpy(q).to(device)
        if slot == "Filter":      # an OIHW view of OHWI memory, as K11 reads
            q = q.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)
        cache[name] = (q, torch.from_numpy(scale).to(device))
    program._quant_weights = cache
    return {"quantized": sorted(quantized), "skipped": skipped}
