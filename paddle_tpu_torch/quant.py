"""Quantized compute: the third AMP level, O3 (the port's counterpart of
paddle_tpu/quant.py, int8 and fp8).

`amp.decorate(optimizer, level="O3").minimize(loss)` (training) and
`ServingEngine(..., quantize="int8" | "fp8")` (serving) mark a program O3
with a quant mode (`PADDLE_TPU_QUANT_MODE`, "int8" by default, read when
`amp.enable` runs), and the `mul`, `matmul` and `conv2d` lowerings route
eligible compute through this module:

  * weights are quantized symmetrically per output channel (scale =
    max|w| / 127, or / 448 for fp8 e4m3, per column of a `mul` Y, per Co
    of a conv filter), activations per row (`mul`) or per tensor (conv),
    at each call;
  * the int8 product accumulates exactly in int32, the fp8 product in f32,
    and dequantizes by the product of the two scales, rounded once to the
    activation's dtype (bf16 under O3), as the reference does
    (quant.py:330-337, :369-383);
  * the conv runs K11, `ops/conv_cuda.conv2d_q8` (the port of the Pallas
    int8 conv; fp8 convs fall back with "mode", as in the reference); the
    `mul` product is a library GEMM on the card, `torch._int_mm` (int8) or
    `torch._scaled_mm` (fp8) (the reference leaves both to XLA's dot,
    outside Pallas);
  * every quantize pass, and the dequantize epilogue of a quantized
    product, goes through Q1's wrappers (`ops/quant_cuda.py`): the port's
    fused quantize kernel on the card, its plain versions on the CPU
    (exported here as `quantize_tensor` and `quantize_channelwise`);
  * `qmatmul` and `qconv2d` are autograd Functions whose backward is the
    plain bf16 product's (straight-through), as the reference's
    custom_vjp; the training graph's explicit grads (`mul_grad`,
    `matmul_grad`, `conv2d_grad` on K2/K3) compute the same products from
    the bf16 operands and re-run no quantized forward;
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

Switches (the reference's, read at import): PADDLE_TPU_QUANT ("1"; "0"
makes every gate answer "disabled", so O3 runs bitwise as O2) and
PADDLE_TPU_QUANT_TOL (0.06, the error bound of the gates and of
admission). `QUANT` and `QUANT_TOL` are read at every call, so a caller may
change them at run time; `cache_token(program)` is the part of the
executor's graph key they and the mode make.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .ops import conv_cuda, quant_cuda, registry

__all__ = ["FALLBACK_REASONS", "QUANT", "QUANT_TOL", "QUANT_OPS", "COUNTERS",
           "cache_token", "count_hit", "count_fallback", "suppress_counters",
           "error_estimate", "ineligible_matmul", "ineligible_conv",
           "quantize_channelwise", "quantize_tensor", "weight_qparams",
           "int_matmul", "fp8_matmul", "qmatmul", "qconv2d", "prequantize",
           "prequantized"]

QUANT = os.environ.get("PADDLE_TPU_QUANT", "1") == "1"
QUANT_TOL = float(os.environ.get("PADDLE_TPU_QUANT_TOL", "0.06"))

# every reason the gates can return (the reference's vocabulary)
FALLBACK_REASONS = frozenset(
    {"disabled", "mode", "rank", "dtype", "shape", "kernel", "error_bound"})

# RMS relative quantization noise per operand element (the reference's
# error model, quant.py:38-45)
_EPS_RMS = {"int8": 1.0 / (127.0 * math.sqrt(12.0)),
            "fp8": 2.0 ** -3 / math.sqrt(12.0)}

_FLOAT_IN = (torch.bfloat16, torch.float32)

# the registered op types that route through this module (quant.py:96)
QUANT_OPS = {
    "mul": "qmatmul",
    "matmul": "qmatmul",
    "conv2d": "qconv2d",
    "depthwise_conv2d": "qconv2d",   # groups: always falls back ("kernel")
}

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


def cache_token(program):
    """The quant part of the executor's graph key (quant.py:104):
    everything that changes how the lowerings route, beyond the program
    itself, read now."""
    return (getattr(program, "_quant_mode", None), QUANT, QUANT_TOL)


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
    if mode not in quant_cuda.QMAX:
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
    is a prerequisite, asked first: "kernel" where it fails, whatever the
    switch and the mode, as the reference's conv lowering counts it (it
    asks its kernel gate before the quant gate, nn_ops.py:300-318)."""
    if _reference_kernel_gate(x, w, strides, paddings, dilations,
                              groups) is not None:
        return "kernel"
    if not QUANT:
        return "disabled"
    if mode != "int8":
        return "mode"      # the reference's quantized conv is int8 only
    co, ci, kh, kw = w.shape
    if error_estimate(ci * kh * kw, mode) > QUANT_TOL:
        return "error_bound"
    return None


# --- quantizers ----------------------------------------------------------

# the plain versions of Q1 (ops/quant_cuda.py), kept beside the kernel
quantize_channelwise = quant_cuda.quantize_channelwise_reference
quantize_tensor = quant_cuda.quantize_tensor_reference


def weight_qparams(w, axis: int, mode: str = "int8"):
    """The reference's host-side admission quantizer (quant.py:303), the
    same numbers in numpy (admission itself, `prequantize`, runs Q1's
    wrappers on the weight's device): numpy (or a tensor, read back as f32
    numpy) in, (q, scale f32, relative RMS error of the dequantized
    weight) out; q is numpy int8, or for fp8 a CPU float8_e4m3fn tensor
    (numpy has no fp8 type), scale numpy."""
    quant_cuda.check_mode(mode)
    if isinstance(w, torch.Tensor):
        w = w.detach().float().cpu().numpy()
    w32 = np.asarray(w, np.float32)
    red = tuple(d for d in range(w32.ndim) if d != axis % w32.ndim)
    amax = np.max(np.abs(w32), axis=red, keepdims=True)
    scale = np.maximum(amax, 1e-12) / quant_cuda.QMAX[mode]
    if mode == "fp8":
        q = torch.from_numpy(np.ascontiguousarray(w32 / scale)).to(
            torch.float8_e4m3fn)
        deq = q.float().numpy() * scale
    else:
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
    padded to at least 32 rows and N to a multiple of 8, as it asks, and B
    column-major (yq a view of [N, K] memory, as Q1 writes it; any other
    yq is copied so), which it runs several times faster. The result may
    be a slice of the padded product."""
    if xq.device.type == "cpu":
        return torch.matmul(xq.double(), yq.double()).to(torch.int32)
    m, k = xq.shape
    n = yq.shape[1]
    mp, np_ = max(32, -(-m // 8) * 8), -(-n // 8) * 8
    if mp != m:
        xq = F.pad(xq, (0, 0, 0, mp - m))
    b = yq.t()                                             # [N, K]
    if np_ != n:
        b = F.pad(b, (0, 0, 0, np_ - n))
    return torch._int_mm(xq.contiguous(), b.contiguous().t())[:m, :n]


def _pad_fp8(t, rows, cols):
    """t [r, c] e4m3 as a contiguous [rows, cols] with zeros past its end
    (zeros add nothing to a product)."""
    if tuple(t.shape) == (rows, cols) and t.is_contiguous():
        return t
    out = torch.zeros((rows, cols), dtype=torch.uint8, device=t.device)
    out[:t.shape[0], :t.shape[1]] = t.view(torch.uint8)
    return out.view(torch.float8_e4m3fn)


def fp8_matmul(xq, yq):
    """The f32 product of e4m3 xq [M, K] and yq [K, N] (quant.py:322-325).
    CPU: an f32 product of the values widened to f32. CUDA: cuBLAS's fp8
    GEMM (`torch._scaled_mm`) with unit scales, an f32 output and
    use_fast_accum off; M, K and N padded with zeros to multiples of 16 and
    B column-major, as it asks (a yq from Q1 or admission is already a
    view of [N, K] memory). Hopper's fp8 tensor cores add the products
    with fewer bits than f32 between the promotions to the f32
    accumulator, so the card's sums are not the CPU's bit for bit."""
    if xq.device.type == "cpu":
        return torch.matmul(xq.float(), yq.float())
    m, k = xq.shape
    n = yq.shape[1]
    mp, kp, np_ = (-(-v // 16) * 16 for v in (m, k, n))
    a = _pad_fp8(xq, mp, kp)
    b = _pad_fp8(yq.t(), np_, kp)
    one = torch.ones((), dtype=torch.float32, device=xq.device)
    out = torch._scaled_mm(a, b.t(), scale_a=one, scale_b=one,
                           out_dtype=torch.float32, use_fast_accum=False)
    return out[:m, :n]


def _qmm_forward(x, y, mode, pre):
    with registry.span(ACT_SPAN):
        xq, sx = quant_cuda.quantize_rows(x, mode)         # [M, 1] rows
    yq, sy = pre if pre is not None else quant_cuda.quantize_cols(y, mode)
    acc = int_matmul(xq, yq) if mode == "int8" else fp8_matmul(xq, yq)
    return quant_cuda.dequantize(acc, sx, sy, x.dtype)


class _QMatmul(torch.autograd.Function):
    """Quantized forward, plain-product backward (quant.py:340-357)."""

    @staticmethod
    def forward(ctx, x, y, mode, pre):
        ctx.save_for_backward(x, y)
        return _qmm_forward(x, y, mode, pre)

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        gx = torch.matmul(g, y.transpose(-1, -2)).to(x.dtype)
        gy = torch.matmul(x.transpose(-1, -2), g).to(y.dtype)
        return gx, gy, None, None


def qmatmul(x, y, mode: str = "int8", pre=None):
    """Quantized x [M, K] @ y [K, N] -> [M, N] in x.dtype: per-row
    activation scales, per-column weight scales, exact int32 (fp8: f32)
    accumulation, `acc * (sx * sy)` rounded once. `pre` gives
    admission-time (q, scale) for y, in the mode's type; y still flows in
    for the backward."""
    quant_cuda.check_mode(mode)
    return _QMatmul.apply(x, y, mode, pre)


def _qconv_forward(x, w, strides, paddings, dilations, pre):
    with registry.span(ACT_SPAN):
        xq, sx = quant_cuda.quantize_tensor(x)
    wq, sw = pre if pre is not None else quant_cuda.quantize_filter(w)
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
    The caller must have passed `ineligible_conv`, which answers "mode"
    for anything but int8."""
    if mode != "int8":
        raise ValueError(f"the quantized conv is int8 (the gate answers "
                         f"'mode' for {mode!r})")
    return _QConv.apply(x, w, tuple(strides), tuple(paddings),
                        tuple(dilations), pre)


# --- serving admission ---------------------------------------------------

# the persistable operand each quantizable op's weight sits in
_WEIGHT_SLOTS = {"mul": "Y", "matmul": "Y", "conv2d": "Filter",
                 "depthwise_conv2d": "Filter"}


def prequantized(ctx, name: str):
    """The admission-time (q, scale) of weight `name`, or None."""
    cache = getattr(ctx.program, "_quant_weights", None)
    return cache.get(name) if cache else None


def _admit(w, slot, mode):
    """One admitted weight through Q1's wrappers, on w's device: (q, scale,
    relative RMS error of the dequantized weight, in f32). A filter's q is
    an OIHW view of OHWI memory (as K11 reads it), a `mul` Y's a [K, N]
    view of [N, K] memory on the card."""
    w32 = w.float()
    quantize = quant_cuda.quantize_filter if slot == "Filter" else \
        quant_cuda.quantize_cols
    q, scale = quantize(w32, mode)
    denom = float(torch.sqrt(torch.mean(w32 * w32))) or 1.0
    err = float(torch.sqrt(torch.mean((q.float() * scale - w32) ** 2)))
    return q, scale, err / denom


def prequantize(program, scope, mode: str = "int8", device="cpu",
                folded=()) -> dict:
    """Quantize every persistable weight of `program`'s quantizable ops
    once, from its scope value (quant.py:443): (q, scale) pairs on
    `device`, kept on the program for the lowerings. Conv filters are
    quantized in int8 whatever the mode, `mul`/`matmul` weights in `mode`
    (quant.py:482). A weight whose dequantization error exceeds QUANT_TOL
    stays unquantized ("error_bound", counted); a transposed matmul Y is
    skipped ("shape": the cache holds [K, N]). The quantization runs
    through Q1's wrappers on `device` (the kernel on the card, its plain
    version on the CPU). Returns {"quantized": [names], "skipped": {name:
    reason}}. The filters named in `folded` (those of fold windows) are
    checked and reported but not kept: a folded conv never reads its raw
    filter's values, the fold quantizes the folded filter
    (ops/fusion.fold_constants)."""
    cache, quantized, skipped = {}, [], {}
    device = torch.device(device)
    block = program.global_block()
    for op_ in block.ops:
        slot = _WEIGHT_SLOTS.get(op_.type)
        names = op_.desc.inputs.get(slot, []) if slot else []
        if not names or names[0] in quantized or names[0] in skipped:
            continue
        name = names[0]
        if op_.type == "matmul" and op_.attr("transpose_Y", False):
            skipped[name] = "shape"
            continue
        var = block.desc.vars.get(name)
        if var is None or not var.persistable:
            continue
        w = scope.find_var(name)
        if w is None:
            skipped[name] = "shape"
            continue
        if not isinstance(w, torch.Tensor):
            w = np.asarray(w)
            w = torch.from_numpy(w) if w.dtype == np.float32 else None
        if w is None or w.dtype not in _FLOAT_IN:
            skipped[name] = "dtype"
            count_fallback(op_.type, "dtype")
            continue
        use_mode = "int8" if slot == "Filter" else mode
        q, scale, err = _admit(w.to(device), slot, use_mode)
        if err > QUANT_TOL:
            skipped[name] = "error_bound"
            count_fallback(op_.type, "error_bound")
            continue
        quantized.append(name)
        if name not in folded:
            cache[name] = (q, scale)
    program._quant_weights = cache
    return {"quantized": sorted(quantized), "skipped": skipped}
