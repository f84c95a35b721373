"""The conv kernels for Hopper — K1 (forward), K2 (grad input), K3 (grad
filter), K4 (forward + channel statistics) — with their one gate, their
plain versions and their counters (the port's counterpart of
paddle_tpu/ops/pallas_conv.py).

Replaces: paddle_tpu/ops/pallas_conv.py `conv2d` (:412) -> `_conv_call`
(:331) -> `_fwd_kernel` (:204), the Pallas TPU kernel that ResNet's
conv -> batch_norm windows reach under AMP.

Kernel: `csrc/conv2d_fwd.cu`, CUDA C++ for sm_90a, built by nvcc at first
use (ops/cuda_build.py) and called through ctypes. An implicit GEMM: M =
N*OH*OW output pixels, N = Co, K = KH*KW*Ci, 128x128 output tiles, im2col
addresses and padding zero-fill computed in the kernel, a two-stage
cp.async ring, wmma bf16 MMAs into f32 fragments, one rounding to the
output type. The TPU kernel's row walk (one output row per grid step, BH
rows sharing a filter tile, `_block_h` :324) is a VMEM fact and is not
copied.

Bound on an H100: the larger of 2*M*Co*KH*KW*Ci FLOPs against 989 TF/s
bf16 and the bytes of x (the pixels the stride reads), w and y against
3.35 TB/s; in ResNet-50 at batch 16 the 3x3 convs are operation-bound and
the 1x1 convs byte-bound.
`chip_smoke.py` times the kernel beside that bound, the plain version and
cuDNN (`F.conv2d`, a yardstick only), and PERF.md keeps the numbers. This
first kernel is simple and right: wgmma, TMA, a deeper ring and split-K
for the small late-stage grids are later work.

K2, `conv2d_grad_input` (replaces pallas_conv.py:445): K1's own kernel
run as the JAX package does it (:451-468) on the cotangent dilated by the
stride, with the filter flipped and its channel axes swapped, at stride 1.
The kernel takes symmetric padding but explicit OH/OW and zero-fills every
read outside the input, so padding lo = (K-1)*d - p with OH = H gives the
hi padding H - Hd + p for free. At stride 2 three quarters of the dilated
cotangent are zeros the kernel multiplies: 4x the work of a direct dgrad.
K3, `conv2d_grad_filter` (replaces pallas_conv.py:471 -> `_wgrad_kernel`
:282): `csrc/conv2d_wgrad.cu`, an implicit GEMM with M = Co, N = KH*KW*Ci
and the reduction over N*OH*OW split across blocks into an f32 workspace
reduced in a fixed order. K4, `conv2d_stats` (replaces pallas_conv.py:420
-> `_fwd_stats_kernel` :241): K1's kernel with a statistics epilogue
(`conv2d_fwd_stats` in conv2d_fwd.cu), y bitwise K1's. K2 and K3 are bound
like K1 (operations at the 3x3 convs, bytes at the 1x1 convs); K2's bound
counts the undilated work.

K11, `conv2d_q8` (replaces pallas_conv.py `conv2d_q8` :431 -> `_conv_call`
(:331) -> `_fwd_kernel` :204 in its int8 form): `csrc/conv2d_q8.cu`, an
implicit GEMM like K1's with int8 operands (the filter passed OHWI, the
reduction axis minor), mma.sync m16n8k32 s8 into exact int32 sums, and an
epilogue that rounds each sum to f32, multiplies it by the f32 dequant
scale of its output channel and rounds once to bf16 — the reference's
arithmetic, so kernel and plain version agree bitwise. Bound: the larger of
2*M*Co*KH*KW*Ci integer operations against 1,979 TOP/s int8 and the bytes
of x (the pixels read, one each), w (one each), dq and y against 3.35
TB/s. Its gate is `quant.ineligible_conv` (the reference's 128-channel
rule); the kernel itself needs Ci, Co % 16.

Routing follows the JAX package: `ineligible` is the one gate, with the
reason vocabulary of pallas_conv.py:84-86; a shape that fails it goes to
`torch.nn.functional.conv2d` (as the JAX package goes to lax.conv) and is
counted by op and reason. On a CPU tensor the wrapper computes the plain
version; on a CUDA tensor it launches the kernel or raises — there is no
fallback that hides the kernel.
"""

from __future__ import annotations

import contextlib
import ctypes
from dataclasses import dataclass, field
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from . import cuda_build

__all__ = ["FALLBACK_REASONS", "COUNTERS", "conv2d", "conv2d_reference",
           "conv2d_grad_input", "conv2d_grad_input_reference",
           "conv2d_grad_filter", "conv2d_grad_filter_reference",
           "conv2d_stats", "conv2d_stats_reference", "conv2d_q8",
           "conv2d_q8_reference", "wgrad_splits",
           "ineligible", "count_hit", "count_fallback", "suppress_counters",
           "conv_flops", "conv_bytes", "input_bytes"]

# The JAX package's reason vocabulary. "disabled" (its kill switch,
# PADDLE_TPU_PALLAS_CONV=0) has no counterpart in the port yet, so
# `ineligible` never returns it.
FALLBACK_REASONS = frozenset(
    {"disabled", "rank", "groups", "dtype", "channels", "attrs", "geometry"})

# 16-byte vector loads: Ci and Co in multiples of 8 bf16 values (K1-K4) or
# 16 int8 values (K11)
_VEC = 8
_VEC_Q8 = 16


@dataclass
class Counters:
    """Kernel launches, one field per wrapper and added to only where that
    wrapper launches its kernel: `launches` K1 (`conv2d`),
    `dgrad_launches` K2 (`conv2d_grad_input`, which runs K1's code),
    `wgrad_launches` K3 (`conv2d_grad_filter`), `stats_launches` K4
    (`conv2d_stats`), `q8_launches` K11 (`conv2d_q8`). `hits`/`fallbacks`: lowerings routed to the kernels
    or to the library path, by op and by (op, reason) — the counterparts of
    the JAX package's pallas_kernel_total / pallas_fallback_total.
    `layout_copies`: cotangents conv2d_grad had to copy into channels_last
    memory."""
    launches: int = 0
    dgrad_launches: int = 0
    wgrad_launches: int = 0
    stats_launches: int = 0
    q8_launches: int = 0
    layout_copies: int = 0
    hits: Dict[str, int] = field(default_factory=dict)
    fallbacks: Dict[Tuple[str, str], int] = field(default_factory=dict)

    def reset(self):
        self.launches = self.dgrad_launches = 0
        self.wgrad_launches = self.stats_launches = 0
        self.q8_launches = 0
        self.layout_copies = 0
        self.hits.clear()
        self.fallbacks.clear()


COUNTERS = Counters()
_SUPPRESS = [False]


@contextlib.contextmanager
def suppress_counters():
    """Silence count_hit/count_fallback while a grad lowering re-runs the
    forward lowering (conv2d_grad's generic fallback), which already
    counted itself on the forward pass (pallas_conv.suppress_counters)."""
    prev = _SUPPRESS[0]
    _SUPPRESS[0] = True
    try:
        yield
    finally:
        _SUPPRESS[0] = prev


def count_hit(op: str):
    if not _SUPPRESS[0]:
        COUNTERS.hits[op] = COUNTERS.hits.get(op, 0) + 1


def count_fallback(op: str, reason: str):
    if not _SUPPRESS[0]:
        key = (op, reason)
        COUNTERS.fallbacks[key] = COUNTERS.fallbacks.get(key, 0) + 1


def ineligible(x, w, strides, paddings, dilations, groups=1):
    """None when the kernel applies, else the fallback reason.

    `x` is the NHWC operand after the AMP cast, `w` the OIHW filter, as in
    pallas_conv.ineligible. The envelope is Hopper's: Ci and Co multiples of
    8 (16-byte loads) where the TPU needed 128-lane tiles, and no width
    limit (the TPU's `_MAX_W` is a VMEM budget). It admits every shape the
    JAX gate admits. `p <= (K-1)*d` stays under "geometry" so that a later
    backward kernel agrees with this route.
    """
    if getattr(x, "ndim", 0) != 4 or getattr(w, "ndim", 0) != 4:
        return "rank"
    if (groups or 1) != 1:
        return "groups"
    if getattr(x, "dtype", None) != torch.bfloat16 or \
            getattr(w, "dtype", None) != torch.bfloat16:
        return "dtype"
    ci = x.shape[3]
    co, ci_w, kh, kw = w.shape
    if ci % _VEC or co % _VEC or ci_w != ci:
        return "channels"
    if len(strides) != 2 or len(paddings) != 2 or len(dilations) != 2:
        return "attrs"
    sh, sw = strides
    ph, pw = paddings
    dh, dw = dilations
    keh, kew = (kh - 1) * dh + 1, (kw - 1) * dw + 1
    oh = (x.shape[1] + 2 * ph - keh) // sh + 1
    ow = (x.shape[2] + 2 * pw - kew) // sw + 1
    if oh < 1 or ow < 1 or ph > keh - 1 or pw > kew - 1:
        return "geometry"
    return None


def _out_hw(x_nhwc, w, strides, paddings, dilations):
    _, h, wd, _ = x_nhwc.shape
    _, _, kh, kw = w.shape
    oh = (h + 2 * paddings[0] - ((kh - 1) * dilations[0] + 1)) // strides[0] + 1
    ow = (wd + 2 * paddings[1] - ((kw - 1) * dilations[1] + 1)) // strides[1] + 1
    return oh, ow


def conv_flops(x_nhwc, w, strides, paddings, dilations) -> int:
    """2*M*Co*KH*KW*Ci for one call (every MAC is needed: no data-dependent
    skipping)."""
    n = x_nhwc.shape[0]
    oh, ow = _out_hw(x_nhwc, w, strides, paddings, dilations)
    co, ci, kh, kw = w.shape
    return 2 * n * oh * ow * co * kh * kw * ci


def _positions_read(size, k, s, p, d, out) -> int:
    """How many of an axis's `size` input positions some output reads (a
    stride above the kernel's reach skips the rest)."""
    return len({o * s + i * d - p for o in range(out) for i in range(k)}
               & set(range(size)))


def input_bytes(x_nhwc, w, strides, paddings, dilations) -> int:
    """The bytes of the input pixels the conv reads, each once: all of x,
    except where the stride skips pixels (a 1x1 conv at stride 2 reads one
    in four)."""
    n, h, wd, ci = x_nhwc.shape
    _, _, kh, kw = w.shape
    oh, ow = _out_hw(x_nhwc, w, strides, paddings, dilations)
    rows = _positions_read(h, kh, strides[0], paddings[0], dilations[0], oh)
    cols = _positions_read(wd, kw, strides[1], paddings[1], dilations[1], ow)
    return n * rows * cols * ci * x_nhwc.element_size()


def conv_bytes(x_nhwc, w, strides, paddings, dilations, out_bytes=2) -> int:
    """Each input element the conv needs read once (in its own element
    size: 2 bytes bf16, 1 int8; `input_bytes` for x), the output written
    once."""
    n = x_nhwc.shape[0]
    oh, ow = _out_hw(x_nhwc, w, strides, paddings, dilations)
    co = w.shape[0]
    return (input_bytes(x_nhwc, w, strides, paddings, dilations)
            + w.numel() * w.element_size() + n * oh * ow * co * out_bytes)


def conv2d_reference(x, w, strides, paddings, dilations, out_dtype=None):
    """The plain version: x [N, H, W, Ci] bf16, w [Co, Ci, KH, KW] bf16 ->
    y [N, OH, OW, Co]. Computes in float32 from the bf16 values and rounds
    once to `out_dtype` (default x's dtype) — the kernel's arithmetic up to
    the order of the f32 sums. TF32 is off for it on the card."""
    return _conv_f32(x, w, strides, [(p, p) for p in paddings],
                     dilations).to(out_dtype or x.dtype)


def _conv_f32(x, w, strides, pads, dilations):
    """f32 conv of NHWC x with OIHW w and explicit ((lo, hi), (lo, hi))
    padding, NHWC out."""
    xf = x.permute(0, 3, 1, 2).float()
    (lh, hh), (lw, hw) = pads
    padding = (lh, lw)
    if lh != hh or lw != hw:
        xf = F.pad(xf, (lw, hw, lh, hh))
        padding = (0, 0)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y = F.conv2d(xf, w.float(), stride=tuple(strides), padding=padding,
                     dilation=tuple(dilations))
    return y.permute(0, 2, 3, 1)


def _dgrad_operands(dout, w, x_hw, strides, paddings, dilations):
    """K2's stride-1 forward problem (pallas_conv.py:451-468): the
    cotangent dilated by the stride, the filter flipped with its channel
    axes swapped ([Ci, Co, KH, KW]), and the transposed-conv padding."""
    sh, sw = strides
    ph, pw = paddings
    dh, dw = dilations
    _, _, kh, kw = w.shape
    n, oh, ow, co = dout.shape
    hd, wd = (oh - 1) * sh + 1, (ow - 1) * sw + 1
    if sh > 1 or sw > 1:
        dd = torch.zeros((n, hd, wd, co), dtype=dout.dtype, device=dout.device)
        dd[:, ::sh, ::sw, :] = dout
    else:
        dd = dout
    keh, kew = (kh - 1) * dh + 1, (kw - 1) * dw + 1
    pads = ((keh - 1 - ph, x_hw[0] - hd + ph), (kew - 1 - pw, x_hw[1] - wd + pw))
    w_t = torch.flip(w, (2, 3)).transpose(0, 1)
    return dd, w_t, pads


def conv2d_grad_input_reference(dout, w, x_hw, strides, paddings, dilations,
                                out_dtype=None):
    """The plain version of K2: the same dilated, flipped, padded stride-1
    conv in float32, rounded once to `out_dtype` (default dout's)."""
    dd, w_t, pads = _dgrad_operands(dout, w, x_hw, strides, paddings,
                                    dilations)
    return _conv_f32(dd, w_t, (1, 1), pads, dilations).to(
        out_dtype or dout.dtype)


def conv2d_grad_filter_reference(x, dout, kernel_hw, strides, paddings,
                                 dilations, out_dtype=None):
    """The plain version of K3: dW [Co, Ci, KH, KW] = dout^T times the
    im2col of x, summed over every output pixel in float32 (F.unfold and
    one matmul), rounded once to `out_dtype` (default x's)."""
    n, _, _, ci = x.shape
    _, oh, ow, co = dout.shape
    kh, kw = kernel_hw
    cols = F.unfold(x.permute(0, 3, 1, 2).float(), (kh, kw),
                    dilation=tuple(dilations), padding=tuple(paddings),
                    stride=tuple(strides))               # [N, Ci*KH*KW, L]
    cols = cols.permute(1, 0, 2).reshape(ci * kh * kw, n * oh * ow)
    d2 = dout.reshape(n * oh * ow, co).float()
    g = torch.matmul(cols, d2)                          # [Ci*KH*KW, Co]
    return g.t().reshape(co, ci, kh, kw).to(out_dtype or x.dtype)


def conv2d_stats_reference(x, w, strides, paddings, dilations,
                           out_dtype=None):
    """The plain version of K4: (y, csum, csq) with y conv2d_reference's
    and csum/csq [Co] the f32 sums of the rounded y and of its square over
    N, OH, OW (pallas_conv.py:269-273)."""
    y = conv2d_reference(x, w, strides, paddings, dilations, out_dtype)
    yf = y.float().reshape(-1, y.shape[-1])
    return y, yf.sum(0), (yf * yf).sum(0)


def conv2d_q8_reference(x, w, strides, paddings, dilations, dq,
                        out_dtype=None):
    """The plain version of K11: x [N, H, W, Ci] int8, w [Co, Ci, KH, KW]
    int8, dq [Co] f32 -> y [N, OH, OW, Co] = (f32(acc) * dq) rounded once
    to `out_dtype` (bf16 default). acc is the exact sum: an f64 product of
    the im2col of x and the filter (every partial sum an integer below
    2^53), whose conversion to f32 rounds to nearest like the kernel's."""
    n, h, wd, ci = x.shape
    co, _, kh, kw = w.shape
    oh, ow = _out_hw(x, w, strides, paddings, dilations)
    cols = F.unfold(x.permute(0, 3, 1, 2).double(), (kh, kw),
                    dilation=tuple(dilations), padding=tuple(paddings),
                    stride=tuple(strides))               # [N, Ci*KH*KW, L]
    acc = torch.matmul(w.reshape(co, -1).double(), cols)  # [N, Co, L]
    y = acc.float() * dq.float().reshape(1, co, 1)
    return y.reshape(n, co, oh, ow).permute(0, 2, 3, 1).to(
        out_dtype or torch.bfloat16)


def q8_ineligible(x, w, strides, paddings, dilations):
    """None when K11 takes the operands, else why not: int8 NHWC x and OIHW
    w, Ci and Co multiples of 16 (16-byte loads), the geometry K1 takes."""
    if getattr(x, "ndim", 0) != 4 or getattr(w, "ndim", 0) != 4:
        return "rank"
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        return "dtype"
    co, ci, _, _ = w.shape
    if x.shape[3] != ci or ci % _VEC_Q8 or co % _VEC_Q8:
        return "channels"
    probe = torch.empty(x.shape, dtype=torch.bfloat16, device="meta")
    return ineligible(probe, torch.empty(w.shape, dtype=torch.bfloat16,
                                         device="meta"),
                      strides, paddings, dilations)


def wgrad_splits(x_nhwc, w, strides, paddings, dilations, sms=132):
    """(splits, steps_per_split) of K3's pixel reduction: enough splits to
    put about two blocks on each of the card's SMs, each split at least 8
    slices of 32 pixels, every split non-empty."""
    n = x_nhwc.shape[0]
    co, ci, kh, kw = w.shape
    oh, ow = _out_hw(x_nhwc, w, strides, paddings, dilations)
    steps = -(-n * oh * ow // 32)
    tiles = -(-co // 128) * kh * kw * -(-ci // 128)
    splits = max(1, min(-(-2 * sms // tiles), steps // 8))
    per = -(-steps // splits)
    return -(-steps // per), per


# conv2d_fwd(x, w, y, 15 shape/geometry ints, out_f32, stream)
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 16 + [ctypes.c_void_p]
# conv2d_fwd_stats(x, w, y, part_sum, part_sq, csum, csq, 15 ints, out_f32,
# stream)
_STATS_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 16 + [ctypes.c_void_p]
# conv2d_q8(x, w, dq, y, 15 shape/geometry ints, out_f32, stream)
_Q8_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 16 + [ctypes.c_void_p]
# conv2d_wgrad(x, dout, ws, out, 15 ints, splits, steps_per_split, out_f32,
# stream)
_WGRAD_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 18 + [ctypes.c_void_p]


def _check_cuda(name, operands, x, w, strides, paddings, dilations,
                out_dtype):
    """Raise unless the `operands` lie on one CUDA device, x (NHWC) and w
    (OIHW), either of which may be a meta stand-in, pass the gate, and
    out_dtype is one the kernels write."""
    devices = {t.device for t in operands}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{name} kernel needs its operands on one CUDA "
                         f"device, got {sorted(map(str, devices))}")
    reason = ineligible(x, w, strides, paddings, dilations)
    if reason is not None:
        raise ValueError(f"{name} kernel called on an ineligible shape "
                         f"({reason}): x {tuple(x.shape)} {x.dtype}, "
                         f"w {tuple(w.shape)} {w.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name} kernel writes bf16 or f32, not {out_dtype}")


def _raise_on(rc, name, x, w):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error "
                           f"{rc} (x {tuple(x.shape)}, w {tuple(w.shape)})")


def _launch_fwd(x, w_hwio, oh, ow, strides, pads, dilations, out_dtype):
    """One launch of K1's kernel: x NHWC, w_hwio [KH, KW, Ci, Co], symmetric
    `pads`, explicit OH/OW. Counts nothing: its callers do."""
    n, h, wd, ci = x.shape
    kh, kw, _, co = w_hwio.shape
    xc = cuda_build.aligned(x)
    wc = cuda_build.aligned(w_hwio)
    y = torch.empty((n, oh, ow, co), dtype=out_dtype, device=x.device)
    fn = cuda_build.entry("conv2d_fwd", "conv2d_fwd", _ARGTYPES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(xc.data_ptr(), wc.data_ptr(), y.data_ptr(), n, h, wd, ci, co,
            kh, kw, oh, ow, strides[0], strides[1], pads[0], pads[1],
            dilations[0], dilations[1], int(out_dtype == torch.float32),
            stream)
    return y, rc


def conv2d(x, w, strides, paddings, dilations, out_dtype=None):
    """K1. x [N, H, W, Ci] bf16, w [Co, Ci, KH, KW] bf16 -> y [N, OH, OW,
    Co] in `out_dtype` (bf16 default, float32 allowed). The caller must
    have passed `ineligible`. CPU tensors take the plain version; CUDA
    tensors launch the kernel on the current stream, or raise."""
    if x.device.type == "cpu":
        return conv2d_reference(x, w, strides, paddings, dilations, out_dtype)
    out_dtype = out_dtype or torch.bfloat16
    _check_cuda("conv2d", (x, w), x, w, strides, paddings, dilations,
                out_dtype)
    oh, ow = _out_hw(x, w, strides, paddings, dilations)
    y, rc = _launch_fwd(x, w.permute(2, 3, 1, 0), oh, ow, strides, paddings,
                        dilations, out_dtype)
    COUNTERS.launches += 1
    _raise_on(rc, "conv2d_fwd", x, w)
    return y


def conv2d_grad_input(dout, w, x_hw, strides, paddings, dilations,
                      out_dtype=None):
    """K2. dL/dx [N, H, W, Ci] from dout [N, OH, OW, Co] bf16 and w [Co, Ci,
    KH, KW] bf16, in `out_dtype` (default dout's). The caller must have
    passed `ineligible` for the forward conv. CPU tensors take the plain
    version; CUDA tensors launch K1's kernel on the stride-1 problem, or
    raise."""
    if dout.device.type == "cpu":
        return conv2d_grad_input_reference(dout, w, x_hw, strides, paddings,
                                           dilations, out_dtype)
    out_dtype = out_dtype or dout.dtype
    probe = torch.empty((dout.shape[0],) + tuple(x_hw) + (w.shape[1],),
                        dtype=dout.dtype, device="meta")
    _check_cuda("conv2d_grad_input", (dout, w), probe, w, strides, paddings,
                dilations, out_dtype)
    dd, w_t, pads = _dgrad_operands(dout, w, x_hw, strides, paddings,
                                    dilations)
    y, rc = _launch_fwd(dd, w_t.permute(2, 3, 1, 0), x_hw[0], x_hw[1],
                        (1, 1), (pads[0][0], pads[1][0]), dilations,
                        out_dtype)
    COUNTERS.dgrad_launches += 1
    _raise_on(rc, "conv2d_fwd (dgrad)", dout, w)
    return y


def conv2d_grad_filter(x, dout, kernel_hw, strides, paddings, dilations,
                       out_dtype=None):
    """K3. dL/dw [Co, Ci, KH, KW] from x [N, H, W, Ci] bf16 and dout [N, OH,
    OW, Co] bf16, in `out_dtype` (default x's; f32 for f32 master
    filters). CPU tensors take the plain version; CUDA tensors launch the
    kernel, or raise."""
    if x.device.type == "cpu":
        return conv2d_grad_filter_reference(x, dout, kernel_hw, strides,
                                            paddings, dilations, out_dtype)
    out_dtype = out_dtype or x.dtype
    n, h, wd, ci = x.shape
    _, oh, ow, co = dout.shape
    kh, kw = kernel_hw
    probe = torch.empty((co, ci, kh, kw), dtype=dout.dtype, device="meta")
    _check_cuda("conv2d_grad_filter", (x, dout), x, probe, strides, paddings,
                dilations, out_dtype)
    if dout.dtype != torch.bfloat16 or \
            (oh, ow) != _out_hw(x, probe, strides, paddings, dilations):
        raise ValueError(f"conv2d_grad_filter kernel: dout {tuple(dout.shape)}"
                         f" {dout.dtype} does not match x {tuple(x.shape)}")
    splits, per = wgrad_splits(x, probe, strides, paddings, dilations)
    xc, dc = cuda_build.aligned(x), cuda_build.aligned(dout)
    ws = torch.empty((splits, co, kh * kw * ci), dtype=torch.float32,
                     device=x.device)
    out = torch.empty((co, ci, kh, kw), dtype=out_dtype, device=x.device)
    fn = cuda_build.entry("conv2d_wgrad", "conv2d_wgrad", _WGRAD_ARGTYPES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(xc.data_ptr(), dc.data_ptr(), ws.data_ptr(), out.data_ptr(),
            n, h, wd, ci, co, kh, kw, oh, ow, strides[0], strides[1],
            paddings[0], paddings[1], dilations[0], dilations[1], splits, per,
            int(out_dtype == torch.float32), stream)
    COUNTERS.wgrad_launches += 1
    _raise_on(rc, "conv2d_wgrad", x, probe)
    return out


def conv2d_stats(x, w, strides, paddings, dilations, out_dtype=None):
    """K4. (y, csum, csq): K1's y and the f32 sums over N, OH, OW of the
    rounded y and of its square, per output channel. CPU tensors take the
    plain version; CUDA tensors launch the kernel, or raise."""
    if x.device.type == "cpu":
        return conv2d_stats_reference(x, w, strides, paddings, dilations,
                                      out_dtype)
    out_dtype = out_dtype or torch.bfloat16
    _check_cuda("conv2d_stats", (x, w), x, w, strides, paddings, dilations,
                out_dtype)
    n, h, wd, ci = x.shape
    co, _, kh, kw = w.shape
    oh, ow = _out_hw(x, w, strides, paddings, dilations)
    m_tiles = -(-n * oh * ow // 128)
    xc = cuda_build.aligned(x)
    wc = cuda_build.aligned(w.permute(2, 3, 1, 0))
    y = torch.empty((n, oh, ow, co), dtype=out_dtype, device=x.device)
    part = torch.empty((2, m_tiles, co), dtype=torch.float32, device=x.device)
    sums = torch.empty((2, co), dtype=torch.float32, device=x.device)
    fn = cuda_build.entry("conv2d_fwd", "conv2d_fwd_stats", _STATS_ARGTYPES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(xc.data_ptr(), wc.data_ptr(), y.data_ptr(), part[0].data_ptr(),
            part[1].data_ptr(), sums[0].data_ptr(), sums[1].data_ptr(),
            n, h, wd, ci, co, kh, kw, oh, ow, strides[0], strides[1],
            paddings[0], paddings[1], dilations[0], dilations[1],
            int(out_dtype == torch.float32), stream)
    COUNTERS.stats_launches += 1
    _raise_on(rc, "conv2d_fwd_stats", x, w)
    return y, sums[0], sums[1]


def conv2d_q8(x, w, strides, paddings, dilations, dq, out_dtype=None):
    """K11. x [N, H, W, Ci] int8, w [Co, Ci, KH, KW] int8 (any strides; an
    OIHW view of an OHWI-contiguous filter is passed without a copy), dq
    [Co] f32 -> y [N, OH, OW, Co] in `out_dtype` (bf16 default, float32
    allowed). The caller must have passed quant.ineligible_conv. CPU
    tensors take the plain version; CUDA tensors launch the kernel on the
    current stream, or raise."""
    if x.device.type == "cpu":
        return conv2d_q8_reference(x, w, strides, paddings, dilations, dq,
                                   out_dtype)
    out_dtype = out_dtype or torch.bfloat16
    devices = {t.device for t in (x, w, dq)}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"conv2d_q8 kernel needs its operands on one CUDA "
                         f"device, got {sorted(map(str, devices))}")
    reason = q8_ineligible(x, w, strides, paddings, dilations)
    if reason is not None:
        raise ValueError(f"conv2d_q8 kernel called on an ineligible shape "
                         f"({reason}): x {tuple(x.shape)} {x.dtype}, "
                         f"w {tuple(w.shape)} {w.dtype}")
    if dq.dtype != torch.float32 or tuple(dq.shape) != (w.shape[0],):
        raise ValueError(f"conv2d_q8 kernel needs dq f32 [{w.shape[0]}], got "
                         f"{dq.dtype} {tuple(dq.shape)}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"conv2d_q8 kernel writes bf16 or f32, not "
                         f"{out_dtype}")
    n, h, wd, ci = x.shape
    co, _, kh, kw = w.shape
    oh, ow = _out_hw(x, w, strides, paddings, dilations)
    xc = cuda_build.aligned(x)
    wc = cuda_build.aligned(w.permute(0, 2, 3, 1))
    dqc = cuda_build.aligned(dq)
    y = torch.empty((n, oh, ow, co), dtype=out_dtype, device=x.device)
    fn = cuda_build.entry("conv2d_q8", "conv2d_q8", _Q8_ARGTYPES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(xc.data_ptr(), wc.data_ptr(), dqc.data_ptr(), y.data_ptr(),
            n, h, wd, ci, co, kh, kw, oh, ow, strides[0], strides[1],
            paddings[0], paddings[1], dilations[0], dilations[1],
            int(out_dtype == torch.float32), stream)
    COUNTERS.q8_launches += 1
    _raise_on(rc, "conv2d_q8", x, w)
    return y
