"""The conv kernels for Hopper — K1 (forward), K2 (grad input), K3 (grad
filter), K4 (forward + channel statistics) — with their one gate, their
plain versions and their counters (the port's counterpart of
paddle_tpu/ops/pallas_conv.py).

Replaces: paddle_tpu/ops/pallas_conv.py `conv2d` (:412) -> `_conv_call`
(:331) -> `_fwd_kernel` (:204), the Pallas TPU kernel that ResNet's
conv -> batch_norm windows reach under AMP.

Kernel: `csrc/conv2d_fwd.cu`, CUDA C++ for sm_90a, built by nvcc at first
use (ops/cuda_build.py) and called through ctypes. An implicit GEMM on
Hopper's wgmma: M = N*OH*OW output pixels, N = Co, K = KH*KW*Ci in 64-deep
steps (one tap, 64 channels), one producer warp keeping a ring of up to
four shared-memory stages full with TMA tile loads under mbarriers, two
consumer warpgroups of wgmma m64nNk16 bf16 -> f32, one rounding to the
output type. The filter is read by TMA from OHWI memory (K-major, as wgmma
takes it); the pixels as the dense [N*H*W, Ci] matrix for a stride-1 1x1
conv, else as a 4-D box of output pixels at the tap's shifted corner,
with TMA's zero fill as the padding and its element stride as the conv's
stride. The bf16 output leaves by TMA stores. The TPU kernel's row walk
(one output row per grid step, BH rows sharing a filter tile, `_block_h`
:324) is a VMEM fact and is not copied.

`conv_plan` chooses per shape, in Python (tested on the CPU): the pixel
tile (FLAT, or the box of 2**7 output pixels that covers the output in
the fewest tiles), the N tile (64 or 128), split-K for the grids that
cannot fill the card, and the ring's depth; its rules (one for bf16, one
for int8) were chosen by timing the alternatives at every ResNet-50 shape
on the card (tests/torch_conv_sweep.py). A split reduces its workspace
(f32; K11's int32) in a fixed order in a second kernel, so every call is
bitwise repeatable.

The filter is not copied per call: `conv2d` and `conv2d_stats` read an
OIHW view of OHWI memory (channels_last) in place, which is how the
serving fold (`fusion.fold_constants`) and the training casts
(`common.mxu_cast` with `CONV_FORMATS`) store it; any other filter is
copied once and counted in `COUNTERS.filter_copies`.

Bound on an H100: the larger of 2*M*Co*KH*KW*Ci FLOPs against 989 TF/s
bf16 and the bytes of x (the pixels the stride reads), w and y against
3.35 TB/s; in ResNet-50 at batch 16 the 3x3 convs are operation-bound and
the 1x1 convs byte-bound.
`chip_smoke.py` times the kernel beside that bound, the plain version and
cuDNN (`F.conv2d`, a yardstick only), and PERF.md keeps the numbers. What
still holds it back: a block per output tile (no persistent scheduling,
so a tile's epilogue does not overlap the next tile's loads), the masked
rows of the ragged boxes at the 14x14 and 7x7 maps, and split-K's
workspace round trip.

K2, `conv2d_grad_input` (replaces pallas_conv.py:445): K1's own kernel
run as the JAX package does it (:451-468) on the cotangent dilated by the
stride, with the filter flipped and its channel axes swapped, at stride 1.
The swap is one copy per call, written as OHWI; the flip costs none (the
kernel reads the taps in reverse). The kernel takes symmetric padding but
explicit OH/OW and zero-fills every read outside the input, so padding
lo = (K-1)*d - p with OH = H gives the hi padding H - Hd + p for free. At
stride 2 three quarters of the dilated cotangent are zeros the kernel
multiplies: 4x the work of a direct dgrad.
K3, `conv2d_grad_filter` (replaces pallas_conv.py:471 -> `_wgrad_kernel`
:282): `csrc/conv2d_wgrad.cu`, an implicit GEMM on wgmma with M = Co, N =
KH*KW*Ci and the reduction over N*OH*OW in 64-pixel slices, both operands
MN-major (dout^T and the pixels, loaded by TMA as K1's are), a ring of up
to six stages, the reduction split across blocks into an f32 workspace
reduced in a fixed order; the split count follows `_WGRAD_BLOCKS`,
measured on the card. K4, `conv2d_stats` (replaces pallas_conv.py:420 ->
`_fwd_stats_kernel` :241): K1's kernel and plan with a statistics
epilogue on wgmma's accumulator layout, y bitwise K1's. K2 and K3 are
bound like K1 (operations at the 3x3 convs, bytes at the 1x1 convs); K2's
bound counts the undilated work.

K11, `conv2d_q8` (replaces pallas_conv.py `conv2d_q8` :431 -> `_conv_call`
(:331) -> `_fwd_kernel` :204 in its int8 form): K1's kernel body in
`csrc/conv2d_fwd.cu` on int8 operands — the same TMA loads, mbarrier ring
and plan (`conv_plan` with the element size: a step is one tap and 128
channels), wgmma m64nNk32 s8 into exact int32 sums, an epilogue that
rounds each sum to f32, multiplies it by the f32 dequant scale of its
output channel and rounds once to bf16 (the reference's arithmetic, so
kernel and plain version agree bitwise), split-K through an int32
workspace added in order. Its filter is read as K1's is (an OIHW view of
OHWI memory in place, as the serving engine's prequantized filters are
stored; any other copied once and counted). Bound: the larger of
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
import functools
from dataclasses import dataclass, field
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from . import cuda_build

__all__ = ["FALLBACK_REASONS", "COUNTERS", "conv2d", "conv2d_reference",
           "conv2d_grad_input", "conv2d_grad_input_reference",
           "conv2d_grad_filter", "conv2d_grad_filter_reference",
           "conv2d_stats", "conv2d_stats_reference", "conv2d_q8",
           "conv2d_q8_reference", "conv_plan", "wgrad_plan", "wgrad_splits",
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
    memory. `filter_copies`: filters a wrapper had to copy into the OHWI
    memory its kernel reads (K1, K4 and K11 copy none when handed an OIHW
    view of OHWI memory, as the serving fold, the training casts and the
    int8 engine's prequantized filters store them; K2 writes its
    channel-swapped filter once per call)."""
    launches: int = 0
    dgrad_launches: int = 0
    wgrad_launches: int = 0
    stats_launches: int = 0
    q8_launches: int = 0
    layout_copies: int = 0
    filter_copies: int = 0
    hits: Dict[str, int] = field(default_factory=dict)
    fallbacks: Dict[Tuple[str, str], int] = field(default_factory=dict)

    def reset(self):
        self.launches = self.dgrad_launches = 0
        self.wgrad_launches = self.stats_launches = 0
        self.q8_launches = 0
        self.layout_copies = self.filter_copies = 0
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


def _dgrad_input(dout, w, x_hw, strides, paddings, dilations):
    """K2's stride-1 input and padding (pallas_conv.py:451-468): the
    cotangent dilated by the stride, and the transposed conv's ((lo, hi),
    (lo, hi)) padding."""
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
    return dd, pads


def _dgrad_operands(dout, w, x_hw, strides, paddings, dilations):
    """K2's stride-1 forward problem: `_dgrad_input` and the filter flipped
    with its channel axes swapped ([Ci, Co, KH, KW])."""
    dd, pads = _dgrad_input(dout, w, x_hw, strides, paddings, dilations)
    return dd, torch.flip(w, (2, 3)).transpose(0, 1), pads


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


# K1's tile holds 128 output pixels (two warpgroups of 64 rows), K3's
# reduction slice 64; each is a box of 2**7 or 2**6 pixels
_LOG_TILE, _LOG_SLICE = 7, 6


@dataclass(frozen=True)
class ConvPlan:
    """How K1's kernel (and K2's and K4's, which run it) tiles one call.
    `flat`: the pixels are the dense [N*H*W, Ci] matrix (a stride-1 1x1
    conv, no padding), tiles of 128 consecutive pixels; else each tile is a
    box of 2**lbn images x 2**lbh rows x 2**lbw columns of output pixels.
    `block_n`: output channels per tile. `tiles`: pixel tiles. The
    reduction's `steps` (one tap, 64 channels each) are cut into `splits`
    ranges of `per`, through a ring of `stages` shared-memory stages."""
    flat: bool
    lbn: int
    lbh: int
    lbw: int
    block_n: int
    tiles: int
    steps: int
    splits: int
    per: int
    stages: int

    def stat_rows(self, m: int) -> int:
        """Rows of K4's per-tile statistics workspace: one per pixel tile,
        or per 128 rows of the split-K output."""
        return -(-m // 128) if self.splits > 1 else self.tiles


@dataclass(frozen=True)
class WgradPlan:
    """How K3 tiles one call: co tiles of 64 * `nwg`, ci tiles of
    `block_n` per tap, the pixels in `steps` slices of 64 (consecutive
    pixels when `flat`, else boxes of 2**lbn x 2**lbh x 2**lbw output
    pixels), cut into `splits` ranges of `per`, through a ring of `stages`
    shared-memory stages."""
    flat: bool
    lbn: int
    lbh: int
    lbw: int
    nwg: int
    block_n: int
    tiles: int
    steps: int
    splits: int
    per: int
    stages: int


def _is_flat(kh, kw, hw, ohw, strides, pads) -> bool:
    return (kh, kw) == (1, 1) and tuple(strides) == (1, 1) and \
        tuple(pads) == (0, 0) and tuple(ohw) == tuple(hw)


def _box(n, oh, ow, strides, log_pixels):
    """((lbn, lbh, lbw), count): the box of 2**log_pixels output pixels
    (TMA takes at most 256 input elements a dimension, strides included)
    that covers [n, oh, ow] in the fewest boxes; ties go to the wider box,
    whose rows are longer runs of memory."""
    best = None
    for lbw in range(log_pixels + 1):
        for lbh in range(log_pixels - lbw + 1):
            if (1 << lbw) * strides[1] > 256 or (1 << lbh) * strides[0] > 256:
                continue
            lbn = log_pixels - lbw - lbh
            count = (-(-n >> lbn)) * (-(-oh >> lbh)) * (-(-ow >> lbw))
            key = (count, -lbw, -lbh)
            if best is None or key < best[0]:
                best = (key, (lbn, lbh, lbw), count)
    return best[1], best[2]


def conv_plan(x_shape, co, kh, kw, oh, ow, strides, pads, sms=132,
              elem=2) -> ConvPlan:
    """The plan of K1's kernel body (`_conv_plan`) for operands of `elem`
    bytes (2: K1, K2, K4 in bf16; 1: K11 in int8), cached by shape: the
    wrappers sit on the host-bound serving path, and a box search costs
    tens of microseconds."""
    return _conv_plan(tuple(x_shape), co, kh, kw, oh, ow, tuple(strides),
                      tuple(pads), sms, elem)


@functools.lru_cache(maxsize=4096)
def _conv_plan(x_shape, co, kh, kw, oh, ow, strides, pads, sms,
               elem) -> ConvPlan:
    """The plan for x [N, H, W, Ci] (NHWC), Co output channels, a KH x KW
    filter, the output's OH x OW, the strides and (lo) paddings, and the
    operands' element size. One function of the shape: K1 and K4 take the
    same plan, so K4's y is K1's bitwise. A reduction step is one tap and
    one 128-byte row of channels (64 bf16, 128 int8). Split-K where the
    pixel and channel tiles leave SMs idle (ResNet-50's stage 4 at batch
    16, the batch-1 and batch-4 buckets); the reduction's order is fixed by
    the plan, so a repeated call is bitwise equal."""
    if elem == 1:
        return _conv_plan_q8(x_shape, co, kh, kw, oh, ow, strides, pads, sms)
    ci = x_shape[3]
    flat, lb, m_tiles = _pixel_tiles(x_shape, kh, kw, oh, ow, strides, pads)
    steps = kh * kw * -(-ci // 64)
    # the rule below was chosen by timing candidates at every ResNet-50
    # shape of the batch-1, -4 and -16 buckets on an H100
    # (tests/torch_conv_sweep.py): 64 output channels a tile where there
    # are only 64, where 128 would leave at most 16 tiles, or where the
    # reduction is one or two steps deep (the tile's epilogue outweighs its
    # mainloop); split-K only where the grid fills at most a quarter of the
    # SMs, each split at least 8 steps; a 3-stage ring (two blocks per SM)
    # where the grid has 64 tiles or more, else 4 stages
    block_n = 64 if co <= 64 or m_tiles * -(-co // 128) <= 16 or steps <= 2 \
        else 128
    tiles = m_tiles * -(-co // block_n)
    splits = 1
    if tiles <= sms // 4:
        splits = max(1, min(sms // tiles, steps // 8))
    per = -(-steps // splits)
    return ConvPlan(flat, *lb, block_n, m_tiles, steps, -(-steps // per), per,
                    min(per, 3 if tiles >= 64 else 4))


def _pixel_tiles(x_shape, kh, kw, oh, ow, strides, pads):
    """(flat, (lbn, lbh, lbw), pixel tiles) of K1's kernel body: FLAT for
    a stride-1 1x1 conv with no padding, else the box of 2**7 output
    pixels that covers the output in the fewest tiles."""
    n, h, w, _ = x_shape
    if _is_flat(kh, kw, (h, w), (oh, ow), strides, pads):
        return True, (0, 0, _LOG_TILE), -(-n * h * w >> _LOG_TILE)
    lb, m_tiles = _box(n, oh, ow, strides, _LOG_TILE)
    return False, lb, m_tiles


def _conv_plan_q8(x_shape, co, kh, kw, oh, ow, strides, pads, sms):
    """K11's plan: K1's pixel tiles, 128-channel steps (steps = KH*KW*
    ceil(Ci/128)), and its own N tile, split and ring rules."""
    flat, lb, m_tiles = _pixel_tiles(x_shape, kh, kw, oh, ow, strides, pads)
    steps = kh * kw * -(-x_shape[3] // 128)
    # the rule below was chosen by timing candidates at every quantized
    # ResNet-50 shape of the batch-1, -4 and -16 buckets on an H100
    # (`python tests/torch_conv_sweep.py q8`): with half K1's reduction per
    # tile, the epilogue weighs more and 64 output channels a tile was as
    # fast or faster at 41 of the 45 shapes; 128 only where Co >= 1024 and
    # 128-channel tiles fill the card. Split-K, and the ring's depth, as
    # K1's, counted on the 128-channel grid, each split at least 4 steps
    # (8 of K1's): a split's int32 workspace round trip cost up to 3.6x
    # the unsplit call at the one- and two-step 1x1 convs.
    grid128 = m_tiles * -(-co // 128)
    block_n = 128 if co >= 1024 and grid128 >= sms else 64
    splits = 1
    if grid128 <= sms // 4:
        splits = max(1, min(sms // grid128, steps // 4))
    per = -(-steps // splits)
    return ConvPlan(flat, *lb, block_n, m_tiles, steps, -(-steps // per), per,
                    min(per, 3 if grid128 >= 64 else 4))


# K3's split: (blocks to aim for on a 132-SM card, least slices of 64
# pixels a split) by (nwg, block_n). Chosen by timing every split count
# from 1 to 256 at every ResNet-50 training shape at batch 32 on an H100
# (tests/torch_conv_sweep.py); the best splits, by (tiles, slices):
#   128 x 128: (144, 28) 1, (128, 28) 1, (64, 25) 2, (36, 98) 3,
#     (32, 98) 4, (32, 28) 4, (16, 98) 8, (9, 392) 12, (8, 392) 12,
#     (8, 98) 8, (4, 392) 16-24, (2, 392) 44: 64-144 blocks
#   128 x 64 and 64 x 128: (2, 1568) 24-32: 48-64 blocks
#   64 x 64 (three fit on an SM): (9, 1568) 24, (1, 1568) 93
# A ring of 3 stages (two blocks an SM) in place of 6 was slower or even
# at every shape but one.
_WGRAD_BLOCKS = {(2, 128): (99, 7), (2, 64): (64, 7), (1, 128): (64, 7),
                 (1, 64): (216, 16)}


def wgrad_plan(x_shape, dout_shape, kh, kw, strides, paddings,
               sms=132) -> WgradPlan:
    """K3's plan for x [N, H, W, Ci] and dout [N, OH, OW, Co] (NHWC),
    cached by shape."""
    return _wgrad_plan(tuple(x_shape), tuple(dout_shape), kh, kw,
                       tuple(strides), tuple(paddings), sms)


@functools.lru_cache(maxsize=4096)
def _wgrad_plan(x_shape, dout_shape, kh, kw, strides, paddings,
                sms) -> WgradPlan:
    n, h, w, ci = x_shape
    _, oh, ow, co = dout_shape
    if _is_flat(kh, kw, (h, w), (oh, ow), strides, paddings):
        lb, steps, flat = (0, 0, _LOG_SLICE), -(-n * oh * ow >> _LOG_SLICE), True
    else:
        lb, steps = _box(n, oh, ow, strides, _LOG_SLICE)
        flat = False
    nwg = 1 if co <= 64 else 2
    block_n = 64 if ci <= 64 else 128
    tiles = kh * kw * -(-ci // block_n) * -(-co // (64 * nwg))
    blocks, least = _WGRAD_BLOCKS[(nwg, block_n)]
    splits = max(1, min(-(-blocks * sms // 132 // tiles), steps // least))
    per = -(-steps // splits)
    return WgradPlan(flat, *lb, nwg, block_n, tiles, steps,
                     -(-steps // per), per,
                     min(per, 4 if (nwg, block_n) == (1, 64) else 6))


def wgrad_splits(x_nhwc, w, strides, paddings, dilations, sms=132):
    """(splits, steps_per_split) of K3's pixel reduction (`wgrad_plan`):
    the measured number of blocks and least slices of 64 pixels a split
    for its tile shape (`_WGRAD_BLOCKS`), every split non-empty."""
    co, _, kh, kw = w.shape
    oh, ow = _out_hw(x_nhwc, w, strides, paddings, dilations)
    plan = wgrad_plan(tuple(x_nhwc.shape), (x_nhwc.shape[0], oh, ow, co),
                      kh, kw, strides, paddings, sms)
    return plan.splits, plan.per


# conv2d_fwd(x, w, y, ws, part_sum, part_sq, csum, csq, 15 shape/geometry
# ints, flip, flat, lbn, lbh, lbw, block_n, splits, per, stages, out_f32,
# stats, stream)
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 26 + [ctypes.c_void_p]
# conv2d_q8(x, w, dq, y, ws, 15 shape/geometry ints, flat, lbn, lbh, lbw,
# block_n, splits, per, stages, out_f32, stream)
_Q8_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 24 + [ctypes.c_void_p]
# conv2d_wgrad(x, dout, ws, out, 15 ints, flat, lbn, lbh, lbw, nwg, block_n,
# splits, per, stages, out_f32, stream)
_WGRAD_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 25 + [ctypes.c_void_p]


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


def _ohwi(w):
    """The OHWI memory of an OIHW filter `w`, as the kernels read it: a view
    when `w` is an OIHW view of aligned OHWI memory (channels_last, as the
    serving fold and the training casts store filters), else one copy,
    counted in COUNTERS.filter_copies."""
    w_ohwi = w.permute(0, 2, 3, 1)
    if w_ohwi.is_contiguous() and w_ohwi.data_ptr() % 16 == 0:
        return w_ohwi
    COUNTERS.filter_copies += 1
    return cuda_build.aligned(w_ohwi)


def _launch_fwd(x, w_ohwi, oh, ow, strides, pads, dilations, out_dtype,
                stats=False, flip=False):
    """One launch of K1's kernel: x NHWC, w_ohwi [Co, KH, KW, Ci] contiguous
    (`flip`: its taps read in reverse, K2's flipped filter), symmetric
    `pads`, explicit OH/OW; the plan from `conv_plan`. Returns (y, sums,
    rc), sums [2, Co] f32 (Σy, Σy²) when `stats`, else None. Counts
    nothing: its callers do."""
    n, h, wd, ci = x.shape
    co, kh, kw, _ = w_ohwi.shape
    plan = conv_plan((n, h, wd, ci), co, kh, kw, oh, ow, strides, pads)
    xc = cuda_build.aligned(x)
    dev = x.device
    y = torch.empty((n, oh, ow, co), dtype=out_dtype, device=dev)
    m = n * oh * ow
    ws = part = sums = None
    if plan.splits > 1:
        ws = torch.empty((plan.splits, m, co), dtype=torch.float32, device=dev)
    if stats:
        part = torch.empty((2, plan.stat_rows(m), co), dtype=torch.float32,
                           device=dev)
        sums = torch.empty((2, co), dtype=torch.float32, device=dev)

    def ptr(t, i=None):
        return 0 if t is None else (t if i is None else t[i]).data_ptr()
    fn = cuda_build.entry("conv2d_fwd", "conv2d_fwd", _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(xc.data_ptr(), w_ohwi.data_ptr(), y.data_ptr(), ptr(ws),
            ptr(part, 0), ptr(part, 1), ptr(sums, 0), ptr(sums, 1),
            n, h, wd, ci, co, kh, kw, oh, ow, strides[0], strides[1],
            pads[0], pads[1], dilations[0], dilations[1], int(flip),
            int(plan.flat), plan.lbn, plan.lbh, plan.lbw, plan.block_n,
            plan.splits, plan.per, plan.stages, int(out_dtype == torch.float32),
            int(stats), stream)
    return y, sums, rc


def conv2d(x, w, strides, paddings, dilations, out_dtype=None):
    """K1. x [N, H, W, Ci] bf16, w [Co, Ci, KH, KW] bf16 -> y [N, OH, OW,
    Co] in `out_dtype` (bf16 default, float32 allowed). An OIHW view of
    OHWI memory is read in place; any other filter is copied once, and
    counted. The caller must have passed `ineligible`. CPU tensors take the
    plain version; CUDA tensors launch the kernel on the current stream, or
    raise."""
    if x.device.type == "cpu":
        return conv2d_reference(x, w, strides, paddings, dilations, out_dtype)
    out_dtype = out_dtype or torch.bfloat16
    _check_cuda("conv2d", (x, w), x, w, strides, paddings, dilations,
                out_dtype)
    oh, ow = _out_hw(x, w, strides, paddings, dilations)
    y, _, rc = _launch_fwd(x, _ohwi(w), oh, ow, strides, paddings, dilations,
                           out_dtype)
    COUNTERS.launches += 1
    _raise_on(rc, "conv2d_fwd", x, w)
    return y


def conv2d_grad_input(dout, w, x_hw, strides, paddings, dilations,
                      out_dtype=None):
    """K2. dL/dx [N, H, W, Ci] from dout [N, OH, OW, Co] bf16 and w [Co, Ci,
    KH, KW] bf16, in `out_dtype` (default dout's). The caller must have
    passed `ineligible` for the forward conv. CPU tensors take the plain
    version; CUDA tensors launch K1's kernel on the stride-1 problem, or
    raise. The kernel reads the filter with its channel axes swapped,
    written once per call as [Ci, KH, KW, Co] (counted in filter_copies),
    and its taps in reverse: the flip costs no copy."""
    if dout.device.type == "cpu":
        return conv2d_grad_input_reference(dout, w, x_hw, strides, paddings,
                                           dilations, out_dtype)
    out_dtype = out_dtype or dout.dtype
    probe = torch.empty((dout.shape[0],) + tuple(x_hw) + (w.shape[1],),
                        dtype=dout.dtype, device="meta")
    _check_cuda("conv2d_grad_input", (dout, w), probe, w, strides, paddings,
                dilations, out_dtype)
    dd, pads = _dgrad_input(dout, w, x_hw, strides, paddings, dilations)
    w_swapped = w.permute(1, 2, 3, 0).contiguous()
    COUNTERS.filter_copies += 1
    y, _, rc = _launch_fwd(dd, w_swapped, x_hw[0], x_hw[1], (1, 1),
                           (pads[0][0], pads[1][0]), dilations, out_dtype,
                           flip=True)
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
    plan = wgrad_plan(tuple(x.shape), tuple(dout.shape), kh, kw, strides,
                      paddings)
    xc, dc = cuda_build.aligned(x), cuda_build.aligned(dout)
    ws = torch.empty((plan.splits, co, kh * kw * ci), dtype=torch.float32,
                     device=x.device)
    out = torch.empty((co, ci, kh, kw), dtype=out_dtype, device=x.device)
    fn = cuda_build.entry("conv2d_wgrad", "conv2d_wgrad", _WGRAD_ARGTYPES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(xc.data_ptr(), dc.data_ptr(), ws.data_ptr(), out.data_ptr(),
            n, h, wd, ci, co, kh, kw, oh, ow, strides[0], strides[1],
            paddings[0], paddings[1], dilations[0], dilations[1],
            int(plan.flat), plan.lbn, plan.lbh, plan.lbw, plan.nwg,
            plan.block_n, plan.splits, plan.per, plan.stages,
            int(out_dtype == torch.float32), stream)
    COUNTERS.wgrad_launches += 1
    _raise_on(rc, "conv2d_wgrad", x, probe)
    return out


def conv2d_stats(x, w, strides, paddings, dilations, out_dtype=None):
    """K4. (y, csum, csq): K1's y and the f32 sums over N, OH, OW of the
    rounded y and of its square, per output channel. The filter is read as
    K1 reads it. CPU tensors take the plain version; CUDA tensors launch
    the kernel, or raise."""
    if x.device.type == "cpu":
        return conv2d_stats_reference(x, w, strides, paddings, dilations,
                                      out_dtype)
    out_dtype = out_dtype or torch.bfloat16
    _check_cuda("conv2d_stats", (x, w), x, w, strides, paddings, dilations,
                out_dtype)
    oh, ow = _out_hw(x, w, strides, paddings, dilations)
    y, sums, rc = _launch_fwd(x, _ohwi(w), oh, ow, strides, paddings,
                              dilations, out_dtype, stats=True)
    COUNTERS.stats_launches += 1
    _raise_on(rc, "conv2d_fwd_stats", x, w)
    return y, sums[0], sums[1]


def conv2d_q8(x, w, strides, paddings, dilations, dq, out_dtype=None):
    """K11. x [N, H, W, Ci] int8, w [Co, Ci, KH, KW] int8 (an OIHW view of
    OHWI memory is read in place; any other filter is copied once, and
    counted in COUNTERS.filter_copies), dq [Co] f32 -> y [N, OH, OW, Co]
    in `out_dtype` (bf16 default, float32 allowed). The caller must have
    passed quant.ineligible_conv. CPU tensors take the plain version; CUDA
    tensors launch the kernel on the current stream, or raise."""
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
    plan = conv_plan((n, h, wd, ci), co, kh, kw, oh, ow, strides, paddings,
                     elem=1)
    xc = cuda_build.aligned(x)
    wc = _ohwi(w)
    dqc = cuda_build.aligned(dq)
    y = torch.empty((n, oh, ow, co), dtype=out_dtype, device=x.device)
    ws = None
    if plan.splits > 1:
        ws = torch.empty((plan.splits, n * oh * ow, co), dtype=torch.int32,
                         device=x.device)
    fn = cuda_build.entry("conv2d_fwd", "conv2d_q8", _Q8_ARGTYPES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(xc.data_ptr(), wc.data_ptr(), dqc.data_ptr(), y.data_ptr(),
            0 if ws is None else ws.data_ptr(),
            n, h, wd, ci, co, kh, kw, oh, ow, strides[0], strides[1],
            paddings[0], paddings[1], dilations[0], dilations[1],
            int(plan.flat), plan.lbn, plan.lbh, plan.lbw, plan.block_n,
            plan.splits, plan.per, plan.stages,
            int(out_dtype == torch.float32), stream)
    COUNTERS.q8_launches += 1
    _raise_on(rc, "conv2d_fwd_q8", x, w)
    return y
