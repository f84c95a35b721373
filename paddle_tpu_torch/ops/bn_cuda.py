"""The batch-norm kernels for Hopper — K5 (`bn_apply`, Triton) and K6
(`bn_act`, CUDA C++) — with their gate, their plain versions and their
counters.

K5 replaces paddle_tpu/ops/pallas_conv.py `bn_apply` (:507) ->
`_bn_apply_kernel` (:303): given per-channel statistics,
ybn = (x - mean) * (rsqrt(var + eps) * scale) + bias rounded to bf16, and
yact = act(ybn), over the [M, C] view of an NHWC activation (M = N*H*W).
It is the epilogue of the conv -> bn [-> act] training window, whose
statistics come from K4 (ops/conv_cuda.py `conv2d_stats`). One Triton
kernel: x read once, one or two bf16 outputs written.

K6 replaces paddle_tpu/ops/fusion.py `_pallas_bn_act` (:738) ->
`_bn_act_kernel` (:697): training batch norm [+ act] with its own
statistics, mean = sum / M and the clamped one-pass variance
max(E[x^2] - mean^2, 0) (fusion.py:720-722), then K5's normalize. One
cooperative launch of `csrc/bn_act.cu` (built by nvcc at first use,
ops/cuda_build.py, called through ctypes), one CTA an SM: per-CTA partial
sums over the CTA's tiles of rows (`bn_act_plan`), a grid-wide hand-off
that adds them in CTA order, then the normalize over the CTA's tiles in
reverse, the last ones read from the CTA's shared memory and the rest from
L2. No float atomics: a repeated call is bitwise equal, and
`bn_act_stats_in_order` repeats its summation order in plain PyTorch.

K6's split form, for a batch split over ranks (parallel/spmd.py), is the
same source as two launches: `bn_act_sums` writes the [2, C] per-channel
sum and sum of squares in K6's fixed order (its plain version
`bn_act_sums_in_order`), the caller all-reduces them over the ranks, and
`bn_act_apply` derives mean, var and the scale from the global sums and
rows as K6 does and normalizes [+ act] this rank's rows. On one rank the
two launches give K6's bits.

Both are bandwidth-bound: no tensor-core work. Their bound on an H100 is x
read once plus the outputs written once against 3.35 TB/s; K6 reads x a
second time, from shared memory and L2 as far as they hold it. The
activations
implemented are identity and relu (`ACTS`, the kernels' act code), the
only ones on the ResNet path; any other is a counted fallback with reason
`act`.

Triton is imported, and K5 compiled, only inside its launching function;
K6 is built at its first launch: the CPU has neither triton nor nvcc, and
the CPU tests import every module. On a CPU tensor a wrapper computes its
plain version; on a CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch

from . import cuda_build

__all__ = ["ACTS", "COUNTERS", "bn_apply", "bn_apply_reference", "bn_act",
           "bn_act_reference", "bn_act_plan", "bn_act_stats_in_order",
           "bn_act_sums_in_order", "bn_act_sums", "bn_act_apply",
           "bn_act_apply_reference", "launch_plan", "ineligible",
           "count_hit", "count_fallback", "one_pass_moments"]

# activation name -> the kernels' ACT code
ACTS = {None: 0, "relu": 1}

# the JAX package's fusion_fallback_total reasons for this kernel, plus
# "act" for an activation the port's kernels do not implement
FALLBACK_REASONS = frozenset(
    {"kernel_is_test", "kernel_layout", "kernel_dtype", "kernel_shape", "act"})

_BLOCK_M = 64
_BLOCK_C = 64

# K6 (csrc/bn_act.cu): threads a CTA, and the fewest passes of its row
# groups a CTA is given, so that a small [M, C] takes few CTAs
BN_THREADS = 512
_MIN_PASSES = 8


@dataclass
class Counters:
    """`apply_launches`: K5 launches made by `bn_apply`; `act_launches`: K6
    launches, one per `bn_act` call and one per launch of its split form
    (`bn_act_sums`, `bn_act_apply`), which `split_launches` also counts by
    form ('sums', 'apply'); each added to only where its wrapper launches.
    `hits`/`fallbacks`: windows routed to the kernels or to the plain
    batch_norm lowering, by op and by (op, reason): a window counts once,
    a hit or a fallback."""
    apply_launches: int = 0
    act_launches: int = 0
    hits: Dict[str, int] = field(default_factory=dict)
    fallbacks: Dict[Tuple[str, str], int] = field(default_factory=dict)
    split_launches: Dict[str, int] = field(default_factory=dict)

    def reset(self):
        self.apply_launches = self.act_launches = 0
        self.hits.clear()
        self.fallbacks.clear()
        self.split_launches.clear()


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


def one_pass_moments(s, sq, rows, spmd=None):
    """Per-channel mean and clamped one-pass variance max(sq / rows -
    mean^2, 0) from a channel's sum `s` and sum of squares `sq` (f32 [C])
    over `rows` values: the statistics K5 applies after K4's sums, and the
    bf16 batch_norm's. In a sharded run whose batch is split over ranks
    (`spmd`, a parallel/spmd.py Spmd) the sums are this rank's: they are
    all-reduced first, in one collective, and `rows` counts every rank's
    rows."""
    if spmd is not None:
        s, sq = spmd.batch_sum(torch.stack([s, sq]), site="bn_stats")
        rows = rows * spmd.nb
    mean = s / float(rows)
    return mean, torch.clamp(sq / float(rows) - mean * mean, min=0.0)


def bn_act_reference(x2, scale, bias, eps, act=None):
    """The plain version of K6: (ybn, yact, mean, var), the statistics in
    f32 with the clamped one-pass variance."""
    xf = x2.float()
    mean = xf.mean(0)
    var = torch.clamp((xf * xf).mean(0) - mean * mean, min=0.0)
    ybn, yact = bn_apply_reference(x2, scale, bias, mean, var, eps, act)
    return ybn, yact, mean, var


# --- K5: the Triton kernel (its body; compiled by _jit on first use) ---------

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
    # rsqrt, as the plain version, the reference and K6 take it; the launch
    # turns off FMA contraction, so the multiply and the add each round as
    # the plain version's separate ops do
    a = tl.rsqrt(var + eps) * scale
    y = ((x - mean[None, :]) * a[None, :] + bias[None, :]).to(tl.bfloat16)
    tl.store(ybn_ptr + offs, y, mask=mask)
    if ACT == 1:
        tl.store(yact_ptr + offs, tl.maximum(y, 0.0).to(tl.bfloat16),
                 mask=mask)


_JIT: Dict[str, object] = {}


def _jit():
    """K5, compiled by Triton at its first launch."""
    if not _JIT:
        import triton
        import triton.language
        globals()["tl"] = triton.language
        _JIT.update(apply=triton.jit(_bn_apply_body))
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
                          BLOCK_C=_BLOCK_C, enable_fp_fusion=False)
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


def bn_act_plan(m, c, sms, per_sm=1):
    """(ctas, rows, vec) of K6's one launch on a card of `sms` SMs that each
    hold `per_sm` of its CTAs (one: a CTA keeps 192 KB of x in shared
    memory): `vec` channels a load (8, 16 bytes, where C is a multiple of
    8; else 1); x cut into tiles of `rows` rows (a CTA's row groups:
    BN_THREADS threads over the row's chunks of `vec`, at most BN_THREADS
    chunks a slab), tile t taken by CTA t mod ctas; at most sms * per_sm
    CTAs (a cooperative launch must be co-resident), each at least one tile
    and, where M allows, about _MIN_PASSES of them."""
    vec = 8 if c % 8 == 0 else 1
    rows = BN_THREADS // min(c // vec, BN_THREADS)
    tiles = _cdiv(m, rows)
    return max(1, min(sms * per_sm, _cdiv(tiles, _MIN_PASSES))), rows, vec


def bn_act_stats_in_order(x2, ctas, rows, vec):
    """K6's (mean, var) with its summation order, in f32, from x2 [M, C]
    and its plan (`bn_act_sums_in_order`, then the kernel's moments)."""
    m, c = x2.shape
    sums = bn_act_sums_in_order(x2, ctas, rows, vec)
    # a tensor, not a scalar: PyTorch's CUDA division by a scalar multiplies
    # by its reciprocal, which is not the kernel's (or IEEE's) quotient
    fm = torch.full((c,), float(m), dtype=torch.float32, device=x2.device)
    mean = sums[0] / fm
    var = torch.clamp(sums[1] / fm - mean * mean, min=0.0)
    return mean, var


def bn_act_sums_in_order(x2, ctas, rows, vec):
    """K6's per-channel [sum(x), sum(x^2)] ([2, C] f32) with its summation
    order, from x2 [M, C] and its plan: each thread of a CTA sums its `vec`
    channels over its row of each of the CTA's tiles in tile order (slabs
    of at most BN_THREADS chunks side by side), the CTA adds its `rows` row
    groups in order, and lane l of a channel's warp adds the CTAs l, l +
    32, ... in order before a butterfly of shuffles joins the lanes. Every
    f32 add is the kernel's, so this repeats it bit for bit (and the split
    form's statistics launch, `bn_act_sums`, too)."""
    m, c = x2.shape
    dev = x2.device
    slab = min(c // vec, BN_THREADS) * vec
    xf = x2.float()
    xf = torch.cat([xf, xf.new_zeros((-m % rows, c))])  # zeros add nothing
    tiles = xf.reshape(-1, rows, c)
    part = torch.empty((ctas, 2, c), dtype=torch.float32, device=dev)
    for b in range(ctas):
        mine = tiles[b::ctas]
        for st, terms in enumerate((mine, mine * mine)):
            acc = torch.zeros((rows, c), dtype=torch.float32, device=dev)
            for t in terms:
                acc = acc + t
            for c0 in range(0, c, slab):
                cols = slice(c0, c0 + slab)
                tot = acc[0, cols]
                for i in range(1, rows):
                    tot = tot + acc[i, cols]
                part[b, st, cols] = tot
    lanes = torch.zeros((32, 2, c), dtype=torch.float32, device=dev)
    for k in range(ctas):
        lanes[k % 32] = lanes[k % 32] + part[k]
    lane = torch.arange(32, device=dev)
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[lane ^ off]
    return lanes[0]


_OCCUPANCY: Dict[Tuple[int, int], int] = {}
_BARRIERS: Dict[int, torch.Tensor] = {}


def _bn_act_entry(name, argtypes):
    return cuda_build.entry("bn_act", name, argtypes)


def _per_sm(vec, act):
    """K6's CTAs per SM for (vec, act), from the CUDA occupancy query."""
    key = (vec, ACTS[act])
    if key not in _OCCUPANCY:
        blocks = ctypes.c_int(0)
        fn = _bn_act_entry("bn_act_occupancy", [ctypes.c_int, ctypes.c_int,
                                                ctypes.c_void_p])
        rc = fn(vec, ACTS[act], ctypes.cast(ctypes.pointer(blocks),
                                            ctypes.c_void_p))
        if rc != 0 or blocks.value < 1:
            raise RuntimeError(f"bn_act occupancy query failed: CUDA {rc}, "
                               f"{blocks.value} CTAs an SM")
        _OCCUPANCY[key] = blocks.value
    return _OCCUPANCY[key]


def _barrier(device):
    """The device's grid-barrier counter: zeroed once, outside any graph
    capture, and left zeroed by every launch."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _BARRIERS:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("bn_act: the first call on a device must not "
                               "be captured in a CUDA graph")
        _BARRIERS[idx] = torch.zeros(1, dtype=torch.int32, device=device)
    return _BARRIERS[idx]


def launch_plan(x2, act):
    """bn_act_plan on x2's card: its SMs, and the CTAs an SM holds as the
    CUDA occupancy query gives them."""
    m, c = x2.shape
    sms = torch.cuda.get_device_properties(x2.device).multi_processor_count
    return bn_act_plan(m, c, sms, _per_sm(8 if c % 8 == 0 else 1, act))


def bn_act(x2, scale, bias, eps, act=None):
    """K6. x2 [M, C] bf16; scale, bias f32 [C] -> (ybn, yact, mean, var):
    batch statistics of x2 (f32, clamped one-pass variance) and the
    normalized bf16 outputs, yact None when act is. CPU tensors take the
    plain version; CUDA tensors launch the kernel, or raise."""
    if x2.device.type == "cpu":
        return bn_act_reference(x2, scale, bias, eps, act)
    _check("bn_act", x2, (scale, bias), act)
    x2 = cuda_build.aligned(x2)
    m, c = x2.shape
    ctas, rows, vec = launch_plan(x2, act)
    ybn = torch.empty_like(x2)
    yact = torch.empty_like(x2) if act is not None else None
    stats = torch.empty((3, c), dtype=torch.float32, device=x2.device)
    part = torch.empty((ctas, 2, c), dtype=torch.float32, device=x2.device)
    scale, bias = scale.contiguous(), bias.contiguous()
    fn = _bn_act_entry("bn_act", [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
    rc = fn(x2.data_ptr(), scale.data_ptr(), bias.data_ptr(), ybn.data_ptr(),
            None if yact is None else yact.data_ptr(), stats[0].data_ptr(),
            stats[1].data_ptr(), part.data_ptr(), stats[2].data_ptr(),
            _barrier(x2.device).data_ptr(), m, c, ctas, float(eps), vec,
            ACTS[act], torch.cuda.current_stream(x2.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bn_act kernel launch failed with CUDA error {rc} "
                           f"(x {m}x{c}, {ctas} CTAs, tiles of {rows} rows)")
    COUNTERS.act_launches += 1
    return ybn, yact, stats[0], stats[1]


# --- K6's split form: a statistics launch and a normalize launch --------------

def bn_act_apply_reference(x2, sums, rows, scale, bias, eps, act=None):
    """The plain version of the split form's normalize: (ybn, yact, mean,
    var) from the global sums [2, C] f32 over `rows` rows, as K6 derives
    its statistics (mean = sum / rows, the clamped one-pass variance),
    then K5's plain apply."""
    mean, var = one_pass_moments(sums[0], sums[1], rows)
    ybn, yact = bn_apply_reference(x2, scale, bias, mean, var, eps, act)
    return ybn, yact, mean, var


def bn_act_sums(x2):
    """K6's statistics launch: [2, C] f32, the per-channel sum of x2 [M, C]
    bf16 and of its squares, in K6's order over K6's plan. CPU tensors
    take the plain sums; CUDA tensors launch the kernel, or raise."""
    if x2.device.type == "cpu":
        xf = x2.float()
        return torch.stack([xf.sum(0), (xf * xf).sum(0)])
    _check("bn_act_sums", x2, (), None)
    x2 = cuda_build.aligned(x2)
    m, c = x2.shape
    ctas, rows, vec = launch_plan(x2, None)
    sums = torch.empty((2, c), dtype=torch.float32, device=x2.device)
    part = torch.empty((ctas, 2, c), dtype=torch.float32, device=x2.device)
    fn = _bn_act_entry("bn_act_sums", [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    rc = fn(x2.data_ptr(), sums.data_ptr(), part.data_ptr(),
            _barrier(x2.device).data_ptr(), m, c, ctas, vec,
            torch.cuda.current_stream(x2.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bn_act_sums kernel launch failed with CUDA error "
                           f"{rc} (x {m}x{c}, {ctas} CTAs)")
    COUNTERS.act_launches += 1
    COUNTERS.split_launches["sums"] = COUNTERS.split_launches.get("sums", 0) + 1
    return sums


def bn_act_apply(x2, sums, rows, scale, bias, eps, act=None):
    """K6's normalize launch: (ybn, yact, mean, var) of x2 [M, C] bf16 from
    the global sums [2, C] f32 over `rows` rows (every rank's), yact None
    when act is. CPU tensors take the plain version; CUDA tensors launch
    the kernel, or raise."""
    if x2.device.type == "cpu":
        return bn_act_apply_reference(x2, sums, rows, scale, bias, eps, act)
    _check("bn_act_apply", x2, (scale, bias), act)
    if sums.dtype != torch.float32 or tuple(sums.shape) != (2, x2.shape[1]) \
            or sums.device != x2.device:
        raise ValueError(f"bn_act_apply takes [2, C] f32 sums on x's card, "
                         f"got {tuple(sums.shape)} {sums.dtype}")
    x2 = cuda_build.aligned(x2)
    m, c = x2.shape
    ctas, _, vec = launch_plan(x2, act)
    ybn = torch.empty_like(x2)
    yact = torch.empty_like(x2) if act is not None else None
    stats = torch.empty((2, c), dtype=torch.float32, device=x2.device)
    sums = sums.contiguous()
    scale, bias = scale.contiguous(), bias.contiguous()
    fn = _bn_act_entry("bn_act_apply", [ctypes.c_void_p] * 8
                       + [ctypes.c_int] * 3
                       + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                          ctypes.c_int, ctypes.c_void_p])
    rc = fn(x2.data_ptr(), scale.data_ptr(), bias.data_ptr(), sums.data_ptr(),
            ybn.data_ptr(), None if yact is None else yact.data_ptr(),
            stats[0].data_ptr(), stats[1].data_ptr(), m, c, ctas,
            float(rows), float(eps), vec, ACTS[act],
            torch.cuda.current_stream(x2.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bn_act_apply kernel launch failed with CUDA error "
                           f"{rc} (x {m}x{c}, {ctas} CTAs)")
    COUNTERS.act_launches += 1
    COUNTERS.split_launches["apply"] = \
        COUNTERS.split_launches.get("apply", 0) + 1
    return ybn, yact, stats[0], stats[1]
