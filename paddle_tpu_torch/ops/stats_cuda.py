"""T1 (`tensor_stats`, Triton): one tensor reduced to the inspector's [8]
float32 stats vector on the card, with its gate, its plain version and its
counters.

T1 replaces no Pallas kernel. The reference's `tensor_stats` is jnp that
XLA fuses into the jitted step (paddle_tpu/inspector.py:94-136
`_tensor_stats_lower`): min, max, mean, abs-mean and l2 over the finite
elements, then the NaN count, the Inf count and the size. Its plain PyTorch
form costs about a dozen launches a probe and three temporaries of the
tensor's size (the masks and the masked copy); a probed ResNet-50 step
under GradientAudit probes its 161 parameter gradients and the `auto`
sites inside one captured graph, so that form would put thousands of nodes
and gigabytes of temporaries into it. T1 reads the tensor once.

Design. Two stages. The first is a grid of at most `_PARTS` programs
(eight an SM), four warps each, each striding over blocks of `_BLOCK`
elements: loads in the tensor's dtype (f32, bf16, fp16), converts to f32,
masks NaN and Inf, and keeps per lane the sum, the sum of |x|, the sum of
squares, the min and the max of the finite values, and the NaN and Inf
counts as int32; at its end it reduces the lanes and writes one row of
partials (five f32, two int32). The second stage is one program that
reduces the partials, the counts in int64, and writes the vector; only
there are the counts cast to f32. A tensor of one block (most of a step's
probes: biases, norms' scales) takes one launch, the first stage writing
the vector itself. No atomics: a repeated call is bitwise equal. The
finite count is the size less the NaN and Inf counts; with no finite
element min and max read 0. A tensor dense in some order of its dims (the
channels-last activations) is read in its memory order as a flat view:
the statistics do not depend on the order, and `contiguous()` would copy
it first (0.200 ms of a [32, 256, 56, 56] bf16 activation, 13x T1's
bound). The grid was sized on the card (`tests/torch_t1_probe.py`): at that
shape 264 programs of 1024 elements took 0.070 ms, one program a block of
4096 0.116, 1056 programs of 2048 0.040 (the bound 0.015).

Its bound on an H100 is the tensor read once (the partials and the [8]
output are a few KB) over 3.35 TB/s. At the probe sites of a training
step most tensors are small, so launch latency, not bandwidth, sets its
time there. No single PyTorch call computes all eight fields.

Triton is imported, and T1 compiled, inside its launching function: the CPU
has no triton, and the CPU tests import every module. On a CPU tensor the
wrapper computes the plain version (`tensor_stats_reference`); on a CUDA
tensor it launches T1 or raises (the gate: f32, bf16 or fp16, at least one
element). The op's lowering (inspector.py) routes what the gate refuses
before calling it: an empty tensor is zeros, an integer tensor is cast to
f32 first, and a float64 one takes the plain version, counted as a
fallback with reason `float64` (its masks must see the f64 values).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import torch

__all__ = ["COUNTERS", "N_FIELDS", "KERNEL_DTYPES", "tensor_stats",
           "tensor_stats_reference", "ineligible", "count_fallback",
           "bytes_read"]

N_FIELDS = 8
KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)

_BLOCK = 2048
_PARTS = 1056           # programs of the first stage, at most: 8 an SM
_FINISH_BLOCK = 1024


@dataclass
class Counters:
    """`launches`: T1 calls made by `tensor_stats` (each one or two
    launches, its stages, counted once), added to only where the wrapper
    launches;
    `fallbacks`: probes the lowering computed with the plain version on a
    CUDA device, by reason."""
    launches: int = 0
    fallbacks: Dict[str, int] = field(default_factory=dict)

    def reset(self):
        self.launches = 0
        self.fallbacks.clear()


COUNTERS = Counters()


def count_fallback(reason: str):
    COUNTERS.fallbacks[reason] = COUNTERS.fallbacks.get(reason, 0) + 1


def ineligible(x: torch.Tensor):
    """None when T1 takes `x`, else the reason it does not."""
    if x.dtype not in KERNEL_DTYPES:
        return "float64" if x.dtype == torch.float64 else "dtype"
    if x.numel() == 0:
        return "empty"
    return None


def bytes_read(x: torch.Tensor) -> int:
    """What T1 must move: the tensor once (its bound's numerator)."""
    return x.numel() * x.element_size()


def tensor_stats_reference(x: torch.Tensor) -> torch.Tensor:
    """The plain version: [min, max, mean, abs_mean, l2, nan_count,
    inf_count, size] of x as f32, over the finite elements, on x's device.
    The masks read x in its own dtype; the sums are taken in float64 and
    rounded to f32 once (an upper bound on T1's accuracy, whose f32
    partial sums it is held to by tolerance)."""
    k = N_FIELDS
    if x.numel() == 0:
        return torch.zeros((k,), dtype=torch.float32, device=x.device)
    if x.is_floating_point():
        nan = torch.isnan(x)
        inf = torch.isinf(x)
    else:
        nan = inf = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    finite = ~(nan | inf)
    n_finite = int(finite.sum())
    xd = x.double()
    safe = torch.where(finite, xd, torch.zeros((), dtype=torch.float64,
                                                device=x.device))
    denom = float(max(n_finite, 1))
    if n_finite:
        mn = torch.where(finite, xd, torch.full((), float("inf"),
                                                 dtype=torch.float64,
                                                 device=x.device)).min()
        mx = torch.where(finite, xd, torch.full((), float("-inf"),
                                                 dtype=torch.float64,
                                                 device=x.device)).max()
        # min/max in f32 as the reference reads them (an f64 value past
        # f32's range rounds to inf there too)
        mn, mx = mn.float(), mx.float()
    else:
        mn = mx = torch.zeros((), dtype=torch.float32, device=x.device)
    fields = [mn, mx, (safe.sum() / denom).float(),
              (safe.abs().sum() / denom).float(),
              # the sum of squares rounded to f32 before the root: past
              # f32's range it is inf, as the reference's (and T1's) f32
              # sum is
              safe.square().sum().float().sqrt(),
              nan.sum().float(), inf.sum().float(),
              torch.tensor(float(x.numel()), device=x.device)]
    return torch.stack([f.reshape(()).float() for f in fields])


_JIT: Dict[str, object] = {}


def _stats_partial_body(x_ptr, part_ptr, cnt_ptr, out_ptr, n, size_f, n_parts,
                        BLOCK: tl.constexpr,  # noqa: F821
                        SINGLE: tl.constexpr):  # noqa: F821
    """Stage 1: program p strides over blocks p, p + n_parts, ...; one row
    of partials [sum, abs_sum, sq_sum, min, max] f32 and [nan, inf] int32,
    or with SINGLE (one program, one block) the vector itself."""
    pid = tl.program_id(0)
    lanes = tl.arange(0, BLOCK)
    acc_s = tl.zeros([BLOCK], dtype=tl.float32)
    acc_a = tl.zeros([BLOCK], dtype=tl.float32)
    acc_q = tl.zeros([BLOCK], dtype=tl.float32)
    acc_mn = tl.full([BLOCK], float("inf"), dtype=tl.float32)
    acc_mx = tl.full([BLOCK], float("-inf"), dtype=tl.float32)
    acc_nan = tl.zeros([BLOCK], dtype=tl.int32)
    acc_inf = tl.zeros([BLOCK], dtype=tl.int32)
    steps = tl.cdiv(n, BLOCK * n_parts)
    for it in range(0, steps):
        offs = (it * n_parts + pid).to(tl.int64) * BLOCK + lanes
        m = offs < n
        x = tl.load(x_ptr + offs, mask=m, other=0.0).to(tl.float32)
        is_nan = x != x
        is_inf = tl.abs(x) == float("inf")
        fin = m & (~is_nan) & (~is_inf)
        xs = tl.where(fin, x, 0.0)
        acc_s += xs
        acc_a += tl.abs(xs)
        acc_q += xs * xs
        acc_mn = tl.minimum(acc_mn, tl.where(fin, x, float("inf")))
        acc_mx = tl.maximum(acc_mx, tl.where(fin, x, float("-inf")))
        acc_nan += (m & is_nan).to(tl.int32)
        acc_inf += (m & is_inf).to(tl.int32)
    if SINGLE:
        n_nan = tl.sum(acc_nan, axis=0)
        n_inf = tl.sum(acc_inf, axis=0)
        n_fin = n - n_nan - n_inf
        has = n_fin > 0
        denom = tl.maximum(n_fin, 1).to(tl.float32)
        tl.store(out_ptr + 0, tl.where(has, tl.min(acc_mn, axis=0), 0.0))
        tl.store(out_ptr + 1, tl.where(has, tl.max(acc_mx, axis=0), 0.0))
        tl.store(out_ptr + 2, tl.sum(acc_s, axis=0) / denom)
        tl.store(out_ptr + 3, tl.sum(acc_a, axis=0) / denom)
        tl.store(out_ptr + 4, tl.sqrt(tl.sum(acc_q, axis=0)))
        tl.store(out_ptr + 5, n_nan.to(tl.float32))
        tl.store(out_ptr + 6, n_inf.to(tl.float32))
        tl.store(out_ptr + 7, size_f)
    else:
        row = part_ptr + pid * 5
        tl.store(row + 0, tl.sum(acc_s, axis=0))
        tl.store(row + 1, tl.sum(acc_a, axis=0))
        tl.store(row + 2, tl.sum(acc_q, axis=0))
        tl.store(row + 3, tl.min(acc_mn, axis=0))
        tl.store(row + 4, tl.max(acc_mx, axis=0))
        tl.store(cnt_ptr + pid * 2 + 0, tl.sum(acc_nan, axis=0))
        tl.store(cnt_ptr + pid * 2 + 1, tl.sum(acc_inf, axis=0))


def _stats_finish_body(part_ptr, cnt_ptr, out_ptr, n, size_f, n_parts,
                       BLOCK: tl.constexpr):  # noqa: F821
    """Stage 2, one program: the partial rows reduced, the counts in int64
    until the final cast, the vector written."""
    lanes = tl.arange(0, BLOCK)
    acc_s = tl.zeros([BLOCK], dtype=tl.float32)
    acc_a = tl.zeros([BLOCK], dtype=tl.float32)
    acc_q = tl.zeros([BLOCK], dtype=tl.float32)
    acc_mn = tl.full([BLOCK], float("inf"), dtype=tl.float32)
    acc_mx = tl.full([BLOCK], float("-inf"), dtype=tl.float32)
    acc_nan = tl.zeros([BLOCK], dtype=tl.int64)
    acc_inf = tl.zeros([BLOCK], dtype=tl.int64)
    for start in range(0, n_parts, BLOCK):
        p = start + lanes
        m = p < n_parts
        acc_s += tl.load(part_ptr + p * 5 + 0, mask=m, other=0.0)
        acc_a += tl.load(part_ptr + p * 5 + 1, mask=m, other=0.0)
        acc_q += tl.load(part_ptr + p * 5 + 2, mask=m, other=0.0)
        acc_mn = tl.minimum(acc_mn, tl.load(part_ptr + p * 5 + 3, mask=m,
                                            other=float("inf")))
        acc_mx = tl.maximum(acc_mx, tl.load(part_ptr + p * 5 + 4, mask=m,
                                            other=float("-inf")))
        acc_nan += tl.load(cnt_ptr + p * 2 + 0, mask=m, other=0).to(tl.int64)
        acc_inf += tl.load(cnt_ptr + p * 2 + 1, mask=m, other=0).to(tl.int64)
    n_nan = tl.sum(acc_nan, axis=0)
    n_inf = tl.sum(acc_inf, axis=0)
    n_fin = n - n_nan - n_inf
    has = n_fin > 0
    denom = tl.maximum(n_fin, 1).to(tl.float32)
    tl.store(out_ptr + 0, tl.where(has, tl.min(acc_mn, axis=0), 0.0))
    tl.store(out_ptr + 1, tl.where(has, tl.max(acc_mx, axis=0), 0.0))
    tl.store(out_ptr + 2, tl.sum(acc_s, axis=0) / denom)
    tl.store(out_ptr + 3, tl.sum(acc_a, axis=0) / denom)
    tl.store(out_ptr + 4, tl.sqrt(tl.sum(acc_q, axis=0)))
    tl.store(out_ptr + 5, n_nan.to(tl.float32))
    tl.store(out_ptr + 6, n_inf.to(tl.float32))
    tl.store(out_ptr + 7, size_f)


def _jit():
    """T1's two stages, compiled by Triton at their first launch."""
    if not _JIT:
        import triton
        import triton.language
        globals()["tl"] = triton.language
        # n stays specialized: Triton then knows a size divisible by 16,
        # and the masked loads of the first stage vectorize (with n a plain
        # runtime value they went element by element: 51 MB in 0.35 ms);
        # the size is written from `size_f`, since a size of 1 becomes a
        # constant
        _JIT.update(partial=triton.jit(_stats_partial_body),
                    finish=triton.jit(_stats_finish_body))
    return _JIT


def _flat(x: torch.Tensor) -> torch.Tensor:
    """x's elements as a 1-D view in memory order where x is dense in some
    order of its dims (contiguous, or channels-last); a copy otherwise."""
    if x.is_contiguous():
        return x.view(-1)
    order = sorted(range(x.dim()), key=lambda d: x.stride(d), reverse=True)
    p = x.permute(order)
    return p.view(-1) if p.is_contiguous() else x.contiguous().view(-1)


def _parts(n: int) -> int:
    return max(1, min(_PARTS, -(-n // _BLOCK)))


def tensor_stats(x: torch.Tensor) -> torch.Tensor:
    """T1: the [8] f32 stats vector of x. CPU tensors take the plain
    version; CUDA tensors launch the kernel, or raise."""
    if x.device.type == "cpu":
        return tensor_stats_reference(x)
    why = ineligible(x)
    if why is not None:
        raise ValueError(f"tensor_stats kernel takes a non-empty f32, bf16 "
                         f"or fp16 tensor, got {tuple(x.shape)} {x.dtype}")
    x = _flat(x)
    n = x.numel()
    parts = _parts(n)
    out = torch.empty((N_FIELDS,), dtype=torch.float32, device=x.device)
    jit = _jit()
    if parts == 1:
        jit["partial"][(1,)](x, out, out, out, n, float(n), 1, BLOCK=_BLOCK,
                             SINGLE=True, num_warps=4)
    else:
        part = torch.empty((parts, 5), dtype=torch.float32, device=x.device)
        cnt = torch.empty((parts, 2), dtype=torch.int32, device=x.device)
        jit["partial"][(parts,)](x, part, cnt, out, n, float(n), parts,
                                 BLOCK=_BLOCK, SINGLE=False, num_warps=4)
        jit["finish"][(1,)](part, cnt, out, n, float(n), parts,
                            BLOCK=_FINISH_BLOCK, num_warps=4)
    COUNTERS.launches += 1
    return out
