"""Q1, the fused quantize pass of AMP O3 (`csrc/quantize.cu`), with its
launch counter. The port's own kernel: it replaces no Pallas kernel, but
the XLA-fused jnp of paddle_tpu/quant.py (`quantize_channelwise` :286-298,
the conv activation's scale :374-376), whose plain PyTorch counterparts
(`quantize_tensor_reference`, `quantize_channelwise_reference`, below;
`quant` exports them as `quantize_tensor` and `quantize_channelwise`) run
about six eager kernels a pass.

Forms, each bitwise its plain version:

  * `quantize_tensor(x)`: a conv activation, NHWC in contiguous memory ->
    int8 of the same shape and memory, and one f32 scale on the device;
  * `quantize_rows(x, mode)`: a `mul` activation [M, K] -> [M, K] int8 or
    e4m3, scales [M, 1];
  * `quantize_cols(y, mode)`: a `mul` Y [K, N] -> scales [1, N] and q, a
    [K, N] view of [N, K] memory (the column-major B that cuBLAS's int8
    and fp8 GEMMs take fastest: on an H100 `torch._int_mm` ran 3.5-9x
    faster on it than on a row-major B at the LM's and ResNet-50's shapes,
    tests/torch_q8_gemm_probe.py);
  * `quantize_filter(w, mode)`: a conv filter [Co, Ci, KH, KW] in any memory
    order -> int8 written as OHWI memory and returned as its OIHW view (what
    K11 reads in place), scales [Co, 1, 1, 1].

and, after a quantized product, its dequantize epilogue,
`dequantize(acc, sx, sy, dtype)`: the int32 or f32 GEMM result [M, N] ->
`(acc.float() * (sx * sy)).to(dtype)` in one pass.

No form syncs with the host, so each runs under CUDA graph capture. On a
CPU tensor a wrapper computes the plain version; on a CUDA tensor it
launches the kernel or raises. `COUNTERS.launches` counts the calls that
launched, by form. Bound: bytes (see the source's note); chip_smoke.py
times each form at the shapes of its paths.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import Dict

import torch

from . import cuda_build

__all__ = ["COUNTERS", "quantize_tensor", "quantize_rows", "quantize_cols",
           "quantize_filter", "dequantize", "quantize_tensor_reference",
           "quantize_channelwise_reference"]

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_MODES = {"int8": 0, "fp8": 1}
_QDTYPES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}

# int8 full scale / fp8 e4m3 max normal
QMAX = {"int8": 127.0, "fp8": 448.0}


@dataclass
class Counters:
    """Calls that launched the kernel, by form: tensor, rows, cols,
    filter, dequant."""
    launches: Dict[str, int] = field(default_factory=dict)

    def reset(self):
        self.launches.clear()

    @property
    def total(self) -> int:
        return sum(self.launches.values())


COUNTERS = Counters()


# --- the plain versions (paddle_tpu/quant.py:286-298, :374-376) ----------

def check_mode(mode):
    if mode not in QMAX:
        raise ValueError(f"quant mode int8 or fp8, not {mode!r}")


def _scale(amax, mode):
    """max(amax, 1e-12) / qmax, a true f32 division on every device. (On
    CUDA, dividing by a Python number multiplies by its f32 reciprocal,
    which can land one ulp off the reference's quotient.)"""
    qmax = torch.full((), QMAX[mode], dtype=torch.float32, device=amax.device)
    return torch.clamp(amax, min=1e-12) / qmax


def _to_q(x32, scale, mode):
    """x32 / scale in the mode's type: int8 rounded half to even and
    clamped to +-127; e4m3 rounded to nearest even by torch's conversion,
    which saturates to +-448 where jnp's gives NaN (past 464), a range
    the quotient never reaches."""
    if mode == "fp8":
        return (x32 / scale).to(torch.float8_e4m3fn)
    return torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)


def quantize_channelwise_reference(x, axis: int, mode: str = "int8"):
    """Symmetric per-channel quantization (quant.py:286): max|x| over every
    dim but `axis`, scaled to 127 (fp8: 448). Returns (q int8 or
    float8_e4m3fn, scale f32 shaped like x reduced to 1 everywhere but
    `axis`)."""
    check_mode(mode)
    x32 = x.float()
    red = tuple(d for d in range(x32.dim()) if d != axis % x32.dim())
    scale = _scale(torch.amax(torch.abs(x32), dim=red, keepdim=True), mode)
    return _to_q(x32, scale, mode), scale


def quantize_tensor_reference(x):
    """Per-tensor int8 quantization of a conv activation (quant.py:374-376):
    one scale from max|x| over the whole tensor, the padded bucket rows
    included. Returns (q int8, scale f32 scalar)."""
    x32 = x.float()
    scale = _scale(torch.amax(torch.abs(x32)), "int8")
    return _to_q(x32, scale, "int8"), scale


# --- the kernel's forms ----------------------------------------------------


def _count(form):
    COUNTERS.launches[form] = COUNTERS.launches.get(form, 0) + 1


def _check(name, x, mode):
    if x.device.type != "cuda":
        raise ValueError(f"Q1 {name}: a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"Q1 {name} reads bf16 or f32, not {x.dtype}")
    if mode not in _MODES:
        raise ValueError(f"Q1 {name}: mode int8 or fp8, not {mode!r}")
    if x.numel() == 0:
        raise ValueError(f"Q1 {name}: an empty tensor")


def _raise_on(rc, name, x):
    if rc != 0:
        raise RuntimeError(f"Q1 {name} launch failed with CUDA error {rc} "
                           f"(x {tuple(x.shape)} {x.dtype}, strides "
                           f"{tuple(x.stride())})")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def quantize_tensor(x):
    """Per-tensor int8 quantization of a conv activation: (q int8 shaped
    like x, scale f32 0-d on x's device). x must lie in contiguous memory
    (an NHWC view of channels_last memory does)."""
    if x.device.type == "cpu":
        return quantize_tensor_reference(x)
    _check("quantize_tensor", x, "int8")
    if not x.is_contiguous():
        raise ValueError(f"Q1 quantize_tensor reads contiguous memory, got "
                         f"strides {tuple(x.stride())} for {tuple(x.shape)}")
    n = x.numel()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    blocks = max(1, min(-(-n // (256 * 8)), 8 * sms))
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    part = torch.empty(blocks, dtype=torch.float32, device=x.device)
    scale = torch.empty((), dtype=torch.float32, device=x.device)
    vec = 8 if x.data_ptr() % 16 == 0 else 1
    fn = cuda_build.entry("quantize", "quant_tensor",
                          [ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
                           ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    rc = fn(x.data_ptr(), n, part.data_ptr(), blocks, q.data_ptr(),
            scale.data_ptr(), _DTYPES[x.dtype], vec, _stream(x))
    _raise_on(rc, "quantize_tensor", x)
    _count("tensor")
    return q, scale


_ROWS_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_long] * 4
                  + [ctypes.c_void_p] + [ctypes.c_long] * 4
                  + [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def _rows_launch(x, dims, xs, q, qs, scale, mode, name):
    """One quant_rows launch over x viewed as [C, A, B, D] (element
    strides xs; q's qs), D innermost."""
    c, a, b, d = dims
    elem = 16 // x.element_size()
    vec = 8 if (d % 8 == 0 and xs[3] == 1 and qs[3] == 1
                and x.data_ptr() % 16 == 0 and q.data_ptr() % 8 == 0
                and all(s % elem == 0 for s in xs[:3])
                and all(s % 8 == 0 for s in qs[:3])) else 1
    work = a * b * d // vec
    threads = 32
    while threads < 256 and threads < work:
        threads *= 2
    fn = cuda_build.entry("quantize", "quant_rows", _ROWS_ARGTYPES)
    rc = fn(x.data_ptr(), c, a, b, d, *xs, q.data_ptr(), *qs,
            scale.data_ptr(), _DTYPES[x.dtype], _MODES[mode], vec, threads,
            _stream(x))
    _raise_on(rc, name, x)


def _cols_launch(x, q, scale, mode, name):
    """One quant_cols call (two launches) over x [R, C] with unit column
    stride, q [C, R] contiguous."""
    r, c = x.shape
    part = torch.empty((-(-r // 64), c), dtype=torch.float32, device=x.device)
    fn = cuda_build.entry("quantize", "quant_cols",
                          [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                           ctypes.c_long, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p])
    rc = fn(x.data_ptr(), r, c, x.stride(0), part.data_ptr(), q.data_ptr(),
            scale.data_ptr(), _DTYPES[x.dtype], _MODES[mode], _stream(x))
    _raise_on(rc, name, x)


def quantize_rows(x, mode="int8"):
    """Per-row quantization of x [M, K]: (q [M, K] contiguous, scale f32
    [M, 1]), as quantize_channelwise_reference(x, 0, mode)."""
    if x.device.type == "cpu":
        return quantize_channelwise_reference(x, 0, mode)
    _check("quantize_rows", x, mode)
    if x.dim() != 2:
        raise ValueError(f"Q1 quantize_rows takes [M, K], got "
                         f"{tuple(x.shape)}")
    m, k = x.shape
    q = torch.empty((m, k), dtype=_QDTYPES[mode], device=x.device)
    scale = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    _rows_launch(x, (m, 1, 1, k), (x.stride(0), 0, 0, x.stride(1)),
                 q.view(torch.uint8), (k, 0, 0, 1), scale, mode,
                 "quantize_rows")
    _count("rows")
    return q, scale


def quantize_cols(y, mode="int8"):
    """Per-column quantization of y [K, N]: (q, scale f32 [1, N]), as
    quantize_channelwise_reference(y, 1, mode), q a [K, N] view of [N, K]
    memory."""
    if y.device.type == "cpu":
        return quantize_channelwise_reference(y, 1, mode)
    _check("quantize_cols", y, mode)
    if y.dim() != 2:
        raise ValueError(f"Q1 quantize_cols takes [K, N], got "
                         f"{tuple(y.shape)}")
    k, n = y.shape
    q = torch.empty((n, k), dtype=_QDTYPES[mode], device=y.device)
    scale = torch.empty((1, n), dtype=torch.float32, device=y.device)
    if y.stride(1) == 1 and y.stride(0) >= n:
        _cols_launch(y, q.view(torch.uint8), scale, mode, "quantize_cols")
    else:   # columns contiguous (a transposed view): one block a column
        _rows_launch(y, (n, 1, 1, k), (y.stride(1), 0, 0, y.stride(0)),
                     q.view(torch.uint8), (k, 0, 0, 1), scale, mode,
                     "quantize_cols")
    _count("cols")
    return q.t(), scale


def quantize_filter(w, mode="int8"):
    """Per-output-channel quantization of a conv filter w [Co, Ci, KH, KW]
    (OIHW, in any memory order): (q, scale f32 [Co, 1, 1, 1]) as
    quantize_channelwise_reference(w, 0, mode), with q an OIHW view of OHWI
    memory, so that K11 reads it without a copy."""
    if w.device.type == "cpu":
        q, scale = quantize_channelwise_reference(w, 0, mode)
        return q.contiguous(memory_format=torch.channels_last), scale
    _check("quantize_filter", w, mode)
    if w.dim() != 4:
        raise ValueError(f"Q1 quantize_filter takes OIHW, got "
                         f"{tuple(w.shape)}")
    co, ci, kh, kw = w.shape
    q = torch.empty((co, kh, kw, ci), dtype=_QDTYPES[mode], device=w.device)
    scale = torch.empty((co, 1, 1, 1), dtype=torch.float32, device=w.device)
    s = w.stride()
    _rows_launch(w, (co, kh, kw, ci), (s[0], s[2], s[3], s[1]),
                 q.view(torch.uint8), (kh * kw * ci, kw * ci, ci, 1), scale,
                 mode, "quantize_filter")
    _count("filter")
    return q.permute(0, 3, 1, 2), scale


_OUT_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def dequantize(acc, sx, sy, dtype):
    """The dequantize epilogue of a quantized product: acc [M, N] (int32 or
    f32; a slice of a padded GEMM result is read in place), sx f32 [M, 1],
    sy f32 [1, N] -> (acc.float() * (sx * sy)).to(dtype), [M, N]
    contiguous; each product rounded to f32 once, as the plain version's
    two multiplies are."""
    if acc.device.type == "cpu":
        return (acc.float() * (sx * sy)).to(dtype)
    m, n = acc.shape
    if acc.dtype not in (torch.int32, torch.float32) or \
            dtype not in _OUT_DTYPES or acc.stride(1) != 1 or \
            tuple(sx.shape) != (m, 1) or tuple(sy.shape) != (1, n) or \
            sx.dtype != torch.float32 or sy.dtype != torch.float32:
        raise ValueError(f"Q1 dequantize: acc {acc.dtype} {tuple(acc.shape)} "
                         f"strides {tuple(acc.stride())}, sx {tuple(sx.shape)}, "
                         f"sy {tuple(sy.shape)}, out {dtype}")
    sx, sy = sx.contiguous(), sy.contiguous()
    y = torch.empty((m, n), dtype=dtype, device=acc.device)
    lda = acc.stride(0)
    vec = 4 if (n % 4 == 0 and lda % 4 == 0 and acc.data_ptr() % 16 == 0
                and sy.data_ptr() % 16 == 0) else 1
    sms = torch.cuda.get_device_properties(acc.device).multi_processor_count
    blocks = max(1, min(-(-(m * n // vec) // 256), 16 * sms))
    fn = cuda_build.entry("quantize", "quant_dequant",
                          [ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    rc = fn(acc.data_ptr(), lda, sx.data_ptr(), sy.data_ptr(), y.data_ptr(),
            m, n, int(acc.dtype == torch.float32), _OUT_DTYPES[dtype], blocks,
            vec, _stream(acc))
    _raise_on(rc, "dequantize", acc)
    _count("dequant")
    return y
