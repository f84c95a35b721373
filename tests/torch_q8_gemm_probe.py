"""Times the library GEMMs behind AMP O3's `mul` on the card, at the LM's
and ResNet-50's shapes, and the dequantize that follows them: cuBLAS's int8
GEMM (`torch._int_mm`) with a row-major and with a column-major B (the
layout Q1's per-column form writes), the bf16 product it replaces, the fp8
GEMM (`torch._scaled_mm`, unit scales, f32 out), and the dequantize of the
int32 result, as the plain version's passes (convert, multiply, cast) and
as Q1's one pass. Each time is a CUDA graph of 20 calls between CUDA
events (chip_smoke._device_ms); the two layouts' products are checked
equal, and Q1's dequantize bitwise the plain one.

    python tests/torch_q8_gemm_probe.py

Prints one line per shape and the card's name and power limit.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# [M, K] x [K, N]: the LM's forward GEMMs at batch 8 x T 2048 and
# ResNet-50's fc at batch 32
SHAPES = [(16384, 512, 1536), (16384, 512, 512), (16384, 512, 2048),
          (16384, 2048, 512), (16384, 512, 8192), (32, 2048, 1008)]


def main():
    import torch
    import chip_smoke as cs
    from paddle_tpu_torch.ops import cuda_build, quant_cuda
    if not torch.cuda.is_available():
        print("torch_q8_gemm_probe: no CUDA device", file=sys.stderr)
        return 2
    cuda_build.build(["quantize"])
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    one = torch.ones((), device=dev)
    for m, k, n in SHAPES:
        a = torch.randint(-127, 128, (m, k), dtype=torch.int8, device=dev,
                          generator=g)
        b_row = torch.randint(-127, 128, (k, n), dtype=torch.int8,
                              device=dev, generator=g)
        b_col = b_row.t().contiguous().t()
        if not torch.equal(torch._int_mm(a, b_row), torch._int_mm(a, b_col)):
            raise RuntimeError(f"{m}x{k}x{n}: the layouts' products differ")
        abf, bbf = a.to(torch.bfloat16), b_row.to(torch.bfloat16)
        a8 = a.to(torch.float8_e4m3fn)
        b8 = b_col.to(torch.float8_e4m3fn)
        acc = torch._int_mm(a, b_col)
        sx = torch.rand((m, 1), device=dev, generator=g) * 1e-3
        sy = torch.rand((1, n), device=dev, generator=g) * 1e-3
        if not torch.equal(quant_cuda.dequantize(acc, sx, sy, torch.bfloat16),
                           (acc.float() * (sx * sy)).to(torch.bfloat16)):
            raise RuntimeError(f"{m}x{n}: Q1's dequantize is not the plain one")
        ms = {
            "int_mm row-major B": lambda: torch._int_mm(a, b_row),
            "int_mm column-major B": lambda: torch._int_mm(a, b_col),
            "bf16 mm": lambda: abf @ bbf,
            "fp8 scaled_mm": lambda: torch._scaled_mm(
                a8, b8, scale_a=one, scale_b=one, out_dtype=torch.float32,
                use_fast_accum=False),
            "plain dequantize": lambda: (acc.float() * (sx * sy)).to(
                torch.bfloat16),
            "Q1 dequantize": lambda: quant_cuda.dequantize(
                acc, sx, sy, torch.bfloat16),
        }
        print(f"{m}x{k}x{n}: " + "; ".join(
            f"{name} {cs._device_ms(fn):.4f} ms" for name, fn in ms.items()),
            flush=True)
    print(cs._card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
