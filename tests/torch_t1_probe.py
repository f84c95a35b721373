"""T1 (ops/stats_cuda.py) on the card at ResNet-50's largest probe shape,
[32, 256, 56, 56] bf16, against what bounds it: the tensor's layout and
copy (`contiguous()` of a channels-last activation), torch.sum over the
same bytes (one reduction's yardstick), and the first stage's block size,
warps and program count; each a CUDA graph of 20 calls between events
(chip_smoke._device_ms). Prints one JSON line.

    python tests/torch_t1_probe.py

Needs a CUDA device (exits 2 without one); about 20 s.
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_t1_probe: no CUDA device", file=sys.stderr)
        return 2
    from paddle_tpu_torch.ops import stats_cuda as S
    ms = chip_smoke._device_ms
    out = {"card": chip_smoke._card_line()}
    x = torch.randn(32, 256, 56, 56, device="cuda").bfloat16()
    xl = x.to(memory_format=torch.channels_last)
    n = x.numel()
    out["bound_ms"] = n * 2 / chip_smoke.PEAK_BYTES * 1e3
    out["t1_contiguous_ms"] = ms(lambda: S.tensor_stats(x))
    out["t1_channels_last_ms"] = ms(lambda: S.tensor_stats(xl))
    out["contiguous_copy_ms"] = ms(lambda: xl.contiguous())
    out["torch_sum_ms"] = ms(lambda: x.sum(dtype=torch.float32))
    jit = S._jit()
    flat = x.reshape(-1)
    res = {}
    for block, warps, cap in ((1024, 4, 264), (1024, 4, 65536),
                              (4096, 8, 16384), (4096, 4, 16384),
                              (2048, 4, 1056), (8192, 8, 528),
                              (4096, 8, 1056)):
        parts = max(1, min(cap, -(-n // block)))
        part = torch.empty((parts, 5), dtype=torch.float32, device="cuda")
        cnt = torch.empty((parts, 2), dtype=torch.int32, device="cuda")
        o = torch.empty(8, dtype=torch.float32, device="cuda")

        def stage1():
            jit["partial"][(parts,)](flat, part, cnt, o, n, float(n), parts,
                                     BLOCK=block, SINGLE=False,
                                     num_warps=warps)

        def stage2():
            jit["finish"][(1,)](part, cnt, o, n, float(n), parts,
                                BLOCK=1024, num_warps=4)
        res[f"b{block}_w{warps}_p{parts}"] = {"stage1_ms": ms(stage1),
                                              "stage2_ms": ms(stage2)}
    out["configs"] = res
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
