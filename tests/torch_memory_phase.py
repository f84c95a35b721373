"""chip_smoke.py's phase `memory` alone on the card: the kernels built,
then ResNet-50 O2's measured peaks, the headroom model and its validation,
the OOM process, the served model's request and admission, the refusal.
The report goes to chiprun_out/memory_phase.json.

    python tests/torch_memory_phase.py

Needs a CUDA device (exits 2 without one); about a minute.
"""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_memory_phase: no CUDA device", file=sys.stderr)
        return 2
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import bn_cuda, conv_cuda, cuda_build
    print(chip_smoke._card_line(), flush=True)
    t0 = time.perf_counter()
    cuda_build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    report = {}
    chip_smoke.phase_memory(pt, conv_cuda, bn_cuda, report)
    out = Path(__file__).resolve().parent.parent / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "memory_phase.json").write_text(
        json.dumps(report, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
