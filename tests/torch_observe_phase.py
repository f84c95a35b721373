"""chip_smoke.py's phase `observe` alone on the card: the kernels built,
then the numeric-health plane on ResNet-50 O2 (probes, the gradient audit,
dynamics, the flight recorder, the step log and tracing, graphed) and on
the LM O2 under check_nan_inf with a poisoned FFN weight, the exports and
the costs. The report goes to chiprun_out/observe_phase.json, the step
log, traces and crash reports to chiprun_out/observe/.

    python tests/torch_observe_phase.py

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
        print("torch_observe_phase: no CUDA device", file=sys.stderr)
        return 2
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import (attention_cuda, bn_cuda, conv_cuda,
                                      cuda_build)
    print(chip_smoke._card_line(), flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    cuda_build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    report = {}
    t1, launches = chip_smoke.phase_observe(pt, conv_cuda, bn_cuda,
                                            attention_cuda, report)
    report["t1"] = t1
    report["launches"] = launches
    print(json.dumps(t1), flush=True)
    out = Path(__file__).resolve().parent.parent / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "observe_phase.json").write_text(
        json.dumps(report, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
