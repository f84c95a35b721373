"""chip_smoke.py's sharded phases alone on the card (train_dp,
train_dp_nccl, train_planned_lm, train_dlrm_sharded; kernel_bn_split,
K6's split form at train_dp's shapes; train_pipeline_lm, train_pp_ep,
which is train_gpipe and train_ep on one group, and train_elastic), each
timed, the report written as JSON: python tests/torch_parallel_phases.py
[--only NAME ...] [--report PATH]. `--only train_dp_f32` runs train_dp's
comparison in f32 (no AMP: every batch norm's statistics held at f32
rounding), and `train_dp_windows` the small ResNet of WINDOWS_DP; the
smoke runs neither.
A failed phase prints its error and the script exits 1 after the rest
have run."""

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

PHASES = ("kernel_bn_split", "train_dp", "train_dp_nccl",
          "train_planned_lm", "train_dlrm_sharded", "train_pipeline_lm",
          "train_pp_ep", "train_elastic")
EXTRA = ("train_dp_f32", "train_dp_windows")
# a small ResNet (resnet_cifar10, depth 8) in O2 over dp 2 on the card:
# its stem's bn + relu window (K6's split form: its statistics launch, the
# sums all-reduced, its normalize launch) and its conv -> bn -> relu
# windows (K4's sums all-reduced, then K5), every batch norm's statistics
# and output held
# (tests/test_torch_parallel_gpu.py)
WINDOWS_DP = {"net": "resnet50", "depth": 8, "world": 2, "batch": 16,
              "img": 32, "classes": 10, "device": "cuda", "amp": "O2",
              "outputs": True}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="*", choices=PHASES + EXTRA,
                    default=PHASES)
    ap.add_argument("--report")
    args = ap.parse_args(argv)
    import torch
    import chip_smoke
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import cuda_build
    print(chip_smoke._card_line(), flush=True)
    t0 = time.perf_counter()
    cuda_build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    report, failed = {"card": chip_smoke._card_line()}, []
    for name in args.only:
        t0 = time.perf_counter()
        try:
            if name == "train_dp_f32":
                chip_smoke.phase_train_dp(pt, report,
                                          dict(chip_smoke.DP, amp=None))
            elif name == "train_dp_windows":
                sub = {}
                try:
                    chip_smoke.phase_train_dp(pt, sub, dict(WINDOWS_DP))
                finally:
                    report["train_dp_windows"] = sub.get("train_dp")
            elif name == "kernel_bn_split":
                from paddle_tpu_torch.ops import bn_cuda
                chip_smoke.phase_kernel_bn_split(pt, bn_cuda, report)
            else:
                getattr(chip_smoke, "phase_" + name)(pt, report)
        except Exception:  # noqa: BLE001 - report every phase
            traceback.print_exc()
            failed.append(name)
        print(f"{name}: {time.perf_counter() - t0:.1f} s", flush=True)
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1, default=str)
    print(json.dumps({"failed": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
