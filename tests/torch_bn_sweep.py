"""Where K6's time goes on the card (paddle_tpu_torch/csrc/bn_act.cu): each
variant is the source with one part cut or one choice swapped, built by nvcc
beside the package's own build, and timed at the main path's window,
ResNet-50's stem at batch 32 ([401408, 64] bf16, relu), as one CUDA graph of
calls between CUDA events:

  the package's kernel; its first pass alone; its first pass, grid syncs and
  statistics (no second pass); no shared-memory copy of x; 96 KB of it, not
  192; evict_last on every first-pass load; four rows in flight a thread in
  the second pass, not two;

each whole variant's ybn held bitwise to the package's. Beside them, PyTorch
calls that move the same bytes as parts of K6 (yardsticks only): a fill of
its two outputs (103 MB written), a clone of x (51 MB read and written).

    python tests/torch_bn_sweep.py

About half a minute on the card. Prints one line per variant.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as C  # noqa: E402
from paddle_tpu_torch.ops import bn_cuda  # noqa: E402
from paddle_tpu_torch.ops import cuda_build  # noqa: E402

PHASE2 = "  // ---- phase 2: normalize [+ act], the CTA's tiles in reverse"
STATS = "  grid_sync(p.bar);\n\n  // ---- the statistics"
# name -> (whole: its outputs are the package's, [(text, replacement)])
VARIANTS = {
    "first pass alone": (False, [(STATS, "  return;\n" + STATS)]),
    "no second pass": (False, [(PHASE2, "  return;\n" + PHASE2)]),
    "no shared-memory copy of x": (True, [(
        "constexpr int CACHE_BYTES = 192 * 1024;",
        "constexpr int CACHE_BYTES = 16;")]),
    "96 KB shared-memory copy of x": (True, [(
        "constexpr int CACHE_BYTES = 192 * 1024;",
        "constexpr int CACHE_BYTES = 96 * 1024;")]),
    "evict_last on every first-pass load": (True, [(
        "last && i + u >= j0 ? last_use : keep", "keep")]),
    "four rows in flight in the second pass": (True, [(
        "constexpr int U2 = 2;", "constexpr int U2 = 4;")]),
}


def build(name, subs):
    src = (cuda_build.CSRC / "bn_act.cu").read_text()
    for old, new in subs:
        assert old in src, (name, old)
        src = src.replace(old, new)
    out = cuda_build.BUILD_DIR / "bn_sweep"
    out.mkdir(parents=True, exist_ok=True)
    tag = "".join(ch if ch.isalnum() else "_" for ch in name)
    cu, lib = out / f"{tag}.cu", out / f"lib{tag}.so"
    cu.write_text(src)
    return subprocess.Popen([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
                             "-I", str(cuda_build.CSRC), "-o", str(lib),
                             str(cu)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), lib


def main():
    print(C._card_line(), flush=True)
    cuda_build.build(["bn_act"])
    procs = {name: build(name, subs) for name, (_, subs) in VARIANTS.items()}
    m, c, act = 401408, 64, "relu"
    gen = torch.Generator().manual_seed(C.SEED)
    x = (torch.randn((m, c), generator=gen) * 2).to(torch.bfloat16).cuda()
    scale = (1 + 0.1 * torch.randn(c, generator=gen)).cuda()
    bias = (0.1 * torch.randn(c, generator=gen)).cuda()

    def k6():
        return bn_cuda.bn_act(x, scale, bias, 1e-5, act)
    want = k6()[0].clone()
    package = cuda_build._LIBS["bn_act"]
    print(f"the package's K6 at [{m}, {c}] relu: {C._device_ms(k6):.4f} ms, "
          f"plan {bn_cuda.launch_plan(x, act)} (CTAs, rows a tile, "
          f"channels a load)", flush=True)
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        cuda_build._LIBS["bn_act"] = ctypes.CDLL(str(lib))
        bn_cuda._OCCUPANCY.clear()
        try:
            got = k6()[0]
            torch.cuda.synchronize()
            same = torch.equal(got, want) if VARIANTS[name][0] else None
            print(f"{name}: {C._device_ms(k6):.4f} ms, plan "
                  f"{bn_cuda.launch_plan(x, act)}"
                  + ("" if same is None else f", ybn bitwise the "
                     f"package's: {same}"), flush=True)
        finally:
            cuda_build._LIBS["bn_act"] = package
            bn_cuda._OCCUPANCY.clear()
    y = torch.empty((2, m, c), dtype=torch.bfloat16, device="cuda")
    print(f"fill of two [{m}, {c}] bf16 outputs (103 MB written): "
          f"{C._device_ms(lambda: y.fill_(1.0)):.4f} ms", flush=True)
    print(f"clone of x (51 MB read, 51 MB written): "
          f"{C._device_ms(lambda: x.clone()):.4f} ms", flush=True)


if __name__ == "__main__":
    main()
