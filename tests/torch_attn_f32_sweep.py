"""Times tile plans of the f32 flash-attention kernels on tf32 wgmma
(paddle_tpu_torch/csrc/flash_attn_bwd_tf32.cu, flash_attn_fwd_tf32.cu) on
the card: each plan is the source with one instantiation swapped (K8's at
D 64; K7's at D 64), built by nvcc beside the package's own build; per
plan, what ptxas says of its wgmma pipeline (C7511: serialized for want of
registers), the HGMMA and WARPGROUP (arrive/wait) instructions of the
swapped kernel in its SASS (one WARPGROUP pair per HGMMA: serialized), and
the kernels' time per call at the f32 paths' shape [1, 2048, 8, 64]
causal (CUDA graph between events), each held to the package build's
outputs; the package's plans also at D 128 ([1, 2048, 4, 128]). With
`--parent DIR` (a checkout whose `csrc/flash_attn_walk.cu` still holds
K7's f32 tile walk, `flash_walk_fwd`), that walk is built from DIR's
sources and timed against the package's K7 f32 at both shapes, in turns,
in the same process.

    python tests/torch_attn_f32_sweep.py [--parent DIR]

About a minute on the card. Prints one line per plan and shape.
"""

import argparse
import collections
import ctypes
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as C  # noqa: E402
from paddle_tpu_torch.ops import attention_cuda as A  # noqa: E402
from paddle_tpu_torch.ops import cuda_build  # noqa: E402

ENTRY = "launch_dq<64, 32, 2>"
PLANS = {"the package's plans (K8 at D 64: 2 stages of 32 keys)": ENTRY,
         "K8 at D 64 with 3 stages of 32 keys": "launch_dq<64, 32, 3>"}
# (plan, shape) pairs timed
RUNS = [(0, (1, 2048, 8, 64)), (1, (1, 2048, 8, 64)), (0, (1, 2048, 4, 128))]
SHAPES = ((1, 2048, 8, 64), (1, 2048, 4, 128))
# K7 f32's plans: (name, (the package's instantiation, its swap) or None
# for the package's plans, the shapes timed)
FWD_PLANS = [
    ("the package's K7 f32 plans", None, SHAPES),
    ("K7 f32 at D 64 with 4 stages of 32 keys",
     ("launch_fwd<64, 64, 2>", "launch_fwd<64, 32, 4>"), SHAPES[:1]),
    ("K7 f32 at D 128 with 1 stage of 64 keys",
     ("launch_fwd<128, 32, 2>", "launch_fwd<128, 64, 1>"), SHAPES[1:]),
    ("K7 f32 at D 128 with P V in two N-64 pieces",
     ("launch_fwd<128, 32, 2>", "launch_fwd<128, 32, 2, 2>"), SHAPES[1:]),
]


def nvcc(src, csrc, name):
    """Build `src` (source text) against the headers in `csrc` into a
    library under build/kernels/sweep; (library path, nvcc's output)."""
    out = cuda_build.BUILD_DIR / "sweep"
    out.mkdir(parents=True, exist_ok=True)
    cu, lib = out / f"{name}.cu", out / f"lib{name}.so"
    cu.write_text(src)
    proc = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
                           "-I", str(csrc), "-o", str(lib), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stdout + proc.stderr)
    return lib, proc.stdout + proc.stderr


def build(name, entry, source="flash_attn_bwd_tf32.cu", package=ENTRY,
          kernel="dq_tf32_kernel"):
    src = (cuda_build.CSRC / source).read_text()
    assert package in src, package
    lib, log = nvcc(src.replace(package, entry), cuda_build.CSRC, name)
    serialized = sorted({C._kernel_label(line.split("'")[-2])
                         for line in log.splitlines() if "C7511" in line})
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    # the swapped kernel's label, its template arguments as the entry's
    # (a defaulted trailing argument may follow)
    want = kernel + "<" + entry[entry.index("<") + 1:-1].replace(" ", "")
    counts, fn = collections.Counter(), None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = C._kernel_label(m.group(1))
        elif fn == want + ">" or fn.startswith(want + ","):
            op = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z]+)",
                           line)
            if op:
                counts[op.group(1)] += 1
    return ctypes.CDLL(str(lib)), serialized, counts


def operands(shape):
    """q, k, v, dO from the smoke's seed, K7's LSE and delta: the kernels'
    arguments at `shape`, causal."""
    gen = torch.Generator().manual_seed(C.SEED)
    q, k, v, do = (torch.randn(shape, generator=gen).cuda() for _ in range(4))
    o, lse = A.flash_forward(q, k, v, True)
    delta = (do * o).sum(-1).transpose(1, 2).contiguous()
    return (q, k, v, do, lse, delta, 0, 0, 1.0 / math.sqrt(shape[-1]), True)


def time_bwd(lib, dq_name, dkv_name, shape):
    """Launch `lib`'s K8 and K9 f32 entries at `shape` causal; (K8 ms, K9 ms)
    a call, their TFLOP/s, and their outputs' largest difference from the
    package build's, relative to its largest output."""
    args = operands(shape)
    want = (A.flash_dq(*args), *A.flash_dkv(*args))
    outs = [torch.empty_like(x) for x in want]
    ptrs = [x.data_ptr() for x in args[:6]]
    b, t, h, d = shape
    scale = args[8]
    fdq, fdkv = getattr(lib, dq_name), getattr(lib, dkv_name)
    fdq.argtypes, fdkv.argtypes = A._argtypes(7), A._argtypes(8)
    fdq.restype = fdkv.restype = ctypes.c_int

    def dq():
        return fdq(*ptrs, outs[0].data_ptr(), b, h, t, t, d, 0, 0, scale, 1,
                   torch.cuda.current_stream().cuda_stream)

    def dkv():
        return fdkv(*ptrs, outs[1].data_ptr(), outs[2].data_ptr(), b, h, t,
                    t, d, 0, 0, scale, 1,
                    torch.cuda.current_stream().cuda_stream)

    assert dq() == 0 and dkv() == 0
    torch.cuda.synchronize()
    rel = [((x - w).abs().max() / w.abs().max()).item()
           for x, w in zip(outs, want)]
    ms = [C._device_ms(f, reps=10) for f in (dq, dkv)]
    fl = [C.attention_flops(kk, b, t, t, h, d, True) for kk in ("dq", "dkv")]
    return (f"K8 {ms[0]:.4f} ms ({fl[0] / ms[0] / 1e9:.1f} TFLOP/s), K9 "
            f"{ms[1]:.4f} ms ({fl[1] / ms[1] / 1e9:.1f} TFLOP/s) a call",
            f"max rel diff from the package build dq/dk/dv "
            f"{rel[0]:.2g}/{rel[1]:.2g}/{rel[2]:.2g}")


def time_fwd(fwd, shape, reps=10):
    """`fwd` (q, k, v) -> (o, lse) at `shape` causal from the smoke's seed:
    ms a call (CUDA graph between events), its TFLOP/s, and its output's
    largest difference from the package build's, relative to its largest
    output."""
    gen = torch.Generator().manual_seed(C.SEED)
    q, k, v = (torch.randn(shape, generator=gen).cuda() for _ in range(3))
    want, _ = A.flash_forward(q, k, v, True)
    got, _ = fwd(q, k, v)
    torch.cuda.synchronize()
    rel = ((got - want).abs().max() / want.abs().max()).item()
    ms = C._device_ms(lambda: fwd(q, k, v), reps=reps)
    b, t, h, d = shape
    fl = C.attention_flops("fwd", b, t, t, h, d, True)
    return ms, fl / ms / 1e9, rel


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path,
                    help="a checkout holding the f32 tile walk's K8 and K9")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(C._card_line(), flush=True)
    built = [build(f"plan{i}", entry) for i, entry in enumerate(PLANS.values())]
    for i, shape in RUNS:
        name = list(PLANS)[i]
        lib, serialized, counts = built[i]
        times, diff = time_bwd(lib, "flash_tf32_bwd_dq", "flash_tf32_bwd_dkv",
                               shape)
        print(f"{name}, at {list(shape)} causal: {times}; D-64 dQ SASS "
              f"HGMMA {counts['HGMMA']}, WARPGROUP {counts['WARPGROUP']}; "
              f"ptxas serialized {serialized}; {diff}", flush=True)
    for i, (name, swap, shapes) in enumerate(FWD_PLANS):
        package, entry = swap or ("launch_fwd<64, 64, 2>",) * 2
        lib, serialized, counts = build(
            f"fwd_plan{i}", entry, "flash_attn_fwd_tf32.cu", package,
            "fwd_tf32_kernel")
        for shape in shapes:
            ms, tf, rel = time_fwd(C.f32_fwd_entry(lib, "flash_tf32_fwd", A),
                                   shape)
            print(f"{name}, at {list(shape)} causal: K7 f32 {ms:.4f} ms a "
                  f"call ({tf:.1f} TFLOP/s); swapped kernel's SASS HGMMA "
                  f"{counts['HGMMA']}, WARPGROUP {counts['WARPGROUP']}; "
                  f"ptxas serialized {serialized}; max rel diff from the "
                  f"package build {rel:.2g}", flush=True)
    if args.parent is None:
        return
    walk = C.parent_walk_fwd(args.parent, A)

    def package(q, k, v):
        return A.flash_forward(q, k, v, True)
    for shape in SHAPES:
        turns = [time_fwd(fn, shape) for fn in (package, walk, walk, package)]
        new = (turns[0][0] + turns[3][0]) / 2
        old = (turns[1][0] + turns[2][0]) / 2
        print(f"K7 f32 at {list(shape)} causal, in turns package, walk of "
              f"{args.parent}, walk, package: "
              + ", ".join(f"{t[0]:.4f}" for t in turns)
              + f" ms a call; walk / package {old / new:.2f}; the walk's max "
              f"rel diff from the package {turns[1][2]:.2g}", flush=True)


if __name__ == "__main__":
    main()
