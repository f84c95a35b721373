"""Chip smoke for the PyTorch/CUDA port (paddle_tpu_torch) on one GPU.

Drives the port's main paths — ResNet-50 (224x224, 1000 classes, full
width and depth, random weights from a seed) under AMP O2, served by the
port's ServingEngine through buckets (1, 4, 16), served in int8 (AMP O3)
from a saved inference model through the same buckets, and trained with
Momentum through Executor.run at batch 32; bench.py's transformer LM
(batch 8, T 2048, 4 layers, d_model 512, 8 heads, vocab 8192) under AMP
O2, trained with Adam and served through buckets (1, 2, 4, 8); and
bench.py's long-context ring configuration of the same LM (batch 1, T
32768, sequence_parallel over an 'sp' mesh of the one card) trained — and
holds every kernel of those paths against its plain PyTorch version on the
card:

  1. device   CUDA present (else exit 2), the card's name and power limit;
  2. build    nvcc builds every CUDA kernel from paddle_tpu_torch/csrc/,
              one process per source, all started together (the Triton
              kernels compile at their first launch);
  3. kernel   K1 (conv2d forward) against conv2d_reference on the JAX
              tests' five cases and every distinct ResNet-50 conv shape at
              each bucket's batch (1, 4, 16), then per shape at batch 16:
              kernel, plain, cuDNN (yardstick only) times, each from a
              CUDA graph of 20 calls timed with CUDA events, beside the
              bound;
  4. slice    build + startup on the card, batch-norm statistics set from
              one calibration batch (so the random model's logits are
              not saturated), 12 requests of batch 1-16, output checks,
              K1 launch count == eligible convs x batches, fallback
              counts, one request per bucket against the same weights in
              f32 on the card and on the port's own CPU plain path, p50
              latency per bucket, img/s over the request window, and one
              profiled batch-16 request: device busy time and the kernels
              it went to;
  5. kernel_q8  K11 (int8 conv) against conv2d_q8_reference, bitwise (bf16
              and f32 out, the bf16 call repeated), on the five test cases
              and every distinct conv shape of ResNet-50's O3 route at each
              bucket's batch, under its plan and split-K forced on and off;
              then per shape at batch 16 kernel, plain and K1-in-bf16 times
              (CUDA graph of 20 calls between events) beside the bound
              (int8 operations or bytes) and, with --parent, the older
              checkout's int8 kernel;
  6. serve_q8 the calibrated model of phase 4 written by
              io.save_inference_model and served by ServingEngine(dir,
              quantize="int8"): quant_report of 54 weights, the 12
              requests, per bucket run K11 42 and K1 10 launches with the
              quant hits and fallbacks of the reference's routing and no
              filter copied, output
              checks, one request op by op against the CPU plain path in
              O3 on the card's own inputs to each op (the quantized
              windows bitwise), one request per bucket against it end to
              end, the O3-vs-O2 distance, p50 and img/s beside O2's, one
              profiled batch-16 request (K11's and the activation-quantize
              passes' shares of the device time);
  7. kernel_train  K2-K6 (conv grad input, conv grad filter, conv +
              statistics, bn apply, bn + act) against their plain versions
              at every distinct shape ResNet-50 training gives them at
              batch 32, each run twice and bitwise repeatable, then timed
              per shape (CUDA graph of 20 calls between CUDA events) beside
              the bound, the plain version and one PyTorch call that
              computes the same function where there is one;
  8. train    ResNet-50 O2 training at batch 32, learning rate 0.0125
              (bench.py's 0.1 at batch 256, scaled linearly), Momentum 0.9,
              one warm-up and five timed steps on one repeated batch: step
              p50 and img/s, each kernel's launches per step held to
              52/52/52/52/1 (K2/K3/K4/K5/K6) and the fallbacks to the two
              `channels` ones of the Ci=3 stem, the loss finite and falling,
              peak memory, one profiled step (device busy share, device
              time by kernel, host and device time by the executor's
              spans: op type, window, and the generic grads' re-run
              forwards);
              then one step at batch 4 from the startup weights against
              the port's CPU plain path: op by op (every op and window
              re-run on the CPU on the card's own inputs), then end to end
              (the loss, per-parameter grad relative L2), in O2 and in f32
              (TF32 off);
  9. kernel_attn  K7-K9 (flash-attention forward, dQ, dK/dV), in bf16
              (the Hopper kernels) and in f32 (their f32 forms), against
              their plain versions at the JAX tests' shapes, causal and
              not, at T = 72 with D 64 and 128, and at the bench shape [8,
              2048, 8, 64] causal (f32 also at the f32 steps' [1, 2048,
              8, 64]), each run twice and bitwise repeatable; then timed
              (CUDA graph of calls between CUDA events), bf16 at the bench
              shape and f32 at the f32 steps' shape, beside the bound, the
              plain versions and F.scaled_dot_product_attention
              (yardstick only: its forward for K7, its backward for K8 +
              K9 together; the backend it picks printed beside its
              time) and, with --parent, the older checkout's f32 K7 (its
              tile walk) at the f32 steps' shape and at [1, 2048, 4, 128];
              the wrappers' host time per call; the
              flash/einsum crossover at T 512-8192;
10. train_lm the transformer LM O2 with Adam 1e-4, one warm-up and five
              timed steps on one batch of random tokens and labels (seed
              0): step p50 and tokens/s, K7/K8/K9 launches held to 4/4/4 per
              step with no attention fallback, the loss finite and falling,
              peak memory, one profiled step; then one step at batch 1 from
              the startup weights against the CPU plain path, op by op and
              end to end, in O2 and in f32 (the f32 step through the f32
              forms of K7-K9, launches held to 4/4/4, no fallback), the O2
              grads held to the CPU's own O2 noise floor (its flash path
              against its einsum path); then that f32 step timed on the
              card: one warm-up and five steps (p50, launches per step
              4/4/4), one profiled step (device busy time);
 11. serve_lm ServingEngine over transformer_lm(is_test=True,
              return_logits=True) in O2, fetching the logits, 6 requests of
              1-8 rows: K7 launches held to 4 per bucket run, one request
              against the CPU plain path; then p50 latency per bucket over
              7 requests that fill it;
 12. kernel_ring  K10 (the ring's unnormalized flash block), in bf16 and in
              f32, against its plain version at the JAX tests' shapes, at
              the 16 (query shard, key shard) pairs of a four-shard causal
              ring of [1, 8192, 8, 64] shards (6 wholly masked: exactly
              (0, 0, -1e30)) and at the path shape [1, 32768, 8, 64], each
              twice and bitwise repeatable (`hold_block`); K8 and K9 at
              the 16 pairs with their offsets; the four shards' ring merge
              (the ring's per-step function looped in one process) against
              K7 on the whole sequence; f32 also K10 at the f32 ring
              step's [1, 2048, 8, 64]; then K10 timed (CUDA graph of calls
              between CUDA events), bf16 at the path shape and f32 at the
              f32 step's, beside the bound, the plain version and
              PyTorch's flash (bf16) or memory-efficient (f32) forward
              with its logsumexp (yardstick only), and K8 and K9 there;
 13. train_ring  the ring configuration O2 with Adam 1e-4, one warm-up and
              five timed steps on one batch of random tokens and labels
              (seed 0): step p50 and tokens/s, launches per step held to
              K10/K8/K9/K7 4/4/4/0 with every attention call a flash-ring
              hit, the loss finite and falling, peak memory, one profiled
              step; then the same ring program at T 2048, one step from the
              startup weights against the CPU plain path, op by op and end
              to end in O2 and in f32 (the f32 ring on the card through
              the f32 forms of K10, K8 and K9, launches held to 4/4/4);
              then that f32 step timed as train_lm's;
 14. result   the kernel table as one JSON line, the card line, then
              {"ok": true, "device": {...}} as the last line.

Every phase is fatal: a failure raises and the script exits non-zero
without printing a result. Run from the root of a checkout:

    python3 chip_smoke.py [--report PATH] [--parent DIR]

`--report` also writes the full per-shape measurements as JSON. `--parent`
names an older checkout (e.g. the parent commit unpacked by `git archive`)
whose int8 conv (`csrc/conv2d_q8.cu`) and f32 attention forward (the tile
walk's `flash_walk_fwd`) are built from its sources and timed beside
this tree's K11 and K7 f32 in the same process, as their "before".
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM published peaks (NVIDIA data sheet, dense)
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_F32_FLOPS = 67e12          # outside the tensor cores
PEAK_BYTES = 3.35e12

# tests/test_pallas_conv.py CASES (channels 128, batch 2)
CASES = [
    (6, 6, 3, 3, (1, 1), (1, 1), (1, 1)),
    (9, 9, 3, 3, (2, 2), (1, 1), (1, 1)),
    (8, 8, 1, 1, (1, 1), (0, 0), (1, 1)),
    (10, 10, 3, 3, (1, 1), (2, 2), (2, 2)),
    (7, 9, 2, 3, (2, 1), (1, 2), (1, 1)),
]
# K1 against its plain version: f32 outputs differ only by the order of
# the f32 sums (|d| <= F32_ATOL + F32_RTOL*|ref|); the bf16 output is the
# kernel's own f32 sum rounded once, so it equals the bf16 rounding of its
# f32 output bitwise, and lies within one bf16 ulp (plus the f32 tolerance)
# of the reference's bf16 output.
F32_RTOL, F32_ATOL = 1e-4, 1e-4
# The served answer (AMP O2 on the card) against two references on the same
# weights, row by row. Logits: within a tolerance of the row's largest
# |logit|.
#  * The port's CPU plain path in O2, the same arithmetic: LOGIT_RTOL. A
#    bf16 rounding that flips with the order of an f32 sum spreads through
#    the ~110 bf16 rounding points of ResNet-50's longest path, so the two
#    differ by bf16 noise, not by rare ulps: the first calibrated run on
#    the card measured 0.031-0.045.
#  * The same program in f32 on the card (TF32 off): F32_LOGIT_RTOL, a
#    check against gross error only. The random model amplifies rounding:
#    the first calibrated run measured 0.14-0.155, and the smoke prints how
#    far the f32 logits move when only the input is rounded to bf16.
# Softmax: within the bound that the row's logit difference d implies,
# |dp| <= p*(exp(2d)(1 + 2^-7) - 1) (a log-softmax moves by at most 2d; a
# bf16 output is rounded once, 2^-8 relative each side). Argmax: equal
# wherever the reference's top-2 margin exceeds 2d. The softmax must not
# be saturated (top prob < MAX_TOP_PROB), or its check would hold whatever
# the values.
LOGIT_RTOL = 0.1
F32_LOGIT_RTOL = 0.5
MAX_TOP_PROB = 0.9
REQUEST_SIZES = [1, 3, 16, 4, 1, 16, 2, 12, 16, 1, 4, 9]
COMPARED = (0, 1, 2)                    # one request per bucket: 1, 3, 16 rows
BUCKETS = (1, 4, 16)
BATCH = 16
SEED = 0
K1_KERNEL = "conv2d_fwd_kernel"     # K1's name in the profiler's events
# the passes after K1's split-K mainloops (conv2d_fwd.cu)
SPLIT_KERNELS = ("splitk_reduce_kernel", "splitk_reduce_q8_kernel",
                 "stats_rows_kernel")
K11_KERNEL = "conv2d_fwd_q8_kernel"  # K11's
# the executor's profiler ranges (paddle_tpu_torch/ops/registry.py span)
# and the activation-quantize passes' (quant.ACT_SPAN): each appears on the
# host and, as the extent of the kernels launched in it, on the device's
# timeline, where it is no kernel
SPANS = ("op", "win", "rerun", "quant")

# int8 serving (phases kernel_q8 and serve_q8): per bucket run of ResNet-50
# in O3, K11 runs the 42 convs the reference quantizes (Ci, Co % 128), K1
# the ten 64-channel convs of stage 1 (quant fallback "kernel"), F.conv2d
# the Ci=3 stem (conv fallback "channels", quant fallback "kernel"); the fc
# is the one quantized `mul`. `quant_report` names the 53 conv filters and
# the fc weight.
Q8_LAUNCHES = {"q8_launches": 42, "launches": 10}
Q8_HITS = {"conv2d": 42, "mul": 1}
Q8_FALLBACKS = {("conv2d", "kernel"): 11}
Q8_CONV_FALLBACKS = {("conv2d", "channels"): 1}
Q8_REPORT_NAMES = 54
# The served O3 answer against the port's CPU plain path in O3 on the same
# weights.
#  * Op by op (_serve_lockstep, one request): every op and window of the
#    card's program, and again on the CPU plain path on a CPU copy of the
#    card's own inputs to it and the card's fold constants, each float
#    output held to LOCKSTEP_BF16 / LOCKSTEP_F32 (below), and every
#    quantized conv window bitwise: K11 equals its plain version, the int8
#    GEMM is exact, and the quantizers are exact f32 operations.
#  * End to end, with _compare's checks: logits within Q8_LOGIT_RTOL of the
#    row's largest |logit|. Here the inputs differ: K1's bf16 roundings
#    (the stage-1 convs) and cuDNN's stem flip with the order of f32 sums,
#    and a flipped bf16 value that crosses an int8 rounding step of the
#    next conv's activation moves it by a whole step (1/127 of the
#    tensor's largest value), larger than the flip. The first calibrated
#    run (NVIDIA H100 80GB HBM3, 700.00 W) measured 0.092-0.131 where O2
#    measured 0.031-0.045; the bound is twice the worst.
Q8_LOGIT_RTOL = 0.25
# The two engines' own fold constants (fusion.fold_constants, each made from
# the same weights on its own device; the lockstep above hands the card's to
# the CPU side) are held to each other within what a few f32 ulps in the
# batch-norm factor s = scale * rsqrt(var + eps) can move (CUDA's rsqrtf is
# within 2 ulps, the CPU's is correctly rounded):
#  * the bf16 folded filter within one bf16 ulp per element;
#  * the f32 channel bias within FOLD_BIAS_REL of |bias| + |mean * s|;
#  * the per-Co int8 scales within 2^-7 relative (one bf16 ulp of max |w|);
#  * the int8 values within one step, at most FOLD_Q8_SHARE of them off.
FOLD_BIAS_REL = 2.0 ** -21
FOLD_SCALE_REL = 2.0 ** -7
FOLD_Q8_SHARE = 1e-3

# training (phases kernel_train and train)
TRAIN_BATCH = 32
TRAIN_LR = 0.0125
TRAIN_STEPS = 5                     # timed, after one warm-up step
SMALL_BATCH = 4                     # the steps compared with the CPU
# launches per training step: K2 (dgrad), K3 (wgrad), K4 (conv + stats),
# K5 (bn apply), K6 (bn + act); 52 of the 53 convs pass the gate, all 53
# sit in conv -> bn windows, and the stem's input is a data layer (no dx)
TRAIN_LAUNCHES = {"dgrad_launches": 52, "wgrad_launches": 52,
                  "stats_launches": 52, "apply_launches": 52,
                  "act_launches": 1}
TRAIN_FALLBACKS = {("conv2d", "channels"): 1, ("conv2d_grad", "channels"): 1}
# K2-K6 against their plain versions: f32 outputs within SUM_RTOL of the
# sum of the terms' magnitudes, sum |a||b| (both sides sum the same bf16
# products in f32, in another order; a long reduction such as K3's over
# N*OH*OW grows its error with that sum, not with the result); bf16 outputs
# within one bf16 ulp plus that tolerance.
SUM_RTOL = 1e-5
# One training step at batch 4 on the card against the port's CPU plain
# path, same weights and batch.
#  * Op by op (LOCKSTEP_*): every op and window of the O2 step runs on the
#    card and, on a CPU copy of the card's own inputs, on the CPU plain
#    path; each float output within a relative L2 difference of
#    LOCKSTEP_BF16 (bf16 outputs: a few ulps) or LOCKSTEP_F32 (f32).
#  * End to end: the loss within O2_LOSS_RTOL (O2) or F32_LOSS_RTOL (f32,
#    TF32 off), the last layer's grads (fc, before the backward amplifies
#    anything) within LAST_GRAD_RL2. The randomly initialized ResNet-50's
#    backward is chaotic: the f32 grads of the card and the CPU, which
#    differ only in the order of their sums, already differ by 1.6-2.3 %
#    (relative L2, median over parameters), and any two O2 runs by more
#    than 1. So the other parameters' grads are held to the noise floor:
#    the median over parameters of the card-vs-CPU relative L2 in O2 no
#    larger than the CPU's own O2-vs-f32 median, and in f32 within
#    F32_GRAD_RL2. The JAX package shows the same spread on this net
#    (tests/torch_o2_spread.py on the CPU at 64x64: its own O2 and f32
#    grads differ by a median relative L2 of 1.25, the port's by 1.27).
#  * A relative L2 near 1 also holds for a zero grad, so each parameter's
#    grad norm on the card over its norm on the CPU lies within
#    [1/NORM_RATIO, NORM_RATIO], and the median of those ratios within
#    NORM_RATIO_MEDIAN of 1: a zero, dropped or wrongly scaled grad fails
#    it (the port's O2 and the JAX package's, which differ only in
#    rounding, give ratios of 0.76-1.33, median 0.97, in that run).
LOCKSTEP_BF16, LOCKSTEP_F32 = 1e-2, 1e-3
O2_LOSS_RTOL, F32_LOSS_RTOL = 2e-2, 1e-4
LAST_GRAD_RL2, F32_GRAD_RL2 = 0.1, 0.1
NORM_RATIO, NORM_RATIO_MEDIAN = 2.0, 0.1

# the transformer LM (phases kernel_attn, train_lm, serve_lm): bench.py's
# `transformer` mode (bench.py:1005-1073), full width and depth
LM = {"batch": 8, "seqlen": 2048, "n_layer": 4, "d_model": 512, "n_head": 8,
      "vocab": 8192, "lr": 1e-4}
LM_STEPS = 5                        # timed, after one warm-up step
LM_SMALL_BATCH = 1                  # the step compared with the CPU
ATTN_BENCH = (8, 2048, 8, 64)       # [B, T, H, D] of its attention
# [B, T, H, D] of the attention of the f32 steps on the card (the batch-1
# LM step, and the ring step at RING_SMALL_T = T on one rank): the f32
# forms' path shape
F32_ATTN = (LM_SMALL_BATCH, LM["seqlen"], LM["n_head"],
            LM["d_model"] // LM["n_head"])
# K7-K9 against their plain versions: tests/test_pallas_attention.py's
# shapes, T = 72 (a 64-row tile past T) at D 64 and 128, the bench shape
ATTN_SHAPES = [(s, c) for s in ((2, 64, 2, 32), (1, 128, 4, 64),
                                (2, 256, 2, 64), (1, 72, 2, 64),
                                (1, 72, 2, 128)) for c in (False, True)] \
    + [(ATTN_BENCH, True)]
# Each bf16 output within attention_tolerance (below) of the plain
# version (one ulp, 1e-5 of the sum of its terms' magnitudes, four flipped
# bf16 roundings of P or dS); LSE within LSE_RTOL of max(1, |lse|).
LSE_RTOL = 1e-5
# the launch counters of the kernels' f32 forms (attention_cuda.COUNTERS)
F32_COUNTERS = ("f32_launches", "f32_dq_launches", "f32_dkv_launches",
                "f32_block_launches")
LM_SERVE_SIZES = [1, 3, 8, 2, 6, 4]
LM_BUCKETS = (1, 2, 4, 8)
LM_LATENCY_REPS = 7                 # full-bucket requests timed per bucket for p50
# The batch-1 step on the card against the CPU plain path. The transformer
# has no batch-norm chaos: two O2 paths on the CPU (flash plain versions vs
# the einsum path, the same weights) differ by a grad relative L2 median of
# 0.63 % and at most 1.19 %, norm ratios 0.998-1.001, losses by 2e-7; two
# f32 paths by 7e-7 (tests measured on the CPU at this config). So: O2
# grads within LM_SPREAD_FACTOR times this run's own CPU flash-vs-einsum
# spread (median and max), norm ratios within 1 +- LM_NORM_RATIO[0]; f32
# grads within LM_F32_GRAD_RL2 (median, max), norm ratios within
# 1 +- LM_NORM_RATIO[1]; losses within LM_*_LOSS_RTOL.
LM_SPREAD_FACTOR = 2.0
LM_NORM_RATIO = (0.02, 1e-3)
LM_F32_GRAD_RL2 = (1e-4, 1e-3)
LM_O2_LOSS_RTOL, LM_F32_LOSS_RTOL = 1e-4, 1e-5
# the long-context transformer LM (phases kernel_ring, train_ring): bench.py's
# `ring_attention` mode (bench.py:1076-1148), full width and depth,
# sequence_parallel over an 'sp' mesh of the one card
RING = {"batch": 1, "seqlen": 32768, "n_layer": 4, "d_model": 512,
        "n_head": 8, "vocab": 8192, "lr": 1e-4}
RING_STEPS = 5                      # timed, after one warm-up step
RING_SHARDS = 4                     # K10/K8/K9 held at a four-shard ring's pairs
RING_SMALL_T = 2048                 # the ring step compared with the CPU
RING_ATTN = (1, 32768, 8, 64)       # [B, T, H, D] of its attention
TOL_ROWS = 2048                     # query rows per chunk of a long bound
# The ring merge of four K10 shards against K7 on the whole sequence: P is
# rounded to bf16 against another running maximum on each side, so each
# term may differ by 2^-8 of itself.
MERGE_REL = 2.0 ** -8 + 1e-5
# The served logits (O2) against the CPU plain path on the same weights:
# within LM_LOGIT_RTOL of the largest |logit| (bf16 noise; the CPU test of
# a 2-layer model measured 0.53 % against the JAX package).
LM_LOGIT_RTOL = 2e-2


def _kernel_label(mangled: str) -> str:
    """A kernel's name and template arguments from its mangled name, as
    ptxas prints it: `_ZN12_GLOBAL__N_116flash_fwd_kernelILi64ELi128ELb1EEEv..`
    -> `flash_fwd_kernel<64,128,true>`, a leading element type as `float`
    or `bf16`."""
    import re
    m = re.search(r"(\w+?_kernel)I(.*?)EEv", mangled)
    if m is None:
        return mangled
    # the name is the last length-prefixed identifier: 16flash_fwd_kernel
    part, name = m.group(1), m.group(1)
    for d in re.finditer(r"\d+", part):
        digits = d.group()
        if any(d.end() + int(digits[i:]) == len(part)
               for i in range(len(digits))):
            name = part[d.end():]
            break
    vals = ["float" if m.group(2).startswith("f") else "bf16"] \
        if m.group(2).startswith(("f", "13__nv_bfloat16")) else []
    vals += [("true" if v == "1" else "false") if t == "b" else v
             for t, v in re.findall(r"L(i|b)(\d+)E", m.group(2))]
    return f"{name}<{','.join(vals)}>"


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


_PARENT_LIBS = {}


def build_parent(parent, source, name):
    """Build `source`, a file under the older checkout `parent`'s
    paddle_tpu_torch/csrc/, from that checkout's sources with the package's
    nvcc flags into build/kernels/parent/lib<name>.so, and load it: the
    "before" of a kernel this tree replaced, timed in the same process."""
    import ctypes
    from paddle_tpu_torch.ops import cuda_build
    if name not in _PARENT_LIBS:
        src = Path(parent).resolve() / "paddle_tpu_torch" / "csrc" / source
        out = cuda_build.BUILD_DIR / "parent"
        out.mkdir(parents=True, exist_ok=True)
        lib = out / f"lib{name}.so"
        proc = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
                               "-o", str(lib), str(src)],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"building {src} failed:\n{proc.stdout}"
                               f"{proc.stderr}")
        _PARENT_LIBS[name] = ctypes.CDLL(str(lib))
    return _PARENT_LIBS[name]


def _device_ms(fn, reps=20):
    """Mean device time of one call of `fn`: `reps` calls captured in one
    CUDA graph, replayed between two CUDA events. The graph leaves out
    the host: for these tens-of-microsecond convs, events around a loop
    of Python calls would measure the wrapper's enqueue rate. Inputs stay
    in L2 between calls, as they are when the serving path hands one
    conv's output to the next."""
    import torch
    side = torch.cuda.Stream()              # warm-up off the default stream,
    side.wait_stream(torch.cuda.current_stream())   # as graph capture asks
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / reps
    del graph
    return ms


def wrapper_host_us(conv_cuda, reps=200):
    """Host microseconds per K1 wrapper call (shape checks, plan, tensor
    maps, launch) at a batch-1 1x1 conv, whose kernel is shorter than the
    call so the host sets the pace: {filter layout: median over 5 rounds of
    `reps` queued calls}, for an OIHW view of OHWI memory (what the serving
    fold stores) and a contiguous OIHW filter, in turns."""
    import torch
    x = torch.randn((1, 56, 56, 256), device="cuda").to(torch.bfloat16)
    w = torch.randn((64, 256, 1, 1), device="cuda").to(torch.bfloat16)
    times = {"ohwi_view": [], "oihw": []}
    filters = {"ohwi_view": w.contiguous(memory_format=torch.channels_last),
               "oihw": w}
    for _ in range(5):                      # the two layouts in turns
        for name, wt in filters.items():
            for _ in range(20):
                conv_cuda.conv2d(x, wt, (1, 1), (0, 0), (1, 1))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                conv_cuda.conv2d(x, wt, (1, 1), (0, 0), (1, 1))
            times[name].append((time.perf_counter() - t0) / reps * 1e6)
            torch.cuda.synchronize()
    return {k: sorted(v)[len(v) // 2] for k, v in times.items()}


def _bf16_ulp(t):
    import torch
    a = t.float().abs().clamp_min(1e-30)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def _check_kernel(conv_cuda, x, w, s, p, d):
    """Run K1 (f32 and bf16 out) and the plain version on one shape;
    raise if they disagree. Returns the max abs error of the f32 output
    and of the bf16 output."""
    import torch
    y32 = conv_cuda.conv2d(x, w, s, p, d, out_dtype=torch.float32)
    y16 = conv_cuda.conv2d(x, w, s, p, d)
    torch.cuda.synchronize()
    r32 = conv_cuda.conv2d_reference(x, w, s, p, d, out_dtype=torch.float32)
    r16 = conv_cuda.conv2d_reference(x, w, s, p, d)
    if not torch.isfinite(y32).all():
        raise RuntimeError(f"K1 produced non-finite values at {tuple(x.shape)}")
    err = (y32 - r32).abs()
    if (err > F32_ATOL + F32_RTOL * r32.abs()).any():
        raise RuntimeError(f"K1 f32 output disagrees with conv2d_reference at "
                           f"x {tuple(x.shape)} w {tuple(w.shape)}: max abs "
                           f"err {err.max().item()}")
    if not torch.equal(y16, y32.to(torch.bfloat16)):
        raise RuntimeError(f"K1 bf16 output is not its f32 sum rounded once at "
                           f"x {tuple(x.shape)}")
    d16 = (y16.float() - r16.float()).abs()
    slack = _bf16_ulp(r16) + F32_ATOL + F32_RTOL * r32.abs()
    if (d16 > slack).any():
        raise RuntimeError(f"K1 bf16 output is more than one ulp from "
                           f"conv2d_reference at x {tuple(x.shape)}")
    return err.max().item(), d16.max().item()


def _resnet50(pt, resnet, is_test=True, amp=True):
    """The served program (AMP O2, is_test), its f32 twin (amp=False), or
    its f32 training-mode twin (is_test=False, amp=False): the same
    variable names; batch-norm momentum 0 in training mode, so one run
    writes one batch's statistics into the running ones."""
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        img = pt.layers.data(name="img", shape=[3, 224, 224], dtype="float32")
        logits = resnet.resnet50(img, class_dim=1000, is_test=is_test)
        prob = pt.layers.softmax(logits)
    main.random_seed = startup.random_seed = SEED + 1
    if amp:
        pt.amp.enable(main, level="O2")
    if not is_test:
        for op in main.global_block().ops:
            if op.type == "batch_norm":
                op.set_attr("momentum", 0.0)
    return main, startup, prob, logits


def _eligible_convs(conv_cuda, program, batch, quant=None):
    """(x NHWC shape, w OIHW shape, strides, paddings, dilations) of every
    conv2d of a program's global block, at `batch`, that passes K1's gate
    in bf16 (as under AMP O2) and, given `quant`, also the quant gate: the
    convs the O3 route sends to K11."""
    import torch
    block = program.global_block()
    out = []
    for op in block.ops:
        if op.type != "conv2d":
            continue
        _, c, h, w = block.desc.var(op.input("Input")[0]).shape
        xs = (batch, h, w, c)
        ws = tuple(block.desc.var(op.input("Filter")[0]).shape)
        s, p, d = (tuple(op.attr(a)) for a in ("strides", "paddings",
                                                "dilations"))
        x = torch.empty(xs, dtype=torch.bfloat16, device="meta")
        wt = torch.empty(ws, dtype=torch.bfloat16, device="meta")
        g = op.attr("groups") or 1
        if conv_cuda.ineligible(x, wt, s, p, d, g) is None and (
                quant is None
                or quant.ineligible_conv(x, wt, s, p, d, g) is None):
            out.append((xs, ws, s, p, d))
    return out


def phase_kernel(pt, conv_cuda, resnet, report):
    import torch
    import torch.nn.functional as F
    gen = torch.Generator().manual_seed(SEED)

    def operands(xs, ws):
        x = torch.randn(xs, generator=gen).to(torch.bfloat16).cuda()
        w = (torch.randn(ws, generator=gen) * 0.1).to(torch.bfloat16).cuda()
        return x, w

    worst_err, worst_err16 = 0.0, 0.0
    for h, w, kh, kw, s, p, d in CASES:
        x, wt = operands((2, h, w, 128), (128, 128, kh, kw))
        err, err16 = _check_kernel(conv_cuda, x, wt, s, p, d)
        worst_err, worst_err16 = max(worst_err, err), max(worst_err16, err16)

    main = _resnet50(pt, resnet)[0]
    # K1 at every shape the served path gives it (each bucket's batch);
    # timed below at batch 16 only
    checked = set()
    for b in BUCKETS:
        for key in _eligible_convs(conv_cuda, main, b):
            if b != BATCH and key not in checked:
                checked.add(key)
                x, wt = operands(*key[:2])
                err, err16 = _check_kernel(conv_cuda, x, wt, *key[2:])
                worst_err = max(worst_err, err)
                worst_err16 = max(worst_err16, err16)
    counts = {}
    for key in _eligible_convs(conv_cuda, main, BATCH):
        counts[key] = counts.get(key, 0) + 1

    rows = []
    for (xs, ws, s, p, d), n in counts.items():
        x, wt = operands(xs, ws)
        err, err16 = _check_kernel(conv_cuda, x, wt, s, p, d)
        worst_err, worst_err16 = max(worst_err, err), max(worst_err16, err16)
        x_nchw = x.permute(0, 3, 1, 2)  # channels_last memory, as served
        # K1 with the filter as the served path passes it, an OIHW view of
        # OHWI memory (fusion.fold_constants), which the wrapper reads in
        # place: the graph holds K1's launches only (and its split-K
        # reduction where the plan splits). The plain version and cuDNN
        # with every kernel they launch.
        w_view = wt.contiguous(memory_format=torch.channels_last)
        copies = conv_cuda.COUNTERS.filter_copies
        k_ms = _device_ms(lambda: conv_cuda.conv2d(x, w_view, s, p, d))
        if conv_cuda.COUNTERS.filter_copies != copies:
            raise RuntimeError("K1 copied an OIHW view of OHWI memory")
        plain_ms = _device_ms(lambda: conv_cuda.conv2d_reference(x, wt, s, p, d))
        lib_ms = _device_ms(lambda: F.conv2d(x_nchw, wt, stride=s, padding=p,
                                             dilation=d))
        flops = conv_cuda.conv_flops(x, wt, s, p, d)
        nbytes = conv_cuda.conv_bytes(x, wt, s, p, d)
        ops_ms, bytes_ms = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        row = {"x_nhwc": list(xs), "w_oihw": list(ws), "strides": list(s),
               "paddings": list(p), "dilations": list(d), "per_request": n,
               "ms": k_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": max(ops_ms, bytes_ms),
               "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
               "flops": flops, "bytes": nbytes, "max_abs_err": err,
               "bf16_max_abs_err": err16}
        rows.append(row)
        print(f"K1 shape x{list(xs)} w{list(ws)} s{list(s)} p{list(p)} "
              f"x{n}/request: kernel {k_ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"F.conv2d {lib_ms:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}), err f32 {err:.3g} bf16 {err16:.3g}",
              flush=True)
    print(f"K1 checked at {len(checked) + len(counts)} distinct shapes "
          f"(batches {list(BUCKETS)}) and the {len(CASES)} test cases", flush=True)
    print(f"K1 vs conv2d_reference: max abs err {worst_err:.3g} (f32 out, "
          f"tol {F32_ATOL} + {F32_RTOL}*|ref|); bf16 out = f32 out rounded "
          f"once, bitwise; bf16 out within 1 ulp + the f32 tol of the "
          f"reference's (max abs err {worst_err16:.3g})", flush=True)
    report["k1_shapes"] = rows
    host = wrapper_host_us(conv_cuda)
    report["k1_wrapper_host_us"] = host
    print(f"K1 wrapper host time per call (batch-1 1x1 256->64, queued): "
          + ", ".join(f"{k} filter {v:.1f} us" for k, v in host.items()),
          flush=True)

    def total(key):
        return sum(r[key] * r["per_request"] for r in rows)
    ops_total = sum(r["flops"] * r["per_request"] for r in rows) / PEAK_BF16_FLOPS
    bytes_total = sum(r["bytes"] * r["per_request"] for r in rows) / PEAK_BYTES
    return {"name": "conv2d_fwd", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/conv2d_fwd.cu",
            "replaces": "paddle_tpu/ops/pallas_conv.py:204",
            "max_abs_err": worst_err, "bf16_max_abs_err": worst_err16,
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": "operations" if ops_total >= bytes_total else "bytes",
            "library_ms": total("library_ms"),
            "per": f"the {sum(counts.values())} eligible convs of one "
                   f"batch-{BATCH} ResNet-50 request"}


def phase_slice(pt, conv_cuda, resnet, report):
    import numpy as np
    import torch
    from paddle_tpu_torch.serving import ServingEngine

    main, startup, prob, logits = _resnet50(pt, resnet)
    scope = pt.Scope()
    exe = pt.Executor()                       # CUDAPlace(0) by default
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    print(f"startup on the card: {time.perf_counter() - t0:.2f} s", flush=True)
    calib = np.random.default_rng(SEED + 2).standard_normal(
        (BATCH, 3, 224, 224)).astype(np.float32)
    exe.run(_resnet50(pt, resnet, is_test=False, amp=False)[0],
            feed={"img": calib}, scope=scope)
    engine = ServingEngine(main, ["img"], [prob, logits], buckets=BUCKETS,
                           scope=scope)

    # eligible convs of one forward pass, from the served program's desc
    eligible = len(_eligible_convs(conv_cuda, engine.program, 1))

    rng = np.random.default_rng(SEED)
    requests = [rng.standard_normal((n, 3, 224, 224)).astype(np.float32)
                for n in REQUEST_SIZES]
    for b in BUCKETS:                          # warm-up: one batch per bucket
        engine.infer({"img": requests[0][:1].repeat(b, axis=0)})
    torch.cuda.synchronize()

    conv_cuda.COUNTERS.reset()
    outs, lat = [], {b: [] for b in BUCKETS}
    t_window = time.perf_counter()
    for req in requests:
        t0 = time.perf_counter()
        out = engine.infer({"img": req})       # ends in a device->host copy
        lat[engine.bucket_for(req.shape[0])].append(time.perf_counter() - t0)
        outs.append(out)
    window_s = time.perf_counter() - t_window
    launches = conv_cuda.COUNTERS.launches
    fallbacks = dict(conv_cuda.COUNTERS.fallbacks)
    hits = dict(conv_cuda.COUNTERS.hits)
    if conv_cuda.COUNTERS.filter_copies:
        raise RuntimeError(f"the served requests copied "
                           f"{conv_cuda.COUNTERS.filter_copies} filters: the "
                           f"fold stores each as an OIHW view of OHWI memory")

    for req, (out, _) in zip(requests, outs):
        if out.shape != (req.shape[0], 1000):
            raise RuntimeError(f"output shape {out.shape} for {req.shape}")
        if not np.isfinite(out).all():
            raise RuntimeError("non-finite softmax output")
        sums = out.astype(np.float64).sum(axis=1)
        if np.abs(sums - 1.0).max() > 2e-2:
            raise RuntimeError(f"softmax rows sum to {sums}")
    if launches != eligible * len(requests):
        raise RuntimeError(f"K1 launched {launches} times, expected {eligible} "
                           f"eligible convs x {len(requests)} batches")
    print(f"K1 launches {launches} = {eligible} eligible convs x "
          f"{len(requests)} batches; lowerings routed to K1 {hits}; "
          f"fallbacks by (op, reason) {fallbacks}", flush=True)

    again = engine.infer({"img": requests[0]})
    if not all(np.array_equal(a, b) for a, b in zip(again, outs[0])):
        raise RuntimeError("a repeated request gave a different answer")

    # one request per bucket against the same weights in f32 on the card
    # and on the port's CPU plain path
    main32, _, prob32, logits32 = _resnet50(pt, resnet, amp=False)
    f32_engine = ServingEngine(main32, ["img"], [prob32, logits32],
                               buckets=BUCKETS, scope=scope)
    cpu_scope = pt.Scope()
    for n in engine._prepared.state_names:
        cpu_scope.set_var(n, scope.find_var(n).cpu())
    cpu_engine = ServingEngine(main, ["img"], [prob, logits],
                               place=pt.CPUPlace(), scope=cpu_scope,
                               buckets=BUCKETS)
    agreement, failures = [], []
    t0 = time.perf_counter()
    for i in COMPARED:
        img = {"img": requests[i]}
        z32 = f32_engine.infer(img)
        for what, ref, rtol in (
                ("f32 on the card", z32, F32_LOGIT_RTOL),
                ("the CPU plain path", cpu_engine.infer(img), LOGIT_RTOL)):
            result, failed = _compare(ref, outs[i], what, rtol)
            agreement.append(result)
            failures += failed
        rounded = torch.from_numpy(requests[i]).bfloat16().float().numpy()
        moved = np.abs(f32_engine.infer({"img": rounded})[1] - z32[1])
        sens = float((moved.max(1) / np.abs(z32[1]).max(1)).max())
        agreement[-2]["f32_moved_by_input_rounding"] = sens
        print(f"f32 on the card, {requests[i].shape[0]} rows, input rounded "
              f"to bf16: logits move by {sens:.3g} of the row's largest "
              f"|logit|", flush=True)
    print(f"the references took {time.perf_counter() - t0:.2f} s", flush=True)
    if failures:
        raise RuntimeError("the served answer disagrees with its references: "
                           + "; ".join(failures))

    card = _card_line()
    p50 = {b: float(np.median(v)) * 1e3 for b, v in lat.items() if v}
    ips = sum(REQUEST_SIZES) / window_s
    print(f"p50 latency per bucket (ms, host clock, {card}): "
          + ", ".join(f"bucket {b}: {v:.2f} ({len(lat[b])} requests)"
                      for b, v in p50.items()), flush=True)
    print(f"img/s: {ips:.1f} = {sum(REQUEST_SIZES)} images (padding not "
          f"counted) / {window_s:.4f} s, the {len(requests)} requests' window "
          f"({card})", flush=True)
    top = max(REQUEST_SIZES)
    conv_cuda.COUNTERS.filter_copies = 0
    profile = _profile_request(engine, requests[REQUEST_SIZES.index(top)],
                               p50[engine.bucket_for(top)],
                               {K1_KERNEL: eligible}, card)
    profile["filter_copies"] = conv_cuda.COUNTERS.filter_copies
    print(f"the profiled request: {profile['filter_copies']} filter copies, "
          f"{profile['device_copies']} device copies "
          f"({profile['device_copy_ms']:.3f} ms)", flush=True)
    if profile["filter_copies"]:
        raise RuntimeError(f"the profiled request copied "
                           f"{profile['filter_copies']} filters")
    report["slice"] = {"p50_ms": p50, "latencies_s": lat,
                       "img_per_s": ips, "window_s": window_s,
                       "launches": launches,
                       "eligible_convs": eligible, "fallbacks": {
                           f"{k[0]}:{k[1]}": v for k, v in fallbacks.items()},
                       "agreement": agreement, "card": card,
                       "profile": profile}
    return launches, {"scope": scope, "main": main, "fetch": [prob, logits],
                      "requests": requests, "outs": outs, "p50_ms": p50,
                      "img_per_s": ips}


def _compare(ref_out, got_out, what, rtol, served="O2"):
    """Hold one served request (softmax, logits) against a reference's
    answer, row by row, with the tolerances stated at the top. Returns the
    numbers and the checks that failed."""
    import numpy as np
    ref_prob, ref_logits = (a.astype(np.float64) for a in ref_out)
    got_prob, got_logits = (a.astype(np.float64) for a in got_out)
    n = ref_prob.shape[0]
    if got_prob.shape != (n, 1000) or ref_logits.shape != got_logits.shape:
        return {}, [f"{what}: shapes {got_prob.shape} vs {ref_prob.shape}"]
    d = np.abs(got_logits - ref_logits).max(axis=1)
    scale = np.abs(ref_logits).max(axis=1)
    top = np.sort(ref_logits, axis=1)
    margin = top[:, -1] - top[:, -2]
    p_bound = ref_prob * (np.exp(2 * d)[:, None] * (1 + 2.0 ** -7) - 1)
    dp = np.abs(got_prob - ref_prob)
    top_prob = ref_prob.max(axis=1)
    decided = margin > 2 * d
    same = ref_prob.argmax(1) == got_prob.argmax(1)
    result = {"against": what, "rows": n,
              "logit_max_abs_diff": float(d.max()),
              "logit_rel_diff": float((d / scale).max()),
              "largest_abs_logit": float(scale.max()),
              "softmax_max_abs_diff": float(dp.max()),
              "softmax_diff_over_bound": float((dp / p_bound).max()),
              "top_prob_max": float(top_prob.max()),
              "top2_margin_min": float(margin.min()),
              "argmax_equal": int(same.sum()),
              "argmax_decided": int(decided.sum())}
    print(f"served {served} vs {what}, {n} rows: logits max abs diff "
          f"{result['logit_max_abs_diff']:.4g} = {result['logit_rel_diff']:.3g} "
          f"of the row's largest |logit| (tol {rtol}; largest "
          f"{result['largest_abs_logit']:.4g}); softmax max abs diff "
          f"{result['softmax_max_abs_diff']:.3g}, at most "
          f"{result['softmax_diff_over_bound']:.3g} of its bound; top prob "
          f"<= {result['top_prob_max']:.4f}; argmax equal in {same.sum()} of "
          f"{n} rows ({decided.sum()} with a top-2 margin over 2x the logit "
          f"diff; smallest margin {result['top2_margin_min']:.4g})", flush=True)
    failed = []
    if (d > rtol * scale).any():
        failed.append(f"{what}: logits past {rtol} of the row's scale")
    if (dp > p_bound).any():
        failed.append(f"{what}: softmax past the bound the logits imply")
    if (top_prob >= MAX_TOP_PROB).any():
        failed.append(f"{what}: softmax saturated (top prob "
                      f"{top_prob.max()}), its check would be vacuous")
    if not same[decided].all():
        failed.append(f"{what}: argmax differs where the top-2 margin "
                      f"exceeds twice the logit difference")
    return result, failed


def _is_span(event) -> bool:
    return event.name.split(":", 1)[0] in SPANS


def _profile_request(engine, req, p50_ms, expect, card, attempts=3):
    """Where one served request's time goes on the device: torch.profiler's
    CUDA activity for one request, as the busy share of the unprofiled p50
    latency of its bucket (the profiler's own host cost inflates the
    profiled wall time), the hand-written kernels' launches and time
    (`expect`: kernel name -> launches per request), the device time of the
    activation-quantize passes (the kernels inside quant.ACT_SPAN's device
    extents), and the device time of the torch ops that launched the rest.
    The profiler now and then loses a window's CUDA activity, so a request
    whose trace does not hold the expected launches is profiled again, up
    to `attempts` times in all; then this raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            engine.infer({"img": req})
            wall_ms = (time.perf_counter() - t0) * 1e3
        cuda = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        events = [e for e in cuda if not _is_span(e)]
        kernels = {k: [e.time_range.elapsed_us() / 1e3 for e in events
                       if k in e.name] for k in expect}
        seen = {k: len(v) for k, v in kernels.items()}
        if seen == expect:
            break
        print(f"profile attempt {attempt}: the trace holds {seen} launches, "
              f"expected {expect}", flush=True)
    else:
        raise RuntimeError(f"the profiler saw {seen} launches in one request, "
                           f"expected {expect}, in each of {attempts} "
                           f"attempts")
    busy_us, end = 0.0, float("-inf")
    for e in sorted(events, key=lambda e: e.time_range.start):
        s, t = e.time_range.start, e.time_range.end   # union of intervals
        if t > end:
            busy_us += t - max(s, end)
            end = t
    busy_ms = busy_us / 1e3
    act = [(e.time_range.start, e.time_range.end) for e in cuda
           if e.name == "quant:act"]
    act_ms = sum(e.time_range.elapsed_us() for e in events
                 if any(a <= e.time_range.start < b for a, b in act)) / 1e3
    # kernels launched by torch ops, by op (the hand-written kernels launch
    # through ctypes, outside any torch op); only aten ops, since the
    # profiler's own bookkeeping entries can claim a copy that aten::copy_
    # also counts
    by_op = sorted(((a.key, a.self_device_time_total / 1e3, a.count)
                    for a in prof.key_averages()
                    if a.key.startswith("aten::")
                    and a.self_device_time_total > 0), key=lambda t: -t[1])
    mine = "; ".join(f"{k} {sum(v):.3f} ms x{len(v)} ({sum(v) / busy_ms:.1%})"
                     for k, v in kernels.items())
    # K1's split-K passes: the in-order sum of the splits (and K4's
    # statistics of it), launched after the split mainloops
    split = [e.time_range.elapsed_us() / 1e3 for e in events
             if any(k in e.name for k in SPLIT_KERNELS)]
    if split:
        mine += f"; split-K reductions {sum(split):.3f} ms x{len(split)}"
    copies = [(ms, n) for k, ms, n in by_op if k == "aten::copy_"]
    copy_ms, copy_n = copies[0] if copies else (0.0, 0)
    quant_part = (f"; activation quantize {act_ms:.3f} ms "
                  f"({act_ms / busy_ms:.1%}) in {len(act)} passes"
                  if act else "")
    print(f"device time of one batch-{req.shape[0]} request: busy {busy_ms:.3f} "
          f"ms = {busy_ms / p50_ms:.1%} of its p50 {p50_ms:.2f} ms (profiled "
          f"wall {wall_ms:.2f} ms; {card}); {mine}{quant_part}; "
          + "; ".join(f"{k} {ms:.3f} ms x{n}" for k, ms, n in by_op[:8]),
          flush=True)
    return {"busy_ms": busy_ms, "p50_ms": p50_ms,
            "busy_share_of_p50": busy_ms / p50_ms, "profiled_wall_ms": wall_ms,
            "kernels": {k: {"ms": sum(v), "launches": len(v),
                            "share_of_busy": sum(v) / busy_ms}
                        for k, v in kernels.items()},
            "split_reduce_ms": sum(split), "split_reduce_launches": len(split),
            "device_copies": copy_n, "device_copy_ms": copy_ms,
            "act_quant_ms": act_ms if act else None,
            "act_quant_passes": len(act),
            "by_op": [{"op": k, "ms": ms, "calls": n} for k, ms, n in by_op]}


# --- int8 serving: K11 -----------------------------------------------------------

def _check_q8(conv_cuda, x, w, s, p, d, dq):
    """K11 (bf16 and f32 out, the bf16 call twice) against its plain
    version on one shape: bitwise, or raise. Returns the largest |got -
    want| of the compared outputs."""
    import torch
    y = conv_cuda.conv2d_q8(x, w, s, p, d, dq)
    y2 = conv_cuda.conv2d_q8(x, w, s, p, d, dq)
    y32 = conv_cuda.conv2d_q8(x, w, s, p, d, dq, out_dtype=torch.float32)
    torch.cuda.synchronize()
    r = conv_cuda.conv2d_q8_reference(x, w, s, p, d, dq)
    r32 = conv_cuda.conv2d_q8_reference(x, w, s, p, d, dq,
                                        out_dtype=torch.float32)
    worst = 0.0
    for got, want, what in ((y, r, "bf16"), (y2, y, "repeated bf16"),
                            (y32, r32, "f32")):
        err = (got.float() - want.float()).abs().max().item()
        worst = max(worst, err)
        if not torch.equal(got, want):
            raise RuntimeError(f"K11 {what} output disagrees with its plain "
                               f"version at x {tuple(x.shape)} w "
                               f"{tuple(w.shape)} s{s} p{p}: max abs err {err}")
    return worst


def _q8_splits_hold(conv_cuda, x, w, s, p, d, dq, want):
    """K11 with its plan's split-K forced off and (where the plan does not
    split) on, bf16 and f32 out, each bitwise `want` (the plain version's
    bf16 output) or raise; the integer sums make the split exact. Returns
    the split counts run."""
    import dataclasses

    import torch
    planner = conv_cuda.conv_plan
    oh, ow = conv_cuda._out_hw(x, w, s, p, d)
    plan = planner(tuple(x.shape), w.shape[0], w.shape[2], w.shape[3], oh, ow,
                   s, p, elem=1)
    ks = {1, plan.splits if plan.splits > 1 else min(4, plan.steps)}
    want32 = conv_cuda.conv2d_q8_reference(x, w, s, p, d, dq,
                                           out_dtype=torch.float32)
    for k in sorted(ks):
        per = -(-plan.steps // k)
        alt = dataclasses.replace(plan, splits=-(-plan.steps // per), per=per,
                                  stages=min(plan.stages, max(per, 2)))
        conv_cuda.conv_plan = lambda *a, _alt=alt, **kw: _alt
        try:
            y = conv_cuda.conv2d_q8(x, w, s, p, d, dq)
            y32 = conv_cuda.conv2d_q8(x, w, s, p, d, dq,
                                      out_dtype=torch.float32)
        finally:
            conv_cuda.conv_plan = planner
        torch.cuda.synchronize()
        if not (torch.equal(y, want) and torch.equal(y32, want32)):
            raise RuntimeError(f"K11 split {alt.splits} is not bitwise its "
                               f"plain version at x {tuple(x.shape)} w "
                               f"{tuple(w.shape)}")
    return sorted(ks)


def parent_q8(parent):
    """The older checkout's int8 conv entry (`csrc/conv2d_q8.cu`: x, w
    OHWI, dq, y, 15 shape ints, out_f32, stream) as a function of (x, w
    OHWI, s, p, d, dq) -> y bf16."""
    import ctypes

    import torch
    fn = build_parent(parent, "conv2d_q8.cu", "parent_conv2d_q8").conv2d_q8
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 16 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(x, w_ohwi, s, p, d, dq):
        n, h, wd, ci = x.shape
        co, kh, kw, _ = w_ohwi.shape
        oh = (h + 2 * p[0] - d[0] * (kh - 1) - 1) // s[0] + 1
        ow = (wd + 2 * p[1] - d[1] * (kw - 1) - 1) // s[1] + 1
        y = torch.empty((n, oh, ow, co), dtype=torch.bfloat16, device=x.device)
        rc = fn(x.data_ptr(), w_ohwi.data_ptr(), dq.data_ptr(), y.data_ptr(),
                n, h, wd, ci, co, kh, kw, oh, ow, s[0], s[1], p[0], p[1],
                d[0], d[1], 0, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"the parent's conv2d_q8 failed: CUDA {rc}")
        return y
    return run


def phase_kernel_q8(pt, conv_cuda, resnet, report, parent=None):
    """K11 against its plain version, bitwise, at CASES and at every
    distinct quantized ResNet-50 conv shape at each bucket's batch, split
    and unsplit; then per shape at batch 16 the kernel's time, the plain
    version's, K1's in bf16 at the same shape (the O2 counterpart) and,
    given `parent`, the older checkout's int8 kernel, beside the bound."""
    import torch
    from paddle_tpu_torch import quant
    gen = torch.Generator().manual_seed(SEED + 7)
    before = None if parent is None else parent_q8(parent)

    def operands(xs, ws):
        x = torch.randint(-127, 128, xs, generator=gen, dtype=torch.int8)
        w = torch.randint(-127, 128, ws, generator=gen, dtype=torch.int8)
        dq = torch.rand(ws[0], generator=gen) * 1e-4 + 1e-6
        return x.cuda(), w.cuda(), dq.cuda()

    worst = 0.0
    for h, w, kh, kw, s, p, d in CASES:
        x, wt, dq = operands((2, h, w, 128), (128, 128, kh, kw))
        worst = max(worst, _check_q8(conv_cuda, x, wt, s, p, d, dq))
    main = _resnet50(pt, resnet)[0]
    checked = {}                               # shape -> max abs err
    split_runs = 0
    for b in BUCKETS:
        for key in _eligible_convs(conv_cuda, main, b, quant):
            if key not in checked:
                x, wt, dq = operands(*key[:2])
                checked[key] = _check_q8(conv_cuda, x, wt, *key[2:], dq)
                want = conv_cuda.conv2d_q8_reference(x, wt, *key[2:], dq)
                split_runs += len(_q8_splits_hold(conv_cuda, x, wt, *key[2:],
                                                  dq, want))
    worst = max(worst, *checked.values())
    counts = {}
    for key in _eligible_convs(conv_cuda, main, BATCH, quant):
        counts[key] = counts.get(key, 0) + 1
    if sum(counts.values()) != Q8_LAUNCHES["q8_launches"]:
        raise RuntimeError(f"{sum(counts.values())} quantized convs in "
                           f"ResNet-50, expected {Q8_LAUNCHES['q8_launches']}")

    rows = []
    for key, n in counts.items():
        xs, ws, s, p, d = key
        x, wt, dq = operands(xs, ws)
        # an OIHW view of OHWI memory: the wrapper then copies nothing, as
        # with the engine's int8 filters
        w_view = wt.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)
        k_ms = _device_ms(lambda: conv_cuda.conv2d_q8(x, w_view, s, p, d, dq))
        plain_ms = _device_ms(
            lambda: conv_cuda.conv2d_q8_reference(x, wt, s, p, d, dq))
        xb = torch.randn(xs, generator=gen).to(torch.bfloat16).cuda()
        wb = (torch.randn(ws, generator=gen) * 0.1).to(torch.bfloat16)
        wb = wb.contiguous(memory_format=torch.channels_last).cuda()
        k1_ms = _device_ms(lambda: conv_cuda.conv2d(xb, wb, s, p, d))
        parent_ms = None
        if before is not None:
            w_ohwi = w_view.permute(0, 2, 3, 1)
            if not torch.equal(before(x, w_ohwi, s, p, d, dq),
                               conv_cuda.conv2d_q8(x, w_view, s, p, d, dq)):
                raise RuntimeError("the parent tree's K11 disagrees with "
                                   "this tree's")
            parent_ms = _device_ms(lambda: before(x, w_ohwi, s, p, d, dq))
        ops = conv_cuda.conv_flops(x, wt, s, p, d)
        nbytes = conv_cuda.conv_bytes(x, wt, s, p, d) + 4 * ws[0]   # + dq
        ops_ms, bytes_ms = ops / PEAK_INT8_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
        row = {"x_nhwc": list(xs), "w_oihw": list(ws), "strides": list(s),
               "paddings": list(p), "dilations": list(d), "per_request": n,
               "ms": k_ms, "plain_ms": plain_ms, "k1_bf16_ms": k1_ms,
               "parent_ms": parent_ms,
               "library_ms": None, "bound_ms": max(ops_ms, bytes_ms),
               "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
               "ops": ops, "bytes": nbytes, "max_abs_err": checked[key]}
        rows.append(row)
        print(f"K11 shape x{list(xs)} w{list(ws)} s{list(s)} p{list(p)} "
              f"x{n}/request: kernel {k_ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"K1 bf16 {k1_ms:.4f} ms, parent tree {parent_ms} ms, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']})", flush=True)
    print(f"K11 bitwise equal to conv2d_q8_reference (bf16 and f32 out, "
          f"repeat bitwise) at {len(checked)} distinct shapes (batches "
          f"{list(BUCKETS)}) and the {len(CASES)} test cases; split-K "
          f"forced off and on: {split_runs} runs, each bitwise", flush=True)
    report["k11_shapes"] = rows

    def total(key):
        return sum(r[key] * r["per_request"] for r in rows)
    ops_total = sum(r["ops"] * r["per_request"] for r in rows) / PEAK_INT8_OPS
    bytes_total = sum(r["bytes"] * r["per_request"] for r in rows) / PEAK_BYTES
    parent_total = None if before is None else total("parent_ms")
    print(f"K11 per batch-{BATCH} request: {total('ms'):.4f} ms, K1 in bf16 "
          f"at the same shapes {total('k1_bf16_ms'):.4f}, parent tree "
          f"{parent_total}, bound {total('bound_ms'):.4f}", flush=True)
    return {"name": "conv2d_q8", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/conv2d_fwd.cu",
            "replaces": "paddle_tpu/ops/pallas_conv.py:431",
            "max_abs_err": worst, "ms": total("ms"),
            "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
            "bound_by": "operations" if ops_total >= bytes_total else "bytes",
            "library_ms": None, "k1_bf16_ms": total("k1_bf16_ms"),
            "parent_ms": parent_total,
            "per": f"the {sum(counts.values())} quantized convs of one "
                   f"batch-{BATCH} ResNet-50 request"}


def _hold_folds(card, cpu):
    """Hold the card engine's fold constants to the CPU engine's within the
    FOLD_* bounds, or raise. Returns the worst differences and how many
    windows and int8 values differ at all."""
    import torch
    pg, pc = card._prepared, cpu._prepared
    if set(pg.folds) != set(pc.folds):
        raise RuntimeError("the card and CPU engines fold different windows")
    bounds = {"filter_ulps": 1, "bias_rel": FOLD_BIAS_REL,
              "scale_rel": FOLD_SCALE_REL, "q8_max_step": 1}
    out = {"folds": len(pc.folds), "differ": 0, "q8_differ": 0,
           "q8_values": 0, **{k: 0 for k in bounds}}
    for anchor, (w_c, b_c, (q_c, s_c)) in pc.folds.items():
        w_g, b_g, (q_g, s_g) = pg.folds[anchor]
        w_g, b_g, q_g, s_g = (t.cpu() for t in (w_g, b_g, q_g, s_g))
        bn = pc.groups[anchor].bn
        st = {k: cpu._state[bn.desc.input(k)[0]].float()
              for k in ("Scale", "Bias", "Mean", "Variance")}
        s = st["Scale"] * torch.rsqrt(st["Variance"] + bn.attr("epsilon", 1e-5))
        terms = (st["Bias"].abs() + (st["Mean"] * s).abs()).clamp_min(1e-30)
        wg, wc = w_g.float(), w_c.float()
        step = (q_g.int() - q_c.int()).abs()
        worst = {"filter_ulps": ((wg - wc).abs() / _bf16_ulp(
                     torch.maximum(wg.abs(), wc.abs()))).max().item(),
                 "bias_rel": ((b_g - b_c).abs() / terms).max().item(),
                 "scale_rel": ((s_g - s_c).abs() / s_c).max().item(),
                 "q8_max_step": int(step.max())}
        for k, v in worst.items():
            if not v <= bounds[k]:                 # NaN fails too
                raise RuntimeError(f"the card's fold constants at op {anchor} "
                                   f"are off the CPU engine's: {k} {v} "
                                   f"(bound {bounds[k]:.3g})")
            out[k] = max(out[k], v)
        out["q8_differ"] += int((step > 0).sum())
        out["q8_values"] += step.numel()
        out["differ"] += int(not all(torch.equal(a, b) for a, b in (
            (w_g, w_c), (b_g, b_c), (q_g, q_c), (s_g, s_c))))
    if out["q8_differ"] > FOLD_Q8_SHARE * out["q8_values"]:
        raise RuntimeError(f"{out['q8_differ']} of the card's "
                           f"{out['q8_values']} folded int8 filter values "
                           f"differ from the CPU engine's, more than "
                           f"{FOLD_Q8_SHARE:.3g} of them")
    return out


def _serve_lockstep(conv_cuda, card, cpu, req):
    """One request, padded to its bucket, through the card engine's prepared
    program with every op and window run again, on a CPU copy of the card's
    inputs to it, through the CPU engine's, each float output held to the
    card's (_hold_outputs). The CPU side gets a CPU copy of the card's fold
    constants too (_hold_folds holds them to the CPU engine's own). With
    equal inputs and constants every quantized conv window must agree
    bitwise (K11 equals its plain version, the quantizers are exact f32
    operations), or this raises. Returns the tally."""
    import torch
    from paddle_tpu_torch.executor import LoweringContext
    from paddle_tpu_torch.ops import fusion
    from paddle_tpu_torch.serving.engine import _pad_rows

    def to_cpu(fold):
        wf, bf, pre = fold
        return wf.cpu(), bf.cpu(), pre and tuple(t.cpu() for t in pre)

    pg, pc = card._prepared, cpu._prepared
    ctx_g = LoweringContext(pg.executor, pg.program, 0)
    ctx_g.folds = pg.folds
    ctx_c = LoweringContext(pc.executor, pc.program, 0)
    ctx_c.folds = {a: to_cpu(f) for a, f in pg.folds.items()}
    groups_g, groups_c = pg.groups or {}, pc.groups or {}
    ops_g, ops_c = pg.program.global_block().ops, pc.program.global_block().ops
    env = dict(card._state)
    env[card.feed_names[0]] = torch.from_numpy(
        _pad_rows(req, card.bucket_for(req.shape[0]))).to(card.device)
    tally = {"worst": {}, "outputs": 0, "bitwise": 0, "q8_windows": 0,
             "q8_bitwise": 0}
    i = 0
    while i < len(ops_g):
        g, start = groups_g.get(i), i
        members = g.members if g is not None else (ops_g[i],)
        env_c = {n: env[n].cpu() for m in members for n in m.input_arg_names
                 if isinstance(env.get(n), torch.Tensor)}
        q8_before = conv_cuda.COUNTERS.q8_launches
        if g is not None:
            fusion.execute_group(pg.executor, ctx_g, g, env, pg.protected)
            fusion.execute_group(pc.executor, ctx_c, groups_c[i], env_c,
                                 pc.protected)
            i, kind = g.end, "+".join(m.type for m in members)
        else:
            pg.executor._exec_op(ctx_g, ops_g[i], env)
            pc.executor._exec_op(ctx_c, ops_c[i], env_c)
            i, kind = i + 1, ops_g[i].type
        equal = _hold_outputs(kind, members, env, env_c, tally)
        if conv_cuda.COUNTERS.q8_launches > q8_before:
            tally["q8_windows"] += 1
            tally["q8_bitwise"] += int(equal)
            if not equal:
                raise RuntimeError(f"O3 lockstep: a quantized {kind} window "
                                   f"(op {start}) differs from the "
                                   f"CPU plain path on equal inputs and "
                                   f"fold constants")
    return tally


def phase_serve_q8(pt, conv_cuda, resnet, report, served):
    """ResNet-50 served in int8 from a saved inference model: the smoke's
    calibrated weights written by io.save_inference_model, served by
    ServingEngine(dir, quantize="int8") through the 12 requests."""
    import tempfile

    import numpy as np
    import torch
    from paddle_tpu_torch import quant
    from paddle_tpu_torch.serving import ServingEngine

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as model_dir:
        t0 = time.perf_counter()
        with pt.scope_guard(served["scope"]):
            pt.io.save_inference_model(model_dir, ["img"], served["fetch"],
                                       pt.Executor(),
                                       main_program=served["main"])
        saved_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        engine = ServingEngine(model_dir, quantize="int8", buckets=BUCKETS)
        torch.cuda.synchronize()
        admit_s = time.perf_counter() - t0
        cpu_engine = ServingEngine(model_dir, place=pt.CPUPlace(),
                                   quantize="int8", buckets=BUCKETS)
    qr = engine.quant_report
    print(f"saved the calibrated ResNet-50 in {saved_s:.2f} s; the int8 "
          f"engine loaded and quantized it in {admit_s:.2f} s: "
          f"{len(qr['quantized'])} weights quantized, skipped "
          f"{qr['skipped']}", flush=True)
    if len(qr["quantized"]) != Q8_REPORT_NAMES or qr["skipped"] or \
            cpu_engine.quant_report != qr:
        raise RuntimeError(f"quant_report {qr}: expected {Q8_REPORT_NAMES} "
                           f"quantized weights, none skipped")

    requests = served["requests"]
    for b in BUCKETS:                          # warm-up: one batch per bucket
        engine.infer({"img": requests[0][:1].repeat(b, axis=0)})
    torch.cuda.synchronize()
    conv_cuda.COUNTERS.reset()
    quant.COUNTERS.reset()
    outs, lat = [], {b: [] for b in BUCKETS}
    t_window = time.perf_counter()
    for req in requests:
        t0 = time.perf_counter()
        out = engine.infer({"img": req})       # ends in a device->host copy
        lat[engine.bucket_for(req.shape[0])].append(time.perf_counter() - t0)
        outs.append(out)
    window_s = time.perf_counter() - t_window
    runs = len(requests)
    counts = {"q8_launches": conv_cuda.COUNTERS.q8_launches,
              "launches": conv_cuda.COUNTERS.launches}
    hits, fallbacks = dict(quant.COUNTERS.hits), dict(quant.COUNTERS.fallbacks)
    conv_fallbacks = dict(conv_cuda.COUNTERS.fallbacks)
    want = ({k: v * runs for k, v in Q8_LAUNCHES.items()},
            {k: v * runs for k, v in Q8_HITS.items()},
            {k: v * runs for k, v in Q8_FALLBACKS.items()},
            {k: v * runs for k, v in Q8_CONV_FALLBACKS.items()})
    copies = conv_cuda.COUNTERS.filter_copies
    print(f"O3 over {runs} bucket runs: K11 launches {counts['q8_launches']}, "
          f"K1 launches {counts['launches']}; quant hits {hits}, quant "
          f"fallbacks {fallbacks}; conv fallbacks {conv_fallbacks}; filters "
          f"copied {copies}", flush=True)
    if copies:
        raise RuntimeError(f"the O3 requests copied {copies} filters: the "
                           f"int8 engine's filters are read in place")
    if (counts, hits, fallbacks, conv_fallbacks) != want:
        raise RuntimeError(f"O3 routing {counts} {hits} {fallbacks} "
                           f"{conv_fallbacks}, expected {want}")
    for req, (out, _) in zip(requests, outs):
        if out.shape != (req.shape[0], 1000) or not np.isfinite(out).all():
            raise RuntimeError(f"output {out.shape} for {req.shape}, or not "
                               f"finite")
        sums = out.astype(np.float64).sum(axis=1)
        if np.abs(sums - 1.0).max() > 2e-2:
            raise RuntimeError(f"softmax rows sum to {sums}")
    again = engine.infer({"img": requests[0]})
    if not all(np.array_equal(a, b) for a, b in zip(again, outs[0])):
        raise RuntimeError("a repeated request gave a different answer")

    folds = _hold_folds(engine, cpu_engine)
    print(f"fold constants, card against the CPU engine: {folds['differ']} "
          f"of {folds['folds']} windows differ at all; filter at most "
          f"{folds['filter_ulps']:.3g} bf16 ulp apart, bias "
          f"{folds['bias_rel']:.3g} of |bias| + |mean * s|, int8 scales "
          f"{folds['scale_rel']:.3g} relative, int8 values "
          f"{folds['q8_differ']} of {folds['q8_values']} off by at most "
          f"{folds['q8_max_step']} step", flush=True)
    t0 = time.perf_counter()
    rows = requests[COMPARED[1]].shape[0]
    lockstep = _serve_lockstep(conv_cuda, engine, cpu_engine,
                               requests[COMPARED[1]])
    if lockstep["q8_windows"] != Q8_LAUNCHES["q8_launches"]:
        raise RuntimeError(f"O3 lockstep: {lockstep['q8_windows']} windows "
                           f"ran K11, expected {Q8_LAUNCHES['q8_launches']}")
    print(f"O3 lockstep, a {rows}-row request (bucket "
          f"{engine.bucket_for(rows)}): "
          f"{lockstep['bitwise']} of {lockstep['outputs']} float outputs "
          f"bitwise equal to the CPU plain path on the card's inputs, "
          f"{lockstep['q8_bitwise']} of {lockstep['q8_windows']} quantized "
          f"conv windows, with the card's fold constants on both sides; "
          f"worst relative L2 by kind "
          + ", ".join(f"{k} {v:.3g}" for k, v in sorted(
              lockstep["worst"].items(), key=lambda kv: -kv[1])[:6])
          + f" ({time.perf_counter() - t0:.2f} s)", flush=True)

    agreement, failures, vs_o2 = [], [], []
    t0 = time.perf_counter()
    for i in COMPARED:
        result, failed = _compare(cpu_engine.infer({"img": requests[i]}),
                                  outs[i], "the CPU plain path in O3",
                                  Q8_LOGIT_RTOL, served="O3")
        agreement.append(result)
        failures += failed
    print(f"the CPU reference took {time.perf_counter() - t0:.2f} s",
          flush=True)
    for req, (_, lq), (_, l2) in zip(requests, outs, served["outs"]):
        d = np.abs(lq.astype(np.float64) - l2).max(axis=1)
        vs_o2.append({"rows": req.shape[0],
                      "logit_rel_diff": float((d / np.abs(l2).max(axis=1))
                                              .max()),
                      "argmax_equal": int((lq.argmax(1) == l2.argmax(1))
                                          .sum())})
    worst = max(v["logit_rel_diff"] for v in vs_o2)
    same = sum(v["argmax_equal"] for v in vs_o2)
    print(f"O3 vs O2 on the card, the same {runs} requests: logits at most "
          f"{worst:.3g} of the row's largest |logit| apart; argmax equal in "
          f"{same} of {sum(REQUEST_SIZES)} rows", flush=True)
    if failures:
        raise RuntimeError("the O3 answer disagrees with the CPU plain path: "
                           + "; ".join(failures))

    card = _card_line()
    p50 = {b: float(np.median(v)) * 1e3 for b, v in lat.items() if v}
    ips = sum(REQUEST_SIZES) / window_s
    print(f"O3 p50 latency per bucket (ms, host clock, {card}): "
          + ", ".join(f"bucket {b}: {v:.2f} (O2 {served['p50_ms'][b]:.2f})"
                      for b, v in p50.items())
          + f"; img/s {ips:.1f} (O2 {served['img_per_s']:.1f})", flush=True)
    top = max(REQUEST_SIZES)
    profile = _profile_request(
        engine, requests[REQUEST_SIZES.index(top)], p50[engine.bucket_for(top)],
        {K11_KERNEL: Q8_LAUNCHES["q8_launches"],
         K1_KERNEL: Q8_LAUNCHES["launches"]}, card)
    report["serve_q8"] = {"card": card, "p50_ms": p50, "latencies_s": lat,
                          "img_per_s": ips, "window_s": window_s,
                          "o2_p50_ms": served["p50_ms"],
                          "o2_img_per_s": served["img_per_s"],
                          "launches": counts, "hits": hits,
                          "fallbacks": {f"{k[0]}:{k[1]}": v
                                        for k, v in fallbacks.items()},
                          "quant_report_names": len(qr["quantized"]),
                          "agreement": agreement, "vs_o2": vs_o2,
                          "lockstep": lockstep, "folds": folds,
                          "profile": profile, "save_s": saved_s,
                          "admit_s": admit_s}
    return counts


# --- training: the kernels K2-K6 ------------------------------------------------

def _resnet50_train(pt, resnet, amp=True):
    """bench.py's `resnet` training mode through the port's fluid API:
    build_image_classifier (softmax cross entropy, mean, accuracy), Momentum
    0.9 at TRAIN_LR, amp.decorate(level="O2")."""
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        img = pt.layers.data(name="img", shape=[3, 224, 224], dtype="float32")
        label = pt.layers.data(name="label", shape=[1], dtype="int64")
        avg_cost, _, _ = pt.models.build_image_classifier(
            resnet.resnet50, img, label, class_dim=1000)
        opt = pt.optimizer.Momentum(learning_rate=TRAIN_LR, momentum=0.9)
        if amp:
            opt = pt.amp.decorate(opt, level="O2")
        opt.minimize(avg_cost)
    main.random_seed = startup.random_seed = SEED + 1
    return main, startup, avg_cost


def _training_shapes(conv_cuda, program, batch):
    """Every distinct shape ResNet-50 training gives K2/K3/K4 (the eligible
    convs: x NHWC, w OIHW, strides, paddings, dilations), K5 (the [M, C] of
    each eligible conv's bn, with the window's act) and K6 (the bn of a conv
    that fails the gate), with how many times a step runs each, from the
    program's conv -> bn [-> act] windows."""
    import torch
    from paddle_tpu_torch.ops import fusion
    block = program.global_block()
    convs, applies, acts = {}, {}, {}
    for g in fusion.plan(program).values():
        if g.conv is None:
            continue
        op = g.conv
        _, c, h, w = block.desc.var(op.input("Input")[0]).shape
        key = ((batch, h, w, c), tuple(block.desc.var(op.input("Filter")[0]).shape),
               tuple(op.attr("strides")), tuple(op.attr("paddings")),
               tuple(op.attr("dilations")))
        _, co, oh, ow = block.desc.var(op.output("Output")[0]).shape
        bn_key = (batch * oh * ow, co, None if g.act is None else g.act.type)
        probe = [torch.empty(k, dtype=torch.bfloat16, device="meta")
                 for k in key[:2]]
        if conv_cuda.ineligible(*probe, *key[2:]) is None:
            convs[key] = convs.get(key, 0) + 1
            applies[bn_key] = applies.get(bn_key, 0) + 1
        else:
            acts[bn_key] = acts.get(bn_key, 0) + 1
    return convs, applies, acts


def _sum_err(got, want, mags):
    """Max abs error, and raise if past SUM_RTOL * sum |a||b|."""
    err = (got.float() - want.float()).abs()
    if (err > SUM_RTOL * mags.float() + 1e-6).any():
        raise ValueError(f"max abs err {err.max().item():.4g} past "
                         f"{SUM_RTOL} * sum|a||b|")
    return err.max().item()


def _bf16_err(got, want, slack=0.0):
    """Max abs error of a bf16 output, and raise if past one ulp of the
    plain version's plus `slack` (the f32 tolerance of the sum it rounds)."""
    err = (got.float() - want.float()).abs()
    if (err > _bf16_ulp(want) + slack + 1e-6).any():
        raise ValueError(f"bf16 output {err.max().item():.4g} past one ulp")
    return err.max().item()


def _twice(fn):
    """Run `fn` twice; raise unless every output is bitwise the same."""
    import torch
    a, b = fn(), fn()
    for x, y in zip(a if isinstance(a, tuple) else (a,),
                    b if isinstance(b, tuple) else (b,)):
        if (x is None) != (y is None) or (x is not None and not torch.equal(x, y)):
            raise RuntimeError("a repeated call gave different bits")
    return a


def _row(name, shape, n, ms, plain_ms, lib_ms, flops, nbytes, err, peak_ops):
    ops_ms, bytes_ms = flops / peak_ops * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"kernel": name, "shape": shape, "per_step": n, "ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "flops": flops, "bytes": nbytes, "max_abs_err": err}


def phase_kernel_train(pt, conv_cuda, bn_cuda, resnet, report):
    """K2-K6 at every distinct ResNet-50 training shape at batch 32: held
    against the plain versions, twice bitwise, then timed."""
    import torch
    import torch.nn.functional as F
    gen = torch.Generator().manual_seed(SEED + 3)

    def randn(shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(torch.bfloat16).cuda()

    main = _resnet50_train(pt, resnet)[0]
    convs, applies, acts = _training_shapes(conv_cuda, main, TRAIN_BATCH)
    rows = []
    for (xs, ws, s, p, d), n in convs.items():
        x, w = randn(xs), randn(ws, 0.1)
        oh, ow = conv_cuda._out_hw(x, w, s, p, d)
        dout = randn((xs[0], oh, ow, ws[0]))
        hw, khw = xs[1:3], ws[2:]
        shape = f"x{list(xs)} w{list(ws)} s{list(s)} p{list(p)}"
        flops = conv_cuda.conv_flops(x, w, s, p, d)
        x_nchw, d_nchw = x.permute(0, 3, 1, 2), dout.permute(0, 3, 1, 2)
        w_view = w.contiguous(memory_format=torch.channels_last)  # as cast

        # K2: dx in bf16 (as on the path) and f32, against the plain version
        g32 = _twice(lambda: conv_cuda.conv2d_grad_input(
            dout, w, hw, s, p, d, out_dtype=torch.float32))
        g16 = _twice(lambda: conv_cuda.conv2d_grad_input(dout, w, hw, s, p, d))
        r32 = conv_cuda.conv2d_grad_input_reference(dout, w, hw, s, p, d,
                                                    out_dtype=torch.float32)
        mags = conv_cuda.conv2d_grad_input_reference(
            dout.abs(), w.abs(), hw, s, p, d, out_dtype=torch.float32)
        err = _sum_err(g32, r32, mags)
        if not torch.equal(g16, g32.to(torch.bfloat16)):
            raise RuntimeError(f"K2 bf16 out is not its f32 sum rounded once at {shape}")
        rows.append(_row("dgrad", shape, n,
                         _device_ms(lambda: conv_cuda.conv2d_grad_input(dout, w, hw, s, p, d)),
                         _device_ms(lambda: conv_cuda.conv2d_grad_input_reference(dout, w, hw, s, p, d)),
                         _device_ms(lambda: torch.nn.grad.conv2d_input(
                             x_nchw.shape, w, d_nchw, s, p, d)),
                         # dout and w read, all of dx written
                         flops, (dout.numel() + w.numel() + x.numel()) * 2,
                         err, PEAK_BF16_FLOPS))

        # K3: dW in f32 (the master filter's dtype), against the plain version
        gw = _twice(lambda: conv_cuda.conv2d_grad_filter(
            x, dout, khw, s, p, d, out_dtype=torch.float32))
        rw = conv_cuda.conv2d_grad_filter_reference(x, dout, khw, s, p, d,
                                                    out_dtype=torch.float32)
        mags = conv_cuda.conv2d_grad_filter_reference(
            x.abs(), dout.abs(), khw, s, p, d, out_dtype=torch.float32)
        err = _sum_err(gw, rw, mags)
        nbytes = (conv_cuda.input_bytes(x, w, s, p, d) + dout.numel() * 2
                  + w.numel() * 4)
        rows.append(_row("wgrad", shape, n,
                         _device_ms(lambda: conv_cuda.conv2d_grad_filter(
                             x, dout, khw, s, p, d, out_dtype=torch.float32)),
                         _device_ms(lambda: conv_cuda.conv2d_grad_filter_reference(
                             x, dout, khw, s, p, d, out_dtype=torch.float32)),
                         _device_ms(lambda: torch.nn.grad.conv2d_weight(
                             x_nchw, w.shape, d_nchw, s, p, d)),
                         flops, nbytes, err, PEAK_BF16_FLOPS))

        # K4: y bitwise K1's, the sums against the plain version's
        y, csum, csq = _twice(lambda: conv_cuda.conv2d_stats(x, w, s, p, d))
        if not torch.equal(y, conv_cuda.conv2d(x, w, s, p, d)):
            raise RuntimeError(f"K4 y is not K1's at {shape}")
        ry = conv_cuda.conv2d_reference(x, w, s, p, d)
        r32 = conv_cuda.conv2d_reference(x, w, s, p, d, out_dtype=torch.float32)
        _bf16_err(y, ry, F32_ATOL + F32_RTOL * r32.abs())     # K1's rule
        yf = y.float().reshape(-1, ws[0])
        err = max(_sum_err(csum, yf.sum(0), yf.abs().sum(0)),
                  _sum_err(csq, (yf * yf).sum(0), (yf * yf).sum(0)))
        rows.append(_row("conv_stats", shape, n,
                         _device_ms(lambda: conv_cuda.conv2d_stats(x, w_view, s, p, d)),
                         _device_ms(lambda: conv_cuda.conv2d_stats_reference(x, w, s, p, d)),
                         None, flops + 3 * y.numel(),
                         conv_cuda.conv_bytes(x, w, s, p, d) + 8 * ws[0], err,
                         PEAK_BF16_FLOPS))
        del x, w, dout, g32, g16, r32, mags, gw, rw, y, ry
        print(f"K2/K3/K4 {shape} x{n}/step: " + "; ".join(
            f"{r['kernel']} {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} "
            f"{r['bound_by']}, plain {r['plain_ms']:.4f}, library "
            + (f"{r['library_ms']:.4f})" if r["library_ms"] is not None
               else "none)") for r in rows[-3:]), flush=True)

    for kind, table in (("bn_apply", applies), ("bn_act", acts)):
        for (m, c, act), n in table.items():
            x = randn((m, c), 2.0)
            g = torch.Generator().manual_seed(SEED + m + c)
            scale = (1 + 0.1 * torch.randn(c, generator=g)).cuda()
            bias = (0.1 * torch.randn(c, generator=g)).cuda()
            mean = (0.1 * torch.randn(c, generator=g)).cuda()
            var = (1 + 0.2 * torch.randn(c, generator=g).abs()).cuda()
            x4 = x.reshape(TRAIN_BATCH, -1, c).permute(0, 2, 1).unsqueeze(-1)
            shape = f"[{m}, {c}] act={act}"
            out_bytes = m * c * 2 * (2 if act else 1)
            if kind == "bn_apply":
                ybn, yact = _twice(lambda: bn_cuda.bn_apply(x, scale, bias, mean,
                                                            var, 1e-5, act))
                rbn, _ = bn_cuda.bn_apply_reference(x, scale, bias, mean, var,
                                                    1e-5, act)
                err = _bf16_err(ybn, rbn)
                fn = lambda: bn_cuda.bn_apply(x, scale, bias, mean, var, 1e-5, act)  # noqa: E731
                plain = lambda: bn_cuda.bn_apply_reference(x, scale, bias, mean, var, 1e-5, act)  # noqa: E731
                lib = lambda: F.batch_norm(x4, mean, var, scale, bias, False, 0.0, 1e-5)  # noqa: E731
                nbytes = m * c * 2 + 16 * c + out_bytes
                flops = (4 if act else 3) * m * c
            else:
                ybn, yact, bmean, bvar = _twice(lambda: bn_cuda.bn_act(
                    x, scale, bias, 1e-5, act))
                _, _, rmean, rvar = bn_cuda.bn_act_reference(x, scale, bias, 1e-5, act)
                xf = x.float()
                err = max(_sum_err(bmean, rmean, xf.abs().mean(0)),
                          _sum_err(bvar, rvar, (xf * xf).mean(0)
                                   + 2 * rmean.abs() * xf.abs().mean(0)))
                want, _ = bn_cuda.bn_apply_reference(x, scale, bias, bmean, bvar, 1e-5)
                err = max(err, _bf16_err(ybn, want))
                fn = lambda: bn_cuda.bn_act(x, scale, bias, 1e-5, act)  # noqa: E731
                plain = lambda: bn_cuda.bn_act_reference(x, scale, bias, 1e-5, act)  # noqa: E731
                lib = lambda: F.batch_norm(x4, None, None, scale, bias, True, 0.0, 1e-5)  # noqa: E731
                nbytes = m * c * 2 + 16 * c + out_bytes
                flops = (7 if act else 6) * m * c
            if act == "relu" and not torch.equal(yact, torch.relu(ybn)):
                raise RuntimeError(f"{kind} yact is not relu(ybn) at {shape}")
            rows.append(_row(kind, shape, n, _device_ms(fn), _device_ms(plain),
                             _device_ms(lib), flops, nbytes, err, PEAK_F32_FLOPS))
            print(f"{kind} {shape} x{n}/step: {rows[-1]['ms']:.4f} ms, plain "
                  f"{rows[-1]['plain_ms']:.4f} ms, F.batch_norm "
                  f"{rows[-1]['library_ms']:.4f} ms, bound "
                  f"{rows[-1]['bound_ms']:.4f} ms", flush=True)
            del x, x4, ybn, yact
    torch.cuda.empty_cache()
    report["train_kernel_shapes"] = rows

    kernels = []
    for name, route, source, replaces in (
            ("dgrad", "cuda", "paddle_tpu_torch/csrc/conv2d_fwd.cu",
             "paddle_tpu/ops/pallas_conv.py:445"),
            ("wgrad", "cuda", "paddle_tpu_torch/csrc/conv2d_wgrad.cu",
             "paddle_tpu/ops/pallas_conv.py:282"),
            ("conv_stats", "cuda", "paddle_tpu_torch/csrc/conv2d_fwd.cu",
             "paddle_tpu/ops/pallas_conv.py:241"),
            ("bn_apply", "triton", "paddle_tpu_torch/ops/bn_cuda.py",
             "paddle_tpu/ops/pallas_conv.py:303"),
            ("bn_act", "triton", "paddle_tpu_torch/ops/bn_cuda.py",
             "paddle_tpu/ops/fusion.py:697")):
        rs = [r for r in rows if r["kernel"] == name]

        def total(key):
            vals = [r[key] for r in rs]
            return None if None in vals else sum(v * r["per_step"] for v, r in zip(vals, rs))
        peak = PEAK_F32_FLOPS if route == "triton" else PEAK_BF16_FLOPS
        ops_t = sum(r["flops"] * r["per_step"] for r in rs) / peak
        bytes_t = sum(r["bytes"] * r["per_step"] for r in rs) / PEAK_BYTES
        kernels.append({"name": name, "route": route, "source": source,
                        "replaces": replaces,
                        "max_abs_err": max(r["max_abs_err"] for r in rs),
                        "ms": total("ms"), "plain_ms": total("plain_ms"),
                        "bound_ms": total("bound_ms"),
                        "bound_by": "operations" if ops_t >= bytes_t else "bytes",
                        "library_ms": total("library_ms"),
                        "per": f"one batch-{TRAIN_BATCH} ResNet-50 training step, "
                               f"{len(rs)} distinct shapes"})
        print(f"{name}: {kernels[-1]['ms']:.3f} ms per step over {len(rs)} "
              f"shapes, plain {kernels[-1]['plain_ms']:.3f}, library "
              f"{kernels[-1]['library_ms']}, bound {kernels[-1]['bound_ms']:.3f} "
              f"({kernels[-1]['bound_by']}), max abs err "
              f"{kernels[-1]['max_abs_err']:.3g}", flush=True)
    return kernels


# --- training: the main path ------------------------------------------------------

def _profile_step(exe, main, feed, loss, scope, p50_ms, card, witness,
                  attempts=3):
    """The device's busy share of one training step and its time by
    kernel name (torch.profiler's CUDA activity). A trace without a launch
    of the `witness` kernel, (label, test on the event name), is profiled
    again: the profiler now and then loses a window's CUDA activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
            wall_ms = (time.perf_counter() - t0) * 1e3
        spanned = [e for e in prof.events() if _is_span(e)]
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA and not _is_span(e)]
        if any(witness[1](e.name) for e in events):
            break
        print(f"profile attempt {attempt}: no {witness[0]} launch in the "
              f"trace", flush=True)
    else:
        raise RuntimeError(f"the profiler saw no {witness[0]} launch in a "
                           f"training step")
    busy_us, end = 0.0, float("-inf")
    for e in sorted(events, key=lambda e: e.time_range.start):
        s, t = e.time_range.start, e.time_range.end
        if t > end:
            busy_us += t - max(s, end)
            end = t
    busy_ms = busy_us / 1e3
    kern = {}
    for e in events:
        k = kern.setdefault(e.name[:70], [0.0, 0])
        k[0] += e.time_range.elapsed_us() / 1e3
        k[1] += 1
    print(f"profiled step: device busy {busy_ms:.2f} ms = {busy_ms / p50_ms:.1%} "
          f"of the step p50 {p50_ms:.2f} ms (profiled wall {wall_ms:.1f} ms; "
          f"{card})", flush=True)
    print("device ms by kernel: " + "; ".join(
        f"{k} {v[0]:.2f} x{v[1]}" for k, v in sorted(
            kern.items(), key=lambda kv: -kv[1][0])[:20]), flush=True)
    # host ms inside each span and the device span of its kernels (first
    # start to last end, gaps included); spans nest (a window holds its
    # ladder's ops, a grad op its re-run), so these do not add up to the step
    spans = {}
    for e in spanned:
        v = spans.setdefault(e.name, [0.0, 0.0, 0])
        if e.device_type == DeviceType.CUDA:
            v[1] += e.time_range.elapsed_us() / 1e3
        else:
            v[0] += e.time_range.elapsed_us() / 1e3
            v[2] += 1
    rerun = sum(v[0] for k, v in spans.items() if k.startswith("rerun:"))
    print(f"host ms by span (of the profiled wall {wall_ms:.1f} ms; the generic "
          f"grads' re-run forwards {rerun:.1f} ms): " + "; ".join(
              f"{k} {v[0]:.1f} (device span {v[1]:.1f}) x{v[2]}" for k, v in sorted(
                  spans.items(), key=lambda kv: -kv[1][0])[:24]), flush=True)
    return {"busy_ms": busy_ms, "p50_ms": p50_ms, "busy_share": busy_ms / p50_ms,
            "profiled_wall_ms": wall_ms, "by_kernel": kern,
            "rerun_forward_host_ms": rerun, "by_span": spans}


def _step(pt, main, loss, params, state, feed, place):
    """One training step from `state` (name -> tensor): the loss and each
    parameter's grad, as numpy."""
    dev = "cuda" if isinstance(place, pt.CUDAPlace) else "cpu"
    scope = pt.Scope()
    for n, v in state.items():
        scope.set_var(n, v.to(dev))
    out = pt.Executor(place).run(main, feed=feed, fetch_list=[loss] + [
        p + "@GRAD" for p in params], scope=scope)
    return float(out[0][0]), out[1:]


def _hold_outputs(kind, members, env, env_c, tally):
    """Hold every float output of one op or window on the card (`env`) to
    the CPU plain path's on the same inputs (`env_c`): relative L2 within
    LOCKSTEP_BF16 (bf16 outputs) or LOCKSTEP_F32, else raise. Adds to
    `tally` the worst difference by kind and the outputs compared and
    bitwise equal; returns whether all of them were."""
    import torch
    equal = True
    for n in {n for m in members for n in m.output_arg_names}:
        a, b = env.get(n), env_c.get(n)
        if not isinstance(a, torch.Tensor) or not a.is_floating_point():
            continue
        a32, b32 = a.float().cpu(), b.float()
        r = ((a32 - b32).norm() / (b32.norm() + 1e-30)).item()
        tol = LOCKSTEP_BF16 if a.dtype == torch.bfloat16 else LOCKSTEP_F32
        if not (r <= tol):
            raise RuntimeError(f"lockstep: {kind} output {n} on the card is "
                               f"{r:.3g} (relative L2) from the CPU plain "
                               f"path on the same inputs (tol {tol})")
        same = torch.equal(a.cpu(), b)
        equal &= same
        tally["outputs"] += 1
        tally["bitwise"] += int(same)
        tally["worst"][kind] = max(tally["worst"].get(kind, 0.0), r)
    return equal


def _lockstep(pt, main, loss, state, feed):
    """One step of `main` on the card with every op and window run again,
    on a CPU copy of the card's inputs to it, on the CPU plain path; each
    float output held to the card's (_hold_outputs). Returns the worst
    relative L2 difference by op type."""
    import torch
    from paddle_tpu_torch.executor import LoweringContext
    from paddle_tpu_torch.ops import fusion
    card, cpu = pt.Executor(pt.CUDAPlace(0)), pt.Executor(pt.CPUPlace())
    env = {n: v.cuda() for n, v in state.items()}
    env.update({n: torch.as_tensor(v).cuda() for n, v in feed.items()})
    ctx_g, ctx_c = LoweringContext(card, main, 0), LoweringContext(cpu, main, 0)
    protected = {loss.name} | set(card._persistable_outputs(main))
    ops, groups = main.global_block().ops, card._plan(main) or {}
    tally, i = {"worst": {}, "outputs": 0, "bitwise": 0}, 0
    while i < len(ops):
        g = groups.get(i)
        members = g.members if g is not None else (ops[i],)
        env_c = {n: env[n].cpu() for m in members for n in m.input_arg_names
                 if isinstance(env.get(n), torch.Tensor)}
        if g is not None:
            fusion.execute_group(card, ctx_g, g, env, protected)
            fusion.execute_group(cpu, ctx_c, g, env_c, protected)
            i, kind = g.end, "+".join(m.type for m in members)
        else:
            card._exec_op(ctx_g, ops[i], env)
            cpu._exec_op(ctx_c, ops[i], env_c)
            i, kind = i + 1, ops[i].type
        _hold_outputs(kind, members, env, env_c, tally)
    return tally["worst"]


def _rl2(a, b):
    import numpy as np
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _grad_agreement(run_a, run_b, params, skip=()):
    """Two runs of one step, (loss, grads): the loss's relative difference,
    and per parameter (those in `skip` left out) the grads' relative L2
    difference and norm ratio, with their median and extremes."""
    import numpy as np
    (la, ga), (lb, gb) = run_a, run_b
    pairs = [(p, x, y) for p, x, y in zip(params, ga, gb) if p not in skip]
    rl2 = {p: _rl2(x, y) for p, x, y in pairs}
    ratio = {p: float(np.linalg.norm(x) / (np.linalg.norm(y) + 1e-30))
             for p, x, y in pairs}
    return {"loss_rel_diff": abs(la - lb) / abs(lb),
            "grad_rl2_median": float(np.median(list(rl2.values()))),
            "grad_rl2_max": max(rl2.values()),
            "grad_rl2_worst": max(rl2, key=rl2.get),
            "norm_ratio_min": min(ratio.values()),
            "norm_ratio_median": float(np.median(list(ratio.values()))),
            "norm_ratio_max": max(ratio.values()),
            "grad_rl2": rl2, "norm_ratio": ratio}


def phase_train(pt, conv_cuda, bn_cuda, resnet, report):
    import numpy as np
    import torch

    main, startup, loss = _resnet50_train(pt, resnet)
    scope = pt.Scope()
    exe = pt.Executor()                        # CUDAPlace(0) by default
    exe.run(startup, scope=scope)
    init = {n: v.clone() for n, v in scope.vars.items()
            if isinstance(v, torch.Tensor)}
    rng = np.random.default_rng(SEED + 4)
    feed = {"img": rng.standard_normal((TRAIN_BATCH, 3, 224, 224)).astype(np.float32),
            "label": rng.integers(0, 1000, (TRAIN_BATCH, 1)).astype(np.int64)}
    card = _card_line()

    t0 = time.perf_counter()
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0][0])]
    print(f"warm-up step (Triton compiles K5/K6): {time.perf_counter() - t0:.2f} s, "
          f"loss {losses[0]:.5f}", flush=True)
    conv_cuda.COUNTERS.reset()
    bn_cuda.COUNTERS.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()               # the fetch ends in a device->host copy
        losses.append(float(exe.run(main, feed=feed, fetch_list=[loss],
                                    scope=scope)[0][0]))
        times.append(time.perf_counter() - t0)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {k: getattr(c, k) for c, keys in (
        (conv_cuda.COUNTERS, ("dgrad_launches", "wgrad_launches", "stats_launches",
                              "launches")),
        (bn_cuda.COUNTERS, ("apply_launches", "act_launches"))) for k in keys}
    conv_fb = dict(conv_cuda.COUNTERS.fallbacks)
    bn_fb = dict(bn_cuda.COUNTERS.fallbacks)
    copies = conv_cuda.COUNTERS.layout_copies
    filter_copies = conv_cuda.COUNTERS.filter_copies

    p50 = float(np.median(times)) * 1e3
    print(f"ResNet-50 O2 training, batch {TRAIN_BATCH}: step p50 {p50:.1f} ms "
          f"(steps {', '.join(f'{t * 1e3:.1f}' for t in times)}), "
          f"{TRAIN_BATCH / (p50 / 1e3):.1f} img/s; peak memory {peak_gb:.2f} GB "
          f"({card})", flush=True)
    print(f"losses: {', '.join(f'{v:.5f}' for v in losses)}", flush=True)
    per_step = {k: v / TRAIN_STEPS for k, v in launches.items()}
    print(f"launches per step: {per_step}; fallbacks per step: conv "
          f"{ {k: v / TRAIN_STEPS for k, v in conv_fb.items()} }, bn "
          f"{ {k: v / TRAIN_STEPS for k, v in bn_fb.items()} }; cotangents "
          f"copied to channels_last per step: {copies / TRAIN_STEPS}; filters "
          f"copied per step: {filter_copies / TRAIN_STEPS} (K2's channel-"
          f"swapped filter, one per call)", flush=True)
    if filter_copies != launches["dgrad_launches"]:
        raise RuntimeError(f"{filter_copies} filter copies in {TRAIN_STEPS} "
                           f"steps, expected one per K2 launch: the casts "
                           f"write OHWI memory, which K1 and K4 read in place")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"the training loss is not finite and falling: {losses}")
    want = {k: v * TRAIN_STEPS for k, v in TRAIN_LAUNCHES.items()}
    want["launches"] = 0                       # every eligible conv goes to K4
    if any(launches[k] != want[k] for k in want):
        raise RuntimeError(f"kernel launches {launches}, expected {want}")
    if conv_fb != {k: v * TRAIN_STEPS for k, v in TRAIN_FALLBACKS.items()} or bn_fb:
        raise RuntimeError(f"unexpected fallbacks: conv {conv_fb}, bn {bn_fb}")

    profile = _profile_step(exe, main, feed, loss, scope, p50, card, (
        "K4", lambda name: K1_KERNEL in name and "true" in name))

    # batch 4 from the startup weights: op by op, then end to end, card vs
    # the CPU plain path, in O2 and in f32
    small = {"img": feed["img"][:SMALL_BATCH], "label": feed["label"][:SMALL_BATCH]}
    t0 = time.perf_counter()
    worst = _lockstep(pt, main, loss, init, small)
    top = sorted(worst.items(), key=lambda kv: -kv[1])
    print(f"lockstep, batch {SMALL_BATCH}: {len(worst)} op and window kinds, "
          f"each output on the card against the CPU plain path on the card's "
          f"inputs ({time.perf_counter() - t0:.1f} s); worst relative L2: "
          + ", ".join(f"{k} {v:.3g}" for k, v in top[:6])
          + f" (tol {LOCKSTEP_BF16} bf16, {LOCKSTEP_F32} f32)", flush=True)
    params = sorted(p.name for p in main.global_block().all_parameters()
                    if p.trainable)
    main32, _, loss32 = _resnet50_train(pt, resnet, amp=False)
    runs = {}
    for key, prog, lss, place in (
            ("o2_card", main, loss, pt.CUDAPlace(0)),
            ("o2_cpu", main, loss, pt.CPUPlace()),
            ("f32_card", main32, loss32, pt.CUDAPlace(0)),
            ("f32_cpu", main32, loss32, pt.CPUPlace())):
        t0 = time.perf_counter()
        runs[key] = _step(pt, prog, lss, params, init, small, place)
        print(f"{key}: one batch-{SMALL_BATCH} step, loss {runs[key][0]:.6f}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    agree = {}
    for what, a, b in (("o2", "o2_card", "o2_cpu"), ("f32", "f32_card", "f32_cpu"),
                       ("o2_cpu_vs_f32", "o2_cpu", "f32_cpu")):
        r = agree[what] = _grad_agreement(runs[a], runs[b], params)
        r["fc_grad_rl2"] = max(v for k, v in r["grad_rl2"].items()
                               if k.startswith("fc_"))
        print(f"{what} ({a} vs {b}): loss {r['loss_rel_diff']:.3g} relative; "
              f"grad relative L2 median {r['grad_rl2_median']:.3g}, max "
              f"{r['grad_rl2_max']:.3g}, fc {r['fc_grad_rl2']:.3g}; grad norm "
              f"ratio min {r['norm_ratio_min']:.3g}, median "
              f"{r['norm_ratio_median']:.3g}, max {r['norm_ratio_max']:.3g} "
              f"({card})", flush=True)
        if not all(np.isfinite(x).all() for x in runs[a][1]):
            raise RuntimeError(f"{a}: non-finite grads")
    o2, f32, floor = agree["o2"], agree["f32"], agree["o2_cpu_vs_f32"]
    failed = []
    if o2["loss_rel_diff"] > O2_LOSS_RTOL or f32["loss_rel_diff"] > F32_LOSS_RTOL:
        failed.append("loss")
    if o2["fc_grad_rl2"] > LAST_GRAD_RL2 or f32["fc_grad_rl2"] > LAST_GRAD_RL2:
        failed.append("fc grads")
    if o2["grad_rl2_median"] > floor["grad_rl2_median"] or \
            f32["grad_rl2_median"] > F32_GRAD_RL2:
        failed.append("grads past the noise floor")
    for what in ("o2", "f32"):
        r = agree[what]
        if not (1 / NORM_RATIO <= r["norm_ratio_min"]
                and r["norm_ratio_max"] <= NORM_RATIO
                and abs(r["norm_ratio_median"] - 1) <= NORM_RATIO_MEDIAN):
            failed.append(f"{what} grad norms")
    if failed:
        raise RuntimeError(f"the batch-{SMALL_BATCH} step on the card disagrees "
                           f"with the CPU plain path: {failed}")
    report["train"] = {"card": card, "batch": TRAIN_BATCH, "lr": TRAIN_LR,
                       "step_ms": [t * 1e3 for t in times], "p50_ms": p50,
                       "img_per_s": TRAIN_BATCH / (p50 / 1e3), "losses": losses,
                       "peak_memory_gb": peak_gb, "launches_per_step": per_step,
                       "fallbacks": {f"{k[0]}:{k[1]}": v for k, v in conv_fb.items()},
                       "layout_copies_per_step": copies / TRAIN_STEPS,
                       "filter_copies_per_step": filter_copies / TRAIN_STEPS,
                       "profile": profile, "lockstep_worst_rl2": worst,
                       "small_batch": agree}
    return per_step


# --- the transformer LM: the kernels K7-K9 -------------------------------------

def _attention_pairs(tq, tk, causal) -> int:
    """(query, key) pairs a call at offsets 0 scores that the mask keeps."""
    return sum(min(i + 1, tk) for i in range(tq)) if causal else tq * tk


def attention_flops(kernel: str, b, tq, tk, h, d, causal) -> int:
    """Tensor-core FLOPs a K7 ("fwd"), K10 ("block"), K8 ("dq") or K9
    ("dkv") call at offsets 0 needs: 2*D per scored pair for each of the
    kernel's products (K7, K10: S, P V; K8: S, dP, dS K; K9: S, dP, P^T dO,
    dS^T Q)."""
    products = {"fwd": 2, "block": 2, "dq": 3, "dkv": 4}[kernel]
    return products * 2 * d * b * h * _attention_pairs(tq, tk, causal)


def attention_bytes(kernel: str, b, tq, tk, h, d, elem=2) -> int:
    """Each input read once, each output written once: operands and
    outputs of `elem` bytes (2 bf16, 4 f32), f32 lse/delta, and K10's
    ("block") f32 acc, m and l."""
    q, kv, stat = b * tq * h * d * elem, b * tk * h * d * elem, b * h * tq * 4
    if kernel == "fwd":
        return q + 2 * kv + q + stat
    if kernel == "block":
        return q + 2 * kv + b * tq * h * d * 4 + 2 * stat
    if kernel == "dq":
        return 2 * q + 2 * kv + 2 * stat + q
    return 2 * q + 2 * kv + 2 * stat + 2 * kv


def attention_tolerance(kernel, q, k, v, causal, dout=None, lse=None,
                        delta=None, flips=None, q_off=0, k_off=0, scale=None,
                        rel=1e-5, rows=None):
    """The per-element bound on |kernel - plain version| for each output of
    K7 ("fwd": o), K8 ("dq": dq), K9 ("dkv": dk, dv) or K10 ("block": acc),
    operands [B, T, H, D], global offsets (q_off, k_off) for the causal
    mask. Each output element is a sum of products a*b (K7: P/l * V; K10:
    exp(S - m) * V; K8: scale * dS * K; K9: P^T * dO and scale * dS^T * Q)
    that both sides form from the same values but in another order. So:
    one ulp of the rounded output (bf16 operands: bf16; f32 operands, and
    K10's acc: f32), `rel` of the sum of the terms' magnitudes (f32 sums in
    another order: 1e-5; the f32 forms' 3xTF32 products keep about 21 bits,
    well inside it; for f32 operands dS, which is not rounded, counts with
    the magnitude of the terms of dP and delta that form it), and `flips`
    bf16 roundings of P or dS landing on the
    other side (2^-8 of the largest term each; the f32 values they round
    differ in the last bits): 4 for bf16 operands by default, 0 for f32,
    whose P and dS are not rounded. `lse` (K7: none needed; K10: the row
    max m) and `delta` [B, H, Tq] as the kernels take them. `rows` walks
    the query rows in chunks of that many, so that a long sequence's [Tq,
    Tk] scores never exist whole (K7 and K10 only: their bounds are row by
    row). Also used by tests/test_torch_attention*.py."""
    import torch
    f32 = q.dtype == torch.float32
    if flips is None:
        flips = 0 if f32 else 4
    if rows is not None and kernel in ("fwd", "block") and q.shape[1] > rows:
        parts = [attention_tolerance(
            kernel, q[:, r:r + rows], k, v, causal,
            lse=None if lse is None else lse[..., r:r + rows], flips=flips,
            q_off=q_off + r, k_off=k_off, scale=scale, rel=rel)[0]
            for r in range(0, q.shape[1], rows)]
        return [torch.cat(parts, dim=1)]
    qf, kf, vf = (x.float().permute(0, 2, 1, 3) for x in (q, k, v))
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if causal:
        qpos = q_off + torch.arange(q.shape[1], device=s.device)
        kpos = k_off + torch.arange(k.shape[1], device=s.device)
        keep = qpos[:, None] >= kpos[None, :]
        s = torch.where(keep, s, torch.full_like(s, -1e30))
    if lse is None:
        lse = torch.logsumexp(s, -1)
    p = torch.exp(s - lse.float()[..., None])
    del s
    pairs = []
    if kernel in ("fwd", "block"):
        pairs.append((p, vf, 1.0))
    else:
        dof = dout.float().permute(0, 2, 1, 3)
        if f32:
            # unrounded, dS = P (dP - delta) carries dP's own error: its
            # magnitude is that of dP's terms (a row's dP and delta may
            # cancel, as row 0's do under the causal mask)
            ds = p * (torch.matmul(dof.abs(), vf.abs().transpose(-1, -2))
                      + delta.float().abs()[..., None])
        else:
            ds = (p * (torch.matmul(dof, vf.transpose(-1, -2))
                       - delta.float()[..., None])).abs()
        if kernel == "dq":
            pairs.append((ds, kf, scale))
        else:
            pairs += [(ds.transpose(-1, -2), qf, scale),
                      (p.transpose(-1, -2), dof, 1.0)]
    mant = 23 if kernel == "block" or f32 else 7
    out = []
    for a, b, sc in pairs:
        b = b.abs()
        total = torch.matmul(a, b) * sc
        largest = a.amax(-1, keepdim=True) * b.amax(-2, keepdim=True) * sc
        ulp = torch.exp2(torch.floor(torch.log2(total.clamp_min(1e-30)))
                         - mant)
        bound = ulp + rel * total + flips * 2.0 ** -8 * largest + 1e-6
        out.append(bound.permute(0, 2, 1, 3))
    return out


def _bounded(got, want, bound, what):
    """Max abs error of a kernel output; raise where past `bound`."""
    err = (got.float() - want.float()).abs()
    if not (err <= bound).all():
        raise RuntimeError(f"{what}: max abs err {err.max().item():.4g}, "
                           f"past its bound by {(err - bound).max().item():.4g}")
    return err.max().item()


def _lse_err(got, want, what):
    err = (got - want).abs()
    if not (err <= LSE_RTOL * want.abs().clamp_min(1.0)).all():
        raise RuntimeError(f"{what}: LSE max abs err {err.max().item():.4g}")
    return err.max().item()


def hold_block(got, want, q, k, v, q_off, k_off, scale, causal, what,
               rows=None):
    """Hold K10's (acc, l, m) to its plain version's on the same operands:
    a row the plain version leaves invalid (m = -1e30, no visited key tile
    or every visited key masked) has exactly m = -1e30 on the card too, and
    exactly (acc, l) = (0, 0) where the plain version has them; a valid
    row's m within LSE_RTOL of max(1, |m|), its m + log(l) within LSE_RTOL
    of max(1, |m + log l|), its acc within attention_tolerance("block").
    Returns acc's max abs error over the valid rows."""
    import torch
    (acc, l, m), (racc, rl, rm) = got, want
    invalid = rm <= -5e29
    if not torch.equal(m[invalid], rm[invalid]):
        raise RuntimeError(f"{what}: m of an invalid row is not -1e30")
    empty = invalid & (rl == 0)
    if not (torch.equal(l[empty], rl[empty]) and
            (acc.transpose(1, 2)[empty] == 0).all()):
        raise RuntimeError(f"{what}: a row no key tile reaches is not (0, 0)")
    if invalid.all():
        return 0.0
    valid = ~invalid
    _lse_err(m[valid], rm[valid], f"{what} m")
    _lse_err((m + torch.log(l))[valid], (rm + torch.log(rl))[valid],
             f"{what} m + log(l)")
    bound, = attention_tolerance("block", q, k, v, causal, lse=rm,
                                 q_off=q_off, k_off=k_off, scale=scale,
                                 rows=rows)
    keep = valid.transpose(1, 2)[..., None]
    return _bounded(torch.where(keep, acc, racc), racc, bound,
                    f"{what} acc")


def attention_wrapper_host_us(attention_cuda, reps=200):
    """Host microseconds per call of each attention wrapper (K7, K10, K8,
    K9: shape checks, four to six tensor-map encodes, the launch) at [1,
    128, 2, 64] bf16 causal, whose kernels are shorter than the call so the
    host sets the pace: {kernel: median over 5 rounds of `reps` queued
    calls}, the four in turns."""
    import torch
    A = attention_cuda
    gen = torch.Generator().manual_seed(SEED + 9)
    q, k, v, do = (torch.randn((1, 128, 2, 64), generator=gen)
                   .to(torch.bfloat16).cuda() for _ in range(4))
    o, lse = A.flash_forward(q, k, v, True)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta, 0, 0, 0.125, True)
    calls = {"fwd": lambda: A.flash_forward(q, k, v, True),
             "block": lambda: A.flash_attention_block(q, k, v, 0, 0, 0.125,
                                                      True),
             "dq": lambda: A.flash_dq(*args),
             "dkv": lambda: A.flash_dkv(*args)}
    times = {name: [] for name in calls}
    for _ in range(5):
        for name, fn in calls.items():
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            times[name].append((time.perf_counter() - t0) / reps * 1e6)
            torch.cuda.synchronize()
    return {k: sorted(v)[len(v) // 2] for k, v in times.items()}


# The f32 forms' products are three TF32 passes (3xTF32): their bound is
# the TF32 rate over the passes.
PEAK_3XTF32_FLOPS = 495e12 / 3
# T of the flash/einsum crossover (D 64, 8 heads, B*T = 16384 tokens, bf16
# causal, forward + backward), measured and recorded only (FLASH_AUTO_T
# stays the reference's 2048)
CROSSOVER_T = (512, 1024, 2048, 4096, 8192)
ATTN_SOURCES = {
    "fwd": ("flash_attn_fwd", "paddle_tpu_torch/csrc/flash_attn_fwd.cu",
            "paddle_tpu/ops/pallas_attention.py:143"),
    "dq": ("flash_attn_bwd_dq", "paddle_tpu_torch/csrc/flash_attn_bwd.cu",
           "paddle_tpu/ops/pallas_attention.py:295"),
    "dkv": ("flash_attn_bwd_dkv", "paddle_tpu_torch/csrc/flash_attn_bwd.cu",
            "paddle_tpu/ops/pallas_attention.py:342"),
    "block": ("flash_attn_fwd_block", "paddle_tpu_torch/csrc/flash_attn_fwd.cu",
              "paddle_tpu/ops/pallas_attention.py:143"),
}
# the f32 forms' sources: the tf32 wgmma forward (K7) and backward (K8,
# K9), the forward walk (K10)
F32_SOURCES = {"fwd": "paddle_tpu_torch/csrc/flash_attn_fwd_tf32.cu",
               "block": "paddle_tpu_torch/csrc/flash_attn_walk.cu",
               "dq": "paddle_tpu_torch/csrc/flash_attn_bwd_tf32.cu",
               "dkv": "paddle_tpu_torch/csrc/flash_attn_bwd_tf32.cu"}


def _attn_kernel_entry(kern, dtype, row, per, what, library):
    """A `kernels` entry of the result line for kernel `kern` ("fwd",
    "dq", "dkv", "block") in `dtype` from its timed row (per call), the
    path unit `per` calls long."""
    name, source, replaces = ATTN_SOURCES[kern]
    f32 = dtype == "float32"
    entry = {
        "name": name + ("_f32" if f32 else ""), "route": "cuda",
        "source": F32_SOURCES[kern] if f32 else source,
        "replaces": replaces,
        "max_abs_err": row["max_abs_err"], "ms": row["ms"] * per,
        "plain_ms": row["plain_ms"] * per,
        "bound_ms": row["bound_ms"] * per, "bound_by": row["bound_by"],
        "library_ms": None if row["library_ms"] is None
        else row["library_ms"] * per,
        "library": library, "per": what}
    if row.get("parent_ms") is not None:
        entry["parent_ms"] = row["parent_ms"] * per
    return entry


def _hold_attn(A, q, k, v, do, causal, at, worst):
    """K7, then K8 and K9, on one shape: each twice and bitwise repeatable,
    within attention_tolerance of its plain version (LSE by LSE_RTOL).
    Returns the backward's arguments."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    o, lse = _twice(lambda: A.flash_forward(q, k, v, causal))
    ro, rlse = A.flash_forward_reference(q, k, v, causal)
    bo, = attention_tolerance("fwd", q, k, v, causal)
    e_o = _bounded(o, ro, bo, f"K7 o at {at}")
    e_lse = _lse_err(lse, rlse, f"K7 at {at}")
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta, 0, 0, scale, causal)
    dq = _twice(lambda: A.flash_dq(*args))
    dk, dv = _twice(lambda: A.flash_dkv(*args))
    bq, = attention_tolerance("dq", q, k, v, causal, do, lse, delta)
    bk, bv = attention_tolerance("dkv", q, k, v, causal, do, lse, delta)
    e_q = _bounded(dq, A.flash_dq_reference(*args), bq, f"K8 dq at {at}")
    rk, rv = A.flash_dkv_reference(*args)
    e_k = _bounded(dk, rk, bk, f"K9 dk at {at}")
    e_v = _bounded(dv, rv, bv, f"K9 dv at {at}")
    worst["fwd"] = max(worst["fwd"], e_o)
    worst["dq"] = max(worst["dq"], e_q)
    worst["dkv"] = max(worst["dkv"], e_k, e_v)
    print(f"K7/K8/K9 at {at}: max abs err o {e_o:.3g} (lse {e_lse:.3g}), "
          f"dq {e_q:.3g}, dk {e_k:.3g}, dv {e_v:.3g}; each bitwise "
          f"repeatable", flush=True)
    return args


def _sdpa_backend(q, k, v):
    """The backend F.scaled_dot_product_attention picks for causal q, k, v
    [B, H, T, D] (torch._fused_sdp_choice), by name: in f32 the
    memory-efficient kernel, whose GEMMs run as 3xTF32 (CUTLASS's
    OpMultiplyAddFastF32), the f32 forms' arithmetic."""
    import torch
    from torch.nn.attention import SDPBackend
    try:
        choice = torch._fused_sdp_choice(q, k, v, is_causal=True)
    except (AttributeError, RuntimeError) as e:  # a yardstick's label only
        return f"unknown ({type(e).__name__}: {str(e)[:80]})"
    return SDPBackend(choice).name


def _time_attn(A, q, k, v, do, args, dtype, worst):
    """K7, K8 and K9 timed at one causal shape (CUDA graph of calls between
    CUDA events): the kernel, the plain version and SDPA (forward for K7,
    its backward for K8 + K9 together). Returns a row per kernel, per
    call."""
    import torch
    import torch.nn.functional as F
    b, t, h, d = q.shape
    f32 = dtype == "float32"
    reps = 5 if f32 else 20
    qv, kv, vv, dov = (x.transpose(1, 2) for x in (q, k, v, do))  # [B,H,T,D]
    leaves = [x.detach().requires_grad_(True) for x in (qv, kv, vv)]
    lib_fwd = _library_ms(lambda: F.scaled_dot_product_attention(
        qv, kv, vv, is_causal=True), reps)
    lib_both = _library_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(*leaves, is_causal=True), leaves, dov),
        reps)
    lib_bwd = None if lib_fwd is None or lib_both is None \
        else lib_both - lib_fwd
    backend = _sdpa_backend(qv, kv, vv)
    calls = {"fwd": (lambda: A.flash_forward(q, k, v, True),
                     lambda: A.flash_forward_reference(q, k, v, True),
                     lib_fwd),
             "dq": (lambda: A.flash_dq(*args),
                    lambda: A.flash_dq_reference(*args), lib_bwd),
             "dkv": (lambda: A.flash_dkv(*args),
                     lambda: A.flash_dkv_reference(*args), lib_bwd)}
    peak = PEAK_3XTF32_FLOPS if f32 else PEAK_BF16_FLOPS
    rows = {}
    for kern, (fn, plain, lib_ms) in calls.items():
        ms = _device_ms(fn, reps=reps)
        plain_ms = _device_ms(plain, reps=2 if f32 else 5)
        flops = attention_flops(kern, b, t, t, h, d, True)
        nbytes = attention_bytes(kern, b, t, t, h, d, 4 if f32 else 2)
        row = _row(ATTN_SOURCES[kern][0], f"{list(q.shape)} causal {dtype}",
                   1, ms, plain_ms, lib_ms, flops, nbytes, worst[kern], peak)
        row["library_backend"] = backend
        rows[kern] = row
        lib = "forward" if kern == "fwd" else "backward (dQ, dK, dV)"
        print(f"{row['kernel']} {dtype} at {list(q.shape)} causal: {ms:.4f} ms "
              f"per call ({flops / ms / 1e9:.1f} TFLOP/s), plain "
              f"{plain_ms:.4f}, SDPA {lib} {lib_ms} (backend {backend}), bound "
              f"{row['bound_ms']:.4f} ({row['bound_by']}; "
              f"{flops / 1e9:.1f} GFLOP)", flush=True)
    return rows


def _crossover(A):
    """Forward + backward of the flash path (K7, K8 + K9 through
    flash_attention) and of the einsum path (attention_reference under
    autograd) at D 64, 8 heads, B*T = 16384 tokens, bf16 causal, T in
    CROSSOVER_T: {T: (flash ms, einsum ms)}."""
    import torch
    out = {}
    for t in CROSSOVER_T:
        shape = (16384 // t, t, 8, 64)
        gen = torch.Generator().manual_seed(SEED + t)
        q, k, v, do = (torch.randn(shape, generator=gen).to(torch.bfloat16)
                       .cuda() for _ in range(4))
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        flash = _device_ms(lambda: torch.autograd.grad(
            A.flash_attention(*leaves, causal=True), leaves, do), reps=5)
        einsum = _device_ms(lambda: torch.autograd.grad(
            A.attention_reference(*leaves, causal=True), leaves, do), reps=5)
        out[t] = (flash, einsum)
        print(f"crossover at {list(shape)} bf16 causal, forward + backward: "
              f"flash {flash:.4f} ms, einsum {einsum:.4f} ms (einsum / "
              f"flash {einsum / flash:.2f})", flush=True)
        del q, k, v, do, leaves
        torch.cuda.empty_cache()
    return out


def f32_fwd_entry(lib, name, A):
    """A loaded library's f32 K7 entry `name` (flash_tf32_fwd's arguments)
    as a function of causal f32 (q, k, v) -> (o, lse)."""
    import ctypes

    import torch
    fn = getattr(lib, name)
    fn.argtypes, fn.restype = A._argtypes(5), ctypes.c_int

    def run(q, k, v):
        b, t, h, d = q.shape
        o = torch.empty_like(q)
        lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), b, h, t, k.shape[1], d, 0, 0,
                1.0 / math.sqrt(d), 1, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{name} failed: CUDA {rc}")
        return o, lse
    return run


def parent_walk_fwd(parent, A):
    """The older checkout's f32 K7, the tile walk's `flash_walk_fwd` in
    `csrc/flash_attn_walk.cu`, built from its sources."""
    return f32_fwd_entry(build_parent(parent, "flash_attn_walk.cu",
                                      "parent_flash_attn_walk"),
                         "flash_walk_fwd", A)


def _time_f32_fwd_parent(A, parent, timed, worst):
    """K7 f32 against the older checkout's walk, in turns (new, walk, walk,
    new, a CUDA graph of calls each), at the f32 steps' shape (`timed`'s
    q, k, v) and at [1, 2048, 4, 128] causal, each output held to the plain
    version by the f32 rule. Returns {shape: {"ms": .., "parent_ms": ..}}."""
    import torch
    walk = parent_walk_fwd(parent, A)
    gen = torch.Generator().manual_seed(SEED + 9)
    d128 = tuple(torch.randn((1, 2048, 4, 128), generator=gen).cuda()
                 for _ in range(3))
    out = {}
    for q, k, v in (timed[:3], d128):
        ro, _ = A.flash_forward_reference(q, k, v, True)
        bound, = attention_tolerance("fwd", q, k, v, True, rows=TOL_ROWS)
        o, _ = A.flash_forward(q, k, v, True)
        worst["fwd"] = max(worst["fwd"], _bounded(
            o, ro, bound, f"K7 f32 at {list(q.shape)}"))
        _bounded(walk(q, k, v)[0], ro, bound,
                 f"the parent's walk at {list(q.shape)}")
        new = [_device_ms(lambda: A.flash_forward(q, k, v, True), reps=5)]
        old = [_device_ms(lambda: walk(q, k, v), reps=5) for _ in range(2)]
        new.append(_device_ms(lambda: A.flash_forward(q, k, v, True), reps=5))
        ms, parent_ms = sum(new) / 2, sum(old) / 2
        out[str(list(q.shape))] = {"ms": ms, "parent_ms": parent_ms,
                                   "turns": new[:1] + old + new[1:]}
        print(f"K7 f32 at {list(q.shape)} causal: {ms:.4f} ms per call, the "
              f"parent tree's walk {parent_ms:.4f} ({parent_ms / ms:.2f}x; in "
              f"turns new, walk, walk, new: "
              + ", ".join(f"{t:.4f}" for t in out[str(list(q.shape))]["turns"])
              + ")", flush=True)
    return out


def phase_kernel_attn(attention_cuda, report, parent=None):
    """K7-K9 in bf16 (the Hopper kernels) and in f32 (their f32 forms)
    against their plain versions at the JAX tests' shapes, T = 72 at D 64
    and 128, and the bench shape (f32 also at its steps' shape F32_ATTN),
    each run twice and bitwise repeatable; then timed at the path shape of
    each form (bf16 the bench shape, f32 F32_ATTN) beside the bound, the
    plain versions and F.scaled_dot_product_attention (forward for K7, its
    backward for K8 + K9 together); the wrappers' host time per call; the
    flash/einsum crossover."""
    import torch
    A = attention_cuda
    gen = torch.Generator().manual_seed(SEED + 5)
    per = LM["n_layer"]
    kernels, table = [], {}
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)

        def randn(shape):
            return torch.randn(shape, generator=gen).to(dt).cuda()

        path = F32_ATTN if dtype == "float32" else ATTN_BENCH
        b, t = path[:2]
        worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
        timed = None
        shapes = ATTN_SHAPES + ([(path, True)] if path != ATTN_BENCH else [])
        for shape, causal in shapes:
            q, k, v, do = (randn(shape) for _ in range(4))
            args = _hold_attn(A, q, k, v, do, causal,
                              f"{list(shape)} causal={causal} {dtype}", worst)
            if shape == path and causal:
                timed = (q, k, v, do, args)
            torch.cuda.empty_cache()
        rows = _time_attn(A, *timed, dtype, worst)
        if dtype == "float32" and parent is not None:
            vs_walk = _time_f32_fwd_parent(A, parent, timed, worst)
            rows["fwd"]["parent_ms"] = vs_walk[str(list(path))]["parent_ms"]
            table["f32_vs_parent_walk"] = vs_walk
        del timed
        torch.cuda.empty_cache()
        table[dtype] = {"rows": list(rows.values()), "max_abs_err": worst}
        for kern, row in rows.items():
            library = "F.scaled_dot_product_attention" + (
                "" if kern == "fwd" else " backward, dQ + dK + dV (K8 and K9 "
                "together)") + (" in f32" if dtype == "float32" else "") + \
                f" (backend {row['library_backend']})"
            what = f"the {per} calls of one batch-{b} T-{t} transformer_lm " \
                f"training step, {list(path)} causal {dtype}"
            if dtype == "float32":
                what += (" (the T-2048 ring step in f32 makes the same calls "
                         "at the same shape)" if kern != "fwd" else "")
            kernels.append(_attn_kernel_entry(kern, dtype, row, per, what,
                                              library))
    host = attention_wrapper_host_us(A)
    print("attention wrappers' host time per call (us, median of 5 rounds, "
          "[1, 128, 2, 64] bf16 causal): " + ", ".join(
              f"{k} {v:.1f}" for k, v in host.items()), flush=True)
    cross = _crossover(A)
    report["attn_kernel"] = {"bench": table, "wrapper_host_us": host,
                             "crossover_ms": cross}
    return kernels


def _library_ms(fn, reps):
    """_device_ms of a PyTorch yardstick call, or None, said why, where
    PyTorch refuses the call (a backend that takes no such inputs, or no
    graph capture): it is a yardstick, never part of a path."""
    try:
        return _device_ms(fn, reps=reps)
    except RuntimeError as e:
        print(f"yardstick not timed: {str(e).splitlines()[0][:200]}",
              flush=True)
        return None


def _sdpa_with_lse(q, k, v):
    """PyTorch's own causal flash attention forward with its logsumexp, one
    call (the yardstick of K10, which has no one-call counterpart: no
    PyTorch call returns the unnormalized (acc, m, l)). q, k, v [B, H, T,
    D]."""
    import torch
    return torch.ops.aten._scaled_dot_product_flash_attention(
        q, k, v, 0.0, True)[:2]


def _efficient_with_lse(q, k, v):
    """PyTorch's causal memory-efficient attention forward with its
    logsumexp, one call: K10's f32 yardstick (the flash one takes no f32).
    q, k, v [B, H, T, D]."""
    import torch
    return torch.ops.aten._scaled_dot_product_efficient_attention(
        q, k, v, None, True, 0.0, True)[:2]


def _ring_kernels(A, ring, dtype, gen, worst):
    """K10 against its plain version at the JAX tests' shapes, at the 16
    (query shard, key shard) pairs of a four-shard causal ring of [1, 8192,
    8, 64] shards (6 wholly masked) with K8 and K9 at the same offsets, and
    at the path shape; each twice and bitwise repeatable; then the
    four-shard ring merge against K7 on the whole sequence; f32 also K10 at
    F32_ATTN, the f32 ring step's shape. Returns the operands (q, k, v,
    do, and K7's lse and delta) for the timings at the form's path shape:
    RING_ATTN for bf16, F32_ATTN for f32."""
    import torch
    dt = getattr(torch, dtype)

    def randn(shape):
        return torch.randn(shape, generator=gen).to(dt).cuda()

    for shape, causal in ATTN_SHAPES:
        q, k, v = (randn(shape) for _ in range(3))
        scale = 1.0 / math.sqrt(shape[-1])
        got = _twice(lambda: A.flash_attention_block(q, k, v, 0, 0, scale,
                                                     causal))
        want = A.flash_forward_block_reference(q, k, v, 0, 0, scale, causal)
        at = f"{list(shape)} causal={causal} {dtype}"
        e = hold_block(got, want, q, k, v, 0, 0, scale, causal, f"K10 at {at}")
        worst["block"] = max(worst["block"], e)
        print(f"K10 at {at}: max abs err acc {e:.3g}; bitwise repeatable",
              flush=True)
        del got, want
    torch.cuda.empty_cache()

    b, t, h, d = RING_ATTN
    q, k, v, do = (randn(RING_ATTN) for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    o7, lse7 = A.flash_forward(q, k, v, True)
    delta = (do.float() * o7.float()).sum(-1).transpose(1, 2).contiguous()
    ts = t // RING_SHARDS
    shard = [slice(i * ts, (i + 1) * ts) for i in range(RING_SHARDS)]
    masked = 0
    for i in range(RING_SHARDS):
        qi, doi = q[:, shard[i]], do[:, shard[i]]
        lse_i = lse7[..., shard[i]].contiguous()
        delta_i = delta[..., shard[i]].contiguous()
        for j in range(RING_SHARDS):
            kj, vj = k[:, shard[j]], v[:, shard[j]]
            at = f"pair ({i}, {j}) of [1, {ts}, {h}, {d}] shards {dtype}"
            got = _twice(lambda: A.flash_attention_block(
                qi, kj, vj, i * ts, j * ts, scale, True))
            want = A.flash_forward_block_reference(qi, kj, vj, i * ts, j * ts,
                                                   scale, True)
            e = hold_block(got, want, qi, kj, vj, i * ts, j * ts, scale, True,
                           f"K10 {at}")
            masked += int(bool((got[2] == -1e30).all()))
            del got, want
            args = (qi, kj, vj, doi, lse_i, delta_i, i * ts, j * ts, scale,
                    True)
            dq = _twice(lambda: A.flash_dq(*args))
            dk, dv = _twice(lambda: A.flash_dkv(*args))
            bq, = attention_tolerance("dq", qi, kj, vj, True, doi, lse_i,
                                      delta_i, q_off=i * ts, k_off=j * ts)
            e_q = _bounded(dq, A.flash_dq_reference(*args), bq, f"K8 {at}")
            del bq
            bk, bv = attention_tolerance("dkv", qi, kj, vj, True, doi, lse_i,
                                         delta_i, q_off=i * ts, k_off=j * ts)
            rk, rv = A.flash_dkv_reference(*args)
            e_k = _bounded(dk, rk, bk, f"K9 dk {at}")
            e_v = _bounded(dv, rv, bv, f"K9 dv {at}")
            del bk, bv, rk, rv, dq, dk, dv
            torch.cuda.empty_cache()
            worst["block"] = max(worst["block"], e)
            worst["dq"] = max(worst["dq"], e_q)
            worst["dkv"] = max(worst["dkv"], e_k, e_v)
            print(f"K10/K8/K9 at {at}: max abs err acc {e:.3g}, dq {e_q:.3g}, "
                  f"dk {e_k:.3g}, dv {e_v:.3g}; each bitwise repeatable",
                  flush=True)
    want_masked = RING_SHARDS * (RING_SHARDS - 1) // 2
    if masked != want_masked:
        raise RuntimeError(f"{masked} wholly masked pairs, expected "
                           f"{want_masked}")

    at = f"the path shape {list(RING_ATTN)} causal {dtype}"
    got = _twice(lambda: A.flash_attention_block(q, k, v, 0, 0, scale, True))
    want = A.flash_forward_block_reference(q, k, v, 0, 0, scale, True)
    e = hold_block(got, want, q, k, v, 0, 0, scale, True, f"K10 at {at}",
                   rows=TOL_ROWS)
    worst["block"] = max(worst["block"], e)
    print(f"K10 at {at}: max abs err acc {e:.3g}; bitwise repeatable",
          flush=True)
    del got, want
    torch.cuda.empty_cache()

    # the ring merge, one process: every query shard's P steps in ring order
    launches0 = A.COUNTERS.block_launches + A.COUNTERS.f32_block_launches
    outs, lses = [], []
    for i in range(RING_SHARDS):
        state = ring.ring_init(q[:, shard[i]])
        for st in range(RING_SHARDS):
            j = (i - st) % RING_SHARDS
            state = ring.ring_step(state, q[:, shard[i]], k[:, shard[j]],
                                   v[:, shard[j]], i * ts, j * ts, scale,
                                   True)
        o_i, lse_i = ring.ring_finish(state, q.dtype)
        outs.append(o_i)
        lses.append(lse_i)
        del state
    if A.COUNTERS.block_launches + A.COUNTERS.f32_block_launches - \
            launches0 != RING_SHARDS ** 2:
        raise RuntimeError("the ring merge did not run K10 at every step")
    # bf16: P rounded against another running maximum on each side; f32:
    # no rounding of P, the sums' order alone
    rel = MERGE_REL if dtype == "bfloat16" else 1e-5
    bound, = attention_tolerance("fwd", q, k, v, True, rel=rel, rows=TOL_ROWS)
    e = _bounded(torch.cat(outs, 1), o7, bound, "the ring merge against K7")
    e_lse = _lse_err(torch.cat(lses, -1), lse7, "the ring merge against K7")
    worst["merge"] = max(worst["merge"], e)
    print(f"ring merge of {RING_SHARDS} shards against K7 on {list(RING_ATTN)} "
          f"causal {dtype}: max abs err o {e:.3g} (bound rel {rel:.3g}), lse "
          f"{e_lse:.3g}", flush=True)
    del outs, lses, bound, o7
    torch.cuda.empty_cache()
    if dtype == "bfloat16":
        return q, k, v, do, lse7, delta

    # the f32 ring step on the card runs K10 at F32_ATTN (T 2048, one rank)
    del q, k, v, do, lse7, delta
    torch.cuda.empty_cache()
    q, k, v, do = (randn(F32_ATTN) for _ in range(4))
    at = f"the f32 step's shape {list(F32_ATTN)} causal {dtype}"
    got = _twice(lambda: A.flash_attention_block(q, k, v, 0, 0, scale, True))
    want = A.flash_forward_block_reference(q, k, v, 0, 0, scale, True)
    e = hold_block(got, want, q, k, v, 0, 0, scale, True, f"K10 at {at}")
    worst["block"] = max(worst["block"], e)
    print(f"K10 at {at}: max abs err acc {e:.3g}; bitwise repeatable",
          flush=True)
    o7, lse7 = A.flash_forward(q, k, v, True)
    delta = (do.float() * o7.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, lse7, delta


def _time_ring(A, q, k, v, do, lse, delta, dtype, worst):
    """At the operands' shape, causal: K10 (the kernel, the plain version,
    PyTorch's flash (bf16) or memory-efficient (f32) forward with its
    logsumexp), and K8 and K9 (the kernel alone: at the bf16 path shape the
    plain versions would form 34 GB of scores). Per call."""
    import torch
    b, t, h, d = q.shape
    f32 = dtype == "float32"
    scale = 1.0 / math.sqrt(d)
    peak = PEAK_3XTF32_FLOPS if f32 else PEAK_BF16_FLOPS
    qv, kv, vv = (x.transpose(1, 2) for x in (q, k, v))          # [B,H,T,D]
    ms = _device_ms(lambda: A.flash_attention_block(q, k, v, 0, 0, scale,
                                                    True), reps=5)
    plain_ms = _device_ms(lambda: A.flash_forward_block_reference(
        q, k, v, 0, 0, scale, True), reps=2)
    lib = _efficient_with_lse if f32 else _sdpa_with_lse
    lib_ms = _library_ms(lambda: lib(qv, kv, vv), 5)
    flops = attention_flops("block", b, t, t, h, d, True)
    nbytes = attention_bytes("block", b, t, t, h, d, 4 if f32 else 2)
    row = _row("flash_attn_fwd_block", f"{list(q.shape)} causal {dtype}", 1,
               ms, plain_ms, lib_ms, flops, nbytes, worst["block"], peak)
    print(f"flash_attn_fwd_block {dtype} at {list(q.shape)} causal: "
          f"{ms:.4f} ms per call ({flops / ms / 1e9:.1f} TFLOP/s), "
          f"plain {plain_ms:.4f}, PyTorch's attention forward with LSE "
          f"{lib_ms}, bound {row['bound_ms']:.4f} ({row['bound_by']}; "
          f"{flops / 1e9:.1f} GFLOP)", flush=True)
    args = (q, k, v, do, lse, delta, 0, 0, scale, True)
    bwd = {}
    for kern in ("dq", "dkv"):
        fn = A.flash_dq if kern == "dq" else A.flash_dkv
        k_ms = _device_ms(lambda: fn(*args), reps=5)
        fl = attention_flops(kern, b, t, t, h, d, True)
        bwd[kern] = {"ms": k_ms, "flops": fl, "bound_ms": fl / peak * 1e3}
        print(f"{ATTN_SOURCES[kern][0]} {dtype} at {list(q.shape)} causal: "
              f"{k_ms:.4f} ms per call ({fl / k_ms / 1e9:.1f} TFLOP/s), "
              f"bound {fl / peak * 1e3:.4f} (operations)", flush=True)
    return row, bwd


def phase_kernel_ring(attention_cuda, ring, report):
    """K10 (the ring's unnormalized flash block), in bf16 and in its f32
    form, against its plain version: at the JAX tests' shapes (offsets 0),
    at the 16 (query shard, key shard) pairs of a four-shard causal ring of
    [1, 8192, 8, 64] shards (6 of them wholly masked), and at the path shape
    [1, 32768, 8, 64]; each twice and bitwise repeatable. K8 and K9 at the
    same 16 pairs with their offsets (their plain versions form [Tq, Tk]
    scores: 34 GB at the path shape, so they are held at the pairs alone).
    The four shards' ring merge (`ring.ring_step` looped over the shards,
    K10 each step) against K7 on the whole sequence. f32 also at F32_ATTN,
    the f32 ring step's shape. Then K10 timed at the path shape of each
    form (bf16 RING_ATTN, f32 F32_ATTN) beside its bound, its plain version
    and PyTorch's attention forward with its logsumexp (a yardstick only),
    and K8 and K9 there."""
    import torch
    A = attention_cuda
    gen = torch.Generator().manual_seed(SEED + 7)
    per = RING["n_layer"]
    entries, table = [], {}
    for dtype in ("bfloat16", "float32"):
        path = F32_ATTN if dtype == "float32" else RING_ATTN
        b, t = path[:2]
        worst = {"block": 0.0, "dq": 0.0, "dkv": 0.0, "merge": 0.0}
        operands = _ring_kernels(A, ring, dtype, gen, worst)
        row, bwd = _time_ring(A, *operands, dtype, worst)
        del operands
        torch.cuda.empty_cache()
        table[dtype] = {"path_shape": row, "backward": bwd,
                        "max_abs_err": worst}
        library = ("torch.ops.aten._scaled_dot_product_efficient_attention "
                   "in f32" if dtype == "float32" else
                   "torch.ops.aten._scaled_dot_product_flash_attention") + \
            " (forward with its logsumexp)"
        entries.append(_attn_kernel_entry(
            "block", dtype, row, per,
            f"the {per} calls of one batch-{b} T-{t} ring transformer_lm "
            f"training step, {list(path)} causal {dtype}", library))
    report["ring_kernel"] = table
    return entries


# --- the transformer LM: training and serving -----------------------------------

def _transformer(pt, amp=True, is_test=False, use_flash="auto", cfg=None,
                 seqlen=None, sequence_parallel=False):
    """bench.py's `transformer` model (`cfg`, LM by default; T `seqlen`,
    cfg's by default) through the port's fluid API: the training program
    (Adam, amp.decorate O2) or, with is_test, the served one (logits
    returned, amp.enable O2). The same variable names. With
    sequence_parallel its attention is the ring over a one-rank 'sp' mesh
    (bench.py's `ring_attention` mode)."""
    cfg = LM if cfg is None else cfg
    main, startup = pt.Program(), pt.Program()
    t = cfg["seqlen"] if seqlen is None else seqlen
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        tok = pt.layers.data(name="tok", shape=[-1, t], dtype="int64",
                             append_batch_size=False)
        lab = pt.layers.data(name="lab", shape=[-1, t], dtype="int64",
                             append_batch_size=False)
        loss, logits = pt.models.transformer_lm(
            tok, lab, vocab_size=cfg["vocab"], d_model=cfg["d_model"],
            n_head=cfg["n_head"], n_layer=cfg["n_layer"], use_flash=use_flash,
            is_test=is_test, sequence_parallel=sequence_parallel,
            return_logits=True)
        if is_test:
            if amp:
                pt.amp.enable(main, level="O2")
        else:
            opt = pt.optimizer.Adam(learning_rate=cfg["lr"])
            if amp:
                opt = pt.amp.decorate(opt, level="O2")
            opt.minimize(loss, startup_program=startup)
    if sequence_parallel:
        main._mesh = pt.parallel.make_mesh((1,), ("sp",))
    main.random_seed = startup.random_seed = SEED + 1
    return main, startup, loss, logits


def _k_biases(main):
    """The biases of the K projections. Their gradient is zero in exact
    arithmetic (a bias on K adds one constant to each query's scores, and
    softmax ignores it), so what any run computes for it is rounding noise
    (norm ~1e-10 against a median of ~1e-2 on the CPU): it is left out of
    the relative comparisons."""
    block = main.global_block()
    made_by = {n: op for op in block.ops for n in op.output_arg_names}
    return {made_by[made_by[op.input("K")[0]].input("X")[0]].input("Y")[0]
            for op in block.ops if op.type == "scaled_dot_product_attention"}


def _hold_lm_step(pt, main, loss, init, small, card, f32, o2_einsum,
                  f32_expect):
    """One step of the LM program `main` (O2) at `small` from `init` on the
    card against the CPU plain path, and the same for its f32 twin `f32`
    ((main, startup, loss, logits)); the O2 grads held to this run's own
    CPU noise floor, the O2 CPU run of `main` against that of `o2_einsum`,
    the einsum-attention program. The f32 twin's card step runs its
    attention through the kernels' f32 forms: its launches are held to
    `f32_expect` ({counter: launches}, every other f32 counter 0), every
    flash call a hit, no fallback. Returns (agreements, the K biases' f32
    CPU grad norms, the f32 card step's launches); raises past the LM_*
    tolerances."""
    import numpy as np
    from paddle_tpu_torch.ops import attention_cuda as A
    params = sorted(p.name for p in main.global_block().all_parameters()
                    if p.trainable)
    skip = _k_biases(main)
    main32, _, loss32, _ = f32
    main_e, _, loss_e, _ = o2_einsum
    runs, f32_launches = {}, None
    for key, prog, lss, place in (
            ("o2_card", main, loss, pt.CUDAPlace(0)),
            ("o2_cpu", main, loss, pt.CPUPlace()),
            ("o2_cpu_einsum", main_e, loss_e, pt.CPUPlace()),
            ("f32_card", main32, loss32, pt.CUDAPlace(0)),
            ("f32_cpu", main32, loss32, pt.CPUPlace())):
        A.COUNTERS.reset()
        t0 = time.perf_counter()
        runs[key] = _step(pt, prog, lss, params, init, small, place)
        print(f"{key}: one batch-{LM_SMALL_BATCH} step, loss {runs[key][0]:.6f}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        if not all(np.isfinite(g).all() for g in runs[key][1]):
            raise RuntimeError(f"{key}: non-finite grads")
        if key == "f32_card":
            f32_launches = {k: getattr(A.COUNTERS, k) for k in F32_COUNTERS}
            hits, fallbacks = dict(A.COUNTERS.hits), dict(A.COUNTERS.fallbacks)
            print(f"f32_card: the f32 kernels' launches {f32_launches}; "
                  f"flash calls {hits}; attention fallbacks {fallbacks}",
                  flush=True)
            want = {k: f32_expect.get(k, 0) for k in F32_COUNTERS}
            if f32_launches != want or fallbacks or not hits:
                raise RuntimeError(f"the f32 step on the card launched "
                                   f"{f32_launches}, expected {want}; hits "
                                   f"{hits}; fallbacks {fallbacks}")
    agree = {what: _grad_agreement(runs[a], runs[b], params, skip)
             for what, a, b in (("o2", "o2_card", "o2_cpu"),
                                ("f32", "f32_card", "f32_cpu"),
                                ("o2_cpu_flash_vs_einsum", "o2_cpu",
                                 "o2_cpu_einsum"))}
    for what, r in agree.items():
        print(f"{what}: loss {r['loss_rel_diff']:.3g} relative; grad relative "
              f"L2 median {r['grad_rl2_median']:.3g}, max {r['grad_rl2_max']:.3g} "
              f"({r['grad_rl2_worst']}); grad norm ratio "
              f"{r['norm_ratio_min']:.5f}-{r['norm_ratio_max']:.5f} "
              f"({len(params) - len(skip)} parameters; the {len(skip)} K "
              f"biases left out) ({card})", flush=True)
    kb = {p: float(np.linalg.norm(g)) for p, g in zip(params, runs["f32_cpu"][1])
          if p in skip}
    print(f"the K biases' grad norms (f32, CPU): {kb}", flush=True)
    o2, f32, floor = agree["o2"], agree["f32"], agree["o2_cpu_flash_vs_einsum"]
    failed = []
    if o2["loss_rel_diff"] > LM_O2_LOSS_RTOL or \
            f32["loss_rel_diff"] > LM_F32_LOSS_RTOL:
        failed.append("loss")
    if o2["grad_rl2_median"] > LM_SPREAD_FACTOR * floor["grad_rl2_median"] or \
            o2["grad_rl2_max"] > LM_SPREAD_FACTOR * floor["grad_rl2_max"]:
        failed.append("O2 grads past twice the noise floor")
    if f32["grad_rl2_median"] > LM_F32_GRAD_RL2[0] or \
            f32["grad_rl2_max"] > LM_F32_GRAD_RL2[1]:
        failed.append("f32 grads")
    for what, tol in (("o2", LM_NORM_RATIO[0]), ("f32", LM_NORM_RATIO[1])):
        r = agree[what]
        if not (1 - tol <= r["norm_ratio_min"] and r["norm_ratio_max"] <= 1 + tol):
            failed.append(f"{what} grad norms")
    if failed:
        raise RuntimeError(f"the batch-{LM_SMALL_BATCH} step disagrees "
                           f"(card against the CPU plain path, O2 and f32): "
                           f"{failed}")
    return agree, kb, f32_launches


def _time_f32_step(pt, f32, init, feed, card, what, expect):
    """The f32 twin `f32` ((main, startup, loss, logits)) trained on the
    card from `init` on `feed`: one warm-up and LM_STEPS timed steps (step
    p50 on the host clock; the fetch ends in a device-to-host copy), the f32
    kernels' launches per step held to `expect` ({counter: launches}, every
    other f32 counter 0) with no attention fallback, then one profiled
    step's device busy time (`_profile_step`, from a trace that holds K8's
    f32 form)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.ops import attention_cuda as A
    main32, _, loss32, _ = f32
    scope = pt.Scope()
    for n, v in init.items():
        scope.set_var(n, v.cuda())
    exe = pt.Executor(pt.CUDAPlace(0))
    losses = [float(exe.run(main32, feed=feed, fetch_list=[loss32],
                            scope=scope)[0][0])]
    torch.cuda.synchronize()
    A.COUNTERS.reset()
    times = []
    for _ in range(LM_STEPS):
        t0 = time.perf_counter()
        losses.append(float(exe.run(main32, feed=feed, fetch_list=[loss32],
                                    scope=scope)[0][0]))
        times.append(time.perf_counter() - t0)
    launches = {k: getattr(A.COUNTERS, k) / LM_STEPS for k in F32_COUNTERS}
    fallbacks = dict(A.COUNTERS.fallbacks)
    want = {k: float(expect.get(k, 0)) for k in F32_COUNTERS}
    if launches != want or fallbacks:
        raise RuntimeError(f"{what}: the f32 kernels' launches per step "
                           f"{launches}, expected {want}; fallbacks "
                           f"{fallbacks}")
    if not np.isfinite(losses).all():
        raise RuntimeError(f"{what}: losses {losses}")
    p50 = float(np.median(times)) * 1e3
    print(f"{what}: step p50 {p50:.1f} ms (steps "
          f"{', '.join(f'{t * 1e3:.1f}' for t in times)}), the f32 kernels' "
          f"launches per step {launches} ({card})", flush=True)
    prof = _profile_step(exe, main32, feed, loss32, scope, p50, card, (
        "K8's f32 form", lambda name: "dq_tf32_kernel" in name))
    top = dict(sorted(prof["by_kernel"].items(),
                      key=lambda kv: -kv[1][0])[:12])
    return {"p50_ms": p50, "step_ms": [t * 1e3 for t in times],
            "losses": losses, "busy_ms": prof["busy_ms"],
            "busy_share": prof["busy_share"], "launches_per_step": launches,
            "by_kernel": top}


def phase_train_lm(pt, attention_cuda, report):
    import numpy as np
    import torch
    A = attention_cuda
    B, T, V = LM["batch"], LM["seqlen"], LM["vocab"]
    main, startup, loss, _ = _transformer(pt)
    scope = pt.Scope()
    exe = pt.Executor()                        # CUDAPlace(0) by default
    exe.run(startup, scope=scope)
    init = {n: v.clone() for n, v in scope.vars.items()
            if isinstance(v, torch.Tensor)}
    rng = np.random.default_rng(SEED)
    feed = {"tok": rng.integers(0, V, (B, T)).astype(np.int64),
            "lab": rng.integers(0, V, (B, T)).astype(np.int64)}
    card = _card_line()

    t0 = time.perf_counter()
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0][0])]
    print(f"transformer_lm warm-up step: {time.perf_counter() - t0:.2f} s, "
          f"loss {losses[0]:.5f}", flush=True)
    A.COUNTERS.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(LM_STEPS):
        t0 = time.perf_counter()               # the fetch ends in a device->host copy
        losses.append(float(exe.run(main, feed=feed, fetch_list=[loss],
                                    scope=scope)[0][0]))
        times.append(time.perf_counter() - t0)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {k: getattr(A.COUNTERS, k)
                for k in ("launches", "dq_launches", "dkv_launches")}
    hits, fallbacks = dict(A.COUNTERS.hits), dict(A.COUNTERS.fallbacks)
    p50 = float(np.median(times)) * 1e3
    tok_s = B * T / (p50 / 1e3)
    print(f"transformer_lm O2 training, batch {B}, T {T}: step p50 {p50:.1f} ms "
          f"(steps {', '.join(f'{t * 1e3:.1f}' for t in times)}), "
          f"{tok_s:.0f} tokens/s; peak memory {peak_gb:.2f} GB ({card})",
          flush=True)
    print(f"losses: {', '.join(f'{v:.5f}' for v in losses)}", flush=True)
    per_step = {k: v / LM_STEPS for k, v in launches.items()}
    print(f"K7/K8/K9 launches per step: {per_step}; flash-path calls {hits}; "
          f"attention fallbacks {fallbacks}", flush=True)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"the training loss is not finite and falling: {losses}")
    want = LM["n_layer"] * LM_STEPS
    if any(v != want for v in launches.values()) or fallbacks:
        raise RuntimeError(f"K7/K8/K9 launches {launches}, expected {want} "
                           f"each; fallbacks {fallbacks}")

    profile = _profile_step(exe, main, feed, loss, scope, p50, card, (
        "K7", lambda name: "flash_fwd_kernel" in name))

    # batch 1 from the startup weights: op by op, then end to end, card vs
    # the CPU plain path, in O2 and in f32; the CPU's O2 flash path against
    # its O2 einsum path is the bf16 noise floor the O2 grads are held to
    small = {k: v[:LM_SMALL_BATCH] for k, v in feed.items()}
    t0 = time.perf_counter()
    worst = _lockstep(pt, main, loss, init, small)
    top = sorted(worst.items(), key=lambda kv: -kv[1])
    print(f"lockstep, batch {LM_SMALL_BATCH}: {len(worst)} op kinds, each output "
          f"on the card against the CPU plain path on the card's inputs "
          f"({time.perf_counter() - t0:.1f} s); worst relative L2: "
          + ", ".join(f"{k} {v:.3g}" for k, v in top[:8])
          + f" (tol {LOCKSTEP_BF16} bf16, {LOCKSTEP_F32} f32)", flush=True)
    n = LM["n_layer"]
    f32 = _transformer(pt, amp=False)
    f32_expect = {"f32_launches": n, "f32_dq_launches": n,
                  "f32_dkv_launches": n}
    agree, kb, f32_launches = _hold_lm_step(
        pt, main, loss, init, small, card, f32,
        _transformer(pt, use_flash=False), f32_expect)
    f32_step = _time_f32_step(
        pt, f32, init, small, card,
        f"transformer_lm f32 training, batch {LM_SMALL_BATCH}, T {T}",
        f32_expect)
    report["train_lm"] = {
        "card": card, "config": LM, "step_ms": [t * 1e3 for t in times],
        "p50_ms": p50, "tokens_per_s": tok_s, "losses": losses,
        "peak_memory_gb": peak_gb, "launches_per_step": per_step,
        "hits": hits, "profile": profile, "lockstep_worst_rl2": worst,
        "small_batch": agree, "k_bias_grad_norms": kb,
        "f32_card_launches": f32_launches, "f32_step": f32_step}
    return {**launches, **f32_launches}


def phase_serve_lm(pt, attention_cuda, report):
    import numpy as np
    import torch
    from paddle_tpu_torch.serving import ServingEngine
    A = attention_cuda
    T, V = LM["seqlen"], LM["vocab"]
    main, startup, _, logits = _transformer(pt, is_test=True)
    scope = pt.Scope()
    pt.Executor().run(startup, scope=scope)
    engine = ServingEngine(main, ["tok"], [logits], buckets=LM_BUCKETS,
                           scope=scope)
    served = {op.type for op in engine.program.global_block().ops}
    if served & {"softmax_with_cross_entropy", "mean", "adam"}:
        raise RuntimeError(f"the loss tail survived pruning to logits: {served}")
    rng = np.random.default_rng(SEED + 6)
    requests = [rng.integers(0, V, (n, T)).astype(np.int64)
                for n in LM_SERVE_SIZES]
    for b in LM_BUCKETS:                       # warm-up: one batch per bucket
        engine.infer({"tok": requests[0][:1].repeat(b, axis=0)})
    torch.cuda.synchronize()
    A.COUNTERS.reset()
    outs, single = [], []
    t_window = time.perf_counter()
    for req in requests:
        t0 = time.perf_counter()
        out, = engine.infer({"tok": req})      # ends in a device->host copy
        single.append((engine.bucket_for(req.shape[0]),
                       (time.perf_counter() - t0) * 1e3))
        outs.append(out)
    window_s = time.perf_counter() - t_window
    launches, fallbacks = A.COUNTERS.launches, dict(A.COUNTERS.fallbacks)
    for req, out in zip(requests, outs):
        if out.shape != (req.shape[0], T, V) or not np.isfinite(out).all():
            raise RuntimeError(f"logits {out.shape} for tokens {req.shape}, "
                               f"or not finite")
    if launches != LM["n_layer"] * len(requests) or fallbacks:
        raise RuntimeError(f"K7 launched {launches} times over {len(requests)} "
                           f"bucket runs, expected {LM['n_layer']} each; "
                           f"fallbacks {fallbacks}")
    if not np.array_equal(engine.infer({"tok": requests[0]})[0], outs[0]):
        raise RuntimeError("a repeated request gave a different answer")
    cpu_scope = pt.Scope()
    for n in engine._prepared.state_names:
        cpu_scope.set_var(n, scope.find_var(n).cpu())
    cpu_engine = ServingEngine(main, ["tok"], [logits], place=pt.CPUPlace(),
                               scope=cpu_scope, buckets=LM_BUCKETS)
    ref = cpu_engine.infer({"tok": requests[0]})[0].astype(np.float64)
    got = outs[0].astype(np.float64)
    rel = float(np.abs(got - ref).max() / np.abs(ref).max())
    same = float((got.argmax(-1) == ref.argmax(-1)).mean())
    card = _card_line()
    lat = {b: [] for b in LM_BUCKETS}          # the window gives 1-2 per bucket
    for b in LM_BUCKETS:
        full = rng.integers(0, V, (b, T)).astype(np.int64)
        for _ in range(LM_LATENCY_REPS):
            t0 = time.perf_counter()
            engine.infer({"tok": full})
            lat[b].append((time.perf_counter() - t0) * 1e3)
    p50 = {b: float(np.median(v)) for b, v in lat.items()}
    tok_s = sum(LM_SERVE_SIZES) * T / window_s
    print(f"served logits vs the CPU plain path, {requests[0].shape[0]} row(s): "
          f"max abs diff {rel:.3g} of the largest |logit| (tol "
          f"{LM_LOGIT_RTOL}); argmax equal at {same:.4f} of the positions",
          flush=True)
    print(f"K7 launches {launches} = {LM['n_layer']} layers x {len(requests)} "
          f"bucket runs; the window's single-request latencies (bucket: ms) "
          + ", ".join(f"{b}: {v:.2f}" for b, v in single)
          + f"; {tok_s:.0f} tokens/s over the {len(requests)} requests' window "
            f"({window_s:.3f} s)", flush=True)
    print(f"p50 latency per bucket over {LM_LATENCY_REPS} full-bucket requests "
          f"each (ms, host clock, {card}): "
          + ", ".join(f"bucket {b}: {v:.2f} ({min(lat[b]):.2f}-"
                      f"{max(lat[b]):.2f})" for b, v in p50.items()), flush=True)
    if rel > LM_LOGIT_RTOL:
        raise RuntimeError("the served logits disagree with the CPU plain path")
    report["serve_lm"] = {"card": card, "p50_ms": p50, "latencies_ms": lat,
                          "window_latencies_ms": single,
                          "tokens_per_s": tok_s, "window_s": window_s,
                          "launches": launches, "cpu_logit_rel_diff": rel,
                          "cpu_argmax_equal": same}
    return launches


def phase_train_ring(pt, attention_cuda, report):
    """bench.py's `ring_attention` configuration trained on the card: the
    ring over a one-rank 'sp' mesh, use_flash=True, AMP O2, Adam 1e-4; one
    warm-up and RING_STEPS timed steps on one batch of random tokens and
    labels (seed 0): step p50 and tokens/s, launches per step held to K10
    4, K8 4, K9 4 and K7 0 with every attention call a flash-ring hit (no
    fallback, no einsum ring), the loss finite and falling, peak memory, a
    profiled step. Then the same ring program at T RING_SMALL_T, one step
    from the startup weights against the CPU plain path: op by op, then
    end to end, in O2; in f32 the ring raises on the card and its CPU step
    is held against the f32 einsum program's."""
    import numpy as np
    import torch
    A = attention_cuda
    B, T, V = RING["batch"], RING["seqlen"], RING["vocab"]
    main, startup, loss, _ = _transformer(pt, use_flash=True, cfg=RING,
                                          sequence_parallel=True)
    scope = pt.Scope()
    exe = pt.Executor()                        # CUDAPlace(0) by default
    exe.run(startup, scope=scope)
    rng = np.random.default_rng(SEED)
    feed = {"tok": rng.integers(0, V, (B, T)).astype(np.int64),
            "lab": rng.integers(0, V, (B, T)).astype(np.int64)}
    card = _card_line()

    t0 = time.perf_counter()
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0][0])]
    print(f"ring transformer_lm warm-up step: {time.perf_counter() - t0:.2f} s, "
          f"loss {losses[0]:.5f}", flush=True)
    A.COUNTERS.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(RING_STEPS):
        t0 = time.perf_counter()               # the fetch ends in a device->host copy
        losses.append(float(exe.run(main, feed=feed, fetch_list=[loss],
                                    scope=scope)[0][0]))
        times.append(time.perf_counter() - t0)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {k: getattr(A.COUNTERS, k) for k in (
        "block_launches", "dq_launches", "dkv_launches", "launches")}
    hits, fallbacks = dict(A.COUNTERS.hits), dict(A.COUNTERS.fallbacks)
    p50 = float(np.median(times)) * 1e3
    tok_s = B * T / (p50 / 1e3)
    print(f"ring transformer_lm O2 training, batch {B}, T {T}: step p50 "
          f"{p50:.1f} ms (steps {', '.join(f'{t * 1e3:.1f}' for t in times)}), "
          f"{tok_s:.0f} tokens/s; peak memory {peak_gb:.2f} GB ({card})",
          flush=True)
    print(f"losses: {', '.join(f'{v:.5f}' for v in losses)}", flush=True)
    per_step = {k: v / RING_STEPS for k, v in launches.items()}
    print(f"K10/K8/K9/K7 launches per step: {per_step}; flash-ring calls "
          f"{hits}; attention fallbacks {fallbacks}", flush=True)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"the training loss is not finite and falling: {losses}")
    n = RING["n_layer"] * RING_STEPS
    want = {"block_launches": n, "dq_launches": n, "dkv_launches": n,
            "launches": 0}
    want_hits = {"scaled_dot_product_attention": n,
                 "scaled_dot_product_attention_grad": n}
    if launches != want or hits != want_hits or fallbacks:
        raise RuntimeError(f"K10/K8/K9/K7 launches {launches}, expected "
                           f"{want}; hits {hits}; fallbacks {fallbacks}")

    profile = _profile_step(exe, main, feed, loss, scope, p50, card, (
        "K10", lambda name: "flash_fwd_kernel" in name and "false" in name))
    del scope, exe
    torch.cuda.empty_cache()

    # T RING_SMALL_T: the same ring program from the startup weights, card
    # against the CPU plain path; the O2 grads held to the CPU's own O2
    # ring-vs-einsum spread; its f32 twin on the card through the f32 forms
    # of K10, K8 and K9 against the same f32 ring on the CPU
    small_prog = _transformer(pt, use_flash=True, cfg=RING,
                              seqlen=RING_SMALL_T, sequence_parallel=True)
    main_s, startup_s, loss_s, _ = small_prog
    scope = pt.Scope()
    pt.Executor().run(startup_s, scope=scope)
    init = {n: v.clone() for n, v in scope.vars.items()
            if isinstance(v, torch.Tensor)}
    del scope
    small = {"tok": feed["tok"][:LM_SMALL_BATCH, :RING_SMALL_T],
             "lab": feed["lab"][:LM_SMALL_BATCH, :RING_SMALL_T]}
    t0 = time.perf_counter()
    worst = _lockstep(pt, main_s, loss_s, init, small)
    top = sorted(worst.items(), key=lambda kv: -kv[1])
    print(f"ring lockstep, batch {LM_SMALL_BATCH}, T {RING_SMALL_T}: "
          f"{len(worst)} op kinds, each output on the card against the CPU "
          f"plain path on the card's inputs ({time.perf_counter() - t0:.1f} s); "
          f"worst relative L2: " + ", ".join(f"{k} {v:.3g}" for k, v in top[:8])
          + f" (tol {LOCKSTEP_BF16} bf16, {LOCKSTEP_F32} f32)", flush=True)
    n = RING["n_layer"]
    f32 = _transformer(pt, amp=False, use_flash=True, cfg=RING,
                       seqlen=RING_SMALL_T, sequence_parallel=True)
    f32_expect = {"f32_block_launches": n, "f32_dq_launches": n,
                  "f32_dkv_launches": n}
    agree, kb, f32_launches = _hold_lm_step(
        pt, main_s, loss_s, init, small, card, f32,
        _transformer(pt, use_flash=False, cfg=RING, seqlen=RING_SMALL_T),
        f32_expect)
    f32_step = _time_f32_step(
        pt, f32, init, small, card,
        f"ring transformer_lm f32 training, batch {LM_SMALL_BATCH}, T "
        f"{RING_SMALL_T}, one rank", f32_expect)
    report["train_ring"] = {
        "card": card, "config": RING, "step_ms": [t * 1e3 for t in times],
        "p50_ms": p50, "tokens_per_s": tok_s, "losses": losses,
        "peak_memory_gb": peak_gb, "launches_per_step": per_step,
        "hits": hits, "profile": profile, "lockstep_worst_rl2": worst,
        "small_t": RING_SMALL_T, "small_batch": agree, "k_bias_grad_norms": kb,
        "f32_card_launches": f32_launches, "f32_step": f32_step}
    return {**launches, **f32_launches}


def ptxas_report(build_log: dict) -> dict:
    """Print ptxas's registers, spills and serialized-wgmma warnings for every
    kernel of every library in `build_log` (cuda_build.BUILD_LOG: name ->
    {"log": ...}) and return them by kernel; raise if any kernel spills."""
    spills, ptxas = [], {}
    for name, info in build_log.items():
        fn = ""
        for line in str(info["log"]).splitlines():
            if "Function properties for" in line:
                fn = _kernel_label(line.split()[-1])
            if "registers" in line or "spill" in line:
                print(f"build {name}: {fn}: {line.strip()}", flush=True)
                ptxas.setdefault(f"{name} {fn}", []).append(line.strip())
                if "spill" in line and \
                        " 0 bytes spill stores, 0 bytes spill loads" not in line:
                    spills.append(f"{name} {fn}: {line.strip()}")
            if "Performance Loss" in line:  # ptxas serialized its wgmmas
                at = _kernel_label(line.split("'")[-2]) if "'" in line else fn
                print(f"build {name}: {at}: {line.strip()[:160]}", flush=True)
                ptxas.setdefault(f"{name} {at}", []).append(line.strip())
    if spills:
        raise RuntimeError("kernels spill registers: " + "; ".join(spills))
    return ptxas


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--report", help="also write the measurements as JSON here")
    ap.add_argument("--parent", help="an older checkout whose K11 and f32 K7 "
                    "are timed beside this tree's")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    # the port under test is the checkout this script stands in, never a
    # copy installed elsewhere
    if not (Path(__file__).resolve().parent / "paddle_tpu_torch").is_dir():
        print("chip_smoke: no paddle_tpu_torch/ beside this script; run it "
              "from the root of a checkout", file=sys.stderr)
        return 2
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import resnet
    from paddle_tpu_torch.ops import (attention_cuda, bn_cuda, conv_cuda,
                                      cuda_build)
    from paddle_tpu_torch.parallel import ring_attention

    card = _card_line()
    print(f"device: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    cuda_build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    ptxas = ptxas_report(cuda_build.BUILD_LOG)

    # f32 results are held against references: no TF32 anywhere
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    report = {"card": card, "ptxas": ptxas}
    k1 = phase_kernel(pt, conv_cuda, resnet, report)
    slice_launches, served = phase_slice(pt, conv_cuda, resnet, report)
    k11 = phase_kernel_q8(pt, conv_cuda, resnet, report, args.parent)
    q8 = phase_serve_q8(pt, conv_cuda, resnet, report, served)
    del served
    k1["launches_by_path"] = {"serve": slice_launches,
                              "serve_q8": q8["launches"]}
    k1["launches"] = sum(k1["launches_by_path"].values())
    k11["launches"] = q8["q8_launches"]
    train_kernels = phase_kernel_train(pt, conv_cuda, bn_cuda, resnet, report)
    per_step = phase_train(pt, conv_cuda, bn_cuda, resnet, report)
    for k, key in zip(train_kernels, ("dgrad_launches", "wgrad_launches",
                                      "stats_launches", "apply_launches",
                                      "act_launches")):
        k["launches"] = int(per_step[key] * TRAIN_STEPS)
    attn_kernels = phase_kernel_attn(attention_cuda, report, args.parent)
    lm_launches = phase_train_lm(pt, attention_cuda, report)
    serve_launches = phase_serve_lm(pt, attention_cuda, report)
    ring_kernels = phase_kernel_ring(attention_cuda, ring_attention, report)
    ring_launches = phase_train_ring(pt, attention_cuda, report)
    counter = {"flash_attn_fwd": "launches", "flash_attn_bwd_dq": "dq_launches",
               "flash_attn_bwd_dkv": "dkv_launches",
               "flash_attn_fwd_block": "block_launches"}
    for k in attn_kernels + ring_kernels:
        f32 = k["name"].endswith("_f32")
        key = ("f32_" if f32 else "") + counter[k["name"].removesuffix("_f32")]
        by_path = {"train_lm": lm_launches.get(key, 0),
                   "train_ring": ring_launches.get(key, 0)}
        if key == "launches":
            by_path["serve_lm"] = serve_launches
        by_path = {p: n for p, n in by_path.items() if n}
        k["launches"] = sum(by_path.values())
        k["launches_by_path"] = by_path
        if not k["launches"]:
            raise RuntimeError(f"{k['name']} was launched no time on its path")
    kernels = {"kernels": [k1] + train_kernels + attn_kernels + ring_kernels
               + [k11]}
    report.update(kernels)
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1, default=str)
    print(json.dumps(kernels))
    print(_card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
