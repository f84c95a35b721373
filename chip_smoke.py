"""Chip smoke for the PyTorch/CUDA port (paddle_tpu_torch) on one GPU.

Drives the port's main paths — ResNet-50 (224x224, 1000 classes, full
width and depth, random weights from a seed) under AMP O2, served by the
port's ServingEngine through buckets (1, 4, 16), one CUDA graph per
bucket, served in int8 (AMP O3) from a saved inference model through the
same buckets, served under concurrent clients through DynamicBatcher
(buckets 1-16, bench.py's serving defaults), and trained with
Momentum through Executor.run at batch 32 and, from the flowers reader,
through the DoubleBufferedFeeder and Executor.run_steps; the book
chapters that need no sequence op; bench.py's transformer LM
(batch 8, T 2048, 4 layers, d_model 512, 8 heads, vocab 8192) under AMP
O2, trained with Adam and served through buckets (1, 2, 4, 8); and
bench.py's long-context ring configuration of the same LM (batch 1, T
32768, sequence_parallel over an 'sp' mesh of the one card) trained; each
training step eager and as a CUDA graph per step signature; ResNet-50 and
the LM trained under AMP O3 (int8; the LM also fp8) and ResNet-50 served
in fp8; bench.py's DLRM trained with sparse embedding gradients (its 1M-row
table in place on the card, and again from the hot-row cache) and its dlrm
model served — and holds every kernel of those paths against its plain
PyTorch version on the card:

  1. device   CUDA present (else exit 2), the card's name and power limit;
  2. build    nvcc builds every CUDA kernel from paddle_tpu_torch/csrc/,
              one process per source, all started together (the Triton
              kernel K5 compiles at its first launch);
  3. kernel   K1 (conv2d forward) against conv2d_reference on the JAX
              tests' five cases and every distinct ResNet-50 conv shape at
              each bucket's batch (1, 4, 16), then per shape at batch 16:
              kernel, plain, cuDNN (yardstick only) times, each from a
              CUDA graph of 20 calls timed with CUDA events, beside the
              bound;
  4. slice    build + startup on the card, batch-norm statistics set from
              one calibration batch (so the random model's logits are
              not saturated); each bucket's first call warms up, captures
              and replays its CUDA graph, the first replay bitwise the
              eager run of the same prepared program on the same request
              (the wrappers count K1 3 x 52 a bucket there: the eager
              reference, warm-up, capture; fallback counts; no filter
              copied); 12 replayed requests of batch 1-16, output checks,
              no wrapper called and no capture, K1 launches from the
              replays' trace == eligible convs x batches, one request per
              bucket against the same weights in f32 on the card and on
              the port's own CPU plain path, p50 latency per bucket,
              img/s over the request window, the graphed request against
              the eager one in turns (p50 per bucket), and one profiled
              batch-16 replay: device busy time and the kernels it went
              to;
  5. kernel_q8  K11 (int8 conv) against conv2d_q8_reference, bitwise (bf16
              and f32 out, the bf16 call repeated), on the five test cases
              and every distinct conv shape of ResNet-50's O3 route at each
              bucket's batch, under its plan and split-K forced on and off;
              then per shape at batch 16 kernel, plain and K1-in-bf16 times
              (CUDA graph of 20 calls between events) beside the bound
              (int8 operations or bytes);
  6. serve_q8 (and serve_fp8) the calibrated model of phase 4 written by
              io.save_inference_model and served by ServingEngine(dir,
              quantize="int8"): quant_report of 54 weights, each bucket
              warmed up and captured as in slice (per eager bucket run
              K11 42 and K1 10 launches, Q1 44, with the quant hits and
              fallbacks of the reference's routing and no filter copied),
              the 12 requests replayed (from their trace K11 42, K1 10,
              Q1 44 a bucket run), output
              checks, one request op by op against the CPU plain path in
              O3 on the card's own inputs to each op (the quantized
              windows bitwise), one request per bucket against it end to
              end, the O3-vs-O2 distance, p50 and img/s beside O2's, the
              graphed request against the eager one in turns, one
              profiled batch-16 replay (K11's and the activation-quantize
              passes' shares of the device time); then the same model
              served by ServingEngine(dir, quantize="fp8"): the same
              report, per bucket run K1 52 launches and K11 none (the
              convs count the quant gate's "mode" 42 and "kernel" 11), the
              fc's fp8 GEMM with Q1's rows and dequantize (the replays'
              trace: K1 52, Q1 2), no filter copied, one request per
              bucket against the CPU plain path in fp8, p50 per bucket
              beside O2's, graphed against eager in turns, one profiled
              replay;
 6b. serve_load  the calibrated O2 model behind DynamicBatcher at
              bench.py main_serving's defaults (bucket_ladder(16),
              max_delay_ms 3, max_queue_depth 32, rows cycling 1-4): every
              bucket warmed and captured, a normal phase of run_load at 4
              clients x 16 requests, an overload phase at 8 x 16 with a 50
              ms deadline, then a profiled normal phase whose trace counts
              the replays' K1 launches (52 a bucket run); each phase's
              p50/p99/qps/shed/goodput/bucket hits and telemetry p50/p99,
              the SLO burn, the engine's and the batcher's stats(); the
              normal phase's goodput 1.0, no capture during the load, every
              accepted request's rows finite softmax rows within
              LOGIT_RTOL of the same rows served alone;
  7. kernel_train  K2-K6 (conv grad input, conv grad filter, conv +
              statistics, bn apply, bn + act) against their plain versions
              at every distinct shape ResNet-50 training gives them at
              batch 32, each run twice and bitwise repeatable, then timed
              per shape (CUDA graph of 20 calls between CUDA events) beside
              the bound (K6 also beside the floor of a design that reads x
              twice from device memory), the plain version and one PyTorch
              call that computes the same function where there is one and,
              with --parent, K6 also beside the older checkout's K6 (its
              Triton kernels), in turns;
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
 8b. train_feeder  ResNet-50 O2 with 102 classes trained from the flowers
              surrogate through the input pipeline: reader.shuffle(512) ->
              batch(32, drop_last) -> DataFeeder.feed ->
              DoubleBufferedFeeder(capacity 2, window_prefetch 2; pinned
              staging, a copy stream) -> Executor.run_steps(K=4), one
              warm-up and three timed windows inside one pass, each step
              a replay of the step's CUDA graph: per-step time and img/s,
              the consumer's wait in next_window, peak memory, the warm-up
              window's eager step and capture launching 52/52/52/52/1 each
              with the two stem fallbacks, the timed windows' wrappers
              launching nothing (replays), every window on the card bit
              for bit the host's batches, the loss finite and its last
              timed window's mean below the first timed window's; the
              next pass's first two windows profiled (the share of the
              host-to-device copies of the pass's other windows that
              overlaps the first one's kernels; the busy share of the wall
              less the wait for the window; the launches per step from
              their traces, held to 52/52/52/52/1); run_steps(K=4) on an
              Executor of its own bit for bit four run() replays from the
              same state and batches, no tensor shared (losses, parameters,
              velocities, statistics);
 8c. book     the five book chapters (fit_a_line, recognize_digits mlp and
              conv, image_classification[resnet], word2vec) on the card at
              their reference tests' budgets and thresholds, with the
              inference round trip; the conv chapters' K1-K6 launches and
              fallbacks by reason;
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
              time); the wrappers' host time per call; the
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
              return_logits=True) in O2, fetching the logits: each bucket
              warmed up and captured (first replay bitwise the eager run),
              6 replayed requests of 1-8 rows: K7 launches from their
              trace held to 4 per bucket run, one request against the CPU
              plain path; then p50 per bucket, graphed against eager in
              turns, over 7 requests that fill it; the host's time on the
              logits (the copy of a replay's rows, then numpy) per bucket;
              one profiled bucket-8 replay;
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
              with --parent, the f32 K10 beside the older checkout's (its
              tile walk), in turns, at [1, 2048, 8, 64] and [1, 2048, 4,
              128];
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
 14. train_graph  the four training paths above (ResNet-50 O2 at batch
              32, the LM O2 at batch 8 x T 2048, the f32 LM at batch 1,
              the ring LM at T 32768) as CUDA graphs, Executor.run's
              default on the card (the earlier training phases pass
              use_jit=False; train_feeder and book run graphed): from one
              startup state on two scopes, the warm-up, capture and first
              replay bitwise the eager steps, then 8 graphed and 8 eager
              steps in turns, the eager launches per step held to the
              path's counts and the replays' wrappers launching nothing,
              no step eager but by use_jit=False, both scopes bitwise
              again and sharing no tensor, the generic grads' re-runs per
              step by op type, p50, busy share (one profiled step each;
              the replay's launches counted from its trace and held to
              the path's counts) and the memory a step needs beyond the
              scope's state; for ResNet the memory a second signature
              (batch 16) adds on the same Executor;
 15. kernel_q1  Q1 (the fused quantize pass and dequantize epilogue,
              csrc/quantize.cu) in every form the O3 paths launch, at
              their shapes: one O3 training step of ResNet-50 (batch 32)
              and of the LM in int8 and in fp8, the serving fc at each
              bucket in int8 and fp8, the fold's filters and admission's
              f32 weights; per tensor, per filter, per row, per column,
              dequantize (int32 and f32 results); each twice bitwise and
              bitwise its plain version (the largest difference is the
              kernel row's max_abs_err), then timed (CUDA graph of 20
              calls between events) beside its plain version and the
              bytes bound;
 16. train_q8  AMP O3 training, graphed, at full width: ResNet-50 int8 at
              batch 32 (Momentum), the LM int8 and fp8 at batch 8 x T 2048
              (Adam): warm-up, capture and replay bitwise the eager steps;
              the eager steps' launches held by the wrappers (ResNet:
              K11 42, K1 10, K2/K3 52/52, K4/K5 0, K6 53, Q1 87, filter
              copies only K2's; LM: K7-K9 4/4/4, Q1 3 per `mul`); the quant
              hits and fallbacks by reason; the generic grads' re-runs
              equal to the O2 twin's; the losses finite and lower after
              five steps; the O3 and O2 graphed steps in turns (p50, busy
              share of one profiled replay each, the replay's launches
              counted from its trace, the memory a step needs); a step at
              batch 4 (ResNet) or 1 (LM) op by op against the CPU plain
              path;
 17. kernel_s1  S1 (the sparse optimizer apply, csrc/sparse_apply.cu) in
              every form (sgd, momentum, Nesterov, Adam) at every distinct
              shape of the sparse paths (K 6656 uniform ids into 1M and 4M
              rows, zipf ids remapped into the 87381-row slab): twice
              bitwise, against its plain version bitwise where no run of
              equal rows exceeds eight and within S1_RTOL otherwise, rows
              outside the gradient untouched; Adam timed (the wrapper and
              S1 alone in a CUDA graph of 20 calls, the plain version
              eagerly) beside the bytes bound;
 18. train_dlrm  bench.py's `embedding` family at its defaults (1M x 64
              f32 table row-sharded on a one-card fsdp mesh, 26 slots,
              batch 256, MLP 1664-256-64-2, Adam 1e-3): a batch-16 step op
              by op against the CPU port; graphed steps bitwise the eager
              ones on one repeated batch, S1 once a step, the table and
              its moments advancing in place (never copied in), the loss
              falling, no densify fallback; p50 and busy share of each;
              the memory a step needs beyond the state and its memory
              copies at 1M and 4M rows, not growing;
 19. train_emb_cache  the same model from the hot-row cache (64 MiB budget:
              87381 slab rows), zipf-1.3 ids through
              DoubleBufferedFeeder(window_prefetch=2, sparse_slots) and
              run_steps(K=8), the next window prefetched behind the
              current one: the steady hit rate against the zipf coverage
              of the slab, the prefetch overlap, the flush bytes a step;
              the flushed tables against an uncached run of the same
              windows;
 20. serve_dlrm  bench.py's `dlrm` serving model (100000 x 32, 26 slots,
              max_batch 16) through bucket graphs, plain and with a 4 MiB
              read-only cache: first replays bitwise the eager runs, the
              two engines' answers bitwise alike, against the CPU port,
              p50 per bucket graphed against eager in turns;
 21. result   the kernel table as one JSON line, the card line, then
              {"ok": true, "device": {...}} as the last line.

Every phase is fatal: a failure raises and the script exits non-zero
without printing a result. Run from the root of a checkout:

    python3 chip_smoke.py [--report PATH] [--parent DIR]

`--report` also writes the full per-shape measurements as JSON. `--parent`
names an older checkout (e.g. the parent commit unpacked by `git archive`)
whose K6 (the Triton kernels of `ops/bn_cuda.py`, loaded from that file)
and f32 K10 (the tile walk `flash_walk_fwd_block` of
`csrc/flash_attn_walk.cu`, built from its sources) are timed beside this
tree's in the same process, in turns, as their "before".
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

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
# a training step's kernel counters, each with a test on the full name of
# a profiler event: how the launches of a CUDA graph's replay are counted
# (a replay runs no Python, so the wrappers' counters never see it). K1
# and K2 are one kernel without statistics; a training step launches no
# K1 (held on its eager steps), so those events are K2's
TRACE_KERNELS = {
    "conv.dgrad_launches": r"conv2d_fwd_kernel<[^>]*\bfalse>",
    "conv.stats_launches": r"conv2d_fwd_kernel<[^>]*\btrue>",
    "conv.wgrad_launches": r"conv2d_wgrad_kernel<",
    "bn.apply_launches": r"_bn_apply_body",
    "bn.act_launches": r"bn_act_kernel",
    "attn.launches": r"flash_fwd_kernel<[^>]*\btrue>",
    "attn.block_launches": r"flash_fwd_kernel<[^>]*\bfalse>",
    "attn.dq_launches": r"flash_dq_kernel<",
    "attn.dkv_launches": r"flash_dkv_kernel<",
    "attn.f32_launches": r"\bfwd_tf32_kernel<[^>]*\btrue>",
    "attn.f32_block_launches": r"\bfwd_tf32_kernel<[^>]*\bfalse>",
    "attn.f32_dq_launches": r"\bdq_tf32_kernel<",
    "attn.f32_dkv_launches": r"\bdkv_tf32_kernel<",
    "conv.q8_launches": r"conv2d_fwd_q8_kernel<",
    # Q1: the one kernel of each form that runs once a call
    "q1.total": r"q8_tensor_kernel|quant_rows_kernel|quant_cols_kernel"
                r"|dequant_kernel",
    "sparse.launches": r"sparse_apply_kernel<",
}


def _trace_launches(events) -> dict:
    """Kernel counter -> the events of its kernel among a profile's CUDA
    `events` (TRACE_KERNELS)."""
    import re
    return {k: sum(1 for e in events if re.search(pat, e.name))
            for k, pat in TRACE_KERNELS.items()}


def _raw_trace_launches(prof) -> dict:
    """_trace_launches over the profiler's raw device records (kineto's,
    before torch turns them into events), or {} where torch keeps none:
    printed beside the events' counts when the two would tell a lost
    record in the profiler's post-processing from one lost on the card."""
    import re
    from torch.autograd import DeviceType
    raw = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if raw is None:
        return {}
    names = [e.name() for e in raw.events()
             if e.device_type() == DeviceType.CUDA]
    return {k: sum(1 for n in names if re.search(pat, n))
            for k, pat in TRACE_KERNELS.items()}
# idle seconds the card keeps at each end of a profiler window, inside it:
# kineto drops a device record whose timestamps, converted from the card's
# clock to the host's, fall outside the window (libkineto's `outOfRange`),
# so with the clocks apart the first kernels of work launched as the window
# opens are lost, in every window while the offset lasts
PROFILE_MARGIN_S = 0.05
# each window's least launch lead (`_launch_lead_us`), in the order taken
LAUNCH_LEADS_US = []


@contextlib.contextmanager
def _profiled():
    """torch.profiler's CPU and CUDA activity over the body, the card
    synchronized and then idle for PROFILE_MARGIN_S at both ends of the
    window. Records the window's launch lead in LAUNCH_LEADS_US."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
    LAUNCH_LEADS_US.append(_launch_lead_us(prof))


def _launch_lead_us(prof):
    """The least time from a CUDA runtime call's start to the start of a
    device record it launched, over the profiler's raw records (None where
    there is no such pair): below zero, the card's timestamps, as the
    profiler converts them, run behind the host's by at least as much."""
    from torch.autograd import DeviceType
    raw = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if raw is None:
        return None
    calls, leads = {}, []
    events = list(raw.events())
    for e in events:
        if e.device_type() == DeviceType.CPU and e.name().startswith("cuda"):
            calls[e.correlation_id()] = e.start_ns()
    for e in events:
        if e.device_type() == DeviceType.CUDA and e.correlation_id() in calls:
            leads.append((e.start_ns() - calls[e.correlation_id()]) / 1e3)
    return min(leads) if leads else None


@contextlib.contextmanager
def _kept_graphs():
    """The Executor's CUDA graphs captured meanwhile keep their nodes
    (executor.capture_graph(keep=True)), for _graph_launches to read."""
    import functools
    from paddle_tpu_torch import executor as E
    capture = E.capture_graph
    E.capture_graph = functools.partial(capture, keep=True)
    try:
        yield
    finally:
        E.capture_graph = capture


@contextlib.contextmanager
def _captures_uncounted(counters):
    """A CUDA graph capture records its launches and runs none: the counts
    the kernel wrappers of `counters` add while the Executor captures are
    taken back, so the counts hold only launches that ran."""
    from paddle_tpu_torch import executor as E
    capture = E.capture_graph

    def uncounted(*args, **kwargs):
        before = dict(counters.launches)
        try:
            return capture(*args, **kwargs)
        finally:
            counters.launches.clear()
            counters.launches.update(before)
    E.capture_graph = uncounted
    try:
        yield
    finally:
        E.capture_graph = capture


def _graph_launches(graph) -> dict:
    """Kernel counter -> the kernel nodes of a CUDA graph that kept its
    nodes (_kept_graphs) whose function TRACE_KERNELS names: what every
    replay of the graph launches, read from its DOT dump (written under the
    checkout's build/, read, removed)."""
    import warnings
    path = Path(__file__).resolve().parent / "build" / f"graph-{os.getpid()}.dot"
    path.parent.mkdir(exist_ok=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # torch's "DEBUG: calling ..."
        graph.debug_dump(str(path))
    try:
        return _dot_launches(path.read_text())
    finally:
        path.unlink(missing_ok=True)


def _dot_launches(text) -> dict:
    """_trace_launches over the kernel nodes of a CUDA graph's verbose DOT
    dump (cudaGraphDebugDotPrint), whose label gives each kernel node's
    mangled function name before its `<<<grid,block,smem>>>`."""
    import re
    import torch
    names = [torch._C._demangle(m) for m in re.findall(
        r"\{KERNEL\s*\|\s*\{ID \| [^|]*\| (\S+?)\\<\\<\\<", text)]
    return {k: sum(1 for n in names if re.search(pat, n))
            for k, pat in TRACE_KERNELS.items()}


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

# training from the input pipeline (phase train_feeder): ResNet-50 O2 with
# 102 classes on the flowers surrogate (512 training samples, 3x224x224),
# reader.shuffle(buf_size=512) -> batch(32, drop_last) -> DataFeeder.feed
# -> DoubleBufferedFeeder(capacity 2, window_prefetch 2) ->
# Executor.run_steps(K=4): one warm-up window, then FEED_WINDOWS timed, all
# inside one pass of 16 batches
FEED_CLASSES = 102
FEED_SHUFFLE = 512
FEED_K = 4
FEED_WINDOWS = 3
FEED_CAPACITY, FEED_PREFETCH = 2, 2
FEED_SEED = SEED + 11               # Python's `random`, which shuffle draws from

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


def parent_bn_cuda(parent):
    """The older checkout's `ops/bn_cuda.py` (K5 and K6 in Triton; it
    imports only torch and, when it launches, triton), loaded from its file
    under a private name: the "before" of K6."""
    import importlib.util
    path = Path(parent).resolve() / "paddle_tpu_torch" / "ops" / "bn_cuda.py"
    spec = importlib.util.spec_from_file_location("_parent_bn_cuda", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod        # its dataclasses look themselves up
    spec.loader.exec_module(mod)
    return mod


def _in_turns(new, old, reps=20):
    """Device ms of `new` and `old` timed in turns (new, old, old, new; a
    CUDA graph of `reps` calls each): (new ms, old ms, the four times)."""
    turns = [_device_ms(fn, reps=reps) for fn in (new, old, old, new)]
    return (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2, turns


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
    # warm-up: each bucket's first call warms up, captures and replays its
    # graph, the replay bitwise the eager run (the wrappers count the eager
    # reference, the warm-up and the capture: three bucket runs each)
    conv_cuda.COUNTERS.reset()
    warm_s, pool_gb = _warm_buckets(engine, "img", requests[0], "slice")
    fallbacks = dict(conv_cuda.COUNTERS.fallbacks)
    hits = dict(conv_cuda.COUNTERS.hits)
    warm = conv_cuda.COUNTERS.launches
    if warm != 3 * eligible * len(BUCKETS) or conv_cuda.COUNTERS.filter_copies:
        raise RuntimeError(f"the warm-up launched K1 {warm} times (expected "
                           f"3 x {eligible} x {len(BUCKETS)} buckets) and "
                           f"copied {conv_cuda.COUNTERS.filter_copies} "
                           f"filters: the fold stores each as an OIHW view "
                           f"of OHWI memory")
    print(f"slice: warm-up and capture per bucket (s) "
          + ", ".join(f"{b}: {s:.2f}" for b, s in warm_s.items())
          + f"; first replays bitwise the eager runs; the graphs hold "
            f"{pool_gb:.3f} GB of device memory", flush=True)

    conv_cuda.COUNTERS.reset()
    misses = engine.cache_misses
    outs, lat = [], {b: [] for b in BUCKETS}
    t_window = time.perf_counter()
    for req in requests:
        t0 = time.perf_counter()
        out = engine.infer({"img": req})       # ends in a device->host copy
        lat[engine.bucket_for(req.shape[0])].append(time.perf_counter() - t0)
        outs.append(out)
    window_s = time.perf_counter() - t_window
    if conv_cuda.COUNTERS.launches or engine.cache_misses != misses:
        raise RuntimeError(f"the replayed requests called a K1 wrapper "
                           f"({conv_cuda.COUNTERS.launches}) or captured "
                           f"({engine.cache_misses - misses})")

    for req, (out, _) in zip(requests, outs):
        if out.shape != (req.shape[0], 1000):
            raise RuntimeError(f"output shape {out.shape} for {req.shape}")
        if not np.isfinite(out).all():
            raise RuntimeError("non-finite softmax output")
        sums = out.astype(np.float64).sum(axis=1)
        if np.abs(sums - 1.0).max() > 2e-2:
            raise RuntimeError(f"softmax rows sum to {sums}")
    launches = _trace_replays(engine, "img", requests, {"K1": eligible},
                              "slice")["K1"]
    print(f"K1 launches {launches} = {eligible} eligible convs x "
          f"{len(requests)} replayed bucket runs (from their trace); "
          f"lowerings routed to K1 in the warm-up {hits}; fallbacks by "
          f"(op, reason) {fallbacks}", flush=True)

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
    full = {b: requests[REQUEST_SIZES.index(b)] for b in BUCKETS}
    turns = _serve_in_turns(engine, "img", full, "slice")
    profile = _profile_request(engine, requests[REQUEST_SIZES.index(top)],
                               p50[engine.bucket_for(top)],
                               {K1_KERNEL: eligible}, card)
    print(f"the profiled request (a replay): {profile['device_copies']} "
          f"device copies ({profile['device_copy_ms']:.3f} ms)", flush=True)
    report["slice"] = {"p50_ms": p50, "latencies_s": lat,
                       "img_per_s": ips, "window_s": window_s,
                       "launches": launches, "warmup_s": warm_s,
                       "graph_gb": pool_gb, "in_turns_p50_ms": turns,
                       "eligible_convs": eligible, "fallbacks": {
                           f"{k[0]}:{k[1]}": v for k, v in fallbacks.items()},
                       "agreement": agreement, "card": card,
                       "profile": profile}
    return launches, {"scope": scope, "main": main, "fetch": [prob, logits],
                      "requests": requests, "outs": outs, "p50_ms": p50,
                      "img_per_s": ips, "full": full, "eligible": eligible}


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


# Serving through one CUDA graph per bucket (ServingEngine on the card): a
# bucket's first call warms up, captures and replays; the first replay is
# held bitwise to the eager run of the same prepared program on the same
# padded request (_eager_request: the engine's path before its graphs). A
# replay calls no kernel wrapper, so the serving paths' launches are
# counted from a profile of the replayed requests (SERVE_TRACE: kernel ->
# TRACE_KERNELS counter; serving runs no K2, so the K1-without-statistics
# events are K1's).
SERVE_TURNS = 7                     # graphed and eager requests in turns, per bucket
SERVE_TRACE = {"K1": "conv.dgrad_launches", "K11": "conv.q8_launches",
               "Q1": "q1.total", "K7": "attn.launches"}
# Q1's per-tensor form, the activation-quantize passes of the quantized
# convs: found by kernel name in a replay, where the quant:act ranges that
# mark them in an eager request do not exist
ACT_KERNELS = ("q8_partial_kernel", "q8_tensor_kernel")


def _eager_request(engine, feed):
    """One request the way the engine served it before its bucket graphs:
    its ids remapped by the engine's hot-row cache, if any, padded on the
    host, copied to the card from pageable memory, the prepared program
    run eagerly, the valid rows copied back."""
    import torch
    from paddle_tpu_torch.executor import to_numpy
    from paddle_tpu_torch.serving.engine import _pad_rows
    n = next(iter(feed.values())).shape[0]
    b = engine.bucket_for(n)
    cache = getattr(engine, "_emb_cache", None)
    if cache is not None:               # ids -> the slab's slots, as served
        feed = cache.prepare_feed(feed)
    padded = {k: torch.from_numpy(_pad_rows(np.ascontiguousarray(
        v, dtype=engine._feed_meta[k][1]), b)).to(engine.device)
        for k, v in feed.items()}
    return [to_numpy(f[:n]) for f in engine._prepared.run(padded,
                                                          engine._state)]


def _bitwise(a, b) -> bool:
    return len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


def _warm_buckets(engine, key, row, what):
    """Warm up and capture every bucket of `engine` on a full-bucket request
    of `row` repeated: the engine's first answer of each bucket (its first
    replay) bitwise _eager_request's on the same request, or raise.
    Returns (seconds each bucket's first call took, the device memory the
    graphs hold: pool and workspaces, in GB)."""
    reserved0 = _settled_reserved()
    took = {}
    for b in engine.buckets:
        feed = {key: row[:1].repeat(b, axis=0)}
        want = _eager_request(engine, feed)
        misses = engine.cache_misses
        t0 = time.perf_counter()
        got = engine.infer(feed)
        took[b] = time.perf_counter() - t0
        if engine.cache_misses != misses + 1 or not _bitwise(got, want):
            raise RuntimeError(f"{what}: bucket {b}'s first replay is not "
                               f"bitwise its eager warm-up (or it was no "
                               f"miss)")
    return took, (_settled_reserved() - reserved0) / 1e9


def _serve_in_turns(engine, key, full, what, turns=SERVE_TURNS):
    """p50 per bucket (ms, host clock, the answer on the host) of the
    graphed request (engine.infer) and the eager one (_eager_request), in
    turns, on the full-bucket requests `full` (bucket -> array); each
    turn's two answers bitwise equal."""
    out = {}
    for b, req in full.items():
        feed = {key: req}
        t = {"graph": [], "eager": []}
        for _ in range(turns):
            res = {}
            for mode, fn in (("graph", engine.infer),
                             ("eager", lambda f: _eager_request(engine, f))):
                t0 = time.perf_counter()
                res[mode] = fn(feed)
                t[mode].append((time.perf_counter() - t0) * 1e3)
            if not _bitwise(res["graph"], res["eager"]):
                raise RuntimeError(f"{what}: a graphed bucket-{b} request "
                                   f"differs from the eager one")
        out[b] = {m: float(np.median(v)) for m, v in t.items()}
    print(f"{what}: p50 per bucket, graphed against eager in turns ({turns} "
          f"each, ms, host clock, {_card_line()}): " + ", ".join(
              f"bucket {b}: {v['graph']:.2f} vs {v['eager']:.2f} "
              f"({v['eager'] / v['graph']:.2f}x)" for b, v in out.items()),
          flush=True)
    return out


def _trace_replays(engine, key, requests, per_run, what, attempts=3):
    """The replayed requests' launches, counted from one profile of them
    (SERVE_TRACE) and held to `per_run` (kernel -> launches a bucket run;
    the others none) times the requests. The profiler now and then loses a
    window's CUDA activity, so a pass whose counts differ is profiled
    again, up to `attempts` times; then this raises. Returns the counts."""
    from torch.autograd import DeviceType
    want = {k: per_run.get(k, 0) * len(requests) for k in SERVE_TRACE}
    misses = engine.cache_misses
    for attempt in range(1, attempts + 1):
        with _profiled() as prof:
            for req in requests:
                engine.infer({key: req})
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA and not _is_span(e)]
        traced = _trace_launches(events)
        got = {k: traced[c] for k, c in SERVE_TRACE.items()}
        if got == want:
            break
        print(f"{what}: trace attempt {attempt}: launches {got}, expected "
              f"{want}; launch lead {LAUNCH_LEADS_US[-1]} us", flush=True)
    else:
        raise RuntimeError(f"{what}: the replays' traces hold {got} "
                           f"launches, expected {want}")
    if engine.cache_misses != misses:
        raise RuntimeError(f"{what}: a traced request captured a graph")
    return got


def _is_span(event) -> bool:
    return event.name.split(":", 1)[0] in SPANS


def _profile_request(engine, req, p50_ms, expect, card, attempts=3,
                     key="img"):
    """Where one served request's time goes on the device: torch.profiler's
    CUDA activity for one request (a replay of its bucket's graph), as the
    busy share of the unprofiled p50 latency of its bucket (the profiler's
    own host cost inflates the profiled wall time), the hand-written
    kernels' launches and time (`expect`: kernel name -> launches per
    request), the device time of the activation-quantize passes (Q1's
    per-tensor kernels, ACT_KERNELS), and the device time of the torch ops
    that launched the rest (a replay's: the feed's and the fetches'
    copies). The profiler now and then loses a window's CUDA activity, so a
    request whose trace does not hold the expected launches is profiled
    again, up to `attempts` times in all; then this raises."""
    from torch.autograd import DeviceType
    for attempt in range(1, attempts + 1):
        with _profiled() as prof:
            t0 = time.perf_counter()
            engine.infer({key: req})
            wall_ms = (time.perf_counter() - t0) * 1e3
        cuda = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        events = [e for e in cuda if not _is_span(e)]
        kernels = {k: [e.time_range.elapsed_us() / 1e3 for e in events
                       if k in e.name] for k in expect}
        seen = {k: len(v) for k, v in kernels.items()}
        if seen == expect:
            break
        print(f"profile attempt {attempt}: the trace holds {seen} launches, "
              f"expected {expect}; launch lead {LAUNCH_LEADS_US[-1]} us",
              flush=True)
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
    act = [e for e in events if ACT_KERNELS[1] in e.name]
    act_ms = sum(e.time_range.elapsed_us() for e in events
                 if any(k in e.name for k in ACT_KERNELS)) / 1e3
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


def phase_kernel_q8(pt, conv_cuda, resnet, report):
    """K11 against its plain version, bitwise, at CASES and at every
    distinct quantized ResNet-50 conv shape at each bucket's batch, split
    and unsplit; then per shape at batch 16 the kernel's time, the plain
    version's and K1's in bf16 at the same shape (the O2 counterpart),
    beside the bound."""
    import torch
    from paddle_tpu_torch import quant
    gen = torch.Generator().manual_seed(SEED + 7)

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
        ops = conv_cuda.conv_flops(x, wt, s, p, d)
        nbytes = conv_cuda.conv_bytes(x, wt, s, p, d) + 4 * ws[0]   # + dq
        ops_ms, bytes_ms = ops / PEAK_INT8_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
        row = {"x_nhwc": list(xs), "w_oihw": list(ws), "strides": list(s),
               "paddings": list(p), "dilations": list(d), "per_request": n,
               "ms": k_ms, "plain_ms": plain_ms, "k1_bf16_ms": k1_ms,
               "library_ms": None, "bound_ms": max(ops_ms, bytes_ms),
               "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
               "ops": ops, "bytes": nbytes, "max_abs_err": checked[key]}
        rows.append(row)
        print(f"K11 shape x{list(xs)} w{list(ws)} s{list(s)} p{list(p)} "
              f"x{n}/request: kernel {k_ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"K1 bf16 {k1_ms:.4f} ms, bound "
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
    print(f"K11 per batch-{BATCH} request: {total('ms'):.4f} ms, K1 in bf16 "
          f"at the same shapes {total('k1_bf16_ms'):.4f}, bound "
          f"{total('bound_ms'):.4f}", flush=True)
    return {"name": "conv2d_q8", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/conv2d_fwd.cu",
            "replaces": "paddle_tpu/ops/pallas_conv.py:431",
            "max_abs_err": worst, "ms": total("ms"),
            "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
            "bound_by": "operations" if ops_total >= bytes_total else "bytes",
            "library_ms": None, "k1_bf16_ms": total("k1_bf16_ms"),
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
    for anchor, (w_c, b_c, pre_c) in pc.folds.items():
        w_g, b_g, pre_g = pg.folds[anchor]
        if (pre_c is None) != (pre_g is None):
            raise RuntimeError(f"the card and CPU engines quantize different "
                               f"folded filters (op {anchor})")
        real = pre_c is not None
        if not real:        # below the quant gate: the bf16 filter alone
            pre_c = pre_g = (torch.zeros(1, dtype=torch.int8),
                             torch.ones(1))
        (q_c, s_c), (q_g, s_g) = pre_c, pre_g
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
        if real:
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
    from paddle_tpu_torch.ops import quant_cuda
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
        fp8 = (ServingEngine(model_dir, quantize="fp8", buckets=BUCKETS),
               ServingEngine(model_dir, place=pt.CPUPlace(), quantize="fp8",
                             buckets=BUCKETS))
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
    # warm-up and capture, each bucket's first replay bitwise its eager
    # run; the routing is held on what the wrappers count there: the eager
    # reference, the warm-up and the capture, three bucket runs a bucket
    conv_cuda.COUNTERS.reset()
    quant.COUNTERS.reset()
    quant_cuda.COUNTERS.reset()
    warm_s, pool_gb = _warm_buckets(engine, "img", requests[0], "serve_q8")
    runs = 3 * len(BUCKETS)
    counts = {"q8_launches": conv_cuda.COUNTERS.q8_launches,
              "launches": conv_cuda.COUNTERS.launches}
    hits, fallbacks = dict(quant.COUNTERS.hits), dict(quant.COUNTERS.fallbacks)
    conv_fallbacks = dict(conv_cuda.COUNTERS.fallbacks)
    want = ({k: v * runs for k, v in Q8_LAUNCHES.items()},
            {k: v * runs for k, v in Q8_HITS.items()},
            {k: v * runs for k, v in Q8_FALLBACKS.items()},
            {k: v * runs for k, v in Q8_CONV_FALLBACKS.items()})
    copies = conv_cuda.COUNTERS.filter_copies
    print(f"O3 warm-up over {runs} eager bucket runs: K11 launches "
          f"{counts['q8_launches']}, K1 launches {counts['launches']}; quant "
          f"hits {hits}, quant fallbacks {fallbacks}; conv fallbacks "
          f"{conv_fallbacks}; filters copied {copies}; first replays bitwise "
          f"the eager runs; the graphs hold {pool_gb:.3f} GB", flush=True)
    if copies:
        raise RuntimeError(f"the O3 requests copied {copies} filters: the "
                           f"int8 engine's filters are read in place")
    if (counts, hits, fallbacks, conv_fallbacks) != want:
        raise RuntimeError(f"O3 routing {counts} {hits} {fallbacks} "
                           f"{conv_fallbacks}, expected {want}")
    # Q1 per bucket run: each quantized conv's activation, the fc's rows
    # and its product's dequantization (the weights were quantized at
    # admission)
    q1 = dict(quant_cuda.COUNTERS.launches)
    if q1 != {"tensor": Q8_HITS["conv2d"] * runs, "rows": runs,
              "dequant": runs}:
        raise RuntimeError(f"Q1 launches {q1} over {runs} O3 bucket runs")
    conv_cuda.COUNTERS.reset()
    quant_cuda.COUNTERS.reset()
    misses = engine.cache_misses
    outs, lat = [], {b: [] for b in BUCKETS}
    t_window = time.perf_counter()
    for req in requests:
        t0 = time.perf_counter()
        out = engine.infer({"img": req})       # ends in a device->host copy
        lat[engine.bucket_for(req.shape[0])].append(time.perf_counter() - t0)
        outs.append(out)
    window_s = time.perf_counter() - t_window
    if conv_cuda.COUNTERS.launches or conv_cuda.COUNTERS.q8_launches or \
            quant_cuda.COUNTERS.launches or engine.cache_misses != misses:
        raise RuntimeError("the replayed O3 requests called a kernel wrapper "
                           "or captured")
    traced = _trace_replays(engine, "img", requests, {
        "K11": Q8_LAUNCHES["q8_launches"], "K1": Q8_LAUNCHES["launches"],
        "Q1": Q8_HITS["conv2d"] + 2}, "serve_q8")
    counts = {"q8_launches": traced["K11"], "launches": traced["K1"],
              "q1": traced["Q1"]}
    print(f"O3 over {len(requests)} replayed bucket runs (from their trace): "
          f"K11 {traced['K11']}, K1 {traced['K1']}, Q1 {traced['Q1']}",
          flush=True)
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
    print(f"O3 vs O2 on the card, the same {len(requests)} requests: logits "
          f"at most "
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
    turns = _serve_in_turns(engine, "img", served["full"], "serve_q8")
    top = max(REQUEST_SIZES)
    profile = _profile_request(
        engine, requests[REQUEST_SIZES.index(top)], p50[engine.bucket_for(top)],
        {K11_KERNEL: Q8_LAUNCHES["q8_launches"],
         K1_KERNEL: Q8_LAUNCHES["launches"]}, card)
    report["serve_q8"] = {"card": card, "p50_ms": p50, "latencies_s": lat,
                          "warmup_s": warm_s, "graph_gb": pool_gb,
                          "in_turns_p50_ms": turns,
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
    counts["fp8"] = _serve_fp8(conv_cuda, fp8, qr, served, report)
    return counts


# fp8 serving of the same saved model: the fc runs its fp8 GEMM (its
# weight admitted in e4m3, its activation rows quantized per request by
# Q1), every eligible conv K1 with its folded bf16 filter, the quant gate
# counting "mode" for the 42 convs it takes in int8 and "kernel" for the
# eleven below its 128-channel rule (the reference's routing,
# quant.py:180, :482); the report names the same 54 weights (filters in
# int8 whatever the mode).
FP8_LAUNCHES = {"launches": 52, "q8_launches": 0}
FP8_HITS = {"mul": 1}
FP8_FALLBACKS = {("conv2d", "mode"): 42, ("conv2d", "kernel"): 11}
# The served fp8 answer against the CPU plain path in fp8 on the same
# weights, end to end (_compare): the convs are O2's bf16 route (K1 vs the
# plain conv: bf16 roundings of f32 sums in another order), then one e4m3
# quantization of the fc's 2048 inputs, where a flipped bf16 value that
# crosses an e4m3 rounding step moves by a whole step (1/8 to 1/16 of the
# value), and the fp8 GEMM's partial sums (2^-12 of sum |x y|). The bound
# is the int8 path's.
FP8_LOGIT_RTOL = Q8_LOGIT_RTOL


def _serve_fp8(conv_cuda, engines, int8_report, served, report):
    """ServingEngine(dir, quantize="fp8") through the 12 requests: the
    report, the routing per bucket run (FP8_*), no filter copied, the
    outputs finite softmax rows, a repeated request bitwise, one request
    per bucket against the CPU plain path in fp8 (FP8_LOGIT_RTOL), the
    distance from O2, p50 per bucket beside O2's."""
    import numpy as np
    from paddle_tpu_torch import quant
    from paddle_tpu_torch.ops import quant_cuda
    engine, cpu_engine = engines
    qr = engine.quant_report
    if qr != int8_report or cpu_engine.quant_report != qr or \
            any(f[2] is not None for f in engine._prepared.folds.values()):
        raise RuntimeError(f"fp8 quant_report {qr} (int8's {int8_report}), "
                           f"or a fold kept int8 values")
    requests = served["requests"]
    conv_cuda.COUNTERS.reset()
    quant.COUNTERS.reset()
    quant_cuda.COUNTERS.reset()
    warm_s, pool_gb = _warm_buckets(engine, "img", requests[0], "serve_fp8")
    runs = 3 * len(BUCKETS)       # the eager reference, warm-up, capture
    counts = {"launches": conv_cuda.COUNTERS.launches,
              "q8_launches": conv_cuda.COUNTERS.q8_launches}
    hits, fallbacks = dict(quant.COUNTERS.hits), dict(quant.COUNTERS.fallbacks)
    q1 = dict(quant_cuda.COUNTERS.launches)
    copies = conv_cuda.COUNTERS.filter_copies
    print(f"fp8 warm-up over {runs} eager bucket runs: K1 launches "
          f"{counts['launches']}, K11 {counts['q8_launches']}; quant hits "
          f"{hits}, fallbacks {fallbacks}; Q1 launches {q1}; filters copied "
          f"{copies}; first replays bitwise the eager runs; the graphs hold "
          f"{pool_gb:.3f} GB", flush=True)
    want = ({k: v * runs for k, v in FP8_LAUNCHES.items()},
            {k: v * runs for k, v in FP8_HITS.items()},
            {k: v * runs for k, v in FP8_FALLBACKS.items()},
            {"rows": runs, "dequant": runs})
    if (counts, hits, fallbacks, q1) != want or copies:
        raise RuntimeError(f"fp8 routing {counts} {hits} {fallbacks} {q1}, "
                           f"{copies} filters copied; expected {want}")
    misses = engine.cache_misses
    outs, lat = [], {b: [] for b in BUCKETS}
    for req in requests:
        t0 = time.perf_counter()
        outs.append(engine.infer({"img": req}))
        lat[engine.bucket_for(req.shape[0])].append(time.perf_counter() - t0)
    if engine.cache_misses != misses:
        raise RuntimeError("fp8: a replayed request captured")
    traced = _trace_replays(engine, "img", requests, {
        "K1": FP8_LAUNCHES["launches"], "Q1": 2}, "serve_fp8")
    print(f"fp8 over {len(requests)} replayed bucket runs (from their "
          f"trace): K1 {traced['K1']}, Q1 {traced['Q1']}, K11 "
          f"{traced['K11']}", flush=True)
    for req, (out, _) in zip(requests, outs):
        sums = out.astype(np.float64).sum(axis=1)
        if out.shape != (req.shape[0], 1000) or not np.isfinite(out).all() \
                or np.abs(sums - 1.0).max() > 2e-2:
            raise RuntimeError(f"fp8 output {out.shape} for {req.shape}, "
                               f"not finite or not softmax rows")
    again = engine.infer({"img": requests[0]})
    if not all(np.array_equal(a, b) for a, b in zip(again, outs[0])):
        raise RuntimeError("fp8: a repeated request gave a different answer")
    agreement, failures = [], []
    for i in COMPARED:
        result, failed = _compare(cpu_engine.infer({"img": requests[i]}),
                                  outs[i], "the CPU plain path in fp8",
                                  FP8_LOGIT_RTOL, served="fp8")
        agreement.append(result)
        failures += failed
    if failures:
        raise RuntimeError("the fp8 answer disagrees with the CPU plain "
                           "path: " + "; ".join(failures))
    vs_o2 = max(float((np.abs(lq.astype(np.float64) - l2).max(axis=1)
                       / np.abs(l2).max(axis=1)).max())
                for (_, lq), (_, l2) in zip(outs, served["outs"]))
    card = _card_line()
    p50 = {b: float(np.median(v)) * 1e3 for b, v in lat.items() if v}
    print(f"fp8 vs O2 on the card: logits at most {vs_o2:.3g} of the row's "
          f"largest |logit| apart; fp8 p50 per bucket (ms, host clock, "
          f"{card}): " + ", ".join(
              f"bucket {b}: {v:.2f} (O2 {served['p50_ms'][b]:.2f})"
              for b, v in p50.items()), flush=True)
    turns = _serve_in_turns(engine, "img", served["full"], "serve_fp8")
    top = max(REQUEST_SIZES)
    profile = _profile_request(
        engine, requests[REQUEST_SIZES.index(top)], p50[engine.bucket_for(top)],
        {K1_KERNEL: FP8_LAUNCHES["launches"]}, card)
    report["serve_fp8"] = {"card": card, "p50_ms": p50, "latencies_s": lat,
                           "warmup_s": warm_s, "graph_gb": pool_gb,
                           "in_turns_p50_ms": turns, "profile": profile,
                           "warmup_launches": counts, "hits": hits,
                           "fallbacks": {f"{k[0]}:{k[1]}": v
                                         for k, v in fallbacks.items()},
                           "warmup_q1_launches": q1,
                           "replay_traced_launches": traced,
                           "agreement": agreement,
                           "vs_o2_logit_rel_diff": vs_o2}
    return {"launches": traced["K1"], "q1": traced["Q1"]}


# serving under load (phase serve_load): the calibrated ResNet-50 O2 behind
# DynamicBatcher at bench.py main_serving's defaults (bench.py:1349-1353,
# 1404-1432): bucket_ladder(16), max_delay_ms 3, max_queue_depth 32,
# request rows cycling through (1, 2, 3, 4), a normal phase of 4 clients x
# 16 requests, then an overload phase of 8 clients x 16 requests with a 50
# ms deadline (bench.py's max(8 x delay, 50)); every bucket warmed and
# captured before the timed phases. Then one more normal phase under the
# profiler, whose trace counts the replays' K1 launches (52 a bucket run).
LOAD = {"max_batch": 16, "max_delay_ms": 3.0, "max_queue_depth": 32,
        "rows": (1, 2, 3, 4), "clients": 4, "requests": 16,
        "deadline_ms": 50.0}
LOAD_POOL = 64                      # distinct images the requests slice


def _load_feeds(seed=SEED + 12):
    """make_feed(client, request) for run_load: rows cycling through
    LOAD["rows"], sliced from one pool of images made in bulk (the data is
    set-up, not load), so a request's content is fixed by its indices."""
    pool = np.random.default_rng(seed).standard_normal(
        (LOAD_POOL, 3, 224, 224)).astype(np.float32)
    rows = LOAD["rows"]

    def make_feed(ci, ri):
        n = rows[(ci + ri) % len(rows)]
        at = (ci * LOAD["requests"] + ri) % (LOAD_POOL - n)
        return {"img": pool[at:at + n]}
    return make_feed, pool


def _recording(batcher):
    """Wrap `batcher.submit` to keep each accepted request's (feed,
    future); sheds raise before anything is kept."""
    import threading
    kept, lock, submit = [], threading.Lock(), batcher.submit

    def recorded(feed, deadline_ms=None):
        fut = submit(feed, deadline_ms=deadline_ms)
        with lock:
            kept.append((feed, fut))
        return fut
    batcher.submit = recorded
    return kept


def _phase_line(p):
    return (f"{p['phase']} {p['clients']} clients x "
            f"{p['requests'] // max(p['clients'], 1)}: p50 "
            f"{p['p50_ms']:.2f} ms, p99 {p['p99_ms']:.2f} ms, qps "
            f"{p['qps']:.1f}, shed {p['shed_fraction']:.3f}, goodput "
            f"{p['goodput_fraction']:.3f}, bucket hits {p['bucket_hits']}, "
            f"telemetry p50/p99 {p['telemetry_p50_ms']:.2f}/"
            f"{p['telemetry_p99_ms']:.2f} ms, timeouts {p['timeouts']}, "
            f"errors {p['errors']}, wall {p['wall_s']:.2f} s")


def phase_serve_load(pt, served, report, attempts=3):
    """ResNet-50 O2 at full width behind DynamicBatcher under concurrent
    clients (LOAD): the normal phase's goodput 1.0 and 0 < p50 <= p99;
    no phase with an engine error or a timed-out future; every accepted
    request's rows finite softmax rows within LOGIT_RTOL of the same rows
    served alone through engine.run_batch after the load (an accepted
    future may hold only a deadline shed); no capture during the timed
    phases; the replays' K1 launches from a profiled phase (profiled again,
    up to `attempts` times in all, while the trace lost launches, as in
    _trace_replays). Returns those launches."""
    import torch
    from torch.autograd import DeviceType
    from paddle_tpu_torch.serving import (DynamicBatcher, ServingEngine,
                                          ServingOverloadError, bucket_ladder,
                                          run_load)
    card = _card_line()
    engine = ServingEngine(served["main"], ["img"], served["fetch"],
                           scope=served["scope"], max_batch=LOAD["max_batch"])
    if engine.buckets != bucket_ladder(LOAD["max_batch"]):
        raise RuntimeError(f"serve_load buckets {engine.buckets}")
    make_feed, pool = _load_feeds()
    t0 = time.perf_counter()
    warm_s, pool_gb = _warm_buckets(engine, "img", pool, "serve_load")
    print(f"serve_load: {len(engine.buckets)} buckets warmed up and captured "
          f"in {time.perf_counter() - t0:.2f} s, first replays bitwise the "
          f"eager runs; the graphs hold {pool_gb:.3f} GB ({card})",
          flush=True)
    misses = engine.cache_misses
    batcher = DynamicBatcher(engine, max_delay_ms=LOAD["max_delay_ms"],
                             max_queue_depth=LOAD["max_queue_depth"])
    kept = _recording(batcher)
    batcher.start()
    try:
        normal = run_load(batcher, make_feed, clients=LOAD["clients"],
                          requests_per_client=LOAD["requests"],
                          label="normal")
        slo_normal = batcher.slo_monitor.report()
        overload = run_load(batcher, make_feed, clients=2 * LOAD["clients"],
                            requests_per_client=LOAD["requests"],
                            deadline_ms=LOAD["deadline_ms"],
                            label="overload")
        slo_over = batcher.slo_monitor.report()
        timed_misses = engine.cache_misses - misses
        eligible = served["eligible"]
        traced = []
        for attempt in range(1, attempts + 1):
            runs0 = dict(engine.bucket_runs)
            with _profiled() as prof:
                traced_phase = run_load(batcher, make_feed,
                                        clients=LOAD["clients"],
                                        requests_per_client=LOAD["requests"],
                                        label="traced")
            torch.cuda.synchronize()
            traced.append(traced_phase)
            runs = sum(engine.bucket_runs.values()) - sum(runs0.values())
            events = [e for e in prof.events()
                      if e.device_type == DeviceType.CUDA and not _is_span(e)]
            launches = _trace_launches(events)[SERVE_TRACE["K1"]]
            if runs and launches == eligible * runs:
                break
            print(f"serve_load: trace attempt {attempt}: {runs} bucket runs "
                  f"replayed {launches} K1 launches, expected {eligible} "
                  f"each; launch lead {LAUNCH_LEADS_US[-1]} us", flush=True)
    finally:
        batcher.stop()
    for p in (normal, overload, *traced):
        print("serve_load " + _phase_line(p), flush=True)
    burn = {"normal": {w: slo_normal["windows"][w]["burn_rate"]
                       for w in ("fast", "slow")},
            "overload": {w: slo_over["windows"][w]["burn_rate"]
                         for w in ("fast", "slow")}}
    print(f"serve_load SLO {slo_over['objective']}: burn fast/slow after the "
          f"normal phase {burn['normal']['fast']:.3f}/"
          f"{burn['normal']['slow']:.3f}, after the overload phase "
          f"{burn['overload']['fast']:.3f}/{burn['overload']['slow']:.3f}",
          flush=True)
    print(f"serve_load engine {engine.stats()}; batcher {batcher.stats()}",
          flush=True)
    per_bucket = {b: n - runs0.get(b, 0) for b, n in
                  engine.bucket_runs.items() if n - runs0.get(b, 0)}
    print(f"serve_load: the profiled phase's bucket runs {per_bucket} "
          f"replayed {launches} K1 launches (trace)", flush=True)

    # every accepted request against the same rows served alone
    worst, checked = 0.0, 0
    for feed, fut in kept:
        exc = fut.exception(timeout=60.0)
        if isinstance(exc, ServingOverloadError) and exc.reason == "deadline":
            continue
        if exc is not None:
            raise RuntimeError(f"serve_load: an accepted request failed "
                               f"({type(exc).__name__}: {exc})") from exc
        prob, lg = fut.result()
        n = feed["img"].shape[0]
        sums = prob.astype(np.float64).sum(axis=1)
        if prob.shape != (n, 1000) or not np.isfinite(prob).all() or \
                not np.isfinite(lg).all() or np.abs(sums - 1.0).max() > 2e-2:
            raise RuntimeError(f"serve_load: an accepted {n}-row request's "
                               f"rows are not finite softmax rows")
        _, alone = engine.run_batch(feed)
        d = np.abs(lg.astype(np.float64) - alone).max(axis=1) / \
            np.abs(alone).max(axis=1)
        worst = max(worst, float(d.max()))
        checked += 1
    print(f"serve_load: {checked} accepted requests' rows within {worst:.3g} "
          f"of the row's largest |logit| of the same rows served alone "
          f"(tol {LOGIT_RTOL})", flush=True)
    failures = [f"the {p['phase']} phase: {p['errors']} engine errors, "
                f"{p['timeouts']} timed-out futures"
                for p in (normal, overload, *traced)
                if p["errors"] or p["timeouts"]]
    if normal["goodput_fraction"] != 1.0 or normal["p50_ms"] is None or \
            not 0.0 < normal["p50_ms"] <= normal["p99_ms"]:
        failures.append(f"normal phase {normal}")
    if worst > LOGIT_RTOL:
        failures.append(f"accepted rows {worst} past {LOGIT_RTOL}")
    if timed_misses or engine.cache_misses != misses:
        failures.append(f"{engine.cache_misses - misses} captures during "
                        f"the load")
    if launches != eligible * runs or not runs:
        failures.append(f"the traced phase's {runs} bucket runs replayed "
                        f"{launches} K1 launches, expected {eligible} each")
    report["serve_load"] = {
        "card": card, "config": LOAD, "warmup_s": warm_s, "graph_gb": pool_gb,
        "normal": normal, "overload": overload, "traced": traced,
        "slo": {"objective": slo_over["objective"], **burn,
                "windows": slo_over["windows"]},
        "engine": engine.stats(), "batcher": batcher.stats(),
        "accepted_checked": checked, "accepted_logit_rel_diff": worst,
        "traced_bucket_runs": runs, "launches": launches}
    if failures:
        raise RuntimeError("serve_load: " + "; ".join(failures))
    engine.close()
    return launches


# --- training: the kernels K2-K6 ------------------------------------------------

def _resnet50_train(pt, resnet, amp=True, class_dim=1000, level="O2"):
    """bench.py's `resnet` training mode through the port's fluid API:
    build_image_classifier (softmax cross entropy, mean, accuracy), Momentum
    0.9 at TRAIN_LR, amp.decorate(level=`level`) (O3: in the mode
    PADDLE_TPU_QUANT_MODE names, int8 by default)."""
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        img = pt.layers.data(name="img", shape=[3, 224, 224], dtype="float32")
        label = pt.layers.data(name="label", shape=[1], dtype="int64")
        avg_cost, _, _ = pt.models.build_image_classifier(
            resnet.resnet50, img, label, class_dim=class_dim)
        opt = pt.optimizer.Momentum(learning_rate=TRAIN_LR, momentum=0.9)
        if amp:
            opt = pt.amp.decorate(opt, level=level)
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


def _bf16_err(got, want, slack=0.0, floor=1e-6):
    """Max abs error of a bf16 output, and raise if past one ulp of the
    plain version's plus `slack` (the f32 tolerance of the sum it rounds)
    and an absolute `floor` (none for K5, which rounds as its plain
    version does)."""
    err = (got.float() - want.float()).abs()
    if (err > _bf16_ulp(want) + slack + floor).any():
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


def phase_kernel_train(pt, conv_cuda, bn_cuda, resnet, report, parent=None):
    """K2-K6 at every distinct ResNet-50 training shape at batch 32: held
    against the plain versions, twice bitwise, then timed; K6 also beside
    the older checkout `parent`'s K6, in turns, when one is given."""
    import torch
    import torch.nn.functional as F
    gen = torch.Generator().manual_seed(SEED + 3)
    before = None if parent is None else parent_bn_cuda(parent)

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
                err = _bf16_err(ybn, rbn, floor=0.0)
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
                omean, ovar = bn_cuda.bn_act_stats_in_order(
                    x, *bn_cuda.launch_plan(x, act))
                if not (torch.equal(bmean, omean) and torch.equal(bvar, ovar)):
                    raise RuntimeError(f"K6 statistics at {shape} are not its "
                                       f"summation order's bit for bit")
                del xf, want, omean, ovar
                fn = lambda: bn_cuda.bn_act(x, scale, bias, 1e-5, act)  # noqa: E731
                plain = lambda: bn_cuda.bn_act_reference(x, scale, bias, 1e-5, act)  # noqa: E731
                lib = lambda: F.batch_norm(x4, None, None, scale, bias, True, 0.0, 1e-5)  # noqa: E731
                nbytes = m * c * 2 + 16 * c + out_bytes
                flops = (7 if act else 6) * m * c
            if act == "relu" and not torch.equal(yact, torch.relu(ybn)):
                raise RuntimeError(f"{kind} yact is not relu(ybn) at {shape}")
            extra, old_ms = {}, None
            if kind == "bn_act" and before is not None:
                # the parent's K6 held to the same rules, then in turns
                pbn, _, pmean, pvar = before.bn_act(x, scale, bias, 1e-5, act)
                _sum_err(pmean, rmean, x.float().abs().mean(0))
                want, _ = bn_cuda.bn_apply_reference(x, scale, bias, pmean,
                                                     pvar, 1e-5)
                _bf16_err(pbn, want)
                del pbn, pmean, pvar, want
                ms, old_ms, turns = _in_turns(
                    fn, lambda: before.bn_act(x, scale, bias, 1e-5, act))
                extra = {"parent_ms": old_ms, "turns": turns}
            else:
                ms = _device_ms(fn)
            rows.append(_row(kind, shape, n, ms, _device_ms(plain),
                             _device_ms(lib), flops, nbytes, err, PEAK_F32_FLOPS))
            rows[-1].update(extra)
            if kind == "bn_act":
                # a design that reads x from device memory twice
                rows[-1]["two_pass_floor_ms"] = \
                    (nbytes + m * c * 2) / PEAK_BYTES * 1e3
            print(f"{kind} {shape} x{n}/step: {rows[-1]['ms']:.4f} ms, plain "
                  f"{rows[-1]['plain_ms']:.4f} ms, F.batch_norm "
                  f"{rows[-1]['library_ms']:.4f} ms, bound "
                  f"{rows[-1]['bound_ms']:.4f} ms"
                  + (f" (two-pass floor {rows[-1]['two_pass_floor_ms']:.4f})"
                     if kind == "bn_act" else "")
                  + ("" if old_ms is None else
                     f", parent tree {old_ms:.4f} ms (in turns new, parent, "
                     f"parent, new: " + ", ".join(f"{t:.4f}" for t in
                                                  extra["turns"]) + ")"),
                  flush=True)
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
            ("bn_act", "cuda", "paddle_tpu_torch/csrc/bn_act.cu",
             "paddle_tpu/ops/fusion.py:697")):
        rs = [r for r in rows if r["kernel"] == name]

        def total(key):
            vals = [r[key] for r in rs]
            return None if None in vals else sum(v * r["per_step"] for v, r in zip(vals, rs))
        peak = PEAK_F32_FLOPS if name.startswith("bn_") else PEAK_BF16_FLOPS
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
        if name == "bn_act":
            kernels[-1]["two_pass_floor_ms"] = total("two_pass_floor_ms")
            if before is not None:
                kernels[-1]["parent_ms"] = total("parent_ms")
        print(f"{name}: {kernels[-1]['ms']:.3f} ms per step over {len(rs)} "
              f"shapes, plain {kernels[-1]['plain_ms']:.3f}, library "
              f"{kernels[-1]['library_ms']}, bound {kernels[-1]['bound_ms']:.3f} "
              f"({kernels[-1]['bound_by']}), max abs err "
              f"{kernels[-1]['max_abs_err']:.3g}", flush=True)
    return kernels


# --- training: the main path ------------------------------------------------------

def _profile_step(exe, main, feed, loss, scope, p50_ms, card, witness,
                  attempts=3, use_jit=None, expect=None, graph=None):
    """The device's busy share of one training step, its time by kernel
    name and its launches by kernel counter (torch.profiler's CUDA
    activity, `_trace_launches`). A trace without a launch of the
    `witness` kernel, (label, test on the event name), or whose launches
    are not `expect`'s (counter -> launches, when given), is profiled
    again: the profiler now and then loses a window's CUDA activity. Past
    `attempts` this raises, with one exception: given the replayed step's
    `graph` (kept, _kept_graphs), `expect` is held first to the graph's
    own kernel nodes, which every replay launches, and a trace that then
    still lacks some of them, and holds nothing beyond them, has lost
    records: that is printed and returned (`lost_records`), not raised."""
    from torch.autograd import DeviceType
    nodes = None
    if graph is not None:
        nodes = _graph_launches(graph)
        off = {k: (nodes[k], v) for k, v in expect.items() if nodes[k] != v}
        if off:
            raise RuntimeError(f"the step's CUDA graph holds other kernel "
                               f"nodes than expected: (graph, expected) {off}")
    lost = {}
    for attempt in range(1, attempts + 1):
        with _profiled() as prof:
            t0 = time.perf_counter()
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                    use_jit=use_jit)
            wall_ms = (time.perf_counter() - t0) * 1e3
        spanned = [e for e in prof.events() if _is_span(e)]
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA and not _is_span(e)]
        launches = _trace_launches(events)
        short = {k: (launches[k], v) for k, v in (expect or {}).items()
                 if launches[k] != v}
        seen = any(witness[1](e.name) for e in events)
        if seen and not short:
            break
        raw = _raw_trace_launches(prof)
        print(f"profile attempt {attempt}: no {witness[0]} launch in the "
              f"trace, or launches (traced, expected) {short}; in the raw "
              f"records { {k: raw.get(k) for k in short} } of "
              f"{len(events)} events; launch lead {LAUNCH_LEADS_US[-1]} us",
              flush=True)
    else:
        lost = {k: v - t for k, (t, v) in short.items()}
        if nodes is None or not seen or min(lost.values()) <= 0:
            raise RuntimeError(f"the profiler saw no {witness[0]} launch in "
                               f"a training step, or launches other than "
                               f"expected: (traced, expected) {short}")
        print(f"the profiler lost records of a replay in all {attempts} "
              f"attempts: (traced, in the graph) {short}; the step's graph "
              f"holds every expected launch ({card})", flush=True)
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
            "launches": launches, "graph_launches": nodes,
            "lost_records": lost,
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


def _on_cpu(v):
    """A CPU copy of a tensor or of a SelectedRows value's rows and values."""
    if hasattr(v, "height"):
        return type(v)(v.rows.cpu(), v.values.cpu(), v.height)
    return v.cpu()


def _lockstep(pt, main, loss, state, feed):
    """One step of `main` on the card with every op and window run again,
    on a CPU copy of the card's inputs to it, on the CPU plain path; each
    float output held to the card's (_hold_outputs). Returns the worst
    relative L2 difference by op type."""
    import torch
    from paddle_tpu_torch.executor import LoweringContext
    from paddle_tpu_torch.ops import fusion
    from paddle_tpu_torch.ops.common import SelectedRowsVal
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
        env_c = {n: _on_cpu(env[n]) for m in members
                 for n in m.input_arg_names
                 if isinstance(env.get(n), (torch.Tensor, SelectedRowsVal))}
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
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                            use_jit=False)[0][0])]
    print(f"warm-up step (Triton compiles K5): {time.perf_counter() - t0:.2f} s, "
          f"loss {losses[0]:.5f}", flush=True)
    conv_cuda.COUNTERS.reset()
    bn_cuda.COUNTERS.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()               # the fetch ends in a device->host copy
        losses.append(float(exe.run(main, feed=feed, fetch_list=[loss],
                                    scope=scope, use_jit=False)[0][0]))
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
        "K4", lambda name: K1_KERNEL in name and "true" in name),
        use_jit=False)

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


# --- training from the input pipeline -----------------------------------------

def _bitwise_scopes(a, b) -> list:
    """Names of the tensors of scope `a` that are not bit for bit `b`'s,
    or that share their storage with `b`'s (then the two runs compared
    would be one)."""
    import torch
    return [n for n, v in a.vars.items() if isinstance(v, torch.Tensor)
            and ((v.numel() and v.data_ptr() == b.vars[n].data_ptr())
                 or not torch.equal(v, b.vars[n]))]


def _scope_from(pt, state):
    scope = pt.Scope()
    for n, v in state.items():
        scope.set_var(n, v.clone())
    return scope


class _Recording:
    """A reader for Executor.run_steps that keeps each window it hands out
    (the tensors on the card), to be held to the host's batches after the
    timed run."""

    def __init__(self, feeder):
        self.feeder = feeder
        self.windows = []

    def next_window(self, k, device=None):
        w = self.feeder.next_window(k, device=device)
        self.windows.append(w)
        return w


def _seeded(reader, seed):
    """`reader` with Python's `random` seeded at the start of each pass, on
    the thread that iterates it (reader.shuffle draws from it)."""
    import random

    def seeded():
        random.seed(seed)
        yield from reader()
    return seeded


def _feeder_chain(pt, seed=FEED_SEED, batch=TRAIN_BATCH):
    """The flowers surrogate, shuffled over FEED_SHUFFLE samples, in
    batches of `batch` with the remainder dropped."""
    return _seeded(pt.batch(pt.reader.shuffle(pt.dataset.flowers.train(),
                                              buf_size=FEED_SHUFFLE),
                            batch, drop_last=True), seed)


def _host_windows(feeder, chain, k):
    """Every whole window of one pass of `chain`, converted by `feeder` and
    stacked on the host: what the card's windows must equal bit for bit."""
    windows, batches = [], []
    for b in chain():
        batches.append(feeder.feed(b))
        if len(batches) == k:
            windows.append({n: np.stack([f[n] for f in batches])
                            for n in batches[0]})
            batches = []
    return windows


def _copy_overlap(events):
    """(ms of host-to-device copies, the share of it that overlaps a kernel)
    from a profile's CUDA events."""
    copies = [(e.time_range.start, e.time_range.end) for e in events
              if "HtoD" in e.name or "Memcpy H" in e.name]
    kernels = sorted((e.time_range.start, e.time_range.end) for e in events
                     if "Memcpy" not in e.name and "Memset" not in e.name)
    merged = []
    for s, t in kernels:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    total = sum(t - s for s, t in copies)
    over = sum(max(0.0, min(t, b) - max(s, a))
               for s, t in copies for a, b in merged)
    return total / 1e3, (over / total if total else None)


def _profile_window(exe, main, reader, loss, scope, card, expect,
                    attempts=3):
    """One run_steps window under torch.profiler: its wall ms, the
    consumer's wait for the window in it, the device's busy ms and share
    of the wall less that wait, the host-to-device copies' ms and the
    share of it that overlaps kernels, and its kernel launches by counter
    (`_trace_launches`). A trace whose launches are not `expect`'s is
    taken again (the profiler now and then loses a window's CUDA
    activity); past `attempts` this raises."""
    from torch.autograd import DeviceType
    from paddle_tpu_torch.reader import pipeline
    for attempt in range(1, attempts + 1):
        wait0 = pipeline.COUNTERS.wait_s
        with _profiled() as prof:
            t0 = time.perf_counter()
            exe.run_steps(main, reader=reader, steps=FEED_K,
                          fetch_list=[loss], scope=scope, fetch_mode="stack")
            wall_ms = (time.perf_counter() - t0) * 1e3
        wait_ms = (pipeline.COUNTERS.wait_s - wait0) * 1e3
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA and not _is_span(e)]
        launches = _trace_launches(events)
        short = {k: (launches[k], v) for k, v in expect.items()
                 if launches[k] != v}
        if not short:
            break
        print(f"profile attempt {attempt}: launches (traced, expected) "
              f"{short}; launch lead {LAUNCH_LEADS_US[-1]} us", flush=True)
    else:
        raise RuntimeError(f"a run_steps window's trace holds other "
                           f"launches than expected: (traced, expected) "
                           f"{short}")
    busy_us, end = 0.0, float("-inf")
    for e in sorted((e for e in events if "Memcpy" not in e.name),
                    key=lambda e: e.time_range.start):
        s, t = e.time_range.start, e.time_range.end
        if t > end:
            busy_us += t - max(s, end)
            end = t
    copy_ms, overlap = _copy_overlap(events)
    return {"wall_ms": wall_ms, "wait_ms": wait_ms, "busy_ms": busy_us / 1e3,
            "busy_share": busy_us / 1e3 / (wall_ms - wait_ms),
            "h2d_copy_ms": copy_ms, "h2d_overlap_share": overlap,
            "launches": {k: launches[k] for k in expect}, "card": card}


def phase_train_feeder(pt, conv_cuda, bn_cuda, resnet, report):
    """ResNet-50 O2 (102 classes) trained on the card from the flowers
    reader through DataFeeder, DoubleBufferedFeeder and run_steps(K=4):
    the warm-up window's launches and fallbacks, the timed windows all
    replays, every device window bitwise the host's, falling loss, step
    time, img/s, the consumer's wait, peak memory, two profiled windows
    (busy share, copy overlap, launches from the traces); then run_steps
    bitwise four run() calls from the same state and batches. Returns the
    kernel launches of the two profiled windows, from their traces."""
    import torch
    from paddle_tpu_torch.reader import pipeline

    main, startup, loss = _resnet50_train(pt, resnet, class_dim=FEED_CLASSES)
    exe = pt.Executor()                        # CUDAPlace(0) by default
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    init = {n: v.clone() for n, v in scope.vars.items()
            if isinstance(v, torch.Tensor)}
    block = main.global_block()
    feeder = pt.DataFeeder([block.var("img"), block.var("label")], exe.place,
                           program=main)
    chain = _feeder_chain(pt)
    card = _card_line()
    t0 = time.perf_counter()
    host = _host_windows(feeder, chain, FEED_K)
    print(f"train_feeder: one pass of the flowers chain on the host, "
          f"{len(host)} windows of {FEED_K} batches of {TRAIN_BATCH} "
          f"({time.perf_counter() - t0:.2f} s)", flush=True)
    if len(host) < 1 + FEED_WINDOWS:
        raise RuntimeError(f"one pass holds {len(host)} windows, fewer than "
                           f"the {1 + FEED_WINDOWS} the phase runs")

    dbf = pipeline.DoubleBufferedFeeder(
        chain, to_feed=feeder.feed, capacity=FEED_CAPACITY,
        window_prefetch=FEED_PREFETCH)
    rec = _Recording(dbf)
    conv_cuda.COUNTERS.reset()
    bn_cuda.COUNTERS.reset()
    t0 = time.perf_counter()
    losses = [exe.run_steps(main, reader=rec, steps=FEED_K, fetch_list=[loss],
                            scope=scope, fetch_mode="stack")[0].ravel()]
    print(f"warm-up window (the shuffle buffer fills, K5 compiles, the "
          f"step's graph is captured): {time.perf_counter() - t0:.2f} s, "
          f"losses {losses[0]}", flush=True)
    # its eager first step and the capture ran the wrappers, its other
    # steps were replays: twice one step's launches and fallbacks
    warm = {k: getattr(c, k) for c, keys in (
        (conv_cuda.COUNTERS, ("dgrad_launches", "wgrad_launches",
                              "stats_launches", "launches")),
        (bn_cuda.COUNTERS, ("apply_launches", "act_launches"))) for k in keys}
    want = {k: 2 * v for k, v in TRAIN_LAUNCHES.items()}
    want["launches"] = 0
    warm_fb = (dict(conv_cuda.COUNTERS.fallbacks),
               dict(bn_cuda.COUNTERS.fallbacks))
    if warm != want or warm_fb != (
            {k: 2 * v for k, v in TRAIN_FALLBACKS.items()}, {}):
        raise RuntimeError(f"train_feeder: the warm-up window's wrappers "
                           f"launched {warm} with fallbacks {warm_fb}, "
                           f"expected {want} and twice {TRAIN_FALLBACKS}")
    conv_cuda.COUNTERS.reset()
    bn_cuda.COUNTERS.reset()
    pipeline.COUNTERS.reset()
    graphs = pt.executor.COUNTERS
    graphs.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(FEED_WINDOWS):
        t0 = time.perf_counter()               # the fetch ends in a device->host copy
        losses.append(exe.run_steps(main, reader=rec, steps=FEED_K,
                                    fetch_list=[loss], scope=scope,
                                    fetch_mode="stack")[0].ravel())
        times.append(time.perf_counter() - t0)
    wait_s = pipeline.COUNTERS.wait_s
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps = FEED_WINDOWS * FEED_K
    # each step of the timed windows a replay of the step's CUDA graph,
    # which calls no kernel wrapper: their launches come from the
    # profiled windows' traces below
    wrapped = {k: getattr(c, k) for c, keys in (
        (conv_cuda.COUNTERS, ("dgrad_launches", "wgrad_launches", "stats_launches",
                              "launches")),
        (bn_cuda.COUNTERS, ("apply_launches", "act_launches"))) for k in keys}
    if graphs.eager or graphs.replays != steps or graphs.captures or \
            any(wrapped.values()) or conv_cuda.COUNTERS.fallbacks or \
            bn_cuda.COUNTERS.fallbacks:
        raise RuntimeError(f"train_feeder: the timed windows' steps are not "
                           f"all replays: {graphs}; wrappers {wrapped}")

    # every window the card ran, bit for bit the host's
    for i, (w, h) in enumerate(zip(rec.windows, host)):
        for n, v in h.items():
            if not torch.equal(w[n].cpu(), torch.from_numpy(v)):
                raise RuntimeError(f"train_feeder: window {i}'s '{n}' on the "
                                   f"card is not the host's batch bit for bit")
    held = len(rec.windows)
    rec.windows.clear()

    per_step_ms = [t / FEED_K * 1e3 for t in times]
    p50 = float(np.median(per_step_ms))
    print(f"ResNet-50 O2 training from the flowers reader, batch {TRAIN_BATCH}, "
          f"run_steps K={FEED_K}: per-step p50 {p50:.1f} ms (windows "
          f"{', '.join(f'{t * 1e3:.1f}' for t in times)} ms), "
          f"{TRAIN_BATCH / (p50 / 1e3):.1f} img/s; consumer wait in "
          f"next_window {wait_s * 1e3:.1f} ms over {FEED_WINDOWS} windows; "
          f"peak memory {peak_gb:.2f} GB; {held} windows bitwise the host's; "
          f"{graphs.replays} graph replays, no eager step ({card})", flush=True)
    print("window losses: " + "; ".join(
        ", ".join(f"{v:.5f}" for v in w) for w in losses), flush=True)
    # falling over the timed windows: from the random start the first few
    # steps drop the loss, which then rises for a few steps while the
    # momentum builds (PERF.md §6), so the warm-up window is no baseline
    flat = np.concatenate(losses)
    if not np.isfinite(flat).all() or not losses[-1].mean() < losses[1].mean():
        raise RuntimeError(f"train_feeder: the loss is not finite and falling "
                           f"over the timed windows (window means, the "
                           f"warm-up's first: "
                           f"{[float(w.mean()) for w in losses]})")

    # the rest of the pass; then the next pass's first window profiled (the
    # window thread stacks and copies the pass's other windows while it
    # computes: their copies' overlap with its kernels), and its second
    # (the busy share with no wait for the shuffle buffer)
    try:
        while True:
            dbf.next_window(FEED_K)
    except StopIteration:
        pass
    torch.cuda.synchronize()
    # a window's launches, from its trace: K1 and K2 share a kernel (the
    # warm-up window's wrappers launched no K1)
    expect = {("bn." if k in ("apply_launches", "act_launches") else "conv.")
              + k: v * FEED_K for k, v in TRAIN_LAUNCHES.items()}
    profiles = {"first_of_pass": _profile_window(exe, main, dbf, loss, scope,
                                                 card, expect),
                "second_of_pass": _profile_window(exe, main, dbf, loss, scope,
                                                  card, expect)}
    dbf.stop()
    launches = {k.split(".", 1)[1]: sum(p["launches"][k]
                                        for p in profiles.values())
                for k in expect}
    print(f"launches per step, from the profiled windows' traces: "
          f"{ {k: v / (2 * FEED_K) for k, v in launches.items()} }",
          flush=True)
    for what, prof in profiles.items():
        print(f"profiled window ({what.replace('_', ' ')}): device busy "
              f"{prof['busy_ms']:.2f} ms of {prof['wall_ms']:.1f} ms wall, "
              f"{prof['busy_share']:.1%} of it less the "
              f"{prof['wait_ms']:.1f} ms waited for the window; host-to-device "
              f"copies {prof['h2d_copy_ms']:.3f} ms"
              + ("" if prof["h2d_overlap_share"] is None else
                 f", {prof['h2d_overlap_share']:.1%} of it overlapping kernels")
              + f" ({card})", flush=True)

    # run_steps against four run() calls from the same state and batches:
    # the run() calls replays of the phase's graph, the window on an
    # Executor of its own (a warm-up, a capture and two replays)
    sa, sb = _scope_from(pt, init), _scope_from(pt, init)
    first = host[0]
    seq = np.stack([exe.run(main, feed={n: v[i] for n, v in first.items()},
                            fetch_list=[loss], scope=sa)[0]
                    for i in range(FEED_K)])
    win, = pt.Executor().run_steps(main, feed_window=first, fetch_list=[loss],
                                   scope=sb, fetch_mode="stack")
    diverged = _bitwise_scopes(sa, sb)
    if not np.array_equal(seq, win) or diverged or \
            sa.find_var("__rng_counter__") != sb.find_var("__rng_counter__"):
        raise RuntimeError(f"train_feeder: run_steps(K={FEED_K}) is not four "
                           f"run() calls bit for bit: losses {seq.ravel()} vs "
                           f"{win.ravel()}; tensors that differ: {diverged[:8]}")
    print(f"run_steps(K={FEED_K}) bitwise {FEED_K} run() calls from the same "
          f"state: losses and {len(sa.vars) - 1} scope tensors (parameters, "
          f"velocities, batch-norm statistics)", flush=True)
    report["train_feeder"] = {
        "card": card, "batch": TRAIN_BATCH, "k": FEED_K, "classes": FEED_CLASSES,
        "window_ms": [t * 1e3 for t in times], "per_step_p50_ms": p50,
        "img_per_s": TRAIN_BATCH / (p50 / 1e3), "wait_ms": wait_s * 1e3,
        "peak_memory_gb": peak_gb, "losses": [w.tolist() for w in losses],
        "launches_per_step": {k: v / (2 * FEED_K)
                              for k, v in launches.items()},
        "warmup_fallbacks": {f"{k[0]}:{k[1]}": v
                             for k, v in warm_fb[0].items()},
        "windows_bitwise": held, "profiles": profiles}
    return launches


# --- the book chapters on the card ---------------------------------------------

def _infer_roundtrip(pt, exe, place, feed, targets, main, rtol=1e-4,
                     atol=1e-6):
    """tests/book/_roundtrip.py's epilogue: predictions from the live scope,
    then save_inference_model, a load into a fresh scope and executor, and
    the same predictions again."""
    import tempfile
    expected = exe.run(pt.io.get_inference_program(targets, main), feed=feed,
                       fetch_list=targets)
    with tempfile.TemporaryDirectory() as d:
        pt.io.save_inference_model(d, list(feed), targets, exe,
                                   main_program=main)
        with pt.scope_guard(pt.Scope()):
            infer_exe = pt.Executor(place)
            prog, names, fetch = pt.io.load_inference_model(d, infer_exe)
            got = infer_exe.run(prog, feed={n: feed[n] for n in names},
                                fetch_list=fetch)
    for e, g in zip(expected, got):
        np.testing.assert_allclose(g, e, rtol=rtol, atol=atol)
    return got


def _chapter(pt):
    """Fresh programs, names and scope for one chapter, and Python's
    `random` seeded (the readers shuffle with it)."""
    import contextlib
    import random
    random.seed(SEED)
    main, startup = pt.Program(), pt.Program()
    stack = contextlib.ExitStack()
    stack.enter_context(pt.unique_name.guard())
    stack.enter_context(pt.program_guard(main, startup))
    stack.enter_context(pt.scope_guard(pt.Scope()))
    return main, startup, stack


def book_fit_a_line(pt, place):
    """tests/book/test_fit_a_line.py: SGD 0.01 on uci_housing, batch 20,
    up to 12 passes (stopping below 0.3); the loss below 1.0."""
    main, startup, stack = _chapter(pt)
    with stack:
        x = pt.layers.data(name="x", shape=[13], dtype="float32")
        y = pt.layers.data(name="y", shape=[1], dtype="float32")
        y_predict = pt.layers.fc(input=x, size=1, act=None)
        avg_cost = pt.layers.mean(pt.layers.square_error_cost(y_predict, y))
        pt.optimizer.SGD(learning_rate=0.01).minimize(avg_cost)
        train = pt.batch(pt.reader.shuffle(pt.dataset.uci_housing.train(),
                                           buf_size=500), batch_size=20)
        exe = pt.Executor(place)
        feeder = pt.DataFeeder(place=place, feed_list=[x, y])
        exe.run(startup)
        last, steps = None, 0
        for _ in range(12):
            for data in train():
                last = float(exe.run(main, feed=feeder.feed(data),
                                     fetch_list=[avg_cost])[0].ravel()[0])
                steps += 1
            if last < 0.3:
                break
        if not (last is not None and last < 1.0):
            raise RuntimeError(f"fit_a_line: the loss did not drop: {last}")
        xs = np.random.RandomState(0).randn(8, 13).astype(np.float32)
        out, = _infer_roundtrip(pt, exe, place, {"x": xs}, [y_predict], main)
        if out.shape != (8, 1) or not np.isfinite(out).all():
            raise RuntimeError(f"fit_a_line: inference gave {out.shape}")
    return {"steps": steps, "last_loss": last}


def book_recognize_digits(pt, place, net):
    """tests/book/test_recognize_digits.py: mnist_mlp or mnist_conv, Adam
    1e-3, batch 64, 61 steps; the last 10 steps' accuracy above 0.7 and
    loss below 1.0; the probabilities sum to 1."""
    main, startup, stack = _chapter(pt)
    with stack:
        img = pt.layers.data(name="img", shape=[784] if net == "mlp"
                             else [1, 28, 28], dtype="float32")
        label = pt.layers.data(name="label", shape=[1], dtype="int64")
        avg_cost, predict, acc = pt.models.build_image_classifier(
            pt.models.mnist_mlp if net == "mlp" else pt.models.mnist_conv,
            img, label, class_dim=10)
        pt.optimizer.Adam(learning_rate=1e-3).minimize(avg_cost)
        train = pt.batch(pt.reader.shuffle(pt.dataset.mnist.train(),
                                           buf_size=500), batch_size=64)
        exe = pt.Executor(place)
        feeder = pt.DataFeeder(place=place, feed_list=[img, label])
        exe.run(startup)
        accs, losses = [], []
        for i, data in enumerate(train()):
            if net == "conv":
                data = [(np.reshape(im, (1, 28, 28)), lb) for im, lb in data]
            loss, a = exe.run(main, feed=feeder.feed(data),
                              fetch_list=[avg_cost, acc])
            accs.append(float(a.ravel()[0]))
            losses.append(float(loss.ravel()[0]))
            if i >= 60:
                break
        if not (np.mean(accs[-10:]) > 0.7 and np.mean(losses[-10:]) < 1.0):
            raise RuntimeError(f"recognize_digits[{net}]: accuracy "
                               f"{accs[-10:]}, loss {losses[-10:]}")
        shape = (4, 784) if net == "mlp" else (4, 1, 28, 28)
        xs = np.random.RandomState(0).rand(*shape).astype(np.float32)
        probs, = _infer_roundtrip(pt, exe, place, {"img": xs}, [predict], main)
        np.testing.assert_allclose(probs.sum(axis=1), np.ones(4), rtol=1e-4)
    return {"steps": len(losses), "last_losses": losses[-10:],
            "last_accuracy": accs[-10:]}


def book_image_classification(pt, place):
    """tests/book/test_image_classification.py[resnet]: resnet_cifar10
    (depth 32) on cifar10, Adam 1e-3, batch 32, 31 steps; the last 5
    losses' mean below 2.2."""
    main, startup, stack = _chapter(pt)
    with stack:
        img = pt.layers.data(name="img", shape=[3, 32, 32], dtype="float32")
        label = pt.layers.data(name="label", shape=[1], dtype="int64")
        avg_cost, predict, acc = pt.models.build_image_classifier(
            pt.models.resnet_cifar10, img, label, class_dim=10)
        pt.optimizer.Adam(learning_rate=1e-3).minimize(avg_cost)
        train = pt.batch(pt.reader.shuffle(pt.dataset.cifar.train10(),
                                           buf_size=512), batch_size=32)
        exe = pt.Executor(place)
        feeder = pt.DataFeeder(place=place, feed_list=[img, label])
        exe.run(startup)
        losses = []
        for i, data in enumerate(train()):
            data = [(np.reshape(im, (3, 32, 32)), lb) for im, lb in data]
            loss, _ = exe.run(main, feed=feeder.feed(data),
                              fetch_list=[avg_cost, acc])
            losses.append(float(loss.ravel()[0]))
            if i >= 30:
                break
        if not np.mean(losses[-5:]) < 2.2:
            raise RuntimeError(f"image_classification[resnet]: losses {losses}")
        xs = np.random.RandomState(0).rand(4, 3, 32, 32).astype(np.float32)
        probs, = _infer_roundtrip(pt, exe, place, {"img": xs}, [predict], main,
                                  rtol=1e-3, atol=1e-5)
        np.testing.assert_allclose(probs.sum(axis=1), np.ones(4), rtol=1e-3)
    return {"steps": len(losses), "last_losses": losses[-5:]}


def book_word2vec(pt, place):
    """tests/book/test_word2vec.py: four context embeddings of one shared
    table, concat, fc(128, sigmoid), fc(dict size), softmax cross entropy;
    Adam 2e-3, batch 64, 3 epochs of imikolov 5-grams; the last loss below
    0.8 of the first."""
    main, startup, stack = _chapter(pt)
    with stack:
        word_dict = pt.dataset.imikolov.build_dict()
        dict_size = len(word_dict)
        names = ("firstw", "secondw", "thirdw", "forthw", "nextw")
        words = [pt.layers.data(name=n, shape=[1], dtype="int64")
                 for n in names]
        embs = [pt.layers.embedding(input=w, size=[dict_size, 32],
                                    param_attr=pt.ParamAttr(name="shared_w"))
                for w in words[:4]]
        hidden = pt.layers.fc(input=pt.layers.concat(input=embs, axis=1),
                              size=128, act="sigmoid")
        logits = pt.layers.fc(input=hidden, size=dict_size)
        avg_cost = pt.layers.mean(pt.layers.softmax_with_cross_entropy(
            logits=logits, label=words[4]))
        pt.optimizer.Adam(learning_rate=2e-3).minimize(avg_cost)
        train = pt.batch(pt.dataset.imikolov.train(word_dict, 5),
                         batch_size=64)
        exe = pt.Executor(place)
        feeder = pt.DataFeeder(place=place, feed_list=words)
        exe.run(startup)
        losses = []
        for _ in range(3):
            for data in train():
                data = [tuple([v] for v in sample) for sample in data]
                losses.append(float(exe.run(main, feed=feeder.feed(data),
                                            fetch_list=[avg_cost])[0].ravel()[0]))
        if not losses[-1] < losses[0] * 0.8:
            raise RuntimeError(f"word2vec: loss {losses[0]} -> {losses[-1]}")
        rng = np.random.RandomState(0)
        ctx = {n: rng.randint(0, dict_size, (6, 1)).astype(np.int64)
               for n in names[:4]}
        out, = _infer_roundtrip(pt, exe, place, ctx, [logits], main)
        if out.shape != (6, dict_size):
            raise RuntimeError(f"word2vec: inference gave {out.shape}")
    return {"steps": len(losses), "first_loss": losses[0],
            "last_loss": losses[-1]}


BOOK = {
    "fit_a_line": book_fit_a_line,
    "recognize_digits[mlp]": lambda pt, place: book_recognize_digits(pt, place, "mlp"),
    "recognize_digits[conv]": lambda pt, place: book_recognize_digits(pt, place, "conv"),
    "image_classification[resnet]": book_image_classification,
    "word2vec": book_word2vec,
}
# the chapters whose conv counters the card run prints
BOOK_CONV = ("recognize_digits[conv]", "image_classification[resnet]")


def phase_book(pt, conv_cuda, bn_cuda, report):
    """The five book chapters on CUDAPlace(0) at their reference tests'
    budgets and thresholds, with the inference round trip; for the conv
    chapters the kernels' launches and the fallbacks by reason."""
    place = pt.CUDAPlace(0)
    out, t_all = {}, time.perf_counter()
    for name, chapter in BOOK.items():
        conv_cuda.COUNTERS.reset()
        bn_cuda.COUNTERS.reset()
        t0 = time.perf_counter()
        res = chapter(pt, place)
        res["seconds"] = time.perf_counter() - t0
        if name in BOOK_CONV:
            c, b = conv_cuda.COUNTERS, bn_cuda.COUNTERS
            res["launches"] = {"K1": c.launches, "K2": c.dgrad_launches,
                               "K3": c.wgrad_launches, "K4": c.stats_launches,
                               "K5": b.apply_launches, "K6": b.act_launches}
            res["fallbacks"] = {f"{k[0]}:{k[1]}": v for k, v in
                                {**c.fallbacks, **b.fallbacks}.items()}
        out[name] = res
        print(f"book {name} on the card: " + ", ".join(
            f"{k} {np.mean(v):.4g}" if isinstance(v, list) else f"{k} {v}"
            for k, v in res.items()), flush=True)
    total = time.perf_counter() - t_all
    print(f"book chapters: {total:.1f} s in all", flush=True)
    report["book"] = {"chapters": out, "seconds": total}
    return out


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
# the f32 forms' sources: the tf32 wgmma forward (K7, K10) and backward
# (K8, K9)
F32_SOURCES = {"fwd": "paddle_tpu_torch/csrc/flash_attn_fwd_tf32.cu",
               "block": "paddle_tpu_torch/csrc/flash_attn_fwd_tf32.cu",
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


def f32_block_entry(lib, name, A):
    """A loaded library's f32 K10 entry `name` (flash_tf32_fwd_block's
    arguments) as a function of causal f32 (q, k, v) at offsets 0 ->
    (acc, l, m)."""
    import ctypes

    import torch
    fn = getattr(lib, name)
    fn.argtypes, fn.restype = A._argtypes(6), ctypes.c_int

    def run(q, k, v):
        b, t, h, d = q.shape
        acc = torch.empty_like(q)
        m = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), acc.data_ptr(),
                m.data_ptr(), l.data_ptr(), b, h, t, k.shape[1], d, 0, 0,
                1.0 / math.sqrt(d), 1, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{name} failed: CUDA {rc}")
        return acc, l, m
    return run


def parent_walk_block(parent, A):
    """The older checkout's f32 K10, the tile walk's `flash_walk_fwd_block`
    in `csrc/flash_attn_walk.cu`, built from its sources."""
    return f32_block_entry(build_parent(parent, "flash_attn_walk.cu",
                                        "parent_flash_attn_walk"),
                           "flash_walk_fwd_block", A)


def _time_f32_block_parent(A, parent, q, k, v, worst):
    """K10 f32 against the older checkout's walk, in turns (new, walk, walk,
    new, a CUDA graph of calls each), at the f32 ring step's shape (q, k, v)
    and at [1, 2048, 4, 128] causal, both held to the plain version by
    `hold_block`. Returns {shape: {"ms": .., "parent_ms": .., "turns":
    ..}}."""
    import torch
    walk = parent_walk_block(parent, A)
    gen = torch.Generator().manual_seed(SEED + 9)
    d128 = tuple(torch.randn((1, 2048, 4, 128), generator=gen).cuda()
                 for _ in range(3))
    out = {}
    for qq, kk, vv in ((q, k, v), d128):
        at = str(list(qq.shape))
        scale = 1.0 / math.sqrt(qq.shape[-1])
        want = A.flash_forward_block_reference(qq, kk, vv, 0, 0, scale, True)
        worst["block"] = max(worst["block"], hold_block(
            A.flash_attention_block(qq, kk, vv, 0, 0, scale, True), want, qq,
            kk, vv, 0, 0, scale, True, f"K10 f32 at {at}", rows=TOL_ROWS))
        hold_block(walk(qq, kk, vv), want, qq, kk, vv, 0, 0, scale, True,
                   f"the parent's walk at {at}", rows=TOL_ROWS)
        del want
        ms, old, turns = _in_turns(
            lambda: A.flash_attention_block(qq, kk, vv, 0, 0, scale, True),
            lambda: walk(qq, kk, vv), reps=5)
        out[at] = {"ms": ms, "parent_ms": old, "turns": turns}
        print(f"K10 f32 at {at} causal: {ms:.4f} ms a call, the parent "
              f"tree's walk {old:.4f} ({old / ms:.2f}x; in turns new, walk, "
              f"walk, new: " + ", ".join(f"{t:.4f}" for t in turns) + ")",
              flush=True)
    return out


def phase_kernel_attn(attention_cuda, report):
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


def phase_kernel_ring(attention_cuda, ring, report, parent=None):
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
    and K8 and K9 there; the f32 K10 also beside the older checkout
    `parent`'s, in turns, when one is given."""
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
        if dtype == "float32" and parent is not None:
            vs_walk = _time_f32_block_parent(A, parent, *operands[:3], worst)
            row["parent_ms"] = vs_walk[str(list(F32_ATTN))]["parent_ms"]
            table["f32_vs_parent_walk"] = vs_walk
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
                 seqlen=None, sequence_parallel=False, level="O2"):
    """bench.py's `transformer` model (`cfg`, LM by default; T `seqlen`,
    cfg's by default) through the port's fluid API: the training program
    (Adam, amp.decorate at `level`, O2 by default; O3 in the mode
    PADDLE_TPU_QUANT_MODE names) or, with is_test, the served one (logits
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
                opt = pt.amp.decorate(opt, level=level)
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
                            scope=scope, use_jit=False)[0][0])]
    torch.cuda.synchronize()
    A.COUNTERS.reset()
    times = []
    for _ in range(LM_STEPS):
        t0 = time.perf_counter()
        losses.append(float(exe.run(main32, feed=feed, fetch_list=[loss32],
                                    scope=scope, use_jit=False)[0][0]))
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
        "K8's f32 form", lambda name: "dq_tf32_kernel" in name),
        use_jit=False)
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
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                            use_jit=False)[0][0])]
    print(f"transformer_lm warm-up step: {time.perf_counter() - t0:.2f} s, "
          f"loss {losses[0]:.5f}", flush=True)
    A.COUNTERS.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(LM_STEPS):
        t0 = time.perf_counter()               # the fetch ends in a device->host copy
        losses.append(float(exe.run(main, feed=feed, fetch_list=[loss],
                                    scope=scope, use_jit=False)[0][0]))
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
        "K7", lambda name: "flash_fwd_kernel" in name), use_jit=False)

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


def _logits_host_ms(engine, reps=3):
    """Per bucket, what the host spends on a replay's logits: the engine's
    trip of the bucket's rows to a float32 numpy array (_fetch_rows: the
    copy to the host, then numpy; median of `reps`, ms), with the rows'
    bytes on the card. Read from each bucket graph's fetch as the last
    replay left it. The other ways it could take are timed by
    tests/torch_logits_host_probe.py."""
    import torch
    from paddle_tpu_torch.serving.engine import _fetch_rows
    out = {}
    for (b, _inner, _token), graph in engine._graphs.items():
        f = graph.fetches[0]
        ms = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            a, = _fetch_rows([f], b)
            ms.append((time.perf_counter() - t0) * 1e3)
            if a.dtype != np.float32 or a.shape[0] != b:
                raise RuntimeError(f"the engine's logits on the host: "
                                   f"{a.dtype} {a.shape}")
            del a
        out[b] = {"bytes": f[:b].numel() * f.element_size(),
                  "dtype": str(f.dtype).replace("torch.", ""),
                  "engine_ms": float(np.median(ms))}
    return out


def phase_serve_lm(pt, attention_cuda, report):
    import numpy as np
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
    # warm-up and capture, each bucket's first replay bitwise its eager
    # run (the wrappers count the eager reference, warm-up and capture)
    A.COUNTERS.reset()
    warm_s, pool_gb = _warm_buckets(engine, "tok", requests[0], "serve_lm")
    warm, fallbacks = A.COUNTERS.launches, dict(A.COUNTERS.fallbacks)
    if warm != 3 * LM["n_layer"] * len(LM_BUCKETS) or fallbacks:
        raise RuntimeError(f"the LM warm-up launched K7 {warm} times, "
                           f"expected 3 x {LM['n_layer']} x "
                           f"{len(LM_BUCKETS)}; fallbacks {fallbacks}")
    A.COUNTERS.reset()
    misses = engine.cache_misses
    outs, single = [], []
    t_window = time.perf_counter()
    for req in requests:
        t0 = time.perf_counter()
        out, = engine.infer({"tok": req})      # ends in a device->host copy
        single.append((engine.bucket_for(req.shape[0]),
                       (time.perf_counter() - t0) * 1e3))
        outs.append(out)
    window_s = time.perf_counter() - t_window
    for req, out in zip(requests, outs):
        if out.shape != (req.shape[0], T, V) or not np.isfinite(out).all():
            raise RuntimeError(f"logits {out.shape} for tokens {req.shape}, "
                               f"or not finite")
    if A.COUNTERS.launches or engine.cache_misses != misses:
        raise RuntimeError("the replayed LM requests called the K7 wrapper "
                           "or captured")
    launches = _trace_replays(engine, "tok", requests,
                              {"K7": LM["n_layer"]}, "serve_lm")["K7"]
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
    del cpu_engine, cpu_scope, ref, got
    card = _card_line()
    full = {b: rng.integers(0, V, (b, T)).astype(np.int64) for b in LM_BUCKETS}
    turns = _serve_in_turns(engine, "tok", full, "serve_lm",
                            turns=LM_LATENCY_REPS)
    p50 = {b: v["graph"] for b, v in turns.items()}
    host = _logits_host_ms(engine)
    tok_s = sum(LM_SERVE_SIZES) * T / window_s
    print(f"served logits vs the CPU plain path, {requests[0].shape[0]} row(s): "
          f"max abs diff {rel:.3g} of the largest |logit| (tol "
          f"{LM_LOGIT_RTOL}); argmax equal at {same:.4f} of the positions",
          flush=True)
    print(f"K7 launches {launches} = {LM['n_layer']} layers x {len(requests)} "
          f"replayed bucket runs (from their trace); warm-up and capture per "
          f"bucket (s) " + ", ".join(f"{b}: {s:.2f}" for b, s in warm_s.items())
          + f", the graphs hold {pool_gb:.3f} GB; the window's "
            f"single-request latencies (bucket: ms) "
          + ", ".join(f"{b}: {v:.2f}" for b, v in single)
          + f"; {tok_s:.0f} tokens/s over the {len(requests)} requests' window "
            f"({window_s:.3f} s)", flush=True)
    print(f"the logits on the host per bucket, the engine's trip of a "
          f"replay's rows to a float32 numpy array (ms, {card}): " + "; ".join(
              f"bucket {b} ({v['bytes'] / 1e6:.0f} MB {v['dtype']}) "
              f"{v['engine_ms']:.2f}" for b, v in sorted(host.items())),
          flush=True)
    profile = _profile_request(engine, full[LM_BUCKETS[-1]],
                               p50[LM_BUCKETS[-1]],
                               {"flash_fwd_kernel": LM["n_layer"]}, card,
                               key="tok")
    if rel > LM_LOGIT_RTOL:
        raise RuntimeError("the served logits disagree with the CPU plain path")
    report["serve_lm"] = {"card": card, "p50_ms": p50, "in_turns_p50_ms": turns,
                          "window_latencies_ms": single,
                          "tokens_per_s": tok_s, "window_s": window_s,
                          "warmup_s": warm_s, "graph_gb": pool_gb,
                          "logits_host_ms": host, "profile": profile,
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
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                            use_jit=False)[0][0])]
    print(f"ring transformer_lm warm-up step: {time.perf_counter() - t0:.2f} s, "
          f"loss {losses[0]:.5f}", flush=True)
    A.COUNTERS.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(RING_STEPS):
        t0 = time.perf_counter()               # the fetch ends in a device->host copy
        losses.append(float(exe.run(main, feed=feed, fetch_list=[loss],
                                    scope=scope, use_jit=False)[0][0]))
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
        "K10", lambda name: "flash_fwd_kernel" in name and "false" in name),
        use_jit=False)
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


# --- the graphed training step -------------------------------------------------

GRAPH_BITWISE_STEPS = 3             # warm-up, capture, replay: held bitwise
GRAPH_TURNS = 8                     # then graphed and eager steps in turns
GRAPH_SECOND_BATCH = 16             # ResNet's second signature
# every kernel counter a training step can move: launches and copies
GRAPH_COUNTERS = (
    ("conv", ("dgrad_launches", "wgrad_launches", "stats_launches",
              "launches", "q8_launches", "filter_copies")),
    ("bn", ("apply_launches", "act_launches")),
    ("attn", ("launches", "dq_launches", "dkv_launches", "block_launches")
     + F32_COUNTERS),
    ("q1", ("total",)))


def _graph_counts(conv_cuda, bn_cuda, attention_cuda):
    from paddle_tpu_torch.ops import quant_cuda
    tables = {"conv": conv_cuda.COUNTERS, "bn": bn_cuda.COUNTERS,
              "attn": attention_cuda.COUNTERS, "q1": quant_cuda.COUNTERS}
    return {f"{t}.{k}": getattr(tables[t], k) for t, keys in GRAPH_COUNTERS
            for k in keys}


def _graph_paths(pt, resnet):
    """(name, (main, startup, loss), feed, launches per step, profile
    witness) of the four training paths that run graphed: ResNet-50 O2 at
    batch 32, the LM O2 at batch 8 x T 2048, the f32 LM at batch 1, the
    ring LM at T 32768."""
    import numpy as np
    rng = np.random.default_rng(SEED + 4)
    r_feed = {"img": rng.standard_normal((TRAIN_BATCH, 3, 224, 224)).astype(np.float32),
              "label": rng.integers(0, 1000, (TRAIN_BATCH, 1)).astype(np.int64)}
    rng = np.random.default_rng(SEED)
    B, T, V = LM["batch"], LM["seqlen"], LM["vocab"]
    lm_feed = {"tok": rng.integers(0, V, (B, T)).astype(np.int64),
               "lab": rng.integers(0, V, (B, T)).astype(np.int64)}
    rng = np.random.default_rng(SEED)
    rb, rt, rv = RING["batch"], RING["seqlen"], RING["vocab"]
    ring_feed = {"tok": rng.integers(0, rv, (rb, rt)).astype(np.int64),
                 "lab": rng.integers(0, rv, (rb, rt)).astype(np.int64)}
    n = LM["n_layer"]
    yield ("resnet50_o2", _resnet50_train(pt, resnet), r_feed,
           {**{("bn." if k in ("apply_launches", "act_launches") else "conv.")
               + k: v for k, v in TRAIN_LAUNCHES.items()},
            "conv.launches": 0},
           ("K4", lambda name: K1_KERNEL in name and "true" in name))
    yield ("lm_o2", _transformer(pt)[:3], lm_feed,
           {"attn.launches": n, "attn.dq_launches": n, "attn.dkv_launches": n},
           ("K7", lambda name: "flash_fwd_kernel" in name))
    yield ("lm_f32", _transformer(pt, amp=False)[:3],
           {k: v[:LM_SMALL_BATCH] for k, v in lm_feed.items()},
           {"attn.f32_launches": n, "attn.f32_dq_launches": n,
            "attn.f32_dkv_launches": n},
           ("K8's f32 form", lambda name: "dq_tf32_kernel" in name))
    yield ("ring_lm_o2", _transformer(pt, use_flash=True, cfg=RING,
                                      sequence_parallel=True)[:3], ring_feed,
           {"attn.block_launches": n, "attn.dq_launches": n,
            "attn.dkv_launches": n, "attn.launches": 0},
           ("K10", lambda name: "flash_fwd_kernel" in name and "false" in name))


def _settled_reserved():
    """The device memory the allocator holds once the garbage is collected
    and its free cached blocks are given back."""
    import gc
    import torch
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved()


def phase_train_graph(pt, conv_cuda, bn_cuda, attention_cuda, resnet, report):
    """Each training path as one CUDA graph per step (Executor.run's
    default on the card) against the eager step (use_jit=False), from the
    same startup state and batch, on two scopes: the warm-up, capture and
    first replay bitwise the eager steps (losses and every scope tensor);
    then GRAPH_TURNS graphed and eager steps in turns: the eager steps'
    launches held to the path's counts, the replays' wrappers launching
    nothing, no step eager for any reason but use_jit=False, the generic
    grads' re-run forwards per step by op type, step p50 of each; both
    scopes bitwise again after, sharing no tensor; one more step of each
    for the memory it needs beyond the scope's state (eager: the peak of
    the tensors it makes; graphed: the graph's state buffers and pool,
    measured across the capture, and what a replay makes); one profiled
    step of each (busy share; the replay's launches counted from its
    trace and held to the eager step's); for ResNet a second signature
    (batch GRAPH_SECOND_BATCH) on the same Executor, the memory it adds.
    Returns the profiled replays' kernel launches by counter."""
    import numpy as np
    import torch
    from paddle_tpu_torch import executor as E
    from paddle_tpu_torch.ops import registry
    card = _card_line()
    counts = lambda: _graph_counts(conv_cuda, bn_cuda, attention_cuda)  # noqa: E731
    graphed_launches, out = {}, {}
    for name, (main, startup, loss), feed, want, witness in \
            _graph_paths(pt, resnet):
        exe = pt.Executor()
        scope = pt.Scope()
        exe.run(startup, scope=scope)
        init = {n: v for n, v in scope.vars.items()
                if isinstance(v, torch.Tensor)}
        sg, se = _scope_from(pt, init), _scope_from(pt, init)
        del scope, init
        E.COUNTERS.reset()
        reserved0 = _settled_reserved()
        t0 = time.perf_counter()
        for i in range(GRAPH_BITWISE_STEPS):
            a = exe.run(main, feed=feed, fetch_list=[loss], scope=sg)[0]
            b = exe.run(main, feed=feed, fetch_list=[loss], scope=se,
                        use_jit=False)[0]
            if not np.array_equal(a, b):
                raise RuntimeError(f"train_graph {name}: step {i} graphed "
                                   f"loss {a} != eager {b}")
        diverged = _bitwise_scopes(sg, se)
        if diverged:
            raise RuntimeError(f"train_graph {name}: after the capture the "
                               f"graphed scope differs from the eager one: "
                               f"{diverged[:8]}")
        setup_s = time.perf_counter() - t0
        # what the graph holds beyond the scope's state: its static state
        # buffers and its pool
        pool_gb = (_settled_reserved() - reserved0) / 1e9
        if (E.COUNTERS.warmups, E.COUNTERS.captures) != (1, 1):
            raise RuntimeError(f"train_graph {name}: {E.COUNTERS}")

        E.COUNTERS.reset()
        registry.RERUNS.clear()
        steps = {"graph": [], "eager": []}
        launches = {"graph": {}, "eager": {}}
        peak = {}
        reruns = {}
        for _ in range(GRAPH_TURNS):
            for mode, sc, use_jit in (("graph", sg, None),
                                      ("eager", se, False)):
                torch.cuda.synchronize()
                c0, r0 = counts(), dict(registry.RERUNS)
                t0 = time.perf_counter()       # the fetch ends in a device->host copy
                exe.run(main, feed=feed, fetch_list=[loss], scope=sc,
                        use_jit=use_jit)
                steps[mode].append((time.perf_counter() - t0) * 1e3)
                for k, v in counts().items():
                    launches[mode][k] = launches[mode].get(k, 0) + v - c0[k]
                if mode == "eager":
                    for k, v in registry.RERUNS.items():
                        reruns[k] = reruns.get(k, 0) + v - r0.get(k, 0)
        # the eager steps' wrappers launched the path's kernels; a replay
        # calls no wrapper (its launches are counted from a trace below)
        per_step = {k: v / GRAPH_TURNS for k, v in launches["eager"].items()
                    if v}
        held = {k: per_step.get(k, 0.0) for k in want}
        if held != {k: float(v) for k, v in want.items()} or \
                any(launches["graph"].values()):
            raise RuntimeError(f"train_graph {name}: eager launches per "
                               f"step {per_step}, expected {want}; the "
                               f"replays' wrappers counted "
                               f"{ {k: v for k, v in launches['graph'].items() if v} }")
        if E.COUNTERS.eager != {"use_jit": GRAPH_TURNS} or \
                E.COUNTERS.replays != GRAPH_TURNS or E.COUNTERS.captures:
            raise RuntimeError(f"train_graph {name}: a graphed step ran "
                               f"eager or captured again: {E.COUNTERS}")
        diverged = _bitwise_scopes(sg, se)
        if diverged:
            raise RuntimeError(f"train_graph {name}: after {GRAPH_TURNS} "
                               f"steps in turns the scopes differ: "
                               f"{diverged[:8]}")
        # the memory a step needs beyond the state: eager, the peak of the
        # live tensors it makes; graphed, the graph's pool (reserved while
        # the graph lives) and what a replay makes (the fetch's copy)
        for mode, sc, use_jit in (("graph", sg, None), ("eager", se, False)):
            _settled_reserved()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            exe.run(main, feed=feed, fetch_list=[loss], scope=sc,
                    use_jit=use_jit)
            torch.cuda.synchronize()
            peak[mode] = (torch.cuda.max_memory_allocated() - before) / 1e9
        peak["graph"] += pool_gb
        state_gb = sum(v.numel() * v.element_size() for v in se.vars.values()
                       if isinstance(v, torch.Tensor)) / 1e9
        if _bitwise_scopes(sg, se):
            raise RuntimeError(f"train_graph {name}: the memory steps differ")
        p50 = {m: float(np.median(v)) for m, v in steps.items()}
        # one profiled step of each: the replay's launches, counted from
        # its trace, are the eager step's (K1 and K2 share a kernel: the
        # eager steps launched no K1)
        traced = {k: v for k, v in want.items() if k in TRACE_KERNELS}
        if "conv.launches" in want:
            traced["conv.dgrad_launches"] += want["conv.launches"]
        prof = {m: _profile_step(exe, main, feed, loss, sc, p50[m], card,
                                 witness, use_jit=use_jit, expect=traced)
                for m, sc, use_jit in (("graph", sg, None),
                                       ("eager", se, False))}
        rerun_step = {k: v / GRAPH_TURNS for k, v in sorted(reruns.items())}
        print(f"train_graph {name}: graphed step bitwise the eager step "
              f"({GRAPH_BITWISE_STEPS} steps, then {GRAPH_TURNS} in turns; "
              f"{setup_s:.1f} s to warm up and capture); step p50 graphed "
              f"{p50['graph']:.2f} ms, eager {p50['eager']:.2f} ms "
              f"({p50['eager'] / p50['graph']:.2f}x); busy "
              f"{prof['graph']['busy_ms']:.2f} ms "
              f"({prof['graph']['busy_share']:.1%}) graphed, "
              f"{prof['eager']['busy_ms']:.2f} ms "
              f"({prof['eager']['busy_share']:.1%}) eager; peak memory "
              f"beyond the {state_gb:.2f} GB of state {peak['graph']:.2f} GB "
              f"graphed (its pool {pool_gb:.2f} GB), {peak['eager']:.2f} GB "
              f"eager; launches per step {per_step} (eager, by the "
              f"wrappers; a replay's from its trace: "
              f"{ {k: prof['graph']['launches'][k] for k in traced} }); "
              f"eager fallbacks none; generic-grad "
              f"re-runs per step {rerun_step} ({card})", flush=True)
        print(f"train_graph {name} steps (ms): graphed "
              f"{', '.join(f'{t:.2f}' for t in steps['graph'])}; eager "
              f"{', '.join(f'{t:.2f}' for t in steps['eager'])}", flush=True)
        for k, v in prof["graph"]["launches"].items():
            graphed_launches[k] = graphed_launches.get(k, 0) + v
        out[name] = {"p50_ms": p50, "step_ms": steps,
                     "step_memory_gb": peak, "graph_pool_gb": pool_gb,
                     "state_gb": state_gb,
                     "launches_per_step": per_step,
                     "replay_traced_launches": {
                         k: prof["graph"]["launches"][k] for k in traced},
                     "reruns_per_step": rerun_step,
                     "busy_ms": {m: prof[m]["busy_ms"] for m in prof},
                     "busy_share": {m: prof[m]["busy_share"] for m in prof},
                     "setup_s": setup_s}
        if name == "resnet50_o2":
            # a second signature on the same Executor: it reads the first's
            # state buffers and draws on its pool
            second = {k: v[:GRAPH_SECOND_BATCH] for k, v in feed.items()}
            E.COUNTERS.reset()
            before = _settled_reserved()
            for _ in range(3):
                exe.run(main, feed=second, fetch_list=[loss], scope=sg)
            added_gb = (_settled_reserved() - before) / 1e9
            if (E.COUNTERS.warmups, E.COUNTERS.captures,
                    E.COUNTERS.replays) != (1, 1, 2):
                raise RuntimeError(f"train_graph {name}: the second "
                                   f"signature: {E.COUNTERS}")
            print(f"train_graph {name}: a second signature (batch "
                  f"{GRAPH_SECOND_BATCH}) on the same Executor adds "
                  f"{added_gb:.2f} GB (the first's state buffers and pool "
                  f"{pool_gb:.2f} GB; {card})", flush=True)
            out[name]["second_signature_gb"] = added_gb
        del exe, sg, se, main, startup, loss
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    report["train_graph"] = {"card": card, "paths": out}
    return graphed_launches


# --- AMP O3 training (phases kernel_q1 and train_q8) ----------------------------

Q1_SOURCE = "paddle_tpu_torch/csrc/quantize.cu"
Q1_REPLACES = ("the port's own: replaces XLA-fused jnp in "
               "paddle_tpu/quant.py:286-298, :374-376")
# the O3 training paths: ResNet-50 at batch 32 (int8) and the LM at batch 8
# x T 2048 (int8, then fp8), each with its O2 twin. ResNet-50's quant
# routing is its serving routing (Q8_HITS, Q8_FALLBACKS: K11 the 42 convs
# of 128-multiple channels, K1 the ten 64-channel convs, F.conv2d the stem,
# the fc an int8 GEMM); every `mul` of the LM quantizes (K 512 or 2048).
Q3_STEPS = 5                        # the losses fall over five steps
Q3_TURNS = 8                        # O3 and O2 graphed steps in turns


@contextlib.contextmanager
def _quant_mode(mode):
    """PADDLE_TPU_QUANT_MODE set to `mode` while a program is built (the
    switch amp.enable reads)."""
    old = os.environ.get("PADDLE_TPU_QUANT_MODE")
    os.environ["PADDLE_TPU_QUANT_MODE"] = mode
    try:
        yield
    finally:
        if old is None:
            del os.environ["PADDLE_TPU_QUANT_MODE"]
        else:
            os.environ["PADDLE_TPU_QUANT_MODE"] = old


def _mul_count(program) -> int:
    return sum(op.type == "mul" for op in program.global_block().ops)


def _bn_windows(program) -> int:
    """The training batch norms of a program's windows: K6's launches per
    step under O3, where every conv window runs its ladder."""
    from paddle_tpu_torch.ops import fusion
    return sum(1 for g in (fusion.plan(program) or {}).values()
               if g.bn is not None and not g.bn.attr("is_test", False))


def _q3_paths(pt, resnet, names=("resnet50_o3", "lm_o3_int8", "lm_o3_fp8")):
    """(name, O3 (main, startup, loss), O2 twin (main, startup, loss), feed,
    small feed for the lockstep, wrapper launches per eager step, quant
    hits and fallbacks per step, profile witness) of the O3 training
    paths."""
    import numpy as np
    rng = np.random.default_rng(SEED + 4)
    r_feed = {"img": rng.standard_normal((TRAIN_BATCH, 3, 224, 224)).astype(np.float32),
              "label": rng.integers(0, 1000, (TRAIN_BATCH, 1)).astype(np.int64)}
    rng = np.random.default_rng(SEED)
    B, T, V = LM["batch"], LM["seqlen"], LM["vocab"]
    lm_feed = {"tok": rng.integers(0, V, (B, T)).astype(np.int64),
               "lab": rng.integers(0, V, (B, T)).astype(np.int64)}
    if "resnet50_o3" in names:
        with _quant_mode("int8"):
            o3 = _resnet50_train(pt, resnet, level="O3")
        hits = Q8_HITS
        want = {"conv.q8_launches": hits["conv2d"],
                "conv.launches": Q8_LAUNCHES["launches"],
                "conv.dgrad_launches": TRAIN_LAUNCHES["dgrad_launches"],
                "conv.wgrad_launches": TRAIN_LAUNCHES["wgrad_launches"],
                "conv.stats_launches": 0, "bn.apply_launches": 0,
                "bn.act_launches": _bn_windows(o3[0]),
                "q1.total": 2 * hits["conv2d"] + 3 * hits["mul"]}
        small = {k: v[:SMALL_BATCH] for k, v in r_feed.items()}
        yield ("resnet50_o3", o3, _resnet50_train(pt, resnet), r_feed, small,
               want, (hits, Q8_FALLBACKS),
               ("K11", lambda name: K11_KERNEL in name))
    n = LM["n_layer"]
    for mode in ("int8", "fp8"):
        if f"lm_o3_{mode}" not in names:
            continue
        with _quant_mode(mode):
            o3 = _transformer(pt, level="O3")[:3]
        muls = _mul_count(o3[0])
        want = {"attn.launches": n, "attn.dq_launches": n,
                "attn.dkv_launches": n, "q1.total": 3 * muls}
        small = {k: v[:LM_SMALL_BATCH] for k, v in lm_feed.items()}
        yield (f"lm_o3_{mode}", o3, _transformer(pt)[:3], lm_feed, small,
               want, ({"mul": muls}, {}),
               ("Q1", lambda name: "quant_rows_kernel" in name))


def _q1_cases(pt, conv_cuda, resnet):
    """Every Q1 form the smoke's O3 paths launch, at their shapes:
    {path: {(form, shape, input dtype, mode, channels_last): calls}}, the
    calls counted per training step (resnet50_o3 at batch 32, lm_o3_int8
    and lm_o3_fp8), per bucket run (serve_q8, serve_fp8: the fc's rows and
    dequantize at each bucket; their conv activations take the training
    path's tensor form), per fold of the int8 engine (serve_q8_fold: the
    folded bf16 filters, in channels_last memory) and per admission
    (admission: every filter and the fc's Y from the f32 scope, the fc in
    int8 and in fp8). Forms: tensor (conv activation), filter (conv
    filter; the training step's is the bf16 cast of an OIHW weight), rows
    (`mul` activation), cols (`mul` Y), dequant ([M, N] GEMM result:
    int32 in int8, f32 in fp8)."""
    import torch
    from paddle_tpu_torch import quant
    bf16, f32 = torch.bfloat16, torch.float32
    main = _resnet50_train(pt, resnet, level="O3")[0]
    train, fold = {}, {}
    for xs, ws, *_ in _eligible_convs(conv_cuda, main, TRAIN_BATCH, quant):
        for calls, key in ((train, ("tensor", xs, bf16, "int8", False)),
                           (train, ("filter", ws, bf16, "int8", False)),
                           (fold, ("filter", ws, bf16, "int8", True))):
            calls[key] = calls.get(key, 0) + 1
    fc = ((TRAIN_BATCH, 2048), (2048, 1000), (TRAIN_BATCH, 1000))
    for form, shape in zip(("rows", "cols", "dequant"), fc):
        train[(form, shape, bf16, "int8", False)] = 1
    block, admission = main.global_block(), {}
    for op in block.ops:
        if op.type == "conv2d":
            ws = tuple(block.desc.var(op.input("Filter")[0]).shape)
            key = ("filter", ws, f32, "int8", False)
            admission[key] = admission.get(key, 0) + 1
    for mode in ("int8", "fp8"):
        admission[("cols", (2048, 1000), f32, mode, False)] = 1
    paths = {"resnet50_o3": train, "serve_q8_fold": fold,
             "admission": admission}
    block = _transformer(pt, level="O3")[0].global_block()
    m = LM["batch"] * LM["seqlen"]
    for mode, serve in (("int8", "serve_q8"), ("fp8", "serve_fp8")):
        calls = paths.setdefault(f"lm_o3_{mode}", {})
        for op in block.ops:
            if op.type == "mul":
                k, n = block.desc.var(op.input("Y")[0]).shape
                for key in (("rows", (m, k), bf16, mode, False),
                            ("cols", (k, n), bf16, mode, False),
                            ("dequant", (m, n), bf16, mode, False)):
                    calls[key] = calls.get(key, 0) + 1
        paths[serve] = {(form, (b, n), bf16, mode, False): 1
                        for b in BUCKETS
                        for form, n in (("rows", 2048), ("dequant", 1000))}
    return paths


def _gemm_result(m, n, mode, gen):
    """A [M, N] GEMM result as quant.int_matmul (int32; M padded to at
    least 32 rows and a multiple of 8, N to a multiple of 8) or
    quant.fp8_matmul (f32; M and N padded to multiples of 16) leaves it:
    a slice of the padded product, which the dequantize reads in place."""
    import torch
    dev = torch.device("cuda", 0)
    if mode == "int8":
        full = torch.randint(-2 ** 20, 2 ** 20,
                             (max(32, -(-m // 8) * 8), -(-n // 8) * 8),
                             device=dev, generator=gen, dtype=torch.int32)
    else:
        full = torch.randn((-(-m // 16) * 16, -(-n // 16) * 16), device=dev,
                           generator=gen) * 1e3
    return full[:m, :n]


def phase_kernel_q1(pt, conv_cuda, resnet, report):
    """Q1 (the fused quantize pass) in every form the O3 paths launch, at
    their shapes (`_q1_cases`: int8 and fp8, bf16 and f32 input, the int32
    and the f32 dequantize): each twice bitwise and bitwise its plain
    version on the same CUDA tensor (quant.quantize_tensor,
    quant.quantize_channelwise(x, axis, mode): the q bytes and the
    scales; the dequantized product), the largest |kernel - plain| over
    the values (e4m3 widened to f32) and the scales kept as the row's
    max_abs_err, then timed (CUDA graph of 20 calls between events)
    beside its plain version and the bound (bytes: x read once, q and
    the scales written once; dequant: the GEMM result read once, the bf16
    product written once)."""
    import torch
    from paddle_tpu_torch import quant
    from paddle_tpu_torch.ops import quant_cuda
    card = _card_line()
    dev = torch.device("cuda", 0)
    forms = {"tensor": (lambda x, mode: quant_cuda.quantize_tensor(x),
                        lambda x, mode: quant.quantize_tensor(x)),
             "filter": (quant_cuda.quantize_filter,
                        lambda w, mode: quant.quantize_channelwise(w, 0,
                                                                   mode)),
             "rows": (quant_cuda.quantize_rows,
                      lambda x, mode: quant.quantize_channelwise(x, 0, mode)),
             "cols": (quant_cuda.quantize_cols,
                      lambda y, mode: quant.quantize_channelwise(y, 1, mode))}

    def bits(t):
        t = t.contiguous()
        return t.view(torch.uint8) if t.element_size() == 1 else t

    def diff(a, b):
        return float((a.float() - b.float()).abs().max())

    rows, totals, worst = [], {}, 0.0
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for path, calls in _q1_cases(pt, conv_cuda, resnet).items():
        tot = totals.setdefault(path, {"ms": 0.0, "plain_ms": 0.0,
                                       "bound_ms": 0.0, "calls": 0})
        for (form, shape, dtype, mode, cl), n in sorted(
                calls.items(), key=lambda kv: str(kv[0])):
            dt = str(dtype).removeprefix("torch.")
            name = (f"Q1 {path} {form} {shape} {dt} {mode}"
                    f"{' channels_last' if cl else ''}")
            if form == "dequant":
                x = _gemm_result(*shape, mode, gen)
                sx = torch.rand((shape[0], 1), device=dev, generator=gen) * 1e-3
                sy = torch.rand((1, shape[1]), device=dev, generator=gen) * 1e-3
                kern = lambda a: quant_cuda.dequantize(  # noqa: E731
                    a, sx, sy, torch.bfloat16)
                plain = lambda a: (a.float() * (sx * sy)).to(  # noqa: E731
                    torch.bfloat16)
                got, again, want = kern(x), kern(x), plain(x)
                pairs = [(got, again, want)]
                nbytes = x.numel() * (x.element_size() + 2) + \
                    (shape[0] + shape[1]) * 4
            else:
                x = torch.randn(shape, device=dev, generator=gen).to(dtype)
                if cl:
                    x = x.contiguous(memory_format=torch.channels_last)
                k_fn, p_fn = forms[form]
                kern = lambda a, f=k_fn, md=mode: f(a, md)  # noqa: E731
                plain = lambda a, f=p_fn, md=mode: f(a, md)  # noqa: E731
                got, again, want = kern(x), kern(x), plain(x)
                pairs = list(zip(got, again, want))
                nbytes = x.numel() * (x.element_size() + 1) + \
                    got[1].numel() * 4
            for a, b, w in pairs:
                if not torch.equal(bits(a), bits(b)):
                    raise RuntimeError(f"{name}: a repeated call gave "
                                       f"different bits")
                if not torch.equal(bits(a), bits(w)):
                    raise RuntimeError(f"{name}: not bitwise its plain "
                                       f"version (max |kernel - plain| "
                                       f"{diff(a, w)})")
                worst = max(worst, diff(a, w))
            del got, again, want, pairs
            ms = _device_ms(lambda: kern(x))
            plain_ms = _device_ms(lambda: plain(x))
            bound = nbytes / PEAK_BYTES * 1e3
            rows.append({"path": path, "form": form, "shape": shape,
                         "dtype": dt, "mode": mode, "channels_last": cl,
                         "calls": n, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound, "bytes": nbytes,
                         "share_of_bound": bound / ms})
            for k, v in (("ms", ms), ("plain_ms", plain_ms),
                         ("bound_ms", bound)):
                tot[k] += v * n
            tot["calls"] += n
            print(f"{name} x{n}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"bound {bound:.4f} ms ({bound / ms:.0%} of it)", flush=True)
            del x
    torch.cuda.empty_cache()
    for path, t in totals.items():
        print(f"Q1 per {path}: {t['calls']} calls, {t['ms']:.3f} ms, "
              f"plain {t['plain_ms']:.3f} ms, bound {t['bound_ms']:.3f} ms "
              f"({t['bound_ms'] / t['ms']:.0%}; {card})", flush=True)
    print(f"Q1: {len(rows)} cases (path, form, shape, dtype, mode) bitwise "
          f"their plain versions, max |kernel - plain| {worst}", flush=True)
    report["kernel_q1"] = {"card": card, "shapes": rows, "per_path": totals,
                           "max_abs_err": worst}
    r = totals["resnet50_o3"]
    return {"name": "quantize", "route": "cuda", "source": Q1_SOURCE,
            "replaces": Q1_REPLACES, "max_abs_err": worst, "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "bytes", "library_ms": None,
            "per": f"one batch-{TRAIN_BATCH} ResNet-50 O3 training step, "
                   f"{r['calls']} calls",
            "lm_o3_step": totals["lm_o3_int8"],
            "lm_o3_fp8_step": totals["lm_o3_fp8"]}


def _reruns(exe, main, feed, loss, scope):
    """The generic grads' forward re-runs, by op type, of one eager step."""
    from paddle_tpu_torch.ops import registry
    before = dict(registry.RERUNS)
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope, use_jit=False)
    return {k: v - before.get(k, 0) for k, v in registry.RERUNS.items()
            if v - before.get(k, 0)}


def phase_train_q8(pt, conv_cuda, bn_cuda, attention_cuda, resnet, report):
    """AMP O3 training, graphed, at full width: ResNet-50 in int8 and the LM
    in int8 and fp8. Per path, from one startup state on three scopes: the
    warm-up, capture and first replay bitwise the eager steps (losses and
    every scope tensor), the launches of each eager step held to the
    path's counts by the wrappers (K11, K1, K2, K3, K4/K5 none, K6 on
    every window, Q1, K7-K9), K11 copying no filter, the quant hits and
    fallbacks by reason, the generic grads' re-runs equal to the O2 twin's
    (no quantized forward re-runs); two more graphed steps and the losses
    finite and lower after five; the O3 and O2 graphed steps in turns
    (p50), one profiled replay of each (busy share; the O3 replay's
    launches counted from its graph's kernel nodes and its trace, main
    captures under _kept_graphs), the memory a step needs beyond the
    state; a step at the small batch op by op against the CPU plain path
    (_lockstep). Returns {path: wrapper launches of its run}."""
    import numpy as np
    import torch
    from paddle_tpu_torch import executor as E
    from paddle_tpu_torch import quant
    card = _card_line()
    counts = lambda: _graph_counts(conv_cuda, bn_cuda, attention_cuda)  # noqa: E731
    out, launched = {}, {}
    for (name, (main, startup, loss), (main2, _, loss2), feed, small, want,
         (hits_want, fb_want), witness) in _q3_paths(pt, resnet):
        exe, exe2 = pt.Executor(), pt.Executor()
        scope = pt.Scope()
        exe.run(startup, scope=scope)
        init = {n: v for n, v in scope.vars.items()
                if isinstance(v, torch.Tensor)}
        sg, se, s2 = (_scope_from(pt, init) for _ in range(3))
        del scope
        E.COUNTERS.reset()
        quant.COUNTERS.reset()
        c_start = counts()
        reserved0 = _settled_reserved()
        losses, per_step = [], None
        for i in range(GRAPH_BITWISE_STEPS):
            a = exe.run(main, feed=feed, fetch_list=[loss], scope=sg)[0]
            c0, h0 = counts(), (dict(quant.COUNTERS.hits),
                                dict(quant.COUNTERS.fallbacks))
            b = exe.run(main, feed=feed, fetch_list=[loss], scope=se,
                        use_jit=False)[0]
            step = {k: v - c0[k] for k, v in counts().items() if v - c0[k]}
            hits = {k: v - h0[0].get(k, 0) for k, v in quant.COUNTERS.hits.items()
                    if v - h0[0].get(k, 0)}
            fbs = {k: v - h0[1].get(k, 0)
                   for k, v in quant.COUNTERS.fallbacks.items()
                   if v - h0[1].get(k, 0)}
            if not np.array_equal(a, b):
                raise RuntimeError(f"train_q8 {name}: step {i} graphed loss "
                                   f"{a} != eager {b}")
            if per_step is not None and step != per_step:
                raise RuntimeError(f"train_q8 {name}: eager steps launched "
                                   f"{per_step}, then {step}")
            per_step = step
            losses.append(float(a[0]))
        pool_gb = (_settled_reserved() - reserved0) / 1e9
        run_launches = {k: v - c_start[k] for k, v in counts().items()
                        if v - c_start[k]}
        diverged = _bitwise_scopes(sg, se)
        if diverged:
            raise RuntimeError(f"train_q8 {name}: graphed and eager scopes "
                               f"differ: {diverged[:8]}")
        if (E.COUNTERS.warmups, E.COUNTERS.captures) != (1, 1) or \
                E.COUNTERS.eager != {"use_jit": GRAPH_BITWISE_STEPS}:
            raise RuntimeError(f"train_q8 {name}: {E.COUNTERS}")
        held = {k: per_step.get(k, 0) for k in want}
        copies = per_step.get("conv.filter_copies", 0)
        if held != want or copies != per_step.get("conv.dgrad_launches", 0):
            raise RuntimeError(f"train_q8 {name}: launches per eager step "
                               f"{per_step}, expected {want} and one filter "
                               f"copy per K2 launch (K11 copies none)")
        if hits != hits_want or fbs != fb_want:
            raise RuntimeError(f"train_q8 {name}: quant hits {hits}, "
                               f"fallbacks {fbs}; expected {hits_want}, "
                               f"{fb_want}")
        reruns = _reruns(exe, main, feed, loss, _scope_from(pt, init))
        reruns2 = _reruns(exe2, main2, feed, loss2, _scope_from(pt, init))
        if reruns != reruns2:
            raise RuntimeError(f"train_q8 {name}: generic-grad re-runs "
                               f"{reruns}, its O2 twin's {reruns2}")
        for _ in range(Q3_STEPS - GRAPH_BITWISE_STEPS):
            losses.append(float(exe.run(main, feed=feed, fetch_list=[loss],
                                        scope=sg)[0][0]))
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise RuntimeError(f"train_q8 {name}: losses {losses} not finite "
                               f"and lower after {Q3_STEPS} steps")
        # the O3 and O2 graphed steps in turns, from the same state
        s3 = _scope_from(pt, init)
        E.COUNTERS.reset()
        before2 = _settled_reserved()
        for _ in range(2):
            exe2.run(main2, feed=feed, fetch_list=[loss2], scope=s2)
        pool2_gb = (_settled_reserved() - before2) / 1e9
        ms = {"o3": [], "o2": []}
        runs = {"o3": (exe, main, loss, s3), "o2": (exe2, main2, loss2, s2)}
        for i in range(Q3_TURNS):
            for m in (("o3", "o2") if i % 2 == 0 else ("o2", "o3")):
                x, prog, lss, sc = runs[m]
                torch.cuda.synchronize()
                t0 = time.perf_counter()       # ends in a device->host copy
                x.run(prog, feed=feed, fetch_list=[lss], scope=sc)
                ms[m].append((time.perf_counter() - t0) * 1e3)
        if E.COUNTERS.replays != 2 * Q3_TURNS + 1 or E.COUNTERS.eager:
            raise RuntimeError(f"train_q8 {name}: a timed step did not "
                               f"replay: {E.COUNTERS}")
        p50 = {m: float(np.median(v)) for m, v in ms.items()}
        peak = {}
        for m, (x, prog, lss, sc) in runs.items():
            _settled_reserved()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            x.run(prog, feed=feed, fetch_list=[lss], scope=sc)
            torch.cuda.synchronize()
            peak[m] = (torch.cuda.max_memory_allocated() - before) / 1e9
        peak["o3"] += pool_gb
        peak["o2"] += pool2_gb
        traced = {k: v for k, v in want.items() if k in TRACE_KERNELS}
        if "conv.launches" in want:     # K1 and K2 are one kernel
            traced["conv.dgrad_launches"] += want["conv.launches"]
        graphs = [e.graph for e in exe._graphs.values()]
        if len(graphs) != 1:
            raise RuntimeError(f"train_q8 {name}: {len(graphs)} step graphs")
        prof = {"o3": _profile_step(exe, main, feed, loss, s3, p50["o3"],
                                    card, witness, expect=traced,
                                    graph=graphs[0]),
                "o2": _profile_step(exe2, main2, feed, loss2, s2, p50["o2"],
                                    card, ("a kernel", lambda n: True))}
        t0 = time.perf_counter()
        worst = _lockstep(pt, main, loss, init, small)
        top = sorted(worst.items(), key=lambda kv: -kv[1])
        lock_s = time.perf_counter() - t0
        print(f"train_q8 {name}: graphed step bitwise the eager step "
              f"({GRAPH_BITWISE_STEPS} steps); losses "
              f"{', '.join(f'{v:.5f}' for v in losses)}; launches per eager "
              f"step {per_step}; quant hits {hits}, fallbacks {fbs}; "
              f"generic-grad re-runs per step {reruns} (O2's {reruns2}); "
              f"a replay's traced launches "
              f"{ {k: prof['o3']['launches'][k] for k in traced} }, its "
              f"graph's kernel nodes "
              f"{ {k: prof['o3']['graph_launches'][k] for k in traced} }"
              + (f", records the profiler lost {prof['o3']['lost_records']}"
                 if prof["o3"]["lost_records"] else "") + f" ({card})",
              flush=True)
        print(f"train_q8 {name}: O3 vs O2 graphed in turns: step p50 "
              f"{p50['o3']:.2f} ms vs {p50['o2']:.2f} ms "
              f"({p50['o3'] / p50['o2']:.3f}x); busy {prof['o3']['busy_ms']:.2f} "
              f"ms ({prof['o3']['busy_share']:.1%}) vs "
              f"{prof['o2']['busy_ms']:.2f} ms ({prof['o2']['busy_share']:.1%}); "
              f"memory a step needs beyond the state (graph pool included) "
              f"{peak['o3']:.2f} GB vs {peak['o2']:.2f} GB; lockstep at the "
              f"small batch ({lock_s:.1f} s), worst relative L2 "
              + ", ".join(f"{k} {v:.3g}" for k, v in top[:6])
              + f" (tol {LOCKSTEP_BF16} bf16, {LOCKSTEP_F32} f32; {card})",
              flush=True)
        print(f"train_q8 {name} steps (ms): O3 "
              f"{', '.join(f'{t:.2f}' for t in ms['o3'])}; O2 "
              f"{', '.join(f'{t:.2f}' for t in ms['o2'])}", flush=True)
        out[name] = {"losses": losses, "launches_per_step": per_step,
                     "hits": hits, "fallbacks": {f"{k[0]}:{k[1]}": v
                                                 for k, v in fbs.items()},
                     "reruns_per_step": reruns, "p50_ms": p50,
                     "step_ms": ms, "step_memory_gb": peak,
                     "busy_ms": {m: prof[m]["busy_ms"] for m in prof},
                     "busy_share": {m: prof[m]["busy_share"] for m in prof},
                     "replay_traced_launches": {
                         k: prof["o3"]["launches"][k] for k in traced},
                     "graph_launches": {
                         k: prof["o3"]["graph_launches"][k] for k in traced},
                     "lost_records": prof["o3"]["lost_records"],
                     "by_kernel_o3": prof["o3"]["by_kernel"],
                     "lockstep_worst_rl2": worst}
        launched[name] = run_launches
        del exe, exe2, sg, se, s2, s3, main, main2, init
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    report["train_q8"] = {"card": card, "paths": out}
    return launched


# --- sparse embeddings (phases kernel_s1, train_dlrm, train_emb_cache,
# serve_dlrm) --------------------------------------------------------------

S1_SOURCE = "paddle_tpu_torch/csrc/sparse_apply.cu"
S1_REPLACES = ("the port's own: replaces the plain jnp merge and "
               "scatter-apply of paddle_tpu/ops/common.py:49-67 and "
               "paddle_tpu/ops/sparse_ops.py:202-244")
# bench.py's `embedding` family at its defaults (bench.py:1151-1328): one
# shared f32 table, 26 slots, batch 256, MLP 1664 -> 256 -> 64 -> 2, Adam
# 1e-3, no AMP, the table row-sharded over an fsdp mesh of every card (one)
DLRM = {"rows": 1_000_000, "dim": 64, "slots": 26, "batch": 256, "lr": 1e-3}
DLRM_BIG_ROWS = 4_000_000           # the second height of the memory check
DLRM_TURNS = 8                      # graphed and eager steps in turns
DLRM_SMALL_BATCH = 16               # the step held op by op to the CPU
DLRM_TABLE_STATE = ("emb_table", "emb_table_moment1_0", "emb_table_moment2_0")
# a step's memory beyond the state may differ between the two heights by
# no more than the allocator's rounding of one large block
DLRM_MEMORY_SLACK = 2 << 20
# the cached run (bench.py BENCH_EMB_BUDGET=64): the same model unsharded,
# a 64 MiB slab budget (87381 rows of table and two moments), zipf ids,
# DoubleBufferedFeeder(window_prefetch=2) windows of 8 steps through
# run_steps, the next window prefetched behind the current one
EMB_BUDGET = 64 << 20
EMB_ZIPF = 1.3
EMB_WINDOW = 8
# the slab fills after some 55 windows of this id stream and evicts from
# then on (its bookkeeping replayed on the CPU at full size,
# tests/torch_emb_cache_replay.py): the first windows warm up, capture and
# fill it, the timed ones are its steady state
EMB_WARM_WINDOWS = 56
EMB_TIMED_WINDOWS = 16
# the LRU's steady hit rate lies below the zipf law's coverage of a slab
# holding the most probable ids (no online policy beats it on independent
# draws, up to the sample's noise, EMB_HIT_SLACK) and within EMB_HIT_GAP of
# it: the CPU replay of this id stream's bookkeeping gave 0.9791 against a
# coverage of 0.9855, and the bound is three times that gap
EMB_HIT_SLACK, EMB_HIT_GAP = 0.005, 0.02
# the dlrm serving model (bench.py:1357-1391) and a 4 MiB slab budget
SERVE_DLRM = {"rows": 100_000, "dim": 32, "slots": 26, "max_batch": 16}
SERVE_DLRM_BUDGET = 4 << 20
SERVE_DLRM_RTOL, SERVE_DLRM_ATOL = 1e-5, 1e-6     # card vs CPU, f32
# S1 against its plain version: bitwise where no run of equal rows is
# longer than eight (S1 then sums in the plain version's order). A longer
# run S1 sums as eight warps' partial sums added in a fixed order, the
# plain version in sorted order: each row's sum within 2 n 2^-24 sum|v| of
# the plain sum (two f32 sums of the same n values; `_hold_s1_sums`), the
# updated tensors within S1_RTOL/S1_ATOL (that difference passed on by the
# update: observed 4.6e-6 at a momentum velocity of 0.3 summed from 300
# values, measured on one NVIDIA H100 80GB HBM3)
S1_RTOL, S1_ATOL = 1e-4, 1e-5
S1_FORMS = ("sgd", "momentum", "nesterov", "adam")


def _dlrm_train(pt, rows, sharded=True):
    """bench.py's DLRM at full width with `rows` table rows: (main,
    startup, loss)."""
    c = DLRM
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        ids = pt.layers.data(name="ids", shape=[c["slots"]], dtype="int64")
        label = pt.layers.data(name="label", shape=[1], dtype="int64")
        emb = pt.layers.embedding(ids, size=[rows, c["dim"]], is_sparse=True,
                                  param_attr=pt.ParamAttr(name="emb_table"))
        flat = pt.layers.reshape(emb, shape=[-1, c["slots"] * c["dim"]])
        h = pt.layers.fc(input=flat, size=256, act="relu")
        h = pt.layers.fc(input=h, size=64, act="relu")
        logits = pt.layers.fc(input=h, size=2)
        loss = pt.layers.mean(
            pt.layers.softmax_with_cross_entropy(logits, label))
        pt.optimizer.Adam(learning_rate=c["lr"]).minimize(
            loss, startup_program=startup)
    if sharded:
        from paddle_tpu_torch.parallel import embedding, mesh
        main._mesh = mesh.make_mesh((1,), ("fsdp",))
        embedding.shard_table(main, "emb_table", "fsdp")
    return main, startup, loss


def _dlrm_batch(rng, rows, batch, zipf=None):
    c = DLRM
    ids = (np.minimum(rng.zipf(zipf, (batch, c["slots"])) - 1, rows - 1)
           if zipf else rng.integers(0, rows, (batch, c["slots"])))
    return {"ids": ids.astype(np.int64),
            "label": rng.integers(0, 2, (batch, 1)).astype(np.int64)}


def _card_device():
    import torch
    return torch.device("cuda", 0)


def _eager_ms(fn, reps=10):
    """Mean ms of one eager call between two CUDA events around `reps`
    calls, the host's waits included: for a function that syncs with the
    host (S1's plain version masks the freed rows out), which no CUDA graph
    can capture."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _s1_cases():
    """(path, table rows, sorted-or-not rows [K]) at every distinct shape
    the sparse paths give S1: train_dlrm's uniform ids into the 1M-row
    table and, for its memory check, the 4M-row one; train_emb_cache's zipf
    ids remapped to slots of the 87381-row slab (each distinct id a slot of
    its own, as the cache maps them)."""
    from paddle_tpu_torch.parallel import emb_cache
    c = DLRM
    rng = np.random.default_rng(SEED + 20)
    k = c["batch"] * c["slots"]
    yield "train_dlrm", c["rows"], rng.integers(0, c["rows"], k)
    yield "train_dlrm_4m", DLRM_BIG_ROWS, rng.integers(0, DLRM_BIG_ROWS, k)
    slab = emb_cache.rows_for_budget(EMB_BUDGET, c["dim"], 4, 3)
    z = np.minimum(rng.zipf(EMB_ZIPF, k) - 1, c["rows"] - 1)
    uniq, inv = np.unique(z, return_inverse=True)
    yield "train_emb_cache", slab, rng.permutation(slab)[:uniq.size][inv]


def _hold_s1_sums(sr, height, d, dev):
    """S1's row sums (sgd at lr 1 on a zero table writes -sum exactly)
    within 2 n 2^-24 sum|v| of the plain merge's, or raise."""
    import torch
    from paddle_tpu_torch.ops import sparse_cuda
    from paddle_tpu_torch.ops.common import (SelectedRowsVal,
                                             merge_selected_rows)
    p = torch.zeros(height, d, device=dev)
    sparse_cuda.sgd(p, sr, torch.tensor(1.0, device=dev))
    rows, g = merge_selected_rows(sr)
    keep = (rows >= 0) & (rows < height)
    rows, g = rows[keep], g[keep]
    _, mags = merge_selected_rows(SelectedRowsVal(sr.rows, sr.values.abs(),
                                                  height))
    valid = sr.rows[(sr.rows >= 0) & (sr.rows < height)]
    n = torch.bincount(valid, minlength=height)[rows]
    bound = 2 * n[:, None] * 2.0 ** -24 * mags[keep]
    if not bool(((-p[rows] - g).abs() <= bound).all()):
        raise RuntimeError("S1: a row's sum is outside 2 n 2^-24 sum|v| of "
                           "the plain merge's")


def phase_kernel_s1(pt, report):
    """S1 (csrc/sparse_apply.cu) in every form (sgd, momentum, Nesterov,
    Adam) at every distinct shape of the sparse paths (`_s1_cases`): twice
    and bitwise repeatable, against its plain version on the same CUDA
    tensors (sparse_cuda.apply_reference) bitwise where no run of equal
    rows exceeds eight, else within S1_RTOL/S1_ATOL, rows outside the
    gradient untouched; then Adam, the paths' form, timed: the wrapper
    (sort, gather, S1) and S1 alone in a CUDA graph of 20 calls between
    events, the plain version eagerly (it syncs), beside the bytes bound
    (the gradient read once, each distinct row of the table and both
    moments read and written once)."""
    import torch
    from paddle_tpu_torch.ops import sparse_cuda
    from paddle_tpu_torch.ops.common import SelectedRowsVal
    card = _card_line()
    dev = _card_device()
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    d = DLRM["dim"]
    lr = torch.tensor(DLRM["lr"], device=dev)
    b1p = torch.tensor(0.9 ** 3, device=dev)
    b2p = torch.tensor(0.999 ** 3, device=dev)
    kw = {"b1p": b1p, "b2p": b2p, "mu": 0.9, "b1": 0.9, "b2": 0.999,
          "eps": 1e-8}
    rows_out, worst = {}, 0.0
    for path, height, ids in _s1_cases():
        k = ids.size
        valid = ids[(ids >= 0) & (ids < height)]
        longest = int(np.bincount(valid).max())
        distinct = int(np.unique(valid).size)
        sr = SelectedRowsVal(torch.from_numpy(ids).to(dev),
                             torch.randn((k, d), device=dev, generator=gen),
                             height)
        base = [torch.randn((height, d), device=dev, generator=gen)
                for _ in range(2)]
        base.append(torch.rand((height, d), device=dev, generator=gen))
        untouched = torch.ones(height, dtype=torch.bool, device=dev)
        untouched[torch.from_numpy(valid).to(dev)] = False
        errs = {}
        for kind in S1_FORMS:
            form = "momentum" if kind == "nesterov" else kind
            n_acc = sparse_cuda.ACCUMULATORS[form]
            args = dict(kw, nesterov=kind == "nesterov")

            def run(plain):
                ts = [t.clone() for t in base[:1 + n_acc]]
                fn = sparse_cuda.apply_reference if plain else \
                    sparse_cuda.apply
                fn(form, sr, ts[0], tuple(ts[1:]), lr, **args)
                torch.cuda.synchronize()
                return ts

            a, b, want = run(False), run(False), run(True)
            err = 0.0
            for x, y, w, t in zip(a, b, want, base):
                if not torch.equal(x, y):
                    raise RuntimeError(f"S1 {kind} {path}: a repeated call "
                                       f"gave different bits")
                if longest <= 8 and not torch.equal(x, w):
                    raise RuntimeError(f"S1 {kind} {path}: not bitwise its "
                                       f"plain version (runs of at most 8)")
                torch.testing.assert_close(x, w, rtol=S1_RTOL, atol=S1_ATOL)
                if not torch.equal(x[untouched], t[untouched]):
                    raise RuntimeError(f"S1 {kind} {path}: a row outside "
                                       f"the gradient changed")
                err = max(err, float((x - w).abs().max()))
            errs[kind] = err
            worst = max(worst, err)
            del a, b, want
        if longest > 8:
            _hold_s1_sums(sr, height, d, dev)
        # Adam timed, on copies the timing loops update in place
        ts = [t.clone() for t in base]
        ms = _device_ms(lambda: sparse_cuda.adam(
            ts[0], ts[1], ts[2], sr, lr, 0.9, 0.999, 1e-8, b1p, b2p))
        r_s, order = torch.sort(sr.rows.long(), stable=True)
        v_s = sr.values[order].contiguous()
        kernel_ms = _device_ms(lambda: sparse_cuda.launch_sorted(
            "adam", r_s, v_s, ts[0], (ts[1], ts[2]), lr, b1p, b2p))
        plain_ms = _eager_ms(lambda: sparse_cuda.apply_reference(
            "adam", sr, ts[0], (ts[1], ts[2]), lr, **kw))
        nbytes = sparse_cuda.bound_bytes("adam", k, d, distinct)
        bound = nbytes / PEAK_BYTES * 1e3
        rows_out[path] = {"height": height, "k": k, "d": d,
                          "distinct": distinct, "longest_run": longest,
                          "ms": ms, "kernel_ms": kernel_ms,
                          "plain_ms": plain_ms, "bound_ms": bound,
                          "bytes": nbytes, "max_abs_err": errs}
        print(f"S1 {path}: table {height} x {d}, K {k} ({distinct} distinct "
              f"rows, longest run {longest}); forms {S1_FORMS} twice bitwise, "
              f"against the plain version max |S1 - plain| {errs}; Adam "
              f"{ms:.4f} ms (S1 alone {kernel_ms:.4f} ms), plain "
              f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({bound / ms:.1%} of "
              f"it; {card})", flush=True)
        del sr, base, ts, untouched, r_s, v_s
        torch.cuda.empty_cache()
    report["kernel_s1"] = {"card": card, "shapes": rows_out,
                           "max_abs_err": worst}
    r = rows_out["train_dlrm"]
    return {"name": "sparse_apply", "route": "cuda", "source": S1_SOURCE,
            "replaces": S1_REPLACES, "max_abs_err": worst, "ms": r["ms"],
            "kernel_ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": "bytes",
            "library_ms": None,
            "per": f"one Adam apply to the {DLRM['rows']} x {DLRM['dim']} "
                   f"table, K {r['k']} uniform ids (the wrapper: sort, "
                   f"gather, S1)",
            "by_shape": {p: {k: v for k, v in s.items()
                             if k in ("ms", "kernel_ms", "plain_ms",
                                      "bound_ms")}
                         for p, s in rows_out.items()}}


def _memcpy_bytes(fn):
    """(bytes, copies) of the memory copies on the card's timeline while
    `fn` runs, from the profiler's chrome trace (kineto writes each copy's
    bytes in its args); (None, copies) when the trace gives no bytes."""
    import json as _json
    with _profiled() as prof:
        fn()
    path = Path(__file__).resolve().parent / "build" / \
        f"trace-{os.getpid()}.json"
    path.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(path))
    try:
        events = _json.loads(path.read_text()).get("traceEvents", [])
    finally:
        path.unlink(missing_ok=True)
    copies = [e for e in events if e.get("cat") == "gpu_memcpy"]
    sizes = [e.get("args", {}).get("bytes") for e in copies]
    if any(s is None for s in sizes):
        return None, len(copies)
    return int(sum(sizes)), len(copies)


def _dlrm_memory(pt, rows, feed):
    """The memory a DLRM step needs beyond its state, at `rows` table rows:
    graphed, the pool the capture reserved and what a replay allocates;
    eager, the peak of what the step allocates; and each step's memory
    copies on the card (bytes, count)."""
    import torch
    main, startup, loss = _dlrm_train(pt, rows)
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    state = sum(v.numel() * v.element_size() for v in scope.vars.values()
                if isinstance(v, torch.Tensor))
    reserved0 = _settled_reserved()
    for _ in range(3):                  # warm-up, capture, replay
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    pool = _settled_reserved() - reserved0
    out = {"rows": rows, "state_bytes": state, "pool_bytes": pool}
    for mode, use_jit in (("graph", None), ("eager", False)):
        def step():
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                    use_jit=use_jit)
        step()
        _settled_reserved()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - before
        out[f"{mode}_step_bytes"] = peak + (pool if mode == "graph" else 0)
        out[f"{mode}_memcpy"] = _memcpy_bytes(step)
    del exe, scope, main, startup
    _settled_reserved()
    return out


def phase_train_dlrm(pt, report):
    """bench.py's DLRM (the `embedding` family at its defaults) trained on
    the card: one step at batch DLRM_SMALL_BATCH op by op against the CPU
    port (_lockstep, the table's Adam through S1 on the card and the plain
    version on the CPU); then from one startup state on two scopes the
    warm-up, capture and first replay bitwise the eager steps, DLRM_TURNS
    graphed and eager steps in turns on one repeated batch (bench.py's
    driver): S1 launched once by each eager step and by no replay's
    wrapper, the scopes bitwise after, the table and its moments in the
    same storage throughout and never copied in, the loss falling, no
    densify fallback, fusion's table reason `sharded_table_sparse_path`
    and never `sparse_grad_unsupported`; step p50 of each; one profiled
    step of each (busy share; the replay's S1 launches from its trace, 1);
    then the memory a step needs beyond the state and its memory copies
    at 1M and at 4M table rows, which must not grow. Returns S1's launches
    on the path: the wrappers' count over the run (the capture's record
    taken out: it runs nothing) and the profiled replay's traced launch."""
    import torch
    from paddle_tpu_torch import executor as E
    from paddle_tpu_torch import telemetry
    from paddle_tpu_torch.ops import fusion, sparse_cuda
    card = _card_line()
    c = DLRM
    densify0 = sum(telemetry.read_series(
        "sparse_densify_fallback_total").values())
    main, startup, loss = _dlrm_train(pt, c["rows"])
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    init = {n: v for n, v in scope.vars.items() if isinstance(v, torch.Tensor)}
    feed = _dlrm_batch(np.random.default_rng(SEED + 21), c["rows"],
                       c["batch"])
    small = {k: v[:DLRM_SMALL_BATCH] for k, v in feed.items()}
    lock = _lockstep(pt, main, loss, {n: v.clone() for n, v in init.items()},
                     small)
    print(f"train_dlrm: a batch-{DLRM_SMALL_BATCH} step op by op on the "
          f"card against the CPU plain path, worst relative L2 by op "
          f"{lock}", flush=True)
    sg, se = _scope_from(pt, init), _scope_from(pt, init)
    del scope, init
    E.COUNTERS.reset()
    fusion.COUNTERS.reset()
    sparse_cuda.COUNTERS.reset()
    losses = []
    with _captures_uncounted(sparse_cuda.COUNTERS):
        for i in range(GRAPH_BITWISE_STEPS):
            a = exe.run(main, feed=feed, fetch_list=[loss], scope=sg)[0]
            b = exe.run(main, feed=feed, fetch_list=[loss], scope=se,
                        use_jit=False)[0]
            if not np.array_equal(a, b):
                raise RuntimeError(f"train_dlrm: step {i} graphed loss {a} "
                                   f"!= eager {b}")
            losses.append(float(a[0]))
    diverged = _bitwise_scopes(sg, se)
    if diverged:
        raise RuntimeError(f"train_dlrm: after the capture the graphed "
                           f"scope differs from the eager one: {diverged}")
    ptrs = {n: sg.find_var(n).data_ptr() for n in DLRM_TABLE_STATE}
    steps = {"graph": [], "eager": []}
    for _ in range(DLRM_TURNS):
        for mode, sc, use_jit in (("graph", sg, None), ("eager", se, False)):
            torch.cuda.synchronize()
            n0 = sparse_cuda.COUNTERS.total
            t0 = time.perf_counter()
            out = exe.run(main, feed=feed, fetch_list=[loss], scope=sc,
                          use_jit=use_jit)[0]
            steps[mode].append((time.perf_counter() - t0) * 1e3)
            launched = sparse_cuda.COUNTERS.total - n0
            if launched != (1 if mode == "eager" else 0):
                raise RuntimeError(f"train_dlrm: a {mode} step's wrapper "
                                   f"launched S1 {launched} times")
            if mode == "graph":
                losses.append(float(out[0]))
    wrapper_launches = sparse_cuda.COUNTERS.total
    diverged = _bitwise_scopes(sg, se)
    if diverged:
        raise RuntimeError(f"train_dlrm: after {DLRM_TURNS} steps in turns "
                           f"the scopes differ: {diverged}")
    moved = [n for n, p in ptrs.items() if sg.find_var(n).data_ptr() != p]
    if moved or E.COUNTERS.copied_in or E.COUNTERS.captures != 1:
        raise RuntimeError(f"train_dlrm: table state moved {moved} or was "
                           f"copied in / captured again: {E.COUNTERS}")
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise RuntimeError(f"train_dlrm: the loss did not fall: {losses}")
    densify = sum(telemetry.read_series(
        "sparse_densify_fallback_total").values()) - densify0
    fb = dict(fusion.COUNTERS.fallbacks)
    if densify or "sparse_grad_unsupported" in fb or \
            not fb.get("sharded_table_sparse_path"):
        raise RuntimeError(f"train_dlrm: densify fallbacks {densify}, "
                           f"fusion fallbacks {fb}")
    p50 = {m: float(np.median(v)) for m, v in steps.items()}
    witness = ("S1", lambda name: "sparse_apply_kernel" in name)
    prof = {m: _profile_step(exe, main, feed, loss, sc, p50[m], card,
                             witness, use_jit=use_jit,
                             expect={"sparse.launches": 1})
            for m, sc, use_jit in (("graph", sg, None), ("eager", se, False))}
    traced = prof["graph"]["launches"]["sparse.launches"]
    del exe, sg, se, main, startup
    _settled_reserved()
    memory = {r: _dlrm_memory(pt, r, feed) for r in (c["rows"], DLRM_BIG_ROWS)}
    m1, m4 = memory[c["rows"]], memory[DLRM_BIG_ROWS]
    for key in ("graph_step_bytes", "eager_step_bytes"):
        if m4[key] > m1[key] + DLRM_MEMORY_SLACK:
            raise RuntimeError(f"train_dlrm: a step's {key} grew from "
                               f"{m1[key]} at {c['rows']} rows to {m4[key]} "
                               f"at {DLRM_BIG_ROWS}")
    for mode in ("graph", "eager"):
        b1, b4 = m1[f"{mode}_memcpy"][0], m4[f"{mode}_memcpy"][0]
        if b1 is not None and b4 is not None and b4 > b1:
            raise RuntimeError(f"train_dlrm: a {mode} step copies {b4} "
                               f"bytes at {DLRM_BIG_ROWS} rows, {b1} at "
                               f"{c['rows']}")
    mb = lambda v: v / 2 ** 20  # noqa: E731
    print(f"train_dlrm: {c['rows']} x {c['dim']} table, batch {c['batch']} "
          f"x {c['slots']} slots, Adam; graphed step bitwise the eager one "
          f"({GRAPH_BITWISE_STEPS} steps, then {DLRM_TURNS} in turns); loss "
          f"{losses[0]:.5f} -> {losses[-1]:.5f}; step p50 graphed "
          f"{p50['graph']:.3f} ms, eager {p50['eager']:.3f} ms; busy "
          f"{prof['graph']['busy_share']:.1%} graphed, "
          f"{prof['eager']['busy_share']:.1%} eager; S1 1 launch a step "
          f"(eager by the wrapper, the replay from its trace); densify "
          f"fallbacks 0; fusion {fb}; memory beyond the state "
          + "; ".join(f"{r} rows: graphed {mb(m['graph_step_bytes']):.2f} "
                      f"MiB (pool {mb(m['pool_bytes']):.2f}), eager "
                      f"{mb(m['eager_step_bytes']):.2f} MiB, copies graphed "
                      f"{m['graph_memcpy']}, eager {m['eager_memcpy']} "
                      f"(bytes, count)" for r, m in memory.items())
          + f" ({card})", flush=True)
    report["train_dlrm"] = {"card": card, "losses": losses, "p50_ms": p50,
                            "step_ms": steps, "lockstep": lock,
                            "busy_share": {m: prof[m]["busy_share"]
                                           for m in prof},
                            "memory": memory, "fusion_fallbacks": fb,
                            "densify_fallbacks": densify,
                            "s1_wrapper_launches": wrapper_launches,
                            "s1_traced_replay_launches": traced}
    return wrapper_launches + traced


def _zipf_coverage(a, rows, slab):
    """The share of zipf(a) draws, clamped to rows - 1, that fall on the
    `slab` most probable ids: the hit rate of the best static slab."""
    m = np.arange(1, rows, dtype=np.float64)
    mass = m ** -a
    tail = (rows - 0.5) ** (1 - a) / (a - 1)     # every draw >= rows
    mass = np.append(mass, tail)
    return float(np.sort(mass)[::-1][:slab].sum() / mass.sum())


def phase_train_emb_cache(pt, report):
    """The DLRM from the hot-row cache (bench.py's BENCH_EMB_BUDGET=64
    driver): emb_cache.enable(budget 64 MiB) -> 87381 slab rows; zipf ids
    through DoubleBufferedFeeder(window_prefetch=2).next_window(8,
    sparse_slots=["ids"]) -> run_steps(K=8), the next window pulled and
    prefetched behind the current one, EMB_WARM_WINDOWS then
    EMB_TIMED_WINDOWS windows, then one profiled window: the steady hit
    rate (timed windows) against the zipf coverage of the slab, the
    prefetch overlap fraction, the flush bytes a step and the evictions a
    window, ms a step; no densify fallback; then the flushed host tables
    bitwise an uncached run of the same windows from the same state (the
    remap is a bijection of rows, so S1 sums the same values in the same
    order). Returns S1's launches that ran on the path: the wrapper's (the
    warm-up; the capture's record taken out) and the profiled window's
    traced ones, held to one a replay."""
    import torch
    from paddle_tpu_torch import executor as E
    from paddle_tpu_torch import telemetry
    from paddle_tpu_torch.ops import sparse_cuda
    from paddle_tpu_torch.parallel import emb_cache
    from paddle_tpu_torch.reader.pipeline import DoubleBufferedFeeder
    card = _card_line()
    c = DLRM
    main, startup, loss = _dlrm_train(pt, c["rows"], sharded=False)
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    init = {n: v.clone() for n, v in scope.vars.items()
            if isinstance(v, torch.Tensor)}
    cache = emb_cache.enable(main, budget_bytes=EMB_BUDGET, scope=scope)
    slab = cache.tables()["emb_table"].cache_rows
    rng = np.random.default_rng(SEED + 22)
    # the warm windows, the timed ones, then one profiled window
    windows = EMB_WARM_WINDOWS + EMB_TIMED_WINDOWS + 1
    batches = [_dlrm_batch(rng, c["rows"], c["batch"], EMB_ZIPF)
               for _ in range(windows * EMB_WINDOW)]
    feeder = DoubleBufferedFeeder(lambda: iter(batches),
                                  device=_card_device(), window_prefetch=2)
    names = cache.feed_id_names()
    densify0 = sum(telemetry.read_series(
        "sparse_densify_fallback_total").values())
    E.COUNTERS.reset()
    sparse_cuda.COUNTERS.reset()
    losses, times, steady, timed = [], [], None, None
    try:
        with _kept_graphs(), _captures_uncounted(sparse_cuda.COUNTERS):
            win, _ = feeder.next_window(EMB_WINDOW, sparse_slots=names)
            for w in range(windows - 1):
                t0 = time.perf_counter()
                out = exe.run_steps(main, feed_window=win, fetch_list=[loss],
                                    scope=scope, return_numpy=False)
                win, uniq = feeder.next_window(EMB_WINDOW, sparse_slots=names)
                handle = cache.prefetch(uniq)
                losses.append(float(out[0].cpu()[0]))   # the window ends
                handle.wait()
                times.append((time.perf_counter() - t0) * 1e3 / EMB_WINDOW)
                if w + 1 == EMB_WARM_WINDOWS:
                    steady = cache.stats()
            timed = cache.stats()
            with _profiled() as prof:
                out = exe.run_steps(main, feed_window=win, fetch_list=[loss],
                                    scope=scope, return_numpy=False)
                losses.append(float(out[0].cpu()[0]))
    finally:
        feeder.stop()
    wrapper = sparse_cuda.COUNTERS.total
    graphs = [e.graph for e in exe._graphs.values() if e.graph is not None]
    nodes = sum(_graph_launches(g)["sparse.launches"] for g in graphs)
    replays = E.COUNTERS.replays
    if len(graphs) != 1 or nodes != 1 or wrapper != 1 or \
            replays != windows * EMB_WINDOW - 1:
        raise RuntimeError(f"train_emb_cache: graphs {len(graphs)}, S1 "
                           f"nodes {nodes}, wrapper launches {wrapper}, "
                           f"{E.COUNTERS}")
    # the profiled window: EMB_WINDOW replays, each launching S1 once
    from torch.autograd import DeviceType
    traced = _trace_launches(
        [e for e in prof.events()
         if e.device_type == DeviceType.CUDA and not _is_span(e)])
    if traced["sparse.launches"] != EMB_WINDOW:
        if not 0 < traced["sparse.launches"] < EMB_WINDOW:
            raise RuntimeError(f"train_emb_cache: a window of "
                               f"{EMB_WINDOW} replays traced "
                               f"{traced['sparse.launches']} S1 launches")
        print(f"train_emb_cache: the profiler lost records of the window: "
              f"{traced['sparse.launches']} S1 launches traced of "
              f"{EMB_WINDOW} replays, each holding one S1 node ({card})",
              flush=True)
    s = timed
    cache.flush()
    d_hit, d_miss = s["hits"] - steady["hits"], s["misses"] - steady["misses"]
    hit = d_hit / max(d_hit + d_miss, 1)
    coverage = _zipf_coverage(EMB_ZIPF, c["rows"], slab)
    p_s = s["prefetch_seconds"] - steady["prefetch_seconds"]
    overlap = (s["overlap_seconds"] - steady["overlap_seconds"]) / p_s \
        if p_s > 0 else 0.0
    timed_steps = EMB_TIMED_WINDOWS * EMB_WINDOW
    evicted = s["evictions"] - steady["evictions"]
    flush_step = (s["flush_bytes"] - steady["flush_bytes"]) / timed_steps
    densify = sum(telemetry.read_series(
        "sparse_densify_fallback_total").values()) - densify0
    if densify or not np.all(np.isfinite(losses)):
        raise RuntimeError(f"train_emb_cache: densify fallbacks {densify}, "
                           f"losses {losses}")
    if not (coverage - EMB_HIT_GAP <= hit <= coverage + EMB_HIT_SLACK):
        raise RuntimeError(f"train_emb_cache: steady hit rate {hit:.4f} "
                           f"outside [{coverage - EMB_HIT_GAP:.4f}, "
                           f"{coverage + EMB_HIT_SLACK:.4f}] (zipf coverage "
                           f"of the {slab}-row slab {coverage:.4f})")
    # the uncached twin on the same windows from the same state
    main2, _, loss2 = _dlrm_train(pt, c["rows"], sharded=False)
    scope2, exe2 = _scope_from(pt, init), pt.Executor()
    del init
    for w in range(windows):
        exe2.run_steps(main2, feed_window=batches[w * EMB_WINDOW:
                                                  (w + 1) * EMB_WINDOW],
                       fetch_list=[loss2], scope=scope2)
    err, bitwise = {}, True
    for n in cache.tables()["emb_table"].state_names:
        got = torch.from_numpy(cache.host_value(n))
        want = scope2.find_var(n).cpu()
        err[n] = float((got - want).abs().max())
        bitwise &= torch.equal(got, want)
    if not bitwise:
        raise RuntimeError(f"train_emb_cache: the flushed tables are not "
                           f"bitwise the uncached run's: max |diff| {err}")
    t_step = float(np.median(times[EMB_WARM_WINDOWS:]))
    print(f"train_emb_cache: {slab}-row slab over the {c['rows']}-row table "
          f"(budget {EMB_BUDGET >> 20} MiB), zipf {EMB_ZIPF}, windows of "
          f"{EMB_WINDOW} steps: steady hit rate {hit:.4f} (the zipf "
          f"coverage of the slab {coverage:.4f}), prefetch overlap "
          f"{overlap:.3f} ({p_s * 1e3 / EMB_TIMED_WINDOWS:.2f} ms of "
          f"prefetch a window), flush {flush_step:.0f} bytes a step "
          f"(victims' write-back; the final flush is not counted), "
          f"{evicted} evictions in the {EMB_TIMED_WINDOWS} timed windows "
          f"({evicted / EMB_TIMED_WINDOWS:.1f} a window), {t_step:.3f} ms "
          f"a step (median over the timed windows, host clock); losses "
          f"{losses[0]:.5f} -> {losses[-1]:.5f}; densify fallbacks 0; the "
          f"flushed tables bitwise the uncached run's; S1 launches: "
          f"{wrapper} by the wrapper (the warm-up), "
          f"{traced['sparse.launches']} traced in a window of {EMB_WINDOW} "
          f"replays, 1 node x {replays} replays in all ({card})", flush=True)
    report["train_emb_cache"] = {
        "card": card, "cache_rows": slab, "hit_rate": hit,
        "zipf_coverage": coverage, "overlap_fraction": overlap,
        "flush_bytes_per_step": flush_step,
        "evictions_per_window": evicted / EMB_TIMED_WINDOWS,
        "step_ms": t_step, "window_step_ms": times, "losses": losses,
        "stats": s, "uncached_max_abs_err": err,
        "s1_wrapper_launches": wrapper,
        "s1_traced_window_launches": traced["sparse.launches"],
        "s1_graph_replays": replays}
    del exe, exe2, scope, scope2, cache, main, main2
    _settled_reserved()
    return wrapper + traced["sparse.launches"]


def _serve_dlrm_model(pt):
    c = SERVE_DLRM
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        ids = pt.layers.data(name="ids", shape=[c["slots"]], dtype="int64")
        emb = pt.layers.embedding(ids, size=[c["rows"], c["dim"]],
                                  is_sparse=True,
                                  param_attr=pt.ParamAttr(name="emb_table"))
        flat = pt.layers.reshape(emb, shape=[-1, c["slots"] * c["dim"]])
        h = pt.layers.fc(input=flat, size=256, act="relu")
        h = pt.layers.fc(input=h, size=64, act="relu")
        out = pt.layers.softmax(pt.layers.fc(input=h, size=2))
    return main, startup, out


def phase_serve_dlrm(pt, report):
    """bench.py's `dlrm` serving model (100000 x 32 table, 26 slots, MLP
    832 -> 256 -> 64 -> 2, softmax, max_batch 16) through ServingEngine's
    bucket graphs, and again with emb_cache_budget_bytes=4 MiB (a
    read-only 32768-row slab): each bucket's first replay bitwise its
    eager run on both engines; the REQUEST_SIZES requests (uniform ids)
    answered bitwise alike by both, rows of a softmax over 2 classes; the
    first ones within SERVE_DLRM_RTOL of the CPU port's engine; p50 per
    bucket graphed against eager in turns; the cache's hits, misses and
    evictions, and no flush."""
    import torch
    from paddle_tpu_torch.serving import ServingEngine
    card = _card_line()
    c = SERVE_DLRM
    main, startup, out = _serve_dlrm_model(pt)
    scope = pt.Scope()
    pt.Executor().run(startup, scope=scope)
    cpu_scope = pt.Scope()
    for n, v in scope.vars.items():
        if isinstance(v, torch.Tensor):
            cpu_scope.set_var(n, v.cpu())
    engines = {
        "plain": ServingEngine(main, ["ids"], [out], scope=scope,
                               max_batch=c["max_batch"]),
        "cached": ServingEngine(main, ["ids"], [out], scope=scope,
                                max_batch=c["max_batch"],
                                emb_cache_budget_bytes=SERVE_DLRM_BUDGET)}
    cpu = ServingEngine(main, ["ids"], [out], place=pt.CPUPlace(),
                        scope=cpu_scope, max_batch=c["max_batch"])
    slab = engines["cached"].stats()["emb_cache"]["tables"]["emb_table"][
        "cache_rows"]
    rng = np.random.default_rng(SEED + 23)
    row = rng.integers(0, c["rows"], (c["max_batch"], c["slots"]))
    warm = {k: _warm_buckets(e, "ids", row, f"serve_dlrm {k}")
            for k, e in engines.items()}
    requests = [rng.integers(0, c["rows"], (n, c["slots"])).astype(np.int64)
                for n in REQUEST_SIZES]
    worst = 0.0
    for i, req in enumerate(requests):
        a, b = (engines[k].infer({"ids": req})[0] for k in ("plain",
                                                           "cached"))
        if not np.array_equal(a, b):
            raise RuntimeError(f"serve_dlrm: request {i} answered "
                               f"differently by the cached engine")
        if a.shape != (len(req), 2) or not np.all(np.isfinite(a)) or \
                np.abs(a.sum(1) - 1).max() > 1e-5:
            raise RuntimeError(f"serve_dlrm: request {i}: {a}")
        if i < len(COMPARED):
            want = cpu.infer({"ids": req})[0]
            np.testing.assert_allclose(a, want, rtol=SERVE_DLRM_RTOL,
                                       atol=SERVE_DLRM_ATOL)
            worst = max(worst, float(np.abs(a - want).max()))
    full = {b: rng.integers(0, c["rows"], (b, c["slots"])).astype(np.int64)
            for b in engines["plain"].buckets}
    turns = {k: _serve_in_turns(e, "ids", full, f"serve_dlrm {k}")
             for k, e in engines.items()}
    st = engines["cached"].stats()["emb_cache"]
    if st["flush_bytes"] or not st["misses"]:
        raise RuntimeError(f"serve_dlrm: the read-only cache {st}")
    print(f"serve_dlrm: {c['rows']} x {c['dim']} table, buckets "
          f"{engines['plain'].buckets}; first replays bitwise the eager runs "
          f"(capture s by bucket {warm['plain'][0]}); {len(requests)} "
          f"requests bitwise alike with the {slab}-row cache (hits "
          f"{st['hits']}, misses {st['misses']}, evictions "
          f"{st['evictions']}, no flush); against the CPU port max |diff| "
          f"{worst:.3g} ({card})", flush=True)
    report["serve_dlrm"] = {"card": card, "cache_rows": slab,
                            "p50_ms": turns, "cache": st,
                            "cpu_max_abs_diff": worst,
                            "graph_pool_gb": {k: w[1]
                                              for k, w in warm.items()}}
    for e in engines.values():
        e.close()
    del engines, scope
    _settled_reserved()


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
    ap.add_argument("--parent", help="an older checkout whose K6 and f32 K10 "
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
    k11 = phase_kernel_q8(pt, conv_cuda, resnet, report)
    q8 = phase_serve_q8(pt, conv_cuda, resnet, report, served)
    load_launches = phase_serve_load(pt, served, report)
    del served
    k1["launches_by_path"] = {"serve": slice_launches,
                              "serve_q8": q8["launches"],
                              "serve_load": load_launches}
    k1["launches"] = sum(k1["launches_by_path"].values())
    k11["launches"] = q8["q8_launches"]
    train_kernels = phase_kernel_train(pt, conv_cuda, bn_cuda, resnet, report,
                                       args.parent)
    per_step = phase_train(pt, conv_cuda, bn_cuda, resnet, report)
    feeder_launches = phase_train_feeder(pt, conv_cuda, bn_cuda, resnet, report)
    phase_book(pt, conv_cuda, bn_cuda, report)
    for k, key in zip(train_kernels, ("dgrad_launches", "wgrad_launches",
                                      "stats_launches", "apply_launches",
                                      "act_launches")):
        k["launches_by_path"] = {"train": int(per_step[key] * TRAIN_STEPS),
                                 "train_feeder": feeder_launches[key]}
        k["launches"] = sum(k["launches_by_path"].values())
    attn_kernels = phase_kernel_attn(attention_cuda, report)
    lm_launches = phase_train_lm(pt, attention_cuda, report)
    serve_launches = phase_serve_lm(pt, attention_cuda, report)
    ring_kernels = phase_kernel_ring(attention_cuda, ring_attention, report,
                                     args.parent)
    ring_launches = phase_train_ring(pt, attention_cuda, report)
    graph_launches = phase_train_graph(pt, conv_cuda, bn_cuda, attention_cuda,
                                       resnet, report)
    q1 = phase_kernel_q1(pt, conv_cuda, resnet, report)
    with _kept_graphs():
        q3 = phase_train_q8(pt, conv_cuda, bn_cuda, attention_cuda, resnet,
                            report)
    r3 = q3["resnet50_o3"]
    k1["launches_by_path"].update({"serve_fp8": q8["fp8"]["launches"],
                                   "train_q8": r3.get("conv.launches", 0)})
    k1["launches"] = sum(k1["launches_by_path"].values())
    k11["launches_by_path"] = {"serve_q8": q8["q8_launches"],
                               "train_q8": r3.get("conv.q8_launches", 0)}
    k11["launches"] = sum(k11["launches_by_path"].values())
    q1["launches_by_path"] = {
        "serve_q8": q8["q1"], "serve_fp8": q8["fp8"]["q1"],
        **{f"train_q8.{p}": c.get("q1.total", 0) for p, c in q3.items()}}
    q1["launches"] = sum(q1["launches_by_path"].values())
    for k, key in zip(train_kernels, ("dgrad_launches", "wgrad_launches",
                                      "stats_launches", "apply_launches",
                                      "act_launches")):
        table = "bn." if key in ("apply_launches", "act_launches") else "conv."
        k["launches_by_path"]["train_graph"] = graph_launches[table + key]
        if r3.get(table + key):
            k["launches_by_path"]["train_q8"] = r3[table + key]
        k["launches"] = sum(k["launches_by_path"].values())
    counter = {"flash_attn_fwd": "launches", "flash_attn_bwd_dq": "dq_launches",
               "flash_attn_bwd_dkv": "dkv_launches",
               "flash_attn_fwd_block": "block_launches"}
    for k in attn_kernels + ring_kernels:
        f32 = k["name"].endswith("_f32")
        key = ("f32_" if f32 else "") + counter[k["name"].removesuffix("_f32")]
        by_path = {"train_lm": lm_launches.get(key, 0),
                   "train_ring": ring_launches.get(key, 0),
                   "train_graph": graph_launches.get("attn." + key, 0),
                   "train_q8": sum(c.get("attn." + key, 0)
                                   for c in q3.values())}
        if key == "launches":
            by_path["serve_lm"] = serve_launches
        by_path = {p: n for p, n in by_path.items() if n}
        k["launches"] = sum(by_path.values())
        k["launches_by_path"] = by_path
        if not k["launches"]:
            raise RuntimeError(f"{k['name']} was launched no time on its path")
    s1 = phase_kernel_s1(pt, report)
    s1["launches_by_path"] = {"train_dlrm": phase_train_dlrm(pt, report),
                              "train_emb_cache": phase_train_emb_cache(
                                  pt, report)}
    s1["launches"] = sum(s1["launches_by_path"].values())
    if not all(s1["launches_by_path"].values()):
        raise RuntimeError(f"S1 was launched no time on a sparse path: "
                           f"{s1['launches_by_path']}")
    phase_serve_dlrm(pt, report)
    kernels = {"kernels": [k1] + train_kernels + attn_kernels + ring_kernels
               + [k11, q1, s1]}
    report.update(kernels)
    leads = [v for v in LAUNCH_LEADS_US if v is not None]
    report["launch_lead_us"] = LAUNCH_LEADS_US
    print(f"profiler windows: {len(LAUNCH_LEADS_US)}, each with "
          f"{PROFILE_MARGIN_S * 1e3:.0f} ms idle at both ends; least launch "
          f"lead {min(leads) if leads else None} us, most "
          f"{max(leads) if leads else None} us (a card record's start less "
          f"its runtime call's)", flush=True)
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
