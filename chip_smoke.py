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
model served; bench.py's lstm; the machine-translation seq2seq (the `rnn`
loop) trained and beam-decoded (a `while` loop) and the SRL tagger (the
CRF) trained at the book's widths; bench.py's AlexNet, GoogLeNet and
SmallNet trained and two of them served, and a MobileNet-SSD trained and
its detections served — and holds every kernel of those paths
against its plain PyTorch version on the card:

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
 8c. book     the thirteen book chapters (`BOOK`: fit_a_line,
              recognize_digits mlp and conv, image_classification resnet
              and vgg, word2vec, understand_sentiment conv and
              stacked_lstm, recommender_system, machine_translation train
              and decode, label_semantic_roles, beam_search_decode) on the
              card at their reference tests' budgets and thresholds, with
              the inference round trip; the conv chapters' K1-K6 launches
              and fallbacks by reason;
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
11b. memory   ResNet-50 O2 training (batch 8, 16, 32) eager under
              Executor.measure_memory: measured peaks beside the static
              IR estimate, memory.what_if's HeadroomModel and its max
              batch under 16 GiB, validated by a measured step there
              (rel_err <= MEMORY_REL_ERR); in a fresh process limited to
              16 GiB (`--memory-oom`), a step at 1.25x that batch raising
              errors.OOMError (breakdown = the scope's bytes, named
              buffers, a suggestion naming the max batch), a batch-32
              step after it with the allocated bytes back within 64 MiB,
              the same for a capture that runs out of memory, then
              batch-32 graphs that capture and replay; a served batch-16
              request's peak and K1 launches; every served program's
              admission by analyze_program (seconds, counts), a
              rank-mismatched program refused before any bucket runs;
              K1-K6 counted on the path;
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
 21. train_lstm  bench.py's lstm graphed bitwise eager, its LoD buckets
              and the imdb reader's stream;
 22. train_seq2seq  the machine-translation chapter's encoder_decoder (a
              DynamicRNN decoder with attention: the `rnn` op and its
              generic grad) at the book ch08 widths (dicts 30000, 512
              wide) with Adam, batch 64 of the wmt14 surrogate: graphed
              bitwise eager, then in turns (p50, tokens/s, busy share,
              launches, the rnn's re-runs, memory), the surrogate's stream
              and a dense LoD batch of length 50, in turns, bitwise;
 23. decode_beam  the chapter's decode program (While over [B, K] lanes,
              beam_search, beam_search_decode) with beam 3 for 250 steps
              on 16 sources from the trained scope: eager under the gate's
              reason "control_flow", the host syncs (the condition's),
              ms an iteration and a request, the ids the same twice, the
              best lane at least greedy's, ServingEngine.infer's ids
              exe.run's;
 24. train_srl  the SRL chapter's db_lstm (depth 8, H 128, the conll05
              vocabularies) with linear_chain_crf and Adam, batch 64 of
              the conll05 surrogate, graphed bitwise eager, then in turns;
              Viterbi on a held-out batch, every tag in [0, 59);
 25. train_lm_recipe  the LM trained to the transformer paper's recipe
              (Adam 0.9/0.98/1e-9, noam_decay(512, 4000), label smoothing
              0.1 over one_hot labels as soft labels, the global-norm clip
              at 1.0), resumed at step 3999: graphed bitwise eager, the
              fetched LR the host's noam of the step, @STEP_COUNTER@
              advanced by the replays, the global-norm gauge a step and
              its cost, one eager step's gauge and update against the
              host's, K7/K8/K9 from a replay's trace;
 26. train_optimizers  the LM once per new optimizer (RMSProp with L1
              decay and the value clip, Adamax on piecewise_decay,
              Adadelta, DecayedAdagrad on a staircase exponential_decay,
              Ftrl with the norm clip, Adam under ModelAverage): graphed
              bitwise eager, p50, busy share, nothing densified; inside
              ModelAverage.apply the parameters and logits the host
              average's, restore bitwise;
 27. train_reader_layers  ResNet-50 O2 at batch 32 reading the flowers
              surrogate from a RecordIO file through open_recordio_file ->
              shuffle -> batch -> double_buffer -> read_file, exe.run()
              with no feed: batches and losses bitwise the fed path's,
              p50 and the consumer's wait beside train_feeder's,
              EOFException at the pass's end, K2-K6 from a replay's trace;
 28. kernel_zoo  K1-K6 at every distinct shape the gates give them on
              train_zoo's and train_ssd's steps and K1 at serve_zoo's
              (AlexNet's and GoogLeNet's 5x5 filters, GoogLeNet's 16- and
              24-channel reductions, the SSD's pointwise convs and their
              batch norms on 150x150 down to 1x1 maps): each twice
              bitwise and against its plain version, then timed beside
              the plain version, one PyTorch call and the bound;
 29. train_zoo  bench.py's alexnet and googlenet (224x224, 1000 classes,
              batch 256) and smallnet (32x32, 10 classes, batch 512),
              AMP O2, Momentum 0.9 at bench.py's rates, one repeated batch
              staged on the card: graphed bitwise eager (dropout
              included), the losses falling, p50, busy share, K1/K2/K3
              launches a step held to ZOO_LAUNCHES;
 30. serve_zoo  alexnet_infer and googlenet_infer through ServingEngine
              (buckets 1, 4, 16): each first replay bitwise eager, batch-16
              requests graphed against eager in turns, K1 from a trace;
 31. train_ssd  a MobileNet-SSD (PaddlePaddle's object-detection example:
              MobileNet-v1, four extra stages, multi_box_head over six
              maps, 2278 priors) at 300x300, 21 classes, batch 32, AMP O2,
              ssd_loss, Momentum 0.9 at 1e-3, synthetic VOC-shaped boxes
              as LoD feeds: the whole step graphed bitwise eager, K1-K6
              launches held;
 32. serve_ssd  its detection_output (multiclass_nms, nms_top_k 400,
              keep_top_k 200) served at batch 16: first replays bitwise
              eager, p50 graphed against eager, the counts the executor's
              LoD counts, kernel launches a request; then the
              detection_map op on the card (eager under host_metric, its
              host reads counted) against DetectionMAP's arithmetic over
              three batches;
 33. observe  the numeric-health plane (ROADMAP 10b-1): ResNet-50 O2 at
              batch 32, graphed, 48 steps instrumented (auto probes and a
              GradientAudit over every trainable parameter, T1 on each),
              dynamics at period 16, the flight recorder, the step log and
              tracing on: T1 held to its plain version on every probe of
              one step (counts exact), the three sampled dynamics rows to
              a host recomputation from copies of W_old, W_new and G, two
              graphs for the signature, K1-K6 launches probed against
              unprobed, the step with the plane on and off in turns; the
              LM O2 under check_nan_inf, graphed: after three clean steps
              one FFN weight element set to inf, the next step raising
              NonFiniteError naming the weight's first reader in at most
              ceil(log2(n/8)) + 2 eager replays, the eager per-op scan
              naming the same op, the scope bitwise as before the step
              and the rng counter not advanced, the crash report read
              back; the exports (Prometheus text, the step log, both
              chrome traces) parsed; the plane's host cost when off on
              SmallNet's graphed batch-8 step and the memory sample's
              cost; T1 timed per probe beside its plain version and
              bound;
 34. result   the kernel table as one JSON line, the card line, then
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
import functools
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
    # T1: its first stage, once a call
    "stats.launches": r"_stats_partial_body",
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
def _captures_uncounted(*counters):
    """A CUDA graph capture records its launches and runs none: the counts
    the kernel wrappers of `counters` (their wrappers' Counters objects)
    add while the Executor captures are taken back, so the counts hold
    only launches that ran."""
    from paddle_tpu_torch import executor as E
    capture = E.capture_graph

    def uncounted(*args, **kwargs):
        before = [{k: dict(v) if isinstance(v, dict) else v
                   for k, v in vars(c).items()} for c in counters]
        try:
            return capture(*args, **kwargs)
        finally:
            for c, fields in zip(counters, before):
                for k, v in fields.items():
                    if isinstance(v, dict):
                        getattr(c, k).clear()
                        getattr(c, k).update(v)
                    else:
                        setattr(c, k, v)
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
    # K1 at every shape vgg16 O2 training gives it (the train_graph
    # path), the f32 and bf16 forms each twice bitwise
    vgg = zoo_kernel_shapes(_vgg16_train(pt)[0], TRAIN_BATCH)[0]["K1"]
    vgg_err, vgg_err16 = 0.0, 0.0
    for xs, ws, s, p, d in vgg:
        x, wt = operands(xs, ws)
        _twice(lambda: (conv_cuda.conv2d(x, wt, s, p, d, out_dtype=torch.float32),
                        conv_cuda.conv2d(x, wt, s, p, d)))
        err, err16 = _check_kernel(conv_cuda, x, wt, s, p, d)
        vgg_err, vgg_err16 = max(vgg_err, err), max(vgg_err16, err16)
        del x, wt
    torch.cuda.empty_cache()
    worst_err, worst_err16 = max(worst_err, vgg_err), max(worst_err16, vgg_err16)
    print(f"K1 at the {len(vgg)} distinct shapes of vgg16 O2 training (batch "
          f"{TRAIN_BATCH}; {sum(vgg.values())} launches a step), twice "
          f"bitwise: max abs err f32 {vgg_err:.3g}, bf16 {vgg_err16:.3g}",
          flush=True)
    report["k1_vgg16_shapes"] = [
        {"x_nhwc": list(k[0]), "w_oihw": list(k[1]), "strides": list(k[2]),
         "paddings": list(k[3]), "per_step": n} for k, n in vgg.items()]
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
    _print_admission("slice (ResNet-50 O2)", engine)

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
    report["slice"] = {"admission": engine.admission,
                       "p50_ms": p50, "latencies_s": lat,
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


def _print_admission(what, engine):
    """The static analyzer's verdict on a served program (ServingEngine's
    admission, analysis.analyze_program): seconds and counts."""
    a = engine.admission
    print(f"{what}: admitted by analyze_program in {a['seconds']:.3f} s, "
          f"{a['error']} errors, {a['warning']} warnings, {a['info']} infos",
          flush=True)


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


def _trace_replays(engine, key, requests, per_run, what, attempts=3,
                   graph=None):
    """The replayed requests' launches, counted from one profile of them
    (SERVE_TRACE) and held to `per_run` (kernel -> launches a bucket run;
    the others none) times the requests. The profiler now and then loses a
    window's CUDA activity, so a pass whose counts differ is profiled
    again, up to `attempts` times; then this raises, with one exception:
    given the replayed bucket's `graph` (kept, _kept_graphs) whose own
    kernel nodes are `per_run`'s, a trace that lacks some launches and
    holds nothing beyond them has lost records: that is printed, and what
    was traced is returned. Returns the traced counts."""
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
        nodes = None if graph is None else _graph_launches(graph)
        if nodes is None or any(got[k] > want[k] for k in want) or any(
                nodes[c] != per_run.get(k, 0) for k, c in SERVE_TRACE.items()):
            raise RuntimeError(f"{what}: the replays' traces hold {got} "
                               f"launches, expected {want}")
        print(f"{what}: the profiler lost records of the replays in all "
              f"{attempts} attempts: (traced, expected) {got}, {want}; the "
              f"bucket's graph holds every expected launch; the traced "
              f"launches are counted", flush=True)
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
    def run(alt):
        conv_cuda.conv_plan = lambda *a, **kw: alt
        try:
            y = conv_cuda.conv2d_q8(x, w, s, p, d, dq)
            y32 = conv_cuda.conv2d_q8(x, w, s, p, d, dq,
                                      out_dtype=torch.float32)
        finally:
            conv_cuda.conv_plan = planner
        torch.cuda.synchronize()
        return y, y32

    def off(got, ref):
        bad = got != ref
        rows = bad.reshape(-1, bad.shape[-1]).any(1).nonzero().flatten()
        return (f"{int(bad.sum())} of {bad.numel()} elements off by at most "
                f"{(got.float() - ref.float()).abs().max().item():.6g}, rows "
                f"{rows[:8].tolist()}{'...' if len(rows) > 8 else ''}")

    for k in sorted(ks):
        per = -(-plan.steps // k)
        alt = dataclasses.replace(plan, splits=-(-plan.steps // per), per=per,
                                  stages=min(plan.stages, max(per, 2)))
        y, y32 = run(alt)
        if not (torch.equal(y, want) and torch.equal(y32, want32)):
            # say which output is off, where, and whether the same call
            # repeats the fault, before failing
            y_again, y32_again = run(alt)
            raise RuntimeError(
                f"K11 split {alt.splits} is not bitwise its plain version at "
                f"x {tuple(x.shape)} w {tuple(w.shape)} s{s} p{p} (plan "
                f"{dataclasses.asdict(alt)}): bf16 {off(y, want)}; f32 "
                f"{off(y32, want32)}; the same calls again: bf16 "
                f"{off(y_again, want)}, f32 {off(y32_again, want32)}")
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
        _print_admission("serve_q8 (ResNet-50 O3 from its directory)",
                         engine)
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
    report["serve_q8"] = {"admission": engine.admission,
                          "card": card, "p50_ms": p50, "latencies_s": lat,
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


VGG_LR = 0.005                      # bench.py's vgg19 entry (bench.py:115)


def _vgg16_train(pt):
    """vgg16 (models/vgg.py: img_conv_group blocks with batch norm and
    dropout, fc -> batch_norm(relu) -> dropout -> fc -> fc) at 224 x 224,
    1000 classes, trained as bench.py's CNN modes are (Momentum 0.9 at
    bench's VGG rate), AMP O2."""
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        img = pt.layers.data(name="img", shape=[3, 224, 224], dtype="float32")
        label = pt.layers.data(name="label", shape=[1], dtype="int64")
        avg_cost, _, _ = pt.models.build_image_classifier(
            pt.models.vgg16, img, label, class_dim=1000)
        opt = pt.amp.decorate(pt.optimizer.Momentum(learning_rate=VGG_LR,
                                                    momentum=0.9), level="O2")
        opt.minimize(avg_cost)
    main.random_seed = startup.random_seed = SEED + 1
    return main, startup, avg_cost


# vgg16 O2's launches per training step (the train_graph path): K1 and K2
# and K3 at its 12 convs of 8-multiple channels (the first, of 3, falls
# back under "channels"), K6 at its 13 conv batch norms (fc1's is 2-D and
# falls back under "kernel_layout"); its convs carry a bias, so no conv ->
# batch_norm window forms and K4/K5 run no time
VGG16_LAUNCHES = {"conv.launches": 12, "conv.dgrad_launches": 12,
                  "conv.wgrad_launches": 12, "bn.act_launches": 13}


def _hold_dgrad(conv_cuda, dout, w, hw, s, p, d, shape):
    """K2 twice bitwise in f32 and in bf16 (the path's dx dtype under O2):
    the f32 sum within SUM_RTOL of the plain version's, the bf16 out that
    sum rounded once. Returns the max abs error."""
    import torch
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
    return err


def _hold_wgrad(conv_cuda, x, dout, khw, s, p, d):
    """K3's dW in f32 (the master filter's dtype) twice bitwise, within
    SUM_RTOL of the plain version's. Returns the max abs error."""
    import torch
    gw = _twice(lambda: conv_cuda.conv2d_grad_filter(
        x, dout, khw, s, p, d, out_dtype=torch.float32))
    rw = conv_cuda.conv2d_grad_filter_reference(x, dout, khw, s, p, d,
                                                out_dtype=torch.float32)
    mags = conv_cuda.conv2d_grad_filter_reference(
        x.abs(), dout.abs(), khw, s, p, d, out_dtype=torch.float32)
    return _sum_err(gw, rw, mags)


def _bn_operands(m, c):
    """scale, bias, mean, var [C] f32 on the card, seeded by the shape."""
    import torch
    g = torch.Generator().manual_seed(SEED + m + c)
    scale = (1 + 0.1 * torch.randn(c, generator=g)).cuda()
    bias = (0.1 * torch.randn(c, generator=g)).cuda()
    mean = (0.1 * torch.randn(c, generator=g)).cuda()
    var = (1 + 0.2 * torch.randn(c, generator=g).abs()).cuda()
    return scale, bias, mean, var


def _hold_bn_act(bn_cuda, x, scale, bias, act, shape):
    """K6 twice bitwise: its statistics within SUM_RTOL of the plain
    version's and bitwise its own summation order's, ybn within one bf16
    ulp of the plain apply with those statistics, yact relu(ybn). Returns
    (ybn, yact, max abs error, the plain version's mean)."""
    import torch
    ybn, yact, bmean, bvar = _twice(lambda: bn_cuda.bn_act(
        x, scale, bias, 1e-5, act))
    _, _, rmean, rvar = bn_cuda.bn_act_reference(x, scale, bias, 1e-5, act)
    xf = x.float()
    err = max(_sum_err(bmean, rmean, xf.abs().mean(0)),
              _sum_err(bvar, rvar, (xf * xf).mean(0)
                       + 2 * rmean.abs() * xf.abs().mean(0)))
    del xf
    want, _ = bn_cuda.bn_apply_reference(x, scale, bias, bmean, bvar, 1e-5)
    err = max(err, _bf16_err(ybn, want))
    del want
    omean, ovar = bn_cuda.bn_act_stats_in_order(x, *bn_cuda.launch_plan(x, act))
    if not (torch.equal(bmean, omean) and torch.equal(bvar, ovar)):
        raise RuntimeError(f"K6 statistics at {shape} are not its "
                           f"summation order's bit for bit")
    if act == "relu" and not torch.equal(yact, torch.relu(ybn)):
        raise RuntimeError(f"bn_act yact is not relu(ybn) at {shape}")
    return ybn, yact, err, rmean


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


def _conv_shape_rows(conv_cuda, key, counts, randn, time_ms):
    """The kernels of `counts` (K1-K4 -> launches a step) at one conv shape
    `key` (x NHWC, w OIHW, strides, paddings, dilations) on operands from
    `randn`: K1 twice bitwise and against conv2d_reference
    (_check_kernel), K2 (_hold_dgrad), K3 (_hold_wgrad), K4 twice bitwise,
    its y bitwise K1's and its sums against the plain version's; each then
    timed by `time_ms` beside its plain version, one PyTorch call of the
    same function and the bound. -> {kernel: row}."""
    import torch
    import torch.nn.functional as F
    xs, ws, s, p, d = key
    x, w = randn(xs), randn(ws, 0.1)
    oh, ow = conv_cuda._out_hw(x, w, s, p, d)
    dout = randn((xs[0], oh, ow, ws[0]))
    hw, khw = xs[1:3], ws[2:]
    shape = f"x{list(xs)} w{list(ws)} s{list(s)} p{list(p)}"
    flops = conv_cuda.conv_flops(x, w, s, p, d)
    x_nchw, d_nchw = x.permute(0, 3, 1, 2), dout.permute(0, 3, 1, 2)
    w_view = w.contiguous(memory_format=torch.channels_last)  # as cast
    rows = {}
    if "K1" in counts:
        _twice(lambda: conv_cuda.conv2d(x, w_view, s, p, d))
        err = max(_check_kernel(conv_cuda, x, w_view, s, p, d))
        rows["K1"] = _row("conv", shape, counts["K1"],
                          time_ms(lambda: conv_cuda.conv2d(x, w_view, s, p, d)),
                          time_ms(lambda: conv_cuda.conv2d_reference(x, w, s, p, d)),
                          time_ms(lambda: F.conv2d(x_nchw, w, None, s, p, d)),
                          flops, conv_cuda.conv_bytes(x, w, s, p, d), err,
                          PEAK_BF16_FLOPS)
    if "K2" in counts:
        # dx in bf16 (as on the path) and f32, against the plain version
        err = _hold_dgrad(conv_cuda, dout, w, hw, s, p, d, shape)
        rows["K2"] = _row("dgrad", shape, counts["K2"],
                          time_ms(lambda: conv_cuda.conv2d_grad_input(dout, w, hw, s, p, d)),
                          time_ms(lambda: conv_cuda.conv2d_grad_input_reference(dout, w, hw, s, p, d)),
                          time_ms(lambda: torch.nn.grad.conv2d_input(
                              x_nchw.shape, w, d_nchw, s, p, d)),
                          # dout and w read, all of dx written
                          flops, (dout.numel() + w.numel() + x.numel()) * 2,
                          err, PEAK_BF16_FLOPS)
    if "K3" in counts:
        # dW in f32 (the master filter's dtype), against the plain version
        err = _hold_wgrad(conv_cuda, x, dout, khw, s, p, d)
        nbytes = (conv_cuda.input_bytes(x, w, s, p, d) + dout.numel() * 2
                  + w.numel() * 4)
        rows["K3"] = _row("wgrad", shape, counts["K3"],
                          time_ms(lambda: conv_cuda.conv2d_grad_filter(
                              x, dout, khw, s, p, d, out_dtype=torch.float32)),
                          time_ms(lambda: conv_cuda.conv2d_grad_filter_reference(
                              x, dout, khw, s, p, d, out_dtype=torch.float32)),
                          time_ms(lambda: torch.nn.grad.conv2d_weight(
                              x_nchw, w.shape, d_nchw, s, p, d)),
                          flops, nbytes, err, PEAK_BF16_FLOPS)
    if "K4" in counts:
        # y bitwise K1's, the sums against the plain version's
        y, csum, csq = _twice(lambda: conv_cuda.conv2d_stats(x, w, s, p, d))
        if not torch.equal(y, conv_cuda.conv2d(x, w, s, p, d)):
            raise RuntimeError(f"K4 y is not K1's at {shape}")
        ry = conv_cuda.conv2d_reference(x, w, s, p, d)
        r32 = conv_cuda.conv2d_reference(x, w, s, p, d, out_dtype=torch.float32)
        _bf16_err(y, ry, F32_ATOL + F32_RTOL * r32.abs())     # K1's rule
        yf = y.float().reshape(-1, ws[0])
        err = max(_sum_err(csum, yf.sum(0), yf.abs().sum(0)),
                  _sum_err(csq, (yf * yf).sum(0), (yf * yf).sum(0)))
        rows["K4"] = _row("conv_stats", shape, counts["K4"],
                          time_ms(lambda: conv_cuda.conv2d_stats(x, w_view, s, p, d)),
                          time_ms(lambda: conv_cuda.conv2d_stats_reference(x, w, s, p, d)),
                          None, flops + 3 * y.numel(),
                          conv_cuda.conv_bytes(x, w, s, p, d) + 8 * ws[0], err,
                          PEAK_BF16_FLOPS)
    return rows


def _bn_shape_row(bn_cuda, kind, key, n, batch, randn, time_ms, before=None):
    """K5 (`kind` "bn_apply") or K6 ("bn_act") at one [M, C] and act `key`
    on operands from `randn`: twice bitwise and against its plain version,
    yact relu(ybn), then timed by `time_ms` beside its plain version,
    F.batch_norm and the bound (K6 also beside the floor of a design that
    reads x twice, and, given the older checkout's bn_cuda `before`, its
    K6 held to the same rules and timed in turns). Prints and returns the
    row."""
    import torch
    import torch.nn.functional as F
    m, c, act = key
    x = randn((m, c), 2.0)
    scale, bias, mean, var = _bn_operands(m, c)
    x4 = x.reshape(batch, -1, c).permute(0, 2, 1).unsqueeze(-1)
    shape = f"[{m}, {c}] act={act}"
    out_bytes = m * c * 2 * (2 if act else 1)
    nbytes = m * c * 2 + 16 * c + out_bytes
    if kind == "bn_apply":
        ybn, yact = _twice(lambda: bn_cuda.bn_apply(x, scale, bias, mean,
                                                    var, 1e-5, act))
        rbn, _ = bn_cuda.bn_apply_reference(x, scale, bias, mean, var,
                                            1e-5, act)
        err = _bf16_err(ybn, rbn, floor=0.0)
        fn = lambda: bn_cuda.bn_apply(x, scale, bias, mean, var, 1e-5, act)  # noqa: E731
        plain = lambda: bn_cuda.bn_apply_reference(x, scale, bias, mean, var, 1e-5, act)  # noqa: E731
        lib = lambda: F.batch_norm(x4, mean, var, scale, bias, False, 0.0, 1e-5)  # noqa: E731
        flops = (4 if act else 3) * m * c
    else:
        ybn, yact, err, rmean = _hold_bn_act(bn_cuda, x, scale, bias, act,
                                             shape)
        fn = lambda: bn_cuda.bn_act(x, scale, bias, 1e-5, act)  # noqa: E731
        plain = lambda: bn_cuda.bn_act_reference(x, scale, bias, 1e-5, act)  # noqa: E731
        lib = lambda: F.batch_norm(x4, None, None, scale, bias, True, 0.0, 1e-5)  # noqa: E731
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
        ms = time_ms(fn)
    row = _row(kind, shape, n, ms, time_ms(plain), time_ms(lib), flops,
               nbytes, err, PEAK_F32_FLOPS)
    row.update(extra)
    if kind == "bn_act":
        # a design that reads x from device memory twice
        row["two_pass_floor_ms"] = (nbytes + m * c * 2) / PEAK_BYTES * 1e3
    print(f"{kind} {shape} x{n}/step: {row['ms']:.4f} ms, plain "
          f"{row['plain_ms']:.4f} ms, F.batch_norm "
          f"{row['library_ms']:.4f} ms, bound "
          f"{row['bound_ms']:.4f} ms"
          + (f" (two-pass floor {row['two_pass_floor_ms']:.4f})"
             if kind == "bn_act" else "")
          + ("" if old_ms is None else
             f", parent tree {old_ms:.4f} ms (in turns new, parent, "
             f"parent, new: " + ", ".join(f"{t:.4f}" for t in
                                          extra["turns"]) + ")"),
          flush=True)
    return row


def phase_kernel_train(pt, conv_cuda, bn_cuda, resnet, report, parent=None):
    """K2-K6 at every distinct ResNet-50 training shape at batch 32: held
    against the plain versions, twice bitwise, then timed; K6 also beside
    the older checkout `parent`'s K6, in turns, when one is given. Then K2,
    K3 and K6 at every distinct vgg16 O2 training shape at batch 32, held
    the same way (not timed)."""
    import torch
    gen = torch.Generator().manual_seed(SEED + 3)
    before = None if parent is None else parent_bn_cuda(parent)

    def randn(shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(torch.bfloat16).cuda()

    main = _resnet50_train(pt, resnet)[0]
    tables = zoo_kernel_shapes(main, TRAIN_BATCH)[0]
    convs, applies, acts = tables["K4"], tables["K5"], tables["K6"]
    rows = []
    for key, n in convs.items():
        got = _conv_shape_rows(conv_cuda, key, {"K2": n, "K3": n, "K4": n},
                               randn, _device_ms)
        rows += [got["K2"], got["K3"], got["K4"]]
        print(f"K2/K3/K4 {rows[-1]['shape']} x{n}/step: " + "; ".join(
            f"{r['kernel']} {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} "
            f"{r['bound_by']}, plain {r['plain_ms']:.4f}, library "
            + (f"{r['library_ms']:.4f})" if r["library_ms"] is not None
               else "none)") for r in rows[-3:]), flush=True)

    for kind, table in (("bn_apply", applies), ("bn_act", acts)):
        for key, n in table.items():
            rows.append(_bn_shape_row(bn_cuda, kind, key, n, TRAIN_BATCH,
                                      randn, _device_ms, before))
    torch.cuda.empty_cache()
    report["train_kernel_shapes"] = rows

    # vgg16 O2 training (the train_graph path): K2, K3 and K6 at each of
    # its shapes, held as ResNet's are and twice bitwise; not timed
    tables, refused = zoo_kernel_shapes(_vgg16_train(pt)[0], TRAIN_BATCH)
    path_launches("vgg16", tables)
    k2, k3, k6 = tables["K2"], tables["K3"], tables["K6"]
    vgg_err = {"dgrad": 0.0, "wgrad": 0.0, "bn_act": 0.0}
    for key in sorted(set(k2) | set(k3)):
        xs, ws, s, p, d = key
        x, w = randn(xs), randn(ws, 0.1)
        oh, ow = conv_cuda._out_hw(x, w, s, p, d)
        dout = randn((xs[0], oh, ow, ws[0]))
        shape = f"x{list(xs)} w{list(ws)} s{list(s)} p{list(p)}"
        if key in k2:
            vgg_err["dgrad"] = max(vgg_err["dgrad"], _hold_dgrad(
                conv_cuda, dout, w, xs[1:3], s, p, d, shape))
        if key in k3:
            vgg_err["wgrad"] = max(vgg_err["wgrad"], _hold_wgrad(
                conv_cuda, x, dout, ws[2:], s, p, d))
        del x, w, dout
    for m, c, act in k6:
        x = randn((m, c), 2.0)
        scale, bias, _, _ = _bn_operands(m, c)
        err = _hold_bn_act(bn_cuda, x, scale, bias, act,
                           f"[{m}, {c}] act={act}")[2]
        vgg_err["bn_act"] = max(vgg_err["bn_act"], err)
        del x
    torch.cuda.empty_cache()
    print(f"vgg16 O2 training (batch {TRAIN_BATCH}): K2 at {len(k2)} "
          f"distinct shapes ({sum(k2.values())} a step), K3 at {len(k3)} "
          f"({sum(k3.values())}), K6 at {len(k6)} ({sum(k6.values())}: "
          f"{sorted(k6)}), each twice bitwise and against its plain "
          f"version: max abs err {vgg_err}; K6 refused {refused}",
          flush=True)
    report["vgg16_train_kernel_checks"] = {
        "dgrad": [list(map(list, k[:2])) for k in k2],
        "wgrad": [list(map(list, k[:2])) for k in k3],
        "bn_act": [list(k) for k in k6], "max_abs_err": vgg_err,
        "bn_act_refused": {str(k): n for k, n in refused.items()}}

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
                        "max_abs_err": max([r["max_abs_err"] for r in rs]
                                           + [vgg_err.get(name, 0.0)]),
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
    records: that is printed and returned (`lost_records`), not raised,
    and the busy time read from that trace is a lower bound
    (`busy_lower_bound`)."""
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
    bound = (f"; a lower bound: the trace lost {sum(lost.values())} "
             f"records" if lost else "")
    print(f"profiled step: device busy {busy_ms:.2f} ms = {busy_ms / p50_ms:.1%} "
          f"of the step p50 {p50_ms:.2f} ms (profiled wall {wall_ms:.1f} ms"
          f"{bound}; {card})", flush=True)
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
            "lost_records": lost, "busy_lower_bound": bool(lost),
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


def _sentiment_conv(pt, data, input_dim, class_dim=2, emb_dim=32,
                    hid_dim=32):
    emb = pt.layers.embedding(input=data, size=[input_dim, emb_dim])
    conv_3 = pt.nets.sequence_conv_pool(input=emb, num_filters=hid_dim,
                                        filter_size=3, act="tanh",
                                        pool_type="sqrt")
    conv_4 = pt.nets.sequence_conv_pool(input=emb, num_filters=hid_dim,
                                        filter_size=4, act="tanh",
                                        pool_type="sqrt")
    return pt.layers.fc(input=[conv_3, conv_4], size=class_dim)


def _sentiment_stacked_lstm(pt, data, input_dim, class_dim=2, emb_dim=32,
                            hid_dim=32, stacked_num=3):
    emb = pt.layers.embedding(input=data, size=[input_dim, emb_dim])
    fc1 = pt.layers.fc(input=emb, size=hid_dim, num_flatten_dims=2)
    lstm1, _cell1 = pt.layers.dynamic_lstm(input=fc1, size=hid_dim)
    inputs = [fc1, lstm1]
    for i in range(2, stacked_num + 1):
        fc = pt.layers.fc(input=inputs, size=hid_dim, num_flatten_dims=2)
        lstm, _cell = pt.layers.dynamic_lstm(input=fc, size=hid_dim,
                                             is_reverse=(i % 2) == 0)
        inputs = [fc, lstm]
    fc_last = pt.layers.sequence_pool(input=inputs[0], pool_type="max")
    lstm_last = pt.layers.sequence_pool(input=inputs[1], pool_type="max")
    return pt.layers.fc(input=[fc_last, lstm_last], size=class_dim)


def book_understand_sentiment(pt, place, net):
    """tests/book/test_understand_sentiment.py: the conv net (two
    sequence_conv_pool, sqrt pooling) or the three stacked LSTMs over imdb
    word sequences fed as LoDTensors; Adam 2e-3, batch 32, 31 steps; the
    last 5 steps' accuracy above 0.8; the inference round trip over a
    LoDTensor of two sequences."""
    main, startup, stack = _chapter(pt)
    with stack:
        word_dict = pt.dataset.imdb.word_dict()
        dict_dim = len(word_dict)
        data = pt.layers.data(name="words", shape=[1], dtype="int64",
                              lod_level=1)
        label = pt.layers.data(name="label", shape=[1], dtype="int64")
        build = _sentiment_conv if net == "conv" else _sentiment_stacked_lstm
        logits = build(pt, data, dict_dim)
        cost = pt.layers.softmax_with_cross_entropy(logits=logits, label=label)
        avg_cost = pt.layers.mean(cost)
        acc = pt.layers.accuracy(input=pt.layers.softmax(logits), label=label)
        pt.optimizer.Adam(learning_rate=2e-3).minimize(avg_cost)
        train = pt.batch(pt.reader.shuffle(pt.dataset.imdb.train(word_dict),
                                           buf_size=1000), batch_size=32)
        exe = pt.Executor(place)
        feeder = pt.DataFeeder(place=place, feed_list=[data, label])
        exe.run(startup)
        accs, losses = [], []
        for i, batch in enumerate(train()):
            batch = [([[w] for w in ws], [lb]) for ws, lb in batch]
            loss, a = exe.run(main, feed=feeder.feed(batch),
                              fetch_list=[avg_cost, acc])
            accs.append(float(a.ravel()[0]))
            losses.append(float(loss.ravel()[0]))
            if i >= 30:
                break
        if not np.mean(accs[-5:]) > 0.8:
            raise RuntimeError(f"understand_sentiment[{net}]: accuracy {accs}")
        rng = np.random.RandomState(0)
        rows = [rng.randint(0, dict_dim, (n, 1)).astype(np.int64)
                for n in (5, 3)]
        feed = {"words": pt.LoDTensor(np.concatenate(rows, 0), [[0, 5, 8]])}
        out, = _infer_roundtrip(pt, exe, place, feed, [logits], main)
        if out.shape != (2, 2) or not np.isfinite(out).all():
            raise RuntimeError(f"understand_sentiment[{net}]: inference "
                               f"gave {out.shape}")
    return {"steps": len(accs), "last_accuracy": accs[-5:],
            "last_losses": losses[-5:]}


def book_recommender_system(pt, place):
    """tests/book/test_recommender_system.py: user and movie features
    (embeddings, fc, the category and title sequences sum-pooled), their
    cos_sim scaled by 5 against the score; Adam 2e-3, batch 64, 41 steps;
    the last loss below the first and the last 5 losses' mean below 2.5;
    the inference round trip with LoDTensor category and title feeds."""
    main, startup, stack = _chapter(pt)
    with stack:
        ml = pt.dataset.movielens
        uid = pt.layers.data(name="user_id", shape=[1], dtype="int64")
        gender = pt.layers.data(name="gender_id", shape=[1], dtype="int64")
        age = pt.layers.data(name="age_id", shape=[1], dtype="int64")
        job = pt.layers.data(name="job_id", shape=[1], dtype="int64")
        mid = pt.layers.data(name="movie_id", shape=[1], dtype="int64")
        category = pt.layers.data(name="category_id", shape=[1],
                                  dtype="int64", lod_level=1)
        title = pt.layers.data(name="movie_title", shape=[1], dtype="int64",
                               lod_level=1)
        score = pt.layers.data(name="score", shape=[1], dtype="float32")

        def fc_emb(var, size, dim=16):
            e = pt.layers.embedding(input=var, size=[size, dim])
            return pt.layers.fc(input=e, size=16)

        usr = pt.layers.concat(
            [fc_emb(uid, ml.max_user_id() + 1), fc_emb(gender, 2),
             fc_emb(age, 8), fc_emb(job, ml.max_job_id() + 1)], axis=1)
        usr_feat = pt.layers.fc(input=usr, size=32, act="tanh")
        mov_emb = fc_emb(mid, ml.max_movie_id() + 1)
        cat_pool = pt.layers.sequence_pool(
            pt.layers.embedding(input=category, size=[18, 16]), "sum")
        tit_pool = pt.layers.sequence_pool(
            pt.layers.embedding(input=title, size=[5175, 16]), "sum")
        mov = pt.layers.concat([mov_emb, cat_pool, tit_pool], axis=1)
        mov_feat = pt.layers.fc(input=mov, size=32, act="tanh")
        predict = pt.layers.scale(pt.layers.cos_sim(X=usr_feat, Y=mov_feat),
                                  scale=5.0)
        avg_cost = pt.layers.mean(
            pt.layers.square_error_cost(input=predict, label=score))
        pt.optimizer.Adam(learning_rate=2e-3).minimize(avg_cost)
        train = pt.batch(ml.train(), batch_size=64)
        exe = pt.Executor(place)
        feeder = pt.DataFeeder(place=place, feed_list=[
            uid, gender, age, job, mid, category, title, score])
        exe.run(startup)
        losses = []
        for i, batch in enumerate(train()):
            losses.append(float(exe.run(main, feed=feeder.feed(batch),
                                        fetch_list=[avg_cost])[0].ravel()[0]))
            if i >= 40:
                break
        if not (losses[-1] < losses[0] and np.mean(losses[-5:]) < 2.5):
            raise RuntimeError(f"recommender_system: losses {losses}")
        rng = np.random.RandomState(0)
        feed = {"user_id": rng.randint(0, 100, (3, 1)).astype(np.int64),
                "gender_id": rng.randint(0, 2, (3, 1)).astype(np.int64),
                "age_id": rng.randint(0, 7, (3, 1)).astype(np.int64),
                "job_id": rng.randint(0, 10, (3, 1)).astype(np.int64),
                "movie_id": rng.randint(0, 100, (3, 1)).astype(np.int64),
                "category_id": pt.LoDTensor(
                    rng.randint(0, 18, (5, 1)).astype(np.int64),
                    [[0, 2, 4, 5]]),
                "movie_title": pt.LoDTensor(
                    rng.randint(0, 5175, (7, 1)).astype(np.int64),
                    [[0, 3, 5, 7]])}
        out, = _infer_roundtrip(pt, exe, place, feed, [predict], main)
        if out.shape != (3, 1) or not np.isfinite(out).all():
            raise RuntimeError(f"recommender_system: inference gave "
                               f"{out.shape}")
    return {"steps": len(losses), "first_loss": losses[0],
            "last_loss": losses[-1], "last_losses": losses[-5:]}


def book_image_classification_vgg(pt, place):
    """tests/book/test_image_classification.py[vgg]: vgg16 (img_conv_group
    with batch norm and dropout) on cifar10, Adam 2e-4, batch 16, 16
    steps; the last 5 losses' mean below the first 5's; the probabilities
    of the inference round trip sum to 1. The reader is seeded
    (`_chapter`), where the reference's draws from an unseeded `random`."""
    main, startup, stack = _chapter(pt)
    with stack:
        img = pt.layers.data(name="img", shape=[3, 32, 32], dtype="float32")
        label = pt.layers.data(name="label", shape=[1], dtype="int64")
        avg_cost, predict, acc = pt.models.build_image_classifier(
            pt.models.vgg16, img, label, class_dim=10)
        pt.optimizer.Adam(learning_rate=2e-4).minimize(avg_cost)
        train = pt.batch(pt.reader.shuffle(pt.dataset.cifar.train10(),
                                           buf_size=512), batch_size=16)
        exe = pt.Executor(place)
        feeder = pt.DataFeeder(place=place, feed_list=[img, label])
        exe.run(startup)
        losses = []
        for i, data in enumerate(train()):
            data = [(np.reshape(im, (3, 32, 32)), lb) for im, lb in data]
            loss, _ = exe.run(main, feed=feeder.feed(data),
                              fetch_list=[avg_cost, acc])
            losses.append(float(loss.ravel()[0]))
            if i >= 15:
                break
        if not np.mean(losses[-5:]) < np.mean(losses[:5]):
            raise RuntimeError(f"image_classification[vgg]: losses {losses}")
        xs = np.random.RandomState(0).rand(4, 3, 32, 32).astype(np.float32)
        probs, = _infer_roundtrip(pt, exe, place, {"img": xs}, [predict], main,
                                  rtol=1e-3, atol=1e-5)
        np.testing.assert_allclose(probs.sum(axis=1), np.ones(4), rtol=1e-3)
    return {"steps": len(losses), "first_losses": losses[:5],
            "last_losses": losses[-5:]}


# --- the control-flow chapters: machine translation, SRL, beam search ---------

MT_BOOK = {"dict": 200, "word": 16, "hid": 32}
MT_START, MT_END = 0, 1
MT_BEAM = 3
MT_BOOK_MAX_LEN = 8


def mt_encoder(pt, src, cfg):
    """The shared encoder of tests/book/test_machine_translation.py:
    embedding, fc(4H, tanh), dynamic_lstm(H), the last step; the
    parameters named so the decode programs reuse the trained ones."""
    L, A = pt.layers, pt.ParamAttr
    src_emb = L.embedding(input=src, size=[cfg["dict"], cfg["word"]],
                          param_attr=A(name="src_emb_w"))
    fc1 = L.fc(input=src_emb, size=cfg["hid"] * 4, num_flatten_dims=2,
               act="tanh", param_attr=A(name="enc_fc_w"),
               bias_attr=A(name="enc_fc_b"))
    enc_hidden, _ = L.dynamic_lstm(input=fc1, size=cfg["hid"] * 4,
                                   param_attr=A(name="enc_lstm_w"),
                                   bias_attr=A(name="enc_lstm_b"))
    return enc_hidden, L.sequence_last_step(enc_hidden)


def mt_encoder_decoder(pt, cfg):
    """The chapter's teacher-forced training graph: a DynamicRNN decoder
    with dot-product attention over the encoder states (sequence_expand,
    sequence_softmax, sequence_pool inside the step block) -> (src, trg,
    logits [B, T, dict])."""
    L, A = pt.layers, pt.ParamAttr
    src = L.data(name="src_word_id", shape=[1], dtype="int64", lod_level=1)
    enc_hidden, enc_last = mt_encoder(pt, src, cfg)
    trg = L.data(name="target_language_word", shape=[1], dtype="int64",
                 lod_level=1)
    trg_emb = L.embedding(input=trg, size=[cfg["dict"], cfg["word"]],
                          param_attr=A(name="trg_emb_w"))
    rnn = L.DynamicRNN()
    with rnn.block():
        x_t = rnn.step_input(trg_emb)
        mem = rnn.memory(init=enc_last)
        expanded = L.sequence_expand(x=mem, y=enc_hidden)
        scores = L.reduce_sum(L.elementwise_mul(expanded, enc_hidden), dim=2,
                              keep_dim=False)
        weights = L.sequence_softmax(scores)
        context = L.sequence_pool(
            L.elementwise_mul(enc_hidden, weights, axis=0), "sum")
        h = L.fc(input=L.concat([context, x_t, mem], axis=1),
                 size=cfg["hid"], act="tanh", param_attr=A(name="dec_fc_w"),
                 bias_attr=A(name="dec_fc_b"))
        rnn.update_memory(mem, h)
        rnn.step_output(L.fc(input=h, size=cfg["dict"],
                             param_attr=A(name="dec_out_w"),
                             bias_attr=A(name="dec_out_b")))
    return src, trg, rnn()


def mt_train_net(pt, cfg, lr):
    """The training program's layers and Adam -> (feed vars, avg cost,
    logits)."""
    src, trg, logits = mt_encoder_decoder(pt, cfg)
    label = pt.layers.data(name="target_language_next_word", shape=[1],
                           dtype="int64", lod_level=1)
    avg_cost = pt.layers.mean(pt.layers.softmax_with_cross_entropy(
        logits=logits, label=label, seq_mask=True))
    pt.optimizer.Adam(learning_rate=lr).minimize(avg_cost)
    return [src, trg, label], avg_cost, logits


def _lane_step(pt, pre_ids, mem, enc_hidden, neg_mask, k, cfg):
    """One decoder step on [B, K] lanes with the trained parameters:
    attention by matmul over the encoder states, padded positions masked
    by neg_mask [B, T]."""
    L, A = pt.layers, pt.ParamAttr
    tok_emb = L.embedding(input=pre_ids, size=[cfg["dict"], cfg["word"]],
                          param_attr=A(name="trg_emb_w"))
    if k == 1:
        tok_emb = L.reshape(tok_emb, shape=[-1, 1, cfg["word"]])
    scores = L.matmul(mem, enc_hidden, transpose_y=True)            # [B,K,T]
    scores_t = L.elementwise_add(L.transpose(scores, [0, 2, 1]), neg_mask,
                                 axis=0)
    weights = L.softmax(L.transpose(scores_t, [0, 2, 1]))
    context = L.matmul(weights, enc_hidden)                          # [B,K,H]
    h = L.fc(input=L.concat([context, tok_emb, mem], axis=2),
             size=cfg["hid"], act="tanh", num_flatten_dims=2,
             param_attr=A(name="dec_fc_w"), bias_attr=A(name="dec_fc_b"))
    logits = L.fc(input=h, size=cfg["dict"], num_flatten_dims=2,
                  param_attr=A(name="dec_out_w"),
                  bias_attr=A(name="dec_out_b"))
    return h, logits


def mt_decode_net(pt, cfg, beam_size, use_beam, max_len):
    """The chapter's generation program (decode_main): a While loop over
    dense [B, K] lanes, beam_search when use_beam, else the argmax (K 1);
    tensor arrays of ids, parents and scores backtracked by
    beam_search_decode -> (src, sentences [B, K, max_len + 1], scores
    [B, K])."""
    L = pt.layers
    src = L.data(name="src_word_id", shape=[1], dtype="int64", lod_level=1)
    enc_hidden, enc_last = mt_encoder(pt, src, cfg)
    neg_mask = L.scale(L.sequence_mask(enc_hidden), scale=1e9, bias=-1e9)
    k = beam_size
    counter = L.fill_constant(shape=[1], dtype="int64", value=0)
    limit = L.fill_constant(shape=[1], dtype="int64", value=max_len)
    init_ids = L.fill_constant_batch_size_like(
        input=enc_last, shape=[-1, k], dtype="int64", value=MT_START)
    lane_penalty = L.assign(np.concatenate(
        [[0.0], np.full(k - 1, -1e9)]).astype(np.float32))
    init_scores = L.elementwise_add(L.fill_constant_batch_size_like(
        input=enc_last, shape=[-1, k], dtype="float32", value=0.0),
        lane_penalty, axis=1)
    cap = max_len + 1
    ids_arr = L.array_write(init_ids, counter, capacity=cap)
    parents_arr = L.array_write(L.cast(init_ids, "int32"), counter,
                                capacity=cap)
    scores_arr = L.array_write(init_scores, counter, capacity=cap)
    pre_ids = L.assign(init_ids)
    pre_scores = L.assign(init_scores)
    z = L.fill_constant_batch_size_like(input=enc_last,
                                        shape=[-1, cfg["hid"], k],
                                        dtype="float32", value=0.0)
    mem = L.transpose(L.elementwise_add(z, enc_last, axis=0), [0, 2, 1])
    cond = L.less_than(x=counter, y=limit)
    w = L.While(cond=cond)
    with w.block():
        h, logits = _lane_step(pt, pre_ids, mem, enc_hidden, neg_mask, k,
                               cfg)
        logp = L.log(L.softmax(logits))
        if use_beam:
            sel_ids, sel_scores, parent = L.beam_search(
                pre_ids=pre_ids, pre_scores=pre_scores, scores=logp,
                beam_size=k, end_id=MT_END)
        else:
            sel_ids = L.cast(L.argmax(logp, axis=2), "int64")
            sel_scores = L.elementwise_add(
                pre_scores, L.reduce_max(logp, dim=2, keep_dim=False))
            parent = L.cast(L.fill_constant_batch_size_like(
                input=sel_scores, shape=[-1, k], dtype="int64", value=0),
                "int32")
        L.increment(counter, value=1, in_place=True)
        L.array_write(sel_ids, counter, array=ids_arr)
        L.array_write(parent, counter, array=parents_arr)
        L.array_write(sel_scores, counter, array=scores_arr)
        L.assign(sel_ids, pre_ids)
        L.assign(sel_scores, pre_scores)
        L.assign(h, mem)
        L.less_than(x=counter, y=limit, cond=cond)
    sentences, final_scores = L.beam_search_decode(
        ids_arr, parents_arr, scores=scores_arr, end_id=MT_END)
    return src, sentences, final_scores


def mt_toy_pairs(n, rng, dict_size):
    """The decode test's copy-reverse task: target = the source reversed."""
    pairs = []
    for _ in range(n):
        s = rng.randint(2, dict_size, rng.randint(2, 5)).tolist()
        pairs.append((s, [MT_START] + s[::-1], s[::-1] + [MT_END]))
    return pairs


def _mt_rows(pairs):
    return [([[w] for w in s], [[w] for w in t], [[w] for w in nx])
            for s, t, nx in pairs]


def book_machine_translation_train(pt, place):
    """tests/book/test_machine_translation.py::test_machine_translation_train:
    the DynamicRNN decoder with attention, dict 200, Adam 4e-3, batch 16
    of the wmt14 reader shuffled, 2 epochs of at most 101 batches; the
    last 5 losses' mean below 0.8 of the first."""
    main, startup, stack = _chapter(pt)
    with stack:
        feeds, avg_cost, _logits = mt_train_net(pt, MT_BOOK, 4e-3)
        train = pt.batch(pt.reader.shuffle(
            pt.dataset.wmt14.train(MT_BOOK["dict"]), buf_size=1000),
            batch_size=16)
        exe = pt.Executor(place)
        feeder = pt.DataFeeder(place=place, feed_list=feeds)
        exe.run(startup)
        losses = []
        for _epoch in range(2):
            for i, data in enumerate(train()):
                loss, = exe.run(main, feed=feeder.feed(_mt_rows(data)),
                                fetch_list=[avg_cost])
                losses.append(float(loss.ravel()[0]))
                if i >= 100:
                    break
        if not np.mean(losses[-5:]) < losses[0] * 0.8:
            raise RuntimeError(f"machine_translation[train]: losses "
                               f"{losses[0]} -> {losses[-5:]}")
    return {"steps": len(losses), "first_loss": losses[0],
            "last_losses": losses[-5:]}


def book_machine_translation_decode(pt, place):
    """tests/book/test_machine_translation.py::test_machine_translation_decode:
    30 Adam 5e-3 steps of 16 copy-reverse pairs; the teacher-forced
    logits' inference round trip; then beam (K 3) and greedy decodes of
    two sources for MT_BOOK_MAX_LEN steps from the trained scope: ids in
    the dict, each hypothesis starting at <s>, the beam's lanes ranked,
    its best lane scoring at least greedy's."""
    main, startup, stack = _chapter(pt)
    with stack:
        rng = np.random.RandomState(5)
        feeds, avg_cost, logits = mt_train_net(pt, MT_BOOK, 5e-3)
        exe = pt.Executor(place)
        feeder = pt.DataFeeder(place=place, feed_list=feeds)
        exe.run(startup)
        losses = []
        for _ in range(30):
            loss, = exe.run(main, feed=feeder.feed(_mt_rows(mt_toy_pairs(
                16, rng, MT_BOOK["dict"]))), fetch_list=[avg_cost])
            losses.append(float(loss.ravel()[0]))
        if not losses[-1] < losses[0]:
            raise RuntimeError(f"machine_translation[decode]: losses {losses}")
        rt = feeder.feed(_mt_rows(mt_toy_pairs(3, rng, MT_BOOK["dict"])))
        rt = {k: v for k, v in rt.items()
              if k in ("src_word_id", "target_language_word")}
        out, = _infer_roundtrip(pt, exe, place, rt, [logits], main)
        if not np.isfinite(np.asarray(out)).all():
            raise RuntimeError("machine_translation[decode]: round trip")
        src = {"src_word_id": pt.LoDTensor(
            np.array([[3], [7], [9], [12], [4]], np.int64), [[0, 3, 5]])}
        res = {}
        for name, k, use_beam in (("beam", MT_BEAM, True),
                                  ("greedy", 1, False)):
            prog = pt.Program()
            with pt.program_guard(prog, pt.Program()):
                _, sent, scores = mt_decode_net(pt, MT_BOOK, k, use_beam,
                                                MT_BOOK_MAX_LEN)
            ids, sc = exe.run(prog, feed=src, fetch_list=[sent, scores])
            if ids.shape[:2] != (2, k) or (ids < 0).any() or \
                    (ids >= MT_BOOK["dict"]).any() or \
                    (ids[:, :, 0] != MT_START).any():
                raise RuntimeError(f"machine_translation[decode] {name}: "
                                   f"ids {ids}")
            res[name] = (ids, sc)
        ids, sc = res["beam"]
        if not (np.diff(sc, axis=1) <= 1e-5).all() or \
                not (sc[:, 0] >= res["greedy"][1][:, 0] - 1e-4).all():
            raise RuntimeError(f"machine_translation[decode]: beam scores "
                               f"{sc}, greedy {res['greedy'][1]}")
    return {"steps": len(losses), "first_loss": losses[0],
            "last_loss": losses[-1], "beam_best": sc[:, 0].tolist(),
            "greedy": res["greedy"][1][:, 0].tolist()}


SRL_BOOK = {"word_dict": 2000, "emb": 16, "mark_emb": 16, "hid": 32,
            "depth": 3}
SRL_NAMES = ("word_data", "verb_data", "ctx_n2_data", "ctx_n1_data",
             "ctx_0_data", "ctx_p1_data", "ctx_p2_data", "mark_data")


def srl_db_lstm(pt, feeds, cfg):
    """The chapter's db_lstm: eight embeddings (the six word slots share
    one table), fc(H, tanh) over them, an LSTM, then depth - 1 more fc(4H)
    + LSTM layers alternating in direction, the emissions an fc to the
    label count."""
    L = pt.layers
    word, predicate, c_n2, c_n1, c_0, c_p1, c_p2, mark = feeds
    conll = pt.dataset.conll05
    embs = [L.embedding(input=w, size=[cfg["word_dict"], cfg["emb"]],
                        param_attr=pt.ParamAttr(name="word_emb"))
            for w in (word, c_n2, c_n1, c_0, c_p1, c_p2)]
    embs.append(L.embedding(input=predicate,
                            size=[conll.PRED_VOCAB, cfg["emb"]]))
    embs.append(L.embedding(input=mark,
                            size=[conll.MARK_VOCAB, cfg["mark_emb"]]))
    hidden_0 = L.fc(input=embs, size=cfg["hid"], num_flatten_dims=2,
                    act="tanh")
    lstm_0, _ = L.dynamic_lstm(input=L.fc(input=hidden_0,
                                          size=cfg["hid"] * 4,
                                          num_flatten_dims=2),
                               size=cfg["hid"] * 4)
    input_tmp = [hidden_0, lstm_0]
    for i in range(cfg["depth"] - 1):
        mix = L.fc(input=input_tmp, size=cfg["hid"] * 4, num_flatten_dims=2)
        lstm, _ = L.dynamic_lstm(input=mix, size=cfg["hid"] * 4,
                                 is_reverse=(i % 2 == 0))
        input_tmp = [mix, lstm]
    return L.fc(input=input_tmp, size=conll.LABEL_N, num_flatten_dims=2)


def srl_net(pt, cfg, lr):
    """-> (feed vars, target, avg CRF cost, Viterbi path): the CRF's
    transition `crfw` shared by the cost and the decode."""
    feeds = [pt.layers.data(name=n, shape=[1], dtype="int64", lod_level=1)
             for n in SRL_NAMES]
    target = pt.layers.data(name="target", shape=[1], dtype="int64",
                            lod_level=1)
    emission = srl_db_lstm(pt, feeds, cfg)
    crf_cost = pt.layers.linear_chain_crf(
        input=emission, label=target, param_attr=pt.ParamAttr(name="crfw"))
    avg_cost = pt.layers.mean(crf_cost)
    pt.optimizer.Adam(learning_rate=lr).minimize(avg_cost)
    decode = pt.layers.crf_decoding(input=emission,
                                    param_attr=pt.ParamAttr(name="crfw"))
    return feeds, target, avg_cost, decode


def srl_book_sample(rng, label_n):
    """The chapter's sample: word-determined tags (learnable)."""
    ln = int(rng.randint(4, 12))
    words = rng.randint(0, 200, ln)
    pred_id = int(rng.randint(0, 50))
    ctxs = [np.roll(words, k) for k in (-2, -1, 0, 1, 2)]
    mark = (rng.rand(ln) < 0.2).astype(np.int64)
    return (words, np.full(ln, pred_id), *ctxs, mark, (words * 7) % label_n)


def book_label_semantic_roles(pt, place):
    """tests/book/test_label_semantic_roles.py: db_lstm (depth 3, H 32,
    2000 words), linear_chain_crf, Adam 5e-3, 55 steps of 16 samples; the
    last 10 losses' mean below 0.7 of the first 10's; Viterbi tags in
    [0, 59) on a batch of 4; the Viterbi program's inference round
    trip."""
    main, startup, stack = _chapter(pt)
    with stack:
        label_n = pt.dataset.conll05.LABEL_N
        feeds, target, avg_cost, decode = srl_net(pt, SRL_BOOK, 5e-3)
        exe = pt.Executor(place)
        feeder = pt.DataFeeder(place=place, feed_list=feeds + [target])
        exe.run(startup)
        rng = np.random.RandomState(0)

        def batch(n):
            return [tuple([[int(v)] for v in f]
                          for f in srl_book_sample(rng, label_n))
                    for _ in range(n)]
        losses = []
        for _ in range(55):
            loss, = exe.run(main, feed=feeder.feed(batch(16)),
                            fetch_list=[avg_cost])
            losses.append(float(loss.ravel()[0]))
        if not np.mean(losses[-10:]) < np.mean(losses[:10]) * 0.7:
            raise RuntimeError(f"label_semantic_roles: losses {losses[:5]} "
                               f"-> {losses[-5:]}")
        path, = exe.run(main, feed=feeder.feed(batch(4)), fetch_list=[decode])
        if not (np.issubdtype(path.dtype, np.integer) and (path >= 0).all()
                and (path < label_n).all()):
            raise RuntimeError(f"label_semantic_roles: Viterbi path {path}")
        samples = [srl_book_sample(rng, label_n) for _ in range(4)]
        feed = _seq_feeds(pt, samples, SRL_NAMES)
        rt, = _infer_roundtrip(pt, exe, place, feed, [decode], main)
        if not ((np.asarray(rt) >= 0).all() and
                (np.asarray(rt) < label_n).all()):
            raise RuntimeError(f"label_semantic_roles: round trip {rt}")
    return {"steps": len(losses), "first_losses": losses[:10],
            "last_losses": losses[-10:]}


BEAM_BOOK = {"vocab": 50, "beam": 4, "max_len": 6, "hid": 16}


def beam_decode_net(pt, capacity=None, cfg=BEAM_BOOK):
    """tests/book/test_beam_search_decode.py's program: a summed source
    embedding, a While loop of embedding -> fc -> log softmax ->
    beam_search over [B, K] lanes, the arrays backtracked -> (src,
    sentences, scores)."""
    L = pt.layers
    v, k, max_len = cfg["vocab"], cfg["beam"], cfg["max_len"]
    capacity = max_len + 1 if capacity is None else capacity
    src = L.data(name="src", shape=[1], dtype="int64", lod_level=1)
    enc = L.sequence_pool(L.embedding(input=src, size=[v, cfg["hid"]]), "sum")
    counter = L.fill_constant(shape=[1], dtype="int64", value=0)
    limit = L.fill_constant(shape=[1], dtype="int64", value=max_len)
    init_ids = L.fill_constant_batch_size_like(
        input=enc, shape=[-1, k], dtype="int64", value=MT_START)
    lane_penalty = L.assign(np.concatenate(
        [[0.0], np.full(k - 1, -1e9)]).astype(np.float32))
    init_scores = L.elementwise_add(L.fill_constant_batch_size_like(
        input=enc, shape=[-1, k], dtype="float32", value=0.0),
        lane_penalty, axis=1)
    ids_arr = L.array_write(init_ids, counter, capacity=capacity)
    parents_arr = L.array_write(L.cast(init_ids, "int32"), counter,
                                capacity=capacity)
    scores_arr = L.array_write(init_scores, counter, capacity=capacity)
    pre_ids, pre_scores = L.assign(init_ids), L.assign(init_scores)
    cond = L.less_than(x=counter, y=limit)
    w = L.While(cond=cond)
    with w.block():
        tok_emb = L.embedding(input=pre_ids, size=[v, cfg["hid"]])
        logp = L.log(L.softmax(L.fc(input=tok_emb, size=v,
                                    num_flatten_dims=2)))
        sel_ids, sel_scores, parent = L.beam_search(
            pre_ids=pre_ids, pre_scores=pre_scores, scores=logp,
            beam_size=k, end_id=MT_END)
        L.increment(counter, value=1, in_place=True)
        L.array_write(sel_ids, counter, array=ids_arr)
        L.array_write(parent, counter, array=parents_arr)
        L.array_write(sel_scores, counter, array=scores_arr)
        L.assign(sel_ids, pre_ids)
        L.assign(sel_scores, pre_scores)
        L.less_than(x=counter, y=limit, cond=cond)
    sentences, final_scores = L.beam_search_decode(
        ids_arr, parents_arr, scores=scores_arr, end_id=MT_END)
    return src, sentences, final_scores


def beam_src_feed(pt, cfg=BEAM_BOOK):
    rows = [np.random.RandomState(i).randint(2, cfg["vocab"], (3, 1))
            .astype(np.int64) for i in range(3)]
    return {"src": pt.LoDTensor(np.concatenate(rows, 0), [[0, 3, 6, 9]])}


def book_beam_search_decode(pt, place):
    """tests/book/test_beam_search_decode.py, both tests: ids in the vocab,
    [B, K] hypotheses starting at <s> with ranked lanes; with a capacity
    larger than the steps written, the slack at the back as end_id."""
    out = {}
    k, max_len = BEAM_BOOK["beam"], BEAM_BOOK["max_len"]
    for name, capacity in (("exact", None), ("slack", max_len + 5)):
        main, startup, stack = _chapter(pt)
        with stack:
            _, sentences, final_scores = beam_decode_net(pt, capacity)
            exe = pt.Executor(place)
            exe.run(startup)
            ids, sc = exe.run(main, feed=beam_src_feed(pt),
                              fetch_list=[sentences, final_scores])
        ok = ids.shape[:2] == (3, k) and (ids >= 0).all() and \
            (ids < BEAM_BOOK["vocab"]).all() and \
            (np.diff(sc, axis=1) <= 1e-5).all() and \
            (ids[:, :, 0] == MT_START).all()
        if name == "slack":
            ok = ok and (ids[:, :, max_len + 1:] == MT_END).all()
        if not ok:
            raise RuntimeError(f"beam_search_decode[{name}]: ids {ids}, "
                               f"scores {sc}")
        out[name] = sc[:, 0].tolist()
    return {"steps": 1, "best_scores": out}


BOOK = {
    "fit_a_line": book_fit_a_line,
    "recognize_digits[mlp]": lambda pt, place: book_recognize_digits(pt, place, "mlp"),
    "recognize_digits[conv]": lambda pt, place: book_recognize_digits(pt, place, "conv"),
    "image_classification[resnet]": book_image_classification,
    "image_classification[vgg]": book_image_classification_vgg,
    "word2vec": book_word2vec,
    "understand_sentiment[conv]":
        lambda pt, place: book_understand_sentiment(pt, place, "conv"),
    "understand_sentiment[stacked_lstm]":
        lambda pt, place: book_understand_sentiment(pt, place, "stacked_lstm"),
    "recommender_system": book_recommender_system,
    "machine_translation[train]": book_machine_translation_train,
    "machine_translation[decode]": book_machine_translation_decode,
    "label_semantic_roles": book_label_semantic_roles,
    "beam_search_decode": book_beam_search_decode,
}
# the chapters whose conv counters the card run prints
BOOK_CONV = ("recognize_digits[conv]", "image_classification[resnet]",
             "image_classification[vgg]")


def phase_book(pt, conv_cuda, bn_cuda, report):
    """The nine book chapters on CUDAPlace(0) at their reference tests'
    budgets and thresholds, with the inference round trip; for the conv
    chapters the kernels' launches and the fallbacks by reason, and for
    each the executor's graph counters (a chapter with LoD feeds takes a
    signature per padded length; vgg16's dropout draws inside its
    graphs)."""
    place = pt.CUDAPlace(0)
    out, t_all = {}, time.perf_counter()
    from paddle_tpu_torch import executor as executor_mod
    for name, chapter in BOOK.items():
        conv_cuda.COUNTERS.reset()
        bn_cuda.COUNTERS.reset()
        executor_mod.COUNTERS.reset()
        t0 = time.perf_counter()
        res = chapter(pt, place)
        res["seconds"] = time.perf_counter() - t0
        g = executor_mod.COUNTERS
        res["graphs"] = {"warmups": g.warmups, "captures": g.captures,
                         "replays": g.replays, "evicted": g.evicted,
                         "eager": dict(g.eager)}
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
                 seqlen=None, sequence_parallel=False, level="O2",
                 dropout=0.0):
    """bench.py's `transformer` model (`cfg`, LM by default; T `seqlen`,
    cfg's by default) through the port's fluid API: the training program
    (Adam, amp.decorate at `level`, O2 by default; O3 in the mode
    PADDLE_TPU_QUANT_MODE names) or, with is_test, the served one (logits
    returned, amp.enable O2). The same variable names. With
    sequence_parallel its attention is the ring over a one-rank 'sp' mesh
    (bench.py's `ring_attention` mode). `dropout` is the model's
    dropout_prob in training."""
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
            dropout_prob=dropout, return_logits=True)
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
    _print_admission("serve_lm (the LM's logits)", engine)
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
    report["serve_lm"] = {"admission": engine.admission, "card": card,
                          "p50_ms": p50, "in_turns_p50_ms": turns,
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


# --- bench.py's lstm: the sequence models on the card -----------------------

LSTM = {"vocab": 30000, "emb": 128, "hidden": 512, "batch": 64, "seqlen": 100,
        "lr": 2e-3}
LSTM_BITWISE_STEPS = 10             # warm-up, capture and 8 replays: bitwise
LSTM_TURNS = 8                      # then graphed and eager steps in turns
# the LoD-fed run: one batch a padded-length bucket, more buckets than the
# Executor keeps graphs (executor.GRAPH_CACHE_SIZE), the longest 600
LSTM_LOD_MAX_LENS = (8, 16, 30, 60, 100, 150, 250, 300, 380, 440, 500, 600)
LSTM_LOD_MIN_LEN = 8
LSTM_LOD_TIMED = 5                  # then a bucket's replays and eager steps in turns
IMDB_BATCHES = 12                   # batches of the imdb surrogate's stream


def _lstm_model(pt, cfg=None):
    """bench.py's `lstm` mode (bench.py:851) through the port's fluid API:
    embedding, two fc(4H) + dynamic_lstm(use_peepholes=True) layers,
    sequence_last_step, fc(2, softmax), cross_entropy, Adam. -> (main,
    startup, loss)."""
    cfg = LSTM if cfg is None else cfg
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        data = pt.layers.data(name="words", shape=[1], dtype="int64",
                              lod_level=1)
        label = pt.layers.data(name="label", shape=[1], dtype="int64")
        h = pt.layers.embedding(input=data, size=[cfg["vocab"], cfg["emb"]])
        for _ in range(2):
            proj = pt.layers.fc(input=h, size=cfg["hidden"] * 4,
                                num_flatten_dims=2)
            h, _c = pt.layers.dynamic_lstm(input=proj,
                                           size=cfg["hidden"] * 4,
                                           use_peepholes=True)
        last = pt.layers.sequence_last_step(h)
        logits = pt.layers.fc(input=last, size=2, act="softmax")
        loss = pt.layers.mean(pt.layers.cross_entropy(input=logits,
                                                      label=label))
        pt.optimizer.Adam(learning_rate=cfg["lr"]).minimize(
            loss, startup_program=startup)
    main.random_seed = startup.random_seed = SEED + 1
    return main, startup, loss


def _lstm_dense_feed(cfg=None):
    """bench.py's feed: dense [B, T] ids (a sequence var fed without a LoD
    counts as full length) and [B, 1] labels, from seed 0."""
    import numpy as np
    cfg = LSTM if cfg is None else cfg
    rng = np.random.default_rng(0)
    return {"words": rng.integers(0, cfg["vocab"], (cfg["batch"], cfg["seqlen"]))
            .astype(np.int32),
            "label": rng.integers(0, 2, (cfg["batch"], 1)).astype(np.int32)}


def _lstm_lod_feeds(pt, cfg=None, max_lens=None):
    """One LoDTensor batch per entry of `max_lens`: cfg's batch of
    sequences with lengths drawn in [LSTM_LOD_MIN_LEN, max], the first at
    the max, so each batch pads to its own bucket."""
    import numpy as np
    cfg = LSTM if cfg is None else cfg
    max_lens = LSTM_LOD_MAX_LENS if max_lens is None else max_lens
    rng = np.random.default_rng(SEED + 16)
    feeds = []
    for top in max_lens:
        lens = rng.integers(min(LSTM_LOD_MIN_LEN, top), top + 1, cfg["batch"])
        lens[0] = top
        ids = rng.integers(0, cfg["vocab"], (int(lens.sum()), 1)).astype(
            np.int64)
        offs = np.concatenate([[0], np.cumsum(lens)]).tolist()
        feeds.append({"words": pt.LoDTensor(ids, [offs]),
                      "label": rng.integers(0, 2, (cfg["batch"], 1))
                      .astype(np.int64)})
    return feeds


def _imdb_lod_feeds(pt, n, cfg=None):
    """The first `n` batches of the port's imdb train reader (the synthetic
    surrogate where no aclImdb tarball is present: lengths uniform in
    [8, 59]) as LoDTensor feeds of cfg's batch."""
    import numpy as np
    from paddle_tpu_torch.dataset import imdb
    cfg = LSTM if cfg is None else cfg
    reader = imdb.train()()
    feeds = []
    for _ in range(n):
        rows = [next(reader) for _ in range(cfg["batch"])]
        lens = [len(w) for w, _ in rows]
        ids = np.concatenate([np.asarray(w, np.int64) for w, _ in rows])
        feeds.append({
            "words": pt.LoDTensor(ids.reshape(-1, 1),
                                  [np.concatenate([[0], np.cumsum(lens)])
                                   .tolist()]),
            "label": np.asarray([[lab] for _, lab in rows], np.int64)})
    return feeds


def _trace_kernels(prof_result):
    """Kernel launches of one profiled step, from its by-kernel table (copies
    and fills left out)."""
    return sum(n for k, (_ms, n) in prof_result["by_kernel"].items()
               if not k.startswith(("Memcpy", "Memset")))


def phase_train_lstm(pt, report):
    """bench.py's lstm (2 x LSTM h512 with peepholes, batch 64, T 100, Adam
    2e-3; a dense [64, 100] ids feed) trained on the card as CUDA graphs:
    graphed on one scope and eager (use_jit=False) on another from one
    startup state, LSTM_BITWISE_STEPS steps held bitwise (losses and every
    scope tensor: the warm-up, the capture and its replays), then
    LSTM_TURNS of each in turns (step p50 of each, the loss falling); the
    generic grads' re-runs per eager step (`lstm` must be none: its grad
    is explicit); the memory a step needs beyond the state; one profiled
    step of each (busy share, kernel launches from the trace). Then the
    same model fed LoDTensors, one batch per padded-length bucket
    (LSTM_LOD_MAX_LENS: more buckets than GRAPH_CACHE_SIZE): each bucket
    warmed up, captured and replayed LSTM_LOD_TIMED more times on one
    scope, in turns with as many eager steps on another, each replay's
    loss and the scopes bitwise the eager steps'; per bucket the warm-up's
    and the capture's seconds, replay and eager p50, and the steps after
    which graphing the bucket has cost less in all than running it eager;
    the captures, replays and evictions. Last, IMDB_BATCHES batches of the
    imdb reader's stream, graphed and eager in turns: the buckets it
    meets, the counters, and the cumulative time of each."""
    import numpy as np
    import torch
    from paddle_tpu_torch import executor as E
    from paddle_tpu_torch.ops import registry
    card = _card_line()
    main, startup, loss = _lstm_model(pt)
    feed = _lstm_dense_feed()
    exe = pt.Executor()
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    init = {n: v for n, v in scope.vars.items() if isinstance(v, torch.Tensor)}
    sg, se = _scope_from(pt, init), _scope_from(pt, init)
    del scope
    E.COUNTERS.reset()
    reserved0 = _settled_reserved()
    t0 = time.perf_counter()
    losses = []
    for i in range(LSTM_BITWISE_STEPS):
        a = exe.run(main, feed=feed, fetch_list=[loss], scope=sg)[0]
        b = exe.run(main, feed=feed, fetch_list=[loss], scope=se,
                    use_jit=False)[0]
        if not np.array_equal(a, b):
            raise RuntimeError(f"train_lstm: step {i} graphed loss {a} != "
                               f"eager {b}")
        losses.append(float(a.ravel()[0]))
    diverged = _bitwise_scopes(sg, se)
    if diverged:
        raise RuntimeError(f"train_lstm: after {LSTM_BITWISE_STEPS} steps "
                           f"the graphed scope differs: {diverged[:8]}")
    setup_s = time.perf_counter() - t0
    pool_gb = (_settled_reserved() - reserved0) / 1e9
    c = E.COUNTERS
    if (c.warmups, c.captures, c.replays) != (1, 1, LSTM_BITWISE_STEPS - 1):
        raise RuntimeError(f"train_lstm: {c}")
    E.COUNTERS.reset()
    registry.RERUNS.clear()
    steps = {"graph": [], "eager": []}
    for _ in range(LSTM_TURNS):
        for mode, sc, use_jit in (("graph", sg, None), ("eager", se, False)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = exe.run(main, feed=feed, fetch_list=[loss], scope=sc,
                          use_jit=use_jit)[0]
            steps[mode].append((time.perf_counter() - t0) * 1e3)
            if mode == "graph":
                losses.append(float(out.ravel()[0]))
    reruns = {k: v / LSTM_TURNS for k, v in sorted(registry.RERUNS.items())}
    if registry.RERUNS.get("lstm", 0):
        raise RuntimeError(f"train_lstm: the lstm grad re-ran its forward: "
                           f"{reruns}")
    if _bitwise_scopes(sg, se) or c.eager != {"use_jit": LSTM_TURNS} \
            or c.replays != LSTM_TURNS:
        raise RuntimeError(f"train_lstm: the steps in turns: {c}")
    if not (np.isfinite(losses).all() and
            np.mean(losses[-4:]) < np.mean(losses[:4])):
        raise RuntimeError(f"train_lstm: the loss did not fall: {losses}")
    peak = {}
    for mode, sc, use_jit in (("graph", sg, None), ("eager", se, False)):
        _settled_reserved()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        exe.run(main, feed=feed, fetch_list=[loss], scope=sc, use_jit=use_jit)
        torch.cuda.synchronize()
        peak[mode] = (torch.cuda.max_memory_allocated() - before) / 1e9
    peak["graph"] += pool_gb
    state_gb = sum(v.numel() * v.element_size() for v in se.vars.values()
                   if isinstance(v, torch.Tensor)) / 1e9
    p50 = {m: float(np.median(v)) for m, v in steps.items()}
    witness = ("GEMM", lambda name: "gemm" in name.lower()
               or "sm90" in name.lower())
    prof = {m: _profile_step(exe, main, feed, loss, sc, p50[m], card, witness,
                             use_jit=use_jit)
            for m, sc, use_jit in (("graph", sg, None), ("eager", se, False))}
    launches = {m: _trace_kernels(prof[m]) for m in prof}
    cfg = LSTM
    tokens_s = cfg["batch"] * cfg["seqlen"] / (p50["graph"] / 1e3)
    print(f"train_lstm: bench.py's lstm (2 x LSTM h{cfg['hidden']} with "
          f"peepholes, batch {cfg['batch']}, T {cfg['seqlen']}, Adam) graphed "
          f"bitwise eager ({LSTM_BITWISE_STEPS} steps, then {LSTM_TURNS} in "
          f"turns; {setup_s:.1f} s to warm up and capture); step p50 graphed "
          f"{p50['graph']:.2f} ms ({tokens_s:.0f} tokens/s), eager "
          f"{p50['eager']:.2f} ms; busy {prof['graph']['busy_ms']:.2f} ms "
          f"({prof['graph']['busy_share']:.1%}) graphed, "
          f"{prof['eager']['busy_ms']:.2f} ms "
          f"({prof['eager']['busy_share']:.1%}) eager; kernel launches per "
          f"step (trace) {launches['graph']} graphed, {launches['eager']} "
          f"eager; generic-grad re-runs per step {reruns}; memory beyond the "
          f"{state_gb:.3f} GB of state {peak['graph']:.3f} GB graphed (pool "
          f"{pool_gb:.3f} GB), {peak['eager']:.3f} GB eager; loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} ({card})", flush=True)
    print(f"train_lstm steps (ms): graphed "
          f"{', '.join(f'{t:.2f}' for t in steps['graph'])}; eager "
          f"{', '.join(f'{t:.2f}' for t in steps['eager'])}", flush=True)
    dense = {"p50_ms": p50, "step_ms": steps, "tokens_per_s": tokens_s,
             "busy_ms": {m: prof[m]["busy_ms"] for m in prof},
             "busy_share": {m: prof[m]["busy_share"] for m in prof},
             "kernel_launches_per_step": launches,
             "reruns_per_step": reruns, "step_memory_gb": peak,
             "graph_pool_gb": pool_gb, "state_gb": state_gb,
             "losses": losses, "setup_s": setup_s}
    del exe, sg, se
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # the LoD feeds: one signature a padded-length bucket
    exe = pt.Executor()
    sg, se = _scope_from(pt, init), _scope_from(pt, init)

    def timed(f, sc, use_jit):
        torch.cuda.synchronize()
        t = time.perf_counter()           # the fetch ends in a device->host copy
        out = exe.run(main, feed=f, fetch_list=[loss], scope=sc,
                      use_jit=use_jit)[0]
        return out, time.perf_counter() - t

    def pays_after(setup_s, replay_ms, eager_ms):
        """The steps of one bucket after which its warm-up, capture and
        replays have cost less in all than as many eager steps."""
        gain = eager_ms - replay_ms
        over = setup_s * 1e3 - 2 * eager_ms
        return None if gain <= 0 else 2 + max(0, int(np.ceil(over / gain)))

    feeds = _lstm_lod_feeds(pt)
    buckets, per_bucket = [], []
    E.COUNTERS.reset()
    t0 = time.perf_counter()
    for i, f in enumerate(feeds):
        t = E._bucket_len(int(np.diff(f["words"].lod[0]).max()))
        buckets.append(t)
        ms = {"graph": [], "eager": []}
        setup = []
        for rep in range(2 + LSTM_LOD_TIMED):
            a, tg = timed(f, sg, None)
            b, te = timed(f, se, False)
            if not np.array_equal(a, b):
                raise RuntimeError(f"train_lstm LoD: batch {i} run {rep}: "
                                   f"graphed loss {a} != eager {b}")
            if rep < 2:
                setup.append(tg)
            else:
                ms["graph"].append(tg * 1e3)
                ms["eager"].append(te * 1e3)
        row = {"bucket": t, "warmup_s": setup[0],
               "capture_s": setup[1],
               "replay_p50_ms": float(np.median(ms["graph"])),
               "eager_p50_ms": float(np.median(ms["eager"])),
               "step_ms": ms}
        row["pays_after_steps"] = pays_after(
            sum(setup), row["replay_p50_ms"], row["eager_p50_ms"])
        row["miss_over_eager_ms"] = setup[0] * 1e3 - row["eager_p50_ms"]
        per_bucket.append(row)
        print(f"train_lstm LoD bucket {t}: warm-up {setup[0]:.3f} s, capture "
              f"and first replay {setup[1]:.3f} s; replay p50 "
              f"{row['replay_p50_ms']:.2f} ms, eager p50 "
              f"{row['eager_p50_ms']:.2f} ms ({LSTM_LOD_TIMED} each, in "
              f"turns); graphing this bucket pays after "
              f"{row['pays_after_steps']} steps of it; a warm-up costs "
              f"{row['miss_over_eager_ms']:.2f} ms over an eager step",
              flush=True)
    lod_s = time.perf_counter() - t0
    diverged = _bitwise_scopes(sg, se)
    if diverged:
        raise RuntimeError(f"train_lstm LoD: the scopes differ: "
                           f"{diverged[:8]}")
    n = len(feeds)
    lod = {"buckets": buckets, "warmups": c.warmups, "captures": c.captures,
           "replays": c.replays, "evicted": c.evicted,
           "eager": dict(c.eager), "graphs_kept": len(exe._graphs),
           "seconds": lod_s, "per_bucket": per_bucket}
    if len(set(buckets)) != n or n <= E.GRAPH_CACHE_SIZE or \
            (c.warmups, c.captures, c.replays) != \
            (n, n, n * (1 + LSTM_LOD_TIMED)) or \
            c.evicted != n - E.GRAPH_CACHE_SIZE:
        raise RuntimeError(f"train_lstm LoD: {lod}")
    print(f"train_lstm LoD: {n} LoDTensor batches of lengths "
          f"{LSTM_LOD_MIN_LEN}-{max(LSTM_LOD_MAX_LENS)}, padded to buckets "
          f"{buckets}: each bucket's replays bitwise its eager runs, the "
          f"scopes bitwise after; warm-ups {c.warmups}, captures "
          f"{c.captures}, replays {c.replays}, evicted {c.evicted} (cache "
          f"{E.GRAPH_CACHE_SIZE}), {lod_s:.1f} s in all ({card})", flush=True)
    del exe, sg, se
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # the imdb reader's stream, graphed and eager in turns
    exe = pt.Executor()
    sg, se = _scope_from(pt, init), _scope_from(pt, init)
    E.COUNTERS.reset()
    ms = {"graph": [], "eager": []}
    seen = []
    for i, f in enumerate(_imdb_lod_feeds(pt, IMDB_BATCHES)):
        seen.append(E._bucket_len(int(np.diff(f["words"].lod[0]).max())))
        a, tg = timed(f, sg, None)
        b, te = timed(f, se, False)
        if not np.array_equal(a, b):
            raise RuntimeError(f"train_lstm imdb: batch {i}: graphed loss "
                               f"{a} != eager {b}")
        ms["graph"].append(tg * 1e3)
        ms["eager"].append(te * 1e3)
    if _bitwise_scopes(sg, se):
        raise RuntimeError("train_lstm imdb: the scopes differ")
    cum = {m: np.cumsum(v) for m, v in ms.items()}
    ahead = [i + 1 for i in range(IMDB_BATCHES)
             if cum["graph"][i] < cum["eager"][i]]
    imdb = {"buckets": seen, "warmups": c.warmups, "captures": c.captures,
            "replays": c.replays, "evicted": c.evicted, "step_ms": ms,
            "total_ms": {m: float(v[-1]) for m, v in cum.items()},
            "graphed_ahead_from_step": ahead[0] if ahead else None}
    print(f"train_lstm imdb: {IMDB_BATCHES} batches of the imdb reader "
          f"(batch {LSTM['batch']}), buckets {sorted(set(seen))}; warm-ups "
          f"{c.warmups}, captures {c.captures}, replays {c.replays}, evicted "
          f"{c.evicted}; {imdb['total_ms']['graph']:.1f} ms graphed, "
          f"{imdb['total_ms']['eager']:.1f} ms eager in all; graphed ahead "
          f"from step {imdb['graphed_ahead_from_step']}; steps (ms) graphed "
          f"{', '.join(f'{t:.2f}' for t in ms['graph'])}; eager "
          f"{', '.join(f'{t:.2f}' for t in ms['eager'])} ({card})",
          flush=True)
    report["train_lstm"] = {"card": card, "config": LSTM, "dense": dense,
                            "lod": lod, "imdb": imdb}
    del exe, sg, se, init
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return dense


# --- control flow and decoding: seq2seq, beam decode, SRL ----------------------

# the book ch08 seqToseq_net widths: source and target dict 30000, word
# vectors 512, encoder LSTM H 512, decoder 512; Adam 1e-3, batch 64
MT_FULL = {"dict": 30000, "word": 512, "hid": 512, "batch": 64, "lr": 1e-3}
MT_SEED = 1
MT_BITWISE_STEPS = 10       # warm-up, capture and 8 replays: bitwise eager
MT_TURNS = 8                # then graphed and eager steps in turns
MT_STREAM_BATCHES = 12      # batches of the wmt14 surrogate's stream
MT_LONG_LEN = 50            # the dense LoD batch the surrogate never reaches
MT_LONG_STEPS = 4           # its warm-up, capture and replays, bitwise
DECODE_BEAM = 3
DECODE_MAX_LEN = 250        # the book's generation length
DECODE_SOURCES = 16
# the book ch07 db_lstm widths: word_dim 32, mark_dim 5, hidden 512 (LSTM H
# 128), depth 8; the conll05 vocabularies; batch 64. Adam 1e-3: at these
# widths the book test's 5e-3 diverges on a repeated batch, in the JAX
# package as in the port (loss 44 -> 100s within 18 steps, on the CPU)
SRL_FULL = {"word_dict": 44068, "emb": 32, "mark_emb": 5, "hid": 128,
            "depth": 8, "batch": 64, "lr": 1e-3}
SRL_BITWISE_STEPS = 10
SRL_TURNS = 8


def _mt_batches(pt, n, batch, dict_size):
    """The first `n` batches of the wmt14 surrogate's train stream as LoD
    feeds of `batch` triples."""
    reader = pt.dataset.wmt14.train(dict_size)()
    return [_seq_feeds(pt, [next(reader) for _ in range(batch)],
                       ("src_word_id", "target_language_word",
                        "target_language_next_word")) for _ in range(n)]


def _seq_feeds(pt, samples, names):
    """Samples of parallel int sequences -> LoDTensor feeds by name."""
    feed = {}
    for col, name in enumerate(names):
        rows = [np.asarray(s[col], np.int64).reshape(-1, 1) for s in samples]
        offs = np.concatenate([[0], np.cumsum([len(r) for r in rows])])
        feed[name] = pt.LoDTensor(np.concatenate(rows, 0), [offs.tolist()])
    return feed


def _mt_long_batch(pt, cfg, length):
    """One batch of `length`-token sources and targets from MT_SEED."""
    rng = np.random.RandomState(MT_SEED)
    samples = []
    for _ in range(cfg["batch"]):
        src = rng.randint(3, cfg["dict"], length).tolist()
        trg = rng.randint(3, cfg["dict"], length - 1).tolist()
        samples.append((src, [MT_START] + trg, trg + [MT_END]))
    return _seq_feeds(pt, samples, ("src_word_id", "target_language_word",
                                    "target_language_next_word"))


def _seq_padded(feed, name):
    from paddle_tpu_torch import executor as E
    return E._bucket_len(int(np.diff(feed[name].lod[0]).max()))


def _turns(exe, main, loss, sg, se, feeds, what, counts=None,
           launches=None):
    """Each feed run graphed on scope `sg` and eager on `se`, in turns;
    each pair's losses bitwise -> (graphed ms, eager ms, graphed losses).
    Given `counts` (-> kernel counter values), what each run added to them
    is summed into `launches[mode]`."""
    import torch
    ms = {"graph": [], "eager": []}
    losses = []
    for i, f in enumerate(feeds):
        out = {}
        for mode, sc, use_jit in (("graph", sg, None), ("eager", se, False)):
            torch.cuda.synchronize()
            c0 = counts() if counts else None
            t0 = time.perf_counter()
            out[mode] = exe.run(main, feed=f, fetch_list=[loss], scope=sc,
                                use_jit=use_jit)[0]
            ms[mode].append((time.perf_counter() - t0) * 1e3)
            if counts:
                for k, v in counts().items():
                    launches[mode][k] = launches[mode].get(k, 0) + v - c0[k]
        if not np.array_equal(out["graph"], out["eager"]):
            raise RuntimeError(f"{what}: step {i} graphed loss "
                               f"{out['graph']} != eager {out['eager']}")
        losses.append(float(out["graph"].ravel()[0]))
    return ms["graph"], ms["eager"], losses


def _graphed_training(pt, name, main, startup, loss, feed, bitwise_steps,
                      turns, witness, card, items, stream=(), extra=(),
                      rerun_type=None, want=None):
    """A training program graphed on one scope and eager on another from
    one startup state, the graph gate admitting its step: `bitwise_steps`
    steps of `feed` (the warm-up, the capture and its replays) and the
    scopes after them bitwise the eager steps; then `turns` of each timed
    in turns (p50), the loss falling from the warm-up's; the generic
    grad's re-runs of `rerun_type` per eager step (when given); the memory
    a step needs beyond the state; one profiled step of each (busy share,
    kernel launches from the trace); then the `stream` batches and the
    `extra` batches graphed and eager in turns, bitwise, with the
    signatures they made. Given `want` (kernel counter -> launches a
    step), the eager steps' wrapper launches are held to it, the replays'
    wrappers to none, and the profiled replay's traced launches to it,
    first to the graph's own kernel nodes (run it under _kept_graphs).
    The launches reported ("launches") are those counted in this run: the
    wrappers' on the warm-up and every eager step (a capture runs nothing:
    _captures_uncounted takes its counts back) and the profiled replay's
    from its trace; the other replays are neither traced nor counted. The
    dense feeds are staged on the card once, as bench.py stages its
    batches. `items`: (per step, unit) for the throughput. -> (the report,
    the Executor, the graphed scope)."""
    import torch
    from paddle_tpu_torch import executor as E
    from paddle_tpu_torch.ops import (attention_cuda, bn_cuda, conv_cuda,
                                      quant_cuda, registry)
    counts = functools.partial(_graph_counts, conv_cuda, bn_cuda,
                               attention_cuda)
    exe = pt.Executor()
    feed = {k: torch.from_numpy(v).to(exe.device)
            if isinstance(v, np.ndarray) else v for k, v in feed.items()}
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    init = {n: v for n, v in scope.vars.items() if isinstance(v, torch.Tensor)}
    sg, se = _scope_from(pt, init), _scope_from(pt, init)
    del scope, init
    gate = exe.graph_gate(main, feed)
    if gate is not None:
        raise RuntimeError(f"{name}: the graph gate runs the step eager: "
                           f"{gate}")
    E.COUNTERS.reset()
    c0 = counts()
    with _captures_uncounted(conv_cuda.COUNTERS, bn_cuda.COUNTERS,
                             attention_cuda.COUNTERS, quant_cuda.COUNTERS):
        reserved0 = _settled_reserved()
        t0 = time.perf_counter()
        _g, _e, losses = _turns(exe, main, loss, sg, se,
                                [feed] * bitwise_steps, name)
        diverged = _bitwise_scopes(sg, se)
        if diverged:
            raise RuntimeError(f"{name}: after {bitwise_steps} steps the "
                               f"graphed scope differs: {diverged[:8]}")
        setup_s = time.perf_counter() - t0
        pool_gb = (_settled_reserved() - reserved0) / 1e9
        c = E.COUNTERS
        if (c.warmups, c.captures, c.replays) != (1, 1, bitwise_steps - 1) \
                or c.eager != {"use_jit": bitwise_steps}:
            raise RuntimeError(f"{name}: {c}")
        E.COUNTERS.reset()
        registry.RERUNS.clear()
        launches = {"graph": {}, "eager": {}}
        g_ms, e_ms, turn_losses = _turns(exe, main, loss, sg, se,
                                         [feed] * turns, name, counts,
                                         launches)
        losses += turn_losses
        reruns = {k: v / turns for k, v in sorted(registry.RERUNS.items())}
        if _bitwise_scopes(sg, se) or c.eager != {"use_jit": turns} \
                or c.replays != turns or c.captures:
            raise RuntimeError(f"{name}: the steps in turns: {c}")
        per_step = {k: v / turns for k, v in launches["eager"].items()
                    if v and k.endswith("launches")}
        if want is not None and (
                per_step != {k: float(v) for k, v in want.items()}
                or any(launches["graph"].values())):
            raise RuntimeError(
                f"{name}: eager launches per step {per_step}, expected "
                f"{want}; the replays' wrappers counted "
                f"{ {k: v for k, v in launches['graph'].items() if v} }")
        if rerun_type and not registry.RERUNS.get(rerun_type):
            raise RuntimeError(f"{name}: no {rerun_type} re-run: {reruns}")
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise RuntimeError(f"{name}: the loss did not fall: {losses}")
        peak = {}
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
        p50 = {"graph": float(np.median(g_ms)), "eager": float(np.median(e_ms))}
        expect, graph = None, None
        if want is not None:
            expect = {k: v for k, v in want.items() if k in TRACE_KERNELS}
            if want.get("conv.launches"):
                # K1 and K2 are one kernel in a trace
                expect["conv.dgrad_launches"] = \
                    expect.get("conv.dgrad_launches", 0) + want["conv.launches"]
            # held first to the replayed graph's own kernel nodes: the
            # profiler loses a replay's first records now and then
            graph, = [e.graph for k, e in exe._graphs.items()
                      if k[0] == id(main) and k[3] == (loss.name,)]
        prof = {m: _profile_step(exe, main, feed, loss, sc, p50[m], card,
                                 witness, use_jit=use_jit,
                                 **({"expect": expect, "graph": graph}
                                    if m == "graph" else {}))
                for m, sc, use_jit in (("graph", sg, None),
                                       ("eager", se, False))}
        if expect is not None:
            # the eager trace is held to nothing (it has no graph to
            # fall back on), but what it lacks of the step's launches
            # makes its busy time a lower bound too
            traced = prof["eager"]["launches"]
            lost = {k: v - traced[k] for k, v in expect.items()
                    if traced[k] < v}
            if lost:
                prof["eager"].update(lost_records=lost, busy_lower_bound=True)
        # a trace that lost records was profiled again: the scope that ran
        # fewer profiled steps catches up, so the two stay step for step
        ran = {"graph": c.replays, "eager": c.eager.get("use_jit", 0)}
        for mode, sc, use_jit in (("graph", sg, None), ("eager", se, False)):
            for _ in range(max(ran.values()) - ran[mode]):
                exe.run(main, feed=feed, fetch_list=[loss], scope=sc,
                        use_jit=use_jit)
        if _bitwise_scopes(sg, se):
            raise RuntimeError(f"{name}: the scopes differ after the "
                               f"profiled steps")
        replayed = bitwise_steps - 1 + c.replays
        E.COUNTERS.reset()
        runs = {}
        for what, feeds in (("stream", stream), ("extra", extra)):
            if not feeds:
                continue
            t0 = time.perf_counter()
            g, e, lo = _turns(exe, main, loss, sg, se, feeds, f"{name} {what}")
            runs[what] = {"graph_ms": g, "eager_ms": e, "losses": lo,
                          "seconds": time.perf_counter() - t0}
        if _bitwise_scopes(sg, se):
            raise RuntimeError(f"{name}: the scopes differ after the stream")
        runs["counters"] = {"warmups": c.warmups, "captures": c.captures,
                            "replays": c.replays, "evicted": c.evicted}
    # what this run launched: the wrappers' counts (warm-up, eager steps),
    # and the profiled replay's trace, whose K1/K2 kernel (one in a trace)
    # is split as its eager twin's wrappers split it
    counted = {k: v - c0[k] for k, v in counts().items()
               if k.endswith("launches") and v - c0[k]}
    replay = {k: v for k, v in prof["graph"]["launches"].items()
              if v and k in TRACE_KERNELS}
    k1 = min(int(per_step.get("conv.launches", 0)),
             replay.get("conv.dgrad_launches", 0))
    if k1:
        replay["conv.dgrad_launches"] -= k1
        replay["conv.launches"] = k1
    total = dict(counted)
    for k, v in replay.items():
        total[k] = total.get(k, 0) + v
    untraced = replayed + c.replays - 1
    n, unit = items
    out = {"card": card, "gate": gate, "p50_ms": p50,
           "step_ms": {"graph": g_ms, "eager": e_ms},
           f"{unit}_per_s": n / (p50["graph"] / 1e3),
           "busy_ms": {m: prof[m]["busy_ms"] for m in prof},
           "busy_share": {m: prof[m]["busy_share"] for m in prof},
           "busy_lower_bound": {m: prof[m]["busy_lower_bound"] for m in prof},
           "lost_records": {m: prof[m]["lost_records"] for m in prof},
           "kernel_launches_per_step": {m: _trace_kernels(prof[m])
                                        for m in prof},
           "launches_per_step": per_step,
           "filter_copies_per_step":
               launches["eager"].get("conv.filter_copies", 0) / turns,
           "replay_traced_launches": replay,
           "launches": total, "launches_by_wrappers": counted,
           "replays_untraced": untraced,
           "reruns_per_eager_step": reruns, "step_memory_gb": peak,
           "graph_pool_gb": pool_gb, "state_gb": state_gb, "losses": losses,
           "setup_s": setup_s, "runs": runs}

    def busy(m):
        low = " (a lower bound: records lost)" if \
            prof[m]["busy_lower_bound"] else ""
        return (f"{prof[m]['busy_ms']:.2f} ms ({prof[m]['busy_share']:.1%})"
                f"{low}")
    print(f"{name}: graphed bitwise eager ({bitwise_steps} steps, then {turns} "
          f"in turns; {setup_s:.1f} s to warm up and capture); step p50 "
          f"graphed {p50['graph']:.2f} ms ({out[f'{unit}_per_s']:.0f} "
          f"{unit}/s), eager {p50['eager']:.2f} ms; busy {busy('graph')} "
          f"graphed, {busy('eager')} eager; kernel launches per step "
          f"(trace) {out['kernel_launches_per_step']['graph']} graphed, "
          f"{out['kernel_launches_per_step']['eager']} eager; the eager "
          f"step's wrappers {per_step}, the profiled replay's trace "
          f"{replay}; counted in this run {total} ({untraced} replays "
          f"untraced); generic-grad re-runs per eager step {reruns}; memory "
          f"beyond the {state_gb:.3f} GB of state {peak['graph']:.3f} GB "
          f"graphed (pool {pool_gb:.3f} GB), {peak['eager']:.3f} GB eager; "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f} ({card})", flush=True)
    for what, r in runs.items():
        if what == "counters":
            continue
        print(f"{name} {what}: {len(r['graph_ms'])} batches bitwise; "
              f"graphed ms {', '.join(f'{t:.2f}' for t in r['graph_ms'])}; "
              f"eager ms {', '.join(f'{t:.2f}' for t in r['eager_ms'])}",
              flush=True)
    if stream or extra:
        print(f"{name}: the stream and extra batches made warm-ups "
              f"{c.warmups}, captures {c.captures}, replays {c.replays}, "
              f"evicted {c.evicted}", flush=True)
    return out, exe, sg


def phase_train_seq2seq(pt, report):
    """The machine-translation chapter's encoder_decoder (a DynamicRNN
    decoder with dot-product attention: the `rnn` op, its generic grad) at
    the book ch08 widths (MT_FULL) trained on the card with Adam: the first
    batch of the wmt14 surrogate (batch 64) graphed bitwise eager
    (MT_BITWISE_STEPS, then MT_TURNS in turns: p50, tokens/s, busy share,
    launches of one profiled step, the rnn's re-runs per eager step, the
    memory beyond the state); then MT_STREAM_BATCHES batches of the
    surrogate's stream (lengths 3-12: padded-length buckets 8 and 16, a
    signature per pair) and one dense LoD batch of length MT_LONG_LEN
    (bucket 64) MT_LONG_STEPS times, graphed and eager in turns, bitwise.
    -> the trained scope and program names, for decode_beam."""
    card = _card_line()
    cfg = MT_FULL
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        feeds, loss, logits = mt_train_net(pt, cfg, cfg["lr"])
    main.random_seed = startup.random_seed = MT_SEED
    batches = _mt_batches(pt, MT_STREAM_BATCHES + 1, cfg["batch"],
                          cfg["dict"])
    feed = batches[0]
    long_batch = _mt_long_batch(pt, cfg, MT_LONG_LEN)
    tokens = int(feed["target_language_word"].lod[0][-1])
    witness = ("GEMM", lambda n: "gemm" in n.lower() or "sm90" in n.lower())
    out, exe, sg = _graphed_training(
        pt, "train_seq2seq", main, startup, loss, feed, MT_BITWISE_STEPS,
        MT_TURNS, witness, card, (tokens, "tokens"), stream=batches[1:],
        extra=[long_batch] * MT_LONG_STEPS, rerun_type="rnn")
    out["config"] = cfg
    out["buckets"] = {
        "stream": sorted({(_seq_padded(f, "src_word_id"),
                           _seq_padded(f, "target_language_word"))
                          for f in batches}),
        "long": (_seq_padded(long_batch, "src_word_id"),
                 _seq_padded(long_batch, "target_language_word"))}
    long_g = out["runs"]["extra"]["graph_ms"]
    out["long_p50_ms"] = {"graph": float(np.median(long_g[2:])),
                          "eager": float(np.median(
                              out["runs"]["extra"]["eager_ms"]))}
    print(f"train_seq2seq: buckets (src, trg) {out['buckets']}; the "
          f"length-{MT_LONG_LEN} batch's replay p50 "
          f"{out['long_p50_ms']['graph']:.2f} ms, eager p50 "
          f"{out['long_p50_ms']['eager']:.2f} ms ({card})", flush=True)
    report["train_seq2seq"] = out
    return sg


def phase_decode_beam(pt, scope, report):
    """The chapter's decode program (While over [B, K] lanes, beam_search,
    the arrays backtracked) with beam DECODE_BEAM for DECODE_MAX_LEN steps
    on DECODE_SOURCES sources of the wmt14 surrogate's test stream, from
    train_seq2seq's trained scope: eager under the gate's reason
    "control_flow" (printed with the host syncs per iteration: the
    condition's); ms per iteration and per request; the ids the same on a
    second run; the lanes' scores non-increasing and the best at least the
    greedy decode's; ServingEngine.infer's ids and scores the same as
    exe.run's (the LoD request takes the executor, counted `lod`)."""
    import torch
    from paddle_tpu_torch import executor as E
    from paddle_tpu_torch.serving import ServingEngine
    card = _card_line()
    cfg = MT_FULL
    reader = pt.dataset.wmt14.test(cfg["dict"])()
    srcs = [next(reader)[0] for _ in range(DECODE_SOURCES)]
    offs = np.concatenate([[0], np.cumsum([len(s) for s in srcs])]).tolist()
    feed = {"src_word_id": pt.LoDTensor(
        np.concatenate(srcs).reshape(-1, 1).astype(np.int64), [offs])}
    exe = pt.Executor()
    progs, res, times = {}, {}, {}
    for name, k, use_beam in (("beam", DECODE_BEAM, True),
                              ("greedy", 1, False)):
        prog = pt.Program()
        with pt.unique_name.guard(), pt.program_guard(prog, pt.Program()):
            _, sent, sc = mt_decode_net(pt, cfg, k, use_beam, DECODE_MAX_LEN)
        progs[name] = (prog, sent, sc)
        runs = []
        for _ in range(2):
            E.COUNTERS.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ids, scores = exe.run(prog, feed=feed, fetch_list=[sent, sc],
                                  scope=scope)
            runs.append((time.perf_counter() - t0) * 1e3)
            if E.COUNTERS.eager != {"control_flow": 1} or \
                    E.COUNTERS.host_syncs != {"while": DECODE_MAX_LEN + 1}:
                raise RuntimeError(f"decode_beam {name}: eager "
                                   f"{E.COUNTERS.eager}, host syncs "
                                   f"{E.COUNTERS.host_syncs}")
            if name in res and not (np.array_equal(ids, res[name][0]) and
                                    np.array_equal(scores, res[name][1])):
                raise RuntimeError(f"decode_beam {name}: a second run gave "
                                   f"other ids or scores")
            res[name] = (ids, scores)
        times[name] = runs
    ids, scores = res["beam"]
    if ids.shape != (DECODE_SOURCES, DECODE_BEAM, DECODE_MAX_LEN + 1) or \
            (ids < 0).any() or (ids >= cfg["dict"]).any() or \
            (ids[:, :, 0] != MT_START).any():
        raise RuntimeError(f"decode_beam: ids {ids.shape}")
    if not (np.diff(scores, axis=1) <= 1e-5).all() or \
            not (scores[:, 0] >= res["greedy"][1][:, 0] - 1e-4).all():
        raise RuntimeError(f"decode_beam: beam {scores[:, 0]}, greedy "
                           f"{res['greedy'][1][:, 0]}")
    engine = ServingEngine(progs["beam"][0], ["src_word_id"],
                           [progs["beam"][1], progs["beam"][2]],
                           place=pt.CUDAPlace(0), scope=scope)
    E.COUNTERS.reset()
    t0 = time.perf_counter()
    served = engine.infer(feed)
    serve_ms = (time.perf_counter() - t0) * 1e3
    if not (np.array_equal(served[0], ids) and
            np.array_equal(served[1], scores)):
        raise RuntimeError("decode_beam: ServingEngine.infer's ids differ "
                           "from exe.run's")
    engine.close()
    reason = "control_flow"
    syncs = DECODE_MAX_LEN + 1
    out = {"card": card, "beam": DECODE_BEAM, "max_len": DECODE_MAX_LEN,
           "sources": DECODE_SOURCES, "reason": reason,
           "host_syncs": syncs,
           "host_syncs_per_iteration": syncs / DECODE_MAX_LEN,
           "request_ms": times, "serve_ms": serve_ms,
           "ms_per_iteration": {m: min(v) / DECODE_MAX_LEN
                                for m, v in times.items()},
           "best_scores": scores[:, 0].tolist(),
           "greedy_scores": res["greedy"][1][:, 0].tolist(),
           "ended": int((ids[:, 0] == MT_END).any(axis=1).sum())}
    print(f"decode_beam: beam {DECODE_BEAM}, {DECODE_MAX_LEN} steps, "
          f"{DECODE_SOURCES} sources, eager under the gate's reason "
          f"'{reason}', host syncs {syncs} a request (1 an iteration, the "
          f"condition, and 1 at the exit); request ms beam "
          f"{', '.join(f'{t:.1f}' for t in times['beam'])} "
          f"({out['ms_per_iteration']['beam']:.3f} ms an iteration), greedy "
          f"{', '.join(f'{t:.1f}' for t in times['greedy'])} "
          f"({out['ms_per_iteration']['greedy']:.3f} ms an iteration); "
          f"ServingEngine.infer {serve_ms:.1f} ms, its ids exe.run's; the "
          f"ids the same twice; best lane >= greedy on all "
          f"{DECODE_SOURCES}; {out['ended']} best hypotheses reached <e> "
          f"({card})", flush=True)
    report["decode_beam"] = out
    return out


def _srl_batches(pt, n, batch):
    """The conll05 surrogate's train stream in LoD batches."""
    reader = pt.dataset.conll05.train()()
    names = SRL_NAMES + ("target",)
    return [_seq_feeds(pt, [next(reader) for _ in range(batch)], names)
            for _ in range(n)]


def phase_train_srl(pt, report):
    """The SRL chapter's db_lstm at the book ch07 widths (SRL_FULL: one
    forward LSTM, then 7 alternating in direction) with linear_chain_crf
    and Adam on batches of 64 from the conll05 surrogate (lengths 4-19),
    graphed bitwise eager (SRL_BITWISE_STEPS, then SRL_TURNS in turns: p50,
    busy share, launches, the CRF's re-runs per eager step); then 4 more
    batches of the stream in turns; crf_decoding on a held-out batch,
    every Viterbi tag in [0, 59)."""
    card = _card_line()
    cfg = SRL_FULL
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        feeds, target, loss, decode = srl_net(pt, cfg, cfg["lr"])
    main.random_seed = startup.random_seed = MT_SEED
    batches = _srl_batches(pt, 6, cfg["batch"])
    tokens = int(batches[0]["word_data"].lod[0][-1])
    witness = ("GEMM", lambda n: "gemm" in n.lower() or "sm90" in n.lower())
    out, exe, sg = _graphed_training(
        pt, "train_srl", main, startup, loss, batches[0], SRL_BITWISE_STEPS,
        SRL_TURNS, witness, card, (tokens, "tokens"), stream=batches[1:5],
        rerun_type="linear_chain_crf")
    held = dict(batches[5])
    del held["target"]
    path, = exe.run(pt.io.get_inference_program([decode], main), feed=held,
                    fetch_list=[decode], scope=sg)
    label_n = pt.dataset.conll05.LABEL_N
    if not ((path >= 0).all() and (path < label_n).all()) or \
            path.shape[0] != int(held["word_data"].lod[0][-1]):
        raise RuntimeError(f"train_srl: Viterbi path {path.shape}, tags "
                           f"{np.unique(path)}")
    out["config"] = cfg
    out["viterbi_tags"] = int(path.size)
    print(f"train_srl: Viterbi on a held-out batch: {path.size} tags, all "
          f"in [0, {label_n}) ({card})", flush=True)
    report["train_srl"] = out
    return out


# --- the graphed training step -------------------------------------------------

GRAPH_BITWISE_STEPS = 3             # warm-up, capture, replay: held bitwise
LM_DROPOUT = 0.1                    # the dropout LM path's dropout_prob
MASK_STEPS = 3                      # its steps whose masks are compared
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
    witness) of the six training paths that run graphed: ResNet-50 O2 at
    batch 32, vgg16 O2 at batch 32 (VGG16_LAUNCHES), the LM O2 at batch 8
    x T 2048, the same LM with dropout (LM_DROPOUT), the f32 LM at batch
    1, the ring LM at T 32768."""
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
    yield ("vgg16_o2", _vgg16_train(pt), r_feed, VGG16_LAUNCHES,
           ("K1", lambda name: K1_KERNEL in name and "false" in name))
    yield ("lm_o2", _transformer(pt)[:3], lm_feed,
           {"attn.launches": n, "attn.dq_launches": n, "attn.dkv_launches": n},
           ("K7", lambda name: "flash_fwd_kernel" in name))
    yield ("lm_o2_dropout", _transformer(pt, dropout=LM_DROPOUT)[:3], lm_feed,
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


def _dropout_masks(pt, exe, main, feed, loss, sg, se, name, card):
    """MASK_STEPS more steps of a dropout path graphed on `sg` and eager on
    `se`, fetching the dropout's Mask (a signature of its own: one warm-up,
    one capture): each step's graphed mask bitwise its eager twin, and
    consecutive steps' masks different. Returns the masks' keep shares."""
    import numpy as np
    drop = next(op for op in main.global_block().ops if op.type == "dropout")
    mask = drop.output("Mask")[0]
    prev, kept = None, []
    for i in range(MASK_STEPS):
        lg, mg = exe.run(main, feed=feed, fetch_list=[loss, mask], scope=sg)
        le, me = exe.run(main, feed=feed, fetch_list=[loss, mask], scope=se,
                         use_jit=False)
        if not (np.array_equal(lg, le) and np.array_equal(mg, me)):
            raise RuntimeError(f"train_graph {name}: mask step {i}: the "
                               f"graphed step's loss or mask is not the "
                               f"eager step's")
        if prev is not None and np.array_equal(prev, mg):
            raise RuntimeError(f"train_graph {name}: steps {i - 1} and {i} "
                               f"drew the same dropout mask")
        prev = mg
        kept.append(float(mg.mean()))
    if _bitwise_scopes(sg, se):
        raise RuntimeError(f"train_graph {name}: the mask steps differ")
    print(f"train_graph {name}: {MASK_STEPS} steps fetching the dropout mask "
          f"{tuple(prev.shape)}: graphed bitwise eager, consecutive masks "
          f"different, keep share {kept} (p {LM_DROPOUT}; {card})", flush=True)
    return kept


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
        launched = dict(prof["graph"]["launches"])
        if want.get("conv.launches"):
            # K1 and K2 are one kernel in a trace: the replay's K1 share is
            # its eager step's K1 count
            launched["conv.dgrad_launches"] -= int(want["conv.launches"])
            launched["conv.launches"] = int(want["conv.launches"])
        for k, v in launched.items():
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
        if name == "lm_o2_dropout":
            out[name]["masks"] = _dropout_masks(pt, exe, main, feed, loss, sg,
                                                se, name, card)
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


MEMCPY_TRIES = 3


def _memcpy_bytes(fn):
    """(bytes, copies) of the memory copies on the card's timeline while
    `fn` runs, from the profiler's chrome trace (kineto writes each copy's
    bytes in its args); (None, copies) when the trace gives no bytes. The
    profiler loses a window's records now and then, and never adds one: of
    MEMCPY_TRIES profiled runs of `fn`, the one that held the most bytes.
    A replayed CUDA graph's copy nodes are traced only when the profiler
    had run once before the graph was captured. In a process that had
    profiled many windows, every window of one configuration lost the
    same records in a smoke run on an NVIDIA H100 80GB HBM3 at 700 W (a
    DLRM step's feed copies, which then read as copies growing with the
    table), so train_dlrm measures in a fresh process that runs the
    profiler once first (_dlrm_copies_fresh;
    tests/torch_dlrm_copies_probe.py shows both effects)."""
    import json as _json
    best = None
    for _ in range(MEMCPY_TRIES):
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
        got = (int(sum(sizes)), len(copies))
        best = got if best is None or got > best else best
    return best


def _dlrm_memory(pt, rows, feed, copies=False):
    """The memory a DLRM step needs beyond its state, at `rows` table rows:
    graphed, the pool the capture reserved and what a replay allocates;
    eager, the peak of what the step allocates; with `copies`, each step's
    memory copies on the card (bytes, count) instead."""
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
        if copies:
            out[f"{mode}_memcpy"] = _memcpy_bytes(step)
            continue
        _settled_reserved()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - before
        out[f"{mode}_step_bytes"] = peak + (pool if mode == "graph" else 0)
    del exe, scope, main, startup
    _settled_reserved()
    return out


def _dlrm_copies_fresh(timeout=600):
    """A DLRM step's memory copies (_dlrm_memory's `copies`) at DLRM's rows
    and at DLRM_BIG_ROWS on the batch train_dlrm trains on, measured by a
    fresh process of this script (`--dlrm-copies`: see _memcpy_bytes),
    which is gone after, whatever happened. -> {rows: {"graph_memcpy":
    [bytes, count], "eager_memcpy": ...}}."""
    d = Path(__file__).resolve().parent / "build"
    d.mkdir(exist_ok=True)
    out = d / f"dlrm-copies-{os.getpid()}.json"
    out.unlink(missing_ok=True)
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                           "--dlrm-copies", str(out)], capture_output=True,
                          text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"train_dlrm: the copies process exited "
                           f"{proc.returncode}:\n{proc.stderr[-3000:]}")
    try:
        return {int(r): v for r, v in json.loads(out.read_text()).items()}
    finally:
        out.unlink(missing_ok=True)


def _dlrm_copies_main(path) -> int:
    """The fresh process of _dlrm_copies_fresh: both heights' copies as
    JSON at `path`. The profiler runs once before any graph is captured,
    so that the graphs' copy nodes are traced (_memcpy_bytes)."""
    import torch
    import paddle_tpu_torch as pt
    with _profiled():
        torch.ones(1, device="cuda").add_(1)
    c = DLRM
    feed = _dlrm_batch(np.random.default_rng(SEED + 21), c["rows"],
                       c["batch"])
    res = {}
    for r in (c["rows"], DLRM_BIG_ROWS):
        m = _dlrm_memory(pt, r, feed, copies=True)
        res[r] = {k: m[k] for k in ("graph_memcpy", "eager_memcpy")}
    Path(path).write_text(json.dumps(res))
    return 0


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
    (these in a fresh process, _dlrm_copies_fresh) at 1M and at 4M table
    rows, which must not grow. Returns S1's launches
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
    for r, cp in _dlrm_copies_fresh().items():
        memory[r].update(cp)
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



# --- the training front end: the recipe, the optimizer family, the readers ---

RECIPE_SEED = 1
# the transformer paper's training recipe (Vaswani et al. 2017, "Attention Is
# All You Need", §5.3-5.4): Adam (0.9, 0.98, 1e-9), noam LR with 4000
# warm-up steps, label smoothing 0.1; and the global-norm clip at 1.0. The
# phase resumes at the end of the warm-up, where the LR peaks (~7.0e-4):
# at step 10 it is ~1.7e-6 and a few steps move nothing
RECIPE = {"beta1": 0.9, "beta2": 0.98, "epsilon": 1e-9, "warmup": 4000,
          "smoothing": 0.1, "clip_norm": 1.0, "resume_step": 3999}
RECIPE_BITWISE_STEPS = 10           # warm-up, capture, 8 replays: bitwise eager
RECIPE_TURNS = 8                    # then graphed and eager steps in turns
GAUGE_TURNS = 8                     # steps with the gauge's read on and off
LR_RTOL = 1e-6                      # the fetched LR against the host's
# the gauge against the norm of the fetched grads: the card sums each
# grad's squares in f32 in its own order, the host in f64
GAUGE_RTOL = 1e-4
# the clipped Adam update against the host's, relative to the update's
# largest magnitude: the host repeats the program's f32 operations in
# their order, with the gauge's norm
UPDATE_RTOL = 1e-5

# one pass per optimizer the slice ports, each with a front-end piece
OPT_PASSES = ("rmsprop", "adamax", "adadelta", "decayed_adagrad", "ftrl",
              "adam_model_average")
OPT_BITWISE_STEPS = 3               # warm-up, capture, replay: bitwise eager
OPT_TIMED_STEPS = 5                 # then replays and eager steps in turns
AVG = {"rate": 1.0, "min_window": 1, "max_window": 1000}

READER_SEED = 1                     # Python's `random`, which shuffle draws from
READER_CMP_STEPS = 3                # pulled batches and losses held to the fed path
TRACE_LM = {"attn.launches": LM["n_layer"], "attn.dq_launches": LM["n_layer"],
            "attn.dkv_launches": LM["n_layer"]}
K7_WITNESS = ("K7", lambda name: "flash_fwd_kernel" in name)


def lm_recipe_net(pt, cfg=None):
    """bench.py's transformer LM (`cfg`, LM by default) trained to the
    transformer paper's recipe: the logits of transformer_lm against
    label_smooth(one_hot(labels), 0.1) as soft labels, Adam (0.9, 0.98,
    1e-9) at noam_decay(d_model, 4000), every parameter's grad clipped to
    global norm 1.0, AMP O2. -> (main, startup, loss, lr, logits)."""
    cfg = LM if cfg is None else cfg
    V, t = cfg["vocab"], cfg["seqlen"]
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        L = pt.layers
        tok = L.data(name="tok", shape=[-1, t], dtype="int64",
                     append_batch_size=False)
        lab = L.data(name="lab", shape=[-1, t], dtype="int64",
                     append_batch_size=False)
        _, logits = pt.models.transformer_lm(
            tok, lab, vocab_size=V, d_model=cfg["d_model"],
            n_head=cfg["n_head"], n_layer=cfg["n_layer"], return_logits=True)
        smooth = L.label_smooth(L.one_hot(L.reshape(lab, [-1, 1]), V),
                                epsilon=RECIPE["smoothing"])
        loss = L.mean(L.softmax_with_cross_entropy(
            L.reshape(logits, [-1, V]), smooth, soft_label=True))
        lr = L.noam_decay(cfg["d_model"], RECIPE["warmup"])
        pt.clip.set_gradient_clip(
            pt.clip.GradientClipByGlobalNorm(RECIPE["clip_norm"]))
        opt = pt.optimizer.Adam(learning_rate=lr, beta1=RECIPE["beta1"],
                                beta2=RECIPE["beta2"],
                                epsilon=RECIPE["epsilon"])
        pt.amp.decorate(opt, level="O2").minimize(loss)
    main.random_seed = startup.random_seed = RECIPE_SEED
    return main, startup, loss, lr, logits


def noam_host(step, d_model, warmup):
    return d_model ** -0.5 * min(step ** -0.5, warmup ** -1.5 * step)


def _lm_feed(cfg=None, seed=RECIPE_SEED):
    cfg = LM if cfg is None else cfg
    rng = np.random.default_rng(seed)
    shape = (cfg["batch"], cfg["seqlen"])
    return {"tok": rng.integers(0, cfg["vocab"], shape).astype(np.int64),
            "lab": rng.integers(0, cfg["vocab"], shape).astype(np.int64)}


def _graphed_eager(exe, main, fetch, sg, se, feed, what):
    """One step of `feed` graphed on scope `sg` and one eager
    (use_jit=False) on `se`, each fetch of the two bitwise -> (the graphed
    fetches, graphed ms, eager ms). A feed of None pulls the program's
    reader."""
    import torch
    out, ms = {}, {}
    for mode, sc, use_jit in (("graph", sg, None), ("eager", se, False)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[mode] = exe.run(main, feed=feed, fetch_list=fetch, scope=sc,
                            use_jit=use_jit)
        ms[mode] = (time.perf_counter() - t0) * 1e3
    for j, (a, b) in enumerate(zip(out["graph"], out["eager"])):
        if not np.array_equal(a, b):
            raise RuntimeError(f"{what}: fetch {j} of the graphed step is "
                               f"not the eager step's: {a.ravel()[:4]} vs "
                               f"{b.ravel()[:4]}")
    return out["graph"], ms["graph"], ms["eager"]


def _step_memory(exe, main, feed, fetch, sg, se, pool_gb):
    """GB a graphed and an eager step need beyond the scope's state (the
    graph's pool, measured across its capture, added to the replay's)."""
    import torch
    peak = {}
    for mode, sc, use_jit in (("graph", sg, None), ("eager", se, False)):
        _settled_reserved()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        exe.run(main, feed=feed, fetch_list=fetch, scope=sc, use_jit=use_jit)
        torch.cuda.synchronize()
        peak[mode] = (torch.cuda.max_memory_allocated() - before) / 1e9
    peak["graph"] += pool_gb
    return peak


def _state_gb(scope):
    import torch
    return sum(v.numel() * v.element_size() for v in scope.vars.values()
               if isinstance(v, torch.Tensor)) / 1e9


def _adam_host(p, g, m1, m2, lr, b1, b2, eps, b1p, b2p):
    """adam_dense's f32 operations in their order, on the host."""
    f = np.float32
    m1o = m1 * f(b1) + g * f(1 - b1)
    m2o = m2 * f(b2) + g * f(1 - b2) * g
    lr_t = f(lr) * np.sqrt(f(1) - f(b2p)) / (f(1) - f(b1p))
    return p - lr_t * m1o / (np.sqrt(m2o) + f(eps))


def phase_train_lm_recipe(pt, report, cfg=None):
    """The LM trained to the transformer paper's recipe (lm_recipe_net)
    from the startup of seed 1, its step counter set to 3999 as a run
    resumed at the end of the warm-up would hold it: RECIPE_BITWISE_STEPS
    graphed steps (warm-up, capture, replays) bitwise their eager twins on
    a second scope, then RECIPE_TURNS of each in turns; each step's
    fetched LR the host's closed form of its step number; the counter at
    the steps run after them (a replay advances it in place); the loss
    finite and falling; the global norm the gauge publishes each step and
    the share of steps that clipped; the gauge's cost (graphed steps with
    PADDLE_TPU_TELEMETRY_FETCH=0 and =1 in turns); memory beyond the
    state; one eager step whose gauge is the host's norm of its fetched
    grads and whose update is Adam on g * min(1, 1/|g|); a replay's
    K7/K8/K9 launches from its trace. -> those launches."""
    import torch
    from paddle_tpu_torch import executor as E
    from paddle_tpu_torch import telemetry
    cfg = LM if cfg is None else cfg
    card = _card_line()
    B, T = cfg["batch"], cfg["seqlen"]
    main, startup, loss, lr, _ = lm_recipe_net(pt, cfg)
    exe = pt.Executor()
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    counter = scope.find_var("@STEP_COUNTER@")
    scope.set_var("@STEP_COUNTER@", torch.full_like(
        counter, RECIPE["resume_step"]))
    init = {n: v for n, v in scope.vars.items() if isinstance(v, torch.Tensor)}
    sg, se = _scope_from(pt, init), _scope_from(pt, init)
    del scope
    feed = _lm_feed(cfg)
    label = telemetry.program_label(main)
    E.COUNTERS.reset()
    reserved0 = _settled_reserved()
    steps = RECIPE_BITWISE_STEPS + RECIPE_TURNS
    losses, lrs, norms, g_ms, e_ms = [], [], [], [], []
    t0 = time.perf_counter()
    for i in range(steps):
        (lo, lr_v), g, e = _graphed_eager(exe, main, [loss, lr], sg, se, feed,
                                          "train_lm_recipe")
        losses.append(float(lo.ravel()[0]))
        lrs.append(float(lr_v.ravel()[0]))
        norms.append(telemetry.read_gauge("optimizer_global_norm",
                                          program=label))
        g_ms.append(g)
        e_ms.append(e)
        if i == RECIPE_BITWISE_STEPS - 1:
            setup_s = time.perf_counter() - t0
            pool_gb = (_settled_reserved() - reserved0) / 1e9
    diverged = _bitwise_scopes(sg, se)
    c = E.COUNTERS
    if diverged or (c.warmups, c.captures, c.replays) != (1, 1, steps - 1) \
            or c.eager != {"use_jit": steps}:
        raise RuntimeError(f"train_lm_recipe: after {steps} steps the scopes "
                           f"differ in {diverged[:8]}, or the steps were not "
                           f"one warm-up, one capture and replays: {c}")
    ran = [int(s.find_var("@STEP_COUNTER@").item()) for s in (sg, se)]
    if ran != [RECIPE["resume_step"] + steps] * 2:
        raise RuntimeError(f"train_lm_recipe: @STEP_COUNTER@ {ran} after "
                           f"{steps} steps from {RECIPE['resume_step']}")
    want_lr = [noam_host(RECIPE["resume_step"] + s, cfg["d_model"],
                         RECIPE["warmup"]) for s in range(1, steps + 1)]
    lr_err = max(abs(a - b) / b for a, b in zip(lrs, want_lr))
    if lr_err > LR_RTOL:
        raise RuntimeError(f"train_lm_recipe: the fetched LR {lrs[:3]}... is "
                           f"{lr_err:.3g} from the host's {want_lr[:3]}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise RuntimeError(f"train_lm_recipe: the loss did not fall: {losses}")
    if any(n is None or not np.isfinite(n) for n in norms):
        raise RuntimeError(f"train_lm_recipe: the gauge read {norms}")
    clipped = float(np.mean([n > RECIPE["clip_norm"] for n in norms]))
    p50 = {"graph": float(np.median(g_ms[RECIPE_BITWISE_STEPS:])),
           "eager": float(np.median(e_ms[RECIPE_BITWISE_STEPS:]))}
    peak = _step_memory(exe, main, feed, [loss, lr], sg, se, pool_gb)
    state_gb = _state_gb(se)

    # the gauge's cost: graphed steps fetching the norm beside the loss and
    # not, in turns (each its own signature: its warm-up and capture first)
    gauge_ms = {"on": [], "off": []}
    try:
        for i in range(2 + GAUGE_TURNS):
            for mode in ("on", "off"):
                os.environ["PADDLE_TPU_TELEMETRY_FETCH"] = \
                    "1" if mode == "on" else "0"
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                exe.run(main, feed=feed, fetch_list=[loss], scope=sg)
                if i >= 2:
                    gauge_ms[mode].append((time.perf_counter() - t0) * 1e3)
    finally:
        os.environ["PADDLE_TPU_TELEMETRY_FETCH"] = "1"
    gauge_p50 = {m: float(np.median(v)) for m, v in gauge_ms.items()}
    prof = _profile_step(exe, main, feed, loss, sg, gauge_p50["on"], card,
                         K7_WITNESS, expect=TRACE_LM)

    # one eager step: the gauge against the host's norm of the fetched
    # grads, and each parameter's update against Adam on the clipped grad
    sc = _scope_from(pt, {n: v for n, v in sg.vars.items()
                          if isinstance(v, torch.Tensor)})
    adams = [o for o in main.global_block().ops if o.type == "adam"]
    params = [o.input("Param")[0] for o in adams]
    before = {n: sc.find_var(n).detach().float().cpu().numpy()
              for o in adams for n in (o.input("Param") + o.input("Moment1")
                                       + o.input("Moment2")
                                       + o.input("Beta1Pow")
                                       + o.input("Beta2Pow"))}
    vals = exe.run(main, feed=feed, fetch_list=[lr] + [p + "@GRAD"
                                                      for p in params],
                   scope=sc, use_jit=False)
    lr_v, grads = float(vals[0].ravel()[0]), dict(zip(params, vals[1:]))
    gauge = telemetry.read_gauge("optimizer_global_norm", program=label)
    host_norm = math.sqrt(sum(float(np.sum(np.square(g.astype(np.float64))))
                              for g in grads.values()))
    if abs(gauge - host_norm) > GAUGE_RTOL * host_norm:
        raise RuntimeError(f"train_lm_recipe: the gauge {gauge} is not the "
                           f"host's norm {host_norm} of the fetched grads")
    scale = np.float32(RECIPE["clip_norm"]) / np.maximum(
        np.float32(RECIPE["clip_norm"]), np.float32(gauge))
    worst = 0.0
    for o in adams:
        p = o.input("Param")[0]
        want = _adam_host(
            before[p], grads[p].astype(np.float32) * scale,
            before[o.input("Moment1")[0]], before[o.input("Moment2")[0]],
            lr_v, RECIPE["beta1"], RECIPE["beta2"], RECIPE["epsilon"],
            before[o.input("Beta1Pow")[0]].ravel()[0],
            before[o.input("Beta2Pow")[0]].ravel()[0])
        got = sc.find_var(p).detach().float().cpu().numpy()
        upd = float(np.abs(want - before[p]).max()) or 1.0
        worst = max(worst, float(np.abs(got - want).max()) / upd)
    if worst > UPDATE_RTOL:
        raise RuntimeError(f"train_lm_recipe: the card's update is "
                           f"{worst:.3g} of the update's size from Adam on "
                           f"the clipped grads")
    del sc
    tok_s = B * T / (p50["graph"] / 1e3)
    out = {"card": card, "config": cfg, "recipe": RECIPE, "p50_ms": p50,
           "tokens_per_s": tok_s, "busy_ms": prof["busy_ms"],
           "busy_share": prof["busy_share"], "losses": losses, "lrs": lrs,
           "lr_max_rel_err": lr_err, "global_norms": norms,
           "clipped_share": clipped, "gauge_p50_ms": gauge_p50,
           "gauge_cost_ms": gauge_p50["on"] - gauge_p50["off"],
           "step_memory_gb": peak, "graph_pool_gb": pool_gb,
           "state_gb": state_gb, "setup_s": setup_s,
           "eager_step": {"gauge": gauge, "host_norm": host_norm,
                          "update_rel_err": worst},
           "launches_per_step": {k: prof["launches"][k] for k in TRACE_LM},
           "step_ms": {"graph": g_ms, "eager": e_ms}}
    report["train_lm_recipe"] = out
    print(f"train_lm_recipe: {steps} steps graphed bitwise eager from "
          f"@STEP_COUNTER@ {RECIPE['resume_step']} (warm-up and capture "
          f"{setup_s:.1f} s); step p50 graphed {p50['graph']:.2f} ms "
          f"({tok_s:.0f} tokens/s), eager {p50['eager']:.2f} ms; busy "
          f"{prof['busy_ms']:.2f} ms ({prof['busy_share']:.1%}) of a "
          f"replay; LR {lrs[0]:.4g} -> {lrs[-1]:.4g}, at most {lr_err:.2g} "
          f"from the host's noam; loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"global norm {min(norms):.3f}-{max(norms):.3f}, {clipped:.0%} of "
          f"the steps clipped; graphed step with the gauge "
          f"{gauge_p50['on']:.2f} ms, without {gauge_p50['off']:.2f} ms; "
          f"memory beyond the {state_gb:.3f} GB of state {peak['graph']:.3f} "
          f"GB graphed (pool {pool_gb:.3f} GB), {peak['eager']:.3f} GB eager; "
          f"one eager step: gauge {gauge:.6f} vs host {host_norm:.6f}, update "
          f"within {worst:.2g} of Adam on the clipped grads; K7/K8/K9 per "
          f"replay {out['launches_per_step']} ({card})", flush=True)
    return prof["launches"]


def lm_optimizer_net(pt, name, cfg=None):
    """The LM (`cfg`, LM by default; AMP O2) trained by one of OPT_PASSES,
    each with a front-end piece: RMSProp with L1Decay(1e-5) and
    GradientClipByValue(-1, 1); Adamax on piecewise_decay; Adadelta;
    DecayedAdagrad on exponential_decay(staircase); Ftrl with
    GradientClipByNorm(1.0); Adam under ModelAverage. -> (main, startup,
    loss, logits, the ModelAverage or None)."""
    cfg = LM if cfg is None else cfg
    t = cfg["seqlen"]
    main, startup = pt.Program(), pt.Program()
    avg = None
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        L = pt.layers
        tok = L.data(name="tok", shape=[-1, t], dtype="int64",
                     append_batch_size=False)
        lab = L.data(name="lab", shape=[-1, t], dtype="int64",
                     append_batch_size=False)
        loss, logits = pt.models.transformer_lm(
            tok, lab, vocab_size=cfg["vocab"], d_model=cfg["d_model"],
            n_head=cfg["n_head"], n_layer=cfg["n_layer"], return_logits=True)
        O = pt.optimizer
        if name == "rmsprop":
            pt.clip.set_gradient_clip(pt.clip.GradientClipByValue(1.0, -1.0))
            opt = O.RMSProp(1e-4, regularization=pt.regularizer.L1Decay(1e-5))
        elif name == "adamax":
            opt = O.Adamax(L.piecewise_decay([2, 5], [1e-3, 5e-4, 2e-4]))
        elif name == "adadelta":
            opt = O.Adadelta(1.0)
        elif name == "decayed_adagrad":
            opt = O.DecayedAdagrad(L.exponential_decay(1e-3, 2, 0.5,
                                                       staircase=True))
        elif name == "ftrl":
            pt.clip.set_gradient_clip(pt.clip.GradientClipByNorm(1.0))
            opt = O.Ftrl(1e-3)
        else:
            opt = O.Adam(1e-3)
        pt.amp.decorate(opt, level="O2").minimize(loss)
        if name == "adam_model_average":
            avg = O.ModelAverage(AVG["rate"], min_average_window=AVG[
                "min_window"], max_average_window=AVG["max_window"])
    main.random_seed = startup.random_seed = RECIPE_SEED
    return main, startup, loss, logits, avg


def model_average_host(snaps, rate, min_window, max_window):
    """ModelAverage's average of the parameter snapshots `snaps` (one dict
    a step), with average_accumulates' sums, window and count, in f32 and
    in the op's order of operations."""
    f = np.float32
    s1 = {n: np.zeros_like(v) for n, v in snaps[0].items()}
    s2 = {n: np.zeros_like(v) for n, v in snaps[0].items()}
    s3 = {n: np.zeros_like(v) for n, v in snaps[0].items()}
    na = on = nu = 0
    for snap in snaps:
        nu, na = nu + 1, na + 1
        s1 = {n: s1[n] + snap[n] for n in snap}
        if nu % 16384 == 0:
            s2 = {n: s2[n] + s1[n] for n in snap}
            s1 = {n: np.zeros_like(v) for n, v in s1.items()}
        limit = int(min(f(max_window), f(nu) * f(rate)))
        if na >= min(min_window, max_window) and na >= limit:
            s3 = {n: s1[n] + s2[n] for n in snap}
            s1 = {n: np.zeros_like(v) for n, v in s1.items()}
            s2 = {n: np.zeros_like(v) for n, v in s2.items()}
            on, na = na, 0
    cnt = max(f(na + on), f(1.0))
    return {n: (s1[n] + s2[n] + s3[n]) / cnt for n in s1}


def _model_average_check(pt, exe, main, logits, avg, sg, snaps, feed, what):
    """Inside ModelAverage.apply on scope `sg`: every parameter bitwise the
    host's average of the snapshots, and the logits of the pruned forward
    bitwise those of the host's averaged parameters; after it, the trained
    parameters back bitwise. -> the logits' checks."""
    import torch
    params = sorted(snaps[-1])
    host = model_average_host([{n: s[n].cpu().numpy() for n in params}
                               for s in snaps], AVG["rate"],
                              AVG["min_window"], AVG["max_window"])
    infer = main.prune(["tok"], [logits.name])
    with pt.scope_guard(sg), avg.apply(exe):
        off = [n for n in params if not np.array_equal(
            sg.find_var(n).cpu().numpy(), host[n])]
        inside, = exe.run(infer, feed={"tok": feed["tok"]},
                          fetch_list=[logits], scope=sg)
    if off:
        raise RuntimeError(f"{what}: inside apply the parameters {off[:4]} "
                           f"are not the host's average")
    sh = pt.Scope()
    dev = sg.find_var(params[0]).device
    for n in params:
        sh.set_var(n, torch.from_numpy(host[n]).to(dev))
    want, = exe.run(infer, feed={"tok": feed["tok"]}, fetch_list=[logits],
                    scope=sh)
    if not np.array_equal(inside, want):
        raise RuntimeError(f"{what}: the logits inside apply are not those "
                           f"of the host-averaged parameters")
    back = [n for n in params if not torch.equal(sg.find_var(n),
                                                 snaps[-1][n])]
    if back:
        raise RuntimeError(f"{what}: restore left {back[:4]} other than "
                           f"trained")
    return {"params": len(params), "steps_averaged": len(snaps),
            "logits_shape": list(inside.shape)}


def phase_train_optimizers(pt, report, cfg=None):
    """The LM at its full widths once per OPT_PASSES entry, from the
    startup of seed 1 on two scopes: OPT_BITWISE_STEPS graphed steps
    (warm-up, capture, replay) bitwise their eager twins, then
    OPT_TIMED_STEPS replays and eager steps in turns, bitwise (p50); the
    loss finite; sparse_densify_fallback_total 0; a replay profiled (busy
    share, K7/K8/K9 from the trace). Under ModelAverage the parameters
    after each step are kept, and inside apply the parameters and the
    logits are those of the host's average, and restore gives the trained
    parameters back, bitwise. -> the replays' launches, summed."""
    import torch
    from paddle_tpu_torch import executor as E
    from paddle_tpu_torch import telemetry
    cfg = LM if cfg is None else cfg
    card = _card_line()
    feed = _lm_feed(cfg)
    tokens = cfg["batch"] * cfg["seqlen"]
    launches, out = {k: 0 for k in TRACE_LM}, {}
    for name in OPT_PASSES:
        main, startup, loss, logits, avg = lm_optimizer_net(pt, name, cfg)
        exe = pt.Executor()
        scope = pt.Scope()
        exe.run(startup, scope=scope)
        init = {n: v for n, v in scope.vars.items()
                if isinstance(v, torch.Tensor)}
        sg, se = _scope_from(pt, init), _scope_from(pt, init)
        del scope, init
        params = [p.name for p in main.global_block().all_parameters()]
        densify0 = sum(telemetry.read_series(
            "sparse_densify_fallback_total").values())
        E.COUNTERS.reset()
        steps = OPT_BITWISE_STEPS + OPT_TIMED_STEPS
        losses, g_ms, e_ms, snaps = [], [], [], []
        for i in range(steps):
            (lo,), g, e = _graphed_eager(exe, main, [loss], sg, se, feed,
                                         f"train_optimizers {name}")
            losses.append(float(lo.ravel()[0]))
            g_ms.append(g)
            e_ms.append(e)
            if avg is not None:
                snaps.append({n: se.find_var(n).clone() for n in params})
        diverged = _bitwise_scopes(sg, se)
        c = E.COUNTERS
        if diverged or (c.warmups, c.captures, c.replays) != \
                (1, 1, steps - 1) or c.eager != {"use_jit": steps}:
            raise RuntimeError(f"train_optimizers {name}: scopes differ in "
                               f"{diverged[:8]}, or the steps were not one "
                               f"warm-up, one capture and replays: {c}")
        densify = sum(telemetry.read_series(
            "sparse_densify_fallback_total").values())
        if not np.isfinite(losses).all() or densify or densify0:
            raise RuntimeError(f"train_optimizers {name}: losses {losses}, "
                               f"densified {densify0} -> {densify}")
        p50 = {"graph": float(np.median(g_ms[OPT_BITWISE_STEPS:])),
               "eager": float(np.median(e_ms[OPT_BITWISE_STEPS:]))}
        prof = _profile_step(exe, main, feed, loss, sg, p50["graph"], card,
                             K7_WITNESS, expect=TRACE_LM)
        for k in TRACE_LM:
            launches[k] += prof["launches"][k]
        if avg is not None:
            # the profiled step trained sg once more: the snapshot of its
            # parameters joins the window
            snaps.append({n: sg.find_var(n).clone() for n in params})
        res = {"p50_ms": p50, "tokens_per_s": tokens / (p50["graph"] / 1e3),
               "busy_ms": prof["busy_ms"], "busy_share": prof["busy_share"],
               "losses": losses, "densified": densify,
               "step_ms": {"graph": g_ms, "eager": e_ms},
               "launches_per_step": {k: prof["launches"][k]
                                     for k in TRACE_LM}}
        if avg is not None:
            res["model_average"] = _model_average_check(
                pt, exe, main, logits, avg, sg, snaps, feed,
                f"train_optimizers {name}")
        out[name] = res
        print(f"train_optimizers {name}: {steps} steps graphed bitwise "
              f"eager; step p50 graphed {p50['graph']:.2f} ms "
              f"({res['tokens_per_s']:.0f} tokens/s), eager "
              f"{p50['eager']:.2f} ms; busy {prof['busy_ms']:.2f} ms "
              f"({prof['busy_share']:.1%}) of a replay; loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f}; densified "
              f"{densify}; K7/K8/K9 per replay {res['launches_per_step']}"
              + ("" if avg is None else
                 f"; ModelAverage over {len(snaps)} steps: inside apply the "
                 f"parameters and logits the host average's, restore "
                 f"bitwise") + f" ({card})", flush=True)
        del exe, sg, se, snaps
        _settled_reserved()
    report["train_optimizers"] = {"card": card, "config": cfg,
                                  "passes": out}
    return launches


def _resnet50_reader_train(pt, resnet, path):
    """_resnet50_train's program (FEED_CLASSES classes) reading its batches
    itself: open_recordio_file(path) -> shuffle(FEED_SHUFFLE) ->
    batch(TRAIN_BATCH) -> double_buffer -> read_file. -> (main, startup,
    loss, reader, img, label)."""
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        L = pt.layers
        r = L.open_recordio_file(path, shapes=[[-1, 3, 224, 224], [-1, 1]],
                                 lod_levels=[0, 0],
                                 dtypes=["float32", "int64"])
        r = L.double_buffer(L.batch(L.shuffle(r, FEED_SHUFFLE), TRAIN_BATCH))
        img, label = L.read_file(r)
        avg_cost, _, _ = pt.models.build_image_classifier(
            resnet.resnet50, img, label, class_dim=FEED_CLASSES)
        opt = pt.optimizer.Momentum(learning_rate=TRAIN_LR, momentum=0.9)
        pt.amp.decorate(opt, level="O2").minimize(avg_cost)
    main.random_seed = startup.random_seed = SEED + 1
    return main, startup, avg_cost, r, img, label


def layer_shuffle_order(samples, buffer_size):
    """layers.shuffle's order of `samples` from the `random` state as it
    is: each full buffer shuffled and handed out from its end."""
    import random
    out, buf = [], []
    for s in samples:
        buf.append(s)
        if len(buf) >= buffer_size:
            random.shuffle(buf)
            out += buf[::-1]
            buf = []
    random.shuffle(buf)
    return out + buf[::-1]


def phase_train_reader_layers(pt, conv_cuda, bn_cuda, resnet, report):
    """ResNet-50 O2 at batch 32 reading the flowers surrogate itself: the
    samples written to a RecordIO file in a temporary directory, the
    program's reader chain pulled by exe.run() with no feed. The first
    READER_CMP_STEPS batches (the signature's warm-up, capture and a
    replay) bit for bit the host's: DataFeeder.feed of the seeded samples
    in the shuffle's order, as train_feeder's path converts them; each
    step's loss bitwise the fed program's on that batch from the same
    state; then the pass's other batches (p50, the consumer's wait); the
    pass's end raising EOFException; after reset() the next pass, whose
    second step, a replay, is profiled (busy share, K2-K6 launches from
    its trace, the graph's own kernel nodes first, held to
    TRAIN_LAUNCHES). Run it under _kept_graphs. -> those launches."""
    import random
    import shutil
    import tempfile
    import torch
    from paddle_tpu_torch import executor as E
    from paddle_tpu_torch.reader import pipeline
    card = _card_line()
    tmp = tempfile.mkdtemp(prefix="reader_layers_")
    try:
        samples = list(pt.dataset.flowers.train()())
        path = os.path.join(tmp, "flowers.recordio")
        t0 = time.perf_counter()
        # uncompressed: zlib takes ~20 s over these 600 MiB of noise
        pt.recordio.write_samples(path, (
            (img.reshape(3, 224, 224), np.array([lab], np.int64))
            for img, lab in samples), compressor="none")
        write_s = time.perf_counter() - t0
        mb = os.path.getsize(path) / 2 ** 20
        main, startup, loss, reader, img, label = _resnet50_reader_train(
            pt, resnet, path)
        fmain, _fstartup, floss = _resnet50_train(pt, resnet,
                                                  class_dim=FEED_CLASSES)
        exe = pt.Executor()
        scope = pt.Scope()
        exe.run(startup, scope=scope)
        init = {n: v for n, v in scope.vars.items()
                if isinstance(v, torch.Tensor)}
        sr, sf = _scope_from(pt, init), _scope_from(pt, init)
        del scope, init
        block = fmain.global_block()
        feeder = pt.DataFeeder([block.var("img"), block.var("label")],
                               exe.place, program=fmain)
        random.seed(READER_SEED)
        order = layer_shuffle_order(samples, FEED_SHUFFLE)
        host = [feeder.feed(order[i:i + TRAIN_BATCH])
                for i in range(0, len(order) - TRAIN_BATCH + 1, TRAIN_BATCH)]
        n_batches = -(-len(samples) // TRAIN_BATCH)

        E.COUNTERS.reset()
        pipeline.COUNTERS.reset()
        random.seed(READER_SEED)
        t0 = time.perf_counter()
        held = []
        for b in range(READER_CMP_STEPS):
            lo, im, lb = exe.run(main, fetch_list=[loss, img, label],
                                 scope=sr)
            if not (np.array_equal(im, host[b]["img"])
                    and np.array_equal(lb, host[b]["label"])):
                raise RuntimeError(f"train_reader_layers: batch {b} the "
                                   f"program read is not the host's")
            lf, = exe.run(fmain, feed=host[b], fetch_list=[floss], scope=sf)
            if not np.array_equal(lo, lf):
                raise RuntimeError(f"train_reader_layers: step {b}'s loss "
                                   f"{lo} is not the fed step's {lf}")
            held.append(float(lo.ravel()[0]))
        first_s = time.perf_counter() - t0
        losses, times = list(held), []
        wait0 = pipeline.COUNTERS.wait_s
        for _ in range(READER_CMP_STEPS, n_batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lo, = exe.run(main, fetch_list=[loss], scope=sr)
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(lo.ravel()[0]))
        # the first two of them warm up and capture the [loss] signature
        wait_ms = (pipeline.COUNTERS.wait_s - wait0) * 1e3
        try:
            exe.run(main, fetch_list=[loss], scope=sr)
        except pt.layers.EOFException:
            pass
        else:
            raise RuntimeError(f"train_reader_layers: no EOFException after "
                               f"the pass's {n_batches} batches")
        c = E.COUNTERS
        if c.eager or c.warmups != 3 or c.captures != 3:
            raise RuntimeError(f"train_reader_layers: {c}")
        if not np.isfinite(losses).all():
            raise RuntimeError(f"train_reader_layers: losses {losses}")
        reader.reset()
        random.seed(READER_SEED + 1)
        # the next pass: its first pull waits for the shuffle buffer to
        # fill; its second step, a replay, is profiled
        lo, = exe.run(main, fetch_list=[loss], scope=sr)
        if not np.isfinite(lo).all():
            raise RuntimeError("train_reader_layers: the second pass's loss")
        timed = times[2:]
        p50 = float(np.median(timed))
        expect = {("bn." if k in ("apply_launches", "act_launches")
                   else "conv.") + k: v for k, v in TRAIN_LAUNCHES.items()}
        # held first to the replayed graph's own kernel nodes: the profiler
        # drops K6's record of a replay now and then (ROADMAP Queue 3)
        graph, = [e.graph for k, e in exe._graphs.items()
                  if k[0] == id(main) and k[3] == (loss.name,)]
        prof = _profile_step(exe, main, None, loss, sr, p50, card,
                             ("K4", lambda name: K1_KERNEL in name
                              and "true" in name), expect=expect, graph=graph)
        reader.reset()
        fed = report.get("train_feeder", {})
        fed_wait = fed.get("wait_ms")
        fed_steps = FEED_WINDOWS * FEED_K
        out = {"card": card, "batch": TRAIN_BATCH, "samples": len(samples),
               "file_mb": mb, "write_s": write_s,
               "first_steps_s": first_s, "p50_ms": p50,
               "img_per_s": TRAIN_BATCH / (p50 / 1e3),
               "wait_ms": wait_ms, "wait_ms_per_step": wait_ms / len(times),
               "busy_ms": prof["busy_ms"], "busy_share": prof["busy_share"],
               "losses": losses, "steps_ms": times,
               "batches_bitwise": READER_CMP_STEPS,
               # the trace's, and records it lost of the graph's nodes
               "launches_per_step": {k: prof["launches"][k]
                                     + prof["lost_records"].get(k, 0)
                                     for k in expect},
               "lost_records": prof["lost_records"],
               "train_feeder": {
                   "per_step_p50_ms": fed.get("per_step_p50_ms"),
                   "wait_ms_per_step": None if fed_wait is None
                   else fed_wait / fed_steps}}
        report["train_reader_layers"] = out
        print(f"train_reader_layers: {len(samples)} flowers samples written "
              f"to RecordIO ({mb:.0f} MiB, {write_s:.1f} s); ResNet-50 O2 "
              f"batch {TRAIN_BATCH} pulling open_recordio_file -> "
              f"shuffle({FEED_SHUFFLE}) -> batch -> double_buffer -> "
              f"read_file with no feed: {READER_CMP_STEPS} batches bitwise "
              f"the host's DataFeeder batches and their losses the fed "
              f"program's ({first_s:.1f} s with the file's read and the "
              f"warm-ups); step p50 {p50:.1f} ms ({out['img_per_s']:.1f} "
              f"img/s; train_feeder's run_steps {fed.get('per_step_p50_ms')} "
              f"ms a step), consumer wait {out['wait_ms_per_step']:.2f} ms a "
              f"step (train_feeder's {out['train_feeder']['wait_ms_per_step']}"
              f"); EOFException after {n_batches} batches, then a pass "
              f"after reset(); busy {prof['busy_ms']:.1f} ms "
              f"({prof['busy_share']:.1%}) of a replay; launches per step "
              f"{out['launches_per_step']} ({card})", flush=True)
        return out["launches_per_step"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# --- vision and detection: the zoo's CNNs and a MobileNet-SSD ----------------

# MobileNet-SSD as PaddlePaddle's object-detection example of the period
# builds it (PaddlePaddle models, fluid/object_detection/mobilenet_ssd.py):
# a MobileNet-v1 backbone (conv_bn 3x3/2, 13 depthwise-separable blocks),
# four extra stride-2 stages, multi_box_head over six maps (19x19 down to
# 1x1 at 300x300), base_size 300, min_ratio 20, max_ratio 90, aspect ratios
# [[2], [2, 3] x 5], flip, clip, kernel_size 3, pad 1; 21 VOC classes;
# ssd_loss with its defaults, summed; Momentum 0.9 at lr 1e-3. Synthetic
# VOC-shaped inputs: images from a seed and 1..SSD["max_boxes"] boxes an
# image, so the padded ground-truth length is 8 for every batch (the
# executor buckets LoD lengths up to 8) and one graph signature serves.
SSD = {"classes": 21, "img": 300, "batch": 32, "lr": 1e-3, "scale": 1.0,
       "max_boxes": 8, "nms_threshold": 0.45}
SSD_ASPECT_RATIOS = [[2.0], [2.0, 3.0], [2.0, 3.0], [2.0, 3.0], [2.0, 3.0],
                     [2.0, 3.0]]


def ssd_conv_bn(pt, x, k, co, stride, pad, groups=1, act="relu"):
    """The example's conv_bn: a bias-free conv (MSRA init, learning rate
    0.1) and a batch norm with `act`."""
    conv = pt.layers.conv2d(
        input=x, num_filters=co, filter_size=k, stride=stride, padding=pad,
        groups=groups, act=None, bias_attr=False,
        param_attr=pt.ParamAttr(learning_rate=0.1,
                                initializer=pt.initializer.MSRA()))
    return pt.layers.batch_norm(input=conv, act=act)


def mobilenet_ssd(pt, img, num_classes, scale=1.0):
    """The example's mobile_net -> (mbox_loc [B, P, 4], mbox_conf
    [B, P, C], prior boxes [P, 4], their variances [P, 4])."""
    def dws(x, c1, c2, groups, stride):
        dw = ssd_conv_bn(pt, x, 3, int(c1 * scale), stride, 1,
                         groups=int(groups * scale))
        return ssd_conv_bn(pt, dw, 1, int(c2 * scale), 1, 0)

    def extra(x, c1, c2):
        pw = ssd_conv_bn(pt, x, 1, int(c1 * scale), 1, 0)
        return ssd_conv_bn(pt, pw, 3, int(c2 * scale), 2, 1)

    t = ssd_conv_bn(pt, img, 3, int(32 * scale), 2, 1)
    t = dws(t, 32, 64, 32, 1)
    t = dws(t, 64, 128, 64, 2)
    t = dws(t, 128, 128, 128, 1)
    t = dws(t, 128, 256, 128, 2)
    t = dws(t, 256, 256, 256, 1)
    t = dws(t, 256, 512, 256, 2)
    for _ in range(5):
        t = dws(t, 512, 512, 512, 1)
    m11 = t
    t = dws(t, 512, 1024, 512, 2)
    m13 = dws(t, 1024, 1024, 1024, 1)
    m14 = extra(m13, 256, 512)
    m15 = extra(m14, 128, 256)
    m16 = extra(m15, 128, 256)
    m17 = extra(m16, 64, 128)
    return pt.layers.detection.multi_box_head(
        inputs=[m11, m13, m14, m15, m16, m17], image=img,
        base_size=img.shape[2], num_classes=num_classes, min_ratio=20,
        max_ratio=90, aspect_ratios=SSD_ASPECT_RATIOS, offset=0.5,
        flip=True, clip=True, kernel_size=3, pad=1)


def ssd_train_net(pt, cfg, amp=True):
    """The example's training program: the feeds (image, gt_box and
    gt_label LoD), ssd_loss summed, Momentum 0.9 (AMP O2 when `amp`)
    -> (feed vars, loss, prior boxes)."""
    L = pt.layers
    img = L.data(name="image", shape=[3, cfg["img"], cfg["img"]],
                 dtype="float32")
    gt_box = L.data(name="gt_box", shape=[4], dtype="float32", lod_level=1)
    gt_label = L.data(name="gt_label", shape=[1], dtype="int32", lod_level=1)
    loc, conf, boxes, variances = mobilenet_ssd(pt, img, cfg["classes"],
                                                cfg["scale"])
    loss = L.reduce_sum(L.detection.ssd_loss(loc, conf, gt_box, gt_label,
                                             boxes, variances))
    opt = pt.optimizer.Momentum(learning_rate=cfg["lr"], momentum=0.9)
    if amp:
        opt = pt.amp.decorate(opt, level="O2")
    opt.minimize(loss)
    return [img, gt_box, gt_label], loss, boxes


def ssd_detect_net(pt, cfg):
    """The example's inference program: the backbone and detection_output
    (box decode, softmax, multiclass_nms: nms_top_k 400, keep_top_k 200,
    the example's nms_threshold) -> (image var, the padded [B, 200, 6]
    detections)."""
    img = pt.layers.data(name="image", shape=[3, cfg["img"], cfg["img"]],
                         dtype="float32")
    loc, conf, boxes, variances = mobilenet_ssd(pt, img, cfg["classes"],
                                                cfg["scale"])
    return img, pt.layers.detection.detection_output(
        loc, conf, boxes, variances, nms_threshold=cfg["nms_threshold"])


def ssd_batch(rng, lod_tensor, batch, cfg):
    """A synthetic VOC-shaped batch from `rng`: images [B, 3, H, W] and
    1..max_boxes boxes an image (x1 < x2, y1 < y2 in [0, 1], labels
    1..classes-1) as LoD feeds of `lod_tensor` (the package's LoDTensor)
    -> (feed, boxes per image, labels per image)."""
    img = rng.standard_normal((batch, 3, cfg["img"], cfg["img"]),
                              dtype=np.float32)
    boxes, labels = [], []
    for _ in range(batch):
        n = int(rng.integers(1, cfg["max_boxes"] + 1))
        lo = rng.uniform(0.0, 0.6, (n, 2))
        wh = rng.uniform(0.1, 0.4, (n, 2))
        boxes.append(np.concatenate([lo, lo + wh], 1).astype(np.float32))
        labels.append(rng.integers(1, cfg["classes"], (n, 1))
                      .astype(np.int32))
    offs = np.concatenate([[0], np.cumsum([len(b) for b in boxes])]).tolist()
    feed = {"image": img,
            "gt_box": lod_tensor(np.concatenate(boxes), [offs]),
            "gt_label": lod_tensor(np.concatenate(labels), [offs])}
    return feed, boxes, labels


# bench.py's CNN configurations (bench.py:111-125): the zoo's models at
# their own widths, trained under AMP O2 with Momentum 0.9 at bench.py's
# rates; alexnet and googlenet also served at bench.py's INFER_BS
ZOO = {"alexnet": {"model_fn": "alexnet", "img": 224, "classes": 1000,
                   "batch": 256, "lr": 0.01},
       "googlenet": {"model_fn": "googlenet", "img": 224, "classes": 1000,
                     "batch": 256, "lr": 0.005},
       "smallnet": {"model_fn": "smallnet_mnist_cifar", "img": 32,
                    "classes": 10, "batch": 512, "lr": 0.01}}
ZOO_SERVED = ("alexnet", "googlenet")
ZOO_INFER_BATCH = 16                # bench.py's INFER_BS (bench.py:124)
ZOO_BUCKETS = (1, 4, 16)
ZOO_BITWISE_STEPS = 3               # warm-up, capture, replay: held bitwise
ZOO_TURNS = 5                       # then graphed and eager steps in turns
SSD_STEPS_BITWISE = 3
SSD_TURNS = 5
SSD_SERVE_BATCH = 16
SSD_MAP_BATCHES = 3                 # batches DetectionMAP accumulates
ZOO_WITNESS = ("K3", lambda name: "conv2d_wgrad_kernel" in name)
# each path's kernel launches per training step, by the port's gates at
# the path's batch (zoo_kernel_shapes), held on the card to the eager
# steps' wrapper counts and to the replays' traces. alexnet: K1/K2/K3 at
# its four convs of 8-multiple channels (the 11x11 stride-4 stem, Ci 3,
# falls back under "channels"); googlenet: its 56 convs but the stem;
# smallnet: two of its three (the first, Ci 3, falls back); the SSD: K4 +
# K5 at its 13 pointwise and 8 extra conv -> bn -> relu windows, K6 after
# its 13 depthwise convs (which fall back under "groups") and its stem (Ci
# 3), K1 at the 6 loc heads (the 84- and 126-channel conf heads fall back
# under "channels"), K2 and K3 at the 27 eligible convs' grads
ZOO_LAUNCHES = {
    "alexnet": {"conv.launches": 4, "conv.dgrad_launches": 4,
                "conv.wgrad_launches": 4},
    "googlenet": {"conv.launches": 56, "conv.dgrad_launches": 56,
                  "conv.wgrad_launches": 56},
    "smallnet": {"conv.launches": 2, "conv.dgrad_launches": 2,
                 "conv.wgrad_launches": 2},
    "ssd": {"conv.launches": 6, "conv.dgrad_launches": 27,
            "conv.wgrad_launches": 27, "conv.stats_launches": 21,
            "bn.apply_launches": 21, "bn.act_launches": 14},
    "vgg16": VGG16_LAUNCHES}


def zoo_train_net(pt, cfg, amp=True):
    """bench.py's CNN training mode for one ZOO entry: the model through
    build_image_classifier, Momentum 0.9 at its rate, AMP O2 when `amp`
    -> (main, startup, avg cost)."""
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        img = pt.layers.data(name="img", shape=[3, cfg["img"], cfg["img"]],
                             dtype="float32")
        label = pt.layers.data(name="label", shape=[1], dtype="int64")
        avg_cost, _, _ = pt.models.build_image_classifier(
            getattr(pt.models, cfg["model_fn"]), img, label,
            class_dim=cfg["classes"])
        opt = pt.optimizer.Momentum(learning_rate=cfg["lr"], momentum=0.9)
        if amp:
            opt = pt.amp.decorate(opt, level="O2")
        opt.minimize(avg_cost)
    main.random_seed = startup.random_seed = SEED + 1
    return main, startup, avg_cost


def zoo_infer_net(pt, cfg):
    """bench.py's CNN inference mode: the model with is_test, softmax, AMP
    O2 -> (main, startup, probabilities)."""
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        img = pt.layers.data(name="img", shape=[3, cfg["img"], cfg["img"]],
                             dtype="float32")
        prob = pt.layers.softmax(getattr(pt.models, cfg["model_fn"])(
            img, class_dim=cfg["classes"], is_test=True))
    main.random_seed = startup.random_seed = SEED + 1
    pt.amp.enable(main, level="O2")
    return main, startup, prob


def ssd_programs(pt, cfg):
    """The SSD's training program (ssd_train_net, AMP O2) and its
    inference program (ssd_detect_net, its batch norms in inference mode,
    AMP O2), built under one name guard each so their parameters share
    names -> (train main, startup, loss, boxes, detect main, detections)."""
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        _, loss, boxes = ssd_train_net(pt, cfg)
    main.random_seed = startup.random_seed = SEED + 1
    det, det_startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(det, det_startup):
        _, out = ssd_detect_net(pt, cfg)
    for op in det.global_block().ops:
        if op.type == "batch_norm":
            op.set_attr("is_test", True)
    pt.amp.enable(det, level="O2")
    return main, startup, loss, boxes, det, out


def zoo_kernel_shapes(main, batch):
    """What the port's gates send to K1-K6 in one training step of `main`
    at `batch`, as under AMP O2: kernel -> {shape key: launches a step}
    (conv keys: x NHWC, w OIHW, strides, paddings, dilations; K5/K6 keys:
    [M, C] and act), and the refusals by (op, reason). conv -> bn [-> act]
    windows (fusion.plan) whose conv passes K1's gate run K4 + K5, the
    others' convs fall back and their bn runs K6 where its gate admits it;
    the other conv2d ops run K1; every conv2d_grad that passes the gate
    runs K2 for an Input grad and K3 for a Filter grad."""
    import torch
    from paddle_tpu_torch.ops import bn_cuda, conv_cuda, fusion
    block = main.global_block()
    ops = block.ops
    tables = {k: {} for k in ("K1", "K2", "K3", "K4", "K5", "K6")}
    refused = {}

    def add(table, key):
        table[key] = table.get(key, 0) + 1

    def conv_key(op):
        _, c, h, w = block.desc.var(op.input("Input")[0]).shape
        key = ((batch, h, w, c),
               tuple(block.desc.var(op.input("Filter")[0]).shape),
               tuple(op.attr("strides")), tuple(op.attr("paddings")),
               tuple(op.attr("dilations")))
        probe = [torch.empty(k, dtype=torch.bfloat16, device="meta")
                 for k in key[:2]]
        return key, conv_cuda.ineligible(*probe, *key[2:],
                                         op.attr("groups") or 1)
    windowed = set()
    for g in (fusion.plan(main) or {}).values():
        if g.bn is None:
            continue
        act = None if g.act is None else g.act.type
        dims = tuple(block.desc.var(g.bn.input("X")[0]).shape[1:])
        bn_key = (batch * int(np.prod(dims[1:])), dims[0], act)
        if g.conv is not None:
            windowed.add(g.start)
            key, reason = conv_key(g.conv)
            if reason is None and act in bn_cuda.ACTS:
                add(tables["K4"], key)
                add(tables["K5"], bn_key)
                continue
            add(refused, ("conv2d", reason or "act"))
        x = torch.empty((batch,) + dims, dtype=torch.bfloat16, device="meta")
        reason = bn_cuda.ineligible(x, g.bn.attr("is_test", False), act)
        if reason is None:
            add(tables["K6"], bn_key)
        else:
            add(refused, ("batch_norm", reason))
    for i, op in enumerate(ops):
        if op.type not in ("conv2d", "conv2d_grad"):
            continue
        key, reason = conv_key(op)
        if reason is not None:
            if i not in windowed:
                add(refused, (op.type, reason))
            continue
        if op.type == "conv2d":
            if i not in windowed:
                add(tables["K1"], key)
            continue
        if "Input@GRAD" in op.desc.outputs:
            add(tables["K2"], key)
        if "Filter@GRAD" in op.desc.outputs:
            add(tables["K3"], key)
    return tables, refused


_LAUNCH_KEYS = {"K1": "conv.launches", "K2": "conv.dgrad_launches",
                "K3": "conv.wgrad_launches", "K4": "conv.stats_launches",
                "K5": "bn.apply_launches", "K6": "bn.act_launches"}


def path_launches(name, tables):
    """The launches a step of path `name` gives each kernel counter by
    its gates (zoo_kernel_shapes' tables), held to ZOO_LAUNCHES[name]."""
    got = {_LAUNCH_KEYS[k]: sum(t.values()) for k, t in tables.items()
           if sum(t.values())}
    if got != ZOO_LAUNCHES[name]:
        raise RuntimeError(f"{name}'s gates admit {got} launches a step, "
                           f"expected {ZOO_LAUNCHES[name]}")
    return got



def _zoo_feed(cfg, batch, seed):
    """One synthetic batch of a ZOO entry from `seed`: images and labels."""
    rng = np.random.default_rng(seed)
    return {"img": rng.standard_normal((batch, 3, cfg["img"], cfg["img"]),
                                       dtype=np.float32),
            "label": rng.integers(0, cfg["classes"], (batch, 1))
            .astype(np.int64)}


def phase_train_zoo(pt, report):
    """bench.py's alexnet, googlenet and smallnet trained at their own
    widths and batches (ZOO), AMP O2, Momentum 0.9, one repeated synthetic
    batch, each through _graphed_training: graphed bitwise eager (dropout
    included), the losses falling, p50, busy share, K1/K2/K3 launches per
    eager step held to ZOO_LAUNCHES and the profiled replay's traced ones
    to the graph's nodes. -> launches by kernel counter counted over the
    phase's runs (wrappers, and the profiled replays' traces)."""
    import torch
    card = _card_line()
    total, out = {}, {}
    for i, (name, cfg) in enumerate(ZOO.items()):
        main, startup, loss = zoo_train_net(pt, cfg)
        want = path_launches(name, zoo_kernel_shapes(main, cfg["batch"])[0])
        feed = _zoo_feed(cfg, cfg["batch"], SEED + 30 + i)
        # the witness is K3, of the backward: the records a profiler
        # window loses are its first ones, the forward's
        with _kept_graphs():
            rec, _, _ = _graphed_training(
                pt, f"train_zoo {name}", main, startup, loss, feed,
                ZOO_BITWISE_STEPS, ZOO_TURNS, ZOO_WITNESS, card,
                (cfg["batch"], "img"), want=want)
        rec.update(batch=cfg["batch"], img=cfg["img"], lr=cfg["lr"])
        out[name] = rec
        for k, v in rec["launches"].items():
            total[k] = total.get(k, 0) + v
        del main, startup, loss
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    report["train_zoo"] = out
    return total


def phase_serve_zoo(pt, conv_cuda, report):
    """bench.py's alexnet_infer and googlenet_infer (AMP O2, is_test,
    softmax) served by ServingEngine through buckets ZOO_BUCKETS: each
    bucket's first replay bitwise its eager run; batch-16 requests
    (bench.py's INFER_BS) graphed against eager in turns (p50); the
    softmax rows finite and summing to 1; K1 launches of three replayed
    requests from their trace, the eligible convs a request. -> K1
    launches."""
    import torch
    from paddle_tpu_torch.serving import ServingEngine
    card = _card_line()
    out, k1 = {}, 0
    for i, name in enumerate(ZOO_SERVED):
        cfg = ZOO[name]
        main, startup, prob = zoo_infer_net(pt, cfg)
        scope = pt.Scope()
        pt.Executor().run(startup, scope=scope)
        engine = ServingEngine(main, ["img"], [prob], buckets=ZOO_BUCKETS,
                               scope=scope)
        eligible = len(_eligible_convs(conv_cuda, engine.program, 1))
        req = _zoo_feed(cfg, ZOO_INFER_BATCH, SEED + 40 + i)["img"]
        with _kept_graphs():
            warm_s, pool_gb = _warm_buckets(engine, "img", req,
                                            f"serve_zoo {name}")
        turns = _serve_in_turns(engine, "img", {ZOO_INFER_BATCH: req},
                                f"serve_zoo {name}")[ZOO_INFER_BATCH]
        got = engine.infer({"img": req})[0]
        sums = got.astype(np.float64).sum(axis=1)
        if got.shape != (ZOO_INFER_BATCH, cfg["classes"]) or \
                not np.isfinite(got).all() or np.abs(sums - 1).max() > 2e-2:
            raise RuntimeError(f"serve_zoo {name}: output {got.shape}, "
                               f"row sums {sums}")
        traced = _trace_replays(engine, "img", [req] * 3, {"K1": eligible},
                                f"serve_zoo {name}",
                                graph=_bucket_graph(engine, ZOO_INFER_BATCH))["K1"]
        k1 += traced
        out[name] = {"card": card, "batch": ZOO_INFER_BATCH,
                     "warm_s": warm_s, "graph_pool_gb": pool_gb,
                     "p50_ms": turns,
                     "img_per_s": ZOO_INFER_BATCH / (turns["graph"] / 1e3),
                     "eligible_convs": eligible, "k1_traced": traced}
        print(f"serve_zoo {name}: buckets {ZOO_BUCKETS} warmed and captured "
              f"({', '.join(f'{b}: {s:.2f} s' for b, s in warm_s.items())}), "
              f"first replays bitwise eager; batch {ZOO_INFER_BATCH} request "
              f"p50 graphed {turns['graph']:.2f} ms, eager "
              f"{turns['eager']:.2f} ms ({out[name]['img_per_s']:.0f} img/s); "
              f"K1 {traced} launches in 3 replays ({eligible} eligible convs "
              f"a request; {card})", flush=True)
        engine.close()
        del engine, scope, main
        torch.cuda.empty_cache()
    report["serve_zoo"] = out
    return k1


def _bucket_graph(engine, bucket):
    """The CUDA graph of `engine`'s bucket `bucket` (kept, _kept_graphs)."""
    graph, = [g.graph for k, g in engine._graphs.items() if k[0] == bucket]
    return graph


def _prior_count(main):
    """The priors the program's prior_box ops make, from their shapes."""
    block = main.global_block()
    total = 0
    for op in block.ops:
        if op.type == "prior_box":
            h, w, n, _ = block.desc.var(op.output("Boxes")[0]).shape
            total += h * w * n
    return total


def phase_train_ssd(pt, report):
    """The MobileNet-SSD (SSD, ssd_train_net) trained at 300x300, 21
    classes, batch 32, AMP O2, Momentum 0.9 at 1e-3, on one synthetic
    VOC-shaped batch (1..8 boxes an image, LoD feeds padded to 8) through
    _graphed_training: the whole step, matching, mining and loss included,
    one CUDA graph, bitwise its eager twin; K1-K6 launches per eager step
    held to ZOO_LAUNCHES["ssd"]. -> (launches by counter counted over the
    phase's runs, the trained scope, the inference program and its
    detections var)."""
    from paddle_tpu_torch import executor as E
    card = _card_line()
    main, startup, loss, boxes, det, out = ssd_programs(pt, SSD)
    want = path_launches("ssd", zoo_kernel_shapes(main, SSD["batch"])[0])
    feed, gt, _ = ssd_batch(np.random.default_rng(SEED + 50), pt.LoDTensor,
                            SSD["batch"], SSD)
    with _kept_graphs():
        rec, _, scope = _graphed_training(
            pt, "train_ssd", main, startup, loss, feed, SSD_STEPS_BITWISE,
            SSD_TURNS, ZOO_WITNESS, card, (SSD["batch"], "img"), want=want)
    rec.update(batch=SSD["batch"], priors=_prior_count(main),
               boxes_per_image=[len(b) for b in gt],
               padded_boxes=E._bucket_len(max(len(b) for b in gt)))
    print(f"train_ssd: {rec['priors']} priors over six maps; ground truths "
          f"padded to {rec['padded_boxes']} boxes; the gate's answer "
          f"{rec['gate']} (graphed); {rec['img_per_s']:.1f} img/s "
          f"({rec['card']})", flush=True)
    report["train_ssd"] = rec
    return rec["launches"], scope, det, out


def _rows_counts(rows):
    """Each image's detection count in padded multiclass_nms rows: the rows
    whose label is not the background's (0), which the op never keeps and
    whose rows past the count it zeroes."""
    return (rows[..., 0] != 0).sum(axis=-1)


def phase_serve_ssd(pt, conv_cuda, scope, det, out, report):
    """The SSD's inference program (ssd_detect_net: decode, softmax,
    multiclass_nms with nms_top_k 400, keep_top_k 200) with train_ssd's
    weights served by ServingEngine at batch 16 through buckets
    ZOO_BUCKETS: each bucket's first replay bitwise its eager run; batch-16
    requests graphed against eager in turns (p50); the rows and counts
    against an Executor run of the same program (its LoD counts); one
    replay and one eager request profiled for the launches a request
    takes (the NMS loop's iterations); then DetectionMAP over
    SSD_MAP_BATCHES batches on the host, and the detection_map op over the
    same batches on the card (eager, gate reason host_metric, one host
    read a batch, counted), the two held equal. -> K1 launches."""
    import torch
    from torch.autograd import DeviceType
    from paddle_tpu_torch import executor as E
    from paddle_tpu_torch.serving import ServingEngine
    card = _card_line()
    engine = ServingEngine(det, ["image"], [out], buckets=ZOO_BUCKETS,
                           scope=scope)
    eligible = len(_eligible_convs(conv_cuda, engine.program, 1))
    rng = np.random.default_rng(SEED + 60)
    batches = [ssd_batch(rng, pt.LoDTensor, SSD_SERVE_BATCH, SSD)
               for _ in range(SSD_MAP_BATCHES)]
    req = batches[0][0]["image"]
    with _kept_graphs():
        warm_s, pool_gb = _warm_buckets(engine, "image", req, "serve_ssd")
    turns = _serve_in_turns(engine, "image", {SSD_SERVE_BATCH: req},
                            "serve_ssd")[SSD_SERVE_BATCH]
    rows = engine.infer({"image": req})[0]
    counts = _rows_counts(rows)
    ref, = pt.Executor().run(det, feed={"image": req}, fetch_list=[out],
                             scope=scope, return_numpy=False)
    ref_counts = np.diff(ref.lod[0])
    if rows.shape != (SSD_SERVE_BATCH, 200, 6) or not np.isfinite(rows).all() \
            or not np.array_equal(counts, ref_counts) or not counts.any():
        raise RuntimeError(f"serve_ssd: rows {rows.shape}, counts {counts}, "
                           f"the executor's {ref_counts}")
    k1 = _trace_replays(engine, "image", [req] * 3, {"K1": eligible},
                        "serve_ssd",
                        graph=_bucket_graph(engine, SSD_SERVE_BATCH))["K1"]
    per_request = {}
    for mode, fn in (("graph", lambda: engine.infer({"image": req})),
                     ("eager", lambda: _eager_request(engine,
                                                      {"image": req}))):
        with _profiled() as prof:
            fn()
        per_request[mode] = sum(
            1 for e in prof.events()
            if e.device_type == DeviceType.CUDA and not _is_span(e))
    nms = next(op for op in engine.program.global_block().ops
               if op.type == "multiclass_nms")
    priors = _prior_count(det)
    iterations = min(priors, nms.attr("nms_top_k"))

    # mAP: the metric on the host, and the op on the card
    metric = pt.metrics.DetectionMAP(overlap_threshold=0.5)
    main_map = pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main_map, pt.Program()):
        d = pt.layers.data(name="det", shape=[6], dtype="float32",
                           lod_level=1)
        g = pt.layers.data(name="gt", shape=[6], dtype="float32",
                           lod_level=1)
        m_ap = pt.layers.detection.detection_map(d, g, overlap_threshold=0.5)
    exe = pt.Executor()
    E.COUNTERS.reset()
    op_maps = []
    for feed, boxes, labels in batches:
        dets = engine.infer({"image": feed["image"]})[0]
        cnt = _rows_counts(dets)
        gts = [np.concatenate([lb.astype(np.float32),
                               np.zeros_like(lb, np.float32), bx], 1)
               for bx, lb in zip(boxes, labels)]
        gmax = max(len(x) for x in gts)
        gpad = np.zeros((len(gts), gmax, 6), np.float32)
        for i, x in enumerate(gts):
            gpad[i, :len(x)] = x
        metric.update(dets, cnt, gpad, [len(x) for x in gts])
        doffs = np.concatenate([[0], np.cumsum(cnt)]).tolist()
        goffs = np.concatenate([[0], np.cumsum([len(x) for x in gts])]
                               ).tolist()
        flat = np.concatenate([dets[i, :cnt[i]] for i in range(len(cnt))])
        v, = exe.run(main_map, feed={
            "det": pt.LoDTensor(flat, [doffs]),
            "gt": pt.LoDTensor(np.concatenate(gts), [goffs])},
            fetch_list=[m_ap])
        from paddle_tpu_torch.ops.detection_ops import detection_map_np
        want = detection_map_np(dets, cnt, gpad, [len(x) for x in gts], 0.5,
                                True, "integral", 0)
        if float(np.asarray(v).ravel()[0]) != float(want):
            raise RuntimeError(f"serve_ssd: the detection_map op's mAP {v} "
                               f"is not the host's {want}")
        op_maps.append(float(np.asarray(v).ravel()[0]))
    syncs = dict(E.COUNTERS.host_syncs)
    if syncs != {"detection_map": len(batches)} or \
            E.COUNTERS.eager != {"host_metric": len(batches)}:
        raise RuntimeError(f"serve_ssd: host syncs {syncs}, eager steps "
                           f"{E.COUNTERS.eager}")
    acc_map = metric.eval()
    rec = {"card": card, "batch": SSD_SERVE_BATCH, "warm_s": warm_s,
           "graph_pool_gb": pool_gb, "p50_ms": turns,
           "img_per_s": SSD_SERVE_BATCH / (turns["graph"] / 1e3),
           "counts": counts.tolist(), "priors": priors,
           "nms_iterations": iterations,
           "launches_per_request": per_request, "k1_traced": k1,
           "eligible_convs": eligible, "batch_maps": op_maps,
           "accumulated_map": acc_map, "host_syncs": syncs}
    print(f"serve_ssd: buckets {ZOO_BUCKETS} warmed and captured, first "
          f"replays bitwise eager; batch {SSD_SERVE_BATCH} request p50 "
          f"graphed {turns['graph']:.2f} ms, eager {turns['eager']:.2f} ms; "
          f"detections per image {counts.tolist()} (the executor's LoD "
          f"counts the same); {priors} priors, the NMS loop {iterations} "
          f"iterations; kernel launches a request {per_request}; K1 {k1} "
          f"in 3 replays; mAP per batch (op on the card, eager under "
          f"host_metric) {op_maps}, DetectionMAP over {len(batches)} "
          f"batches {acc_map:.4f}; host syncs {syncs} ({card})", flush=True)
    report["serve_ssd"] = rec
    engine.close()
    return k1



def _zoo_shape_rows(conv_cuda, bn_cuda, tables, batch, held):
    """K1-K6 at each shape of `tables` (zoo_kernel_shapes') not in `held`
    yet, held and timed (a CUDA graph of 10 calls between events) by
    _conv_shape_rows and _bn_shape_row. -> rows by (kernel, shape key)."""
    import torch
    gen = torch.Generator().manual_seed(SEED + 70)

    def randn(shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(
            torch.bfloat16).cuda()
    time_ms = functools.partial(_device_ms, reps=10)
    rows = {}
    conv_keys = set()
    for k in ("K1", "K2", "K3", "K4"):
        conv_keys |= set(tables[k])
    for key in sorted(conv_keys):
        counts = {k: tables[k][key] for k in ("K1", "K2", "K3", "K4")
                  if key in tables[k] and (k, key) not in held}
        if counts:
            for k, row in _conv_shape_rows(conv_cuda, key, counts, randn,
                                           time_ms).items():
                rows[(k, key)] = row
    for kern, kind in (("K5", "bn_apply"), ("K6", "bn_act")):
        for key, n in sorted(tables[kern].items(), key=str):
            if (kern, key) not in held:
                rows[(kern, key)] = _bn_shape_row(bn_cuda, kind, key, n,
                                                  batch, randn, time_ms)
    torch.cuda.empty_cache()
    return rows


def phase_kernel_zoo(pt, conv_cuda, bn_cuda, report):
    """K1-K6 at every distinct shape the gates give them on train_zoo's
    and train_ssd's steps (AlexNet's and GoogLeNet's 5x5 filters,
    GoogLeNet's 16- and 24-channel reductions, the SSD's pointwise convs
    and their batch norms on 150x150 down to 1x1 maps), and K1 at each
    shape serve_zoo's and serve_ssd's bucket-16 requests give it (every
    conv that passes K1's gate, the SSD's folded conv -> bn windows
    included): each twice bitwise and held to its plain version, then
    timed (_zoo_shape_rows). Per path and kernel: its ms a step (the
    shapes' times by their launches), the plain version's, the library's
    and the bound."""
    import torch
    card = _card_line()
    paths = {name: zoo_train_net(pt, cfg)[0] for name, cfg in ZOO.items()}
    ssd = ssd_programs(pt, SSD)
    paths["ssd"] = ssd[0]
    batches = {name: cfg["batch"] for name, cfg in ZOO.items()}
    batches["ssd"] = SSD["batch"]
    for name in ZOO_SERVED:
        paths[f"{name}_infer"] = zoo_infer_net(pt, ZOO[name])[0]
        batches[f"{name}_infer"] = ZOO_INFER_BATCH
    paths["ssd_infer"], batches["ssd_infer"] = ssd[4], SSD_SERVE_BATCH
    held, per_path = {}, {}
    for name, main in paths.items():
        tables, refused = zoo_kernel_shapes(main, batches[name])
        if name.endswith("_infer"):
            # inference: K1 at every conv that passes its gate (a served
            # conv -> bn window folds the bn into the conv), nothing else
            k1 = {}
            for key in _eligible_convs(conv_cuda, main, batches[name]):
                k1[key] = k1.get(key, 0) + 1
            tables = {k: (k1 if k == "K1" else {}) for k in tables}
        held.update(_zoo_shape_rows(conv_cuda, bn_cuda, tables,
                                    batches[name], held))
        per_path[name] = {}
        for kern, table in tables.items():
            if not table:
                continue
            rs = [(held[(kern, key)], n) for key, n in table.items()]

            def total(field):
                vals = [r[field] for r, _ in rs]
                return None if None in vals else sum(
                    v * n for v, (_, n) in zip(vals, rs))
            worst = max(rs, key=lambda rn: rn[0]["ms"] / rn[0]["bound_ms"])[0]
            per_path[name][kern] = {
                "shapes": len(table), "launches": sum(table.values()),
                "ms": total("ms"), "plain_ms": total("plain_ms"),
                "library_ms": total("library_ms"),
                "bound_ms": total("bound_ms"),
                "max_abs_err": max(r["max_abs_err"] for r, _ in rs),
                "worst_shape": worst["shape"],
                "worst_ms": worst["ms"], "worst_bound_ms": worst["bound_ms"]}
            v = per_path[name][kern]
            print(f"kernel_zoo {name} {kern}: {v['launches']} launches a step "
                  f"at {v['shapes']} shapes, {v['ms']:.3f} ms (plain "
                  f"{v['plain_ms']:.3f}, library {v['library_ms']}, bound "
                  f"{v['bound_ms']:.3f}); farthest from its bound "
                  f"{v['worst_shape']} {v['worst_ms']:.4f} ms vs "
                  f"{v['worst_bound_ms']:.4f}; max abs err "
                  f"{v['max_abs_err']:.3g}; refused {refused} ({card})",
                  flush=True)
        torch.cuda.empty_cache()
    report["kernel_zoo"] = {"card": card, "paths": per_path,
                            "shapes": [dict(r, key=str(k))
                                       for k, r in held.items()]}
    print(f"kernel_zoo: {len(held)} (kernel, shape) pairs held twice bitwise "
          f"and against their plain versions ({card})", flush=True)
    return per_path


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


# --- the sharded runs (ROADMAP 9b-1): rank processes sharing the card --------
#
# The card's machine has one H100, so a process group's ranks are
# processes on that one card over gloo: each collective stages its tensors
# through pinned host memory (parallel/_collectives.py), and a sharded step
# runs eager under the gate's reason `host_collective`. These phases show
# the sharded run on the card, its kernels and its agreement with one rank;
# their times are processes sharing one card over host-staged gloo, not
# scaling numbers. The parent has built the kernels before it starts the
# ranks (their libraries load from build/kernels/; K5's Triton cache is
# shared). Each rank is this script run again with `--rank` (_rank_main).

PAR_TIMEOUT = 420                   # seconds for one group of rank processes
PAR_STEPS = 3
# bench.py's ResNet-50 in O2 transpiled over dp 2: the global batch of 64,
# TRAIN_BATCH a rank. Step 1 against the one-rank step on the same global
# batch, and beside one rank against itself on the batch's rows permuted
# (the same function summed in another order: the floor of the
# comparison). The loss within DP_LOSS_RTOL. Every batch norm's SavedMean
# and SavedVariance (the synchronized statistics: K4's sums or the stem
# window's all-reduced, then K5), as relative L2 against one rank's: the
# first DP_STATS_FIRST batch norms, whose inputs agree up to rounding,
# within DP_STATS_F32, f32 rounding; the median over all within
# DP_STATS_RTOL (bf16 differences grow with depth in O2: 1e-7 at the stem,
# 1e-2 at the last; statistics over one rank's half of the rows would be
# off by ~1e-2 at most of them); in f32 (no AMP) every one within
# DP_STATS_F32; every output Y, where fetched, within one bf16 ulp of its
# mean magnitude. The gradients' relative L2, median over the parameters,
# within DP_GRAD_FLOOR of the permuted floor's (one rank against itself
# differs by ~2e-2 in f32 and ~1 in O2: ResNet-50's backward at random
# init amplifies rounding), and in O2 the train phase's criteria (the last
# layer's within LAST_GRAD_RL2, every norm ratio within NORM_RATIO, their
# median within NORM_RATIO_MEDIAN of 1). tests/torch_parallel_phases.py
# runs the f32 form (--only train_dp_f32).
DP = {"net": "resnet50", "world": 2, "batch": 2 * TRAIN_BATCH,
      "img": 224, "classes": 1000, "device": "cuda", "amp": "O2"}
DP_LOSS_RTOL = 2e-3
DP_STATS_FIRST, DP_STATS_F32, DP_STATS_RTOL = 2, 1e-5, 2e-3
DP_GRAD_FLOOR = 1.25
# the LM at LM's widths in f32, planned over (fsdp 2, tp 2) on 4 ranks,
# against the one-rank LM under the same plan (a one-rank mesh: its table
# row-sharded too, so both take the lazy sparse Adam) within
# LM_F32_LOSS_RTOL
PLANNED_LM = {"lm": dict(LM), "world": 4,
              "mesh": ((2, 2), ("fsdp", "tp")), "device": "cuda"}
# bench.py's DLRM with its table row-sharded over fsdp 2 and the batch
# split over it, against the one-rank DLRM (its table sharded over a
# one-rank mesh): the table after PAR_STEPS within a relative L2 of
# DLRM_SHARDED_RTOL (the tower's gradients are summed in another order, and
# Adam's normalized update passes that on to rows with small gradients:
# the largest difference, 1.5e-6 of the largest |value| in the CPU
# rehearsal at 1000 rows, is reported beside it)
DLRM_SHARDED = {"rows": DLRM["rows"], "world": 2, "device": "cuda"}
DLRM_SHARDED_RTOL = 1e-6
# the kernels each sharded path must launch on every rank, by counter
DP_KERNELS = ("conv.dgrad_launches", "conv.wgrad_launches",
              "conv.stats_launches", "bn.apply_launches")
LM_KERNELS = ("attn.f32_launches", "attn.f32_dq_launches",
              "attn.f32_dkv_launches")


def lm_stage_cuts(main, n_layer):
    """The cut variables that split transformer_lm's program into one
    pipeline stage a layer: the residual stream after each layer's FFN
    residual add but the last. The stream is followed from the embedding's
    `pos_emb` add through the adds that read it (attention then FFN, each
    layer). Takes either package's program."""
    block = main.global_block()
    adds = [op for op in block.ops if op.type == "elementwise_add"]
    x = next(op for op in adds if "pos_emb" in op.desc.input("Y")) \
        .desc.output("Out")[0]
    chain = []
    while True:
        nxt = [op for op in adds if op.desc.input("X") == [x]]
        if not nxt:
            break
        x = nxt[0].desc.output("Out")[0]
        chain.append(x)
    if len(chain) != 2 * n_layer:
        raise ValueError(f"{len(chain)} residual adds for {n_layer} layers")
    return [block.var(n) for n in chain[1::2][:n_layer - 1]]


def _par_dir(phase):
    import shutil
    d = Path(__file__).resolve().parent / "build" / "parallel_smoke" / phase
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    return d


def _par_launch(phase, world, payload, backend="gloo", timeout=PAR_TIMEOUT):
    """Run `phase`'s rank function on `world` fresh processes of this
    script in a `backend` group (a file store under build/), through
    `parallel.multihost.launch_local`: every process is gone after,
    whatever happened, and a rank that exits non-zero or a group that
    outlives `timeout` fails the phase. -> each rank's result."""
    import torch
    from paddle_tpu_torch.parallel import multihost
    d = _par_dir(phase)
    torch.save(payload, d / "payload.pt")
    script = Path(__file__).resolve()
    tails = multihost.launch_local(
        lambda r: [sys.executable, script, "--rank", r, "--world", world,
                   "--phase", phase, "--dir", d, "--backend", backend],
        world, d, timeout, env=dict(os.environ, OMP_NUM_THREADS="2"),
        tail=3000)
    bad = [f"rank {r} of {world} exited {rc}:\n{tail}"
           for r, (rc, tail) in enumerate(tails) if rc != 0]
    if bad:
        raise RuntimeError(f"{phase}: " + "\n".join(bad))
    return [torch.load(d / f"out{r}.pt", weights_only=False)
            for r in range(world)]


def _rank_main(args) -> int:
    """One rank of a sharded phase: join the group, run the phase's rank
    function on its payload, write its result."""
    import datetime
    import torch
    import torch.distributed as dist
    d = Path(args.dir)
    dist.init_process_group(args.backend, init_method=f"file://{d}/store",
                            rank=args.rank, world_size=args.world,
                            timeout=datetime.timedelta(seconds=PAR_TIMEOUT))
    try:
        import paddle_tpu_torch as pt
        payload = torch.load(d / "payload.pt", weights_only=False)
        if payload["device"] == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        res = RANK_PHASES[args.phase](pt, payload, args.rank, args.world)
        torch.save(res, d / f"out{args.rank}.pt")
        # no rank tears its connections down while a peer still talks
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def _par_net(pt, payload):
    """(main, startup, loss) of a sharded phase's program."""
    kind = payload["net"]
    if kind == "resnet50":
        c = payload
        main, startup = pt.Program(), pt.Program()
        with pt.unique_name.guard(), pt.program_guard(main, startup):
            img = pt.layers.data(name="img", shape=[3, c["img"], c["img"]],
                                 dtype="float32")
            label = pt.layers.data(name="label", shape=[1], dtype="int64")
            model = pt.models.resnet.resnet50 if c.get("depth", 50) == 50 \
                else functools.partial(pt.models.resnet.resnet_cifar10,
                                       depth=c["depth"])
            loss, _, _ = pt.models.build_image_classifier(
                model, img, label, class_dim=c["classes"])
            opt = pt.optimizer.Momentum(learning_rate=TRAIN_LR, momentum=0.9)
            if c.get("amp", "O2"):
                opt = pt.amp.decorate(opt, level=c.get("amp", "O2"))
            opt.minimize(loss)
        main.random_seed = startup.random_seed = SEED + 1
        return main, startup, loss
    if kind == "lm":
        c = payload["lm"]
        main, startup = pt.Program(), pt.Program()
        with pt.unique_name.guard(), pt.program_guard(main, startup):
            tok = pt.layers.data(name="tok", shape=[-1, c["seqlen"]],
                                 dtype="int64", append_batch_size=False)
            lab = pt.layers.data(name="lab", shape=[-1, c["seqlen"]],
                                 dtype="int64", append_batch_size=False)
            loss = pt.models.transformer_lm(
                tok, lab, vocab_size=c["vocab"], d_model=c["d_model"],
                n_head=c["n_head"], n_layer=c["n_layer"])
            pt.optimizer.Adam(learning_rate=c["lr"]).minimize(loss)
        main.random_seed = startup.random_seed = SEED + 1
        return main, startup, loss
    if kind == "dlrm":
        return _dlrm_train(pt, payload["rows"], sharded=False)
    raise ValueError(kind)


def _par_shard(pt, main, payload, mesh):
    """The phase's sharding of `main` on `mesh`."""
    how = payload["shard"]
    if how == "transpile":
        pt.DistributeTranspiler().transpile(trainer_id=mesh.rank,
                                            program=main,
                                            trainers=mesh.size, mesh=mesh)
    elif how == "plan":
        pt.parallel.planner.plan(main, mesh)
    elif how == "table":
        main._mesh = mesh
        pt.parallel.shard_table(main, "emb_table", "fsdp")
        for n in ("ids", "label"):
            pt.parallel.shard_feed(main, n, ("fsdp", None))
    return main


def _par_place(pt, payload):
    return pt.CUDAPlace(0) if payload["device"] == "cuda" else pt.CPUPlace()


def _par_counts():
    from paddle_tpu_torch.ops import (attention_cuda, bn_cuda, conv_cuda,
                                      sparse_cuda)
    c = _graph_counts(conv_cuda, bn_cuda, attention_cuda)
    c["s1.launches"] = sparse_cuda.COUNTERS.total
    return c


def _par_reset():
    from paddle_tpu_torch import executor as E
    from paddle_tpu_torch.ops import (attention_cuda, bn_cuda, conv_cuda,
                                      sparse_cuda)
    from paddle_tpu_torch.parallel import _collectives, spmd
    for c in (conv_cuda.COUNTERS, bn_cuda.COUNTERS, attention_cuda.COUNTERS,
              sparse_cuda.COUNTERS, spmd.COUNTERS, _collectives.COUNTERS,
              E.COUNTERS):
        c.reset()


def _digests(scope, names):
    import hashlib
    import torch
    out = {}
    for n in names:
        v = scope.find_var(n)
        if isinstance(v, torch.Tensor):
            t = v.detach().contiguous()
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
            out[n] = hashlib.sha1(t.cpu().numpy().tobytes()).hexdigest()
    return out


def _par_steps(pt, main, loss, exe, scope, feeds, grads=(), use_jit=None,
               digest=()):
    """Run the steps of `feeds`: per step the loss, the seconds (the card
    synchronized), the kernel launches counted by the wrappers, the
    sharded run's buckets and staged bytes, the gate's eager reasons and
    the digests of `digest`'s tensors after it; step 1 also fetches
    `grads`. -> list of per-step records."""
    import torch
    from paddle_tpu_torch import executor as E
    from paddle_tpu_torch.ops import bn_cuda
    from paddle_tpu_torch.parallel import _collectives, spmd
    sync = torch.cuda.synchronize if exe.device.type == "cuda" \
        else (lambda: None)
    out = []
    for i, f in enumerate(feeds):
        _par_reset()
        fetch = [loss] + (list(grads) if i == 0 else [])
        sync()
        t0 = time.perf_counter()
        vals = exe.run(main, feed=f, fetch_list=fetch, scope=scope,
                       use_jit=use_jit)
        sync()
        rec = {"loss": float(np.ravel(vals[0])[0]),
               "s": time.perf_counter() - t0,
               "launches": {k: v for k, v in _par_counts().items()
                            if v and k.endswith("launches")},
               "coll_s": dict(_collectives.COUNTERS.seconds),
               "buckets": spmd.COUNTERS.buckets,
               "gathers": sum(spmd.COUNTERS.gathers.values()),
               "staged_bytes": _collectives.COUNTERS.staged_bytes,
               "staged": dict(_collectives.COUNTERS.host_staged),
               "eager": dict(E.COUNTERS.eager),
               "bn_fallbacks": {f"{o}:{r}": n for (o, r), n in
                                bn_cuda.COUNTERS.fallbacks.items()},
               "bn_hits": dict(bn_cuda.COUNTERS.hits),
               "bn_split": dict(bn_cuda.COUNTERS.split_launches),
               "digests": _digests(scope, digest)}
        if i == 0 and grads:
            rec["grads"] = {g: np.asarray(v, np.float32)
                            for g, v in zip(grads, vals[1:])}
        out.append(rec)
    return out


def _rank_train(pt, payload, rank, world):
    """A sharded phase's rank: the program sharded on the phase's mesh (on
    the card, over this process group), the whole initial state loaded,
    the steps run on the global batches. -> the steps' records, the bytes
    the rank holds against per_shard_param_bytes, the plan when planned,
    and the state named in payload['keep'] whole."""
    import torch
    from paddle_tpu_torch.parallel import spmd
    main, _startup, loss = _par_net(pt, payload)
    dev = "cuda" if payload["device"] == "cuda" else "cpu"
    mesh = pt.parallel.make_mesh(*payload["mesh"], device=dev)
    _par_shard(pt, main, payload, mesh)
    exe = pt.Executor(_par_place(pt, payload))
    scope = _par_scope(pt, payload["init"], exe.device)
    st = spmd.for_program(main)
    replicated = [n for n in payload["init"] if n not in st.specs]
    steps = _par_steps(pt, main, loss, exe, scope, payload["feeds"],
                       payload.get("grads", ()), digest=replicated)
    params = [p.name for p in main.global_block().all_parameters()]
    held = sum(scope.find_var(n).numel() * scope.find_var(n).element_size()
               for n in params if isinstance(scope.find_var(n), torch.Tensor))
    psb = pt.parallel.per_shard_param_bytes(main, scope)
    plan = getattr(main, "_sharding_plan", None)
    whole = spmd.gather_state(main, scope)
    keep = {n: (whole[n] if n in whole else scope.find_var(n)).cpu()
            for n in payload.get("keep", ())}
    return {"steps": steps, "held_bytes": int(held),
            "per_shard_bytes": psb["per_device_bytes"],
            "by_axes": psb["by_axes"],
            "plan": None if plan is None else plan.to_dict(),
            "validate": None if plan is None else
            len(pt.parallel.validate_plan_bytes(main, scope)),
            "sharded": sorted(st.specs), "keep": keep,
            "shard_shapes": {n: tuple(scope.find_var(n).shape)
                             for n in sorted(st.specs)
                             if scope.find_var(n) is not None}}


def _rank_dp_nccl(pt, payload, rank, world):
    """train_dp_nccl's one rank: the ResNet-50 O2 step graphed (warm-up,
    capture, replays) with no group and, on another scope from the same
    state, transpiled over this one-rank NCCL group, whose bucket
    all-reduces are posted under the step's capture; the two bitwise, step
    by step; the collectives posted at each step; a profiled replay of the
    grouped graph and the kernels it ran."""
    import torch
    from paddle_tpu_torch import executor as E
    from paddle_tpu_torch.parallel import _collectives
    plain, _s, loss_a = _par_net(pt, payload)
    grouped, _s, loss_b = _par_net(pt, payload)
    mesh = pt.parallel.make_mesh((1,), ("dp",))
    pt.DistributeTranspiler().transpile(program=grouped, trainers=1,
                                        mesh=mesh)
    exe = pt.Executor(pt.CUDAPlace(0))
    scopes = [_par_scope(pt, payload["init"], exe.device) for _ in range(2)]
    res = {"gate": exe.graph_gate(grouped, {k: torch.from_numpy(v)
                                            for k, v in
                                            payload["feeds"][0].items()})}
    E.COUNTERS.reset()
    calls, by_step = {}, []
    losses, diverged = [], []
    for f in payload["feeds"]:
        la, = exe.run(plain, feed=f, fetch_list=[loss_a], scope=scopes[0])
        _collectives.COUNTERS.reset()
        lb, = exe.run(grouped, feed=f, fetch_list=[loss_b], scope=scopes[1])
        by_step.append(sum(_collectives.COUNTERS.calls.values()))
        for k, v in _collectives.COUNTERS.calls.items():
            calls[k] = calls.get(k, 0) + v
        losses.append((float(np.ravel(la)[0]), float(np.ravel(lb)[0])))
        if not np.array_equal(la, lb):
            diverged.append("loss")
        diverged += _bitwise_scopes(scopes[1], scopes[0])
    res.update(losses=losses, diverged=diverged,
               captures=E.COUNTERS.captures, replays=E.COUNTERS.replays,
               calls=calls, calls_by_step=by_step)
    traced = []
    for prog, loss, scope in ((plain, loss_a, scopes[0]),
                              (grouped, loss_b, scopes[1])):
        kernels = {}
        with _profiled() as prof:
            exe.run(prog, feed=payload["feeds"][-1], fetch_list=[loss],
                    scope=scope)
        for e in prof.events():
            if e.device_type.name == "CUDA":
                kernels[e.name] = kernels.get(e.name, 0) + 1
        traced.append(kernels)
    res["nccl_kernels"] = {k: v for k, v in traced[1].items()
                           if "nccl" in k.lower()}
    res["kernels_traced"] = [sum(k.values()) for k in traced]
    # what the grouped replay ran that the plain one did not
    res["added"] = {k: v - traced[0].get(k, 0) for k, v in traced[1].items()
                    if v != traced[0].get(k, 0)}
    return res


RANK_PHASES = {"train_dp": _rank_train, "train_planned_lm": _rank_train,
               "train_dlrm_sharded": _rank_train,
               "train_dp_nccl": _rank_dp_nccl}



def _par_init(pt, main, startup, place):
    """The startup's state on the CPU, to hand to every rank whole."""
    import torch
    exe = pt.Executor(place)
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    return {n: v.detach().cpu() for n, v in scope.vars.items()
            if isinstance(v, torch.Tensor)}


def _par_scope(pt, init, device):
    """A scope holding copies of `init` on `device` (sparse applies update
    their tables in place)."""
    scope = pt.Scope()
    for n, t in init.items():
        scope.set_var(n, t.to(device, copy=True))
    return scope


def _free_card():
    import gc
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _dp_feeds(cfg, steps):
    rng = np.random.default_rng(SEED + 70)
    return [{"img": rng.standard_normal(
        (cfg["batch"], 3, cfg["img"], cfg["img"])).astype(np.float32),
        "label": rng.integers(0, cfg["classes"], (cfg["batch"], 1))
        .astype(np.int64)} for _ in range(steps)]


def _rel_l2(a, b):
    return float(np.linalg.norm((a - b).ravel())
                 / max(np.linalg.norm(b.ravel()), 1e-30))


def _bn_fetches(main, outputs=False):
    """The names of every training batch norm's SavedMean and
    SavedVariance in `main` (and its output Y with `outputs`)."""
    slots = ("SavedMean", "SavedVariance") + (("Y",) if outputs else ())
    return [op.desc.output(slot)[0] for op in main.global_block().ops
            if op.type == "batch_norm" and not op.attr("is_test", False)
            for slot in slots]


def _bn_split_row(bn_cuda, key, n, randn, time_ms):
    """K6's split form on one rank at one [M, C] and act `key`: the
    statistics launch twice bitwise and bit for bit bn_act_sums_in_order's
    at its plan; the normalize launch from those sums over M rows twice
    bitwise, its outputs and statistics bit for bit K6's (whole) on the
    same x, ybn within one bf16 ulp of the plain apply; then the two
    launches timed together beside the window they replace (plain channel
    sums, the moments and K5), K6 whole, F.batch_norm and the bound (x read
    once, the outputs written once). Prints and returns the row."""
    import torch
    import torch.nn.functional as F
    m, c, act = key
    x = randn((m, c), 2.0)
    scale, bias, _, _ = _bn_operands(m, c)
    shape = f"[{m}, {c}] act={act}"
    sums = _twice(lambda: (bn_cuda.bn_act_sums(x),))[0]
    if not torch.equal(sums, bn_cuda.bn_act_sums_in_order(
            x, *bn_cuda.launch_plan(x, None))):
        raise RuntimeError(f"K6's statistics launch at {shape} is not its "
                           f"summation order's bit for bit")
    ybn, yact, mean, var = _twice(lambda: bn_cuda.bn_act_apply(
        x, sums, m, scale, bias, 1e-5, act))
    wbn, wact, wmean, wvar = bn_cuda.bn_act(x, scale, bias, 1e-5, act)
    same = [torch.equal(a, b) for a, b in ((ybn, wbn), (mean, wmean),
                                           (var, wvar))]
    if act is not None:
        same.append(torch.equal(yact, wact))
    if not all(same):
        raise RuntimeError(f"K6's split form at {shape} on one rank is not "
                           f"K6's bits: {same}")
    want, _ = bn_cuda.bn_apply_reference(x, scale, bias, mean, var, 1e-5)
    err = _bf16_err(ybn, want)
    del want, wbn, wact

    def old():
        xf = x.float()
        mu, v = bn_cuda.one_pass_moments(xf.sum(0), (xf * xf).sum(0), m)
        return bn_cuda.bn_apply(x, scale, bias, mu, v, 1e-5, act)
    split = lambda: bn_cuda.bn_act_apply(  # noqa: E731
        x, bn_cuda.bn_act_sums(x), m, scale, bias, 1e-5, act)
    x4 = x.reshape(TRAIN_BATCH, -1, c).permute(0, 2, 1).unsqueeze(-1)
    out_bytes = m * c * 2 * (2 if act else 1)
    row = _row("bn_act_split", shape, n, time_ms(split), time_ms(old),
               time_ms(lambda: F.batch_norm(x4, None, None, scale, bias,
                                            True, 0.0, 1e-5)),
               (7 if act else 6) * m * c, m * c * 2 + 16 * c + out_bytes,
               err, PEAK_F32_FLOPS)
    row["whole_ms"] = time_ms(lambda: bn_cuda.bn_act(x, scale, bias, 1e-5,
                                                     act))
    row["two_pass_floor_ms"] = (row["bytes"] + m * c * 2) / PEAK_BYTES * 1e3
    print(f"bn_act split {shape} x{n}/step: {row['ms']:.4f} ms (statistics "
          f"and normalize launches), the window it replaces (plain sums + "
          f"K5) {row['plain_ms']:.4f} ms, K6 whole {row['whole_ms']:.4f} ms, "
          f"F.batch_norm {row['library_ms']:.4f} ms, bound "
          f"{row['bound_ms']:.4f} ms (two-pass floor "
          f"{row['two_pass_floor_ms']:.4f})", flush=True)
    return row


def phase_kernel_bn_split(pt, bn_cuda, report):
    """K6's split form (a batch split over ranks: train_dp's windows) at
    every K6 shape of a ResNet-50 training step at TRAIN_BATCH, the batch
    of one train_dp rank (_bn_split_row). -> the split form's totals a
    step, for the K6 entry of the kernels line."""
    import torch
    gen = torch.Generator().manual_seed(SEED + 87)

    def randn(shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale) \
            .to(torch.bfloat16).cuda()
    main = _resnet50_train(pt, pt.models.resnet)[0]
    acts = zoo_kernel_shapes(main, TRAIN_BATCH)[0]["K6"]
    rows = [_bn_split_row(bn_cuda, key, n, randn, _device_ms)
            for key, n in acts.items()]
    torch.cuda.empty_cache()
    report["bn_split_shapes"] = rows

    def total(key):
        return sum(r[key] * r["per_step"] for r in rows)
    out = {"ms": total("ms"), "window_before_ms": total("plain_ms"),
           "whole_ms": total("whole_ms"), "library_ms": total("library_ms"),
           "bound_ms": total("bound_ms"), "bound_by": "bytes",
           "two_pass_floor_ms": total("two_pass_floor_ms"),
           "max_abs_err": max(r["max_abs_err"] for r in rows),
           "shapes": [r["shape"] for r in rows],
           "per": f"one batch-{TRAIN_BATCH} ResNet-50 step of a train_dp "
                  f"rank"}
    print(f"bn_act split form: {out['ms']:.3f} ms per train_dp rank step "
          f"over {len(rows)} shapes, the window before (plain sums + K5) "
          f"{out['window_before_ms']:.3f}, K6 whole "
          f"{out['whole_ms']:.3f}, bound {out['bound_ms']:.3f} (bytes)",
          flush=True)
    return out


def phase_train_dp(pt, report, cfg=None):
    """bench.py's ResNet-50 in O2 at full width transpiled over dp 2 (two
    rank processes on the card, gloo, host-staged), the global batch of 64
    (TRAIN_BATCH a rank), PAR_STEPS steps from one startup state: step 1's
    loss, batch-norm statistics and gradients against one rank's step on
    the same global batch (DP above), the replicated state bitwise equal
    across ranks after every step, the losses equal across ranks, K2-K5
    launched on every rank and K6's split form (its statistics launch, the
    sums all-reduced, its normalize launch) on the stem's window, which
    counts one K6 hit and no fallback, the buckets posted and the bytes
    staged, each step eager under
    `host_collective`; the ranks' step p50 beside the one-rank step's
    (eager). cfg "outputs" also holds every batch norm's output Y (mean
    |difference| over mean |Y| within one bf16 ulp, 2^-8); cfg "amp" None
    runs it in f32. The record is written to `report` before any failure
    raises. -> launches by counter summed over the ranks' steps."""
    cfg = dict(DP if cfg is None else cfg)
    card = _card_line() if cfg["device"] == "cuda" else "cpu"
    o2 = bool(cfg.get("amp", "O2"))
    payload = dict(cfg, mesh=((cfg["world"],), ("dp",)), shard="transpile")
    main, startup, loss = _par_net(pt, payload)
    place = _par_place(pt, payload)
    init = _par_init(pt, main, startup, place)
    feeds = _dp_feeds(cfg, PAR_STEPS)
    params = sorted(p.name for p in main.global_block().all_parameters()
                    if p.trainable)
    grads = [p + "@GRAD" for p in params]
    stats = _bn_fetches(main, cfg.get("outputs", False))
    exe = pt.Executor(place)
    ref = _par_steps(pt, main, loss, exe, _par_scope(pt, init, exe.device),
                     feeds, grads + stats, use_jit=False)
    # the chaos floor: step 1 on the global batch's rows permuted
    perm = np.random.default_rng(SEED + 72).permutation(cfg["batch"])
    floor = _par_steps(pt, main, loss, exe, _par_scope(pt, init, exe.device),
                       [{k: v[perm] for k, v in feeds[0].items()}], grads,
                       use_jit=False)[0]
    del exe
    _free_card()
    payload.update(init=init, feeds=feeds, grads=grads + stats)
    ranks = _par_launch("train_dp", cfg["world"], payload)
    fails = []
    r0 = ranks[0]["steps"]
    for r, res in enumerate(ranks):
        steps = res["steps"]
        if [s["loss"] for s in steps] != [s["loss"] for s in r0]:
            fails.append(f"rank {r}'s losses differ from rank 0's")
        for i, (s, s0) in enumerate(zip(steps, r0)):
            if s["digests"] != s0["digests"]:
                bad = [n for n in s0["digests"]
                       if s["digests"].get(n) != s0["digests"][n]]
                fails.append(f"rank {r} step {i + 1}: replicated state "
                             f"differs from rank 0's: {bad[:6]}")
            missing = [k for k in DP_KERNELS if not s["launches"].get(k)]
            if missing and cfg["device"] == "cuda" and o2:
                fails.append(f"rank {r} step {i + 1}: {missing} not launched")
            if cfg["device"] == "cuda" and o2 and (
                    not s["bn_split"].get("sums")
                    or s["bn_split"].get("sums") != s["bn_split"].get(
                        "apply")):
                fails.append(f"rank {r} step {i + 1}: K6's split form not "
                             f"launched in pairs: {s['bn_split']}")
            if s["bn_fallbacks"].get("fused_bn_act:batch_split"):
                fails.append(f"rank {r} step {i + 1}: a K6 window taken as "
                             f"batch_split: {s['bn_fallbacks']}")
            if not s["buckets"]:
                fails.append(f"rank {r} step {i + 1}: no bucket posted")
            if cfg["device"] == "cuda" and (
                    not s["staged_bytes"]
                    or s["eager"] != {"host_collective": 1}):
                fails.append(f"rank {r} step {i + 1}: staged "
                             f"{s['staged_bytes']} B, eager {s['eager']}")
    loss_rel = abs(r0[0]["loss"] - ref[0]["loss"]) / abs(ref[0]["loss"])
    if loss_rel > DP_LOSS_RTOL:
        fails.append(f"step 1 loss {r0[0]['loss']} against one rank's "
                     f"{ref[0]['loss']}")
    got, want = r0[0]["grads"], ref[0]["grads"]
    saved = _bn_fetches(main)
    ys = [n for n in stats if n not in set(saved)]
    stat_rel = {n: _rel_l2(got[n], want[n]) for n in saved}
    for n in ys:
        stat_rel[n] = float(np.abs(got[n] - want[n]).mean()
                            / max(np.abs(want[n]).mean(), 1e-30))
    per_bn = len(stats) // (len(saved) // 2)    # 2, or 3 with Y
    first = stats[:DP_STATS_FIRST * per_bn]
    first_max = max(stat_rel[n] for n in first)
    stats_med = float(np.median([stat_rel[n] for n in saved]))
    worst = max(saved, key=stat_rel.get)
    if first_max > DP_STATS_F32:
        fails.append(f"the first {DP_STATS_FIRST} batch norms against one "
                     f"rank's: {[(n, stat_rel[n]) for n in first]}")
    if stats_med > DP_STATS_RTOL or (not o2 and
                                     stat_rel[worst] > DP_STATS_F32):
        fails.append(f"batch-norm statistics against one rank's: median "
                     f"{stats_med:.3e}, {worst} {stat_rel[worst]:.3e}")
    ys_max = max((stat_rel[n] for n in ys), default=None)
    if ys and ys_max > 2.0 ** -8:
        fails.append(f"batch-norm outputs against one rank's: "
                     f"{max(ys, key=stat_rel.get)} {ys_max:.3e}")
    rl2, ratios, floor_rl2 = {}, {}, {}
    for g in grads:
        a, b = got[g], want[g]
        rl2[g] = _rel_l2(a, b)
        floor_rl2[g] = _rel_l2(floor["grads"][g], b)
        ratios[g] = float(np.linalg.norm(a) / max(np.linalg.norm(b), 1e-30))
    fc = [g for g in grads if g.startswith("fc_")]
    med_ratio = float(np.median(list(ratios.values())))
    rl2_med = float(np.median(list(rl2.values())))
    floor_med = float(np.median(list(floor_rl2.values())))
    floor_ratio = rl2_med / max(floor_med, 1e-30)
    if rl2_med > DP_GRAD_FLOOR * floor_med + 1e-6:
        fails.append(f"grads rel L2 median {floor_ratio:.3f}x the permuted "
                     f"floor's")
    if o2:
        if any(rl2[g] > LAST_GRAD_RL2 for g in fc):
            fails.append(f"last layer grads {[(g, rl2[g]) for g in fc]}")
        off = [g for g, v in ratios.items()
               if not 1 / NORM_RATIO <= v <= NORM_RATIO]
        if off or abs(med_ratio - 1) > NORM_RATIO_MEDIAN:
            fails.append(f"grad norm ratios off {off[:6]}, median "
                         f"{med_ratio}")
    p50 = float(np.median([s["s"] for res in ranks
                           for s in res["steps"][1:]])) * 1e3
    ref_p50 = float(np.median([s["s"] for s in ref[1:]])) * 1e3
    totals = {}
    for res in ranks:
        for s in res["steps"]:
            for k, v in s["launches"].items():
                totals[k] = totals.get(k, 0) + v
    coll = {k: round(float(np.median([s["coll_s"].get(k, 0.0)
                                      for s in r0[1:]])), 4)
            for k in r0[-1]["coll_s"]}
    rec = {"card": card, "world": cfg["world"], "global_batch": cfg["batch"],
           "amp": cfg.get("amp", "O2"), "coll_s_p50": coll,
           "losses": [s["loss"] for s in r0],
           "one_rank_losses": [s["loss"] for s in ref],
           "step1_loss_rel": loss_rel,
           "permuted_loss_rel": abs(floor["loss"] - ref[0]["loss"])
           / abs(ref[0]["loss"]),
           "bn_first_rel_max": first_max,
           "bn_stats_rel_max": stat_rel[worst], "bn_stats_worst": worst,
           "bn_stats_rel_median": stats_med, "bn_outputs_rel_max": ys_max,
           "bn_rel_in_order": [[n, stat_rel[n]] for n in stats],
           "grad_rel_l2_median": float(np.median(list(rl2.values()))),
           "grad_rel_l2_max": max(rl2.values()),
           "grad_rel_l2_worst": max(rl2, key=rl2.get),
           "permuted_grad_rel_l2_median": float(np.median(
               list(floor_rl2.values()))),
           "permuted_grad_rel_l2_max": max(floor_rl2.values()),
           "grad_floor_ratio": floor_ratio,
           "grad_rel_l2_by_name": {g: [rl2[g], floor_rl2[g]] for g in grads},
           "grad_norm_ratio_median": med_ratio,
           "launches_per_rank_step": r0[0]["launches"],
           "bn_fallbacks_per_rank_step": r0[0]["bn_fallbacks"],
           "bn_hits_per_rank_step": r0[0]["bn_hits"],
           "k6_split_per_rank_step": r0[0]["bn_split"],
           "one_rank_launches": ref[0]["launches"],
           "buckets_per_step": r0[0]["buckets"],
           "staged_bytes_per_step": r0[0]["staged_bytes"],
           "staged_per_step": r0[0]["staged"],
           "step_p50_ms": p50, "one_rank_step_p50_ms": ref_p50,
           "launches": totals, "fails": fails}
    report["train_dp" if o2 else "train_dp_f32"] = rec
    print(f"train_dp ({card}): ResNet-50 {rec['amp'] or 'f32'} over dp "
          f"{cfg['world']} (rank processes sharing the card, gloo, "
          f"host-staged), global batch {cfg['batch']}: losses "
          f"{rec['losses']} (one rank {rec['one_rank_losses']}), step-1 "
          f"loss rel {loss_rel:.2e} (one rank on the rows permuted "
          f"{rec['permuted_loss_rel']:.2e}); {len(saved)} batch-norm "
          f"statistics rel L2: the first {DP_STATS_FIRST} batch norms' "
          f"max {first_max:.2e}, median {stats_med:.2e}, max "
          f"{stat_rel[worst]:.2e} ({worst}); outputs max {ys_max}; "
          f"grads rel L2 median "
          f"{rec['grad_rel_l2_median']:.3e} max {rec['grad_rel_l2_max']:.3e}"
          f" (one rank on the rows permuted: median "
          f"{rec['permuted_grad_rel_l2_median']:.3e} max "
          f"{rec['permuted_grad_rel_l2_max']:.3e}; {floor_ratio:.3f}x), "
          f"norm ratio median "
          f"{med_ratio:.4f}; replicated state bitwise across ranks after "
          f"every step; a rank's step launches {r0[0]['launches']}, K6's "
          f"split form {r0[0]['bn_split']}, batch-norm windows' hits "
          f"{r0[0]['bn_hits']} and fallbacks {r0[0]['bn_fallbacks']}, "
          f"{r0[0]['buckets']} buckets, "
          f"{r0[0]['staged_bytes'] / 1e6:.1f} MB staged, the host's seconds "
          f"in collectives {coll}; step p50 {p50:.1f} ms a rank (eager, "
          f"host_collective) beside one rank's {ref_p50:.1f} ms at the "
          f"global batch (eager)", flush=True)
    if fails:
        raise RuntimeError("train_dp: " + "; ".join(fails[:10]))
    return totals


def phase_train_dp_nccl(pt, report, cfg=None):
    """An NCCL group of one rank on the card (one rank process): the
    ResNet-50 O2 step of train_dp at TRAIN_BATCH transpiled over it runs
    graphed, its bucket all-reduces posted under the step's capture and
    none from the host on a replay, bitwise the graphed step with no
    group, step by step (the losses and every scope tensor); the kernels
    of a profiled replay, NCCL's named. A one-rank all-reduce in place
    moves nothing, so the replay cannot show it ran; that NCCL collectives
    the port posts under capture replay as graph nodes is shown by an
    out-of-place one (tests/test_torch_parallel_gpu.py)."""
    cfg = dict(DP if cfg is None else cfg, batch=TRAIN_BATCH)
    card = _card_line()
    payload = dict(cfg)
    main, startup, _loss = _par_net(pt, payload)
    payload.update(init=_par_init(pt, main, startup, _par_place(pt, payload)),
                   feeds=_dp_feeds(cfg, PAR_STEPS))
    _free_card()
    res, = _par_launch("train_dp_nccl", 1, payload, backend="nccl")
    fails = []
    if res["gate"] is not None:
        fails.append(f"the grouped step runs eager: {res['gate']}")
    if res["diverged"]:
        fails.append(f"grouped graph not bitwise the plain one: "
                     f"{res['diverged'][:6]}")
    if res["captures"] != 2 or res["replays"] < 2 * (PAR_STEPS - 2):
        fails.append(f"captures {res['captures']}, replays {res['replays']}")
    if not any(k.startswith("dp_grad_bucket") for k in res["calls"]):
        fails.append(f"no bucket posted: {res['calls']}")
    # the warm-up and the capture post one step's collectives each; a
    # replay runs them as the graph's nodes and posts none from the host
    by_step = res["calls_by_step"]
    if not by_step[0] or by_step[1] != by_step[0] or any(by_step[2:]):
        fails.append(f"collectives posted by step {by_step}")
    if fails:
        raise RuntimeError("train_dp_nccl: " + "; ".join(fails))
    report["train_dp_nccl"] = dict(res, card=card)
    print(f"train_dp_nccl ({card}): ResNet-50 O2 at batch {TRAIN_BATCH} "
          f"over a one-rank NCCL group, graphed ({res['captures']} captures, "
          f"{res['replays']} replays with the plain graph's), bitwise the "
          f"graph with no group for {PAR_STEPS} steps; collectives posted "
          f"per captured step: {len(res['calls'])} sites, "
          f"{sum(res['calls'].values())} calls over the warm-up and the "
          f"capture ({res['calls_by_step']} by step: none from the host "
          f"on a replay); profiled replays ran {res['kernels_traced'][0]} "
          f"kernels "
          f"(no group) and {res['kernels_traced'][1]} (grouped), NCCL's "
          f"{res['nccl_kernels']}, the grouped replay's extra "
          f"{res['added']} (a one-rank NCCL all-reduce in place launches "
          f"nothing)", flush=True)
    return res


def _lm_feeds(c, steps):
    rng = np.random.default_rng(SEED + 71)
    out = []
    for _ in range(steps):
        tok = rng.integers(0, c["vocab"], (c["batch"], c["seqlen"] + 1))
        out.append({"tok": tok[:, :-1].astype(np.int64),
                    "lab": tok[:, 1:].astype(np.int64)})
    return out


def phase_train_planned_lm(pt, report, cfg=None):
    """The LM at LM's widths in f32, planned by planner.plan over (fsdp 2,
    tp 2) on 4 rank processes sharing the card: the roles and specs the
    plan gives (tests/test_torch_parallel.py holds them to the JAX
    planner's), validate_plan_bytes and each rank's parameter bytes
    against per_shard_param_bytes; PAR_STEPS losses against the one-rank LM
    under the same plan within LM_F32_LOSS_RTOL; K7-K9 (their f32 forms)
    on every rank; the replicated state bitwise across ranks. -> launches
    by counter summed over the ranks' steps."""
    import torch
    cfg = dict(PLANNED_LM if cfg is None else cfg)
    card = _card_line() if cfg["device"] == "cuda" else "cpu"
    payload = dict(cfg, net="lm", shard="plan")
    main, startup, loss = _par_net(pt, payload)
    dev = "cuda" if cfg["device"] == "cuda" else "cpu"
    ones = tuple(1 for _ in cfg["mesh"][1])
    pt.parallel.planner.plan(main, pt.parallel.make_mesh(
        ones, cfg["mesh"][1], device=dev))
    place = _par_place(pt, payload)
    init = _par_init(pt, main, startup, place)
    feeds = _lm_feeds(cfg["lm"], PAR_STEPS)
    exe = pt.Executor(place)
    ref = _par_steps(pt, main, loss, exe, _par_scope(pt, init, exe.device),
                     feeds)
    del exe
    _free_card()
    payload.update(init=init, feeds=feeds)
    ranks = _par_launch("train_planned_lm", cfg["world"], payload)
    fails = []
    r0 = ranks[0]
    for r, res in enumerate(ranks):
        if res["held_bytes"] != res["per_shard_bytes"]:
            fails.append(f"rank {r} holds {res['held_bytes']} parameter "
                         f"bytes, per_shard_param_bytes {res['per_shard_bytes']}")
        if not res["validate"]:
            fails.append(f"rank {r}: validate_plan_bytes held nothing")
        for i, (s, s0) in enumerate(zip(res["steps"], r0["steps"])):
            if s["digests"] != s0["digests"]:
                fails.append(f"rank {r} step {i + 1}: replicated state "
                             f"differs from rank 0's")
            missing = [k for k in LM_KERNELS if not s["launches"].get(k)]
            if missing and cfg["device"] == "cuda":
                fails.append(f"rank {r} step {i + 1}: {missing} not launched")
    losses = [s["loss"] for s in r0["steps"]]
    want = [s["loss"] for s in ref]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, want)]
    if max(rel) > LM_F32_LOSS_RTOL:
        fails.append(f"losses {losses} against one rank's {want}")
    if fails:
        raise RuntimeError("train_planned_lm: " + "; ".join(fails[:10]))
    totals = {}
    for res in ranks:
        for s in res["steps"]:
            for k, v in s["launches"].items():
                totals[k] = totals.get(k, 0) + v
    p50 = float(np.median([s["s"] for res in ranks
                           for s in res["steps"][1:]])) * 1e3
    plan = r0["plan"]
    coll = {k: round(float(np.median([s["coll_s"].get(k, 0.0)
                                      for s in r0["steps"][1:]])), 4)
            for k in r0["steps"][-1]["coll_s"]}
    rec = {"card": card, "mesh": cfg["mesh"], "losses": losses,
           "coll_s_p50": coll,
           "one_rank_losses": want, "loss_rel": rel,
           "roles": plan["roles"], "specs": plan["specs"],
           "plan_total_bytes": plan["total_bytes"],
           "plan_per_shard_bytes": plan["per_shard_bytes"],
           "held_bytes": [res["held_bytes"] for res in ranks],
           "by_axes": r0["by_axes"],
           "launches_per_rank_step": r0["steps"][0]["launches"],
           "staged_bytes_per_step": r0["steps"][0]["staged_bytes"],
           "step_p50_ms": p50,
           "one_rank_step_p50_ms": float(np.median(
               [s["s"] for s in ref[1:]])) * 1e3,
           "launches": totals}
    report["train_planned_lm"] = rec
    roles = {}
    for n, role in plan["roles"].items():
        roles.setdefault(role, []).append(n)
    print(f"train_planned_lm ({card}): the LM (f32, batch "
          f"{cfg['lm']['batch']} x T {cfg['lm']['seqlen']}, "
          f"{cfg['lm']['n_layer']} layers, d_model {cfg['lm']['d_model']}, "
          f"vocab {cfg['lm']['vocab']}) planned over {cfg['mesh']} on "
          f"{cfg['world']} rank processes: roles "
          f"{ {k: len(v) for k, v in sorted(roles.items())} }, specs "
          f"{ {n: s for n, s in sorted(plan['specs'].items())[:6]} } ...; "
          f"parameter bytes a rank {rec['held_bytes']} (= "
          f"per_shard_param_bytes; {plan['total_bytes']} whole); losses "
          f"{losses} against one rank's {want} (rel {max(rel):.2e}); a "
          f"rank's step launches {rec['launches_per_rank_step']}, "
          f"{rec['staged_bytes_per_step'] / 1e6:.0f} MB staged, the host's "
          f"seconds in collectives {coll}; step p50 "
          f"{p50:.0f} ms a rank (eager, host_collective), one rank "
          f"{rec['one_rank_step_p50_ms']:.0f} ms", flush=True)
    return totals


def _dlrm_sharded_feeds(rows, steps):
    rng = np.random.default_rng(SEED + 72)
    return [_dlrm_batch(rng, rows, DLRM["batch"]) for _ in range(steps)]


def phase_train_dlrm_sharded(pt, report, cfg=None):
    """bench.py's DLRM (its table rows x 64, batch 256) with the table
    row-sharded over fsdp 2 and the batch split over it, on two rank
    processes sharing the card: each rank holds half the table and its
    moments, looks its ids up by a masked local gather and one all-reduce,
    and applies the rows it owns of the gathered SelectedRows gradient
    through S1 (launched on every rank, every step); the table after
    PAR_STEPS against the one-rank DLRM with its table sharded over a
    one-rank mesh (a relative L2 of DLRM_SHARDED_RTOL). -> S1
    launches summed over the ranks' steps."""
    cfg = dict(DLRM_SHARDED if cfg is None else cfg)
    card = _card_line() if cfg["device"] == "cuda" else "cpu"
    payload = dict(cfg, net="dlrm", shard="table",
                   mesh=((cfg["world"],), ("fsdp",)))
    main, startup, loss = _par_net(pt, payload)
    dev = "cuda" if cfg["device"] == "cuda" else "cpu"
    main._mesh = pt.parallel.make_mesh((1,), ("fsdp",), device=dev)
    pt.parallel.shard_table(main, "emb_table", "fsdp")
    place = _par_place(pt, payload)
    init = _par_init(pt, main, startup, place)
    feeds = _dlrm_sharded_feeds(cfg["rows"], PAR_STEPS)
    exe = pt.Executor(place)
    scope = _par_scope(pt, init, exe.device)
    ref = _par_steps(pt, main, loss, exe, scope, feeds)
    want = scope.find_var("emb_table").cpu()
    del exe, scope
    _free_card()
    payload.update(init=init, feeds=feeds, keep=("emb_table",))
    ranks = _par_launch("train_dlrm_sharded", cfg["world"], payload)
    fails = []
    half = (cfg["rows"] // cfg["world"], DLRM["dim"])
    for r, res in enumerate(ranks):
        if res["shard_shapes"].get("emb_table") != half:
            fails.append(f"rank {r} holds {res['shard_shapes']}")
        for i, s in enumerate(res["steps"]):
            if cfg["device"] == "cuda" and not s["launches"].get(
                    "s1.launches"):
                fails.append(f"rank {r} step {i + 1}: S1 not launched")
    got = ranks[0]["keep"]["emb_table"]
    err = float((got - want).norm() / want.norm())
    err_max = float((got - want).abs().max() / want.abs().max())
    if err > DLRM_SHARDED_RTOL:
        fails.append(f"the table after {PAR_STEPS} steps off by {err:.2e}")
    if any((res["keep"]["emb_table"] != got).any() for res in ranks[1:]):
        fails.append("the gathered table differs across ranks")
    if fails:
        raise RuntimeError("train_dlrm_sharded: " + "; ".join(fails[:10]))
    s1 = sum(s["launches"].get("s1.launches", 0) for res in ranks
             for s in res["steps"])
    rec = {"card": card, "rows": cfg["rows"], "world": cfg["world"],
           "table_rel_err": err, "table_max_rel_err": err_max,
           "losses": [s["loss"] for s in ranks[0]["steps"]],
           "one_rank_losses": [s["loss"] for s in ref],
           "s1_launches_per_rank": [sum(s["launches"].get("s1.launches", 0)
                                        for s in res["steps"])
                                    for res in ranks],
           "table_shard_shape": half,
           "step_p50_ms": float(np.median([s["s"] for res in ranks
                                           for s in res["steps"][1:]])) * 1e3,
           "one_rank_step_p50_ms": float(np.median(
               [s["s"] for s in ref[1:]])) * 1e3}
    report["train_dlrm_sharded"] = rec
    print(f"train_dlrm_sharded ({card}): DLRM {cfg['rows']} x "
          f"{DLRM['dim']} rows sharded over fsdp {cfg['world']} (a rank "
          f"holds {half}), batch {DLRM['batch']} split over it: S1 launches "
          f"a rank {rec['s1_launches_per_rank']}; the table after "
          f"{PAR_STEPS} steps within a relative L2 of {err:.2e} of one rank's "
          f"(largest difference {err_max:.2e} of the largest |value|); losses "
          f"{rec['losses']} (one rank {rec['one_rank_losses']}); step p50 "
          f"{rec['step_p50_ms']:.1f} ms a rank, one rank "
          f"{rec['one_rank_step_p50_ms']:.1f} ms", flush=True)
    return s1



# --- pipelines, experts and the elastic queue (ROADMAP 9b-2) ---------------------

# the LM at LM's widths in f32 trained through PipelineTranspiler: cut after
# each layer's FFN residual add into n_layer stages (chip_smoke.lm_stage_cuts;
# stage 0 holds the embedding and pos_emb, the last the final layer norm,
# the head and the loss), 4 microbatches of 2 rows, Adam at 1e-4, every
# stage program run eager; against the one-device f32 LM (the same program
# minimized) from the same initial state and batches: the losses within
# LM_F32_LOSS_RTOL, each stage's parameters (relative L2 over the stage)
# within PIPE_PARAM_FACTOR of the floor (the one-device run against itself
# on each batch's microbatches reversed: the same gradients summed in
# another order), plus PIPE_PARAM_SLACK
PIPE_LM = {"lm": dict(LM, lr=1e-4), "microbatches": 4, "steps": 3,
           "device": "cuda"}
PIPE_PARAM_FACTOR = 4.0
PIPE_PARAM_SLACK = 1e-7
# K7 a step: the forward and the grad program's recompute, each layer and
# microbatch; K8 and K9 once each
PIPE_KERNELS = {"attn.f32_launches": 2, "attn.f32_dq_launches": 1,
                "attn.f32_dkv_launches": 1}
# gpipe over 'pp' 4 (rank processes sharing the card, gloo): M 8
# microbatches of [2048, 512] f32 rows through pre-LN residual FFN blocks
# 512 -> 2048 -> 512; forward and gradients against gpipe_reference on one
# rank within GPIPE_RTOL (relative L2)
GPIPE = {"stages": 4, "microbatches": 8, "rows": 2048, "d": 512,
         "hidden": 2048, "reps": 3}
GPIPE_RTOL = 1e-5
# sparse_moe at x [4096, 512], 8 experts of hidden 2048, capacity 1.25 (C
# 640), over 'ep' 4 (2 experts a rank): form (a) tokens replicated and form
# (b) the batch split over 'ep', 3 SGD steps each against the one-rank run
# from the same state: losses and state within EP_RTOL (tests/test_moe.py's)
EP = {"tokens": 4096, "d": 512, "experts": 8, "hidden": 2048, "cf": 1.25,
      "world": 4, "lr": 0.02, "steps": 3}
EP_RTOL = 2e-4
PP_EP_WORLD = 4
# the port's MLP fed by elastic_reader over a TaskQueue through 2 passes:
# 256 samples in 16 tasks of 16, batches of 16; in pass 0 a reader dies
# holding its first task's lease after one batch, the injected clock passes
# the timeout, and the task requeues
ELASTIC = {"samples": 256, "task": 16, "batch": 16, "passes": 2,
           "timeout_s": 60.0, "device": "cuda"}


def _pipe_lm_net(pt, c, optimizer=None):
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        tok = pt.layers.data(name="tok", shape=[-1, c["seqlen"]],
                             dtype="int64", append_batch_size=False)
        lab = pt.layers.data(name="lab", shape=[-1, c["seqlen"]],
                             dtype="int64", append_batch_size=False)
        loss = pt.models.transformer_lm(
            tok, lab, vocab_size=c["vocab"], d_model=c["d_model"],
            n_head=c["n_head"], n_layer=c["n_layer"])
        if optimizer is not None:
            optimizer().minimize(loss)
    main.random_seed = startup.random_seed = SEED + 1
    return main, startup, loss


def _timed_steps(fn, feeds, sync):
    out = []
    for f in feeds:
        sync()
        t0 = time.perf_counter()
        loss = fn(f)
        sync()
        out.append((loss, time.perf_counter() - t0))
    return out


def _stage_rel(a, b, names):
    num = sum(float(np.sum((a[n] - b[n]).astype(np.float64) ** 2))
              for n in names)
    den = sum(float(np.sum(b[n].astype(np.float64) ** 2)) for n in names)
    return (num / max(den, 1e-60)) ** 0.5


def phase_train_pipeline_lm(pt, report, cfg=None, places=None):
    """The LM at full width trained through PipelineTranspiler on the card
    (PIPE_LM above): the stage partition disjoint and covering every
    trainable parameter, the losses and each stage's parameters against
    the one-device LM, the f32 K7/K8/K9 launches a step (PIPE_KERNELS per
    layer and microbatch), the step's p50 over steps 2-3. `places` is the
    stages' (default: CUDAPlace(i mod the cards)). -> launches by counter
    over the steps."""
    import torch
    from paddle_tpu_torch.ops import attention_cuda, bn_cuda, conv_cuda
    from paddle_tpu_torch.parallel import program_pipeline
    t_phase = time.perf_counter()
    cfg = dict(PIPE_LM if cfg is None else cfg)
    c, m = cfg["lm"], cfg["microbatches"]
    card = _card_line() if cfg["device"] == "cuda" else "cpu"
    place = pt.CUDAPlace(0) if cfg["device"] == "cuda" else pt.CPUPlace()
    sync = torch.cuda.synchronize if cfg["device"] == "cuda" \
        else (lambda: None)
    adam = lambda: pt.optimizer.Adam(learning_rate=c["lr"])  # noqa: E731
    main, startup, loss = _pipe_lm_net(pt, c, adam)
    init = _par_init(pt, main, startup, place)
    trainable = sorted(p.name for p in main.global_block().all_parameters()
                       if p.trainable)
    feeds = _lm_feeds(c, cfg["steps"])
    exe = pt.Executor(place)

    def one_device(batches):
        scope = _par_scope(pt, init, exe.device)
        steps = _timed_steps(lambda f: float(np.ravel(exe.run(
            main, feed=f, fetch_list=[loss], scope=scope,
            use_jit=False)[0])[0]), batches, sync)
        return steps, {n: scope.find_var(n).detach().cpu().numpy()
                       for n in trainable}
    ref, ref_state = one_device(feeds)
    # the floor: each batch's microbatches in reverse order
    rows = c["batch"] // m
    order = np.concatenate([np.arange(j * rows, (j + 1) * rows)
                            for j in reversed(range(m))])
    _, floor_state = one_device([{k: v[order] for k, v in f.items()}
                                 for f in feeds])
    del exe
    _free_card()

    pmain, pstartup, ploss = _pipe_lm_net(pt, c)
    cuts = lm_stage_cuts(pmain, c["n_layer"])
    trainer = pt.parallel.PipelineTranspiler().transpile(
        ploss, cut_vars=cuts, optimizer=adam, num_microbatches=m,
        places=places)
    scope = pt.Scope()
    trainer.startup(pstartup, scope=scope)
    for n, t in init.items():
        if n in trainable:
            scope.set_var(n, t.to(trainer.executors[0].device, copy=True))
    fails = []
    owned = [set(s.param_names) for s in trainer.stages]
    if sum(len(o) for o in owned) != len(set().union(*owned)) or \
            set().union(*owned) != set(trainable):
        fails.append(f"stage partition {[sorted(o) for o in owned]} is not "
                     f"disjoint or does not cover {trainable}")
    from paddle_tpu_torch.ops import quant_cuda
    counters = (conv_cuda.COUNTERS, bn_cuda.COUNTERS,
                attention_cuda.COUNTERS, quant_cuda.COUNTERS)
    launches = []

    def step(f):
        for k in counters:
            k.reset()
        program_pipeline.COUNTERS.reset()
        out = trainer.train_step(f, scope=scope, use_jit=False)
        launches.append({k: v for k, v in _graph_counts(
            conv_cuda, bn_cuda, attention_cuda).items() if v})
        return out
    got = _timed_steps(step, feeds, sync)
    runs = dict(program_pipeline.COUNTERS.runs)
    losses = [g[0] for g in got]
    want = [r[0] for r in ref]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, want)]
    if max(rel) > LM_F32_LOSS_RTOL:
        fails.append(f"losses {losses} against one device's {want}")
    state = {n: scope.find_var(n).detach().cpu().numpy() for n in trainable}
    stages = []
    for s in trainer.stages:
        names = s.param_names
        r_pipe = _stage_rel(state, ref_state, names)
        r_floor = _stage_rel(floor_state, ref_state, names)
        bound = PIPE_PARAM_FACTOR * r_floor + PIPE_PARAM_SLACK
        stages.append({"params": len(names), "rel_l2": r_pipe,
                       "floor_rel_l2": r_floor, "bound": bound,
                       "place": repr(s.place)})
        if r_pipe > bound:
            fails.append(f"stage {s.idx}'s parameters rel L2 {r_pipe:.3e} "
                         f"past {bound:.3e} (floor {r_floor:.3e})")
    want_launches = {k: v * c["n_layer"] * m for k, v in PIPE_KERNELS.items()}
    if cfg["device"] == "cuda":
        for i, l in enumerate(launches):
            got_l = {k: l.get(k, 0) for k in want_launches}
            if got_l != want_launches:
                fails.append(f"step {i + 1} launches {got_l}, want "
                             f"{want_launches}")
    totals = {}
    for l in launches:
        for k, v in l.items():
            totals[k] = totals.get(k, 0) + v
    p50 = float(np.median([g[1] for g in got[1:]])) * 1e3
    ref_p50 = float(np.median([r[1] for r in ref[1:]])) * 1e3
    rec = {"card": card, "stages": stages, "losses": losses,
           "one_device_losses": want, "loss_rel": rel,
           "launches_per_step": launches[0], "runs_per_step": runs,
           "boundary_moves": program_pipeline.COUNTERS.moves,
           "step_p50_ms": p50, "one_device_step_p50_ms": ref_p50,
           "seconds": time.perf_counter() - t_phase, "fails": fails}
    report["train_pipeline_lm"] = rec
    print(f"train_pipeline_lm ({card}): the LM (f32, batch {c['batch']} x "
          f"T {c['seqlen']}, {c['n_layer']} layers, d_model "
          f"{c['d_model']}, vocab {c['vocab']}) through PipelineTranspiler "
          f"in {len(trainer.stages)} stages on "
          f"{[s['place'] for s in stages]}, {m} microbatches, Adam "
          f"{c['lr']}: losses {losses} against one device's {want} (rel "
          f"max {max(rel):.2e}); stage parameters rel L2 "
          f"{[f'{s['rel_l2']:.2e}' for s in stages]} (floors "
          f"{[f'{s['floor_rel_l2']:.2e}' for s in stages]}, bound "
          f"{PIPE_PARAM_FACTOR}x + {PIPE_PARAM_SLACK}); launches a step "
          f"{launches[0]}; stage runs a step {rec['runs_per_step']}; step "
          f"p50 {p50:.0f} ms (eager) beside one device's {ref_p50:.0f} ms "
          f"(eager); {rec['seconds']:.1f} s", flush=True)
    if fails:
        raise RuntimeError("train_pipeline_lm: " + "; ".join(fails[:10]))
    return totals


def _ffn_stage(params, h):
    """A pre-LN residual FFN block: h + W2 relu(W1 LN(h) + b1) + b2."""
    import torch
    g, b, w1, b1, w2, b2 = params
    x = torch.nn.functional.layer_norm(h, (h.shape[-1],), g, b)
    return h + torch.relu(x @ w1 + b1) @ w2 + b2


def _gpipe_params(c, device):
    """GPIPE's stacked stage parameters from one seed, on `device`."""
    import torch
    gen = torch.Generator().manual_seed(SEED + 81)
    p, d, f = c["stages"], c["d"], c["hidden"]

    def rnd(*shape, scale):
        return (torch.randn(shape, generator=gen) * scale).to(device)
    return (1 + rnd(p, d, scale=0.1), rnd(p, d, scale=0.1),
            rnd(p, d, f, scale=d ** -0.5), rnd(p, f, scale=0.01),
            rnd(p, f, d, scale=f ** -0.5), rnd(p, d, scale=0.01))


def _gpipe_rank(pt, c, device, mesh):
    """One rank's gpipe: its stage's parameters alone on `device`, the
    forward and backward of mean(out^2) timed `reps` times, the last
    against gpipe_reference on this rank (the whole stack)."""
    import torch
    from paddle_tpu_torch.parallel import _collectives as C
    from paddle_tpu_torch.parallel import pipeline
    sync = torch.cuda.synchronize if device.type == "cuda" \
        else (lambda: None)
    p, idx = mesh.axis_size("pp"), mesh.axis_index("pp")
    whole = _gpipe_params(c, torch.device("cpu"))
    mine = [t[idx:idx + 1].clone().to(device).requires_grad_()
            for t in whole]
    gen = torch.Generator().manual_seed(SEED + 82)
    xs = torch.randn((c["microbatches"], c["rows"], c["d"]),
                     generator=gen).to(device)
    secs = []
    for _ in range(c["reps"]):
        for t in mine:
            t.grad = None
        C.COUNTERS.reset()
        sync()
        t0 = time.perf_counter()
        out = pipeline.gpipe(_ffn_stage, tuple(mine), xs, mesh)
        out.square().mean().backward()
        sync()
        secs.append(time.perf_counter() - t0)
    calls = dict(C.COUNTERS.calls)
    ref_params = [t.clone().to(device).requires_grad_() for t in whole]
    want = pipeline.gpipe_reference(_ffn_stage, tuple(ref_params), xs)
    want.square().mean().backward()
    rel = lambda a, b: float((a - b).norm() / b.norm().clamp_min(1e-30))  # noqa: E731
    grads = [rel(t.grad[0], r.grad[idx]) for t, r in zip(mine, ref_params)]
    return {"out_rel": rel(out.detach(), want.detach()),
            "grad_rel": grads, "secs": secs, "calls": calls,
            "held_bytes": sum(t.numel() * t.element_size() for t in mine),
            "stack_bytes": sum(t.numel() * t.element_size() for t in whole),
            "staged": dict(C.COUNTERS.host_staged)}


def _ep_net(pt, c):
    """sparse_moe -> fc(1) -> mean squared error, SGD (tests/test_moe.py's
    net at EP's widths)."""
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[c["d"]], dtype="float32")
        y = pt.layers.data(name="y", shape=[1], dtype="float32")
        h = pt.layers.sparse_moe(x, num_experts=c["experts"],
                                 hidden_size=c["hidden"],
                                 capacity_factor=c["cf"])
        pred = pt.layers.fc(input=h, size=1)
        loss = pt.layers.mean(pt.layers.square_error_cost(pred, y))
        pt.optimizer.SGD(learning_rate=c["lr"]).minimize(loss)
    main.random_seed = startup.random_seed = SEED + 83
    return main, startup, loss


def _ep_shard(pt, main, mesh, form):
    main._mesh = mesh
    for p in main.global_block().all_parameters():
        if p.shape is not None and len(p.shape) == 3:
            pt.parallel.shard_parameter(main, p.name, ("ep", None, None))
    if form == "b":
        for n in ("x", "y"):
            pt.parallel.shard_feed(main, n, ("ep", None))


def _ep_feeds(c):
    rng = np.random.default_rng(SEED + 84)
    w = rng.standard_normal((c["d"], 1)) / c["d"] ** 0.5
    out = []
    for _ in range(c["steps"]):
        x = rng.standard_normal((c["tokens"], c["d"])).astype(np.float32)
        out.append({"x": x, "y": (x @ w).astype(np.float32)})
    return out


def _ep_rank(pt, c, payload, mesh_device, form):
    """One rank's sparse_moe over 'ep' in `form`: the losses, the whole
    state after the steps, the expert bytes it holds, the gathers and the
    collectives posted a step."""
    import torch
    from paddle_tpu_torch.parallel import _collectives as C
    from paddle_tpu_torch.parallel import spmd
    main, _startup, loss = _ep_net(pt, c)
    mesh = pt.parallel.make_mesh((c["world"],), ("ep",), device=mesh_device)
    _ep_shard(pt, main, mesh, form)
    exe = pt.Executor(_par_place(pt, payload))
    scope = _par_scope(pt, payload["ep_init"], exe.device)
    losses, calls, secs = [], [], []
    spmd.COUNTERS.reset()
    for f in payload["ep_feeds"]:
        C.COUNTERS.reset()
        t0 = time.perf_counter()
        losses.append(float(np.ravel(exe.run(main, feed=f, fetch_list=[loss],
                                             scope=scope))[0]))
        secs.append(time.perf_counter() - t0)
        calls.append(dict(C.COUNTERS.calls))
    st = spmd.for_program(main)
    whole = spmd.gather_state(main, scope)
    state = {n: (whole[n] if n in whole else scope.find_var(n)).cpu()
             for n in payload["ep_init"]}
    experts = {n: scope.find_var(n).numel() * scope.find_var(n)
               .element_size() for n in st.specs}
    return {"losses": losses, "state": state, "expert_bytes": experts,
            "gathers": sum(spmd.COUNTERS.gathers.values()),
            "calls": calls, "secs": secs}


def _rank_pp_ep(pt, payload, rank, world):
    """train_gpipe's and train_ep's rank: gpipe over 'pp', then sparse_moe
    over 'ep' in forms (a) and (b), on one group."""
    import torch
    dev = torch.device("cuda", 0) if payload["device"] == "cuda" \
        else torch.device("cpu")
    mesh_dev = "cuda" if payload["device"] == "cuda" else "cpu"
    t0 = time.perf_counter()
    out = {"gpipe": _gpipe_rank(pt, payload["gpipe"], dev,
                                pt.parallel.make_mesh(
                                    (world,), ("pp",), device=mesh_dev))}
    out["gpipe"]["phase_s"] = time.perf_counter() - t0
    for form in ("a", "b"):
        t0 = time.perf_counter()
        out[f"ep_{form}"] = _ep_rank(pt, payload["ep"], payload, mesh_dev,
                                     form)
        out[f"ep_{form}"]["phase_s"] = time.perf_counter() - t0
    return out


RANK_PHASES["train_pp_ep"] = _rank_pp_ep


def phase_train_pp_ep(pt, report, cfg=None):
    """train_gpipe and train_ep on one group of PP_EP_WORLD rank processes
    sharing the card (gloo, host-staged), so the group's start is paid
    once. train_gpipe (GPIPE above): the outputs and each rank's stage
    gradients against gpipe_reference, the hop bytes and the bubble, each
    rank holding its stage's parameters alone. train_ep (EP above): forms
    (a) and (b) against the one-rank run from the same state, each rank
    holding 2 of the 8 experts' weights and gathering none, the dispatch
    bytes a step."""
    import torch
    t_phase = time.perf_counter()
    cfg = dict(device="cuda", world=PP_EP_WORLD, gpipe=dict(GPIPE),
               ep=dict(EP)) if cfg is None else dict(cfg)
    card = _card_line() if cfg["device"] == "cuda" else "cpu"
    g, c = cfg["gpipe"], cfg["ep"]
    place = _par_place(pt, cfg)
    # the one-rank sparse_moe run, from the startup's state
    main, startup, loss = _ep_net(pt, c)
    init = _par_init(pt, main, startup, place)
    feeds = _ep_feeds(c)
    exe = pt.Executor(place)
    scope = _par_scope(pt, init, exe.device)
    want = [float(np.ravel(exe.run(main, feed=f, fetch_list=[loss],
                                   scope=scope))[0]) for f in feeds]
    want_state = {n: scope.find_var(n).cpu() for n in init}
    del exe, scope
    _free_card()
    payload = dict(device=cfg["device"], gpipe=g, ep=c, ep_init=init,
                   ep_feeds=feeds)
    ranks = _par_launch("train_pp_ep", cfg["world"], payload)
    fails = []
    # train_gpipe
    p, mb = g["stages"], g["microbatches"]
    hop = g["rows"] * g["d"] * 4
    bubble = pt.parallel.pipeline.bubble_fraction(p, mb)
    for r, res in enumerate(ranks):
        gp = res["gpipe"]
        if gp["out_rel"] > GPIPE_RTOL or max(gp["grad_rel"]) > GPIPE_RTOL:
            fails.append(f"gpipe rank {r}: outputs rel {gp['out_rel']:.2e}, "
                         f"grads rel {max(gp['grad_rel']):.2e}")
        if gp["held_bytes"] * p != gp["stack_bytes"]:
            fails.append(f"gpipe rank {r} holds {gp['held_bytes']} B of "
                         f"{gp['stack_bytes']}")
    sends = [res["gpipe"]["calls"].get("pipe_send", 0) for res in ranks]
    if sends != [mb] * (p - 1) + [0]:
        fails.append(f"gpipe hops sent by rank {sends}, want {mb} each but "
                     f"the last's")
    gp_p50 = float(np.median([s for res in ranks
                              for s in res["gpipe"]["secs"][1:]])) * 1e3
    # train_ep
    e_loc = c["experts"] // cfg["world"]
    expert_bytes = 2 * c["experts"] * c["d"] * c["hidden"] * 4  # W1, W2
    cap = max(int(np.ceil(c["tokens"] / c["experts"] * c["cf"])), 1)
    slab = c["experts"] * cap * c["d"] * 4
    ep_rec = {}
    for form in ("a", "b"):
        key = f"ep_{form}"
        r0 = ranks[0][key]
        rel = [abs(a - b) / abs(b) for a, b in zip(r0["losses"], want)]
        srel = {n: _rel_l2(r0["state"][n].numpy(), want_state[n].numpy())
                for n in want_state}
        if max(rel) > EP_RTOL or max(srel.values()) > EP_RTOL:
            fails.append(f"ep form ({form}): losses rel {max(rel):.2e}, "
                         f"state rel {max(srel.values()):.2e} "
                         f"({max(srel, key=srel.get)})")
        for r, res in enumerate(ranks):
            got = res[key]
            if got["losses"] != r0["losses"]:
                fails.append(f"ep form ({form}): rank {r}'s losses differ")
            if got["gathers"] or sorted(got["expert_bytes"].values()) != \
                    [expert_bytes // 2 // cfg["world"]] * 2:
                fails.append(f"ep form ({form}) rank {r}: gathers "
                             f"{got['gathers']}, expert bytes "
                             f"{got['expert_bytes']}")
        calls = r0["calls"][-1]
        moved = sum(n for k, n in calls.items()
                    if k.startswith(("expert_dispatch", "expert_combine")))
        ep_rec[form] = {"losses": r0["losses"], "loss_rel": rel,
                        "state_rel_max": max(srel.values()),
                        "collectives_per_step": calls,
                        "dispatch_bytes_per_step": moved * slab
                        if form == "b" else None,
                        "combine_bytes_per_step": slab if form == "a"
                        else None,
                        "step_p50_ms": float(np.median(r0["secs"][1:])) * 1e3,
                        "seconds": r0["phase_s"]}
    rec = {"card": card, "world": cfg["world"],
           "gpipe": {"stages": p, "microbatches": mb, "hop_bytes": hop,
                     "hops_per_link_each_way": mb, "bubble": bubble,
                     "out_rel": [res["gpipe"]["out_rel"] for res in ranks],
                     "grad_rel_max": max(max(res["gpipe"]["grad_rel"])
                                         for res in ranks),
                     "held_bytes": ranks[0]["gpipe"]["held_bytes"],
                     "stack_bytes": ranks[0]["gpipe"]["stack_bytes"],
                     "step_p50_ms": gp_p50,
                     "seconds": ranks[0]["gpipe"]["phase_s"]},
           "ep": {"capacity": cap, "experts_per_rank": e_loc,
                  "expert_bytes": expert_bytes,
                  "held_expert_bytes": sum(ranks[0]["ep_b"]["expert_bytes"]
                                           .values()),
                  "one_rank_losses": want, **ep_rec},
           "seconds": time.perf_counter() - t_phase, "fails": fails}
    report["train_gpipe"] = dict(rec["gpipe"], card=card)
    report["train_ep"] = dict(rec["ep"], card=card)
    print(f"train_gpipe ({card}): P {p} over 'pp' (rank processes sharing "
          f"the card, gloo, host-staged), M {mb} microbatches of "
          f"[{g['rows']}, {g['d']}] f32 through pre-LN residual FFN blocks "
          f"{g['d']} -> {g['hidden']} -> {g['d']}: outputs rel "
          f"{max(rec['gpipe']['out_rel']):.2e}, stage grads rel max "
          f"{rec['gpipe']['grad_rel_max']:.2e} against gpipe_reference; "
          f"each rank holds {rec['gpipe']['held_bytes'] / 2**20:.1f} MiB of "
          f"{rec['gpipe']['stack_bytes'] / 2**20:.1f} MiB; {hop / 2**20:.0f} "
          f"MiB a hop, {mb} hops a link each way; bubble (P-1)/(M+P-1) = "
          f"{bubble:.1%}; forward+backward p50 {gp_p50:.0f} ms; "
          f"{rec['gpipe']['seconds']:.1f} s", flush=True)
    print(f"train_ep ({card}): sparse_moe at x [{c['tokens']}, {c['d']}], "
          f"{c['experts']} experts of hidden {c['hidden']}, capacity "
          f"{c['cf']} (C {cap}), {e_loc} experts a rank over 'ep' "
          f"{cfg['world']}: each rank holds "
          f"{rec['ep']['held_expert_bytes'] / 2**20:.0f} MiB of "
          f"{expert_bytes / 2**20:.0f} MiB of expert weights, gathers none; "
          + "; ".join(
              f"form ({f}) losses {ep_rec[f]['losses']} (one rank "
              f"{want}, rel max {max(ep_rec[f]['loss_rel']):.2e}, state rel "
              f"max {ep_rec[f]['state_rel_max']:.2e}), collectives a step "
              f"{ep_rec[f]['collectives_per_step']}, step p50 "
              f"{ep_rec[f]['step_p50_ms']:.0f} ms" for f in ep_rec)
          + f"; form (b) moves {ep_rec['b']['dispatch_bytes_per_step'] / 2**20:.0f} "
          f"MiB a step on its expert dispatch and combine ({slab / 2**20:.0f} "
          f"MiB a collective); {rec['seconds']:.1f} s", flush=True)
    if fails:
        raise RuntimeError("train_gpipe/train_ep: " + "; ".join(fails[:10]))
    return rec


def _elastic_net(pt, lr=0.1):
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[16], dtype="float32")
        y = pt.layers.data(name="y", shape=[1], dtype="int64")
        h = pt.layers.fc(input=x, size=32, act="relu")
        logits = pt.layers.fc(input=h, size=4)
        loss = pt.layers.mean(
            pt.layers.softmax_with_cross_entropy(logits, y))
        pt.optimizer.Momentum(learning_rate=lr, momentum=0.9).minimize(loss)
    main.random_seed = startup.random_seed = SEED + 85
    return main, startup, loss


def phase_train_elastic(pt, report, cfg=None):
    """The port's MLP on the card fed by parallel.master.elastic_reader
    over a TaskQueue in a temp dir (ELASTIC above), 2 passes: in pass 0 a
    reader takes its first task's lease, yields one batch and dies; the
    injected clock passes the lease's timeout and the task requeues to the
    next reader. Every sample is consumed once a pass, plus the requeued
    task's in pass 0; the losses equal those of the same samples fed in the
    same order by a plain reader on a fresh scope from the same state."""
    import tempfile
    t_phase = time.perf_counter()
    c = dict(ELASTIC if cfg is None else cfg)
    card = _card_line() if c["device"] == "cuda" else "cpu"
    place = pt.CUDAPlace(0) if c["device"] == "cuda" else pt.CPUPlace()
    rng = np.random.default_rng(SEED + 86)
    xs = rng.standard_normal((c["samples"], 16)).astype(np.float32)
    ys = rng.integers(0, 4, (c["samples"], 1)).astype(np.int64)
    main, startup, loss = _elastic_net(pt)
    init = _par_init(pt, main, startup, place)
    exe = pt.Executor(place)

    def train(scope, batches):
        return [float(np.ravel(exe.run(
            main, feed={"x": xs[ids], "y": ys[ids]}, fetch_list=[loss],
            scope=scope)[0])[0]) for ids in batches]

    def batches(reader):
        buf = []
        for i in reader():
            buf.append(i)
            if len(buf) == c["batch"]:
                yield buf
                buf = []
        if buf:
            yield buf
    now = [1000.0]
    tasks = [list(range(i, i + c["task"]))
             for i in range(0, c["samples"], c["task"])]
    fails, fed, losses, requeued = [], [], [], None
    scope = _par_scope(pt, init, exe.device)
    with tempfile.TemporaryDirectory() as d:
        q = pt.parallel.master.TaskQueue(d, timeout_s=c["timeout_s"],
                                         clock=lambda: now[0])
        q.partition(tasks, chunks_per_task=1)
        for p in range(c["passes"]):
            seen = []
            if p == 0:
                dying = batches(pt.parallel.master.elastic_reader(
                    q, chunk_fetch=lambda t: t, worker="dies"))
                first = next(dying)
                losses += train(scope, [first])
                seen += first
                requeued = list(first)
                del dying                    # dies holding its lease
                now[0] += c["timeout_s"] + 1
            for ids in batches(pt.parallel.master.elastic_reader(
                    q, chunk_fetch=lambda t: t, worker="lives")):
                losses += train(scope, [ids])
                seen += ids
            fed.append(seen)
            counts = np.bincount(seen, minlength=c["samples"])
            want = np.ones(c["samples"], np.int64)
            if p == 0:
                want[requeued] += 1
            if not np.array_equal(counts, want):
                fails.append(f"pass {p}: samples consumed "
                             f"{dict(zip(*np.unique(counts, return_counts=True)))}"
                             f" times, want once (+1 for the requeued task)")
            if not q.pass_done():
                fails.append(f"pass {p} not drained: {q.stats()}")
            q.reset_pass()
    # the same samples in the same order, by a plain reader
    plain = _par_scope(pt, init, exe.device)
    order = [ids[i:i + c["batch"]] for ids in fed
             for i in range(0, len(ids), c["batch"])]
    want_losses = train(plain, order)
    if losses != want_losses:
        fails.append(f"losses differ from the plain reader's: {losses[:4]} "
                     f"vs {want_losses[:4]}")
    rec = {"card": card, "passes": c["passes"], "tasks": len(tasks),
           "consumed": [len(f) for f in fed],
           "requeued_samples": len(requeued or []),
           "losses_first_last": [losses[0], losses[-1]],
           "steps": len(losses), "seconds": time.perf_counter() - t_phase,
           "fails": fails}
    report["train_elastic"] = rec
    print(f"train_elastic ({card}): the MLP fed by elastic_reader over a "
          f"TaskQueue ({len(tasks)} tasks of {c['task']} samples, batches "
          f"of {c['batch']}), {c['passes']} passes: a reader died holding "
          f"a lease after one batch, the injected clock expired it, its "
          f"task ({rec['requeued_samples']} samples) requeued; samples "
          f"consumed a pass {rec['consumed']} of {c['samples']}; {len(losses)} "
          f"steps, losses {losses[0]:.4f} -> {losses[-1]:.4f}, equal to a "
          f"plain reader's of the same samples in the same order; "
          f"{rec['seconds']:.1f} s", flush=True)
    if fails:
        raise RuntimeError("train_elastic: " + "; ".join(fails[:10]))
    return rec


# --- memory and static analysis (ROADMAP 10a) -------------------------------

# ResNet-50 O2 training (bench.py's `resnet`: 224x224, 1000 classes, Momentum)
# measured at three batches, the headroom model fitted under a 16 GiB budget
# (the JAX package's default budget) and validated at its max batch; OOM at
# 1.25x that batch in a fresh process held to the same budget; a batch-16
# request of the served model measured
MEMORY = {"net": "resnet50", "img": 224, "classes": 1000,
          "batches": (8, 16, 32), "budget": 16 << 30, "oom_factor": 1.25,
          "recover": 32, "serve_batch": 16, "device": "cuda",
          "timeout": 300, "tracker_steps": 50}
MEMORY_REL_ERR = 0.10               # what_if's rel_err at the validated batch
MEMORY_SLACK = 64 << 20             # allocated bytes after an OOM vs before
MEMORY_KERNELS = ("conv.launches", "conv.dgrad_launches",
                  "conv.wgrad_launches", "conv.stats_launches",
                  "bn.apply_launches", "bn.act_launches")


def memory_train_net(pt, cfg):
    """The phase's training program: bench.py's ResNet-50 O2 (the smoke's
    `_resnet50_train`), or at a small size a CIFAR ResNet of cfg["depth"]
    under the same optimizer and AMP."""
    if cfg["net"] == "resnet50":
        from paddle_tpu_torch.models import resnet
        return _resnet50_train(pt, resnet, class_dim=cfg["classes"])
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        img = pt.layers.data(name="img", shape=[3, cfg["img"], cfg["img"]],
                             dtype="float32")
        label = pt.layers.data(name="label", shape=[1], dtype="int64")
        loss, _, _ = pt.models.build_image_classifier(
            pt.models.resnet_cifar10, img, label, class_dim=cfg["classes"],
            depth=cfg["depth"])
        opt = pt.amp.decorate(pt.optimizer.Momentum(
            learning_rate=TRAIN_LR, momentum=0.9), level="O2")
        opt.minimize(loss)
    main.random_seed = startup.random_seed = SEED + 1
    return main, startup, loss


def memory_serve_net(pt, cfg):
    """The served twin (is_test, AMP O2, softmax) of memory_train_net's
    model: (main, startup, prob)."""
    if cfg["net"] == "resnet50":
        from paddle_tpu_torch.models import resnet
        main, startup, prob, _ = _resnet50(pt, resnet)
        return main, startup, prob
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        img = pt.layers.data(name="img", shape=[3, cfg["img"], cfg["img"]],
                             dtype="float32")
        logits = pt.models.resnet_cifar10(img, class_dim=cfg["classes"],
                                          depth=cfg["depth"], is_test=True)
        prob = pt.layers.softmax(logits)
    main.random_seed = startup.random_seed = SEED + 1
    pt.amp.enable(main, level="O2")
    return main, startup, prob


def _memory_feed(cfg, batch, seed):
    rng = np.random.default_rng(seed)
    return {"img": rng.standard_normal(
                (batch, 3, cfg["img"], cfg["img"]), dtype=np.float32),
            "label": rng.integers(0, cfg["classes"],
                                  (batch, 1)).astype(np.int64)}


def _memory_spec(cfg, batch):
    """The feeds as (shape, dtype) specs: the static analysis allocates
    nothing."""
    return {"img": ((batch, 3, cfg["img"], cfg["img"]), np.float32),
            "label": ((batch, 1), np.int64)}


def _kernel_counts(conv_cuda, bn_cuda) -> dict:
    """K1-K6's launch counters, by the names of MEMORY_KERNELS."""
    return {k: getattr(conv_cuda.COUNTERS if k.startswith("conv.")
                       else bn_cuda.COUNTERS, k.split(".", 1)[1])
            for k in MEMORY_KERNELS}


def _scope_state_bytes(pt, exe, main, scope, feed):
    """params + opt_state bytes of the state a step of `main` reads
    (memory.classify)."""
    from paddle_tpu_torch import memory
    names = exe._resolve_state(main, feed, scope)
    cls = memory.classify(main, {n: scope.find_var(n) for n in names}, {})
    return cls["params"] + cls["opt_state"]


def _oom_attempt(fn):
    """Run `fn`, which must run out of memory: (the OOMError's fields or
    None, allocated bytes before, after the error was dropped and the
    cache emptied, whether the stream was left capturing)."""
    import torch
    from paddle_tpu_torch import errors
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    got, t0 = None, time.perf_counter()
    try:
        fn()
    except errors.OOMError as e:
        got = {"breakdown": e.breakdown, "top_buffers": e.top_buffers,
               "suggestions": e.suggestions,
               "analysis_total_bytes": (e.analysis or {}).get("total_bytes"),
               "first_line": str(e).splitlines()[0],
               "cause": type(e.__cause__).__name__}
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return {"error": got, "allocated_before": before,
            "allocated_after": torch.cuda.memory_allocated(),
            "capturing": bool(torch.cuda.is_current_stream_capturing()),
            "seconds": seconds}


def _hold_oom(what, att, state_bytes, max_batch, names):
    """The checks of one OOM attempt; a list of failures."""
    bad = []
    err = att["error"]
    if err is None:
        return [f"{what}: no OOMError"]
    bd = err["breakdown"]
    if bd.get("params", 0) + bd.get("opt_state", 0) != state_bytes:
        bad.append(f"{what}: breakdown params + opt_state "
                   f"{bd.get('params', 0) + bd.get('opt_state', 0)} != the "
                   f"scope's {state_bytes}")
    rows = err["top_buffers"]
    if not rows or not any(r.get("kind") in ("param", "opt_state", "feed")
                           and r.get("name") in names for r in rows):
        bad.append(f"{what}: top_buffers name no scope or feed var: "
                   f"{[(r.get('name'), r.get('kind')) for r in rows]}")
    # the ten largest live tensors, before the largest scope variable and
    # feed are appended: forensics must name at least one of them
    if not any(r.get("name") for r in rows[:10]):
        bad.append(f"{what}: none of the ten largest buffers is named: "
                   f"{[(r.get('name'), r.get('nbytes')) for r in rows[:10]]}")
    if not any(f"max_batch={max_batch}" in s for s in err["suggestions"]):
        bad.append(f"{what}: no suggestion names max_batch={max_batch}: "
                   f"{err['suggestions']}")
    drift = att["allocated_after"] - att["allocated_before"]
    if abs(drift) > MEMORY_SLACK:
        bad.append(f"{what}: allocated bytes {drift:+d} after the OOM "
                   f"(slack {MEMORY_SLACK})")
    if att["capturing"]:
        bad.append(f"{what}: the stream is left capturing")
    return bad


def _tracker_cost(pt, exe, main, scope, cfg, reps=200, rounds=6) -> dict:
    """What the memory sample after every run costs: memory.on_run timed
    alone on ResNet-50 O2's feeds and state (microseconds a call), and
    graphed steps of bench.py's SmallNet at the phase's first batch, fed
    from the card and fetching the loss (host-bound: the card waits on
    the executor), in blocks of cfg["tracker_steps"] with the
    memory_tracker flag on and off in turns, each side first in every
    other round (milliseconds a step, the median block of each)."""
    import torch
    from paddle_tpu_torch import flags, memory, telemetry
    b = cfg["batches"][0]
    feed = {n: torch.as_tensor(v, device=exe.device)
            for n, v in _memory_feed(cfg, b, SEED + 50).items()}
    state = {n: scope.find_var(n)
             for n in exe._resolve_state(main, feed, scope)}
    label = telemetry.program_label(main)
    memory.on_run(exe, main, label, feed, state)
    t0 = time.perf_counter()
    for _ in range(reps):
        memory.on_run(exe, main, label, feed, state)
    sample_us = (time.perf_counter() - t0) / reps * 1e6

    zc = ZOO["smallnet"]
    zmain, zstart, zloss = zoo_train_net(pt, zc)
    zscope, zexe = pt.Scope(), pt.Executor()
    zexe.run(zstart, scope=zscope)
    rng = np.random.default_rng(SEED + 51)
    zfeed = {"img": torch.as_tensor(rng.standard_normal(
                 (b, 3, zc["img"], zc["img"]), dtype=np.float32),
                 device=zexe.device),
             "label": torch.as_tensor(rng.integers(
                 0, zc["classes"], (b, 1)), device=zexe.device)}

    def step():
        return zexe.run(zmain, feed=zfeed, fetch_list=[zloss],
                        scope=zscope)[0]

    for _ in range(3):                  # warm-up, capture, replay
        step()
    raw = os.environ.get("PADDLE_TPU_MEMORY_TRACKER")
    blocks = {"on": [], "off": []}
    try:
        for r in range(rounds):
            for on in ((True, False) if r % 2 == 0 else (False, True)):
                flags.set("memory_tracker", on)
                t0 = time.perf_counter()
                for _ in range(cfg["tracker_steps"]):
                    loss = step()
                blocks["on" if on else "off"].append(
                    (time.perf_counter() - t0) * 1e3 / cfg["tracker_steps"])
    finally:
        flags.set("memory_tracker", None if raw is None else raw == "1")
    return {"sample_us": sample_us, "state_tensors": len(state),
            "smallnet_batch": b, "smallnet_loss": float(loss.reshape(-1)[0]),
            "step_ms_on": float(np.median(blocks["on"])),
            "step_ms_off": float(np.median(blocks["off"])),
            "blocks": blocks}


def _memory_oom_run(pt, conv_cuda, bn_cuda, cfg, fit) -> dict:
    """The OOM half of phase `memory`, in a process of its own: the card
    limited to cfg["budget"] (torch.cuda.set_per_process_memory_fraction),
    the fitted HeadroomModel registered for the program, then (1) an eager
    step at ceil(oom_factor x max_batch) that must raise errors.OOMError,
    (2) a batch-`recover` eager step, (3) a graphed step at the OOM batch
    whose capture must run out of memory (its warm-up, the signature's
    eager first run, with the limit lifted), (4) batch-`recover` graphed
    steps that warm up, capture and replay. K1-K6 launches counted over
    (1)-(2), the eager steps."""
    import torch
    from paddle_tpu_torch import executor as E
    from paddle_tpu_torch import memory, telemetry
    c = cfg
    main, startup, loss = memory_train_net(pt, c)
    scope = pt.Scope()
    exe = pt.Executor()
    exe.run(startup, scope=scope)
    label = telemetry.program_label(main)
    model = memory.HeadroomModel(fit["fixed_bytes"], fit["per_item_bytes"])
    max_batch = model.max_batch(c["budget"])
    memory.set_headroom(label, model, c["budget"])
    b_oom = math.ceil(c["oom_factor"] * max_batch)
    feed_oom = _memory_feed(c, b_oom, SEED + 41)
    feed_ok = _memory_feed(c, c["recover"], SEED + 42)
    names = set(exe._resolve_state(main, feed_ok, scope)) | set(feed_ok)
    state_bytes = _scope_state_bytes(pt, exe, main, scope, feed_ok)

    def run(feed, **kw):
        return float(exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                             **kw)[0].reshape(-1)[0])

    total = int(torch.cuda.mem_get_info()[1])
    frac = min(c["budget"] / total, 1.0)
    torch.cuda.set_per_process_memory_fraction(frac)
    run(feed_ok, use_jit=False)               # plans, workspaces, Triton
    conv_cuda.COUNTERS.reset()
    bn_cuda.COUNTERS.reset()
    eager = _oom_attempt(lambda: run(feed_oom, use_jit=False))
    torch.cuda.synchronize()
    before = eager["allocated_before"]
    recovered = run(feed_ok, use_jit=False)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    after_recovery = torch.cuda.memory_allocated() - before
    launches = _kernel_counts(conv_cuda, bn_cuda)
    bad = _hold_oom("eager", eager, state_bytes, max_batch, names)
    if not np.isfinite(recovered):
        bad.append(f"the batch-{c['recover']} step after the OOM: loss "
                   f"{recovered}")
    if abs(after_recovery) > MEMORY_SLACK:
        bad.append(f"allocated bytes {after_recovery:+d} after the recovery "
                   f"step against before the failed one")

    # a capture that runs out of memory
    torch.cuda.set_per_process_memory_fraction(1.0)
    run(feed_oom)                             # the signature's warm-up
    torch.cuda.set_per_process_memory_fraction(frac)
    counts = dict(vars(E.COUNTERS))
    graphed = _oom_attempt(lambda: run(feed_oom))
    bad += _hold_oom("capture", graphed, state_bytes, max_batch, names)
    if E.COUNTERS.captures != counts["captures"]:
        bad.append("the failed capture counted as a capture")
    r0, c0 = E.COUNTERS.replays, E.COUNTERS.captures
    steps = [run(feed_ok) for _ in range(3)]  # warm-up, capture, replay
    replays, captures = E.COUNTERS.replays - r0, E.COUNTERS.captures - c0
    if (captures, replays) != (1, 2) or not np.all(np.isfinite(steps)):
        bad.append(f"after the failed capture, batch {c['recover']} graphed: "
                   f"{captures} captures, {replays} replays, losses {steps}")
    torch.cuda.set_per_process_memory_fraction(1.0)
    return {"max_batch": max_batch, "oom_batch": b_oom, "fraction": frac,
            "state_bytes": state_bytes, "eager": eager,
            "recovered_loss": recovered,
            "after_recovery_bytes": after_recovery,
            "capture": graphed, "graphed_losses": steps,
            "graphed_captures": captures, "graphed_replays": replays,
            "launches": launches, "failures": bad}


def _memory_oom_fresh(cfg, fit, timeout):
    """_memory_oom_run in a fresh process of this script (`--memory-oom`),
    gone after whatever happened (hard timeout)."""
    d = Path(__file__).resolve().parent / "build"
    d.mkdir(exist_ok=True)
    path = d / f"memory-oom-{os.getpid()}.json"
    out = Path(str(path) + ".out")
    out.unlink(missing_ok=True)
    path.write_text(json.dumps({"cfg": cfg, "fit": fit}))
    try:
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--memory-oom", str(path)],
                              capture_output=True, text=True,
                              timeout=timeout)
        if proc.returncode != 0:
            raise RuntimeError(f"memory: the OOM process exited "
                               f"{proc.returncode}:\n{proc.stderr[-3000:]}")
        return json.loads(out.read_text())
    finally:
        path.unlink(missing_ok=True)
        out.unlink(missing_ok=True)


def _memory_oom_main(path) -> int:
    """The fresh process of _memory_oom_fresh: its result as JSON beside
    `path`."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import bn_cuda, conv_cuda, cuda_build
    job = json.loads(Path(path).read_text())
    cuda_build.build()
    res = _memory_oom_run(pt, conv_cuda, bn_cuda, job["cfg"], job["fit"])
    Path(str(path) + ".out").write_text(json.dumps(res, default=str))
    return 0


def _memory_serve(pt, conv_cuda, cfg):
    """The served model admitted (its analysis seconds), one eager
    batch-`serve_batch` request measured beside its static estimate, K1's
    launches counted."""
    import torch
    from paddle_tpu_torch import memory
    from paddle_tpu_torch.serving import ServingEngine
    main, startup, prob = memory_serve_net(pt, cfg)
    scope = pt.Scope()
    pt.Executor().run(startup, scope=scope)
    b = cfg["serve_batch"]
    engine = ServingEngine(main, ["img"], [prob], buckets=(b,), scope=scope)
    _print_admission("memory (ResNet-50 O2 served)", engine)
    feed = {"img": _memory_feed(cfg, b, SEED + 43)["img"]}
    _eager_request(engine, feed)             # plans, workspaces
    conv_cuda.COUNTERS.reset()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out, = _eager_request(engine, feed)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    k1 = conv_cuda.COUNTERS.launches
    static = engine._exe.static_memory_analysis(
        engine.program, feed={"img": _memory_spec(cfg, b)["img"]},
        fetch_list=engine.fetch_names, scope=engine._scope)
    if out.shape != (b, cfg["classes"]) or not np.isfinite(out).all():
        raise RuntimeError(f"memory: the served request gave {out.shape}")
    state = sum(memory.nbytes_of(v) for v in engine._state.values())
    return {"admission": engine.admission, "request_peak_bytes": peak,
            "state_bytes": state,
            "static_total_bytes": static.total_bytes,
            "static_over_measured": static.total_bytes / max(peak + state, 1),
            "k1_launches": k1}


def _memory_refusal(pt, counters):
    """A program with a rank-mismatched `mul` refused by ServingEngine's
    admission before any bucket runs: ProgramVerifyError, no
    serving_bucket_runs_total moved, no kernel launched."""
    from paddle_tpu_torch import telemetry
    from paddle_tpu_torch.errors import ProgramVerifyError
    from paddle_tpu_torch.serving import ServingEngine
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[13], dtype="float32")
        pred = pt.layers.fc(input=x, size=2)
    scope = pt.Scope()
    pt.Executor().run(startup, scope=scope)
    main.global_block().desc.var("x").shape = [-1]
    def snapshot():
        return [{k: dict(v) if isinstance(v, dict) else v
                 for k, v in vars(c).items()} for c in counters]

    runs = telemetry.read_series("serving_bucket_runs_total")
    launched = snapshot()
    t0 = time.perf_counter()
    try:
        ServingEngine(main, ["x"], [pred], buckets=(1, 4), scope=scope)
    except ProgramVerifyError as e:
        codes = [d.code for d in e.diagnostics]
    else:
        raise RuntimeError("memory: the rank-mismatched program was admitted")
    seconds = time.perf_counter() - t0
    if codes != ["rank-mismatch"] or \
            telemetry.read_series("serving_bucket_runs_total") != runs or \
            snapshot() != launched:
        raise RuntimeError(f"memory: the refusal said {codes}, or a bucket "
                           f"ran, or a kernel launched")
    return {"codes": codes, "seconds": seconds}


def phase_memory(pt, conv_cuda, bn_cuda, report, cfg=None, counters=()):
    """Memory and static analysis on ResNet-50 O2 (ROADMAP 10a): the
    headroom model fitted from measured peaks and validated, the static IR
    estimate beside each, OOM forensics and recovery eager and in a capture
    (a fresh process), the served model's admission and request memory,
    and a broken program refused at admission. -> K1-K6 launches on the
    path (MEMORY_KERNELS)."""
    import torch
    from paddle_tpu_torch import memory, telemetry
    c = dict(MEMORY, **(cfg or {}))
    t_phase = time.perf_counter()
    card = _card_line()
    main, startup, loss = memory_train_net(pt, c)
    scope = pt.Scope()
    exe = pt.Executor()
    exe.run(startup, scope=scope)
    label = telemetry.program_label(main)
    conv_cuda.COUNTERS.reset()
    bn_cuda.COUNTERS.reset()
    rows = {}

    def measure(b):
        feed = _memory_feed(c, b, SEED + 30 + b)
        exe.measure_memory(main, feed=feed, fetch_list=[loss], scope=scope)
        rec = exe.measure_memory(main, feed=feed, fetch_list=[loss],
                                 scope=scope)
        st = exe.static_memory_analysis(main, feed=_memory_spec(c, b),
                                        fetch_list=[loss], scope=scope)
        rows[b] = {"measured_bytes": rec.total_bytes,
                   "state_and_feeds_bytes": rec.argument_bytes,
                   "step_bytes": rec.temp_bytes,
                   "static_bytes": st.total_bytes,
                   "static_over_measured": st.total_bytes / rec.total_bytes,
                   "static_top": st.peak["top"][:3]}
        print(f"memory: batch {b}: measured peak "
              f"{rec.total_bytes / 2**30:.3f} GiB (state and feeds "
              f"{rec.argument_bytes / 2**30:.3f}, the step's own "
              f"{rec.temp_bytes / 2**30:.3f}); static IR estimate "
              f"{st.total_bytes / 2**30:.3f} GiB, static/measured "
              f"{st.total_bytes / rec.total_bytes:.3f}", flush=True)
        return rec

    t0 = time.perf_counter()
    res = memory.what_if(measure, batches=c["batches"],
                         budget_bytes=c["budget"], program=label)
    fit_s = time.perf_counter() - t0
    model = memory.headroom_for(label)[0]
    fit_launches = _kernel_counts(conv_cuda, bn_cuda)
    print(f"memory: HeadroomModel fixed {model.fixed_bytes / 2**30:.3f} GiB "
          f"+ {model.per_item_bytes / 2**20:.2f} MiB an image: max_batch "
          f"{res['max_batch']} under {c['budget'] / 2**30:.2f} GiB; measured "
          f"at it {res.get('measured_bytes', 0) / 2**30:.3f} GiB against "
          f"{res.get('predicted_bytes', 0) / 2**30:.3f} predicted, rel_err "
          f"{res.get('rel_err', float('nan')):.4f} (bound {MEMORY_REL_ERR}); "
          f"{fit_s:.1f} s ({card})", flush=True)
    failures = []
    if not res["max_batch"] or res["max_batch"] <= max(c["batches"]):
        failures.append(f"max_batch {res['max_batch']}")
    if not res.get("rel_err", 1.0) <= MEMORY_REL_ERR:
        failures.append(f"rel_err {res.get('rel_err')} > {MEMORY_REL_ERR}")
    tracker = _tracker_cost(pt, exe, main, scope, c)
    print(f"memory: the sample after each run: {tracker['sample_us']:.1f} "
          f"us a call over {tracker['state_tensors']} state tensors; "
          f"SmallNet's graphed batch-{tracker['smallnet_batch']} steps "
          f"{tracker['step_ms_on']:.4f} ms with it, "
          f"{tracker['step_ms_off']:.4f} ms without (median blocks of "
          f"{c['tracker_steps']}, in turns; blocks {tracker['blocks']})",
          flush=True)
    if not np.isfinite(tracker["smallnet_loss"]):
        failures.append(f"SmallNet's loss {tracker['smallnet_loss']}")
    # the OOM process shares the card: give it what this one holds unused
    del exe, scope
    _settled_reserved()

    t0 = time.perf_counter()
    oom = _memory_oom_fresh(c, {"fixed_bytes": model.fixed_bytes,
                                "per_item_bytes": model.per_item_bytes},
                            c["timeout"])
    oom_s = time.perf_counter() - t0
    failures += oom["failures"]
    for what in ("eager", "capture"):
        a = oom[what]
        err = a["error"] or {}
        top = [(r.get("name"), r.get("kind"))
               for r in err.get("top_buffers", [])[:4]]
        print(f"memory: OOM {what} at batch {oom['oom_batch']} under "
              f"{c['budget'] / 2**30:.2f} GiB: {err.get('first_line')!r} "
              f"after {a['seconds']:.2f} s; allocated "
              f"{(a['allocated_after'] - a['allocated_before']) / 2**20:+.2f} "
              f"MiB after it; top buffers {top}", flush=True)
    print(f"memory: after the OOMs, batch {c['recover']} ran (loss "
          f"{oom['recovered_loss']:.5f}, allocated "
          f"{oom['after_recovery_bytes'] / 2**20:+.2f} MiB) and graphed "
          f"{oom['graphed_captures']} capture, {oom['graphed_replays']} "
          f"replays; the OOM process {oom_s:.1f} s", flush=True)

    serve = _memory_serve(pt, conv_cuda, c)
    print(f"memory: a batch-{c['serve_batch']} served request: peak "
          f"{serve['request_peak_bytes'] / 2**20:.1f} MiB over "
          f"{serve['state_bytes'] / 2**20:.1f} MiB of state, static/measured "
          f"{serve['static_over_measured']:.3f}; K1 {serve['k1_launches']}",
          flush=True)
    refusal = _memory_refusal(pt, counters or (conv_cuda.COUNTERS,
                                               bn_cuda.COUNTERS))
    admission = {"memory_serve": serve["admission"],
                 **{p: report[p]["admission"]
                    for p in ("slice", "serve_q8", "serve_lm")
                    if p in report}}
    for p, a in admission.items():
        if a["error"]:
            failures.append(f"{p} admitted with {a['error']} errors")
    launches = {k: fit_launches[k] + oom["launches"][k]
                for k in MEMORY_KERNELS}
    launches["conv.launches"] += serve["k1_launches"]
    if c["device"] == "cuda":
        missing = [k for k, v in launches.items() if not v]
        if missing:
            failures.append(f"{missing} were launched no time")
    seconds = time.perf_counter() - t_phase
    print(f"memory: refused the broken program ({refusal['codes']}) in "
          f"{refusal['seconds']:.3f} s before any bucket; K1-K6 launches "
          f"{launches}; phase {seconds:.1f} s", flush=True)
    report["memory"] = {"card": card, "cfg": c, "by_batch": rows,
                        "what_if": res, "tracker": tracker, "oom": oom,
                        "serve": serve,
                        "refusal": refusal, "admission": admission,
                        "launches": launches, "seconds": seconds}
    if failures:
        raise RuntimeError("memory: " + "; ".join(failures))
    return launches


# ---------------------------------------------------------------------------
# The numeric-health plane (ROADMAP 10b-1)
# ---------------------------------------------------------------------------

OBSERVE = {"net": "resnet50", "img": 224, "classes": 1000, "batch": 32,
           "steps": 48, "period": 16, "turns": 6, "turn_steps": 4,
           "lm": dict(LM), "lm_clean": 3, "smallnet_batch": 8,
           "host_reps": 2000, "sample_reps": 200, "device": "cuda"}
# T1 against its plain version: the counts, min and max exact; mean,
# abs-mean and l2 within STATS_RTOL (T1 adds f32 partial sums in a tree,
# the plain version in f64), mean's error bounded by STATS_RTOL x abs-mean
STATS_RTOL = 1e-5
# the dynamics rows against a host recomputation in f64: f32 norms of up to
# 2.4M elements a tensor through torch._foreach_norm's per-thread partial
# sums (~128 terms each) and a host sum in f64
DYN_RTOL = 1e-4
T1_SOURCE = "paddle_tpu_torch/ops/stats_cuda.py"
T1_REPLACES = ("the port's own: replaces the XLA-fused jnp of "
               "paddle_tpu/inspector.py:94-136 (_tensor_stats_lower)")
OBSERVE_KERNELS = ("conv.launches", "conv.dgrad_launches",
                   "conv.wgrad_launches", "conv.stats_launches",
                   "bn.apply_launches", "bn.act_launches")
OBSERVE_LM_KERNELS = ("attn.launches", "attn.dq_launches",
                      "attn.dkv_launches")


def _observe_dir() -> Path:
    """chiprun_out/observe under the checkout, emptied: the phase's step log
    (appended to, so an earlier run's would count), chrome traces and crash
    reports, this run's only."""
    import shutil
    d = Path(__file__).resolve().parent / "chiprun_out" / "observe"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True, exist_ok=True)
    return d


def _path_counts(conv_cuda, bn_cuda, attention_cuda, stats_cuda):
    """The kernel wrappers' counts by TRACE_KERNELS' keys, T1's included."""
    out = _graph_counts(conv_cuda, bn_cuda, attention_cuda)
    out["stats.launches"] = stats_cuda.COUNTERS.launches
    return out


class _Replays:
    """Counts each graph's replays on one Executor: after a run, the graph
    it replayed is the last of the Executor's LRU (Executor._step moves a
    hit to the end, and a new signature enters there)."""

    def __init__(self, exe, E):
        self.exe, self.E = exe, E
        self.by_entry = {}

    def step(self, fn):
        before = self.E.COUNTERS.replays
        out = fn()
        if self.E.COUNTERS.replays > before:
            entry = next(reversed(self.exe._graphs.values()))
            n = self.by_entry.get(id(entry), (entry, 0))[1]
            self.by_entry[id(entry)] = (entry, n + 1)
        return out

    def launches(self) -> dict:
        """Kernel counter -> launches the counted replays made, from each
        graph's kept nodes (_kept_graphs)."""
        tot = {}
        for entry, n in self.by_entry.values():
            for k, v in _graph_launches(entry.graph).items():
                tot[k] = tot.get(k, 0) + v * n
        return tot


def _merged(*tables) -> dict:
    out = {}
    for t in tables:
        for k, v in t.items():
            out[k] = out.get(k, 0) + v
    return out


def _host_dynamics_rows(plan, old, new, grads):
    """The reference's _group_row (paddle_tpu/dynamics.py:324-391) in f64
    on the host, from copies of the step's W_old, W_new and G (CPU f32
    tensors by name): one row a group."""
    import torch
    rows = []
    for grp in plan.groups:
        w_sq = w_max = d_sq = g_sq = g_nz = m_sq = 0.0
        w_n = g_n = m_n = 0
        has_grad = has_update = has_moment = False
        for ent in grp.params:
            if ent.name not in old:
                continue
            wo = old[ent.name].double()
            wn = new.get(ent.name, old[ent.name]).double()
            w_sq += float((wn * wn).sum())
            w_max = max(w_max, float(wn.abs().max()))
            w_n += wn.numel()
            if ent.name in new:
                has_update = True
                d_sq += float(((wn - wo) ** 2).sum())
            g = grads.get(ent.grad) if ent.grad else None
            if g is not None:
                g = g.double()
                has_grad = True
                g_sq += float((g * g).sum())
                g_nz += float((g != 0).sum())
                g_n += g.numel()
            for m in ent.moments:
                mv = new.get(m, old.get(m))
                if mv is None:
                    continue
                has_moment = True
                m_sq += float((mv.double() ** 2).sum())
                m_n += mv.numel()
        w_l2 = math.sqrt(w_sq)
        rows.append([
            w_l2, math.sqrt(w_sq / max(w_n, 1)), w_max,
            math.sqrt(g_sq) if has_grad else -1.0,
            math.sqrt(g_sq / max(g_n, 1)) if has_grad else -1.0,
            (1.0 - g_nz / max(g_n, 1)) if has_grad else -1.0,
            math.sqrt(d_sq) / (w_l2 + 1e-12) if has_update else -1.0,
            math.sqrt(m_sq / max(m_n, 1)) if has_moment else -1.0])
    return torch.tensor(rows, dtype=torch.float64)


def _windows(fusion, program) -> dict:
    """The program's fusion windows by kind -> the output names of their
    members, one tuple a window."""
    out = {}
    for g in fusion.plan(program).values():
        out.setdefault(g.kind, set()).add(
            tuple(n for m in g.members for n in m.output_arg_names))
    return out


def _hold_t1(stats_cuda, pairs):
    """Every recorded (probe input, T1 output) against the plain version:
    -> (max |T1 - plain| over the fields, the probes held)."""
    import torch
    worst = 0.0
    for x, got in pairs:
        want = stats_cuda.tensor_stats_reference(x)
        got = got.double().cpu()
        want = want.double().cpu()
        exact = [0, 1, 5, 6, 7]
        if not torch.equal(got[exact], want[exact]):
            raise RuntimeError(f"T1 on {tuple(x.shape)} {x.dtype}: {got} "
                               f"against the plain {want}")
        tol = STATS_RTOL * torch.stack([want[3], want[3], want[4]]).abs()
        close = (got[2:5] == want[2:5]) | (
            (got[2:5] - want[2:5]).abs() <= tol + 1e-30)
        if not bool(close.all()):
            raise RuntimeError(f"T1 on {tuple(x.shape)} {x.dtype}: mean, "
                               f"abs-mean, l2 {got[2:5].tolist()} against "
                               f"{want[2:5].tolist()} (rtol {STATS_RTOL})")
        diff = torch.where(got == want, torch.zeros_like(got), got - want)
        worst = max(worst, float(diff.abs().max()))
    return worst, len(pairs)


def _time_t1(stats_cuda, pairs):
    """T1 and its plain version timed at each distinct (shape, dtype) of
    the step's probes, summed over the probes -> the kernel entry's ms,
    plain_ms, bound_ms and the rows."""
    shapes = {}
    for x, _ in pairs:
        key = (tuple(x.shape), str(x.dtype))
        shapes.setdefault(key, [x, 0])[1] += 1
    rows, tot = [], {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "calls": 0}
    for (shape, dtype), (x, n) in sorted(shapes.items(),
                                         key=lambda it: -it[1][0].numel()):
        ms = _device_ms(lambda: stats_cuda.tensor_stats(x))
        plain = _eager_ms(lambda: stats_cuda.tensor_stats_reference(x))
        bound = stats_cuda.bytes_read(x) / PEAK_BYTES * 1e3
        rows.append({"shape": list(shape), "dtype": dtype, "probes": n,
                     "ms": ms, "plain_ms": plain, "bound_ms": bound})
        tot["ms"] += ms * n
        tot["plain_ms"] += plain * n
        tot["bound_ms"] += bound * n
        tot["calls"] += n
    return tot, rows


def _observe_resnet(pt, conv_cuda, bn_cuda, attention_cuda, cfg, card, out,
                    rec):
    """Phase observe (a): ResNet-50 O2, graphed, with the plane on."""
    import torch
    from paddle_tpu_torch import dynamics, inspector, telemetry, tracing
    from paddle_tpu_torch import executor as E
    from paddle_tpu_torch.ops import fusion, stats_cuda
    main, startup, loss = memory_train_net(pt, cfg)
    inst = inspector.instrument(main, auto=True)
    audit = inspector.GradientAudit(inst)
    prog = audit.program
    sites = prog._probe_sites
    trainable = [p.name for p in main.global_block().all_parameters()
                 if getattr(p, "trainable", True)]
    if sorted(audit.params) != sorted(trainable) or audit.missing:
        raise RuntimeError(f"the audit covers {len(audit.params)} of "
                           f"{len(trainable)} parameters, missing "
                           f"{audit.missing}")
    exe = pt.Executor()
    s_on, s_off = pt.Scope(), pt.Scope()
    exe.run(startup, scope=s_on)
    for n, v in s_on.vars.items():
        s_off.set_var(n, v.clone() if isinstance(v, torch.Tensor) else v)
    feed = {n: torch.as_tensor(v, device=exe.device) for n, v in
            _memory_feed(cfg, cfg["batch"], SEED + 80).items()}
    grads = [p + "@GRAD" for p in trainable]
    fetch = [loss] + grads
    period = cfg["period"]
    steplog = str(out / "steps.jsonl")
    with dynamics.override(True, period):
        plan = dynamics.plan(prog)
    planned = {n for g in plan.groups for e in g.params
               for n in (e.name,) + tuple(e.moments)}
    written = set(exe._persistable_outputs(prog))
    for c in (conv_cuda.COUNTERS, bn_cuda.COUNTERS, attention_cuda.COUNTERS,
              stats_cuda.COUNTERS):
        c.reset()
    E.COUNTERS.reset()
    reps = _Replays(exe, E)
    samples, losses, reserved = [], [], {}
    telemetry.enable_step_log(steplog)
    tracing.enable()
    inspector.enable_flight_recorder(str(out / "crash_resnet.json"))
    t0 = time.perf_counter()
    with dynamics.override(True, period), _kept_graphs(), \
            _captures_uncounted(conv_cuda.COUNTERS, bn_cuda.COUNTERS,
                                attention_cuda.COUNTERS, stats_cuda.COUNTERS):
        for _ in range(cfg["steps"]):
            c = s_on.find_var("__rng_counter__") or 0
            old = None
            if c % period == 0:
                old = {n: s_on.find_var(n).detach().float().cpu()
                       for n in planned}
            got = reps.step(lambda: exe.run(prog, feed=feed, fetch_list=fetch,
                                            scope=s_on, return_numpy=False))
            losses.append(float(got[0].float().reshape(-1)[0]))
            if old is not None:
                new = {n: s_on.find_var(n).detach().float().cpu()
                       for n in planned & written}
                g = {n: t.detach().float().cpu()
                     for n, t in zip(grads, got[1:])}
                samples.append((c, old, new, g))
            graphs = [k for k in exe._graphs if k[0] == id(prog)
                      and exe._graphs[k].graph is not None]
            reserved.setdefault(len(graphs), torch.cuda.memory_reserved())
    torch.cuda.synchronize()
    steps_s = time.perf_counter() - t0
    path = _merged(_path_counts(conv_cuda, bn_cuda, attention_cuda,
                                stats_cuda), reps.launches())
    entries = [e for k, e in exe._graphs.items() if k[0] == id(prog)]
    if len(entries) != 2 or any(e.graph is None for e in entries):
        raise RuntimeError(f"{len(entries)} graphs for the probed signature, "
                           f"not a sampled and a plain one")
    tokens = sorted(k[-2][2] for k in exe._graphs if k[0] == id(prog))
    if tokens != [False, True]:
        raise RuntimeError(f"the graphs' plane tokens sample {tokens}")
    if reserved.get(2, 0) > 2 * reserved.get(1, 1):
        raise RuntimeError(f"reserved {reserved} bytes after the first and "
                           f"second graph: the pool doubled")
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"non-finite losses {losses}")
    snap_bytes = sum(t.numel() * t.element_size() for e in entries
                     for t in e.snap.values())
    # the dynamics rows against the host
    label = telemetry.program_label(prog)
    recent = dynamics.payload(recent=cfg["steps"])["programs"][label]["series"]
    if [s[0] for s in samples] != list(range(period, cfg["steps"] + 1,
                                             period)):
        raise RuntimeError(f"sampled counters {[s[0] for s in samples]}")
    worst_dyn = 0.0
    for c, old, new, g in samples:
        want = _host_dynamics_rows(plan, old, new, g)
        for gi, grp in enumerate(plan.groups):
            row = next(r for r in recent[grp.name]["recent"]
                       if r["step"] == c)
            got = torch.tensor([-1.0 if row[f] is None else row[f]
                                for f in dynamics.STAT_FIELDS],
                               dtype=torch.float64)
            err = ((got - want[gi]).abs()
                   / want[gi].abs().clamp_min(1e-30)).max()
            worst_dyn = max(worst_dyn, float(err))
            if not bool(torch.allclose(got, want[gi], rtol=DYN_RTOL,
                                       atol=1e-12)):
                raise RuntimeError(f"dynamics row of {grp.name} at step {c}:"
                                   f" {got.tolist()} against the host's "
                                   f"{want[gi].tolist()}")
    del samples
    rep = audit.report()
    statuses = sorted({r["status"] for r in rep.values()})
    telemetry.disable_step_log()
    runs = [r for r in telemetry.read_step_log(steplog)
            if r["kind"] == "run" and r.get("program") == label]
    if len(runs) != cfg["steps"] or any(r["mode"] != "graph" for r in runs):
        raise RuntimeError(f"{len(runs)} run events for {cfg['steps']} steps,"
                           f" modes {sorted({r['mode'] for r in runs})}")

    # the plane on (prog) and off (main) in turns, each fetching the loss
    # alone; first each signature's graphs (prog's sampled one too)
    blocks = {"on": [], "off": []}
    with _kept_graphs():
        for _ in range(3):      # main's warm-up, capture, replay
            exe.run(main, feed=feed, fetch_list=[loss], scope=s_off)
        with dynamics.override(True, period):
            for _ in range(3 * period):
                exe.run(prog, feed=feed, fetch_list=[loss], scope=s_on)
                if sum(1 for k, e in exe._graphs.items()
                       if k[0] == id(prog) and grads[0] not in k[3]
                       and e.graph is not None) == 2:
                    break
    for r in range(cfg["turns"]):
        for on in ((True, False) if r % 2 == 0 else (False, True)):
            t0 = time.perf_counter()
            for _ in range(cfg["turn_steps"]):
                if on:
                    with dynamics.override(True, period):
                        exe.run(prog, feed=feed, fetch_list=[loss],
                                scope=s_on)
                else:
                    tracing.disable()
                    inspector.disable_flight_recorder()
                    exe.run(main, feed=feed, fetch_list=[loss], scope=s_off)
                    tracing.enable()
                    inspector.enable_flight_recorder(
                        str(out / "crash_resnet.json"))
            torch.cuda.synchronize()
            blocks["on" if on else "off"].append(
                (time.perf_counter() - t0) * 1e3 / cfg["turn_steps"])
    inspector.disable_flight_recorder()
    off_entry = next(e for k, e in exe._graphs.items() if k[0] == id(main))
    plain_entry = next(e for k, e in exe._graphs.items()
                       if k[0] == id(prog) and not k[-2][2]
                       and grads[0] not in k[3])
    probed_k = _graph_launches(plain_entry.graph)
    off_k = _graph_launches(off_entry.graph)
    differ = {k: (probed_k.get(k, 0), off_k.get(k, 0))
              for k in OBSERVE_KERNELS
              if probed_k.get(k, 0) != off_k.get(k, 0)}
    wm, wp = _windows(fusion, main), _windows(fusion, prog)
    broken = {kind: sorted(wm[kind] - wp.get(kind, set()))
              for kind in wm if wm[kind] - wp.get(kind, set())}

    # T1 against its plain version on every probe of one (eager) step
    scratch = pt.Scope()
    for n, v in s_on.vars.items():
        scratch.set_var(n, v.clone() if isinstance(v, torch.Tensor) else v)
    pairs = []
    launch = stats_cuda.tensor_stats

    def recorded(x):
        y = launch(x)
        pairs.append((x.detach().clone(), y.clone()))
        return y
    stats_cuda.tensor_stats = recorded
    try:
        with dynamics.override(False):
            exe.run(prog, feed=feed, fetch_list=[loss], scope=scratch,
                    use_jit=False)
    finally:
        stats_cuda.tensor_stats = launch
    if len(pairs) != len(sites):
        raise RuntimeError(f"{len(pairs)} T1 calls for {len(sites)} probes")
    t1_err, held = _hold_t1(stats_cuda, pairs)
    t1_time, t1_rows = _time_t1(stats_cuda, pairs)
    del pairs, scratch
    res = {
        "probes": len(sites), "grad_probes": len(audit.params),
        "steps": cfg["steps"], "steps_s": steps_s, "losses": losses[-3:],
        "graphs": len(entries), "reserved_by_graphs": reserved,
        "prestep_copy_bytes": snap_bytes, "dynamics_rows": len(plan.groups),
        "dynamics_max_rel_err": worst_dyn, "audit_statuses": statuses,
        "launches": path, "probed_replay": probed_k, "unprobed_replay": off_k,
        "kernels_differ": differ, "windows_broken": broken,
        "step_ms_on": float(np.median(blocks["on"])),
        "step_ms_off": float(np.median(blocks["off"])), "blocks": blocks,
        "t1_max_abs_err": t1_err, "t1_held": held, "t1": t1_time,
        "t1_rows": t1_rows, "run_events": len(runs)}
    rec["resnet50_o2"] = res
    print(f"observe resnet50_o2: {len(sites)} probes ({len(audit.params)} "
          f"gradients), {cfg['steps']} graphed steps in {steps_s:.2f} s, "
          f"2 graphs (sampled, plain; reserved {reserved}), pre-step copy "
          f"{snap_bytes} B; dynamics {len(plan.groups)} rows x 3 samples "
          f"within {worst_dyn:.2e} of the host's; audit {statuses}; K1-K6 a "
          f"replay probed {probed_k} unprobed {off_k} (differ {differ}; "
          f"windows broken {broken}); step {res['step_ms_on']:.3f} ms on, "
          f"{res['step_ms_off']:.3f} ms off (median of {cfg['turns']} blocks "
          f"in turns; {card})", flush=True)
    print(f"observe T1: {held} probes held to the plain version (counts "
          f"exact, max |T1 - plain| {t1_err:.3e}); per step "
          f"{t1_time['calls']} calls {t1_time['ms']:.4f} ms, plain "
          f"{t1_time['plain_ms']:.4f} ms, bound {t1_time['bound_ms']:.4f} ms",
          flush=True)
    return res


def _first_reader(program, name):
    return next(i for i, op in enumerate(program.global_block().ops)
                if name in op.input_arg_names)


def _observe_lm(pt, attention_cuda, conv_cuda, bn_cuda, cfg, card, out, rec):
    """Phase observe (b): the LM O2 under check_nan_inf, graphed, a poisoned
    FFN weight."""
    import torch
    from paddle_tpu_torch import debugger, errors, flags, inspector
    from paddle_tpu_torch import executor as E
    from paddle_tpu_torch.ops import stats_cuda
    from paddle_tpu_torch.parallel.planner import classify_params
    c = cfg["lm"]
    main, startup, loss, _ = _transformer(pt, cfg=c)
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    feed = {n: torch.as_tensor(v, device=exe.device)
            for n, v in _lm_feed(c).items()}
    roles = classify_params(main)
    ffn = sorted(n for n, r in roles.items() if r == "ffn_up")[-1]
    block = main.global_block()
    want_i = _first_reader(main, ffn)
    want_op = block.ops[want_i]
    n_cands = sum(1 for op in block.ops
                  if inspector._probe_target(block, op) is not None)
    bound_runs = math.ceil(math.log2(n_cands / 8)) + 2
    for t in (attention_cuda.COUNTERS, conv_cuda.COUNTERS, bn_cuda.COUNTERS,
              stats_cuda.COUNTERS):
        t.reset()
    reps = _Replays(exe, E)
    crash = str(out / "crash_lm.json")
    inspector.enable_flight_recorder(crash)
    raw = os.environ.get("PADDLE_TPU_CHECK_NAN_INF")
    flags.set("check_nan_inf", True)
    try:
        with _kept_graphs(), _captures_uncounted(
                attention_cuda.COUNTERS, conv_cuda.COUNTERS, bn_cuda.COUNTERS,
                stats_cuda.COUNTERS):
            clean = [float(reps.step(lambda: exe.run(
                main, feed=feed, fetch_list=[loss], scope=scope))[0][0])
                for _ in range(cfg["lm_clean"])]
            t = scope.find_var(ffn).clone()
            t.view(-1)[0] = float("inf")
            scope.set_var(ffn, t)
            before = {n: (v.clone() if isinstance(v, torch.Tensor) else v)
                      for n, v in scope.vars.items()}
            t0 = time.perf_counter()
            try:
                reps.step(lambda: exe.run(main, feed=feed, fetch_list=[loss],
                                          scope=scope))
                raise RuntimeError("the poisoned LM step did not raise")
            except errors.NonFiniteError as e:
                graphed_err = e
            raise_s = time.perf_counter() - t0
            report = inspector.read_crash_report(crash)
            _hold_scope(before, scope, "after the graphed raise")
            try:
                exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                        use_jit=False)
                raise RuntimeError("the eager scan did not raise")
            except errors.NonFiniteError as e:
                eager_err = e
            _hold_scope(before, scope, "after the eager raise")
    finally:
        flags.set("check_nan_inf", None if raw is None else raw == "1")
        inspector.disable_flight_recorder()
    att = graphed_err.attribution
    if att is None or att.op_index != want_i or att.runs > bound_runs:
        raise RuntimeError(
            f"attribution {att!r}: want op {want_i} '{want_op.type}' (the "
            f"first reader of {ffn}) in at most {bound_runs} replays")
    if (eager_err.op_type, eager_err.var_name) != (att.op_type, att.var):
        raise RuntimeError(f"the eager scan names {eager_err.op_type} -> "
                           f"{eager_err.var_name}, the attribution "
                           f"{att.op_type} -> {att.var}")
    lines = []
    debugger.pprint_program(main, print_fn=lines.append)
    if report["program"] != "\n".join(lines) or \
            report["error"]["attribution"]["op_index"] != want_i:
        raise RuntimeError("the crash report read back differs")
    path = _merged(_path_counts(conv_cuda, bn_cuda, attention_cuda,
                                stats_cuda), reps.launches())
    res = {"weight": ffn, "first_reader": [want_i, want_op.type],
           "named": [att.op_index, att.op_type, att.var],
           "replays": att.runs, "replay_bound": bound_runs,
           "candidates": n_cands, "replay_s": att.seconds,
           "raise_s": raise_s, "clean_losses": clean,
           "graphed_var": graphed_err.var_name,
           "eager_named": [eager_err.op_type, eager_err.var_name],
           "launches": path, "crash_report_keys": sorted(report)}
    rec["lm_o2"] = res
    print(f"observe lm_o2: {ffn} poisoned after {len(clean)} clean steps; "
          f"NonFiniteError on '{graphed_err.var_name}', attributed to op "
          f"{att.op_index} '{att.op_type}' -> '{att.var}' (its first reader) "
          f"in {att.runs} eager replays (bound {bound_runs} over {n_cands} "
          f"candidates, {att.seconds:.2f} s; the raise {raise_s:.2f} s); the "
          f"eager scan names the same; scope bitwise, counter kept; crash "
          f"report read back; K7-K9 {[path.get(k, 0) for k in OBSERVE_LM_KERNELS]}"
          f" ({card})", flush=True)
    return res


def _hold_scope(before, scope, what):
    import torch
    if set(before) != set(scope.vars):
        raise RuntimeError(f"{what}: the scope's names changed")
    for n, v in before.items():
        w = scope.vars[n]
        same = torch.equal(v, w) if isinstance(v, torch.Tensor) else v == w
        if not same:
            raise RuntimeError(f"{what}: {n} is not as before the step")


PROM_LINE = r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? (\+Inf|-Inf|NaN|[-+0-9.e]+)$'


def _observe_exports(pt, out, rec):
    """Phase observe (c): the exports parse."""
    import re
    from paddle_tpu_torch import telemetry, tracing
    text = telemetry.prometheus_text()
    bad = [ln for ln in text.splitlines() if not ln.startswith("# ")
           and not re.match(PROM_LINE, ln)]
    if bad or not text:
        raise RuntimeError(f"invalid exposition lines: {bad[:5]}")
    a, b = str(out / "telemetry_trace.json"), str(out / "spans_trace.json")
    telemetry.export_chrome_trace(a)
    tracing.export_chrome_trace(b)
    ev = json.load(open(a))["traceEvents"]
    sp = json.load(open(b))["traceEvents"]
    runs = sum(1 for e in ev if e["name"] == "run")
    steps = sum(1 for e in sp if e["name"] == "step")
    if not runs or not steps:
        raise RuntimeError(f"{runs} run events, {steps} step spans")
    res = {"prometheus_lines": len(text.splitlines()), "trace_runs": runs,
           "trace_step_spans": steps,
           "compile_spans": sum(1 for e in sp if e["name"] == "compile")}
    rec["exports"] = res
    print(f"observe exports: {res['prometheus_lines']} exposition lines "
          f"valid; chrome traces load, {runs} run events, {steps} step spans "
          f"({res['compile_spans']} compile)", flush=True)
    tracing.disable()


def _observe_costs(pt, cfg, card, rec):
    """Phase observe (d): the plane's per-run host cost while it is off,
    on SmallNet's graphed batch-8 step, and the memory sample's cost."""
    import torch
    from paddle_tpu_torch import flags, inspector, memory, telemetry
    zc = ZOO["smallnet"]
    zmain, zstart, zloss = zoo_train_net(pt, zc)
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(zstart, scope=scope)
    b = cfg["smallnet_batch"]
    feed = {n: torch.as_tensor(v, device=exe.device)
            for n, v in _zoo_feed(zc, b, SEED + 81).items()}
    for _ in range(3):
        exe.run(zmain, feed=feed, fetch_list=[zloss], scope=scope)
    label = telemetry.program_label(zmain)
    reason = exe.graph_gate(zmain, feed)
    n = cfg["host_reps"]

    def plane_off():
        # what Executor.run adds per run with every flag of the plane off
        check = flags.get("check_nan_inf")
        exe._plane(zmain, reason, check, None, 1, False)
        c0 = telemetry.compile_seconds()
        t0 = time.perf_counter()
        dt = time.perf_counter() - t0
        exe._publish_run(zmain, label, dt, telemetry.compile_seconds() - c0,
                         2, 1, 10)
        inspector.flight_enabled()
    plane_off()
    t0 = time.perf_counter()
    for _ in range(n):
        plane_off()
    off_us = (time.perf_counter() - t0) / n * 1e6
    steps = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(50):
            exe.run(zmain, feed=feed, fetch_list=[zloss], scope=scope)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3 / 50)
    step_ms = float(np.median(steps))
    # the memory sample: the per-run hook against the full sample it
    # replaced and against torch.cuda.memory_allocated + its max
    state = {k: scope.find_var(k) for k in exe._resolve_state(zmain, feed,
                                                               scope)}
    m = cfg["sample_reps"]
    memory.on_run(exe, zmain, label, feed, state)
    t0 = time.perf_counter()
    for _ in range(m):
        memory.on_run(exe, zmain, label, feed, state)
    hook_us = (time.perf_counter() - t0) / m * 1e6
    cls = memory.classify(zmain, state, {})
    t0 = time.perf_counter()
    for _ in range(m):
        memory.tracker().sample(device=exe.device, program=label,
                                classes=dict(cls, feeds=0))
    full_us = (time.perf_counter() - t0) / m * 1e6
    t0 = time.perf_counter()
    for _ in range(m):
        torch.cuda.memory_allocated(exe.device)
        torch.cuda.max_memory_allocated(exe.device)
    flat_us = (time.perf_counter() - t0) / m * 1e6
    memory.on_run(exe, zmain, label, feed, state)
    t0 = time.perf_counter()
    telemetry.snapshot()
    read_us = (time.perf_counter() - t0) * 1e6
    res = {"smallnet_batch": b, "plane_off_us": off_us,
           "smallnet_step_ms": step_ms, "smallnet_blocks": steps,
           "plane_off_share": off_us / (step_ms * 1e3),
           "memory_hook_us": hook_us, "memory_full_sample_us": full_us,
           "memory_allocated_pair_us": flat_us, "snapshot_us": read_us}
    rec["costs"] = res
    print(f"observe costs: the plane off adds {off_us:.2f} us a run "
          f"({res['plane_off_share']:.2%} of SmallNet's graphed batch-{b} "
          f"step, {step_ms:.4f} ms, median of 5 blocks of 50); the memory "
          f"hook {hook_us:.2f} us a run (the full sample it replaced "
          f"{full_us:.2f} us, memory_allocated + max_memory_allocated "
          f"{flat_us:.2f} us; a snapshot publishing it {read_us:.1f} us; "
          f"{card})", flush=True)
    return res


def phase_observe(pt, conv_cuda, bn_cuda, attention_cuda, report, cfg=None):
    """The numeric-health plane on the card (ROADMAP 10b-1): (a) ResNet-50
    O2 graphed with probes, the gradient audit, dynamics, the flight
    recorder, the step log and tracing on; (b) the LM O2 under
    check_nan_inf with a poisoned FFN weight; (c) the exports; (d) the
    costs. Returns the T1 kernel entry and K1-K9's launches on the phase
    ({counter: launches})."""
    from paddle_tpu_torch import dynamics, telemetry
    from paddle_tpu_torch.ops import stats_cuda
    cfg = OBSERVE if cfg is None else cfg
    card = _card_line()
    out = _observe_dir()
    rec = report.setdefault("observe", {"card": card})
    t0 = time.perf_counter()
    telemetry.reset()
    dynamics.reset()
    a = _observe_resnet(pt, conv_cuda, bn_cuda, attention_cuda, cfg, card,
                        out, rec)
    b = _observe_lm(pt, attention_cuda, conv_cuda, bn_cuda, cfg, card, out,
                    rec)
    _observe_exports(pt, out, rec)
    _observe_costs(pt, cfg, card, rec)
    rec["seconds"] = time.perf_counter() - t0
    print(f"observe: {rec['seconds']:.1f} s", flush=True)
    launches = _merged(a["launches"], b["launches"])
    t1 = a["t1"]
    entry = {"name": "tensor_stats", "route": "triton", "source": T1_SOURCE,
             "replaces": T1_REPLACES,
             "launches": launches.get("stats.launches", 0),
             "launches_by_path": {"observe": launches.get("stats.launches",
                                                          0)},
             "max_abs_err": a["t1_max_abs_err"], "ms": t1["ms"],
             "plain_ms": t1["plain_ms"], "bound_ms": t1["bound_ms"],
             "bound_by": "bytes", "library_ms": None,
             "per": f"one probed batch-{cfg['batch']} ResNet-50 O2 training "
                    f"step, {t1['calls']} calls (no single PyTorch call "
                    f"computes the eight fields)"}
    if not entry["launches"]:
        raise RuntimeError("T1 was launched no time on phase observe")
    return entry, launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--report", help="also write the measurements as JSON here")
    ap.add_argument("--parent", help="an older checkout whose K6 and f32 K10 "
                    "are timed beside this tree's")
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--phase", help=argparse.SUPPRESS)
    ap.add_argument("--dir", help=argparse.SUPPRESS)
    ap.add_argument("--backend", default="gloo", help=argparse.SUPPRESS)
    ap.add_argument("--dlrm-copies", help=argparse.SUPPRESS)
    ap.add_argument("--memory-oom", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.dlrm_copies:
        return _dlrm_copies_main(args.dlrm_copies)
    if args.memory_oom:
        return _memory_oom_main(args.memory_oom)
    if args.rank is not None:
        # one rank process of a sharded phase (_par_launch); it leaves
        # without the interpreter's teardown, where a process group's
        # threads may be destroyed unjoined and abort the process
        rc = _rank_main(args)
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(rc)

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
    # memory and static analysis (ROADMAP 10a): after the served programs
    # whose admissions it reports
    from paddle_tpu_torch.ops import quant_cuda, sparse_cuda
    mem = phase_memory(pt, conv_cuda, bn_cuda, report, counters=(
        conv_cuda.COUNTERS, bn_cuda.COUNTERS, attention_cuda.COUNTERS,
        quant_cuda.COUNTERS, sparse_cuda.COUNTERS))
    k1["launches_by_path"]["memory"] = mem["conv.launches"]
    k1["launches"] = sum(k1["launches_by_path"].values())
    for k, key in zip(train_kernels, ("dgrad_launches", "wgrad_launches",
                                      "stats_launches", "apply_launches",
                                      "act_launches")):
        table = "bn." if key in ("apply_launches", "act_launches") else "conv."
        k["launches_by_path"]["memory"] = mem[table + key]
        k["launches"] = sum(k["launches_by_path"].values())
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
                                   "train_q8": r3.get("conv.launches", 0),
                                   "train_graph": graph_launches.get(
                                       "conv.launches", 0)})
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
    phase_train_lstm(pt, report)
    trained = phase_train_seq2seq(pt, report)
    phase_decode_beam(pt, trained, report)
    del trained
    phase_train_srl(pt, report)
    # the training front end: K7-K9 from the recipe's and the optimizer
    # passes' replays, K2-K6 from the reader layers' replay, by their traces
    front_end = {"train_lm_recipe": phase_train_lm_recipe(pt, report),
                 "train_optimizers": phase_train_optimizers(pt, report)}
    for k in attn_kernels:
        if k["name"].endswith("_f32"):
            continue
        key = "attn." + counter[k["name"]]
        for path, traced in front_end.items():
            if traced.get(key):
                k["launches_by_path"][path] = traced[key]
        k["launches"] = sum(k["launches_by_path"].values())
    with _kept_graphs():
        reader = phase_train_reader_layers(pt, conv_cuda, bn_cuda, resnet,
                                           report)
    for k, key in zip(train_kernels, ("dgrad_launches", "wgrad_launches",
                                      "stats_launches", "apply_launches",
                                      "act_launches")):
        table = "bn." if key in ("apply_launches", "act_launches") else "conv."
        k["launches_by_path"]["train_reader_layers"] = reader[table + key]
        k["launches"] = sum(k["launches_by_path"].values())
    # vision and detection: K1-K6 at the zoo's and the SSD's shapes, then
    # their training and serving paths
    phase_kernel_zoo(pt, conv_cuda, bn_cuda, report)
    zoo = {"train_zoo": phase_train_zoo(pt, report)}
    zoo_k1 = {"serve_zoo": phase_serve_zoo(pt, conv_cuda, report)}
    zoo["train_ssd"], ssd_scope, det, det_out = phase_train_ssd(pt, report)
    zoo_k1["serve_ssd"] = phase_serve_ssd(pt, conv_cuda, ssd_scope, det,
                                          det_out, report)
    del ssd_scope
    for path, got in zoo.items():
        zoo_k1[path] = got.get("conv.launches", 0)
    k1["launches_by_path"].update(zoo_k1)
    k1["launches"] = sum(k1["launches_by_path"].values())
    for k, key in zip(train_kernels, ("dgrad_launches", "wgrad_launches",
                                      "stats_launches", "apply_launches",
                                      "act_launches")):
        table = "bn." if key in ("apply_launches", "act_launches") else "conv."
        for path, got in zoo.items():
            if got.get(table + key):
                k["launches_by_path"][path] = got[table + key]
        k["launches"] = sum(k["launches_by_path"].values())
    missing = [k["name"] for k in [k1] + train_kernels
               if not any(k["launches_by_path"].get(p)
                          for p in list(zoo) + list(zoo_k1))]
    if missing:
        raise RuntimeError(f"{missing} were launched no time on the vision "
                           f"and detection paths")
    # the sharded runs (ROADMAP 9b-1): rank processes sharing the card
    k6_split = phase_kernel_bn_split(pt, bn_cuda, report)
    sharded = {"train_dp": phase_train_dp(pt, report)}
    phase_train_dp_nccl(pt, report)
    sharded["train_planned_lm"] = phase_train_planned_lm(pt, report)
    s1["launches_by_path"]["train_dlrm_sharded"] = \
        phase_train_dlrm_sharded(pt, report)
    s1["launches"] = sum(s1["launches_by_path"].values())
    for k, key in zip(train_kernels, ("dgrad_launches", "wgrad_launches",
                                      "stats_launches", "apply_launches",
                                      "act_launches")):
        table = "bn." if key in ("apply_launches", "act_launches") else "conv."
        if sharded["train_dp"].get(table + key):
            k["launches_by_path"]["train_dp"] = sharded["train_dp"][table + key]
        k["launches"] = sum(k["launches_by_path"].values())
    # pipelines, experts and the elastic queue (ROADMAP 9b-2)
    t_new = time.perf_counter()
    sharded["train_pipeline_lm"] = phase_train_pipeline_lm(pt, report)
    phase_train_pp_ep(pt, report)
    phase_train_elastic(pt, report)
    report["pipelines_experts_elastic_s"] = time.perf_counter() - t_new
    print(f"train_pipeline_lm, train_gpipe, train_ep, train_elastic: "
          f"{report['pipelines_experts_elastic_s']:.1f} s together",
          flush=True)
    for k in attn_kernels:
        if not k["name"].endswith("_f32"):
            continue
        key = "attn.f32_" + counter[k["name"].removesuffix("_f32")]
        for path in ("train_planned_lm", "train_pipeline_lm"):
            got = sharded[path].get(key)
            if got:
                k["launches_by_path"][path] = got
        k["launches"] = sum(k["launches_by_path"].values())
    # the numeric-health plane (ROADMAP 10b-1): T1, and K1-K9 on its paths
    t1, obs = phase_observe(pt, conv_cuda, bn_cuda, attention_cuda, report)
    for k, key in zip([k1] + train_kernels,
                      ("conv.launches", "conv.dgrad_launches",
                       "conv.wgrad_launches", "conv.stats_launches",
                       "bn.apply_launches", "bn.act_launches")):
        if obs.get(key):
            k["launches_by_path"]["observe"] = obs[key]
            k["launches"] = sum(k["launches_by_path"].values())
    for k in attn_kernels:
        if k["name"].endswith("_f32") or k["name"] not in counter:
            continue
        got = obs.get("attn." + counter[k["name"]])
        if got:
            k["launches_by_path"]["observe"] = got
            k["launches"] = sum(k["launches_by_path"].values())
    missing = [k["name"] for k in train_kernels + attn_kernels
               if not k["name"].endswith("_f32")
               and not k["launches_by_path"].get("observe")]
    if missing:
        raise RuntimeError(f"{missing} were launched no time on phase "
                           f"observe")
    k6 = next(k for k in train_kernels if k["name"] == "bn_act")
    k6["split"] = k6_split
    if not k6["launches_by_path"].get("train_dp"):
        raise RuntimeError("K6's split form was launched no time on "
                           "train_dp")
    kernels = {"kernels": [k1] + train_kernels + attn_kernels + ring_kernels
               + [k11, q1, s1, t1]}
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
