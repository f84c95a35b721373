"""Inference serving engine (the port's counterpart of
paddle_tpu/serving/engine.py `ServingEngine`).

`ServingEngine` owns one pruned inference program end to end:

  * **Model**: a `save_inference_model` directory, loaded into a private
    scope (io.load_inference_model; feed and fetch names from its
    `__model__`), or an in-memory Program with explicit feed and fetch
    names, its weights read from `scope` or the global scope.
  * **Admission**: the program is stripped of training ops, pruned to the
    inference fetch set, cloned `for_test`, and refused if a training-only
    op survived, a fetch is not computable from the feeds, or the static
    analyzer (analysis.analyze_program) finds an error-severity diagnostic
    (errors.ProgramVerifyError), before any bucket warms up.
  * **Quantization** (`quantize="int8"` or `"fp8"`, AMP O3): the program
    is marked O3 in that mode and every quantizable weight is checked for
    the report (quant.prequantize, `quant_report`; conv filters in int8
    whatever the mode, as the reference's quant.py:482); the unfolded ones
    (the fc) are quantized once, here, and the folded conv filters once
    after the fold (ops/fusion.fold_constants), in int8 only. Under int8
    the eligible convs run the int8 kernel K11 and the fc an int8 GEMM;
    under fp8 the fc runs an fp8 GEMM and the convs K1, each counting a
    ("conv2d", "mode") fallback, as the reference's.
  * **Bucket graphs**: a request is padded (edge rows) to the smallest
    bucket of the ladder that holds it, and larger requests are chunked.
    Where the reference compiles one XLA executable per bucket, the port
    captures one CUDA graph per bucket (PreparedProgram.capture): a
    bucket's first call runs the program eagerly once as the warm-up,
    captures it, and replays the capture, so its first answer already
    comes from a replay; later calls replay. The graphs are keyed by
    bucket, the feeds' inner shapes and `quant.cache_token(program)` (a
    replay never runs a route the quant switches no longer select), share
    one memory pool, and live in an LRU of `cache_capacity` (default: the
    ladder's length). A request is written, padding included, into its
    graph's pinned host buffers (BucketGraph.staging, evicted with the
    graph) and copied from there into the graph's static feed buffers;
    the valid rows of each fetch are
    copied to fresh pinned host blocks under the engine lock, before
    another bucket's replay can reuse the pool, and come back as numpy
    arrays the caller owns (`_fetch_rows`). A program the executor's graph
    gate refuses runs eagerly, counted in `serving_fallback_total{reason}`:
    "cpu" on a CPU place (the CPU tests' path: a bucket's first run counts
    a miss, later runs hits). A request holding a LoDTensor
    with a LoD skips the buckets: the executor runs the pruned program on
    it (padded to its own length, graphed on the card as the executor's
    signatures are), counted `serving_fallback_total{reason="lod"}`, as
    the reference's (engine.py:405).
  * **Resident state**: the weights the program reads are resolved from the
    scope and placed on the serving device once, at construction, with the
    fold windows' filters and biases computed from them once; the graphs
    read them in place.
  * **Hot-row embedding cache** (`emb_cache_budget_bytes=` or
    `emb_cache_tables=`, parallel/emb_cache.py `enable_serving`): a
    cached table's resident state is a [cache_rows, dim] slab over a host
    copy of the full table, read-only: a request's ids are remapped to
    slots under the engine lock before its bucket runs, misses are staged
    into the slab in place (the bucket graphs captured its address), and
    nothing is flushed. `stats()["emb_cache"]` reports it.
  * **Telemetry**: the reference's series (`serving_cache_{hit,miss}_total`,
    `serving_cache_evictions_total`, `serving_compile_seconds` — warm-up
    plus capture — and `serving_bucket_runs_total`), the `serving_admit`,
    `serving_prequantize`, `serving_compile` and `serving_evict` events,
    python mirrors of the counters and `stats()`.

The static-analyzer admission gate is a later slice.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import io as io_mod
from .. import quant as quant_mod
from .. import telemetry
from ..errors import ProgramVerifyError
from ..executor import (CUDAPlace, Executor, LoDTensor, Scope, global_scope,
                        scope_guard, _to_device)
from ..framework.framework import Variable

DEFAULT_MAX_BATCH = 64

#: Op roles that must never appear in a served program.
TRAINING_ONLY_ROLES = ("backward", "optimize")

#: Optimizer op types and their fused/sparse twins (the JAX package derives
#: this set from its fusion tables, serving/engine.py:58).
TRAINING_ONLY_OP_TYPES = frozenset({
    "sgd", "momentum", "adam", "fused_sgd", "fused_momentum", "fused_adam",
    "fused_sparse_sgd", "fused_sparse_momentum", "fused_sparse_adam",
})


def training_only_op_types() -> frozenset:
    """Op types that only make sense while training (gradient ops are
    matched by their `_grad` suffix in `is_training_only_op` instead)."""
    return TRAINING_ONLY_OP_TYPES


def is_training_only_op(op_type: str, op_role: Optional[str]) -> bool:
    return (op_role in TRAINING_ONLY_ROLES
            or op_type.endswith("_grad")
            or op_type in TRAINING_ONLY_OP_TYPES)


def bucket_ladder(max_batch: int = DEFAULT_MAX_BATCH) -> Tuple[int, ...]:
    """Powers-of-two padded batch sizes up to and including max_batch."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return tuple(out)


def _pad_rows(arr: np.ndarray, rows: int) -> np.ndarray:
    """Pad axis 0 to `rows` by repeating the last row: values stay
    in-distribution and only the first n result rows are returned."""
    n = arr.shape[0]
    if n == rows:
        return arr
    pad = np.repeat(arr[-1:], rows - n, axis=0)
    return np.concatenate([arr, pad], axis=0)


def _fetch_rows(fetch: List[torch.Tensor], rows: int) -> List[np.ndarray]:
    """The first `rows` rows of each fetch as fresh numpy arrays the caller
    owns (bf16 widened to float32, which is exact: numpy has no bfloat16).
    On the card only the valid rows move: a bf16 fetch is widened there
    (the host's widening of the LM's logits cost far more than the card's,
    PERF.md §5), and each is copied once into a fresh pinned block, which
    the copy engine fills several times faster than pageable memory; the
    stream is waited on once, after the last copy."""
    out = []
    for t in fetch:
        t = t.detach()[:rows]
        if t.dtype == torch.bfloat16:
            t = t.float()
        if t.device.type == "cuda":
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            t = h
        out.append(t)
    if any(f.device.type == "cuda" for f in fetch):
        torch.cuda.current_stream(fetch[0].device).synchronize()
    return [t.numpy() for t in out]


class ServingEngine:
    """Bucketed serving for one inference program. `infer(feed)` is the
    synchronous surface; `run_batch` is the batcher's hot path."""

    def __init__(self, model, feed_names: Optional[Sequence[str]] = None,
                 fetch_names: Optional[Sequence] = None, place=None,
                 scope=None, max_batch: int = DEFAULT_MAX_BATCH,
                 buckets: Optional[Sequence[int]] = None,
                 cache_capacity: Optional[int] = None,
                 emb_cache_budget_bytes: Optional[int] = None,
                 emb_cache_tables: Optional[Dict[str, int]] = None,
                 quantize: Optional[str] = None):
        if quantize not in (None, "int8", "fp8"):
            raise ValueError(f"quantize must be 'int8' or 'fp8', got "
                             f"{quantize!r}")
        self.place = place if place is not None else CUDAPlace(0)
        self._exe = Executor(self.place)
        self.device = self._exe.device
        self._lock = threading.RLock()
        self._closed = False

        if isinstance(model, str):
            self._scope = Scope()
            with scope_guard(self._scope):
                program, loaded_feeds, fetch_targets = \
                    io_mod.load_inference_model(model, self._exe)
            feed_names = list(feed_names or loaded_feeds)
            fetch_names = list(fetch_names
                               or [v.name for v in fetch_targets])
        else:
            if not feed_names or not fetch_names:
                raise ValueError(
                    "ServingEngine(program) needs explicit feed_names and "
                    "fetch_names (a model_dir carries them in __model__)")
            feed_names = list(feed_names)
            fetch_names = [v.name if isinstance(v, Variable) else str(v)
                           for v in fetch_names]
            program = io_mod._strip_training_ops(model) \
                .prune(feed_names, fetch_names).clone(for_test=True)
            self._scope = scope if scope is not None else global_scope()
        self.feed_names = feed_names
        self.fetch_names = fetch_names
        self.program = program
        self._label = telemetry.program_label(program)

        self.quantize = quantize
        self.quant_report: Optional[Dict[str, object]] = None
        if quantize is not None:
            program._amp_dtype = "bfloat16"
            program._amp_level = "O3"
            program._quant_mode = quantize
        self._admit(program, feed_names, fetch_names)

        if buckets is not None:
            self.buckets = tuple(sorted(set(int(b) for b in buckets)))
            if not self.buckets or self.buckets[0] < 1:
                raise ValueError(f"bad bucket ladder {buckets}")
        else:
            self.buckets = bucket_ladder(max_batch)
        self.max_batch = self.buckets[-1]
        self.cache_capacity = (int(cache_capacity) if cache_capacity
                               else len(self.buckets))

        # feed geometry from the program desc: the leading dim must be the
        # batch (-1) for the bucket ladder to apply
        block = program.global_block()
        self._feed_meta: Dict[str, Tuple[Tuple[int, ...], np.dtype]] = {}
        for n in feed_names:
            v = block.desc.var(n)
            shape = tuple(int(d) for d in v.shape)
            if not shape or shape[0] != -1:
                raise ValueError(
                    f"feed '{n}' has static shape {shape}; serving buckets "
                    f"pad the leading batch dim, which must be -1")
            self._feed_meta[n] = (shape, np.dtype(str(v.dtype)))

        self._prepared = self._exe.prepare_serving(program, feed_names,
                                                   fetch_names, self._scope)
        if quantize is not None:
            # AMP O3 (serving/engine.py:152-174): the weights are quantized
            # once, here, and the lowerings read them by name; the fold
            # windows' filters only for the report, since their convs read
            # the folded filter's int8 values (fold_weights, below)
            folded = {g.conv.desc.input("Filter")[0]
                      for g in (self._prepared.groups or {}).values()
                      if g.fold}
            self.quant_report = quant_mod.prequantize(
                program, self._scope, quantize, device=self.device,
                folded=folded)
            telemetry.log_event(
                "serving_prequantize", program=self._label, mode=quantize,
                quantized=len(self.quant_report["quantized"]),
                skipped=len(self.quant_report["skipped"]))
        self._state: Dict[str, torch.Tensor] = {
            n: _to_device(self._scope.find_var(n), self.device)
            for n in self._prepared.state_names}
        # a cached table's slab replaces its resident state before any
        # bucket graph captures the state's addresses
        self._emb_cache = None
        if emb_cache_budget_bytes is not None or emb_cache_tables:
            from ..parallel import emb_cache as emb_cache_mod
            self._emb_cache = emb_cache_mod.enable_serving(
                self, budget_bytes=emb_cache_budget_bytes,
                tables=emb_cache_tables)
        self._prepared.fold_weights(self._state)

        # None: every bucket runs as a graph; else why every bucket runs
        # eager ("cpu")
        self._eager_reason = self._exe.graph_gate(program, feed_names)
        # (bucket, inner feed shapes, quant token) -> BucketGraph (None
        # when eager), least recently used first
        self._graphs: "collections.OrderedDict[tuple, object]" = \
            collections.OrderedDict()
        self._pool = None           # the graphs' shared memory pool
        # python-side mirrors of the telemetry counters (tests + stats())
        self.cache_hits = 0
        self.cache_misses = 0
        self.evictions = 0
        self.bucket_runs: Dict[int, int] = {}

    # --- admission ----------------------------------------------------------
    def _admit(self, program, feed_names, fetch_names):
        """Admission (the JAX package's _admit, engine.py:240-273): refuse
        a program where a training-only op survived pruning or a fetch is
        not computable from the feeds, then run the static analyzer
        (analysis.analyze_program) and refuse one with error-severity
        diagnostics (errors.ProgramVerifyError), before any bucket warms
        up. `self.admission` keeps the analysis's seconds and counts."""
        leaked = [
            f"op[{i}] {op.type} (role={op.desc.attrs.get('op_role')})"
            for i, op in enumerate(program.global_block().ops)
            if is_training_only_op(op.type, op.desc.attrs.get("op_role"))]
        if leaked:
            raise ValueError(
                f"refusing to serve: training-only ops survived pruning: "
                f"{leaked} — the inference fetch set likely includes a "
                f"gradient or optimizer output")
        block = program.global_block()
        produced = {n for op in block.ops for n in op.output_arg_names}
        for n in fetch_names:
            v = block.desc.vars.get(n)
            if (n not in produced and n not in feed_names
                    and not (v is not None and v.persistable)):
                raise ValueError(
                    f"refusing to serve: fetch '{n}' is not computable from "
                    f"the feeds — no op in the pruned program produces it")
        from ..analysis import analyze_program
        t0 = time.perf_counter()
        report = analyze_program(program, feeds=list(feed_names),
                                 fetches=list(fetch_names))
        self.admission = {"seconds": time.perf_counter() - t0,
                          **report.counts()}
        if report.errors:
            raise ProgramVerifyError(report.errors,
                                     program_name="serving admission")
        telemetry.log_event("serving_admit", program=self._label,
                            ops=len(program.global_block().ops),
                            warnings=len(report.warnings))

    # --- bucket cache -------------------------------------------------------
    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _stage(self, arrays: Dict[str, np.ndarray], bucket: int,
               graph) -> Dict[str, torch.Tensor]:
        """The request padded to `bucket` rows (edge rows), as tensors the
        compute can read: where buckets run graphed, the pinned host
        buffers of the bucket's `graph`, written in place (new ones when
        the bucket is about to be captured, which the graph then keeps);
        on the eager path new tensors."""
        if self._eager_reason is not None:
            return {n: torch.from_numpy(_pad_rows(a, bucket))
                    for n, a in arrays.items()}
        stage = graph.staging if graph is not None else {
            n: torch.from_numpy(np.empty((bucket,) + a.shape[1:],
                                         a.dtype)).pin_memory()
            for n, a in arrays.items()}
        for n, a in arrays.items():
            s = stage[n].numpy()
            s[:len(a)] = a
            s[len(a):] = a[-1]
        return stage

    def _graph_locked(self, key: tuple, staged: Dict[str, torch.Tensor]):
        """The graph of `key` (bucket, inner feed shapes, quant token; None
        where the gate runs it eager), from the LRU cache with telemetry; a
        miss warms up and captures it on the staged request, which it
        keeps as its staging buffers. Caller holds self._lock."""
        bucket = key[0]
        if key in self._graphs:
            self._graphs.move_to_end(key)
            self.cache_hits += 1
            telemetry.counter(
                "serving_cache_hit_total",
                "serving bucket-graph cache hits",
                labels=("program", "bucket")).labels(
                    program=self._label, bucket=str(bucket)).inc()
            return self._graphs[key]
        self.cache_misses += 1
        telemetry.counter(
            "serving_cache_miss_total",
            "serving bucket-graph cache misses (warm-up and capture)",
            labels=("program", "bucket")).labels(
                program=self._label, bucket=str(bucket)).inc()
        t0 = time.perf_counter()
        graph = None
        if self._eager_reason is None:
            feeds = {n: torch.empty(s.shape, dtype=s.dtype, device=self.device)
                     for n, s in staged.items()}
            for n, buf in feeds.items():
                buf.copy_(staged[n], non_blocking=True)
            graph = self._prepared.capture(feeds, self._state, self._pool)
            graph.staging = staged
            if self._pool is None:
                self._pool = graph.graph.pool()
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        telemetry.histogram(
            "serving_compile_seconds",
            "bucket warm-up plus CUDA graph capture wall seconds",
            labels=("program", "bucket")).labels(
                program=self._label, bucket=str(bucket)).observe(dt)
        telemetry.log_event("serving_compile", program=self._label,
                            bucket=bucket, seconds=dt)
        # insert before evicting: the pool stays held by a live graph
        self._graphs[key] = graph
        while len(self._graphs) > self.cache_capacity:
            evicted, _ = self._graphs.popitem(last=False)
            self.evictions += 1
            telemetry.counter(
                "serving_cache_evictions_total",
                "bucket graphs LRU-evicted",
                labels=("program",)).labels(program=self._label).inc()
            telemetry.log_event("serving_evict", program=self._label,
                                bucket=evicted[0])
        return graph

    def _compute_locked(self, graph, staged: Dict[str, torch.Tensor],
                        rows: int) -> List[np.ndarray]:
        """Run the bucket (replay its graph, else eagerly) and copy the
        valid rows of each fetch to the host, before any other replay can
        write the pool."""
        if graph is not None:
            for n, buf in graph.feeds.items():
                buf.copy_(staged[n], non_blocking=True)
            fetch = graph.replay()
        else:
            telemetry.counter(
                "serving_fallback_total",
                "bucket runs on the eager path, by the graph gate's reason",
                labels=("program", "reason")).labels(
                    program=self._label, reason=self._eager_reason).inc()
            feed = {n: s.to(self.device, non_blocking=True)
                    for n, s in staged.items()}
            fetch = self._prepared.run(feed, self._state)
        return _fetch_rows(fetch, rows)

    # --- execution ----------------------------------------------------------
    def run_batch(self, feed: Dict[str, np.ndarray],
                  valid_rows: Optional[int] = None,
                  _phase_marks: Optional[Dict] = None) -> List[np.ndarray]:
        """Execute one batch: pad to the smallest admissible bucket, run its
        graph, copy the valid rows back out.

        `_phase_marks`, when a dict, is filled with contiguous
        (start, end) monotonic pairs for the pad / bucket_select /
        compute phases (+ the chosen bucket) — the hook the batcher uses
        to record per-request child spans retroactively. compute runs
        from the feeds' copy to the device to the fetches' arrival on the
        host."""
        if self.closed:
            raise RuntimeError("ServingEngine is closed")
        t_enter = time.monotonic() if _phase_marks is not None else 0.0
        arrays = {}
        n = None
        for name in self.feed_names:
            if name not in feed:
                raise KeyError(f"missing feed '{name}'; engine feeds: "
                               f"{self.feed_names}")
            shape, dtype = self._feed_meta[name]
            a = np.ascontiguousarray(feed[name], dtype=dtype)
            if a.ndim != len(shape):
                raise ValueError(
                    f"feed '{name}' rank {a.ndim} != declared {len(shape)}")
            if n is None:
                n = a.shape[0]
            elif a.shape[0] != n:
                raise ValueError(
                    f"feeds disagree on batch: '{name}' has {a.shape[0]} "
                    f"rows, expected {n}")
            arrays[name] = a
        if n == 0:
            raise ValueError("empty batch")
        if n > self.max_batch:
            raise ValueError(
                f"batch {n} exceeds the largest bucket {self.max_batch}; "
                f"split the request (infer() chunks automatically)")
        rows = valid_rows if valid_rows is not None else n
        bucket = self.bucket_for(n)
        inner = tuple(a.shape[1:] for a in arrays.values())
        with self._lock:
            if self._closed:
                raise RuntimeError("ServingEngine is closed")
            if self._emb_cache is not None:
                # ids -> slab slots (misses staged in place); the padding
                # below repeats the last row, so pad rows hold valid slots
                arrays = self._emb_cache.prepare_feed(arrays)
            key = (bucket, inner, quant_mod.cache_token(self.program))
            staged = self._stage(arrays, bucket, self._graphs.get(key))
            if _phase_marks is not None:
                t_pad = time.monotonic()
                _phase_marks["bucket"] = bucket
                _phase_marks["pad"] = (t_enter, t_pad)
            graph = self._graph_locked(key, staged)
            if _phase_marks is not None:
                t_sel = time.monotonic()
                _phase_marks["bucket_select"] = (t_pad, t_sel)
            out = self._compute_locked(graph, staged, rows)
            if self._emb_cache is not None:
                self._emb_cache.window_dispatched()
            if _phase_marks is not None:
                _phase_marks["compute"] = (t_sel, time.monotonic())
            self.bucket_runs[bucket] = self.bucket_runs.get(bucket, 0) + 1
        telemetry.counter(
            "serving_bucket_runs_total",
            "batches executed per bucket",
            labels=("program", "bucket")).labels(
                program=self._label, bucket=str(bucket)).inc()
        return out

    def infer(self, feed: Dict[str, object]) -> List[np.ndarray]:
        """Synchronous inference: dense feeds through the buckets, chunked
        when larger than the top bucket; a request holding a LoDTensor
        with a LoD through the executor on the same pruned program,
        counted `serving_fallback_total{reason="lod"}`."""
        if self.closed:
            raise RuntimeError("ServingEngine is closed")
        if any(isinstance(feed.get(n), LoDTensor) and feed[n].lod
               for n in self.feed_names):
            telemetry.counter(
                "serving_fallback_total",
                "bucket runs on the eager path, by the graph gate's reason",
                labels=("program", "reason")).labels(
                    program=self._label, reason="lod").inc()
            with self._lock:
                with scope_guard(self._scope):
                    outs = self._exe.run(self.program, feed=dict(feed),
                                         fetch_list=list(self.fetch_names),
                                         scope=self._scope)
            return [np.asarray(o) for o in outs]
        arrays = {n: np.asarray(feed[n]) for n in self.feed_names}
        n = arrays[self.feed_names[0]].shape[0]
        if n <= self.max_batch:
            return self.run_batch(arrays)
        parts = []
        for start in range(0, n, self.max_batch):
            chunk = {k: v[start:start + self.max_batch]
                     for k, v in arrays.items()}
            parts.append(self.run_batch(chunk))
        return [np.concatenate([p[i] for p in parts], axis=0)
                for i in range(len(self.fetch_names))]

    # --- lifecycle / introspection ------------------------------------------
    def stats(self) -> Dict[str, object]:
        # under the run lock: the batcher's worker mutates the counters
        # mid-run_batch, and stats() is called from other threads
        with self._lock:
            out = {
                "cache_hits": self.cache_hits,
                "cache_misses": self.cache_misses,
                "evictions": self.evictions,
                "bucket_runs": dict(self.bucket_runs),
                "buckets": list(self.buckets),
                "resident_state": len(self._state or ()),
            }
        if self._emb_cache is not None:
            out["emb_cache"] = self._emb_cache.stats()
        return out

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    def close(self):
        """Drop the bucket graphs (their staging buffers with them), their
        pool and the resident device state (the fold constants too);
        further calls raise."""
        with self._lock:
            self._graphs.clear()
            self._pool = None
            self._state = {}
            self._prepared.folds = None
            self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
