"""Inference serving engine (the port's counterpart of
paddle_tpu/serving/engine.py `ServingEngine`).

`ServingEngine` owns one pruned inference program end to end:

  * **Model**: a `save_inference_model` directory, loaded into a private
    scope (io.load_inference_model; feed and fetch names from its
    `__model__`), or an in-memory Program with explicit feed and fetch
    names, its weights read from `scope` or the global scope.
  * **Admission**: the program is stripped of training ops, pruned to the
    inference fetch set, cloned `for_test`, and refused if a training-only
    op survived or a fetch is not computable from the feeds.
  * **Quantization** (`quantize="int8"` or `"fp8"`, AMP O3): the program
    is marked O3 in that mode and every quantizable weight is checked for
    the report (quant.prequantize, `quant_report`; conv filters in int8
    whatever the mode, as the reference's quant.py:482); the unfolded ones
    (the fc) are quantized once, here, and the folded conv filters once
    after the fold (ops/fusion.fold_constants), in int8 only. Under int8
    the eligible convs run the int8 kernel K11 and the fc an int8 GEMM;
    under fp8 the fc runs an fp8 GEMM and the convs K1, each counting a
    ("conv2d", "mode") fallback, as the reference's.
  * **Buckets**: a request is padded (edge rows) to the smallest bucket of
    the ladder that holds it, and larger requests are chunked. The JAX
    package compiles one XLA executable per bucket; here every bucket runs
    the same prepared op list eagerly (Executor.prepare_serving). CUDA
    graphs per bucket are later work. The hit/miss/run counters stay as
    plain ints: a miss is a bucket's first run.
  * **Resident state**: the weights the program reads are resolved from the
    scope and placed on the serving device once, at construction, with the
    fold windows' filters and biases computed from them once.

The static-analyzer admission gate, telemetry counters, the hot-row
embedding cache and LoD requests are later slices; the cache raises
NotImplementedError.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import io as io_mod
from .. import quant as quant_mod
from ..executor import (CUDAPlace, Executor, Scope, global_scope, scope_guard,
                        to_numpy, _to_device)
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


class ServingEngine:
    """Bucketed serving for one inference program. `infer(feed)` is the
    synchronous surface; `run_batch` runs one padded batch."""

    def __init__(self, model, feed_names: Optional[Sequence[str]] = None,
                 fetch_names: Optional[Sequence] = None, place=None,
                 scope=None, max_batch: int = DEFAULT_MAX_BATCH,
                 buckets: Optional[Sequence[int]] = None,
                 emb_cache_budget_bytes: Optional[int] = None,
                 emb_cache_tables: Optional[Dict[str, int]] = None,
                 quantize: Optional[str] = None):
        if quantize not in (None, "int8", "fp8"):
            raise ValueError(f"quantize must be 'int8' or 'fp8', got "
                             f"{quantize!r}")
        if emb_cache_budget_bytes is not None or emb_cache_tables:
            raise NotImplementedError(
                "the hot-row embedding cache is a later slice of the port")

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
        self._state: Dict[str, torch.Tensor] = {
            n: _to_device(self._scope.find_var(n), self.device)
            for n in self._prepared.state_names}
        self._prepared.fold_weights(self._state)

        self.cache_hits = 0
        self.cache_misses = 0
        self.bucket_runs: Dict[int, int] = {}

    # --- admission ----------------------------------------------------------
    def _admit(self, program, feed_names, fetch_names):
        """Training-op leak check (the JAX package's _admit minus the
        static-analyzer gate, which a later slice ports)."""
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

    # --- buckets ------------------------------------------------------------
    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    # --- execution ----------------------------------------------------------
    def run_batch(self, feed: Dict[str, np.ndarray],
                  valid_rows: Optional[int] = None) -> List[np.ndarray]:
        """Execute one batch: pad to the smallest admissible bucket, run it,
        slice the valid rows back out."""
        if self.closed:
            raise RuntimeError("ServingEngine is closed")
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
        with self._lock:
            padded = {name: torch.from_numpy(_pad_rows(a, bucket)).to(self.device)
                      for name, a in arrays.items()}
            if bucket in self.bucket_runs:
                self.cache_hits += 1
            else:
                self.cache_misses += 1
            fetch = self._prepared.run(padded, self._state)
            self.bucket_runs[bucket] = self.bucket_runs.get(bucket, 0) + 1
        return [to_numpy(f[:rows]) for f in fetch]

    def infer(self, feed: Dict[str, object]) -> List[np.ndarray]:
        """Synchronous inference on dense feeds, chunked when larger than
        the top bucket."""
        if self.closed:
            raise RuntimeError("ServingEngine is closed")
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

    # --- lifecycle ----------------------------------------------------------
    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    def close(self):
        """Drop the prepared program and resident device state; further
        calls raise."""
        with self._lock:
            self._state = {}
            self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
