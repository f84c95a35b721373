"""Executor: runs a program's global block op by op on a torch device (the
port's counterpart of paddle_tpu/executor.py).

The JAX package traces a whole block into one jitted XLA computation,
once per signature, with the state donated. The port interprets the
block: every op's lowering runs on torch tensors on the executor's
device, in program order, with the planned windows (ops/fusion.py: conv
-> batch_norm [-> act], fc_act, chain, optimizer buckets) lowered as one
unit at their anchor, and each temporary dropped after its last reader
(`liveness`). On a CUDA place that interpretation is captured once per
signature as a CUDA graph and replayed (`Executor.run`, `_graphed`): the
port's counterpart of the jitted, donated step. A training program's grad
and optimizer ops run like any other op; the optimizer's in-place outputs
(parameters, accumulators, batch-norm statistics) are persistable and go
back to the scope at the end of the run. Scope semantics follow the
reference (scope.h:38): persistable variables live in the scope across
runs; block temporaries vanish after the run. A LoDTensor feed
becomes a padded dense tensor plus its lengths, `<name>@SEQLEN` (and the
inner lengths `<name>@SEQLEN2` at LoD level 2), which ride along the step
as feeds of their own and reach the lowerings through `ctx.seq_len`;
each op's outputs inherit the lengths of its first sequence input unless
the lowering sets them (`propagate_seq_len`), and a fetched sequence
comes back packed, as the reference's LoDTensor. `run_steps` runs K steps
over a window of K batches in one call, with the scope written once at
the end (the JAX package's fused loop).

Places: `CUDAPlace` is the real card here (the JAX package made it an
alias of its TPU place). `Executor()` with no place runs on CUDAPlace(0),
or on CUDAPlace(local rank) in a torch.distributed process group (the
`LOCAL_RANK` a launcher sets, else the rank, modulo the cards visible, so
ranks sharing a card stay on it), and raises when there is no CUDA device:
it never carries on on the CPU unless the caller asks for `CPUPlace()`.
`TPUPlace` raises. A program's mesh (`program._mesh`, parallel/mesh.py)
reaches the lowerings as `ctx.mesh`. On a mesh of a process group a
program with a batch axis or sharded parameters runs SPMD
(parallel/spmd.py, `ctx.spmd`): each rank keeps its rows of the fed
batch, reductions over the batch all-reduce, parameter gradients are
all-reduced in the overlap plan's buckets, sharded state is gathered on
use, and a fetch comes back as the one-device run returns it. A step with
a collective staged through host memory (a gloo group of ranks on cards)
runs eager under the gate's reason `host_collective`; on an NCCL group the
collectives are posted under the step's CUDA graph capture, so a replay
runs them as graph nodes.

Every run publishes its step telemetry (the `executor_*` families, the
`run`, `run_window`, `compile` and `cache_miss` events, a `step` span with
tracing on; a capture is the compile, a replay of a signature the cache
hit) and calls the numeric-health plane where one of its parts is on
(`_Plane`): check_nan_inf (a per-op finite scan in an eager run, one
finiteness flag computed inside a graphed step and read with the fetches;
a NonFiniteError names the variable, the op the inspector's bisection
finds, and leaves the scope and the rng counter as before the step), the
inspector's probes (their vectors stacked into one fetch, recorded before
the write-back), dynamics (a sampled and a plain graph per signature),
trap_fp (every run eager with the scan), the benchmark flag (per-op times
in eager runs), the op recorder and the flight recorder; a run that raises
writes its crash report (inspector.notify_crash).
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
import weakref
import zlib
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from . import dynamics as dynamics_mod
from . import flags as flags_mod
from . import inspector as inspector_mod
from . import memory as memory_mod
from . import quant, telemetry
from . import tracing as tracing_mod
from .errors import EnforceNotMet, NonFiniteError
from .framework.desc import BlockRef, BlocksRef
from .framework.framework import (Program, Variable, default_main_program,
                                  op_external_reads)
from .ops import fusion as fusion_mod
from .ops import registry, sparse_ops
from .ops.common import (SEQLEN2_SUFFIX, SEQLEN_SUFFIX, SelectedRowsVal,
                         maybe_dense, propagate_seq_len, seq_carrier)
from .parallel import spmd as spmd_mod

__all__ = ["CPUPlace", "CUDAPlace", "TPUPlace", "place_device", "Scope",
           "global_scope", "scope_guard", "Executor", "COUNTERS", "LoDTensor",
           "SEQLEN_SUFFIX", "SEQLEN2_SUFFIX", "pack_to_padded",
           "padded_to_pack"]


# ---------------------------------------------------------------------------
# Places (reference: platform/place.h:24,34)
# ---------------------------------------------------------------------------

class Place:
    def __init__(self, device_id: int = 0):
        self.device_id = device_id

    def __eq__(self, other):
        return type(self) is type(other) and self.device_id == other.device_id

    def __hash__(self):
        return hash((type(self).__name__, self.device_id))

    def __repr__(self):
        return f"{type(self).__name__}({self.device_id})"


class CPUPlace(Place):
    pass


class CUDAPlace(Place):
    """An NVIDIA GPU, by CUDA device index."""


class TPUPlace(Place):
    """The JAX package's accelerator place; the port has no TPU backend."""

    def __init__(self, device_id: int = 0):
        raise ValueError("TPUPlace belongs to the JAX package (paddle_tpu); "
                         "paddle_tpu_torch runs on CUDAPlace or CPUPlace")


def place_device(place: Place) -> torch.device:
    """Resolve a Place to a torch.device; a CUDA place with no CUDA device
    raises rather than falling back to the CPU."""
    if isinstance(place, CPUPlace):
        return torch.device("cpu")
    if isinstance(place, CUDAPlace):
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{place!r} asked for, but torch sees no CUDA device; pass "
                f"CPUPlace() to run on the CPU")
        if place.device_id >= torch.cuda.device_count():
            raise RuntimeError(f"{place!r} asked for, but only "
                               f"{torch.cuda.device_count()} CUDA devices exist")
        return torch.device("cuda", place.device_id)
    raise TypeError(f"not a place: {place!r}")


# ---------------------------------------------------------------------------
# Runtime values: LoDTensor and the padded-LoD convention
# ---------------------------------------------------------------------------

class LoDTensor:
    """A tensor and its level-of-detail sequence offsets (reference
    framework/lod_tensor.h:55,107; JAX executor.py:104). The array holds
    the sequences packed, [sum_len, ...]; the LoD records each level's
    offsets."""

    def __init__(self, array=None, lod: Optional[List[List[int]]] = None):
        self._array = array
        self.lod = lod or []

    def set(self, array, place=None):
        self._array = np.asarray(array)

    def set_lod(self, lod):
        self.lod = lod

    def array(self):
        return self._array

    def __array__(self, dtype=None, copy=None):
        a = np.asarray(self._array)
        return a.astype(dtype) if dtype is not None else a

    @property
    def shape(self):
        return tuple(self._array.shape)

    def recursive_sequence_lengths(self):
        return [[b - a for a, b in zip(lvl[:-1], lvl[1:])] for lvl in self.lod]


def _bucket_len(n: int) -> int:
    """A max sequence length rounded up to its bucket (JAX executor.py:393):
    powers of two up to 64, multiples of 64 after, so a run of batches
    gives a few padded shapes (and graph signatures), not one per batch."""
    if n <= 8:
        return 8
    b = 8
    while b < n and b < 64:
        b *= 2
    return b if b >= n else ((n + 63) // 64) * 64


def pack_to_padded(flat: np.ndarray, lod: List[List[int]]):
    """Packed [sum_len, ...] rows + LoD offsets -> padded dense + lengths
    (JAX executor.py:405): level 1 gives ([batch, T, ...], lengths [batch],
    None); level 2 gives ([batch, S, T, ...], outer lengths [batch], inner
    lengths [batch, S]). T and S are `_bucket_len` of the longest."""
    if len(lod) not in (1, 2):
        raise ValueError(f"lod_level must be 1 or 2, got a LoD of "
                         f"{len(lod)} levels")
    if len(lod) == 1:
        offs = np.asarray(lod[0], dtype=np.int64)
        lengths = np.diff(offs).astype(np.int32)
        bsz = len(lengths)
        t = _bucket_len(int(lengths.max()) if bsz else 1)
        padded = np.zeros((bsz, t) + tuple(flat.shape[1:]), dtype=flat.dtype)
        if bsz and len(flat):
            batch_idx = np.repeat(np.arange(bsz), lengths)
            time_idx = np.arange(offs[-1]) - np.repeat(offs[:-1], lengths)
            padded[batch_idx, time_idx] = flat[: offs[-1]]
        return padded, lengths, None
    outer, inner = lod
    outer = np.asarray(outer, dtype=np.int64)
    inner = np.asarray(inner, dtype=np.int64)
    outer_lens = np.diff(outer).astype(np.int32)
    inner_lens_flat = np.diff(inner).astype(np.int32)
    bsz = len(outer_lens)
    s_max = _bucket_len(int(outer_lens.max()) if bsz else 1)
    t_max = _bucket_len(int(inner_lens_flat.max())
                        if len(inner_lens_flat) else 1)
    padded = np.zeros((bsz, s_max, t_max) + tuple(flat.shape[1:]),
                      dtype=flat.dtype)
    inner_lens = np.zeros((bsz, s_max), dtype=np.int32)
    if bsz and len(inner_lens_flat):
        n_seq = len(inner_lens_flat)
        seq_batch = np.repeat(np.arange(bsz), outer_lens)
        seq_pos = np.arange(n_seq) - np.repeat(outer[:-1], outer_lens)
        inner_lens[seq_batch, seq_pos] = inner_lens_flat
        total = int(inner[-1])
        if total:
            row_seq = np.repeat(np.arange(n_seq), inner_lens_flat)
            row_b = seq_batch[row_seq]
            row_s = seq_pos[row_seq]
            row_t = np.arange(total) - np.repeat(inner[:-1], inner_lens_flat)
            padded[row_b, row_s, row_t] = flat[:total]
    return padded, outer_lens, inner_lens


def padded_to_pack(padded: np.ndarray, lengths: np.ndarray,
                   inner_lengths: Optional[np.ndarray] = None):
    """The inverse of pack_to_padded (JAX executor.py:451): padded +
    lengths -> packed rows + LoD offsets; with inner_lengths the input is a
    nested [B, S, T, ...] batch and a 2-level LoD comes back."""
    lengths = np.asarray(lengths, dtype=np.int64)
    if inner_lengths is None:
        bsz = len(lengths)
        offs = np.concatenate([[0], np.cumsum(lengths)])
        if bsz == 0 or offs[-1] == 0:
            return padded[:0, 0], [offs.tolist()]
        batch_idx = np.repeat(np.arange(bsz), lengths)
        time_idx = np.arange(offs[-1]) - np.repeat(offs[:-1], lengths)
        return padded[batch_idx, time_idx], [offs.tolist()]
    inner_lengths = np.asarray(inner_lengths, dtype=np.int64)
    bsz = len(lengths)
    outer_offs = np.concatenate([[0], np.cumsum(lengths)])
    n_seq = int(outer_offs[-1])
    if n_seq == 0:
        return padded[:0, 0, 0], [outer_offs.tolist(), [0]]
    seq_batch = np.repeat(np.arange(bsz), lengths)
    seq_pos = np.arange(n_seq) - np.repeat(outer_offs[:-1], lengths)
    seq_lens = inner_lengths[seq_batch, seq_pos]
    inner_offs = np.concatenate([[0], np.cumsum(seq_lens)])
    total = int(inner_offs[-1])
    if total == 0:
        return padded[:0, 0, 0], [outer_offs.tolist(), inner_offs.tolist()]
    row_seq = np.repeat(np.arange(n_seq), seq_lens)
    row_t = np.arange(total) - np.repeat(inner_offs[:-1], seq_lens)
    return (padded[seq_batch[row_seq], seq_pos[row_seq], row_t],
            [outer_offs.tolist(), inner_offs.tolist()])


def _unpack_lod(name: str, value, out: Dict[str, Any]):
    """Put feed or state `value` into `out` under `name`: a LoDTensor with
    a LoD as its padded array and lengths (JAX executor.py:1131-1170),
    anything else as it is."""
    if not isinstance(value, LoDTensor):
        out[name] = value
        return
    arr = value.array()
    arr = arr.cpu().numpy() if isinstance(arr, torch.Tensor) else np.asarray(arr)
    if value.lod:
        arr, lengths, inner = pack_to_padded(arr, value.lod)
        out[name + SEQLEN_SUFFIX] = lengths
        if inner is not None:
            out[name + SEQLEN2_SUFFIX] = inner
    out[name] = arr


def _repack(arr: np.ndarray, lens, inner, as_lod: bool):
    """A fetched padded sequence back in the reference's packed layout
    (JAX executor.py:1458): the packed rows, or with `as_lod` a LoDTensor
    of them. Lengths that do not fit the array (a fetch tagged by the
    default propagation but no longer [batch, T]) give None: the fetch is
    then returned as it is."""
    lens = np.asarray(lens)
    if arr.ndim < 2 or lens.shape[0] != arr.shape[0] or \
            (lens.size and lens.max() > arr.shape[1]):
        return None
    if inner is not None:
        inner = np.asarray(inner)
        if arr.ndim < 3 or inner.shape[:2] != arr.shape[:2] or \
                (inner.size and inner.max() > arr.shape[2]):
            inner = None
    packed, lod = padded_to_pack(arr, lens, inner)
    return LoDTensor(packed, lod) if as_lod else np.asarray(packed)


# ---------------------------------------------------------------------------
# Scope
# ---------------------------------------------------------------------------

class Scope:
    """name -> runtime value, with parent chain (reference scope.h:38)."""

    def __init__(self, parent: Optional["Scope"] = None):
        self.parent = parent
        self.vars: Dict[str, Any] = {}

    def set_var(self, name: str, value):
        self.vars[name] = value

    def find_var(self, name: str):
        s: Optional[Scope] = self
        while s is not None:
            if name in s.vars:
                return s.vars[name]
            s = s.parent
        return None

    def has_var(self, name: str) -> bool:
        s: Optional[Scope] = self
        while s is not None:
            if name in s.vars:
                return True
            s = s.parent
        return False


_scope_stack = [Scope()]


def global_scope() -> Scope:
    return _scope_stack[-1]


@contextlib.contextmanager
def scope_guard(scope: Scope):
    _scope_stack.append(scope)
    try:
        yield
    finally:
        _scope_stack.pop()


# ---------------------------------------------------------------------------
# Lowering context handed to op lowerings
# ---------------------------------------------------------------------------

class LoweringContext:
    def __init__(self, executor: "Executor", program: Program,
                 rng_counter: int):
        self.executor = executor
        self.program = program
        self.device = executor.device
        # mixed-precision compute dtype for matmul/conv (amp.py); None =
        # full precision. Read by ops.common.mxu_cast.
        self.amp_dtype = getattr(program, "_amp_dtype", None)
        self.amp_level = getattr(program, "_amp_level", "O1")
        # AMP O3's quantized compute ("int8") or None: read by the mul and
        # conv2d lowerings (quant.py), as JAX executor.py:212-214
        self.quant_mode = getattr(program, "_quant_mode", None)
        # the device mesh of a sequence-parallel op (ring attention), or None
        self.mesh = getattr(program, "_mesh", None)
        # the step's sharded-run state on a process group's mesh
        # (parallel/spmd.py), or None on the one-device path
        self.spmd = None
        # a serving program's fold constants (PreparedProgram.fold_weights)
        self.folds = None
        self._seed = program.random_seed or 12345
        self._rng_counter = rng_counter
        # set while a CUDA graph captures the step: the random ops' seeds
        # are then the executor's to set before each replay
        self.capturing = False
        # the environment of the op being lowered, and the lengths its
        # lowering sets for its outputs (None clears), read by
        # propagate_seq_len (JAX executor.py:216-221)
        self.env: Dict[str, Any] = {}
        self.seq_overrides: Dict[str, Any] = {}
        # the eager step's per-op finite scan (check_nan_inf, trap_fp) and
        # per-op timing (the benchmark flag), read by Executor._run_block
        self.scan = False
        self.bench = False

    def seq_len(self, name: str):
        """The valid lengths [batch] of padded sequence `name`, or None for
        a dense value (JAX executor.py:236): the `<name>@SEQLEN` tensor a
        LoD feed brought or an op set, on the device."""
        return self.env.get(name + SEQLEN_SUFFIX)

    def seq_len2(self, name: str):
        """The inner lengths [batch, S] of a nested (LoD level 2) `name`,
        or None."""
        return self.env.get(name + SEQLEN2_SUFFIX)

    def set_seq_len(self, name: str, lengths):
        self.seq_overrides[name] = lengths

    def set_seq_len2(self, name: str, lengths):
        self.seq_overrides[name + SEQLEN2_SUFFIX] = lengths

    def run_block(self, block_idx: int, env: Dict[str, Any]) -> Dict[str, Any]:
        """Run sub-block `block_idx`'s ops on `env`, each through
        `Executor._exec_op` (so their outputs' lengths propagate), and
        return `env` (JAX executor.py:271): the control-flow lowerings'
        loop and branch bodies. A sub-block's env is a copy of the outer
        one, `@SEQLEN` entries included, plus the carry; nothing is dropped
        inside it. The env and the length overrides of the op that called
        it are restored after."""
        saved = self.env, self.seq_overrides
        try:
            for op in self.program.block(block_idx).ops:
                self.executor._exec_op(self, op, env)
        finally:
            self.env, self.seq_overrides = saved
        return env

    def host_sync(self, op_type: str):
        """Count one read of a device value to the host by a `while`
        condition, a `conditional_block` predicate or a host metric
        (detection_map's inputs) (`COUNTERS.host_syncs`), the only
        lowerings allowed one."""
        COUNTERS.host_syncs[op_type] = COUNTERS.host_syncs.get(op_type, 0) + 1

    def generator(self, op) -> torch.Generator:
        """The torch.Generator of one random op: the executor's own for the
        op's first output name (`Executor._generator`), seeded from the
        op's `seed` attr (or the program seed and the run counter) and that
        name, like the JAX package's per-op key (executor.py next_rng): the
        same program and run draw the same numbers, and step i and step
        i+1 different ones. While a CUDA graph captures the step the seed
        is left alone: the generator is registered with the graph, and the
        executor seeds it before each replay (`Executor._seed_random`),
        which hands the replay its seed and offset on the device."""
        name = random_ident(op)
        g = self.executor._generator(name)
        if not self.capturing:
            seed_generator(g, op, name, self._seed, self._rng_counter)
        return g


def random_ident(op) -> str:
    outs = op.desc.output_arg_names()
    return outs[0] if outs else ""


def seed_generator(g: torch.Generator, op, name: str, program_seed: int,
                   rng_counter: int):
    """Seed `g` for one draw of random op `op` at run `rng_counter`. CUDA's
    Philox takes all 64 bits of (base, ident); a CPU generator (mt19937)
    keeps only the low 32 of its seed, so there the 64 bits are mixed and
    folded into 32 first (`fold_seed`), and the seed and counter still
    count."""
    seed = int(op.attr("seed", 0) or 0)
    ident = zlib.crc32(name.encode("utf-8")) if name else 0
    base = seed if seed else (program_seed * 1_000_003 + rng_counter)
    key = ((base & 0xFFFFFFFF) << 32 | ident) & (2 ** 63 - 1)
    g.manual_seed(key if g.device.type == "cuda" else fold_seed(key))


_M64 = 2 ** 64 - 1


def fold_seed(key: int) -> int:
    """64 bits -> 32: splitmix64's finalizer, then the high half xor-folded
    into the low, so every input bit moves the 32 a CPU generator keeps."""
    x = key & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    x ^= x >> 31
    return (x ^ (x >> 32)) & 0xFFFFFFFF


def _to_device(value, device: torch.device) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.to(device)
    a = np.asarray(value)
    if not a.flags.writeable:
        # a sparse apply updates its table in place: never in memory the
        # caller did not hand over for writing
        a = a.copy()
    return torch.as_tensor(a, device=device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A fetched tensor as numpy; bf16 comes back as float32 (numpy has no
    bfloat16), which is exact."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _normalize_window(feed_window, steps):
    """-> ({name: [K, ...] array or tensor} or None, the per-step feed
    dicts or None, K), with the JAX package's checks and messages
    (executor.py:755-799). A list of per-step feed dicts is stacked on the
    host, unless one holds a LoDTensor with a LoD: then the window is
    left per step (stacked None), for run_steps to run one run() a step;
    a dict whose entries carry a leading [K] axis
    (DoubleBufferedFeeder.next_window, DataFeeder.feed_window) passes
    through, and raises if one is a LoDTensor."""
    if isinstance(feed_window, dict):
        if not feed_window:
            raise ValueError("feed_window dict is empty")
        ks = set()
        for n, v in feed_window.items():
            if isinstance(v, LoDTensor):
                raise ValueError(
                    f"pre-stacked feed_window entry '{n}' is a "
                    f"LoDTensor; pass a list of per-step feed dicts "
                    f"so the executor can fall back per-step")
            shape = getattr(v, "shape", None)
            if not shape:
                raise ValueError(
                    f"feed_window entry '{n}' has no leading steps "
                    f"axis (shape {shape})")
            ks.add(int(shape[0]))
        if len(ks) != 1:
            raise ValueError(
                f"feed_window leading dims disagree: {sorted(ks)}")
        k = ks.pop()
        if steps is not None and steps != k:
            raise ValueError(
                f"steps={steps} but feed_window leading dim is {k}")
        return dict(feed_window), None, k
    per_step = list(feed_window)
    if not per_step:
        raise ValueError("feed_window list is empty")
    if steps is not None and steps != len(per_step):
        raise ValueError(
            f"steps={steps} but feed_window has {len(per_step)} entries")
    names = set(per_step[0])
    if any(set(f) != names for f in per_step[1:]):
        raise ValueError("per-step feed dicts must share the same keys")
    if any(isinstance(f[n], LoDTensor) and f[n].lod
           for f in per_step for n in names):
        return None, per_step, len(per_step)
    stacked = {n: torch.stack([v if isinstance(v, torch.Tensor) else
                               torch.as_tensor(np.asarray(v))
                               for v in (f[n] for f in per_step)])
               for n in sorted(names)}
    return stacked, None, len(per_step)


@dataclass
class Counters:
    """`windows`: run_steps calls that finished; `steps`: the steps they
    ran (K a window). The graphed steps (`Executor.run`): `warmups`, the
    eager first step of a signature; `captures`; `replays`; `copied_in`,
    state tensors copied into their static buffers before a replay (the
    caller replaced or changed the scope's tensor, or another scope or
    signature left the buffer another value); `evicted`, graphs dropped
    past GRAPH_CACHE_SIZE; `eager`, the steps that ran eager, by the
    gate's reason (`graph_gate`); `window_fallbacks`, run_steps windows
    served one run() a step, by reason (the JAX package's
    executor_window_fallback_total: `lod_feed`); `host_syncs`, the device
    values read to the host by op type (a `while` condition each
    iteration, a `conditional_block` predicate each run: the lowerings
    that decide their path on the host; detection_map's inputs each run). A replay runs no Python: the
    kernel wrappers' launch counters do not move."""
    windows: int = 0
    steps: int = 0
    warmups: int = 0
    captures: int = 0
    replays: int = 0
    copied_in: int = 0
    evicted: int = 0
    eager: Dict[str, int] = field(default_factory=dict)
    window_fallbacks: Dict[str, int] = field(default_factory=dict)
    host_syncs: Dict[str, int] = field(default_factory=dict)

    def reset(self):
        self.windows = self.steps = 0
        self.warmups = self.captures = self.replays = 0
        self.copied_in = self.evicted = 0
        self.eager.clear()
        self.window_fallbacks.clear()
        self.host_syncs.clear()


COUNTERS = Counters()

# ops that draw from ctx.generator. Each op's generator is registered with
# every graph that draws from it and seeded before each replay, so a replay
# draws what the eager step of the same run counter draws
RANDOM_OPS = frozenset({"uniform_random", "gaussian_random", "dropout", "nce",
                        "uniform_random_batch_size_like",
                        "gaussian_random_batch_size_like"})

# ops that decide their path on the host (a `while` condition, a
# `conditional_block` predicate) or act there (`print`): a block holding one
# runs eager under the gate's reason "control_flow", since a replay would
# neither re-read the condition nor print. `rnn` is not among them: its trip
# count is the padded length, static per signature, and its masks come from
# the lengths on the device
HOST_CONTROL_OPS = frozenset({"while", "while_grad", "conditional_block",
                              "conditional_block_grad", "print"})

# ops that read or write a file on the host (ops/misc_ops.py): a block
# holding one runs eager under the gate's reason "host_io", since a replay
# would skip the write, or return the file's contents at capture
HOST_IO_OPS = frozenset({"save", "save_combine", "load", "load_combine"})

# ops that compute on the host from device values they read there
# (detection_map, the JAX package's pure_callback): a block holding one runs
# eager under the gate's reason "host_metric", since a replay would return
# the value computed at capture
HOST_METRIC_OPS = frozenset({"detection_map"})


# opt-in static verification (paddle_tpu_torch.analysis; JAX
# executor.py:293-297): error-severity diagnostics raise
# errors.ProgramVerifyError before a program's first op, pointing at the
# op's creation site instead of a lowering's traceback
_VERIFY = os.environ.get("PADDLE_TPU_VERIFY", "0") == "1"

# PADDLE_TPU_EAGER=1 as the process started (the eager flag; JAX
# executor.py:284): a run whose caller leaves use_jit unset runs eager
_EAGER = flags_mod.snapshot("eager")

# PADDLE_TPU_CHECK_NAN_INF as the process started; the live flag is read
# too, at every run (JAX executor.py:285, :1128)
_CHECK_NAN_INF = flags_mod.snapshot("check_nan_inf")

# FP trapping (reference TrainerMain.cpp:49 feenableexcept; the JAX package
# turns on jax_debug_nans, executor.py:356-358), read at import: every run
# goes eager (the gate's reason "trap_fp") with the per-op finite scan, so
# the op that made a NaN or an Inf raises NonFiniteError
_TRAP_FP = flags_mod.snapshot("trap_fp")

# FLAGS_benchmark (reference executor.cc:321; JAX executor.py:1645), read
# at import: an eager run waits for the device after every op and window
# and logs its wall time at vlog level 1
_BENCHMARK = flags_mod.snapshot("benchmark")

# the op recorder (JAX executor.py:364-373): every op type a run lowers
# lands in _RECORDED_OPS; PADDLE_TPU_RECORD_OPS, read at import, also
# appends each new one to a file, for reports across processes
_RECORD_OPS_PATH = flags_mod.snapshot("record_ops") or None
_RECORDED_OPS = set()


def _record_op(op_type: str):
    if op_type not in _RECORDED_OPS:
        _RECORDED_OPS.add(op_type)
        if _RECORD_OPS_PATH:
            with open(_RECORD_OPS_PATH, "a") as f:
                f.write(op_type + "\n")


def vlog(level: int, msg: str):
    """glog-style leveled logging to stderr (reference VLOG; JAX
    executor.py:345): on where the vlog flag, read at every call
    (PADDLE_TPU_VLOG=<level> or flags.set("vlog", n)), is `level` or
    more."""
    if level <= int(flags_mod.get("vlog") or 0):
        import datetime
        ts = datetime.datetime.now().strftime("%H:%M:%S.%f")[:-3]
        print(f"V{level} {ts} paddle_tpu_torch] {msg}", file=sys.stderr)


def telemetry_fetch_enabled() -> bool:
    """PADDLE_TPU_TELEMETRY_FETCH (default on; JAX executor.py:290), read
    at every run: the program's `_telemetry_fetch_extra` marks (the clip
    pass's global norm) are fetched beside the caller's list and published
    as gauges, a read of the device each step; 0 skips them."""
    return flags_mod.env("PADDLE_TPU_TELEMETRY_FETCH") in (None, "1")


# ops that take a SelectedRows input as it is (executor.py:384): the sparse
# sum, the optimizers with a sparse apply and their fused buckets. Any other
# op densifies it at its boundary, counted as `sparse_unaware_op`.
_SPARSE_AWARE_OPS = frozenset(
    {"sum"} | set(sparse_ops.SPARSE_APPLY_OPS)
    | {"fused_sparse_" + t for t in sparse_ops.SPARSE_APPLY_OPS})


def _fetched(v):
    """A fetch as a dense tensor: a SelectedRows value densifies, counted."""
    return maybe_dense(v, count_as="fetch")


def _lengths_of(env, names) -> Dict[str, torch.Tensor]:
    """The lengths tensors in `env` of the sequences `names`, by
    `<name>@SEQLEN` and `<name>@SEQLEN2`."""
    return {n + sfx: env[n + sfx] for n in names
            for sfx in (SEQLEN_SUFFIX, SEQLEN2_SUFFIX) if n + sfx in env}


def _accepts_sparse_slots(reader) -> bool:
    """Whether a run_steps reader's next_window takes `sparse_slots`."""
    import inspect
    try:
        params = inspect.signature(reader.next_window).parameters
    except (TypeError, ValueError):
        return False
    return "sparse_slots" in params


def _sub_blocks(op) -> List[int]:
    """The indices of the blocks an op's attrs name."""
    idxs: List[int] = []
    for a in op.desc.attrs.values():
        if isinstance(a, BlockRef):
            idxs.append(a.idx)
        elif isinstance(a, BlocksRef):
            idxs.extend(a.idxs)
    return idxs


def _block_reads_writes(program, block, reads, writes, produced,
                        types):
    """Into `reads` the names `block` reads before any op of it (or of the
    blocks around it) produced them, into `writes` every name it writes,
    into `types` its op types, recursing into sub-blocks (JAX
    executor.py:1529)."""
    for op in block.ops:
        if op.type in ("feed", "fetch"):
            continue
        types.add(op.type)
        reads.update(n for n in op.input_arg_names if n not in produced)
        for si in _sub_blocks(op):
            _block_reads_writes(program, program.block(si), reads, writes,
                                set(produced), types)
        produced.update(op.output_arg_names)
        writes.update(op.output_arg_names)


def liveness(ops, groups) -> Dict[int, List[str]]:
    """position -> the names whose last reader or writer runs there, for
    `_run_block` to drop after it. A window's members all count at its end
    index (it runs as one unit), so what a window reads lives until it
    has run. An op with a sub-block (`while`, `conditional_block`, `rnn`
    and their grads) counts as a reader of everything its sub-blocks read
    from outside them, so no value a loop body still reads goes before the
    loop has run. Only op arguments are dropped: the lengths tensors
    (`<name>@SEQLEN`, a few bytes each) stay for the whole step, for any
    later op, grad op or fetch of the sequence to read."""
    last: Dict[str, int] = {}
    groups = groups or {}
    i = 0
    while i < len(ops):
        g = groups.get(i)
        members, pos = (g.members, g.end - 1) if g is not None else \
            ((ops[i],), i)
        for m in members:
            if m.type in ("feed", "fetch"):
                continue
            for n in m.input_arg_names + m.output_arg_names:
                last[n] = pos
            if _sub_blocks(m):
                for n in op_external_reads(m.block.program, m):
                    last[n] = pos
        i = pos + 1
    drops: Dict[int, List[str]] = {}
    for n, pos in last.items():
        drops.setdefault(pos, []).append(n)
    return drops


# at most this many step signatures keep a graph on one Executor; the one
# run least recently goes first
GRAPH_CACHE_SIZE = 8


def capture_graph(body, pool=None, keep=False, generators=()):
    """A CUDA graph of what `body()` launches on the current device, its
    memory drawn from `pool` (another graph's, `graph.pool()`) when given.
    Only this thread's calls are checked during the capture, so a feeder's
    copy thread goes on beside it. With `keep` the graph keeps its nodes
    past instantiation, for `graph.debug_dump` to list them. Each of
    `generators` is registered with the graph before the capture: its
    draws then read the seed and offset the generator holds when a replay
    starts, and a replay advances its offset as the eager draws would.
    The capture's seconds count as compile time
    (telemetry.note_compile)."""
    t0 = time.perf_counter()
    graph = torch.cuda.CUDAGraph(keep_graph=keep)
    for g in generators:
        graph.register_generator_state(g)
    cm = torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local")
    cm.__enter__()
    try:
        body()
    except BaseException:
        # a body that raised (an allocation past the card's memory) still
        # ends the capture and leaves the capture stream, even where ending
        # the capture fails too; the partial graph and its pool go with
        # the caller's last reference to them
        try:
            cm.__exit__(None, None, None)
        except Exception:
            cm.stream_ctx.__exit__(None, None, None)
        raise
    cm.__exit__(None, None, None)
    if keep:
        graph.instantiate()
    telemetry.note_compile("graph_capture", time.perf_counter() - t0)
    return graph


def _identities(state, names) -> tuple:
    """The identities of the state tensors named: the tensors a graph that
    updates them in place is bound to."""
    return tuple(id(state[n]) for n in sorted(names))


def _copies(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """New tensors holding `tensors`' values, filled by one multi-tensor
    copy: a clone each would cost a launch each, hundreds a step."""
    out = [torch.empty_like(t) for t in tensors]
    if out:
        torch._foreach_copy_(out, tensors)
    return out


class _StateBuffer:
    """The static buffer of one state variable at one shape and dtype,
    shared by every graph of an Executor that reads it, and the scope
    tensor whose value it holds (`src`, a weak reference, at version
    `ver`). A replay copies a scope tensor in unless the buffer holds it
    unchanged; a replay that writes the variable leaves the buffer holding
    only its own value until the scope is handed a copy of it."""

    __slots__ = ("t", "src", "ver")

    def __init__(self, t: torch.Tensor):
        self.t = t
        self.src = None
        self.ver = -1

    def holds(self, v: torch.Tensor) -> bool:
        return v is self.t or (self.src is not None and self.src() is v
                               and v._version == self.ver)

    def source(self, v: Optional[torch.Tensor]):
        self.src = None if v is None else weakref.ref(v)
        self.ver = -1 if v is None else v._version


class _GraphedStep:
    """One signature's step as a captured CUDA graph (the counterpart of
    the reference's jitted, donated step, executor.py:1959-1994): static
    buffers for the feeds, the state buffers it reads, the state it
    writes (`persist`), the state it updates in place (`inplace`: the
    tables and accumulators of sparse applies, whose buffers are the
    scope's own tensors), the graph, the fetches and the other persistable
    outputs it writes into the shared pool."""

    def __init__(self):
        self.graph = None
        self.feeds: Dict[str, torch.Tensor] = {}
        self.state: Dict[str, _StateBuffer] = {}
        self.persist: List[str] = []
        self.inplace: set = set()
        self.fetches: List[torch.Tensor] = []
        self.lens: Dict[str, torch.Tensor] = {}
        self.written: Dict[str, torch.Tensor] = {}
        # the numeric-health plane's: the finiteness flag and the dynamics
        # rows the graph writes, its static pre-step copies of the
        # in-place state, and the compile cause and feed signature its
        # warm-up noted (telemetry)
        self.flag: Optional[torch.Tensor] = None
        self.rows: Optional[torch.Tensor] = None
        self.snap: Dict[str, torch.Tensor] = {}
        self.cause = "first_compile"
        self.sig = None


class BucketGraph:
    """One serving bucket's run as a captured CUDA graph (the counterpart
    of the reference's `jit(fn).lower(avals).compile()` per bucket): the
    static feed buffers it reads, the graph, and the fetches it writes
    into its memory pool. `replay()` reruns the captured launches on
    whatever the feed buffers hold; the fetches are valid until the next
    replay of any graph sharing the pool. `staging` is left to the caller:
    the serving engine keeps there the pinned host buffers of the feeds'
    shapes that it writes requests into, so they go with the graph."""

    def __init__(self, feeds: Dict[str, torch.Tensor], graph,
                 fetches: List[torch.Tensor]):
        self.feeds = feeds
        self.graph = graph
        self.fetches = fetches
        self.staging: Optional[Dict[str, torch.Tensor]] = None

    def replay(self) -> List[torch.Tensor]:
        self.graph.replay()
        return self.fetches


class PreparedProgram:
    """One inference program bound to its state names and fusion plan: the
    serving engine's per-bucket "executable" (Executor.prepare_serving).
    `run` interprets it eagerly; `capture` makes a bucket's CUDA graph."""

    def __init__(self, executor: "Executor", program: Program,
                 feed_names: List[str], fetch_names: List[str],
                 state_names: List[str], persist_out: List[str]):
        self.executor = executor
        self.program = program
        self.feed_names = feed_names
        self.fetch_names = fetch_names
        self.state_names = state_names
        self.persist_out = persist_out
        self.groups = fusion_mod.plan(program)
        self.drops = liveness(program.global_block().ops, self.groups)
        self.protected = set(fetch_names) | set(persist_out)
        self.keep = self.protected | set(state_names)
        self.folds = None

    def fold_weights(self, state: Dict[str, torch.Tensor]):
        """Compute every fold window's filter, channel bias and, under O3,
        int8 filter once from the resident `state`, so no request repeats
        them (fusion.fold_constants)."""
        ctx = LoweringContext(self.executor, self.program, 0)
        self.folds = fusion_mod.fold_constants(ctx, self.groups, state)

    def run(self, feed: Dict[str, torch.Tensor],
            state: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
        """One eager run: the fetches. A run that runs the card out of
        memory raises errors.OOMError."""
        env = self._env_after(feed, state)
        return [env[n] for n in self.fetch_names]

    def _env_after(self, feed, state, capturing=False) -> Dict[str, Any]:
        """The environment after one eager run: fetches, persistable
        outputs and state. A run that fails has its environment pinned on
        the exception for OOM forensics; outside a capture an OOM is
        raised as errors.OOMError here (a capture's, once the capture has
        ended)."""
        env = dict(state)
        env.update(feed)
        ctx = LoweringContext(self.executor, self.program, 0)
        ctx.folds = self.folds
        try:
            self.executor._run_block(ctx, self.program, env, self.groups,
                                     self.protected, self.drops, self.keep)
        except Exception as e:
            e.__dict__["step_env"] = env
            if not capturing:
                self.executor._raise_oom(self.program, e, feed, state)
            raise
        return env

    def capture(self, feeds: Dict[str, torch.Tensor],
                state: Dict[str, torch.Tensor], pool=None) -> BucketGraph:
        """Warm up and capture one bucket: `run` once eagerly on `feeds`
        (the caller's static buffers, already holding a request: lazy
        inits, cuBLAS's workspace and the kernels' plans happen here), then
        the same `run` captured as a CUDA graph into `pool` (another
        graph's `graph.pool()`, when given). The state and the fold
        constants are read in place, so a served program must write no
        persistable: each persistable output of the warm-up must be the
        state tensor itself (is_test batch_norm passes its running
        statistics through as MeanOut/VarianceOut), or this raises. A
        capture that fails raises; nothing runs eager in its place."""
        env = self._env_after(feeds, state)
        written = [n for n in self.persist_out
                   if n in env and env[n] is not state.get(n)]
        if written:
            raise RuntimeError(
                f"a served program writes persistables {written}; its bucket "
                f"graph reads the resident state in place")
        fetches: List[torch.Tensor] = []

        def body():
            env = self._env_after(feeds, state, capturing=True)
            fetches[:] = [env[n] for n in self.fetch_names]

        try:
            graph = capture_graph(body, pool)
        except Exception as e:
            self.executor._raise_oom(self.program, e, feeds, state)
            raise RuntimeError(
                f"CUDA graph capture of a serving bucket "
                f"({ {n: tuple(v.shape) for n, v in feeds.items()} }) "
                f"failed ({type(e).__name__}: {e})") from e
        return BucketGraph(feeds, graph, fetches)


# the windows that lower their members through Executor._exec_op, which
# classifies each member's outputs for the sharded run itself
_MEMBER_WINDOWS = ("fc_act", "chain", "opt_bucket")


def _spmd_for(seed, env):
    """The step's sharded-run state for `env` (its feeds already cut), or
    None on the one-device path."""
    if seed is None:
        return None
    st, marks, sharded = seed
    sp = spmd_mod.Spmd(st, sharded, marks)
    sp.begin(env)
    return sp


def _spmd_outputs(spmd, env, fetch_names, persist_out):
    """A sharded step's (fetches as one device returns them, persistable
    outputs as the scope keeps them, the fetched sequences' lengths), in
    one order on every rank; every posted bucket waited on."""
    fetch = [_fetched(spmd.fetch(n, env)) for n in fetch_names]
    written = {n: spmd.persist(n, env) for n in persist_out if n in env}
    spmd.finish(env)
    lens = spmd.lengths(_lengths_of(env, list(fetch_names)
                                    + list(persist_out)))
    return fetch, written, lens


def default_place() -> Place:
    """CUDAPlace(0) in one process; in a process group, the card of this
    rank on its host (its local rank modulo the cards visible: ranks that
    outnumber the cards share them)."""
    if not dist.is_initialized():
        return CUDAPlace(0)
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return CUDAPlace(local % n if n else local)


def _names(fetch_list) -> List[str]:
    return [v.name if isinstance(v, Variable) else str(v)
            for v in (fetch_list or [])]


# ---------------------------------------------------------------------------
# The numeric-health plane (inspector.py, dynamics.py) inside a step
# ---------------------------------------------------------------------------

def dtype_name(dtype) -> str:
    """A torch dtype by its numpy name ("float32", "bfloat16")."""
    return str(dtype).replace("torch.", "")


def finite_flag(tensors) -> Optional[torch.Tensor]:
    """One bool tensor: every floating tensor of `tensors` finite (the JAX
    package's _finite_all, executor.py:545-552), or None when none is
    floating. Computed on the device as max |x| per tensor
    (torch._foreach_norm with ord inf, one call a dtype; NaN propagates
    through the max), never from an l2 norm, whose squares overflow on a
    finite tensor."""
    groups: Dict[Any, List[torch.Tensor]] = {}
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.is_floating_point() and \
                t.numel():
            groups.setdefault(t.dtype, []).append(t)
    flags = [torch.stack(torch._foreach_norm(ts, float("inf"))).isfinite()
             .all() for ts in groups.values()]
    if not flags:
        return None
    return flags[0] if len(flags) == 1 else torch.stack(flags).all()


def _stack_probes(fetches, n):
    """The fetch list with its last `n` entries, the probe vectors,
    stacked into one [n, 8] tensor."""
    return list(fetches[:-n]) + [torch.stack(list(fetches[-n:]))]


def _nonfinite(v) -> bool:
    """Whether one value holds a NaN or an Inf (a SelectedRows value by its
    rows' values); a read of the device."""
    if isinstance(v, SelectedRowsVal):
        v = v.values
    if not isinstance(v, torch.Tensor) or not v.is_floating_point():
        return False
    return not bool(torch.isfinite(v).all())


def _scan_outputs(ops, env):
    """The eager per-op finite scan (reference FLAGS_check_nan_inf,
    executor.cc:325; JAX executor.py:2109-2121): every output of `ops`
    (one op, or a window's members in order) still in `env` read for NaN
    and Inf; the first one found raises NonFiniteError naming it and its
    op. tensor_stats outputs are exempt (their counts describe other
    tensors)."""
    for op in ops:
        if op.type in ("tensor_stats", "feed", "fetch"):
            continue
        for name in op.output_arg_names:
            v = env.get(name)
            if v is not None and _nonfinite(v):
                t = v.values if isinstance(v, SelectedRowsVal) else v
                raise NonFiniteError(
                    f"NaN/Inf in output '{name}' of op {op.type}",
                    var_name=name, op_type=op.type,
                    dtype=dtype_name(t.dtype))


class _Plane:
    """What the numeric-health plane asks of one step, and what the step
    hands back. `check`: compute the finiteness flag of the fetches (less
    the probe vectors, `exclude`) and the persistable outputs inside the
    step (a graphed step's check_nan_inf); `scan`: the per-op finite scan
    (an eager step's check_nan_inf, or trap_fp); `dyn`: the dynamics plan
    and `sample`, whether this step samples; `restore`: a step that raises
    must leave the scope as it was. The pre-step copy (`snap`, by name)
    covers the state the step updates in place, where the scope's tensor
    is the step's own (a sparse apply's table and accumulators): restored
    from it on failure, and the W_old of a sampled step. `flag` and `rows`
    come back from the step. `token` is the plane's part of a graph key:
    a checked, a sampled and a plain step are graphs of their own."""

    __slots__ = ("check", "scan", "exclude", "dyn", "sample", "restore",
                 "token", "flag", "rows", "snap")

    def __init__(self, check, scan, exclude, dyn, sample, restore):
        self.check = check
        self.scan = scan
        # the probe vectors, the fetch list's tail: stacked into one
        # [probes, 8] fetch inside the step (one copy out, not one a probe)
        self.exclude = exclude
        self.dyn = dyn
        self.sample = sample
        self.restore = restore
        self.token = (check, dynamics_mod.cache_token_of(dyn), sample)
        self.flag = None
        self.rows = None
        self.snap: Dict[str, torch.Tensor] = {}


class _RunSeries:
    """One (program, place, mode)'s executor_* series, resolved once: a run
    then costs an increment each, no label lookup. The hit and optimizer
    series are made at their first increment, as the reference makes
    them. Stale once the registry is cleared (telemetry.reset), by its
    generation."""

    __slots__ = ("gen", "labels", "runs", "steps", "seconds", "last_step",
                 "_opt", "_hits")

    def __init__(self, prog_label, place_label, mode):
        self.gen = telemetry.registry().generation()
        self.labels = (prog_label, place_label)
        self.runs = telemetry.counter(
            "executor_runs_total", "Executor.run calls",
            labels=("program", "place", "mode")).labels(
                program=prog_label, place=place_label, mode=mode)
        self.steps = telemetry.counter(
            "executor_steps_total",
            "training/eval steps executed (a run_steps window counts K)",
            labels=("program", "place")).labels(
                program=prog_label, place=place_label)
        self.seconds = telemetry.histogram(
            "executor_run_seconds",
            "Executor.run wall seconds (dispatch-only: a graphed run "
            "returns when its fetches are copied out)",
            labels=("program", "mode")).labels(program=prog_label, mode=mode)
        self.last_step = telemetry.gauge(
            "executor_last_step_seconds",
            "wall seconds of the most recent executor step (per-step "
            "average for run_steps windows) less its compile seconds"
        ).labels()
        self._opt = self._hits = None

    def opt_steps(self):
        if self._opt is None:
            self._opt = telemetry.counter(
                "optimizer_steps_total",
                "runs of programs carrying optimizer-role ops",
                labels=("program",)).labels(program=self.labels[0])
        return self._opt

    def hits(self):
        if self._hits is None:
            self._hits = telemetry.counter(
                "executor_cache_hits_total",
                "runs served by an already-captured graph signature",
                labels=("program", "place")).labels(
                    program=self.labels[0], place=self.labels[1])
        return self._hits


class Executor:
    """Runs programs on a place. On a CUDA place a training or inference
    step whose block the gate admits (`graph_gate`) runs as a CUDA graph,
    one per signature (the reference's jit cache key, executor.py:1183:
    program and version, feed names, shapes and dtypes, fetch names, state
    names, shapes and dtypes, AMP dtype and level, the quant routing as
    `quant.cache_token` reads it now (mode, PADDLE_TPU_QUANT,
    PADDLE_TPU_QUANT_TOL; executor.py:1192), seed): the
    signature's first run is eager and warms up (Triton compiles, K6's
    barrier is zeroed, cuBLAS sets up its workspace), the second captures
    the step and replays it, later runs replay. The state lives in static
    buffers, one per variable, shape and dtype, shared by the Executor's
    graphs; the graph ends by copying each persistable output into its
    input's buffer (the reference donates the state), and the scope is
    handed a copy of each. A table and its accumulators that only sparse
    applies write (ops/sparse_ops.py, in place) are the exception: their
    buffers are the scope's own tensors, which every step, eager or
    graphed, advances in place, so no step copies or allocates a tensor
    of a table's size. Such a graph is bound to those tensors: their
    identities are in its key, so another scope, or a tensor the caller
    put in their place, warms up and captures a graph of its own. Any
    other scope tensor the buffer does not hold (the caller replaced or
    changed it, or another scope ran) is copied in before a replay;
    fetches come back as copies. The graphs share one memory pool,
    and at most GRAPH_CACHE_SIZE signatures keep theirs. The key also
    holds `sparse_ops.cache_token` (PADDLE_TPU_SPARSE_APPLY, the program's
    hot-row cache). `use_jit=False` runs eager, and so does a run
    that leaves it unset under PADDLE_TPU_EAGER=1. Either way an env entry
    goes once its last reader has run (`liveness`), unless it is fetched,
    a persistable output or state.

    A program with a hot-row embedding cache (parallel/emb_cache.py) has
    its cached ids remapped to slab slots on the host before they cross
    (`prepare_feed`), and records the end of each run for the cache's
    copy stream (`window_dispatched`).

    Memory (memory.py): each run or window is sampled into the hbm_*
    gauges (memory.on_run); a step that runs the card out of memory, eager
    or in a capture, raises errors.OOMError (`_raise_oom`);
    `measure_memory` and `static_memory_analysis` give a step's measured
    and estimated footprint. With PADDLE_TPU_VERIFY=1 a program is
    analysed once per version before its first op (`_maybe_verify`)."""

    def __init__(self, place: Optional[Place] = None):
        self.place = place if place is not None else default_place()
        self.device = place_device(self.place)
        self._analysis_cache: Dict[tuple, tuple] = {}
        self._plans: Dict[tuple, tuple] = {}
        self._graphs: "OrderedDict[tuple, _GraphedStep]" = OrderedDict()
        self._buffers: Dict[tuple, _StateBuffer] = {}
        # the names a graph signature's step updates in place, by key less
        # those tensors' identities (from its warm-up)
        self._inplace_names: Dict[tuple, set] = {}
        self._pool = None
        # one torch.Generator per random op (by its first output name), so
        # a graph that draws from it can register it (ctx.generator)
        self._generators: Dict[str, torch.Generator] = {}
        self._consts: Dict[tuple, torch.Tensor] = {}
        # (id, version) -> the program PADDLE_TPU_VERIFY admitted
        self._verified_programs: Dict[tuple, Program] = {}
        # the step telemetry: each graph family's feed signatures seen (the
        # reference's seen_sigs, for its compile and cache_miss events),
        # the resolved executor_* series, and the last step's route
        self._sigs: Dict[tuple, list] = {}
        self._facts: Dict[tuple, tuple] = {}
        self._series: Dict[tuple, _RunSeries] = {}
        self._route = ("eager", "n/a")
        self.place_label = (f"{type(self.place).__name__}:"
                            f"{self.place.device_id}")

    def constant(self, values, dtype: torch.dtype) -> torch.Tensor:
        """A host array (a static attr's values) on this Executor's device,
        copied once: a step's first run is eager and makes it, so a CUDA
        graph's capture, which may not copy from the host, finds it."""
        a = np.ascontiguousarray(values)
        key = (str(dtype), a.shape, a.dtype.str, a.tobytes())
        t = self._consts.get(key)
        if t is None:
            t = self._consts[key] = torch.as_tensor(
                a, device=self.device).to(dtype)
        return t

    def _generator(self, name: str) -> torch.Generator:
        g = self._generators.get(name)
        if g is None:
            g = self._generators[name] = torch.Generator(device=self.device)
        return g

    def _seed_random(self, program, rng_counter):
        """Seed the generator of every random op of the block for run
        `rng_counter`, as ctx.generator does on an eager step: a replay
        then draws what the eager step would."""
        seed = program.random_seed or 12345
        for op in self._block_plan(program)[2]:
            name = random_ident(op)
            seed_generator(self._generator(name), op, name, seed, rng_counter)

    # --- public API ---------------------------------------------------------
    def run(self, program: Optional[Program] = None, feed: Optional[Dict] = None,
            fetch_list: Optional[Sequence] = None, scope: Optional[Scope] = None,
            return_numpy: bool = True, use_program_cache: bool = True,
            use_jit: Optional[bool] = None):
        """Run the global block once: feeds in, fetches out, persistable
        outputs written back to `scope`. On a CUDA place an admitted block
        runs graphed (see the class), unless `use_jit` is False or
        `use_program_cache` is False. A run that raises writes the flight
        recorder's crash report first (inspector.notify_crash, a no-op
        unless the recorder is on)."""
        program = program if program is not None else default_main_program()
        try:
            return self._run_impl(program, feed, fetch_list, scope,
                                  return_numpy, use_program_cache, use_jit)
        except Exception as e:
            inspector_mod.notify_crash(self, program, e)
            raise

    def _run_impl(self, program, feed, fetch_list, scope, return_numpy,
                  use_program_cache, use_jit):
        scope = scope if scope is not None else global_scope()
        feed = self._pull_readers(program, feed)
        fetch_names = _names(fetch_list)
        self._maybe_verify(program, list(feed or {}), fetch_names)
        n_user = len(fetch_names)
        extra = self._telemetry_extra(program, fetch_names)
        fetch_names += [n for _, n in extra]
        # the inspector's probe vectors ride the fetch list; its own replay
        # programs (_inspector_internal) record and check nothing
        internal = getattr(program, "_inspector_internal", False)
        probe_sites = None if internal else \
            getattr(program, "_probe_sites", None)
        n_keep = len(fetch_names)
        if probe_sites:
            fetch_names += [s.stat_var for s in probe_sites]
        check = not internal and (_CHECK_NAN_INF
                                  or flags_mod.get("check_nan_inf"))
        user_feed = feed
        cache = getattr(program, "_emb_cache", None)
        if cache is not None and feed:
            feed = cache.prepare_feed(feed)
        raw: Dict[str, Any] = {}
        for n, v in (feed or {}).items():
            _unpack_lod(n, v, raw)
        feed_vals = {n: _to_device(v, self.device) for n, v in raw.items()}
        state_names = self._resolve_state(program, feed_vals, scope)
        persist_out = self._persistable_outputs(program)
        state = {}
        for n in state_names:
            v = scope.find_var(n)
            if isinstance(v, LoDTensor) and v.lod:
                # sequence state: padded, its lengths fed beside it
                lod_state: Dict[str, Any] = {}
                _unpack_lod(n, v, lod_state)
                v = lod_state.pop(n)
                feed_vals.update((k, _to_device(a, self.device))
                                 for k, a in lod_state.items())
            state[n] = _to_device(v, self.device)
        rng_counter = scope.find_var("__rng_counter__") or 0
        reason = self.graph_gate(program, feed_vals, use_jit,
                                 use_program_cache)
        plane = self._plane(program, reason, check, probe_sites,
                            rng_counter, internal)
        compile_before = telemetry.compile_seconds()
        t0 = time.perf_counter()
        try:
            fetch, written, lens = self._step(program, state, feed_vals,
                                              fetch_names, persist_out,
                                              rng_counter, reason,
                                              plane=plane)
        except NonFiniteError:
            self._restore(plane, state)     # the eager per-op scan raised
            raise
        except Exception as e:
            self._raise_oom(program, e, feed_vals, state)
            raise
        run_dt = time.perf_counter() - t0
        compile_s = telemetry.compile_seconds() - compile_before
        if cache is not None:
            cache.window_dispatched()
        prog_label = telemetry.program_label(program)
        if plane is not None:
            # before the commit: a step that went non-finite raises here,
            # the rng counter not advanced, the in-place state restored
            # (before an attribution replays from the scope)
            try:
                self._check_step(plane, program, fetch_names[:n_keep],
                                 fetch[:n_keep], written, user_feed,
                                 rng_counter, scope, prog_label, state)
                if probe_sites:
                    # the probe vectors stacked on the device: one copy to
                    # the host, not one a probe
                    stats = list(to_numpy(fetch[n_keep]))
                    if any(s.kind == "probe" and (v[5] or v[6])
                           for s, v in zip(probe_sites, stats)):
                        self._restore(plane, state)
                    inspector_mod.record_probes(
                        self, program, scope, probe_sites, stats,
                        feed=user_feed, new_state=written,
                        rng_counter=rng_counter, prog_label=prog_label)
            except NonFiniteError:
                self._restore(plane, state)
                raise
        scope.set_var("__rng_counter__", rng_counter + 1)
        if plane is not None and plane.rows is not None:
            dynamics_mod.on_step(program, prog_label, plane.rows,
                                 int(rng_counter))
        self._publish_run(program, prog_label, run_dt, compile_s, len(raw),
                          n_user, len(state))
        self._sample_memory(program, feed_vals, state)
        self._write_back(program, scope, written, lens)
        out = self._fetch_out(fetch_names[:n_keep], fetch[:n_keep], lens,
                              return_numpy)
        if extra:
            for (metric, _n), v in zip(extra, out[n_user:]):
                telemetry.gauge(metric, labels=("program",)).labels(
                    program=prog_label).set(float(v.reshape(-1)[0]))
        if not internal and inspector_mod.flight_enabled():
            self._flight_record(program, prog_label, run_dt, compile_s,
                                len(raw), n_user, rng_counter)
        return out[:n_user]

    # --- the step's telemetry and the numeric-health plane --------------
    def _plane(self, program, reason, check, probe_sites, rng_counter,
               internal) -> Optional[_Plane]:
        """The plane's asks of this step, or None when none is on (the
        step then runs as it would without the plane). Dynamics samples the
        graphed path only (its eager warm-up included), as the reference
        samples its traced step only."""
        dyn = None
        if reason is None and not internal:
            dyn = dynamics_mod.plan(program)
        scan = reason is not None and (check or reason == "trap_fp")
        if not (check or probe_sites or dyn is not None or scan):
            return None
        exclude = frozenset(s.stat_var for s in probe_sites or ())
        return _Plane(check and reason is None, scan, exclude, dyn,
                      dynamics_mod.sampled(dyn, rng_counter),
                      bool(check or probe_sites or scan))

    def _check_step(self, plane, program, fetch_names, fetch, written, feed,
                    rng_counter, scope, prog_label, state):
        """The graphed step's check_nan_inf: its one finiteness flag, read
        here (the fetches' copy out has read the device already); on
        failure the fetches (less the probe vectors) and the persistable
        outputs are walked in order to name the first non-finite one (JAX
        executor.py:1293-1317)."""
        if not plane.check or plane.flag is None or bool(plane.flag):
            return
        checked = [(n, v) for n, v in zip(fetch_names, fetch)
                   if n not in plane.exclude] + sorted(written.items())
        for name, val in checked:
            if _nonfinite(val):
                self._raise_nonfinite(
                    program, name, val, feed, written, rng_counter, scope,
                    prog_label, restore=lambda: self._restore(plane, state))

    def _raise_nonfinite(self, program, name, val, feed, new_state,
                         rng_counter, scope, prog_label, restore=None):
        """NonFiniteError for a check_nan_inf hit after a graphed step
        (JAX executor.py:1490): the variable, its dtype and contamination,
        counted as nonfinite_detections_total{source="fetch"}, and with
        the nonfinite_attribution flag (default on) the bisection's
        attribution, replayed eager from the scope as it was before the
        step (`restore`, called once the variable is read, puts the state
        a step updated in place back first)."""
        telemetry.counter(
            "nonfinite_detections_total",
            "NaN/Inf values caught by check_nan_inf or inspector probes",
            labels=("program", "source")).labels(
                program=prog_label, source="fetch").inc()
        t = val.values if isinstance(val, SelectedRowsVal) else val
        dtype = dtype_name(t.dtype)
        nan_c = int(torch.isnan(t).sum())
        inf_c = int(torch.isinf(t).sum())
        msg = (f"NaN/Inf detected in variable '{name}' (dtype {dtype}, "
               f"shape {tuple(t.shape)}, {nan_c} NaN / {inf_c} Inf) after "
               f"graphed step (check_nan_inf)")
        if restore is not None:
            restore()
        attribution = None
        if flags_mod.get("nonfinite_attribution"):
            try:
                attribution = inspector_mod.attribute_nonfinite(
                    self, program, feed, scope=scope, state=new_state,
                    rng_counter=rng_counter)
            except Exception:
                attribution = None
            if attribution is not None:
                msg += "\n  " + attribution.summary()
        raise NonFiniteError(msg, var_name=name, dtype=dtype,
                             attribution=attribution,
                             feed_signature=inspector_mod.feed_signature(
                                 feed))

    @staticmethod
    def _restore(plane, state):
        """A raising step's in-place state back from its pre-step copy:
        the scope holds what it held before the step."""
        if plane is None or not plane.restore or not plane.snap:
            return
        names = [n for n in plane.snap if n in state]
        torch._foreach_copy_([state[n] for n in names],
                             [plane.snap[n] for n in names])

    def _run_series(self, prog_label, mode) -> _RunSeries:
        key = (prog_label, mode)
        ser = self._series.get(key)
        if ser is None or ser.gen != telemetry.registry().generation():
            ser = self._series[key] = _RunSeries(prog_label,
                                                 self.place_label, mode)
        return ser

    def _publish_run(self, program, prog_label, run_dt, compile_s, n_feeds,
                     n_fetches, n_state):
        """The run's executor_* series, its `run` event (JAX
        executor.py:1355-1386) and, with tracing on, its `step` span with a
        `compile` child on a capture. A graphed run's mode is "graph"; its
        cache is "miss" when it warmed a signature up or captured it, "hit"
        when it replayed."""
        mode, cache_status = self._route
        ser = self._run_series(prog_label, mode)
        ser.runs.inc()
        ser.steps.inc()
        ser.seconds.observe(run_dt)
        if cache_status == "hit":
            ser.hits().inc()
        ser.last_step.set(max(run_dt - compile_s, 0.0))
        if self._program_facts(program)[0]:
            ser.opt_steps().inc()
        telemetry.log_event(
            "run", program=prog_label, place=self.place_label, mode=mode,
            seconds=run_dt, compile_s=compile_s,
            execute_s=max(run_dt - compile_s, 0.0), cache=cache_status,
            donated=n_state if mode == "graph" else 0, feeds=n_feeds,
            fetches=n_fetches)
        if tracing_mod.enabled():
            t_end = time.monotonic()
            sp = tracing_mod.record_span(
                "step", t_end - run_dt, t_end,
                attrs={"program": prog_label, "place": self.place_label,
                       "mode": mode, "cache": cache_status})
            if compile_s > 0.0 and cache_status == "miss":
                tracing_mod.record_span(
                    "compile", t_end - run_dt,
                    min(t_end - run_dt + compile_s, t_end), parent=sp,
                    attrs={"seconds": compile_s})

    def _publish_window(self, program, prog_label, steps, run_dt, compile_s,
                        n_feeds, n_fetches, n_state):
        """A run_steps window's series and its `run_window` event (JAX
        executor.py:942-990): runs count one (mode "window"), steps K, the
        last-step gauge the window's per-step time less its compile."""
        cache_status = self._route[1]
        ser = self._run_series(prog_label, "window")
        ser.runs.inc()
        ser.steps.inc(steps)
        ser.seconds.observe(run_dt)
        ser.last_step.set(max(run_dt - compile_s, 0.0) / steps)
        if self._program_facts(program)[0]:
            ser.opt_steps().inc(steps)
        telemetry.log_event(
            "run_window", program=prog_label, place=self.place_label,
            mode="window", steps=steps, seconds=run_dt,
            per_step_seconds=run_dt / steps, compile_s=compile_s,
            execute_s=max(run_dt - compile_s, 0.0), cache=cache_status,
            donated=n_state, feeds=n_feeds, fetches=n_fetches)
        if tracing_mod.enabled():
            t_end = time.monotonic()
            tracing_mod.record_span(
                "run_steps_window", t_end - run_dt, t_end,
                attrs={"program": prog_label, "place": self.place_label,
                       "steps": steps, "cache": cache_status})

    def _flight_record(self, program, prog_label, seconds, compile_s,
                       n_feeds, n_fetches, rng_counter, **more):
        """One flight-recorder record (JAX executor.py:1441-1456), the
        memory gauges published first."""
        mode, cache_status = self._route
        mem = memory_mod.tracker().last
        rec = {"place": self.place_label, "mode": mode, "seconds": seconds,
               "compile_s": compile_s, "cache": cache_status,
               "feeds": n_feeds, "fetches": n_fetches,
               "rng_counter": int(rng_counter),
               "global_norm": telemetry.read_gauge(
                   "optimizer_global_norm", program=prog_label),
               "hbm_bytes_in_use": mem.get("bytes_in_use"),
               "hbm_peak_bytes": mem.get("peak_bytes")}
        rec.update(more)
        inspector_mod.record_step(program, prog_label, rec)

    def _note_signature(self, family, feed, program, prog_label, entry):
        """A new graph signature (its warm-up): the reference's retrace
        bookkeeping (JAX executor.py:1244-1290). A family (program,
        version, fetches, plane) that has graphed before and now sees a
        new feed signature counts executor_cache_misses_total and logs a
        `cache_miss` event with the signature and what changed; the
        capture that follows logs the `compile`."""
        sig = telemetry.signature_of(feed)
        seen = self._sigs.get(family)
        if seen is None:
            seen = self._sigs[family] = [set(), None, program]
        entry.cause = "first_compile" if not seen[0] else "signature_change"
        entry.sig = sig
        if sig not in seen[0] and seen[0]:
            last = seen[1] or ()
            telemetry.counter(
                "executor_cache_misses_total",
                "graph signatures warmed up after the program's first",
                labels=("program", "place")).labels(
                    program=prog_label, place=self.place_label).inc()
            telemetry.log_event(
                "cache_miss", program=prog_label, place=self.place_label,
                signature=[list(x) for x in sig],
                changed=[list(x) for x in sig if x not in last])
        seen[0].add(sig)
        seen[1] = sig

    def _note_capture(self, entry, program, seconds):
        prog_label = telemetry.program_label(program)
        telemetry.counter(
            "executor_compiles_total", "block graph captures",
            labels=("program", "place")).labels(
                program=prog_label, place=self.place_label).inc()
        telemetry.counter(
            "executor_compile_seconds_total",
            "graph capture wall seconds inside Executor.run",
            labels=("program", "place")).labels(
                program=prog_label, place=self.place_label).inc(seconds)
        telemetry.log_event(
            "compile", program=prog_label, place=self.place_label,
            cause=entry.cause, seconds=seconds,
            signature=[list(x) for x in (entry.sig or ())])

    def _pull_readers(self, program, feed):
        """`feed` with the next batch of each program-bound reader
        (layers.read_file) whose variables the caller did not feed (JAX
        executor.py:1075): the executor's half of the reference's reader
        ops. Feeding some of a reader's variables but not all raises; an
        exhausted reader raises layers.EOFException."""
        readers = getattr(program, "_pipeline_readers", None)
        if not readers:
            return feed
        feed = dict(feed or {})
        for reader, names in readers:
            fed = [n for n in names if n in feed]
            if fed:
                if len(fed) != len(names):
                    raise ValueError(
                        f"Reader variables {sorted(set(names) - set(fed))} "
                        f"are not in the feed but their sibling(s) {fed} "
                        f"are; feed all of a reader's outputs or none "
                        f"(pipeline pull is all-or-nothing)")
                continue
            feed.update(zip(names, reader.next_batch(self.device)))
        return feed

    @staticmethod
    def _telemetry_extra(program, fetch_names):
        """[(gauge name, variable name)] of the program's telemetry marks
        to fetch beside `fetch_names`, when PADDLE_TPU_TELEMETRY_FETCH is
        on."""
        marked = getattr(program, "_telemetry_fetch_extra", None)
        if not marked or not telemetry_fetch_enabled():
            return []
        return [(m, n) for m, n in sorted(marked.items())
                if n not in fetch_names]

    @staticmethod
    def _write_back(program, scope, written, lens):
        """The persistable outputs into `scope`; a variable declared a
        sequence (lod_level > 0) whose lengths the step knows goes back as
        a LoDTensor, so the next run packs it again (JAX
        executor.py:1414)."""
        block = program.global_block()
        for n, v in written.items():
            if n + SEQLEN_SUFFIX in lens and block.has_var(n) and \
                    block.var(n).lod_level > 0:
                inner = lens.get(n + SEQLEN2_SUFFIX) \
                    if block.var(n).lod_level > 1 else None
                packed, lod = padded_to_pack(
                    to_numpy(v), to_numpy(lens[n + SEQLEN_SUFFIX]),
                    None if inner is None else to_numpy(inner))
                v = LoDTensor(packed, lod)
            scope.set_var(n, v)

    @staticmethod
    def _fetch_out(fetch_names, fetch, lens, return_numpy):
        """The fetches as the caller asked: numpy arrays, or the tensors;
        a fetched sequence comes back packed (numpy), or as a LoDTensor
        when return_numpy is False (JAX executor.py:1458)."""
        out = []
        for n, v in zip(fetch_names, fetch):
            sl = lens.get(n + SEQLEN_SUFFIX)
            if sl is None:
                out.append(to_numpy(v) if return_numpy else v)
                continue
            inner = lens.get(n + SEQLEN2_SUFFIX)
            r = _repack(to_numpy(v), to_numpy(sl),
                        None if inner is None else to_numpy(inner),
                        not return_numpy)
            if r is None:
                r = to_numpy(v) if return_numpy else v
            out.append(r)
        return out

    def run_steps(self, program: Optional[Program] = None, feed_window=None,
                  *, reader=None, steps: Optional[int] = None,
                  fetch_list: Optional[Sequence] = None,
                  scope: Optional[Scope] = None, return_numpy: bool = True,
                  fetch_mode: str = "last", use_jit: Optional[bool] = None):
        """Run K training steps in one call (the JAX package's
        executor.py:622): K passes of the block, with no host sync between
        them, over a window of K batches.

        feed_window: a list of K per-step feed dicts, or a dict whose every
        entry has a leading [K] axis (DataFeeder.feed_window). reader: an
        object with `next_window(k, device=...)`
        (reader.pipeline.DoubleBufferedFeeder), pulled instead of
        feed_window; it needs `steps`, and raises StopIteration at the end
        of a pass. fetch_mode: 'last' returns the last step's fetches,
        'stack' a [K, ...] stack of each, 'mean' their mean over the window.

        Step i starts from the state (the scope's variables, as the
        previous step left them) and slice i of the window's feeds, never
        from an earlier step's temporaries, and runs with rng counter c +
        i: the results are bitwise those of K run() calls. On a graphed
        signature each step is a replay, slice i copied into the feed
        buffers on the compute stream (after the window's copy-stream
        event, which the reader's hand-out waits on). The fetches stay on
        the device until the window ends, and come back with one
        device-to-host copy each. The scope is written once, after the
        last step, and `__rng_counter__` goes up by K then: a window that
        fails leaves both as they were (the eager dense optimizer ops are
        functional; a graphed window steps its state buffers in place, as
        the reference's donated state, and hands the scope copies only
        after its last step), except the tables of sparse applies, which
        advance in place step by step.

        With a hot-row cache on the program, a reader is asked for the
        cached ids' slots kept on the host (`sparse_slots`), and the whole
        window's ids are remapped in one residency transaction before it
        runs.

        A window of per-step dicts holding a LoDTensor with a LoD, or a
        program reading sequence state (a LoDTensor in the scope), runs
        one run() a step (reasons `lod_feed`, `lod_state`: each batch pads
        to its own length, JAX executor.py:755); a pre-stacked window
        holding a LoDTensor raises."""
        if fetch_mode not in ("last", "stack", "mean"):
            raise ValueError(f"fetch_mode must be last|stack|mean, "
                             f"got {fetch_mode!r}")
        program = program if program is not None else default_main_program()
        try:
            return self._run_steps_impl(program, feed_window, reader, steps,
                                        fetch_list, scope, return_numpy,
                                        fetch_mode, use_jit)
        except Exception as e:
            inspector_mod.notify_crash(self, program, e)
            raise

    def _run_steps_impl(self, program, feed_window, reader, steps,
                        fetch_list, scope, return_numpy, fetch_mode,
                        use_jit):
        scope = scope if scope is not None else global_scope()
        cache = getattr(program, "_emb_cache", None)
        if reader is not None:
            if feed_window is not None:
                raise ValueError("pass feed_window or reader, not both")
            if steps is None:
                raise ValueError("reader windows need an explicit steps=K")
            if cache is not None and _accepts_sparse_slots(reader):
                feed_window, _uniq = reader.next_window(
                    steps, device=self.device,
                    sparse_slots=cache.feed_id_names())
            else:
                feed_window = reader.next_window(steps, device=self.device)
        if feed_window is None:
            raise ValueError("run_steps needs feed_window= or reader=")
        stacked, per_step, steps = _normalize_window(feed_window, steps)
        if per_step is not None:
            return self._run_steps_per_step(
                program, per_step, fetch_list, scope, return_numpy,
                fetch_mode, use_jit, "lod_feed")
        if steps < 1:
            raise ValueError(f"steps must be >= 1, got {steps}")
        internal = getattr(program, "_inspector_internal", False)
        check = _CHECK_NAN_INF or flags_mod.get("check_nan_inf")
        if not internal and (check or getattr(program, "_probe_sites", None)):
            # per-step attribution needs per-step runs (JAX
            # executor.py:672-675)
            return self._run_steps_per_step(
                program, [{n: v[i] for n, v in stacked.items()}
                          for i in range(steps)],
                fetch_list, scope, return_numpy, fetch_mode, use_jit,
                "check_nan_inf" if check else "probes")
        if any(isinstance(scope.find_var(n), LoDTensor)
               and scope.find_var(n).lod
               for n in self._external_inputs(program, set(stacked), scope)):
            return self._run_steps_per_step(
                program, [{n: v[i] for n, v in stacked.items()}
                          for i in range(steps)],
                fetch_list, scope, return_numpy, fetch_mode, use_jit,
                "lod_state")
        if cache is not None:
            stacked = cache.prepare_feed(stacked)
        fetch_names = _names(fetch_list)
        self._maybe_verify(program, list(stacked), fetch_names)
        feed_vals = {n: _to_device(v, self.device) for n, v in stacked.items()}
        state_names = self._resolve_state(program, feed_vals, scope)
        persist_out = self._persistable_outputs(program)
        state = {n: _to_device(scope.find_var(n), self.device)
                 for n in state_names}
        rng_counter = scope.find_var("__rng_counter__") or 0
        fetched, written, samples = [], {}, []
        compile_before = telemetry.compile_seconds()
        t0 = time.perf_counter()
        for i in range(steps):
            feed_i = {n: v[i] for n, v in feed_vals.items()}
            reason = self.graph_gate(program, feed_i, use_jit, True)
            plane = self._plane(program, reason, False, None,
                                rng_counter + i, internal)
            try:
                fetch, out, _lens = self._step(
                    program, state, feed_i, fetch_names, persist_out,
                    rng_counter + i, reason, hand_out=i == steps - 1,
                    plane=plane)
            except Exception as e:
                self._raise_oom(program, e, feed_vals, state)
                raise
            if plane is not None and plane.rows is not None:
                samples.append((rng_counter + i, plane.rows))
            written.update(out)
            state.update({n: v for n, v in out.items() if n in state})
            fetched.append(fetch)
        run_dt = time.perf_counter() - t0
        compile_s = telemetry.compile_seconds() - compile_before
        if cache is not None:
            cache.window_dispatched()
        scope.set_var("__rng_counter__", rng_counter + steps)
        prog_label = telemetry.program_label(program)
        for c, rows in samples:
            dynamics_mod.on_step(program, prog_label, rows, c)
        self._publish_window(program, prog_label, steps, run_dt, compile_s,
                             len(feed_vals), len(fetch_names), len(state))
        self._sample_memory(program, feed_vals, state)
        for n, v in written.items():
            scope.set_var(n, v)
        COUNTERS.windows += 1
        COUNTERS.steps += steps
        if not internal and inspector_mod.flight_enabled():
            self._flight_record(program, prog_label, run_dt, compile_s,
                                len(feed_vals), len(fetch_names),
                                rng_counter, steps=steps,
                                per_step_seconds=run_dt / steps)
        if fetch_mode == "last":
            out = fetched[-1]
        else:
            out = [torch.stack([f[j] for f in fetched])
                   for j in range(len(fetch_names))]
            if fetch_mode == "mean":
                out = [t.mean(0) if t.is_floating_point()
                       else t.double().mean(0) for t in out]
        return [to_numpy(v) for v in out] if return_numpy else out

    def _run_steps_per_step(self, program, per_step, fetch_list, scope,
                            return_numpy, fetch_mode, use_jit, reason):
        """A window served one run() a step (JAX executor.py:800), counted
        in COUNTERS.window_fallbacks by `reason`: the results of K run()
        calls, the scope and the rng counter advanced a step at a time. A
        fetched sequence comes back packed, so 'stack' and 'mean' need its
        packed rows to agree in shape across the window."""
        if len(per_step) > 1:
            COUNTERS.window_fallbacks[reason] = \
                COUNTERS.window_fallbacks.get(reason, 0) + 1
            telemetry.counter(
                "executor_window_fallback_total",
                "run_steps windows that fell back to per-step execution",
                labels=("program", "reason")).labels(
                    program=telemetry.program_label(program),
                    reason=reason).inc()
            vlog(1, f"run_steps window of {len(per_step)} steps served one "
                    f"run() a step ({reason})")
        outs = []
        for f in per_step:
            vals = self.run(program, feed=f, fetch_list=fetch_list,
                            scope=scope, return_numpy=return_numpy,
                            use_jit=use_jit)
            if fetch_mode == "last":
                outs = vals
            else:
                outs.append(vals)
        COUNTERS.windows += 1
        COUNTERS.steps += len(per_step)
        if fetch_mode == "last":
            return outs
        cols = list(zip(*outs))
        if fetch_mode == "stack":
            return [np.stack([np.asarray(v) for v in col]) for col in cols]
        return [np.mean(np.stack([np.asarray(v) for v in col]), axis=0)
                for col in cols]

    def prepare_serving(self, program: Program, feed_names: Sequence[str],
                        fetch_names: Sequence[str], scope: Scope) -> PreparedProgram:
        """Resolve one inference program's state names once, for the
        serving engine (the JAX package's executor.py:2021). Raises the
        same missing-state error as run() when the startup never ran."""
        feed_names = sorted(feed_names)
        state_names = self._resolve_state(program, feed_names, scope)
        return PreparedProgram(self, program, feed_names, list(fetch_names),
                               state_names, self._persistable_outputs(program))

    # --- verification and memory -----------------------------------------
    def _maybe_verify(self, program, feed_names, fetch_names):
        """PADDLE_TPU_VERIFY=1: run the static analyzer once per program
        version (JAX executor.py:1990), so a verified program costs one
        set lookup a run after, and refuse a program with error-severity
        diagnostics before its first op."""
        if not _VERIFY:
            return
        key = (id(program), getattr(program, "_version", 0))
        seen = self._verified_programs
        if seen.get(key) is program:
            return
        from .analysis import analyze_program
        report = analyze_program(program, feeds=list(feed_names),
                                 fetches=list(fetch_names))
        if report.errors:
            from .errors import ProgramVerifyError
            raise ProgramVerifyError(
                report.errors, program_name=getattr(program, "name", None))
        seen[key] = program

    def _raise_oom(self, program, exc, feed, state):
        """Raise the errors.OOMError that replaces `exc` when it is the card
        running out of memory (memory.maybe_oom_error, JAX
        executor.py:900, :1225, :1329); return otherwise. The error is
        raised from a frame that keeps no reference to it, and the failed
        step's frames are cleared, so that once the caller drops the error
        the step's tensors are free."""
        from . import telemetry
        err = memory_mod.maybe_oom_error(
            self, program, telemetry.program_label(program), exc, feed,
            state)
        if err is None:
            return
        err.__cause__ = exc
        try:
            raise err
        finally:
            del err, exc

    def _sample_memory(self, program, feed, state):
        """One memory.on_run sample after a run or a window: advisory, it
        never fails the step."""
        try:
            from . import telemetry
            memory_mod.on_run(self, program, telemetry.program_label(program),
                              feed, state)
        except Exception:
            pass

    def _memory_inputs(self, program, feed, scope):
        """(feed specs, state tensors) of a step of `program` on `feed`,
        for the memory analyses: meta tensors (or anything with a shape and
        a dtype) and (shape, dtype) specs pass as they are; arrays are
        measured, never moved."""
        feed_vals = {}
        for name, val in dict(feed or {}).items():
            if isinstance(val, LoDTensor):
                val = np.asarray(val.array())
            if isinstance(val, tuple):
                val = memory_mod._spec_tensor(val)
            elif not (hasattr(val, "shape") and hasattr(val, "dtype")):
                val = np.asarray(val)
            feed_vals[name] = val
        state_names = self._resolve_state(program, feed_vals, scope)
        state = {n: scope.find_var(n) for n in state_names}
        return feed_vals, {n: v.array() if isinstance(v, LoDTensor) else v
                           for n, v in state.items()}

    def static_memory_analysis(self, program=None, feed=None,
                               fetch_list=None, scope=None, top_k=8):
        """The memory footprint of one run of `program` on feeds of these
        shapes, from the IR alone (memory.program_peak_liveness: the bytes
        of live variables at each op, the batch substituted into the
        inferred shapes, the executor's own liveness over its fusion
        windows): no step runs and no feed is allocated, so feeds may be
        meta tensors (`torch.empty(shape, dtype=..., device="meta")`) or
        (shape, dtype) specs at any batch. Returns the
        memory.ProgramMemory record (also kept in memory.records())."""
        from . import telemetry
        program = program if program is not None else default_main_program()
        scope = scope if scope is not None else global_scope()
        feed_vals, state = self._memory_inputs(program, feed, scope)
        return memory_mod.analyze(
            program, feed_vals, state, _names(fetch_list),
            program_label=telemetry.program_label(program),
            place=f"{type(self.place).__name__}:{self.place.device_id}",
            top_k=top_k)

    def measure_memory(self, program=None, feed=None, fetch_list=None,
                       scope=None):
        """Run one eager step of `program` on `feed` (use_jit=False: a
        graph's pool would hide the step's own peak) under
        torch.cuda.reset_peak_memory_stats(), and record the allocator's
        peak over the bytes held before the step, with the state the step
        reads, as a memory.ProgramMemory (source "measured"). The step is
        a real one: it updates the state. Needs a CUDA place."""
        from . import telemetry
        if self.device.type != "cuda":
            raise ValueError("measure_memory reads the CUDA caching "
                             "allocator's peak: it needs a CUDA place "
                             "(static_memory_analysis works anywhere)")
        program = program if program is not None else default_main_program()
        scope = scope if scope is not None else global_scope()
        feed_vals, state = self._memory_inputs(program, feed, scope)
        state_bytes = sum(memory_mod.nbytes_of(v) for v in state.values())
        feed_bytes = sum(memory_mod.nbytes_of(v) for v in feed_vals.values())
        torch.cuda.synchronize(self.device)
        before = torch.cuda.memory_allocated(self.device)
        torch.cuda.reset_peak_memory_stats(self.device)
        self.run(program, feed=feed, fetch_list=fetch_list, scope=scope,
                 use_jit=False)
        torch.cuda.synchronize(self.device)
        step = torch.cuda.max_memory_allocated(self.device) - before
        return memory_mod.measured(
            telemetry.program_label(program),
            f"{type(self.place).__name__}:{self.place.device_id}",
            feed_vals, state_bytes, step, feed_bytes)

    def graph_gate(self, program, feed, use_jit=None,
                   use_program_cache=True) -> Optional[str]:
        """None when a step of `program` on `feed` may run as a CUDA graph,
        else the reason it runs eager: "use_jit" (use_jit=False, or unset
        under PADDLE_TPU_EAGER=1), "cpu"
        (not a CUDA place), "no_program_cache" (use_program_cache=False),
        "startup" (the block reads nothing but its feeds and writes
        persistables: an initialiser, run once a scope, whose graph would
        only take a cache slot and pin a copy of every value it makes),
        "control_flow" (the block, or a sub-block it runs, holds a `while`,
        a `conditional_block`, their grads or a `print`: HOST_CONTROL_OPS,
        which read a device value on the host to choose their path, or
        print there), "host_io" (it holds a save or load op, HOST_IO_OPS,
        which write or read a file on the host), "host_metric" (it holds an
        op that computes on the host from device values, HOST_METRIC_OPS,
        each read counted in COUNTERS.host_syncs), "host_collective" (the
        program runs sharded on a gloo group of ranks on cards: its
        collectives stage through host memory, parallel/spmd.py). A random
        op is graphed
        (RANDOM_OPS), and so is a LoD feed: its lengths are feeds of the
        graph, each padded length its own signature; so is an `rnn`, whose
        trip count is the padded length."""
        if use_jit is False or (use_jit is None and _EAGER):
            return "use_jit"
        if _TRAP_FP:
            return "trap_fp"
        if self.device.type != "cuda":
            return "cpu"
        if not use_program_cache:
            return "no_program_cache"
        st = spmd_mod.for_program(program)
        if st is not None and st.host_staged(self.device):
            return "host_collective"
        reads, writes, persistable, types = self._analysis(program)
        if types & HOST_CONTROL_OPS:
            return "control_flow"
        if types & HOST_IO_OPS:
            return "host_io"
        if types & HOST_METRIC_OPS:
            return "host_metric"
        if not reads - set(feed) and writes & persistable:
            return "startup"
        return None

    # --- analysis -----------------------------------------------------------
    def _analysis(self, program):
        """Per-(program, version) read/write sets, persistable map and op
        types of the global block and, through the ops that hold them, its
        sub-blocks (a weight only a loop body reads is state too)."""
        key = (id(program), program._version)
        hit = self._analysis_cache.get(key)
        if hit is not None and hit[0] is program:
            return hit[1:]
        reads, writes, types = set(), set(), set()
        _block_reads_writes(program, program.global_block(), reads, writes,
                            set(), types)
        persistable = {name for b in program.blocks
                       for name, v in b.desc.vars.items() if v.persistable}
        # keep a strong program ref: the key uses id(program)
        self._analysis_cache[key] = (program, reads, writes, persistable,
                                     types)
        return reads, writes, persistable, types

    def _external_inputs(self, program, fed: set, scope) -> List[str]:
        """Vars the block reads from the scope: present scope vars or
        declared persistables."""
        reads, _writes, persistable, _types = self._analysis(program)
        return [n for n in sorted(reads - fed)
                if (scope.has_var(n) and scope.find_var(n) is not None)
                or n in persistable]

    def _resolve_state(self, program, fed, scope) -> List[str]:
        """The scope variables a run reads; raises when one is missing."""
        state_names = self._external_inputs(program, set(fed), scope)
        missing = [n for n in state_names if scope.find_var(n) is None]
        if missing:
            raise RuntimeError(
                f"Variables {missing} are read by the program but absent from "
                f"the scope — run the startup program first.")
        return state_names

    def _persistable_outputs(self, program) -> List[str]:
        _reads, writes, persistable, _types = self._analysis(program)
        return [n for n in sorted(writes) if n in persistable]

    def _block_plan(self, program):
        """(fusion plan, liveness drops, the random ops) of the global
        block, once per (program, version)."""
        key = (id(program), program._version)
        hit = self._plans.get(key)
        if hit is None or hit[0] is not program:
            ops = program.global_block().ops
            groups = fusion_mod.plan(program)
            hit = self._plans[key] = (
                program, groups, liveness(ops, groups),
                tuple(o for b in program.blocks for o in b.ops
                      if o.type in RANDOM_OPS))
        return hit[1:]

    def _plan(self, program):
        return self._block_plan(program)[0]

    def _program_facts(self, program):
        """(whether the block carries optimizer-role ops, the state names a
        step may update in place) of the global block, once per (program,
        version). The second: the outputs of the sparse-apply optimizer
        ops (sparse_ops.SPARSE_APPLY_OPS) whose Grad is a sparse
        lookup_table gradient, directly or through a `sum` of them: the
        tables and accumulators a sparse apply advances in place."""
        key = (id(program), program._version)
        hit = self._facts.get(key)
        if hit is None or hit[0] is not program:
            ops = program.global_block().ops
            has_opt = any(op.desc.attrs.get("op_role") == "optimize"
                          for op in ops)
            sparse = set()
            for op in ops:
                if op.type == "lookup_table_grad" and op.attr("is_sparse",
                                                              False):
                    sparse.update(op.output_arg_names)
                elif op.type == "sum" and op.input_arg_names and \
                        set(op.input_arg_names) <= sparse:
                    sparse.update(op.output_arg_names)
            inplace = set()
            for op in ops:
                if op.type in sparse_ops.SPARSE_APPLY_OPS and \
                        set(op.desc.inputs.get("Grad", ())) & sparse:
                    inplace.update(op.output_arg_names)
            hit = self._facts[key] = (program, has_opt, frozenset(inplace))
        return hit[1:]

    # --- execution ----------------------------------------------------------
    def _step(self, program, state, feed, fetch_names, persist_out,
              rng_counter, reason, hand_out=True, plane=None):
        """One step from `state` and `feed`: (fetch tensors, the persistable
        outputs by name, the lengths of the fetched and written sequences
        by `<name>@SEQLEN[2]`). `reason` is the graph gate's answer: None
        runs the signature's graph (warming it up first), else eager,
        counted by reason. `hand_out=False` (a run_steps step before the
        last) lets a replay return the state buffers themselves, for the
        next step to read in place. On a process group's mesh the feeds
        are cut to this rank's rows and the sharded state to its shards
        first (parallel/spmd.py). `plane` (a _Plane, or None) asks for the
        numeric-health plane's work: its token is part of the graph key,
        and the step leaves its finiteness flag, its dynamics rows and its
        pre-step copy on it. `self._route` tells the caller how the step
        ran: (mode, cache status)."""
        spmd_seed = None
        st = spmd_mod.for_program(program)
        if st is not None:
            feed, marks = st.split_feeds(feed)
            spmd_seed = (st, marks, st.localize(state))
        if reason is None:
            # the state's names are sorted (_resolve_state); a LoD feed's
            # lengths are feeds, so each padded length is its own key
            base = (id(program), program._version,
                    tuple((n, v.shape, v.dtype)
                          for n, v in sorted(feed.items())),
                    tuple(fetch_names), tuple(state),
                    tuple(v.shape for v in state.values()),
                    tuple(v.dtype for v in state.values()),
                    getattr(program, "_amp_dtype", None),
                    getattr(program, "_amp_level", "O1"),
                    quant.cache_token(program), sparse_ops.cache_token(program),
                    program.random_seed,
                    None if plane is None else plane.token)
            # a graph updates the in-place state of the scope it was
            # captured on: those tensors' identities are part of its key
            names = self._inplace_names.get(base)
            key = None if names is None else base + (
                _identities(state, names),)
            entry = None if key is None else self._graphs.get(key)
            if entry is None:
                entry = _GraphedStep()
                COUNTERS.warmups += 1
                self._note_signature(
                    (id(program), program._version, tuple(fetch_names),
                     base[-1]), feed, program,
                    telemetry.program_label(program), entry)
                self._route = ("graph", "miss")
            else:
                self._graphs.move_to_end(key)
                self._route = ("graph", "miss" if entry.graph is None
                               else "hit")
                try:
                    return self._graphed(entry, program, state, feed,
                                         fetch_names, persist_out,
                                         rng_counter, hand_out, spmd_seed,
                                         plane)
                except BaseException:
                    if entry.graph is None:
                        # the capture failed: the signature warms up again
                        # next time, and the state buffers no graph reads
                        # go (an OOM's memory goes back with them)
                        self._graphs.pop(key, None)
                        self._evict()
                    raise
        else:
            COUNTERS.eager[reason] = COUNTERS.eager.get(reason, 0) + 1
            self._route = ("eager", "n/a")
        if plane is not None:
            self._snapshot(plane, program, state, None)
        env = dict(state)
        env.update(feed)
        ctx = LoweringContext(self, program, rng_counter)
        ctx.spmd = _spmd_for(spmd_seed, env)
        ctx.scan = plane is not None and plane.scan
        ctx.bench = _BENCHMARK and reason is not None
        groups, drops, _ = self._block_plan(program)
        protected = set(fetch_names) | set(persist_out)
        keep = protected | set(state)
        if plane is not None and plane.sample:
            keep |= set(plane.dyn.grab_names)
        try:
            self._run_block(ctx, program, env, groups, protected, drops, keep)
        except Exception as e:
            # the failed step's tensors by name, for OOM forensics
            # (memory.maybe_oom_error reads and drops it)
            e.__dict__["step_env"] = env
            raise
        if ctx.spmd is not None:
            out = _spmd_outputs(ctx.spmd, env, fetch_names, persist_out)
        else:
            out = ([_fetched(env[n]) for n in fetch_names],
                   {n: env[n] for n in persist_out if n in env},
                   _lengths_of(env, list(fetch_names) + list(persist_out)))
        if plane is not None and reason is None:
            # the graphed signature's warm-up computes what its graph will
            plane.flag, plane.rows = self._plane_outputs(
                plane, fetch_names, out[0], out[1], state, env)
        if plane is not None and plane.exclude:
            out = (_stack_probes(out[0], len(plane.exclude)),) + out[1:]
        if reason is None:
            # the warm-up: a persistable output that is its state tensor
            # itself was updated in place (the sparse applies' tables)
            entry.inplace = {n for n in persist_out
                             if n in state and out[1].get(n) is state[n]}
            self._inplace_names[base] = entry.inplace
            self._graphs[base + (_identities(state, entry.inplace),)] = entry
            self._evict()
        return out

    def _snapshot(self, plane, program, state, entry):
        """The pre-step copy of the state this step may update in place,
        where the plane needs it (a step that must restore on failure, or
        a sampled step, whose update ratio reads W_old): a graphed step's
        exact in-place set (its warm-up found it) into the graph's static
        copies, an eager step's candidates (_program_facts) into new
        tensors, one multi-tensor copy either way."""
        if not (plane.restore or plane.sample):
            return
        if entry is not None:
            names = sorted(entry.snap)
            if names:
                torch._foreach_copy_([entry.snap[n] for n in names],
                                     [state[n] for n in names])
            plane.snap = entry.snap
            return
        names = [n for n in sorted(self._program_facts(program)[1])
                 if n in state]
        plane.snap = dict(zip(names, _copies([state[n] for n in names])))

    def _plane_outputs(self, plane, fetch_names, fetches, written, state,
                       env):
        """(finiteness flag, dynamics rows) of a graphed step, computed in
        the step (inside its graph on a capture) before its write-back:
        `state` holds the values the step started from, except a tensor
        updated in place, whose pre-step copy is in `plane.snap`."""
        flag = rows = None
        if plane.check:
            flag = finite_flag(
                [f for n, f in zip(fetch_names, fetches)
                 if n not in plane.exclude] + list(written.values()))
        if plane.sample:
            old = dict(state)
            old.update(plane.snap)
            grabs = {g: env[g] for g in plane.dyn.grab_names if g in env}
            rows = dynamics_mod.group_rows(plane.dyn, old, written, grabs,
                                           const=self.constant)
        return flag, rows

    def _evict(self):
        """Drop the graphs run least recently past GRAPH_CACHE_SIZE, and
        the state buffers no graph left reads."""
        while len(self._graphs) > GRAPH_CACHE_SIZE:
            self._graphs.popitem(last=False)
            COUNTERS.evicted += 1
        used = {id(b) for e in self._graphs.values() for b in e.state.values()}
        self._buffers = {k: b for k, b in self._buffers.items()
                         if id(b) in used}
        bases = {k[:-1] for k in self._graphs}
        self._inplace_names = {k: v for k, v in self._inplace_names.items()
                               if k in bases}

    def _buffer(self, name, v, inplace=False) -> _StateBuffer:
        """The static buffer of state `name` at v's shape and dtype: a clone
        of v shared by the Executor's graphs, or, for a tensor the step
        updates in place, v itself, bound to this graph alone (a buffer
        that is a scope's tensor is never copied into)."""
        if inplace:
            b = _StateBuffer(v)
            b.source(v)
            return b
        key = (name, v.shape, v.dtype)
        b = self._buffers.get(key)
        if b is None:
            b = self._buffers[key] = _StateBuffer(v.clone())
            b.source(v)
        return b

    def _graphed(self, entry: _GraphedStep, program, state, feed,
                 fetch_names, persist_out, rng_counter, hand_out=True,
                 spmd_seed=None, plane=None):
        """Capture `entry` on its first call, then replay it: a state
        tensor its buffer does not hold copied in, the feeds copied into
        their buffers. The scope is handed copies of the persistable
        outputs, never a buffer, except the state the step updates in
        place, whose buffer is the scope's tensor. A capture that fails
        raises; nothing runs eager in its place. With the plane on, the
        in-place state is copied into the graph's static pre-step copies
        before the replay, and the flag and the dynamics rows come back
        with the fetches."""
        if entry.graph is None:
            t0 = time.perf_counter()
            self._capture(entry, program, state, feed, fetch_names,
                          persist_out, rng_counter, spmd_seed, plane)
            self._note_capture(entry, program, time.perf_counter() - t0)
        for n, b in entry.state.items():
            v = state[n]
            if not b.holds(v):
                b.t.copy_(v)
                b.source(v)
                COUNTERS.copied_in += 1
        for n, buf in entry.feeds.items():
            buf.copy_(feed[n])
        if plane is not None:
            self._snapshot(plane, program, state, entry)
        self._seed_random(program, rng_counter)
        entry.graph.replay()
        COUNTERS.replays += 1
        # the fetches and the outputs outside the state live in the shared
        # pool, where the next graph's replay may write: copied out now
        fetch = [t.clone() for t in entry.fetches]
        lens = {n: t.clone() for n, t in entry.lens.items()}
        if plane is not None:
            plane.flag = None if entry.flag is None else entry.flag.clone()
            plane.rows = None if entry.rows is None else entry.rows.clone()
        bufs = [entry.state[n] for n in entry.persist]
        if not hand_out:
            for b in bufs:
                b.source(None)
            return fetch, {n: b.t for n, b in zip(entry.persist, bufs)}, lens
        copied = [n for n in entry.persist if n not in entry.inplace]
        copies = _copies([entry.state[n].t for n in copied]
                         + list(entry.written.values()))
        for n, c in zip(copied, copies):
            entry.state[n].source(c)
        out = dict(zip(copied + list(entry.written), copies))
        out.update((n, entry.state[n].t) for n in entry.persist
                   if n in entry.inplace)
        return fetch, out, lens

    def _capture(self, entry: _GraphedStep, program, state, feed,
                 fetch_names, persist_out, rng_counter, spmd_seed=None,
                 plane=None):
        entry.state = {n: self._buffer(n, v, n in entry.inplace)
                       for n, v in state.items()}
        entry.persist = [n for n in persist_out if n in entry.state]
        entry.feeds = {n: v.clone() for n, v in feed.items()}
        if plane is not None and (plane.restore or plane.sample):
            # the graph's static pre-step copies of its in-place state,
            # filled before each replay (_snapshot)
            entry.snap = {n: state[n].clone() for n in sorted(entry.inplace)}
            plane.snap = entry.snap
        groups, drops, _ = self._block_plan(program)
        protected = set(fetch_names) | set(persist_out)
        keep = protected | set(state)
        if plane is not None and plane.sample:
            keep |= set(plane.dyn.grab_names)

        def body():
            env = {n: b.t for n, b in entry.state.items()}
            env.update(entry.feeds)
            ctx = LoweringContext(self, program, rng_counter)
            ctx.capturing = True
            ctx.spmd = _spmd_for(spmd_seed, env)
            try:
                self._run_block(ctx, program, env, groups, protected, drops,
                                keep)
            except Exception as e:
                # the captured step's tensors by name, for OOM forensics
                e.__dict__["step_env"] = env
                raise
            if ctx.spmd is not None:
                fetches, written, entry.lens = _spmd_outputs(
                    ctx.spmd, env, fetch_names, persist_out)
            else:
                entry.lens = _lengths_of(env, list(fetch_names)
                                         + list(persist_out))
                fetches = [_fetched(env[n]) for n in fetch_names]
                written = {n: env[n] for n in persist_out if n in env}
            if plane is not None:
                # the plane reads the step's start from the buffers before
                # the write-back below
                entry.flag, entry.rows = self._plane_outputs(
                    plane, fetch_names, fetches, written,
                    {n: b.t for n, b in entry.state.items()}, env)
                if plane.exclude:
                    fetches = _stack_probes(fetches, len(plane.exclude))
            for n in entry.persist:
                buf = entry.state[n].t
                if written[n] is not buf:
                    buf.copy_(written[n])
            entry.fetches = fetches
            entry.written = {n: v for n, v in written.items()
                             if n not in entry.state}

        generators = [self._generator(random_ident(op))
                      for op in self._block_plan(program)[2]]
        kw = {"generators": generators} if generators else {}
        try:
            graph = capture_graph(body, self._pool, **kw)
        except Exception as e:
            if memory_mod.is_oom(e):
                raise           # Executor.run makes it an OOMError
            raise RuntimeError(
                f"CUDA graph capture of a step of program {id(program)} "
                f"failed ({type(e).__name__}: {e}); run it with "
                f"use_jit=False to take the eager path") from e
        if self._pool is None:
            self._pool = graph.pool()
        entry.graph = graph
        # whatever the capture left in the buffers it writes, the replay
        # starts from the state
        for n in entry.persist:
            if entry.state[n].t is not state[n]:
                entry.state[n].t.copy_(state[n])
            entry.state[n].source(state[n])
        COUNTERS.captures += 1

    def _run_block(self, ctx, program, env, groups, protected, drops=None,
                   keep=()):
        """The block's ops and windows in order on `env`. With `drops`
        (liveness), each name goes from `env` after its last reader unless
        it is in `keep`."""
        ops = program.global_block().ops
        groups = groups or {}
        spmd = ctx.spmd
        i = 0
        while i < len(ops):
            g = groups.get(i)
            lo = i
            t0 = time.perf_counter() if ctx.bench else None
            if g is not None:
                if spmd is not None:
                    spmd.window(g.members, env)
                for m in g.members:
                    _record_op(m.type)
                with registry.span(fusion_mod.span_name(g)):
                    fusion_mod.execute_group(self, ctx, g, env, protected)
                if spmd is not None and g.kind not in _MEMBER_WINDOWS:
                    spmd.after_window(g.members, env)
                i = g.end
            else:
                self._exec_op(ctx, ops[i], env)
                i += 1
            if t0 is not None:
                # FLAGS_benchmark (reference executor.cc:321): wait for the
                # device after each op or window and log its wall time
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                what = fusion_mod.span_name(g) if g is not None else \
                    ops[lo].type
                vlog(1, f"[benchmark] {what}: "
                        f"{(time.perf_counter() - t0) * 1e3:.3f} ms")
            if ctx.scan:
                _scan_outputs(g.members if g is not None else (ops[lo],),
                              env)
            if spmd is not None:
                spmd.flush_range(ctx, env, lo, i)
            if drops:
                for n in drops.get(i - 1, ()):
                    if n not in keep:
                        env.pop(n, None)

    def _exec_op(self, ctx: LoweringContext, op, env: Dict[str, Any]):
        if op.type in ("feed", "fetch"):
            return
        _record_op(op.type)
        try:
            opdef = registry.get(op.type)
        except KeyError as e:
            raise RuntimeError(f"Operator '{op.type}' is not registered in "
                               f"the port (outputs {op.output_arg_names})") from e
        if opdef.lower is None:
            raise RuntimeError(f"Operator '{op.type}' has no lowering")
        ins = {slot: [env.get(n) for n in names]
               for slot, names in op.desc.inputs.items()}
        if ctx.spmd is not None:
            ins = ctx.spmd.prepare(op, ins, env)
        if op.type not in _SPARSE_AWARE_OPS and any(
                isinstance(v, SelectedRowsVal)
                for vals in ins.values() for v in vals):
            # a SelectedRows value densifies at the boundary of an op with
            # no sparse path (executor.py:1620), counted
            sparse_ops.count_densify(op.type, "sparse_unaware_op")
            ins = {slot: [maybe_dense(v) for v in vals]
                   for slot, vals in ins.items()}
        ctx.env = env
        ctx.seq_overrides = {}
        carrier = seq_carrier(op, env)
        try:
            with registry.span("op:" + op.type):
                outs = opdef.lower(ctx, op, ins)
        except (TypeError, ValueError, IndexError) as e:
            shapes = {slot: [tuple(getattr(v, "shape", ())) for v in vals]
                      for slot, vals in ins.items()}
            raise EnforceNotMet(
                f"Operator {op.type} failed: {e}\n"
                f"  inputs: {dict(op.desc.inputs)}\n"
                f"  input shapes: {shapes}\n"
                f"  outputs: {dict(op.desc.outputs)}\n"
                f"  built at: {op.creation_site or '<unknown>'}",
                op_type=op.type, creation_site=op.creation_site) from e
        for slot, names in op.desc.outputs.items():
            for name, val in zip(names, outs.get(slot, [])):
                if val is not None:
                    env[name] = val
        if ctx.spmd is not None:
            ctx.spmd.after(op, outs)
        propagate_seq_len(op, env, ctx.seq_overrides, carrier)
