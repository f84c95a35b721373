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
runs; block temporaries vanish after the run. Feeds and fetches are
dense tensors; LoD feeds wait for a later slice. `run_steps` runs K steps
over a window of K batches in one call, with the scope written once at
the end (the JAX package's fused loop).

Places: `CUDAPlace` is the real card here (the JAX package made it an
alias of its TPU place). `Executor()` with no place runs on CUDAPlace(0),
or on CUDAPlace(local rank) in a torch.distributed process group (the
`LOCAL_RANK` a launcher sets, else the rank), and raises when there is no
CUDA device: it never carries on on the CPU unless the caller asks for
`CPUPlace()`. `TPUPlace` raises. A program's mesh (`program._mesh`,
parallel/mesh.py) reaches the lowerings as `ctx.mesh`; programs stay
global-view, so the interpreter itself does nothing per rank.
"""

from __future__ import annotations

import contextlib
import os
import weakref
import zlib
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from . import quant
from .framework.framework import Program, Variable, default_main_program
from .ops import fusion as fusion_mod
from .ops import registry, sparse_ops
from .ops.common import SelectedRowsVal, maybe_dense

__all__ = ["CPUPlace", "CUDAPlace", "TPUPlace", "place_device", "Scope",
           "global_scope", "scope_guard", "Executor", "COUNTERS"]


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


class EnforceNotMet(RuntimeError):
    """An op lowering failed; the message names the op, its variables, the
    live input shapes and the user line that built it."""


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
        # a serving program's fold constants (PreparedProgram.fold_weights)
        self.folds = None
        self._seed = program.random_seed or 12345
        self._rng_counter = rng_counter

    def generator(self, op) -> torch.Generator:
        """A torch.Generator for one random op, seeded from the op's `seed`
        attr (or the program seed and the run counter) and its first output
        name, like the JAX package's per-op key (executor.py next_rng): the
        same program and run draw the same numbers. CUDA's Philox takes
        all 64 bits of (base, ident); a CPU generator (mt19937) keeps only
        the low 32 of its seed, so there the 64 bits are mixed and folded
        into 32 first (`fold_seed`), and the seed and counter still count."""
        seed = int(op.attr("seed", 0) or 0)
        outs = op.desc.output_arg_names()
        ident = zlib.crc32(outs[0].encode("utf-8")) if outs else 0
        base = seed if seed else (self._seed * 1_000_003 + self._rng_counter)
        key = ((base & 0xFFFFFFFF) << 32 | ident) & (2 ** 63 - 1)
        g = torch.Generator(device=self.device)
        g.manual_seed(key if self.device.type == "cuda" else fold_seed(key))
        return g


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
    """-> ({name: [K, ...] array or tensor}, K), with the JAX package's
    checks and messages (executor.py:755-799). A list of per-step feed
    dicts is stacked on the host; a dict whose entries carry a leading [K]
    axis (DoubleBufferedFeeder.next_window, DataFeeder.feed_window) passes
    through."""
    if isinstance(feed_window, dict):
        if not feed_window:
            raise ValueError("feed_window dict is empty")
        ks = set()
        for n, v in feed_window.items():
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
        return dict(feed_window), k
    per_step = list(feed_window)
    if not per_step:
        raise ValueError("feed_window list is empty")
    if steps is not None and steps != len(per_step):
        raise ValueError(
            f"steps={steps} but feed_window has {len(per_step)} entries")
    names = set(per_step[0])
    if any(set(f) != names for f in per_step[1:]):
        raise ValueError("per-step feed dicts must share the same keys")
    stacked = {n: torch.stack([v if isinstance(v, torch.Tensor) else
                               torch.as_tensor(np.asarray(v))
                               for v in (f[n] for f in per_step)])
               for n in sorted(names)}
    return stacked, len(per_step)


@dataclass
class Counters:
    """`windows`: run_steps calls that finished; `steps`: the steps they
    ran (K a window). The graphed steps (`Executor.run`): `warmups`, the
    eager first step of a signature; `captures`; `replays`; `copied_in`,
    state tensors copied into their static buffers before a replay (the
    caller replaced or changed the scope's tensor, or another scope or
    signature left the buffer another value); `evicted`, graphs dropped
    past GRAPH_CACHE_SIZE; `eager`, the steps that ran eager, by the
    gate's reason (`graph_gate`). A replay runs no Python: the kernel
    wrappers' launch counters do not move."""
    windows: int = 0
    steps: int = 0
    warmups: int = 0
    captures: int = 0
    replays: int = 0
    copied_in: int = 0
    evicted: int = 0
    eager: Dict[str, int] = field(default_factory=dict)

    def reset(self):
        self.windows = self.steps = 0
        self.warmups = self.captures = self.replays = 0
        self.copied_in = self.evicted = 0
        self.eager.clear()


COUNTERS = Counters()

# ops that draw from ctx.generator: a replayed graph would repeat the
# captured draw, so a block holding one runs eager
RANDOM_OPS = frozenset({"uniform_random", "gaussian_random", "dropout"})

# ops that take a SelectedRows input as it is (executor.py:384): the sparse
# sum, the optimizers with a sparse apply and their fused buckets. Any other
# op densifies it at its boundary, counted as `sparse_unaware_op`.
_SPARSE_AWARE_OPS = frozenset(
    {"sum"} | set(sparse_ops.SPARSE_APPLY_OPS)
    | {"fused_sparse_" + t for t in sparse_ops.SPARSE_APPLY_OPS})


def _fetched(v):
    """A fetch as a dense tensor: a SelectedRows value densifies, counted."""
    return maybe_dense(v, count_as="fetch")


def _accepts_sparse_slots(reader) -> bool:
    """Whether a run_steps reader's next_window takes `sparse_slots`."""
    import inspect
    try:
        params = inspect.signature(reader.next_window).parameters
    except (TypeError, ValueError):
        return False
    return "sparse_slots" in params


def liveness(ops, groups) -> Dict[int, List[str]]:
    """position -> the names whose last reader or writer runs there, for
    `_run_block` to drop after it. A window's members all count at its end
    index (it runs as one unit), so what a window reads lives until it
    has run."""
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
        i = pos + 1
    drops: Dict[int, List[str]] = {}
    for n, pos in last.items():
        drops.setdefault(pos, []).append(n)
    return drops


# at most this many step signatures keep a graph on one Executor; the one
# run least recently goes first
GRAPH_CACHE_SIZE = 8


def capture_graph(body, pool=None, keep=False):
    """A CUDA graph of what `body()` launches on the current device, its
    memory drawn from `pool` (another graph's, `graph.pool()`) when given.
    Only this thread's calls are checked during the capture, so a feeder's
    copy thread goes on beside it. With `keep` the graph keeps its nodes
    past instantiation, for `graph.debug_dump` to list them."""
    graph = torch.cuda.CUDAGraph(keep_graph=keep)
    with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
        body()
    if keep:
        graph.instantiate()
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
        self.written: Dict[str, torch.Tensor] = {}


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
        env = self._env_after(feed, state)
        return [env[n] for n in self.fetch_names]

    def _env_after(self, feed, state) -> Dict[str, Any]:
        """The environment after one eager run: fetches, persistable
        outputs and state."""
        env = dict(state)
        env.update(feed)
        ctx = LoweringContext(self.executor, self.program, 0)
        ctx.folds = self.folds
        self.executor._run_block(ctx, self.program, env, self.groups,
                                 self.protected, self.drops, self.keep)
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
            fetches[:] = self.run(feeds, state)

        try:
            graph = capture_graph(body, pool)
        except Exception as e:
            raise RuntimeError(
                f"CUDA graph capture of a serving bucket "
                f"({ {n: tuple(v.shape) for n, v in feeds.items()} }) "
                f"failed ({type(e).__name__}: {e})") from e
        return BucketGraph(feeds, graph, fetches)


def default_place() -> Place:
    """CUDAPlace(0) in one process; in a process group, the card of this
    rank on its host."""
    if not dist.is_initialized():
        return CUDAPlace(0)
    return CUDAPlace(int(os.environ.get("LOCAL_RANK", dist.get_rank())))


def _names(fetch_list) -> List[str]:
    return [v.name if isinstance(v, Variable) else str(v)
            for v in (fetch_list or [])]


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
    hot-row cache). `use_jit=False` runs eager. Either way an env entry
    goes once its last reader has run (`liveness`), unless it is fetched,
    a persistable output or state.

    A program with a hot-row embedding cache (parallel/emb_cache.py) has
    its cached ids remapped to slab slots on the host before they cross
    (`prepare_feed`), and records the end of each run for the cache's
    copy stream (`window_dispatched`)."""

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

    # --- public API ---------------------------------------------------------
    def run(self, program: Optional[Program] = None, feed: Optional[Dict] = None,
            fetch_list: Optional[Sequence] = None, scope: Optional[Scope] = None,
            return_numpy: bool = True, use_program_cache: bool = True,
            use_jit: Optional[bool] = None):
        """Run the global block once: feeds in, fetches out, persistable
        outputs written back to `scope`. On a CUDA place an admitted block
        runs graphed (see the class), unless `use_jit` is False or
        `use_program_cache` is False."""
        program = program if program is not None else default_main_program()
        scope = scope if scope is not None else global_scope()
        fetch_names = _names(fetch_list)
        cache = getattr(program, "_emb_cache", None)
        if cache is not None and feed:
            feed = cache.prepare_feed(feed)
        feed_vals = {n: _to_device(v, self.device)
                     for n, v in (feed or {}).items()}
        state_names = self._resolve_state(program, feed_vals, scope)
        persist_out = self._persistable_outputs(program)
        state = {n: _to_device(scope.find_var(n), self.device)
                 for n in state_names}
        rng_counter = scope.find_var("__rng_counter__") or 0
        reason = self.graph_gate(program, feed_vals, use_jit,
                                 use_program_cache)
        fetch, written = self._step(program, state, feed_vals, fetch_names,
                                    persist_out, rng_counter, reason)
        if cache is not None:
            cache.window_dispatched()
        scope.set_var("__rng_counter__", rng_counter + 1)
        for n, v in written.items():
            scope.set_var(n, v)
        return [to_numpy(v) for v in fetch] if return_numpy else fetch

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
        runs."""
        if fetch_mode not in ("last", "stack", "mean"):
            raise ValueError(f"fetch_mode must be last|stack|mean, "
                             f"got {fetch_mode!r}")
        program = program if program is not None else default_main_program()
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
        stacked, steps = _normalize_window(feed_window, steps)
        if cache is not None:
            stacked = cache.prepare_feed(stacked)
        if steps < 1:
            raise ValueError(f"steps must be >= 1, got {steps}")
        block = program.global_block()
        for n in stacked:
            if block.has_var(n) and block.var(n).lod_level > 0:
                raise NotImplementedError(
                    f"feed '{n}' is a sequence (lod_level "
                    f"{block.var(n).lod_level}): LoD feeds come with the "
                    f"port's LoD slice (ROADMAP Queue 1, slice 8)")
        fetch_names = _names(fetch_list)
        feed_vals = {n: _to_device(v, self.device) for n, v in stacked.items()}
        state_names = self._resolve_state(program, feed_vals, scope)
        persist_out = self._persistable_outputs(program)
        state = {n: _to_device(scope.find_var(n), self.device)
                 for n in state_names}
        rng_counter = scope.find_var("__rng_counter__") or 0
        fetched, written = [], {}
        for i in range(steps):
            feed_i = {n: v[i] for n, v in feed_vals.items()}
            reason = self.graph_gate(program, feed_i, use_jit, True)
            fetch, out = self._step(program, state, feed_i, fetch_names,
                                    persist_out, rng_counter + i, reason,
                                    hand_out=i == steps - 1)
            written.update(out)
            state.update({n: v for n, v in out.items() if n in state})
            fetched.append(fetch)
        if cache is not None:
            cache.window_dispatched()
        scope.set_var("__rng_counter__", rng_counter + steps)
        for n, v in written.items():
            scope.set_var(n, v)
        COUNTERS.windows += 1
        COUNTERS.steps += steps
        if fetch_mode == "last":
            out = fetched[-1]
        else:
            out = [torch.stack([f[j] for f in fetched])
                   for j in range(len(fetch_names))]
            if fetch_mode == "mean":
                out = [t.mean(0) if t.is_floating_point()
                       else t.double().mean(0) for t in out]
        return [to_numpy(v) for v in out] if return_numpy else out

    def prepare_serving(self, program: Program, feed_names: Sequence[str],
                        fetch_names: Sequence[str], scope: Scope) -> PreparedProgram:
        """Resolve one inference program's state names once, for the
        serving engine (the JAX package's executor.py:2021). Raises the
        same missing-state error as run() when the startup never ran."""
        feed_names = sorted(feed_names)
        state_names = self._resolve_state(program, feed_names, scope)
        return PreparedProgram(self, program, feed_names, list(fetch_names),
                               state_names, self._persistable_outputs(program))

    def graph_gate(self, program, feed, use_jit=None,
                   use_program_cache=True) -> Optional[str]:
        """None when a step of `program` on `feed` may run as a CUDA graph,
        else the reason it runs eager: "use_jit" (use_jit=False), "cpu"
        (not a CUDA place), "no_program_cache" (use_program_cache=False),
        "random_op" (the block draws random numbers: a replay would repeat
        the captured draw), "lod_feed" (a sequence feed)."""
        if use_jit is False:
            return "use_jit"
        if self.device.type != "cuda":
            return "cpu"
        if not use_program_cache:
            return "no_program_cache"
        if self._block_plan(program)[2]:
            return "random_op"
        block = program.global_block()
        if any(block.has_var(n) and block.var(n).lod_level > 0
               for n in feed):
            return "lod_feed"
        return None

    # --- analysis -----------------------------------------------------------
    def _analysis(self, program):
        """Per-(program, version) read/write sets and persistable map of
        the global block."""
        key = (id(program), program._version)
        hit = self._analysis_cache.get(key)
        if hit is not None and hit[0] is program:
            return hit[1:]
        reads, writes, produced = set(), set(), set()
        for op in program.global_block().ops:
            if op.type in ("feed", "fetch"):
                continue
            reads.update(n for n in op.input_arg_names if n not in produced)
            produced.update(op.output_arg_names)
            writes.update(op.output_arg_names)
        persistable = {name for b in program.blocks
                       for name, v in b.desc.vars.items() if v.persistable}
        # keep a strong program ref: the key uses id(program)
        self._analysis_cache[key] = (program, reads, writes, persistable)
        return reads, writes, persistable

    def _external_inputs(self, program, fed: set, scope) -> List[str]:
        """Vars the block reads from the scope: present scope vars or
        declared persistables."""
        reads, _writes, persistable = self._analysis(program)
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
        _reads, writes, persistable = self._analysis(program)
        return [n for n in sorted(writes) if n in persistable]

    def _block_plan(self, program):
        """(fusion plan, liveness drops, holds a random op) of the global
        block, once per (program, version)."""
        key = (id(program), program._version)
        hit = self._plans.get(key)
        if hit is None or hit[0] is not program:
            ops = program.global_block().ops
            groups = fusion_mod.plan(program)
            hit = self._plans[key] = (program, groups, liveness(ops, groups),
                                      any(o.type in RANDOM_OPS for o in ops))
        return hit[1:]

    def _plan(self, program):
        return self._block_plan(program)[0]

    # --- execution ----------------------------------------------------------
    def _step(self, program, state, feed, fetch_names, persist_out,
              rng_counter, reason, hand_out=True):
        """One step from `state` and `feed`: (fetch tensors, the persistable
        outputs by name). `reason` is the graph gate's answer: None runs
        the signature's graph (warming it up first), else eager, counted
        by reason. `hand_out=False` (a run_steps step before the last)
        lets a replay return the state buffers themselves, for the next
        step to read in place."""
        if reason is None:
            # the state's names are sorted (_resolve_state)
            base = (id(program), program._version,
                    tuple((n, v.shape, v.dtype)
                          for n, v in sorted(feed.items())),
                    tuple(fetch_names), tuple(state),
                    tuple(v.shape for v in state.values()),
                    tuple(v.dtype for v in state.values()),
                    getattr(program, "_amp_dtype", None),
                    getattr(program, "_amp_level", "O1"),
                    quant.cache_token(program), sparse_ops.cache_token(program),
                    program.random_seed)
            # a graph updates the in-place state of the scope it was
            # captured on: those tensors' identities are part of its key
            names = self._inplace_names.get(base)
            key = None if names is None else base + (
                _identities(state, names),)
            entry = None if key is None else self._graphs.get(key)
            if entry is None:
                entry = _GraphedStep()
                COUNTERS.warmups += 1
            else:
                self._graphs.move_to_end(key)
                return self._graphed(entry, program, state, feed,
                                     fetch_names, persist_out, rng_counter,
                                     hand_out)
        else:
            COUNTERS.eager[reason] = COUNTERS.eager.get(reason, 0) + 1
        env = dict(state)
        env.update(feed)
        ctx = LoweringContext(self, program, rng_counter)
        groups, drops, _ = self._block_plan(program)
        protected = set(fetch_names) | set(persist_out)
        self._run_block(ctx, program, env, groups, protected, drops,
                        protected | set(state))
        if reason is None:
            # the warm-up: a persistable output that is its state tensor
            # itself was updated in place (the sparse applies' tables)
            entry.inplace = {n for n in persist_out
                             if n in state and env.get(n) is state[n]}
            self._inplace_names[base] = entry.inplace
            self._graphs[base + (_identities(state, entry.inplace),)] = entry
            self._evict()
        return ([_fetched(env[n]) for n in fetch_names],
                {n: env[n] for n in persist_out if n in env})

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
                 fetch_names, persist_out, rng_counter, hand_out=True):
        """Capture `entry` on its first call, then replay it: a state
        tensor its buffer does not hold copied in, the feeds copied into
        their buffers. The scope is handed copies of the persistable
        outputs, never a buffer, except the state the step updates in
        place, whose buffer is the scope's tensor. A capture that fails
        raises; nothing runs eager in its place."""
        if entry.graph is None:
            self._capture(entry, program, state, feed, fetch_names,
                          persist_out, rng_counter)
        for n, b in entry.state.items():
            v = state[n]
            if not b.holds(v):
                b.t.copy_(v)
                b.source(v)
                COUNTERS.copied_in += 1
        for n, buf in entry.feeds.items():
            buf.copy_(feed[n])
        entry.graph.replay()
        COUNTERS.replays += 1
        # the fetches and the outputs outside the state live in the shared
        # pool, where the next graph's replay may write: copied out now
        fetch = [t.clone() for t in entry.fetches]
        bufs = [entry.state[n] for n in entry.persist]
        if not hand_out:
            for b in bufs:
                b.source(None)
            return fetch, {n: b.t for n, b in zip(entry.persist, bufs)}
        copied = [n for n in entry.persist if n not in entry.inplace]
        copies = _copies([entry.state[n].t for n in copied]
                         + list(entry.written.values()))
        for n, c in zip(copied, copies):
            entry.state[n].source(c)
        out = dict(zip(copied + list(entry.written), copies))
        out.update((n, entry.state[n].t) for n in entry.persist
                   if n in entry.inplace)
        return fetch, out

    def _capture(self, entry: _GraphedStep, program, state, feed,
                 fetch_names, persist_out, rng_counter):
        entry.state = {n: self._buffer(n, v, n in entry.inplace)
                       for n, v in state.items()}
        entry.persist = [n for n in persist_out if n in entry.state]
        entry.feeds = {n: v.clone() for n, v in feed.items()}
        groups, drops, _ = self._block_plan(program)
        protected = set(fetch_names) | set(persist_out)

        def body():
            env = {n: b.t for n, b in entry.state.items()}
            env.update(entry.feeds)
            ctx = LoweringContext(self, program, rng_counter)
            self._run_block(ctx, program, env, groups, protected, drops,
                            protected | set(state))
            for n in entry.persist:
                buf = entry.state[n].t
                if env[n] is not buf:
                    buf.copy_(env[n])
            entry.fetches = [_fetched(env[n]) for n in fetch_names]
            entry.written = {n: env[n] for n in persist_out
                             if n in env and n not in entry.state}

        try:
            graph = capture_graph(body, self._pool)
        except Exception as e:
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
        i = 0
        while i < len(ops):
            g = groups.get(i)
            if g is not None:
                with registry.span(fusion_mod.span_name(g)):
                    fusion_mod.execute_group(self, ctx, g, env, protected)
                i = g.end
            else:
                self._exec_op(ctx, ops[i], env)
                i += 1
            if drops:
                for n in drops.get(i - 1, ()):
                    if n not in keep:
                        env.pop(n, None)

    def _exec_op(self, ctx: LoweringContext, op, env: Dict[str, Any]):
        if op.type in ("feed", "fetch"):
            return
        try:
            opdef = registry.get(op.type)
        except KeyError as e:
            raise RuntimeError(f"Operator '{op.type}' is not registered in "
                               f"the port (outputs {op.output_arg_names})") from e
        if opdef.lower is None:
            raise RuntimeError(f"Operator '{op.type}' has no lowering")
        ins = {slot: [env.get(n) for n in names]
               for slot, names in op.desc.inputs.items()}
        if op.type not in _SPARSE_AWARE_OPS and any(
                isinstance(v, SelectedRowsVal)
                for vals in ins.values() for v in vals):
            # a SelectedRows value densifies at the boundary of an op with
            # no sparse path (executor.py:1620), counted
            sparse_ops.count_densify(op.type, "sparse_unaware_op")
            ins = {slot: [maybe_dense(v) for v in vals]
                   for slot, vals in ins.items()}
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
                f"  built at: {op.creation_site or '<unknown>'}") from e
        for slot, names in op.desc.outputs.items():
            for name, val in zip(names, outs.get(slot, [])):
                if val is not None:
                    env[name] = val
