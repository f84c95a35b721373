"""Executor: runs a program's global block op by op on a torch device (the
port's counterpart of paddle_tpu/executor.py).

The JAX package traces a whole block into one jitted XLA computation. The
port interprets the block eagerly: every op's lowering runs on torch
tensors on the executor's device, in program order, with the planned
conv -> batch_norm [-> act] windows (ops/fusion.py: the inference fold,
the training kernels) lowered as one unit at their anchor. A training
program's grad and optimizer ops run like any other op; the optimizer's
in-place outputs (parameters, accumulators, batch-norm statistics) are
persistable and go back to the scope at the end of the run. Scope semantics follow the reference (scope.h:38): persistable
variables live in the scope across runs; block temporaries vanish after
the run. Feeds and fetches are dense tensors; LoD feeds wait for a later
slice.

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
import zlib
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .framework.framework import Program, Variable, default_main_program
from .ops import fusion as fusion_mod
from .ops import registry

__all__ = ["CPUPlace", "CUDAPlace", "TPUPlace", "place_device", "Scope",
           "global_scope", "scope_guard", "Executor"]


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
        same program and run draw the same numbers."""
        seed = int(op.attr("seed", 0) or 0)
        outs = op.desc.output_arg_names()
        ident = zlib.crc32(outs[0].encode("utf-8")) if outs else 0
        base = seed if seed else (self._seed * 1_000_003 + self._rng_counter)
        g = torch.Generator(device=self.device)
        g.manual_seed(((base & 0xFFFFFFFF) << 32 | ident) & (2 ** 63 - 1))
        return g


def _to_device(value, device: torch.device) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.to(device)
    return torch.as_tensor(np.asarray(value), device=device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A fetched tensor as numpy; bf16 comes back as float32 (numpy has no
    bfloat16), which is exact."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


class PreparedProgram:
    """One inference program bound to its state names and fusion plan: the
    serving engine's per-bucket "executable" (Executor.prepare_serving)."""

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
        self.protected = set(fetch_names) | set(persist_out)
        self.folds = None

    def fold_weights(self, state: Dict[str, torch.Tensor]):
        """Compute every fold window's filter, channel bias and, under O3,
        int8 filter once from the resident `state`, so no request repeats
        them (fusion.fold_constants)."""
        ctx = LoweringContext(self.executor, self.program, 0)
        self.folds = fusion_mod.fold_constants(ctx, self.groups, state)

    def run(self, feed: Dict[str, torch.Tensor],
            state: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
        env = dict(state)
        env.update(feed)
        ctx = LoweringContext(self.executor, self.program, 0)
        ctx.folds = self.folds
        self.executor._run_block(ctx, self.program, env, self.groups,
                                 self.protected)
        return [env[n] for n in self.fetch_names]


def default_place() -> Place:
    """CUDAPlace(0) in one process; in a process group, the card of this
    rank on its host."""
    if not dist.is_initialized():
        return CUDAPlace(0)
    return CUDAPlace(int(os.environ.get("LOCAL_RANK", dist.get_rank())))


class Executor:
    def __init__(self, place: Optional[Place] = None):
        self.place = place if place is not None else default_place()
        self.device = place_device(self.place)
        self._analysis_cache: Dict[tuple, tuple] = {}
        self._plans: Dict[tuple, tuple] = {}

    # --- public API ---------------------------------------------------------
    def run(self, program: Optional[Program] = None, feed: Optional[Dict] = None,
            fetch_list: Optional[Sequence] = None, scope: Optional[Scope] = None,
            return_numpy: bool = True):
        """Run the global block once: feeds in, fetches out, persistable
        outputs written back to `scope`."""
        program = program if program is not None else default_main_program()
        scope = scope if scope is not None else global_scope()
        fetch_names = [v.name if isinstance(v, Variable) else str(v)
                       for v in (fetch_list or [])]
        feed_vals = {n: _to_device(v, self.device)
                     for n, v in (feed or {}).items()}
        state_names = self._resolve_state(program, feed_vals, scope)
        persist_out = self._persistable_outputs(program)
        env = {n: _to_device(scope.find_var(n), self.device)
               for n in state_names}
        env.update(feed_vals)
        rng_counter = scope.find_var("__rng_counter__") or 0
        ctx = LoweringContext(self, program, rng_counter)
        self._run_block(ctx, program, env, self._plan(program),
                        set(fetch_names) | set(persist_out))
        scope.set_var("__rng_counter__", rng_counter + 1)
        for n in persist_out:
            if n in env:
                scope.set_var(n, env[n])
        fetch = [env[n] for n in fetch_names]
        return [to_numpy(v) for v in fetch] if return_numpy else fetch

    def prepare_serving(self, program: Program, feed_names: Sequence[str],
                        fetch_names: Sequence[str], scope: Scope) -> PreparedProgram:
        """Resolve one inference program's state names once, for the
        serving engine (the JAX package's executor.py:2021). Raises the
        same missing-state error as run() when the startup never ran."""
        feed_names = sorted(feed_names)
        state_names = self._resolve_state(program, feed_names, scope)
        return PreparedProgram(self, program, feed_names, list(fetch_names),
                               state_names, self._persistable_outputs(program))

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

    def _plan(self, program):
        key = (id(program), program._version)
        hit = self._plans.get(key)
        if hit is None or hit[0] is not program:
            hit = self._plans[key] = (program, fusion_mod.plan(program))
        return hit[1]

    # --- execution ----------------------------------------------------------
    def _run_block(self, ctx, program, env, groups, protected):
        ops = program.global_block().ops
        groups = groups or {}
        i = 0
        while i < len(ops):
            g = groups.get(i)
            if g is not None:
                with registry.span("win:" + "+".join(m.type for m in g.members)):
                    fusion_mod.execute_group(self, ctx, g, env, protected)
                i = g.end
            else:
                self._exec_op(ctx, ops[i], env)
                i += 1

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
