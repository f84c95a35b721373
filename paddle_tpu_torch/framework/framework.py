"""Program/Block/Variable/Operator graph model.

The port's counterpart of paddle_tpu/framework/framework.py (reference:
python/paddle/fluid/framework.py:117 Variable, :361 Operator, :644 Block,
:940 Program, :1118 Parameter). The user builds a Program whose desc is the
serializable IR in `desc.py`; the port's executor interprets the global
block op by op on torch tensors.
"""

from __future__ import annotations

import contextlib
import copy
import os
import sys
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from . import unique_name
from .desc import BlockDesc, BlockRef, BlocksRef, OpDesc, ProgramDesc, VarDesc, VarType

__all__ = [
    "Variable",
    "Operator",
    "Block",
    "Program",
    "Parameter",
    "default_main_program",
    "default_startup_program",
    "switch_main_program",
    "switch_startup_program",
    "program_guard",
    "GRAD_VAR_SUFFIX",
    "grad_var_name",
]

GRAD_VAR_SUFFIX = "@GRAD"


def grad_var_name(name: str) -> str:
    return name + GRAD_VAR_SUFFIX


def op_external_reads(program, op) -> set:
    """Names an op reads, including everything its sub-blocks read from
    outside themselves (reference prune.cc:181 recurses into block attrs)."""
    reads = set(op.input_arg_names)
    sub_idxs = []
    for a in op.desc.attrs.values():
        if isinstance(a, BlockRef):
            sub_idxs.append(a.idx)
        elif isinstance(a, BlocksRef):
            sub_idxs.extend(a.idxs)
    seen = set()
    while sub_idxs:
        si = sub_idxs.pop()
        if si in seen:
            continue
        seen.add(si)
        sub = program.block(si)
        produced = set()
        for sop in sub.ops:
            for name in sop.input_arg_names:
                if name not in produced and not sub.desc.has_var(name):
                    reads.add(name)
            produced.update(sop.output_arg_names)
            for a in sop.desc.attrs.values():
                if isinstance(a, BlockRef):
                    sub_idxs.append(a.idx)
                elif isinstance(a, BlocksRef):
                    sub_idxs.extend(a.idxs)
    return reads


_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _user_frame() -> Optional[str]:
    """file:line of the first stack frame outside the package."""
    try:
        f = sys._getframe(2)
    except ValueError:
        return None
    while f is not None:
        fn = f.f_code.co_filename
        if not fn.startswith(_PKG_DIR):
            return f"{fn}:{f.f_lineno}"
        f = f.f_back
    return None


_np_dtype_names = {
    "float16", "bfloat16", "float32", "float64",
    "int8", "int16", "int32", "int64", "uint8", "bool",
}


def convert_dtype(dtype) -> str:
    """Normalize a dtype spec (np.dtype, str, torch.dtype) to a canonical
    numpy-style name; bf16 is spelled "bfloat16" as in the JAX package."""
    if dtype is None:
        return "float32"
    if isinstance(dtype, str):
        name = dtype
    elif isinstance(dtype, torch.dtype):
        name = str(dtype)[len("torch."):]
    else:
        name = np.dtype(dtype).name
    if name not in _np_dtype_names:
        name = np.dtype(name).name
    if name not in _np_dtype_names:
        raise ValueError(f"unsupported dtype {dtype!r}")
    return name


class Variable:
    """Compile-time variable handle inside a Block (reference
    framework.py:117). Holds no data; runtime values live in a Scope."""

    def __init__(
        self,
        block: "Block",
        name: Optional[str] = None,
        shape: Optional[Iterable[int]] = None,
        dtype=None,
        lod_level: Optional[int] = None,
        type: VarType = VarType.LOD_TENSOR,
        persistable: Optional[bool] = None,
        stop_gradient: bool = False,
        **kwargs,
    ):
        self.block = block
        if name is None:
            name = unique_name.generate("_generated_var")
        if block.desc.has_var(name):
            # re-opening an existing var (startup/main share parameter
            # names): merge, verifying compatible metadata
            d = block.desc.var(name)
            if shape is not None and d.shape is not None and \
                    list(shape) != list(d.shape):
                raise ValueError(f"Variable {name} re-declared with shape "
                                 f"{list(shape)} != {d.shape}")
            if shape is not None:
                d.shape = list(shape)
            if dtype is not None:
                d.dtype = convert_dtype(dtype)
            if lod_level is not None:
                d.lod_level = lod_level
            if persistable is not None:
                d.persistable = persistable
        else:
            d = VarDesc(
                name=name,
                type=type,
                dtype=convert_dtype(dtype),
                shape=list(shape) if shape is not None else None,
                lod_level=lod_level or 0,
                persistable=bool(persistable),
                stop_gradient=stop_gradient,
            )
            block.desc.vars[name] = d
        self.desc = d
        self.stop_gradient = stop_gradient
        block.vars[name] = self

    @property
    def name(self) -> str:
        return self.desc.name

    @property
    def shape(self):
        return tuple(self.desc.shape) if self.desc.shape is not None else None

    @property
    def dtype(self) -> str:
        return self.desc.dtype

    @property
    def lod_level(self) -> int:
        return self.desc.lod_level

    @property
    def type(self) -> VarType:
        return self.desc.type

    @property
    def persistable(self) -> bool:
        return self.desc.persistable

    @persistable.setter
    def persistable(self, p: bool):
        self.desc.persistable = p
        self.block.program._version += 1

    def __str__(self):
        return (f"Variable(name={self.name}, shape={self.shape}, "
                f"dtype={self.dtype}, type={self.type.value})")

    __repr__ = __str__


class Operator:
    """Compile-time operator inside a Block (reference framework.py:361).
    Appending an operator runs shape inference via the op registry."""

    def __init__(self, block: "Block", desc: OpDesc):
        self.block = block
        self.desc = desc
        # the user line that built the op, for executor error messages
        self.creation_site = _user_frame()

    @property
    def type(self) -> str:
        return self.desc.type

    @property
    def input_arg_names(self):
        return self.desc.input_arg_names()

    @property
    def output_arg_names(self):
        return self.desc.output_arg_names()

    def input(self, slot):
        return self.desc.input(slot)

    def output(self, slot):
        return self.desc.output(slot)

    def attr(self, name, default=None):
        return self.desc.attr(name, default)

    def set_attr(self, name, val):
        self.desc.attrs[name] = val

    def __str__(self):
        return (f"Op(type={self.type}, inputs={dict(self.desc.inputs)}, "
                f"outputs={dict(self.desc.outputs)})")

    __repr__ = __str__


class Block:
    """An ordered op list plus a var table (reference framework.py:644)."""

    def __init__(self, program: "Program", idx: int):
        self.program = program
        self.desc: BlockDesc = program.desc.block(idx)
        self.vars: Dict[str, Variable] = {}
        self.ops: List[Operator] = []

    @property
    def idx(self) -> int:
        return self.desc.idx

    @property
    def parent_idx(self) -> int:
        return self.desc.parent_idx

    @property
    def parent_block(self) -> Optional["Block"]:
        if self.desc.parent_idx < 0:
            return None
        return self.program.block(self.desc.parent_idx)

    def create_var(self, **kwargs) -> Variable:
        return Variable(self, **kwargs)

    def var_recursive(self, name: str) -> Variable:
        b: Optional[Block] = self
        while b is not None:
            if b.has_var(name):
                return b.var(name)
            b = b.parent_block
        raise ValueError(f"Variable {name} not found in block chain from "
                         f"{self.idx}")

    def has_var_recursive(self, name: str) -> bool:
        b: Optional[Block] = self
        while b is not None:
            if b.has_var(name):
                return True
            b = b.parent_block
        return False

    def all_parameters(self) -> List["Parameter"]:
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def create_parameter(self, **kwargs) -> "Parameter":
        # parameters always live in the global (root) block
        return Parameter(self.program.global_block(), **kwargs)

    def has_var(self, name: str) -> bool:
        return name in self.vars or self.desc.has_var(name)

    def var(self, name: str) -> Variable:
        v = self.vars.get(name)
        if v is not None:
            return v
        if self.desc.has_var(name):
            # materialize a wrapper for a desc-only var (e.g. after clone)
            d = self.desc.vars[name]
            v = Variable.__new__(Variable)
            v.block = self
            v.desc = d
            v.stop_gradient = d.stop_gradient
            self.vars[name] = v
            return v
        raise ValueError(f"Variable {name} not found in block {self.idx}")

    def _make_op(self, type: str, inputs=None, outputs=None, attrs=None) -> OpDesc:
        def norm(d):
            out = {}
            for k, v in (d or {}).items():
                if v is None:
                    continue
                if isinstance(v, (Variable, str)):
                    v = [v]
                out[k] = [x.name if isinstance(x, Variable) else x for x in v]
            return out

        return OpDesc(type=type, inputs=norm(inputs), outputs=norm(outputs),
                      attrs=dict(attrs or {}))

    def append_op(self, type: str, inputs=None, outputs=None, attrs=None) -> Operator:
        desc = self._make_op(type, inputs, outputs, attrs)
        op = Operator(self, desc)
        self.desc.ops.append(desc)
        self.ops.append(op)
        self.program._version += 1
        self._infer_shape(op)
        return op

    def _infer_shape(self, op: Operator):
        from ..ops import registry  # local import to avoid a cycle
        opdef = registry.try_get(op.type)
        if opdef is None:
            raise ValueError(f"Operator type '{op.type}' is not registered "
                             f"in the port")
        if opdef.infer_shape is not None:
            opdef.infer_shape(op, self)

    def _sync_ops(self):
        """Rebuild Operator wrappers from desc (after clone/deserialize)."""
        self.ops = [Operator(self, d) for d in self.desc.ops]
        for name in list(self.desc.vars):
            self.var(name)


class Program:
    """A whole computation: list of blocks (reference framework.py:940)."""

    def __init__(self):
        self.desc = ProgramDesc()
        self.blocks: List[Block] = [Block(self, 0)]
        self.current_block_idx = 0
        self._seed = 0
        # bumped on every op append/remove so cached plans (fusion.plan,
        # the executor's analysis) never serve a mutated program
        self._version = 0
        # the device mesh a sequence-parallel op runs over (parallel/mesh.py)
        self._mesh = None
        # grad var name -> forward var name, filled by append_backward
        self.grad_info_map: Dict[str, str] = {}

    @property
    def random_seed(self) -> int:
        return self._seed

    @random_seed.setter
    def random_seed(self, s: int):
        self._seed = int(s)

    def global_block(self) -> Block:
        return self.blocks[0]

    def block(self, idx: int) -> Block:
        return self.blocks[idx]

    def current_block(self) -> Block:
        return self.blocks[self.current_block_idx]

    def list_vars(self):
        """Every variable of every block (JAX framework.py:443)."""
        for b in self.blocks:
            yield from b.vars.values()

    def clone(self, for_test: bool = False) -> "Program":
        """Deep-copy the program (reference Program.clone). for_test=True
        sets every `is_test` attr, as the JAX package's clone does. The AMP
        policy (`_amp_dtype`/`_amp_level`), the mesh and the feed layouts
        (`_feed_shardings`) ride along: they are program state the desc
        does not carry. The quant mode does not, as in the JAX package
        (framework.py:460-469): a clone of an O3 program runs as O2."""
        p = Program()
        p.desc = ProgramDesc.from_json(self.desc.to_json())
        p._seed = self._seed
        p._mesh = getattr(self, "_mesh", None)
        p.grad_info_map = dict(self.grad_info_map)
        for attr in ("_amp_dtype", "_amp_level", "_feed_shardings"):
            if hasattr(self, attr):
                val = getattr(self, attr)
                setattr(p, attr, dict(val) if isinstance(val, dict) else val)
        p.blocks = [Block(p, i) for i in range(len(p.desc.blocks))]
        for b in p.blocks:
            b._sync_ops()
            src = self.blocks[b.idx]
            for name, v in src.vars.items():
                if isinstance(v, Parameter) and name in b.vars:
                    param = Parameter.__new__(Parameter)
                    param.__dict__.update(b.vars[name].__dict__)
                    param.trainable = v.trainable
                    param.optimize_attr = copy.copy(v.optimize_attr)
                    param.regularizer = v.regularizer
                    param.gradient_clip_attr = v.gradient_clip_attr
                    param.do_model_average = v.do_model_average
                    b.vars[name] = param
        if for_test:
            for b in p.blocks:
                for op in b.ops:
                    if "is_test" in op.desc.attrs:
                        op.set_attr("is_test", True)
        p.current_block_idx = 0
        return p

    def prune(self, feeds: List[str], fetches: List[str]) -> "Program":
        """Dead-op elimination from fetch targets (reference prune.cc:181):
        keeps, in the root block, only ops on a path to `fetches` given that
        `feeds` are provided. Backward/optimize-role ops reached only
        through an in-place persistable update are dropped, as in the JAX
        package (framework.py Program.prune)."""
        pruned = self.clone()
        block = pruned.global_block()

        def _persistable(name):
            return block.desc.has_var(name) and block.desc.var(name).persistable

        needed = set(fetches)
        keep: List[int] = []
        for i in range(len(block.ops) - 1, -1, -1):
            op = block.ops[i]
            hit = needed & set(op.output_arg_names)
            if hit:
                if op.desc.attrs.get("op_role") in ("backward", "optimize") \
                        and all(_persistable(n) for n in hit):
                    continue
                keep.append(i)
                for name in op_external_reads(pruned, op):
                    if name not in feeds:
                        needed.add(name)
        keep.reverse()
        block.desc.ops = [block.desc.ops[i] for i in keep]
        block._sync_ops()
        used = set(feeds) | set(fetches)
        for op in block.ops:
            used |= op_external_reads(pruned, op) | set(op.output_arg_names)
        for name in list(block.desc.vars):
            if name not in used:
                del block.desc.vars[name]
                block.vars.pop(name, None)
        return pruned

    def to_json(self) -> str:
        return self.desc.to_json()

    @staticmethod
    def from_json(s: str) -> "Program":
        p = Program()
        p.desc = ProgramDesc.from_json(s)
        p.blocks = [Block(p, i) for i in range(len(p.desc.blocks))]
        for b in p.blocks:
            b._sync_ops()
        return p

    def __str__(self):
        lines = []
        for b in self.blocks:
            lines.append(f"block {b.idx} (parent {b.parent_idx}):")
            for name, v in sorted(b.desc.vars.items()):
                tag = " [persistable]" if v.persistable else ""
                lines.append(f"  var {name}: {v.dtype}{v.shape}{tag}")
            for op in b.ops:
                lines.append(f"  {op}")
        return "\n".join(lines)


class Parameter(Variable):
    """A persistable, trainable variable (reference framework.py:1118)."""

    def __init__(self, block: Block, shape=None, dtype=None, **kwargs):
        if shape is None or not all(s > 0 for s in shape):
            raise ValueError(f"Parameter shape must be static, got {shape}")
        self.trainable = kwargs.pop("trainable", True)
        self.optimize_attr = kwargs.pop("optimize_attr", {"learning_rate": 1.0})
        self.regularizer = kwargs.pop("regularizer", None)
        self.gradient_clip_attr = kwargs.pop("gradient_clip_attr", None)
        self.do_model_average = kwargs.pop("do_model_average", None)
        super().__init__(block, shape=shape, dtype=dtype, persistable=True, **kwargs)


# --- default programs -------------------------------------------------------

_main_program = Program()
_startup_program = Program()


def default_main_program() -> Program:
    return _main_program


def default_startup_program() -> Program:
    return _startup_program


def switch_main_program(program: Program) -> Program:
    global _main_program
    old, _main_program = _main_program, program
    return old


def switch_startup_program(program: Program) -> Program:
    global _startup_program
    old, _startup_program = _startup_program, program
    return old


@contextlib.contextmanager
def program_guard(main_program: Program, startup_program: Optional[Program] = None):
    old_main = switch_main_program(main_program)
    old_startup = None
    if startup_program is not None:
        old_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(old_main)
        if old_startup is not None:
            switch_startup_program(old_startup)
