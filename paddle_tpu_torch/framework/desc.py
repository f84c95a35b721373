"""Serializable program IR: ProgramDesc / BlockDesc / OpDesc / VarDesc.

The port's own copy of paddle_tpu/framework/desc.py (the two packages share
no code, and a program serialized by one loads in the other). A rebuild of
the reference's protobuf IR schema
(reference: paddle/fluid/framework/framework.proto:19,34,64,94-176). The
semantics match — a program is a list of blocks; a block owns named variables
and an ordered op list; ops name their inputs/outputs through parameter slots
(each slot holds a list of variable names) and carry typed attributes,
including references to sub-blocks for control flow. Rather than protobuf we
use plain dataclasses with a stable JSON round-trip, which is all the
serialization surface the framework needs (save/load_inference_model).
"""

from __future__ import annotations

import dataclasses
import enum
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


class VarType(enum.Enum):
    # Tensor-ish types (reference framework.proto:94-176).
    LOD_TENSOR = "lod_tensor"
    SELECTED_ROWS = "selected_rows"
    LOD_TENSOR_ARRAY = "lod_tensor_array"
    LOD_RANK_TABLE = "lod_rank_table"
    # Executor plumbing types.
    FEED_MINIBATCH = "feed_minibatch"
    FETCH_LIST = "fetch_list"
    STEP_SCOPES = "step_scopes"
    READER = "reader"
    RAW = "raw"


# Attribute values are restricted to JSON-serializable shapes: bool, int,
# float, str, lists/tuples thereof, and ints naming sub-blocks (reference
# OpDesc::Attr with BlockDesc attrs, framework.proto:34-63). Block references
# are stored as {"__block__": idx} and tuples as {"__tuple__": [...]} so
# round-trips are unambiguous — a tuple-valued attr (e.g. an axes pair an op
# compares with `== (0, 1)`) must come back a tuple, not a list.
@dataclass
class BlockRef:
    idx: int


@dataclass
class BlocksRef:
    idxs: List[int]


@dataclass
class VarDesc:
    name: str
    type: VarType = VarType.LOD_TENSOR
    dtype: str = "float32"           # numpy dtype name; bf16 spelled "bfloat16"
    shape: Optional[List[int]] = None  # -1 = unknown/dynamic (batch) dim
    lod_level: int = 0
    persistable: bool = False
    stop_gradient: bool = False

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["type"] = self.type.value
        return d

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "VarDesc":
        d = dict(d)
        d["type"] = VarType(d["type"])
        return VarDesc(**d)


def _attr_to_json(v: Any) -> Any:
    if isinstance(v, BlockRef):
        return {"__block__": v.idx}
    if isinstance(v, BlocksRef):
        return {"__blocks__": v.idxs}
    if isinstance(v, tuple):
        return {"__tuple__": [_attr_to_json(x) for x in v]}
    if isinstance(v, list):
        return [_attr_to_json(x) for x in v]
    return v


def _attr_from_json(v: Any) -> Any:
    if isinstance(v, dict) and "__block__" in v:
        return BlockRef(v["__block__"])
    if isinstance(v, dict) and "__blocks__" in v:
        return BlocksRef(v["__blocks__"])
    if isinstance(v, dict) and "__tuple__" in v:
        return tuple(_attr_from_json(x) for x in v["__tuple__"])
    if isinstance(v, list):
        # pre-__tuple__ JSON stored tuples as bare lists; those load as
        # lists (the old, lossy behavior) — only new dumps round-trip
        return [_attr_from_json(x) for x in v]
    return v


@dataclass
class OpDesc:
    type: str
    # slot name -> list of variable names (reference OpDesc.Var, framework.proto:40)
    inputs: Dict[str, List[str]] = field(default_factory=dict)
    outputs: Dict[str, List[str]] = field(default_factory=dict)
    attrs: Dict[str, Any] = field(default_factory=dict)

    def input(self, slot: str) -> List[str]:
        return self.inputs.get(slot, [])

    def output(self, slot: str) -> List[str]:
        return self.outputs.get(slot, [])

    def input_arg_names(self) -> List[str]:
        return [n for names in self.inputs.values() for n in names]

    def output_arg_names(self) -> List[str]:
        return [n for names in self.outputs.values() for n in names]

    def attr(self, name: str, default: Any = None) -> Any:
        return self.attrs.get(name, default)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "type": self.type,
            "inputs": {k: list(v) for k, v in self.inputs.items()},
            "outputs": {k: list(v) for k, v in self.outputs.items()},
            "attrs": {k: _attr_to_json(v) for k, v in self.attrs.items()},
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "OpDesc":
        return OpDesc(
            type=d["type"],
            inputs={k: list(v) for k, v in d.get("inputs", {}).items()},
            outputs={k: list(v) for k, v in d.get("outputs", {}).items()},
            attrs={k: _attr_from_json(v) for k, v in d.get("attrs", {}).items()},
        )


@dataclass
class BlockDesc:
    idx: int = 0
    parent_idx: int = -1
    vars: Dict[str, VarDesc] = field(default_factory=dict)
    ops: List[OpDesc] = field(default_factory=list)
    # forward block this block is the grad of (-1 = none), mirrors
    # reference BlockDesc.forward_block_idx
    forward_block_idx: int = -1

    def var(self, name: str) -> VarDesc:
        return self.vars[name]

    def has_var(self, name: str) -> bool:
        return name in self.vars

    def to_dict(self) -> Dict[str, Any]:
        return {
            "idx": self.idx,
            "parent_idx": self.parent_idx,
            "forward_block_idx": self.forward_block_idx,
            "vars": {k: v.to_dict() for k, v in self.vars.items()},
            "ops": [o.to_dict() for o in self.ops],
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "BlockDesc":
        return BlockDesc(
            idx=d["idx"],
            parent_idx=d["parent_idx"],
            forward_block_idx=d.get("forward_block_idx", -1),
            vars={k: VarDesc.from_dict(v) for k, v in d["vars"].items()},
            ops=[OpDesc.from_dict(o) for o in d["ops"]],
        )


@dataclass
class ProgramDesc:
    blocks: List[BlockDesc] = field(default_factory=lambda: [BlockDesc(idx=0)])
    version: int = 1

    def block(self, idx: int) -> BlockDesc:
        return self.blocks[idx]

    def append_block(self, parent_idx: int) -> BlockDesc:
        b = BlockDesc(idx=len(self.blocks), parent_idx=parent_idx)
        self.blocks.append(b)
        return b

    def to_json(self) -> str:
        return json.dumps(
            {"version": self.version, "blocks": [b.to_dict() for b in self.blocks]}
        )

    @staticmethod
    def from_json(s: str) -> "ProgramDesc":
        d = json.loads(s)
        return ProgramDesc(
            version=d.get("version", 1),
            blocks=[BlockDesc.from_dict(b) for b in d["blocks"]],
        )
