"""Checkpoint and inference-model save/load (the port's counterpart of
paddle_tpu/io.py; reference python/paddle/fluid/io.py:66 save_vars, :145
save_persistables, :234 load_persistables, :298 save_inference_model, :383
load_inference_model).

The on-disk format is the JAX package's, so a directory either package
writes loads in the other: one file per variable, named by the variable and
holding a pickled {"tensor": numpy array, "lod": lod or None, "version": 0}
(or one combined pickle {name: (array, lod)} when a file name is given),
and `__model__` holding a pickled {"program": Program.to_json(),
"feed_names", "fetch_names"}. Tensors are written as plain numpy arrays:
float32 weights stay float32, and a bfloat16 value (which numpy spells only
through ml_dtypes) is written as its exact float32 widening, so no reader
needs jax or ml_dtypes.

A loaded variable that carries a LoD is set in the scope as an
`executor.LoDTensor` of its packed rows and LoD, as the JAX package's io
restores it (io.py:151-155), so a run pads it with its lengths; a
LoDTensor in the scope is saved as its rows and LoD. Values come from, and
go to, the current scope (`global_scope()`, or a `scope_guard`), as in the
reference; the executor argument is kept for the API. The JAX package's
checkpoint telemetry is later work.

A program with a hot-row embedding cache (parallel/emb_cache.py) holds
only [cache_rows, dim] slabs in its scope: saving flushes the dirty slots
first and writes each cached table's full host slab in its slab's place
(io.py:56-64), and loading restores into the host slab and invalidates
the residency, so the scope keeps its slab (io.py:146-156). The inference
program of such a program shares its cache.
"""

from __future__ import annotations

import os
import pickle
from typing import List, Optional, Sequence

import numpy as np
import torch

from .executor import LoDTensor, global_scope
from .framework.framework import (Parameter, Program, Variable,
                                  default_main_program, op_external_reads)

__all__ = [
    "save_vars", "save_params", "save_persistables", "load_vars",
    "load_params", "load_persistables", "save_inference_model",
    "load_inference_model", "get_inference_program",
]

def _is_persistable(var: Variable) -> bool:
    return var.persistable


def _is_parameter(var: Variable) -> bool:
    return isinstance(var, Parameter)


def _as_numpy(val) -> np.ndarray:
    if isinstance(val, torch.Tensor):
        t = val.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(val)


def _selected(program, vars, predicate):
    if vars is not None:
        return list(vars)
    return [v for v in program.list_vars()
            if predicate is None or predicate(v)]


def save_vars(executor, dirname: str, main_program: Optional[Program] = None,
              vars: Optional[Sequence[Variable]] = None, predicate=None,
              save_file_name: Optional[str] = None):
    """Write the current scope's values of the selected variables to
    `dirname` (reference io.py:66); variables with no value are skipped."""
    main_program = main_program or default_main_program()
    os.makedirs(dirname, exist_ok=True)
    scope = global_scope()
    # a cached table's checkpoint is its full host slab, after the flush
    emb_cache = getattr(main_program, "_emb_cache", None)
    if emb_cache is not None:
        emb_cache.flush()
    combine = {}
    for v in _selected(main_program, vars, predicate):
        val = scope.find_var(v.name)
        if emb_cache is not None:
            host = emb_cache.host_value(v.name)
            if host is not None:
                val = host
        if val is None:
            continue
        lod = None
        if isinstance(val, LoDTensor):
            lod, val = val.lod or None, val.array()
        arr = _as_numpy(val)
        if save_file_name is None:
            with open(os.path.join(dirname, v.name), "wb") as f:
                pickle.dump({"tensor": arr, "lod": lod, "version": 0}, f)
        else:
            combine[v.name] = (arr, lod)
    if save_file_name is not None:
        with open(os.path.join(dirname, save_file_name), "wb") as f:
            pickle.dump(combine, f)


def save_params(executor, dirname, main_program=None, filename=None):
    save_vars(executor, dirname, main_program, predicate=_is_parameter,
              save_file_name=filename)


def save_persistables(executor, dirname, main_program=None, filename=None):
    save_vars(executor, dirname, main_program, predicate=_is_persistable,
              save_file_name=filename)


def _restore(scope, name, arr, lod, emb_cache=None):
    arr = np.asarray(arr)
    if emb_cache is not None and emb_cache.load_host(name, arr):
        return
    if lod:
        scope.set_var(name, LoDTensor(arr, lod))
    else:
        scope.set_var(name, torch.from_numpy(np.ascontiguousarray(arr)))


def load_vars(executor, dirname: str, main_program: Optional[Program] = None,
              vars: Optional[Sequence[Variable]] = None, predicate=None,
              load_file_name: Optional[str] = None):
    """Read the selected variables from `dirname` into the current scope, as
    CPU tensors (reference io.py:234); files that do not exist are
    skipped."""
    main_program = main_program or default_main_program()
    scope = global_scope()
    emb_cache = getattr(main_program, "_emb_cache", None)
    selected = _selected(main_program, vars, predicate)
    if load_file_name is not None:
        with open(os.path.join(dirname, load_file_name), "rb") as f:
            blob = pickle.load(f)
        for v in selected:
            if v.name in blob:
                _restore(scope, v.name, *blob[v.name], emb_cache=emb_cache)
        return
    for v in selected:
        path = os.path.join(dirname, v.name)
        if not os.path.exists(path):
            continue
        with open(path, "rb") as f:
            d = pickle.load(f)
        _restore(scope, v.name, d["tensor"], d.get("lod"), emb_cache)


def load_params(executor, dirname, main_program=None, filename=None):
    load_vars(executor, dirname, main_program, predicate=_is_parameter,
              load_file_name=filename)


def load_persistables(executor, dirname, main_program=None, filename=None):
    load_vars(executor, dirname, main_program, predicate=_is_persistable,
              load_file_name=filename)


def _strip_training_ops(program):
    """Drop backward/optimize-role ops before inference pruning (reference
    inference_optimize + OpRole attr, prune.cc:187): without this, a fetch
    built after minimize() would see the optimizer's in-place ParamOut as
    the parameter's producer and the prune would keep the training tail."""
    p = program.clone()
    for b in p.blocks:
        b.desc.ops = [d for d in b.desc.ops
                      if d.attrs.get("op_role") not in ("backward", "optimize")]
        b._sync_ops()
    return p


def get_inference_program(target_vars, main_program=None):
    main_program = main_program or default_main_program()
    if not isinstance(target_vars, list):
        target_vars = [target_vars]
    pruned = _strip_training_ops(main_program).prune(
        [], [t.name for t in target_vars])
    out = pruned.clone(for_test=True)
    _share_emb_cache(main_program, out)
    return out


def _share_emb_cache(src, dst):
    """The pruned clone reads the source scope's cache slabs: it takes the
    cache along, or its lookups would read slab rows with global ids and a
    save would write slabs as tables."""
    emb_cache = getattr(src, "_emb_cache", None)
    if emb_cache is not None:
        dst._emb_cache = emb_cache


def save_inference_model(dirname: str, feeded_var_names: List[str],
                         target_vars: List[Variable], executor,
                         main_program: Optional[Program] = None,
                         model_filename: Optional[str] = None,
                         params_filename: Optional[str] = None):
    """Prune to the inference slice and write the program and its
    persistables (reference io.py:298). Refuses a target whose producer is
    a training op (a gradient or optimizer output): the pruned program
    would leak the training tail, or could not compute the target."""
    main_program = main_program or default_main_program()
    if isinstance(feeded_var_names, str):
        feeded_var_names = [feeded_var_names]
    if not isinstance(target_vars, list):
        target_vars = [target_vars]
    os.makedirs(dirname, exist_ok=True)
    inference_program = _strip_training_ops(main_program).prune(
        feeded_var_names, [t.name for t in target_vars]).clone(for_test=True)
    _share_emb_cache(main_program, inference_program)
    # feeds the targets do not depend on (a training program's label) are
    # dropped from the recorded feed list
    block = inference_program.global_block()
    live = set()
    for op_ in block.ops:
        live |= op_external_reads(inference_program, op_)
    feed_names = [n for n in feeded_var_names if n in live]
    leaked = [op_.type for op_ in block.ops
              if op_.desc.attrs.get("op_role") in ("backward", "optimize")
              or op_.type.endswith("_grad")]
    if leaked:
        raise ValueError(
            f"save_inference_model: training-only ops {leaked} survived "
            f"pruning — a target var appears to be a gradient/optimizer "
            f"output, which is not an inference fetch")
    produced = {n for op_ in block.ops for n in op_.output_arg_names}
    for t in target_vars:
        v = block.desc.vars.get(t.name)
        if (t.name not in produced and t.name not in feeded_var_names
                and not (v is not None and v.persistable)):
            what = ("a gradient" if t.name.endswith("@GRAD")
                    or t.name.endswith("_grad") else "not computable")
            raise ValueError(
                f"save_inference_model: target '{t.name}' is {what} — "
                f"its producer was stripped with the training tail, so "
                f"the inference program cannot compute it from the feeds")
    meta = {"program": inference_program.to_json(),
            "feed_names": feed_names,
            "fetch_names": [t.name for t in target_vars]}
    with open(os.path.join(dirname, model_filename or "__model__"), "wb") as f:
        pickle.dump(meta, f)
    save_persistables(executor, dirname, inference_program,
                      filename=params_filename)
    return inference_program


def load_inference_model(dirname: str, executor,
                         model_filename: Optional[str] = None,
                         params_filename: Optional[str] = None):
    """(program, feed_target_names, fetch_targets), the persistables loaded
    into the current scope (reference io.py:383)."""
    with open(os.path.join(dirname, model_filename or "__model__"),
              "rb") as f:
        meta = pickle.load(f)
    program = Program.from_json(meta["program"])
    load_persistables(executor, dirname, program, filename=params_filename)
    fetch_targets = [program.global_block().var(n)
                     for n in meta["fetch_names"]]
    return program, meta["feed_names"], fetch_targets
