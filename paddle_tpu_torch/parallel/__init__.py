"""Parallelism over torch.distributed (the port's counterpart of
paddle_tpu/parallel/): device meshes with a sub-group per axis and axis
tuple (`mesh.py`), their collectives (`_collectives.py`), the sharded run
the executor makes of a program on a process group's mesh (`spmd.py`),
the transpiler (`transpiler.py`), tensor parallelism
(`tensor_parallel.py`), the sharding planner (`planner.py`), bucketed
gradient sync (`overlap.py`), multi-process bring-up, reader sharding and
checkpoints (`multihost.py`), row-sharded embedding tables
(`embedding.py`), the hot-row embedding cache (`emb_cache.py`), ring
attention (`ring_attention.py`), the GPipe schedule over a 'pp' axis
(`pipeline.py`), program-level pipelines (`program_pipeline.py`) and the
elastic task queue (`master.py`). Expert parallelism is moe_ffn's own
rule under a mesh whose 'ep' axis splits its expert weights
(ops/nn_ops.py, spmd.py)."""

from . import mesh
from .mesh import (Mesh, NamedSharding, get_mesh, make_mesh, replicated,
                   set_mesh, data_parallel_mesh, batch_sharding)
from . import _collectives
from . import spmd
from . import transpiler
from . import multihost
from . import master
from . import tensor_parallel
from .tensor_parallel import (shard_parameter, shard_fc_params,
                              shard_all_params_zero)
from . import ring_attention
from .ring_attention import ring_attention_sharded
from . import embedding
from .embedding import (shard_table, shard_embeddings,
                        per_shard_table_bytes)
from . import planner
from .planner import SpecLayout, mesh_from_env, validate_plan_bytes
from . import overlap
from . import emb_cache
from . import pipeline
from .pipeline import gpipe
from . import program_pipeline
from .program_pipeline import PipelineTranspiler


def shard_feed(program, name, spec):
    """Set a feed variable's mesh layout (dims -> axis name, a tuple of
    axes, or None), e.g. shard_feed(prog, "x", ("dp", None)). On a process
    group's mesh the executor cuts the fed batch to this rank's rows along
    a dim-0 entry (parallel/spmd.py); a spec with None at dim 0 keeps the
    feed whole on every rank. A split of another dim, such as
    shard_feed(prog, "tokens", (None, "sp")) for ring attention, stays
    global-view in the port: the sequence-parallel op shards inside
    itself."""
    if not hasattr(program, "_feed_shardings"):
        program._feed_shardings = {}
    program._feed_shardings[name] = tuple(spec)
    program._version = getattr(program, "_version", 0) + 1
    return program


def per_shard_param_bytes(program, scope=None):
    """Per-rank parameter bytes under the program's mesh (JAX
    parallel/__init__.py:36): a parameter annotated in `_param_shardings`
    occupies ceil(bytes / its shard factor) on each rank; the rest is
    replicated. A parameter's bytes are its declared shape's at the dtype
    the scope holds, and where the scope holds this rank's shard (after a
    sharded step) its per-rank bytes are that shard's own. Returns
    {devices, replicated_bytes, sharded_bytes_per_device, per_device_bytes,
    by_axes, params}."""
    import math

    from .. import executor as executor_mod

    scope = scope if scope is not None else executor_mod.global_scope()
    m = getattr(program, "_mesh", None)
    axis_sizes = dict(m.axis_sizes) if m is not None else {}
    n_dev = math.prod(axis_sizes.values()) if axis_sizes else 1
    specs = getattr(program, "_param_shardings", {}) or {}
    replicated_b = sharded = 0
    detail, by_axes = {}, {}
    for p in program.global_block().all_parameters():
        v = scope.find_var(p.name)
        if v is None or not hasattr(v, "element_size"):
            continue
        shape = tuple(int(d) for d in (p.shape or ()))
        b = math.prod(shape) * v.element_size() if shape else \
            v.numel() * v.element_size()
        if not b:
            continue
        factor, spec_axes = 1, set()
        for ent in specs.get(p.name) or ():
            axes = (tuple(ent) if isinstance(ent, (tuple, list))
                    else (ent,) if ent else ())
            for ax in axes:
                factor *= int(axis_sizes.get(ax, 1))
                spec_axes.add(str(ax))
        held = v.numel() * v.element_size()
        if factor > 1:
            per_dev = held if held < b else -(-b // factor)
            sharded += per_dev
            key = "+".join(sorted(spec_axes))
            detail[p.name] = {"bytes": b, "per_device": per_dev,
                              "factor": factor, "axes": key}
        else:
            per_dev = b
            replicated_b += b
            key = "replicated"
            detail[p.name] = {"bytes": b, "per_device": b, "factor": 1,
                              "axes": key}
        by_axes[key] = int(by_axes.get(key, 0) + per_dev)
    return {"devices": n_dev, "replicated_bytes": int(replicated_b),
            "sharded_bytes_per_device": int(sharded),
            "per_device_bytes": int(replicated_b + sharded),
            "by_axes": by_axes, "params": detail}
