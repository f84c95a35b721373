"""Parallelism over torch.distributed (the port's counterpart of
paddle_tpu/parallel/): device meshes (`mesh.py`), the ring's collectives
(`_collectives.py`) and ring attention (`ring_attention.py`), the
sequence-parallel path of `scaled_dot_product_attention`; row-sharded
embedding tables on a one-rank mesh (`embedding.py`) and the hot-row
embedding cache (`emb_cache.py`). Data, tensor and pipeline parallelism,
multi-rank sharded tables and a local-view executor are a later slice
(ROADMAP Queue 1, slice 9)."""

from . import mesh
from .mesh import (Mesh, NamedSharding, get_mesh, make_mesh, replicated,
                   set_mesh)
from . import ring_attention
from .ring_attention import ring_attention_sharded
from . import embedding
from . import emb_cache


def shard_feed(program, name, spec):
    """Record a feed variable's mesh layout (dims -> axis name or None),
    e.g. shard_feed(prog, "tokens", (None, "sp")), in
    `program._feed_shardings`, as the JAX package does. Programs are
    global-view in the port: every rank is fed the whole value, and an op
    that runs sequence-parallel splits it inside itself, so the record has
    no effect on values; it is kept for a later local-view executor."""
    if not hasattr(program, "_feed_shardings"):
        program._feed_shardings = {}
    program._feed_shardings[name] = tuple(spec)
    return program
