"""Tensor (model) parallelism by parameter sharding (the port's counterpart
of paddle_tpu/parallel/tensor_parallel.py, whose pure-Python spec writes it
copies).

Parameters carry spec tuples (dims -> mesh axis or None) in
`program._param_shardings`. The JAX package hands them to GSPMD; the port's
executor runs them explicitly (parallel/spmd.py): the scope holds each
rank's shard, a sharded weight is all-gathered where an op reads it, and a
`mul` whose weight is split on a model axis ("tp", or "mp" as this module
names it) runs Megatron's algebra in its forward and in `mul_grad`
(ops/math_ops.py):

  * column-parallel (weight [in, out] split on out): the local product,
    then an all-gather of the output's columns; dX all-reduced;
  * row-parallel (split on in): this rank's columns of X times its rows of
    W, then an all-reduce; dX all-gathered.

API:
    mesh = make_mesh((dp, tp), ("dp", "mp"))
    DistributeTranspiler().transpile(trainers=..., mesh=mesh)
    shard_parameter(program, "fc_0.w_0", (None, "mp"))   # column-parallel
    shard_parameter(program, "fc_1.w_0", ("mp", None))   # row-parallel
    shard_fc_params(program, axis="mp")
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

__all__ = ["shard_parameter", "param_shardings", "shard_fc_params",
           "shard_all_params_zero", "expected_collectives"]


def _specs(program) -> Dict[str, Tuple]:
    if not hasattr(program, "_param_shardings"):
        program._param_shardings = {}
    return program._param_shardings


def shard_parameter(program, param_name: str, spec: Sequence[Optional[str]]):
    """Annotate one parameter with a spec tuple (dims -> mesh axis, a tuple
    of axes, or None). The one spec write path (planner.plan and
    embedding.shard_table route through here), so the `_version` bump that
    invalidates the executor's plans lives here."""
    specs = _specs(program)
    spec = tuple(spec)
    if specs.get(param_name) != spec:
        specs[param_name] = spec
        program._version = getattr(program, "_version", 0) + 1
    return program


def param_shardings(program) -> Dict[str, Tuple]:
    return dict(getattr(program, "_param_shardings", {}))


def shard_fc_params(program, axis: str = "mp", min_dim: int = 2):
    """Column-shard every 2-D fc/mul weight over `axis` (Megatron
    column-parallel): weight [in, out] splits on out. Biases whose length
    matches a sharded output dim shard too."""
    sharded_cols = set()
    for p in program.global_block().all_parameters():
        shape = p.shape
        if shape is not None and len(shape) == 2 and shape[1] >= min_dim:
            shard_parameter(program, p.name, (None, axis))
            sharded_cols.add(shape[1])
    for p in program.global_block().all_parameters():
        shape = p.shape
        if shape is not None and len(shape) == 1 and shape[0] in sharded_cols:
            shard_parameter(program, p.name, (axis,))
    return program


def expected_collectives(program) -> Dict[str, str]:
    """{param_name: its collective pattern} for every annotated parameter:
    the Megatron algebra in words (the JAX package's wording; in the port
    these collectives are the executor's, under pd.coll scopes)."""
    out: Dict[str, str] = {}
    for name, spec in param_shardings(program).items():
        spec = tuple(spec)
        ndim = len(spec)
        axes = [a for a in spec if a]
        if not axes:
            continue
        if ndim >= 2 and spec[-1]:
            out[name] = ("column-parallel ({0}): activation all-gather on "
                         "use, grad reduce-scatter".format(spec[-1]))
        elif ndim >= 2 and spec[0]:
            out[name] = ("row-parallel ({0}): output all-reduce"
                         .format(spec[0]))
        elif ndim == 1:
            out[name] = ("sharded bias ({0}): gathers with its layer"
                         .format(axes[0]))
        else:
            out[name] = ("zero-sharded ({0}): param all-gather on use, "
                         "grad reduce-scatter".format(axes[0]))
    return out


def shard_all_params_zero(program, axis: str = "dp", min_size: int = 1024):
    """ZeRO-style sharding: every parameter of at least `min_size` elements
    shards its leading dim over `axis`; gathered on use, its gradient
    reduced and cut to the shard, its optimizer state a shard."""
    import numpy as np
    for p in program.global_block().all_parameters():
        shape = p.shape
        if shape and all(d is not None for d in shape) and \
                int(np.prod(shape)) >= min_size:
            shard_parameter(program, p.name,
                            (axis,) + (None,) * (len(shape) - 1))
    return program
