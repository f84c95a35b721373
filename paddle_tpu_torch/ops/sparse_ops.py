"""Sparse embeddings: the SelectedRows gradient end to end (the port's
counterpart of paddle_tpu/ops/sparse_ops.py).

A recommender-scale table's step must cost O(rows touched), not O(table
rows) (reference framework/selected_rows.h:19,
operators/math/selected_rows_functor.cc). This module is the op layer of
that contract:

  * `SPARSE_APPLY_OPS`: the optimizer ops with a sparse apply (the
    reference registers SelectedRows kernels for sgd and adam; momentum is
    the JAX package's extension). Everything else densifies, counted.
  * `sgd_apply` / `momentum_apply` / `adam_apply`: the applies, through S1
    (ops/sparse_cuda.py) on a CUDA tensor and its plain version on a CPU
    tensor. They update the table and its accumulators IN PLACE and
    return the same tensors: the reference's donated state, where the JAX
    package's functional scatter hands XLA a buffer to reuse. A table that
    only sparse applies write therefore keeps its storage across steps,
    eager and graphed (executor.py), and a step never allocates or copies
    a tensor of the table's size. Rows the gradient does not name keep
    their values and their moments (lazy semantics, adam_op.h
    SparseAdamFunctor).
  * `sharded_lookup` / `pin_table` for a row-sharded table
    (parallel/embedding.py) on the program's mesh. The port's mesh of one
    rank runs them as the plain gather and the identity; a shard axis of
    more than one rank needs the local-view executor of ROADMAP Queue 1
    item 9b and raises.
  * Telemetry: `sparse_apply_rows_total{op}` (rows scatter-applied, per
    eager call: a graph replay runs no Python and counts nothing) and
    `sparse_densify_fallback_total{op,reason}`, with a warning once per
    (op, reason).

`PADDLE_TPU_SPARSE_APPLY=0` turns the applies off (the gradient densifies
at the optimizer, counted as `gated_off`). It is read at every call and is
part of a graphed step's key (`cache_token`), so a replay never runs a
step captured under the other setting.
"""

from __future__ import annotations

import os
import warnings
from typing import Optional, Tuple

from . import sparse_cuda
from .common import SelectedRowsVal

__all__ = [
    "SPARSE_APPLY_OPS", "sparse_apply_enabled", "cache_token",
    "count_densify", "count_apply_rows", "note_once", "table_axes",
    "shard_factor", "sharded_lookup", "pin_table", "sgd_apply",
    "momentum_apply", "adam_apply",
]

SPARSE_APPLY_OPS: Tuple[str, ...] = ("sgd", "momentum", "adam")

ITEM_9B = ("a row-sharded table over more than one rank needs the "
           "local-view executor of ROADMAP Queue 1 item 9b")


def sparse_apply_enabled() -> bool:
    """PADDLE_TPU_SPARSE_APPLY gate, read at every call (default on)."""
    return os.environ.get("PADDLE_TPU_SPARSE_APPLY", "1") == "1"


def cache_token(program) -> tuple:
    """What of the sparse path a graphed step of `program` was captured
    under: the gate, and the identity of the program's hot-row cache."""
    cache = getattr(program, "_emb_cache", None)
    return (sparse_apply_enabled(), None if cache is None else id(cache))


_WARNED: set = set()


def count_densify(op: str, reason: str, amount: int = 1, *,
                  log: bool = True):
    """sparse_densify_fallback_total{op,reason}, and a warning once per
    (op, reason): a SelectedRows gradient just became a table-sized dense
    tensor."""
    from .. import telemetry
    telemetry.counter(
        "sparse_densify_fallback_total",
        "SelectedRows gradients densified to a full table-sized tensor, "
        "by consuming op and reason (sparse-path perf cliffs made visible)",
        labels=("op", "reason")).labels(op=op, reason=reason).inc(amount)
    if log and (op, reason) not in _WARNED:
        _WARNED.add((op, reason))
        warnings.warn(
            f"SelectedRows gradient densified at '{op}' ({reason}): this "
            f"update now costs O(table rows), not O(rows touched). "
            f"sgd/momentum/adam keep sparse gradients sparse "
            f"(PADDLE_TPU_SPARSE_APPLY=1); other consumers densify.",
            stacklevel=3)


def note_once(key: str, msg: str):
    """One warning per process for a sparse-path note that is no counter."""
    if key not in _WARNED:
        _WARNED.add(key)
        warnings.warn(msg, stacklevel=3)


def count_apply_rows(op: str, rows: int):
    """sparse_apply_rows_total{op}: the K rows one apply call scattered."""
    from .. import telemetry
    telemetry.counter(
        "sparse_apply_rows_total",
        "rows scatter-applied per traced step by sparse optimizer "
        "kernels (static K per apply site, counted at trace time)",
        labels=("op",)).labels(op=op).inc(int(rows))


# --- sharded tables -----------------------------------------------------------

def table_axes(program, wname: str) -> Optional[Tuple[str, ...]]:
    """The mesh axes that shard dim 0 of parameter `wname`, or None when
    the table is unsharded, the program has no mesh, or the annotation
    names an axis the mesh lacks."""
    spec = (getattr(program, "_param_shardings", None) or {}).get(wname)
    mesh = getattr(program, "_mesh", None)
    if not spec or mesh is None:
        return None
    first = spec[0]
    if not first:
        return None
    axes = tuple(first) if isinstance(first, (tuple, list)) else (first,)
    if not all(a in mesh.axis_names for a in axes):
        return None
    return axes


def shard_factor(program, wname: str) -> int:
    """How many ways the table's rows split; 1 when unsharded."""
    axes = table_axes(program, wname) or ()
    mesh = getattr(program, "_mesh", None)
    f = 1
    for a in axes:
        f *= mesh.axis_size(a)
    return f


def _one_rank(program, wname):
    if shard_factor(program, wname) > 1:
        raise NotImplementedError(f"table '{wname}': {ITEM_9B}")


def sharded_lookup(program, wname: str, w, ids):
    """The gather of a row-sharded table under the `pd.coll.emb_lookup`
    range. On the one rank of the port's mesh the rank holds the whole
    table and the gather is local."""
    from ..parallel._collectives import coll_scope
    _one_rank(program, wname)
    with coll_scope("emb_lookup"):
        return w[ids]


def pin_table(program, pname: str, *vals):
    """The table-shaped outputs of an apply, as the sharding leaves them:
    on one rank, unchanged."""
    _one_rank(program, pname)
    return vals if len(vals) != 1 else vals[0]


# --- the applies ----------------------------------------------------------------

def sgd_apply(p, lr, sr: SelectedRowsVal):
    """reference sgd_op.h SelectedRows branch, merge first. Returns p,
    updated in place."""
    count_apply_rows("sgd", sr.values.shape[0])
    return sparse_cuda.sgd(p, sr, lr)[0]


def momentum_apply(p, v, lr, mu, use_nesterov, sr: SelectedRowsVal):
    """Lazy momentum: the velocity decays and the parameter moves only on
    the gradient's rows. Returns (p, v), updated in place."""
    count_apply_rows("momentum", sr.values.shape[0])
    return sparse_cuda.momentum(p, v, sr, lr, mu, use_nesterov)


def adam_apply(p, m1, m2, lr, b1, b2, eps, b1p, b2p, sr: SelectedRowsVal):
    """Lazy Adam (reference adam_op.h SparseAdamFunctor): the moments and
    the parameter move only on the gradient's rows; untouched rows keep
    stale moments. Returns (p, m1, m2), updated in place."""
    count_apply_rows("adam", sr.values.shape[0])
    return sparse_cuda.adam(p, m1, m2, sr, lr, b1, b2, eps, b1p, b2p)
