"""S1, the sparse optimizer apply (`csrc/sparse_apply.cu`), with its plain
version and launch counter. The port's own kernel: it replaces no Pallas
kernel, but the plain jnp merge and scatter-apply of
paddle_tpu/ops/common.py:49-67 and paddle_tpu/ops/sparse_ops.py:202-244.

`sgd`, `momentum` and `adam` apply one SelectedRows gradient to a table
and its accumulators in place, with lazy semantics (rows the gradient does
not name keep their values and moments: the reference's adam_op.h
SparseAdamFunctor), and return the same tensors. On a CUDA tensor the
wrapper sorts the rows (`torch.sort(stable=True)`, outside the kernel, as
the JAX package's argsort is outside any kernel), gathers the values in
that order and launches S1, which finds the runs of equal rows, sums each
run in a fixed order without atomics (so a step is bitwise repeatable and
a graphed step bitwise its eager twin) and updates each distinct row once.
A CUDA tensor S1 does not take raises (`ineligible`); nothing falls back
quietly. On a CPU tensor the wrapper computes the plain version,
`apply_reference`: merge_selected_rows, gather, the `*_dense` math of
ops/optimizer_ops.py, index_copy_ back. No form syncs with the host, so
each runs under CUDA graph capture.

Bound: bytes, K*D*4 for the gradient's values read once plus
U*D*4*2*(1 + accumulators) for the U distinct rows of the table and its
accumulators, read and written once (`bound_bytes`). `COUNTERS.launches`
counts the calls that launched S1, by form.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from . import cuda_build
from .common import SelectedRowsVal, merge_selected_rows

__all__ = ["COUNTERS", "apply", "sgd", "momentum", "adam", "apply_reference",
           "ineligible", "bound_bytes", "launch_sorted", "KINDS"]

KINDS = {"sgd": 0, "momentum": 1, "adam": 2}
ACCUMULATORS = {"sgd": 0, "momentum": 1, "adam": 2}


@dataclass
class Counters:
    """Calls that launched S1, by form (sgd, momentum, adam)."""
    launches: Dict[str, int] = field(default_factory=dict)

    def reset(self):
        self.launches.clear()

    @property
    def total(self) -> int:
        return sum(self.launches.values())


COUNTERS = Counters()


def bound_bytes(kind: str, k: int, d: int, distinct: int) -> int:
    """The bytes the function must move: the gradient's values read once,
    each distinct row of the table and its accumulators read and written
    once (f32)."""
    return k * d * 4 + distinct * d * 4 * 2 * (1 + ACCUMULATORS[kind])


# --- the plain version --------------------------------------------------

def apply_reference(kind: str, sr: SelectedRowsVal, p, accs=(), lr=None,
                    b1p=None, b2p=None, mu=0.0, nesterov=False, b1=0.9,
                    b2=0.999, eps=1e-8):
    """The sparse apply in plain PyTorch: merge the duplicate rows, gather
    the touched rows of the table and its accumulators, run the dense
    update on the [U, D] slab, and copy the rows back in place. Returns
    (p, *accs), the same tensors."""
    from . import optimizer_ops
    rows, gv = merge_selected_rows(sr)
    keep = (rows >= 0) & (rows < sr.height)
    rows, gv = rows[keep].long(), gv[keep].to(p.dtype)
    if kind == "sgd":
        new = (optimizer_ops.sgd_dense(p[rows], gv, lr),)
    elif kind == "momentum":
        new = optimizer_ops.momentum_dense(p[rows], gv, accs[0][rows], lr,
                                           mu, nesterov)
    else:
        new = optimizer_ops.adam_dense(p[rows], gv, accs[0][rows],
                                       accs[1][rows], lr, b1, b2, eps, b1p,
                                       b2p)
    outs = (p,) + tuple(accs)
    for t, v in zip(outs, new):
        t.index_copy_(0, rows, v.to(t.dtype))
    return outs


# --- the kernel ---------------------------------------------------------

def ineligible(kind: str, sr: SelectedRowsVal, p, accs, scalars) -> Optional[str]:
    """None when S1 takes these tensors, else why not: every tensor on one
    CUDA device, the table and accumulators f32 [H, D] and contiguous, the
    values [K, D], the scalars f32 with one element."""
    tensors = (p,) + tuple(accs) + (sr.values, sr.rows) + tuple(scalars)
    if any(t.device != p.device for t in tensors):
        return "device"
    if p.dim() != 2 or any(a.shape != p.shape for a in accs):
        return "shape"
    if sr.values.dim() != 2 or sr.values.shape[1] != p.shape[1] or \
            sr.rows.reshape(-1).shape[0] != sr.values.shape[0]:
        return "shape"
    if any(t.dtype != torch.float32 for t in (p,) + tuple(accs)):
        return "dtype"
    if any(t.dtype != torch.float32 or t.numel() != 1 for t in scalars):
        return "scalar"
    if not all(t.is_contiguous() for t in (p,) + tuple(accs)):
        return "layout"
    if sr.height != p.shape[0]:
        return "height"
    return None


_ARGTYPES = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
              ctypes.c_int, ctypes.c_long] + [ctypes.c_void_p] * 6
             + [ctypes.c_float, ctypes.c_int] + [ctypes.c_float] * 5
             + [ctypes.c_void_p])


def _launch(kind, sr, p, accs, lr, b1p, b2p, mu, nesterov, b1, b2, eps):
    reason = ineligible(kind, sr, p, accs,
                        [t for t in (lr, b1p, b2p) if t is not None])
    if reason is not None:
        raise ValueError(
            f"S1 sparse_apply ({kind}) does not take these tensors "
            f"({reason}): table {tuple(p.shape)} {p.dtype} on {p.device}, "
            f"values {tuple(sr.values.shape)} {sr.values.dtype}, rows "
            f"{tuple(sr.rows.shape)}")
    r_s, order = torch.sort(sr.rows.reshape(-1).long(), stable=True)
    v_s = sr.values.to(p.dtype)[order].contiguous()
    return launch_sorted(kind, r_s, v_s, p, accs, lr, b1p, b2p, mu,
                         nesterov, b1, b2, eps)


def launch_sorted(kind, r_s, v_s, p, accs, lr, b1p=None, b2p=None, mu=0.0,
                  nesterov=False, b1=0.9, b2=0.999, eps=1e-8):
    """S1 alone on rows already sorted (int64, contiguous) and their
    values in that order (f32 [K, D], contiguous): the launch the wrappers
    end with, counted."""
    k, d = v_s.shape
    a1 = accs[0] if accs else p
    a2 = accs[1] if len(accs) > 1 else p
    fn = cuda_build.entry("sparse_apply", "sparse_apply", _ARGTYPES)
    rc = fn(KINDS[kind], r_s.data_ptr(), v_s.data_ptr(), k, d, p.shape[0],
            p.data_ptr(), a1.data_ptr(), a2.data_ptr(), lr.data_ptr(),
            (b1p if b1p is not None else lr).data_ptr(),
            (b2p if b2p is not None else lr).data_ptr(), float(mu),
            int(bool(nesterov)), float(b1), float(b2), float(eps),
            float(1 - b1), float(1 - b2),
            torch.cuda.current_stream(p.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"S1 sparse_apply ({kind}) launch failed with "
                           f"CUDA error {rc} (K {k}, D {d}, table "
                           f"{tuple(p.shape)})")
    COUNTERS.launches[kind] = COUNTERS.launches.get(kind, 0) + 1
    return (p,) + tuple(accs)


def apply(kind, sr, p, accs, lr, b1p=None, b2p=None, mu=0.0,
          nesterov=False, b1=0.9, b2=0.999, eps=1e-8):
    """One sparse apply of form `kind` (sgd, momentum, adam): S1 on a CUDA
    tensor, the plain version on a CPU tensor. Returns (p, *accs)."""
    args = (kind, sr, p, accs, lr, b1p, b2p, mu, nesterov, b1, b2, eps)
    return apply_reference(*args) if p.device.type == "cpu" else \
        _launch(*args)


def sgd(p, sr: SelectedRowsVal, lr):
    """p[r] -= lr * (sum of the gradient's values at r), for each row r the
    gradient names. Returns (p,)."""
    return apply("sgd", sr, p, (), lr)


def momentum(p, v, sr: SelectedRowsVal, lr, mu, nesterov=False):
    """Lazy momentum on the gradient's rows. Returns (p, v)."""
    return apply("momentum", sr, p, (v,), lr, mu=mu, nesterov=nesterov)


def adam(p, m1, m2, sr: SelectedRowsVal, lr, b1, b2, eps, b1p, b2p):
    """Lazy Adam on the gradient's rows. Returns (p, m1, m2)."""
    return apply("adam", sr, p, (m1, m2), lr, b1=b1, b2=b2, eps=eps,
                  b1p=b1p, b2p=b2p)
