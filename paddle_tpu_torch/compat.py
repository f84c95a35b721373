"""Checkpoint compatibility helpers for reference-trained weights (the
port's copy of paddle_tpu/compat.py: pure numpy; the port's sequence ops
keep the JAX package's gate layouts, so the converters apply unchanged).

This framework's fused RNN cells use a different gate layout / update rule
than the reference's CUDA kernels (a deliberate TPU-first choice — the
layouts here match the split order the cells use):

  LSTM  (ops/sequence_ops.py): gate order [input, forget, cell, output]
        along the 4H axis; the reference orders [cell, input, forget,
        output] (reference: paddle/fluid/operators/math/lstm_compute.h,
        detail/lstm_cpu_kernel.h).
  GRU   (ops/sequence_ops.py): weight [H, 3H] = [update, reset | candidate]
        and h = u * h_prev + (1 - u) * c; the reference computes
        h = u * c + (1 - u) * h_prev (reference: operators/math/gru_compute.h,
        detail/gru_cpu_kernel.h — i.e. the roles of u and (1-u) are swapped).

Training from scratch is unaffected (the cells are self-consistent and
grad-checked). Porting reference-trained weights requires the converters
below. The GRU converter is an involution (applying twice returns the
original); the LSTM converters are a permutation and its inverse — use the
`_to_reference` variant to go back.
"""

from __future__ import annotations

import numpy as np

__all__ = ["convert_lstm_weight_from_reference",
           "convert_lstm_weight_to_reference",
           "convert_gru_weight_from_reference"]


def _split4(w, axis):
    return np.split(np.asarray(w), 4, axis=axis)


def convert_lstm_weight_from_reference(weight, axis=-1):
    """Reorder a reference LSTM gate weight/bias from the reference's
    [cell, input, forget, output] layout into this framework's
    [input, forget, cell, output] layout along `axis` (the 4H axis)."""
    c, i, f, o = _split4(weight, axis)
    return np.concatenate([i, f, c, o], axis=axis)


def convert_lstm_weight_to_reference(weight, axis=-1):
    """Inverse of convert_lstm_weight_from_reference: reorder
    [input, forget, cell, output] back to the reference's
    [cell, input, forget, output] layout."""
    i, f, c, o = _split4(weight, axis)
    return np.concatenate([c, i, f, o], axis=axis)


def convert_gru_weight_from_reference(gate_weight, axis=-1):
    """Swap the update/reset blocks of a reference GRU gate weight/bias
    ([update, reset] along 2H) to account for the inverted update rule:
    reference h = u*c + (1-u)*h_prev equals ours with u' = 1 - u, which for
    sigmoid gates means negating the update-gate pre-activation — not a
    pure permutation. For *weights* the equivalent transform is to negate
    the update-gate block (weight AND bias); candidate block is unchanged.

    Pass the full [D, 3H] weight (or [3H] bias); returns a copy with the
    update-gate third negated.
    """
    w = np.array(gate_weight, copy=True)
    h3 = w.shape[axis]
    assert h3 % 3 == 0, "expected a [.., 3H] GRU gate weight"
    h = h3 // 3
    sl = [slice(None)] * w.ndim
    sl[axis] = slice(0, h)
    w[tuple(sl)] = -w[tuple(sl)]
    return w
