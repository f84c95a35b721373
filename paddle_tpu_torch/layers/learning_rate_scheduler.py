"""Learning-rate schedules as ops on the global step counter (the port's
counterpart of paddle_tpu/layers/learning_rate_scheduler.py; reference
python/paddle/fluid/layers/learning_rate_scheduler.py:43-180).

Each schedule reads `@STEP_COUNTER@` (layers.autoincreased_step_counter:
int64 state that an `increment` at the head of the step advances in place)
and computes the rate on the device with elementwise ops, no `Switch`, so
a step holding one is captured as a CUDA graph whose replays advance the
counter and recompute the rate, and the optimizer reads it as the device
tensor it is.
"""

from __future__ import annotations

from . import nn
from . import ops as _ops
from . import tensor

__all__ = ["exponential_decay", "natural_exp_decay", "inverse_time_decay",
           "polynomial_decay", "piecewise_decay", "noam_decay"]


def _float_step():
    return tensor.cast(nn.autoincreased_step_counter(), "float32")


def exponential_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    """lr * decay_rate ^ (step / decay_steps), the exponent floored with
    `staircase`."""
    div = _float_step() / float(decay_steps)
    if staircase:
        div = _ops.floor(div)
    return learning_rate * (decay_rate ** div)


def natural_exp_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    """lr * exp(-decay_rate * step / decay_steps)."""
    div = _float_step() / float(decay_steps)
    if staircase:
        div = _ops.floor(div)
    return learning_rate * _ops.exp(-1.0 * decay_rate * div)


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    """lr / (1 + decay_rate * step / decay_steps)."""
    div = _float_step() / float(decay_steps)
    if staircase:
        div = _ops.floor(div)
    return learning_rate / (1.0 + decay_rate * div)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    """(lr - end) (1 - step / decay_steps)^power + end, the step held at
    decay_steps, or with `cycle` decay_steps stretched to the next
    multiple of itself past the step."""
    step = _float_step()
    if cycle:
        div = _ops.ceil(step / float(decay_steps))
        div = nn.elementwise_max(
            div, tensor.fill_constant([1], "float32", 1.0))
        frac = step / (div * float(decay_steps))
    else:
        frac = nn.elementwise_min(
            step / float(decay_steps),
            tensor.fill_constant([1], "float32", 1.0))
    return (learning_rate - end_learning_rate) * \
        ((1.0 - frac) ** power) + end_learning_rate


def piecewise_decay(boundaries, values):
    """values[i] while step < boundaries[i], values[-1] after the last."""
    if len(values) - len(boundaries) != 1:
        raise ValueError("piecewise_decay needs one value more than "
                         "boundaries")
    step = _float_step()
    lr = tensor.fill_constant([1], "float32", values[-1])
    for b, v in zip(reversed(boundaries), reversed(values[:-1])):
        below = tensor.cast(
            step < tensor.fill_constant([1], "float32", float(b)), "float32")
        lr = below * v + (1.0 - below) * lr
    return lr


def noam_decay(d_model, warmup_steps):
    """d_model^-0.5 min(step^-0.5, warmup_steps^-1.5 step), the
    transformer paper's schedule (Vaswani et al. 2017, eq. 3)."""
    step = _float_step()
    a = step ** -0.5
    b = (warmup_steps ** -1.5) * step
    return (d_model ** -0.5) * nn.elementwise_min(a, b)
