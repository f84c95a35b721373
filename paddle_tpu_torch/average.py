"""Weighted running averages (the port's copy of paddle_tpu/average.py;
reference python/paddle/fluid/average.py): host-side helpers for the
metrics a training loop fetches; they never touch the Program."""

from __future__ import annotations

import numpy as np

__all__ = ["WeightedAverage"]


def _is_number(v):
    return isinstance(v, (int, float)) or (
        isinstance(v, np.ndarray) and v.shape == (1,))


def _is_number_or_matrix(v):
    return _is_number(v) or isinstance(v, np.ndarray)


class WeightedAverage:
    """sum(value_i * weight_i) / sum(weight_i) (reference average.py:35)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.numerator = None
        self.denominator = None

    def add(self, value, weight):
        if not _is_number_or_matrix(value):
            raise ValueError(
                "The 'value' must be a number(int, float) or a numpy "
                "ndarray.")
        if not _is_number(weight):
            raise ValueError("The 'weight' must be a number(int, float).")
        if self.numerator is None or self.denominator is None:
            self.numerator = value * weight
            self.denominator = weight
        else:
            self.numerator += value * weight
            self.denominator += weight

    def eval(self):
        if self.numerator is None or self.denominator is None:
            raise ValueError(
                "There is no data to be averaged in WeightedAverage.")
        if self.denominator == 0:
            raise ValueError("The denominator is zero.")
        return self.numerator / self.denominator
