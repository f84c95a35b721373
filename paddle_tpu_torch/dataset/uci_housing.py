"""UCI housing dataset, the port's copy of paddle_tpu/dataset/uci_housing.py
(reference: python/paddle/v2/dataset/uci_housing.py).

Schema: 13 float32 features (normalized), 1 float32 target. With no cached
real data, serves a deterministic synthetic linear-ish task of the same
shape so fit_a_line trains and converges."""

from __future__ import annotations

import numpy as np

from . import common

feature_names = [
    "CRIM", "ZN", "INDUS", "CHAS", "NOX", "RM", "AGE", "DIS", "RAD", "TAX",
    "PTRATIO", "B", "LSTAT",
]

_TRAIN_N, _TEST_N = 404, 102


def _synthetic():
    rng = np.random.RandomState(42)
    n = _TRAIN_N + _TEST_N
    x = rng.randn(n, 13).astype(np.float32)
    w = rng.randn(13, 1).astype(np.float32)
    y = (x @ w + 0.1 * rng.randn(n, 1)).astype(np.float32)
    return x, y


def _load():
    path = None
    if common.have_real_data("uci_housing", "housing.data"):
        raw = np.loadtxt(common.cache_path("uci_housing", "housing.data"))
        feats = raw[:, :13]
        feats = (feats - feats.mean(0)) / (feats.std(0) + 1e-8)
        return feats.astype(np.float32), raw[:, 13:14].astype(np.float32)
    return _synthetic()


def train():
    def reader():
        x, y = _load()
        for i in range(_TRAIN_N):
            yield x[i], y[i]
    return reader


def test():
    def reader():
        x, y = _load()
        for i in range(_TRAIN_N, len(x)):
            yield x[i], y[i]
    return reader
