"""MNIST, the port's copy of paddle_tpu/dataset/mnist.py (reference:
python/paddle/v2/dataset/mnist.py). Schema: 784 float32
pixels in [-1, 1], int64 label 0-9. Synthetic surrogate: class-dependent
blob patterns, learnable by mlp/conv book models."""

from __future__ import annotations

import gzip
import struct

import numpy as np

from . import common

_TRAIN_N, _TEST_N = 8192, 1024


def _synthetic(n, seed):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, n)
    imgs = np.zeros((n, 28, 28), np.float32)
    for k in range(n):
        c = labels[k]
        r0, c0 = (c // 5) * 12 + 2, (c % 5) * 5 + 1
        imgs[k, r0:r0 + 12, c0:c0 + 4] = 1.0
    imgs += rng.randn(n, 28, 28).astype(np.float32) * 0.2
    imgs = np.clip(imgs, 0, 1) * 2.0 - 1.0
    return imgs.reshape(n, 784), labels.astype(np.int64)


def _read_idx(img_path, lab_path):
    with gzip.open(img_path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        imgs = np.frombuffer(f.read(), np.uint8).reshape(n, rows * cols)
    with gzip.open(lab_path, "rb") as f:
        struct.unpack(">II", f.read(8))
        labels = np.frombuffer(f.read(), np.uint8)
    return (imgs.astype(np.float32) / 127.5 - 1.0), labels.astype(np.int64)


def _load(split):
    prefix = "train" if split == "train" else "t10k"
    img = f"{prefix}-images-idx3-ubyte.gz"
    lab = f"{prefix}-labels-idx1-ubyte.gz"
    if common.have_real_data("mnist", img) and \
            common.have_real_data("mnist", lab):
        return _read_idx(common.cache_path("mnist", img),
                         common.cache_path("mnist", lab))
    if split == "train":
        return _synthetic(_TRAIN_N, 0)
    return _synthetic(_TEST_N, 1)


def _reader(split):
    def reader():
        imgs, labels = _load(split)
        for i in range(len(imgs)):
            yield imgs[i], int(labels[i])
    return reader


def train():
    return _reader("train")


def test():
    return _reader("test")
