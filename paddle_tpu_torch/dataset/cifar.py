"""CIFAR-10/100, the port's copy of paddle_tpu/dataset/cifar.py (reference:
python/paddle/v2/dataset/cifar.py). Schema:
3*32*32 float32 in [0,1], int64 label.

Real data: drop `cifar-10-python.tar.gz` / `cifar-100-python.tar.gz` (the
upstream pickled tarballs, reference cifar.py:40-43) under
DATA_HOME/cifar/ and the readers parse them exactly as the reference does
(cifar.py:46-64: tar members matched by substring, per-batch pickle dicts
with 'data' uint8 [N, 3072] and 'labels'/'fine_labels'). Without the
files, a deterministic synthetic surrogate with the same schema serves
(class-colored quadrant blobs)."""

from __future__ import annotations

import pickle
import tarfile

import numpy as np

from . import common

_TRAIN_N, _TEST_N = 4096, 512
_FILE10 = "cifar-10-python.tar.gz"
_FILE100 = "cifar-100-python.tar.gz"


def _synthetic(n, classes, seed):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, classes, n)
    imgs = rng.rand(n, 3, 32, 32).astype(np.float32) * 0.25
    for k in range(n):
        c = int(labels[k])
        ch = c % 3
        q = (c // 3) % 4
        r0, c0 = (q // 2) * 16, (q % 2) * 16
        imgs[k, ch, r0:r0 + 16, c0:c0 + 16] += 0.7
    return np.clip(imgs, 0, 1).reshape(n, 3 * 32 * 32), labels.astype(np.int64)


def _synthetic_reader(n, classes, seed):
    def reader():
        imgs, labels = _synthetic(n, classes, seed)
        for i in range(n):
            yield imgs[i], int(labels[i])
    return reader


def _real_reader(filename, sub_name):
    """Reference cifar.py:46-64: iterate tar members whose name contains
    sub_name ('data_batch'/'test_batch' for 10, 'train'/'test' for 100),
    unpickle each batch, yield (pixels/255 float32, int label)."""
    path = common.cache_path("cifar", filename)

    def reader():
        with tarfile.open(path, mode="r") as f:
            names = [m.name for m in f if sub_name in m.name]
            for name in sorted(names):
                batch = pickle.load(f.extractfile(name), encoding="latin1")
                data = batch["data"]
                labels = batch.get("labels", batch.get("fine_labels"))
                assert labels is not None
                for sample, label in zip(data, labels):
                    yield (np.asarray(sample, np.float32) / 255.0,
                           int(label))

    return reader


def _reader(filename, sub_name, n, classes, seed):
    if common.have_real_data("cifar", filename):
        return _real_reader(filename, sub_name)
    return _synthetic_reader(n, classes, seed)


def train10():
    return _reader(_FILE10, "data_batch", _TRAIN_N, 10, 0)


def test10():
    return _reader(_FILE10, "test_batch", _TEST_N, 10, 1)


def train100():
    return _reader(_FILE100, "train", _TRAIN_N, 100, 2)


def test100():
    return _reader(_FILE100, "test", _TEST_N, 100, 3)
