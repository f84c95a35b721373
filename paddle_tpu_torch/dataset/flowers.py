"""Flowers-102, the port's copy of paddle_tpu/dataset/flowers.py (reference:
python/paddle/v2/dataset/flowers.py). Schema:
(3*224*224 float32 image in [0,1], int64 label in [0,102)).

Real data: drop `102flowers.tgz`, `imagelabels.mat`, `setid.mat` (the
VGG 102-flowers release, reference flowers.py:34-41) under
DATA_HOME/flowers/ and train/test/valid parse them as the reference does
(flowers.py:73-123): setid.mat's trnid/tstid/valid index the tarball's
jpg/image_%05d.jpg members, imagelabels.mat supplies 1-based labels, each
image is resized (short side 256), center-cropped to 224, emitted CHW
flattened with the label shifted to 0-based. Pixels here stay in [0,1]
(this stack's CNN stems normalize internally) where the reference's
default mapper subtracted BGR channel means. Synthetic surrogate
otherwise: per-class hue blob on a textured background."""

from __future__ import annotations

import io
import tarfile

import numpy as np

from . import common

CLASS_NUM = 102
_TRAIN_N, _TEST_N, _VALID_N = 512, 128, 128
_H = _W = 224

_DATA_FILE = "102flowers.tgz"
_LABEL_FILE = "imagelabels.mat"
_SETID_FILE = "setid.mat"
TRAIN_FLAG, TEST_FLAG, VALID_FLAG = "trnid", "tstid", "valid"


def _have_real():
    return all(common.have_real_data("flowers", f)
               for f in (_DATA_FILE, _LABEL_FILE, _SETID_FILE))


def _transform(img_bytes):
    """Resize short side to 256, center-crop 224, CHW float32 in [0,1]."""
    from PIL import Image

    img = Image.open(io.BytesIO(img_bytes)).convert("RGB")
    w, h = img.size
    scale = 256.0 / min(w, h)
    img = img.resize((max(int(w * scale), 224), max(int(h * scale), 224)))
    w, h = img.size
    x0, y0 = (w - _W) // 2, (h - _H) // 2
    img = img.crop((x0, y0, x0 + _W, y0 + _H))
    arr = np.asarray(img, np.float32) / 255.0          # HWC
    return arr.transpose(2, 0, 1).reshape(-1)          # CHW flat


def _real_reader(flag):
    import scipy.io as scio

    def reader():
        labels = scio.loadmat(
            common.cache_path("flowers", _LABEL_FILE))["labels"][0]
        indexes = scio.loadmat(
            common.cache_path("flowers", _SETID_FILE))[flag][0]
        wanted = {f"jpg/image_{i:05d}.jpg": int(labels[i - 1])
                  for i in indexes}
        with tarfile.open(common.cache_path("flowers", _DATA_FILE)) as tf:
            for member in tf:
                label = wanted.get(member.name)
                if label is None:
                    continue
                data = tf.extractfile(member).read()
                yield _transform(data), label - 1
    return reader


def _sample(rng, classes):
    label = int(rng.randint(0, classes))
    img = rng.rand(3, _H, _W).astype(np.float32) * 0.2
    ch = label % 3
    r0 = (label * 37) % (_H - 64)
    c0 = (label * 53) % (_W - 64)
    img[ch, r0:r0 + 64, c0:c0 + 64] += 0.7
    return np.clip(img, 0, 1).reshape(-1), label


def _synthetic_reader(n, seed, classes=CLASS_NUM):
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            yield _sample(rng, classes)
    return reader


def train(mapper=None, buffered_size=1024, use_xmap=True):
    if _have_real():
        return _real_reader(TRAIN_FLAG)
    return _synthetic_reader(_TRAIN_N, 0)


def test(mapper=None, buffered_size=1024, use_xmap=True):
    if _have_real():
        return _real_reader(TEST_FLAG)
    return _synthetic_reader(_TEST_N, 1)


def valid(mapper=None, buffered_size=1024, use_xmap=True):
    if _have_real():
        return _real_reader(VALID_FLAG)
    return _synthetic_reader(_VALID_N, 2)
