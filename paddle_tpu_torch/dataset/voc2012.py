"""Pascal VOC2012 segmentation, the port's copy of
paddle_tpu/dataset/voc2012.py (reference:
python/paddle/v2/dataset/voc2012.py). Schema: (image [3,H,W] float32 in
[0,1], segmentation mask [H,W] int32 with 21 classes + 255 void).

Real data: drop `VOCtrainval_11-May-2012.tar` (reference voc2012.py:31-37)
under DATA_HOME/voc2012/ and train/test/val parse it as the reference
(voc2012.py:42-79): ImageSets/Segmentation/{trainval,train,val}.txt list
the ids, JPEGImages/{id}.jpg is the image, SegmentationClass/{id}.png is
the palette-indexed mask (np.array of the 'P'-mode PIL image = class
ids). The reference yields HWC uint8; this stack's segmentation contract
is CHW float32 [0,1] + int32 mask, so the real path converts. Synthetic
surrogate otherwise: class-colored rectangles at 64x64."""

from __future__ import annotations

import io
import tarfile

import numpy as np

from . import common

CLASS_NUM = 21          # 20 object classes + background
_TRAIN_N, _TEST_N, _VALID_N = 256, 64, 64
_H = _W = 64

_FILE = "VOCtrainval_11-May-2012.tar"
_SET_FILE = "VOCdevkit/VOC2012/ImageSets/Segmentation/{}.txt"
_DATA_FILE = "VOCdevkit/VOC2012/JPEGImages/{}.jpg"
_LABEL_FILE = "VOCdevkit/VOC2012/SegmentationClass/{}.png"


def _have_real():
    return common.have_real_data("voc2012", _FILE)


def _real_reader(sub_name):
    """Reference voc2012.py:42-66 with the split-name mapping preserved:
    its train() reads 'trainval', test() reads 'train', val() reads
    'val'."""
    from PIL import Image

    def reader():
        with tarfile.open(common.cache_path("voc2012", _FILE)) as tf:
            names = {m.name: m for m in tf.getmembers()}
            sets = tf.extractfile(names[_SET_FILE.format(sub_name)])
            for line in sets:
                line = line.decode("utf-8").strip()
                if not line:
                    continue
                data = tf.extractfile(names[_DATA_FILE.format(line)]).read()
                label = tf.extractfile(
                    names[_LABEL_FILE.format(line)]).read()
                img = np.asarray(
                    Image.open(io.BytesIO(data)).convert("RGB"),
                    np.float32) / 255.0
                mask = np.asarray(Image.open(io.BytesIO(label)),
                                  np.int32)
                yield img.transpose(2, 0, 1), mask
    return reader


def _sample(rng):
    img = rng.rand(3, _H, _W).astype(np.float32) * 0.2
    mask = np.zeros((_H, _W), np.int32)
    for _ in range(int(rng.randint(1, 4))):
        c = int(rng.randint(1, CLASS_NUM))
        h, w = int(rng.randint(8, 32)), int(rng.randint(8, 32))
        r0 = int(rng.randint(0, _H - h))
        c0 = int(rng.randint(0, _W - w))
        mask[r0:r0 + h, c0:c0 + w] = c
        img[c % 3, r0:r0 + h, c0:c0 + w] += 0.5 + 0.02 * c
    return np.clip(img, 0, 1), mask


def _synthetic_reader(n, seed):
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            yield _sample(rng)
    return reader


def train():
    if _have_real():
        return _real_reader("trainval")
    return _synthetic_reader(_TRAIN_N, 0)


def test():
    if _have_real():
        return _real_reader("train")
    return _synthetic_reader(_TEST_N, 1)


def val():
    if _have_real():
        return _real_reader("val")
    return _synthetic_reader(_VALID_N, 2)
