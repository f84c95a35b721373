"""GoogLeNet / Inception-v1 (the port's copy of
paddle_tpu/models/googlenet.py; reference
benchmark/paddle/image/googlenet.py).

Only the main classifier head is returned (the reference benchmark also drops
the aux heads for timing)."""

from __future__ import annotations

from .. import layers


def _inception(input, c1, c3r, c3, c5r, c5, proj):
    conv1 = layers.conv2d(input=input, num_filters=c1, filter_size=1,
                          act="relu")
    conv3r = layers.conv2d(input=input, num_filters=c3r, filter_size=1,
                           act="relu")
    conv3 = layers.conv2d(input=conv3r, num_filters=c3, filter_size=3,
                          padding=1, act="relu")
    conv5r = layers.conv2d(input=input, num_filters=c5r, filter_size=1,
                           act="relu")
    conv5 = layers.conv2d(input=conv5r, num_filters=c5, filter_size=5,
                          padding=2, act="relu")
    pool = layers.pool2d(input=input, pool_size=3, pool_stride=1,
                         pool_padding=1, pool_type="max")
    convprj = layers.conv2d(input=pool, num_filters=proj, filter_size=1,
                            act="relu")
    return layers.concat([conv1, conv3, conv5, convprj], axis=1)


def googlenet(input, class_dim=1000, is_test=False):
    conv1 = layers.conv2d(input=input, num_filters=64, filter_size=7,
                          stride=2, padding=3, act="relu")
    pool1 = layers.pool2d(input=conv1, pool_size=3, pool_stride=2,
                          pool_type="max")
    conv2r = layers.conv2d(input=pool1, num_filters=64, filter_size=1,
                           act="relu")
    conv2 = layers.conv2d(input=conv2r, num_filters=192, filter_size=3,
                          padding=1, act="relu")
    pool2 = layers.pool2d(input=conv2, pool_size=3, pool_stride=2,
                          pool_type="max")

    i3a = _inception(pool2, 64, 96, 128, 16, 32, 32)
    i3b = _inception(i3a, 128, 128, 192, 32, 96, 64)
    pool3 = layers.pool2d(input=i3b, pool_size=3, pool_stride=2,
                          pool_type="max")

    i4a = _inception(pool3, 192, 96, 208, 16, 48, 64)
    i4b = _inception(i4a, 160, 112, 224, 24, 64, 64)
    i4c = _inception(i4b, 128, 128, 256, 24, 64, 64)
    i4d = _inception(i4c, 112, 144, 288, 32, 64, 64)
    i4e = _inception(i4d, 256, 160, 320, 32, 128, 128)
    pool4 = layers.pool2d(input=i4e, pool_size=3, pool_stride=2,
                          pool_type="max")

    i5a = _inception(pool4, 256, 160, 320, 32, 128, 128)
    i5b = _inception(i5a, 384, 192, 384, 48, 128, 128)
    pool5 = layers.pool2d(input=i5b, pool_size=7, pool_type="avg",
                          global_pooling=True)
    drop = layers.dropout(x=pool5, dropout_prob=0.4, is_test=is_test)
    out = layers.fc(input=drop, size=class_dim, act=None)
    return out
