"""AlexNet (the port's copy of paddle_tpu/models/alexnet.py; reference
benchmark/paddle/image/alexnet.py)."""

from __future__ import annotations

from .. import layers


def alexnet(input, class_dim=1000, is_test=False):
    conv1 = layers.conv2d(input=input, num_filters=64, filter_size=11,
                          stride=4, padding=2, act="relu")
    pool1 = layers.pool2d(input=conv1, pool_size=3, pool_stride=2)
    norm1 = layers.lrn(input=pool1, n=5, alpha=1e-4, beta=0.75)

    conv2 = layers.conv2d(input=norm1, num_filters=192, filter_size=5,
                          padding=2, act="relu")
    pool2 = layers.pool2d(input=conv2, pool_size=3, pool_stride=2)
    norm2 = layers.lrn(input=pool2, n=5, alpha=1e-4, beta=0.75)

    conv3 = layers.conv2d(input=norm2, num_filters=384, filter_size=3,
                          padding=1, act="relu")
    conv4 = layers.conv2d(input=conv3, num_filters=256, filter_size=3,
                          padding=1, act="relu")
    conv5 = layers.conv2d(input=conv4, num_filters=256, filter_size=3,
                          padding=1, act="relu")
    pool3 = layers.pool2d(input=conv5, pool_size=3, pool_stride=2)

    drop1 = layers.dropout(x=pool3, dropout_prob=0.5, is_test=is_test)
    fc1 = layers.fc(input=drop1, size=4096, act="relu")
    drop2 = layers.dropout(x=fc1, dropout_prob=0.5, is_test=is_test)
    fc2 = layers.fc(input=drop2, size=4096, act="relu")
    out = layers.fc(input=fc2, size=class_dim, act=None)
    return out
