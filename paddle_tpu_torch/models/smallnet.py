"""SmallNet — the CIFAR-quick benchmark CNN (the port's copy of
paddle_tpu/models/smallnet.py; reference
benchmark/paddle/image/smallnet_mnist_cifar.py: three 5x5/3x3 convs with
3x3/stride-2 pools, fc64, softmax head; the BASELINE.md §1 "SmallNet"
rows). 32x32 color input."""

from __future__ import annotations

from .. import layers


def smallnet_mnist_cifar(input, class_dim=10, is_test=False):
    net = layers.conv2d(input=input, num_filters=32, filter_size=5,
                        stride=1, padding=2, act="relu")
    net = layers.pool2d(input=net, pool_size=3, pool_stride=2,
                        pool_padding=1, pool_type="max")
    net = layers.conv2d(input=net, num_filters=32, filter_size=5,
                        stride=1, padding=2, act="relu")
    net = layers.pool2d(input=net, pool_size=3, pool_stride=2,
                        pool_padding=1, pool_type="avg")
    net = layers.conv2d(input=net, num_filters=64, filter_size=3,
                        stride=1, padding=1, act="relu")
    net = layers.pool2d(input=net, pool_size=3, pool_stride=2,
                        pool_padding=1, pool_type="avg")
    net = layers.fc(input=net, size=64, act="relu")
    return layers.fc(input=net, size=class_dim)
