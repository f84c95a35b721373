"""MNIST models, the port's copy of paddle_tpu/models/mnist.py (reference:
tests/book/test_recognize_digits.py mlp + conv,
benchmark/paddle/image/smallnet_mnist_cifar.py)."""

from __future__ import annotations

from .. import layers, nets


def mnist_mlp(input, class_dim=10, is_test=False):
    h1 = layers.fc(input=input, size=200, act="tanh")
    h2 = layers.fc(input=h1, size=200, act="tanh")
    return layers.fc(input=h2, size=class_dim, act=None)


def mnist_conv(input, class_dim=10, is_test=False):
    conv_pool_1 = nets.simple_img_conv_pool(
        input=input, filter_size=5, num_filters=20, pool_size=2,
        pool_stride=2, act="relu")
    conv_pool_2 = nets.simple_img_conv_pool(
        input=conv_pool_1, filter_size=5, num_filters=50, pool_size=2,
        pool_stride=2, act="relu")
    return layers.fc(input=conv_pool_2, size=class_dim, act=None)
