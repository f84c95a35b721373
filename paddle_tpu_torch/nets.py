"""Composite network helpers, the part the ported chapters use (the port's
counterpart of paddle_tpu/nets.py; reference python/paddle/fluid/nets.py).
The JAX package's other helpers (img_conv_group, sequence_conv_pool, glu,
scaled_dot_product_attention) are a later slice."""

from __future__ import annotations

from . import layers

__all__ = ["simple_img_conv_pool"]


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, act, param_attr=None,
                         pool_type="max", use_cudnn=True, use_mkldnn=False):
    """conv2d (unpadded, stride 1) with `act`, then pool2d (nets.py:11)."""
    conv_out = layers.conv2d(input=input, num_filters=num_filters,
                             filter_size=filter_size, param_attr=param_attr,
                             act=act)
    return layers.pool2d(input=conv_out, pool_size=pool_size,
                         pool_type=pool_type, pool_stride=pool_stride)
