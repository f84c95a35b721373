"""VGG-16/19 (the port's counterpart of paddle_tpu/models/vgg.py;
reference benchmark/paddle/image/vgg.py,
tests/book/test_image_classification.py vgg16_bn_drop): img_conv_group
blocks with batch norm and dropout, then fc -> batch_norm(relu) ->
dropout -> fc -> fc."""

from __future__ import annotations

from .. import layers, nets


def _conv_block(input, num_filter, groups, dropouts, is_test=False):
    # per reference vgg16_bn_drop: dropout after every conv in the group
    # except the last (rate 0 there)
    rates = [dropouts] * (groups - 1) + [0.0]
    return nets.img_conv_group(
        input=input, conv_num_filter=[num_filter] * groups,
        pool_size=2, pool_stride=2, conv_filter_size=3, conv_act="relu",
        conv_with_batchnorm=True, conv_batchnorm_drop_rate=rates,
        pool_type="max", is_test=is_test)


def _vgg(input, class_dim, depth_groups, fc_size=4096, with_dropout=True,
         is_test=False):
    c1 = _conv_block(input, 64, depth_groups[0], 0.3, is_test=is_test)
    c2 = _conv_block(c1, 128, depth_groups[1], 0.4, is_test=is_test)
    c3 = _conv_block(c2, 256, depth_groups[2], 0.4, is_test=is_test)
    c4 = _conv_block(c3, 512, depth_groups[3], 0.4, is_test=is_test)
    c5 = _conv_block(c4, 512, depth_groups[4], 0.4, is_test=is_test)

    drop = layers.dropout(x=c5, dropout_prob=0.5, is_test=is_test) \
        if with_dropout else c5
    fc1 = layers.fc(input=drop, size=fc_size, act=None)
    bn = layers.batch_norm(input=fc1, act="relu", is_test=is_test)
    drop2 = layers.dropout(x=bn, dropout_prob=0.5, is_test=is_test) \
        if with_dropout else bn
    fc2 = layers.fc(input=drop2, size=fc_size, act=None)
    out = layers.fc(input=fc2, size=class_dim, act=None)
    return out


def vgg16(input, class_dim=1000, is_test=False):
    return _vgg(input, class_dim, [2, 2, 3, 3, 3], is_test=is_test)


def vgg19(input, class_dim=1000, is_test=False):
    return _vgg(input, class_dim, [2, 2, 4, 4, 4], is_test=is_test)
