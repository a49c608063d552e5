"""SE-ResNeXt-50 as a Program: the port's own copy of
paddle_tpu/models/se_resnext.py (the reference benchmark's model).
Bottleneck blocks of grouped 3 x 3 convolutions (cardinality 32) with a
squeeze-excitation gate: a global average pool, two fc layers (ReLU, then
sigmoid) and an ``elementwise_mul`` of the block's output by the gate along
its channel axis (``axis=0``: y [N, C] against x [N, C, H, W]). Built with
the port's layers, so that the program is the JAX package's, op for op."""
from .. import layers

__all__ = ['se_resnext_50', 'build']


def conv_bn_layer(input, num_filters, filter_size, stride=1, groups=1,
                  act=None, is_test=False):
    conv = layers.conv2d(input=input, num_filters=num_filters,
                         filter_size=filter_size, stride=stride,
                         padding=(filter_size - 1) // 2, groups=groups,
                         act=None, bias_attr=False)
    return layers.batch_norm(input=conv, act=act, is_test=is_test)


def squeeze_excitation(input, num_channels, reduction_ratio):
    pool = layers.pool2d(input=input, pool_type='avg', global_pooling=True)
    squeeze = layers.fc(input=pool,
                        size=num_channels // reduction_ratio, act='relu')
    excitation = layers.fc(input=squeeze, size=num_channels, act='sigmoid')
    return layers.elementwise_mul(x=input, y=excitation, axis=0)


def _shortcut(input, ch_out, stride, is_test):
    ch_in = input.shape[1]
    if ch_in != ch_out or stride != 1:
        return conv_bn_layer(input, ch_out, 1, stride, is_test=is_test)
    return input


def bottleneck_block(input, num_filters, stride, cardinality,
                     reduction_ratio, is_test=False):
    conv0 = conv_bn_layer(input, num_filters, 1, act='relu',
                          is_test=is_test)
    conv1 = conv_bn_layer(conv0, num_filters, 3, stride=stride,
                          groups=cardinality, act='relu', is_test=is_test)
    conv2 = conv_bn_layer(conv1, num_filters * 2, 1, act=None,
                          is_test=is_test)
    scale = squeeze_excitation(conv2, num_filters * 2, reduction_ratio)
    short = _shortcut(input, num_filters * 2, stride, is_test)
    return layers.elementwise_add(x=short, y=scale, act='relu')


def se_resnext_50(input, class_dim=1000, is_test=False):
    cardinality, reduction_ratio = 32, 16
    depth = [3, 4, 6, 3]
    num_filters = [128, 256, 512, 1024]
    conv = conv_bn_layer(input, 64, 7, stride=2, act='relu',
                         is_test=is_test)
    conv = layers.pool2d(input=conv, pool_size=3, pool_stride=2,
                         pool_padding=1, pool_type='max')
    for block in range(len(depth)):
        for i in range(depth[block]):
            conv = bottleneck_block(
                conv, num_filters[block], 2 if i == 0 and block != 0 else 1,
                cardinality, reduction_ratio, is_test=is_test)
    pool = layers.pool2d(input=conv, pool_type='avg', global_pooling=True)
    drop = layers.dropout(x=pool, dropout_prob=0.2, is_test=is_test)
    return layers.fc(input=drop, size=class_dim, act='softmax')


def build(class_dim=1000, image_shape=(3, 224, 224), is_test=False):
    """(img, label, pred, avg_cost, acc) of the classifier on
    ``image_shape`` images and ``class_dim`` classes."""
    img = layers.data(name='img', shape=list(image_shape), dtype='float32')
    label = layers.data(name='label', shape=[1], dtype='int64')
    pred = se_resnext_50(img, class_dim, is_test=is_test)
    cost = layers.cross_entropy(input=pred, label=label)
    avg_cost = layers.mean(cost)
    acc = layers.accuracy(input=pred, label=label)
    return img, label, pred, avg_cost, acc
