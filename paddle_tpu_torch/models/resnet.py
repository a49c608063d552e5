"""ResNet as a Program: the port's own copy of paddle_tpu/models/resnet.py
(the reference benchmark's cifar10 and ImageNet variants), NCHW conv +
batch-norm blocks built with the port's layers, so that each program is
the JAX package's, op for op."""
from .. import layers

__all__ = ['resnet_cifar10', 'resnet_imagenet', 'build']


def conv_bn_layer(input, ch_out, filter_size, stride, padding, act='relu',
                  is_test=False):
    conv = layers.conv2d(input=input, num_filters=ch_out,
                         filter_size=filter_size, stride=stride,
                         padding=padding, act=None, bias_attr=False)
    return layers.batch_norm(input=conv, act=act, is_test=is_test)


def _shortcut(input, ch_in, ch_out, stride, is_test):
    if stride != 1 or ch_in != ch_out:
        return conv_bn_layer(input, ch_out, 1, stride, 0, act=None,
                             is_test=is_test)
    return input


def basicblock(input, ch_in, ch_out, stride, is_test):
    short = _shortcut(input, ch_in, ch_out, stride, is_test)
    conv1 = conv_bn_layer(input, ch_out, 3, stride, 1, is_test=is_test)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, act=None, is_test=is_test)
    return layers.elementwise_add(x=short, y=conv2, act='relu')


def bottleneck(input, ch_in, ch_out, stride, is_test):
    short = _shortcut(input, ch_in, ch_out * 4, stride, is_test)
    conv1 = conv_bn_layer(input, ch_out, 1, stride, 0, is_test=is_test)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, is_test=is_test)
    conv3 = conv_bn_layer(conv2, ch_out * 4, 1, 1, 0, act=None,
                          is_test=is_test)
    return layers.elementwise_add(x=short, y=conv3, act='relu')


def _layer_warp(block_func, input, ch_in, ch_out, count, stride, is_test):
    res_out = block_func(input, ch_in, ch_out, stride, is_test)
    ch_in = ch_out * (4 if block_func is bottleneck else 1)
    for i in range(1, count):
        res_out = block_func(res_out, ch_in, ch_out, 1, is_test)
    return res_out


def resnet_cifar10(input, class_dim=10, depth=32, is_test=False):
    if (depth - 2) % 6:
        raise ValueError('a cifar10 ResNet has depth 6n + 2, got %d' % depth)
    n = (depth - 2) // 6
    conv1 = conv_bn_layer(input, ch_out=16, filter_size=3, stride=1,
                          padding=1, is_test=is_test)
    res1 = _layer_warp(basicblock, conv1, 16, 16, n, 1, is_test)
    res2 = _layer_warp(basicblock, res1, 16, 32, n, 2, is_test)
    res3 = _layer_warp(basicblock, res2, 32, 64, n, 2, is_test)
    pool = layers.pool2d(input=res3, pool_size=8, pool_type='avg',
                         pool_stride=1, global_pooling=True)
    return layers.fc(input=pool, size=class_dim, act='softmax')


def resnet_imagenet(input, class_dim=1000, depth=50, is_test=False):
    cfg = {18: ([2, 2, 2, 1], basicblock),
           34: ([3, 4, 6, 3], basicblock),
           50: ([3, 4, 6, 3], bottleneck),
           101: ([3, 4, 23, 3], bottleneck),
           152: ([3, 8, 36, 3], bottleneck)}
    stages, block_func = cfg[depth]
    conv1 = conv_bn_layer(input, ch_out=64, filter_size=7, stride=2,
                          padding=3, is_test=is_test)
    pool1 = layers.pool2d(input=conv1, pool_type='max', pool_size=3,
                          pool_stride=2, pool_padding=1)
    res1 = _layer_warp(block_func, pool1, 64, 64, stages[0], 1, is_test)
    res2 = _layer_warp(block_func, res1, 256, 128, stages[1], 2, is_test)
    res3 = _layer_warp(block_func, res2, 512, 256, stages[2], 2, is_test)
    res4 = _layer_warp(block_func, res3, 1024, 512, stages[3], 2, is_test)
    pool2 = layers.pool2d(input=res4, pool_size=7, pool_type='avg',
                          pool_stride=1, global_pooling=True)
    return layers.fc(input=pool2, size=class_dim, act='softmax')


def build(variant='cifar10', batch_size=-1, depth=None, class_dim=None,
          is_test=False):
    """(img, label, pred, avg_cost, acc) of a cifar10 (3 x 32 x 32) or, for
    any other ``variant``, an ImageNet (3 x 224 x 224) ResNet in the
    default programs."""
    if variant == 'cifar10':
        img = layers.data(name='img', shape=[3, 32, 32], dtype='float32')
        label = layers.data(name='label', shape=[1], dtype='int64')
        pred = resnet_cifar10(img, class_dim or 10, depth or 32,
                              is_test=is_test)
    else:
        img = layers.data(name='img', shape=[3, 224, 224], dtype='float32')
        label = layers.data(name='label', shape=[1], dtype='int64')
        pred = resnet_imagenet(img, class_dim or 1000, depth or 50,
                               is_test=is_test)
    cost = layers.cross_entropy(input=pred, label=label)
    avg_cost = layers.mean(cost)
    acc = layers.accuracy(input=pred, label=label)
    return img, label, pred, avg_cost, acc
