"""VGG-16 with batch norm and dropout as a Program: the port's own copy of
paddle_tpu/models/vgg.py (the reference benchmark's CIFAR model): five
`nets.img_conv_group` blocks (3 x 3 convolutions, each with batch norm,
ReLU and, but for a block's last, dropout; then a 2 x 2 max pool), then
dropout, fc 512, batch norm, dropout, fc 512 and the softmax head. The
conv groups' dropouts take no ``is_test``: a program cloned with
``for_test=True`` turns them off."""
from .. import layers
from .. import nets

__all__ = ['vgg16_bn_drop', 'build']


def vgg16_bn_drop(input, is_test=False):
    def conv_block(inp, num_filter, groups, dropouts):
        return nets.img_conv_group(
            input=inp, pool_size=2, pool_stride=2,
            conv_num_filter=[num_filter] * groups, conv_filter_size=3,
            conv_act='relu', conv_with_batchnorm=True,
            conv_batchnorm_drop_rate=dropouts, pool_type='max')

    conv1 = conv_block(input, 64, 2, [0.3, 0])
    conv2 = conv_block(conv1, 128, 2, [0.4, 0])
    conv3 = conv_block(conv2, 256, 3, [0.4, 0.4, 0])
    conv4 = conv_block(conv3, 512, 3, [0.4, 0.4, 0])
    conv5 = conv_block(conv4, 512, 3, [0.4, 0.4, 0])

    drop = layers.dropout(x=conv5, dropout_prob=0.5, is_test=is_test)
    fc1 = layers.fc(input=drop, size=512, act=None)
    bn = layers.batch_norm(input=fc1, act='relu', is_test=is_test)
    drop2 = layers.dropout(x=bn, dropout_prob=0.5, is_test=is_test)
    return layers.fc(input=drop2, size=512, act=None)


def build(class_dim=10, image_shape=(3, 32, 32), is_test=False):
    """(img, label, pred, avg_cost, acc) of the classifier on
    ``image_shape`` images and ``class_dim`` classes."""
    img = layers.data(name='img', shape=list(image_shape), dtype='float32')
    label = layers.data(name='label', shape=[1], dtype='int64')
    net = vgg16_bn_drop(img, is_test=is_test)
    pred = layers.fc(input=net, size=class_dim, act='softmax')
    cost = layers.cross_entropy(input=pred, label=label)
    avg_cost = layers.mean(cost)
    acc = layers.accuracy(input=pred, label=label)
    return img, label, pred, avg_cost, acc
