"""MNIST models: the port's own copy of paddle_tpu/models/mnist.py (the
reference's benchmark/fluid/models/mnist.py cnn and
tests/book/test_recognize_digits.py mlp and conv paths). ``build``
emits the JAX package's program, letter for letter."""
from .. import layers
from .. import nets

__all__ = ['mlp', 'conv_net', 'build']


def mlp(img, label, hidden_sizes=(128, 64)):
    h = img
    for size in hidden_sizes:
        h = layers.fc(input=h, size=size, act='relu')
    prediction = layers.fc(input=h, size=10, act='softmax')
    cost = layers.cross_entropy(input=prediction, label=label)
    avg_cost = layers.mean(cost)
    acc = layers.accuracy(input=prediction, label=label)
    return prediction, avg_cost, acc


def conv_net(img, label):
    conv_pool_1 = nets.simple_img_conv_pool(
        input=img, filter_size=5, num_filters=20, pool_size=2,
        pool_stride=2, act="relu")
    conv_pool_1 = layers.batch_norm(conv_pool_1)
    conv_pool_2 = nets.simple_img_conv_pool(
        input=conv_pool_1, filter_size=5, num_filters=50, pool_size=2,
        pool_stride=2, act="relu")
    prediction = layers.fc(input=conv_pool_2, size=10, act='softmax')
    cost = layers.cross_entropy(input=prediction, label=label)
    avg_cost = layers.mean(cost)
    acc = layers.accuracy(input=prediction, label=label)
    return prediction, avg_cost, acc


def build(nn_type='mlp'):
    if nn_type == 'mlp':
        img = layers.data(name='img', shape=[784], dtype='float32')
        label = layers.data(name='label', shape=[1], dtype='int64')
        return (img, label) + mlp(img, label)
    img = layers.data(name='img', shape=[1, 28, 28], dtype='float32')
    label = layers.data(name='label', shape=[1], dtype='int64')
    return (img, label) + conv_net(img, label)
