"""The word2vec n-gram model: the port's own copy of
paddle_tpu/models/word2vec.py (the reference's tests/book/test_word2vec.py).
``build`` emits the JAX package's program, letter for letter."""
from .. import layers

__all__ = ['build']

EMBED_SIZE = 32
HIDDEN_SIZE = 256
N = 5


def build(dict_size, is_sparse=False):
    words = [layers.data(name='firstw', shape=[1], dtype='int64'),
             layers.data(name='secondw', shape=[1], dtype='int64'),
             layers.data(name='thirdw', shape=[1], dtype='int64'),
             layers.data(name='forthw', shape=[1], dtype='int64')]
    next_word = layers.data(name='nextw', shape=[1], dtype='int64')

    embeds = []
    for i, w in enumerate(words):
        embeds.append(layers.embedding(
            input=w, size=[dict_size, EMBED_SIZE], dtype='float32',
            is_sparse=is_sparse, param_attr='shared_w'))
    concat = layers.concat(input=embeds, axis=1)
    hidden1 = layers.fc(input=concat, size=HIDDEN_SIZE, act='sigmoid')
    predict = layers.fc(input=hidden1, size=dict_size, act='softmax')
    cost = layers.cross_entropy(input=predict, label=next_word)
    avg_cost = layers.mean(cost)
    return words + [next_word], predict, avg_cost
