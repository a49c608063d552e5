"""Metric layers.

The port's own copy of `accuracy` from paddle_tpu/layers/metric_op.py: a
``top_k`` op, then an ``accuracy`` op over its indices. ``auc`` and
``chunk_eval`` wait for a later slice.
"""
from ..layer_helper import LayerHelper

__all__ = ['accuracy']


def accuracy(input, label, k=1, correct=None, total=None):
    """The share of rows whose label is among the ``k`` largest entries of
    ``input``, as a [1] float32 variable (no gradient)."""
    helper = LayerHelper("accuracy")
    shape = tuple(input.shape[:-1]) + (k,)
    topk_out = helper.create_variable_for_type_inference(dtype=input.dtype,
                                                         shape=shape)
    topk_indices = helper.create_variable_for_type_inference(
        dtype='int64', shape=shape)
    helper.append_op(type='top_k', inputs={'X': [input]},
                     outputs={'Out': [topk_out],
                              'Indices': [topk_indices]},
                     attrs={'k': k})
    acc_out = helper.create_variable_for_type_inference(dtype='float32',
                                                        shape=(1,))
    if correct is None:
        correct = helper.create_variable_for_type_inference(
            dtype='int32', shape=(1,))
    if total is None:
        total = helper.create_variable_for_type_inference(dtype='int32',
                                                          shape=(1,))
    helper.append_op(
        type='accuracy',
        inputs={'Out': [topk_out], 'Indices': [topk_indices],
                'Label': [label]},
        outputs={'Accuracy': [acc_out], 'Correct': [correct],
                 'Total': [total]})
    acc_out.stop_gradient = True
    return acc_out
