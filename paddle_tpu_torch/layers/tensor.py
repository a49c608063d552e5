"""Tensor layers: ``assign``.

The port's own copy of `assign` from paddle_tpu/layers/tensor.py (a
numpy value becomes an ``assign_value`` op holding it).
"""
import numpy as np

from ..framework import Variable
from ..layer_helper import LayerHelper

__all__ = ['assign']


def assign(input, output=None):
    helper = LayerHelper('assign')
    if isinstance(input, Variable):
        if output is None:
            output = helper.create_variable_for_type_inference(
                dtype=input.dtype, shape=input.shape)
        helper.append_op(type='assign', inputs={'X': [input]},
                         outputs={'Out': [output]})
    else:
        arr = np.asarray(input)
        if output is None:
            output = helper.create_variable_for_type_inference(
                dtype=arr.dtype, shape=arr.shape)
        helper.append_op(
            type='assign_value', outputs={'Out': [output]},
            attrs={'shape': list(arr.shape), 'dtype': arr.dtype,
                   'values': arr.flatten().tolist()})
    return output
