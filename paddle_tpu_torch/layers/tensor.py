"""Tensor layers: ``create_global_var`` and ``assign``.

The port's own copy of `create_global_var` and `assign` from
paddle_tpu/layers/tensor.py (a numpy value becomes an ``assign_value`` op
holding it).
"""
import numpy as np

from ..framework import Variable
from ..initializer import Constant
from ..layer_helper import LayerHelper

__all__ = ['create_global_var', 'assign']


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    """A global variable of ``shape`` filled with ``value`` by the startup
    program (and, when not persistable, by a ``fill_constant`` op in the
    main program too)."""
    helper = LayerHelper("global_var", name=name)
    var = helper.create_global_variable(
        dtype=dtype, shape=tuple(shape), persistable=persistable,
        name=name)
    helper.set_variable_initializer(var, Constant(value))
    if not persistable:
        helper.main_block.append_op(
            type='fill_constant', outputs={'Out': [var]},
            attrs={'shape': list(shape), 'dtype': var.dtype,
                   'value': float(value)})
    return var


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
