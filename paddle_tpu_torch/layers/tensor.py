"""Tensor layers.

The port's own copy of paddle_tpu/layers/tensor.py's `create_parameter`,
`create_global_var`,
`cast`, `concat`, `sums`, `assign` (a numpy value becomes an
``assign_value`` op holding it), `fill_constant`,
`fill_constant_batch_size_like`, `ones`, `zeros`, `zeros_like`, `reverse`,
`argmin`, `argmax`, `argsort`, `isfinite` (and `has_inf`, `has_nan`, which
emit it too, as in the JAX package) and `diag`: each appends the JAX
layer's op with the same slots, attrs and static output shape.
"""
import numpy as np

from ..core.types import convert_np_dtype_to_dtype_
from ..framework import Variable
from ..initializer import Constant
from ..layer_helper import LayerHelper

__all__ = ['create_parameter', 'create_global_var', 'cast', 'concat', 'sums', 'assign',
           'fill_constant', 'fill_constant_batch_size_like', 'ones', 'zeros',
           'reverse', 'argmin', 'argmax', 'argsort', 'has_inf', 'has_nan',
           'isfinite', 'zeros_like', 'diag']


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """A parameter of ``shape`` in the main program's global block, with
    its init op in the startup program."""
    helper = LayerHelper("create_parameter", name=name, param_attr=attr)
    attr = helper.param_attr
    if name is not None and attr.name is None:
        attr.name = name
    return helper.create_parameter(attr, shape,
                                   convert_np_dtype_to_dtype_(dtype), is_bias,
                                   default_initializer)


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


def cast(x, dtype):
    helper = LayerHelper('cast')
    dtype = convert_np_dtype_to_dtype_(dtype)
    out = helper.create_variable_for_type_inference(dtype=dtype,
                                                    shape=x.shape)
    helper.append_op(type='cast', inputs={'X': [x]}, outputs={'Out': [out]},
                     attrs={'in_dtype': x.dtype, 'out_dtype': dtype})
    return out


def concat(input, axis=0, name=None):
    helper = LayerHelper('concat', name=name)
    shape = list(input[0].shape)
    if all(i.shape[axis] is not None and i.shape[axis] >= 0 for i in input):
        shape[axis] = sum(i.shape[axis] for i in input)
    else:
        shape[axis] = -1
    out = helper.create_variable_for_type_inference(
        dtype=input[0].dtype, shape=shape)
    helper.append_op(type='concat', inputs={'X': input},
                     outputs={'Out': [out]}, attrs={'axis': axis})
    return out


def sums(input, out=None):
    helper = LayerHelper('sum')
    if out is None:
        out = helper.create_variable_for_type_inference(
            dtype=input[0].dtype, shape=input[0].shape)
    helper.append_op(type='sum', inputs={'X': input}, outputs={'Out': [out]})
    return out


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


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    helper = LayerHelper('fill_constant')
    dtype = convert_np_dtype_to_dtype_(dtype)
    if out is None:
        out = helper.create_variable_for_type_inference(dtype=dtype,
                                                        shape=shape)
    helper.append_op(
        type='fill_constant', outputs={'Out': [out]},
        attrs={'shape': list(shape), 'dtype': dtype, 'value': float(value)})
    out.stop_gradient = True
    return out


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0):
    helper = LayerHelper('fill_constant_batch_size_like')
    dtype = convert_np_dtype_to_dtype_(dtype)
    out_shape = list(shape)
    out_shape[output_dim_idx] = input.shape[input_dim_idx]
    out = helper.create_variable_for_type_inference(dtype=dtype,
                                                    shape=out_shape)
    helper.append_op(
        type='fill_constant_batch_size_like',
        inputs={'Input': [input]}, outputs={'Out': [out]},
        attrs={'shape': list(shape), 'dtype': dtype, 'value': float(value),
               'input_dim_idx': input_dim_idx,
               'output_dim_idx': output_dim_idx})
    out.stop_gradient = True
    return out


def ones(shape, dtype, force_cpu=False):
    return fill_constant(shape=shape, dtype=dtype, value=1.0)


def zeros(shape, dtype, force_cpu=False):
    return fill_constant(shape=shape, dtype=dtype, value=0.0)


def zeros_like(x, out=None):
    helper = LayerHelper('zeros_like')
    if out is None:
        out = helper.create_variable_for_type_inference(dtype=x.dtype,
                                                        shape=x.shape)
    helper.append_op(type='fill_zeros_like', inputs={'X': [x]},
                     outputs={'Out': [out]})
    return out


def reverse(x, axis):
    helper = LayerHelper('reverse')
    out = helper.create_variable_for_type_inference(dtype=x.dtype,
                                                    shape=x.shape)
    helper.append_op(type='reverse', inputs={'X': [x]},
                     outputs={'Out': [out]}, attrs={'axis': axis})
    return out


def _arg(op_type, x, axis):
    helper = LayerHelper(op_type)
    shape = [s for i, s in enumerate(x.shape) if i != axis % len(x.shape)]
    out = helper.create_variable_for_type_inference('int64', shape=shape)
    helper.append_op(type=op_type, inputs={'X': [x]},
                     outputs={'Out': [out]}, attrs={'axis': axis})
    return out


def argmin(x, axis=0):
    return _arg('arg_min', x, axis)


def argmax(x, axis=0):
    return _arg('arg_max', x, axis)


def argsort(x, axis=-1, name=None):
    helper = LayerHelper('argsort', name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype,
                                                    shape=x.shape)
    ids = helper.create_variable_for_type_inference('int64', shape=x.shape)
    helper.append_op(type='argsort', inputs={'X': [x]},
                     outputs={'Out': [out], 'Indices': [ids]},
                     attrs={'axis': axis})
    return out, ids


def isfinite(x):
    helper = LayerHelper('isfinite')
    out = helper.create_variable_for_type_inference('bool', shape=(1,))
    helper.append_op(type='isfinite', inputs={'X': [x]},
                     outputs={'Out': [out]})
    return out


def has_inf(x):
    return isfinite(x)


def has_nan(x):
    return isfinite(x)


def diag(diagonal):
    n = diagonal.shape[0]
    helper = LayerHelper('diag')
    out = helper.create_variable_for_type_inference(
        dtype=diagonal.dtype, shape=(n, n))
    helper.append_op(type='diag', inputs={'Diagonal': [diagonal]},
                     outputs={'Out': [out]})
    return out
