"""The ops behind ``Variable``'s operators (framework.py).

The port's own copy of paddle_tpu/layers/math_op_patch.py: ``x + s`` and
``x * s`` for a Python scalar ``s`` append one ``scale`` op; any other
scalar operand becomes a ``fill_constant`` of shape [1] (never 0-dim: a
0-dim float32 tensor would take a bf16 operand's dtype in torch and not
in JAX); then one elementwise or comparison op with ``axis`` -1, whose
output takes x's dtype, or bool for a comparison, and the longer shape of
the two operands.
"""
import numpy as np

from ..layer_helper import LayerHelper

__all__ = []

_SCALAR_FRIENDLY = {'elementwise_add': ('scale', lambda s: {'scale': 1.0,
                                                            'bias': float(s)}),
                    'elementwise_sub': None,
                    'elementwise_mul': ('scale', lambda s: {'scale': float(s),
                                                            'bias': 0.0})}

_COMPARISONS = ('less_than', 'less_equal', 'greater_than', 'greater_equal',
                'equal', 'not_equal')


def _create_scalar_var(helper, value, dtype):
    out = helper.create_variable_for_type_inference(dtype, shape=(1,))
    helper.append_op(type='fill_constant', outputs={'Out': [out]},
                     attrs={'shape': [1], 'dtype': out.dtype,
                            'value': float(value)})
    return out


def binary_op(x, other, op_type, reverse=False):
    """``x <op> other`` (``other <op> x`` with ``reverse``) for a Variable
    ``x`` and a Variable or Python scalar ``other``."""
    helper = LayerHelper(op_type)
    if np.isscalar(other):
        fast = _SCALAR_FRIENDLY.get(op_type)
        if fast is not None and not reverse:
            name, mk = fast
            out = helper.create_variable_for_type_inference(
                dtype=x.dtype, shape=x.shape)
            helper.append_op(type=name, inputs={'X': [x]},
                             outputs={'Out': [out]}, attrs=mk(other))
            return out
        other = _create_scalar_var(helper, other, x.dtype)
    a, b = (other, x) if reverse else (x, other)
    out = helper.create_variable_for_type_inference(
        dtype='bool' if op_type in _COMPARISONS else x.dtype,
        shape=a.shape if len(a.shape or ()) >= len(b.shape or ())
        else b.shape)
    helper.append_op(type=op_type, inputs={'X': [a], 'Y': [b]},
                     outputs={'Out': [out]}, attrs={'axis': -1})
    return out
