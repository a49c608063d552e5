"""Control-flow layers: the comparisons, ``increment`` and ``is_empty``.

The port's own copy of paddle_tpu/layers/control_flow.py's thin op
wrappers (`less_than`, `less_equal`, `greater_than`, `greater_equal`,
`equal`, `not_equal`, `increment`, `is_empty`), each appending the JAX
layer's op with the same slots and a bool output. ``While``, the RNNs and
the tensor arrays are not ported yet.
"""
from ..layer_helper import LayerHelper

__all__ = ['less_than', 'less_equal', 'greater_than', 'greater_equal',
           'equal', 'not_equal', 'increment', 'is_empty']


def _cmp(op_type, x, y, cond=None):
    helper = LayerHelper(op_type)
    if cond is None:
        cond = helper.create_variable_for_type_inference(dtype='bool',
                                                         shape=x.shape)
    helper.append_op(type=op_type, inputs={'X': [x], 'Y': [y]},
                     outputs={'Out': [cond]})
    return cond


def less_than(x, y, force_cpu=None, cond=None):
    return _cmp('less_than', x, y, cond)


def less_equal(x, y, cond=None):
    return _cmp('less_equal', x, y, cond)


def greater_than(x, y, cond=None):
    return _cmp('greater_than', x, y, cond)


def greater_equal(x, y, cond=None):
    return _cmp('greater_equal', x, y, cond)


def equal(x, y, cond=None):
    return _cmp('equal', x, y, cond)


def not_equal(x, y, cond=None):
    return _cmp('not_equal', x, y, cond)


def increment(x, value=1.0, in_place=True):
    from .nn import increment as _inc
    return _inc(x, value, in_place)


def is_empty(x, cond=None):
    helper = LayerHelper('is_empty')
    if cond is None:
        cond = helper.create_variable_for_type_inference(dtype='bool',
                                                         shape=[1])
    helper.append_op(type='is_empty', inputs={'X': [x]},
                     outputs={'Out': [cond]})
    return cond
